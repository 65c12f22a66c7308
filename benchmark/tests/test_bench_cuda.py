"""On the card: each cell's job at the tiny size through the harness, its
check correct and its trace read. Run with ``-m cuda``; skips without a
card."""

import pytest

from conftest import CELLS, run_tiny


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_on_the_card(card, workload):
    line = run_tiny(workload, seconds=2.0, device="cuda")
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    traced = run_tiny(workload, seed=8, seconds=3.0, trace=True, device="cuda")
    assert traced["correct"] is True and traced["device"]["busy_s"] > 0
    names = {name.split(".")[0] for name in traced["metrics"]}
    assert {"mfu", "device_idle_share"} <= names
