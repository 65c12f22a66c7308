"""Each traffic file's job at the tiny size on the CPU, through the
harness, with the card's look skipped: the result line has its keys in
order, every metric the cell lists with its unit, the device block and
the checks last."""

import json
import math
import subprocess
import sys

import pytest

from conftest import BENCH, CELLS, run_tiny

BENCHMARK = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def _expected(workload, trace):
    from benchlib import harness

    return {m["name"]: m["unit"] for m in harness.metrics_of(BENCHMARK, workload, trace)}


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_has_every_key_and_metric(workload):
    line = run_tiny(workload)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = _expected(workload, False)
    assert set(line["metrics"]) == set(want) - {"peak_gib"}  # no allocator on the CPU
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and math.isfinite(m["value"]) and m["value"] > 0
    dev = line["device"]
    assert set(dev) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert dev["count"] == 1
    assert line["checks"] and all({"value", "limit"} == set(c) for c in line["checks"].values())
    json.dumps(line)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line_carries_the_per_layer_metrics(workload):
    line = run_tiny(workload, seconds=1.5, trace=True)
    want = _expected(workload, True)
    assert set(line["metrics"]) <= set(want)
    assert any(name.split(".")[0] == "mfu" for name in line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0], "--seed",
                        str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=BENCH.parent)
    assert r.returncode == 3 and r.stdout == ""


def test_every_cell_has_its_files():
    from benchlib import harness

    for w in BENCHMARK["workloads"]:
        cell, config, traffic, limits = harness.cell_files(BENCHMARK, w["name"])
        assert (BENCH / "benchlib" / "jobs" / f"{traffic['job']}.py").exists()
        assert limits, f"{w['name']} has no limits file"
        for m in harness.metrics_of(BENCHMARK, w["name"], True):
            assert harness.reader_path(m["name"]).exists(), m["name"]
