"""The benchmark's own tests: the harness at the tiny size on the CPU (the
card's look skipped), the FLOP counter, the module check, the reference
against the program, the controls and the faults. Card tests carry the
``cuda`` marker and decide in their fixture whether a card is present.

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m cuda    # on the card
"""

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

TINY = {"in_chans": 8, "img_size": [41, 40], "patch_size": [11, 10], "patch_stride": [10, 10],
        "embed_dim": 8, "y_channels": 16, "z_channels": 8, "depth": 4, "num_heads": 2,
        "window_sizes": [[2, 2], [1, 4], [4, 1]], "interval": 2, "hyper_embed_dim": 12,
        "hyper_depth": 2, "hyper_num_heads": 2, "hyper_patch": [2, 2]}
CELLS = ("vaeformer_268.roundtrip_c1", "vaeformer_159.train_b4")


def tiny_overrides(workload: str):
    """The cell at the tiny size: its model, a 20-step fit and a rate
    the tiny fields can reach."""
    from benchlib import harness

    bench = harness.load_json(BENCH.parent / "BENCHMARK.json")
    _, config, _, _ = harness.cell_files(bench, workload)
    over = {"model": TINY}
    traffic = {"trace_at": 0.2, "trace_seconds": 0.3}
    if "codec" in config:
        over["codec"] = {**config["codec"], "fit_steps": 20}
        traffic["rate_bytes"] = 300
    return over, traffic


def run_tiny(workload: str, seed: int = 7, seconds: float = 1.0, trace: bool = False,
             device: str = "cpu") -> dict:
    from benchlib import harness

    over, traffic = tiny_overrides(workload)
    return harness.run(workload, seed, seconds, trace, time.perf_counter(), device=device,
                       config_override=over, traffic_override=traffic, log=lambda msg: None)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
