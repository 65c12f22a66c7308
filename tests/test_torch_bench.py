"""``cra5_tpu_torch.bench`` on the CPU with ``BENCH_MODEL=tiny``: the last
(only) stdout line is the headline JSON of ``bench.py``'s metric, the
detail JSON on stderr carries every block it promises, a calibration that
fails ends the run with a non-zero exit and no headline, and without a
card the module refuses to run. This file imports no JAX."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from cra5_tpu_torch import bench, kernels
from cra5_tpu_torch.train import calibrate

ROOT = Path(__file__).resolve().parents[1]
SHORT = dict(BENCH_MODEL="tiny", BENCH_ITERS="2", BENCH_WARMUP="1", BENCH_CALIB_STEPS="5",
             BENCH_CONCURRENCY="2", BENCH_WINDOW="2", BENCH_PRODUCTION="1",
             BENCH_CONFIGS34="1", BENCH_FULL="0", BENCH_TIME_BUDGET="600")


@pytest.fixture
def short_env(monkeypatch, tmp_path):
    for k, v in SHORT.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "CACHE_DIR", tmp_path)


def test_headline_is_the_last_stdout_line_and_detail_on_stderr(short_env, capsys):
    assert bench.main(device="cpu") == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    head = json.loads(lines[-1])
    assert len(lines) == 1
    assert set(head) == {"metric", "value", "unit", "vs_baseline"}
    assert head["metric"] == "era5_268v_roundtrips_per_sec_per_chip"
    assert head["unit"] == "roundtrips/s" and head["value"] > 0
    assert head["vs_baseline"] == pytest.approx(head["value"] / bench.BASELINE_RPS, abs=1e-4)
    detail = json.loads(err.strip().splitlines()[-1])["detail"]
    assert detail["calibration"]["steps"] == 5 and detail["calibration"]["cached"] is False
    assert detail["pipelined_windows"] and detail["concurrency"] == 2
    assert set(detail["headline_wrmse"]) == {"mean", "p50", "p95", "max"}
    assert detail["production_point"]["probes"][0][0] == 1.0
    configs = detail["baseline_configs"]
    assert configs["config3_batched_encode"]["batch"] == 8
    assert configs["config4_decoder_only"]["pipelined_by_depth"].keys() == {"2"}
    assert configs["config1_159v"] == {"skipped": "BENCH_FULL=0"}
    assert configs["config5_mesh_recompress"] == {"skipped": "BENCH_FULL=0"}
    for block in (detail, detail["production_point"], configs["config3_batched_encode"],
                  configs["config4_decoder_only"]):
        assert block["card"] == "cpu"


def test_a_failing_calibration_fails_the_run(short_env, monkeypatch, capsys):
    def diverge(*a, **k):
        raise FloatingPointError("calibration diverged")

    monkeypatch.setattr(calibrate, "calibrate_entropy", diverge)
    with pytest.raises(FloatingPointError):
        bench.main(device="cpu")
    assert capsys.readouterr().out == ""


def test_the_bench_module_needs_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **SHORT}
    r = subprocess.run([sys.executable, "-m", "cra5_tpu_torch.bench"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "device='cpu'" in r.stderr


def test_pipelined_rate_checks_and_times_on_every_thread():
    """The pipelined estimator runs the checked call max(concurrency, 4)
    times first, then n_windows windows, and returns their median."""
    calls = []
    rate, windows = bench.pipelined_rate(lambda: calls.append("t"), 3, 5, 3,
                                         torch.device("cpu"), first=lambda: calls.append("c"))
    assert calls.count("c") == 4 and calls.count("t") == 15
    assert len(windows) == 3 and rate == sorted(windows)[1]


def test_launch_counts_lose_no_launch_across_threads():
    """The pipelined bench launches from several threads at once: 16
    threads counting 2000 launches each, with the interpreter switching
    threads every microsecond, leave exactly 32000 on the counter."""
    @kernels.counted
    def probe_wrapper():
        kernels.count(probe_wrapper)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [probe_wrapper() for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
        kernels._wrappers.remove(probe_wrapper)
    assert probe_wrapper.launches == 32000


def test_config5_recompresses_on_gloo_processes():
    """bench.py's config 5 at 2 gloo processes on the CPU (the bench runs
    8): 16 timesteps recompressed, a rate, each rank's seconds."""
    res = bench.config5(n_procs=2, timeout=240)
    assert set(res) == {"samples_per_sec", "n_samples", "mesh", "rank_seconds"}, res
    assert res["n_samples"] == 16 and res["samples_per_sec"] > 0
    assert len(res["rank_seconds"]) == 2 and res["mesh"].startswith("2 gloo cpu processes")
