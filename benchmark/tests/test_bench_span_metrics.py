"""The readers of the program's spans on a synthetic run: a ``Trace`` whose
operations sit in the train step's spans and stubbed span totals give the
expected milliseconds a timestep; an untraced run, and a program without
the spans, give None."""

import json
import sys
import types

import pytest

from conftest import BENCH
from benchlib import harness
from benchlib.trace import Op, Trace

BENCHMARK = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELL = {"coder_host_ms": "vaeformer_268.roundtrip_c1",
        "recompute_device_ms": "vaeformer_159.train_b4",
        "optimizer_device_ms": "vaeformer_159.train_b4"}


def _run(ops, units, batch):
    return {"trace": Trace(1.0, 0.5, units, ops, [], [], {}), "batch": batch}


def _train_ops():
    return [Op("gemm", 0.010, 0, "train/recompute"), Op("flash", 0.002, 1, "train/recompute"),
            Op("foreach", 0.001, 0, "train/optimizer"), Op("lerp", 0.0005, 1, "train/ema"),
            Op("gemm", 0.100, 0, "train/backward"), Op("gemm", 0.050, 0, None),
            Op("foreach", 0.300, None, "train/optimizer")]  # outside the traced steps


def test_each_reader_is_listed_for_its_cell_alone():
    for name, cell in CELL.items():
        for w in BENCHMARK["workloads"]:
            traced = {m["name"] for m in harness.metrics_of(BENCHMARK, w["name"], True)}
            assert (name in traced) == (w["name"] == cell), (name, w["name"])
            assert name not in {m["name"] for m in harness.metrics_of(BENCHMARK, w["name"], False)}


def test_train_readers_give_device_ms_a_timestep():
    run = _run(_train_ops(), units=2, batch=4)
    assert harness.reader("recompute_device_ms")(run) == pytest.approx(1e3 * 0.012 / 8)
    assert harness.reader("optimizer_device_ms")(run) == pytest.approx(1e3 * 0.0015 / 8)


def test_coder_host_ms_reads_the_programs_totals(monkeypatch):
    from cra5_tpu_torch.utils import profiling

    totals = {"coder/pack": {"s": 0.030, "self_s": 0.030, "calls": 4},
              "coder/parse": {"s": 0.010, "self_s": 0.010, "calls": 8},
              "compress/finalize": {"s": 0.050, "self_s": 0.020, "calls": 4}}
    monkeypatch.setattr(profiling, "span_totals", lambda: totals)
    run = _run([Op("rans", 0.001, 0, "compress/finalize")], units=4, batch=1)
    assert harness.reader("coder_host_ms")(run) == pytest.approx(1e3 * 0.040 / 4)
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert harness.reader("coder_host_ms")(run) is None


@pytest.mark.parametrize("name", sorted(CELL))
def test_untraced_run_reads_none(name):
    assert harness.reader(name)({"trace": None, "batch": 1}) is None
    assert harness.reader(name)(_run([], units=0, batch=1)) is None


def test_a_program_without_the_spans_reads_none(monkeypatch):
    ops = [Op("gemm", 0.01, 0, "compress/g_a"), Op("gemm", 0.01, 0, None)]
    for name in ("recompute_device_ms", "optimizer_device_ms"):
        assert harness.reader(name)(_run(ops, units=1, batch=4)) is None
    bare = types.ModuleType("cra5_tpu_torch.utils.profiling")  # a profiling module of old
    monkeypatch.setitem(sys.modules, "cra5_tpu_torch.utils.profiling", bare)
    assert harness.reader("coder_host_ms")(_run(ops, units=1, batch=1)) is None
