"""The harness: one run of one cell, as ``BENCHMARK.json`` names it.

It finds the cell's configuration file and its traffic file by name, runs
the traffic file's job (``benchlib/jobs/<job>.py``: set-up, the measured
window, the check), computes the end-to-end metrics (``--trace 0``) or
reads the per-layer metrics with their own readers (``--trace 1``,
``metrics/<name>.py``, see ``reader_path``), makes sure that no JAX module was loaded, and
prints the result as the last line of standard output, with every number
that decided ``correct`` beside its limit as the line's last key and as the
last lines of standard error.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cra5_tpu")


class NoCard(RuntimeError):
    pass


@dataclasses.dataclass
class Context:
    """What a job gets: the cell, its configuration and traffic, the
    device, the run's options and the process's start time."""
    cell: dict
    config: dict
    traffic: dict
    device: Any
    seed: int
    seconds: float
    trace: bool
    t_process: float
    log: Callable[[str], None]
    limits: Dict[str, float]


@dataclasses.dataclass
class Outcome:
    """What a job returns."""
    attempted: int
    failed: int
    metrics: Dict[str, float]              # end-to-end values by name
    checks: List[Tuple[str, float, float]]  # (number, value, limit)
    correct: bool
    memory_peak_bytes: int
    run: Dict[str, Any]                    # what the per-layer readers read


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``cra5_tpu_torch`` is another name)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str) -> Tuple[dict, dict, dict, dict]:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    root = HERE.parent
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    lim_path = HERE / "limits" / f"{workload}.json"
    limits = load_json(lim_path)["limits"] if lim_path.exists() else {}
    return cell, config, traffic, limits


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or for a metric split by the end-to-end
    metric it moves (``<base>.<part>``, as ``mfu.train``) without a file
    of its own, its base's ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    return path if path.exists() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def reader(name: str):
    """The per-layer metric ``name``'s reader (``reader_path``)."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    def ours(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if ours(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def result_line(bench: dict, workload: str, out: Outcome, trace: bool, device_info: dict,
                breakdown: Optional[dict]) -> dict:
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = out.metrics.get(m["name"]) if not trace else reader(m["name"])(out.run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return line


def run(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        device: Optional[str] = None, config_override: Optional[dict] = None,
        traffic_override: Optional[dict] = None, log: Callable[[str], None] = None) -> dict:
    """One run; returns the result line's object. ``device`` "cpu" and the
    overrides exist for the CPU tests, which skip the card."""
    log = log or (lambda msg: print(f"[bench] {msg}", file=sys.stderr, flush=True))
    bench = load_json(HERE.parent / "BENCHMARK.json")
    cell, config, traffic, limits = cell_files(bench, workload)
    config = {**config, **(config_override or {})}
    traffic = {**traffic, **(traffic_override or {})}
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"the cell needs {cell['chips']} card(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    job = importlib.import_module(f"benchlib.jobs.{traffic['job']}")
    ctx = Context(cell, config, traffic, dev, seed, seconds, trace, t_process, log, limits)
    out: Outcome = job.run(ctx)
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "count": cell["chips"], "memory_peak_bytes": int(out.memory_peak_bytes)}
    breakdown = None
    if trace:
        tr = out.run.get("trace")
        info["busy_s"] = tr.busy_s if tr is not None else 0.0
        info["window_s"] = tr.window_s if tr is not None else 0.0
        if tr is not None:
            breakdown = {"device_ops": [[n, s] for n, s in tr.device_ops],
                         "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    return result_line(bench, workload, out, trace, info, breakdown)


def main(args, t_process: float) -> int:
    try:
        line = run(args.workload, args.seed, args.seconds, bool(args.trace), t_process)
    except NoCard as e:
        print(f"[bench] no result: {e}", file=sys.stderr, flush=True)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"[bench] no result: the run loaded {bad}", file=sys.stderr, flush=True)
        return 4
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
