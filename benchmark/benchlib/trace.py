"""The reduction of a ``torch.profiler`` trace to what the per-layer metrics
read.

The profiler records the host ranges (``record_function``) and operators
of the thread that started it, and every operation on the device. A device
operation names its launch's host operator (kineto's linked correlation
id); that operator lies inside ranges of its thread. So each device
operation launched inside one of the benchmark's own units (``bench/request``
or ``bench/step``, one a unit of work; a launch from the profiled autograd
thread by its time) is attributed to that unit and to the innermost
program range around its launch (``compress/g_a``, ...).

The traced window runs from the first unit's start to the last unit's end.
``busy_s`` is the union of every device operation's time within it, on
every stream; idle gaps are the holes in that union, each named by what the
profiling thread was doing at the gap's middle.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

UNIT_PREFIX = "bench/"


@dataclasses.dataclass
class Ev:
    name: str
    start: int  # ns
    end: int
    thread: int
    corr: int
    lcorr: int
    device: bool
    annotation: bool


@dataclasses.dataclass
class Op:
    """A device operation inside the traced window."""
    name: str
    dur_s: float
    unit: Optional[int]  # index of the unit whose launch it belongs to
    stage: Optional[str]  # the innermost program range of its launch


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    units: int
    ops: List[Op]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    diagnostics: Dict[str, object]


def activities(device) -> list:
    """What the profiler records: the host, and the card where there is one.
    A profile is first started on the main thread (kineto requires it) before
    one starts on a client's."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def events(prof) -> List[Ev]:
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        start = int(e.start_ns())
        out.append(Ev(e.name(), start, start + int(e.duration_ns()), int(e.start_thread_id()),
                      int(e.correlation_id()), int(e.linked_correlation_id()), dev,
                      bool(e.is_user_annotation())))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _innermost(spans: List[Ev], t: int) -> Optional[Ev]:
    best = None
    for a in spans:
        if a.start <= t <= a.end and (best is None or a.end - a.start < best.end - best.start):
            best = a
    return best


def reduce(evs: List[Ev], top: int = 10) -> Trace:
    host = [e for e in evs if not e.device]
    units = sorted((e for e in host if e.annotation and e.name.startswith(UNIT_PREFIX)),
                   key=lambda e: e.start)
    device = [e for e in evs if e.device and not e.annotation]
    diag = {"host_events": len(host), "device_events": len(device), "units": len(units)}
    if not units:
        return Trace(0.0, 0.0, 0, [], [], [], diag)
    t0, t1 = units[0].start, units[-1].end
    ranges = defaultdict(list)  # thread -> program ranges
    for e in host:
        if e.annotation and not e.name.startswith(UNIT_PREFIX):
            ranges[e.thread].append(e)
    ops_by_corr = {e.corr: e for e in host if not e.name.startswith("cu")}
    ops, clipped = [], []
    attributed = 0
    for k in device:
        s, e = max(k.start, t0), min(k.end, t1)
        if e <= s:
            continue
        clipped.append((s, e))
        owner = ops_by_corr.get(k.lcorr)
        unit = stage = None
        if owner is not None:
            for i, u in enumerate(units):
                if u.start <= owner.start <= u.end:  # the autograd thread's too
                    unit = i
                    break
            inner = _innermost(ranges[owner.thread], owner.start)
            stage = inner.name if inner is not None else None
        attributed += unit is not None
        ops.append(Op(k.name, (k.end - k.start) / 1e9, unit, stage))
    busy = _union(clipped)
    busy_s = sum(e - s for s, e in busy) / 1e9
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, k in ((max(k.start, t0), min(k.end, t1), k) for k in device):
        if e > s:
            by_name[k.name] += (e - s) / 1e9
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    holes = sorted(((s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s),
                   key=lambda g: g[0] - g[1])[:top]
    prof_thread = units[0].thread
    prof_ops = [h for h in host if h.thread == prof_thread and not h.annotation]
    gaps = []
    for s, e in holes:
        mid = (s + e) // 2
        inner = _innermost(ranges[prof_thread], mid)
        op = _innermost(prof_ops, mid)
        label = " > ".join(x.name for x in (inner, op) if x is not None) or "no host range"
        gaps.append((label, (e - s) / 1e9))
    diag["attributed"] = attributed
    return Trace((t1 - t0) / 1e9, busy_s, len(units), ops,
                 sorted(by_name.items(), key=lambda kv: -kv[1])[:top], gaps[:top], diag)
