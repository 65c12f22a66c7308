"""Spans and profiler traces.

Counterpart of ``cra5_tpu/utils/profiling.py``. ``span(name, **args)``
opens a ``torch.profiler.record_function`` range, which a trace holds on
the profiler's clock beside the device activity. While a ``torch.profiler``
session records on the calling thread (torch's own flag, which the
autograd threads of that thread share), the range also carries ``args``,
and the span adds its host seconds, its self seconds (less the child spans
on the same thread) and one call to process-wide totals by name:
``span_totals()``, cleared by ``reset_span_totals()``. Off a profiler a
span costs the range and one read of that flag.

``stage_span`` is a span that, given a ``times`` dict, also ends in a
device synchronize and adds its host seconds there (the codecs'
``stage_times``). ``profile_trace`` records a trace (host and, on a card,
device activity) into ``log_dir`` for TensorBoard or Perfetto; read
``span_totals()`` after it for the spans' host seconds.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

_lock = threading.Lock()
_totals: Dict[str, List[float]] = {}  # name -> [seconds, self seconds, calls]
_local = threading.local()  # the open spans' child seconds, innermost last


@contextlib.contextmanager
def span(name: str, **args) -> Iterator[None]:
    """A named range in the profiler's timeline; under a recording
    profiler, with ``args`` (``key=value``) and counted in the totals."""
    if not torch.autograd._profiler_enabled():
        with torch.profiler.record_function(name):
            yield
        return
    stack = _local.__dict__.setdefault("stack", [])
    children = [0.0]
    stack.append(children)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(
                name, ", ".join(f"{k}={v}" for k, v in args.items()) or None):
            yield
    finally:
        sec = time.perf_counter() - t0
        stack.pop()
        if stack:
            stack[-1][0] += sec
        with _lock:
            t = _totals.setdefault(name, [0.0, 0.0, 0])
            t[0] += sec
            t[1] += sec - children[0]
            t[2] += 1


def span_totals() -> Dict[str, Dict[str, float]]:
    """{name: {"s", "self_s", "calls"}} of the spans recorded under a
    profiler since the last ``reset_span_totals``."""
    with _lock:
        return {k: {"s": s, "self_s": own, "calls": int(n)} for k, (s, own, n) in _totals.items()}


def reset_span_totals() -> None:
    with _lock:
        _totals.clear()


@contextlib.contextmanager
def stage_span(name: str, times: Optional[Dict[str, float]], device) -> Iterator[None]:
    """``span(name)``; with ``times`` a dict, the region also ends in a
    synchronize of ``device`` (a card) and adds its host seconds to
    ``times[name]``."""
    with span(name):
        t0 = time.perf_counter()
        yield
        if times is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the region written into ``log_dir``
    (``*.pt.trace.json``); nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
