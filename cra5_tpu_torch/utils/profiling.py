"""Timing spans and profiler traces.

Counterpart of ``cra5_tpu/utils/profiling.py``: ``Timings`` accumulates
named wall-clock spans (the API facades' reading/encoding/saving keys);
where the JAX package blocks on an array at a span's end, ``block_on``
here synchronises the current CUDA stream of each card that holds one of
its tensors. ``profile_trace`` records a ``torch.profiler`` trace (host
and, on a card, device activity) into ``log_dir`` for TensorBoard or
Perfetto, and ``annotate`` names a range in it
(``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

import torch


def _sync_tensors(tree: Any) -> None:
    """Wait for the current stream of every card holding a tensor of
    ``tree`` (a tensor, or lists, tuples and dicts of them)."""
    devices = set()

    def visit(obj):
        if isinstance(obj, torch.Tensor):
            if obj.device.type == "cuda":
                devices.add(obj.device)
        elif isinstance(obj, dict):
            for v in obj.values():
                visit(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                visit(v)

    visit(tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class Timings:
    """Named wall-clock spans, summed where a name repeats."""

    def __init__(self):
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, block_on=None) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            if block_on is not None:
                _sync_tensors(block_on)
            self.spans[name] = self.spans.get(name, 0.0) + time.time() - t0

    def as_dict(self) -> Dict[str, float]:
        return dict(self.spans)


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield
