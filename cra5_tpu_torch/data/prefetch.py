"""Host-side data feed: batches from an indexable dataset, and a producer
thread that keeps batches loaded, and moved to the device, ahead of the
step.

Counterpart of ``cra5_tpu/data/prefetch.py``: ``batch_iterator`` yields
the same (B, C, H, W) numpy batches in the same order for the same seed
(``np.random.default_rng(seed).permutation`` each epoch), and
``PrefetchLoader`` wraps any batch iterable with a bounded queue filled by
one daemon thread, raising the producer's error on the consumer's side.
``device_put(device)`` is the device transfer to give it: the card unless
the caller asks for the CPU, through pinned memory, so the copy of the
next batch overlaps the current step.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    key: str = "inputs",
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    epochs: Optional[int] = 1,
) -> Iterator[np.ndarray]:
    """Yield (B, C, H, W) batches from an indexable dataset whose items
    are dicts with ``key`` -> (T, C, H, W); the first sequence step is
    used (codec training consumes single timesteps)."""
    n = len(dataset)
    rng = np.random.default_rng(seed)
    epoch_iter = range(epochs) if epochs is not None else itertools.count()
    for _ in epoch_iter:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, n, batch_size):
            idx = order[i : i + batch_size]
            if len(idx) < batch_size and drop_last:
                continue
            items = [dataset[int(j)] for j in idx]
            arrs = [it[key][0] if isinstance(it, dict) else np.asarray(it) for it in items]
            yield np.stack(arrs)


def device_put(device=None) -> Callable[[np.ndarray], torch.Tensor]:
    """A batch -> tensor transfer onto ``device`` (default: the card; a
    CUDA device without a card raises). On the card the batch goes through
    pinned memory and a non-blocking copy on the current stream."""
    dev = resolve_device(device)

    def put(batch) -> torch.Tensor:
        t = torch.as_tensor(np.ascontiguousarray(batch))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    return put


class PrefetchLoader:
    """Wrap any batch iterable: a producer thread keeps ``depth`` batches
    loaded (and, with ``to_device``, transferred) ahead of the consumer.
    A consumer that stops early (``Trainer.fit`` after ``num_steps``)
    releases them: when its iterator is closed or dropped, the producer
    stops at its next batch and the queued batches are freed, so no
    device batch outlives the loop that read it."""

    def __init__(
        self,
        batches: Iterable,
        depth: int = 2,
        to_device: Optional[Callable[[np.ndarray], Any]] = None,
    ):
        self.batches = batches
        self.depth = max(1, depth)
        self.to_device = to_device

    def __iter__(self):
        import queue as _queue
        import threading

        put = self.to_device or (lambda x: x)
        q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        _END = object()

        def offer(item) -> bool:
            """Queue ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except _queue.Full:
                    pass
            return False

        def producer():
            try:
                for batch in self.batches:
                    if stop.is_set() or not offer(put(batch)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                offer(("__error__", e))
            offer(_END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
                    raise item[1]
                yield item
        finally:
            stop.set()
            while True:  # free what the producer queued ahead
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
        t.join()
