"""A closed loop of client threads, each on its own CUDA stream.

Frozen from the program's bench (``pipelined_rate``: one stream a
thread, each call waiting for its own stream), extended to a timed window:
every client takes the next request number, issues the request, waits for
its stream and records the request's issue and completion times; a client
stops issuing once the window's seconds have passed, and the window ends
when the last request completes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, List, Optional

import torch


@dataclasses.dataclass
class Done:
    number: int
    client: int
    issued: float
    completed: float
    value: Any = None
    error: Optional[str] = None


class _Gate:
    """Lets one client act while no other is inside a request: the profiler
    starts and stops while no other thread launches (a start or stop under
    concurrent launches has crashed the process)."""

    def __init__(self):
        self.cond = threading.Condition()
        self.inflight, self.closed = 0, False

    def enter(self):
        with self.cond:
            while self.closed:
                self.cond.wait()
            self.inflight += 1

    def leave(self):
        with self.cond:
            self.inflight -= 1
            self.cond.notify_all()

    @contextlib.contextmanager
    def alone(self):
        with self.cond:
            self.closed = True
            while self.inflight:
                self.cond.wait()
        try:
            yield
        finally:
            with self.cond:
                self.closed = False
                self.cond.notify_all()


def run(clients: int, work: Callable[[int, int], Any], seconds: float, device,
        warm: Callable[[int], None], hook: Optional[Callable[..., None]] = None,
        midway: Optional[Callable[[], None]] = None):
    """Run ``work(client, number)`` in a closed loop for ``seconds``, after
    ``warm(client)`` on every client's own thread and stream (set-up).
    ``hook(client, "before" | "after", now, window start, alone)`` runs
    around each request on its client's thread, outside the request; within
    ``with alone():`` no other client is inside a request (the traced run
    starts and stops its profiler there). ``midway()`` runs on the calling
    thread half way through the window. Returns (window start, the
    completed requests in order of completion)."""
    gate = _Gate()
    counter = itertools.count()
    lock = threading.Lock()
    done: List[Done] = []
    ready = threading.Barrier(clients + 1)
    go = threading.Event()
    t0 = [0.0]
    warm_errors: List[str] = []

    def client(ci: int):
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        ctx = torch.cuda.stream(stream) if stream is not None else _null()
        with ctx:
            try:
                warm(ci)
                if stream is not None:
                    stream.synchronize()
            except Exception as e:
                warm_errors.append(f"client {ci} warm-up: {type(e).__name__}: {e}")
            ready.wait()
            go.wait()
            while not warm_errors:
                now = time.perf_counter()
                if now >= t0[0] + seconds:
                    break
                if hook:
                    hook(ci, "before", now, t0[0], gate.alone)
                gate.enter()
                with lock:
                    n = next(counter)
                issued = time.perf_counter()
                value, error = None, None
                try:
                    with torch.profiler.record_function("bench/request"):
                        value = work(ci, n)
                        if stream is not None:
                            stream.synchronize()
                except Exception as e:  # a failed request counts as failed
                    error = f"{type(e).__name__}: {e}"
                completed = time.perf_counter()
                gate.leave()
                with lock:
                    done.append(Done(n, ci, issued, completed, value, error))
                if hook:
                    hook(ci, "after", completed, t0[0], gate.alone)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    ready.wait()
    t0[0] = time.perf_counter()
    go.set()
    if midway:
        time.sleep(max(0.0, t0[0] + seconds / 2 - time.perf_counter()))
        midway()
    for t in threads:
        t.join()
    if warm_errors:
        raise RuntimeError("; ".join(warm_errors))
    return t0[0], done


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
