"""The codec job: closed-loop clients that each compress a timestep to
host bytes and decompress the bytes back to a field on the device.

Traffic parameters (``traffic/<mix>.json``): ``clients``; ``pool``, the
distinct seeded fields on the device; ``rate_bytes`` and
``rate_tolerance``, where the amplitude search puts field 0's ideal code
length under the reference's own entropy models; ``check_requests``, the
requests drawn from the seed whose outputs the reference judges;
``trace_at`` and ``trace_seconds``, where in the window the traced run's
profile lies.

Set-up: the benchmark's side first (``Inputs``: the seeded weights, the
entropy fit and the amplitude, all on the float32 reference, so that the
program's bytes are measured on an input the program did not choose),
then the program's (the model, its codec's tables, one roundtrip on every
client's stream). Window: requests take pool fields in a seeded order.
Check, once the window has closed and the program is freed: every sampled
request's streams decoded by the plain decoder, its symbols, rows and
reconstruction against the float32 reference (``judge.codec_numbers``).
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from reference import crx2, model as ref, tables

from .. import card, clients, fields, fit, flops, judge, params, peaks, program, trace
from ..harness import Context, Outcome
from ..seeds import rng


def _nbytes(out) -> int:
    return sum(len(s) for grp in out["strings"] for s in grp)


def _eb_params(P) -> dict:
    return {k.split(".")[-1]: v.detach().float().cpu().numpy() for k, v in P.items()
            if k.startswith("entropy_bottleneck.")}


class Inputs:
    """The benchmark's side of set-up, made before the program exists: the
    entropy side fit on the reference (``fitted``), the pool of seeded
    fields, and the amplitude (``amp``, applied to the pool) at which field
    0's ideal code length under the reference's entropy models comes
    within ``rate_tolerance`` of ``rate_bytes``."""

    def __init__(self, ctx: Context, P):
        m, job, tr, dev, seed = ctx.config["model"], ctx.config["codec"], ctx.traffic, ctx.device, ctx.seed
        t = time.perf_counter()
        self.fitted = fit.fit_entropy(P, m, seed, steps=job["fit_steps"], lr=job["fit_lr"])
        ctx.log(f"set-up: entropy fit on the reference {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        R = ref.VAEformer(m, {**P, **self.fitted})
        st = torch.from_numpy(tables.scale_table()).to(dev)
        self.pool = [fields.field(m, seed, i, dev) for i in range(tr["pool"])]
        with torch.no_grad():
            self.amp, probes = fields.production_amplitude(
                lambda a: ref.rate_bits(R, R.codec_symbols(self.pool[0] * a, st)) / 8,
                tr["rate_bytes"], tr["rate_tolerance"])
        for x in self.pool:
            x.mul_(self.amp)
        ctx.log(f"set-up: pool and amplitude {time.perf_counter() - t:.2f} s; amplitude "
                f"{self.amp:.6g} after {len(probes)} probes {probes}")


class Setup:
    """Both sides after set-up: ``Inputs``, then the program's model and
    codec holding the same weights. The device's peak counter is reset
    between the two, so ``peak_gib`` reads the program with the pool."""

    def __init__(self, ctx: Context):
        from cra5_tpu_torch.models.vaeformer import VAEformerCodec

        m, job, dev, seed = ctx.config["model"], ctx.config["codec"], ctx.device, ctx.seed
        t = time.perf_counter()
        P = params.make(m, seed, dev)
        ctx.log(f"set-up: weights {time.perf_counter() - t:.2f} s (from process start "
                f"{time.perf_counter() - ctx.t_process:.2f} s)")
        inputs = Inputs(ctx, P)
        self.fitted, self.amp, self.pool = inputs.fitted, inputs.amp, inputs.pool
        del inputs
        P.update(self.fitted)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        self.model = program.build(m, P, job["dtype"], dev, job["flash"])
        del P
        self.codec = VAEformerCodec(self.model, coder=job["coder"])
        self.codec.update(force=True)
        # one roundtrip on this thread first: a checkout's first run builds the
        # program's kernels here, not in two client threads at once
        self.roundtrip(self.pool[0])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ctx.log(f"set-up: the program's model, tables and first roundtrip "
                f"{time.perf_counter() - t:.2f} s")

    def roundtrip(self, x):
        out = self.codec.compress(x)
        return out, self.codec.decompress(out["strings"], out["z_shape"])["x_hat"]


def run(ctx: Context) -> Outcome:
    m, job, tr, dev, seed = ctx.config["model"], ctx.config["codec"], ctx.traffic, ctx.device, ctx.seed
    S = Setup(ctx)
    order = rng(seed, "arrivals").integers(0, tr["pool"], size=1 << 20)
    keep, kept, seen = tr["check_requests"], [], [0]
    pick = rng(seed, "check")
    lock = threading.Lock()

    def work(ci, n):
        idx = int(order[n])
        out, x_hat = S.roundtrip(S.pool[idx])
        with lock:  # a reservoir of ``keep`` requests, drawn from the seed
            seen[0] += 1
            j = seen[0] - 1 if len(kept) < keep else int(pick.integers(0, seen[0]))
            if j < keep:
                item = (idx, out["strings"], tuple(out["z_shape"]), x_hat)
                kept.append(item) if len(kept) < keep else kept.__setitem__(j, item)
        return _nbytes(out)

    traced = {}
    if ctx.trace:
        with torch.profiler.profile(activities=trace.activities(dev)):
            torch.zeros(1, device=dev).add_(1)  # kineto starts on the main thread
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def hook(ci, when, now, t0, alone):
        if not ctx.trace or ci != 0:
            return
        start = t0 + min(tr["trace_at"], ctx.seconds / 4)  # a short window still profiles
        if when == "before" and "prof" not in traced and now >= start:
            with alone():
                traced["prof"] = torch.profiler.profile(activities=trace.activities(dev))
                traced["prof"].__enter__()
            traced["t"] = now
        elif when == "after" and "prof" in traced and "done" not in traced \
                and now >= traced["t"] + tr["trace_seconds"]:
            with alone():
                traced["prof"].__exit__(None, None, None)
            traced["done"] = True

    ctx.log(f"before the window: {card.sample()}")
    cpu = card.cpu_s()
    t0, done = clients.run(tr["clients"], work, ctx.seconds, dev,
                           lambda ci: S.roundtrip(S.pool[ci % len(S.pool)]), hook,
                           lambda: ctx.log(f"midway: {card.sample()}"))
    setup_s = t0 - ctx.t_process
    if "prof" in traced and "done" not in traced:
        traced["prof"].__exit__(None, None, None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = max(d.completed for d in done)
    ok = [d for d in done if d.error is None]
    failed = [d for d in done if d.error is not None]
    for d in failed[:3]:
        ctx.log(f"request {d.number} failed: {d.error}")
    window_s = t_end - t0
    lat = np.array([d.completed - d.issued for d in ok])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {"timesteps_per_s": len(ok) / window_s,
               "request_p95_ms": float(np.percentile(lat, 95) * 1e3) if len(lat) else float("nan"),
               "peak_gib": peak / 2 ** 30 if dev.type == "cuda" else None,
               "bytes_per_timestep": float(np.mean([d.value for d in ok])) if ok else float("nan"),
               "setup_s": setup_s}
    ctx.log(f"window {window_s:.3f} s, {len(ok)} requests ({len(failed)} failed), {metrics}")
    ctx.log(f"after the window: {card.sample()}; the process's CPU {card.cpu_s() - cpu:.2f} s")
    run_info = {"job": "roundtrip", "timesteps": len(ok), "window_s": window_s, "batch": 1,
                "flops_per_timestep": flops.roundtrip(m), "peak_flops": peaks.FLOPS[job["dtype"]],
                "trace": trace.reduce(trace.events(traced["prof"])) if "prof" in traced else None,
                "card": peaks.card()}
    if run_info["trace"] is not None:
        ctx.log(f"trace {run_info['trace'].diagnostics}")

    # -- the check: the program's outputs, then the program freed --------
    t_check = time.perf_counter()
    eb_table = tables.factorized_table(_eb_params(S.fitted))
    gc_table = tables.gaussian_table(tables.scale_table())
    samples, faults = [], 0
    with torch.inference_mode():
        for idx, strings, z_shape, x_hat in kept:
            z_idx = np.broadcast_to(np.arange(m["z_channels"], dtype=np.int32)[:, None, None],
                                    (m["z_channels"], *z_shape))
            try:
                z_sym = crx2.decode(strings[1][0], z_idx, eb_table)
            except crx2.StreamError as e:
                ctx.log(f"z stream of pool field {idx}: {e}")
                faults += 1
                continue
            scales, _ = S.model.scales_from_z_symbols(torch.from_numpy(z_sym)[None].to(dev))
            idx_p = ref.indexes(scales.float(), torch.from_numpy(tables.scale_table()).to(dev))
            samples.append((idx, strings[0][0], z_sym, idx_p.cpu(), x_hat.cpu()))
    fitted, amp = S.fitted, S.amp
    del S, kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    P = params.make(m, seed, dev)
    P.update(fitted)
    R = ref.VAEformer(m, P)
    st = torch.from_numpy(tables.scale_table()).to(dev)
    worst = {}
    with torch.no_grad():
        for idx, y_stream, z_sym, idx_p, x_hat in samples:
            x = fields.field(m, seed, idx, dev) * amp
            r = R.codec_symbols(x, st)
            z_t = torch.from_numpy(z_sym)[None].to(dev)
            _, means_rp, idx_rp = R.hyper_from_z(z_t, st)
            try:
                y_sym = crx2.decode(y_stream, idx_p[0].numpy(), gc_table)
            except crx2.StreamError as e:
                ctx.log(f"y stream of pool field {idx}: {e}")
                faults += 1
                continue
            y_t = torch.from_numpy(y_sym)[None].to(dev)
            x_ref = R.g_s(y_t.float() + means_rp)
            nums = judge.codec_numbers(r, z_t, idx_p.to(dev), y_t, x_hat.to(dev), means_rp, idx_rp,
                                       x_ref)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
    worst["stream_faults"] = float(faults)
    if len(samples) == 0:
        worst["stream_faults"] = max(worst["stream_faults"], 1.0)
    correct, checks = judge.decide(worst, ctx.limits)
    correct = correct and not failed
    ctx.log(f"check of {len(samples)} requests in {time.perf_counter() - t_check:.1f} s: {worst}")
    return Outcome(len(done), len(failed), metrics, checks, correct, peak, run_info)
