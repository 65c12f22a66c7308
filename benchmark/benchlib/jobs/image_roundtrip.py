"""The image codec job: closed-loop clients that each compress an image
from the device to host bytes and decompress the bytes back to x_hat on
the device, through the program's TCM 2023 (``make_codec`` ->
``CharmCodec``).

Traffic parameters (``traffic/<mix>.json``): ``clients``; ``pool``, the
distinct seeded images on the device; ``height`` and ``width``, padded to
a multiple of ``pad_to``; ``bpp`` and ``rate_tolerance``, where the
contrast search puts image 0's ideal code length under the reference's
fitted models (bits over the unpadded pixels; set-up fails where the
search ends outside it); ``check_requests``;
``trace_at`` and ``trace_seconds``. Configuration (``configs/<c>.json``):
``model``, the reference's configuration keys; ``codec``: ``fit_steps``,
``fit_lr``, ``fit_crop``, ``contrast``, the fit's and the search's base.

Set-up: the program's parameter names and shapes against the
configuration's first (a program without the published parameters stops
here, in seconds); then the benchmark's side on the float32 reference
(``benchlib/tcm.py``: the seeded weights, the fit, the pool, the contrast,
every pool image's ideal length); then the program holding the same
weights, its tables, one roundtrip on set-up's thread. Window: requests
take pool images in a seeded order. Check, once the window has closed: for
every sampled request, the plain decoder (``reference/crx2.py``) reads the
z stream, then each y stream against the rows the program's slice model
gives on the slices decoded before it (the program is followed there, as
``roundtrip_c1`` follows its h_s); the program is freed; the float32
reference judges the symbols, the rows and x_hat (``judge.codec_numbers``)
on the same decoded symbols.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from reference import crx2, tables, tcm2023 as ref

from .. import card, clients, judge, peaks, tcm, tcm_count, trace
from ..fields import production_amplitude
from ..harness import Context, Outcome
from ..seeds import rng


def _nbytes(out) -> int:
    return sum(len(s) for grp in out["strings"] for s in grp)


def _eb_params(P) -> dict:
    return {k.split(".")[-1]: v.detach().float().cpu().numpy() for k, v in P.items()
            if k.startswith("entropy_bottleneck.")}


class Inputs:
    """The benchmark's side of set-up on the float32 reference: the fitted
    entropy side (``fitted``), the pool's unit fields, and the contrast
    (``contrast``) at which image 0's ideal code length comes within
    ``rate_tolerance`` of ``bpp``."""

    def __init__(self, ctx: Context, P):
        m, job, tr, dev, seed = ctx.config["model"], ctx.config["codec"], ctx.traffic, ctx.device, ctx.seed
        H, W = tr["height"], tr["width"]
        t = time.perf_counter()
        self.fitted = tcm.fit_entropy(P, m, seed, job["fit_steps"], job["fit_lr"], job["fit_crop"],
                                      contrast=job["contrast"])
        ctx.log(f"set-up: entropy fit on the reference ({job['fit_steps']} steps) "
                f"{time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        R = ref.TCM(m, {**P, **self.fitted})
        self.fields = [tcm.field(seed, i, H, W, dev) for i in range(tr["pool"])]
        target = tr["bpp"] * H * W / 8
        frame = lambda f, a: tcm.frame(f, job["contrast"] * a, tr["pad_to"])  # noqa: E731
        with torch.no_grad():
            length = lambda f, a: R.rate_bits(R.encode(frame(f, a))) / 8  # noqa: E731
            amp, probes = production_amplitude(lambda a: length(self.fields[0], a), target,
                                               tr["rate_tolerance"])
            self.contrast = job["contrast"] * amp
            lengths = [dict(probes)[amp]] + [length(f, amp) for f in self.fields[1:]]
        if abs(lengths[0] / target - 1.0) > tr["rate_tolerance"]:
            raise RuntimeError(f"the contrast search missed the traffic's rate: image 0 codes "
                               f"{lengths[0]:.0f} B at its nearest probe, the target is "
                               f"{target:.0f} B +- {tr['rate_tolerance']:.1%}; probes {probes}")
        ctx.log(f"set-up: pool and contrast {time.perf_counter() - t:.2f} s; contrast "
                f"{self.contrast:.6g} after {len(probes)} probes {probes}; ideal bytes of each "
                f"pool image {[round(b) for b in lengths]} (target {target:.0f}, spread "
                f"{(max(lengths) - min(lengths)) / np.median(lengths):.4f})")


class Setup:
    """Both sides after set-up. The device's peak counter is reset between
    the benchmark's side and the program's, so ``peak_gib`` reads the
    program with the pool."""

    def __init__(self, ctx: Context):
        from cra5_tpu_torch.models import make_codec

        m, tr, dev, seed = ctx.config["model"], ctx.traffic, ctx.device, ctx.seed
        t = time.perf_counter()
        self.model = tcm.empty_program(m, dev)
        P = tcm.make(m, seed, dev)
        ctx.log(f"set-up: the program's parameters match the configuration's; weights "
                f"{time.perf_counter() - t:.2f} s (from process start "
                f"{time.perf_counter() - ctx.t_process:.2f} s)")
        inputs = Inputs(ctx, P)
        self.fitted, self.contrast = inputs.fitted, inputs.contrast
        self.pool = [tcm.frame(f, self.contrast, tr["pad_to"]) for f in inputs.fields]
        del inputs
        P.update(self.fitted)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        tcm.fill(self.model, P)
        del P
        self.codec = make_codec(self.model)
        self.codec.update(force=True)
        self.roundtrip(self.pool[0])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ctx.log(f"set-up: the program's tables and first roundtrip "
                f"{time.perf_counter() - t:.2f} s")

    def roundtrip(self, x):
        out = self.codec.compress(x)
        return out, self.codec.decompress(out["strings"], out["shape"])["x_hat"]


@torch.inference_mode()
def follow(model, z_sym: torch.Tensor, y_streams, table: torch.Tensor, gc_table):
    """The program's slice model on the plain decoder's slices: each y
    stream decoded against the rows the program gives it. Returns the y
    symbols and the rows, a list each."""
    lm, ls = model.hyper_params_from_z(z_sym)
    syms, rows, hats = [], [], []
    for i, stream in enumerate(y_streams):
        mu, sigma, lrp_in = model.slice_entropy(lm, ls, hats, i)
        idx = ref.indexes(sigma, table)
        sym = torch.from_numpy(crx2.decode(stream, idx[0].cpu().numpy(), gc_table))[None]
        sym = sym.to(mu.device)
        y_hat = sym.float() + mu
        hats.append(y_hat + model.slice_residual(lrp_in, y_hat, i))
        syms.append(sym)
        rows.append(idx)
    return syms, rows


def numbers(R: ref.TCM, x, z_sym, y_syms, rows, x_hat, table) -> dict:
    """The codec numbers of one request: the reference's own encode of x,
    and its chain on the decoded symbols."""
    r = R.encode(x)
    lm, ls = R.hyper(z_sym)
    chain = R.slices(lm, ls, syms=y_syms)
    means = torch.cat(chain["mu"], 1)
    idx_r = ref.indexes(torch.cat(chain["sigma"], 1), table)
    x_ref = R.g_s(torch.cat(chain["y_hat"], 1))
    own = {"z": r["z"], "y": r["y"], "z_sym": r["z_sym"], "y_sym": torch.cat(r["sym"], 1)}
    return judge.codec_numbers(own, z_sym, torch.cat(rows, 1), torch.cat(y_syms, 1), x_hat, means,
                               idx_r, x_ref)


def run(ctx: Context) -> Outcome:
    m, tr, dev, seed = ctx.config["model"], ctx.traffic, ctx.device, ctx.seed
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
                item = (idx, out["strings"], tuple(out["shape"]), x_hat)
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
    ctx.log(f"window {window_s:.3f} s, {len(ok)} images ({len(failed)} failed), {metrics}")
    ctx.log(f"after the window: {card.sample()}; the process's CPU {card.cpu_s() - cpu:.2f} s")
    Hp, Wp = S.pool[0].shape[-2:]
    run_info = {"job": "image_roundtrip", "timesteps": len(ok), "window_s": window_s, "batch": 1,
                "flops_per_timestep": tcm_count.roundtrip_flops(m, Hp, Wp),
                "peak_flops": peaks.FLOPS["float32"],
                "attention_bound_s": tcm_count.attention_bound_s(m, Hp, Wp),
                "trace": trace.reduce(trace.events(traced["prof"])) if "prof" in traced else None,
                "card": peaks.card()}
    if run_info["trace"] is not None:
        ctx.log(f"trace {run_info['trace'].diagnostics}")

    # -- the check: the program followed on the decoded slices, then freed --
    t_check = time.perf_counter()
    eb_table = tables.factorized_table(_eb_params(S.fitted))
    gc_table = tables.gaussian_table(tables.scale_table())
    table = torch.from_numpy(tables.scale_table()).to(dev)
    hc = ref.cfg_of(m)["hyper_channels"]
    samples, faults = [], 0
    for idx, strings, z_shape, x_hat in kept:
        z_idx = np.broadcast_to(np.arange(hc, dtype=np.int32)[:, None, None], (hc, *z_shape))
        try:
            z_sym = torch.from_numpy(crx2.decode(strings[1][0], z_idx, eb_table))[None].to(dev)
            y_syms, rows = follow(S.model, z_sym, list(strings[0]), table, gc_table)
        except crx2.StreamError as e:
            ctx.log(f"a stream of pool image {idx}: {e}")
            faults += 1
            continue
        samples.append((idx, z_sym.cpu(), [s.cpu() for s in y_syms], [r.cpu() for r in rows],
                        x_hat.cpu()))
    fitted, contrast = S.fitted, S.contrast
    del S, kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    P = tcm.make(m, seed, dev)
    P.update(fitted)
    R = ref.TCM(m, P)
    worst = {}
    with torch.no_grad():
        for idx, z_sym, y_syms, rows, x_hat in samples:
            x = tcm.frame(tcm.field(seed, idx, tr["height"], tr["width"], dev), contrast,
                          tr["pad_to"])
            nums = numbers(R, x, z_sym.to(dev), [s.to(dev) for s in y_syms],
                           [r.to(dev) for r in rows], x_hat.to(dev), table)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
    worst["stream_faults"] = float(faults)
    if len(samples) == 0:
        worst["stream_faults"] = max(worst["stream_faults"], 1.0)
    correct, checks = judge.decide(worst, ctx.limits)
    correct = correct and not failed
    ctx.log(f"check of {len(samples)} requests in {time.perf_counter() - t_check:.1f} s: {worst}")
    return Outcome(len(done), len(failed), metrics, checks, correct, peak, run_info)
