#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cra5_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, printed as they run; any failure raises and exits non-zero, and no
result line is printed then:

  1. card: nvidia-smi's name and power limit, the device count;
  2. build: nvcc compiles the kernels from cra5_tpu_torch/csrc (one process
     per source), with each kernel's registers, shared memory and spills;
  3. kernels: each kernel against its plain PyTorch version at the 268v
     main paths' shapes (K1-K3 exact, the lane decode K2 on the z stream
     and on the y geometry written unsorted on 1024 lanes, K4-K6
     within stated bf16 tolerances), with the kernel's time, the plain
     version's, the card's bound and, for attention, the time of
     scaled_dot_product_attention (forward for K4; its backward, i.e.
     forward + backward less forward, for K5 and K6) as the library
     yardstick;
  4. reference: a tiny f32 model on the card against the same weights on
     the CPU: symbols exact and x_hat within 1e-4 through compress and
     decompress (both of whose streams take the lane decode K2), and one
     training step with the same noise, losses within 1e-4; then one global
     block of the 268v towers (N = 10368, bf16, remat): its gradients
     through FlashAttention (K4, K5, K6) against the same block on the
     plain attention path, within FLASH_GRAD_RTOL x max |ref|;
  5. codec path: the 268-variable VAEformer in bf16 at full width with
     seeded random weights compresses a (1, 268, 721, 1440) field to bytes
     and decompresses it; the launch counters are zeroed just before the
     timed roundtrip and read just after;
  6. profile: where the codec path's time goes, from the codec's own stage
     ranges: one roundtrip with every stage ending in a synchronize (host
     ms per stage), then one unsynchronised roundtrip under torch.profiler
     (device ms by kernel name, and the device's busy share of the wall);
  7. train path: Trainer.fit on the 268v VAEformer in bf16 with remat,
     seeded init, synthetic N(0, 1) x 0.5 fields: one warm-up step, then
     three timed steps with the launch counters zeroed just before and
     read just after (14 forward, 7 dQ and 7 dK/dV launches a step), then
     one step under torch.profiler.

The line before the last is a JSON object listing every kernel; the last
is {"ok": true, "device": {...}}. It needs one card and no network.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores, published
# K4 against its plain version. out is an average of N rows of v, so its
# size falls with N (about sqrt(e / N) for unit logits: ~0.016 typical and
# ~0.09 at most at N = 10368); the bound scales with the reference,
# max |out - ref| <= FLASH_OUT_RTOL * max |ref|, a few bf16 ulps of the
# largest output. lse is f32 statistics whose summation order differs.
FLASH_OUT_RTOL = 2e-2
FLASH_LSE_ATOL = 2e-3
# K5/K6: dq, dk and dv are sums over N rows of bf16-rounded products whose
# tiles the kernels add in another order than the plain versions; each is
# bounded as out is, max |got - ref| <= FLASH_GRAD_RTOL * max |ref|.
FLASH_GRAD_RTOL = 2e-2
TRAIN_STEPS = 3  # timed steps of the train path, after one warm-up step


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events around
    ``iters`` back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def sample_symbols(rng, table, idx: np.ndarray, escape_frac: float) -> np.ndarray:
    """Symbols drawn from each index's own quantized pmf, with a fraction
    pushed far out of range (escapes)."""
    sym = np.empty(idx.size, np.int64)
    for r in np.unique(idx):
        m = idx == r
        L = int(table.cdf_length[r])
        u = rng.integers(0, 1 << 16, int(m.sum()))
        bins = np.searchsorted(table.quantized_cdf[r, :L], u, side="right") - 1
        sym[m] = np.minimum(bins, L - 3) + int(table.offset[r])
    esc = rng.random(idx.size) < escape_frac
    sym[esc] += rng.integers(200, 5000, int(esc.sum())) * rng.choice([-1, 1], int(esc.sum()))
    return sym.astype(np.int32)


def phase_card() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    log(smi)  # name and power limit, as nvidia-smi gives them
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{dev['kind']} x{dev['count']}")
    return dev


def phase_build() -> None:
    from cra5_tpu_torch import kernels

    t0 = time.time()
    kernels.lib()
    log(f"[build] {time.time() - t0:.2f} s (nvcc {kernels.NVCC_FLAGS})")
    for src, report in sorted(kernels.build_info.get("ptxas", {}).items()):
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem")):
                log(f"[build] {src}: {line.strip()}")


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from cra5_tpu_torch.coder import rans_kernels as rk
    from cra5_tpu_torch.coder.lane_coder import (
        LaneCoder, _sort_by_index, merge_tiny_buckets, parse_v2_header, sorted_rows,
    )
    from cra5_tpu_torch.entropy import EntropyBottleneck, eb_update, gc_update, get_scale_table
    from cra5_tpu_torch.ops.attention import flash_attention_forward, flash_attention_plain

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    eb = EntropyBottleneck(256, device=dev)
    eb.reset_parameters(gen)
    eb_table = eb_update(eb.params_numpy())
    gc_table = gc_update(get_scale_table())
    rows = {}

    # streams at the 268v geometry: z (256, 18, 36) channel-broadcast on
    # the EB table, y (256, 72, 144) on the 64-row GC table
    z_idx = np.repeat(np.arange(256, dtype=np.int32), 18 * 36)
    z_sym = sample_symbols(rng, eb_table, z_idx, 0.01)
    y_idx = rng.integers(0, 64, 256 * 72 * 144).astype(np.int32)
    y_sym = sample_symbols(rng, gc_table, y_idx, 0.01)
    z_coder = LaneCoder(eb_table, device=dev)
    y_coder = LaneCoder(gc_table, device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)

    # K1 on both streams
    for name, coder, sym, idx in (("z", z_coder, z_sym, z_idx), ("y", y_coder, y_sym, y_idx)):
        n, K, _, starts, freqs, _, _, _ = coder.encode_grids(t(sym), t(idx))
        got = rk.rans_encode(starts, freqs)
        want = rk.rans_encode_plain(starts, freqs)
        torch.cuda.synchronize()
        same = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got[2][got[1]], want[2][want[1]]))
        if not same:
            raise RuntimeError(f"K1 rans_encode differs from its plain version on {name}")
        M = starts.shape[0]
        ms = timed_ms(lambda: rk.rans_encode(starts, freqs), 20)
        plain = timed_ms(lambda: rk.rans_encode_plain(starts, freqs), 2)
        bound = bytes_bound_ms(M * K * 11 + K * 4)
        log(f"[K1 rans_encode {name}] (M, K) = ({M}, {K}) exact; kernel {ms:.4f} ms, "
            f"plain {plain:.2f} ms, bound {bound:.4f} ms (bytes)")
        if name == "y":
            rows["rans_encode"] = dict(max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bound,
                                       bound_by="bytes", library_ms=None)

    # K2 (rans_decode_generic): decode the z stream, as the codec path does
    data = z_coder.encode(z_sym, z_idx)
    (n, K, n_esc, n_words, srt, _, _), states, words, _ = z_coder._upload(
        data, parse_v2_header(data))
    if srt or K != 256:
        raise RuntimeError(f"z stream: expected K=256 unsorted, got K={K} sorted={srt}")
    M = -(-n // K)
    idx2 = t(z_idx).reshape(M, K)
    tabs = (z_coder._max_values, z_coder._offsets)
    got = rk.rans_decode_generic(z_coder._cdf, idx2, states, words, *tabs)
    want = rk.lane_decode_plain(z_coder._cdf, idx2, states, words, *tabs)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("K2 rans_decode_generic differs from lane_decode_plain on z")
    if not np.array_equal(z_coder.decode(data, z_idx), z_sym):
        raise RuntimeError("z stream does not roundtrip")
    ms = timed_ms(lambda: rk.rans_decode_generic(z_coder._cdf, idx2, states, words, *tabs), 20)
    plain = timed_ms(lambda: rk.lane_decode_plain(z_coder._cdf, idx2, states, words, *tabs), 2)
    ncd, L = z_coder._cdf.shape
    bound = bytes_bound_ms(M * K * 4 + K * 4 + n_words * 2 + ncd * (L + 2) * 4 + M * K * 5)
    log(f"[K2 rans_decode_generic z] (M, K, L) = ({M}, {K}, {L}), {n_words} words, "
        f"{n_esc} escapes; exact; kernel {ms:.4f} ms, plain {plain:.2f} ms, "
        f"bound {bound:.4f} ms (bytes)")
    rows["rans_decode_generic"] = dict(max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bound,
                                       bound_by="bytes", library_ms=None)

    # K3: decode the sorted y stream
    data = y_coder.encode(y_sym, y_idx)
    hdr = parse_v2_header(data)
    (n, K, n_esc, n_words, srt, safe, merged), states, words, _ = y_coder._upload(data, hdr)
    if not (srt and safe and merged and K == 8192):
        raise RuntimeError(f"y stream: expected K=8192 sorted/safe/merged, got {hdr}")
    M = -(-n // K)
    sidx, _ = _sort_by_index(t(y_idx))
    sidx = merge_tiny_buckets(sidx, y_coder.num_indexes, K)
    idx2 = torch.cat([sidx, sidx[-1:].expand(M * K - n)]).reshape(M, K)
    r0, r1, split = sorted_rows(idx2)
    tabs = (y_coder._max_values, y_coder._offsets)
    args = (y_coder._cdf, r0, r1, split, states, words, *tabs)
    got = rk.rans_decode_sorted(*args)
    want = rk.rans_decode_sorted_plain(*args)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("K3 rans_decode_sorted differs from its plain version")
    if not np.array_equal(y_coder.decode(data, y_idx), y_sym):
        raise RuntimeError("y stream does not roundtrip")
    ms = timed_ms(lambda: rk.rans_decode_sorted(*args), 20)
    plain = timed_ms(lambda: rk.rans_decode_sorted_plain(*args), 2)
    ncd, L = y_coder._cdf.shape
    bound = bytes_bound_ms(M * 12 + K * 4 + n_words * 2 + ncd * (L + 2) * 4 + M * K * 5)
    log(f"[K3 rans_decode_sorted y] (M, K, L) = ({M}, {K}, {L}), {n_words} words, "
        f"{n_esc} escapes; exact; kernel {ms:.4f} ms, plain {plain:.2f} ms, "
        f"bound {bound:.4f} ms (bytes)")
    rows["rans_decode_sorted"] = dict(max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bound,
                                      bound_by="bytes", library_ms=None)

    # K2 on the y geometry written unsorted on 1024 lanes, with random GC
    # indexes (a stream the JAX package decodes with decode_scan_pallas)
    g_coder = LaneCoder(gc_table, num_lanes=1024, device=dev)
    data = g_coder.encode(y_sym, y_idx)
    (n, K, n_esc, n_words, srt, _, _), states, words, _ = g_coder._upload(
        data, parse_v2_header(data))
    if srt or K != 1024:
        raise RuntimeError(f"generic stream: expected K=1024 unsorted, got K={K} sorted={srt}")
    M = -(-n // K)
    idx2 = t(y_idx).reshape(M, K)
    tabs = (g_coder._max_values, g_coder._offsets)
    got = rk.rans_decode_generic(g_coder._cdf, idx2, states, words, *tabs)
    want = rk.lane_decode_plain(g_coder._cdf, idx2, states, words, *tabs)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("K2 rans_decode_generic differs from lane_decode_plain on y")
    if not np.array_equal(g_coder.decode(data, y_idx), y_sym):
        raise RuntimeError("the unsorted y stream does not roundtrip")
    ms = timed_ms(lambda: rk.rans_decode_generic(g_coder._cdf, idx2, states, words, *tabs), 10)
    plain = timed_ms(lambda: rk.lane_decode_plain(g_coder._cdf, idx2, states, words, *tabs),
                     1, warmup=0)
    ncd, L = g_coder._cdf.shape
    bound = bytes_bound_ms(M * K * 4 + K * 4 + n_words * 2 + ncd * (L + 2) * 4 + M * K * 5)
    log(f"[K2 rans_decode_generic y unsorted] (M, K, L) = ({M}, {K}, {L}), {n_words} "
        f"words, {n_esc} escapes; exact; kernel {ms:.4f} ms, plain {plain:.2f} ms, "
        f"bound {bound:.4f} ms (bytes)")
    del g_coder, idx2, states, words, got, want

    # K4 at the global blocks' shape, and at a ragged N
    for B, H, N in ((1, 2, 1000), (1, 16, 10368)):
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        scale = 64 ** -0.5
        out, lse = flash_attention_forward(q, k, v, scale)
        ref, ref_lse = flash_attention_plain(q, k, v, scale)
        err = (out.float() - ref.float()).abs().max().item()
        out_tol = FLASH_OUT_RTOL * ref.float().abs().max().item()
        lerr = (lse - ref_lse).abs().max().item()
        if not (err <= out_tol and lerr <= FLASH_LSE_ATOL and torch.isfinite(out).all()):
            raise RuntimeError(f"K4 flash_attn_fwd at N={N}: out err {err} (bound {out_tol}), "
                               f"lse err {lerr}")
        ms = timed_ms(lambda: flash_attention_forward(q, k, v, scale), 10)
        plain = timed_ms(lambda: flash_attention_plain(q, k, v, scale), 2)
        lib = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale), 10)
        flops = 4 * B * H * N * N * 64
        bound = max(flops / BF16_FLOPS * 1e3, bytes_bound_ms(4 * B * H * N * 64 * 2 + B * H * N * 4))
        log(f"[K4 flash_attn_fwd] (B, H, N, D) = ({B}, {H}, {N}, 64): out err {err:.3g} "
            f"(bound {out_tol:.3g} = {FLASH_OUT_RTOL} x max|ref|), lse err {lerr:.3g} "
            f"(atol {FLASH_LSE_ATOL}); "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.2f} ms, "
            f"sdpa {lib:.4f} ms, bound {bound:.4f} ms (operations)")
        del q, k, v, out, lse, ref, ref_lse
    rows["flash_attn_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                                  bound_by="operations", library_ms=lib)
    torch.cuda.empty_cache()
    rows.update(flash_backward_rows(rng, dev))
    return rows


def flash_backward_rows(rng, dev) -> dict:
    """K5 and K6 against their plain versions, at a ragged N and at the
    global blocks' shape."""
    from cra5_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_forward,
    )

    rows = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, H, N in ((1, 2, 1000), (1, 16, 10368)):
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32))
                       .to(dev, torch.bfloat16) for _ in range(4))
        scale = 64 ** -0.5
        out, lse = flash_attention_forward(q, k, v, scale)
        delta = (do.float() * out.float()).sum(-1)
        ops = (q, k, v, do, lse, delta, scale)
        errs = {}
        dq = flash_attention_backward_dq(*ops)
        ref = flash_attention_backward_dq_plain(*ops)
        errs["dq"] = ((dq.float() - ref.float()).abs().max().item(),
                      FLASH_GRAD_RTOL * ref.float().abs().max().item())
        finite = bool(torch.isfinite(dq).all())
        del dq, ref
        dk, dv = flash_attention_backward_dkv(*ops)
        ref_dk, ref_dv = flash_attention_backward_dkv_plain(*ops)
        for name, a, b in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            errs[name] = ((a.float() - b.float()).abs().max().item(),
                          FLASH_GRAD_RTOL * b.float().abs().max().item())
        finite = finite and bool(torch.isfinite(dk).all() and torch.isfinite(dv).all())
        del dk, dv, ref_dk, ref_dv
        bad = {n: e for n, e in errs.items() if not e[0] <= e[1]}
        if bad or not finite:
            raise RuntimeError(f"K5/K6 at N={N}: (err, bound) {errs}, finite {finite}")
        ms_dq = timed_ms(lambda: flash_attention_backward_dq(*ops), 10)
        ms_dkv = timed_ms(lambda: flash_attention_backward_dkv(*ops), 10)
        plain_dq = timed_ms(lambda: flash_attention_backward_dq_plain(*ops), 1)
        plain_dkv = timed_ms(lambda: flash_attention_backward_dkv_plain(*ops), 1)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        fwd_ms = timed_ms(lambda: sdpa(qg, kg, vg, scale=scale), 10)
        both_ms = timed_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, scale=scale), (qg, kg, vg), do), 10)
        lib = both_ms - fwd_ms
        io = B * H * N * 64 * 2
        bound_dq = max(6 * B * H * N * N * 64 / BF16_FLOPS * 1e3,
                       bytes_bound_ms(5 * io + 2 * B * H * N * 4))
        bound_dkv = max(8 * B * H * N * N * 64 / BF16_FLOPS * 1e3,
                        bytes_bound_ms(6 * io + 2 * B * H * N * 4))
        log(f"[K5/K6 flash_attn_bwd] (B, H, N, D) = ({B}, {H}, {N}, 64): (err, bound "
            f"{FLASH_GRAD_RTOL} x max|ref|) " + ", ".join(
                f"{n} ({e:.3g}, {b:.3g})" for n, (e, b) in errs.items())
            + f"; dQ kernel {ms_dq:.4f} ms, plain {plain_dq:.2f} ms, bound {bound_dq:.4f} ms; "
            f"dK/dV kernel {ms_dkv:.4f} ms, plain {plain_dkv:.2f} ms, bound {bound_dkv:.4f} ms "
            f"(operations); sdpa backward (fwd+bwd {both_ms:.4f} less fwd {fwd_ms:.4f}) "
            f"{lib:.4f} ms")
        rows["flash_attn_bwd_dq"] = dict(max_abs_err=errs["dq"][0], ms=ms_dq, plain_ms=plain_dq,
                                         bound_ms=bound_dq, bound_by="operations",
                                         library_ms=lib)
        rows["flash_attn_bwd_dkv"] = dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                                          ms=ms_dkv, plain_ms=plain_dkv, bound_ms=bound_dkv,
                                          bound_by="operations", library_ms=lib)
        del q, k, v, do, out, lse, delta, ops, qg, kg, vg
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def shared_noise():
    """The entropy side's training noise drawn on the CPU from a generator
    seeded by the tensor's shape, so the card and the CPU add the same."""
    from cra5_tpu_torch.entropy import entropy_bottleneck as ebm
    from cra5_tpu_torch.entropy import gaussian_conditional as gcm
    from cra5_tpu_torch.entropy import ops

    def quantize(inputs, mode, means=None, generator=None):
        if mode != "noise":
            return ops.quantize(inputs, mode, means=means, generator=generator)
        g = torch.Generator().manual_seed(int(np.prod(inputs.shape)))
        noise = torch.rand(tuple(inputs.shape), generator=g) - 0.5
        return inputs + noise.to(inputs.device, inputs.dtype)

    saved = ebm.quantize, gcm.quantize
    ebm.quantize = gcm.quantize = quantize
    try:
        yield
    finally:
        ebm.quantize, gcm.quantize = saved


def phase_reference(dev) -> dict:
    """The tiny f32 model on the card against the same weights on the CPU:
    the codec roundtrip (both streams take the lane decode K2, whose
    launches are counted over the card's decompress) and one train step;
    then the 268v global block's gradients through the flash kernels."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny
    from cra5_tpu_torch.train import TrainerConfig, TrainState, ema_init
    from cra5_tpu_torch.train import make_net_aux_optimizers, make_train_step

    cfg = vaeformer_tiny()
    gpu = VAEformer(cfg, device=dev).reset_parameters(SEED)
    cpu = VAEformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    x = np.random.default_rng(SEED).standard_normal((1, cfg.in_chans, *cfg.img_size), np.float32)
    with torch.inference_mode():
        a = gpu.encode_symbols(torch.from_numpy(x).to(dev))
        b = cpu.encode_symbols(torch.from_numpy(x))
    for key in ("z_sym", "y_sym"):
        if not torch.equal(a[key].cpu(), b[key]):
            raise RuntimeError(f"tiny model: {key} differs between the card and the CPU")
    codec_gpu, codec_cpu = VAEformerCodec(gpu), VAEformerCodec(cpu)
    out = codec_gpu.compress(x)
    if out["strings"] != codec_cpu.compress(x)["strings"]:
        raise RuntimeError("tiny codec: the card's streams differ from the CPU's")
    kernels.reset_launch_counts()
    xa = codec_gpu.decompress(out["strings"], out["z_shape"])["x_hat"]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    xb = codec_cpu.decompress(out["strings"], out["z_shape"])["x_hat"]
    err = (xa.cpu() - xb).abs().max().item()
    if launches["rans_decode_generic"] != 2 or not err <= 1e-4:
        raise RuntimeError(f"tiny codec decompress on the card: x_hat err {err}, "
                           f"launches {launches}")
    log(f"[reference] vaeformer_tiny f32: symbols and streams equal on card and CPU; the card "
        f"decompresses (lane decode K2 launched {launches['rans_decode_generic']}x), "
        f"x_hat err {err:.3g}")

    metrics = {}
    tcfg = TrainerConfig(learning_rate=1e-3, use_ema=True)
    with shared_noise():
        for name, model in (("card", gpu), ("cpu", cpu)):
            tx = make_net_aux_optimizers(tcfg.learning_rate, tcfg.aux_learning_rate,
                                         tcfg.max_grad_norm)
            params = dict(model.named_parameters())
            state = TrainState(step=0, params=params, opt_state=tx.init(params),
                               ema=ema_init(params))
            batch = torch.from_numpy(x).to(model.device)
            _, m = make_train_step(model, tx, tcfg)(state, batch, SEED)
            metrics[name] = {k: float(v) for k, v in m.items()}
    bad = {k: (v, metrics["cpu"][k]) for k, v in metrics["card"].items()
           if not abs(v - metrics["cpu"][k]) <= 1e-4 * max(1.0, abs(metrics["cpu"][k]))}
    if bad:
        raise RuntimeError(f"tiny train step: card and CPU losses differ: {bad}")
    log(f"[reference] vaeformer_tiny f32 train step, same weights and noise: card "
        f"{metrics['card']} vs CPU {metrics['cpu']} (within 1e-4)")
    global_block_grads(dev)
    return launches


def global_block_grads(dev) -> None:
    """One global block of the 268v towers (width 1024, 16 heads, N =
    72 x 144 tokens) in bf16 under remat, as the train path runs it: the
    gradients of its input, qkv and proj through FlashAttention (K4 twice,
    K5, K6) against the same block, weights and inputs with attention on
    the plain path, each within FLASH_GRAD_RTOL x max |ref|."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models.vaeformer import vaeformer_268
    from cra5_tpu_torch.nn import blocks
    from cra5_tpu_torch.nn.vit import _run_block

    cfg = vaeformer_268()
    Hp, Wp = cfg.latent_grid
    gen = torch.Generator(device=dev).manual_seed(SEED)
    blk = blocks.Block(cfg.y_channels, cfg.num_heads, layer_id=cfg.interval - 1,
                       dtype=torch.bfloat16, device=dev)
    for m in blk.modules():
        if m is not blk and hasattr(m, "reset_parameters") and not isinstance(m, torch.nn.Linear):
            m.reset_parameters(gen)
    x = torch.randn((1, Hp * Wp, cfg.y_channels), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(x.shape, generator=gen, device=dev)
    watch = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight")
    grads = {}
    use_flash = blocks._use_flash
    for route in ("flash", "plain"):
        if route == "plain":
            blocks._use_flash = lambda *a: False
        try:
            kernels.reset_launch_counts()
            blk.zero_grad(set_to_none=True)
            xg = x.clone().requires_grad_()
            (_run_block(blk, xg, Hp, Wp, remat=True).float() * w).sum().backward()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            blocks._use_flash = use_flash
        params = dict(blk.named_parameters())
        grads[route] = {"x": xg.grad, **{k: params[k].grad.clone() for k in watch}}
        want = (2, 1, 1) if route == "flash" else (0, 0, 0)
        got = tuple(launches[k] for k in ("flash_attention_forward", "flash_attention_backward_dq",
                                          "flash_attention_backward_dkv"))
        if got != want:
            raise RuntimeError(f"global block, {route} route: flash launches {got}, expected {want}")
        del xg
        torch.cuda.empty_cache()
    errs = {k: ((grads["flash"][k].float() - ref.float()).abs().max().item(),
                FLASH_GRAD_RTOL * ref.float().abs().max().item())
            for k, ref in grads["plain"].items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads["flash"].values())
    if not finite or any(not e <= b for e, b in errs.values()):
        raise RuntimeError(f"global block gradients, flash vs plain: (err, bound) {errs}, "
                           f"finite {finite}")
    log(f"[reference] 268v global block (1, {Hp * Wp}, {cfg.y_channels}) bf16 remat, gradients "
        f"through FlashAttention vs the plain path, (err, bound {FLASH_GRAD_RTOL} x max|ref|): "
        + ", ".join(f"{k} ({e:.3g}, {b:.3g})" for k, (e, b) in errs.items()))
    del blk, grads, x, w
    torch.cuda.empty_cache()


def phase_main_path(dev) -> dict:
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268

    cfg = vaeformer_268()
    t0 = time.time()
    model = VAEformer(cfg, dtype=torch.bfloat16, device=dev).reset_parameters(SEED)
    x = np.random.default_rng(SEED).standard_normal((1, cfg.in_chans, *cfg.img_size), np.float32)
    codec = VAEformerCodec(model)
    codec.update()
    torch.cuda.synchronize()
    log(f"[main] vaeformer_268 bf16, {sum(p.numel() for p in model.parameters())} params, "
        f"seeded init + tables {time.time() - t0:.2f} s")

    out = codec.compress(x)  # warm-up roundtrip
    codec.decompress(out["strings"], out["z_shape"])
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    out = codec.compress(x)
    torch.cuda.synchronize()
    t1 = time.time()
    x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    torch.cuda.synchronize()
    t2 = time.time()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    want = {k: 0 for k in launches}
    want.update(rans_encode=2, rans_decode_generic=1, rans_decode_sorted=1,
                flash_attention_forward=7)
    if launches != want:
        raise RuntimeError(f"launch counts {launches}, expected {want}")
    y_str, z_str = out["strings"][0][0], out["strings"][1][0]
    zh, yh = parse_v2_header(z_str), parse_v2_header(y_str)
    if zh[1] != 256 or zh[4]:
        raise RuntimeError(f"z header {zh}: expected K=256, unsorted")
    if yh[1] != 8192 or not (yh[4] and yh[5] and yh[6]):
        raise RuntimeError(f"y header {yh}: expected K=8192 with bits 31/30/29")
    if tuple(x_hat.shape) != (1, cfg.in_chans, *cfg.img_size) or not torch.isfinite(x_hat).all():
        raise RuntimeError(f"x_hat {tuple(x_hat.shape)} is not a finite full-size field")

    # the decoded symbols equal the encoded ones (outside the timed run)
    with torch.inference_mode():
        enc = model.encode_symbols(torch.from_numpy(x).to(dev))
        z_dec = codec._eb_coder.decode_batch_to_device(
            [z_str], codec._z_indexes(enc["z_sym"].shape).to(dev))
        scales, _ = model.scales_from_z_symbols(z_dec)
        y_dec = codec._gc_coder.decode_batch_to_device([y_str], codec._gc_indexes(scales))
    if not (torch.equal(z_dec, enc["z_sym"]) and torch.equal(y_dec, enc["y_sym"])):
        raise RuntimeError("decoded z/y symbols differ from the encoded ones")

    res = dict(roundtrip_s=t2 - t0, encode_s=t1 - t0, decode_s=t2 - t1,
               y_bytes=len(y_str), z_bytes=len(z_str), y_escapes=yh[2],
               peak_bytes=peak, launches=launches)
    log(f"[main] compress {t1 - t0:.4f} s, decompress {t2 - t1:.4f} s, roundtrip "
        f"{t2 - t0:.4f} s; y {len(y_str)} B ({yh[2]} escapes of {yh[0]}), z {len(z_str)} B; "
        f"peak {peak / 2**30:.2f} GiB; symbols roundtrip exactly")
    log(f"[main] launches per roundtrip {launches}")
    return res, codec, x


def phase_profile(codec, x) -> None:
    """Stage split and device-time breakdown of the main path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    codec.stage_times = {}
    out = codec.compress(x)
    codec.decompress(out["strings"], out["z_shape"])
    stages, codec.stage_times = codec.stage_times, None
    for name, sec in stages.items():
        log(f"[stage] {name:24s} {sec * 1e3:10.3f} ms")
    log(f"[stage] sum {sum(stages.values()) * 1e3:.3f} ms (each stage ends in a synchronize)")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = codec.compress(x)
        codec.decompress(out["strings"], out["z_shape"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_profile(prof, wall, "profile")
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in dev_events:  # the codec's stage ranges on the device timeline
        if e.is_user_annotation:
            log(f"[profile] stage {e.name:24s} device span "
                f"{(e.time_range.end - e.time_range.start) * 1e-3:10.3f} ms")


def device_profile(prof, wall: float, tag: str, top: int = 20) -> None:
    """Device busy time (union of kernel and copy intervals), its share
    of ``wall``, and device ms by kernel name."""
    from torch.autograd import DeviceType

    acts = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy, cur_s, cur_e = 0.0, None, None  # union of device intervals, us
    for s, e in sorted((a.time_range.start, a.time_range.end) for a in acts):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + (0.0 if cur_e is None else cur_e - cur_s)) * 1e-6
    by_name = defaultdict(lambda: [0.0, 0])
    for a in acts:
        by_name[a.name][0] += (a.time_range.end - a.time_range.start) * 1e-3
        by_name[a.name][1] += 1
    log(f"[{tag}] wall {wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
        f"({len(acts)} device activities), busy share {busy / wall}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[{tag}] {ms:10.3f} ms {n:5d}x  {name[:100]}")


def phase_train(dev) -> dict:
    """Trainer.fit on the full-width 268v VAEformer, bf16, remat."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_268
    from cra5_tpu_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    t0 = time.time()
    model = VAEformer(cfg, dtype=torch.bfloat16, device=dev)
    trainer = Trainer(model, TrainerConfig(log_every=1, ckpt_every=10**9), seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fields = [torch.randn((1, cfg.in_chans, *cfg.img_size), generator=gen, device=dev) * 0.5
              for _ in range(TRAIN_STEPS + 2)]
    torch.cuda.synchronize()
    log(f"[train] vaeformer_268 bf16 remat, {sum(p.numel() for p in model.parameters())} "
        f"float32 params; model and {len(fields)} fields {time.time() - t0:.2f} s")

    t0 = time.time()
    state = trainer.fit(fields[:1], num_steps=1, log_fn=lambda *a: None)  # init + warm-up
    torch.cuda.synchronize()
    log(f"[train] init_state + warm-up step {time.time() - t0:.2f} s")
    first_global = next(i for i, b in enumerate(model.g_a.blocks) if b.window_size is None)
    watch = (f"g_a.blocks.{first_global}.attn.qkv.weight", "quant_conv.weight",
             "entropy_bottleneck.quantiles")
    before = {k: state.params[k].detach().clone() for k in watch}

    stamps, metrics = [], []

    def log_fn(step, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append(m)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    stamps.append(time.perf_counter())
    state = trainer.fit(fields[1:1 + TRAIN_STEPS], state=state, num_steps=TRAIN_STEPS,
                        log_fn=log_fn)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    for i, (sec, m) in enumerate(zip(steps_s, metrics)):
        log(f"[train] step {state.step - TRAIN_STEPS + i + 1}: {sec:.4f} s; loss "
            f"{m['loss']:.6g} bpp {m['bpp_loss']:.6g} mse {m['mse_loss']:.6g} "
            f"aux {m['aux_loss']:.6g} total {m['total_loss']:.6g}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise RuntimeError(f"train metrics are not all finite: {metrics}")
    per_step = {"flash_attention_forward": 14, "flash_attention_backward_dq": 7,
                "flash_attention_backward_dkv": 7}
    want = {k: v * TRAIN_STEPS if k in per_step else 0 for k, v in launches.items()}
    want.update({k: v * TRAIN_STEPS for k, v in per_step.items()})
    if launches != want:
        raise RuntimeError(f"train launches over {TRAIN_STEPS} steps {launches}, expected {want}")
    moved = {k: (state.params[k].detach() - before[k]).abs().max().item() for k in watch}
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"parameters did not move: {moved}")
    median = statistics.median(steps_s)
    log(f"[train] median step {median:.4f} s over {TRAIN_STEPS} (host clock ending in a "
        f"synchronize); peak {peak / 2**30:.2f} GiB; launches {launches}; max |change| {moved}")
    fields_b = sum(f.numel() * f.element_size() for f in fields)
    log(f"[train] resident before the timed steps {resident / 2**30:.2f} GiB: float32 params, "
        f"two Adam moments and the EMA {4 * n_params * 4 / 2**30:.2f} GiB, {len(fields)} input "
        f"fields {fields_b / 2**30:.2f} GiB; a step's own peak above that "
        f"{(peak - resident) / 2**30:.2f} GiB (activations, grads, optimizer temporaries)")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = trainer.fit(fields[-1:], state=state, num_steps=1, log_fn=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_profile(prof, wall, "train profile", top=25)
    return dict(median_step_s=median, peak_bytes=peak, launches=launches)


def main() -> int:
    device = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from cra5_tpu_torch.device import resolve_device

    resolve_device(dev)  # TF32 off
    phase_build()
    rows = phase_kernels(dev)
    ref_launches = phase_reference(dev)
    main_res, codec, x = phase_main_path(dev)
    phase_profile(codec, x)
    del codec, x
    torch.cuda.empty_cache()
    train_res = phase_train(dev)

    # every launch of the paths' own runs: the codec roundtrip, the tiny
    # codec's decompress on the card, and the three timed train steps.
    # K2 (rans_decode_generic) replaces both decode_scan_pallas (:705) and
    # decode_rowplan_pallas (:368); its entry names the former.
    paths = (main_res["launches"], ref_launches, train_res["launches"])
    sources = {
        "rans_encode": ("rans_encode", "cra5_tpu_torch/csrc/rans_encode.cu",
                        "cra5_tpu/coder/rans_pallas.py:212"),
        "rans_decode_sorted": ("rans_decode_sorted", "cra5_tpu_torch/csrc/rans_decode.cu",
                               "cra5_tpu/coder/rans_pallas.py:569"),
        "rans_decode_generic": ("rans_decode_generic", "cra5_tpu_torch/csrc/rans_decode.cu",
                                "cra5_tpu/coder/rans_pallas.py:705"),
        "flash_attn_fwd": ("flash_attention_forward", "cra5_tpu_torch/csrc/flash_attn_fwd.cu",
                           "cra5_tpu/ops/attention.py:102"),
        "flash_attn_bwd_dq": ("flash_attention_backward_dq",
                              "cra5_tpu_torch/csrc/flash_attn_bwd.cu",
                              "cra5_tpu/ops/attention.py:140"),
        "flash_attn_bwd_dkv": ("flash_attention_backward_dkv",
                               "cra5_tpu_torch/csrc/flash_attn_bwd.cu",
                               "cra5_tpu/ops/attention.py:189"),
    }
    kernels_line = []
    for name, (counter, src, replaces) in sources.items():
        launches = sum(p[counter] for p in paths)
        if launches == 0:
            raise RuntimeError(f"{name} was not launched on any path")
        kernels_line.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                                 launches=launches, **rows[name]))
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
