#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cra5_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, printed as they run; any failure raises and exits non-zero, and no
result line is printed then:

  1. card: nvidia-smi's name and power limit, the device count;
  2. build: g++ compiles the v1 host coder (coder/csrc/rans64.cpp), nvcc
     the kernels from cra5_tpu_torch/csrc (one process per source), with
     each kernel's registers, shared memory and spills;
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
     one step under torch.profiler;
  8. probe path: cra5_tpu_torch.profiling.perm_probe.main on the card (the
     torch sort/take/scatter probes at 2.65 M elements, K7 and K8), the
     counters zeroed just before and read just after;
  9. API path: cra5_api(model_version=268) in float32 with seeded weights
     writes a synthetic timestep to a .bin with coder="v2" and again with
     coder="v1" (encode_era5_as_bin) and reads each back (decode_from_bin),
     the counters zeroed just before and read just after (float32 K4 seven
     times a roundtrip, K1-K3 for the v2 file); every z and y symbol
     decodes exactly from both files, both give the same z symbols, and
     x_hat is a finite full-size field.

The kernels phase also holds K4-K6 on float32 operands (the SIMT entries)
at the global blocks' shape against the float32 plain versions, within
FLASH_F32_RTOL x max |ref|, with SDPA in float32 as the yardstick, and K7
(perm_expand) and K8 (perm_dynroll) at (8, 1024) against their plain
versions exactly; the reference phase adds the 268v global block in
float32. The line before the last is a JSON object listing every kernel;
the last is {"ok": true, "device": {...}}. It needs one card and no
network.
"""

from __future__ import annotations

import contextlib
import json
import re
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
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
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
# K4-K6 on float32 operands against the float32 plain versions: the same
# rounding points, float32 sums in another order. The plain versions sum
# in cuBLAS's blocked order (within 1.3e-6 x max |ref| of float64 at N =
# 10368 on the CPU); the kernels carry one running float32 sum over the N
# keys or queries, about 5e-6 x max |ref| from the plain versions at
# (1, 16, 10368, 64) on an H100. Bound: out, dq, dk, dv within
# FLASH_F32_RTOL x max |ref|, lse within FLASH_F32_LSE_ATOL.
FLASH_F32_RTOL = 1e-5
FLASH_F32_LSE_ATOL = 1e-5
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
    from cra5_tpu_torch.coder import native

    t0 = time.time()
    native.lib()  # the v1 host coder, g++
    t1 = time.time()
    kernels.lib()
    log(f"[build] v1 host coder {t1 - t0:.2f} s (g++ {native.GXX_FLAGS}); kernels "
        f"{time.time() - t1:.2f} s (nvcc {kernels.NVCC_FLAGS})")
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
    flash_f32_rows(rng, dev)
    rows.update(perm_rows(rng, dev))
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


def flash_f32_rows(rng, dev) -> None:
    """K4, K5 and K6 on float32 operands (the SIMT entries) at the global
    blocks' shape against the float32 plain versions, with SDPA in float32
    (forward; backward as forward + backward less forward) as the
    yardstick. The bound is FP32 operations at 67 TFLOP/s."""
    from cra5_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_forward,
        flash_attention_plain,
    )

    B, H, N, scale = 1, 16, 10368, 64 ** -0.5
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32)).to(dev)
                   for _ in range(4))
    out, lse = flash_attention_forward(q, k, v, scale)
    ref, ref_lse = flash_attention_plain(q, k, v, scale)
    delta = (do * out).sum(-1)
    ops = (q, k, v, do, lse, delta, scale)
    got = {"out": (out, ref), "dq": (flash_attention_backward_dq(*ops),
                                     flash_attention_backward_dq_plain(*ops))}
    got.update(zip(("dk", "dv"), zip(flash_attention_backward_dkv(*ops),
                                     flash_attention_backward_dkv_plain(*ops))))
    torch.cuda.synchronize()
    errs = {n: ((a - b).abs().max().item(), FLASH_F32_RTOL * b.abs().max().item())
            for n, (a, b) in got.items()}
    lerr = (lse - ref_lse).abs().max().item()
    finite = all(bool(torch.isfinite(a).all()) for a, _ in got.values())
    if not finite or lerr > FLASH_F32_LSE_ATOL or any(e > b for e, b in errs.values()):
        raise RuntimeError(f"float32 K4-K6 at N={N}: (err, bound) {errs}, lse err {lerr}, "
                           f"finite {finite}")
    del got
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = {"fwd": timed_ms(lambda: flash_attention_forward(q, k, v, scale), 5),
          "dq": timed_ms(lambda: flash_attention_backward_dq(*ops), 3),
          "dkv": timed_ms(lambda: flash_attention_backward_dkv(*ops), 3)}
    plain = {"fwd": timed_ms(lambda: flash_attention_plain(q, k, v, scale), 1),
             "dq": timed_ms(lambda: flash_attention_backward_dq_plain(*ops), 1),
             "dkv": timed_ms(lambda: flash_attention_backward_dkv_plain(*ops), 1)}
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    lib_fwd = timed_ms(lambda: sdpa(qg, kg, vg, scale=scale), 5)
    lib_both = timed_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg, scale=scale),
                                                    (qg, kg, vg), do), 3)
    flops = {"fwd": 4 * B * H * N * N * 64, "dq": 6 * B * H * N * N * 64,
             "dkv": 8 * B * H * N * N * 64}
    log(f"[K4-K6 float32] (B, H, N, D) = ({B}, {H}, {N}, 64): (err, bound {FLASH_F32_RTOL} x "
        f"max|ref|) " + ", ".join(f"{n} ({e:.3g}, {b:.3g})" for n, (e, b) in errs.items())
        + f", lse err {lerr:.3g} (atol {FLASH_F32_LSE_ATOL})")
    for name, lib in (("fwd", lib_fwd), ("dq", lib_both - lib_fwd), ("dkv", lib_both - lib_fwd)):
        bound = flops[name] / FP32_FLOPS * 1e3
        log(f"[K4-K6 float32 {name}] kernel {ms[name]:.4f} ms "
            f"({flops[name] / ms[name] / 1e9:.2f} TFLOP/s), plain {plain[name]:.2f} ms, "
            f"bound {bound:.4f} ms (operations, FP32), sdpa float32 {lib:.4f} ms")
    del q, k, v, do, out, lse, ref, ref_lse, delta, ops, qg, kg, vg
    torch.cuda.empty_cache()


def perm_rows(rng, dev) -> dict:
    """K7 (expand) and K8 (dynroll) at the probe's (8, 1024) against their
    plain versions, exactly: K7 at mask densities 0, 0.6 and 1, K8 at
    shifts 0, 3 and 1023. Both are launch-bound; the bound is the bytes of
    their operands."""
    from cra5_tpu_torch.profiling import perm_probe as pp

    t = lambda a: torch.from_numpy(a).to(dev)
    shape = (pp.R, pp.KD)
    words = t(rng.integers(0, 1 << 16, shape).astype(np.int32))
    for density in (0.0, 1.0, 0.6):
        mask = t((rng.random(shape) < density).astype(np.int32))
        got, want = pp.expand(mask, words), pp.expand_plain(mask, words)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"K7 expand differs from its plain version at density {density}")
    ms = timed_ms(lambda: pp.expand(mask, words), 200, warmup=10)
    plain = timed_ms(lambda: pp.expand_plain(mask, words), 20)
    bound = bytes_bound_ms(3 * words.numel() * 4)
    log(f"[K7 perm_expand] {shape} exact at densities 0, 1, 0.6; kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {bound:.6f} ms (bytes)")
    rows = {"perm_expand": dict(max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by="bytes", library_ms=None)}
    for shift in (0, 3, 1023):
        s = torch.tensor([shift], dtype=torch.int32, device=dev)
        got = pp.dynroll(words, s)
        if not (torch.equal(got, pp.dynroll_plain(words, s))
                and torch.equal(got, torch.roll(words, shift, 1))):
            raise RuntimeError(f"K8 dynroll differs from its plain version at shift {shift}")
    s = torch.tensor([3], dtype=torch.int32, device=dev)
    ms = timed_ms(lambda: pp.dynroll(words, s), 200, warmup=10)
    plain = timed_ms(lambda: pp.dynroll_plain(words, s), 50, warmup=5)
    lib = timed_ms(lambda: torch.roll(words, 3, 1), 200, warmup=10)
    bound = bytes_bound_ms(2 * words.numel() * 4 + 4)
    log(f"[K8 perm_dynroll] {shape} exact at shifts 0, 3, 1023; kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms (reads the shift to the host), torch.roll {lib:.4f} ms, "
        f"bound {bound:.6f} ms (bytes)")
    rows["perm_dynroll"] = dict(max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by="bytes", library_ms=lib)
    # a launch-bound kernel's event time above is the wrapper's launch rate;
    # the profiler gives the device's own time per launch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            pp.expand(mask, words)
            pp.dynroll(words, s)
        torch.cuda.synchronize()
    dev_us = defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "perm_" in e.name:
            dev_us[re.search(r"perm_\w+", e.name).group(0)].append(
                e.time_range.end - e.time_range.start)
    log("[K7/K8 device] " + ", ".join(f"{n} {statistics.median(v):.2f} us median of {len(v)}"
                                        for n, v in sorted(dev_us.items())))
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
    global_block_grads(dev, torch.bfloat16, FLASH_GRAD_RTOL)
    global_block_grads(dev, torch.float32, FLASH_F32_RTOL)
    return launches


def global_block_grads(dev, dtype, rtol) -> None:
    """One global block of the 268v towers (width 1024, 16 heads, N =
    72 x 144 tokens) under remat, as the train path runs it, in ``dtype``
    (bf16 as the train path; float32 as VAEformer's and cra5_api's
    default): the gradients of its input, qkv and proj through
    FlashAttention (K4 twice, K5, K6) against the same block, weights and
    inputs with attention on the plain path, each within rtol x max |ref|."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models.vaeformer import vaeformer_268
    from cra5_tpu_torch.nn import blocks
    from cra5_tpu_torch.nn.vit import _run_block

    cfg = vaeformer_268()
    Hp, Wp = cfg.latent_grid
    gen = torch.Generator(device=dev).manual_seed(SEED)
    blk = blocks.Block(cfg.y_channels, cfg.num_heads, layer_id=cfg.interval - 1,
                       dtype=dtype, device=dev)
    for m in blk.modules():
        if m is not blk and hasattr(m, "reset_parameters") and not isinstance(m, torch.nn.Linear):
            m.reset_parameters(gen)
    x = torch.randn((1, Hp * Wp, cfg.y_channels), generator=gen, device=dev).to(dtype)
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
                rtol * ref.float().abs().max().item())
            for k, ref in grads["plain"].items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads["flash"].values())
    if not finite or any(not e <= b for e, b in errs.values()):
        raise RuntimeError(f"global block gradients, flash vs plain: (err, bound) {errs}, "
                           f"finite {finite}")
    log(f"[reference] 268v global block (1, {Hp * Wp}, {cfg.y_channels}) {dtype} remat, "
        f"gradients through FlashAttention vs the plain path, (err, bound {rtol} x max|ref|): "
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


def phase_probe(dev) -> dict:
    """The permutation probe on the card: its torch probes' ms, and K7/K8's
    launches, counted over main() alone."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.profiling import perm_probe

    kernels.reset_launch_counts()
    res = perm_probe.main(dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {k: 0 for k in launches}
    want.update(expand=11, dynroll=1)  # K7: a warm-up call and 10 timed ones
    if launches != want or not res["dynroll_matches"]:
        raise RuntimeError(f"probe launches {launches}, expected {want}")
    log(f"[probe] ms {json.dumps(res['ms'])}; launches K7 {launches['expand']}, "
        f"K8 {launches['dynroll']}")
    return launches


def _bin_symbols(api, path):
    """(z_sym, y_sym) decoded from a .bin with the api's own coder."""
    from cra5_tpu_torch.api.bitstream import load_bin

    codec, cfg = api.codec, api.model_cfg
    strings, z_shape = load_bin(path)
    z_idx = codec._z_indexes((1, cfg.z_channels, *z_shape))
    with torch.inference_mode():
        if codec.coder == "v1":
            z = codec._v1_decode(codec._eb_table, strings[1], z_idx)
            scales, _ = api.net.scales_from_z_symbols(z)
            y = codec._v1_decode(codec._gc_table, strings[0], codec._gc_indexes(scales))
        else:
            z = codec._eb_coder.decode_batch_to_device(strings[1], z_idx.to(api.device))
            scales, _ = api.net.scales_from_z_symbols(z)
            y = codec._gc_coder.decode_batch_to_device(strings[0], codec._gc_indexes(scales))
    return z, y


def phase_api(dev) -> dict:
    """cra5_api(model_version=268) in float32 with seeded weights: a
    synthetic timestep to a .bin and back with each coder."""
    import os
    import tempfile

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.api.cra5_api import cra5_api
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header

    ts = "2024-01-01T00:00:00"
    t0 = time.time()
    apis = {c: cra5_api(model_version=268, coder=c, seed=SEED, device=dev) for c in ("v2", "v1")}
    torch.cuda.synchronize()
    log(f"[api] cra5_api(model_version=268) float32 for coders v2 and v1, seeded, "
        f"{sum(p.numel() for p in apis['v2'].net.parameters())} params each, {time.time() - t0:.2f} s")
    x = apis["v2"].normalization(apis["v2"]._read_or_synthesize(ts))[None]
    warm = apis["v2"].codec.compress(x)  # warm-up roundtrip
    apis["v2"].codec.decompress(warm["strings"], warm["z_shape"])
    apis["v1"].codec.update()  # the CDF tables, built at first use
    torch.cuda.synchronize()

    res, x_hats = {}, {}
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        for c, api in apis.items():
            api.local_root = os.path.join(root, c)
            api.codec.stage_times = {}
            enc = api.encode_era5_as_bin(ts, save_root=api.local_root)
            dec = api.decode_from_bin(ts, return_format="normalized")
            stages, api.codec.stage_times = api.codec.stage_times, None
            x_hats[c] = dec["x_hat"]
            y_str, z_str = enc["output"]["strings"][0][0], enc["output"]["strings"][1][0]
            res[c] = dict(path=enc["save_path"], encode_s=enc["encoding_time"],
                          decode_s=dec["decoding_time"], read_s=enc["reading_time"],
                          save_s=enc["saving_time"], file_bytes=os.path.getsize(enc["save_path"]),
                          y_bytes=len(y_str), z_bytes=len(z_str), y_string=y_str,
                          stages=stages)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()

        # the v2 y stream takes K3 when it is sorted and kernel-safe, else K2
        yh = parse_v2_header(res["v2"]["y_string"])
        k3 = int(yh[4] and yh[5])
        want = {k: 0 for k in launches}
        want.update(rans_encode=2, rans_decode_generic=2 - k3, rans_decode_sorted=k3,
                    flash_attention_forward=14)
        if launches != want:
            raise RuntimeError(f"API launches {launches}, expected {want}")
        with torch.inference_mode():
            enc_sym = apis["v2"].net.encode_symbols(torch.as_tensor(x, device=dev))
        dec_sym = {c: _bin_symbols(api, res[c]["path"]) for c, api in apis.items()}
        for c, (z, y) in dec_sym.items():
            if not (torch.equal(z, enc_sym["z_sym"]) and torch.equal(y, enc_sym["y_sym"])):
                raise RuntimeError(f"the {c} .bin does not decode to the encoder's symbols")
        if not torch.equal(dec_sym["v2"][0], dec_sym["v1"][0]):
            raise RuntimeError("the v2 and v1 files give different z symbols")
        cfg = apis["v2"].model_cfg
        shape = (1, cfg.in_chans, *cfg.img_size)
        for c, xh in x_hats.items():
            if tuple(xh.shape) != shape or xh.dtype != torch.float32 or not torch.isfinite(xh).all():
                raise RuntimeError(f"{c}: x_hat {tuple(xh.shape)} {xh.dtype} is not a finite "
                                   f"full-size float32 field")
        field = apis["v1"].decode_from_bin(ts)["x_hat"]  # the default, de-normalized numpy
        if field.shape != shape[1:] or not np.isfinite(field).all():
            raise RuntimeError(f"decode_from_bin's de-normalized field {field.shape} is not finite")
    for c, r in res.items():
        log(f"[api] coder {c}: compress {r['encode_s']:.4f} s, decompress {r['decode_s']:.4f} s "
            f"(normalized x_hat on the card); .bin {r['file_bytes']} B (y {r['y_bytes']}, z "
            f"{r['z_bytes']}); read/synthesize {r['read_s']:.2f} s, save {r['save_s']:.4f} s")
        log(f"[api] coder {c} stages (each ends in a synchronize): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in r["stages"].items()))
    log(f"[api] symbols decode exactly from both files, z equal across coders; x_hat "
        f"{shape} finite; v2 y header {yh}; peak {peak / 2**30:.2f} GiB; launches {launches}")
    del apis, x_hats, enc_sym, dec_sym
    torch.cuda.empty_cache()
    return launches


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
    torch.cuda.empty_cache()
    probe_launches = phase_probe(dev)
    api_launches = phase_api(dev)

    # every launch of the paths' own runs: the codec roundtrip, the tiny
    # codec's decompress on the card, the three timed train steps, the
    # probe and the API's two .bin roundtrips. K2 (rans_decode_generic)
    # replaces both decode_scan_pallas (:705) and decode_rowplan_pallas
    # (:368); its entry names the former.
    paths = (main_res["launches"], ref_launches, train_res["launches"], probe_launches,
             api_launches)
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
        "perm_expand": ("expand", "cra5_tpu_torch/csrc/perm_probe.cu",
                        "profiling/_perm_probe.py:141"),
        "perm_dynroll": ("dynroll", "cra5_tpu_torch/csrc/perm_probe.cu",
                         "profiling/_perm_probe.py:160"),
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
