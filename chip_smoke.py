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
     and on the y geometry written unsorted on 1024 lanes, with the time a
     step beside each, K1's, K2's on z and K3's device time too, and K1's
     chain floor: its serial chain alone, profiling/encode_chain_probe.py;
     then streams wider than one block, 32768
     lanes sorted (K3 on a cluster) and 2**20 - 1 unsorted (K2 on a
     cooperative grid), each timed once; K4-K6
     within stated bf16 tolerances, two calls of the bf16 K4, K5 and K6
     bitwise equal), with the kernel's time, the plain version's, the
     card's bound and, for attention, the time of
     scaled_dot_product_attention (forward for K4; its backward, i.e.
     forward + backward less forward, for K5 and K6) as the library
     yardstick, K4's, K5's and K6's TFLOP/s and share of their bound, and
     the floor that the N*N exponentials set on the special-function units;
  4. reference: a tiny f32 model on the card against the same weights on
     the CPU: symbols exact and x_hat within 1e-4 through compress and
     decompress (both of whose streams take the lane decode K2), and one
     training step with the same noise, losses within 1e-4; then one global
     block of the 268v towers (N = 10368, bf16, remat): its gradients
     through FlashAttention (K4, K5, K6) against the same block on the
     plain attention path, within FLASH_GRAD_RTOL x max |ref|;
  4b. hyper_width path: one global ViT block at the 268v hyperprior's
     width (360, 5 heads of 72) on N = 2048 tokens, forward and backward
     through autograd in bf16 and then in float32, the launch counters
     zeroed just before and read just after each (the any-head-dim K4, K5
     and K6 on the tensor cores, once each), its gradients
     against the same block on the plain attention path within
     FLASH_GRAD_RTOL and FLASH_F32_RTOL x max |ref|;
  5. codec path: the 268-variable VAEformer in bf16 at full width with
     seeded random weights compresses a (1, 268, 721, 1440) field to bytes
     and decompresses it; the launch counters are zeroed just before the
     timed roundtrip and read just after;
  6. profile: where the codec path's time goes, from the codec's own stage
     ranges: one roundtrip with every stage ending in a synchronize (host
     ms per stage), then one unsynchronised roundtrip under torch.profiler
     (device ms by kernel name, and the device's busy share of the wall);
  6b. calibrate: the same bf16 model's entropy side (h_a, h_s, the
     EntropyBottleneck) fit by train/calibrate.py::calibrate_entropy on two
     seeded latents through g_a (K4 at (1, 16, 10368, 64)) for the bench's
     600 steps: the bits per latent element at the first and the last
     step (the last lower), every tower parameter bitwise unchanged and
     without a gradient, the counters zeroed just before and read just
     after;
  6c. calibrated roundtrip: the calibrated codec (CDF tables rebuilt)
     compresses and decompresses the main phase's field: y and z bytes,
     the share of escapes, stage ms and the roundtrip beside the
     uncalibrated figures (the streams must be smaller), the decoded
     symbols equal to the encoded ones, the counters zeroed and read
     around the timed roundtrip;
  6d. bench: cra5_tpu_torch/bench.py's functions in-process on the
     calibrated model at a short setting (3 iterations, one pipelined
     window of 12 roundtrips on 6 threads with a stream each, each
     pipelined measurement first holding a roundtrip a thread to the
     sequential bytes and symbols; the production point, config 4, config
     3 at batch 2; configs 1 and 5 skipped): the detail JSON and the
     headline JSON, the counters zeroed and read around it;
  7. train paths: Trainer.fit on the 268v VAEformer with remat, seeded
     init, synthetic N(0, 1) x 0.5 fields, first in bf16, then in float32
     (the JAX package's training default) once the bf16 phase has freed
     its memory: one warm-up step, then three timed steps with the launch
     counters zeroed just before and read just after (14 forward, 7 dQ and
     7 dK/dV launches a step, of the bf16 kernels in the one, of the
     float32 kernels in the other), then one step under torch.profiler;
  7b. published configs (each line carries the card's name and power
     limit; it runs right after the build, while the process holds
     nothing on the card): the port's train_era5_268v_1h.py as published
     (float32, no remat) one step each at batch 1 and 2 on a card batch,
     each in a process of its own (profiling/train_memory.py), each
     step's K4, K5 and K6 launches the 7 global blocks' and its loss
     finite, their peaks and batch 4 reckoned from them (the phase raises
     if it fits without remat); K4, K5 and K6 at a 268v window block's
     attentions at batch 4, (72, 16, 576, 64) and, for the 48 x 12
     windows over the grid padded to 96 rows, (96, 16, 576, 64) float32,
     against
     their plain versions and SDPA; then, on one seeded .npy tree of four
     six-hourly stamps (268v's channels and tp6h), tools/train.py::run at
     the published batch of 4 through configs whose _base_ is the port's
     train_era5_268v_1h.py and train_era5_159v_1h.py, two steps each,
     each adding only remat (CONFIG_REMAT): the "auto" rule puts the 18
     window blocks on K4-K6 beside the 7 global ones, so K4 50 (the
     forward and the recompute), K5 25 and K6 25 a step, the built model's
     blocks held to that layout (CONFIG_FLASH) under "auto"; each step's seconds, rate (the published
     WarmupCosineLR over the 300 000-step horizon, within 1e-9) and batch
     reads from the tree, the peak, a finite loss, the parameters and the
     EMA moved from the seeded init, the params file reloading equal, one
     step on a card batch; then the 159v checkpoint through
     tools/recompress.py --config 159 twice (two timesteps, the .bin files
     byte-identical) and tools/serve.py --config 159 (each .npy equal
     bitwise to the in-process decompress, K1 and K2/K3 of each bin held to
     their plain versions, each decode equal to the encoder's symbols), and
     one bf16 159v roundtrip from a host field with its stages. The
     counters are zeroed just before each path and read just after;
  8. probe path: cra5_tpu_torch.profiling.perm_probe.main on the card (the
     torch sort/take/scatter probes at 2.65 M elements, K7 and K8), the
     counters zeroed just before and read just after;
  9. API path: cra5_api(model_version=268) in float32 with seeded weights
     writes a synthetic timestep to a .bin with coder="v2" and again with
     coder="v1" (encode_era5_as_bin) and reads each back (decode_from_bin),
     the counters zeroed just before and read just after (float32 K4 seven
     times a roundtrip, K1-K3 for the v2 file); every z and y symbol
     decodes exactly from both files, both give the same z symbols, and
     x_hat is a finite full-size field;
  10. dist phases (each line carries the card's name and power limit):
     [recompress] tools/recompress.main on vaeformer_268 in float32 from
     the seeded init over 2 synthetic (268, 721, 1440) .npy timesteps, as
     one process at --batch 1 and 2 and as 2 gloo ranks sharing the card
     (NCCL refuses two ranks on one device) at --batch 1: every 2-rank bin
     byte-identical to the one-process --batch 1 bin (--batch 2 printed
     beside), then decompress_batch on the 2 ranks against the one-process
     decompress; seconds and each rank's peak; [dp_train] one 268v bf16
     remat step on 2 gloo ranks at local batch 1 (Trainer with a dp mesh)
     against one step at batch 2 in this process: metrics and the
     parameters' update within stated bounds, step s, the gradient
     all-reduce s, each rank's peak; [remat_dots] the 268v bf16 step with
     remat="dots" beside remat=True (step s, peak), and one global block's
     gradients under "dots" held to remat=True's; [ring]
     ring_attention_sharded at world size 1 on (1, 16, 10368, 64) in bf16
     and float32 against the plain attention, timed beside K4; [msgpack]
     the 268v params through the port's msgpack writer and reader, bitwise,
     into a fresh model. The ranks reset their launch counters just before
     their path and report them; those launches join the kernels line;
  10b. tp phase (each line carries the card's name and power limit): 2
     gloo ranks sharing the card on a {"tp": 2} mesh, 268v bf16: [tp_train]
     one remat training step and a second, timed (Trainer with the tp mesh:
     the attention and MLP weights of the 16-head towers split, 8 heads of
     64 a rank, the 5-head hyper attention whole) against the same seeded
     init, noise and rng in this process at the same batch: the first
     step's metrics within DP_METRIC_RTOL, the update's L1 within
     DP_UPDATE_RTOL and no element past twice the larger Adam rate, the
     replicated parameters bitwise equal across the ranks after both steps,
     the gathered parameters' names and shapes the one-process model's,
     K4, K5 and K6 on each rank; each rank's step s, tp all-reduce s
     (forward and backward), peak and launches; [tp_codec] compress and
     decompress of one 268v field on the same 2 ranks: both ranks' strings
     byte-identical, each rank's decode equal to its encoder's symbols,
     K1, K2 and K3 launched with the y stream sorted and kernel-safe; the
     tp g_s on the tp's symbols and the tp h_s on seeded z symbols within
     TP_XHAT_RTOL of the one-process towers; against the one-process
     roundtrip z symbols equal, at most TP_MOVED_MAX of the y symbols
     moved and none by more than one, bytes within TP_RD_RTOL and x_hat's
     squared difference within TP_MOVED_MAX of its square;
  11. zoo phase (each line carries the card's name and power limit):
     mbt2018-mean at a small width (N=32, M=48) on the card against the same
     weights on the CPU (streams byte-identical, x_hat within ZOO_XHAT_RTOL);
     then cra5_tpu_torch.tools.eval_model.main --device cuda at the zoo's
     full widths with seeded weights on seeded Kodak-size (3 x 512 x 768)
     .npy images: bmshj2018-factorized, bmshj2018-hyperprior and
     mbt2018-mean at q8 with the v2 coder, mbt2018-mean q8 with v1,
     cheng2020-anchor q6 through AutoregressiveCodec on one image, and
     mbt2018-mean q8 --entropy-estimation (bpp, encode s, decode s); after
     each coded run one synchronised roundtrip of its first image (host ms
     a codec stage, which kernel decodes each stream); then one CLIC-size
     (3 x 2048 x 1365) image through mbt2018-mean q8 v2, whose y stream (8192
     lanes, sorted, kernel-safe) must decode on K3. Gates: every decoded
     symbol equals the encoded one, decompress's x_hat equals reconstruct
     of the encoded symbols bitwise, the counters zeroed just before each
     eval_model run and each roundtrip and read just after show K1 and K2
     (and K3 for the CLIC image) on v2 and no coder kernel on v1; those
     launches join the kernels line. On each v2 stream of those
     roundtrips, at its own geometry, K1 is held exactly against its plain
     version on the stream's grids and against the container, and the
     decode kernel (K2 or K3) against its plain version on the uploaded
     stream, and the stream's decode against the encoder's symbols; [zoo
     kernels] lines give both kernels' device times;
  12. serve phase (each line carries the card's name and power limit): the
     published-model serving path at full width in float32 on seeded
     weights written as the reference's .pth (reference_state_dict, with
     trained-style CDF tables: the EB table of its own EB params, a GC
     table of a non-default 48-level scale table): convert_checkpoint of it
     gives the model's params bitwise and the tables; verify_268_manifest
     reports only the seven CDF buffers reshaped (the manifest lists them
     empty); tools/convert_torch.main on a manifest-exact copy exits 0;
     cra5_api(weights=.pth) installs the file's tables and writes two
     timesteps' .bin files (synthetic fields), whose y stream differs from
     recomputed tables'; on the first bin's y and z streams, under the
     file's tables, K1 and the decode kernel each takes (K3 or K2) are
     held exactly against their plain versions and the decode against the
     encoder's symbols ([serve kernels] lines); tools/serve.main --config 268 --checkpoint .pth
     --threads 4 --denormalize serves them (its JSON line printed; the
     counters zeroed just before and read just after: K2 on every z
     stream, K3 or K2 on each y stream as its header names, the float32 K4
     three times a decode); each .npy equals cra5_api's decode_from_bin
     bitwise (the .npy files deleted after the check), with decode_from_bin
     timed beside np.save of the field; era5_eval.evaluate_fields over the
     two pairs (mean_wrmse, the worst three variables); decode_profile at
     268 with --depths 2 --batches 1 --iters 2 --per-window 6
     --phase-iters 2 (its launches counted).
     Serve's launches join the float32 K4 and K2/K3 rows of the kernels
     line, decode_profile's the bf16 ones.
  13. variants phase (each line carries the card's name and power limit):
     the ERA5 VAEformer variants at vaeformer_268's full width and depth in
     bf16 with seeded weights, each freed before the next: VariationCNNPrior
     (variational), the mean-scale baseline (variational=False) and the
     former baseline (vaeformer_former_baseline(): no quant convs, y of
     1024 channels, 10.6 M symbols on 16384 lanes) each through one eval
     forward (finite; the mean-scale KL all zeros) and a VAEformerCodec v2
     roundtrip of a seeded host field (stage ms; gates: symbols exact,
     x_hat bitwise reconstruct_from_y_symbols, the launches the headers
     name and 7 K4; hold_stream_kernels on the y and z streams, K1 and
     K2/K3 exact against their plain versions with their device times;
     the former baseline's y must take K3 on 16384 lanes);
     VITAutoencoderKL's forward in the mode and sampled from a card
     generator (14 K4, finite KL, the sample differs); Trainer.fit on
     VariationCNNPrior with remat and use_kl, one warm-up step and three
     timed (14 K4, 7 K5, 7 K6 a step; finite metrics; step s, peak);
     vivt69_experiment.main at 69 x 181 x 360, width 384, depth 10, one
     lambda, VIVT69_STEPS steps on the device sampler, --nval 2 (s a step,
     the RD point; K1/K2 on its streams); finalize_scaling record --model
     268 (calibrated through the bench's cache) and replay --parse at
     FINALIZE_WORKERS threads (samples/s; every container byte-identical).
     The counters are zeroed just before each path and read just after;
     its bf16 paths' launches join the bf16 rows of the kernels line, and
     every path's K1-K3 launches the coder rows.
  14. context phase (each line carries the card's name and power limit):
     the context-model image codecs in float32 with TF32 off. ELIC, STF
     and TCM at the JAX tests' tiny widths (CONTEXT_TINY) with the same
     seeded weights on the card and on the CPU, one roundtrip of a seeded
     3 x 128 x 192 image each: every stream byte-identical (a symbol or
     index flipped on a rounding boundary would be printed pass by pass,
     and the card's coder held to the CPU's streams on the CPU's symbols
     and indexes), x_hat within ZOO_XHAT_RTOL; then
     cra5_tpu_torch.tools.eval_model.main --device cuda at the published
     widths with seeded weights on seeded Kodak-size .npy images:
     elic2022, stf and tcm2023 q4 (v2: ElicCodec / CharmCodec, one stream
     a checkerboard pass or slice), invcompress q4 through
     AutoregressiveCodec, elic2022 q4 --entropy-estimation, and one
     CLIC-size image through elic2022 q4, whose 192-channel group codes on
     2048 lanes, sorted and kernel-safe, and must decode on K3. After each
     coded run one synchronised roundtrip of its first image (host ms a
     stage, the decode kernel of each stream, the coder kernels' share of
     the roundtrip). Gates: the decoder's GC indexes of every pass equal
     the encoder's, every decoded symbol equals the encoded one,
     decompress's x_hat equals synthesis of the encoder's y_hat bitwise;
     on every v2 stream of the first sample K1 is held exactly against its
     plain version and the container and the decode kernel (K2 or K3)
     against its plain version on the uploaded stream ([context kernels]
     lines with device us); the counters zeroed just before each
     eval_model run and each roundtrip and read just after show K1 and K2
     (and K3 at CLIC size) on the v2 runs, no coder kernel on InvCompress
     and the entropy estimation, and no other kernel anywhere (no flash
     kernel: Swin windows hold 16 or 64 tokens). Its launches join the coder
     rows of the kernels line.
  15. video phase (each line carries the card's name and power limit):
     ScaleSpaceFlow in float32 with TF32 off. At the tiny test widths
     (VIDEO_TINY) the same seeded weights on the card and on the CPU code a
     seeded 3-frame 128 x 128 clip: every stream byte-identical, each
     side's streams decoding on the other, the frames within ZOO_XHAT_RTOL
     x max|ref|. Then zoo.ssf2020(1, "mse") at the published widths
     (planes 192, mid 128, 5 levels, sigma0 1.5), seeded, through
     tools/video_eval.eval_clip on a seeded UVG-size clip (3 x 3 x 1080 x
     1920, padded to 1152 x 1920) and a seeded Vimeo-90k-size septuplet
     (7 x 3 x 256 x 448, padded to 256 x 512): one warm-up and VIDEO_TIMED
     timed runs each (bpp, PSNR, MS-SSIM, encode and decode s), then one
     roundtrip of each clip with every stage synchronised (host ms for
     analysis, hyperprior, coder, motion and synthesis). Gates: the
     decoder's GC indexes of every latent equal the encoder's, every
     decoded symbol the encoder's, every decoded frame bitwise the
     encoder's reference frame, the metrics finite, and the launches the
     streams' (K1 each, K2 or K3 as each header names, nothing else); the
     1080p y streams (2048 lanes, sorted) decode on K3, or the phase prints
     why each went to K2. On every stream of those roundtrips K1 and its
     decode kernel are held against their plain versions ([video kernels]
     lines: device us a stream and a step, and the coder kernels' share of
     the roundtrip). The counters are zeroed just before each run and read
     just after; the launches join the coder rows of the kernels line.
  16. examples phase (each line carries the card's name and power limit):
     cra5_tpu_torch.examples through their main(), the counters zeroed
     just before each and read just after. train_demo_268 at 268v (bf16
     remat, EMA), 40 steps saved at 20 (with --examples its defaults, 400
     saved at 200 on 6 fields): the full state saved, restored into a fresh
     model and Trainer with every tensor and count bitwise equal, the step
     after the save taken live and again from the restored state, its
     metrics and every tensor bitwise equal, the step-0, trained and EMA
     codecs on a held-out field with every decoded symbol equal to the
     encoder's (bytes, bpp, MSE, the y stream's decode kernel and escape
     share); train_demo_report on its JSON; quickstart (268v float32,
     --no-plots); test_model --full; roundtrip_timing (1 iteration;
     --examples: 5); train_268v_smoke; profile_268_train --steps 2
     (--examples: 3). Gates: every metric finite; the launches reckoned
     from each one's steps and roundtrips (a remat step 14 K4, 7 K5, 7
     K6; a codec roundtrip K1 and K2 or K3 a stream, 7 K4; an API
     roundtrip's four calls 14 K4); no profile variant in error; the mean
     total loss of the demo's last 10 steps below its first 10's, and with
     --examples the trained codec's held-out rate-distortion cost below the
     step-0 codec's. The bf16 launches join the bf16 rows of the kernels
     line, the float32 ones the float32 K4 row, all the coder rows.
  17. switches phase (each line carries the card's name and power limit;
     both modes restored afterwards): (a) the seeded 268v bf16 codec,
     uncalibrated, one compress and decompress under each flash mode
     ("auto", "on", "off"; nn/blocks.py::set_flash_attention) after a
     warm-up: g_a, h_a, h_s and g_s ms, the peak, the K4 launches (7, 37,
     0); each decoder's symbols exactly its encoder's; against "auto" the y
     symbols within one on at most 1% of positions and the x_hat each
     mode's g_s makes of "auto"'s decoded y within 2e-2 x max |x_hat| (the
     roundtrips' own x_hat printed beside); then the bf16 remat train step
     under "on" beside "auto": each parameter's gradient at the same
     weights and noise within 4 x its own bf16 noise (the gradient's move
     when every weight moves by half a bf16 ulp) + 2^-8 x max |g_auto|,
     and Trainer.fit's s a step, peak and launches (K4 58, K5 33, K6 33 a
     step under "on"); (b) K4, K5 and K6 at (18, 16, 576, 64) and (1, 5,
     648, 72) in bf16 and float32 against their plain versions, event ms,
     device us, SDPA, bound; (c) the 268v y of the "auto" encode written
     under the sorted-lanes mode "auto" (sorted, K3) and "off" (unsorted,
     K2; coder/rans_kernels.py::set_sorted_lanes), each twice
     byte-identical and decoded exactly, K1 and the decode kernel held to
     their plain versions, both byte counts and K2's and K3's device time;
     (d) the towers' options at 268v width: a codec roundtrip at 720 x 1440
     with patch = stride = (10, 10) and the linear un-patchify
     (use_conv_transpose=False), and a ViTEncoder(window=False) forward (13
     global blocks of 10 368 tokens on K4). The counters are zeroed just
     before each path run and read just after; its launches join the
     kernels line (the flash ones split by head dim: 64 to the bf16 rows,
     72 to the bf16 any-head-dim rows).

The kernels phase also holds K4-K6 on float32 operands (on the tensor
cores with 3xTF32) at a ragged N and at the global blocks' shape against
the float32 plain versions, within FLASH_F32_RTOL x max |ref|, two calls of
each bitwise equal, with SDPA in float32 as the yardstick; the
any-head-dim K4, K5 and K6 on the tensor cores (every head dim but 64) at
head dim 72 in float32, bf16 and float16 at (1, 5, 2048, 72) and (1, 5,
10368, 72) against their plain versions, two calls bitwise equal, timed
beside the SIMT K4, K5 and K6 (held to their plain versions too), SDPA and
their tensor-core bound; the SIMT K4, K5 and K6 at head dims past 256 (D =
320 and 520, walked in 256-column chunks) at (1, 2, 2048, D) in bf16 and
float32 against their plain versions, two calls bitwise equal, with event
ms and device us beside SDPA's and the operations bound
([K4/K5/K6 SIMT D=...] lines); and K7
(perm_expand) at (8, 1024) and (16, 1024) and K8 (perm_dynroll) at (8,
1024) against their plain versions exactly, with the event and device
time of each and of torch.roll, the launch floor (an empty kernel through
the same ctypes path) and where a K8 call's host time goes ([K8 issue]);
the reference phase adds the 268v global block in float32. Before the last
two lines comes the bench's headline JSON. The line before
the last is a JSON object listing every kernel (the float32 K4, K5 and K6
rows of their own: K4's launches those of the API and the float32 train
path, K5's and K6's those of the float32 train path; the bf16 rows those
of the bf16 paths, the calibration's, the calibrated roundtrip's and the
bench's included, and dp_train's, remat_dots' and the tp phase's; the
float32 rows those of the published configs' two trainings too, and the
float32 K4 row recompress's and the 159v recompression's and serve's,
whose K1-K3 launches join those rows; the head-dim-72 rows those of the
hyper_width path in their dtype); the last is {"ok": true, "device":
{...}}. It needs one card and no network.

    python3 chip_smoke.py --coder
    python3 chip_smoke.py --perm
    python3 chip_smoke.py --dist
    python3 chip_smoke.py --tp
    python3 chip_smoke.py --zoo
    python3 chip_smoke.py --serve
    python3 chip_smoke.py --variants
    python3 chip_smoke.py --context
    python3 chip_smoke.py --video
    python3 chip_smoke.py --examples
    python3 chip_smoke.py --switches
    python3 chip_smoke.py --configs

run phases 1 and 2 and then only the coder kernels of phase 3 (K1 on z and
y, K2 on z, K3 on y, K9 and K10 on a y stream with ~10^5 escapes: exact,
event ms and device us, no chain floor), only
K7 and K8 (exact, event ms and device us, torch.roll beside K8; no launch
floor or host breakdown), only the dist phases (10), only the tp phase
(10b), only the zoo phase (11), only the serve phase (12), only the
variants phase (13), only the context phase (14), only the video phase
(15), only the examples phase at its default depth (16), only the
switches phase (17), or only the published configs (7b), and print no
result line. They import
the cra5_tpu_torch that Python finds, so with PYTHONSAFEPATH=1
PYTHONPATH=<checkout> they time another checkout's kernels with this
script's timers, for a comparison in one run.
"""

from __future__ import annotations

import contextlib
import io
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
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor cores, published
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
MUFU_EX2_PER_CLOCK = 16  # ex2 a clock per SM on Hopper's special-function units
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
# rounding points, float32 sums in another order, and the 3xTF32 split
# products (hi hi + hi lo + lo hi; tests/test_torch_flash.py emulates them
# on the CPU within this bound). The plain versions sum in cuBLAS's blocked
# order (within 1.3e-6 x max |ref| of float64 at N = 10368 on the CPU); the
# kernels add each stage's products to their running sums in float32, and
# came within 0.16-0.28 of the bound at (1, 16, 10368, 64) on an H100.
# Bound: out, dq, dk, dv within
# FLASH_F32_RTOL x max |ref|, lse within FLASH_F32_LSE_ATOL.
FLASH_F32_RTOL = 1e-5
FLASH_F32_LSE_ATOL = 1e-5
TRAIN_STEPS = 3  # timed steps of the train path, after one warm-up step
CARD = ""  # nvidia-smi's name and power limit, set by phase_card


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


def device_us(fn, iters: int = 20) -> float:
    """Microseconds of device time a call (the kernels' and copies' own
    durations under torch.profiler, summed and divided by ``iters``), where
    a short kernel's event time is the host's issue rate. A trace that
    recorded no device activity (seen once on an H100) is taken again, up
    to three times; then the result is nan, printed as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if us > 0:
            return us / iters
    return float("nan")


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def exp_floor_ms(n_exp: int) -> float:
    """The least time the card's special-function units take for n_exp
    ex2 at the SMs' maximum clock (nvidia-smi clocks.max.sm); printed
    beside a flash kernel's operations bound, not part of it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (MUFU_EX2_PER_CLOCK * sms * mhz * 1e6) * 1e3


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
    global CARD
    CARD = smi
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
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem",
                                       "warning", "wgmma", "setmaxnreg")):
                log(f"[build] {src}: {line.strip()}")


def coder_rows(dev, rng, floor: bool = True) -> tuple:
    """K1 on the 268v z and y streams, K2 decoding z and K3 decoding the
    sorted y stream, each exactly against its plain version, timed by CUDA
    events over back-to-back calls and by device time (``device_us``); with
    ``floor``, K1's chain floor beside it (profiling/encode_chain_probe.py).
    Returns the kernels line's rows, the GC table and the y stream."""
    from cra5_tpu_torch.coder import rans_kernels as rk
    from cra5_tpu_torch.coder.lane_coder import (
        LaneCoder, _sort_by_index, merge_tiny_buckets, parse_v2_header, sorted_rows,
    )
    from cra5_tpu_torch.entropy import EntropyBottleneck, eb_update, gc_update, get_scale_table

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

    # K1 on both streams; its floor is M times one step's dependent
    # latency, timed as the chain alone in registers
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
        us = device_us(lambda: rk.rans_encode(starts, freqs))
        plain = timed_ms(lambda: rk.rans_encode_plain(starts, freqs), 2)
        bound = bytes_bound_ms(M * K * 11 + K * 4)
        log(f"[K1 rans_encode {name}] (M, K) = ({M}, {K}) exact; kernel {ms:.4f} ms, device "
            f"{us:.2f} us ({us / M * 1e3:.1f} ns a step), plain {plain:.2f} ms, "
            f"bound {bound:.4f} ms (bytes)")
        if floor:
            from cra5_tpu_torch.profiling import encode_chain_probe

            states = torch.empty(K, dtype=torch.int32, device=dev)
            chain = device_us(lambda: encode_chain_probe.chain(M, K, states))
            log(f"[K1 chain floor {name}] (M, K) = ({M}, {K}): {chain:.2f} us device "
                f"({chain / M * 1e3:.1f} ns a step: K1's chain alone, "
                f"profiling/encode_chain_probe.py)")
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
    got = rk.rans_decode_generic(z_coder._cdf, idx2, states, words, *tabs, z_coder._slots)
    want = rk.lane_decode_plain(z_coder._cdf, idx2, states, words, *tabs)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("K2 rans_decode_generic differs from lane_decode_plain on z")
    if not np.array_equal(z_coder.decode(data, z_idx), z_sym):
        raise RuntimeError("z stream does not roundtrip")
    run = lambda: rk.rans_decode_generic(z_coder._cdf, idx2, states, words, *tabs, z_coder._slots)
    ms, us = timed_ms(run, 20), device_us(run)
    plain = timed_ms(lambda: rk.lane_decode_plain(z_coder._cdf, idx2, states, words, *tabs), 2)
    ncd, L = z_coder._cdf.shape
    bound = bytes_bound_ms(M * K * 4 + K * 4 + n_words * 2 + ncd * (L + 2) * 4 + M * K * 5)
    log(f"[K2 rans_decode_generic z] (M, K, L) = ({M}, {K}, {L}), {n_words} words, "
        f"{n_esc} escapes; exact; kernel {ms:.4f} ms ({ms / M * 1e3:.3f} us a step; "
        f"{rk.decode_geometry(K)}), device {us:.2f} us, plain {plain:.2f} ms, "
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
    got = rk.rans_decode_sorted(*args, y_coder._slots)
    want = rk.rans_decode_sorted_plain(*args)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("K3 rans_decode_sorted differs from its plain version")
    if not np.array_equal(y_coder.decode(data, y_idx), y_sym):
        raise RuntimeError("y stream does not roundtrip")
    run = lambda: rk.rans_decode_sorted(*args, y_coder._slots)
    ms, us = timed_ms(run, 20), device_us(run)
    plain = timed_ms(lambda: rk.rans_decode_sorted_plain(*args), 2)
    ncd, L = y_coder._cdf.shape
    bound = bytes_bound_ms(M * 12 + K * 4 + n_words * 2 + ncd * (L + 2) * 4 + M * K * 5)
    log(f"[K3 rans_decode_sorted y] (M, K, L) = ({M}, {K}, {L}), {n_words} words, "
        f"{n_esc} escapes; exact; kernel {ms:.4f} ms ({ms / M * 1e3:.3f} us a step; "
        f"{rk.decode_geometry(K)}), device {us:.2f} us, plain {plain:.2f} ms, "
        f"bound {bound:.4f} ms (bytes)")
    rows["rans_decode_sorted"] = dict(max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bound,
                                      bound_by="bytes", library_ms=None)
    rows.update(container_rows(dev, rng, y_coder, y_idx))
    return rows, gc_table, y_sym, y_idx


def host_ms(fn, iters: int = 5) -> float:
    """Median host milliseconds of a call (perf_counter; work that ends
    on the card ends in a synchronize inside ``fn``)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def container_rows(dev, rng, coder, idx, escape_frac: float = 0.04) -> dict:
    """K9 and K10 on a 268v-geometry y stream with ``escape_frac`` of its
    symbols escaped (~10^5 escapes): each exactly against the host's
    reference (``assemble_container``, ``container_arrays``), timed by CUDA
    events and device time beside its bytes bound, and the host ms of a
    stream's finalize and upload down the card's route (K9 and one copy
    out; one copy in and K10) and down the host's (the arrays' reads and
    ``assemble_container``; ``container_arrays`` and three copies in)."""
    from cra5_tpu_torch.coder import rans_kernels as rk
    from cra5_tpu_torch.coder.lane_coder import (LaneCoder, assemble_container, container_arrays,
                                                 parse_v2_header)

    t = lambda a: torch.as_tensor(a, device=dev)
    sym = sample_symbols(rng, coder.table, idx, escape_frac)
    h = coder.encode_dispatch(t(sym), t(idx))
    n, K, sort, states, words, escs, safe = h
    nw, ne = words.numel(), escs.numel()

    def host_pack():
        st, wd, es = states.cpu().numpy(), words.cpu().numpy(), escs.cpu().numpy()
        return assemble_container(n, K, nw, ne, sort, bool(safe.item()), st.view(np.uint32),
                                  wd.view(np.uint16), es)

    data = host_pack()
    hdr = parse_v2_header(data)
    if LaneCoder.encode_finalize_many([h]) != [data]:
        raise RuntimeError("K9: the card's container differs from assemble_container's")
    image = rk.container_write(n, sort, states, words, escs, safe).cpu().numpy()
    size = int(image[:8].view("<i8")[0])
    if size != len(data) or image[8:8 + size].tobytes() != data:
        raise RuntimeError("K9 container_write differs from assemble_container")
    k9 = lambda: rk.container_write(n, sort, states, words, escs, safe)
    k9_ms, k9_us = timed_ms(k9, 20), device_us(k9)
    k9_bound = bytes_bound_ms(4 * K + 2 * nw + 4 * ne + 8 + len(data))

    dev_image = t(np.frombuffer(data, np.uint8).copy())
    got = rk.container_read(dev_image, K, nw, ne)
    ref = container_arrays(data, hdr)
    if not all(np.array_equal(g.cpu().numpy(), r) for g, r in zip(got, ref)):
        raise RuntimeError("K10 container_read differs from container_arrays")
    k10 = lambda: rk.container_read(dev_image, K, nw, ne)
    k10_ms, k10_us = timed_ms(k10, 20), device_us(k10)
    k10_bound = bytes_bound_ms(len(data) + 4 * K + 2 * nw + 4 * ne)

    def sync(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    fin_card = host_ms(sync(lambda: LaneCoder.encode_finalize_many([h])))
    fin_host = host_ms(sync(host_pack))
    up_card = host_ms(sync(lambda: coder._upload(data, n=n)))
    up_host = host_ms(sync(lambda: [torch.from_numpy(a).to(dev)
                                    for a in container_arrays(data, parse_v2_header(data))]))
    st, wd, es = ref
    pack_ms = host_ms(lambda: assemble_container(n, K, nw, ne, sort, hdr[5], st.view(np.uint32),
                                                 wd.view(np.uint16), es))
    parse_ms = host_ms(lambda: container_arrays(data, parse_v2_header(data)))
    log(f"[container y] (K, words, escapes) = ({K}, {nw}, {ne}), {len(data)} B; K9 exact "
        f"(assemble_container's bytes), kernel {k9_ms:.4f} ms, device {k9_us:.2f} us, bound "
        f"{k9_bound:.4f} ms (bytes); K10 exact (container_arrays), kernel {k10_ms:.4f} ms, "
        f"device {k10_us:.2f} us, bound {k10_bound:.4f} ms (bytes); their plain versions on the "
        f"host: assemble_container {pack_ms:.3f} ms, container_arrays {parse_ms:.3f} ms; a "
        f"stream's finalize {fin_card:.3f} ms (K9) "
        f"against {fin_host:.3f} ms (the reads and assemble_container), its upload "
        f"{up_card:.3f} ms (K10) against {up_host:.3f} ms (container_arrays and three copies)")
    return {"container_write": dict(max_abs_err=0, ms=k9_ms, plain_ms=pack_ms, bound_ms=k9_bound,
                                    bound_by="bytes", library_ms=None),
            "container_read": dict(max_abs_err=0, ms=k10_ms, plain_ms=parse_ms,
                                   bound_ms=k10_bound, bound_by="bytes", library_ms=None)}


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from cra5_tpu_torch.coder import rans_kernels as rk
    from cra5_tpu_torch.coder.lane_coder import LaneCoder, parse_v2_header
    from cra5_tpu_torch.ops.attention import flash_attention_forward, flash_attention_plain

    rng = np.random.default_rng(SEED)
    rows, gc_table, y_sym, y_idx = coder_rows(dev, rng)
    t = lambda a: torch.as_tensor(a, device=dev)

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
    got = rk.rans_decode_generic(g_coder._cdf, idx2, states, words, *tabs, g_coder._slots)
    want = rk.lane_decode_plain(g_coder._cdf, idx2, states, words, *tabs)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("K2 rans_decode_generic differs from lane_decode_plain on y")
    if not np.array_equal(g_coder.decode(data, y_idx), y_sym):
        raise RuntimeError("the unsorted y stream does not roundtrip")
    ms = timed_ms(lambda: rk.rans_decode_generic(g_coder._cdf, idx2, states, words, *tabs,
                                                 g_coder._slots), 10)
    plain = timed_ms(lambda: rk.lane_decode_plain(g_coder._cdf, idx2, states, words, *tabs),
                     1, warmup=0)
    ncd, L = g_coder._cdf.shape
    bound = bytes_bound_ms(M * K * 4 + K * 4 + n_words * 2 + ncd * (L + 2) * 4 + M * K * 5)
    log(f"[K2 rans_decode_generic y unsorted] (M, K, L) = ({M}, {K}, {L}), {n_words} "
        f"words, {n_esc} escapes; exact; kernel {ms:.4f} ms ({ms / M * 1e3:.3f} us a step), "
        f"plain {plain:.2f} ms, bound {bound:.4f} ms (bytes)")
    del g_coder, idx2, states, words, got, want
    wide_lane_checks(rng, dev, gc_table)

    # K4 at the global blocks' shape, and at a ragged N
    for B, H, N in ((1, 2, 1000), (1, 16, 10368)):
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        scale = 64 ** -0.5
        out, lse = flash_attention_forward(q, k, v, scale)
        again = flash_attention_forward(q, k, v, scale)
        ref, ref_lse = flash_attention_plain(q, k, v, scale)
        err = (out.float() - ref.float()).abs().max().item()
        out_tol = FLASH_OUT_RTOL * ref.float().abs().max().item()
        lerr = (lse - ref_lse).abs().max().item()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        if not (err <= out_tol and lerr <= FLASH_LSE_ATOL and torch.isfinite(out).all() and same):
            raise RuntimeError(f"K4 flash_attn_fwd at N={N}: out err {err} (bound {out_tol}), "
                               f"lse err {lerr}, two calls bitwise equal {same}")
        ms = timed_ms(lambda: flash_attention_forward(q, k, v, scale), 10)
        plain = timed_ms(lambda: flash_attention_plain(q, k, v, scale), 2)
        lib = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale), 10)
        flops = 4 * B * H * N * N * 64
        bound = max(flops / BF16_FLOPS * 1e3, bytes_bound_ms(4 * B * H * N * 64 * 2 + B * H * N * 4))
        log(f"[K4 flash_attn_fwd] (B, H, N, D) = ({B}, {H}, {N}, 64): out err {err:.3g} "
            f"(bound {out_tol:.3g} = {FLASH_OUT_RTOL} x max|ref|), lse err {lerr:.3g} "
            f"(atol {FLASH_LSE_ATOL}), two calls bitwise equal; "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of the bound), "
            f"plain {plain:.2f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms (operations), "
            f"exp floor {exp_floor_ms(B * H * N * N):.4f} ms")
        del q, k, v, out, lse, ref, ref_lse, again
    rows["flash_attn_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                                  bound_by="operations", library_ms=lib)
    torch.cuda.empty_cache()
    rows.update(flash_backward_rows(rng, dev))
    rows.update(flash_f32_rows(rng, dev))
    rows.update(flash_anydim_rows(rng, dev))
    flash_wide_rows(rng, dev)
    rows.update(perm_rows(rng, dev))
    return rows


def wide_lane_checks(rng, dev, gc_table) -> None:
    """Streams wider than one block of the decode kernels: 32768 lanes
    sorted on the GC table (K3 on a cluster of 8 blocks, 4 lanes a thread)
    and 2**20 - 1 lanes unsorted on a 256-channel EB table (K2 on a
    cooperative grid, 8 lanes a thread), M = 3 each, encoded on the card:
    each kernel equals its plain version and the coder decodes the symbols;
    one timed call each (the cooperative route is the slow one)."""
    from cra5_tpu_torch.coder import rans_kernels as rk
    from cra5_tpu_torch.coder.lane_coder import (
        LaneCoder, _sort_by_index, merge_tiny_buckets, parse_v2_header, sorted_rows,
    )
    from cra5_tpu_torch.entropy import EntropyBottleneck, eb_update

    eb = EntropyBottleneck(256, device=dev)
    eb.reset_parameters(torch.Generator(device=dev).manual_seed(SEED + 1))
    eb_table = eb_update(eb.params_numpy())
    for name, table, K in (("sorted GC", gc_table, 32768), ("unsorted EB", eb_table, 2**20 - 1)):
        n = 3 * K - 5
        sorted_ = name.startswith("sorted")
        idx = (rng.integers(20, 23, n) if sorted_ else rng.integers(0, 256, n)).astype(np.int32)
        sym = sample_symbols(rng, table, idx, 0.01)
        coder = LaneCoder(table, num_lanes=K, device=dev)
        data = coder.encode(sym, idx)
        hdr = parse_v2_header(data)
        (_, _, n_esc, n_words, srt, safe, _), states, words, _ = coder._upload(data, hdr)
        if (srt and safe) != sorted_ or hdr[1] != K:
            raise RuntimeError(f"{name} stream at K={K}: header {hdr}")
        t = torch.as_tensor(idx, device=dev)
        tabs = (coder._max_values, coder._offsets)
        if sorted_:
            sidx = merge_tiny_buckets(_sort_by_index(t)[0], coder.num_indexes, K)
            idx2 = torch.cat([sidx, sidx[-1:].expand(3 * K - n)]).reshape(3, K)
            args = (coder._cdf, *sorted_rows(idx2), states, words, *tabs)
            fn, plain_fn = rk.rans_decode_sorted, rk.rans_decode_sorted_plain
        else:
            idx2 = torch.cat([t, t.new_zeros(3 * K - n)]).reshape(3, K)
            args = (coder._cdf, idx2, states, words, *tabs)
            fn, plain_fn = rk.rans_decode_generic, rk.lane_decode_plain
        got, want = fn(*args, coder._slots), plain_fn(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"{fn.__name__} differs from its plain version at K={K}")
        if not np.array_equal(coder.decode(data, idx), sym):
            raise RuntimeError(f"the {name} stream of {K} lanes does not roundtrip on the card")
        ms = timed_ms(lambda: fn(*args, coder._slots), 1, warmup=0)
        log(f"[wide lanes {name}] (M, K) = (3, {K}), {n_words} words, {n_esc} escapes; "
            f"{fn.__name__} on {rk.decode_geometry(K)} equals its plain version, symbols "
            f"roundtrip; one call {ms:.4f} ms ({ms / 3 * 1e3:.3f} us a step)")
        del coder, got, want, args, idx2, states, words
    torch.cuda.empty_cache()


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
        same_dq = torch.equal(dq, flash_attention_backward_dq(*ops))
        ref = flash_attention_backward_dq_plain(*ops)
        errs["dq"] = ((dq.float() - ref.float()).abs().max().item(),
                      FLASH_GRAD_RTOL * ref.float().abs().max().item())
        finite = bool(torch.isfinite(dq).all())
        del dq, ref
        dk, dv = flash_attention_backward_dkv(*ops)
        again = flash_attention_backward_dkv(*ops)
        same = same_dq and torch.equal(dk, again[0]) and torch.equal(dv, again[1])
        ref_dk, ref_dv = flash_attention_backward_dkv_plain(*ops)
        for name, a, b in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            errs[name] = ((a.float() - b.float()).abs().max().item(),
                          FLASH_GRAD_RTOL * b.float().abs().max().item())
        finite = finite and bool(torch.isfinite(dk).all() and torch.isfinite(dv).all())
        del dk, dv, ref_dk, ref_dv, again
        bad = {n: e for n, e in errs.items() if not e[0] <= e[1]}
        if bad or not finite or not same:
            raise RuntimeError(f"K5/K6 at N={N}: (err, bound) {errs}, finite {finite}, "
                               f"dQ and dK/dV of two calls bitwise equal {same}")
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
        flops_dq, flops_dkv = 6 * B * H * N * N * 64, 8 * B * H * N * N * 64
        log(f"[K5/K6 flash_attn_bwd] (B, H, N, D) = ({B}, {H}, {N}, 64): (err, bound "
            f"{FLASH_GRAD_RTOL} x max|ref|) " + ", ".join(
                f"{n} ({e:.3g}, {b:.3g})" for n, (e, b) in errs.items())
            + f", dQ and dK/dV of two calls bitwise equal; dQ kernel {ms_dq:.4f} ms "
            f"({flops_dq / ms_dq / 1e9:.1f} TFLOP/s, {bound_dq / ms_dq:.1%} of the bound), plain "
            f"{plain_dq:.2f} ms, bound {bound_dq:.4f} ms (operations); dK/dV kernel {ms_dkv:.4f} ms "
            f"({flops_dkv / ms_dkv / 1e9:.1f} TFLOP/s, {bound_dkv / ms_dkv:.1%} of the bound), "
            f"plain {plain_dkv:.2f} ms, bound {bound_dkv:.4f} ms (operations), exp floor "
            f"{exp_floor_ms(B * H * N * N):.4f} ms; sdpa backward (fwd+bwd {both_ms:.4f} less "
            f"fwd {fwd_ms:.4f}) {lib:.4f} ms")
        rows["flash_attn_bwd_dq"] = dict(max_abs_err=errs["dq"][0], ms=ms_dq, plain_ms=plain_dq,
                                         bound_ms=bound_dq, bound_by="operations",
                                         library_ms=lib)
        rows["flash_attn_bwd_dkv"] = dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                                          ms=ms_dkv, plain_ms=plain_dkv, bound_ms=bound_dkv,
                                          bound_by="operations", library_ms=lib)
        del q, k, v, do, out, lse, delta, ops, qg, kg, vg
        torch.cuda.empty_cache()
    return rows


def flash_f32_rows(rng, dev) -> dict:
    """K4, K5 and K6 on float32 operands (3xTF32 on the tensor cores)
    against the float32 plain versions at a ragged N and at the global
    blocks' shape, two calls of each bitwise equal, with SDPA in float32
    (forward; backward as forward + backward less forward) as the
    yardstick. Each bound is its design's, three TF32 products at 495
    TFLOP/s, printed with the exp floor and the FP32 FFMA bound (what a
    kernel off the tensor cores could reach) beside it. Returns the three
    rows of the kernels line."""
    from cra5_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_forward,
        flash_attention_plain,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 64 ** -0.5
    for B, H, N in ((1, 2, 1000), (1, 16, 10368)):
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32)).to(dev)
                       for _ in range(4))
        out, lse = flash_attention_forward(q, k, v, scale)
        again = flash_attention_forward(q, k, v, scale)
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        del again
        ref, ref_lse = flash_attention_plain(q, k, v, scale)
        delta = (do * out).sum(-1)
        ops = (q, k, v, do, lse, delta, scale)
        got = {"out": (out, ref), "dq": (flash_attention_backward_dq(*ops),
                                         flash_attention_backward_dq_plain(*ops))}
        got.update(zip(("dk", "dv"), zip(flash_attention_backward_dkv(*ops),
                                         flash_attention_backward_dkv_plain(*ops))))
        same = (same and torch.equal(got["dq"][0], flash_attention_backward_dq(*ops))
                and all(torch.equal(got[n][0], a) for n, a in
                        zip(("dk", "dv"), flash_attention_backward_dkv(*ops))))
        torch.cuda.synchronize()
        errs = {n: ((a - b).abs().max().item(), FLASH_F32_RTOL * b.abs().max().item())
                for n, (a, b) in got.items()}
        lerr = (lse - ref_lse).abs().max().item()
        finite = all(bool(torch.isfinite(a).all()) for a, _ in got.values())
        if (not finite or not same or lerr > FLASH_F32_LSE_ATOL
                or any(e > b for e, b in errs.values())):
            raise RuntimeError(f"float32 K4-K6 at N={N}: (err, bound) {errs}, lse err {lerr}, "
                               f"finite {finite}, two calls of each bitwise equal {same}")
        log(f"[K4-K6 float32] (B, H, N, D) = ({B}, {H}, {N}, 64): (err, bound {FLASH_F32_RTOL} "
            f"x max|ref|) " + ", ".join(f"{n} ({e:.3g}, {b:.3g})" for n, (e, b) in errs.items())
            + f", lse err {lerr:.3g} (atol {FLASH_F32_LSE_ATOL}), two calls of K4, K5 and K6 "
            "each bitwise equal")
        del got, out, ref, ref_lse
        torch.cuda.empty_cache()
        if N != 10368:
            del q, k, v, do, lse, delta, ops
            continue
        ms = {"fwd": timed_ms(lambda: flash_attention_forward(q, k, v, scale), 5),
              "dq": timed_ms(lambda: flash_attention_backward_dq(*ops), 5),
              "dkv": timed_ms(lambda: flash_attention_backward_dkv(*ops), 5)}
        plain = {"fwd": timed_ms(lambda: flash_attention_plain(q, k, v, scale), 1),
                 "dq": timed_ms(lambda: flash_attention_backward_dq_plain(*ops), 1),
                 "dkv": timed_ms(lambda: flash_attention_backward_dkv_plain(*ops), 1)}
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        lib_fwd = timed_ms(lambda: sdpa(qg, kg, vg, scale=scale), 5)
        lib_both = timed_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg, scale=scale),
                                                        (qg, kg, vg), do), 3)
        flops = {"fwd": 4 * B * H * N * N * 64, "dq": 6 * B * H * N * N * 64,
                 "dkv": 8 * B * H * N * N * 64}
        io = B * H * N * 64 * 4
        nbytes = {"fwd": 4 * io + B * H * N * 4, "dq": 5 * io + 2 * B * H * N * 4,
                  "dkv": 6 * io + 2 * B * H * N * 4}
        ffma = {n: f / FP32_FLOPS * 1e3 for n, f in flops.items()}
        bounds = {n: max(3 * f / TF32_FLOPS * 1e3, bytes_bound_ms(nbytes[n]))
                  for n, f in flops.items()}
        floor = exp_floor_ms(B * H * N * N)
        for name, lib in (("fwd", lib_fwd), ("dq", lib_both - lib_fwd),
                          ("dkv", lib_both - lib_fwd)):
            log(f"[K4-K6 float32 {name}] kernel {ms[name]:.4f} ms "
                f"({flops[name] / ms[name] / 1e9:.2f} TFLOP/s, {bounds[name] / ms[name]:.1%} of "
                f"the bound), plain {plain[name]:.2f} ms, bound {bounds[name]:.4f} ms "
                f"(operations, 3xTF32 at {TF32_FLOPS / 1e12:.0f} TFLOP/s; exp floor {floor:.4f} "
                f"ms, FP32 FFMA {ffma[name]:.4f} ms), sdpa float32 {lib:.4f} ms")
        err = {"fwd": errs["out"][0], "dq": errs["dq"][0],
               "dkv": max(errs["dk"][0], errs["dv"][0])}
        rows = {f"flash_attn_{k}_f32": dict(
                    max_abs_err=err[n], ms=ms[n], plain_ms=plain[n], bound_ms=bounds[n],
                    bound_by="operations", library_ms=lib)
                for n, k, lib in (("fwd", "fwd", lib_fwd), ("dq", "bwd_dq", lib_both - lib_fwd),
                                  ("dkv", "bwd_dkv", lib_both - lib_fwd))}
        del q, k, v, do, lse, delta, ops, qg, kg, vg
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def simt_route():
    """K4, K5 and K6 on the SIMT kernels (csrc/flash_attn_any.cu) at every
    head dim but 64, so that they are held to their plain versions and timed
    beside the any-head-dim tensor-core kernels in one run. Only this script
    does it; the port's route takes the tensor-core kernels wherever
    ops/attention.py::anydim_supports."""
    from cra5_tpu_torch.ops import attention

    saved = attention.anydim_supports
    attention.anydim_supports = lambda *a: False
    try:
        yield
    finally:
        attention.anydim_supports = saved


def flash_anydim_rows(rng, dev) -> dict:
    """The any-head-dim tensor-core K4, K5 and K6 (csrc/flash_attn_anydim.cu,
    csrc/flash_attn_anydim_f32.cu) at the 268v hyperprior's head dim 72 in
    float32, bf16 and float16, at (1, 5, 2048, 72) (where the hyperprior's
    width takes the flash route) and (1, 5, 10368, 72) (three waves and
    more): each against its plain version within the bound of the kernels
    of the same width, two calls bitwise equal, the SIMT K4, K5 and K6 held
    the same way; the time of each beside the SIMT kernel's, the plain
    versions' (at N = 2048), SDPA's forward and backward (forward + backward
    less forward; the library yardstick, K5's as K6's) and the tensor-core
    bound at D itself (bf16/f16 at 989 TFLOP/s, float32 as three TF32
    products at 495) with the exp floor beside it; at N = 2048 also the
    device time a call of each kernel and of SDPA (torch.profiler). Returns
    the float32 and bf16 rows of the kernels line at N = 2048."""
    from cra5_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_forward,
        flash_attention_plain,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, D = 1, 5, 72
    scale = D ** -0.5
    rows = {}
    for N in (2048, 10368):
        for dtype, rtol, lse_atol, tag in (
                (torch.float32, FLASH_F32_RTOL, FLASH_F32_LSE_ATOL, "_f32"),
                (torch.bfloat16, FLASH_GRAD_RTOL, FLASH_LSE_ATOL, ""),
                (torch.float16, FLASH_GRAD_RTOL, FLASH_LSE_ATOL, None)):
            q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, D), np.float32))
                           .to(dev, dtype) for _ in range(4))
            fwd = lambda: flash_attention_forward(q, k, v, scale)
            out, lse = fwd()
            delta = (do.float() * out.float()).sum(-1)
            ops = (q, k, v, do, lse, delta, scale)
            dkv = lambda: flash_attention_backward_dkv(*ops)
            dq = lambda: flash_attention_backward_dq(*ops)
            got = {"out": out, "dq": dq()}
            got["dk"], got["dv"] = dkv()
            again = {"out": fwd()[0], "dq": dq()}
            again["dk"], again["dv"] = dkv()
            same = all(torch.equal(got[n], again[n]) for n in got)
            with simt_route():
                s_out, s_lse = fwd()
                got["out SIMT"], got["dq SIMT"] = s_out, dq()
                got["dk SIMT"], got["dv SIMT"] = dkv()
            ref_out, ref_lse = flash_attention_plain(q, k, v, scale)
            refs = {"out": ref_out, "dq": flash_attention_backward_dq_plain(*ops)}
            refs["dk"], refs["dv"] = flash_attention_backward_dkv_plain(*ops)
            refs.update({"out SIMT": ref_out, "dq SIMT": refs["dq"], "dk SIMT": refs["dk"],
                         "dv SIMT": refs["dv"]})
            torch.cuda.synchronize()
            errs = {n: ((a.float() - refs[n].float()).abs().max().item(),
                        rtol * refs[n].float().abs().max().item()) for n, a in got.items()}
            lerr = max((lse - ref_lse).abs().max().item(), (s_lse - ref_lse).abs().max().item())
            finite = all(bool(torch.isfinite(a).all()) for a in got.values())
            if not finite or not same or lerr > lse_atol or any(e > b for e, b in errs.values()):
                raise RuntimeError(f"any-head-dim K4-K6 {dtype} at {(B, H, N, D)}: (err, bound) "
                                   f"{errs}, lse err {lerr}, finite {finite}, two calls bitwise "
                                   f"equal {same}")
            del got, again, refs, ref_out, ref_lse, s_out, s_lse
            torch.cuda.empty_cache()

            it = 20 if N == 2048 else 10
            ms = {"fwd": timed_ms(fwd, it), "dkv": timed_ms(dkv, it), "dq": timed_ms(dq, it)}
            with simt_route():
                simt = {"fwd": timed_ms(fwd, 3), "dkv": timed_ms(dkv, 3), "dq": timed_ms(dq, 3)}
            plain = ({"fwd": timed_ms(lambda: flash_attention_plain(q, k, v, scale), 1),
                      "dkv": timed_ms(lambda: flash_attention_backward_dkv_plain(*ops), 1),
                      "dq": timed_ms(lambda: flash_attention_backward_dq_plain(*ops), 1)}
                     if N == 2048 else None)
            qg, kg, vg = (a.detach().requires_grad_() for a in (q, k, v))
            lib_fwd = timed_ms(lambda: sdpa(qg, kg, vg, scale=scale), it)
            lib_bwd = timed_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg, scale=scale),
                                                           (qg, kg, vg), do), it) - lib_fwd
            if N == 2048:  # event times at this size come near the host's issue rate
                dev_us = {n: device_us(f) for n, f in (
                    ("K4", fwd), ("K6", dkv), ("K5", dq),
                    ("sdpa forward", lambda: sdpa(qg, kg, vg, scale=scale)),
                    ("sdpa forward + backward", lambda: torch.autograd.grad(
                        sdpa(qg, kg, vg, scale=scale), (qg, kg, vg), do)))}
                log(f"[K4-K6 anydim device {str(dtype)[6:]}] ({B}, {H}, {N}, {D}): " + ", ".join(
                    f"{n} {u:.2f} us" for n, u in dev_us.items()) + " (device time a call)")
            del qg, kg, vg
            flops = {"fwd": 4 * B * H * N * N * D, "dkv": 8 * B * H * N * N * D,
                     "dq": 6 * B * H * N * N * D}
            io, stats = B * H * N * D * q.element_size(), B * H * N * 4
            nbytes = {"fwd": 4 * io + stats, "dkv": 6 * io + 2 * stats, "dq": 5 * io + 2 * stats}
            mult, peak = (3, TF32_FLOPS) if dtype == torch.float32 else (1, BF16_FLOPS)
            bounds = {n: max(mult * f / peak * 1e3, bytes_bound_ms(nbytes[n]))
                      for n, f in flops.items()}
            floor = exp_floor_ms(B * H * N * N)
            lib = {"fwd": lib_fwd, "dkv": lib_bwd, "dq": lib_bwd}
            name = str(dtype)[6:]
            log(f"[K4-K6 anydim {name}] (B, H, N, D) = ({B}, {H}, {N}, {D}): (err, bound {rtol} "
                f"x max|ref|) " + ", ".join(f"{n} ({e:.3g}, {b:.3g})" for n, (e, b) in errs.items())
                + f", lse err {lerr:.3g} (atol {lse_atol}), two calls of each bitwise equal")
            for n, label in (("fwd", "K4 anydim"), ("dkv", "K6 anydim"), ("dq", "K5 anydim")):
                simt_txt = f", SIMT {simt[n]:.4f} ms"
                plain_txt = f", plain {plain[n]:.4f} ms" if plain else ""
                log(f"[{label} {name}] ({B}, {H}, {N}, {D}): kernel {ms[n]:.4f} ms "
                    f"({flops[n] / ms[n] / 1e9:.2f} TFLOP/s, {bounds[n] / ms[n]:.1%} of the bound)"
                    f"{simt_txt}{plain_txt}, bound {bounds[n]:.4f} ms (operations at D = {D}"
                    f"{', 3xTF32' if mult == 3 else ''}; exp floor {floor:.4f} ms, FP32 FMA "
                    f"{flops[n] / FP32_FLOPS * 1e3:.4f} ms), sdpa "
                    f"{'forward' if n == 'fwd' else 'backward'} {lib[n]:.4f} ms")
            if N == 2048 and tag is not None:
                err = {"fwd": errs["out"][0], "dkv": max(errs["dk"][0], errs["dv"][0]),
                       "dq": errs["dq"][0]}
                for n, key in (("fwd", "flash_attn_fwd_anydim"),
                               ("dkv", "flash_attn_bwd_dkv_anydim"),
                               ("dq", "flash_attn_bwd_dq_anydim")):
                    rows[key + tag] = dict(max_abs_err=err[n], ms=ms[n], plain_ms=plain[n],
                                           bound_ms=bounds[n], bound_by="operations",
                                           library_ms=lib[n])
            del q, k, v, do, out, lse, delta, ops
            torch.cuda.empty_cache()
    return rows


def flash_wide_rows(rng, dev) -> None:
    """C5: the SIMT K4, K5 and K6 (csrc/flash_attn_any.cu) at head dims past
    256, which they walk in 256-column chunks, at (1, 2, 2048, D) for D = 320
    and 520 in bf16 and float32: each against its plain version within the
    bound of the kernels of the same width, two calls bitwise equal; then
    event ms and device us a call of each beside SDPA's forward and
    backward (forward + backward less forward) on the same operands, and
    the operations bound at D (bf16 at 989 TFLOP/s, float32 as three TF32
    products at 495) with the exp floor beside it."""
    from cra5_tpu_torch.ops.attention import (
        anydim_supports,
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_forward,
        flash_attention_plain,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, N = 1, 2, 2048
    for D in (320, 520):
        scale = D ** -0.5
        for dtype, rtol, lse_atol in ((torch.bfloat16, FLASH_GRAD_RTOL, FLASH_LSE_ATOL),
                                      (torch.float32, FLASH_F32_RTOL, FLASH_F32_LSE_ATOL)):
            assert not anydim_supports(dtype, D)
            q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, D), np.float32))
                           .to(dev, dtype) for _ in range(4))
            fwd = lambda: flash_attention_forward(q, k, v, scale)
            out, lse = fwd()
            delta = (do.float() * out.float()).sum(-1)
            ops = (q, k, v, do, lse, delta, scale)
            dq = lambda: flash_attention_backward_dq(*ops)
            dkv = lambda: flash_attention_backward_dkv(*ops)
            got = {"out": out, "dq": dq()}
            got["dk"], got["dv"] = dkv()
            again = {"out": fwd()[0], "dq": dq()}
            again["dk"], again["dv"] = dkv()
            same = all(torch.equal(got[n], again[n]) for n in got)
            ref_out, ref_lse = flash_attention_plain(q, k, v, scale)
            refs = {"out": ref_out, "dq": flash_attention_backward_dq_plain(*ops)}
            refs["dk"], refs["dv"] = flash_attention_backward_dkv_plain(*ops)
            torch.cuda.synchronize()
            errs = {n: ((a.float() - refs[n].float()).abs().max().item(),
                        rtol * refs[n].float().abs().max().item()) for n, a in got.items()}
            lerr = (lse - ref_lse).abs().max().item()
            finite = all(bool(torch.isfinite(a).all()) for a in got.values())
            if not finite or not same or lerr > lse_atol or any(e > b for e, b in errs.values()):
                raise RuntimeError(f"SIMT K4-K6 {dtype} at {(B, H, N, D)}: (err, bound) {errs}, "
                                   f"lse err {lerr}, finite {finite}, two calls bitwise equal "
                                   f"{same}")
            del got, again, refs, ref_out, ref_lse
            ms = {"fwd": timed_ms(fwd, 5), "dq": timed_ms(dq, 5), "dkv": timed_ms(dkv, 5)}
            qg, kg, vg = (a.detach().requires_grad_() for a in (q, k, v))
            lib_f = lambda: sdpa(qg, kg, vg, scale=scale)
            lib_fb = lambda: torch.autograd.grad(sdpa(qg, kg, vg, scale=scale), (qg, kg, vg), do)
            lib = {"fwd": timed_ms(lib_f, 5)}
            lib["dq"] = lib["dkv"] = timed_ms(lib_fb, 5) - lib["fwd"]
            dev_us = {"fwd": device_us(fwd, 5), "dq": device_us(dq, 5), "dkv": device_us(dkv, 5),
                      "sdpa forward": device_us(lib_f, 5),
                      "sdpa forward + backward": device_us(lib_fb, 5)}
            flops = {"fwd": 4 * B * H * N * N * D, "dq": 6 * B * H * N * N * D,
                     "dkv": 8 * B * H * N * N * D}
            mult, peak = (3, TF32_FLOPS) if dtype == torch.float32 else (1, BF16_FLOPS)
            io, stats = B * H * N * D * q.element_size(), B * H * N * 4
            nbytes = {"fwd": 4 * io + stats, "dq": 5 * io + 2 * stats, "dkv": 6 * io + 2 * stats}
            bounds = {n: max(mult * f / peak * 1e3, bytes_bound_ms(nbytes[n]))
                      for n, f in flops.items()}
            name = str(dtype)[6:]
            log(f"[K4/K5/K6 SIMT D={D} {name}] ({B}, {H}, {N}, {D}): (err, bound {rtol} x "
                f"max|ref|) " + ", ".join(f"{n} ({e:.3g}, {b:.3g})" for n, (e, b) in errs.items())
                + f", lse err {lerr:.3g} (atol {lse_atol}), two calls of each bitwise equal")
            for n, label in (("fwd", "K4"), ("dq", "K5"), ("dkv", "K6")):
                log(f"[K4/K5/K6 SIMT D={D} {name}] {label}: kernel {ms[n]:.4f} ms, device "
                    f"{dev_us[n]:.2f} us ({flops[n] / ms[n] / 1e9:.2f} TFLOP/s, "
                    f"{bounds[n] / ms[n]:.1%} of the bound), bound {bounds[n]:.4f} ms (operations "
                    f"at D = {D}{', 3xTF32' if mult == 3 else ''}; exp floor "
                    f"{exp_floor_ms(B * H * N * N):.4f} ms, FP32 FMA "
                    f"{flops[n] / FP32_FLOPS * 1e3:.4f} ms), sdpa "
                    f"{'forward' if n == 'fwd' else 'backward'} {lib[n]:.4f} ms")
            log(f"[K4/K5/K6 SIMT D={D} {name}] sdpa device: forward "
                f"{dev_us['sdpa forward']:.2f} us, forward + backward "
                f"{dev_us['sdpa forward + backward']:.2f} us")
            del q, k, v, do, out, lse, delta, ops, qg, kg, vg
            torch.cuda.empty_cache()


def host_us(fns: dict, n: int = 2000, rounds: int = 5) -> dict:
    """Host microseconds a call of each of ``fns`` (time.perf_counter_ns):
    ``rounds`` rounds in which each takes its turn at ``n`` back-to-back
    calls, after 100 warm-up calls; the median round, net of an empty
    call's. The card is synchronized around each turn, outside the clock."""
    fns = {"": lambda: None, **fns}
    times = defaultdict(list)
    for fn in fns.values():
        for _ in range(100):
            fn()
    for _ in range(rounds):
        for key, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            times[key].append((time.perf_counter_ns() - t0) / n / 1e3)
    torch.cuda.synchronize()
    loop = statistics.median(times.pop(""))
    return {k: statistics.median(v) - loop for k, v in times.items()}


def alternating_ms(fns: dict, iters: int = 1000, rounds: int = 5) -> dict:
    """Event ms a call of each of ``fns`` (timed_ms over ``iters`` calls),
    taking turns for ``rounds`` rounds; the median round of each. Host
    noise on the card's machine moves a short call's event time by tens of
    percent between moments, so calls that are compared take turns."""
    times = defaultdict(list)
    for _ in range(rounds):
        for key, fn in fns.items():
            times[key].append(timed_ms(fn, iters, warmup=20))
    return {k: statistics.median(v) for k, v in times.items()}


def k8_host_breakdown(dev, words, s) -> None:
    """The [K8 issue] lines: where the host time of a K8 call (the rate at
    which the host issues it) goes, in host us a call (``host_us``: 10 000
    calls each, the steps taking turns). Each step of the lean launch path
    (cra5_tpu_torch/kernels.py) and of a wrapper built on Stream objects
    and torch.device checks (written out here), the stream lookups and
    output allocations that were candidates, the empty kernel behind K8's
    argument list in the call forms ctypes offers
    (profiling/launch_floor.py), and torch.roll as a whole."""
    import ctypes

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.profiling import launch_floor
    from cra5_tpu_torch.profiling import perm_probe as pp

    index = words.get_device()
    out = torch.empty_like(words)
    cdll, pydll = (loader(str(kernels.build())).cra5_perm_dynroll
                   for loader in (ctypes.CDLL, ctypes.PyDLL))
    for fn in (cdll, pydll):
        fn.argtypes, fn.restype = kernels._SIGNATURES["cra5_perm_dynroll"], ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (words.data_ptr(), s.data_ptr(), out.data_ptr())

    def old_checks(x=words, shift=s):
        if x.dim() != 2 or shift.numel() != 1 or shift.device != x.device:
            raise ValueError
        if x.device.type == "cpu" or x.device.type != "cuda":
            raise ValueError
        if x.dtype != torch.int32 or shift.dtype != torch.int32 or not x.is_contiguous():
            raise TypeError

    def old_wrapper(x=words, shift=s):
        old_checks(x, shift)
        o = torch.empty_like(x)
        status = cdll(x.data_ptr(), shift.data_ptr(), o.data_ptr(), x.shape[0], x.shape[1],
                      torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(status, "dynroll")
        return o

    steps = {
        "old checks": old_checks,
        "empty_like": lambda: torch.empty_like(words),
        "current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "3 data_ptr": lambda: (words.data_ptr(), s.data_ptr(), out.data_ptr()),
        "CDLL call (launch, cudaGetLastError)": lambda: cdll(*ptrs, 8, 1024, stream),
        "PyDLL call": lambda: pydll(*ptrs, 8, 1024, stream),
        "check": lambda: kernels.check(0, "dynroll"),
        "old whole": old_wrapper,
        "torch.roll": lambda: torch.roll(words, 3, 1),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "current_stream(index).cuda_stream": lambda: torch.cuda.current_stream(index).cuda_stream,
        "raw_stream(index)": lambda: kernels.raw_stream(index),
        "new_empty": lambda: words.new_empty((8, 1024)),
        "empty(shape, dtype, device)": lambda: torch.empty((8, 1024), dtype=torch.int32,
                                                          device=dev),
        "lean checks": lambda: pp._check_dynroll(words, s),
        "shape": lambda: tuple(words.shape),
        "lib() call, check": lambda: kernels.check(kernels.lib().cra5_perm_dynroll(
            *ptrs, 8, 1024, stream), "dynroll"),
        "lean whole": lambda: pp.dynroll(words, s),
        **{f"empty kernel, {k}": fn for k, fn in launch_floor.call_forms(index, ptrs).items()},
    }
    us = host_us(steps)
    group = lambda keys: ", ".join(f"{k} {us[k]:.3f}" for k in keys)
    old = ["old checks", "empty_like", "current_stream(dev).cuda_stream", "3 data_ptr",
           "CDLL call (launch, cudaGetLastError)", "check"]
    lean = ["lean checks", "empty_like", "raw_stream(index)", "3 data_ptr", "shape",
            "lib() call, check"]
    log(f"[K8 issue] Stream-object wrapper, host us a call: {group(old)}; sum "
        f"{sum(us[k] for k in old):.3f}, whole {us['old whole']:.3f}; torch.roll "
        f"{us['torch.roll']:.3f}")
    log(f"[K8 issue] lean path, host us a call: {group(lean)}; sum "
        f"{sum(us[k] for k in lean):.3f}, whole {us['lean whole']:.3f}")
    same = kernels.raw_stream(index) == torch.cuda.current_stream(dev).cuda_stream
    log("[K8 issue] stream lookups: " + group([
        "current_stream(dev).cuda_stream", "current_stream().cuda_stream",
        "current_stream(index).cuda_stream", "raw_stream(index)"])
        + f"; raw_stream gives current_stream's handle: {same}; outputs: "
        + group(["empty_like", "new_empty", "empty(shape, dtype, device)"]))
    log("[K8 issue] call forms: " + group(["CDLL call (launch, cudaGetLastError)", "PyDLL call"]
                                          + [k for k in us if k.startswith("empty kernel")]))
    if not same:
        raise RuntimeError("kernels.raw_stream differs from current_stream().cuda_stream")


def perm_rows(rng, dev, extras: bool = True) -> dict:
    """K7 (expand) at the probe's (8, 1024) and at (16, 1024), and K8
    (dynroll) at (8, 1024), against their plain versions exactly: K7 at
    mask densities 0, 1 and 0.6, K8 at shifts 0, 3, 1023, -1025 and 2047
    (and against torch.roll). Each is timed by CUDA events over
    back-to-back calls (ms a call, the host's issue rate where that is the
    longer) and by device time, torch.roll beside K8. Both are
    launch-bound; the bound is the bytes of their operands. With
    ``extras``: the launch floor (an empty kernel through the same ctypes
    path, profiling/launch_floor.py) and the [K8 issue] breakdown."""
    from cra5_tpu_torch.profiling import perm_probe as pp

    t = lambda a: torch.from_numpy(a).to(dev)
    rows = {}
    for shape in ((pp.R, pp.KD), (16, pp.KD)):
        words = t(rng.integers(0, 1 << 16, shape).astype(np.int32))
        for density in (0.0, 1.0, 0.6):
            mask = t((rng.random(shape) < density).astype(np.int32))
            got, want = pp.expand(mask, words), pp.expand_plain(mask, words)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K7 expand differs from its plain version at {shape}, "
                                   f"density {density}")
        run = lambda: pp.expand(mask, words)
        ms, us = timed_ms(run, 2000, warmup=50), device_us(run, 50)
        plain = timed_ms(lambda: pp.expand_plain(mask, words), 20)
        bound = bytes_bound_ms(3 * words.numel() * 4)
        log(f"[K7 perm_expand] {shape} exact at densities 0, 1, 0.6; kernel {ms:.4f} ms, device "
            f"{us:.2f} us, plain {plain:.4f} ms, bound {bound:.6f} ms (bytes)")
        if shape == (pp.R, pp.KD):
            rows["perm_expand"] = dict(max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bound,
                                       bound_by="bytes", library_ms=None)
    words = t(rng.integers(0, 1 << 16, (pp.R, pp.KD)).astype(np.int32))
    for shift in (0, 3, 1023, -1025, 2047):
        s = torch.tensor([shift], dtype=torch.int32, device=dev)
        got = pp.dynroll(words, s)
        if not (torch.equal(got, pp.dynroll_plain(words, s))
                and torch.equal(got, torch.roll(words, shift, 1))):
            raise RuntimeError(f"K8 dynroll differs from its plain version at shift {shift}")
    s = torch.tensor([3], dtype=torch.int32, device=dev)
    run, roll = lambda: pp.dynroll(words, s), lambda: torch.roll(words, 3, 1)
    ms, lib = alternating_ms({"K8": run, "roll": roll}).values()
    us, lib_us = device_us(run, 50), device_us(roll, 50)
    plain = timed_ms(lambda: pp.dynroll_plain(words, s), 50, warmup=5)
    bound = bytes_bound_ms(2 * words.numel() * 4 + 4)
    log(f"[K8 perm_dynroll] {tuple(words.shape)} exact at shifts 0, 3, 1023, -1025, 2047; kernel "
        f"{ms:.4f} ms, device {us:.2f} us; torch.roll {lib:.4f} ms, device {lib_us:.2f} us; "
        f"plain {plain:.4f} ms (reads the shift to the host); bound {bound:.6f} ms (bytes)")
    rows["perm_dynroll"] = dict(max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by="bytes", library_ms=lib)
    if extras:
        from cra5_tpu_torch.profiling import launch_floor

        empty = lambda: launch_floor.empty(dev.index)
        log(f"[launch floor] an empty kernel through the same ctypes path: device "
            f"{device_us(empty, 50):.2f} us, {timed_ms(empty, 2000, warmup=50):.4f} ms a call "
            f"(events), host {host_us({'floor': empty})['floor']:.3f} us a call")
        k8_host_breakdown(dev, words, s)
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
    from cra5_tpu_torch.models.vaeformer import vaeformer_268

    cfg = vaeformer_268()
    block_grads(dev, dtype, rtol, cfg.y_channels, cfg.num_heads, cfg.latent_grid,
                layer_id=cfg.interval - 1, remat=True, tag="268v global block")


def block_grads(dev, dtype, rtol, dim, heads, grid, layer_id, remat, tag) -> dict:
    """A global ViT block of width ``dim`` over a ``grid`` of tokens, batch
    1, seeded, forward and backward through autograd, first with attention
    on the flash route (the launch counters zeroed just before and read
    just after; K4 once, or twice under remat, K5 and K6 once), then on the
    plain path (no launch): the gradients of its input, qkv and proj of the
    flash route each within rtol x max |ref| of the plain path's. Returns
    the flash route's launches."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.nn import blocks
    from cra5_tpu_torch.nn.vit import _run_block

    Hp, Wp = grid
    gen = torch.Generator(device=dev).manual_seed(SEED)
    blk = blocks.Block(dim, heads, layer_id=layer_id, dtype=dtype, device=dev)
    for m in blk.modules():
        if m is not blk and hasattr(m, "reset_parameters") and not isinstance(m, torch.nn.Linear):
            m.reset_parameters(gen)
    x = torch.randn((1, Hp * Wp, dim), generator=gen, device=dev).to(dtype)
    w = torch.randn(x.shape, generator=gen, device=dev)
    watch = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight")
    grads, flash_launches = {}, None
    use_flash = blocks._use_flash
    for route in ("flash", "plain"):
        if route == "plain":
            blocks._use_flash = lambda *a: False
        try:
            blk.zero_grad(set_to_none=True)
            xg = x.clone().requires_grad_()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            (_run_block(blk, xg, Hp, Wp, remat=remat).float() * w).sum().backward()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            blocks._use_flash = use_flash
        params = dict(blk.named_parameters())
        grads[route] = {"x": xg.grad, **{k: params[k].grad.clone() for k in watch}}
        want = (1 + remat, 1, 1) if route == "flash" else (0, 0, 0)
        got = tuple(launches[k] for k in ("flash_attention_forward", "flash_attention_backward_dq",
                                          "flash_attention_backward_dkv"))
        if got != want:
            raise RuntimeError(f"{tag}, {route} route: flash launches {got}, expected {want}")
        flash_launches = flash_launches or launches
        del xg
        torch.cuda.empty_cache()
    errs = {k: ((grads["flash"][k].float() - ref.float()).abs().max().item(),
                rtol * ref.float().abs().max().item())
            for k, ref in grads["plain"].items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads["flash"].values())
    if not finite or any(not e <= b for e, b in errs.values()):
        raise RuntimeError(f"{tag} gradients, flash vs plain: (err, bound) {errs}, "
                           f"finite {finite}")
    log(f"[reference] {tag} (1, {Hp * Wp}, {dim}), {heads} heads of {dim // heads}, {dtype}"
        f"{' remat' if remat else ''}, gradients through FlashAttention vs the plain path, "
        f"(err, bound {rtol} x max|ref|): "
        + ", ".join(f"{k} ({e:.3g}, {b:.3g})" for k, (e, b) in errs.items()))
    del blk, grads, x, w
    torch.cuda.empty_cache()
    return flash_launches


def phase_hyper_width(dev) -> dict:
    """The hyper_width path: one global ViT block at the 268v hyperprior's
    width (360, 5 heads of 72) on N = 2048 tokens (a 32 x 64 grid, where
    attention takes the flash route), batch 1, forward and backward in bf16
    and then in float32, each against the plain path (block_grads). Its K4,
    K5 and K6 are the any-head-dim tensor-core kernels
    (csrc/flash_attn_anydim.cu, csrc/flash_attn_anydim_f32.cu). Returns each
    dtype's launches."""
    from cra5_tpu_torch.models.vaeformer import vaeformer_268

    cfg = vaeformer_268()
    return {name: block_grads(dev, dtype, rtol, cfg.hyper_embed_dim, cfg.hyper_num_heads,
                              (32, 64), layer_id=None, remat=False,
                              tag=f"hyper_width {name} block")
            for name, dtype, rtol in (("bf16", torch.bfloat16, FLASH_GRAD_RTOL),
                                      ("f32", torch.float32, FLASH_F32_RTOL))}


def phase_main_path(dev) -> dict:
    from cra5_tpu_torch import bench, kernels
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
    want = _with_containers(want)
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
    z_dec, y_dec = bench.decode_symbols(codec, out["strings"], out["z_shape"])
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


CALIB_STEPS = 600  # the bench's calibration steps


def phase_calibrate(codec, dev) -> dict:
    """The main path's bf16 268v model: two seeded latents through g_a (K4
    at (1, 16, 10368, 64), 4 launches each), then calibrate_entropy for the
    bench's steps; the bits per latent element fall, and no tower
    parameter moves (bitwise) or gets a gradient."""
    from cra5_tpu_torch import bench, kernels
    from cra5_tpu_torch.train import TRAINABLE, calibrate_entropy

    model = codec.model
    towers = {k: p.detach().clone() for k, p in model.named_parameters()
              if k.split(".")[0] not in TRAINABLE}
    kernels.reset_launch_counts()
    t0 = time.time()
    with torch.inference_mode():
        lats = [model.encode_latent(bench.field(model.cfg, dev, seed=100 + i)) for i in range(2)]
    torch.cuda.synchronize()
    t1 = time.time()
    res = calibrate_entropy(model, lats, steps=CALIB_STEPS)
    torch.cuda.synchronize()
    t2 = time.time()
    launches = kernels.launch_counts()
    want = {k: 0 for k in launches}
    want.update(flash_attention_forward=8)
    if launches != want:
        raise RuntimeError(f"calibrate launches {launches}, expected {want}")
    moved = [k for k, p in model.named_parameters() if k in towers
             and (p.grad is not None or not torch.equal(p.detach(), towers[k]))]
    if moved:
        raise RuntimeError(f"calibration moved or gave a gradient to tower parameters {moved[:5]}")
    if not res["bpe_last"] < res["bpe_first"]:
        raise RuntimeError(f"calibration did not lower the bits per element: {res}")
    log(f"[calibrate] vaeformer_268 bf16: 2 latents {tuple(lats[0].shape)} through g_a "
        f"{t1 - t0:.2f} s (K4 launched {launches['flash_attention_forward']}x); "
        f"{res['steps']} steps {t2 - t1:.2f} s ({(t2 - t1) / res['steps'] * 1e3:.2f} ms a step); "
        f"bits per latent element {res['bpe_first']:.4f} at the first step, "
        f"{res['bpe_last']:.4f} at the last; {len(towers)} tower parameters bitwise unchanged, "
        f"none with a gradient")
    del towers, lats
    codec.update(force=True)
    return dict(calibration=res, seconds=t2 - t1, launches=launches)


def phase_calibrated_roundtrip(codec, x, dev, uncal: dict) -> dict:
    """The calibrated codec compresses and decompresses the main phase's
    field: bytes, escapes, stage ms and the roundtrip beside the
    uncalibrated figures; the decoded symbols equal the encoded ones."""
    from cra5_tpu_torch import bench, kernels
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header

    model = codec.model
    out = codec.compress(x)  # warm-up
    codec.decompress(out["strings"], out["z_shape"])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    out = codec.compress(x)
    torch.cuda.synchronize()
    t1 = time.time()
    x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    torch.cuda.synchronize()
    t2 = time.time()
    launches = kernels.launch_counts()
    y_str, z_str = out["strings"][0][0], out["strings"][1][0]
    yh = parse_v2_header(y_str)
    k3 = int(yh[4] and yh[5])
    want = {k: 0 for k in launches}
    want.update(rans_encode=2, rans_decode_generic=2 - k3, rans_decode_sorted=k3,
                flash_attention_forward=7)
    want = _with_containers(want)
    if launches != want:
        raise RuntimeError(f"calibrated roundtrip launches {launches}, expected {want}")
    with torch.inference_mode():
        enc = model.encode_symbols(torch.from_numpy(x).to(dev))
    z, y = bench.decode_symbols(codec, out["strings"], out["z_shape"])
    if not (torch.equal(z, enc["z_sym"]) and torch.equal(y, enc["y_sym"])):
        raise RuntimeError("calibrated roundtrip: decoded symbols differ from the encoded ones")
    if not torch.isfinite(x_hat).all():
        raise RuntimeError("calibrated roundtrip: x_hat is not finite")
    total, uncal_total = len(y_str) + len(z_str), uncal["y_bytes"] + uncal["z_bytes"]
    if not total < uncal_total:
        raise RuntimeError(f"calibrated streams {total} B are not below the uncalibrated "
                           f"{uncal_total} B")
    codec.stage_times = {}
    o = codec.compress(x)
    codec.decompress(o["strings"], o["z_shape"])
    stages, codec.stage_times = codec.stage_times, None
    log(f"[calibrated] y {len(y_str)} B ({yh[2]} escapes of {yh[0]}, {yh[2] / yh[0]:.2%}), z "
        f"{len(z_str)} B, y+z {total} B; uncalibrated y {uncal['y_bytes']} B ({uncal['y_escapes']} "
        f"escapes), z {uncal['z_bytes']} B, y+z {uncal_total} B; y header {yh}")
    log(f"[calibrated] compress {t1 - t0:.4f} s, decompress {t2 - t1:.4f} s, roundtrip "
        f"{t2 - t0:.4f} s (uncalibrated {uncal['roundtrip_s']:.4f} s); symbols roundtrip "
        f"exactly; launches {launches}")
    log("[calibrated] stages (each ends in a synchronize): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))
    return dict(roundtrip_s=t2 - t0, y_bytes=len(y_str), z_bytes=len(z_str), y_escapes=yh[2],
                launches=launches)


def phase_bench(codec, dev, calibration: dict) -> dict:
    """cra5_tpu_torch/bench.py's functions in-process on the calibrated
    model (no second fit) at a short setting: 3 iterations, one pipelined
    window at the bench's concurrency, the production point, config 4,
    config 3 at batch 2 only, configs 1 and 5 skipped. Prints the headline
    JSON and the detail."""
    from cra5_tpu_torch import bench, kernels

    s = bench.Setup(codec.model, codec, bench.field(codec.model.cfg, dev, seed=0), dev,
                    bench.card_line(dev), {"calibration": calibration})
    conc = 6
    per_window = 2 * conc
    kernels.reset_launch_counts()
    t0 = time.time()
    result, detail = bench.headline(s, iters=3, warmup=1, concurrency=conc,
                                    per_window=per_window, n_windows=1)
    bench.run_extras(s, detail, iters=3, concurrency=conc, per_window=per_window, n_windows=1,
                     production=True, prod_bytes=2.6e6, configs34=True, full=False,
                     batches=(2,), budget=bench.Budget(600), calibrate=False, calib_steps=0)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for k in ("rans_encode", "rans_decode_generic", "rans_decode_sorted",
              "flash_attention_forward"):
        if launches[k] == 0:
            raise RuntimeError(f"bench: {k} was not launched ({launches})")
    log(f"[bench] detail {json.dumps(detail)}")
    log(f"[bench] {time.time() - t0:.2f} s; launches {launches}")
    print(json.dumps(result), flush=True)
    return dict(result=result, detail=detail, launches=launches)


# --configs: the published training configurations at their batch of 4
CONFIG_YEARS = ("2020-01-01T00:00:00", "2020-01-01T18:00:00")  # four six-hourly stamps
CONFIG_STEPS = {"268": 2, "159": 2}  # CLI steps a model; the config's `steps` stays the horizon
CONFIG_SCHEDULE = dict(type="WarmupCosineLR", warmup_steps=2000, min_lr_ratio=0.1)
CONFIG_HORIZON = 300_000  # train_era5_base.py's `steps`
CONFIG_LR_RTOL = 1e-9
CONFIG_HEADROOM = 2 * 2**30  # a run must fit the card's memory less this
# a 268v window block's attention at batch 4: 18 windows of 24 x 24 or
# 12 x 48 over the 72 x 144 grid, or 24 of 48 x 12 (the grid padded to 96 rows)
CONFIG_WINDOW = ((72, 16, 576, 64), (96, 16, 576, 64))
# (window, global) blocks of g_a and g_s on K4-K6 a forward by batch under
# "auto" (nn/blocks.py::_use_flash): the 7 global blocks always; the 18
# window blocks from batch 3, where their float32 logits (batch x 18 or
# 24 windows x 16 heads x 576^2 x 4 B) pass 1 GiB. The 648-token hyperprior
# blocks stay on the plain path.
CONFIG_FLASH = {1: (0, 7), 2: (0, 7), 4: (18, 7)}
# What the derived configs add to the published ones, fixed here (not
# reached by catching an out-of-memory error): remat. As published (float32,
# no remat) batch 4 does not fit one card: float32_reckoning measures batch
# 1 and 2 and prints the reckoning. With remat, float32 fits, so the
# published dtype stays.
CONFIG_REMAT = True


def _published(model: str):
    """(the path of the port's train_era5_<model>v_1h.py, its Config)."""
    import os

    from cra5_tpu_torch.tools import train as train_cli
    from cra5_tpu_torch.utils.config import Config

    path = os.path.abspath(os.path.join(os.path.dirname(train_cli.__file__), "..", "api",
                                        "configs", f"train_era5_{model}v_1h.py"))
    return path, Config.fromfile(path)


def _model_cfg(model: str, remat=False):
    import dataclasses

    from cra5_tpu_torch.models.vaeformer import vaeformer_159, vaeformer_268

    return dataclasses.replace({"268": vaeformer_268, "159": vaeformer_159}[model](), remat=remat)


def flash_per_forward(layout: list, batch: int) -> dict:
    """The attentions of one forward at ``batch`` that the flash mode sends
    to K4 on the card, by tower and kind, from a built model's
    ``attention_layout`` (profiling/train_memory.py)."""
    from cra5_tpu_torch.nn import blocks

    out = {}
    for tower, n, windows, heads in layout:
        kind = f"{tower} {'global' if windows == 1 else 'window'}"
        out[kind] = out.get(kind, 0) + bool(
            blocks._use_flash(n, batch * windows * heads, torch.device("cuda")))
    return out


def _hold_flash_layout(layout: dict, batch: int, tag: str) -> int:
    """Raise unless the flash attentions a forward at ``batch`` (
    flash_per_forward) are CONFIG_FLASH's window and global counts; returns
    their sum."""
    window = layout.get("g_a window", 0) + layout.get("g_s window", 0)
    glob = layout.get("g_a global", 0) + layout.get("g_s global", 0)
    hyper = sum(v for k, v in layout.items() if k.startswith("h_"))
    if (window, glob, hyper) != (*CONFIG_FLASH[batch], 0):
        raise RuntimeError(f"[{tag}] flash attentions a forward at batch {batch}: {layout}, "
                           f"expected {CONFIG_FLASH[batch]} window and global blocks and no "
                           f"hyperprior block")
    return window + glob


def write_config_tree(root: str, card: str) -> dict:
    """One seeded .npy tree of the CONFIG_YEARS stamps for both published
    models: 268v's channels and the one more of 159v's (tp6h), each file
    once (ERA5NpyDataset.save_timestep). Returns each model's dataset over
    it."""
    import os

    from cra5_tpu_torch.data import ERA5NpyDataset

    ds = {}
    for model in ("268", "159"):
        d = _published(model)[1]["dataset"]
        ds[model] = ERA5NpyDataset(root, d["vnames"], d["pressure_level"], CONFIG_YEARS,
                                   d["time_interval"])
    n268, n159 = ds["268"].channel_names(), ds["159"].channel_names()
    extra = [n for n in n159 if n not in n268]
    if (len(n268), len(n159), extra, len(ds["268"])) != (268, 159, ["tp6h"], 4):
        raise RuntimeError(f"[configs] 159v's channels beyond 268v's: {extra}; "
                           f"{len(ds['268'])} stamps")
    names = n268 + extra
    t0 = time.time()
    rng = np.random.default_rng(SEED)
    for ts in ds["268"].timestamps:
        data = rng.standard_normal((len(names), *_model_cfg("268").img_size),
                                   dtype=np.float32) * np.float32(0.5)
        ERA5NpyDataset.save_timestep(root, ts, data, names)
    del data
    nbytes = sum(os.path.getsize(os.path.join(d, n)) for d, _, fs in os.walk(root) for n in fs)
    log(f"[configs] wrote {len(ds['268'])} timesteps x {len(names)} channels (268v's and tp6h; "
        f"159v's {len(n159)} among them) as .npy, {nbytes / 1e9:.2f} GB, in "
        f"{time.time() - t0:.2f} s  ({card})")
    return ds


def float32_reckoning(dev, card: str) -> None:
    """The published 268v config as it stands (float32, no remat), its
    trainer block, one step at batch 1, then one at batch 2, on a card
    batch in a process of its own under "auto" (profiling/train_memory.py:
    a fresh allocator, whatever this process's earlier phases left cached): the
    peaks, and batch 4 reckoned from them, the slope a sample less the
    window blocks' saved float32 softmax, which from batch 3 K4-K6 hold
    instead. Gates: each step's K4, K5 and K6 launches the layout's global
    blocks (CONFIG_FLASH), its loss and bpp finite, and the reckoning over
    the card (else the published config needs no remat, CONFIG_REMAT)."""
    import os

    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True", "CRA5_TPU_FLASH": "auto"}
    r = subprocess.run([sys.executable, "-m", "cra5_tpu_torch.profiling.train_memory",
                        "--dtype", "float32", "--batch", "1,2", "--steps", "1"], cwd=root,
                       env=env, capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"[configs] train_memory exited {r.returncode}: {r.stderr[-3000:]}")
    runs = {run["batch"]: run for run in map(json.loads, r.stdout.strip().splitlines()[-2:])}
    for b, run in sorted(runs.items()):
        n = _hold_flash_layout(flash_per_forward(run["attention"], b), b, "configs")
        want = {k: n for k in ("flash_attention_forward", "flash_attention_backward_dq",
                               "flash_attention_backward_dkv")}
        mt = run["metrics"]
        if (run["flash_mode"] != "auto" or run["remat"] or run["launches"] != want
                or not all(np.isfinite(mt[k]) for k in ("loss", "bpp_loss", "total_loss"))):
            raise RuntimeError(f"[configs] train_memory at batch {b}: mode {run['flash_mode']}, "
                               f"remat {run['remat']}, launches {run['launches']} (expected "
                               f"{want}), metrics {mt}")
    peaks = {b: run["peak_gib"] * 2**30 for b, run in runs.items()}
    window = [r for r in runs[1]["attention"] if r[0] in ("g_a", "g_s") and r[2] > 1]
    softmax = sum(windows * heads * n * n * 4 for _, n, windows, heads in window)
    slope = peaks[2] - peaks[1]
    reckoned = peaks[1] + 3 * slope - 4 * softmax
    limit = torch.cuda.get_device_properties(dev).total_memory - CONFIG_HEADROOM
    _, n, _, heads = window[0]
    by_windows = ", ".join(f"{sum(r[2] == w for r in window)} at {w}"
                           for w in sorted({r[2] for r in window}))
    line = (f"[configs] float32 268v without remat (as published), its trainer block, one step "
            f"at batch 1, then at 2, on a card batch in a process of its own (this one holding {held[0] / 2**30:.2f} "
            f"GiB, {held[1] / 2**30:.2f} reserved): batch 1 peak {peaks[1] / 2**30:.2f} GiB "
            f"({runs[1]['steps_s'][0]:.4f} s, loss {runs[1]['metrics']['loss']:.6g}), batch 2 "
            f"{peaks[2] / 2**30:.2f} GiB ({runs[2]['steps_s'][0]:.4f} s, loss "
            f"{runs[2]['metrics']['loss']:.6g}); launches a step {runs[1]['launches']} (the "
            f"{CONFIG_FLASH[1][1]} global blocks); batch 4 reckoned {peaks[1] / 2**30:.2f} + 3 x "
            f"{slope / 2**30:.2f} (a sample) - 4 x {softmax / 2**30:.2f} (a sample's float32 "
            f"softmax of the {len(window)} window blocks, {by_windows} windows x {heads} heads x "
            f"{n}^2 x 4 B each, on K4-K6 from batch 3) = {reckoned / 2**30:.2f} GiB against "
            f"{limit / 2**30:.2f} GiB (the card less {CONFIG_HEADROOM / 2**30:.0f} GiB)")
    if reckoned <= limit:
        raise RuntimeError(f"{line}: fits, so the published config runs unchanged and "
                           f"CONFIG_REMAT={CONFIG_REMAT} is not wanted")
    log(f"{line}: does not fit; so the derived configs add remat={CONFIG_REMAT} and keep "
        f"float32  ({card})")


def _derived_config(path: str, model: str, root: str) -> str:
    """A config whose _base_ is the published one, with the tree's root and
    stamps, log_every 1 and the model's remat (CONFIG_REMAT)."""
    with open(path, "w") as f:
        f.write("import dataclasses\n\n"
                f"from cra5_tpu_torch.models.vaeformer import vaeformer_{model}\n\n"
                f"_base_ = [{_published(model)[0]!r}]\n"
                f"dataset = dict(root={root!r}, years={CONFIG_YEARS!r})\n"
                f"trainer = dict(log_every=1)\n"
                f"model = dict(type='VAEformer', "
                f"cfg=dataclasses.replace(vaeformer_{model}(), remat={CONFIG_REMAT!r}))\n")
    return path


def train_published(dev, card: str, model: str, root: str, ds, tmp: str) -> dict:
    """tools/train.py::run on the derived config of train_era5_<model>v_1h.py
    at its batch of 4 for CONFIG_STEPS[model] steps, the counters zeroed
    just before and read just after. Gates: the built model's blocks put
    CONFIG_FLASH's 18 window and 7 global blocks on K4-K6 at batch 4; K4,
    K5 and K6 launches equal to those a step (K4 twice under remat: the
    forward and the recompute); loss and bpp finite; each step's rate the published
    schedule's over the 300 000-step horizon (and the horizon's own); the
    parameters and the EMA moved from the seeded init; the params file
    reloads equal. Prints each step's seconds and rate, each batch's reads
    from the tree, the peak, and for 268v one step on a batch on the card."""
    import os

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.data import ERA5NpyDataset, device_put
    from cra5_tpu_torch.models.vaeformer import VAEformer
    from cra5_tpu_torch.profiling.train_memory import attention_layout
    from cra5_tpu_torch.tools import train as train_cli
    from cra5_tpu_torch.train import build_schedule
    from cra5_tpu_torch.train.checkpoints import load_variables

    tag = f"configs {model}v"
    published = _published(model)[1]
    batch, steps = published["dataset"]["batch_size"], CONFIG_STEPS[model]
    if batch != 4 or published["steps"] != CONFIG_HORIZON:
        raise RuntimeError(f"[{tag}] published batch {batch}, steps {published['steps']}")
    cfg_path = _derived_config(os.path.join(tmp, f"train_{model}v_batch4.py"), model, root)
    reads, stamps, metrics = [], [], []
    get = ERA5NpyDataset.__getitem__

    def timed_get(self, i):
        t0 = time.perf_counter()
        out = get(self, i)
        reads.append(time.perf_counter() - t0)
        return out

    def log_fn(step, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append(m)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ERA5NpyDataset.__getitem__ = timed_get
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, state, path = train_cli.run(
            [cfg_path, "--steps", str(steps), "--ckpt-dir", os.path.join(tmp, f"ckpt_{model}")],
            log_fn=log_fn)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        ERA5NpyDataset.__getitem__ = get
    t_save = time.perf_counter() - stamps[-1]
    peak = torch.cuda.max_memory_allocated()
    steps_s = [b - a for a, b in zip([t0] + stamps, stamps)]
    m = trainer.model
    if m.dtype != torch.float32 or m.cfg != _model_cfg(model, CONFIG_REMAT):
        raise RuntimeError(f"[{tag}] the CLI built {m.cfg} in {m.dtype}")
    for i, (sec, mt) in enumerate(zip(steps_s, metrics)):
        log(f"[{tag}] step {i + 1}: {sec:.4f} s{' (with init)' if i == 0 else ''}, lr "
            f"{trainer.tx.net_rate(i):.6g}; loss {mt['loss']:.6g} bpp {mt['bpp_loss']:.6g} mse "
            f"{mt['mse_loss']:.6g} aux {mt['aux_loss']:.6g}  ({card})")
    if len(metrics) != steps or not all(np.isfinite(mt[k]) for mt in metrics
                                        for k in ("loss", "bpp_loss", "total_loss")):
        raise RuntimeError(f"[{tag}] metrics {metrics}")
    sched = build_schedule(CONFIG_SCHEDULE, published["trainer"]["learning_rate"], CONFIG_HORIZON)
    counts = list(range(steps)) + [2000, CONFIG_HORIZON // 2, CONFIG_HORIZON - 1]
    bad = [(c, trainer.tx.net_rate(c), sched(c)) for c in counts
           if abs(trainer.tx.net_rate(c) - sched(c)) > CONFIG_LR_RTOL * abs(sched(c))]
    if bad or trainer.cfg.total_steps != CONFIG_HORIZON or state.opt_state.count != steps:
        raise RuntimeError(f"[{tag}] rates (count, got, want) {bad}, horizon "
                           f"{trainer.cfg.total_steps}, updates {state.opt_state.count}")
    rows = attention_layout(m)
    layout = flash_per_forward(rows, batch)
    n_flash = _hold_flash_layout(layout, batch, tag)
    per_step = {"flash_attention_forward": n_flash * (2 if CONFIG_REMAT else 1),
                "flash_attention_backward_dq": n_flash, "flash_attention_backward_dkv": n_flash}
    want = {k: steps * per_step.get(k, 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"[{tag}] launches {launches}, expected {want} from the layout "
                           f"{layout}")
    saved = load_variables(path)
    if set(saved) != set(state.params) or not all(
            torch.equal(saved[k], p.detach().cpu()) for k, p in state.params.items()):
        raise RuntimeError(f"[{tag}] {path} does not reload equal to the parameters")
    del saved
    init = dict(VAEformer(m.cfg, device=dev).reset_parameters(trainer.seed).named_parameters())
    watch = ("g_a.blocks.3.attn.qkv.weight", "g_a.patch_embed.weight", "quant_conv.weight",
             "entropy_bottleneck.quantiles", "g_s.final.weight")
    moved = {k: tuple(float((t.detach() - init[k].detach()).abs().max())
                      for t in (state.params[k], state.ema.params[k])) for k in watch}
    if not all(a > 0 and e > 0 for a, e in moved.values()) or state.ema.steps != steps:
        raise RuntimeError(f"[{tag}] the parameters or the EMA did not move: {moved}")
    del init
    per_batch = [sum(reads[i:i + batch]) for i in range(0, batch * steps, batch)]
    card_step = ""
    if model == "268":  # 159v's tower is 268v's: one step on a card batch is enough
        x = device_put(dev)(ds[model][0]["inputs"][:1].repeat(batch, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit([x], state=state, num_steps=1, log_fn=lambda *a: None)
        torch.cuda.synchronize()
        card_step = f"one step on a card batch {time.perf_counter() - t0:.4f} s; "
        del x
    del trainer, state, m
    torch.cuda.empty_cache()
    log(f"[{tag}] the published config at batch {batch}, float32, remat {CONFIG_REMAT}, dp=-1 "
        f"on 1 card: steps {', '.join(f'{t:.4f}' for t in steps_s)} s; each step's batch of "
        f"{batch} read from the tree in the loader's thread, ahead of its step, "
        f"{', '.join(f'{t:.4f}' for t in per_batch)} s ({len(reads)} timesteps read in all); "
        f"{card_step}fit's return (the loader's thread "
        f"joined) and the save {t_save:.2f} s; peak {peak / 2**30:.2f} GiB; flash "
        f"attentions a forward {layout}; launches {launches} ({per_step} a step, from the "
        f"layout); rates the schedule's within {CONFIG_LR_RTOL:g} at counts {counts}; loss and "
        f"bpp finite; max |change| from the seeded init (params, EMA) {moved}; "
        f"{os.path.basename(path)} reloads equal  ({card})")
    return dict(launches=launches, path=path, layout=rows)


def chain_159(dev, card: str, ds, ckpt: str, layout: list, tmp: str) -> dict:
    """The 159v checkpoint through tools/recompress.py --config 159 (two
    timesteps of the tree, stacked (159, 721, 1440) .npy files) twice, the
    .bin files byte-identical, and tools/serve.py --config 159 on them
    (4 threads, no --denormalize: C19), the counters zeroed just before
    and read just after each. Gates: each .npy equal bitwise to the
    in-process VAEformerCodec.decompress of its container on the card;
    each bin's streams held by hold_stream_kernels (K1 and K2/K3 exact
    against their plain versions, the decode equal to the encoder's
    symbols); launches as the headers and the layout give them. Then one
    bf16 roundtrip from a host field with its stages. Returns each path's
    launches."""
    import os

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.api.bitstream import load_bin
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec
    from cra5_tpu_torch.tools import recompress, serve
    from cra5_tpu_torch.train.checkpoints import load_variables

    tag = "configs 159v"
    inputs = os.path.join(tmp, "fields_159")
    os.makedirs(inputs)
    fields = {}
    for i in range(2):
        fields[f"t{i}"] = ds["159"][i]["inputs"][0]
        np.save(os.path.join(inputs, f"t{i}.npy"), fields[f"t{i}"])
    cfg = _model_cfg("159")
    launches, outs, lines = {}, [], []
    for run in range(2):
        out = os.path.join(tmp, f"bins_159_{run}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = recompress.main([inputs, "-o", out, "--config", "159", "--checkpoint", ckpt])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"[{tag}] recompress exited {rc}")
        lines.append((json.loads(buf.getvalue().strip().splitlines()[-1]), time.time() - t0))
        if run == 0:
            launches["recompress"] = kernels.launch_counts()
        outs.append({n: open(os.path.join(out, n), "rb").read() for n in sorted(os.listdir(out))})
    if outs[0] != outs[1] or sorted(outs[0]) != ["t0.bin", "t1.bin"]:
        raise RuntimeError(f"[{tag}] the two recompressions differ")
    want = {k: 0 for k in launches["recompress"]}
    want.update(rans_encode=2 * len(fields), flash_attention_forward=sum(
        v for k, v in flash_per_forward(layout, len(fields)).items() if k.startswith("g_a")))
    want = _with_containers(want)
    if launches["recompress"] != want:
        raise RuntimeError(f"[{tag}] recompress launches {launches['recompress']}, expected "
                           f"{want}")
    sizes = {n: len(b) for n, b in outs[0].items()}
    bpp = {n: round(8 * s / (cfg.img_size[0] * cfg.img_size[1]), 4) for n, s in sizes.items()}
    log(f"[{tag}] recompress --config 159 --checkpoint {os.path.basename(ckpt)} (float32), twice: "
        f"the .bin files byte-identical, {sizes} B ({bpp} bits a grid point); main's lines "
        f"{[ln for ln, _ in lines]}, the calls {[round(s, 2) for _, s in lines]} s with the "
        f"model build; launches {launches['recompress']}  ({card})")

    bin_dir, npy_dir = os.path.join(tmp, "bins_159_0"), os.path.join(tmp, "served_159")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main([bin_dir, "-o", npy_dir, "--config", "159", "--checkpoint", ckpt,
                         "--threads", "4"])
    torch.cuda.synchronize()
    serve_wall = time.time() - t0
    launches["serve"] = kernels.launch_counts()
    if rc != 0:
        raise RuntimeError(f"[{tag}] serve exited {rc}")
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    served = sorted(outs[0])
    decodes = [served[0]] + served  # the warm decode, then every file
    heads = {b: parse_v2_header(load_bin(os.path.join(bin_dir, b))[0][0][0]) for b in served}
    k3 = sum(1 for b in decodes if heads[b][4] and heads[b][5])
    g_s = sum(v for k, v in flash_per_forward(layout, 1).items() if k.startswith("g_s"))
    want = {k: 0 for k in launches["serve"]}
    want.update(rans_decode_generic=2 * len(decodes) - k3, rans_decode_sorted=k3,
                flash_attention_forward=g_s * len(decodes))
    want = _with_containers(want)
    if launches["serve"] != want or line["decoded"] != len(served) or line["kernel_fallbacks"]:
        raise RuntimeError(f"[{tag}] serve launches {launches['serve']} (expected {want}), "
                           f"line {line}")
    codec = recompress.build_codec("159", ckpt, dev)
    # the encoder's symbols at the batch recompress coded (its one call of
    # both files, in their order): a row's symbols may depend on the batch
    with torch.inference_mode():
        enc = codec.model.symbols_from_latent(codec.model.encode_latent(torch.as_tensor(
            np.stack([fields[b[:-4]] for b in served]), device=dev)))
    for i, b in enumerate(served):
        strings, z_shape = load_bin(os.path.join(bin_dir, b))
        with torch.inference_mode():
            x_hat = codec.decompress(strings, z_shape)["x_hat"][0].float().cpu().numpy()
        got = np.load(os.path.join(npy_dir, b[:-4] + ".npy"))
        if got.dtype != np.float32 or not np.array_equal(got, x_hat):
            raise RuntimeError(f"[{tag}] serve's {b[:-4]}.npy differs from the in-process decode")
        hold_stream_kernels(codec, {"strings": strings}, {k: v[i:i + 1] for k, v in enc.items()},
                            f"159v {b}", card, "configs kernels")
    del enc
    y_heads = [(h[0], h[1], h[2], h[4], h[5]) for h in heads.values()]
    log(f"[{tag}] serve --config 159 --threads 4: {line['decoded']} decodes in "
        f"{line['seconds']} s, {line['decodes_per_sec']} decodes/s; the call {serve_wall:.1f} s "
        f"with the model build; each .npy equal bitwise to the in-process decompress on the "
        f"card; y headers (n, K, escapes, sorted, safe) {y_heads}; launches {launches['serve']}  "
        f"({card})")

    # one bf16 roundtrip from a host field, with its stages
    del codec
    model = VAEformer(cfg, dtype=torch.bfloat16, device=dev)
    params = load_variables(ckpt)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    del params
    codec = VAEformerCodec(model)
    codec.update()
    x = fields["t0"][None]
    for run in range(2):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        codec.stage_times = {}
        t0 = time.perf_counter()
        enc = codec.compress(x)
        dec = codec.decompress(enc["strings"], enc["z_shape"])["x_hat"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages, codec.stage_times = codec.stage_times, None
    launches["codec"] = kernels.launch_counts()
    _launch_gate(f"{tag} roundtrip", launches["codec"], {
        "rans_encode": 2, "flash_attention_forward": sum(flash_per_forward(layout, 1).values())},
        decodes=2)
    if not bool(torch.isfinite(dec).all()) or tuple(dec.shape) != (1, 159, *cfg.img_size):
        raise RuntimeError(f"[{tag}] the bf16 roundtrip gave {tuple(dec.shape)}, finite "
                           f"{bool(torch.isfinite(dec).all())}")
    log(f"[{tag}] bf16 roundtrip from a host field (the second of two): {wall:.4f} s, "
        f"{sum(len(s[0]) for s in enc['strings'])} B; stages " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in stages.items())
        + f"; launches {launches['codec']}  ({card})")
    del model, codec, dec, enc
    torch.cuda.empty_cache()
    return launches


def phase_configs(dev, card: str) -> dict:
    """The published training configurations on the card: the float32
    reckoning at batch 1 and 2 (while the host writes one seeded .npy
    tree into a temporary directory), K4-K6 at a 268v window block's
    shapes at batch 4, the 268v CLI at batch 4 (train_published), then
    159v from training through recompression to serving (chain_159), on
    that tree. Returns each path's launches."""
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from cra5_tpu_torch.nn import blocks

    if blocks.flash_attention_mode() != "auto":
        raise RuntimeError(f"[configs] the flash mode is {blocks.flash_attention_mode()!r}: the "
                           f"phase holds the \"auto\" rule's routing")
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "era5_np")
        # the host writes the tree while the reckoning's process has the card
        with ThreadPoolExecutor(1) as pool:
            tree = pool.submit(write_config_tree, root, card)
            float32_reckoning(dev, card)
            ds = tree.result()
        switch_kernel_rows(dev, card, CONFIG_WINDOW, (torch.float32,), "configs")
        res268 = train_published(dev, card, "268", root, ds, tmp)
        shutil.rmtree(os.path.dirname(res268["path"]))
        res159 = train_published(dev, card, "159", root, ds, tmp)
        chained = chain_159(dev, card, ds, res159["path"], res159["layout"], tmp)
    log(f"[configs] phase {time.time() - t_phase:.1f} s  ({card})")
    return {"configs_268": res268["launches"], "configs_159": res159["launches"],
            **{f"configs_159_{k}": v for k, v in chained.items()}}


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


def phase_train(dev, dtype=torch.bfloat16) -> dict:
    """Trainer.fit on the full-width 268v VAEformer in ``dtype`` (bf16, or
    float32: the JAX package's training default), remat, batch 1."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_268
    from cra5_tpu_torch.train import Trainer, TrainerConfig

    tag = "train" if dtype == torch.bfloat16 else "train f32"
    name = "bf16" if dtype == torch.bfloat16 else "float32"
    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    t0 = time.time()
    model = VAEformer(cfg, dtype=dtype, device=dev)
    trainer = Trainer(model, TrainerConfig(log_every=1, ckpt_every=10**9), seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fields = [torch.randn((1, cfg.in_chans, *cfg.img_size), generator=gen, device=dev) * 0.5
              for _ in range(TRAIN_STEPS + 2)]
    torch.cuda.synchronize()
    log(f"[{tag}] vaeformer_268 {name} remat, {sum(p.numel() for p in model.parameters())} "
        f"float32 params; model and {len(fields)} fields {time.time() - t0:.2f} s")

    t0 = time.time()
    state = trainer.fit(fields[:1], num_steps=1, log_fn=lambda *a: None)  # init + warm-up
    torch.cuda.synchronize()
    log(f"[{tag}] init_state + warm-up step {time.time() - t0:.2f} s")
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
        log(f"[{tag}] step {state.step - TRAIN_STEPS + i + 1}: {sec:.4f} s; loss "
            f"{m['loss']:.6g} bpp {m['bpp_loss']:.6g} mse {m['mse_loss']:.6g} "
            f"aux {m['aux_loss']:.6g} total {m['total_loss']:.6g}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise RuntimeError(f"{tag} metrics are not all finite: {metrics}")
    per_step = {"flash_attention_forward": 14, "flash_attention_backward_dq": 7,
                "flash_attention_backward_dkv": 7}
    want = {k: v * TRAIN_STEPS if k in per_step else 0 for k, v in launches.items()}
    want.update({k: v * TRAIN_STEPS for k, v in per_step.items()})
    if launches != want:
        raise RuntimeError(f"{tag} launches over {TRAIN_STEPS} steps {launches}, "
                           f"expected {want}")
    moved = {k: (state.params[k].detach() - before[k]).abs().max().item() for k in watch}
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"{tag}: parameters did not move: {moved}")
    median = statistics.median(steps_s)
    log(f"[{tag}] median step {median:.4f} s over {TRAIN_STEPS} (host clock ending in a "
        f"synchronize); peak {peak / 2**30:.2f} GiB; launches {launches}; max |change| {moved}")
    fields_b = sum(f.numel() * f.element_size() for f in fields)
    log(f"[{tag}] resident before the timed steps {resident / 2**30:.2f} GiB: float32 params, "
        f"two Adam moments and the EMA {4 * n_params * 4 / 2**30:.2f} GiB, {len(fields)} input "
        f"fields {fields_b / 2**30:.2f} GiB; a step's own peak above that "
        f"{(peak - resident) / 2**30:.2f} GiB (activations, grads, optimizer temporaries)")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = trainer.fit(fields[-1:], state=state, num_steps=1, log_fn=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_profile(prof, wall, f"{tag} profile", top=25)
    del model, trainer, state, fields, prof
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
    z_idx = codec._channel_indexes((1, cfg.z_channels, *z_shape))
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
        want = _with_containers(want)
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


# ---------------------------------------------------------------- dist phases
# the rank script of the multi-rank phases: two processes on the one card
# join a gloo world (NCCL refuses two ranks on one device), reset the
# launch counters just before their path and print one JSON line
RANK_SCRIPT = r'''
import json, os, sys, time
import numpy as np, torch
mode, args = sys.argv[1], json.loads(sys.argv[2])
from cra5_tpu_torch import kernels
from cra5_tpu_torch.device import resolve_device
from cra5_tpu_torch.parallel import init_distributed, make_mesh
dev = resolve_device("cuda")
rank = init_distributed(backend="gloo", device=dev)
dev = torch.device("cuda", torch.cuda.current_device())
res = {"rank": rank}
mesh = make_mesh({"tp" if mode == "tp" else "dp": -1}, device_type="cuda")
if mode == "tp":
    import chip_smoke
    res.update(chip_smoke.tp_rank(mesh, dev, args))
elif mode == "recompress":
    from cra5_tpu_torch.api.bitstream import load_bin
    from cra5_tpu_torch.tools import recompress
    torch.cuda.synchronize(); kernels.reset_launch_counts(); torch.cuda.reset_peak_memory_stats()
    import contextlib, io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = recompress.main(args["main"])
    res["main"] = json.loads(buf.getvalue().strip().splitlines()[-1])
    bins = [load_bin(p) for p in args["bins"]]
    codec = recompress.build_codec("268", None, dev)
    strings = [[b[0][0][0] for b in bins], [b[0][1][0] for b in bins]]
    t0 = time.perf_counter()
    x_hat = recompress.decompress_batch(codec, mesh, strings, bins[0][1])
    torch.cuda.synchronize()
    res.update(rc=rc, decompress_s=time.perf_counter() - t0, launches=kernels.launch_counts(),
               peak=torch.cuda.max_memory_allocated())
    if rank == 0:
        np.save(args["x_hat"], x_hat)
elif mode == "dp_train":
    import dataclasses
    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_268
    from cra5_tpu_torch.train import Trainer, TrainerConfig
    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    tr = Trainer(VAEformer(cfg, dtype=torch.bfloat16, device=dev), TrainerConfig(), mesh=mesh,
                 seed=args["seed"])
    x = torch.load(args["batch"])
    batch = tr.shard_batch(x[rank:rank + 1])
    torch.cuda.synchronize(); t0 = time.perf_counter()
    state = tr.init_state(batch)
    torch.cuda.synchronize(); t1 = time.perf_counter()
    kernels.reset_launch_counts(); torch.cuda.reset_peak_memory_stats()
    state, m = tr._step_fn(state, batch, args["rng"])
    torch.cuda.synchronize(); t2 = time.perf_counter()
    res.update(init_s=t1 - t0, first_s=t2 - t1, first_allreduce_s=tr._step_fn.timing["allreduce_s"],
               launches=kernels.launch_counts(), metrics={k: float(v) for k, v in m.items()})
    if rank == 0:
        torch.save({k: p.detach().cpu() for k, p in state.params.items()}, args["params"])
    torch.distributed.barrier()
    torch.cuda.synchronize(); t0 = time.perf_counter()
    tr._step_fn(state, batch, args["rng"])  # a second step, timed warm
    torch.cuda.synchronize()
    res.update(step_s=time.perf_counter() - t0, allreduce_s=tr._step_fn.timing["allreduce_s"],
               peak=torch.cuda.max_memory_allocated())
print("RANK_RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
'''


def run_ranks(mode: str, args: dict, n: int = 2, timeout: float = 600.0) -> list:
    """RANK_SCRIPT on ``n`` gloo ranks sharing the card; each rank's result."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "CRA5_TPU_COORDINATOR": f"127.0.0.1:{port}",
           "CRA5_TPU_NUM_PROCESSES": str(n),
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, mode, json.dumps(args)],
                              env={**env, "CRA5_TPU_PROCESS_ID": str(r)}, cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    results, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            lines = [ln for ln in out.splitlines() if ln.startswith("RANK_RESULT ")]
            for ln in out.splitlines():
                if not ln.startswith("RANK_RESULT "):
                    log(f"[{mode} rank {r}] {ln}")
            if p.returncode or not lines:
                failed.append((r, p.returncode, err[-3000:]))
            else:
                results.append(json.loads(lines[0][len("RANK_RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(f"[{mode}] ranks failed: {failed}")
    return sorted(results, key=lambda r: r["rank"])


def _require(launches: dict, kernels_: tuple, tag: str) -> None:
    """Each of ``kernels_`` (launch counter names) launched on the path."""
    missing = [k for k in kernels_ if not launches.get(k)]
    if missing:
        raise RuntimeError(f"[{tag}] the path launched no {missing}: {launches}")


def _sum_launches(*counts) -> dict:
    out = defaultdict(int)
    for c in counts:
        for k, v in c.items():
            out[k] += v
    return dict(out)


def phase_recompress(dev, card: str) -> dict:
    """tools/recompress.main at full width: vaeformer_268 in float32 from
    the seeded init on 2 synthetic (268, 721, 1440) float32 timesteps,
    first as one process at --batch 1 and at --batch 2 (in this process),
    then as 2 gloo ranks on the card at --batch 1, a file each, which then
    decompress the bins with decompress_batch (a row each, all-gathered
    through the host). Every 2-rank .bin must be byte-identical to the
    one-process --batch 1 run's, and the 2-rank decompress must equal the
    one-process decompress at the same per-call batch; whether --batch 2
    writes the --batch 1 bytes is printed, not required (a GEMM may choose
    another order at another row count)."""
    import os
    import tempfile

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.api.bitstream import load_bin
    from cra5_tpu_torch.tools import recompress

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.time()
        for i in range(2):
            x = torch.randn((268, 721, 1440), generator=gen, device=dev) * 0.5
            np.save(os.path.join(src, f"ts{i}.npy"), x.cpu().numpy())
        del x
        log(f"[recompress] wrote 2 timesteps (268, 721, 1440) float32 in {time.time() - t0:.2f} s "
            f"({card})")
        outs, res = {}, {}
        for batch in (1, 2):
            out = os.path.join(tmp, f"one_b{batch}")
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = recompress.main([src, "-o", out, "--config", "268", "--batch", str(batch)])
            torch.cuda.synchronize()
            res[f"one_b{batch}"] = dict(seconds=time.perf_counter() - t0,
                                        main=json.loads(buf.getvalue().strip().splitlines()[-1]),
                                        launches=kernels.launch_counts(),
                                        peak=torch.cuda.max_memory_allocated())
            if rc != 0:
                raise RuntimeError(f"recompress --batch {batch} exited {rc}")
            outs[batch] = {n: open(os.path.join(out, n), "rb").read()
                           for n in sorted(os.listdir(out))}
        same_b2 = outs[2] == outs[1]
        one = {b: res[f"one_b{b}"] for b in (1, 2)}
        log(f"[recompress] one process, main's own line: --batch 1 {one[1]['main']}, --batch 2 "
            f"{one[2]['main']}; with the model build {one[1]['seconds']:.3f} and "
            f"{one[2]['seconds']:.3f} s; --batch 2 bins "
            f"{'byte-identical to' if same_b2 else 'DIFFER from'} --batch 1's "
            f"({[len(v) for v in outs[1].values()]} B); peak "
            f"{res['one_b1']['peak'] / 2**30:.2f} / {res['one_b2']['peak'] / 2**30:.2f} GiB  ({card})")
        if not same_b2:
            for n in outs[1]:
                a, b = load_bin(os.path.join(tmp, "one_b1", n)), load_bin(
                    os.path.join(tmp, "one_b2", n))
                log(f"[recompress] {n}: --batch 1 y {len(a[0][0][0])} B z {len(a[0][1][0])} B, "
                    f"--batch 2 y {len(b[0][0][0])} B z {len(b[0][1][0])} B")
        # the one-process decompress of each bin alone (the ranks' per-call batch)
        codec = recompress.build_codec("268", None, dev)
        ref = []
        for n in sorted(outs[1]):
            strings, zs = load_bin(os.path.join(tmp, "one_b1", n))
            ref.append(codec.decompress(strings, zs)["x_hat"].float().cpu())
        ref = torch.cat(ref).numpy()
        del codec
        torch.cuda.empty_cache()

        two = os.path.join(tmp, "two")
        args = dict(main=[src, "-o", two, "--config", "268", "--batch", "1",
                          "--backend", "gloo"],
                    bins=[os.path.join(two, n) for n in sorted(outs[1])],
                    x_hat=os.path.join(tmp, "x_hat.npy"))
        t0 = time.perf_counter()
        ranks = run_ranks("recompress", args)
        wall = time.perf_counter() - t0
        for n, data in outs[1].items():
            if open(os.path.join(two, n), "rb").read() != data:
                raise RuntimeError(f"[recompress] 2-rank {n} differs from the one-process bin")
        x_hat = np.load(args["x_hat"])
        err = float(np.abs(x_hat - ref).max())
        bound = 1e-5 * float(np.abs(ref).max())
        if x_hat.shape != ref.shape or not np.isfinite(x_hat).all() or not err <= bound:
            raise RuntimeError(f"[recompress] 2-rank decompress vs one process: shape "
                               f"{x_hat.shape}, err {err} > {bound}")
    encode = ("rans_encode", "flash_attention_forward")
    for r in (res["one_b1"], res["one_b2"]):
        _require(r["launches"], encode, "recompress")
    for r in ranks:  # compress, then decompress
        _require(r["launches"], encode + ("rans_decode_generic", "rans_decode_sorted"),
                 "recompress")
    for r in ranks:
        log(f"[recompress] rank {r['rank']}: main {r['main']['seconds']} s, "
            f"{r['main']['timesteps_per_sec']} timesteps/s; peak {r['peak'] / 2**30:.2f} GiB, decompress "
            f"{r['decompress_s']:.3f} s, launches {r['launches']}  ({card})")
    slowest = max(r["main"]["seconds"] for r in ranks)
    log(f"[recompress] 2 gloo ranks on one card, --batch 1, a file each: every bin "
        f"byte-identical to one process; decompress_batch x_hat err {err} (bound 1e-5 x max|ref| "
        f"= {bound:.3g}); 2 timesteps in {slowest:.2f} s (the slower rank's main), "
        f"{2 / slowest:.3f} timesteps/s; {wall:.2f} s for both ranks, process start and "
        f"decompress included  ({card})")
    return dict(launches=_sum_launches(res["one_b1"]["launches"], res["one_b2"]["launches"],
                                       *[r["launches"] for r in ranks]),
                same_b2=same_b2, seconds=res["one_b1"]["seconds"])


DP_METRIC_RTOL = 1e-2  # bf16 losses at local batch 1 against batch 2: a few 2^-8 ulps
DP_UPDATE_RTOL = 5e-2  # L1 of (dp update - one-process update) over L1 of the update


def phase_dp_train(dev, card: str) -> dict:
    """One 268v bf16 remat training step on 2 gloo ranks sharing the card at
    local batch 1 (Trainer(mesh=make_mesh({"dp": -1}))), against one step of
    the same seeded init, noise and rng in this process at batch 2, each
    followed by a second step, timed (the first carries the first calls'
    set-up). After the first step: the metrics (averaged over the ranks)
    within DP_METRIC_RTOL; the update of
    the parameters (new - init) within DP_UPDATE_RTOL of the one-process
    update in L1 over every parameter (the first Adam step moves each
    element by about lr times the sign of its gradient, so updates differ
    where a gradient's sign moves with the bf16 rounding of batch 1 against
    batch 2), and no element further than twice the larger rate (net or
    aux)."""
    import dataclasses
    import os
    import tempfile

    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_268
    from cra5_tpu_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = (torch.randn((2, cfg.in_chans, *cfg.img_size), generator=gen, device=dev) * 0.5).cpu()
    tcfg = TrainerConfig()
    tr = Trainer(VAEformer(cfg, dtype=torch.bfloat16, device=dev), tcfg, seed=SEED)
    batch = tr.shard_batch(x)
    state = tr.init_state(batch)
    init = {k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = tr._step_fn(state, batch, SEED + 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    one = {k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
    one_m = {k: float(v) for k, v in m.items()}
    t0 = time.perf_counter()
    tr._step_fn(state, batch, SEED + 1)  # a second step, timed warm
    torch.cuda.synchronize()
    one_s, one_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    del tr, state, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        args = dict(batch=os.path.join(tmp, "x.pt"), params=os.path.join(tmp, "p.pt"),
                    seed=SEED, rng=SEED + 1)
        torch.save(x, args["batch"])
        ranks = run_ranks("dp_train", args)
        dp = torch.load(args["params"])
    bad = {k: (v, ranks[0]["metrics"][k]) for k, v in one_m.items()
           if not abs(ranks[0]["metrics"][k] - v) <= DP_METRIC_RTOL * abs(v)}
    l1_diff = sum(float((dp[k] - one[k]).abs().sum()) for k in one)
    l1_upd = sum(float((one[k] - init[k]).abs().sum()) for k in one)
    worst = max(float((dp[k] - one[k]).abs().max()) for k in one)
    rel = l1_diff / l1_upd
    step_max = max(tcfg.learning_rate, tcfg.aux_learning_rate)  # Adam's first step, at most
    if bad or not rel <= DP_UPDATE_RTOL or not worst <= 2 * step_max * 1.001:
        raise RuntimeError(f"[dp_train] 2 ranks vs one process at batch 2: metrics off {bad}, "
                           f"update L1 rel {rel}, worst element {worst}")
    for r in ranks:
        _require(r["launches"], ("flash_attention_forward", "flash_attention_backward_dq",
                                 "flash_attention_backward_dkv"), "dp_train")
    for r in ranks:
        log(f"[dp_train] rank {r['rank']}: init (with rank 0's broadcast) {r['init_s']:.3f} s; "
            f"first step {r['first_s']:.4f} s (all-reduce {r['first_allreduce_s']:.4f}); second "
            f"step {r['step_s']:.4f} s, its gradient all-reduce {r['allreduce_s']:.4f} s; peak "
            f"{r['peak'] / 2**30:.2f} GiB; first step's launches {r['launches']}  ({card})")
    log(f"[dp_train] one process at batch 2: first step {first_s:.4f} s, second {one_s:.4f} s, "
        f"peak {one_peak / 2**30:.2f} GiB; first step's metrics {one_m}  ({card})")
    log(f"[dp_train] 2 ranks x batch 1 vs one process x batch 2: metrics within rtol "
        f"{DP_METRIC_RTOL} ({ranks[0]['metrics']}); update L1 rel diff {rel:.4g} (bound "
        f"{DP_UPDATE_RTOL}); worst element {worst:.3g} (bound {2 * step_max:.3g})  ({card})")
    return dict(launches=_sum_launches(*[r["launches"] for r in ranks]))


# The tp codec against one process. Both run bf16 towers, and the tp one
# sums its row-parallel partial products in float32 in another order than
# one GEMM, so a bf16 activation may round to its neighbour: a y symbol
# near a rounding edge then moves by one, and x_hat moves where that
# symbol decodes (max |x_hat - one| 0.059 of 0.711 at 268v on an H100,
# 0.42% of the y symbols moved; PERF.md). So the decoders are held on the
# same inputs: the tp g_s on the tp's symbols and means, and the tp h_s on
# seeded z symbols in [-8, 8] (the seeded field's z symbols are all 0,
# whose h_s output is 0 at any arithmetic), against the one-process
# towers, bounded as the main path's bf16 attention outputs are
# (max |tp - one| <= TP_XHAT_RTOL * max |one|). The encoders are held by
# what that cause allows: z symbols equal, at most TP_MOVED_MAX of the y
# symbols moved, none by more than one. The roundtrips are held by their
# bytes within TP_RD_RTOL, as the dp phase holds its metrics, and by
# x_hat's squared difference from the one-process x_hat within
# TP_MOVED_MAX of that x_hat's square: a symbol moved by one moves y_hat
# by one against its |y_hat|, so the share of x_hat's energy that moves
# is of the order of the moved share times 1 / mean(y_hat^2).
TP_XHAT_RTOL = FLASH_OUT_RTOL
TP_RD_RTOL = DP_METRIC_RTOL
TP_MOVED_MAX = 1e-2


def tp_rank(mesh, dev, args: dict) -> dict:
    """One rank of the tp phase (in RANK_SCRIPT): the 268v bf16 remat
    training step and a second, timed; then the codec roundtrip of the
    field on a tp-placed model. Both ranks run every collective in the
    same order; rank 0 writes the gathered parameters and x_hat."""
    import dataclasses
    import hashlib
    import pickle

    from cra5_tpu_torch import bench, kernels
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268
    from cra5_tpu_torch.parallel import fetch_tree, parallelize_, placement_of, process_index
    from cra5_tpu_torch.train import Trainer, TrainerConfig
    from cra5_tpu_torch.train.checkpoints import save_variables

    rank, res = process_index(), {}
    sync = lambda: torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    field = np.load(args["field"])
    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    tr = Trainer(VAEformer(cfg, dtype=torch.bfloat16, device=dev), TrainerConfig(), mesh=mesh,
                 seed=args["seed"])
    batch = tr.shard_batch(torch.from_numpy(field) * 0.5)
    sync()
    t0 = time.perf_counter()
    state = tr.init_state(batch)
    sync()
    t1 = time.perf_counter()
    tp, placement = tr.model.tp, placement_of(tr.model)
    tp.timing = {}
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    state, m = tr._step_fn(state, batch, args["rng"])
    sync()
    t2 = time.perf_counter()
    res.update(init_s=t1 - t0, first_s=t2 - t1, first_tp=dict(tp.timing),
               launches=kernels.launch_counts(), metrics={k: float(v) for k, v in m.items()},
               heads=sorted({(a.num_heads, a.local_heads) for a in tr.model.modules()
                             if hasattr(a, "local_heads")}))
    t0 = time.perf_counter()
    full = fetch_tree(state.params, mesh, placement)
    res["gather_s"] = time.perf_counter() - t0
    if rank == 0:
        save_variables(args["params"], full, model=tr.model)
    del full
    torch.distributed.barrier()
    tp.timing = {}
    sync()
    t0 = time.perf_counter()
    tr._step_fn(state, batch, args["rng"])  # a second step, timed warm
    sync()
    res.update(step_s=time.perf_counter() - t0, tp_timing=dict(tp.timing),
               peak=torch.cuda.max_memory_allocated(dev))
    digest = hashlib.sha256()
    for k in sorted(state.params):
        if placement[k] is None:
            digest.update(state.params[k].detach().cpu().numpy().tobytes())
    res["replicated"] = (sum(v is None for v in placement.values()), digest.hexdigest())
    del tr, state, batch, m
    torch.cuda.empty_cache()

    model = VAEformer(vaeformer_268(), dtype=torch.bfloat16, device=dev).reset_parameters(
        args["seed"])
    parallelize_(model, mesh)
    codec = VAEformerCodec(model)
    codec.update()
    model.tp.timing = {}
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = codec.compress(field)
    sync()
    t1 = time.perf_counter()
    x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    sync()
    t2 = time.perf_counter()
    res.update(codec_launches=kernels.launch_counts(), compress_s=t1 - t0,
               decompress_s=t2 - t1, codec_tp=dict(model.tp.timing))
    with torch.inference_mode():
        enc = model.encode_symbols(torch.from_numpy(field).to(dev))
    z_dec, y_dec = bench.decode_symbols(codec, out["strings"], out["z_shape"])
    res["symbols_exact"] = bool(torch.equal(z_dec, enc["z_sym"])
                                and torch.equal(y_dec, enc["y_sym"]))
    res["strings"] = hashlib.sha256(pickle.dumps(out["strings"])).hexdigest()
    res["y_header"] = list(parse_v2_header(out["strings"][0][0]))
    with torch.inference_mode():
        means = model.scales_from_z_symbols(z_dec)[1]
        probe = model.scales_from_z_symbols(torch.from_numpy(np.load(args["z_probe"])).to(dev))
    if rank == 0:
        np.save(args["x_hat"], x_hat.float().cpu().numpy())
        with open(args["streams"], "wb") as f:
            pickle.dump(out["strings"], f)
        torch.save({"z": z_dec.cpu(), "y": y_dec.cpu(), "means": means.cpu(),
                    "probe": [t.float().cpu() for t in probe]}, args["symbols"])
    del model, codec, enc, x_hat, means, probe
    torch.cuda.empty_cache()
    return res


def phase_tp(dev, card: str) -> dict:
    """Tensor parallelism on 2 gloo ranks sharing the card (NCCL refuses
    two ranks on one device), a {"tp": 2} mesh, 268v bf16: the training
    step against one step in this process (the pattern of phase_dp_train,
    at the same batch of 1), then the codec roundtrip against the
    one-process roundtrip (phase 10b of the docstring). The one-process
    models are freed before the ranks start. Returns the launches of the
    ranks' paths: the first step's and the roundtrip's."""
    import dataclasses
    import os
    import pickle
    import tempfile

    from cra5_tpu_torch.coder.lane_coder import parse_v2_header
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268
    from cra5_tpu_torch.train import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    field = np.random.default_rng(SEED).standard_normal((1, cfg.in_chans, *cfg.img_size),
                                                        np.float32)
    tcfg = TrainerConfig()
    tr = Trainer(VAEformer(cfg, dtype=torch.bfloat16, device=dev), tcfg, seed=SEED)
    batch = tr.shard_batch(torch.from_numpy(field) * 0.5)
    state = tr.init_state(batch)
    init = {k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = tr._step_fn(state, batch, SEED + 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    one = {k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
    one_m = {k: float(v) for k, v in m.items()}
    t0 = time.perf_counter()
    tr._step_fn(state, batch, SEED + 1)  # a second step, timed warm
    torch.cuda.synchronize()
    one_s, one_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    del tr, state, batch, m
    torch.cuda.empty_cache()
    model = VAEformer(vaeformer_268(), dtype=torch.bfloat16, device=dev).reset_parameters(SEED)
    codec = VAEformerCodec(model)
    codec.update()
    one_out = codec.compress(field)
    one_x = codec.decompress(one_out["strings"], one_out["z_shape"])["x_hat"].float().cpu()
    with torch.inference_mode():
        enc = model.encode_symbols(torch.from_numpy(field).to(dev))
        one_y, one_z = enc["y_sym"].cpu(), enc["z_sym"].cpu()
        del enc
    z_probe = np.random.default_rng(SEED + 2).integers(-8, 9, one_z.shape).astype(np.int32)
    with torch.inference_mode():
        one_probe = [t.float().cpu() for t in
                     model.scales_from_z_symbols(torch.from_numpy(z_probe).to(dev))]
    del model, codec
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        args = dict(field=os.path.join(tmp, "field.npy"), params=os.path.join(tmp, "p.pt"),
                    x_hat=os.path.join(tmp, "x_hat.npy"),
                    streams=os.path.join(tmp, "streams.pkl"),
                    symbols=os.path.join(tmp, "symbols.pt"),
                    z_probe=os.path.join(tmp, "z_probe.npy"), seed=SEED, rng=SEED + 1)
        np.save(args["field"], field)
        np.save(args["z_probe"], z_probe)
        t0 = time.perf_counter()
        ranks = run_ranks("tp", args)
        wall = time.perf_counter() - t0
        tp = torch.load(args["params"])["params"]
        x_hat = torch.from_numpy(np.load(args["x_hat"]))
        with open(args["streams"], "rb") as f:
            streams = pickle.load(f)
        sym = torch.load(args["symbols"])

    # (a) training
    if {k: tuple(v.shape) for k, v in tp.items()} != {k: tuple(v.shape) for k, v in one.items()}:
        raise RuntimeError("[tp_train] the gathered parameters' names or shapes differ from "
                           "the one-process model's")
    bad = {k: (v, ranks[0]["metrics"][k]) for k, v in one_m.items()
           if not abs(ranks[0]["metrics"][k] - v) <= DP_METRIC_RTOL * abs(v)}
    l1_diff = sum(float((tp[k] - one[k]).abs().sum()) for k in one)
    l1_upd = sum(float((one[k] - init[k]).abs().sum()) for k in one)
    worst = max(float((tp[k] - one[k]).abs().max()) for k in one)
    rel = l1_diff / l1_upd
    step_max = max(tcfg.learning_rate, tcfg.aux_learning_rate)  # Adam's first step, at most
    if bad or not rel <= DP_UPDATE_RTOL or not worst <= 2 * step_max * 1.001:
        raise RuntimeError(f"[tp_train] 2 tp ranks vs one process: metrics off {bad}, update "
                           f"L1 rel {rel}, worst element {worst}")
    if ranks[0]["replicated"] != ranks[1]["replicated"]:
        raise RuntimeError(f"[tp_train] the replicated parameters differ across the ranks: "
                           f"{[r['replicated'] for r in ranks]}")
    for r in ranks:
        _require(r["launches"], ("flash_attention_forward", "flash_attention_backward_dq",
                                 "flash_attention_backward_dkv"), "tp_train")
    for r in ranks:
        log(f"[tp_train] rank {r['rank']}: heads (whole, local) {r['heads']}; init (rank 0's "
            f"broadcast, the cut) {r['init_s']:.3f} s; first step {r['first_s']:.4f} s (tp "
            f"all-reduce {r['first_tp']}); second step {r['step_s']:.4f} s, its tp all-reduce "
            f"forward {r['tp_timing'].get('forward_s', 0.0):.4f} s + backward "
            f"{r['tp_timing'].get('backward_s', 0.0):.4f} s over "
            f"{r['tp_timing'].get('calls', 0)} calls; gather {r['gather_s']:.3f} s; peak "
            f"{r['peak'] / 2**30:.2f} GiB; first step's launches {r['launches']}  ({card})")
    log(f"[tp_train] one process: first step {first_s:.4f} s, second {one_s:.4f} s, peak "
        f"{one_peak / 2**30:.2f} GiB; first step's metrics {one_m}  ({card})")
    log(f"[tp_train] 2 tp ranks vs one process at batch 1: metrics within rtol {DP_METRIC_RTOL} "
        f"({ranks[0]['metrics']}); update L1 rel diff {rel:.4g} (bound {DP_UPDATE_RTOL}); worst "
        f"element {worst:.3g} (bound {2 * step_max:.3g}); {ranks[0]['replicated'][0]} replicated "
        f"parameters bitwise equal across the ranks; the gathered parameters' names and shapes "
        f"the one-process model's  ({card})")

    # (b) the codec
    if ranks[0]["strings"] != ranks[1]["strings"]:
        raise RuntimeError("[tp_codec] the two ranks' strings differ")
    if not all(r["symbols_exact"] for r in ranks):
        raise RuntimeError("[tp_codec] a rank's decode differs from its encoder's symbols")
    yh = ranks[0]["y_header"]
    for r in ranks:
        _require(r["codec_launches"], RANS, "tp_codec")
        _require(r["codec_launches"], ("flash_attention_forward",), "tp_codec")
    if not (yh[4] and yh[5]):
        raise RuntimeError(f"[tp_codec] y header {yh}: expected sorted and kernel-safe (K3)")
    # the tp decoders against the one-process ones on the same inputs
    model = VAEformer(vaeformer_268(), dtype=torch.bfloat16, device=dev).reset_parameters(SEED)
    with torch.inference_mode():
        ref = model.reconstruct_from_y_symbols(sym["y"].to(dev), sym["means"].to(dev))
        ref = ref.float().cpu()
    del model
    torch.cuda.empty_cache()
    err = float((x_hat - ref).abs().max())
    bound = TP_XHAT_RTOL * float(ref.abs().max())
    probe = [(float((t - o).abs().max()), TP_XHAT_RTOL * float(o.abs().max()))
             for t, o in zip(sym["probe"], one_probe)]
    if x_hat.shape != ref.shape or not torch.isfinite(x_hat).all() or not err <= bound \
            or not all(0 < b and e <= b for e, b in probe):
        raise RuntimeError(f"[tp_codec] the tp decoders vs one process on the same inputs: "
                           f"x_hat {tuple(x_hat.shape)} err {err} (bound {bound}); h_s on the "
                           f"probe (scales, means) err and bound {probe}")
    # the encoders and the two roundtrips
    nbytes = sum(len(b) for group in streams for b in group)
    one_bytes = sum(len(b) for group in one_out["strings"] for b in group)
    moved = sym["y"] != one_y
    moved_share = float(moved.float().mean())
    moved_max = int((sym["y"] - one_y).abs().max())
    rel_mse = float((x_hat - one_x).square().mean() / one_x.square().mean())
    if not (torch.equal(sym["z"], one_z) and moved_share <= TP_MOVED_MAX and moved_max <= 1
            and abs(nbytes - one_bytes) <= TP_RD_RTOL * one_bytes
            and rel_mse <= TP_MOVED_MAX):
        raise RuntimeError(f"[tp_codec] tp vs one-process roundtrip: z symbols equal "
                           f"{torch.equal(sym['z'], one_z)}, y symbols moved {moved_share} "
                           f"(max |diff| {moved_max}), bytes {nbytes} vs {one_bytes}, x_hat's "
                           f"relative squared difference {rel_mse}")
    rt_err = float((x_hat - one_x).abs().max())
    mean_err = float((x_hat - one_x).abs().mean())
    for r in ranks:
        log(f"[tp_codec] rank {r['rank']}: compress {r['compress_s']:.4f} s, decompress "
            f"{r['decompress_s']:.4f} s (tp all-reduce {r['codec_tp']}); launches "
            f"{r['codec_launches']}  ({card})")
    log(f"[tp_codec] 2 tp ranks: strings byte-identical across the ranks, each rank's decode "
        f"equal to its encoder's symbols, the y stream sorted and kernel-safe (K3); the tp "
        f"decoders vs one process on the same inputs: g_s on the tp's symbols x_hat max err "
        f"{err:.4g} (bound {TP_XHAT_RTOL} x max|ref| = {bound:.4g}), h_s on the probe scales "
        f"{probe[0][0]:.4g} (bound {probe[0][1]:.4g}), means {probe[1][0]:.4g} (bound "
        f"{probe[1][1]:.4g})  ({card})")
    log(f"[tp_codec] tp vs one-process roundtrip: z symbols equal; {int(moved.sum())} of "
        f"{moved.numel()} y symbols moved ({moved_share:.4g}, bound {TP_MOVED_MAX}; max |diff| "
        f"{moved_max}, bound 1); bytes {nbytes} vs {one_bytes} (within {TP_RD_RTOL}); x_hat's "
        f"squared difference over its square {rel_mse:.4g} (bound {TP_MOVED_MAX}), max err "
        f"{rt_err:.4g}, mean {mean_err:.4g}; {wall:.2f} s for both ranks, process start "
        f"included; the phase {time.perf_counter() - t_phase:.1f} s  ({card})")
    del one, init, tp
    return {"tp_train": _sum_launches(*[r["launches"] for r in ranks]),
            "tp_codec": _sum_launches(*[r["codec_launches"] for r in ranks])}


def phase_remat_dots(dev, card: str) -> dict:
    """The 268v bf16 training step with remat="dots" against remat=True:
    step s and peak for each (a warm-up step, then one timed), the counters
    zeroed around the timed "dots" step; then one global block's gradients
    under "dots" held to remat=True's within FLASH_GRAD_RTOL x max|ref|."""
    import dataclasses

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_268
    from cra5_tpu_torch.nn import blocks
    from cra5_tpu_torch.nn.vit import _run_block
    from cra5_tpu_torch.train import Trainer, TrainerConfig

    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = vaeformer_268()
    fields = [torch.randn((1, base.in_chans, *base.img_size), generator=gen, device=dev) * 0.5
              for _ in range(2)]
    res = {}
    for remat in (True, "dots"):
        model = VAEformer(dataclasses.replace(base, remat=remat), dtype=torch.bfloat16, device=dev)
        tr = Trainer(model, TrainerConfig(log_every=10**9, ckpt_every=10**9), seed=SEED)
        state = tr.fit(fields[:1], num_steps=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tr.fit(fields[1:], state=state, num_steps=1)
        torch.cuda.synchronize()
        res[remat] = dict(step_s=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated(),
                          launches=kernels.launch_counts())
        del model, tr, state
        torch.cuda.empty_cache()
    per_step = {"flash_attention_forward": 14, "flash_attention_backward_dq": 7,
                 "flash_attention_backward_dkv": 7}
    want = {k: per_step.get(k, 0) for k in res["dots"]["launches"]}
    if res["dots"]["launches"] != want:
        raise RuntimeError(f"[remat_dots] launches {res['dots']['launches']}, expected {want}")
    for remat, r in res.items():
        log(f"[remat_dots] 268v bf16 remat={remat!r}: step {r['step_s']:.4f} s, peak "
            f"{r['peak'] / 2**30:.2f} GiB, launches {r['launches']}  ({card})")
    # one global block: gradients under "dots" against remat=True
    dim, heads, (Hp, Wp) = base.y_channels, base.num_heads, base.latent_grid
    gen = torch.Generator(device=dev).manual_seed(SEED)
    blk = blocks.Block(dim, heads, layer_id=base.interval - 1, dtype=torch.bfloat16, device=dev)
    for mod in blk.modules():
        if mod is not blk and hasattr(mod, "reset_parameters") and not isinstance(mod, torch.nn.Linear):
            mod.reset_parameters(gen)
    x = torch.randn((1, Hp * Wp, dim), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(x.shape, generator=gen, device=dev)
    grads = {}
    for remat in (True, "dots"):
        blk.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_()
        (_run_block(blk, xg, Hp, Wp, remat=remat).float() * w).sum().backward()
        grads[remat] = {"x": xg.grad, **{k: p.grad.clone() for k, p in blk.named_parameters()}}
    errs = {k: ((grads["dots"][k].float() - ref.float()).abs().max().item(),
                FLASH_GRAD_RTOL * ref.float().abs().max().item())
            for k, ref in grads[True].items()}
    if any(not e <= b for e, b in errs.values()):
        raise RuntimeError(f"[remat_dots] global block gradients, dots vs True: {errs}")
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-30))
    log(f"[remat_dots] 268v global block (1, {Hp * Wp}, {dim}) bf16: gradients under 'dots' vs "
        f"remat=True within {FLASH_GRAD_RTOL} x max|ref| for all {len(errs)} (worst {worst}: "
        f"err {errs[worst][0]:.3g}, bound {errs[worst][1]:.3g})  ({card})")
    del blk, grads, x, w
    torch.cuda.empty_cache()
    return dict(launches=res["dots"]["launches"])


def phase_ring(dev, card: str) -> None:
    """ring_attention_sharded at world size 1 on the card (an NCCL world of
    one rank, no rotation) on the 268v global block's (1, 16, 10368, 64),
    bf16 and float32, against the plain attention (float32 logits and
    softmax), timed beside K4 (flash_attention_forward) on the same
    inputs."""
    import torch.distributed as dist

    from cra5_tpu_torch.ops.attention import flash_attention_forward
    from cra5_tpu_torch.ops.ring_attention import ring_attention_sharded
    from cra5_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sp": 1}, device_type="cuda")
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        shape = (1, 16, 10368, 64)
        for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
            out = ring_attention_sharded(q, k, v, mesh)
            logits = torch.matmul(q.float() * 0.125, k.float().transpose(-1, -2))
            ref = torch.matmul(torch.softmax(logits, -1), v.float())
            del logits
            err = (out.float() - ref).abs().max().item()
            if out.dtype != dtype or not err <= atol:
                raise RuntimeError(f"[ring] {dtype}: err {err} > {atol}")
            ring_ms = timed_ms(lambda: ring_attention_sharded(q, k, v, mesh), 3)
            k4_ms = timed_ms(lambda: flash_attention_forward(q, k, v, 0.125), 10)
            log(f"[ring] {shape} {dtype}, world size 1: err vs plain {err:.3g} (atol {atol}); "
                f"ring {ring_ms:.4f} ms, K4 {k4_ms:.4f} ms  ({card})")
            del q, k, v, out, ref
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def phase_msgpack(dev, card: str) -> None:
    """The 268v params written by the port's msgpack writer (the JAX
    package's .msgpack variables), read back bitwise, and loaded into a
    fresh model on the card."""
    import os
    import tempfile

    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_268
    from cra5_tpu_torch.train.checkpoints import load_variables, save_variables

    model = VAEformer(vaeformer_268(), device=dev).reset_parameters(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "step_0.msgpack")
        t0 = time.perf_counter()
        save_variables(path, dict(model.named_parameters()), model=model)
        t1 = time.perf_counter()
        fresh = VAEformer(vaeformer_268(), device=dev)
        params = load_variables(path, model=fresh)
        t2 = time.perf_counter()
        with torch.no_grad():
            for name, p in fresh.named_parameters():
                p.copy_(params[name])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        nbytes = os.path.getsize(path)
    bad = [k for k, p in model.named_parameters() if not torch.equal(fresh.get_parameter(k), p)]
    if bad:
        raise RuntimeError(f"[msgpack] {len(bad)} params differ after the roundtrip: {bad[:3]}")
    n = sum(p.numel() for p in model.parameters())
    log(f"[msgpack] 268v params ({n} float32) -> {nbytes} B: write {t1 - t0:.3f} s, read "
        f"{t2 - t1:.3f} s, into a fresh model {t3 - t2:.3f} s; every tensor bitwise  ({card})")
    del model, fresh, params
    torch.cuda.empty_cache()


def phase_dist(dev, card: str) -> dict:
    """The multi-rank, remat, ring and msgpack phases, in order; the
    launches of each path driven."""
    rc = phase_recompress(dev, card)
    dp = phase_dp_train(dev, card)
    dots = phase_remat_dots(dev, card)
    phase_ring(dev, card)
    phase_msgpack(dev, card)
    return {"recompress": rc["launches"], "dp_train": dp["launches"],
            "remat_dots": dots["launches"]}


# the image-codec zoo: card against CPU at a small width, x_hat within
# this share of max |x_hat| (the card's im2col / cuBLAS GEMMs and the
# CPU's convolutions sum in other orders, TF32 off;
# tests/test_torch_cuda.py states the same bound)
ZOO_XHAT_RTOL = 1e-4
KODAK = (3, 512, 768)  # Kodak's published size, landscape (C, H, W)
CLIC = (3, 2048, 1365)  # CLIC 2020 professional's largest, padded to 2048 x 1408
# eval_model.main runs at the zoo's full widths: (arch, quality, options, images)
ZOO_RUNS = (
    ("bmshj2018-factorized", 8, ["--entropy-coder", "v2"], 2),
    ("bmshj2018-hyperprior", 8, ["--entropy-coder", "v2"], 2),
    ("mbt2018-mean", 8, ["--entropy-coder", "v2"], 2),
    ("mbt2018-mean", 8, ["--entropy-coder", "v1"], 2),
    ("cheng2020-anchor", 6, [], 1),
    ("mbt2018-mean", 8, ["--entropy-estimation"], 2),
)
# the coder's kernels: K1-K3, and K9/K10, which write and read each stream's container
RANS = ("rans_encode", "rans_decode_generic", "rans_decode_sorted", "container_write",
        "container_read")


def _zoo_folder(root: str, name: str, n: int, shape, seed: int) -> str:
    """A folder of n seeded float32 .npy images in [0, 1]."""
    import os

    folder = os.path.join(root, name)
    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    for i in range(n):
        np.save(os.path.join(folder, f"img{i}.npy"), rng.random(shape, np.float32))
    return folder


def _record(obj, name: str, seen: dict) -> None:
    """Make obj.name record its arguments and result in seen[name]."""
    fn = getattr(obj, name)

    def wrapped(*args):
        out = fn(*args)
        seen.setdefault(name, []).append((args, out))
        return out

    setattr(obj, name, wrapped)


def _stream_kernels(out: dict) -> tuple:
    """Each v2 stream's (group, lanes, sorted, safe, bytes, decode kernel),
    and the K1/K2/K3 launches a roundtrip of them makes."""
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header

    rows, want = [], dict.fromkeys(RANS, 0)
    for group, strings in zip(("y", "z"), out["strings"]):
        for s in strings:
            _, K, _, _, srt, safe, _ = parse_v2_header(s)
            k = "rans_decode_sorted" if srt and safe else "rans_decode_generic"
            rows.append((group, K, srt, safe, len(s), "K3" if k.endswith("sorted") else "K2"))
            for kernel in ("rans_encode", k, "container_write", "container_read"):
                want[kernel] += 1
    return rows, want


def kernel_us(fn, match: str, iters: int = 10) -> float:
    """Device microseconds of the one kernel a call of ``fn`` launches whose
    name holds ``match`` (torch.profiler): the mean over the launches the
    trace recorded, since a trace late in a long run can drop some. A trace
    that recorded none is taken again, up to three times; then nan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and match in e.name]
        if spans:
            return sum(spans) / len(spans)
    return float("nan")


def hold_streams(streams, tag: str, card: str, where: str = "zoo kernels",
                 iters: int = 10) -> dict:
    """Each v2 stream of ``streams``, a list of (name, coder, symbols,
    indexes, stream bytes) of one sample, at its own geometry and with the
    coder's own tables: K1 on the (M, K) grids of the encoded symbols and
    indexes against rans_encode_plain (states, emit, emitted words) and
    against the container's states and words; the decode kernel the stream
    takes (K2 or K3) on it as uploaded against lane_decode_plain or
    rans_decode_sorted_plain (values, sentinels); the stream's decode
    (escapes applied, the sort undone) against the encoder's symbols.
    Every comparison is exact and raises on a difference; each kernel's
    device time (``iters`` launches traced) and byte bound beside (the
    formulas of phase_rans). ``where`` heads the lines. Returns, by name,
    the stream's lanes and steps and each kernel's device us and bound
    ms."""
    from cra5_tpu_torch.coder import rans_kernels as rk
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header

    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))
    held = {}
    for name, coder, sym, idx, string in streams:
        n, K, _, n_words, srt, safe, _ = parse_v2_header(string)
        dec_name = "K3" if srt and safe else "K2"
        up = coder.upload_batch([string])[0]
        with torch.inference_mode():
            starts, freqs = coder.encode_grids(sym, idx)[3:5]
            got, want = rk.rans_encode(starts, freqs), rk.rans_encode_plain(starts, freqs)
            if not (same(got[:2], want[:2]) and torch.equal(got[2][got[1]], want[2][want[1]])):
                raise RuntimeError(f"[{where}] {tag} {name}: K1 rans_encode differs from "
                                   f"rans_encode_plain on the stream's grids")
            if not (torch.equal(got[0], up[1]) and torch.equal(got[2][got[1]], up[2])):
                raise RuntimeError(f"[{where}] {tag} {name}: K1's states and words differ "
                                   f"from the container's")
            kernel, plain, args, _ = coder.decode_call(up, idx)
            if not same(kernel(*args, coder._slots), plain(*args)):
                raise RuntimeError(f"[{where}] {tag} {name}: {dec_name} differs from "
                                   f"{plain.__name__} on the uploaded stream")
            decoded, n_sent = coder._decode(up, idx)
            if not torch.equal(decoded, sym.to(decoded)) or int(n_sent) != up[0][2]:
                raise RuntimeError(f"[{where}] {tag} {name}: the decoded symbols differ "
                                   f"from the encoder's ({int(n_sent)} escapes decoded, "
                                   f"{up[0][2]} in the stream)")
            k1 = kernel_us(lambda: rk.rans_encode(starts, freqs), "rans_encode", iters)
            dec = kernel_us(lambda: kernel(*args, coder._slots), "rans_decode", iters)
        steps = -(-n // K)
        ncd, L = coder._cdf.shape
        k1_bound = bytes_bound_ms(steps * K * 11 + K * 4)
        dec_bound = bytes_bound_ms((steps * 12 if dec_name == "K3" else steps * K * 4) + K * 4
                                   + n_words * 2 + ncd * (L + 2) * 4 + steps * K * 5)
        log(f"[{where}] {tag} {name}: {n} symbols, {K} lanes x {steps} steps, sorted {srt}, "
            f"kernel-safe {safe}, {len(string)} B, {up[0][2]} escapes, {ncd} table rows; K1 "
            f"and {dec_name} exact against their plain versions, the decode equal to the "
            f"encoder's symbols; K1 device {k1:.2f} us ({k1 * 1e3 / steps:.1f} ns a step, bound "
            f"{k1_bound:.4f} ms), {dec_name} device {dec:.2f} us ({dec / steps:.3f} us a step, "
            f"bound {dec_bound:.4f} ms)  ({card})")
        held[name] = dict(K=K, steps=steps, k1_us=k1, k1_bound_ms=k1_bound, dec=dec_name,
                          dec_us=dec, dec_bound_ms=dec_bound)
    return held


def hold_stream_kernels(codec, out: dict, enc: dict, tag: str, card: str,
                        where: str = "zoo kernels") -> dict:
    """hold_streams on the y and z streams of a written sample
    (out["strings"], the first sample) of a one-y-stream codec, with the
    symbols and indexes the encoder's device methods give (enc). Used by
    the zoo's roundtrips, by serve's bins and by the variants."""
    if codec.kind == "factorized":
        streams = [("y", codec._eb_coder, enc["y_sym"][0],
                    codec._channel_indexes(enc["y_sym"].shape)[0], out["strings"][0][0])]
    else:
        streams = [("y", codec._gc_coder, enc["y_sym"][0], codec._gc_indexes(enc["scales"])[0],
                    out["strings"][0][0]),
                   ("z", codec._eb_coder, enc["z_sym"][0],
                    codec._channel_indexes(enc["z_sym"].shape)[0], out["strings"][1][0])]
    return hold_streams(streams, tag, card, where)


def zoo_roundtrip(codec, x: np.ndarray, dev, tag: str, card: str) -> dict:
    """One roundtrip with every stage synchronised (host ms a stage), the
    counters zeroed just before and read just after; then its gates: the
    decoded symbols (the AR codec: the decoded y_hat) equal the encoded
    ones, and x_hat equals the model's reconstruct of the encoded symbols
    bitwise."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models import AutoregressiveCodec

    model, ar = codec.model, isinstance(codec, AutoregressiveCodec)
    codec.update()  # the CDF tables, built on the host at first use: not timed
    seen = {}
    spies = ((codec, "_encode_ar"), (model, "hyper_synthesis"), (model, "synthesis")) if ar else (
        (model, "hyper_params_from_z"), (model, "reconstruct"))
    spies = [(obj, name) for obj, name in spies if hasattr(obj, name)]
    for obj, name in spies:
        _record(obj, name, seen)
    codec.stage_times = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = codec.compress(x)
    t1 = time.perf_counter()
    x_hat = codec.decompress(out["strings"], out["shape"])["x_hat"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts()
    stages, codec.stage_times = codec.stage_times, None
    for obj, name in spies:
        delattr(obj, name)

    with torch.inference_mode():
        if ar:
            y_enc = seen["_encode_ar"][0][1][2]
            y_dec = seen["synthesis"][0][0][0]
            (z_enc,), (z_dec,) = (a for a, _ in seen["hyper_synthesis"])
            same = torch.equal(z_enc, z_dec) and np.array_equal(y_dec[0].cpu().numpy(), y_enc)
            ref = model.synthesis(torch.from_numpy(y_enc)[None].to(dev))
        else:
            enc = model.encode_symbols(torch.from_numpy(x).to(dev))
            same = torch.equal(seen["reconstruct"][0][0][0], enc["y_sym"])
            if "z_sym" in enc:
                same &= torch.equal(seen["hyper_params_from_z"][0][0][0], enc["z_sym"])
            ref = model.reconstruct(enc["y_sym"], enc.get("means"))
    if not same:
        raise RuntimeError(f"[zoo] {tag}: decoded symbols differ from the encoded ones")
    if not torch.equal(x_hat, ref):
        raise RuntimeError(f"[zoo] {tag}: decompress's x_hat differs from reconstruct of the "
                           f"encoded symbols")
    if codec.coder == "v2":
        hold_stream_kernels(codec, out, enc, tag, card)
        rows, want = _stream_kernels(out)
        for group, K, srt, safe, nbytes, kern in rows:
            log(f"[zoo] {tag}: {group} stream {nbytes} B on {K} lanes, sorted {srt}, kernel-safe "
                f"{safe}: decodes on {kern}  ({card})")
    else:
        want = dict.fromkeys(RANS, 0)  # v1: the host coder
        log(f"[zoo] {tag}: v1 streams y {[len(s) for s in out['strings'][0]]} B, z "
            f"{[len(s) for s in out['strings'][1]]} B  ({card})")
    got = {k: launches.get(k, 0) for k in RANS}
    if got != want or any(v for k, v in launches.items() if k not in RANS):
        raise RuntimeError(f"[zoo] {tag}: launches {launches}, expected {want}")
    ms = {k: round(v * 1e3, 3) for k, v in stages.items()}
    log(f"[zoo] {tag}: synchronised roundtrip compress {t1 - t0:.4f} s, decompress "
        f"{t2 - t1:.4f} s; host ms a stage {ms}; launches {got}; symbols exact, x_hat "
        f"bitwise reconstruct  ({card})")
    return dict(launches=launches, out=out)


def zoo_card_vs_cpu(dev, card: str) -> dict:
    """mbt2018-mean at a small width (N=32, M=48), the same seeded weights on
    the card and on the CPU, one ImageCodec v2 roundtrip of a seeded
    3 x 256 x 384 image on each: the same symbols and bytes, x_hat within
    ZOO_XHAT_RTOL."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models import MeanScaleHyperprior, make_codec

    gpu = MeanScaleHyperprior(N=32, M=48, device=dev).reset_parameters(SEED)
    cpu = MeanScaleHyperprior(N=32, M=48, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    x = np.random.default_rng(SEED).random((1, 3, 256, 384), np.float32)
    a, b = make_codec(gpu), make_codec(cpu)
    a.compress(x)  # warm-up
    kernels.reset_launch_counts()
    out = a.compress(x)
    x_gpu = a.decompress(out["strings"], out["shape"])["x_hat"]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    ref = b.compress(x)
    x_cpu = b.decompress(ref["strings"], ref["shape"])["x_hat"]
    err = (x_gpu.cpu() - x_cpu).abs().max().item()
    bound = ZOO_XHAT_RTOL * x_cpu.abs().max().item()
    if out["strings"] != ref["strings"] or not err <= bound:
        raise RuntimeError(f"[zoo] card vs CPU: streams equal {out['strings'] == ref['strings']}, "
                           f"x_hat err {err} > {bound}")
    _require(launches, ("rans_encode", "rans_decode_generic"), "zoo card vs CPU")
    log(f"[zoo] card vs CPU, mbt2018-mean N=32 M=48 on (1, 3, 256, 384): y and z streams "
        f"byte-identical ({[len(s[0]) for s in out['strings']]} B), x_hat err {err:.3g} (bound "
        f"{ZOO_XHAT_RTOL} x max|ref| = {bound:.3g}); launches {launches}  ({card})")
    return launches


def phase_zoo(dev, card: str) -> dict:
    """The image-codec zoo on the card: card against CPU; then
    tools/eval_model.main (--device cuda) at the zoo's full widths on
    Kodak-size .npy images for each of ZOO_RUNS, each followed by one
    synchronised roundtrip of its first image (zoo_roundtrip); then one
    CLIC-size image through mbt2018-mean q8 v2, whose y stream must decode
    on K3. The counters are zeroed just before each eval_model run and each
    roundtrip and read just after; the launches of every run join the
    kernels line."""
    import os
    import tempfile
    from pathlib import Path

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models import load_model
    from cra5_tpu_torch.tools import eval_model

    t_phase = time.time()
    launches = [zoo_card_vs_cpu(dev, card)]
    with tempfile.TemporaryDirectory() as root:
        kodak = {n: _zoo_folder(root, f"kodak{n}", n, KODAK, SEED) for n in (1, 2)}
        clic = _zoo_folder(root, "clic", 1, CLIC, SEED + 1)
        runs = [(a, q, o, kodak[n]) for a, q, o, n in ZOO_RUNS]
        runs.append(("mbt2018-mean", 8, ["--entropy-coder", "v2"], clic))
        for arch, q, opts, folder in runs:
            tag = f"{arch} q{q} {' '.join(opts) or 'v1 (autoregressive)'}" + (
                " CLIC" if folder == clic else "")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = eval_model.main([folder, "-a", arch, "-q", str(q), "--device", "cuda", *opts])
            wall = time.perf_counter() - t0
            got = kernels.launch_counts()
            if rc != 0:
                raise RuntimeError(f"[zoo] {tag}: eval_model exited {rc}")
            res = json.loads(buf.getvalue())["results"]
            if not all(np.isfinite(v[0]) for v in res.values()):
                raise RuntimeError(f"[zoo] {tag}: eval_model results not finite: {res}")
            coder = "none" if "--entropy-estimation" in opts else (
                "v1" if "v1" in opts or arch.startswith("cheng") else "v2")
            need = ("rans_encode", "rans_decode_generic") if coder == "v2" else ()
            _require(got, need + (("rans_decode_sorted",) if folder == clic else ()), tag)
            if coder != "v2" and any(got.get(k, 0) for k in RANS):
                raise RuntimeError(f"[zoo] {tag}: the {coder} path launched {got}")
            launches.append(got)
            log(f"[zoo] {tag}: eval_model.main {wall:.2f} s with the model build; bpp "
                f"{res['bpp'][0]:.6f}, encode {res['encoding_time'][0]:.4f} s, decode "
                f"{res['decoding_time'][0]:.4f} s (means over {len(os.listdir(folder))} "
                f"image(s)), mse {res['mse'][0]:.6g}, psnr {res['psnr'][0]:.4f}; launches "
                f"{got}  ({card})")
            if coder == "none":
                continue
            _, codec = load_model(arch, q, coder="v2" if coder == "v2" else "v1", device=dev)
            x, _ = eval_model._pad(eval_model.read_input(Path(folder, "img0.npy"))[None], 64)
            rt = zoo_roundtrip(codec, x, dev, tag, card)
            launches.append(rt["launches"])
            if folder == clic:
                from cra5_tpu_torch.coder.lane_coder import parse_v2_header

                n, K, esc, _, srt, safe, _ = parse_v2_header(rt["out"]["strings"][0][0])
                if not (K == 8192 and srt and safe):
                    raise RuntimeError(f"[zoo] CLIC y stream: K {K}, sorted {srt}, safe {safe}; "
                                       f"expected 8192 lanes sorted and kernel-safe (K3)")
                log(f"[zoo] CLIC y: {n} symbols padded to {x.shape[-2:]} on {K} lanes, sorted, "
                    f"kernel-safe, {esc} escapes, {len(rt['out']['strings'][0][0])} B: K3  "
                    f"({card})")
            del codec
            torch.cuda.empty_cache()
    log(f"[zoo] phase {time.time() - t_phase:.1f} s  ({card})")
    return _sum_launches(*launches)


# ---------------------------------------------------------------- serve phase
SERVE_STAMPS = ("2024-01-01T00:00:00", "2024-01-01T06:00:00")
CDF_BUFFERS = ("entropy_bottleneck._cdf_length", "entropy_bottleneck._offset",
               "entropy_bottleneck._quantized_cdf", "gaussian_conditional._cdf_length",
               "gaussian_conditional._offset", "gaussian_conditional._quantized_cdf",
               "gaussian_conditional.scale_table")


def reference_state_dict(model) -> dict:
    """The port's VAEformer as the reference's state dict (CPU float32
    copies): the inverse of tools/convert_torch.py's layouts, kept here and
    not in the package. The patch embeds' ``weight``/``bias`` go under
    ``patch_embed.proj``, the EntropyBottleneck's ``matrixN``/``biasN``/
    ``factorN`` become ``_matrixN``/..., every other name and layout stays;
    then the reference's non-parameter buffers, at CompressAI's values."""
    sd = {}
    for name, p in model.named_parameters():
        key = re.sub(r"\.patch_embed\.(weight|bias)$", r".patch_embed.proj.\1", name)
        key = re.sub(r"^entropy_bottleneck\.(matrix|bias|factor)(\d+)$",
                     r"entropy_bottleneck._\1\2", key)
        sd[key] = p.detach().float().cpu().clone()
    t = float(np.log(2 / 1e-9 - 1))
    sd.update({"entropy_bottleneck.likelihood_lower_bound.bound": torch.tensor([1e-9]),
               "entropy_bottleneck.target": torch.tensor([-t, 0.0, t]),
               "gaussian_conditional.likelihood_lower_bound.bound": torch.tensor([1e-9]),
               "gaussian_conditional.lower_bound_scale.bound": torch.tensor([0.11]),
               "gaussian_conditional.scale_bound": torch.tensor([0.11])})
    return sd


def with_cdf_buffers(sd: dict, tables=None) -> dict:
    """``sd`` with the seven CDF buffers: ``tables`` ({"eb", "gc",
    "scale_table"}), or empty, as the published manifest lists them."""
    out = dict(sd)
    for key in CDF_BUFFERS:
        module, field = key.split(".")
        if field == "scale_table":
            value = np.zeros(0, np.float32) if tables is None else tables["scale_table"]
        else:
            table = None if tables is None else tables["eb" if module[0] == "e" else "gc"]
            value = np.zeros(0, np.int32) if table is None else getattr(table, field[1:])
        out[key] = torch.from_numpy(np.array(value))
    return out


def _same_tables(got: dict, want: dict) -> bool:
    return (all(np.array_equal(getattr(got[k], f), getattr(want[k], f))
                for k in ("eb", "gc") for f in ("quantized_cdf", "cdf_length", "offset"))
            and np.array_equal(got["scale_table"], want["scale_table"]))


def phase_serve(dev, card: str) -> dict:
    """The published-model serving path at full width in float32 (the
    default of VAEformer, cra5_api and serve), on seeded weights in the
    reference's .pth format (reference_state_dict) with trained-style CDF
    tables: the EB table of its own EB params and a GC table built from a
    non-default scale table (48 levels from 0.15). Steps: the .pth round
    trip and the manifest gate; cra5_api(weights=.pth) writing the
    SERVE_STAMPS .bin files (synthetic fields) with the file's tables;
    the first bin's y and z streams held by hold_stream_kernels (K1 and
    the decode kernel each takes exact against their plain versions under
    the file's tables, the decode equal to the encoder's symbols);
    tools/serve.main over them (4 threads, --denormalize; the counters
    zeroed just before and read just after: K2 on every z stream, the y
    kernel each header names, the float32 K4 three times a decode); each
    .npy held bitwise to cra5_api's decode_from_bin; era5_eval over the
    pairs; decode_profile at 268 with small depths (its launches counted
    too). Returns {"serve": launches, "decode_profile": launches}."""
    import os
    import tempfile

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.api.bitstream import load_bin
    from cra5_tpu_torch.api.cra5_api import cra5_api
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header
    from cra5_tpu_torch.entropy import eb_update, gc_update, get_scale_table
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268
    from cra5_tpu_torch.nn.vit import _win_for_block
    from cra5_tpu_torch.tools import convert_torch, decode_profile, era5_eval, serve

    t_phase = time.time()
    cfg = vaeformer_268()
    g_s_global = sum(_win_for_block(cfg.depth // 2 + j, True, cfg.interval, cfg.window_sizes)
                     is None for j in range(cfg.depth - cfg.depth // 2))  # 3 at 268v
    with tempfile.TemporaryDirectory() as root:
        # 1. the reference-format state dict, its round trip, the gate
        t0 = time.time()
        model = VAEformer(cfg, device=dev).reset_parameters(SEED)
        scale_table = get_scale_table(0.15, 256.0, 48)
        tables = {"eb": eb_update(model.entropy_bottleneck.params_numpy()),
                  "gc": gc_update(scale_table), "scale_table": scale_table}
        sd = reference_state_dict(model)
        full = with_cdf_buffers(sd, tables)
        params = convert_torch.convert_checkpoint("", state_dict=full, model=model)
        got_tables = params.pop("_cdf_tables")
        own = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del model
        torch.cuda.empty_cache()
        if list(params) != list(own) or not all(torch.equal(params[n], own[n]) for n in own):
            raise RuntimeError("[serve] convert_checkpoint of the reference dict differs from "
                               "the model's params")
        if not _same_tables(got_tables, tables):
            raise RuntimeError("[serve] the converted CDF tables differ from the dict's")
        report = convert_torch.verify_268_manifest(full)
        if report != {"missing": [], "extra": [], "shape_mismatch": sorted(CDF_BUFFERS)}:
            raise RuntimeError(f"[serve] manifest report {report}: expected the seven CDF "
                               f"buffers reshaped and nothing else")
        del params, own
        pth = os.path.join(root, "cra5_268v_seeded.pth")
        torch.save(full, pth)
        exact, out_msgpack = os.path.join(root, "exact.pth"), os.path.join(root, "exact.msgpack")
        torch.save(with_cdf_buffers(sd), exact)
        del sd, full
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf), contextlib.redirect_stdout(io.StringIO()):
            rc = convert_torch.main([exact, "-o", out_msgpack])
        if rc != 0 or not buf.getvalue().startswith("manifest OK"):
            raise RuntimeError(f"[serve] convert_torch.main on the manifest-exact copy: rc {rc}, "
                               f"{buf.getvalue()[:300]}")
        msgpack_gib = os.path.getsize(out_msgpack) / 2**30
        os.remove(exact)
        os.remove(out_msgpack)
        log(f"[serve] reference .pth of vaeformer_268 (seed {SEED}): convert_checkpoint gives "
            f"the params bitwise and the tables; the manifest reports only the seven CDF buffers "
            f"reshaped; convert_torch.main on the manifest-exact copy exits 0 "
            f"({msgpack_gib:.2f} GiB .msgpack); .pth {os.path.getsize(pth) / 2**30:.2f} GiB; "
            f"{time.time() - t0:.1f} s  ({card})")

        # 2. the bins, written by cra5_api with the file's tables
        t0 = time.time()
        api = cra5_api(model_version=268, weights=pth, device=dev)
        c = api.codec
        if not _same_tables({"eb": c._eb_table, "gc": c._gc_table,
                             "scale_table": c.scale_table}, tables):
            raise RuntimeError("[serve] cra5_api did not install the file's tables")
        bins, fields = os.path.join(root, "bins"), {}
        written = {}
        for ts in SERVE_STAMPS:
            fields[ts] = api._read_or_synthesize(ts)  # the synthetic field, kept as the target
            written[ts] = api.encode_era5_as_bin(ts, save_root=bins)
        ts0 = SERVE_STAMPS[0]
        # the first bin's streams under the file's tables, as served: K1 and
        # the decode kernel each takes against their plain versions, and the
        # decode against the symbols of cra5_api's encode
        with torch.inference_mode():
            enc0 = c.model.symbols_from_latent(c.model.encode_latent(
                torch.as_tensor(api.normalization(fields[ts0])[None], device=dev)))
        hold_stream_kernels(c, {"strings": load_bin(written[ts0]["save_path"])[0]}, enc0,
                            f"268v {ts0}", card, "serve kernels")
        del enc0
        fresh = VAEformerCodec(api.net)
        fresh.update()
        y_fresh = fresh.compress(api.normalization(fields[ts0])[None])["strings"][0][0]
        if y_fresh == written[ts0]["output"]["strings"][0][0]:
            raise RuntimeError("[serve] the y stream equals the one of recomputed tables")
        del fresh
        bin_dir = os.path.join(bins, "CRA5", "2024")
        sizes = [os.path.getsize(w["save_path"]) for w in written.values()]
        log(f"[serve] cra5_api(weights=.pth) float32 installed the file's scale table "
            f"({len(scale_table)} levels) and EB/GC tables; {len(SERVE_STAMPS)} .bin files "
            f"{sizes} B, {time.time() - t0:.1f} s with the synthetic fields; the y stream "
            f"differs from recomputed tables' ({len(y_fresh)} B)  ({card})")

        # 3. serve, the counters zeroed just before and read just after
        out_dir = os.path.join(root, "npy")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main([bin_dir, "-o", out_dir, "--config", "268", "--checkpoint", pth,
                             "--threads", "4", "--denormalize"])
        torch.cuda.synchronize()
        serve_wall = time.time() - t0
        launches = kernels.launch_counts()
        if rc != 0:
            raise RuntimeError(f"[serve] serve.main exited {rc}")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        served = sorted(os.listdir(bin_dir))
        decodes = [served[0]] + served  # the warm decode, then every file
        heads = {b: parse_v2_header(load_bin(os.path.join(bin_dir, b))[0][0][0]) for b in served}
        k3 = sum(1 for b in decodes if heads[b][4] and heads[b][5])
        want = {k: 0 for k in launches}
        want.update(rans_decode_generic=len(decodes) + len(decodes) - k3,
                    rans_decode_sorted=k3, flash_attention_forward=g_s_global * len(decodes))
        want = _with_containers(want)
        if launches != want or line["decoded"] != len(served) or line["kernel_fallbacks"]:
            raise RuntimeError(f"[serve] launches {launches} (expected {want}), line {line}")
        y_heads = [(h[0], h[1], h[2], h[4], h[5]) for h in heads.values()]
        log(f"[serve] serve.main --config 268 --threads 4 --denormalize: {line['decoded']} "
            f"decodes in {line['seconds']} s, {line['decodes_per_sec']} decodes/s; the call "
            f"{serve_wall:.1f} s with the model build and the .pth read; y headers (n, K, "
            f"escapes, sorted, safe) {y_heads}; launches {launches}  ({card})")

        # 4. each .npy against the API's decode, bitwise; the split; the score
        names = [api.channels_to_vname[i] for i in range(api.model_cfg.in_chans)]
        recon, target = [], []
        dec_s, write_s = [], []
        path = os.path.join(bin_dir, f"{SERVE_STAMPS[0]}.bin")
        strings, z_shape = load_bin(path)
        c.stage_times = {}
        x_dev = c.decompress(strings, z_shape)["x_hat"]
        stages, c.stage_times = c.stage_times, None
        t1 = time.time()
        on_host = x_dev[0].float().cpu().numpy()
        t_host = time.time() - t1
        t1 = time.time()
        api.de_normalization(on_host)
        t_denorm = time.time() - t1
        del x_dev, on_host
        log("[serve] one decode's split: stages (each ends in a synchronize) " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()) + f"; the field to the host "
            f"{t_host:.4f} s, de-normalised {t_denorm:.4f} s  ({card})")
        for ts in SERVE_STAMPS:
            path = os.path.join(bin_dir, f"{ts}.bin")
            torch.cuda.synchronize()
            t1 = time.time()
            want_x = api.decode_from_bin(custom_path=path)["x_hat"]
            dec_s.append(time.time() - t1)
            got_x = np.load(os.path.join(out_dir, f"{ts}.npy"))
            if got_x.dtype != np.float32 or not np.array_equal(got_x, want_x):
                raise RuntimeError(f"[serve] {ts}.npy differs from decode_from_bin")
            t1 = time.time()
            np.save(os.path.join(root, "write_probe.npy"), got_x)
            write_s.append(time.time() - t1)
            os.remove(os.path.join(root, "write_probe.npy"))
            os.remove(os.path.join(out_dir, f"{ts}.npy"))
            recon.append(got_x)
            target.append(fields[ts])
        log(f"[serve] every .npy equals cra5_api's decode_from_bin (de-normalized) bitwise; "
            f"decode_from_bin {[round(s, 4) for s in dec_s]} s against np.save of the "
            f"{recon[0].nbytes / 1e9:.2f} GB field {[round(s, 4) for s in write_s]} s  ({card})")
        del api, fields
        torch.cuda.empty_cache()
        t0 = time.time()
        score = era5_eval.evaluate_fields(np.stack(recon), np.stack(target), names, device=dev)
        del recon, target
        worst = sorted(score["wrmse"].items(), key=lambda kv: -kv[1])[:3]
        if not np.isfinite(score["mean_wrmse"]):
            raise RuntimeError(f"[serve] era5_eval mean_wrmse {score['mean_wrmse']}")
        log(f"[serve] era5_eval over the {len(SERVE_STAMPS)} pairs (random weights, not an RD "
            f"point): mean_wrmse {score['mean_wrmse']:.6g}, mean_mae {score['mean_mae']:.6g}, "
            f"worst wrmse {[(k, round(v, 6)) for k, v in worst]}, {time.time() - t0:.1f} s  "
            f"({card})")

    # 5. decode_profile at 268 with small depths
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = decode_profile.main(["--depths", "2", "--batches", "1", "--iters", "2",
                                  "--per-window", "6", "--phase-iters", "2"])
    torch.cuda.synchronize()
    prof_launches = kernels.launch_counts()
    if rc != 0:
        raise RuntimeError(f"[serve] decode_profile exited {rc}: {err.getvalue()[-2000:]}")
    prof = json.loads(buf.getvalue().strip().splitlines()[-1])
    _require(prof_launches, ("rans_encode", "rans_decode_generic", "flash_attention_forward"),
             "decode_profile")
    log(f"[serve] decode_profile --depths 2 --batches 1 --iters 2 --per-window 6 "
        f"--phase-iters 2 (268v bf16, calibrated), "
        f"{time.time() - t0:.1f} s: {json.dumps(prof)}  ({card})")
    log(f"[serve] decode_profile launches {prof_launches}  ({card})")
    log(f"[serve] phase {time.time() - t_phase:.1f} s  ({card})")
    return {"serve": launches, "decode_profile": prof_launches}


# --variants: the ERA5 VAEformer variants, the vivt69 experiment, finalize
VIVT69_STEPS = 150  # vivt69_experiment.main's training steps on the card
FINALIZE_WORKERS = "1,2,4,8"


def variant_roundtrip(codec, x: np.ndarray, dev, tag: str, card: str) -> dict:
    """One warm roundtrip, then one with every stage synchronised (host ms a
    stage), the counters zeroed just before and read just after. Gates:
    the decoded z and y symbols equal the encoded ones, x_hat equals
    reconstruct_from_y_symbols of the encoded symbols bitwise and is a
    finite full-size field, the launches are the streams' (K1 each, the
    decode kernel its header names) and 7 K4 (g_a's 4 global blocks and
    g_s's 3); then hold_stream_kernels on the y and z streams."""
    from cra5_tpu_torch import bench, kernels
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header

    model = codec.model
    codec.update()
    out = codec.compress(x)  # warm-up
    codec.decompress(out["strings"], out["z_shape"])
    codec.stage_times = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = codec.compress(x)
    t1 = time.perf_counter()
    x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts()
    stages, codec.stage_times = codec.stage_times, None

    with torch.inference_mode():
        enc = model.encode_symbols(torch.from_numpy(x).to(dev))
        ref = model.reconstruct_from_y_symbols(enc["y_sym"], enc["means"])
    z_dec, y_dec = bench.decode_symbols(codec, out["strings"], out["z_shape"])
    if not (torch.equal(z_dec, enc["z_sym"]) and torch.equal(y_dec, enc["y_sym"])):
        raise RuntimeError(f"[variants] {tag}: decoded symbols differ from the encoded ones")
    if not torch.equal(x_hat, ref):
        raise RuntimeError(f"[variants] {tag}: decompress's x_hat differs from reconstruct of "
                           f"the encoded symbols")
    if tuple(x_hat.shape) != x.shape or not torch.isfinite(x_hat).all():
        raise RuntimeError(f"[variants] {tag}: x_hat {tuple(x_hat.shape)} is not a finite "
                           f"full-size field")
    rows, want = _stream_kernels(out)
    want["flash_attention_forward"] = 7
    got = {k: launches.get(k, 0) for k in want}
    if got != want or any(v for k, v in launches.items() if k not in want):
        raise RuntimeError(f"[variants] {tag}: launches {launches}, expected {want}")
    held = hold_stream_kernels(codec, out, enc, tag, card, where="variants kernels")
    for group, K, srt, safe, nbytes, kern in rows:
        log(f"[variants] {tag}: {group} stream {nbytes} B on {K} lanes, sorted {srt}, "
            f"kernel-safe {safe}: decodes on {kern}  ({card})")
    ms = {k: round(v * 1e3, 3) for k, v in stages.items()}
    yh = parse_v2_header(out["strings"][0][0])
    log(f"[variants] {tag}: compress {t1 - t0:.4f} s, decompress {t2 - t1:.4f} s, roundtrip "
        f"{t2 - t0:.4f} s (stages synchronised); y {len(out['strings'][0][0])} B ({yh[2]} "
        f"escapes of {yh[0]}), z {len(out['strings'][1][0])} B; host ms a stage {ms}; "
        f"launches {launches}; symbols exact, x_hat bitwise reconstruct  ({card})")
    return dict(launches=launches, out=out, roundtrip_s=t2 - t0, y_header=yh, held=held)


def variant_forward(model, x: np.ndarray, tag: str, card: str, zero_kl: bool) -> None:
    """One eval forward: finite x_hat and likelihoods, and a KL that is
    finite (all zeros for the mean-scale baseline)."""
    with torch.inference_mode():
        out = model(torch.from_numpy(x).to(model.device))
    kl = out["kl"].float()
    finite = all(torch.isfinite(t).all() for t in (out["x_hat"], out["likelihoods"]["y"],
                                                   out["likelihoods"]["z"], kl))
    if not finite or (zero_kl and kl.abs().max().item() != 0.0):
        raise RuntimeError(f"[variants] {tag}: forward finite {finite}, kl {kl.tolist()}")
    log(f"[variants] {tag}: forward x_hat {tuple(out['x_hat'].shape)} finite, kl "
        f"{kl.tolist()}  ({card})")


def phase_variants(dev, card: str) -> dict:
    """The ERA5 VAEformer variants at vaeformer_268's full width and depth,
    bf16, seeded weights, one seeded (1, 268, 721, 1440) host field (each
    model freed before the next): VariationCNNPrior (variational, then the
    mean-scale baseline) and the former baseline through VAEformerCodec v2
    (variant_roundtrip; the former baseline's y is 10.6 M symbols on 16384
    lanes, K3's widest model stream); VITAutoencoderKL's forward in the
    mode and sampled from a card generator; Trainer.fit on
    VariationCNNPrior with remat (one warm-up step, three timed);
    vivt69_experiment.main at its default geometry and widths (float32,
    one lambda, VIVT69_STEPS steps, the device sampler, --nval 2);
    finalize_scaling record --model 268 (calibrated, the bench's cache)
    and replay --parse at FINALIZE_WORKERS threads. The counters are zeroed
    just before each path and read just after; returns each path's
    launches by name."""
    import dataclasses
    import os
    import tempfile

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models import (VAEformer, VAEformerCodec, VariationCNNPrior,
                                       VITAutoencoderKL, vaeformer_268,
                                       vaeformer_former_baseline)
    from cra5_tpu_torch.tools import finalize_scaling, vivt69_experiment
    from cra5_tpu_torch.train import Trainer, TrainerConfig

    t_phase = time.time()
    cfg = vaeformer_268()
    x = np.random.default_rng(SEED).standard_normal((1, cfg.in_chans, *cfg.img_size), np.float32)
    paths = {}

    # 1-3. the codecs
    codec_launches, y_held = [], {}
    for tag, build in (
            ("VariationCNNPrior", lambda: VariationCNNPrior(cfg, dtype=torch.bfloat16, device=dev)),
            ("MeanScale baseline", lambda: VariationCNNPrior(cfg, variational=False,
                                                             dtype=torch.bfloat16, device=dev)),
            ("former baseline", lambda: VAEformer(vaeformer_former_baseline(),
                                                  dtype=torch.bfloat16, device=dev))):
        t0 = time.time()
        model = build().reset_parameters(SEED)
        codec = VAEformerCodec(model)
        codec.update()
        torch.cuda.synchronize()
        log(f"[variants] {tag} 268v bf16: {sum(p.numel() for p in model.parameters())} params, "
            f"seeded init + tables {time.time() - t0:.2f} s  ({card})")
        variant_forward(model, x, tag, card, zero_kl=tag.startswith("MeanScale"))
        res = variant_roundtrip(codec, x, dev, tag, card)
        codec_launches.append(res["launches"])
        y_held[tag] = res["held"]["y"]
        if tag == "former baseline":
            n, K, _, _, srt, safe, _ = res["y_header"]
            if (K, srt, safe) != (16384, True, True):
                raise RuntimeError(f"[variants] former baseline y header {res['y_header']}: "
                                   f"expected 16384 lanes, sorted and kernel-safe (K3)")
            wide, main = y_held[tag], y_held["VariationCNNPrior"]
            log(f"[variants] former baseline y: {n} symbols on {K} lanes x {wide['steps']} "
                f"steps, K3 device {wide['dec_us'] / 1e3:.4f} ms "
                f"({wide['dec_us'] / wide['steps']:.3f} us a step, bound "
                f"{wide['dec_bound_ms']:.4f} ms); VariationCNNPrior's y in this run on "
                f"{main['K']} lanes x {main['steps']} steps, {main['dec']} device "
                f"{main['dec_us'] / 1e3:.4f} ms ({main['dec_us'] / main['steps']:.3f} us a "
                f"step, bound {main['dec_bound_ms']:.4f} ms)  ({card})")
        del model, codec, res
        torch.cuda.empty_cache()
    paths["variants_codec"] = _sum_launches(*codec_launches)

    # 4. VITAutoencoderKL
    model = VITAutoencoderKL(cfg, dtype=torch.bfloat16, device=dev).reset_parameters(SEED)
    xd = torch.from_numpy(x).to(dev)
    with torch.inference_mode():
        model(xd, sample_posterior=False)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        mode = model(xd, sample_posterior=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sampled = model(xd, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = kernels.launch_counts()
    kl = mode["kl"].float()
    if not (torch.isfinite(kl).all() and torch.isfinite(mode["x_hat"]).all()
            and torch.isfinite(sampled["x_hat"]).all()):
        raise RuntimeError(f"[variants] VITAutoencoderKL: kl {kl.tolist()}, x_hat finite "
                           f"{bool(torch.isfinite(mode['x_hat']).all())}")
    if torch.equal(sampled["x_hat"], mode["x_hat"]):
        raise RuntimeError("[variants] VITAutoencoderKL: the sampled x_hat equals the mode's")
    want = {k: 0 for k in launches}
    want["flash_attention_forward"] = 14
    if launches != want:
        raise RuntimeError(f"[variants] VITAutoencoderKL launches {launches}, expected {want}")
    log(f"[variants] VITAutoencoderKL 268v bf16: forward (mode) {t1 - t0:.4f} s, sampled "
        f"{t2 - t1:.4f} s; kl {kl.tolist()}; max |sampled - mode| "
        f"{(sampled['x_hat'] - mode['x_hat']).abs().max().item():.4g}; launches {launches}  "
        f"({card})")
    paths["variants_vae"] = launches
    del model, mode, sampled, xd
    torch.cuda.empty_cache()

    # 5. Trainer.fit on VariationCNNPrior, bf16, remat
    rcfg = dataclasses.replace(cfg, remat=True)
    model = VariationCNNPrior(rcfg, dtype=torch.bfloat16, device=dev)
    trainer = Trainer(model, TrainerConfig(log_every=1, ckpt_every=10**9, use_kl=True),
                      seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fields = [torch.randn((1, cfg.in_chans, *cfg.img_size), generator=gen, device=dev) * 0.5
              for _ in range(TRAIN_STEPS + 1)]
    state = trainer.fit(fields[:1], num_steps=1, log_fn=lambda *a: None)  # init + warm-up
    stamps, metrics = [], []

    def log_fn(step, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append(m)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    stamps.append(time.perf_counter())
    state = trainer.fit(fields[1:], state=state, num_steps=TRAIN_STEPS, log_fn=log_fn)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    if len(metrics) != TRAIN_STEPS or not all(np.isfinite(v) for m in metrics
                                              for v in m.values()):
        raise RuntimeError(f"[variants] train metrics are not all finite: {metrics}")
    per_step = {"flash_attention_forward": 14, "flash_attention_backward_dq": 7,
                "flash_attention_backward_dkv": 7}
    want = {k: 0 for k in launches}
    want.update({k: v * TRAIN_STEPS for k, v in per_step.items()})
    if launches != want:
        raise RuntimeError(f"[variants] train launches {launches}, expected {want}")
    log(f"[variants] train VariationCNNPrior 268v bf16 remat use_kl: steps "
        f"{[round(v, 4) for v in steps_s]} s, median {statistics.median(steps_s):.4f} s; peak "
        f"{peak / 2**30:.2f} GiB; last metrics "
        f"{ {k: round(v, 6) for k, v in metrics[-1].items() if k != 'steps_per_sec'} }; "
        f"launches {launches}  ({card})")
    paths["variants_train"] = launches
    del model, trainer, state, fields
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        # 6. the VIVT-69 experiment, float32 at 181 x 360
        out_json = os.path.join(root, "rd.json")
        err = io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            rc = vivt69_experiment.main(["-o", out_json, "--steps", str(VIVT69_STEPS),
                                         "--lmbdas", "128", "--ntrain", "0", "--nval", "2",
                                         "--device", "cuda"])
        wall = time.time() - t0
        launches = kernels.launch_counts()
        if rc != 0:
            raise RuntimeError(f"[variants] vivt69 exited {rc}: {err.getvalue()[-2000:]}")
        rd = json.load(open(out_json))
        (point,) = rd["points"]
        if not (np.isfinite(point["bpsp"]) and np.isfinite(point["MSE"]) and point["bpsp"] > 0):
            raise RuntimeError(f"[variants] vivt69 point {point}")
        _require(launches, ("rans_encode", "rans_decode_generic"), "vivt69")
        rates = [float(m) for m in re.findall(r"steps_per_sec=([0-9.e+-]+)", err.getvalue())]
        trained = re.search(r"trained (\d+) steps in (\d+)s", err.getvalue())
        log(f"[variants] vivt69 main --steps {VIVT69_STEPS} (69 x 181 x 360, width 384, depth "
            f"10, batch 4, float32, device sampler): {wall:.1f} s in all; steps/s by log "
            f"window {[round(r, 3) for r in rates]}, {1.0 / statistics.median(rates[1:] or rates):.4f} "
            f"s a step (median of the windows after the first); {trained.group(0) if trained else ''}; "
            f"point {point}; launches {launches}  ({card})")
        paths["vivt69"] = launches
        torch.cuda.empty_cache()

        # 7. finalize_scaling: record on the card, replay on the host
        npz = os.path.join(root, "fin.npz")
        buf = io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = finalize_scaling.main(["record", "-o", npz, "--model", "268",
                                        "--device", "cuda"])
        launches = kernels.launch_counts()
        if rc != 0:
            raise RuntimeError(f"[variants] finalize record exited {rc}")
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        _require(launches, ("rans_encode", "flash_attention_forward"), "finalize record")
        log(f"[variants] finalize record --model 268 {time.time() - t0:.1f} s: {json.dumps(rec)}; "
            f"launches {launches}  ({card})")
        paths["finalize"] = launches
        torch.cuda.empty_cache()
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = finalize_scaling.main(["replay", npz, "--workers", FINALIZE_WORKERS,
                                        "--seconds", "1.0", "--parse"])
        if rc != 0:
            raise RuntimeError(f"[variants] finalize replay exited {rc}")
        log(f"[variants] finalize replay --parse ({time.time() - t0:.1f} s; every replayed "
            f"container byte-identical to the recording): {buf.getvalue().strip()}  ({card})")
    log(f"[variants] phase {time.time() - t_phase:.1f} s  ({card})")
    return paths


# -------------------------------------------------------------- context phase
# eval_model.main at the published widths: (arch, quality, options, images)
CONTEXT_RUNS = (
    ("elic2022", 4, [], 2),
    ("stf", 4, [], 2),
    ("tcm2023", 4, [], 2),
    ("invcompress", 4, [], 1),
    ("elic2022", 4, ["--entropy-estimation"], 2),
)
# card against CPU: the JAX tests' tiny widths, on a 3 x 128 x 192 image
CONTEXT_TINY = (
    ("ELIC2022", dict(N=32, M=64, num_slices=3)),
    ("SymmetricalTransFormer2022", dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                                        num_slices=4)),
    ("TCM2023", dict(config=(1,) * 6, head_dim=(4,) * 6, N=8, M=20, num_slices=4,
                     max_support_slices=2)),
)


def _outs(seen: dict, name: str) -> list:
    return [out for _, out in seen.get(name, [])]


def context_card_vs_cpu(dev, card: str) -> dict:
    """ELIC, STF and TCM at the tiny widths of CONTEXT_TINY, the same seeded
    weights on the card and on the CPU, one roundtrip of a seeded 3 x 128 x
    192 image on each: every stream byte-identical, x_hat within
    ZOO_XHAT_RTOL x max|ref|. Should a symbol or index flip on a rounding
    boundary, the flips are printed pass by pass and the card's coder is
    held to the CPU's streams on the CPU's symbols and indexes; the x_hat
    bound stays."""
    from cra5_tpu_torch import kernels, models
    from cra5_tpu_torch.models import make_codec

    x = np.random.default_rng(SEED).random((1, 3, 128, 192), np.float32)
    launches = []
    for name, kw in CONTEXT_TINY:
        gpu = getattr(models, name)(**kw, device=dev).reset_parameters(SEED)
        cpu = getattr(models, name)(**kw, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        a, b = make_codec(gpu), make_codec(cpu)
        a.compress(x)  # warm-up
        seen_a, seen_b = {}, {}
        for codec, seen in ((a, seen_a), (b, seen_b)):
            for m in ("_symbols", "_indexes"):
                _record(codec, m, seen)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = a.compress(x)
        x_gpu = a.decompress(out["strings"], out["shape"])["x_hat"]
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        ref = b.compress(x)
        x_cpu = b.decompress(ref["strings"], ref["shape"])["x_hat"]
        err = (x_gpu.cpu() - x_cpu).abs().max().item()
        bound = ZOO_XHAT_RTOL * x_cpu.abs().max().item()
        n = len(ref["strings"][0])
        if out["strings"] != ref["strings"]:
            sa, sb = _outs(seen_a, "_symbols"), _outs(seen_b, "_symbols")
            ia, ib = _outs(seen_a, "_indexes")[:n], _outs(seen_b, "_indexes")[:n]
            flips = [(p, int((u.cpu() != v).sum()), int((i.cpu() != j).sum()))
                     for p, (u, v, i, j) in enumerate(zip(sa, sb, ia, ib))]
            log(f"[context] card vs CPU, {name}: streams differ; (pass, symbols differing, "
                f"indexes differing): {flips}; z streams equal "
                f"{out['strings'][1] == ref['strings'][1]}  ({card})")
            coded = [a._gc_coder.encode_from_device(u[0].to(dev), i[0].to(dev))
                     for u, i in zip(sb, ib)]
            if coded != ref["strings"][0] or out["strings"][1] != ref["strings"][1]:
                raise RuntimeError(f"[context] card vs CPU, {name}: the card's coder on the "
                                   f"CPU's symbols and indexes does not write the CPU's streams")
        if not err <= bound:
            raise RuntimeError(f"[context] card vs CPU, {name}: x_hat err {err} > {bound}")
        _require(got, ("rans_encode", "rans_decode_generic"), f"context card vs CPU {name}")
        launches.append(got)
        log(f"[context] card vs CPU, {name} {kw} on (1, 3, 128, 192): {n} y streams and the z "
            f"stream byte-identical {out['strings'] == ref['strings']} "
            f"({sum(map(len, out['strings'][0]))} + {len(out['strings'][1][0])} B), x_hat err "
            f"{err:.3g} (bound {ZOO_XHAT_RTOL} x max|ref| = {bound:.3g}); launches {got}  "
            f"({card})")
    return _sum_launches(*launches)


def context_roundtrip(codec, x: np.ndarray, dev, tag: str, card: str) -> dict:
    """One ElicCodec / CharmCodec roundtrip with every stage synchronised
    (host ms a stage), the counters zeroed just before and read just after.
    Gates: the decoder's GC indexes of every pass (ELIC: anchors and
    non-anchors of each group; charm: each slice) equal the encoder's, the
    decoded symbols equal the encoded ones, decompress's y_hat equals the
    encoder's and its x_hat equals synthesis of the encoder's y_hat
    bitwise, and the launches are the streams' (K1 each, the decode kernel
    its header names, nothing else). Then hold_streams on the z stream and
    every y stream of the first sample, and the coder's share of the
    roundtrip (the streams' K1 and decode device time)."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models import ElicCodec

    model, elic = codec.model, isinstance(codec, ElicCodec)
    hat = "_hat" if elic else "_slice_hat"
    codec.update()  # the CDF tables, built on the host at first use: not timed
    seen = {}
    spies = ((model, "analysis"), (model, "synthesis"), (codec, "_symbols"),
             (codec, "_indexes"), (codec, "_decode"), (codec, hat))
    for obj, name in spies:
        _record(obj, name, seen)
    codec.stage_times = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = codec.compress(x)
    t1 = time.perf_counter()
    x_hat = codec.decompress(out["strings"], out["shape"])["x_hat"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts()
    stages, codec.stage_times = codec.stage_times, None
    for obj, name in spies:
        delattr(obj, name)

    syms, idx, decs, hats = (_outs(seen, k) for k in ("_symbols", "_indexes", "_decode", hat))
    n = len(syms)
    enc_idx, dec_idx = idx[:n], idx[n:]
    bad = [p for p in range(n) if p >= len(dec_idx) or not torch.equal(enc_idx[p], dec_idx[p])]
    if len(dec_idx) != n or bad:
        raise RuntimeError(f"[context] {tag}: the decoder's GC indexes differ from the "
                           f"encoder's in passes {bad} of {n}")
    if len(decs) != n or not all(torch.equal(u, v) for u, v in zip(syms, decs)):
        raise RuntimeError(f"[context] {tag}: decoded symbols differ from the encoded ones")
    if elic:  # each group's y_hat: its anchor pass's plus its non-anchor pass's
        y_enc = torch.cat([hats[p] + hats[p + 1] for p in range(0, n, 2)], dim=1)
    else:
        y_enc = torch.cat(hats[:n], dim=1)
    (y_dec,), _ = seen["synthesis"][0]
    with torch.inference_mode():
        ref = model.synthesis(y_enc)
    if not torch.equal(y_dec, y_enc) or not torch.equal(x_hat, ref):
        raise RuntimeError(f"[context] {tag}: decompress's y_hat equal {torch.equal(y_dec, y_enc)}"
                           f", x_hat equal to synthesis of the encoder's y_hat "
                           f"{torch.equal(x_hat, ref)}")
    rows, want = _stream_kernels(out)
    got = {k: launches.get(k, 0) for k in RANS}
    if got != want or any(v for k, v in launches.items() if k not in RANS):
        raise RuntimeError(f"[context] {tag}: launches {launches}, expected {want}")

    z_sym = _outs(seen, "analysis")[0]["z_sym"]
    B = z_sym.shape[0]
    streams = [("z", codec._eb_coder, z_sym[0], codec._channel_indexes(z_sym.shape)[0],
                out["strings"][1][0])]
    for p in range(n):
        label = f"y{p // 2}{'a' if p % 2 == 0 else 'n'}" if elic else f"y{p}"
        streams.append((label, codec._gc_coder, syms[p][0], enc_idx[p][0],
                        out["strings"][0][p * B]))
    held = hold_streams(streams, tag, card, "context kernels")
    times = [t for h in held.values() for t in (h["k1_us"], h["dec_us"]) if t == t]
    coder_us = sum(times)
    ms = {k: round(v * 1e3, 3) for k, v in stages.items()}
    kinds = {k: sum(r[-1] == k for r in rows) for k in ("K2", "K3")}
    log(f"[context] {tag}: synchronised roundtrip compress {t1 - t0:.4f} s, decompress "
        f"{t2 - t1:.4f} s; host ms a stage {ms}; {len(streams)} streams a sample (decode "
        f"kernels {kinds}), the first sample's coder kernels' device time "
        f"{coder_us / 1e3:.4f} ms ({len(times)} of {2 * len(streams)} kernels traced) = "
        f"{coder_us / 1e4 / (t2 - t0):.3f}% of the roundtrip; "
        f"launches {got}; indexes, symbols, y_hat and x_hat exact  ({card})")
    return dict(launches=launches, out=out, held=held, roundtrip_s=t2 - t0)


def phase_context(dev, card: str) -> dict:
    """The context-model image codecs on the card: card against CPU; then
    tools/eval_model.main (--device cuda) at their published widths on
    Kodak-size .npy images for each of CONTEXT_RUNS, each coded run
    followed by one synchronised roundtrip of its first image
    (context_roundtrip; InvCompress's AR codec: zoo_roundtrip); then one
    CLIC-size image through elic2022 q4, whose 192-channel group must code
    on 2048 lanes, sorted and kernel-safe, and decode on K3. The counters
    are zeroed just before each eval_model run and each roundtrip and read
    just after; the v2 runs must launch K1 and K2 (and K3 at CLIC size),
    InvCompress and the entropy estimation no coder kernel, and no run any
    other kernel (no flash kernel: Swin windows hold 16 or 64 tokens). Every
    run's launches join the kernels line's coder rows."""
    import os
    import tempfile
    from pathlib import Path

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header
    from cra5_tpu_torch.models import load_model
    from cra5_tpu_torch.tools import eval_model

    t_phase = time.time()
    launches = [context_card_vs_cpu(dev, card)]
    with tempfile.TemporaryDirectory() as root:
        kodak = {n: _zoo_folder(root, f"kodak{n}", n, KODAK, SEED) for n in (1, 2)}
        clic = _zoo_folder(root, "clic", 1, CLIC, SEED + 1)
        runs = [(a, q, o, kodak[n]) for a, q, o, n in CONTEXT_RUNS]
        runs.append(("elic2022", 4, [], clic))
        for arch, q, opts, folder in runs:
            ar = arch == "invcompress"
            tag = f"{arch} q{q} {' '.join(opts) or ('v1 (autoregressive)' if ar else 'v2')}" + (
                " CLIC" if folder == clic else "")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = eval_model.main([folder, "-a", arch, "-q", str(q), "--device", "cuda", *opts])
            wall = time.perf_counter() - t0
            got = kernels.launch_counts()
            if rc != 0:
                raise RuntimeError(f"[context] {tag}: eval_model exited {rc}")
            res = json.loads(buf.getvalue())["results"]
            if not all(np.isfinite(v[0]) for v in res.values()):
                raise RuntimeError(f"[context] {tag}: eval_model results not finite: {res}")
            coded = not ar and "--entropy-estimation" not in opts
            if coded:
                _require(got, ("rans_encode", "rans_decode_generic")
                         + (("rans_decode_sorted",) if folder == clic else ()), tag)
            if any(v for k, v in got.items() if not (coded and k in RANS)):
                raise RuntimeError(f"[context] {tag}: the path launched {got}")
            launches.append(got)
            log(f"[context] {tag}: eval_model.main {wall:.2f} s with the model build; bpp "
                f"{res['bpp'][0]:.6f}, encode {res['encoding_time'][0]:.4f} s, decode "
                f"{res['decoding_time'][0]:.4f} s (means over {len(os.listdir(folder))} "
                f"image(s)), mse {res['mse'][0]:.6g}, psnr {res['psnr'][0]:.4f}; launches "
                f"{got}  ({card})")
            if "--entropy-estimation" in opts:
                continue
            _, codec = load_model(arch, q, device=dev)
            x, _ = eval_model._pad(eval_model.read_input(Path(folder, "img0.npy"))[None], 64)
            rt = (zoo_roundtrip if ar else context_roundtrip)(codec, x, dev, tag, card)
            launches.append(rt["launches"])
            if folder == clic:  # the 192-channel group: passes 8 and 9
                for p in (8, 9):
                    s = rt["out"]["strings"][0][p]
                    n, K, esc, _, srt, safe, _ = parse_v2_header(s)
                    if not (K == 2048 and srt and safe):
                        raise RuntimeError(f"[context] CLIC ELIC pass {p}: K {K}, sorted {srt}, "
                                           f"safe {safe}; expected 2048 lanes sorted and "
                                           f"kernel-safe (K3)")
                    log(f"[context] CLIC ELIC pass {p} (192 channels, "
                        f"{'anchors' if p == 8 else 'non-anchors'}): {n} symbols of y padded to "
                        f"{x.shape[-2:]} on {K} lanes, sorted, kernel-safe, {esc} escapes, "
                        f"{len(s)} B: K3  ({card})")
            del codec
            torch.cuda.empty_cache()
    log(f"[context] phase {time.time() - t_phase:.1f} s  ({card})")
    return _sum_launches(*launches)


# --video: ScaleSpaceFlow at the tiny test widths card against CPU, then at
# the published widths through tools/video_eval.eval_clip on seeded clips
VIDEO_TINY = dict(num_levels=2, mid_planes=8, planes=8)
UVG = (3, 3, 1080, 1920)  # UVG's 1080p, 3 frames (T, C, H, W), padded to 1152 x 1920
VIMEO = (7, 3, 256, 448)  # a Vimeo-90k septuplet, padded to 256 x 512
VIDEO_TIMED = 2  # timed eval_clip runs a clip, after one warm-up


def _video_tweak(model, seed: int) -> None:
    """Latents of a few units and scales over the GC table on tiny seeded
    towers (as tests/test_torch_video_codec.py does), so the tiny codec
    codes more than zeros."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for enc in (model.img_encoder, model.res_encoder, model.motion_encoder):
            enc.l6.conv.weight.mul_(6.0)
        for hp in (model.img_hyperprior, model.res_hyperprior, model.motion_hyperprior):
            b = hp.hyper_decoder_scale.d3.conv.bias
            b.copy_(torch.rand(b.shape, generator=g).to(b) * 6.0)


def _video_streams(strings) -> list:
    """(label, which, y string, z string) of every coded latent of a clip,
    in coding order: the keyframe, then each inter frame's motion and
    residual."""
    out = [("f0 keyframe", "keyframe", strings[0][0], strings[0][1])]
    for t, s in enumerate(strings[1:], 1):
        out += [(f"f{t} {w}", w, s[w][0], s[w][1]) for w in ("motion", "residual")]
    return out


def video_card_vs_cpu(dev, card: str) -> dict:
    """ScaleSpaceFlow at the tiny widths of VIDEO_TINY (tweaked as the CPU
    tests tweak them), the same weights on the card and on the CPU, one
    3-frame 128 x 128 clip: every stream byte-identical, each side's
    streams decoding on the other, the frames within ZOO_XHAT_RTOL x
    max|ref|, K1 and K2 launched on the card."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models.video import ScaleSpaceFlow, ScaleSpaceFlowCodec

    cpu = ScaleSpaceFlow(**VIDEO_TINY, device="cpu").reset_parameters(SEED)
    _video_tweak(cpu, SEED)
    gpu = ScaleSpaceFlow(**VIDEO_TINY, device=dev)
    gpu.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()})
    a, b = ScaleSpaceFlowCodec(gpu), ScaleSpaceFlowCodec(cpu)
    clip = np.random.default_rng(SEED).random((3, 1, 3, 128, 128), np.float32)
    frames = [clip[i] for i in range(3)]
    a.compress(frames)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out, shapes = a.compress(frames)
    dec_gpu = a.decompress(out, shapes)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    ref, ref_shapes = b.compress(frames)
    if out != ref or shapes != ref_shapes:
        flips = [(label, u == v, zu == zv) for (label, _, u, zu), (_, _, v, zv)
                 in zip(_video_streams(out), _video_streams(ref))]
        raise RuntimeError(f"[video] card vs CPU: streams differ, (latent, y equal, z equal): "
                           f"{flips}")
    dec_cpu = b.decompress(out, shapes)  # the card's streams on the CPU
    dec_x = a.decompress(ref, ref_shapes)  # the CPU's streams on the card
    torch.cuda.synchronize()
    err = max((g.cpu() - c).abs().max().item() for g, c in zip(dec_gpu, dec_cpu))
    bound = ZOO_XHAT_RTOL * max(c.abs().max().item() for c in dec_cpu)
    if not err <= bound or not all(torch.equal(u, v) for u, v in zip(dec_gpu, dec_x)):
        raise RuntimeError(f"[video] card vs CPU: frames err {err} > {bound}, or the card's "
                           f"decode of the CPU's streams differs from its own")
    _require(launches, ("rans_encode", "rans_decode_generic"), "video card vs CPU")
    nbytes = [len(s) for _, _, y, z in _video_streams(out) for s in (y[0], z[0])]
    log(f"[video] card vs CPU, ScaleSpaceFlow {VIDEO_TINY} on (3, 1, 3, 128, 128): "
        f"{len(nbytes)} streams byte-identical ({sum(nbytes)} B), each side's streams decode on "
        f"the other, frames err {err:.3g} (bound {ZOO_XHAT_RTOL} x max|ref| = {bound:.3g}); "
        f"launches {launches}  ({card})")
    return launches


def video_roundtrip(codec, clip: np.ndarray, tag: str, card: str) -> dict:
    """One compress / decompress of a (T, C, H, W) clip (padded as
    video_eval pads it) with every stage synchronised (host ms a stage),
    the counters zeroed just before and read just after. Gates: the
    decoder's GC indexes equal the encoder's for every latent, every
    decoded symbol the encoder's, every decoded frame bitwise the encoder's
    reference frame, and the launches the streams' (K1 each, the decode
    kernel its header names, nothing else). Then hold_streams on every
    stream ([video kernels] lines) and the coder kernels' share of the
    roundtrip."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.coder.lane_coder import parse_v2_header
    from cra5_tpu_torch.tools import video_eval

    model = codec.model
    padded, _ = video_eval._pad_frames(clip)
    frames = [padded[i:i + 1] for i in range(padded.shape[0])]
    seen = {}
    spies = ((codec, "_indexes"), (codec, "_decode"), (codec, "_reference"),
             (model, "hp_symbols"), (model, "synthesize_keyframe"))
    for obj, name in spies:
        _record(obj, name, seen)
    codec.stage_times = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    strings, shapes = codec.compress(frames)
    t1 = time.perf_counter()
    dec = codec.decompress(strings, shapes)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts()
    stages, codec.stage_times = codec.stage_times, None
    for obj, name in spies:
        delattr(obj, name)

    outs = lambda name: [out for _, out in seen[name]]  # noqa: E731
    n = len(seen["hp_symbols"])
    idx = outs("_indexes")
    bad = [k for k in range(n) if not torch.equal(idx[k], idx[n + k])]
    if len(idx) != 2 * n or bad:
        raise RuntimeError(f"[video] {tag}: the decoder's GC indexes differ from the encoder's "
                           f"for latents {bad} of {n}")
    enc = [sym[k] for sym in outs("hp_symbols") for k in ("z_sym", "y_sym")]
    decs = outs("_decode")
    if len(decs) != len(enc) or not all(torch.equal(u, v) for u, v in zip(enc, decs)):
        raise RuntimeError(f"[video] {tag}: decoded symbols differ from the encoded ones")
    kf, refs = outs("synthesize_keyframe"), outs("_reference")
    T = len(frames)
    chain_enc, chain_dec = [kf[0], *refs[:T - 1]], [kf[1], *refs[T - 1:]]
    bad = [t for t in range(T) if not (torch.equal(chain_enc[t], chain_dec[t])
                                       and torch.equal(chain_dec[t], dec[t]))]
    if bad:
        raise RuntimeError(f"[video] {tag}: decoded frames {bad} differ from the encoder's "
                           f"reference frames")
    want = dict.fromkeys(RANS, 0)
    routes = []
    for label, which, ys, zs in _video_streams(strings):
        for part, s in (("y", ys[0]), ("z", zs[0])):
            _, K, esc, _, srt, safe, _ = parse_v2_header(s)
            k = "rans_decode_sorted" if srt and safe else "rans_decode_generic"
            for kernel in ("rans_encode", k, "container_write", "container_read"):
                want[kernel] += 1
            routes.append((f"{label} {part}", K, srt, safe, len(s), esc,
                           "K3" if k.endswith("sorted") else "K2"))
    got = {k: launches.get(k, 0) for k in RANS}
    if got != want or any(v for k, v in launches.items() if k not in RANS):
        raise RuntimeError(f"[video] {tag}: launches {launches}, expected {want}")

    streams = []
    for k, (label, which, ys, zs) in enumerate(_video_streams(strings)):
        sym = outs("hp_symbols")[k]
        coders = codec._coders[which]
        streams.append((f"{label} y", coders["gc"], sym["y_sym"][0], idx[k][0], ys[0]))
        streams.append((f"{label} z", coders["eb"], sym["z_sym"][0],
                        codec._channel_indexes(sym["z_sym"].shape)[0], zs[0]))
    held = hold_streams(streams, tag, card, "video kernels", iters=5)
    ms = {k: round(v * 1e3, 3) for k, v in stages.items()}
    kinds = {r: sum(x[-1] == r for x in routes) for r in ("K2", "K3")}
    log(f"[video] {tag}: synchronised roundtrip compress {t1 - t0:.4f} s, decompress "
        f"{t2 - t1:.4f} s; host ms a stage {ms}; {len(routes)} streams (decode kernels {kinds}); "
        f"launches {got}; indexes, symbols and the reference chain exact  ({card})")
    for name, K, srt, safe, nbytes, esc, kern in routes:
        if name.endswith(" y") and K >= 2048 and kern == "K2":
            log(f"[video] {tag}: {name} on {K} lanes, sorted {srt}, kernel-safe {safe}: "
                f"decodes on K2 because its sorted steps span more than two cdf rows  ({card})")
    summary = {}
    for kern in ("K1", "K2", "K3"):
        rows = ([(h["k1_us"], h["steps"]) for h in held.values()] if kern == "K1" else
                [(h["dec_us"], h["steps"]) for h in held.values() if h["dec"] == kern])
        rows = [(us, st) for us, st in rows if us == us]
        if rows:
            summary[kern] = (len(rows), sum(u for u, _ in rows), sum(u for u, _ in rows)
                             / sum(st for _, st in rows))
    coder_ms = sum(v[1] for v in summary.values()) / 1e3
    log(f"[video kernels] {tag}: " + "; ".join(
        f"{kern} {c} streams, {tot / c:.2f} us a stream, {per * 1e3:.1f} ns a step"
        for kern, (c, tot, per) in summary.items())
        + f"; the coder kernels {coder_ms:.4f} ms = {coder_ms / 10 / (t2 - t0):.3f}% of the "
        f"roundtrip ({t2 - t0:.4f} s)  ({card})")
    return dict(launches=launches, routes=routes, held=held, roundtrip_s=t2 - t0)


def phase_video(dev, card: str) -> dict:
    """ScaleSpaceFlow on the card: card against CPU at tiny widths; then
    zoo.ssf2020(1, "mse") at its published widths (planes 192, mid 128, 5
    levels, sigma0 1.5), seeded, float32 with TF32 off, through
    tools/video_eval.eval_clip on a seeded UVG-size 3-frame clip and a
    seeded Vimeo-90k-size 7-frame clip: one warm-up and VIDEO_TIMED timed
    runs each (bpp, PSNR, MS-SSIM, encode and decode s), the counters
    zeroed just before and read just after; then video_roundtrip on each
    clip, whose 1080p y streams (2048 lanes, sorted) must decode on K3 or
    print why not. Every run's launches join the kernels line's coder
    rows."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models import ssf2020
    from cra5_tpu_torch.tools import video_eval

    t_phase = time.time()
    launches = [video_card_vs_cpu(dev, card)]
    model, _, codec = ssf2020(1, "mse", device=dev, seed=SEED)
    log(f"[video] ssf2020(1, 'mse'): planes {model.planes}, mid {model.mid_planes}, "
        f"{model.num_levels} levels, sigma0 {model.sigma0}, "
        f"{sum(p.numel() for p in model.parameters())} params, float32  ({card})")
    rng = np.random.default_rng(SEED)
    for name, shape in (("UVG 1080p", UVG), ("Vimeo-90k", VIMEO)):
        clip = rng.random(shape, np.float32)
        video_eval.eval_clip(codec, clip)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        runs = [video_eval.eval_clip(codec, clip) for _ in range(VIDEO_TIMED)]
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        _require(got, ("rans_encode", "rans_decode_generic"), f"video {name}")
        launches.append(got)
        for r in runs:
            if not all(np.isfinite(v) for v in r.values()):
                raise RuntimeError(f"[video] {name}: eval_clip results not finite: {r}")
        pick = lambda k: ", ".join(f"{r[k]:.4f}" for r in runs)  # noqa: E731
        log(f"[video] {name} {shape}: eval_clip bpp {runs[0]['bpp']:.6f}, psnr-rgb "
            f"{runs[0]['psnr-rgb']:.4f}, ms-ssim-rgb {runs[0]['ms-ssim-rgb']:.6f}; encode s "
            f"{pick('encoding_time')}, decode s {pick('decoding_time')} ({VIDEO_TIMED} runs "
            f"after a warm-up); launches {got}  ({card})")
        rt = video_roundtrip(codec, clip, name, card)
        launches.append(rt["launches"])
        if name.startswith("UVG"):
            ys = [r for r in rt["routes"] if r[0].endswith(" y")]
            if not any(r[-1] == "K3" for r in ys):
                log(f"[video] UVG 1080p: no y stream decoded on K3: "
                    f"{[(r[0], r[1], r[2], r[3]) for r in ys]}  ({card})")
            else:
                _require(rt["launches"], ("rans_decode_sorted",), "video UVG 1080p")
        torch.cuda.empty_cache()
    del model, codec
    torch.cuda.empty_cache()
    log(f"[video] phase {time.time() - t_phase:.1f} s  ({card})")
    return _sum_launches(*launches)


# cra5_tpu_torch.examples' arguments: with --examples each at its defaults
# (the demo 400 steps saved at 200 on 6 fields); in the full run shorter.
EXAMPLES_ARGS = {"default": dict(demo=[], timing=[], profile=["--steps", "3"]),
                 "short": dict(demo=["--steps", "40", "--save-at", "20"], timing=["1"],
                               profile=["--steps", "2"])}
LEARN_STEPS = 10  # the short demo learns: its last 10 steps' mean total loss below its first 10's
TRAIN_STEP_LAUNCHES = {"flash_attention_forward": 14, "flash_attention_backward_dq": 7,
                       "flash_attention_backward_dkv": 7}  # a 268v remat step


def _with_containers(want: dict, reads=None) -> dict:
    """``want`` with the container kernels' launches beside the coder's:
    one K9 a stream K1 wrote, and one K10 a stream read (``reads``; by
    default one a decode, K2 + K3)."""
    want = dict(want)
    want["container_write"] = want.get("rans_encode", 0)
    want["container_read"] = (want.get("rans_decode_generic", 0)
                              + want.get("rans_decode_sorted", 0) if reads is None else reads)
    return want


def _launch_gate(tag: str, got: dict, want: dict, decodes: int = 0, sorted_y=None) -> None:
    """got equals want (every other counter 0), K2 and K3 together equal
    ``decodes`` and, where given, K3 equals ``sorted_y``; K9 equals K1's
    count in want, K10 ``decodes`` (``_with_containers``)."""
    dec = ("rans_decode_generic", "rans_decode_sorted")
    want = _with_containers(want, decodes)
    rest = {k: v for k, v in got.items() if k not in dec}
    n_dec = sum(got.get(k, 0) for k in dec)
    if (rest != {k: want.get(k, 0) for k in rest} or n_dec != decodes
            or sorted_y is not None and got.get("rans_decode_sorted", 0) != sorted_y):
        raise RuntimeError(f"[{tag}] launches {got}, expected {want} with {decodes} "
                           f"decodes (K2 + K3{'' if sorted_y is None else f', K3 {sorted_y}'})")


def phase_examples(dev, card: str, depth: str) -> dict:
    """cra5_tpu_torch.examples through their main() on the card, each with
    the counters zeroed just before and read just after (EXAMPLES_ARGS[depth]):
    train_demo_268 at 268v (bf16 remat, EMA; the full state saved and
    restored bitwise into a fresh Trainer, the resumed step repeated, the
    step-0, trained and EMA codecs on the held-out field with their decoded
    symbols equal to the encoder's), train_demo_report on its JSON,
    quickstart (268v float32, --no-plots), test_model --full,
    roundtrip_timing, train_268v_smoke and profile_268_train. Gates: every
    metric finite; the launches reckoned from the steps and roundtrips
    each ran; no profile variant in error; training learned: with the
    short depth the mean total loss of the last LEARN_STEPS steps below the
    first LEARN_STEPS', at the default depth the trained codec's held-out
    rate-distortion cost (lmbda mse + bpp_weight bpp, from its bytes and
    x_hat) below the step-0 codec's. Returns {"examples": bf16 launches,
    "examples_f32": float32 launches}."""
    import os
    import tempfile

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.examples import (profile_268_train, quickstart, roundtrip_timing,
                                         test_model, train_268v_smoke, train_demo_268,
                                         train_demo_report)
    from cra5_tpu_torch.models.vaeformer import vaeformer_268

    args = EXAMPLES_ARGS[depth]
    t_phase = time.time()

    def run(fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        got, sec = kernels.launch_counts(), time.time() - t0
        torch.cuda.empty_cache()
        return res, got, sec

    def finite(tag: str, values) -> None:
        values = list(values)
        if not all(np.isfinite(v) for v in values):
            raise RuntimeError(f"[examples] {tag}: values not all finite: {values}")

    def scaled(n: int) -> dict:
        return {k: v * n for k, v in TRAIN_STEP_LAUNCHES.items()}

    bf16, f32 = [], []
    with tempfile.TemporaryDirectory() as tmp:
        # the demo: steps + 1 training steps (the live step after the save is
        # taken twice) and three codec evals
        out = os.path.join(tmp, "demo.json")
        demo, got, sec = run(lambda: train_demo_268.main(
            args["demo"] + ["--ckpt-dir", os.path.join(tmp, "ckpt"), "--out", out]))
        cfg, resume = demo["config"], demo["resume"]
        evals = {k: demo[k] for k in ("codec_step0", "codec_trained", "codec_trained_ema")}
        n_steps = cfg["steps"] + 1
        want = scaled(n_steps)
        want.update(rans_encode=6, flash_attention_forward=want["flash_attention_forward"] + 21)
        _launch_gate("train_demo_268", got, want, decodes=6,
                     sorted_y=sum(e["y_decode_kernel"] == "K3" for e in evals.values()))
        bf16.append(got)
        finite("train_demo_268 losses", [v for m in demo["losses"].values() for v in m.values()])
        finite("train_demo_268 total loss", demo["total_loss"])
        finite("train_demo_268 evals", [v for e in evals.values() for k, v in e.items()
                                        if k != "y_decode_kernel"])
        if not (resume["checksums_match"] and resume["repeat_bitwise"]
                and resume["resumed_step"] == cfg["save_at"]):
            raise RuntimeError(f"[examples] train_demo_268 resume: {resume}")
        rd = {k: cfg["lmbda"] * e["mse"] + cfg["bpp_weight"] * e["bpp"] for k, e in evals.items()}
        first = statistics.mean(demo["total_loss"][:LEARN_STEPS])
        last = statistics.mean(demo["total_loss"][-LEARN_STEPS:])
        losses = {int(k): v for k, v in demo["losses"].items()}
        for step in sorted(losses):
            m = losses[step]
            log(f"[examples] demo step {step}: total {m['total_loss']:.6g} bpp "
                f"{m['bpp_loss']:.6g} mse {m['mse_loss']:.6g} aux {m['aux_loss']:.6g}  ({card})")
        for k, e in evals.items():
            log(f"[examples] demo {k}: {e['bin_bytes']} B, bpp {e['bpp']:.6f}, mse "
                f"{e['mse']:.6g}, rd {rd[k]:.6g}, {e['wall_s']:.3f} s, y on "
                f"{e['y_decode_kernel']} with {e['y_escape_share']:.4%} escapes; symbols exact  "
                f"({card})")
        t = demo["timing"]
        log(f"[examples] demo {cfg['steps']} steps saved at {cfg['save_at']} on {cfg['pool']} "
            f"fields: init {t['init_s']:.2f} s, median step {t['step_s_median']:.4f} s over "
            f"{t['steps_timed']} (host clock ending in a synchronize, the field made on the card "
            f"included); save {resume['save_s']:.2f} s ({resume['bytes']} B), restore "
            f"{resume['restore_s']:.2f} s, every tensor bitwise; step {cfg['save_at'] + 1} "
            f"repeated bitwise {resume['repeat_bitwise']}; total loss first "
            f"{LEARN_STEPS} mean {first:.6g}, last {LEARN_STEPS} {last:.6g}; demo {sec:.1f} s; "
            f"launches {got}  ({card})")
        if not last < first:
            raise RuntimeError(f"[examples] train_demo_268 did not learn: the mean total loss "
                               f"of its last {LEARN_STEPS} steps {last} is not below the first "
                               f"{LEARN_STEPS}' {first}")
        if depth == "default" and not rd["codec_trained"] < rd["codec_step0"]:
            raise RuntimeError(f"[examples] the trained codec's held-out rate-distortion cost "
                               f"{rd['codec_trained']} is not below the step-0 codec's "
                               f"{rd['codec_step0']}")
        md = os.path.join(tmp, "demo.md")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_demo_report.main([out, md])
        log(f"[examples] train_demo_report: {buf.getvalue().strip()}")

        qs, got, sec = run(lambda: quickstart.main(
            ["--no-plots", "--out", os.path.join(tmp, "quickstart")]))
        _launch_gate("quickstart", got, {"flash_attention_forward": 14, "rans_encode": 4},
                     decodes=4)
        c = vaeformer_268()
        if not (qs["x_hat_finite"] and qs["x_hat_shape"] == (c.in_chans, *c.img_size)):
            raise RuntimeError(f"[examples] quickstart: x_hat {qs['x_hat_shape']}, finite "
                               f"{qs['x_hat_finite']}")
        f32.append(got)
        log(f"[examples] quickstart 268v float32: .bin streams {qs['bin_bytes']} B, encode "
            f"{qs['encoding_time']:.3f} s, decode {qs['decoding_time']:.3f} s; {sec:.1f} s; "
            f"launches {got}  ({card})")

        tm, got, sec = run(lambda: test_model.main(["--full"]))
        _launch_gate("test_model", got, {"flash_attention_forward": 7, "rans_encode": 3},
                     decodes=3)
        if not tm["finite"]:
            raise RuntimeError(f"[examples] test_model: x_hat not finite: {tm}")
        f32.append(got)
        log(f"[examples] test_model --full: bmshj2018-factorized {tm['zoo_bytes']} B, "
            f"VAEformer(268v) float32 {tm['vaeformer_bytes']} B; {sec:.1f} s; launches {got}  "
            f"({card})")

        rt, got, sec = run(lambda: roundtrip_timing.main(
            args["timing"] + ["--out", os.path.join(tmp, "timing")]))
        n = len(rt["encode_s"])
        _launch_gate("roundtrip_timing", got, {"flash_attention_forward": 14 * n,
                                               "rans_encode": 4 * n}, decodes=4 * n)
        finite("roundtrip_timing", rt["encode_s"] + rt["decode_s"])
        f32.append(got)
        log(f"[examples] roundtrip_timing {n} iterations, 268v float32: encode "
            f"{rt['encode_mean_s']:.4f} s ± {rt['encode_pstdev_s']:.4f}, decode "
            f"{rt['decode_mean_s']:.4f} s ± {rt['decode_pstdev_s']:.4f} (each "
            f"{[round(v, 4) for v in rt['encode_s']]} / {[round(v, 4) for v in rt['decode_s']]}); "
            f"{sec:.1f} s; launches {got}  ({card})")

    sm, got, sec = run(lambda: train_268v_smoke.main([]))
    _launch_gate("train_268v_smoke", got, scaled(1 + train_268v_smoke.TIMED_STEPS))
    finite("train_268v_smoke", sm["metrics"].values())
    bf16.append(got)
    log(f"[examples] train_268v_smoke: init {sm['init_s']:.2f} s, warm-up step "
        f"{sm['warmup_step_s']:.2f} s, {sm['step_s']:.4f} s a step over "
        f"{train_268v_smoke.TIMED_STEPS}; {sec:.1f} s; launches {got}  ({card})")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (rc, got, sec) = run(lambda: profile_268_train.main(args["profile"]))
    prof = json.loads(buf.getvalue().splitlines()[-1])
    variants = {k: v for k, v in prof.items() if k.startswith("auto+")}
    if rc != 0 or len(variants) != 2 or any("error" in v for v in variants.values()):
        raise RuntimeError(f"[examples] profile_268_train: {prof}")
    steps = int(args["profile"][-1])
    _launch_gate("profile_268_train", got, scaled(2 * (1 + steps)))
    finite("profile_268_train", [v["loss"] for v in variants.values()])
    bf16.append(got)
    for k, v in variants.items():
        log(f"[examples] profile_268_train {k}: median step {v['step_s']:.4f} s "
            f"({[round(t, 4) for t in v['all_steps_s']]}), init {v['init_s']:.2f} s, warm-up "
            f"{v['warmup_s']:.2f} s  ({card})")
    log(f"[examples] profile_268_train: {prof['decision']} (speed-up "
        f"{prof['dots_remat_speedup']}); {sec:.1f} s; launches {got}  ({card})")
    log(f"[examples] phase {time.time() - t_phase:.1f} s  ({card})")
    return {"examples": _sum_launches(*bf16), "examples_f32": _sum_launches(*f32)}


# ------------------------------------------------------------- switches
# The flash mode and the sorted-lanes mode (nn/blocks.py::set_flash_attention,
# coder/rans_kernels.py::set_sorted_lanes) and the JAX towers' options at
# 268v. Gates of the three flash modes' roundtrips, each against "auto":
# the y symbols differ by at most one on at most SWITCH_Y_SHARE of the
# positions (the window and hyperprior attention rounds at other places in
# K4 than on the plain path, a bf16 ulp here and there), and the x_hat that
# each mode's g_s makes of "auto"'s decoded y lies within SWITCH_XHAT_RTOL x
# max |x_hat|. Each roundtrip's own x_hat is printed beside, not gated: a
# few y symbols moved by one move x_hat past that bound (on an H100 the
# 0.33-0.49% that "off" and "on" move put it at 3.8-4.6 x the bound).
SWITCH_Y_SHARE = 0.01
SWITCH_XHAT_RTOL = FLASH_OUT_RTOL
# K4 launches of one compress + decompress of the 268v codec by mode: "auto"
# the 7 global blocks; "on" every attention, g_a 13 (the dual heads
# included), h_a 4, h_s 4 in the compress and 4 in the decompress, g_s 12
SWITCH_K4 = {"auto": 7, "on": 37, "off": 0}
# K4, K5, K6 launches of one bf16 remat train step: under "on" the 25 g_a
# and g_s blocks forward and again in the recompute, the 8 hyperprior
# blocks once, and one backward each
SWITCH_STEP = {"auto": (14, 7, 7), "on": (58, 33, 33)}
# the train step's gradient under "on" against "auto": each parameter's
# max |g_on - g_auto| within SWITCH_NOISE_MULT times that parameter's own
# bf16 noise (max |g' - g_auto|, g' the same step with every weight moved
# by half a bf16 ulp, 2**-9 of itself, so that its bf16 rounding moves)
# plus 2**-8 x max |g_auto|
SWITCH_NOISE_MULT = 4.0
SWITCH_WINDOW = ((18, 16, 576, 64), (1, 5, 648, 72))  # K4-K6 shapes "on" adds at 268v
LINEAR_FINAL_SIZE = (720, 1440)  # the linear un-patchify's field: 72 x 144 patches of 10 x 10


@contextlib.contextmanager
def tally_into(tally):
    """Adds to ``tally`` (a Counter) the flash launches inside the block
    by (entry, dtype, head dim): ops/attention.py::_kernel_entry picks the
    entry before each launch. The wrappers' own counters stay the launch
    counts; this only splits them between the kernels line's rows."""
    from cra5_tpu_torch.ops import attention

    real = attention._kernel_entry

    def pick(name, *ts):
        tally[(name, str(ts[0].dtype)[6:], ts[0].shape[-1])] += 1
        return real(name, *ts)

    attention._kernel_entry = pick
    try:
        yield
    finally:
        attention._kernel_entry = real


def _tally_paths(tally) -> dict:
    """The switches phase's flash launches as kernels-line paths: bf16 at
    head dim 64 (the 268v width) and bf16 at 72 (the hyperprior's)."""
    counters = {"cra5_flash_attn_fwd": "flash_attention_forward",
                "cra5_flash_attn_bwd_dq": "flash_attention_backward_dq",
                "cra5_flash_attn_bwd_dkv": "flash_attention_backward_dkv"}
    paths = {"switches_d64": {}, "switches_d72": {}}
    for (name, dtype, D), n in tally.items():
        if dtype != "bfloat16" or D not in (64, 72):
            raise RuntimeError(f"switches: unexpected flash launches {name} {dtype} D={D}")
        path = paths[f"switches_d{D}"]
        path[counters[name]] = path.get(counters[name], 0) + n
    return paths


def switch_codec(dev, card: str, tally) -> dict:
    """(a) One compress and decompress of the seeded 268v bf16 codec
    (uncalibrated) under each flash mode, after a warm-up roundtrip: the
    towers' ms (CUDA events, 3 calls each after one), the roundtrip's peak
    and K4 launches; each decoder's symbols exactly its own encoder's;
    against "auto" the y symbols, x_hat, and x_hat of g_s on "auto"'s
    decoded y. Returns the roundtrips' launches, the model, codec, field
    and "auto"'s encoder output for (c)."""
    from cra5_tpu_torch import bench, kernels
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268
    from cra5_tpu_torch.nn import blocks

    cfg = vaeformer_268()
    model = VAEformer(cfg, dtype=torch.bfloat16, device=dev).reset_parameters(SEED)
    codec = VAEformerCodec(model)
    codec.update()
    x = np.random.default_rng(SEED).standard_normal((1, cfg.in_chans, *cfg.img_size), np.float32)
    xd = torch.from_numpy(x).to(dev)
    res, launches, fails = {}, [], []
    for mode in ("auto", "on", "off"):
        blocks.set_flash_attention(mode)
        out = codec.compress(x)  # warm-up
        codec.decompress(out["strings"], out["z_shape"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with tally_into(tally):
            out = codec.compress(x)
            x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        launches.append(got)
        with torch.inference_mode():
            enc = model.encode_symbols(xd)
            y_in = model.post_quant_conv(enc["y_sym"].to(enc["means"].dtype) + enc["means"])
            z_hat = enc["z_sym"].to(model.dtype) + model._medians()
            ms = {"g_a": timed_ms(lambda: model.g_a(xd), 3),
                  "h_a": timed_ms(lambda: model.h_a(enc["y"]), 3),
                  "h_s": timed_ms(lambda: model.h_s(z_hat), 3),
                  "g_s": timed_ms(lambda: model.g_s(y_in), 3)}
        z_dec, y_dec = bench.decode_symbols(codec, out["strings"], out["z_shape"])
        exact = torch.equal(z_dec, enc["z_sym"]) and torch.equal(y_dec, enc["y_sym"])
        want = dict.fromkeys(got, 0)
        want.update(_stream_kernels(out)[1], flash_attention_forward=SWITCH_K4[mode])
        if not exact or got != want or not torch.isfinite(x_hat).all():
            fails.append(f"{mode}: symbols exact {exact}, launches {got} (expected {want}), "
                         f"x_hat finite {bool(torch.isfinite(x_hat).all())}")
        res[mode] = dict(enc=enc, x_hat=x_hat, ms=ms, peak=peak, k4=got["flash_attention_forward"],
                         sec=sec, y_bytes=len(out["strings"][0][0]))
        with torch.inference_mode():  # g_s of "auto"'s decoded y under this mode
            res[mode]["g_s_on_auto_y"] = model.reconstruct_from_y_symbols(
                res["auto"]["enc"]["y_sym"], res["auto"]["enc"]["means"])
        log(f"[switches flash {mode}] roundtrip {sec:.4f} s (compress + decompress, host clock "
            f"ending in a synchronize), y {res[mode]['y_bytes']} B; towers "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
            + f"; peak {peak / 2**30:.2f} GiB; K4 launches {got['flash_attention_forward']} "
            f"(expected {SWITCH_K4[mode]}); decoded symbols exactly the encoder's {exact}  "
            f"({card})")
    blocks.set_flash_attention("auto")
    ref = res["auto"]
    bound = SWITCH_XHAT_RTOL * ref["x_hat"].float().abs().max().item()
    bound_same = SWITCH_XHAT_RTOL * ref["g_s_on_auto_y"].float().abs().max().item()
    for mode in ("on", "off"):
        dy = (res[mode]["enc"]["y_sym"] - ref["enc"]["y_sym"]).abs()
        dz = (res[mode]["enc"]["z_sym"] - ref["enc"]["z_sym"]).abs()
        share = (dy > 0).float().mean().item()
        err = (res[mode]["x_hat"].float() - ref["x_hat"].float()).abs().max().item()
        err_same = (res[mode]["g_s_on_auto_y"].float()
                    - ref["g_s_on_auto_y"].float()).abs().max().item()
        log(f"[switches flash {mode} vs auto] y symbols: {share:.4%} differ, by at most "
            f"{int(dy.max())} (gate: at most 1 on at most {SWITCH_Y_SHARE:.0%}); z symbols "
            f"{(dz > 0).float().mean().item():.4%} differ, by at most {int(dz.max())}; g_s on "
            f"auto's decoded y err {err_same:.4g} (bound {bound_same:.4g} = {SWITCH_XHAT_RTOL} x "
            f"max|x_hat|); the roundtrips' own x_hat err {err:.4g} ({err / bound:.3g} x the "
            f"bound, not gated)  ({card})")
        if int(dy.max()) > 1 or share > SWITCH_Y_SHARE or not err_same <= bound_same:
            fails.append(f"{mode} vs auto: y share {share}, max {int(dy.max())}; g_s on auto's "
                         f"y err {err_same} (bound {bound_same})")
    if fails:
        raise RuntimeError("[switches flash] " + "; ".join(fails))
    return dict(launches=_sum_launches(*launches), model=model, codec=codec, x=x,
                enc=ref["enc"])


class _GradRecorder:
    """Stands in for the optimizer of make_train_step: keeps the step's
    gradients and changes no parameter."""

    def update_(self, params, grads, opt_state, split=None, tp_group=None):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}


def switch_train(dev, card: str, tally) -> dict:
    """(a) The 268v bf16 remat train step under "on" beside "auto": each
    parameter's gradient of one step at the same weights and noise, held
    to "auto"'s within SWITCH_NOISE_MULT x its own bf16 noise + 2**-8 x
    max |g_auto|; then Trainer.fit under each mode, a warm-up and two
    timed steps with the counters zeroed just before and read just after:
    s a step, peak, launches, finite metrics."""
    import dataclasses

    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_268
    from cra5_tpu_torch.nn import blocks
    from cra5_tpu_torch.train import Trainer, TrainerConfig, TrainState, make_train_step

    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    model = VAEformer(cfg, dtype=torch.bfloat16, device=dev).reset_parameters(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fields = [torch.randn((1, cfg.in_chans, *cfg.img_size), generator=gen, device=dev) * 0.5
              for _ in range(3)]
    rec = _GradRecorder()
    step = make_train_step(model, rec, TrainerConfig())
    params = dict(model.named_parameters())

    def grads_of(mode):
        blocks.set_flash_attention(mode)
        _, m = step(TrainState(step=0, params=params, opt_state=None), fields[0], SEED)
        blocks.set_flash_attention("auto")
        if not all(bool(torch.isfinite(v)) for v in m.values()):
            raise RuntimeError(f"[switches train] {mode}: metrics not finite {m}")
        return rec.grads, {k: float(v) for k, v in m.items()}

    g_auto, m_auto = grads_of("auto")
    g_on, m_on = grads_of("on")
    with torch.no_grad():
        saved = {k: p.detach().clone() for k, p in params.items()}
        for p in params.values():  # half a bf16 ulp, so that roundings move
            p.mul_(1.0 + 2.0 ** -9)
    g_noise, _ = grads_of("auto")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved[k])
    del saved
    worst, fails = (None, 0.0, 0.0, 0.0), []
    for k, ref in g_auto.items():
        top = ref.float().abs().max().item()
        err = (g_on[k].float() - ref.float()).abs().max().item()
        noise = (g_noise[k].float() - ref.float()).abs().max().item()
        tol = SWITCH_NOISE_MULT * noise + 2.0 ** -8 * top
        if not err <= tol:
            fails.append((k, err, noise, top))
        ratio = err / tol if tol > 0 else (0.0 if err == 0 else float("inf"))
        if ratio >= worst[1]:
            worst = (k, ratio, err, noise)
    log(f"[switches train grads] 268v bf16 remat, one step at the same weights and noise: "
        f"loss auto {m_auto['loss']:.6g}, on {m_on['loss']:.6g}; {len(g_auto)} parameters' "
        f"gradients under on within {SWITCH_NOISE_MULT} x their bf16 noise + 2^-8 x max|g_auto| "
        f"of auto's: {len(g_auto) - len(fails)} of {len(g_auto)}; worst {worst[0]} at "
        f"{worst[1]:.3f} of its tolerance (err {worst[2]:.4g}, noise {worst[3]:.4g})  ({card})")
    if fails:
        raise RuntimeError(f"[switches train grads] {len(fails)} parameters past their "
                           f"tolerance, e.g. (name, err, noise, max) {fails[:5]}")
    del g_auto, g_on, g_noise, rec, step
    torch.cuda.empty_cache()

    res, launches = {}, []
    for mode in ("auto", "on"):
        blocks.set_flash_attention(mode)
        trainer = Trainer(model, TrainerConfig(log_every=1, ckpt_every=10**9), seed=SEED)
        state = trainer.fit(fields[:1], num_steps=1, log_fn=lambda *a: None)  # init + warm-up
        stamps, metrics = [], []

        def log_fn(i, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            metrics.append(m)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        stamps.append(time.perf_counter())
        with tally_into(tally):
            state = trainer.fit(fields[1:], state=state, num_steps=2, log_fn=log_fn)
        got = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        blocks.set_flash_attention("auto")
        launches.append(got)
        steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
        want = dict.fromkeys(got, 0)
        want.update(zip(("flash_attention_forward", "flash_attention_backward_dq",
                         "flash_attention_backward_dkv"), (2 * n for n in SWITCH_STEP[mode])))
        finite = all(np.isfinite(v) for m in metrics for v in m.values())
        log(f"[switches train {mode}] 268v bf16 remat: steps {[round(s, 4) for s in steps_s]} s "
            f"(host clock ending in a synchronize), peak {peak / 2**30:.2f} GiB, loss "
            f"{[round(float(m['loss']), 6) for m in metrics]}, launches {got}  ({card})")
        if got != want or not finite:
            raise RuntimeError(f"[switches train {mode}] launches {got}, expected {want}; "
                               f"finite {finite}")
        res[mode] = dict(step_s=statistics.median(steps_s), peak=peak)
        del trainer, state
        torch.cuda.empty_cache()
    del model, fields
    torch.cuda.empty_cache()
    return dict(launches=_sum_launches(*launches), **res)


def switch_kernel_rows(dev, card: str, shapes=SWITCH_WINDOW,
                       dtypes=(torch.bfloat16, torch.float32), where: str = "switches") -> dict:
    """(b) K4, K5 and K6 at the attention shapes that "on" adds at 268v
    (the window blocks' (18, 16, 576, 64) and the hyperprior's (1, 5, 648,
    72)), or ``shapes``, in ``dtypes``, each against its plain version to the
    kernels phase's bounds, two calls bitwise equal: event ms (20 calls
    after one), device us a call, the plain version's ms, SDPA's
    forward and backward (forward + backward less forward) and the bound
    (the larger of the tensor-core operations, float32 as three TF32
    products, and the bytes)."""
    from cra5_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_forward,
        flash_attention_plain,
    )

    rng = np.random.default_rng(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    tols = {torch.bfloat16: (FLASH_GRAD_RTOL, FLASH_LSE_ATOL),
            torch.float32: (FLASH_F32_RTOL, FLASH_F32_LSE_ATOL)}
    for B, H, N, D in shapes:
        for dtype in dtypes:
            rtol, lse_atol = tols[dtype]
            scale = D ** -0.5
            q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, D), np.float32))
                           .to(dev, dtype) for _ in range(4))
            fwd = lambda: flash_attention_forward(q, k, v, scale)
            out, lse = fwd()
            delta = (do.float() * out.float()).sum(-1)
            ops = (q, k, v, do, lse, delta, scale)
            dq = lambda: flash_attention_backward_dq(*ops)
            dkv = lambda: flash_attention_backward_dkv(*ops)
            got = {"out": out, "dq": dq()}
            got["dk"], got["dv"] = dkv()
            again = {"out": fwd()[0], "dq": dq()}
            again["dk"], again["dv"] = dkv()
            same = all(torch.equal(got[n], again[n]) for n in got)
            ref_out, ref_lse = flash_attention_plain(q, k, v, scale)
            refs = {"out": ref_out, "dq": flash_attention_backward_dq_plain(*ops)}
            refs["dk"], refs["dv"] = flash_attention_backward_dkv_plain(*ops)
            torch.cuda.synchronize()
            errs = {n: ((a.float() - refs[n].float()).abs().max().item(),
                        rtol * refs[n].float().abs().max().item()) for n, a in got.items()}
            lerr = (lse - ref_lse).abs().max().item()
            finite = all(bool(torch.isfinite(a).all()) for a in got.values())
            name = f"({B}, {H}, {N}, {D}) {str(dtype)[6:]}"
            if not finite or not same or lerr > lse_atol or any(e > b for e, b in errs.values()):
                raise RuntimeError(f"[{where} kernels] {name}: (err, bound) {errs}, lse err "
                                   f"{lerr}, finite {finite}, two calls bitwise equal {same}")
            del got, again, refs, ref_out, ref_lse
            ms = {"K4": timed_ms(fwd, 20), "K5": timed_ms(dq, 20), "K6": timed_ms(dkv, 20)}
            dev_us = {"K4": device_us(fwd), "K5": device_us(dq), "K6": device_us(dkv)}
            plain = {"K4": timed_ms(lambda: flash_attention_plain(q, k, v, scale), 1),
                     "K5": timed_ms(lambda: flash_attention_backward_dq_plain(*ops), 1),
                     "K6": timed_ms(lambda: flash_attention_backward_dkv_plain(*ops), 1)}
            qg, kg, vg = (a.detach().requires_grad_() for a in (q, k, v))
            lib_fwd = timed_ms(lambda: sdpa(qg, kg, vg, scale=scale), 20)
            lib_bwd = timed_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg, scale=scale),
                                                           (qg, kg, vg), do), 20) - lib_fwd
            lib = {"K4": lib_fwd, "K5": lib_bwd, "K6": lib_bwd}
            flops = {"K4": 4 * B * H * N * N * D, "K5": 6 * B * H * N * N * D,
                     "K6": 8 * B * H * N * N * D}
            io, stats = B * H * N * D * q.element_size(), B * H * N * 4
            nbytes = {"K4": 4 * io + stats, "K5": 5 * io + 2 * stats, "K6": 6 * io + 2 * stats}
            mult, peak = (3, TF32_FLOPS) if dtype == torch.float32 else (1, BF16_FLOPS)
            bounds, kinds = {}, {}
            for n, f in flops.items():
                ops_ms, bytes_ms = mult * f / peak * 1e3, bytes_bound_ms(nbytes[n])
                bounds[n] = max(ops_ms, bytes_ms)
                kinds[n] = "operations" if ops_ms >= bytes_ms else "bytes"
            log(f"[{where} kernels {name}] (err, bound {rtol} x max|ref|) "
                + ", ".join(f"{n} ({e:.3g}, {b:.3g})" for n, (e, b) in errs.items())
                + f", lse err {lerr:.3g} (atol {lse_atol}), two calls of each bitwise equal  "
                f"({card})")
            for n in ("K4", "K5", "K6"):
                log(f"[{where} {n} {name}] kernel {ms[n]:.4f} ms, device {dev_us[n]:.2f} us "
                    f"({bounds[n] / ms[n]:.1%} of the bound by events), plain {plain[n]:.4f} ms, "
                    f"sdpa {'forward' if n == 'K4' else 'backward'} {lib[n]:.4f} ms, bound "
                    f"{bounds[n]:.4f} ms ({kinds[n]})  ({card})")
            rows[name] = dict(ms=ms, device_us=dev_us, plain_ms=plain, library_ms=lib,
                              bound_ms=bounds)
            del q, k, v, do, out, lse, delta, ops, qg, kg, vg
            torch.cuda.empty_cache()
    return rows


def switch_sorted_lanes(codec, enc: dict, card: str) -> dict:
    """(c) The 268v y of one "auto" encode (2 654 208 symbols, 8192 lanes)
    written under the sorted-lanes mode "auto" (sorted, K3) and "off"
    (unsorted, K2), twice each, and decoded, the counters zeroed just
    before and read just after; then hold_streams on each (K1 and the
    decode kernel exact against their plain versions, the decode the
    encoder's symbols, device us). Gates: each container byte-identical
    across its two encodes, the headers' routes, symbols exact."""
    from cra5_tpu_torch import kernels
    from cra5_tpu_torch.coder import rans_kernels
    from cra5_tpu_torch.coder.lane_coder import default_num_lanes, parse_v2_header

    coder = codec._gc_coder
    idx = codec._gc_indexes(enc["scales"])
    sym = enc["y_sym"]
    strings, launches = {}, []
    for mode, route in (("auto", "K3"), ("off", "K2")):
        rans_kernels.set_sorted_lanes(mode)
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            a = coder.encode_from_device(sym[0], idx[0])
            b = coder.encode_from_device(sym[0], idx[0])
            dec = coder.decode_batch_to_device([a], idx)
            torch.cuda.synchronize()
            got = kernels.launch_counts()
        finally:
            rans_kernels.set_sorted_lanes("auto")
        launches.append(got)
        n, K, n_esc, _, srt, safe, _ = parse_v2_header(a)
        want = dict.fromkeys(got, 0)
        want.update(rans_encode=2, **{"rans_decode_sorted" if route == "K3"
                                      else "rans_decode_generic": 1})
        want = _with_containers(want)
        ok = (a == b and torch.equal(dec, sym) and got == want
              and (srt and safe) == (route == "K3") and K == default_num_lanes(n))
        log(f"[switches sorted {mode}] y {n} symbols on {K} lanes, sorted {srt}, kernel-safe "
            f"{safe}, {len(a)} B ({n_esc} escapes); two encodes byte-identical {a == b}; decoded "
            f"on {route}, symbols exact {torch.equal(dec, sym)}; launches {got}  ({card})")
        if not ok:
            raise RuntimeError(f"[switches sorted {mode}] expected {route} on the default lanes, "
                               f"launches {want}: got K={K} sorted {srt} safe {safe}, "
                               f"launches {got}, identical {a == b}")
        strings[mode] = a
    held = {}
    for mode in ("auto", "off"):
        rans_kernels.set_sorted_lanes(mode)
        try:
            held.update(hold_streams([(f"y {mode}", coder, sym[0], idx[0], strings[mode])],
                                     "268v", card, where="switches sorted kernels"))
        finally:
            rans_kernels.set_sorted_lanes("auto")
    log(f"[switches sorted] the same y: sorted {len(strings['auto'])} B, K3 device "
        f"{held['y auto']['dec_us'] / 1e3:.4f} ms; unsorted {len(strings['off'])} B, K2 device "
        f"{held['y off']['dec_us'] / 1e3:.4f} ms  ({card})")
    return dict(launches=_sum_launches(*launches), bytes={m: len(s) for m, s in strings.items()},
                held=held)


def switch_tower_options(dev, card: str, tally) -> dict:
    """(d) The JAX towers' options at 268v width, bf16, seeded, "auto":
    a codec roundtrip at 720 x 1440 with patch = stride = (10, 10) and the
    linear un-patchify (use_conv_transpose=False; decoded symbols exactly
    the encoder's, x_hat finite at 720 x 1440, launches K1 2, K2 1, K3 1,
    K4 7), and a ViTEncoder(window=False) forward at 721 x 1440 (13 global
    blocks of 10 368 tokens: 13 K4 launches, finite moments). The counters
    are zeroed just before each and read just after."""
    import dataclasses

    from cra5_tpu_torch import bench, kernels
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268
    from cra5_tpu_torch.nn.vit import ViTEncoder

    cfg = dataclasses.replace(vaeformer_268(), img_size=LINEAR_FINAL_SIZE, patch_size=(10, 10),
                              use_conv_transpose=False)
    model = VAEformer(cfg, dtype=torch.bfloat16, device=dev).reset_parameters(SEED)
    codec = VAEformerCodec(model)
    codec.update()
    x = np.random.default_rng(SEED).standard_normal((1, cfg.in_chans, *cfg.img_size), np.float32)
    out = codec.compress(x)  # warm-up
    codec.decompress(out["strings"], out["z_shape"])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with tally_into(tally):
        out = codec.compress(x)
        x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = kernels.launch_counts()
    with torch.inference_mode():
        enc = model.encode_symbols(torch.from_numpy(x).to(dev))
    z_dec, y_dec = bench.decode_symbols(codec, out["strings"], out["z_shape"])
    exact = torch.equal(z_dec, enc["z_sym"]) and torch.equal(y_dec, enc["y_sym"])
    want = dict.fromkeys(got, 0)
    want.update(_stream_kernels(out)[1], flash_attention_forward=SWITCH_K4["auto"])
    finite = (tuple(x_hat.shape) == (1, cfg.in_chans, *LINEAR_FINAL_SIZE)
              and bool(torch.isfinite(x_hat).all()))
    log(f"[switches linear_final] 268v bf16 at {LINEAR_FINAL_SIZE}, patch = stride = (10, 10), "
        f"use_conv_transpose=False: roundtrip {sec:.4f} s, y {len(out['strings'][0][0])} B, z "
        f"{len(out['strings'][1][0])} B; x_hat {tuple(x_hat.shape)} finite {finite}; symbols "
        f"exact {exact}; launches {got}  ({card})")
    if not (exact and finite and got == want):
        raise RuntimeError(f"[switches linear_final] launches {got} (expected {want}), "
                           f"exact {exact}, finite {finite}")
    paths = [got]
    del model, codec, x_hat, enc
    torch.cuda.empty_cache()

    base = vaeformer_268()
    enc_tower = ViTEncoder(base.img_size, base.patch_size, base.patch_stride, base.in_chans,
                           base.y_channels, base.depth, base.num_heads, base.window_sizes,
                           base.interval, window=False, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for m in enc_tower.modules():  # the flax initializers; Linears are their owners'
        if hasattr(m, "reset_parameters") and not isinstance(m, torch.nn.Linear):
            m.reset_parameters(gen)
    xd = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (1, base.in_chans, *base.img_size), np.float32)).to(dev)
    with torch.inference_mode():
        enc_tower(xd)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with tally_into(tally):
            moments = enc_tower(xd)
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        ms = timed_ms(lambda: enc_tower(xd), 3)
    want = dict.fromkeys(got, 0)
    want.update(flash_attention_forward=base.depth // 2 + 1)
    Hp, Wp = base.latent_grid
    finite = (tuple(moments.shape) == (1, 2 * base.y_channels, Hp, Wp)
              and bool(torch.isfinite(moments).all()))
    log(f"[switches window_false] ViTEncoder(window=False) at 268v bf16: {base.depth // 2 + 1} "
        f"global blocks of {Hp * Wp} tokens, {ms:.3f} ms a forward; moments "
        f"{tuple(moments.shape)} finite {finite}; launches {got}  ({card})")
    if not (finite and got == want):
        raise RuntimeError(f"[switches window_false] launches {got} (expected {want}), "
                           f"finite {finite}")
    paths.append(got)
    del enc_tower, xd, moments
    torch.cuda.empty_cache()
    return dict(launches=_sum_launches(*paths))


def phase_switches(dev, card: str) -> dict:
    """The flash and sorted-lanes modes and the towers' options at 268v
    ((a)-(d) above); both modes restored afterwards. Returns the paths'
    launches for the kernels line: the coder kernels' under
    "switches_codec", the flash kernels' split by head dim."""
    from collections import Counter

    from cra5_tpu_torch.coder import rans_kernels
    from cra5_tpu_torch.nn import blocks

    t_phase = time.time()
    saved = blocks.flash_attention_mode(), rans_kernels.sorted_lanes_mode()
    tally = Counter()
    try:
        a = switch_codec(dev, card, tally)
        c = switch_sorted_lanes(a["codec"], a["enc"], card)
        del a["model"], a["codec"], a["x"], a["enc"]
        torch.cuda.empty_cache()
        train = switch_train(dev, card, tally)
        switch_kernel_rows(dev, card)
        d = switch_tower_options(dev, card, tally)
    finally:
        blocks.set_flash_attention(saved[0])
        rans_kernels.set_sorted_lanes(saved[1])
    log(f"[switches] train step median auto {train['auto']['step_s']:.4f} s, peak "
        f"{train['auto']['peak'] / 2**30:.2f} GiB; on {train['on']['step_s']:.4f} s, peak "
        f"{train['on']['peak'] / 2**30:.2f} GiB  ({card})")
    log(f"[switches] phase {time.time() - t_phase:.1f} s  ({card})")
    coder_only = lambda launches: {k: v for k, v in launches.items() if k.startswith("rans_")}
    return {"switches_codec": coder_only(_sum_launches(a["launches"], c["launches"],
                                                       train["launches"], d["launches"])),
            **_tally_paths(tally)}


def main(args) -> int:
    if args not in ([], ["--coder"], ["--perm"], ["--dist"], ["--tp"], ["--zoo"], ["--serve"],
                    ["--variants"], ["--context"], ["--video"], ["--examples"], ["--switches"],
                    ["--configs"]):
        raise SystemExit("usage: python3 chip_smoke.py [--coder | --perm | --dist | --tp | "
                         "--zoo | --serve | --variants | --context | --video | --examples | "
                         f"--switches | --configs]; got {args}")
    device = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from cra5_tpu_torch.device import resolve_device

    resolve_device(dev)  # TF32 off
    phase_build()
    if args:
        import cra5_tpu_torch

        log(f"[{args[0][2:]}] cra5_tpu_torch from {cra5_tpu_torch.__path__[0]}")
        if args == ["--coder"]:
            coder_rows(dev, np.random.default_rng(SEED), floor=False)
        elif args == ["--dist"]:
            phase_dist(dev, CARD)
        elif args == ["--tp"]:
            phase_tp(dev, CARD)
        elif args == ["--zoo"]:
            phase_zoo(dev, CARD)
        elif args == ["--serve"]:
            phase_serve(dev, CARD)
        elif args == ["--variants"]:
            phase_variants(dev, CARD)
        elif args == ["--context"]:
            phase_context(dev, CARD)
        elif args == ["--video"]:
            phase_video(dev, CARD)
        elif args == ["--examples"]:
            phase_examples(dev, CARD, "default")
        elif args == ["--switches"]:
            phase_switches(dev, CARD)
        elif args == ["--configs"]:
            phase_configs(dev, CARD)
        else:
            perm_rows(np.random.default_rng(SEED), dev, extras=False)
        return 0
    t_start = time.time()
    lap = lambda name: log(f"[time] {name} done at {time.time() - t_start:.1f} s")
    # first, while this process holds nothing on the card: the float32
    # batch-2 step of its reckoning takes 69 GiB of the card's 79, and the
    # phases before the train CLI's old place leave ~11 GiB held here
    configs_launches = phase_configs(dev, CARD)
    lap("configs")
    torch.cuda.empty_cache()
    rows = phase_kernels(dev)
    lap("kernels")
    ref_launches = phase_reference(dev)
    lap("reference")
    hyper_launches = phase_hyper_width(dev)
    lap("hyper_width")
    main_res, codec, x = phase_main_path(dev)
    lap("main_path")
    phase_profile(codec, x)
    lap("profile")
    calib_res = phase_calibrate(codec, dev)
    lap("calibrate")
    calrt_res = phase_calibrated_roundtrip(codec, x, dev, main_res)
    lap("calibrated_roundtrip")
    bench_res = phase_bench(codec, dev, calib_res["calibration"])
    lap("bench")
    del codec, x
    torch.cuda.empty_cache()
    train_res = phase_train(dev)
    lap("train")
    torch.cuda.empty_cache()
    train_f32_res = phase_train(dev, torch.float32)
    lap("train_f32")
    torch.cuda.empty_cache()
    probe_launches = phase_probe(dev)
    lap("probe")
    api_launches = phase_api(dev)
    lap("api")
    torch.cuda.empty_cache()
    dist_launches = phase_dist(dev, CARD)
    lap("dist")
    torch.cuda.empty_cache()
    tp_launches = phase_tp(dev, CARD)
    lap("tp")
    torch.cuda.empty_cache()
    zoo_launches = phase_zoo(dev, CARD)
    lap("zoo")
    torch.cuda.empty_cache()
    serve_launches = phase_serve(dev, CARD)
    lap("serve")
    torch.cuda.empty_cache()
    variants_launches = phase_variants(dev, CARD)
    lap("variants")
    torch.cuda.empty_cache()
    context_launches = phase_context(dev, CARD)
    lap("context")
    torch.cuda.empty_cache()
    video_launches = phase_video(dev, CARD)
    lap("video")
    torch.cuda.empty_cache()
    examples_launches = phase_examples(dev, CARD, "short")
    lap("examples")
    torch.cuda.empty_cache()
    switches_launches = phase_switches(dev, CARD)
    lap("switches")

    # every launch of the paths' own runs: the codec roundtrip, the tiny
    # codec's decompress on the card, the three timed steps of each train
    # path, the published configs' CLI steps, recompression, serving and
    # roundtrip, the probe and the API's two .bin roundtrips. K2
    # (rans_decode_generic) replaces both decode_scan_pallas (:705) and
    # decode_rowplan_pallas (:368); its entry names the former.
    paths = {"codec": main_res["launches"], "tiny": ref_launches, "train": train_res["launches"],
             "train_f32": train_f32_res["launches"], "probe": probe_launches,
             "api": api_launches, "hyper_bf16": hyper_launches["bf16"],
             "hyper_f32": hyper_launches["f32"], "calibrate": calib_res["launches"],
             "calibrated": calrt_res["launches"], "bench": bench_res["launches"],
             **configs_launches, **dist_launches, **tp_launches,
             "zoo": zoo_launches,
             **serve_launches, **variants_launches, "context": context_launches,
             "video": video_launches, **examples_launches, **switches_launches}
    sources = {
        "rans_encode": ("rans_encode", "cra5_tpu_torch/csrc/rans_encode.cu",
                        "cra5_tpu/coder/rans_pallas.py:212"),
        "rans_decode_sorted": ("rans_decode_sorted", "cra5_tpu_torch/csrc/rans_decode.cu",
                               "cra5_tpu/coder/rans_pallas.py:569"),
        "rans_decode_generic": ("rans_decode_generic", "cra5_tpu_torch/csrc/rans_decode.cu",
                                "cra5_tpu/coder/rans_pallas.py:705"),
        "container_write": ("container_write", "cra5_tpu_torch/csrc/crx2_container.cu",
                            "none: the JAX package packs containers on the host"),
        "container_read": ("container_read", "cra5_tpu_torch/csrc/crx2_container.cu",
                           "none: the JAX package parses containers on the host"),
        "flash_attn_fwd": ("flash_attention_forward", "cra5_tpu_torch/csrc/flash_attn_fwd.cu",
                           "cra5_tpu/ops/attention.py:102"),
        "flash_attn_fwd_f32": ("flash_attention_forward", "cra5_tpu_torch/csrc/flash_attn_fwd.cu",
                               "cra5_tpu/ops/attention.py:102"),
        "flash_attn_bwd_dq": ("flash_attention_backward_dq",
                              "cra5_tpu_torch/csrc/flash_attn_bwd.cu",
                              "cra5_tpu/ops/attention.py:140"),
        "flash_attn_bwd_dkv": ("flash_attention_backward_dkv",
                               "cra5_tpu_torch/csrc/flash_attn_bwd.cu",
                               "cra5_tpu/ops/attention.py:189"),
        "flash_attn_bwd_dq_f32": ("flash_attention_backward_dq",
                                  "cra5_tpu_torch/csrc/flash_attn_bwd_f32.cu",
                                  "cra5_tpu/ops/attention.py:140"),
        "flash_attn_bwd_dkv_f32": ("flash_attention_backward_dkv",
                                   "cra5_tpu_torch/csrc/flash_attn_bwd_f32.cu",
                                   "cra5_tpu/ops/attention.py:189"),
        "flash_attn_fwd_anydim": ("flash_attention_forward",
                                  "cra5_tpu_torch/csrc/flash_attn_anydim.cu",
                                  "cra5_tpu/ops/attention.py:102"),
        "flash_attn_fwd_anydim_f32": ("flash_attention_forward",
                                      "cra5_tpu_torch/csrc/flash_attn_anydim_f32.cu",
                                      "cra5_tpu/ops/attention.py:102"),
        "flash_attn_bwd_dq_anydim": ("flash_attention_backward_dq",
                                     "cra5_tpu_torch/csrc/flash_attn_anydim.cu",
                                     "cra5_tpu/ops/attention.py:140"),
        "flash_attn_bwd_dq_anydim_f32": ("flash_attention_backward_dq",
                                         "cra5_tpu_torch/csrc/flash_attn_anydim_f32.cu",
                                         "cra5_tpu/ops/attention.py:140"),
        "flash_attn_bwd_dkv_anydim": ("flash_attention_backward_dkv",
                                      "cra5_tpu_torch/csrc/flash_attn_anydim.cu",
                                      "cra5_tpu/ops/attention.py:189"),
        "flash_attn_bwd_dkv_anydim_f32": ("flash_attention_backward_dkv",
                                          "cra5_tpu_torch/csrc/flash_attn_anydim_f32.cu",
                                          "cra5_tpu/ops/attention.py:189"),
        "perm_expand": ("expand", "cra5_tpu_torch/csrc/perm_probe.cu",
                        "profiling/_perm_probe.py:141"),
        "perm_dynroll": ("dynroll", "cra5_tpu_torch/csrc/perm_probe.cu",
                         "profiling/_perm_probe.py:160"),
    }
    # the flash kernels of every dtype and head dim share one wrapper and
    # counter each: the head-dim-64 float32 paths are the API's, serve's,
    # the float32 train step's, the published configs' (their two
    # trainings, the 159v recompression and serve) and the float32 examples' (quickstart,
    # test_model, roundtrip_timing), the head-dim-72 paths hyper_width's two
    # and the switches phase's bf16 hyperprior launches (its paths split by
    # head dim), every other path is bf16 at head dim 64 (vivt69, float32,
    # has no sequence long enough for a flash kernel: its coder launches only)
    bf16 = ("codec", "tiny", "train", "probe", "calibrate", "calibrated", "bench", "dp_train",
            "remat_dots", "tp_train", "tp_codec", "decode_profile", "variants_codec",
            "variants_vae", "variants_train", "finalize", "examples", "switches_d64",
            "configs_159_codec")
    only = {"flash_attn_fwd": bf16, "flash_attn_bwd_dq": bf16, "flash_attn_bwd_dkv": bf16,
            "flash_attn_fwd_f32": ("api", "train_f32", "configs_268", "configs_159",
                                   "configs_159_recompress", "configs_159_serve", "recompress",
                                   "serve", "examples_f32"),
            "flash_attn_bwd_dq_f32": ("train_f32", "configs_268", "configs_159"),
            "flash_attn_bwd_dkv_f32": ("train_f32", "configs_268", "configs_159")}
    only.update({f"{k}{t}": ("hyper_f32",) if t else ("hyper_bf16", "switches_d72")
                 for t in ("", "_f32") for k in
                 ("flash_attn_fwd_anydim", "flash_attn_bwd_dq_anydim",
                  "flash_attn_bwd_dkv_anydim")})
    kernels_line = []
    for name, (counter, src, replaces) in sources.items():
        launches = sum(paths[p].get(counter, 0) for p in only.get(name, paths))
        if launches == 0:
            raise RuntimeError(f"{name} was not launched on any path")
        kernels_line.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                                 launches=launches, **rows[name]))
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
