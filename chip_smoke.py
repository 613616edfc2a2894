#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device and build: the card's name and power limit, and the build of
   every CUDA kernel from ``gan_inpainting_torch/csrc`` with nvcc; the
   registers, spills and HGMMA (and, for the attention forwards', the
   patch backward's and the fused backward's wgmma kernels, UTMALDG)
   counts of the wgmma kernels,
   each required > 0 and the attention kernels' spills 0; the patch
   backward's clusters of 16 resident on the card;
2. kernels against their plain PyTorch versions on the card, at the
   256² serve shape (B=8, map 64×64×192) and the 512² shape (B=2, map
   128×128×192), in float32 and bfloat16, with times of the kernel, the
   plain version and one library call computing the same function; the
   fold (``gi_fold_taps``) at B 8 and B 64 on the 256² map and at the
   8×512² train map, float32 and bf16, its wrapper's and bare launch's
   time beside its byte bound, the plain version and ``F.fold``; and
   the fused attention backward's kernels (bf16: δ, score tiles, dQ and
   dK/dV tap products on wgmma; float32: the core kernels; the
   tap-gradient fold ``gi_fold_tap_grads``) and the forward's
   log-sum-exp at the train shapes (256²: B=16, map 64×64×192; 512²: B=8,
   map 128×128×192), with an all-hole sample, two runs and a chunked run
   bit-identical, each launch's time beside its bound, its plain version,
   SDPA's backward and the five products as torch.matmul, and the
   backward's split into prep, kernels and epilogue; and the two
   gated-conv kernels
   and the partial-conv epilogue kernel at full-width shapes of their
   paths, in float32 and bfloat16;
3. the serve path: the pinned ``tex256_attn`` generator under the
   ``serve_v4_8`` model config, full width, through ``Inpainter`` on the
   card — launch counts, known pixels bit-exact, a float32 card-vs-CPU
   check, the latency of one 1×256² request and img/s at 64×256²
   bfloat16;
4. the train path: ``places512_deepfill`` at full width (512², batch 8,
   bfloat16, synthetic textured data) for 4 steps from step 0 through
   ``create_state`` / ``make_train_step`` — metrics finite, launch
   counts, parameters moved, the attention branch's gradient, a
   checkpoint round trip, steps/s split by CUDA events; the 256²
   attention config (``celebahq256_freeform`` with attention, batch 16)
   on one fixed batch with ``g_l1`` falling; and one float32 step of a
   small config on the card against the same step on the CPU;
5. path A, the kernel conv path: the same pinned generator served with
   ``model.kernel_backend=pallas``, where every gated conv runs a
   hand-written CUDA kernel with its epilogue fused — launch counts per
   forward, known pixels bit-exact, float32 against the ``xla`` backend on
   the card and against the CPU, img/s at 64×256² for ``pallas``, ``xla``
   and ``auto``;
6. path B, the partial-conv family: ``partialconv256`` at full width from
   a seeded initialization, served through ``Inpainter`` and trained for 3
   steps (16×256², bfloat16, seeded random VGG) with the partial-conv
   epilogue kernel — launch counts, known pixels bit-exact, float32 card
   vs CPU, img/s and ms/step for ``pallas`` and ``xla``, and one float32
   step of a small partial config on the card against the CPU;
7. path C, large maps: the pinned generator served at a 2048² bucket (the
   attention map 512×512×192, L = 65 536 cells, past the measured
   fused-route threshold) through the patch-attention forward kernel; one
   ``places512_deepfill`` train step at 1×2048² bf16 from step 0 and one
   more, through the patch forward, dQ and dK/dV kernels — launch counts,
   known pixels bit-exact, metrics finite, parameters moved, the attention
   branch's gradient, ms per request and per step, peak memory; and the
   fused forward whose backward plan does not hold, its gradient through
   the patch kernels against the plain gradient;
8. the serving tier: the pinned generator under ``serve_v4_8``'s model
   config and its batch (1, 8, 16, 32, 64; its 256 cut, which no traffic
   of this phase reaches) and size (256, 512)
   buckets (full width, bf16) behind ``InpaintService``, once its
   dispatcher thread has warmed every bucket (``ready()``) — 16
   closed-loop clients, as ``tools/load_serve.py`` drives the service,
   with 128 requests of 256², 16 of 512² and 4 of 200×240 (known pixels
   bit-exact, hole pixels within ±2 of ``inpaint_batch`` of the same
   images on ≥ 99.9 %, fewer dispatches than requests, the fused
   attention and fold launched from the dispatcher thread at both
   buckets); img/s, p50/p99 and the mean batch at 256² from closed-loop
   windows of 16 and 64 clients, two of each, against ``inpaint_batch``
   at 64×256², in turns; the HTTP front (16 closed-loop clients, two
   windows, ``/healthz``); overload at ``max_queue=4``
   (``ServiceOverloadedError`` in process, 429 over HTTP);
   ``inpaint_dir`` over 8 PNGs against one ``inpaint_batch``, an
   ``export_generator`` → ``from_npz`` round trip, and ``evaluate`` with
   SWD;
9. file data and the run's record: a JPEG corpus written at run time
   (640 files of 640×480, quality 92, from one seed); the decoder used
   and decode rates at 512², batch 8 (native libjpeg and PIL, 2 and 4
   decoder threads; native against PIL within the JAX package's bound);
   ``train()`` of ``places512_deepfill`` at full width fed from the folder
   (6 steps, evals at 3 and 6 on 2 × 16 images, checkpoints; metrics.jsonl
   lines, the sample grid in TensorBoard where it imports, the fused
   attention, fold and fused backward launched); steps/s fed from the
   folder and from synthetic data in turns, with the share of a step's
   host time spent in ``next(data)``; ``make_dataset(start=6)`` against
   the uninterrupted stream; ``run_parity`` of every config on the card
   against the committed ``cuda`` pins, and ``evaluate`` of the three
   pinned artifacts beside their manifests' TPU-era figures; one step
   under ``interpret_kernels`` (no launch, metrics near the kernel
   step's) and one under ``debug_mode``;
10. path F, data parallelism: (a) ``torchrun --nproc-per-node 1 -m
   gan_inpainting_torch train --config places512_deepfill`` (one NCCL
   rank, 6 steps, an eval): the record (metrics.jsonl with the world size
   and 2 gradient all-reduces per step, a checkpoint, the sample grid) and
   steps/s beside the same train() without torchrun, in this process, in
   turns (torchrun, then alone); (b) two
   gloo ranks sharing cuda:0 (spawned workers calling the port with
   ``device="cuda:0"``): ``places512_deepfill`` at full width, global
   batch 8 (4 per rank), 2 steps on fixed batches in bf16 at 512² and in
   float32 at 256² with the ranks' whole state bit-identical after each
   step, the float32 steps against one process on the 8 images, then
   ``train()`` over both ranks (4 steps, an eval, a checkpoint; only rank
   0 writes) resumed to step 5, each rank's peak memory, steps/s and
   launches of rows 2–5b; (c) an
   ``Inpainter`` over two replicas on cuda:0 at 64×256² bf16 against one
   replica (known pixels bit-exact, holes within ±2 on ≥ 99.9 %), behind
   ``InpaintService``, img/s of one and two replicas in turns. One card
   cannot time NCCL across cards: no rate of this phase is one;
11. AOT serving artifacts (``io/aot.py``, ``torch.export``): the pinned
   generator under serve_v4_8's model config (bf16) exported at 1×256²,
   64×256² and 1×512² under ``auto`` and at 64×256² under ``pallas``,
   ``partialconv256`` (seeded) at 64×256² under ``pallas`` and the pinned
   generator at 1×2048² (the patch route), with seconds and bytes per
   program; each bucket through a fresh ``AotInpainter`` against the live
   ``Inpainter`` (known pixels bit-exact, hole pixels within ±2 on
   ≥ 99.9 %, the identical share printed) and the kernels launched per
   forward through each program equal to the live forward's (fused
   attention and fold, the gated convs under ``pallas``, the partial
   epilogue, the patch forward at 2048², each > 0); start-up (construction
   to the end of the warm-up of the three serve_v4_8 buckets), artifact
   and live, each in a fresh process; img/s at 64×256² (over ≥ 1.5 s) and
   the 1×256² latency (over 50 requests), artifact against live, in
   turns; ``InpaintService`` over an artifact (32 mixed 256²/512² requests
   from concurrent clients, fewer dispatches); a ``cpu`` artifact and a
   stale kernel build refused on the card;
12. the mesh's model axis (``train.mesh.model=2 model.tp_shard=true``):
   (a) ``places512_deepfill`` at full width, bf16, ``auto``, 2 steps over
   one model group of two gloo ranks sharing cuda:0 (global batch cut
   from 8 to 2: every gather goes through the host under gloo) — the
   ranks bit-identical after each step, losses and parameters against
   one process on the same batches within stated tolerances, step ms,
   channel gathers and their bytes per step, peak memory per rank (a
   check, not a rate of NCCL); the peak memory of one 8×512² step with
   and without ``model.remat_stages``; (b) the pinned generator under
   serve_v4_8's model config through ``Inpainter(devices=[cuda:0,
   cuda:0])`` at model=2 against one device at model=1, under ``auto``
   and ``pallas``, at 8×256² and 1×512² (known pixels bit-exact, hole
   pixels within ±2 on ≥ 99.9 %, launches per forward of rows 1–3 and
   6–7 equal to the group's plan, ms per batch of both in turns); (c)
   the gated-conv kernel at every slice form of (b)'s pallas forwards
   (F = 12 included) against its plain version, with its time, the plain
   version's, ``conv2d`` + bias and the bound;
13. path I, the mesh's spatial axis in serving
   (``train.mesh.spatial``): (a) the pinned generator under path C's
   buckets serves one 1×2048² request (bf16) over spatial groups of 2
   and 4 members sharing cuda:0 against the whole map on one device
   (known pixels bit-exact, hole pixels within ±2 on ≥ 99.9 %, one
   patch-attention forward per member at Lq = Lk / n and no fused
   attention, the row exchanges and their bytes, peak memory; ms per
   request of the whole map and the group of 2 in turns); (b) the patch-attention forward (row 9)
   at a member's shapes, B 1 Lq 32 768 Lk 65 536 and B 8 Lq 512 Lk 1024,
   against its plain version (over chunks of query rows), with its time,
   the plain version's, SDPA's and the bound; (c) serve_v4_8 at 8×256²
   and 1×512² over a spatial group of two against one device, under
   ``auto`` and ``pallas`` (bf16) and a float32 1×512² pair, with
   launches per forward of rows 1–3, 6–7 and 9 and ms per batch in
   turns;
14. path J, training and evaluating over the mesh's spatial axis: (a)
   path C's ``places512_deepfill`` 1×2048² bf16 run (the same seed, state
   and two batches, from step 0 with the lazy R1) over a spatial group of
   two gloo ranks sharing cuda:0, each on one row band, against path C's
   own figures (metrics and G parameters within stated tolerances, rows
   9–11 launched 2 / 1 / 1 times per step on every rank, ms per step, the
   exchanges and their bytes per step, peak memory per rank); (b) the
   patch dQ and dK/dV kernels (rows 10, 11) at a member's shapes, B 1 Lq
   32 768 Lk 65 536, against their plain versions over chunks of query
   rows, with their times, the plain backward's, SDPA's autograd
   backward and the bounds; (c) ``evaluate`` (float32, 256², two batches)
   over the group against one process;
15. the bench module and CLI command (``gan_inpainting_torch/bench.py``):
   (a) ``bench --config serve_v4_8 --mode infer`` (32×256²) and ``bench
   --mode train data.batch_size=32`` (``celeba128_center``) through
   ``cli.main`` in this process, each one JSON line with the JAX bench's
   keys and a finite, positive value; (b) ``bench_infer`` of
   ``serve_v4_8`` at 128×256², 10 batches, 2 warm passes (the infer256
   point of the top-level ``bench.py``): the fused attention and the fold
   launched once per forward, the body's known pixels bit-exact on a pool
   batch, img/s beside phase [3]'s device forward; (c) ``bench_train`` of
   ``places512_deepfill`` (8×512², 4 runs of 10 steps, each from step 0
   with its R1 pass): launches per step as phase [4]'s, steps/s beside
   [4]'s step without R1;
16. one JSON line of per-kernel numbers (with the service's under
   ``"service"``, phase 9's under ``"file_data"``, phase 10's under
   ``"data_parallel"``, phase 11's under ``"aot"``, phase 12's under
   ``"model_axis"``, phase 13's under ``"spatial_axis"``, phase 14's
   under ``"spatial_training"`` and phase 15's under ``"bench"``), then
   the result line.

Phase 2 also holds the three patch-attention kernels (forward, dQ, dK/dV)
against their plain versions at the full widths (d 1728, dv 3072) at L
16 384 and, over chunks of query rows, L 65 536 (bfloat16 only), at an
odd shape and through contextual attention with f ≠ b, in float32 and
bfloat16, each with a sample that has no valid key; the bf16 forward (and its lse) and
the bf16 dQ and dK/dV at ragged L 1000 and 4097, d 200, dv 300; and times
the fused and the patch route where both hold. The fused forward's lse is held against the plain
one (1e-3) at the 256² and 512² shapes.

Float32 checks turn TF32 off for cuDNN convs and matmuls. Imports nothing
of JAX. Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np

NPZ = "docs/artifacts/tex256_attn/generator_best.npz"
SERVE_OVERRIDES = ["model.fuse_upsample=true",
                   "infer.size_buckets=256,512",
                   "infer.batch_buckets=1,8,64"]
# phase 8 serves under serve_v4_8's own batch and size buckets, all but
# the batch of 256: at most 64 clients are in flight, so no dispatch
# reaches it, and its warm-up (cuDNN's search at 256×512²) was cut to keep
# the script inside its time limit
SERVE_V4_8 = SERVE_OVERRIDES[:2] + ["infer.batch_buckets=1,8,16,32,64"]
SERVICE_WINDOW_S = 3.0        # each closed-loop window of phase 8's rates
H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, SXM, 700 W
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # HBM3
F32_TOL = 1e-3                # kernel vs plain, both float32 (see below)
BF16_TOL_FRAC = 2.0 ** -7     # of max|input|: weights and outputs in bf16
# backward kernels, as a fraction of the largest entry of the reference:
# float32 sums of up to L·C products in another order; bf16 p and dsr
BWD_F32_TOL_FRAC = 2e-4
BWD_BF16_TOL_FRAC = 2.0 ** -6
# the tap-gradient fold against the eager epilogue, float32, as a fraction
# of the largest entry: the same float32 terms in the same order per pixel
# (bf16: BF16_TOL_FRAC, the output rounded once)
FOLD_GRAD_F32_TOL_FRAC = 1e-5
# gated-conv and partial-epilogue kernels against their plain versions, as a
# fraction of the largest reference entry: float32 sums of up to 1728
# products in another order; bf16 outputs rounded to bf16
CONV_F32_TOL_FRAC = 2e-4
CONV_BF16_TOL_FRAC = 2.0 ** -7
# patch-attention kernels against their plain versions, float32: as a
# fraction of the largest reference entry (sums of up to L·d products in
# another order); bf16 uses BF16_TOL_FRAC (forward) and BWD_BF16_TOL_FRAC
PATCH_F32_TOL_FRAC = 2e-4
# served uint8 outputs of the bf16 kernel path against the bf16 library
# path: hole pixels within this many levels, on at least this fraction
BF16_SERVE_LEVELS, BF16_SERVE_FRAC = 2, 0.999
# launches per forward of serve_v4_8 under kernel_backend=pallas: gated
# convs at stride 1 / stride 2, with the fused decoder (256² buckets) and
# without it (512²); partial convs per forward of partialconv256
DIRECT_FUSED, DIRECT_UNFUSED, MATMUL_PER_FWD, PARTIAL_PER_FWD = 29, 33, 6, 16
# the mma.sync dQ and dK/dV kernels that the wgmma backward replaced, bf16,
# B2 L16384 / B1 L65536, d1728 dv3072 (gan_inpainting_torch/tools/
# bench_attention.py at the commit before the replacement, NVIDIA H100 80GB
# HBM3, 700.00 W), printed beside this run's times
PATCH_BWD_REPLACED_MS = {"dq": (137.66, 1083.23), "dkv": (183.95, 1454.20)}
TRAIN_512 = ["data.synthetic_family=textured"]
TRAIN_256 = ["model.use_attention=true", "data.synthetic_family=textured"]
# a JPEG corpus as users hand the folder loader: 640 photos of 640×480 at
# JPEG quality 92 (608 train, 32 eval files), from one seed
CORPUS_FILES, CORPUS_W, CORPUS_H, CORPUS_QUALITY = 640, 640, 480, 92
# decode rates: images per measurement, batch 8 at 512²
DECODE_BATCHES = 32
# steps per timed train() run in phase 9's turns, logged every 4: the
# windows [4, 8) and [8, 12) carry no R1 pass and no warm-up
TURN_STEPS, TURN_LOG = 12, 4
# the step under interpret_kernels against the kernel step, per metric:
# |a − b| ≤ this · max(|b|, 1e-2) (bf16 mirrors round p and ds where the
# kernels do, but add float32 terms in another order)
INTERPRET_STEP_TOL = 2e-2
# the fused attention and fold launches (rows 2, 3), the fused backward's
# four (rows 4, 5) and the tap-gradient fold (5b): the 512² train path's
FILE_PATH_KERNELS = (
    "contextual_attention_fused", "fold_taps",
    "contextual_attention_bwd_delta", "contextual_attention_bwd_scores",
    "contextual_attention_bwd_dq", "contextual_attention_bwd_dkv",
    "contextual_attention_bwd_fold")
ARTIFACTS = ("tex256_attn", "qual256_stab", "qual512")


def _smooth_images(rng, b, h, w):
    """Natural-ish uint8 images: low-frequency colour fields + stripes."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = np.empty((b, h, w, 3), np.uint8)
    for i in range(b):
        fy, fx, ph = rng.uniform(0.01, 0.08, 2).tolist() + [rng.uniform(0, 6)]
        base = np.stack([np.sin(fy * yy + ph + k) * np.cos(fx * xx - k)
                         for k in range(3)], -1)
        stripes = 0.3 * np.sign(np.sin(0.4 * (xx + yy) + ph))[..., None]
        out[i] = np.clip(127.5 * (1 + 0.7 * base + stripes), 0, 255)
    return out


def _stroke_masks(rng, b, h, w):
    """Free-form-like brush strokes (thick polylines), 1 = hole."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    masks = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for _ in range(rng.integers(2, 6)):
            y, x = rng.uniform(0, h), rng.uniform(0, w)
            width = rng.uniform(0.03, 0.09) * min(h, w)
            for _ in range(rng.integers(3, 7)):
                ang = rng.uniform(0, 2 * np.pi)
                step = rng.uniform(0.05, 0.2) * min(h, w)
                y2, x2 = y + step * np.sin(ang), x + step * np.cos(ang)
                for t in np.linspace(0, 1, 12):
                    cy, cx = y + t * (y2 - y), x + t * (x2 - x)
                    masks[i][(yy - cy) ** 2 + (xx - cx) ** 2
                             < (width / 2) ** 2] = 1.0
                y, x = y2, x2
    return masks


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def _time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _im2col_rows(x, k, stride, dil):
    """(B, H, W, C) → (1, 1, B·Ho·Wo, k²·C) TF-SAME im2col rows, taps
    outermost: the Pallas kernel's operand, timed as a yardstick against
    the strided route of the gated-conv kernel."""
    import torch.nn.functional as F

    from gan_inpainting_torch.ops.patches import same_pads

    _, h, w, _ = x.shape
    eff = (k - 1) * dil + 1
    ph, pw = same_pads(h, eff, stride), same_pads(w, eff, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    b, _, _, c = xp.shape
    sb, sh, sw, sc = xp.stride()
    ho, wo = -(-h // stride), -(-w // stride)
    taps = xp.as_strided((b, ho, wo, k, k, c), (
        sb, sh * stride, sw * stride, sh * dil, sw * dil, sc))
    return taps.reshape(1, 1, b * ho * wo, k * k * c)


def check_kernels(torch, shape_name, bsz, hw, c, rng, smi):
    """Phase 2 at one shape: both kernels against their plain versions."""
    import torch.nn.functional as F

    from gan_inpainting_torch.ops.contextual_attention import (
        _attention_inputs,
        downscale_mask_max,
    )
    from gan_inpainting_torch.ops.kernels.fold import (
        fold_taps,
        fold_taps_plain,
    )
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        _launch,
        _prepare,
        fused_attention_taps,
        fused_attention_taps_plain,
        plan,
    )

    from gan_inpainting_torch.ops import dispatch

    dispatch.reset_launches()
    dev = torch.device("cuda")
    rate, scale = 2, 10.0
    hs = ws = hw // rate
    lk = hs * ws
    # post-ReLU features, as the attention encoder's last layer emits
    x32 = torch.relu(torch.from_numpy(
        rng.standard_normal((bsz, hw, hw, c)).astype(np.float32))).to(dev)
    masks = _stroke_masks(rng, bsz, 4 * hw, 4 * hw)
    masks[0] = 0.0                       # no hole
    if bsz > 2:
        masks[1] = 1.0                   # all hole
    hole = downscale_mask_max(
        torch.from_numpy(masks[..., None]).to(dev), 4)  # generator's ×4 max

    out = {}
    # float32: kernel against the plain version, TF32 off
    k32 = fused_attention_taps(x32, hole)
    p32 = fused_attention_taps_plain(x32, hole)
    err32 = (k32 - p32).abs().max().item()
    if bsz > 2:
        _require(k32[1].abs().max().item() == 0.0, "all-hole sample not 0")
    f32_fold = (fold_taps(p32, hs, ws, rate)
                - fold_taps_plain(p32, hs, ws, rate)).abs().max().item()
    # bfloat16: kernel on bf16 inputs against the plain version in float32
    # on the same (bf16-valued) inputs — the plain version's own bf16 path
    # rounds the normalized keys, which moves scores at scale 10 by more
    # than the kernel's error
    xb = x32.to(torch.bfloat16)
    kb = fused_attention_taps(xb, hole)
    pb_ref = fused_attention_taps_plain(xb.float(), hole)
    errb = (kb.float() - pb_ref).abs().max().item()
    tolb = BF16_TOL_FRAC * xb.float().abs().max().item()
    # the forward's lse (training asks for it) against the plain one
    _, lse_k = fused_attention_taps(xb, hole, want_lse=True)
    _, lse_p = fused_attention_taps_plain(xb.float(), hole, want_lse=True)
    err_lse = (lse_k - lse_p).abs().max().item()
    _require(err_lse <= 1e-3, f"fused lse off by {err_lse:.3e} at "
                              f"{shape_name}")
    if bsz > 2:
        _require(kb[1].abs().max().item() == 0.0
                 and lse_k[1].abs().max().item() == 0.0,
                 "bf16 all-hole sample: taps or lse not 0")
    taps_b = pb_ref.to(torch.bfloat16)
    fold_k = fold_taps(taps_b, hs, ws, rate)
    fold_p = fold_taps_plain(taps_b.float(), hs, ws, rate)
    errb_fold = (fold_k.float() - fold_p).abs().max().item()
    tolb_fold = BF16_TOL_FRAC * taps_b.float().abs().max().item()
    torch.cuda.synchronize()
    print(f"[2] {shape_name} attention max_abs_err f32 {err32:.3e} "
          f"(tol {F32_TOL:g}) bf16 {errb:.3e} (tol {tolb:.3e}), lse "
          f"{err_lse:.3e} (tol 1e-3); "
          f"fold f32 {f32_fold:.3e} bf16 {errb_fold:.3e} "
          f"(tol {tolb_fold:.3e})")
    _require(err32 <= F32_TOL and errb <= tolb and f32_fold <= 1e-5
             and errb_fold <= tolb_fold,
             f"a kernel disagrees with its plain version at {shape_name}")

    # ---- times at the serve dtype (bf16) ---------------------------------
    reps = 20 if bsz > 2 else 10
    attn_ms = _time_ms(torch, lambda: fused_attention_taps(xb, hole), reps)
    maps, bias, rnorm, _ = _prepare(xb, hole, 3, rate)
    variant, group, cluster = plan(hs, ws, c, torch.bfloat16)
    kernel_only_ms = _time_ms(
        torch, lambda: _launch(maps, bias, rnorm, hs, ws, rate, scale), reps)
    # the CUDA-core variant on the same bf16 inputs (float32 runs it)
    core = _launch(maps, bias, rnorm, hs, ws, rate, scale, variant="core")
    err_core = (core.float() - pb_ref).abs().max().item()
    _require(err_core <= tolb, f"core variant disagrees at {shape_name}")
    core_ms = _time_ms(torch, lambda: _launch(
        maps, bias, rnorm, hs, ws, rate, scale, variant="core"),
        max(reps // 4, 3))
    attn_plain_ms = _time_ms(
        torch, lambda: fused_attention_taps_plain(xb, hole), max(reps // 4, 3))
    # library yardstick (never called by the port): SDPA over materialized
    # patch Q/K/V with a boolean key mask
    q, k, valid, v, _ = _attention_inputs(xb, xb, hole, 3, rate)
    sdpa_mask = valid[:, None, None, :]
    attn_lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None], attn_mask=sdpa_mask,
        scale=scale), max(reps // 4, 3))
    attn_bytes = (xb.numel() * 2 + hole.numel() * 4
                  + bsz * 16 * lk * c * 2)
    # products over the (query, valid key) pairs of this batch: a hole key's
    # weight is 0, so the function needs none of its products
    attn_ops = 2.0 * lk * int(valid.sum().item()) * (9 + 16) * c
    attn_bound, attn_by = _bound_ms(attn_bytes, attn_ops, H100_BF16_FLOPS)

    print(f"[2] {shape_name} bf16 ms: attention {attn_ms:.3f} ({variant} "
          f"G={group} cluster={cluster} kernel only {kernel_only_ms:.3f} = "
          f"{attn_ops / kernel_only_ms / 1e9:.1f} TFLOP/s of valid pairs, "
          f"core variant {core_ms:.3f} "
          f"err {err_core:.3e}, plain {attn_plain_ms:.3f}, sdpa "
          f"{attn_lib_ms:.3f}, bound {attn_bound:.4f} by {attn_by}) | {smi}")
    print(f"[2] {shape_name} launches in these checks and timings "
          f"(not counted for the serve path): {dict(dispatch.launches)}")
    out["attention"] = dict(
        ms=attn_ms, variant=variant, group=group, cluster=cluster,
        kernel_only_ms=kernel_only_ms,
        core_variant_ms=core_ms, core_variant_max_abs_err=err_core,
        plain_ms=attn_plain_ms,
        library_ms=attn_lib_ms, bound_ms=attn_bound, bound_by=attn_by,
        tflops=attn_ops / kernel_only_ms / 1e9, max_abs_err=errb,
        max_abs_err_f32=err32, lse_max_abs_err=err_lse)
    return out


FOLD_SHAPES = (("256² serve (B=8, 64x64x192)", "b8_256", 8, 64),
               ("64x256² serve (B=64, 64x64x192)", "b64_256", 64, 64),
               ("8x512² train (B=8, 128x128x192)", "b8_512train", 8, 128))


def check_fold(torch, rng, smi):
    """Phase 2, the forward's fold (``gi_fold_taps``) at the serve and
    train shapes: float32 and bf16 against ``fold_taps_plain``, and the
    wrapper's time, the bare C call's (CUDA events around back-to-back
    launches alone), the plain version's and ``F.fold``'s beside the byte
    bound."""
    import torch.nn.functional as F

    from gan_inpainting_torch.ops.kernels.fold import (
        fold_taps,
        fold_taps_plain,
        fold_vector,
        library,
    )

    dev = torch.device("cuda")
    rate = 2
    res = {}
    for shape_name, key, bsz, hw in FOLD_SHAPES:
        hs = ws = hw // rate
        lk, c = hs * ws, 192
        t32 = torch.from_numpy(rng.standard_normal(
            (bsz, 4 * rate * rate, lk, c)).astype(np.float32)).to(dev)
        err32 = (fold_taps(t32, hs, ws, rate)
                 - fold_taps_plain(t32, hs, ws, rate)).abs().max().item()
        del t32
        taps = torch.from_numpy(rng.standard_normal(
            (bsz, 4 * rate * rate, lk, c)).astype(np.float32)).to(
            dev, torch.bfloat16)
        got = fold_taps(taps, hs, ws, rate)
        errb = (got.float() - fold_taps_plain(taps.float(), hs, ws, rate)) \
            .abs().max().item()
        tolb = BF16_TOL_FRAC * 4 * taps.float().abs().max().item()
        torch.cuda.synchronize()
        _require(err32 <= 1e-5 and errb <= tolb,
                 f"fold disagrees with its plain version at {shape_name}: "
                 f"f32 {err32:.3e}, bf16 {errb:.3e} (tol {tolb:.3e})")
        reps = 50 if bsz <= 8 else 20
        ms = _time_ms(torch, lambda: fold_taps(taps, hs, ws, rate), reps)
        lib = library()
        out = torch.empty_like(got)
        vec = fold_vector(c, taps.dtype, taps.data_ptr(), out.data_ptr())
        args = (taps.data_ptr(), out.data_ptr(), bsz, hs, ws, c, rate, 1,
                vec, torch.cuda.current_stream().cuda_stream)
        _require(lib.gi_fold_taps(*args) == 0, "gi_fold_taps refused")
        kernel_ms = _time_ms(torch, lambda: lib.gi_fold_taps(*args), reps)
        _require(torch.equal(out, got), "bare fold call differs")
        plain_ms = _time_ms(
            torch, lambda: fold_taps_plain(taps, hs, ws, rate), 5)
        cols = taps.reshape(bsz, 4, 4, lk, c).permute(0, 4, 1, 2, 3) \
            .reshape(bsz, c * 16, lk).contiguous()
        lib_ms = _time_ms(torch, lambda: F.fold(
            cols, (hw, hw), 4, padding=1, stride=2), 5)
        del cols
        # each tap read once, each output written once (bf16); 4 adds and
        # a multiply per output element
        bound, by = _bound_ms(taps.numel() * 2 + got.numel() * 2,
                              got.numel() * 5.0, H100_BF16_FLOPS)
        print(f"[2] fold {shape_name} bf16 ms: wrapper {ms:.4f}, kernel "
              f"{kernel_ms:.4f} ({vec * 2}-byte vectors; "
              f"{100 * bound / kernel_ms:.1f} % of the bound), plain "
              f"{plain_ms:.4f}, F.fold {lib_ms:.4f}, bound {bound:.4f} by "
              f"{by}; max_abs_err f32 {err32:.3e} (tol 1e-5) bf16 "
              f"{errb:.3e} (tol {tolb:.3e}) | {smi}")
        res[key] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bound, bound_by=by,
                        max_abs_err=errb, max_abs_err_f32=err32)
        del taps, got, out
    return res


def check_backward(torch, shape_name, bsz, hw, c, rng, smi):
    """Phase 2, backward: the fused backward's kernels (bf16: δ, score
    tiles, dQ and dK/dV tap products on wgmma; float32: the core kernels)
    and the forward's lse against their plain versions at one train
    shape, with an all-hole sample, repeat runs and chunked runs."""
    import torch.nn.functional as F

    from gan_inpainting_torch.ops.contextual_attention import (
        _attention_inputs,
        downscale_mask_max,
    )
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        fused_attention_taps,
        fused_attention_taps_plain,
    )
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        TILE,
        _tap,
        contextual_attention_bwd,
        contextual_attention_bwd_plain,
        fold_tap_grads,
        fold_tap_grads_plain,
        launch_delta,
        launch_dkv,
        launch_dq,
        launch_scores,
        plan_bwd,
        prepare_bwd,
        scratch_bytes_per_sample,
        tap_grads,
        tap_grads_mirror,
        v_tap_geometry,
    )

    dev = torch.device("cuda")
    rate, scale = 2, 10.0
    hs = ws = hw // rate
    lk = hs * ws
    x32 = torch.relu(torch.from_numpy(
        rng.standard_normal((bsz, hw, hw, c)).astype(np.float32))).to(dev)
    g32 = torch.from_numpy(
        rng.standard_normal((bsz, hw, hw, c)).astype(np.float32)).to(dev)
    masks = _stroke_masks(rng, bsz, 4 * hw, 4 * hw)
    masks[0] = 0.0                       # no hole
    masks[1] = 1.0                       # all hole
    hole = downscale_mask_max(
        torch.from_numpy(masks[..., None]).to(dev), 4)

    def worst(got, want):
        """max abs error and its tolerance base over a kernel's outputs"""
        return max(((a - b).abs().max().item()
                    / max(b.abs().max().item(), 1.0)) for a, b in zip(got,
                                                                      want))

    # ---- float32 (core kernels), three samples: no hole, all hole,
    # strokes; TF32 off --------------------------------------------------
    n32 = 3
    xs, gs, hl = x32[:n32], g32[:n32], hole[:n32]
    taps_k, lse_k = fused_attention_taps(xs, hl, want_lse=True)
    taps_p, lse_p = fused_attention_taps_plain(xs, hl, want_lse=True)
    lse_err32 = (lse_k - lse_p).abs().max().item()
    args32 = (*prepare_bwd(xs, hl, gs, 3, rate)[:4], lse_p, taps_p, hs, ws,
              rate, scale)
    got32 = tap_grads(*args32)
    err32 = worst(got32, tap_grads_mirror(*args32))
    # the tap-gradient fold (gi_fold_tap_grads) on the core kernels' taps
    fargs32 = (args32[0], *got32[:4], args32[3], hs, ws, rate, scale)
    fold32 = fold_tap_grads(*fargs32)
    fold_err32 = worst((fold32,), (fold_tap_grads_plain(*fargs32),))
    _require(fold32[1].abs().max().item() == 0.0,
             f"float32 tap-gradient fold: all-hole sample not 0 at "
             f"{shape_name}")
    del got32, fargs32, fold32
    full_k = contextual_attention_bwd(xs, hl, taps_k, lse_k, gs)
    full_p = contextual_attention_bwd_plain(xs, hl, gs)
    full_err32 = ((full_k - full_p).abs().max().item()
                  / max(full_p.abs().max().item(), 1.0))
    _require(full_k[1].abs().max().item() == 0.0
             and bool(torch.isfinite(full_k).all()),
             f"all-hole gradient not exactly 0 at {shape_name}")
    del args32, taps_k, taps_p, full_k, full_p

    # ---- bfloat16 (wgmma kernels), the whole batch, against the mirror
    # in float32 on the same bf16 values; repeat and chunked runs --------
    xb, gb = x32.to(torch.bfloat16), g32
    taps_b, lse_b = fused_attention_taps(xb, hole, want_lse=True)
    _, lse_bp = fused_attention_taps_plain(xb.float(), hole, want_lse=True)
    lse_errb = (lse_b - lse_bp).abs().max().item()
    maps, gmaps, bias, rnorm, _ = prepare_bwd(xb, hole, gb, 3, rate)
    args = (maps, gmaps, bias, rnorm, lse_b, taps_b, hs, ws, rate, scale)
    chosen = plan_bwd(hs, ws, c, torch.bfloat16)
    _require(chosen.variant == "wgmma" and chosen.chunk >= bsz,
             f"the bf16 backward plan at {shape_name}: {chosen}")
    got = tap_grads(*args)
    again = tap_grads(*args)
    n_chunk = max(1, bsz // 3)
    chunked = tap_grads(*args, budget=n_chunk
                        * scratch_bytes_per_sample(lk))
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    same_chunked = all(torch.equal(a, b) for a, b in zip(got, chunked))
    del again, chunked
    dq_errb = worst((got[0], got[4]), tap_grads_mirror(*args, which="dq"))
    dkv_errb = worst(got[1:4], tap_grads_mirror(*args, which="dkv"))
    _require(all(t[1].abs().max().item() == 0.0 for t in got[:4])
             and all(bool(torch.isfinite(t).all()) for t in got),
             f"all-hole tap gradients not exactly 0 at {shape_name}")
    # the tap-gradient fold on the wgmma kernels' taps, written in bf16,
    # against the eager epilogue in float32
    fargs = (maps, *got[:4], rnorm, hs, ws, rate, scale)
    fold_k = fold_tap_grads(*fargs)
    fold_repeat = torch.equal(fold_k, fold_tap_grads(*fargs))
    fold_errb = worst((fold_k.float(),), (fold_tap_grads_plain(*fargs),))
    _require(fold_k.dtype == torch.bfloat16
             and fold_k[1].abs().max().item() == 0.0
             and bool(torch.isfinite(fold_k).all()),
             f"bf16 tap-gradient fold: all-hole sample not 0 at "
             f"{shape_name}")
    del fold_k
    torch.cuda.synchronize()
    print(f"[2] {shape_name} backward, error / max|reference|: f32 core "
          f"kernels {err32:.3e} whole {full_err32:.3e} (tol "
          f"{BWD_F32_TOL_FRAC:g}); bf16 wgmma dq+δ {dq_errb:.3e} dk/dv/t "
          f"{dkv_errb:.3e} (tol {BWD_BF16_TOL_FRAC:.3e}); lse max abs err "
          f"f32 {lse_err32:.3e} bf16 {lse_errb:.3e} (tol 1e-3 / 2e-2); "
          f"all-hole sample exactly 0; two runs bit-identical {repeat}; "
          f"chunks of {n_chunk} samples bit-identical to one chunk "
          f"{same_chunked}; plan {chosen._asdict()}")
    print(f"[2] {shape_name} tap-gradient fold (gi_fold_tap_grads) against "
          f"fold_tap_grads_plain, error / max|reference|: f32 "
          f"{fold_err32:.3e} (tol {FOLD_GRAD_F32_TOL_FRAC:g}), bf16 "
          f"{fold_errb:.3e} (tol {BF16_TOL_FRAC:.3e}); all-hole sample "
          f"exactly 0; two runs bit-identical {fold_repeat}")
    _require(max(err32, full_err32) <= BWD_F32_TOL_FRAC
             and max(dq_errb, dkv_errb) <= BWD_BF16_TOL_FRAC
             and lse_err32 <= 1e-3 and lse_errb <= 2e-2,
             f"a backward kernel or lse disagrees at {shape_name}")
    _require(fold_err32 <= FOLD_GRAD_F32_TOL_FRAC
             and fold_errb <= BF16_TOL_FRAC,
             f"the tap-gradient fold disagrees at {shape_name}")
    _require(repeat and same_chunked and fold_repeat,
             f"the bf16 backward is not repeatable at {shape_name}")

    # ---- times, bf16, the train batch: each launch --------------------
    reps = 5 if lk <= 1024 else 2
    delta = launch_delta(gmaps, taps_b, hs, ws, rate)
    scratch, tpart = launch_scores(maps, gmaps, bias, rnorm, lse_b, delta,
                                   hs, ws, rate, scale)
    ms = {"delta": _time_ms(torch, lambda: launch_delta(
              gmaps, taps_b, hs, ws, rate), reps),
          "scores": _time_ms(torch, lambda: launch_scores(
              maps, gmaps, bias, rnorm, lse_b, delta, hs, ws, rate, scale,
              scratch, tpart), reps),
          "dq": _time_ms(torch, lambda: launch_dq(
              maps, gmaps, scratch, tpart, hs, ws, rate), reps),
          "dkv": _time_ms(torch, lambda: launch_dkv(
              maps, gmaps, scratch, tpart, hs, ws, rate), reps)}
    # the whole of the kernels, wgmma and the core variant on the same bf16
    # maps in turns (wgmma, core, core, wgmma)
    turns = {"wgmma": [], "core": []}
    for v in ("wgmma", "core", "core", "wgmma"):
        turns[v].append(_time_ms(torch, lambda: tap_grads(
            *args, variant=v), reps if v == "wgmma" else 2))
    kernels_ms, core_ms = min(turns["wgmma"]), min(turns["core"])
    prep_ms = _time_ms(torch, lambda: prepare_bwd(xb, hole, gb, 3, rate),
                       reps)
    fold_ms = _time_ms(torch, lambda: fold_tap_grads(*fargs), 10)
    fold_plain_ms = _time_ms(torch, lambda: fold_tap_grads_plain(
        *fargs).to(torch.bfloat16), 2)
    # the 34 float32 tap gradients read once, the (0, 0) parity map, tnorm
    # and rnorm, and the bf16 gradient written once; ~4 operations per tap
    # element added (float32, outside the tensor cores)
    tap_elems = sum(t.numel() for t in got[:3])
    fold_bound = _bound_ms(
        tap_elems * 4 + maps[:, 0, 0].numel() * 2 + 2 * bsz * lk * 4
        + xb.numel() * 2, tap_elems * 4.0, H100_F32_FLOPS)
    del got, fargs
    whole_ms = _time_ms(torch, lambda: contextual_attention_bwd(
        xb, hole, taps_b, lse_b, gb), reps)
    fwd_lse_ms = _time_ms(torch, lambda: fused_attention_taps(
        xb, hole, want_lse=True), reps)
    fwd_ms = _time_ms(torch, lambda: fused_attention_taps(xb, hole), reps)

    # the plain version of each launch: the mirror's steps in PyTorch on
    # the card (float32 sums over the same bf16 values)
    geo = v_tap_geometry(rate)
    qk = [_tap(maps, 0, 0, i // 3, i % 3, hs, ws).float() for i in range(9)]
    do = [_tap(gmaps, *g_, hs, ws).float() for g_ in geo]
    vv = [_tap(maps, *g_, hs, ws).float() for g_ in geo]
    rs = (rnorm * scale)[:, None, :]

    def plain_delta():
        return sum((d * taps_b[:, i].float()).sum(-1)
                   for i, d in enumerate(do))

    def plain_scores():
        u = sum(torch.bmm(t, t.transpose(1, 2)) for t in qk)
        p = torch.where(bias[:, None, :] >= 0.0, torch.exp(
            u * rs + bias[:, None, :] - lse_b[:, :, None]), 0.0)
        dp = sum(torch.bmm(d, t.transpose(1, 2)) for d, t in zip(do, vv))
        ds = p * (dp - delta[:, :, None])
        part = (ds * u).reshape(bsz, lk // TILE, TILE, lk).sum(2)
        return (ds * rs).to(torch.bfloat16), p.to(torch.bfloat16), part

    dsr_b, p_b, _ = plain_scores()
    dsr_f, p_f = dsr_b.float(), p_b.float()
    plain_ms = {
        "delta": _time_ms(torch, plain_delta, 2),
        "scores": _time_ms(torch, plain_scores, 2),
        "dq": _time_ms(torch, lambda: torch.stack(
            [torch.bmm(dsr_f, t) for t in qk], 1), 2),
        "dkv": _time_ms(torch, lambda: (
            torch.stack([torch.bmm(dsr_f.transpose(1, 2), t) for t in qk], 1),
            torch.stack([torch.bmm(p_f.transpose(1, 2), d) for d in do], 1)),
            2)}
    del qk, vv, dsr_f, p_f
    whole_plain_ms = _time_ms(torch, lambda: contextual_attention_bwd_plain(
        xb, hole, gb), 2)
    # library yardsticks (never called by the port): (1) autograd through
    # SDPA over materialized patch Q/K/V, dQ, dK and dV in one call, held
    # against the dQ and dK/dV rows; (2) the five products as torch.matmul
    # in bf16 over the materialized patch tensors and this run's p and dsr:
    # S = Q·Kᵀ and dP = dO·Vᵀ (the score tiles' products), dQ = dS·K,
    # dK = dSᵀ·Q and dV = Pᵀ·dO
    q, k, valid, v, _ = _attention_inputs(xb, xb, hole, 3, rate)
    dop = torch.cat([_tap(gmaps, *g_, hs, ws) for g_ in geo], -1)
    del do
    matmul_ms = {
        "scores": _time_ms(torch, lambda: (
            torch.matmul(q, k.transpose(1, 2)),
            torch.matmul(dop, v.transpose(1, 2))), reps),
        "dq": _time_ms(torch, lambda: torch.matmul(dsr_b, k), reps),
        "dkv": _time_ms(torch, lambda: (
            torch.matmul(dsr_b.transpose(1, 2), q),
            torch.matmul(p_b.transpose(1, 2), dop)), reps)}
    del dop, dsr_b, p_b
    q, k, v = (t.detach()[:, None].requires_grad_(True) for t in (q, k, v))
    sdpa_mask = valid[:, None, None, :].clone()
    sdpa_mask[1] = True       # no all-masked rows: SDPA gives NaN there
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                         scale=scale)
    go = torch.randn_like(out)
    lib_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, (q, k, v), go, retain_graph=True), 2)
    del out, q, k, v, go, scratch, tpart

    # bounds: (query, valid key) pairs, 2 operations each per channel of a
    # product; bytes: each input read once, each output written once
    taps = 4 * rate * rate
    pairs = 2.0 * lk * int(valid.sum().item())
    pairs_all = 2.0 * bsz * lk * lk
    maps_b, gmaps_b = maps.numel() * 2, gmaps.numel() * 2
    vec = bsz * lk * 4
    scr = 2 * bsz * lk * lk * 2                  # p and dsr, bf16
    tp = bsz * (lk // TILE) * lk * 4
    qk_out, v_out = bsz * 9 * lk * c * 4, bsz * taps * lk * c * 4
    o_in = taps_b.numel() * 2
    bounds = {
        "delta": _bound_ms(gmaps_b + o_in + vec, 2.0 * bsz * lk * taps * c,
                           H100_F32_FLOPS),
        "scores": _bound_ms(maps_b + gmaps_b + 4 * vec + scr + tp,
                            pairs * c * (9 + taps), H100_BF16_FLOPS),
        "dq": _bound_ms(scr // 2 + maps_b + qk_out, pairs * c * 9,
                        H100_BF16_FLOPS),
        "dkv": _bound_ms(scr + maps_b + gmaps_b + tp + qk_out + v_out + vec,
                         pairs * c * (9 + taps), H100_BF16_FLOPS)}
    # the old kernels' rows (the flash count, scores recomputed in each:
    # dQ 9 + 4r² + 9, dK/dV 9 + 2·4r² + 9 units) beside the materialized
    # count (4r² + 9 + … once: 9 + 4r² for the scores, 9 for dQ, 9 + 4r²
    # for dK/dV, with the p/dsr round trip's bytes); a row's bound is the
    # least of the two
    io = maps_b + gmaps_b + 3 * vec + o_in
    flash = {"dq": _bound_ms(io + qk_out + vec, pairs * c * (9 + taps + 9),
                             H100_BF16_FLOPS),
             "dkv": _bound_ms(io + qk_out + v_out + vec,
                              pairs * c * (9 + 2 * taps + 9),
                              H100_BF16_FLOPS)}
    mat = {"dq": _bound_ms(io + qk_out + vec + scr, pairs * c
                           * (9 + taps + 9), H100_BF16_FLOPS),
           "dkv": _bound_ms(scr + maps_b + gmaps_b + tp + qk_out + v_out
                            + vec, pairs * c * (9 + taps), H100_BF16_FLOPS)}
    whole_flash = _bound_ms(io + 2 * qk_out + v_out + 2 * vec,
                            pairs * c * (2 * 9 + 3 * taps + 2 * 9),
                            H100_BF16_FLOPS)
    whole_mat = _bound_ms(io + 2 * qk_out + v_out + 2 * vec + 2 * scr,
                          pairs * c * (3 * 9 + 2 * taps), H100_BF16_FLOPS)
    row_ms = {"dq": ms["delta"] + ms["scores"] + ms["dq"], "dkv": ms["dkv"]}
    tflops = {k: ops / 1e9 / ms[k] for k, ops in (
        ("scores", pairs_all * c * (9 + taps)), ("dq", pairs_all * c * 9),
        ("dkv", pairs_all * c * (9 + taps)))}
    print(f"[2] {shape_name} backward bf16 ms: δ {ms['delta']:.3f}, scores "
          f"{ms['scores']:.3f}, dQ products {ms['dq']:.3f}, dK/dV products "
          f"{ms['dkv']:.3f}; TFLOP/s of all pairs "
          f"{ {k: round(v, 1) for k, v in tflops.items()} }; the kernels "
          f"with their chunking {kernels_ms:.3f} (core kernels in turns "
          f"{core_ms:.3f}), whole backward with prep "
          f"and epilogue {whole_ms:.3f} (plain autograd "
          f"{whole_plain_ms:.3f}); bounds by launch "
          f"{ {k: (round(b[0], 4), b[1]) for k, b in bounds.items()} }; "
          f"whole backward bound: flash count {whole_flash[0]:.4f} by "
          f"{whole_flash[1]}, materialized count {whole_mat[0]:.4f} by "
          f"{whole_mat[1]}; plain per launch "
          f"{ {k: round(v, 3) for k, v in plain_ms.items()} }; yardsticks: "
          f"SDPA backward over patches {lib_ms:.3f}, the five products as "
          f"torch.matmul {sum(matmul_ms.values()):.3f} "
          f"{ {k: round(v, 3) for k, v in matmul_ms.items()} }; forward "
          f"with lse {fwd_lse_ms:.3f} vs without {fwd_ms:.3f} | {smi}")
    print(f"[2] {shape_name} backward split, bf16 ms: prep (prepare_bwd) "
          f"{prep_ms:.3f}, kernels {kernels_ms:.3f}, epilogue (the "
          f"tap-gradient fold) {fold_ms:.4f} (plain {fold_plain_ms:.3f}; "
          f"bound {fold_bound[0]:.4f} by {fold_bound[1]}, "
          f"{100 * fold_bound[0] / fold_ms:.1f} %); whole {whole_ms:.3f} "
          f"| {smi}")
    res = {}
    for k in ("delta", "scores", "dq", "dkv"):
        res[k] = dict(ms=ms[k], plain_ms=plain_ms[k],
                      library_ms=lib_ms if k in ("dq", "dkv") else None,
                      matmul_ms=matmul_ms.get(k), bound_ms=bounds[k][0],
                      bound_by=bounds[k][1])
    for k in ("dq", "dkv"):
        least = min(flash[k], mat[k])
        res[k].update(row_ms=row_ms[k], row_bound_ms=least[0],
                      row_bound_by=least[1], flash_bound_ms=flash[k][0],
                      materialized_bound_ms=mat[k][0],
                      max_abs_err=dq_errb if k == "dq" else dkv_errb,
                      max_abs_err_f32=err32,
                      err_is="fraction of max|reference|")
    for k in ("delta", "scores"):
        res[k].update(max_abs_err=dq_errb if k == "delta" else max(
            dq_errb, dkv_errb), err_is="fraction of max|reference| of the "
            "gradients downstream")
    res["fold"] = dict(ms=fold_ms, plain_ms=fold_plain_ms, library_ms=None,
                       bound_ms=fold_bound[0], bound_by=fold_bound[1],
                       max_abs_err=fold_errb, max_abs_err_f32=fold_err32,
                       err_is="fraction of max|reference|")
    res.update(whole_backward_ms=whole_ms, kernels_ms=kernels_ms,
               core_kernels_ms=core_ms, kernel_turns_ms=turns,
               prep_ms=prep_ms,
               whole_plain_ms=whole_plain_ms,
               whole_flash_bound_ms=whole_flash[0],
               whole_materialized_bound_ms=whole_mat[0],
               forward_with_lse_ms=fwd_lse_ms, forward_ms=fwd_ms)
    return res


def check_conv_kernels(torch, rng, smi):
    """Phase 2, conv kernels: gated_conv_direct, gated_matmul and
    partial_epilogue against their plain versions at full-width shapes."""
    import torch.nn.functional as F

    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.ops.conv import conv2d
    from gan_inpainting_torch.ops.gated_conv import (
        gated_conv,
        gated_conv_plain,
    )
    from gan_inpainting_torch.ops.kernels import gated_matmul as gm
    from gan_inpainting_torch.ops.kernels.direct_conv import launch_direct
    from gan_inpainting_torch.ops.kernels.partial_epilogue import (
        partial_conv_epilogue,
        partial_conv_epilogue_plain,
    )
    from gan_inpainting_torch.ops.partial_conv import _window_counts

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    # the dilation-16 convs need cuDNN's per-shape search (see Inpainter)
    torch.backends.cudnn.benchmark = True
    dispatch.reset_launches()
    out = {}

    def gated(name, b, hw, cin, f, k, stride, dil, reps, act="elu"):
        x32 = torch.from_numpy(rng.standard_normal(
            (b, hw, hw, cin)).astype(np.float32)).to(dev)
        w32 = torch.from_numpy((rng.standard_normal((2 * f, cin, k, k))
                                / np.sqrt(k * k * cin)).astype(
                                    np.float32)).to(dev)
        bias = torch.from_numpy(0.5 * rng.standard_normal(2 * f).astype(
            np.float32)).to(dev)
        kw = dict(stride=stride, dilation=dil, activation=act)
        want32 = gated_conv_plain(x32, w32, bias, **kw)
        got32 = gated_conv(x32, w32, bias, backend="pallas", **kw)
        ref = max(want32.abs().max().item(), 1.0)
        err32 = (got32 - want32).abs().max().item()
        del got32, want32
        xb, wb = x32.to(bf16), w32.to(bf16)
        wantb = gated_conv_plain(xb.float(), wb.float(), bias, **kw)
        gotb = gated_conv(xb, wb, bias, backend="pallas", **kw)
        errb = (gotb.float() - wantb).abs().max().item()
        ho = gotb.shape[1]
        del gotb, wantb, x32, w32
        torch.cuda.synchronize()
        _require(err32 <= CONV_F32_TOL_FRAC * ref
                 and errb <= CONV_BF16_TOL_FRAC * ref,
                 f"{name}: gated conv kernel disagrees with its plain "
                 f"version (f32 {err32:.3e}, bf16 {errb:.3e}, max|ref| "
                 f"{ref:.3e})")
        # ---- times, bf16 -------------------------------------------------
        ms = _time_ms(torch, lambda: gated_conv(xb, wb, bias,
                                                backend="pallas", **kw), reps)
        plain_ms = _time_ms(torch, lambda: gated_conv_plain(xb, wb, bias,
                                                            **kw), reps)
        # library yardstick: the conv with bias alone — it lacks the gate
        lib_ms = _time_ms(torch, lambda: conv2d(xb, wb, bias, stride=stride,
                                                dilation=dil), reps)
        # the bound is the function's: x and the weights read once, the
        # output written once, 2·M·K·2F operations (the im2col rows of the
        # yardstick route below are not in it).
        m = b * ho * ho
        k_dim = k * k * cin
        n_bytes = (xb.numel() + wb.numel() + m * f) * 2 + bias.numel() * 4
        extra = {}
        p = gm.plan(cin, f, bf16)
        wp = gm.pack_weights(wb, p)
        xp = gm.pad_channels(xb, p.cin_pad)
        if stride == 1 and k % 2:
            tile = gm.a_tile(p, b, ho, ho, 1)
            kernel_ms = _time_ms(torch, lambda: launch_direct(
                xp, wp, bias, f, k, dil, p, act), reps)
        else:
            # the route the wrapper takes (the strided taps of the map) and,
            # in turns with it (A B B A), the kernel over materialized
            # im2col rows as a flat 1×1 map — the Pallas kernel's route
            cols = _im2col_rows(xp, k, stride, dil)
            dense = p._replace(kpt=p.cin_pad)      # the im2col's K order
            flat = dense._replace(kpt=cols.shape[-1])
            wpd = gm.pack_weights(wb, dense)
            g_flat = gm.ConvGeom(1, 1, 1, 0, 0, 1, m)
            runs = {"im2col": lambda: gm.launch_gated(
                        cols, wpd, bias, f, g_flat, flat, act, gm.KERNEL),
                    "strided": lambda: gm.launch_strided(
                        xp, wp, bias, f, k, stride, dil, p, act)}
            wraps = {"im2col": lambda: gm.launch_gated(
                         _im2col_rows(xp, k, stride, dil), wpd, bias, f,
                         g_flat, flat, act, gm.KERNEL),
                     "strided": lambda: gated_conv(xb, wb, bias,
                                                   backend="pallas", **kw)}
            want_flat = gated_conv_plain(xb.float(), wb.float(), bias, **kw)
            errs = {r: (run().float().reshape(want_flat.shape)
                        - want_flat).abs().max().item()
                    for r, run in runs.items()}
            _require(max(errs.values()) <= CONV_BF16_TOL_FRAC * ref,
                     f"{name}: a strided route disagrees ({errs})")
            errb = max(errb, *errs.values())
            kt = {r: [] for r in runs}
            wt = {r: [] for r in runs}
            for r in ("im2col", "strided", "strided", "im2col"):
                kt[r].append(_time_ms(torch, runs[r], reps))
                wt[r].append(_time_ms(torch, wraps[r], reps))
            tile = gm.a_tile(p, b, ho, ho, stride)
            kernel_ms = float(np.mean(kt["strided"]))
            del cols
            extra = dict(routes={r: dict(kernel_ms=kt[r], wrapper_ms=wt[r])
                                 for r in runs})
            print(f"[2] {name}: routes in turns (im2col, strided, strided, "
                  f"im2col), ms kernel / with its host prep: " + "; ".join(
                      f"{r} {' '.join(f'{t:.3f}' for t in kt[r])} / "
                      f"{' '.join(f'{t:.3f}' for t in wt[r])}" for r in runs)
                  + f"; the wrapper takes the strided taps; max_abs_err "
                  f"{errs}")
        bound, by = _bound_ms(n_bytes, 2.0 * m * k_dim * 2 * f,
                              H100_BF16_FLOPS)
        tflops = 2.0 * m * k_dim * 2 * f / kernel_ms / 1e9
        flop_per_byte = 1.0 / gm.fill_bytes_per_flop(p)
        a_path = f"TMA box {tile}" if tile else "cp.async gather"
        print(f"[2] {name}: max_abs_err f32 {err32:.3e} (tol "
              f"{CONV_F32_TOL_FRAC * ref:.3e}) bf16 {errb:.3e} (tol "
              f"{CONV_BF16_TOL_FRAC * ref:.3e}); bf16 ms {ms:.3f} (kernel "
              f"only {kernel_ms:.3f} = {tflops:.1f} TFLOP/s; plan {p}, A by "
              f"{a_path}, {flop_per_byte:.1f} FLOP per byte filled), plain "
              f"{plain_ms:.3f}, conv2d+bias alone {lib_ms:.3f}, bound "
              f"{bound:.4f} by {by} | {smi}")
        return dict(ms=ms, kernel_only_ms=kernel_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound, bound_by=by,
                    max_abs_err=errb, max_abs_err_f32=err32,
                    shape=name, plan=p._asdict(), a_path=a_path,
                    tflops=tflops, flop_per_fill_byte=flop_per_byte,
                    **extra)

    out["direct_d1"] = gated("gated_conv_direct 192->2x192 3x3 d1 64x64² ",
                             64, 64, 192, 192, 3, 1, 1, 10)
    out["direct_d16"] = gated("gated_conv_direct 192->2x192 3x3 d16 64x64²",
                              64, 64, 192, 192, 3, 1, 16, 10)
    out["direct_stem"] = gated("gated_conv_direct 4->2x48 5x5 8x256² (stem)",
                               8, 256, 4, 48, 5, 1, 1, 10)
    out["matmul_s2"] = gated("gated_matmul 96->2x192 3x3 s2 64x128²->64²",
                             64, 128, 96, 192, 3, 2, 1, 10)
    # the other forms of path A: F = 96 and F = 24 (wgmma N 192 and 48),
    # Cin = 48 (gathered) and 384, the relu epilogue, the first stride-2
    # conv
    out["direct_f96"] = gated("gated_conv_direct 96->2x96 3x3 64x128²      ",
                              64, 128, 96, 96, 3, 1, 1, 5)
    out["direct_f24"] = gated("gated_conv_direct 48->2x24 3x3 16x256²      ",
                              16, 256, 48, 24, 3, 1, 1, 5)
    out["direct_c384"] = gated("gated_conv_direct 384->2x192 3x3 64x64²   ",
                               64, 64, 384, 192, 3, 1, 1, 5)
    out["direct_relu"] = gated("gated_conv_direct 192->2x192 3x3 64x64² relu",
                               64, 64, 192, 192, 3, 1, 1, 5, act="relu")
    out["matmul_c48"] = gated("gated_matmul 48->2x96 3x3 s2 16x256²->128²",
                              16, 256, 48, 96, 3, 2, 1, 5)

    def partial(name, b, hw, c, reps):
        raw32 = torch.from_numpy(rng.standard_normal(
            (b, hw, hw, c)).astype(np.float32)).to(dev)
        holes = _stroke_masks(rng, b, hw, hw)
        holes[0, : hw // 2] = 1.0         # windows with no valid pixel
        valid = 1.0 - torch.from_numpy(holes[..., None]).to(dev)
        counts = _window_counts(valid, 3, 1, 1)
        dead = counts[..., 0] == 0
        _require(bool(dead.any()) and not bool(dead.all()),
                 f"{name}: the masks leave no window with count 0")
        raw32[dead] = 1e30                # finite garbage under count 0
        bias = torch.from_numpy(rng.standard_normal(c).astype(
            np.float32)).to(dev)
        errs = {}
        for dtype in (torch.float32, bf16):
            raw = raw32.to(dtype)
            y, v = partial_conv_epilogue(raw, counts, bias, 3)
            wy, wv = partial_conv_epilogue_plain(raw.float(), counts, bias, 3)
            _require(y.dtype == dtype and v.dtype == dtype
                     and torch.equal(v.float(), wv),
                     f"{name}: valid_out not exact in {dtype}")
            _require(bool((y[dead] == 0).all()),
                     f"{name}: y not exactly 0 where count = 0")
            errs[dtype] = ((y.float() - wy).abs().max().item(),
                           max(wy.abs().max().item(), 1.0))
        (err32, ref), (errb, _) = errs[torch.float32], errs[bf16]
        _require(err32 <= 1e-6 * ref and errb <= CONV_BF16_TOL_FRAC * ref,
                 f"{name}: partial epilogue kernel disagrees (f32 "
                 f"{err32:.3e}, bf16 {errb:.3e}, max|ref| {ref:.3e})")
        rawb = raw32.to(bf16)
        del raw32
        ms = _time_ms(torch, lambda: partial_conv_epilogue(
            rawb, counts, bias, 3), reps)
        plain_ms = _time_ms(torch, lambda: partial_conv_epilogue_plain(
            rawb, counts, bias, 3), reps)
        m = b * hw * hw
        bound, by = _bound_ms(2 * m * c * 2 + m * 4 + m * 2 + c * 4,
                              3.0 * m * c, H100_F32_FLOPS)
        print(f"[2] {name}: max_abs_err f32 {err32:.3e} (tol "
              f"{1e-6 * ref:.1e}) bf16 {errb:.3e} (tol "
              f"{CONV_BF16_TOL_FRAC * ref:.3e}), valid_out exact, y = 0 on "
              f"{int(dead.sum())} count-0 pixels; bf16 ms {ms:.4f}, plain "
              f"{plain_ms:.4f}, bound {bound:.4f} by {by} | {smi}")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                    bound_ms=bound, bound_by=by, max_abs_err=errb,
                    max_abs_err_f32=err32, shape=name)

    out["partial_c48"] = partial("partial_epilogue C=48 64x256² ", 64, 256,
                                 48, 20)
    out["partial_c192"] = partial("partial_epilogue C=192 64x64²", 64, 64,
                                  192, 20)
    print(f"[2] conv kernels: launches in these checks and timings (not "
          f"counted for any path): {dict(dispatch.launches)}")
    torch.backends.cudnn.benchmark = False
    return out


def _train_setup(torch, name, overrides, device="cuda", n_batches=2):
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.data.loader import make_dataset
    from gan_inpainting_torch.data.pipeline import make_train_batch
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step
    from gan_inpainting_torch.utils.rng import STREAM_MASKS, stream_generator

    cfg = apply_overrides(get_config(name), overrides)
    state = create_state(cfg, device=device)
    data = make_dataset(cfg.data, seed=cfg.train.seed, device=device)
    batches = [make_train_batch(
        next(data), stream_generator(cfg.train.seed, STREAM_MASKS, i),
        cfg.mask, flip=cfg.data.random_flip) for i in range(n_batches)]
    return cfg, state, make_train_step(cfg), batches


def _timed_steps(torch, step_fn, state, batches, n):
    """steps/s over n steps without the R1 pass, and the phases' ms."""
    from gan_inpainting_torch.tools.profile_train import time_steps
    from gan_inpainting_torch.utils.spans import SpanRecorder, set_section_hook

    at = state.step
    state.step = 1
    ms = time_steps(step_fn, state, batches, n)
    recorder = SpanRecorder(events=True)
    set_section_hook(recorder)
    state.step = 1
    for i in range(n):
        step_fn(state, batches[i % len(batches)])
    set_section_hook(None)
    parts = {k: v / n for k, v in recorder.device_ms().items()}
    state.step = at
    return ms, parts


def train(torch, smi):
    """Phase 4: the train path on the card."""
    import tempfile

    from gan_inpainting_torch.io.checkpoint import CheckpointManager
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.tools.profile_train import time_steps
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import composite

    # per step, two attention forwards (the detached and the differentiated
    # generator pass) and one backward. A bf16 map takes the fused route up
    # to FUSED_MAX_CELLS_BF16_FORWARD cells for the detached forward and up
    # to FUSED_MAX_CELLS for the differentiated one, whose backward then
    # runs the fused backward's five launches (δ, scores, dQ and dK/dV
    # products, the tap-gradient fold); above a limit a forward (and the
    # backward) take the patch kernels. The 512² map has 4096 cells, the
    # 256² map 1024.
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        FUSED_MAX_CELLS,
        FUSED_MAX_CELLS_BF16_FORWARD,
    )

    names = ("patch_attention_fwd", "patch_attention_bwd_dq",
             "patch_attention_bwd_dkv", "contextual_attention_fused",
             "fold_taps", "contextual_attention_bwd_delta",
             "contextual_attention_bwd_scores", "contextual_attention_bwd_dq",
             "contextual_attention_bwd_dkv", "contextual_attention_bwd_fold")

    def expected(cells):
        detached = int(cells <= FUSED_MAX_CELLS_BF16_FORWARD)
        trained = int(cells <= FUSED_MAX_CELLS)
        fused = detached + trained
        return dict(zip(names, (2 - fused, 1 - trained, 1 - trained, fused,
                                fused, trained, trained, trained, trained,
                                trained)))

    per_step, per_step_256 = expected(64 * 64), expected(32 * 32)

    def snapshot(state):
        return [t.detach().clone() for t in (
            *state.generator.parameters(), *state.discriminator.parameters(),
            *state.g_ema.values())]

    def moved(before, state):
        now = snapshot(state)
        ng = len(list(state.generator.parameters()))
        nd = len(list(state.discriminator.parameters()))
        parts = (slice(0, ng), slice(ng, ng + nd), slice(ng + nd, None))
        return [sum((a.float() - b.float()).abs().sum().item()
                    for a, b in zip(before[p], now[p])) for p in parts]

    # ---- places512_deepfill, full width, 6 steps from step 0 ------------
    t0 = time.perf_counter()
    cfg, state, step_fn, batches = _train_setup(
        torch, "places512_deepfill", TRAIN_512)
    m = cfg.model
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.discriminator.parameters())
    print(f"[4] train {cfg.name}: {m.generator}/{m.conv_kind} width "
          f"{m.base_features} attention={m.use_attention} "
          f"rate={m.attention_rate} dtype={m.dtype_policy} "
          f"{cfg.data.batch_size}x{cfg.data.image_size}² G params {n_g} D "
          f"params {n_d} r1 γ={cfg.loss.r1_gamma} every "
          f"{cfg.loss.r1_interval} EMA {cfg.train.g_ema_decay}")
    before = snapshot(state)
    n_steps = 4
    dispatch.reset_launches()
    history = []
    for i in range(n_steps):
        metrics = step_fn(state, batches[i % 2])
        history.append({k: float(v) for k, v in metrics.items()})
    torch.cuda.synchronize()
    launches_512 = dict(dispatch.launches)
    for i, h in enumerate(history):
        _require(all(np.isfinite(v) for v in h.values()),
                 f"step {i} metrics not finite: {h}")
    _require(history[0]["d_r1"] > 0
             and all(h["d_r1"] == 0 for h in history[1:]),
             "R1 must apply at step 0 only")
    _require(state.step == n_steps, "step count")
    for name in names:
        _require(launches_512.get(name, 0) == per_step[name] * n_steps,
                 f"{name}: {launches_512.get(name, 0)} launches in "
                 f"{n_steps} steps, expected {per_step[name]} per step")
    dg, dd, de = moved(before, state)
    _require(dg > 0 and dd > 0 and de > 0, "parameters did not move")
    print(f"[4] {n_steps} steps from step 0 in "
          f"{time.perf_counter() - t0:.1f} s (kernel build, cuDNN "
          f"autotuning); step 0 {history[0]}")
    print(f"[4] step {n_steps - 1} {history[-1]}; launches {launches_512}; "
          f"moved |Δ| G {dg:.4g} D {dd:.4g} EMA {de:.4g}")

    # the attention branch gets a gradient through the backward kernels
    b0 = batches[0]
    out = state.generator(b0.masked, b0.mask)
    loss = (composite(out.fine, b0.image, b0.mask) - b0.image).abs().mean()
    branch = list(state.generator.refine_attn_enc.parameters())
    grads = torch.autograd.grad(loss, branch)
    gsum = sum(g.abs().sum().item() for g in grads)
    _require(np.isfinite(gsum) and all(g.abs().max().item() > 0
                                       for g in grads),
             "attention branch parameters got no gradient")
    del out, loss, grads

    # checkpoint: save, restore into a fresh state, equal
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(state.step, state, cfg)
        other = create_state(cfg, seed=123, device="cuda")
        mgr.restore(other)
    a, b = state.state_dict(), other.state_dict()
    same = (a["step"] == b["step"] and all(
        torch.equal(a[part][k], b[part][k])
        for part in ("g_params", "d_params", "g_ema") for k in a[part])
        and all(torch.equal(v.cpu(), b[part]["state"][i][k].cpu())
                for part in ("g_opt", "d_opt")
                for i, st in a[part]["state"].items() for k, v in st.items()))
    _require(same, "restored checkpoint differs from the saved state")
    del other
    ms_512, parts_512 = _timed_steps(torch, step_fn, state, batches, 3)
    print(f"[4] attention-branch gradient Σ|g| {gsum:.4g}; checkpoint saved "
          f"and restored equal; {cfg.data.batch_size}x512² bf16 "
          f"{ms_512:.1f} ms/step = {1e3 / ms_512:.3f} steps/s (steps "
          f"without R1, after warm-up); phases ms "
          f"{ {k: round(v, 1) for k, v in parts_512.items()} }; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB "
          f"| {smi}")
    # ---- AUTO_CUDA["gated_conv"] on this step: the library composition
    # and the kernels (whose backward recomputes through the library), in
    # turns A B B A, 4 steps each without R1, after two warm steps each
    saved, at = dispatch.AUTO_CUDA["gated_conv"], state.step
    gated_turns = {"xla": [], "pallas": []}
    gated_launches = {}
    for choice in ("xla", "pallas", "xla", "pallas", "pallas", "xla"):
        dispatch.AUTO_CUDA["gated_conv"] = choice
        state.step = 1
        if choice not in gated_launches:
            dispatch.reset_launches()
            for i in range(2):
                step_fn(state, batches[i])
            torch.cuda.synchronize()
            gated_launches[choice] = {
                k: v // 2 for k, v in dispatch.launches.items()
                if k in ("gated_conv_direct", "gated_matmul")}
            continue
        gated_turns[choice].append(time_steps(step_fn, state, batches, 4))
    dispatch.AUTO_CUDA["gated_conv"], state.step = saved, at
    _require(not any(gated_launches["xla"].values())
             and gated_launches["pallas"].get("gated_conv_direct", 0) > 0
             and gated_launches["pallas"].get("gated_matmul", 0) > 0,
             f"gated-conv launches per step {gated_launches}")
    gain, spread = _decide(gated_turns["xla"], gated_turns["pallas"])
    print(f"[4] {cfg.data.batch_size}x512² step ms with "
          f"AUTO_CUDA['gated_conv'] = xla {gated_turns['xla']} / pallas "
          f"{gated_turns['pallas']} (in turns; pallas launches per step "
          f"{gated_launches['pallas']}): pallas "
          f"{'slower' if gain < 0 else 'faster'} by {abs(gain):.1f} ms, "
          f"spread {spread:.1f} ms | {smi}")
    del state, step_fn, batches, before
    torch.cuda.empty_cache()

    # ---- 256² attention config, batch 16: one fixed batch ---------------
    cfg, state, step_fn, batches = _train_setup(
        torch, "celebahq256_freeform", TRAIN_256 + ["train.g_lr=0.0005"])
    n_fixed = 30
    dispatch.reset_launches()
    l1 = [float(step_fn(state, batches[0])["g_l1"]) for _ in range(n_fixed)]
    torch.cuda.synchronize()
    launches_256 = dict(dispatch.launches)
    for name in names:
        _require(launches_256.get(name, 0) == per_step_256[name] * n_fixed,
                 f"{name}: {launches_256.get(name, 0)} launches at 256²")
    _require(all(np.isfinite(l1)) and np.mean(l1[-3:]) < 0.9 * l1[0],
             f"g_l1 did not fall on a fixed batch: {l1[0]} -> {l1[-3:]}")
    ms_256, parts_256 = _timed_steps(torch, step_fn, state, batches, 5)
    print(f"[4] {cfg.name}+attention {cfg.data.batch_size}x256² bf16, one "
          f"fixed batch, g_lr 5e-4: g_l1 {l1[0]:.4f} -> "
          f"{np.mean(l1[-3:]):.4f} over {n_fixed} steps; {ms_256:.1f} "
          f"ms/step = {1e3 / ms_256:.3f} steps/s; phases ms "
          f"{ {k: round(v, 1) for k, v in parts_256.items()} }; launches "
          f"{launches_256} | {smi}")
    del state, step_fn, batches
    torch.cuda.empty_cache()

    # ---- one float32 step, small size: card (kernels) vs CPU (plain) ----
    small = TRAIN_256 + ["model.dtype_policy=f32", "model.base_features=16",
                         "model.disc_features=16", "data.image_size=64",
                         "data.batch_size=2", "model.spectral_norm=true"]
    _, s_cpu, f_cpu, b_cpu = _train_setup(torch, "celebahq256_freeform",
                                          small, device="cpu", n_batches=1)
    _, s_gpu, f_gpu, _ = _train_setup(torch, "celebahq256_freeform", small,
                                      n_batches=1)
    b_gpu = type(b_cpu[0])(*(t.cuda() for t in b_cpu[0]))
    m_cpu = {k: float(v) for k, v in f_cpu(s_cpu, b_cpu[0]).items()}
    m_gpu = {k: float(v) for k, v in f_gpu(s_gpu, b_gpu).items()}
    rel = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-3)
              for k in m_cpu)
    sd_c, sd_g = s_cpu.state_dict(), s_gpu.state_dict()
    gap = max((sd_g[p][k].cpu() - sd_c[p][k]).abs().max().item()
              for p in ("g_params", "d_params", "g_ema") for k in sd_c[p])
    # one Adam step moves a parameter by at most lr = 4e-4; where a
    # gradient is near 0 its rounding noise decides the direction
    print(f"[4] f32 step cuda vs cpu (TF32 off, 2x64², width 16): metrics "
          f"max rel diff {rel:.3e} (tol 1e-3), parameters max abs diff "
          f"{gap:.3e} (tol 1e-4)")
    _require(rel <= 1e-3 and gap <= 1e-4,
             "f32 train step on the card disagrees with the CPU")

    # does a run repeat bit for bit on the card? Two runs of 3 bf16 steps
    # from the same seed and batch (reported, not required: the attention
    # kernels add in a fixed order, cuDNN's autotuned algorithms and some
    # of PyTorch's backward kernels need not)
    runs = []
    for _ in range(2):
        _, st, fn, bt = _train_setup(
            torch, "celebahq256_freeform",
            [o for o in small if o != "model.dtype_policy=f32"], n_batches=1)
        for _ in range(3):
            fn(st, bt[0])
        runs.append([p.detach().clone() for p in st.generator.parameters()])
    repeat = all(torch.equal(a, b) for a, b in zip(*runs))
    drift = max((a - b).abs().max().item() for a, b in zip(*runs))
    print(f"[4] two bf16 runs of 3 steps from one seed on the card: "
          f"generator parameters bit-identical: {repeat} (max abs diff "
          f"{drift:.3e})")
    return dict(launches_512=launches_512, steps_512=n_steps,
                launches_256=launches_256, ms_512=ms_512, ms_256=ms_256, parts_512=parts_512,
                parts_256=parts_256, gated_turns_512=gated_turns,
                gated_launches_512=gated_launches)


def serve(torch, rng, smi):
    """Phase 3: the serve path through Inpainter on the card."""
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.ops import dispatch

    inp = Inpainter.from_npz(NPZ, overrides=SERVE_OVERRIDES, device="cuda")
    m = inp.cfg.model
    n_params = sum(int(np.prod(v.shape)) for v in inp.state_dict.values())
    print(f"[3] model {m.generator}/{m.conv_kind} width {m.base_features} "
          f"attention={m.use_attention} rate={m.attention_rate} "
          f"fuse_upsample={m.fuse_upsample} dtype={m.dtype_policy} "
          f"params {n_params}")

    def request(imgs, masks):
        out = inp.inpaint_batch(imgs, masks)
        keep = np.broadcast_to(masks[..., None] == 0, imgs.shape)
        hole = ~keep
        _require(out.shape == imgs.shape and out.dtype == np.uint8,
                 f"output {out.shape} {out.dtype}")
        _require(np.array_equal(out[keep], imgs[keep]), "known pixels changed")
        _require((out[hole] != imgs[hole]).any(), "holes not filled")
        return out

    reqs = {
        "1x256": (1, 256, 256), "8x256": (8, 256, 256),
        "1x200x240": (1, 200, 240), "1x512": (1, 512, 512)}
    data = {k: (_smooth_images(rng, *s), _stroke_masks(rng, *s))
            for k, s in reqs.items()}
    dispatch.reset_launches()
    t0 = time.perf_counter()
    for name in ("1x256", "8x256", "1x200x240"):
        request(*data[name])
    at_256 = dict(dispatch.launches)
    request(*data["1x512"])
    torch.cuda.synchronize()
    total = dict(dispatch.launches)
    at_512 = {k: total.get(k, 0) - at_256.get(k, 0) for k in total}
    print(f"[3] served 1x256², 8x256², 1x200x240, 1x512² in "
          f"{time.perf_counter() - t0:.2f} s (first use; cuDNN plans); "
          f"known pixels bit-exact; launches 256-bucket {at_256}, "
          f"512-bucket {at_512}")
    # both buckets' maps (1024 and 4096 cells, a bf16 forward alone: at
    # most FUSED_MAX_CELLS_BF16_FORWARD) take the fused route
    for name in ("contextual_attention_fused", "fold_taps"):
        _require(at_256.get(name, 0) > 0 and at_512.get(name, 0) > 0,
                 f"serve path: {name} launches {at_256.get(name, 0)} at the "
                 f"256² bucket, {at_512.get(name, 0)} at 512²")
    _require(at_512.get("patch_attention_fwd", 0) == 0
             and at_256.get("patch_attention_fwd", 0) == 0,
             "a serve bucket took the patch route")

    # ---- float32 on the card vs the CPU, TF32 off ---------------------
    f32 = SERVE_OVERRIDES + ["model.dtype_policy=f32"]
    img, msk = data["1x256"]
    gpu = Inpainter.from_npz(NPZ, overrides=f32, device="cuda")
    cpu = Inpainter.from_npz(NPZ, overrides=f32, device="cpu")
    a = gpu.inpaint_batch(img, msk).astype(int)
    b = cpu.inpaint_batch(img, msk).astype(int)
    diff = np.abs(a - b)
    frac = float((diff <= 1).mean())
    hole_px = np.broadcast_to(msk[..., None] > 0, img.shape)
    frac_hole = float((diff[hole_px] <= 1).mean())
    print(f"[3] f32 cuda vs cpu (TF32 off): within ±1 on {frac:.6f} of "
          f"pixels ({frac_hole:.6f} of hole pixels), max diff "
          f"{int(diff.max())}")
    _require(frac >= 0.999, "f32 card output disagrees with the CPU")

    # ---- latency of one 1×256² request (host uint8 in/out), warm --------
    img, msk = data["1x256"]
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        inp.inpaint_batch(img, msk)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[3] latency 1x256² bf16 request: median {np.median(lat):.2f} ms, "
          f"min {min(lat):.2f} ms over 10 | {smi}")

    # ---- throughput: 64×256² bf16 --------------------------------------
    t_c = time.perf_counter()
    imgs = _smooth_images(rng, 64, 256, 256)
    masks = _stroke_masks(rng, 64, 256, 256)
    inp.inpaint_batch(imgs, masks)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        inp.inpaint_batch(imgs, masks)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    fwd = inp._forward(True)             # the 256² buckets' fused decoder
    dev_img = torch.from_numpy(imgs).cuda()
    dev_msk = torch.from_numpy(masks[..., None]).cuda()
    fwd_ms = _time_ms(torch, lambda: fwd(dev_img, dev_msk), reps)
    print(f"[3] serve 64x256² bf16: {64 / dt:.1f} img/s through "
          f"inpaint_batch (host uint8 in/out), device forward "
          f"{fwd_ms:.2f} ms = {64e3 / fwd_ms:.1f} img/s | {smi}")
    return at_256, at_512, (*data["1x256"], b), 64e3 / fwd_ms


def _known_exact(out, imgs, masks, what):
    keep = np.broadcast_to(masks[..., None] == 0, imgs.shape)
    _require(out.shape == imgs.shape and out.dtype == np.uint8,
             f"{what}: output {out.shape} {out.dtype}")
    _require(np.array_equal(out[keep], imgs[keep]),
             f"{what}: known pixels changed")
    _require((out[~keep] != imgs[~keep]).any(), f"{what}: holes not filled")


def _within_one(a, b):
    diff = np.abs(a.astype(int) - b.astype(int))
    return float((diff <= 1).mean()), int(diff.max())


def _serve_rates(torch, inpainters, imgs, masks, reps=3, gated=None):
    """img/s of each Inpainter at one batch: through ``inpaint_batch`` and
    of the device forward alone; taken in turns, A B C C B A. ``gated``
    names, per entry, the value of ``AUTO_CUDA["gated_conv"]`` during its
    turns. Each entry also holds the uint8 ``output`` of the batch and the
    forward ms of each turn."""
    from gan_inpainting_torch.ops import dispatch

    dev_img = torch.from_numpy(imgs).cuda()
    dev_msk = torch.from_numpy(masks[..., None]).cuda()
    n = imgs.shape[0]
    api = {k: [] for k in inpainters}
    fwd = {k: [] for k in inpainters}
    saved = dispatch.AUTO_CUDA["gated_conv"]
    gated = gated or {}
    outputs = {}
    for k in list(inpainters) + list(inpainters) + list(inpainters)[::-1]:
        inp = inpainters[k]
        dispatch.AUTO_CUDA["gated_conv"] = gated.get(k, saved)
        if k not in outputs:           # first use of the bucket
            outputs[k] = inp.inpaint_batch(imgs, masks)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            inp.inpaint_batch(imgs, masks)
        torch.cuda.synchronize()
        api[k].append((time.perf_counter() - t0) / reps)
        f = inp._forward(inp._cfg_for_size(imgs.shape[1]).model.fuse_upsample)
        fwd[k].append(_time_ms(torch, lambda: f(dev_img, dev_msk), reps))
    dispatch.AUTO_CUDA["gated_conv"] = saved
    return {k: dict(api_img_s=n / float(np.mean(api[k])),
                    fwd_ms=float(np.mean(fwd[k])), fwd_turns_ms=fwd[k],
                    fwd_img_s=n * 1e3 / float(np.mean(fwd[k])),
                    output=outputs[k])
            for k in inpainters}


def _decide(turns_a, turns_b):
    """(mean of a − mean of b, the larger spread of the two): b gains when
    the first exceeds the second."""
    gain = float(np.mean(turns_a) - np.mean(turns_b))
    spread = max(max(t) - min(t) for t in (turns_a, turns_b))
    return gain, float(spread)


def _hole_agreement(a, b, masks):
    """Of the hole pixels of two uint8 batches: the fractions that differ
    by at most 1, 2, 4 and 8 levels, and the largest difference."""
    hole = np.broadcast_to(masks[..., None] > 0, a.shape)
    diff = np.abs(a.astype(int) - b.astype(int))[hole]
    return {f"within_{t}": float((diff <= t).mean()) for t in (1, 2, 4, 8)
            } | {"max": int(diff.max())}


def serve_kernel_backend(torch, rng, smi, img1, msk1, cpu_f32):
    """Phase 5, path A: serve_v4_8 with model.kernel_backend=pallas."""
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.models.layers import InpaintConv
    from gan_inpainting_torch.ops import dispatch

    def load(backend, extra=()):
        return Inpainter.from_npz(NPZ, overrides=SERVE_OVERRIDES + [
            f"model.kernel_backend={backend}", *extra], device="cuda")

    inp = load("pallas")
    # what the module tree says should reach the kernels
    for fuse, want_direct in ((True, DIRECT_FUSED), (False, DIRECT_UNFUSED)):
        convs = [m for m in inp._forward(fuse).generator.modules()
                 if isinstance(m, InpaintConv) and m.conv_kind == "gated"
                 and not (m.pre_upsample or m.s2d)]
        _require(all(m.backend == "pallas" for m in convs)
                 and sum(m.stride == 1 for m in convs) == want_direct
                 and sum(m.stride != 1 for m in convs) == MATMUL_PER_FWD,
                 f"serve_v4_8 (fuse_upsample={fuse}) does not hold "
                 f"{want_direct} + {MATMUL_PER_FWD} kernel-routed gated convs")
    reqs = {"1x256": (1, 256, 256), "8x256": (8, 256, 256),
            "1x512": (1, 512, 512)}
    per_request = {}
    total = {}
    t0 = time.perf_counter()
    dispatch.reset_launches()
    for name, shape in reqs.items():
        before = dict(dispatch.launches)
        imgs, masks = _smooth_images(rng, *shape), _stroke_masks(rng, *shape)
        _known_exact(inp.inpaint_batch(imgs, masks), imgs, masks,
                     f"path A {name}")
        per_request[name] = {k: v - before.get(k, 0)
                             for k, v in dispatch.launches.items()
                             if v - before.get(k, 0)}
    torch.cuda.synchronize()
    total = dict(dispatch.launches)
    for name, got in per_request.items():
        # attention: the fused forward and fold on the 256² and the 512²
        # map (a bf16 forward alone, at most FUSED_MAX_CELLS_BF16_FORWARD)
        want = {"gated_conv_direct": DIRECT_UNFUSED if name == "1x512"
                else DIRECT_FUSED, "gated_matmul": MATMUL_PER_FWD,
                "contextual_attention_fused": 1,
                "contextual_attention_fused_wgmma": 1, "fold_taps": 1}
        _require(got == want, f"path A {name}: launches {got}, expected "
                 f"{want}")
    print(f"[5] path A: serve_v4_8 kernel_backend=pallas served 1x256², "
          f"8x256², 1x512² in {time.perf_counter() - t0:.2f} s; known pixels "
          f"bit-exact; launches per forward {per_request}")

    # ---- float32: pallas on the card vs xla on the card vs the CPU -------
    f32 = ["model.dtype_policy=f32"]
    dispatch.reset_launches()
    a = load("pallas", f32).inpaint_batch(img1, msk1)
    _require(dispatch.launches.get("gated_conv_direct", 0) == DIRECT_FUSED,
             "float32 pallas forward did not launch the gated-conv kernel")
    b = load("xla", f32).inpaint_batch(img1, msk1)
    frac_x, max_x = _within_one(a, b)
    frac_c, max_c = _within_one(a, cpu_f32)
    print(f"[5] f32 pallas on the card (TF32 off): within ±1 of xla on the "
          f"card on {frac_x:.6f} of pixels (max diff {max_x}), of the CPU on "
          f"{frac_c:.6f} (max diff {max_c})")
    _require(frac_x >= 0.999 and frac_c >= 0.999,
             "f32 pallas output disagrees with xla or the CPU")

    # ---- throughput, 64×256² bf16, the three backend values --------------
    t_c = time.perf_counter()
    imgs = _smooth_images(rng, 64, 256, 256)
    masks = _stroke_masks(rng, 64, 256, 256)
    auto = load("auto")
    rates = _serve_rates(torch, {"pallas": inp, "xla": load("xla"),
                                 "auto[gated=xla]": auto,
                                 "auto[gated=pallas]": auto}, imgs, masks,
                         gated={"auto[gated=xla]": "xla",
                                "auto[gated=pallas]": "pallas"})
    # the timed configuration itself: bf16 through every kernel variant and
    # block width of the 35 layers (WMMA, BN 32 and 64, elu and relu)
    # against the library composition on the same 64 images. bf16 rounding
    # through 35 layers moves single levels, a wrong tile moves many.
    outs = {k: r.pop("output") for k, r in rates.items()}
    _known_exact(outs["pallas"], imgs, masks, "path A 64x256² bf16")
    agree = _hole_agreement(outs["pallas"], outs["xla"], masks)
    print(f"[5] bf16 64x256² pallas vs xla on the card, hole pixels: {agree} "
          f"(tol: within ±{BF16_SERVE_LEVELS} on >= {BF16_SERVE_FRAC})")
    _require(agree[f"within_{BF16_SERVE_LEVELS}"] >= BF16_SERVE_FRAC,
             "path A: the bf16 kernel path disagrees with the library path")
    print("[5] serve 64x256² bf16, device forward ms / img/s (through "
          "inpaint_batch img/s): " + "; ".join(
              f"{k} {r['fwd_ms']:.2f} / {r['fwd_img_s']:.1f} "
              f"({r['api_img_s']:.1f})" for k, r in rates.items())
          + f" | {smi}")
    gain, spread = _decide(rates["auto[gated=xla]"]["fwd_turns_ms"],
                           rates["auto[gated=pallas]"]["fwd_turns_ms"])
    rates["gated_conv_decision"] = dict(
        pallas_gain_ms=gain, spread_ms=spread, gains=gain > spread,
        auto_cuda=dispatch.AUTO_CUDA["gated_conv"])
    print(f"[5] AUTO_CUDA['gated_conv']: the kernels take the forward "
          f"{gain:.2f} ms below the library composition (turns "
          f"{rates['auto[gated=xla]']['fwd_turns_ms']} / "
          f"{rates['auto[gated=pallas]']['fwd_turns_ms']}), spread "
          f"{spread:.2f} ms: {'a gain' if gain > spread else 'no gain'}; "
          f"set to {dispatch.AUTO_CUDA['gated_conv']!r}")
    return total, rates


def _autograd_nodes(root, needle: str) -> int:
    """Nodes of the autograd graph under ``root`` whose name holds
    ``needle``."""
    seen, stack, hits = set(), [root], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        hits += needle in type(node).__name__
        stack.extend(fn for fn, _ in node.next_functions)
    return hits


def partial_family(torch, rng, smi):
    """Phase 6, path B: partialconv256 served and trained on the card."""
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.tools.profile_train import time_steps
    from gan_inpainting_torch.train.step import composite

    name = "partial_epilogue"
    buckets = ["infer.size_buckets=256", "infer.batch_buckets=1,8,64"]

    def cfg_for(backend, extra=()):
        return apply_overrides(get_config("partialconv256"), buckets + [
            f"model.kernel_backend={backend}", *extra])

    cfg = cfg_for("pallas")
    gen = build_generator(cfg.model, device="cuda", seed=0)
    state_dict = gen.state_dict()
    m = cfg.model
    print(f"[6] path B: {cfg.name} {m.generator}/{m.conv_kind} width "
          f"{m.base_features} dtype={m.dtype_policy} params "
          f"{sum(p.numel() for p in gen.parameters())}, seeded "
          f"initialization (the repo holds no trained partial-conv weights)")
    del gen
    inp = Inpainter(cfg, state_dict, device="cuda")
    shapes = {"1x256": (1, 256, 256), "8x256": (8, 256, 256),
              "64x256": (64, 256, 256)}
    data = {k: (_smooth_images(rng, *sh), _stroke_masks(rng, *sh))
            for k, sh in shapes.items()}
    per_request = {}
    t0 = time.perf_counter()
    dispatch.reset_launches()
    for k, (imgs, masks) in data.items():
        before = dispatch.launches.get(name, 0)
        _known_exact(inp.inpaint_batch(imgs, masks), imgs, masks,
                     f"path B {k}")
        per_request[k] = dispatch.launches.get(name, 0) - before
    torch.cuda.synchronize()
    serve_launches = dict(dispatch.launches)
    _require(all(v == PARTIAL_PER_FWD for v in per_request.values())
             and not serve_launches.get("gated_conv_direct", 0),
             f"path B: partial epilogue launches per forward {per_request}, "
             f"expected {PARTIAL_PER_FWD}")
    print(f"[6] served 1x256², 8x256², 64x256² in "
          f"{time.perf_counter() - t0:.2f} s; known pixels bit-exact; "
          f"{name} launches per forward {per_request}")

    # ---- float32 on the card (kernel) vs the CPU (plain), TF32 off -------
    f32 = ["model.dtype_policy=f32"]
    img1, msk1 = data["1x256"]
    a = Inpainter(cfg_for("pallas", f32), state_dict,
                  device="cuda").inpaint_batch(img1, msk1)
    b = Inpainter(cfg_for("pallas", f32), state_dict,
                  device="cpu").inpaint_batch(img1, msk1)
    frac, worst = _within_one(a, b)
    print(f"[6] f32 cuda vs cpu (TF32 off): within ±1 on {frac:.6f} of "
          f"pixels, max diff {worst}")
    _require(frac >= 0.999, "path B f32 card output disagrees with the CPU")

    rates = _serve_rates(torch, {
        "pallas": inp, "xla": Inpainter(cfg_for("xla"), state_dict,
                                        device="cuda")}, *data["64x256"])
    outs = {k: r.pop("output") for k, r in rates.items()}
    agree = _hole_agreement(outs["pallas"], outs["xla"], data["64x256"][1])
    print(f"[6] bf16 64x256² pallas vs xla on the card, hole pixels: {agree} "
          f"(tol: within ±{BF16_SERVE_LEVELS} on >= {BF16_SERVE_FRAC})")
    _require(agree[f"within_{BF16_SERVE_LEVELS}"] >= BF16_SERVE_FRAC,
             "path B: the bf16 kernel path disagrees with the library path")
    print("[6] serve 64x256² bf16, device forward ms / img/s (through "
          "inpaint_batch img/s): " + "; ".join(
              f"{k} {r['fwd_ms']:.2f} / {r['fwd_img_s']:.1f} "
              f"({r['api_img_s']:.1f})" for k, r in rates.items())
          + f" | {smi}")
    del inp
    torch.cuda.empty_cache()

    # ---- 3 train steps, 16×256² bf16, synthetic data, seeded random VGG --
    over = ["data.synthetic_family=textured"]
    cfg, state, step_fn, batches = _train_setup(
        torch, "partialconv256", over + ["model.kernel_backend=pallas"])
    before = [p.detach().clone() for p in state.generator.parameters()]
    n_steps = 3
    dispatch.reset_launches()
    history = [{k: float(v) for k, v in step_fn(state, batches[i % 2]).items()}
               for i in range(n_steps)]
    torch.cuda.synchronize()
    train_launches = dict(dispatch.launches)
    for i, h in enumerate(history):
        _require(all(np.isfinite(v) for v in h.values()),
                 f"path B step {i} metrics not finite: {h}")
        _require(h["g_perceptual"] > 0 and h["g_style"] > 0,
                 f"path B step {i}: VGG losses are zero: {h}")
    # two generator forwards per step (detached for D, then with gradient)
    _require(train_launches.get(name, 0) == 2 * PARTIAL_PER_FWD * n_steps,
             f"path B train: {train_launches.get(name, 0)} launches of {name} "
             f"in {n_steps} steps, expected {2 * PARTIAL_PER_FWD} per step")
    moved = sum((a - b.detach()).abs().sum().item()
                for a, b in zip(before, state.generator.parameters()))
    _require(moved > 0, "path B: generator parameters did not move")
    # the backward goes through the kernel's autograd Function, layer by
    # layer, down to the first conv's weight
    b0 = batches[0]
    out = state.generator(b0.masked, b0.mask)
    nodes = _autograd_nodes(out.fine.grad_fn, "_PartialEpilogue")
    loss = (composite(out.fine, b0.image, b0.mask) - b0.image).abs().mean()
    g0 = torch.autograd.grad(loss, state.generator.body.conv0.weight)[0]
    _require(nodes == PARTIAL_PER_FWD and bool(torch.isfinite(g0).all())
             and g0.abs().max().item() > 0,
             f"path B: {nodes} _PartialEpilogue backward nodes (expected "
             f"{PARTIAL_PER_FWD}) or no gradient at the first conv")
    del out, loss
    _, state_x, step_x, _ = _train_setup(
        torch, "partialconv256", over + ["model.kernel_backend=xla"])
    for i in range(2):
        step_x(state_x, batches[i])
    # taken in turns, A B B A: the step is partly host-bound, and the host
    # drifts between one stretch of steps and the next
    runs = {"pallas": (step_fn, state), "xla": (step_x, state_x)}
    taken = {k: [] for k in runs}
    for k in ("pallas", "xla", "xla", "pallas"):
        taken[k].append(time_steps(*runs[k], batches, 4))
    ms = {k: float(np.mean(v)) for k, v in taken.items()}
    del state, step_fn, runs
    print(f"[6] train {cfg.name} {cfg.data.batch_size}x256² bf16, random VGG "
          f"(seed 7): step 0 {history[0]}; step {n_steps - 1} {history[-1]}; "
          f"launches {train_launches}; {nodes} _PartialEpilogue backward "
          f"nodes; |Δ| G {moved:.4g}; ms/step pallas {ms['pallas']:.1f} "
          f"{taken['pallas']}, xla {ms['xla']:.1f} {taken['xla']}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB | {smi}")
    del state_x, step_x, batches
    torch.cuda.empty_cache()

    # ---- one float32 step, small size: card (kernel) vs CPU (plain) ------
    small = over + ["model.kernel_backend=pallas", "model.dtype_policy=f32",
                    "model.base_features=16", "model.disc_features=16",
                    "data.image_size=64", "data.batch_size=2"]
    _, s_cpu, f_cpu, b_cpu = _train_setup(torch, "partialconv256", small,
                                          device="cpu", n_batches=1)
    _, s_gpu, f_gpu, _ = _train_setup(torch, "partialconv256", small,
                                      n_batches=1)
    b_gpu = type(b_cpu[0])(*(t.cuda() for t in b_cpu[0]))
    dispatch.reset_launches()
    m_cpu = {k: float(v) for k, v in f_cpu(s_cpu, b_cpu[0]).items()}
    m_gpu = {k: float(v) for k, v in f_gpu(s_gpu, b_gpu).items()}
    _require(dispatch.launches.get(name, 0) == 2 * PARTIAL_PER_FWD,
             "path B f32 step: the CPU state launched a kernel, or the card "
             "did not")
    rel = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-3)
              for k in m_cpu)
    gaps = torch.cat([
        (pg.detach().cpu() - pc.detach()).abs().flatten()
        for net in ("generator", "discriminator")
        for pg, pc in zip(getattr(s_gpu, net).parameters(),
                          getattr(s_cpu, net).parameters())])
    within = float((gaps <= 1e-4).float().mean())
    # the first Adam step moves every entry by ±lr (1e-4 for G, 4e-4 for
    # D); the VGG trunk runs in bfloat16 on both devices, so where a
    # gradient is near 0 its sign can differ and the entry lands 2·lr apart
    # (about 0.08 % of the entries in three runs; the limit leaves room)
    print(f"[6] f32 partial step cuda vs cpu (TF32 off, 2x64², width 16, "
          f"bf16 VGG): metrics max rel diff {rel:.3e} (tol 1e-3); parameters "
          f"within 1e-4 on {within:.6f} of entries (tol 0.995), max abs diff "
          f"{gaps.max().item():.3e} (tol 8.1e-4 = 2·lr of D)")
    _require(rel <= 1e-3 and within >= 0.995 and gaps.max().item() <= 8.1e-4,
             "f32 partial train step on the card disagrees with the CPU")
    return dict(serve_launches=serve_launches, train_launches=train_launches,
                rates=rates, train_ms=ms)


def _patch_inputs(torch, seed, b, lq, lk, d, dv, dtype, dead=True):
    """Patch q, unit-norm k, v and an output gradient, made on the card
    from a seed; 70 % of keys valid, with ``dead`` the last sample's
    none."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v, g = randn(b, lq, d), randn(b, lk, d), randn(b, lk, dv), \
        randn(b, lq, dv)
    k = k / k.norm(dim=-1, keepdim=True)
    valid = torch.rand((b, lk), generator=gen, device="cuda") < 0.7
    if dead:
        valid[-1] = False
    return (*(t.to(dtype).contiguous() for t in (q, k, v, g)), valid)


def _patch_kernels(torch, q, k, valid, v, g):
    """All three kernels: (out, lse, dq, dk, dv); the backward from the
    kernel forward's own residuals."""
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        launch_dkv,
        launch_dq,
        launch_fwd,
    )

    out, lse = launch_fwd(q, k, valid, v, 10.0, want_lse=True)
    delta = (g.float() * out.float()).sum(-1)
    dq = launch_dq(q, k, valid, v, g, lse, delta, 10.0)
    dk, dv = launch_dkv(q, k, valid, v, g, lse, delta, 10.0)
    return out, lse, dq, dk, dv


def _patch_errors(torch, q, k, valid, v, g, got, chunk):
    """Each kernel output against the plain versions, computed over chunks
    of query rows: forward and dq are exact per query row, dk and dv are
    the sums over the chunks. → {name: (max abs err, max |reference|)}, the
    forward's lse as an absolute error. 64-bit indexing throughout."""
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        patch_attention_bwd_plain,
        patch_attention_plain,
    )

    out_k, lse_k, dq_k, dk_k, dv_k = got
    kf, vf = k.float(), v.float()
    errs = {n: [0.0, 0.0] for n in ("out", "lse", "dq", "dk", "dv")}
    dk_p = torch.zeros(k.shape, device="cuda")
    dv_p = torch.zeros(v.shape, device="cuda")

    def upd(name, a, ref):
        errs[name][0] = max(errs[name][0], (a.float() - ref).abs().max().item())
        errs[name][1] = max(errs[name][1], ref.abs().max().item())

    for c0 in range(0, q.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        o, lse = patch_attention_plain(q[:, sl].float(), kf, valid, vf,
                                       softmax_scale=10.0, want_lse=True)
        upd("out", out_k[:, sl], o)
        upd("lse", lse_k[:, sl], lse)
        del o, lse
        dq, dk, dv = patch_attention_bwd_plain(
            q[:, sl].float(), kf, valid, vf, out_k[:, sl].float(),
            lse_k[:, sl], g[:, sl].float(), softmax_scale=10.0,
            keep_float=True)
        upd("dq", dq_k[:, sl], dq)
        dk_p += dk
        dv_p += dv
        del dq, dk, dv
    upd("dk", dk_k, dk_p)
    upd("dv", dv_k, dv_p)
    return {n: tuple(e) for n, e in errs.items()}


def _patch_require(errs, f32, what):
    """f32: 2e-4 of the largest reference entry (sums in another order);
    bf16: 2^-7 (forward: p rounded to bf16) and 2^-6 (gradients: p and ds
    rounded to bf16 for their products); lse 1e-3 absolute."""
    for name, (err, ref) in errs.items():
        if name == "lse":
            tol = 1e-3
        else:
            frac = PATCH_F32_TOL_FRAC if f32 else (
                BF16_TOL_FRAC if name == "out" else BWD_BF16_TOL_FRAC)
            tol = frac * max(ref, 1.0)
        _require(err <= tol, f"{what}: {name} max abs err {err:.3e} above "
                             f"{tol:.3e}")


def _patch_bounds(valid, lq, d, dv, elem):
    """(bytes, operations) of each function: inputs read once, outputs
    written once; q·k, p·v, dO·v, ds·k, ds·q, p·dO products over the
    (query, valid key) pairs of this run's data, the only pairs the
    functions need (an invalid key's weight and gradients are 0)."""
    b, lk = valid.shape
    ins = (b * lq * d + b * lk * d + b * lk * dv) * elem + b * lk
    bwd_in = ins + b * lq * dv * elem + 2 * b * lq * 4
    pairs = 2.0 * lq * int(valid.sum().item())
    return {"fwd": (ins + b * lq * dv * elem + b * lq * 4, pairs * (d + dv)),
            "dq": (bwd_in + b * lq * d * elem, pairs * (2 * d + dv)),
            "dkv": (bwd_in + b * lk * (d + dv) * elem,
                    pairs * (2 * d + 2 * dv))}


def _sdpa_yardstick(torch, q, k, valid, v, g):
    """One PyTorch call computing the same attention (never called by the
    port): SDPA over the patches with an additive −1e9 mask, forward and
    autograd backward; it does not zero a row with no valid key, so it is a
    timing only. → (backend, fwd ms, bwd ms), or ("none", None, None)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = torch.where(valid, 0.0, -1e9).to(q.dtype)[:, None, None, :]
    qs, ks, vs = (t[:, None] for t in (q, k, v))
    runs = []
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                               scale=10.0)
            runs.append(be.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    if not runs:
        return "none", None, None
    picked = "?"
    try:    # the backend PyTorch's dispatcher picks for this call
        choice = int(torch._fused_sdp_choice(qs, ks, vs, mask, 0.0, False,
                                             scale=10.0))
        picked = next((name for name, be in SDPBackend.__members__.items()
                       if int(be.value) == choice), picked)
    except (AttributeError, TypeError, RuntimeError):
        pass
    fwd = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, scale=10.0), 2)
    leaves = [t.detach().requires_grad_(True) for t in (qs, ks, vs)]
    y = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=10.0)
    gy = g[:, None]
    bwd = _time_ms(torch, lambda: torch.autograd.grad(
        y, leaves, gy, retain_graph=True), 2)
    del y, leaves
    return f"{picked}; runs: {'/'.join(runs)}", fwd, bwd


def check_patch_kernels(torch, smi):
    """Phase 2, patch attention: the forward, dQ and dK/dV kernels against
    their plain versions at the full widths (d 1728, dv 3072) at L 4096 B 8
    (the 512² train shape), L 16 384 and, over chunks of query rows,
    L 65 536 (bf16); the forward at L 4096 B 64 (the 512² serve bucket); the bf16
    kernels at ragged shapes; an odd shape; an f ≠ b map;
    each with a sample that has no valid key; times at L 16 384 (kernel,
    plain, SDPA) and L 65 536 (kernel) with every sample live, bounds from
    the shapes and the valid keys."""
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.ops.contextual_attention import (
        _attention_inputs,
        _fold,
        contextual_attention,
    )
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        launch_dkv,
        launch_dq,
        launch_fwd,
        patch_attention,
        patch_attention_bwd,
        patch_attention_bwd_plain,
        patch_attention_plain,
        plan,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    d, dv = 9 * 192, 16 * 192
    dispatch.reset_launches()
    res = {}
    t0 = time.perf_counter()
    # ---- correctness: full widths at L 4096 (the 8×512² train step),
    # L 16 384, L 65 536, odd, f ≠ b ----------------------------------------
    for dtype in (f32, bf16):
        for name, (b, lq) in (("L4096", (8, 4096)), ("L16384", (2, 16384)),
                              ("L65536", (2, 65536)), ("odd", (2, 1000))):
            if name == "L65536" and dtype == f32:
                # float32 runs no 2048² path (its CUDA-core kernels are
                # held at L 4096 and 16 384): cut to keep the script
                # inside its time limit
                continue
            dd, ddv = (36, 64) if name == "odd" else (d, dv)
            q, k, v, g, valid = _patch_inputs(torch, lq + len(name), b, lq,
                                              lq, dd, ddv, dtype)
            got = _patch_kernels(torch, q, k, valid, v, g)
            torch.cuda.synchronize()
            for t in (got[0], got[2], got[3], got[4]):
                _require(t[-1].abs().max().item() == 0.0
                         and bool(torch.isfinite(t.float()).all()),
                         f"patch {name} {dtype}: the sample with no valid "
                         "key is not exactly 0")
            errs = _patch_errors(torch, q, k, valid, v, g, got,
                                 4096 if lq > 16384 else lq)
            _patch_require(errs, dtype == f32, f"patch {name} {dtype}")
            res[f"{name}_{str(dtype)[6:]}"] = errs
            print(f"[2] patch attention {name} B={b} L={lq} d={dd} dv={ddv} "
                  f"{str(dtype)[6:]}: max abs err / max|ref| " + ", ".join(
                      f"{n} {e:.3e}/{r:.3g}" for n, (e, r) in errs.items())
                  + f" ({plan(dd, ddv, dtype)})")
            del q, k, v, g, valid, got
            torch.cuda.empty_cache()
    # the bf16 forward at the 512² serve bucket's largest batch (B 64,
    # L 4096, d 1728, dv 3072) as the serve route calls it, without lse;
    # the plain version over chunks of 16 samples, the dead sample 0
    q, k, v, _, valid = _patch_inputs(torch, 64, 64, 4096, 4096, d, dv, bf16)
    o = patch_attention(q, k, valid, v, softmax_scale=10.0)
    torch.cuda.synchronize()
    err = ref = 0.0
    for s0 in range(0, 64, 16):
        sl = slice(s0, s0 + 16)
        o_p = patch_attention_plain(q[sl].float(), k[sl].float(), valid[sl],
                                    v[sl].float(), softmax_scale=10.0)
        err = max(err, (o[sl].float() - o_p).abs().max().item())
        ref = max(ref, o_p.abs().max().item())
        del o_p
    tol = BF16_TOL_FRAC * max(ref, 1.0)
    _require(err <= tol and o[-1].abs().max().item() == 0.0
             and bool(torch.isfinite(o.float()).all()),
             f"patch forward B=64 L=4096 bf16: err {err:.3e} above {tol:.3e}"
             " or the sample with no valid key is not 0")
    res["serve512_B64_L4096_bfloat16"] = {"out": (err, ref)}
    print(f"[2] patch attention forward B=64 L=4096 d={d} dv={dv} bf16 (the "
          f"512² serve bucket): max abs err / max|ref| out {err:.3e}/"
          f"{ref:.3g} ({plan(d, dv, bf16)})")
    del q, k, v, valid, o
    torch.cuda.empty_cache()
    # the bf16 kernels where L is ragged against their 64-row tiles and
    # 128-column steps and d, dv against their 64-wide units (dv 300 is
    # padded to 304 for the tensor maps): out, lse and the gradients, the
    # dead sample exactly 0
    for b, lq in ((3, 1000), (1, 4097)):
        q, k, v, g, valid = _patch_inputs(torch, lq, b, lq, lq, 200, 300,
                                          bf16, dead=b > 1)
        o, lse = launch_fwd(q, k, valid, v, 10.0, want_lse=True)
        o_p, lse_p = patch_attention_plain(q.float(), k.float(), valid,
                                           v.float(), softmax_scale=10.0,
                                           want_lse=True)
        err = (o.float() - o_p).abs().max().item()
        ref = o_p.abs().max().item()
        err_lse = (lse - lse_p).abs().max().item()
        _require(err <= BF16_TOL_FRAC * max(ref, 1.0) and err_lse <= 1e-3
                 and (b == 1 or (o[-1].abs().max().item() == 0.0
                                 and lse[-1].abs().max().item() == 0.0)),
                 f"patch forward B={b} L={lq} d=200 dv=300: err {err:.3e}, "
                 f"lse err {err_lse:.3e}")
        # the wgmma dQ and dK/dV from this forward's out and lse (the
        # 128-column steps and 64-row tiles ragged on both sides)
        delta = (g.float() * o.float()).sum(-1)
        got = (launch_dq(q, k, valid, v, g, lse, delta, 10.0),
               *launch_dkv(q, k, valid, v, g, lse, delta, 10.0))
        want = patch_attention_bwd_plain(
            q.float(), k.float(), valid, v.float(), o.float(), lse,
            g.float(), softmax_scale=10.0, keep_float=True)
        grads = {n: ((a.float() - w).abs().max().item(), w.abs().max().item())
                 for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        _patch_require(grads, False, f"patch backward B={b} L={lq} d=200 "
                                     "dv=300 bf16")
        _require(b == 1 or all(t[-1].abs().max().item() == 0.0
                               for t in got),
                 f"patch backward B={b} L={lq}: the sample with no valid key "
                 "has gradients")
        res[f"ragged_B{b}_L{lq}_bfloat16"] = {"out": (err, ref),
                                              "lse": (err_lse, 0.0), **grads}
        print(f"[2] patch attention forward and backward B={b} L={lq} "
              f"d=200 dv=300 bf16: max abs err / max|ref| out {err:.3e}/"
              f"{ref:.3g}, lse {err_lse:.3e}, " + ", ".join(
                  f"{n} {e:.3e}/{r:.3g}" for n, (e, r) in grads.items())
              + f" ({plan(200, 300, bf16)}, dq {plan(200, 300, bf16, 'dq')},"
              f" dkv {plan(200, 300, bf16, 'dkv')})")
        del q, k, v, g, valid, o, lse, o_p, lse_p, delta, got, want
    # f ≠ b through the op: a 128² map, rate 2, C 192
    rng = np.random.default_rng(3)
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (2, 128, 128, 192)).astype(np.float32))).cuda()
    hole = torch.from_numpy(_stroke_masks(rng, 2, 128, 128)[..., None]).cuda()
    hole[1] = 1.0
    other = x.flip(1).contiguous()
    for dtype in (f32, bf16):
        dispatch.reset_launches()
        y = contextual_attention(x.to(dtype), other.to(dtype), hole)
        n = dispatch.launches.get("patch_attention_fwd", 0)
        # the plain attention in float32 on the same patches (in bf16 the
        # normalized keys are rounded by the front end, which moves scores
        # at scale 10 by more than the kernel's error)
        pq, pk, pvalid, pv, _ = _attention_inputs(x.to(dtype),
                                                  other.to(dtype), hole, 3, 2)
        want = _fold(patch_attention_plain(
            pq.float(), pk.float(), pvalid, pv.float(), softmax_scale=10.0),
            x.shape, 2)
        err = (y.float() - want).abs().max().item()
        tol = (F32_TOL if dtype == f32
               else BF16_TOL_FRAC * x.to(dtype).float().abs().max().item())
        _require(n == 1 and err <= tol and y[1].abs().max().item() == 0.0,
                 f"f != b contextual attention ({dtype}): {n} launches, "
                 f"err {err:.3e} (tol {tol:.3e})")
        res[f"f_not_b_{str(dtype)[6:]}"] = err
        print(f"[2] contextual attention f != b, 2x128x128x192 {dtype}: "
              f"patch_attention_fwd launches {n}, max abs err {err:.3e} "
              f"(tol {tol:.3e}), all-hole sample 0")
    del x, other, y, want, pq, pk, pv
    check_s = time.perf_counter() - t0

    # ---- times, bf16: L 16 384 B 2 (kernel, plain, SDPA), L 65 536 B 1;
    # every sample has valid keys -------------------------------------------
    out = {}
    q, k, v, g, valid = _patch_inputs(torch, 7, 2, 16384, 16384, d, dv, bf16,
                                      dead=False)
    o, lse = launch_fwd(q, k, valid, v, 10.0, want_lse=True)
    delta = (g.float() * o.float()).sum(-1)
    ms = {
        "fwd": _time_ms(torch, lambda: patch_attention(
            q, k, valid, v, softmax_scale=10.0), 3),
        "fwd_lse": _time_ms(torch, lambda: launch_fwd(
            q, k, valid, v, 10.0, want_lse=True), 3),
        "dq": _time_ms(torch, lambda: launch_dq(
            q, k, valid, v, g, lse, delta, 10.0), 3),
        "dkv": _time_ms(torch, lambda: launch_dkv(
            q, k, valid, v, g, lse, delta, 10.0), 3),
        "bwd": _time_ms(torch, lambda: patch_attention_bwd(
            q, k, valid, v, o, lse, g, softmax_scale=10.0), 2)}
    plain = {
        "fwd": _time_ms(torch, lambda: patch_attention_plain(
            q, k, valid, v, softmax_scale=10.0), 2),
        "bwd": _time_ms(torch, lambda: patch_attention_bwd_plain(
            q, k, valid, v, o, lse, g, softmax_scale=10.0), 2)}
    backend, lib_fwd, lib_bwd = _sdpa_yardstick(torch, q, k, valid, v, g)
    bounds = _patch_bounds(valid, 16384, d, dv, 2)
    del q, k, v, g, valid, o, lse, delta
    torch.cuda.empty_cache()
    q, k, v, g, valid = _patch_inputs(torch, 8, 1, 65536, 65536, d, dv, bf16,
                                      dead=False)
    o, lse = launch_fwd(q, k, valid, v, 10.0, want_lse=True)
    delta = (g.float() * o.float()).sum(-1)
    big = {
        "fwd": _time_ms(torch, lambda: patch_attention(
            q, k, valid, v, softmax_scale=10.0), 1),
        "dq": _time_ms(torch, lambda: launch_dq(
            q, k, valid, v, g, lse, delta, 10.0), 1),
        "dkv": _time_ms(torch, lambda: launch_dkv(
            q, k, valid, v, g, lse, delta, 10.0), 1)}
    big_bounds = _patch_bounds(valid, 65536, d, dv, 2)
    del q, k, v, g, valid, o, lse, delta
    torch.cuda.empty_cache()
    for kname in ("fwd", "dq", "dkv"):
        n_bytes, n_ops = bounds[kname]
        bound, by = _bound_ms(n_bytes, n_ops, H100_BF16_FLOPS)
        b_bytes, b_ops = big_bounds[kname]
        big_bound, big_by = _bound_ms(b_bytes, b_ops, H100_BF16_FLOPS)
        errs = res["L16384_bfloat16"]
        err = {"fwd": errs["out"], "dq": errs["dq"], "dkv": max(
            errs["dk"], errs["dv"], key=lambda e: e[0] / max(e[1], 1.0))}[
                kname]
        err32 = res["L16384_float32"]
        err32 = {"fwd": err32["out"], "dq": err32["dq"],
                 "dkv": max(err32["dk"], err32["dv"],
                            key=lambda e: e[0] / max(e[1], 1.0))}[kname]
        out[kname] = dict(
            ms=ms[kname], plain_ms=plain["fwd" if kname == "fwd" else "bwd"],
            library_ms=lib_fwd if kname == "fwd" else lib_bwd,
            library=f"SDPA ({backend}), additive mask"
                    + ("" if kname == "fwd" else ", autograd backward: "
                       "dq, dk and dv in one call"),
            bound_ms=bound, bound_by=by, max_abs_err=err[0],
            max_abs_err_of=err[1], max_abs_err_f32=err32[0],
            tflops=n_ops / ms[kname] / 1e9, shape="B2 L16384 d1728 dv3072",
            at_2048_map=dict(ms=big[kname], bound_ms=big_bound,
                             bound_by=big_by,
                             tflops=b_ops / big[kname] / 1e9,
                             shape="B1 L65536 d1728 dv3072"))
    out["fwd"]["with_lse_ms"] = ms["fwd_lse"]
    out["bwd_ms"] = ms["bwd"]
    out["checks"] = res
    print(f"[2] patch attention bf16 ms at B2 L16384 d1728 dv3072: forward "
          f"{ms['fwd']:.2f} (with lse {ms['fwd_lse']:.2f}; plain "
          f"{plain['fwd']:.2f}; SDPA {backend} {lib_fwd}), dq {ms['dq']:.2f}, "
          f"dkv {ms['dkv']:.2f}, whole backward {ms['bwd']:.2f} (plain "
          f"{plain['bwd']:.2f}; SDPA backward {lib_bwd}); bounds " + ", ".join(
              f"{kk} {out[kk]['bound_ms']:.2f} ({out[kk]['tflops']:.1f} "
              f"TFLOP/s)" for kk in ("fwd", "dq", "dkv")) + f" | {smi}")
    print(f"[2] patch attention bf16 ms at B1 L65536 (the 2048² map): "
          + ", ".join(f"{kk} {big[kk]:.1f} (bound "
                      f"{out[kk]['at_2048_map']['bound_ms']:.1f}, "
                      f"{out[kk]['at_2048_map']['tflops']:.1f} TFLOP/s)"
                      for kk in ("fwd", "dq", "dkv"))
          + f"; checks took {check_s:.1f} s | {smi}")
    print("[2] patch backward: the replaced mma.sync kernels took " + ", ".join(
        f"{kk} {PATCH_BWD_REPLACED_MS[kk][0]:.2f} / "
        f"{PATCH_BWD_REPLACED_MS[kk][1]:.1f}" for kk in ("dq", "dkv"))
        + " ms at L16384 B2 / L65536 B1; this run " + ", ".join(
            f"{kk} {ms[kk]:.2f} / {big[kk]:.1f}" for kk in ("dq", "dkv")))
    print(f"[2] patch kernels: launches in these checks and timings (not "
          f"counted for any path): {dict(dispatch.launches)}")
    return out


def compare_routes(torch, smi, maps=((64, 64), (64, 128), (128, 128),
                                    (128, 256), (256, 256))):
    """Phase 2: where both the fused and the patch route hold (B 2, C 192
    maps of L = 1024, 2048, 4096, 8192 and 16 384 cells at rate 2: the 256²
    image, a 256×512 one, the 512² image, a 512×1024 one and the 1024²
    one), time both, forward without gradient
    and forward + backward in bf16, the forward in float32 up to L 4096
    (past its threshold of 2048), taken in turns (fused, patch, patch,
    fused); the route the op takes at every L in both."""
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.ops.contextual_attention import (
        _FusedAttention,
        _patch_route,
        contextual_attention,
    )
    from gan_inpainting_torch.ops.kernels.fold import fold_taps
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        FUSED_MAX_CELLS_BF16_FORWARD,
        FUSED_MAX_CELLS_F32,
        fused_attention_taps,
        fused_supported,
    )
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        bwd_supported,
    )

    rng = np.random.default_rng(4)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for h, w in maps:
            cells = (h // 2) * (w // 2)
            x = torch.relu(torch.from_numpy(rng.standard_normal(
                (2, h, w, 192)).astype(np.float32))).cuda().to(dtype)
            hole = torch.from_numpy(_stroke_masks(rng, 2, h, w)[..., None]) \
                .cuda()
            g = torch.randn(x.shape, device="cuda", dtype=dtype)
            _require(fused_supported(x.shape, 3, 2, x.dtype)
                     and bwd_supported(h // 2, w // 2, 192, x.dtype),
                     f"the fused route should hold at {h}x{w}")

            def fwd(route):
                with torch.no_grad():
                    if route == "patch":
                        return _patch_route(x, x, hole, 3, 2, 10.0)
                    return fold_taps(fused_attention_taps(x, hole),
                                     h // 2, w // 2, 2)

            def train(route):
                leaf = x.detach().requires_grad_(True)
                y = (_FusedAttention.apply(leaf, hole, 3, 2, 10.0)
                     if route == "fused"
                     else _patch_route(leaf, leaf, hole, 3, 2, 10.0))
                y.backward(g)
                return leaf.grad

            # the op's own choice follows the measured thresholds (a
            # forward alone here)
            dispatch.reset_launches()
            with torch.no_grad():
                contextual_attention(x, x, hole)
            took = ("fused" if dispatch.launches.get(
                "contextual_attention_fused") else "patch")
            limit = (FUSED_MAX_CELLS_BF16_FORWARD
                     if dtype == torch.bfloat16 else FUSED_MAX_CELLS_F32)
            _require(took == ("fused" if cells <= limit else "patch"),
                     f"contextual attention took the {took} route at L "
                     f"{cells}")
            with_bwd = dtype == torch.bfloat16
            if not with_bwd and cells > 2 * FUSED_MAX_CELLS_F32:
                # float32 timed where its threshold is decided (the fused
                # forward at L 16 384 takes ≈ 3.7 s a call): cut to keep
                # the script inside its time limit
                continue
            diff = (fwd("fused").float() - fwd("patch").float()).abs().max() \
                .item()
            times = {k: [] for k in ("fused_fwd", "patch_fwd", "fused_train",
                                     "patch_train")}
            for route in ("fused", "patch", "patch", "fused"):
                times[f"{route}_fwd"].append(_time_ms(
                    torch, lambda: fwd(route), 1))
                if with_bwd:
                    times[f"{route}_train"].append(_time_ms(
                        torch, lambda: train(route), 1))
            ms = {k: float(np.mean(v)) for k, v in times.items() if v}
            key = f"{str(dtype)[6:]}_L{cells}"
            out[key] = dict(ms=ms, turns=times, forward_diff=diff,
                            route_taken=took)
            print(f"[2] routes at B2 {h}x{w}x192 (L {cells}) {dtype}: "
                  f"forward fused {ms['fused_fwd']:.2f} vs patch "
                  f"{ms['patch_fwd']:.2f} ms" + (
                      f"; forward + backward fused {ms['fused_train']:.2f} "
                      f"vs patch {ms['patch_train']:.2f} ms" if with_bwd
                      else "") + f"; outputs differ by {diff:.3e}; the op "
                  f"takes the {took} route | {smi}")
            del x, hole, g
            torch.cuda.empty_cache()
    return out


def path_c(torch, rng, smi):
    """Phase 7, path C: large maps. (a) serve the pinned generator at a
    2048² bucket; (b) train places512_deepfill at 1×2048²; (c) the fused
    forward whose backward plan does not hold."""
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.ops.contextual_attention import _FusedAttention
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        fused_supported,
    )
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        bwd_supported,
        contextual_attention_bwd_plain,
    )

    out = {}
    # ---- (a) serve one 1×2048² request, bf16 ------------------------------
    inp = Inpainter.from_npz(NPZ, overrides=[
        "model.fuse_upsample=true", "infer.size_buckets=256,512,2048",
        "infer.batch_buckets=1"], device="cuda")
    imgs = _smooth_images(rng, 1, 2048, 2048)
    masks = _stroke_masks(rng, 1, 2048, 2048)
    dispatch.reset_launches()
    _known_exact(inp.inpaint_batch(imgs, masks), imgs, masks,
                 "path C 1x2048²")
    torch.cuda.synchronize()
    serve_launches = dict(dispatch.launches)
    _require(serve_launches.get("patch_attention_fwd", 0) == 1
             and not serve_launches.get("contextual_attention_fused", 0),
             f"path C serve: launches {serve_launches}, expected one "
             "patch_attention_fwd and no fused attention")
    lat = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inp.inpaint_batch(imgs, masks)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    out["serve_2048_ms"] = lat
    out["serve_launches"] = serve_launches
    print(f"[7] path C serve_v4_8 (pinned tex256_attn) 1x2048² bf16: known "
          f"pixels bit-exact, holes filled; launches {serve_launches}; "
          f"ms per request (host uint8 in/out) {[round(t, 1) for t in lat]} "
          f"| {smi}")
    del inp
    torch.cuda.empty_cache()

    # ---- (b) train places512_deepfill at 1×2048², bf16, 2 steps ----------
    out.update(_path_c_train(torch, smi))
    torch.cuda.empty_cache()

    # ---- (c) fused forward, backward through the patch kernels ---------
    # a float32 344² map at C 32 (hs = ws = 172): the fused forward's core
    # group holds its 29 584 score columns, neither backward kernel's rows.
    # The op itself routes a float32 map this large to the patch route
    # (above FUSED_MAX_CELLS_F32), so the fused route's Function is driven
    # directly.
    x = torch.relu(torch.from_numpy(rng.standard_normal(
        (1, 344, 344, 32)).astype(np.float32))).cuda()
    hole = torch.from_numpy(_stroke_masks(rng, 1, 344, 344)[..., None]).cuda()
    g = torch.randn(x.shape, device="cuda")
    _require(fused_supported(x.shape, 3, 2, x.dtype)
             and not bwd_supported(172, 172, 32, x.dtype),
             "path C (c): the map should hold the fused forward only")
    leaf = x.clone().requires_grad_(True)
    dispatch.reset_launches()
    y = _FusedAttention.apply(leaf, hole, 3, 2, 10.0)
    y.backward(g)
    torch.cuda.synchronize()
    fb_launches = dict(dispatch.launches)
    want = contextual_attention_bwd_plain(x, hole, g)
    err = ((leaf.grad - want).abs().max().item()
           / max(want.abs().max().item(), 1.0))
    fb_launches = {k: v for k, v in fb_launches.items() if v}
    _require(fb_launches == {"contextual_attention_fused": 1,
                             "contextual_attention_fused_core": 1,
                             "fold_taps": 1,
                             "patch_attention_fwd": 1,
                             "patch_attention_bwd_dq": 1,
                             "patch_attention_bwd_dkv": 1},
             f"path C (c): launches {fb_launches}")
    _require(err <= BWD_F32_TOL_FRAC and bool(torch.isfinite(
        leaf.grad).all()), f"path C (c): gradient error {err:.3e}")
    out.update(fallback_launches=fb_launches, fallback_grad_err=err)
    print(f"[7] path C fused forward + patch backward (f32 1x344x344x32): "
          f"launches {fb_launches}; gradient vs plain {err:.3e} of max "
          f"(tol {BWD_F32_TOL_FRAC:g})")
    return out


def _path_c_train(torch, smi):
    """Path C (b): places512_deepfill at 1×2048², bf16, 2 steps from step
    0 — metrics finite, launches per step, parameters moved, the attention
    branch's gradient, ms per step and the peak memory."""
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.train.step import composite

    torch.cuda.reset_peak_memory_stats()
    names = ("patch_attention_fwd", "patch_attention_bwd_dq",
             "patch_attention_bwd_dkv", "contextual_attention_fused")
    per_step = dict(zip(names, (2, 1, 1, 0)))
    cfg, state, step_fn, batches = _train_setup(
        torch, "places512_deepfill", TRAIN_512 + [
            "data.image_size=2048", "data.batch_size=1"])
    before = [p.detach().clone() for p in state.generator.parameters()]
    n_steps = 2
    dispatch.reset_launches()
    history, step_ms = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history.append({k: float(v) for k, v in
                        step_fn(state, batches[i % 2]).items()})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_launches = dict(dispatch.launches)
    for i, h in enumerate(history):
        _require(all(np.isfinite(v) for v in h.values()),
                 f"path C step {i} metrics not finite: {h}")
    for name in names:
        _require(train_launches.get(name, 0) == per_step[name] * n_steps,
                 f"path C train: {train_launches.get(name, 0)} launches of "
                 f"{name} in {n_steps} steps, expected {per_step[name]} per "
                 "step")
    moved = sum((a - b.detach()).float().abs().sum().item()
                for a, b in zip(before, state.generator.parameters()))
    _require(moved > 0, "path C: generator parameters did not move")
    del before
    b0 = batches[0]
    fine = state.generator(b0.masked, b0.mask).fine
    loss = (composite(fine, b0.image, b0.mask) - b0.image).abs().mean()
    branch = list(state.generator.refine_attn_enc.parameters())
    grads = torch.autograd.grad(loss, branch)
    _require(all(bool(torch.isfinite(g_).all()) and g_.abs().max().item() > 0
                 for g_ in grads),
             "path C: the attention branch got no gradient")
    del fine, loss, grads
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(train_step_ms=step_ms, train_launches=train_launches,
               train_peak_gib=peak, metrics_step1=history[-1])
    # phase 14 trains the same state on the same batches over the spatial
    # axis: its reference (left out of the JSON line)
    res["_spatial_ref"] = dict(
        batches=[tuple(t.cpu() for t in b) for b in batches[:n_steps]],
        metrics=history, step_ms=step_ms, peak_gib=peak,
        g_params={k: v.float().cpu() for k, v in
                  state.generator.state_dict().items()})
    print(f"[7] path C train places512_deepfill 1x2048² bf16, 2 steps from "
          f"step 0: metrics finite, step 1 {history[-1]}; launches "
          f"{train_launches}; |Δ| G {moved:.4g}; attention-branch gradient "
          f"nonzero; ms per step {[round(t, 1) for t in step_ms]} (step 0 "
          f"with R1 and cuDNN autotuning); peak memory {peak:.1f} GiB | {smi}")
    del state, step_fn, batches
    return res


def _service_inpainter(inp):
    """The Inpainter as the service sees it, recording per dispatch its
    thread, its size bucket and the kernel launches it made."""
    import threading

    from gan_inpainting_torch.ops import dispatch

    class Recorder:
        cfg, device = inp.cfg, inp.device

        def __init__(self):
            self.dispatches = []

        def warmup(self):
            inp.warmup()

        def inpaint_batch(self, images, masks):
            before = dict(dispatch.launches)
            out = inp.inpaint_batch(images, masks)
            self.dispatches.append(dict(
                thread=threading.current_thread().name,
                batch=images.shape[0], size=images.shape[1],
                launches={k: v - before.get(k, 0)
                          for k, v in dispatch.launches.items()}))
            return out

    return Recorder()


def _closed_loop(call, n_clients, *, items=None, pool=None, seconds=None,
                 keep=True):
    """Closed-loop clients, as ``tools/load_serve.py`` drives the service:
    each of ``n_clients`` threads sends one request, waits for its answer
    and only then sends the next. With ``items``, client k sends items k,
    k + n, ...; with ``pool`` and ``seconds``, it sends pool entries drawn
    by its own seeded generator until the window closes. ``call(item)``
    sends one request and returns its answer. Returns the (item index,
    answer) pairs (answers dropped unless ``keep``), the wall seconds from
    the first send to the last answer, and every request's latency."""
    import threading

    answers, latency, errors = [], [], []
    lock = threading.Lock()

    def client(k):
        pick = np.random.default_rng(k)
        mine = iter(range(k, len(items), n_clients)) if items else None
        try:
            while True:
                if mine is not None:
                    i = next(mine, None)
                    if i is None:
                        return
                    item = items[i]
                else:
                    if time.perf_counter() >= deadline:
                        return
                    i = int(pick.integers(len(pool)))
                    item = pool[i]
                t = time.perf_counter()
                out = call(item)
                dt = time.perf_counter() - t
                with lock:
                    latency.append(dt)
                    answers.append((i, out if keep else None))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    t0 = time.perf_counter()
    deadline = t0 + (seconds or 0.0)
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    _require(not errors and not any(t.is_alive() for t in threads),
             f"closed-loop clients failed: {errors[:3]}")
    return answers, wall, latency


def _percentiles_ms(latency):
    lat = sorted(latency)
    return (1e3 * lat[len(lat) // 2],
            1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))])


def _http_body(image, mask) -> bytes:
    from gan_inpainting_torch.infer.service import _png_encode

    return json.dumps({"image": _png_encode(image), "mask": _png_encode(
        (mask * 255).astype(np.uint8))}).encode()


def _http_post(port, body: bytes):
    """POST one prepared body; (status, response body, headers)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/inpaint", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, None, e.headers


def serving_tier(torch, rng, smi):
    """Phase 8: the serving tier on the card. The pinned generator under
    serve_v4_8's model config and batch and size buckets, full width,
    bf16, behind InpaintService: (1) 16 closed-loop clients, 148 requests
    of three sizes; 256² rates from closed-loop windows at 16 and 64
    clients against inpaint_batch; (2) the HTTP front, 16 closed-loop
    clients; (3) overload; (4) inpaint_dir, an export round trip and
    evaluate with SWD."""
    import pathlib
    import tempfile
    import threading
    import urllib.request

    from PIL import Image

    from gan_inpainting_torch.configs.base import apply_overrides
    from gan_inpainting_torch.infer.batch_files import inpaint_dir
    from gan_inpainting_torch.infer.inpaint import Inpainter, _bucket
    from gan_inpainting_torch.infer.service import (
        InpaintService,
        ServiceOverloadedError,
        _png_decode,
        _png_encode,
        make_http_server,
    )
    from gan_inpainting_torch.io.export import export_generator
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.train.evaluate import evaluate

    def make(n, h, w, n_masks):
        imgs = _smooth_images(rng, n, h, w)
        masks = _stroke_masks(rng, n_masks, h, w)
        return [(imgs[i], masks[i % n_masks]) for i in range(n)]

    reqs = make(128, 256, 256, 16) + make(16, 512, 512, 8) + make(
        4, 200, 240, 4)
    order = rng.permutation(len(reqs))
    reqs = [reqs[i] for i in order]
    pool = [r for r in reqs if r[0].shape[:2] == (256, 256)]

    # warmup() of every bucket runs on the dispatcher thread (cuDNN's tuned
    # plans are per thread); ready() waits for it and raises its error
    inp = Inpainter.from_npz(NPZ, overrides=SERVE_V4_8, device="cuda")
    batch_buckets = inp.cfg.infer.batch_buckets
    rec = _service_inpainter(inp)
    t0 = time.perf_counter()
    service = InpaintService(rec, max_wait_ms=5.0)
    service.ready(timeout=900)
    warm_s = time.perf_counter() - t0
    res = {"warmup_s": warm_s, "batch_buckets": list(batch_buckets),
           "size_buckets": list(inp.cfg.infer.size_buckets)}

    def submit(item):
        return service.submit(*item).result(timeout=600)

    def batches_since(n_before):
        sizes = [d["batch"] for d in rec.dispatches[n_before:]]
        padded = [_bucket(n, batch_buckets) for n in sizes]
        return (sum(sizes) / len(sizes), sum(padded) / len(padded),
                len(sizes))

    # ---- (1) 16 closed-loop clients: 128 x 256², 16 x 512², 4 x 200x240
    rec.dispatches.clear()
    before = service.stats
    dispatch.reset_launches()
    answers, wall, latency = _closed_loop(submit, 16, items=reqs)
    launches = dict(dispatch.launches)
    after = service.stats
    outs = dict(answers)
    stats = {k: after[k] - before[k] for k in ("requests", "dispatches",
                                                "rejected")}
    stats["inflight"] = after["inflight"]
    stats["latency_p50_ms"], stats["latency_p99_ms"] = _percentiles_ms(
        latency)
    _require(stats["requests"] == len(reqs) and len(outs) == len(reqs)
             and stats["inflight"] == 0
             and stats["dispatches"] < len(reqs)
             and len(rec.dispatches) == stats["dispatches"],
             f"service stats {stats}")
    _require(all(d["thread"] == "inpaint-dispatch" for d in rec.dispatches),
             "a dispatch ran outside the dispatcher thread")
    by_bucket = {}
    for d in rec.dispatches:
        acc = by_bucket.setdefault(d["size"], {})
        for k, v in d["launches"].items():
            acc[k] = acc.get(k, 0) + v
    for size in (256, 512):
        for name in ("contextual_attention_fused", "fold_taps"):
            _require(by_bucket.get(size, {}).get(name, 0) > 0,
                     f"service: no {name} launch at the {size}² bucket "
                     f"({by_bucket.get(size)})")
    # against inpaint_batch of the same images, grouped by size (<= 64)
    worst = 1.0
    groups = {}
    for i, (img, _) in enumerate(reqs):
        groups.setdefault(img.shape[:2], []).append(i)
    for idx in groups.values():
        for lo in range(0, len(idx), 64):
            part = idx[lo:lo + 64]
            imgs = np.stack([reqs[i][0] for i in part])
            masks = np.stack([reqs[i][1] for i in part])
            want = inp.inpaint_batch(imgs, masks)
            got = np.stack([outs[i] for i in part])
            keep = np.broadcast_to(masks[..., None] == 0, imgs.shape)
            _require(got.shape == imgs.shape and got.dtype == np.uint8
                     and np.array_equal(got[keep], imgs[keep]),
                     "service: known pixels changed")
            diff = np.abs(got.astype(int) - want.astype(int))[~keep]
            worst = min(worst, float((diff <= BF16_SERVE_LEVELS).mean()))
    _require(worst >= BF16_SERVE_FRAC, f"service vs inpaint_batch: hole "
             f"pixels within ±{BF16_SERVE_LEVELS} on {worst:.6f}")
    mean_batch = stats["requests"] / stats["dispatches"]
    res.update(mixed=dict(requests=len(reqs), clients=16, wall_s=wall,
                          stats=stats, mean_batch=mean_batch,
                          hole_within_2=worst, launches=launches,
                          launches_by_bucket=by_bucket))
    print(f"[8] service (batch buckets {batch_buckets}), 16 closed-loop "
          f"clients, {len(reqs)} requests (128x256², 16x512², 4x200x240) in "
          f"{wall:.2f} s after warmup() on the dispatcher thread "
          f"({warm_s:.1f} s to ready()): {stats['dispatches']} dispatches "
          f"(mean batch {mean_batch:.1f}), p50 "
          f"{stats['latency_p50_ms']:.1f} ms, p99 "
          f"{stats['latency_p99_ms']:.1f} ms; known pixels bit-exact, hole "
          f"pixels within ±{BF16_SERVE_LEVELS} of inpaint_batch on "
          f"{worst:.6f}; launches from the dispatcher thread by bucket "
          f"{by_bucket} | {smi}")

    # ---- 256² rates: closed-loop windows at 16 and 64 clients against
    # inpaint_batch at 64x256², in turns, each window SERVICE_WINDOW_S long
    imgs64 = np.stack([r[0] for r in pool[:64]])
    masks64 = np.stack([r[1] for r in pool[:64]])
    windows = []
    batch_rates = []
    for turn in ("service", "inpaint_batch", "inpaint_batch", "service"):
        if turn == "inpaint_batch":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                inp.inpaint_batch(imgs64, masks64)
            batch_rates.append(8 * 64 / (time.perf_counter() - t0))
            continue
        for clients in (16, 64):
            n_before = len(rec.dispatches)
            answers, wall, latency = _closed_loop(
                submit, clients, pool=pool, seconds=SERVICE_WINDOW_S,
                keep=False)
            mb, padded, n_disp = batches_since(n_before)
            p50, p99 = _percentiles_ms(latency)
            windows.append(dict(clients=clients, requests=len(latency),
                                wall_s=wall, img_s=len(latency) / wall,
                                latency_p50_ms=p50, latency_p99_ms=p99,
                                dispatches=n_disp, mean_batch=mb,
                                mean_padded_batch=padded))
    res.update(rate_256=dict(windows=windows,
                             inpaint_batch_64x256_img_s=batch_rates))
    for c in (16, 64):
        ws = [w for w in windows if w["clients"] == c]
        print(f"[8] 256² InpaintService, {c} closed-loop clients, two "
              f"{SERVICE_WINDOW_S:.0f} s windows (turns service, "
              f"inpaint_batch, inpaint_batch, service): "
              + "; ".join(f"{w['requests']} requests, {w['img_s']:.1f} "
                          f"img/s, p50 {w['latency_p50_ms']:.1f} ms, p99 "
                          f"{w['latency_p99_ms']:.1f} ms, mean batch "
                          f"{w['mean_batch']:.1f} (padded "
                          f"{w['mean_padded_batch']:.1f})" for w in ws)
              + f" | {smi}")
    print(f"[8] inpaint_batch at 64x256², 8 calls per turn: "
          f"{', '.join(f'{v:.1f}' for v in batch_rates)} img/s | {smi}")

    # ---- (2) HTTP: 16 closed-loop clients, two windows, /healthz ---------
    before = service.stats
    server = make_http_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        # bodies encoded before the clock starts: a client encodes its
        # PNGs on its own machine; the server decodes, batches, encodes
        bodies = [_http_body(*r) for r in pool[:32]]
        http_windows = []
        sent = 0
        for _ in range(2):
            d_before = service.stats["dispatches"]
            answers, wall, latency = _closed_loop(
                lambda b: _http_post(port, b), 16, pool=bodies,
                seconds=SERVICE_WINDOW_S)
            d_after = service.stats["dispatches"]
            sent += len(answers)
            _require(all(a[0] == 200 for _, a in answers),
                     f"HTTP: codes {sorted({a[0] for _, a in answers})}")
            for i, (_, payload, _) in answers:
                img, mask = pool[i]
                out = _png_decode(json.loads(payload)["output"])
                keep = np.broadcast_to(mask[..., None] == 0, img.shape)
                _require(out.shape == img.shape
                         and np.array_equal(out[keep], img[keep]),
                         "HTTP: known pixels changed")
            p50, p99 = _percentiles_ms(latency)
            http_windows.append(dict(
                clients=16, requests=len(latency), wall_s=wall,
                img_s=len(latency) / wall, latency_p50_ms=p50,
                latency_p99_ms=p99,
                mean_batch=len(latency) / (d_after - d_before)))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        _require(health.get("ok")
                 and health.get("requests") == before["requests"] + sent,
                 f"/healthz {health}")
        last_out = _png_decode(json.loads(answers[0][1][1])["output"])
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    # the server's PNG work per 256² request, one thread: decode the image
    # and the mask, encode the output
    body = json.loads(bodies[0])
    t0 = time.perf_counter()
    for _ in range(20):
        _png_decode(body["image"]), _png_decode(body["mask"])
    dec_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        _png_encode(last_out)
    enc_ms = (time.perf_counter() - t0) / 20 * 1e3
    res.update(http=dict(windows=http_windows, png_decode_ms=dec_ms,
                         png_encode_ms=enc_ms, healthz=health))
    print(f"[8] HTTP front, 16 closed-loop clients in this process, 256² "
          f"PNG bodies encoded beforehand, two {SERVICE_WINDOW_S:.0f} s "
          f"windows: "
          + "; ".join(f"{w['requests']} requests, {w['img_s']:.1f} img/s, "
                      f"round trip p50 {w['latency_p50_ms']:.1f} ms, p99 "
                      f"{w['latency_p99_ms']:.1f} ms, mean batch "
                      f"{w['mean_batch']:.1f}" for w in http_windows)
          + f"; known pixels bit-exact; the server's PNG work per request, "
          f"one thread: decode image + mask {dec_ms:.2f} ms, encode the "
          f"output {enc_ms:.2f} ms; /healthz {health} | {smi}")

    # ---- (3) overload: max_queue=4 -------------------------------------
    # a service of its own over an Inpainter with two batch buckets, so its
    # dispatcher thread's warmup stays short
    small = Inpainter.from_npz(NPZ, overrides=SERVE_OVERRIDES[:2] + [
        "infer.batch_buckets=1,8"], device="cuda")
    service = InpaintService(small, max_wait_ms=5.0, max_queue=4)
    server = make_http_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        service.ready(timeout=900)
        admitted, rejected = [], 0
        for img, mask in pool[:16]:
            try:
                admitted.append(service.submit(img, mask))
            except ServiceOverloadedError:
                rejected += 1
        for f in admitted:
            f.result(timeout=600)
        _require(rejected >= 1 and len(admitted) >= 4,
                 f"overload in process: {len(admitted)} admitted, "
                 f"{rejected} rejected")
        # four 512² requests fill the window; 16 HTTP posts arrive behind
        big = [r for r in reqs if r[0].shape[0] == 512][:4]
        held = [service.submit(*r) for r in big]
        codes, retry = [], []

        def post(i):
            status, _, headers = _http_post(port, bodies[i])
            codes.append(status)
            retry.append(headers.get("Retry-After"))

        posts = [threading.Thread(target=post, args=(i,)) for i in range(16)]
        for p in posts:
            p.start()
        for p in posts:
            p.join(timeout=600)
        for f in held:
            f.result(timeout=600)
        n429 = codes.count(429)
        _require(n429 >= 1 and set(codes) <= {200, 429} and all(
            r == "1" for c, r in zip(codes, retry) if c == 429),
            f"overload over HTTP: codes {codes}")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    del small
    res.update(overload=dict(in_process_admitted=len(admitted),
                             in_process_rejected=rejected,
                             http_codes=sorted(codes)))
    print(f"[8] overload (max_queue=4, batch buckets 1,8): a burst of 16 in "
          f"process, {len(admitted)} admitted and {rejected} refused with "
          f"ServiceOverloadedError; 16 HTTP posts behind 4 held 512² "
          f"requests: {n429} x 429 (Retry-After: 1), {codes.count(200)} x "
          f"200")

    # ---- (4) inpaint_dir, export round trip, evaluate with SWD ---------
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        for sub in ("images", "masks", "out"):
            (root / sub).mkdir()
        eight = pool[:8]
        for i, (img, mask) in enumerate(eight):
            Image.fromarray(img).save(root / "images" / f"{i}.png")
            Image.fromarray((mask * 255).astype(np.uint8)).save(
                root / "masks" / f"{i}.png")
        t0 = time.perf_counter()
        n = inpaint_dir(inp, root / "images", root / "masks", root / "out")
        dir_s = time.perf_counter() - t0
        got = np.stack([np.asarray(Image.open(root / "out" / f"{i}.png"))
                        for i in range(8)])
        imgs8 = np.stack([r[0] for r in eight])
        masks8 = np.stack([r[1] for r in eight])
        want = inp.inpaint_batch(imgs8, masks8)
        _require(n == 8 and np.array_equal(got, want),
                 "inpaint_dir differs from one inpaint_batch of the same 8")
        path = str(root / "g.npz")
        export_generator(inp.cfg, inp.state_dict, path)
        again = Inpainter.from_npz(path, device="cuda")
        _require(again.cfg == inp.cfg and np.array_equal(
            again.inpaint_batch(imgs8, masks8), want),
            "export round trip (float32 storage) changed the outputs")
    ecfg = apply_overrides(inp.cfg, ["data.num_eval_batches=2"])
    t0 = time.perf_counter()
    ev = evaluate(ecfg, inp.state_dict, device="cuda")
    eval_s = time.perf_counter() - t0
    _require({"psnr", "ssim", "swd_avg", "swd_256", "swd_16"} <= set(ev)
             and all(np.isfinite(v) for v in ev.values()),
             f"evaluate: {ev}")
    res.update(inpaint_dir_s=dir_s, evaluate=ev, evaluate_s=eval_s)
    print(f"[8] inpaint_dir over 8 PNGs bit-identical to one inpaint_batch "
          f"({dir_s:.2f} s with PNG I/O); export_generator -> from_npz "
          f"(float32) bit-identical; evaluate with swd, 2 x "
          f"{ecfg.data.eval_batch_size} images, {eval_s:.1f} s: {ev}")
    del inp, again
    return res


def _jpeg_corpus(root, seed=0):
    """CORPUS_FILES JPEGs from one numpy seed: a bicubic colour field from
    a 6×8 grid of random colours, a stripe field and pixel noise."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (CORPUS_FILES, 6, 8, 3), dtype=np.uint8)
    freq = rng.uniform(0.02, 0.2, CORPUS_FILES)
    phase = rng.uniform(0.0, 2 * np.pi, CORPUS_FILES)
    seeds = rng.integers(0, 2 ** 31, CORPUS_FILES)
    yy, xx = np.mgrid[:CORPUS_H, :CORPUS_W].astype(np.float32)

    def one(i):
        img = np.asarray(Image.fromarray(coarse[i]).resize(
            (CORPUS_W, CORPUS_H), Image.BICUBIC), np.float32)
        img = img + 25.0 * np.sin(freq[i] * (xx + 0.5 * yy)
                                  + phase[i])[..., None]
        img += np.random.default_rng(seeds[i]).normal(0.0, 6.0, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / f"{i:06d}.jpg", quality=CORPUS_QUALITY)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(CORPUS_FILES)))


def _decode_rate(data_cfg, threads: int, pil: bool) -> float:
    """Images/s of the folder stream on the host, from the iterator's
    creation to its DECODE_BATCHES-th batch."""
    import contextlib
    import dataclasses
    from unittest import mock

    from gan_inpainting_torch.data import native_loader
    from gan_inpainting_torch.data.loader import make_dataset

    cfg = dataclasses.replace(data_cfg, loader_threads=threads,
                              loader_cache="off")
    force = (mock.patch.object(native_loader, "available", lambda: False)
             if pil else contextlib.nullcontext())
    with force:
        t0 = time.perf_counter()
        it = make_dataset(cfg, seed=0, device="cpu")
        for _ in range(DECODE_BATCHES):
            next(it)
        dt = time.perf_counter() - t0
        it.close()
    return DECODE_BATCHES * cfg.batch_size / dt


def _loop_run(torch, overrides, workdir):
    """train() from step 0 for TURN_STEPS steps; returns (steps/s of the
    windows after the first, the share of those steps' host time spent in
    next(data), the launches)."""
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.train import loop

    cfg = apply_overrides(get_config("places512_deepfill"), overrides + [
        f"train.steps={TURN_STEPS}", f"train.log_every={TURN_LOG}",
        "train.eval_every=1000000", "train.checkpoint_every=1000000",
        "data.num_eval_batches=1", f"train.workdir={workdir}"])
    spans = []
    real = loop.make_dataset

    def timed(*args, **kwargs):
        it = real(*args, **kwargs)

        def gen():
            try:
                while True:
                    t = time.perf_counter()
                    batch = next(it)
                    spans.append((t, time.perf_counter()))
                    yield batch
            finally:
                it.close()
        return gen()

    loop.make_dataset = timed
    dispatch.reset_launches()
    try:
        loop.train(cfg, resume=False, verbose=False, device="cuda")
    finally:
        loop.make_dataset = real
    torch.cuda.synchronize()
    launches = dict(dispatch.launches)
    recs = [json.loads(ln) for ln in
            (workdir / "metrics.jsonl").read_text().splitlines()]
    rates = [r["steps_per_sec"] for r in recs
             if "steps_per_sec" in r and r["step"] > TURN_LOG]
    train_spans = spans[TURN_LOG:TURN_STEPS - 1]
    wait = sum(b - a for a, b in train_spans)
    share = wait / (spans[TURN_STEPS - 1][0] - spans[TURN_LOG][0])
    return rates, share, launches


def file_data(torch, smi):
    """Phase 9: file data and the run's record on the card. A JPEG corpus
    written at run time; decode rates (native libjpeg and PIL, 2 and 4
    decoder threads); train() of places512_deepfill at full width fed
    from the folder (metrics.jsonl, evals, a checkpoint, the sample grid
    in TensorBoard, the attention kernels launched); steps/s fed from the
    folder and from synthetic data in turns, and the share of a step spent
    waiting for data; the resumed stream; the parity fingerprint on the
    card against the committed cuda pins, and the pinned artifacts'
    evaluate; one step under interpret_kernels and one under
    debug_mode."""
    import dataclasses
    import pathlib
    import tempfile

    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.data import native_loader
    from gan_inpainting_torch.data.loader import (
        _load_batch,
        _load_image,
        make_dataset,
        split_files,
    )
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.io.checkpoint import CheckpointManager
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.train.evaluate import evaluate
    from gan_inpainting_torch.train.loop import train as train_loop
    from gan_inpainting_torch.train.parity import (
        PINNED_PATH,
        check_parity,
        run_parity,
    )

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        root = tmp / "corpus"
        root.mkdir()
        t0 = time.perf_counter()
        _jpeg_corpus(root)
        folder = ["data.dataset=folder", f"data.root={root}",
                  f"data.loader_cache_dir={tmp / 'cache'}"]
        cfg = apply_overrides(get_config("places512_deepfill"), folder)
        n_train = len(split_files(cfg.data, "train"))
        n_eval = len(split_files(cfg.data, "eval"))
        _require((n_train, n_eval) == (608, 32), f"split {n_train}/{n_eval}")
        native = native_loader.available()
        print(f"[9] corpus: {CORPUS_FILES} JPEGs {CORPUS_W}x{CORPUS_H} "
              f"q{CORPUS_QUALITY} in {time.perf_counter() - t0:.1f} s "
              f"({n_train} train, {n_eval} eval); decoder for JPEG batches: "
              f"{'native libjpeg (g++ build)' if native else 'PIL'}")

        # ---- decode rates, 512², batch 8 ----------------------------------
        rates = {}
        for pil in ((False, True) if native else (True,)):
            for threads in (2, 4):
                name = f"{'PIL' if pil else 'native'}_{threads}"
                rates[name] = _decode_rate(cfg.data, threads, pil)
        diff = None
        if native:
            files = split_files(cfg.data, "train")[:8]
            nat = _load_batch(files, 512)
            pil_b = np.stack([_load_image(p, 512) for p in files])
            diff = float(np.abs(nat.astype(int) - pil_b.astype(int)).mean())
            _require(diff < 12.0, f"native vs PIL decode mean |Δ| {diff}")
        print(f"[9] decode rate at 512², batch 8, images/s (host, from the "
              f"iterator's start over {DECODE_BATCHES} batches): "
              + ", ".join(f"{k} threads {v:.1f}" for k, v in rates.items())
              + "; native vs PIL mean |Δ| "
              + (f"{diff:.2f} levels (bound 12, tests/unit/"
                 "test_native_loader.py)" if native else
                 "not checked: no native loader (g++ or libjpeg missing)")
              + f" | {smi}")
        res.update(decoder="native" if native else "PIL",
                   decode_img_per_s=rates, native_vs_pil_mean_abs=diff)

        # ---- train() fed from the folder, full width ----------------------
        work = tmp / "run"
        run_cfg = apply_overrides(cfg, [
            "train.steps=6", "train.log_every=2", "train.eval_every=3",
            "train.checkpoint_every=3", "data.num_eval_batches=2",
            f"train.workdir={work}"])
        dispatch.reset_launches()
        t0 = time.perf_counter()
        _, last = train_loop(run_cfg, resume=False, verbose=False,
                             device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(dispatch.launches)
        recs = [json.loads(ln) for ln in
                (work / "metrics.jsonl").read_text().splitlines()]
        logged = [r["step"] for r in recs if "g_loss" in r]
        evals = {r["step"]: r for r in recs if "eval_psnr" in r}
        _require(logged == [2, 4, 6] and sorted(evals) == [3, 6],
                 f"metrics.jsonl steps {logged}, evals {sorted(evals)}")
        _require(all(np.isfinite(r["eval_psnr"]) for r in evals.values())
                 and all(np.isfinite(v) for v in last.values()),
                 f"metrics not finite: {last} {evals}")
        _require(CheckpointManager(str(work)).latest_step() == 6,
                 "no checkpoint at step 6")
        missing = [k for k in FILE_PATH_KERNELS if not launches.get(k)]
        _require(not missing, f"not launched from the folder run: {missing}")
        tb = (work / "tb").exists()
        tb_images = None
        if tb:
            from tensorboard.backend.event_processing.event_accumulator \
                import EventAccumulator

            acc = EventAccumulator(str(work / "tb"),
                                   size_guidance={"images": 0})
            acc.Reload()
            tb_images = acc.Tags()["images"]
            _require(any("samples" in t for t in tb_images)
                     and len(acc.Images(tb_images[0])) == 2,
                     f"sample grids in TensorBoard: {tb_images}")
        print(f"[9] train() places512_deepfill 8x512² bf16 from the folder: "
              f"6 steps, 2 evals (2 x 16 images, a cut), 2 checkpoints, "
              f"{run_s:.1f} s with cuDNN tuning; metrics.jsonl steps "
              f"{logged}, evals {sorted(evals)}: eval_psnr "
              f"{[round(evals[s]['eval_psnr'], 3) for s in sorted(evals)]}; "
              f"TensorBoard {'on, sample grids ' + str(tb_images) if tb else 'off (does not import): metrics.jsonl only'}; "
              f"launches {launches} | {smi}")
        res.update(train_s=run_s, launches=launches, tensorboard=tb,
                   eval_psnr={s: evals[s]["eval_psnr"] for s in evals})

        # ---- the loop fed from the folder and from synthetic data --------
        synthetic = ["data.synthetic_family=textured"]
        turns = {"folder": [], "synthetic": []}
        shares = {"folder": [], "synthetic": []}
        for i, kind in enumerate(("folder", "synthetic", "synthetic",
                                  "folder")):
            rates_, share, _ = _loop_run(
                torch, folder if kind == "folder" else synthetic,
                tmp / f"turn{i}")
            turns[kind] += rates_
            shares[kind].append(share)
        gain, spread = _decide(turns["synthetic"], turns["folder"])
        print(f"[9] train() steps/s at 8x512², windows of {TURN_LOG} steps "
              f"after the first, in turns folder, synthetic, synthetic, "
              f"folder: folder {[round(r, 3) for r in turns['folder']]}, "
              f"synthetic (textured, rendered on the card) "
              f"{[round(r, 3) for r in turns['synthetic']]}; folder "
              f"{'faster' if gain < 0 else 'slower'} by {abs(gain):.3f} "
              f"steps/s, spread {spread:.3f}; share of a step's host time in "
              f"next(data): folder {[round(s, 4) for s in shares['folder']]}"
              f", synthetic {[round(s, 4) for s in shares['synthetic']]} "
              f"| {smi}")
        res.update(steps_per_s=turns, data_wait_share=shares)

        # ---- resume: start=6 is the uninterrupted stream's 7th batch ------
        rdata = dataclasses.replace(cfg.data, loader_cache="on")
        t0 = time.perf_counter()
        it = make_dataset(rdata, seed=0, device="cpu")
        stream = [next(it) for _ in range(7)]
        it.close()
        again = make_dataset(rdata, seed=0, device="cpu", start=6)
        resumed = next(again)
        again.close()
        _require(torch.equal(resumed, stream[6]),
                 "make_dataset(start=6) is not the 7th batch")
        print(f"[9] resume: make_dataset(start=6) equals the uninterrupted "
              f"stream's 7th batch (decode-once cache on, built and read in "
              f"{time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # ---- parity: the fixed-seed fingerprint against the cuda pins -----
    t0 = time.perf_counter()
    par = run_parity(device="cuda")
    par.update(run_parity(["places512_deepfill", "places512_sn_vgg"], 256,
                          device="cuda"))
    pins = json.loads(PINNED_PATH.read_text())
    for key, got in par.items():
        print(f"[9] parity {key}: cuda {got} | pinned cuda "
              f"{pins.get('cuda', {}).get(key)} | pinned cpu "
              f"{pins['cpu'].get(key)}")
    problems = check_parity(par, device="cuda")
    _require(not problems, f"parity drift on the card: {problems}")
    print(f"[9] parity: {len(par)} entries within ±0.1 dB PSNR, 0.005 SSIM, "
          f"2 % SWD of the committed cuda pins ({time.perf_counter() - t0:.1f}"
          f" s) | {smi}")
    res.update(parity=par)
    arts = {}
    for name in ARTIFACTS:
        base = pathlib.Path("docs/artifacts") / name
        inp = Inpainter.from_npz(str(base / "generator_best.npz"),
                                 device="cuda")
        ev = evaluate(inp.cfg, inp.state_dict, device="cuda")
        tpu = json.loads((base / "manifest.json").read_text())[
            "reproduced_from_npz"]
        _require(all(np.isfinite(v) for v in ev.values()), f"{name}: {ev}")
        arts[name] = ev
        print(f"[9] evaluate {name} ({inp.cfg.name}, "
              f"{inp.cfg.data.num_eval_batches} x "
              f"{inp.cfg.data.eval_batch_size} images): "
              f"{ {k: round(v, 4) for k, v in ev.items()} } | TPU-era figure, "
              f"different draws: {tpu} | {smi}")
        del inp
    res.update(artifacts=arts)
    torch.cuda.empty_cache()
    res.update(debug_steps(torch, smi))
    return res


def debug_steps(torch, smi):
    """Phase 9's last part: one places512_deepfill step (8x512², bf16)
    under interpret_kernels against the same step on the kernels, and one
    under debug_mode."""
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.utils.debug import debug_mode, interpret_kernels

    def fresh():
        _, st, fn, bt = _train_setup(torch, "places512_deepfill", TRAIN_512,
                                     n_batches=1)
        st.step = 1                       # no R1 pass
        return st, fn, bt[0]

    def one_step(fn, st, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = {k: float(v) for k, v in fn(st, batch).items()}
        return m, (time.perf_counter() - t) * 1e3

    st, fn, batch = fresh()
    one_step(fn, st, batch)               # cuDNN tunes a fresh process here
    st, fn, batch = fresh()
    m_kernel, ms_kernel = one_step(fn, st, batch)
    st_i, fn_i, _ = fresh()
    dispatch.reset_launches()
    with interpret_kernels():
        m_interp, ms_interp = one_step(fn_i, st_i, batch)
    inside = {k: v for k, v in dispatch.launches.items() if v}
    _require(not inside, f"kernels launched under interpret_kernels: "
             f"{inside}")
    rel = max(abs(m_interp[k] - m_kernel[k]) / max(abs(m_kernel[k]), 1e-2)
              for k in m_kernel)
    _require(rel <= INTERPRET_STEP_TOL,
             f"interpret step vs kernel step: {m_interp} vs {m_kernel}")
    del st_i, fn_i
    with debug_mode():
        m_debug, ms_debug = one_step(fn, st, batch)
    _require(all(np.isfinite(v) for v in m_debug.values()),
             f"debug step: {m_debug}")
    print(f"[9] one 8x512² bf16 step: kernels {ms_kernel:.1f} ms; under "
          f"interpret_kernels (every kernel's mirror, 0 launches) "
          f"{ms_interp:.1f} ms, metrics within {rel:.2e} of the kernel "
          f"step's (tol {INTERPRET_STEP_TOL}); under debug_mode (NaN check "
          f"per op, anomaly detection) {ms_debug:.1f} ms, nothing raised "
          f"| {smi}")
    del st, fn, batch
    torch.cuda.empty_cache()
    return dict(step_ms={"kernels": ms_kernel, "interpret": ms_interp,
                         "debug_mode": ms_debug}, interpret_rel=rel)


# ---------------------------------------------------------------------------
# phase 10: path F, data parallelism
# ---------------------------------------------------------------------------

# (a) the train command under torchrun and without it: steps, logged every
# DP_LOG (the windows after the first carry no R1 pass and no tuning); the
# eval batch is a train batch, so that it needs no cuDNN tuning of its own
DP_STEPS, DP_LOG = 6, 2
DP_TRAIN = ["data.synthetic_family=textured", "data.num_eval_batches=1",
            "data.eval_batch_size=8"]
# (b) the float32 steps at 256² images (full width; the 512² map's float32
# tuning and patch route took minutes of the phase), bf16 at 512²
DP_F32 = TRAIN_512 + ["model.dtype_policy=f32", "data.image_size=256"]
# (b) the f32 2-rank steps against one process on the whole batch: the
# metrics within F32_DP_METRIC_REL (relative), and the parameters within
# F32_DP_PARAM_ATOL on at least F32_DP_PARAM_FRAC of the entries, none
# further apart than two Adam steps can move them (2 · 2 · the larger lr:
# where a gradient is near 0, its rounding noise decides the direction of
# the update, as in phase 4)
F32_DP_METRIC_REL, F32_DP_PARAM_ATOL, F32_DP_PARAM_FRAC = 1e-3, 1e-5, 0.999
# (c) two replicas serve 256² only: two buckets to warm per replica thread
DP_SERVE = ["model.fuse_upsample=true", "infer.size_buckets=256",
            "infer.batch_buckets=8,64"]


def _dp_command(torch, workdir, torchrun: bool):
    """The train command for DP_STEPS steps: the user's command line under
    ``torchrun --nproc-per-node 1`` (a process of its own), or train() of
    the same config in this process, alone (its cuDNN plans tuned by the
    phases before). Returns (the command's stdout, the metrics.jsonl
    records, the steps/s of the windows after the first)."""
    import os

    overrides = DP_TRAIN + [
        f"train.steps={DP_STEPS}", f"train.log_every={DP_LOG}",
        f"train.eval_every={DP_STEPS}", f"train.checkpoint_every={DP_STEPS}",
        f"train.workdir={workdir}"]
    out = ""
    if torchrun:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "gan_inpainting_torch", "train",
               "--config", "places512_deepfill"] + overrides
        res = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
            __file__)), capture_output=True, text=True, timeout=600)
        _require(res.returncode == 0, f"{' '.join(cmd[:8])} ... exited "
                 f"{res.returncode}: {res.stderr[-3000:]}")
        out = res.stdout
    else:
        from gan_inpainting_torch.configs.base import (
            apply_overrides,
            get_config,
        )
        from gan_inpainting_torch.train.loop import train as train_loop

        train_loop(apply_overrides(get_config("places512_deepfill"),
                                   overrides),
                   resume=False, verbose=False, device="cuda")
    recs = [json.loads(ln) for ln in
            (workdir / "metrics.jsonl").read_text().splitlines()]
    rates = [r["steps_per_sec"] for r in recs
             if "steps_per_sec" in r and r["step"] > DP_LOG]
    return out, recs, rates


def _dp_gap(torch, state) -> float:
    """The largest difference of any rank's state from rank 0's, over
    parameters, spectral vectors, both Adams (their step counters too)
    and the EMA: 0.0 where every rank holds it bit for bit."""
    import torch.distributed as dist

    from gan_inpainting_torch.parallel.sharding import _state_tensors

    mine = torch.cat([t.reshape(-1).float().to(state.device)
                      for t in _state_tensors(
                          (state.generator, state.discriminator),
                          (state.g_opt, state.d_opt), state.g_ema.values())])
    ref = mine.clone()
    dist.broadcast(ref, 0)
    gap = torch.tensor([0.0 if torch.equal(ref, mine) else max(
        (ref - mine).abs().max().item(), 1e-30)])
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return gap.item()


def _dp_identical(torch, state) -> bool:
    """Whether every rank holds rank 0's state bit for bit."""
    return _dp_gap(torch, state) == 0.0


def _dp_batches(torch, cfg, n):
    """n fixed global batches, made on the CPU from seeds (every process
    makes the same ones)."""
    from gan_inpainting_torch.data.loader import make_dataset
    from gan_inpainting_torch.data.pipeline import make_train_batch
    from gan_inpainting_torch.utils.rng import STREAM_MASKS, stream_generator

    data = make_dataset(cfg.data, seed=0, device="cpu")
    return [make_train_batch(next(data),
                             stream_generator(0, STREAM_MASKS, i), cfg.mask)
            for i in range(n)]


def _gloo_rank(rank, tmp, jobs):
    """One of two gloo ranks sharing cuda:0: ``jobs(torch, rank, tmp)``
    inside a group this worker sets up, its result pickled."""
    import os
    import pathlib
    import pickle

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import torch
    import torch.distributed as dist

    tmp = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}",
                            rank=rank, world_size=2)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        pickle.dump(jobs(torch, rank, tmp),
                    open(tmp / f"rank{rank}.pkl", "wb"))
    except BaseException:
        import traceback

        (tmp / f"error{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _spawn_gloo(torch, tmp, jobs, while_running, timeout=900):
    """Two gloo ranks running ``jobs``, and ``while_running()`` in this
    process meanwhile; returns (its result, the ranks' results)."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp), jobs))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        mine = while_running()
    finally:
        for p in procs:
            p.join(timeout=timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
    errors = [f.read_text()[-3000:] for f in tmp.glob("error*.txt")]
    _require(not alive and not errors
             and all(p.exitcode == 0 for p in procs),
             f"gloo ranks: alive {alive}, exit codes "
             f"{[p.exitcode for p in procs]}, {errors}")
    return mine, [pickle.load(open(tmp / f"rank{r}.pkl", "rb"))
                  for r in range(2)]


def _dp_rank_jobs(torch, rank, tmp):
    import dataclasses

    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.data.pipeline import Batch
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.parallel.sharding import reduce_metrics
    from gan_inpainting_torch.train.loop import train as train_loop
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    out = {}
    for kind in ("f32", "bf16"):
        batches = torch.load(tmp / f"batches_{kind}.pt", weights_only=False)
        cfg = apply_overrides(get_config("places512_deepfill"),
                              DP_F32 if kind == "f32" else TRAIN_512)
        state = create_state(cfg, device="cuda:0")
        step = make_train_step(cfg)
        same, metrics = [_dp_identical(torch, state)], []
        for b in batches:
            half = Batch(*(t[4 * rank:4 * rank + 4].cuda() for t in b))
            metrics.append(reduce_metrics(step(state, half)))
            same.append(_dp_identical(torch, state))
        res = dict(identical=same, metrics=metrics)
        if kind == "f32" and rank == 0:
            while not (tmp / "f32_ref.pt").exists():     # the parent's
                time.sleep(0.5)
            ref = torch.load(tmp / "f32_ref.pt", weights_only=True)
            sd = state.state_dict()
            gaps = torch.cat([(sd[p][k].cpu() - v).abs().flatten()
                              for p in ("g_params", "d_params", "g_ema")
                              for k, v in ref[p].items()])
            res.update(param_max=gaps.max().item(),
                       param_frac=(gaps <= F32_DP_PARAM_ATOL).float()
                       .mean().item())
        out[kind] = res
        del state, step
        torch.cuda.empty_cache()

    # train() over both ranks: 4 steps with an eval and a checkpoint, then
    # resumed to 5
    torch.cuda.reset_peak_memory_stats()
    cfg = apply_overrides(get_config("places512_deepfill"), DP_TRAIN + [
        "train.steps=4", "train.log_every=2", "train.eval_every=4",
        "train.checkpoint_every=4", f"train.workdir={tmp / 'run'}"])
    dispatch.reset_launches()
    t0 = time.perf_counter()
    state, scalars = train_loop(cfg, resume=False, verbose=False,
                                device="cuda:0")
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = dict(dispatch.launches)
    out["scalars"] = scalars
    out["identical_after_train"] = _dp_identical(torch, state)
    del state
    more = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              steps=5))
    state, _ = train_loop(more, resume=True, verbose=False, device="cuda:0")
    out["resumed_step"] = state.step
    out["identical_after_resume"] = _dp_identical(torch, state)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _dp_torchrun(torch, tmp, smi):
    """Phase 10 (a): the train command over one NCCL rank through torchrun,
    its record, and steps/s beside train() alone in this process, in
    turns."""
    turns = {"torchrun": [], "alone": []}
    t_all = time.perf_counter()
    # two runs, so that the whole script stays inside its time limit
    for i, kind in enumerate(("torchrun", "alone")):
        t0 = time.perf_counter()
        out, recs, rates = _dp_command(torch, tmp / f"a{i}",
                                       kind == "torchrun")
        turns[kind].append(rates)
        if i == 0:
            wall = time.perf_counter() - t0
            logged = [r for r in recs if "g_loss" in r]
            evals = [r["step"] for r in recs if "eval_psnr" in r]
            _require("backend nccl" in out and "over 1 rank" in out,
                     f"torchrun run: no NCCL group in {out[-2000:]}")
            _require([r["step"] for r in logged] == list(
                range(DP_LOG, DP_STEPS + 1, DP_LOG)) and evals == [
                DP_STEPS], f"torchrun record: steps "
                f"{[r['step'] for r in logged]}, evals {evals}")
            _require(all(r["world_size"] == 1
                         and r["grad_all_reduces"] == 2 * r["step"]
                         for r in logged),
                     f"NCCL gradient reduces: {logged}")
            _require((tmp / "a0" / "checkpoints" /
                      f"step_{DP_STEPS}.pt").exists(),
                     "torchrun run: no checkpoint")
            grid = (tmp / "a0" / "tb").exists()
            print(f"[10] (a) torchrun --nproc-per-node 1 -m "
                  f"gan_inpainting_torch train --config "
                  f"places512_deepfill (8x512² bf16, {DP_STEPS} steps, "
                  f"1 eval): NCCL group of 1, gradient all-reduces "
                  f"{[r['grad_all_reduces'] for r in logged]} at steps "
                  f"{[r['step'] for r in logged]} (2 per step), "
                  f"metrics.jsonl, eval_psnr "
                  f"{[round(r['eval_psnr'], 3) for r in recs if 'eval_psnr' in r]}, "
                  f"checkpoint step_{DP_STEPS}, TensorBoard sample grid "
                  f"{'written' if grid else 'off (does not import)'}; "
                  f"{wall:.1f} s with start-up and cuDNN tuning | {smi}")
    flat = {k: [r for rates in v for r in rates] for k, v in turns.items()}
    gain, spread = _decide(flat["alone"], flat["torchrun"])
    print(f"[10] (a) steps/s at 8x512², windows of {DP_LOG} steps after "
          f"the first, in turns torchrun, alone (train() in this "
          f"process) ({time.perf_counter() - t_all:.1f} s for the two "
          f"runs): "
          f"torchrun {[round(r, 3) for r in flat['torchrun']]}, alone "
          f"{[round(r, 3) for r in flat['alone']]}; torchrun "
          f"{'faster' if gain < 0 else 'slower'} by {abs(gain):.3f} "
          f"steps/s, spread {spread:.3f} (no gain claimed) | {smi}")
    return dict(steps_per_s=flat, wall_s=wall)


def _dp_gloo(torch, tmp, smi):
    """Phase 10 (b): two gloo ranks sharing cuda:0 through the port's step
    and train(): bit-identical ranks, float32 parity with one process on
    the whole batch, a resumed run."""
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False    # as main() and the
    torch.backends.cudnn.allow_tf32 = False          # ranks have them
    torch.save(_dp_batches(torch, apply_overrides(
        get_config("places512_deepfill"), TRAIN_512), 2),
        tmp / "batches_bf16.pt")
    cfg = apply_overrides(get_config("places512_deepfill"), DP_F32)
    batches = _dp_batches(torch, cfg, 2)
    torch.save(batches, tmp / "batches_f32.pt")
    t0 = time.perf_counter()

    def reference():
        # while the ranks start: rank 0 waits for its file
        state = create_state(cfg, device="cuda:0")
        step = make_train_step(cfg)
        one = [{k: float(v) for k, v in step(
            state, type(b)(*(t.cuda() for t in b))).items()}
            for b in batches]
        sd = state.state_dict()
        torch.save({p: {k: v.cpu() for k, v in sd[p].items()}
                    for p in ("g_params", "d_params", "g_ema")},
                   tmp / "f32_ref.part")
        (tmp / "f32_ref.part").rename(tmp / "f32_ref.pt")
        del state, step, sd
        torch.cuda.empty_cache()
        return one, time.perf_counter() - t0

    (one, ref_s), ranks = _spawn_gloo(torch, tmp, _dp_rank_jobs, reference)
    b_s = time.perf_counter() - t0
    r0, r1 = ranks
    for kind in ("f32", "bf16"):
        _require(all(r0[kind]["identical"]) and all(
            r1[kind]["identical"]),
            f"{kind}: ranks differ after a step: "
            f"{r0[kind]['identical']}")
        _require(r0[kind]["metrics"] == r1[kind]["metrics"],
                 f"{kind}: the reduced metrics differ between ranks")
    rel = max(abs(m[k] - w[k]) / max(abs(w[k]), 1e-3)
              for m, w in zip(r0["f32"]["metrics"], one) for k in w)
    lr = max(cfg.train.g_lr, cfg.train.d_lr)
    f32 = r0["f32"]
    print(f"[10] (b) places512_deepfill full width, global batch 8 as "
          f"2 gloo ranks x 4 on cuda:0, 2 steps on fixed batches: ranks' "
          f"parameters, spectral vectors, Adam states and EMA "
          f"bit-identical after each step, bf16 at 512² and f32 at 256²; "
          f"f32 against one process on the 8 images (run beside the "
          f"ranks, {ref_s:.1f} s): "
          f"metrics max rel diff {rel:.3e} "
          f"(tol {F32_DP_METRIC_REL}), parameters max abs diff "
          f"{f32['param_max']:.3e} (bound {4 * lr:.1e}), "
          f"{100 * f32['param_frac']:.4f} % within "
          f"{F32_DP_PARAM_ATOL} (need {100 * F32_DP_PARAM_FRAC} %) "
          f"| {smi}")
    _require(rel <= F32_DP_METRIC_REL
             and f32["param_max"] <= 4 * lr
             and f32["param_frac"] >= F32_DP_PARAM_FRAC,
             "f32 2-rank steps disagree with one process")
    recs = [json.loads(ln) for ln in
            (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in recs if "g_loss" in r]
    evals = [r["step"] for r in recs if "eval_psnr" in r]
    _require(steps == [2, 4, 5] and evals == [4, 5]
             and all(r["world_size"] == 2 for r in recs if "g_loss" in r),
             f"2-rank train() record: steps {steps}, evals {evals}")
    _require(all(r["resumed_step"] == 5 and r["identical_after_train"]
                 and r["identical_after_resume"] for r in ranks),
             "2-rank train() did not resume to step 5 bit-identical")
    missing = [k for k in FILE_PATH_KERNELS
               if not all(r["launches"].get(k) for r in ranks)]
    _require(not missing, f"path F: not launched on every rank: "
             f"{missing}")
    print(f"[10] (b) train() over the 2 ranks: 4 steps, an eval and a "
          f"checkpoint, then resumed to step 5 (record written once, "
          f"by rank 0: steps {steps}, evals {evals}); per rank peak "
          f"memory {[round(r['peak_gib'], 2) for r in ranks]} GiB, "
          f"steps/s {[round(r['scalars']['steps_per_sec'], 3) for r in ranks]} "
          f"(gloo stages every reduce through the host: a check, not a "
          f"rate of NCCL); launches per rank "
          f"{[{k: r['launches'].get(k, 0) for k in FILE_PATH_KERNELS} for r in ranks]}; "
          f"{b_s:.1f} s with spawn and cuDNN tuning | {smi}")
    return dict(f32_metric_rel=rel, f32_param_max=f32["param_max"],
                f32_reference_s=ref_s,
                f32_param_frac=f32["param_frac"],
                peak_gib=[r["peak_gib"] for r in ranks],
                steps_per_s=[r["scalars"]["steps_per_sec"] for r in ranks],
                launches=[r["launches"] for r in ranks], wall_s=b_s)


def _dp_serve(torch, rng, smi):
    """Phase 10 (c): an Inpainter over two replicas on cuda:0, and
    InpaintService over it, against one replica."""
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.infer.service import InpaintService

    t_c = time.perf_counter()
    imgs = _smooth_images(rng, 64, 256, 256)
    masks = _stroke_masks(rng, 64, 256, 256)
    one = Inpainter.from_npz(NPZ, overrides=DP_SERVE, device="cuda:0")
    two = Inpainter.from_npz(NPZ, overrides=DP_SERVE,
                             devices=["cuda:0", "cuda:0"])
    out1 = one.inpaint_batch(imgs, masks)
    out2 = two.inpaint_batch(imgs, masks)
    _known_exact(out2, imgs, masks, "two replicas")
    agree = _hole_agreement(out2, out1, masks)
    _require(agree[f"within_{BF16_SERVE_LEVELS}"] >= BF16_SERVE_FRAC,
             f"two replicas vs one: {agree}")
    rates = {"one": [], "two": []}
    for kind in ("one", "two", "two", "one"):
        inp = one if kind == "one" else two
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            inp.inpaint_batch(imgs, masks)
        torch.cuda.synchronize()
        rates[kind].append(3 * 64 / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    service = InpaintService(two, max_wait_ms=5.0)
    try:
        service.ready(timeout=600)
        warm_s = time.perf_counter() - t0
        futs = [service.submit(imgs[i], masks[i]) for i in range(16)]
        served = np.stack([f.result(timeout=600) for f in futs])
    finally:
        service.close()
    _known_exact(served, imgs[:16], masks[:16], "service over two replicas")
    s_agree = _hole_agreement(served, out1[:16], masks[:16])
    _require(s_agree[f"within_{BF16_SERVE_LEVELS}"] >= BF16_SERVE_FRAC,
             f"service over two replicas vs one replica: {s_agree}")
    print(f"[10] (c) Inpainter over 2 replicas on cuda:0 (tex256_attn npz, "
          f"64x256² bf16, 32 per replica thread): known pixels bit-exact, "
          f"hole pixels within ±{BF16_SERVE_LEVELS} of one replica's on "
          f"{agree[f'within_{BF16_SERVE_LEVELS}']:.6f} (max {agree['max']}); "
          f"InpaintService over it: warm-up of 2 buckets on each replica's "
          f"thread {warm_s:.1f} s, 16 requests within ±{BF16_SERVE_LEVELS} on "
          f"{s_agree[f'within_{BF16_SERVE_LEVELS}']:.6f}; inpaint_batch "
          f"img/s in turns one, two, two, one: one replica "
          f"{[round(r, 1) for r in rates['one']]}, two on the same card "
          f"{[round(r, 1) for r in rates['two']]} (one card: no gain "
          f"claimed); {time.perf_counter() - t_c:.1f} s | {smi}")
    two.close()
    del one, two
    torch.cuda.empty_cache()
    return dict(hole_agreement=agree, service_agreement=s_agree,
                img_per_s=rates, service_warmup_s=warm_s)


def data_parallel(torch, rng, smi):
    """Phase 10, path F: (a) torchrun, (b) gloo ranks on one card, (c) two
    serving replicas on one card."""
    import pathlib
    import tempfile

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["a"] = _dp_torchrun(torch, pathlib.Path(tmp), smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res["b"] = _dp_gloo(torch, pathlib.Path(tmp), smi)
    torch.cuda.empty_cache()
    res["c"] = _dp_serve(torch, rng, smi)
    return res


# phase 11: the serve_v4_8 buckets whose start-up the artifact and the live
# Inpainter are held to, each in a fresh process (the 1-image and the full
# bucket at 256², one image at 512²); the patch route's bucket
AOT_START_BUCKETS = ((1, 256), (64, 256), (1, 512))
AOT_PATCH_BUCKET = (1, 2048)
# kernels counted per forward through an exported program, by case
AOT_KERNELS = ("contextual_attention_fused", "fold_taps", "gated_conv_direct",
               "gated_matmul", "partial_epilogue", "patch_attention_fwd")
# phase 11's rates, artifact against live in turns: img/s at 64×256² over a
# window of at least this many seconds, and the 1×256² latency over this
# many requests
AOT_RATE_WINDOW_S = 1.5
AOT_LATENCY_REQUESTS = 50


def _aot_start(kind: str, path: str) -> None:
    """Phase 11 (d), in a fresh process: the seconds from construction to
    the end of the warm-up over AOT_START_BUCKETS of an AotInpainter on the
    artifact at ``path`` (``kind`` "aot", with the share spent in
    ``torch.export.load``) or of the live Inpainter of the same npz and
    config ("live"); prints one JSON line."""
    import torch

    from gan_inpainting_torch.ops.kernels import build

    build.build_all()                 # built by the parent: loads them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_s = 0.0
    if kind == "aot":
        from gan_inpainting_torch.io.aot import AotInpainter

        inp = AotInpainter(path)
        t1 = time.perf_counter()
        for b, s in inp.buckets:           # torch.export.load of each
            inp._load(b, s)
        load_s = time.perf_counter() - t1
        inp.warmup()
    else:
        from gan_inpainting_torch.infer.inpaint import Inpainter

        batches, sizes = ({str(x[i]) for x in AOT_START_BUCKETS}
                          for i in (0, 1))
        inp = Inpainter.from_npz(NPZ, overrides=SERVE_OVERRIDES[:1] + [
            f"infer.batch_buckets={','.join(sorted(batches, key=int))}",
            f"infer.size_buckets={','.join(sorted(sizes, key=int))}"],
            device="cuda")
        for b, s in AOT_START_BUCKETS:       # what AotInpainter.warmup runs
            inp.inpaint_batch(np.zeros((b, s, s, 3), np.uint8),
                              np.zeros((b, s, s, 1), np.float32))
    torch.cuda.synchronize()
    print(json.dumps({"kind": kind, "start_s": time.perf_counter() - t0,
                      "load_s": load_s}))


def _aot_rates(inpainters, rng):
    """Phase 11 (d): img/s of ``inpaint_batch`` at 64×256² over a window of
    AOT_RATE_WINDOW_S and the 1×256² latency over AOT_LATENCY_REQUESTS
    requests (median and p90), through each of ``inpainters`` (name →
    inpainter, warmed up), in turns a b b a."""
    bb, sb = AOT_START_BUCKETS[1]
    imgs = _smooth_images(rng, bb, sb, sb)
    masks = _stroke_masks(rng, bb, sb, sb)
    a, b = inpainters
    turns = {a: [], b: []}
    for kind in (a, b, b, a):
        inp = inpainters[kind]
        inp.inpaint_batch(imgs, masks)
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < AOT_RATE_WINDOW_S:
            inp.inpaint_batch(imgs, masks)    # returns on the host: synced
            n += 1
        img_s = n * bb / (time.perf_counter() - t0)
        lat = []
        for i in range(AOT_LATENCY_REQUESTS):
            j = i % bb
            t0 = time.perf_counter()
            inp.inpaint_batch(imgs[j:j + 1], masks[j:j + 1])
            lat.append((time.perf_counter() - t0) * 1e3)
        turns[kind].append({
            "img_s_64x256": img_s, "batches": n,
            "latency_1x256_ms": {"p50": float(np.percentile(lat, 50)),
                                 "p90": float(np.percentile(lat, 90))}})
    return turns


def _aot_forward_turns(torch, aot, live, imgs, masks, reps=3):
    """Device ms of one forward through the artifact's program and
    through the live Inpainter's, CUDA events, in turns a b b a."""
    dev_img = torch.from_numpy(imgs).cuda()
    dev_msk = torch.from_numpy(masks[..., None]).cuda()
    s = imgs.shape[1]
    bucket = aot._pick_bucket(imgs.shape[0], s)
    program, packed = aot._load(*bucket), aot.packed[bucket]
    fwd = live._forward(live._cfg_for_size(s).model.fuse_upsample)
    runs = {"artifact": lambda: program(aot.params, packed, dev_img,
                                        dev_msk),
            "live": lambda: fwd(dev_img, dev_msk)}
    turns = {"artifact": [], "live": []}
    with torch.inference_mode():
        for kind in ("artifact", "live", "live", "artifact"):
            turns[kind].append(_time_ms(torch, runs[kind], reps))
    return turns


def _pack_ms(torch, live, size):
    """ms of pack_weights over the weights of every gated conv that the
    kernels take in a forward at ``size``: what a program would pack per
    forward if the packing were traced into it (the artifact takes the
    packed weights as inputs instead, packed once at load, as the live
    path keeps packed copies)."""
    from gan_inpainting_torch.ops.kernels.gated_matmul import (
        pack_weights,
        plan,
    )

    weights = []

    def hook(mod, args, _out):
        if (mod.conv_kind == "gated" and not mod.pre_upsample
                and not mod.s2d):
            weights.append((mod.weight, plan(args[0].shape[-1],
                                             mod.weight.shape[0] // 2,
                                             torch.bfloat16)))

    gen = live._forward(live._cfg_for_size(size).model.fuse_upsample) \
        .generator
    from gan_inpainting_torch.models.layers import InpaintConv

    hooks = [m.register_forward_hook(hook) for m in gen.modules()
             if isinstance(m, InpaintConv)]
    live.inpaint_batch(np.zeros((1, size, size, 3), np.uint8),
                       np.zeros((1, size, size), np.float32))
    for h in hooks:
        h.remove()
    _require(len(weights) == DIRECT_FUSED + MATMUL_PER_FWD,
             f"phase 11: {len(weights)} kernel-routed gated convs")
    return _time_ms(torch, lambda: [pack_weights(w.to(torch.bfloat16), p)
                                    for w, p in weights], 5)


class _DispatchSizes:
    """An inpainter as InpaintService sees it, recording the batch and
    size of every dispatch it is handed."""

    def __init__(self, inner):
        self.inner = inner
        self.dispatches = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def inpaint_batch(self, images, masks):
        self.dispatches.append(images.shape[:2])
        return self.inner.inpaint_batch(images, masks)


def aot_artifacts(torch, rng, smi):
    """Phase 11 (below), its artifacts in a temporary directory that is
    removed however the phase ends."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_aot_")
    t0 = time.perf_counter()
    try:
        out = _aot_artifacts(torch, rng, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[11] phase 11 took {out['phase_s']:.1f} s (by part "
          f"{ {k: round(v, 1) for k, v in out['part_s'].items()} })")
    return out


def _aot_artifacts(torch, rng, smi, tmp):
    """Phase 11: AOT serving artifacts (io/aot.py) on the card. (a) export
    the pinned generator under serve_v4_8's model config (bf16) at 1×256²,
    64×256² and 1×512² under ``auto`` and 64×256² under ``pallas``,
    ``partialconv256`` (seeded) at 64×256² under ``pallas`` and the pinned
    generator at 1×2048² (the patch route); (b) each bucket through a fresh
    AotInpainter against the live Inpainter; (c) the kernels launched per
    forward through each program against the live forward's; (d) start-up,
    artifact against live, each in a fresh process, and img/s and latency
    in turns; (e) InpaintService over an AotInpainter, 32 mixed requests
    from concurrent clients; (f) mismatches."""
    import os
    import threading

    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.infer.service import InpaintService
    from gan_inpainting_torch.io.aot import AotInpainter, export_serving
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.ops import dispatch

    out = {"cases": {}, "part_s": {}}
    clock = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        out["part_s"][name] = now - clock[0]
        clock[0] = now

    full = AOT_START_BUCKETS[1]
    pinned = Inpainter.from_npz(NPZ, overrides=SERVE_OVERRIDES,
                                device="cuda")

    def with_backend(cfg, backend, buckets):
        sizes = ",".join(str(s) for s in sorted({s for _, s in buckets}))
        return apply_overrides(cfg, [f"model.kernel_backend={backend}",
                                     f"infer.size_buckets={sizes}"])

    pcfg = with_backend(get_config("partialconv256"), "pallas", [full])
    pstate = build_generator(pcfg.model, device="cuda", seed=0).state_dict()
    cases = {
        "auto": list(AOT_START_BUCKETS), "pallas": [full],
        "partialconv256": [full], "patch_2048": [AOT_PATCH_BUCKET]}
    cases = {name: (pcfg if name == "partialconv256" else with_backend(
        pinned.cfg, "pallas" if name == "pallas" else "auto", buckets),
        pstate if name == "partialconv256" else pinned.state_dict, buckets)
        for name, buckets in cases.items()}
    # kernels that must launch per forward through each case's programs
    expect = {"auto": ("contextual_attention_fused", "fold_taps"),
              "pallas": ("contextual_attention_fused", "fold_taps",
                         "gated_conv_direct", "gated_matmul"),
              "partialconv256": ("partial_epilogue",),
              "patch_2048": ("patch_attention_fwd",)}
    part("setup")
    for name, (cfg, state, buckets) in cases.items():
        # ---- (a) export ----------------------------------------------------
        path = os.path.join(tmp, name)
        manifest = export_serving(cfg, state, path, buckets=buckets,
                                  device="cuda")
        sizes = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        secs = {k: round(v, 2) for k, v in manifest["export_seconds"].items()}
        print(f"[11] {name}: exported {manifest['buckets']} (formulation "
              f"{manifest['formulation']}; ops {manifest['ops']}; kernel "
              f"builds {manifest['kernels']}) in seconds {secs}; bytes "
              f"{sizes}")
        # ---- (b) parity, (c) launches --------------------------------------
        aot = AotInpainter(path)
        live = Inpainter(cfg, state, device="cuda")
        res = {"export_s": manifest["export_seconds"], "bytes": sizes,
               "ops": manifest["ops"], "kernels": manifest["kernels"],
               "buckets": {}}
        for b, s in buckets:
            imgs = _smooth_images(rng, b, s, s)
            masks = _stroke_masks(rng, b, s, s)
            counts = {}
            outs = {}
            # each kind's first run of the bucket (live: cuDNN's plans
            # tuned; artifact: its program loaded), counted
            for kind, inp in (("live", live), ("aot", aot)):
                dispatch.reset_launches()
                outs[kind] = inp.inpaint_batch(imgs, masks)
                torch.cuda.synchronize()
                counts[kind] = {k: dispatch.launches.get(k, 0)
                                for k in AOT_KERNELS}
            what = f"phase 11 {name} {b}x{s}²"
            _known_exact(outs["aot"], imgs, masks, f"{what} artifact")
            agree = _hole_agreement(outs["aot"], outs["live"], masks)
            same = float(np.mean(outs["aot"] == outs["live"]))
            _require(agree[f"within_{BF16_SERVE_LEVELS}"] >= BF16_SERVE_FRAC,
                     f"{what}: artifact vs live, hole pixels {agree}")
            _require(counts["aot"] == counts["live"]
                     and all(counts["aot"][k] > 0 for k in expect[name]),
                     f"{what}: launches per forward through the artifact "
                     f"{counts['aot']}, live {counts['live']}")
            res["buckets"][f"{b}x{s}"] = {
                "hole_agreement": agree, "identical_share": same,
                "launches_per_forward": counts["aot"]}
            print(f"[11] {what}: known pixels bit-exact; hole pixels vs live "
                  f"{agree}; identical share {same:.6f}; launches per "
                  f"forward through the artifact {counts['aot']} (= live)")
            if (b, s) == full:
                res["fwd_ms"] = _aot_forward_turns(torch, aot, live, imgs,
                                                   masks)
                print(f"[11] {what}: device forward ms in turns (artifact, "
                      f"live, live, artifact) {res['fwd_ms']} | {smi}")
        if name == "pallas":
            res["pack_ms"] = _pack_ms(torch, live, full[1])
            n_packed = len(manifest["packed"][f"{full[0]}x{full[1]}"])
            _require(n_packed == DIRECT_FUSED + MATMUL_PER_FWD,
                     f"phase 11: {n_packed} packed-weight inputs")
            print(f"[11] pallas: {n_packed} packed-weight inputs, packed "
                  f"once at load; packing them per forward would take "
                  f"{res['pack_ms']:.3f} ms | {smi}")
        out["cases"][name] = res
        if name == "auto":
            # kept for (d)'s rates and (e)'s service, its programs loaded
            auto = {"artifact": aot, "live": live}
        del aot, live
        torch.cuda.empty_cache()
        part(f"{name} (a-c)")

    # ---- (d) start-up in fresh processes, then rates in turns --------------
    start = {}
    for kind in ("aot", "live"):
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke as cs; "
             f"cs._aot_start({kind!r}, {os.path.join(tmp, 'auto')!r})"],
            capture_output=True, text=True, timeout=600)
        _require(proc.returncode == 0,
                 f"phase 11 start-up ({kind}): {proc.stderr[-2000:]}")
        start[kind] = json.loads(proc.stdout.strip().splitlines()[-1])
    part("start-up")
    rates = _aot_rates(auto, rng)
    out["start"] = start
    out["rates"] = rates
    print(f"[11] start-up over {list(AOT_START_BUCKETS)} (construction to "
          f"the end of the warm-up, one fresh process each): artifact "
          f"{start['aot']['start_s']:.2f} s, of which loading its programs "
          f"{start['aot']['load_s']:.2f} s; live "
          f"{start['live']['start_s']:.2f} s | {smi}")
    print(f"[11] rates in turns (artifact, live, live, artifact; img/s at "
          f"64x256² over ≥ {AOT_RATE_WINDOW_S} s, 1x256² latency over "
          f"{AOT_LATENCY_REQUESTS} requests): {rates} | {smi}")
    part("rates")

    # ---- (e) the service over an artifact, concurrent clients ------------
    recording = _DispatchSizes(auto["artifact"])
    service = InpaintService(recording, max_wait_ms=5.0)
    service.ready(600)
    recording.dispatches.clear()
    s_small, s_large = full[1], AOT_START_BUCKETS[2][1]
    requests = [(_smooth_images(rng, 1, s, s)[0], _stroke_masks(rng, 1, s,
                                                                s)[0])
                for s in [s_small] * 28 + [s_large] * 4]
    order = rng.permutation(len(requests))          # mixed arrivals
    results = [None] * len(requests)
    gate = threading.Barrier(len(requests))

    def client(i):
        gate.wait()
        results[i] = service.inpaint(*requests[i])

    threads = [threading.Thread(target=client, args=(int(i),))
               for i in order]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    stats = service.stats
    service.close()
    _require(all(r is not None for r in results),
             f"phase 11 service: {sum(r is None for r in results)} requests "
             f"unanswered")
    for (img, m), got in zip(requests, results):
        _known_exact(got[None], img[None], m[None], "phase 11 service")
    n_req = len(requests)
    _require(stats["requests"] == n_req and stats["dispatches"] < n_req,
             f"phase 11 service: {stats} for {n_req} requests")
    groups = {s: sorted(int(b) for b, sb in recording.dispatches if sb == s)
              for s in (s_small, s_large)}
    out["service"] = {"requests": n_req, "dispatches": stats["dispatches"],
                      "dispatch_batches": groups}
    print(f"[11] InpaintService over the artifact: 28 256² and 4 512² "
          f"requests from concurrent clients in {stats['dispatches']} "
          f"dispatches (requests per dispatch by size {groups}; the "
          f"artifact's 512² bucket holds one image, a larger group is served "
          f"in chunks), known pixels bit-exact")
    del auto, recording
    torch.cuda.empty_cache()
    part("service")

    # ---- (f) mismatches raise --------------------------------------------
    cpu_path = os.path.join(tmp, "cpu")
    export_serving(cases["auto"][0], pinned.state_dict, cpu_path,
                   buckets=AOT_START_BUCKETS[:1], device="cpu")
    raised = []
    try:
        AotInpainter(cpu_path)
    except ValueError as e:
        raised.append(str(e))
    manifest_path = os.path.join(tmp, "auto", "manifest.json")
    with open(manifest_path) as f:
        man = json.load(f)
    man["kernels"] = {k: "0" * 16 for k in man["kernels"]}
    with open(manifest_path, "w") as f:
        json.dump(man, f)
    try:
        AotInpainter(os.path.join(tmp, "auto"))
    except ValueError as e:
        raised.append(str(e))
    _require(len(raised) == 2 and "exported for 'cpu'" in raised[0]
             and "re-export with this build" in raised[1],
             f"phase 11: mismatched artifacts loaded: {raised}")
    print(f"[11] a cpu artifact on the card raises ({raised[0][-60:]!r}); "
          f"a stale kernel build raises ({raised[1][-40:]!r})")
    part("mismatch")
    return out


# ---------------------------------------------------------------------------
# phase 12: the mesh's model axis (model.tp_shard) and model.remat_stages
# ---------------------------------------------------------------------------

MA_MODEL2 = ["train.mesh.model=2", "model.tp_shard=true"]
# (a) places512_deepfill at full width over one model group of two gloo
# ranks on cuda:0, bf16 under auto. The global batch is cut from 8 to 2:
# under gloo every gather and input-gradient reduce is staged through the
# host (≈ 0.8 GB of gathers per forward at batch 2)
MA_STEPS = 2                  # 3 until [14] was added: the time limit
MA_TRAIN = TRAIN_512 + ["data.batch_size=2"]
# (a) the group's steps against one process on the same batches, both
# bf16: per metric |a − b| ≤ MA_METRIC_TOL · max(|b|, 1) (bf16 activations
# rounded at other points where a conv's output channels are split); the
# parameters after MA_STEPS Adam steps no further apart than the steps can
# move them (2 · steps · the larger lr: where a gradient is near 0 its
# rounding noise decides the sign of an update), and at least
# MA_PARAM_FRAC of the entries within MA_PARAM_ATOL
MA_METRIC_TOL = 2.0 ** -5
MA_PARAM_ATOL, MA_PARAM_FRAC = 1e-4, 0.99
# (b) serve_v4_8's model config at the 8×256² and 1×512² buckets
MA_SERVE = ["model.fuse_upsample=true", "infer.size_buckets=256,512",
            "infer.batch_buckets=1,8"]
# the kernels of PERF.md §6 rows 1–3 and 6–7, counted per forward in (b)
MA_ROWS = ("contextual_attention_fused", "fold_taps", "gated_conv_direct",
           "gated_matmul")


def _ma_cfg(model2: bool):
    from gan_inpainting_torch.configs.base import apply_overrides, get_config

    return apply_overrides(get_config("places512_deepfill"),
                           MA_TRAIN + (MA_MODEL2 if model2 else
                                       ["model.tp_shard=true"]))


def _ma_rank_jobs(torch, rank, tmp):
    """Phase 12 (a), one member: MA_STEPS steps of the model group on the
    fixed batches, each timed, its collectives counted, the ranks compared
    bit for bit after each."""
    from gan_inpainting_torch.data.pipeline import Batch
    from gan_inpainting_torch.models.generator import sliced_parameters
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.parallel.sharding import counts, reduce_metrics
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    cfg = _ma_cfg(True)
    batches = torch.load(tmp / "batches.pt", weights_only=False)
    torch.cuda.reset_peak_memory_stats()
    state = create_state(cfg, device="cuda:0")
    step = make_train_step(cfg)
    gaps, metrics, steps = [_dp_gap(torch, state)], [], []
    dispatch.reset_launches()
    for b in batches:
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(reduce_metrics(step(state, Batch(
            *(t.cuda() for t in b)))))
        torch.cuda.synchronize()
        steps.append(dict(ms=1e3 * (time.perf_counter() - t0),
                          **{k: counts[k] - before[k] for k in counts}))
        gaps.append(_dp_gap(torch, state))
    out = dict(gaps=gaps, metrics=metrics, steps=steps,
               launches=dict(dispatch.launches),
               sharded=len(sliced_parameters(state.generator)) // 2,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if rank == 0:
        while not (tmp / "ref.pt").exists():     # the parent's
            time.sleep(0.5)
        ref = torch.load(tmp / "ref.pt", weights_only=True)
        sd = state.state_dict()
        gaps = torch.cat([(sd[p][k].float().cpu() - v).abs().flatten()
                          for p in ("g_params", "d_params", "g_ema")
                          for k, v in ref[p].items()])
        out.update(param_max=gaps.max().item(),
                   param_frac=(gaps <= MA_PARAM_ATOL).float().mean().item())
    return out


def _ma_train(torch, tmp, smi):
    """Phase 12 (a): the model group's steps against one process."""
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    one_cfg = _ma_cfg(False)
    batches = _dp_batches(torch, one_cfg, MA_STEPS)
    torch.save(batches, tmp / "batches.pt")
    t0 = time.perf_counter()

    def reference():
        # one process on the same batches while the ranks start: rank 0
        # waits for its file
        state = create_state(one_cfg, device="cuda:0")
        step = make_train_step(one_cfg)
        got = [{k: float(v) for k, v in step(
            state, type(b)(*(t.cuda() for t in b))).items()}
            for b in batches]
        sd = state.state_dict()
        torch.save({p: {k: v.float().cpu() for k, v in sd[p].items()}
                    for p in ("g_params", "d_params", "g_ema")},
                   tmp / "ref.part")
        (tmp / "ref.part").rename(tmp / "ref.pt")
        del state, step, sd
        torch.cuda.empty_cache()
        return got

    one, ranks = _spawn_gloo(torch, tmp, _ma_rank_jobs, reference)
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    _require(not any(r0["gaps"]) and r0["metrics"] == r1["metrics"],
             f"model group: ranks differ after a step: largest gaps "
             f"{r0['gaps']}, metrics {r0['metrics']} / {r1['metrics']}")
    gaps = {k: max(abs(m[k] - w[k]) / max(abs(w[k]), 1.0)
                   for m, w in zip(r0["metrics"], one))
            for k in one[0]}
    lr = max(one_cfg.train.g_lr, one_cfg.train.d_lr)
    bound = 2 * MA_STEPS * lr
    missing = [k for k in FILE_PATH_KERNELS
               if not all(r["launches"].get(k) for r in ranks)]
    per = r0["steps"]
    print(f"[12] (a) places512_deepfill full width, bf16, auto, "
          f"train.mesh.model=2 model.tp_shard=true: one model group of 2 "
          f"gloo ranks on cuda:0, {MA_STEPS} steps on fixed batches of 2 "
          f"(global batch cut from 8: every gather goes through the host "
          f"under gloo); {r0['sharded']} channel-sharded convs; ranks' "
          f"parameters, spectral vectors, Adam states and EMA bit-identical "
          f"after each step; against one process on the same batches: "
          f"metrics max |a−b|/max(|b|,1) {max(gaps.values()):.3e} (tol "
          f"{MA_METRIC_TOL:.3e}; by metric "
          f"{ {k: round(v, 5) for k, v in gaps.items()} }), parameters max "
          f"abs diff {r0['param_max']:.3e} (bound {bound:.1e}), "
          f"{100 * r0['param_frac']:.4f} % within {MA_PARAM_ATOL} (need "
          f"{100 * MA_PARAM_FRAC} %); per step ms "
          f"{[round(s['ms'], 1) for s in per]}, channel gathers "
          f"{[s['channel_gathers'] for s in per]}, gathered bytes "
          f"{[s['channel_gather_bytes'] for s in per]} "
          f"(the zero-filled all_reduce buffers: 2x an all_gather's), "
          f"input-gradient all-reduces "
          f"{[s['input_grad_all_reduces'] for s in per]}, model-group "
          f"gradient reduces {[s['model_grad_reduces'] for s in per]}; "
          f"peak memory per "
          f"rank {[round(r['peak_gib'], 2) for r in ranks]} GiB; launches "
          f"per rank {[{k: r['launches'].get(k, 0) for k in FILE_PATH_KERNELS} for r in ranks]} "
          f"(gloo stages every collective through the host: a check, not "
          f"a rate of NCCL); {wall:.1f} s with spawn and cuDNN tuning "
          f"| {smi}")
    _require(not missing, f"model group: not launched on every rank: "
             f"{missing}")
    _require(max(gaps.values()) <= MA_METRIC_TOL
             and r0["param_max"] <= bound
             and r0["param_frac"] >= MA_PARAM_FRAC,
             "the model group's steps disagree with one process")
    return dict(metric_gaps=gaps, param_max=r0["param_max"],
                param_frac=r0["param_frac"], steps=per,
                sharded_convs=r0["sharded"],
                peak_gib=[r["peak_gib"] for r in ranks],
                launches=[r["launches"] for r in ranks], wall_s=wall)


def _ma_remat_peak(torch, smi):
    """Phase 12: the peak memory of one 8×512² places512_deepfill step
    with and without model.remat_stages, in this process."""
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    base = apply_overrides(get_config("places512_deepfill"), TRAIN_512)
    batch = _dp_batches(torch, base, 1)[0]
    batch = type(batch)(*(t.cuda() for t in batch))
    out = {}
    for remat in (False, True, False, True):
        cfg = apply_overrides(base, [f"model.remat_stages={str(remat).lower()}"])
        state = create_state(cfg, device="cuda")
        step = make_train_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        _require(all(np.isfinite(float(v)) for v in m.values()),
                 f"remat={remat}: metrics not finite")
        out.setdefault(remat, []).append(dict(
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            above_state_gib=(torch.cuda.max_memory_allocated() - start)
            / 2 ** 30, ms=ms))
        del state, step, m
        torch.cuda.empty_cache()
    print(f"[12] one places512_deepfill step at 8x512² bf16 (step 0: R1 "
          f"included), in turns off, on, off, on: peak memory without "
          f"remat_stages {[round(r['peak_gib'], 2) for r in out[False]]} "
          f"GiB ({[round(r['above_state_gib'], 2) for r in out[False]]} "
          f"above the state), with it "
          f"{[round(r['peak_gib'], 2) for r in out[True]]} GiB "
          f"({[round(r['above_state_gib'], 2) for r in out[True]]}); "
          f"step ms {[round(r['ms'], 1) for r in out[False]]} against "
          f"{[round(r['ms'], 1) for r in out[True]]} (one step each, not "
          f"a rate) | {smi}")
    _require(max(r["peak_gib"] for r in out[True])
             < min(r["peak_gib"] for r in out[False]),
             "remat_stages did not lower the step's peak memory")
    return {"off": out[False], "on": out[True]}


def _ma_plan(gen, cfg_model, model: int) -> dict:
    """Launches per forward of the gated-conv kernels the group's plan
    predicts: every member runs every gated conv that is not a rewrite
    (s2d stem, fused upsample), stride 1 on the direct kernel, stride 2
    on the strided one, sharded or whole."""
    from gan_inpainting_torch.models.layers import InpaintConv

    if cfg_model.kernel_backend != "pallas":
        return {"gated_conv_direct": 0, "gated_matmul": 0}
    convs = [m for m in gen.modules() if isinstance(m, InpaintConv)
             and m.conv_kind == "gated" and not (m.s2d or m.pre_upsample)]
    return {"gated_conv_direct": model * sum(m.stride == 1 for m in convs),
            "gated_matmul": model * sum(m.stride == 2 for m in convs)}


def _ma_forms(inp, imgs, masks) -> dict:
    """The gated-conv forms one member's forward gives the kernels: (x
    shape, features of the member's slice, window, stride, dilation,
    activation) → count per forward, by forward pre-hooks on member 0."""
    from gan_inpainting_torch.models.layers import InpaintConv

    fuse = inp._cfg_for_size(imgs.shape[1]).model.fuse_upsample
    gen = inp._forwards[0][0](fuse).generator
    forms: dict = {}

    def hook(m, args):
        x = args[0]
        f = m.features // (m.model_group.size if m.model_group else 1)
        key = (tuple(x.shape), f, m.kernel_size, m.stride, m.dilation,
               m.activation)
        forms[key] = forms.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in gen.modules()
               if isinstance(m, InpaintConv) and m.conv_kind == "gated"
               and not (m.s2d or m.pre_upsample)]
    try:
        inp.inpaint_batch(imgs, masks)
    finally:
        for h in handles:
            h.remove()
    return forms


def _ma_serve(torch, rng, smi):
    """Phase 12 (b): serve_v4_8 over a group of two devices (cuda:0 twice)
    against one, under auto and pallas; the gated-conv slice forms."""
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.ops import dispatch

    t_all = time.perf_counter()
    reqs = {"8x256": (_smooth_images(rng, 8, 256, 256),
                      _stroke_masks(rng, 8, 256, 256)),
            "1x512": (_smooth_images(rng, 1, 512, 512),
                      _stroke_masks(rng, 1, 512, 512))}
    out, forms = {}, {}
    for backend in ("auto", "pallas"):
        ov = MA_SERVE + [f"model.kernel_backend={backend}"]
        one = Inpainter.from_npz(NPZ, overrides=ov, device="cuda:0")
        two = Inpainter.from_npz(NPZ, overrides=ov + MA_MODEL2,
                                 devices=["cuda:0", "cuda:0"])
        _require(len(two.groups) == 1 and len(two.groups[0]) == 2,
                 f"model=2 over 2 devices: groups {two.groups}")
        res = {}
        for name, (imgs, masks) in reqs.items():
            want = one.inpaint_batch(imgs, masks)
            dispatch.reset_launches()
            one.inpaint_batch(imgs, masks)
            l_one = {k: dispatch.launches.get(k, 0) for k in MA_ROWS}
            two.inpaint_batch(imgs, masks)            # cuDNN tuning, build
            dispatch.reset_launches()
            got = two.inpaint_batch(imgs, masks)
            l_two = {k: dispatch.launches.get(k, 0) for k in MA_ROWS}
            _known_exact(got, imgs, masks, f"model group {backend} {name}")
            agree = _hole_agreement(got, want, masks)
            _require(agree[f"within_{BF16_SERVE_LEVELS}"] >= BF16_SERVE_FRAC,
                     f"model group {backend} {name} vs one device: {agree}")
            fuse = two._cfg_for_size(imgs.shape[1]).model.fuse_upsample
            plan = _ma_plan(two._forwards[0][0](fuse).generator,
                            two.cfg.model, 2)
            # rows 1–3 run whole on every member: twice model=1's
            predicted = {**{k: 2 * l_one[k] for k in MA_ROWS[:2]}, **plan}
            _require(l_two == predicted and all(
                l_two[k] > 0 for k in MA_ROWS[:2]) and (
                backend == "auto" or all(l_two[k] > 0 for k in plan)),
                f"model group {backend} {name}: launches per forward "
                f"{l_two}, plan {predicted}")
            # ms per batch through inpaint_batch, in turns one, two, two,
            # one: CUDA events on the card's default stream, which both
            # members' work runs on, so the host's waits between the
            # exchanges are inside
            turns = {"one": [], "two": []}
            for kind in ("one", "two", "two", "one"):
                inp = one if kind == "one" else two
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                runs = []
                for _ in range(3):
                    start.record()
                    inp.inpaint_batch(imgs, masks)
                    end.record()
                    torch.cuda.synchronize()
                    runs.append(start.elapsed_time(end))
                turns[kind].append(float(np.median(runs)))
            if backend == "pallas":
                forms[name] = _ma_forms(two, imgs, masks)
            res[name] = dict(hole_agreement=agree, launches_one=l_one,
                             launches_two=l_two, predicted=predicted,
                             ms=turns)
            print(f"[12] (b) serve_v4_8 (tex256_attn npz) {name} bf16 "
                  f"{backend}: Inpainter(devices=[cuda:0, cuda:0]) with "
                  f"train.mesh.model=2 model.tp_shard=true against one "
                  f"device at model=1: known pixels bit-exact, hole pixels "
                  f"within ±{BF16_SERVE_LEVELS} on "
                  f"{agree[f'within_{BF16_SERVE_LEVELS}']:.6f} (need "
                  f"{BF16_SERVE_FRAC}; max {agree['max']}); launches per "
                  f"forward of rows 1-3, 6-7 {l_two} = the group's plan "
                  f"{predicted} (model=1: {l_one}); ms per batch through "
                  f"inpaint_batch in turns one, two, two, one: model=1 "
                  f"{[round(t, 2) for t in turns['one']]}, model=2 on the "
                  f"same card {[round(t, 2) for t in turns['two']]} (one "
                  f"card: no gain claimed) | {smi}")
        out[backend] = res
        two.close()
        del one, two
        torch.cuda.empty_cache()
    print(f"[12] (b) took {time.perf_counter() - t_all:.1f} s")
    return out, forms


def _ma_kernels(torch, rng, forms, smi):
    """Phase 12 (c): the gated-conv kernel at every slice form of (b)'s
    pallas group forwards against its plain version, bf16, with its time,
    the plain version's, conv2d + bias and the bound."""
    from gan_inpainting_torch.ops.conv import conv2d
    from gan_inpainting_torch.ops.gated_conv import (
        gated_conv,
        gated_conv_plain,
    )
    from gan_inpainting_torch.ops.kernels import gated_matmul as gm

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    merged: dict = {}
    for name, fs in forms.items():
        for key, n in fs.items():
            merged.setdefault(key, {})[name] = 2 * n    # both members
    rows = []
    for (shape, f, k, stride, dil, act), launches in sorted(
            merged.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        b, h, w, cin = shape
        xb = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, bf16)
        wb = torch.from_numpy((rng.standard_normal((2 * f, cin, k, k))
                               / np.sqrt(k * k * cin)).astype(
                                   np.float32)).to(dev, bf16)
        bias = torch.from_numpy(0.5 * rng.standard_normal(2 * f).astype(
            np.float32)).to(dev)
        kw = dict(stride=stride, dilation=dil, activation=act)
        want = gated_conv_plain(xb.float(), wb.float(), bias, **kw)
        got = gated_conv(xb, wb, bias, backend="pallas", **kw)
        ref = max(want.abs().max().item(), 1.0)
        err = (got.float() - want).abs().max().item()
        ho, wo = got.shape[1:3]
        del got, want
        form = (f"{'matmul s2' if stride == 2 else f'direct d{dil}'} "
                f"{cin}->2x{f} {k}x{k} {b}x{h}x{w} {act}")
        _require(err <= CONV_BF16_TOL_FRAC * ref,
                 f"slice form {form}: kernel disagrees with its plain "
                 f"version ({err:.3e}, max|ref| {ref:.3e})")
        ms = _time_ms(torch, lambda: gated_conv(xb, wb, bias,
                                                backend="pallas", **kw), 5)
        plain_ms = _time_ms(torch, lambda: gated_conv_plain(xb, wb, bias,
                                                            **kw), 5)
        lib_ms = _time_ms(torch, lambda: conv2d(xb, wb, bias, stride=stride,
                                                dilation=dil), 5)
        m = b * ho * wo
        n_bytes = (xb.numel() + wb.numel() + m * f) * 2 + bias.numel() * 4
        bound, by = _bound_ms(n_bytes, 2.0 * m * k * k * cin * 2 * f,
                              H100_BF16_FLOPS)
        p = gm.plan(cin, f, bf16)
        rows.append(dict(form=form, features=f, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by,
                         max_abs_err=err, launches=launches,
                         block_f=p.block_f, n_col=p.n_col))
        print(f"[12] (c) {form}: max_abs_err {err:.3e} (tol "
              f"{CONV_BF16_TOL_FRAC * ref:.3e}); ms {ms:.4f}, plain "
              f"{plain_ms:.4f}, conv2d+bias {lib_ms:.4f}, bound "
              f"{bound:.4f} by {by}; plan block_f {p.block_f} x {p.n_col}; "
              f"launches per group forward {launches} | {smi}")
        del xb, wb
    _require(any(r["features"] == 12 for r in rows),
             "no slice form of 12 features was held")
    return rows


def model_axis(torch, rng, smi):
    """Phase 12: (a) training over a model group of two gloo ranks, the
    remat_stages peak, (b) serving over a group of two devices, (c) the
    gated-conv kernel at the slice shapes."""
    import pathlib
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a = _ma_train(torch, pathlib.Path(tmp), smi)
    torch.cuda.empty_cache()
    remat = _ma_remat_peak(torch, smi)
    b, forms = _ma_serve(torch, rng, smi)
    c = _ma_kernels(torch, rng, forms, smi)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"[12] phase 12 took {wall:.1f} s")
    return dict(train=a, remat=remat, serve=b, slice_kernels=c,
                phase_s=wall)


# ---------------------------------------------------------------------------
# phase 13: the mesh's spatial axis in serving (train.mesh.spatial)
# ---------------------------------------------------------------------------

# (a) path C's pinned generator and buckets, one 1×2048² request, bf16
SP_2048 = ["model.fuse_upsample=true", "infer.size_buckets=256,512,2048",
           "infer.batch_buckets=1"]
SP_GROUPS = (2, 4)
# the groups whose ms per request is taken in turns against the whole map:
# not the group of 4, whose turns would take the script past its time
# limit since [14] (its check, launches and exchanges stay)
SP_TIMED = (2,)
# the kernels of PERF.md §6 rows 1–3, 6–7 and 9, counted per forward
SP_ROWS = ("contextual_attention_fused", "fold_taps", "gated_conv_direct",
           "gated_matmul", "patch_attention_fwd")
# the row exchanges of parallel/spatial.py, counted in sharding.counts
SP_COUNTS = ("halo_exchanges", "halo_bytes", "row_gathers",
             "row_gather_bytes", "spill_adds", "spill_bytes",
             "unsharded_forwards")
# (b) row 9 at the spatial shapes: B, Lq, Lk (d 1728, dv 3072, bf16) of a
# member of a group of 2 at the 2048² request and at the 8×256² bucket;
# the forward within phase 2's bf16 tolerance of max|reference|
# (BF16_TOL_FRAC: the output is rounded to bf16 once, and the plain
# version rounds the weights to bf16 before its PV product)
SP_KERNEL_SHAPES = {"B1_Lq32768_Lk65536": (1, 32768, 65536),
                    "B8_Lq512_Lk1024": (8, 512, 1024)}
SP_KERNEL_TOL_FRAC = BF16_TOL_FRAC
SP_PLAIN_CHUNK = 2048            # query rows per chunk of the plain version


def _sp_recorder():
    """Record (thread, B, Lq, Lk) of every call of the spatial branch's
    patch-attention wrapper, which still runs (and counts its launch);
    returns the list and a function that restores the wrapper."""
    import importlib
    import threading

    ca = importlib.import_module(
        "gan_inpainting_torch.ops.contextual_attention")
    real, calls, lock = ca.attend, [], threading.Lock()

    def recorded(q, k, key_valid, v, softmax_scale):
        with lock:
            calls.append((threading.current_thread().name, q.shape[0],
                          q.shape[1], k.shape[1]))
        return real(q, k, key_valid, v, softmax_scale)

    ca.attend = recorded

    def restore():
        ca.attend = real

    return calls, restore


def _sp_forward(torch, inp, imgs, masks):
    """One forward through ``inp`` with the launch counts set to 0 just
    before and read just after: (output, launches of SP_ROWS, row
    exchanges of SP_COUNTS, patch-attention calls)."""
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.parallel.sharding import counts

    torch.cuda.synchronize()
    calls, restore = _sp_recorder()
    before = {k: counts[k] for k in SP_COUNTS}
    dispatch.reset_launches()
    try:
        out = inp.inpaint_batch(imgs, masks)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = {k: dispatch.launches.get(k, 0) for k in SP_ROWS}
    moved = {k: counts[k] - before[k] for k in SP_COUNTS}
    return out, launches, moved, calls


def _sp_turns(torch, inps, order, imgs, masks, runs=2):
    """ms per request through ``inpaint_batch`` (host uint8 in and out),
    ``runs`` each, taken in the turns of ``order``."""
    turns = {k: [] for k in inps}
    for k in order:
        lat = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inps[k].inpaint_batch(imgs, masks)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        turns[k].append(lat)
    return turns


def _sp_2048(torch, rng, smi):
    """Phase 13 (a): one 1×2048² request of the pinned generator on
    spatial groups of SP_GROUPS members sharing cuda:0 against the whole
    map on one device; ms per request in turns for SP_TIMED."""
    from gan_inpainting_torch.infer.inpaint import Inpainter

    imgs = _smooth_images(rng, 1, 2048, 2048)
    masks = _stroke_masks(rng, 1, 2048, 2048)
    torch.cuda.reset_peak_memory_stats()
    whole = Inpainter.from_npz(NPZ, overrides=SP_2048, device="cuda:0")
    want, l_whole, _, _ = _sp_forward(torch, whole, imgs, masks)
    _known_exact(want, imgs, masks, "spatial (a) whole map")
    inps, res = {1: whole}, {1: dict(
        launches=l_whole,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)}
    lk = (2048 // 4 // 2) ** 2
    for n in SP_GROUPS:
        torch.cuda.reset_peak_memory_stats()
        inp = Inpainter.from_npz(NPZ, overrides=SP_2048 + [
            f"train.mesh.spatial={n}"], devices=["cuda:0"] * n)
        _require(len(inp.groups) == 1 and len(inp.groups[0]) == n
                 and inp.row_sharded(2048),
                 f"spatial={n}: groups {inp.groups}")
        t0 = time.perf_counter()
        inp.inpaint_batch(imgs, masks)       # cuDNN tuning on every member
        first_s = time.perf_counter() - t0
        got, launches, moved, calls = _sp_forward(torch, inp, imgs, masks)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _known_exact(got, imgs, masks, f"spatial={n} 1x2048²")
        agree = _hole_agreement(got, want, masks)
        _require(agree[f"within_{BF16_SERVE_LEVELS}"] >= BF16_SERVE_FRAC,
                 f"spatial={n} 1x2048² vs the whole map: {agree}")
        shapes = sorted(c[1:] for c in calls)
        _require(launches["patch_attention_fwd"] == n
                 and launches["contextual_attention_fused"] == 0
                 and shapes == [(1, lk // n, lk)] * n
                 and len({c[0] for c in calls}) == n
                 and moved["unsharded_forwards"] == 0
                 and moved["halo_exchanges"] > 0,
                 f"spatial={n} 1x2048²: launches {launches}, attention "
                 f"calls {calls}, exchanges {moved}; expected one "
                 f"patch_attention_fwd per member at Lq {lk // n}, Lk {lk}")
        res[n] = dict(hole_agreement=agree, launches=launches,
                      attention_calls=shapes, exchanges=moved,
                      first_request_s=first_s, peak_gib=peak)
        inps[n] = inp
        print(f"[13] (a) serve_v4_8 (tex256_attn npz) 1x2048² bf16 over "
              f"train.mesh.spatial={n} (devices=[cuda:0] x {n}) against "
              f"the whole map: known pixels bit-exact, hole pixels within "
              f"±{BF16_SERVE_LEVELS} on "
              f"{agree[f'within_{BF16_SERVE_LEVELS}']:.6f} (need "
              f"{BF16_SERVE_FRAC}; max {agree['max']}); launches "
              f"{launches} (whole map {l_whole}); patch attention per "
              f"member (B, Lq, Lk) {shapes[0]}; exchanges per request "
              f"{moved}; first request {first_s:.1f} s (cuDNN tuning per "
              f"member thread); peak {peak:.2f} GiB (whole map "
              f"{res[1]['peak_gib']:.2f}) | {smi}")
        if n not in SP_TIMED:
            inps.pop(n).close()
            torch.cuda.empty_cache()
    order = [1, *SP_TIMED, *SP_TIMED[::-1], 1]
    turns = _sp_turns(torch, inps, order, imgs, masks)
    for n in inps:
        res[n]["ms_turns"] = turns[n]
    print(f"[13] (a) ms per 1x2048² request through inpaint_batch, "
          f"{len(turns[1][0])} runs per turn in turns {order}: " + "; ".join(
              f"spatial={n} {[[round(t, 1) for t in r] for r in turns[n]]}"
              for n in inps) + f" (one card: no gain claimed) | {smi}")
    for n in SP_TIMED:
        inps[n].close()
    return res


def _sp_kernel(torch, smi):
    """Phase 13 (b): row 9 (the patch-attention forward) at the spatial
    shapes against its plain version, with the wrapper's time, the plain
    version's, SDPA's and the bound."""
    import torch.nn.functional as F

    from gan_inpainting_torch.ops.kernels.patch_attention import (
        patch_attention,
        patch_attention_plain,
    )

    d, dv, rows = 1728, 3072, {}
    for name, (b, lq, lk) in SP_KERNEL_SHAPES.items():
        q, k, v, _, valid = _patch_inputs(torch, 23, b, lq, lk, d, dv,
                                          torch.bfloat16, dead=b > 1)

        def wrapper():
            return patch_attention(q, k, valid, v, softmax_scale=10.0)

        def plain():
            return [patch_attention_plain(
                q[:, c0:c0 + SP_PLAIN_CHUNK], k, valid, v,
                softmax_scale=10.0) for c0 in range(0, lq, SP_PLAIN_CHUNK)]

        got = wrapper()
        err = ref = 0.0
        for c0, want in zip(range(0, lq, SP_PLAIN_CHUNK), plain()):
            a = got[:, c0:c0 + SP_PLAIN_CHUNK].float()
            err = max(err, (a - want.float()).abs().max().item())
            ref = max(ref, want.float().abs().max().item())
        _require(err <= SP_KERNEL_TOL_FRAC * max(ref, 1.0),
                 f"spatial (b) {name}: max abs err {err:.3e} of max|ref| "
                 f"{ref:.3e} (tol {SP_KERNEL_TOL_FRAC})")
        # the last sample of a batch has no valid key: exactly 0
        _require(b == 1 or got[-1].abs().max().item() == 0.0,
                 f"spatial (b) {name}: a row with no valid key is not 0")
        del got
        ms = _time_ms(torch, wrapper, 3)
        plain_ms = _time_ms(torch, plain, 1)
        n_bytes, n_ops = _patch_bounds(valid, lq, d, dv, 2)["fwd"]
        bound, by = _bound_ms(n_bytes, n_ops, H100_BF16_FLOPS)
        mask = torch.where(valid, 0.0, -1e9).to(q.dtype)[:, None, None, :]
        try:
            sdpa_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], attn_mask=mask,
                scale=10.0), 2)
        except RuntimeError as e:          # no SDPA backend holds it
            sdpa_ms = None
            print(f"[13] (b) {name}: SDPA refused ({str(e)[:80]})")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                          bound_ms=bound, bound_by=by, max_abs_err=err,
                          max_abs_err_of=ref,
                          tflops=n_ops / (ms * 1e-3) / 1e12)
        print(f"[13] (b) patch_attention_fwd {name} d{d} dv{dv} bf16: max "
              f"abs err {err:.3e} of max|ref| {ref:.3e} (tol "
              f"{SP_KERNEL_TOL_FRAC} of it); wrapper {ms:.3f} ms "
              f"({rows[name]['tflops']:.1f} TFLOP/s of valid pairs), plain "
              f"{plain_ms:.3f}, SDPA "
              f"{'n/a' if sdpa_ms is None else f'{sdpa_ms:.3f}'}, bound "
              f"{bound:.3f} by {by} | {smi}")
        del q, k, v, valid, mask
        torch.cuda.empty_cache()
    return rows


def _sp_serve(torch, rng, smi):
    """Phase 13 (c): serve_v4_8 at 8×256² and 1×512² over a spatial group
    of two against one device, under auto and pallas, and a float32
    1×512² pair."""
    from gan_inpainting_torch.infer.inpaint import Inpainter

    reqs = {"8x256": (_smooth_images(rng, 8, 256, 256),
                      _stroke_masks(rng, 8, 256, 256)),
            "1x512": (_smooth_images(rng, 1, 512, 512),
                      _stroke_masks(rng, 1, 512, 512))}
    out = {}
    for backend in ("auto", "pallas", "f32"):
        ov = MA_SERVE + (["model.dtype_policy=f32"] if backend == "f32"
                         else [f"model.kernel_backend={backend}"])
        one = Inpainter.from_npz(NPZ, overrides=ov, device="cuda:0")
        two = Inpainter.from_npz(NPZ, overrides=ov + [
            "train.mesh.spatial=2"], devices=["cuda:0", "cuda:0"])
        res = {}
        for name, (imgs, masks) in reqs.items():
            if backend == "f32" and name != "1x512":
                continue
            one.inpaint_batch(imgs, masks)           # tuning, build
            want, l_one, _, _ = _sp_forward(torch, one, imgs, masks)
            two.inpaint_batch(imgs, masks)
            got, l_two, moved, calls = _sp_forward(torch, two, imgs, masks)
            _known_exact(got, imgs, masks, f"spatial (c) {backend} {name}")
            agree = _hole_agreement(got, want, masks)
            if backend == "f32":
                ok = agree["max"] <= 1
            else:
                ok = agree[f"within_{BF16_SERVE_LEVELS}"] >= BF16_SERVE_FRAC
            b, s = imgs.shape[0], imgs.shape[1]
            lk = (s // 4 // 2) ** 2
            convs = ("gated_conv_direct", "gated_matmul")
            _require(ok and l_two["patch_attention_fwd"] == 2
                     and l_two["contextual_attention_fused"] == 0
                     and sorted(c[1:] for c in calls) == [(b, lk // 2,
                                                           lk)] * 2
                     and all(l_two[k] == 2 * l_one[k] for k in convs)
                     and (backend != "pallas"
                          or all(l_two[k] > 0 for k in convs)),
                     f"spatial (c) {backend} {name}: agreement {agree}, "
                     f"launches {l_two} (one device {l_one}), attention "
                     f"calls {calls}")
            turns = _sp_turns(torch, {1: one, 2: two}, (1, 2, 2, 1), imgs,
                              masks)
            res[name] = dict(hole_agreement=agree, launches_one=l_one,
                             launches_two=l_two, exchanges=moved,
                             ms_turns={f"spatial{k}": v
                                       for k, v in turns.items()})
            print(f"[13] (c) serve_v4_8 {name} "
                  f"{'float32' if backend == 'f32' else 'bf16 ' + backend}:"
                  f" spatial=2 (devices=[cuda:0, cuda:0]) against one "
                  f"device: known pixels bit-exact, hole pixels "
                  + (f"max {agree['max']} (need ≤ 1)" if backend == "f32"
                     else f"within ±{BF16_SERVE_LEVELS} on "
                     f"{agree[f'within_{BF16_SERVE_LEVELS}']:.6f} (need "
                     f"{BF16_SERVE_FRAC}; max {agree['max']})")
                  + f"; launches per forward {l_two} (one device {l_one}; "
                  f"per member rows 6-7 as one device's, row 9 once at Lq "
                  f"{lk // 2}, Lk {lk}); exchanges {moved}; ms per batch in "
                  f"turns one, two, two, one: one "
                  f"{[[round(t, 1) for t in r] for r in turns[1]]}, two "
                  f"{[[round(t, 1) for t in r] for r in turns[2]]} | {smi}")
        out[backend] = res
        two.close()
        del one, two
        torch.cuda.empty_cache()
    return out


def spatial_axis(torch, rng, smi):
    """Phase 13: serving over the mesh's spatial axis: (a) the 2048²
    request on spatial groups of SP_GROUPS, (b) row 9 at the spatial
    shapes, (c) serve_v4_8's buckets at spatial 2."""
    t0 = time.perf_counter()
    a = _sp_2048(torch, rng, smi)
    torch.cuda.empty_cache()
    b = _sp_kernel(torch, smi)
    c = _sp_serve(torch, rng, smi)
    wall = time.perf_counter() - t0
    print(f"[13] phase 13 took {wall:.1f} s")
    return dict(serve_2048=a, kernel=b, serve_v4_8=c, phase_s=wall)


# ---------------------------------------------------------------------------
# phase 14: training and evaluating over the mesh's spatial axis
# ---------------------------------------------------------------------------

# (a) path C (b)'s run over a spatial group of two gloo ranks sharing
# cuda:0: places512_deepfill at 1×2048², bf16, from step 0 (the lazy R1
# step) on path C's two batches, against path C's own figures (one
# process, the same seed, state and batches). Both bf16: per metric
# |a − b| ≤ ST_METRIC_TOL · max(|b|, 1) (each band's convs round bf16
# activations where cuDNN's algorithms for the band's shapes do); the G
# parameters after the steps no further apart than the steps can move
# them (2 · steps · g_lr: where a gradient is near 0 its rounding noise
# decides the sign of an update), and at least ST_PARAM_FRAC of the
# entries within ST_PARAM_ATOL
ST_TRAIN = TRAIN_512 + ["data.image_size=2048", "data.batch_size=1"]
ST_METRIC_TOL = 2.0 ** -5
ST_PARAM_ATOL, ST_PARAM_FRAC = 1e-4, 0.99
# rows 9–11 and the fused forward, launched per step on every rank: the
# D step's detached forward and the G step's forward on the member's
# query rows, one dQ and one dK/dV; the fused route never
ST_ROWS = {"patch_attention_fwd": 2, "patch_attention_bwd_dq": 1,
           "patch_attention_bwd_dkv": 1, "contextual_attention_fused": 0}
ST_COUNTS = SP_COUNTS + ("row_reduces", "row_reduce_bytes", "band_sums",
                         "band_sum_bytes", "unsharded_steps")
# (c) evaluate over the group: float32, two eval batches of 2 at 256²,
# against one process: the same composites to float32 sums in another
# order, PSNR and SSIM within ST_EVAL_REL of one process's
ST_EVAL = ["model.dtype_policy=f32", "data.image_size=256",
           "data.eval_batch_size=2", "data.num_eval_batches=2",
           "eval.metrics=psnr,ssim"]
ST_EVAL_REL = 1e-4
# (b) rows 10 and 11 at a member's shapes at spatial 2: B, Lq, Lk
ST_KERNEL_SHAPE = (1, 32768, 65536)
ST_PLAIN_CHUNK = 4096          # query rows per chunk of the plain versions


def _st_cfg(overrides, spatial: bool):
    from gan_inpainting_torch.configs.base import apply_overrides, get_config

    return apply_overrides(get_config("places512_deepfill"), overrides + (
        ["train.mesh.spatial=2"] if spatial else []))


def _st_rank_jobs(torch, rank, tmp):
    """Phase 14 (a) and (c), one member: the steps on path C's batches,
    each timed with its exchanges counted, then ``evaluate``."""
    from gan_inpainting_torch.data.pipeline import Batch
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.parallel.sharding import counts, reduce_metrics
    from gan_inpainting_torch.train.evaluate import evaluate
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    cfg = _st_cfg(ST_TRAIN, True)
    batches = torch.load(tmp / "batches.pt", weights_only=True)
    torch.cuda.reset_peak_memory_stats()
    state = create_state(cfg, device="cuda:0")
    step = make_train_step(cfg)
    metrics, steps = [], []
    dispatch.reset_launches()
    for b in batches:
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(reduce_metrics(step(state, Batch(
            *(t.cuda() for t in b)))))
        torch.cuda.synchronize()
        steps.append(dict(ms=1e3 * (time.perf_counter() - t0),
                          **{k: counts[k] - before[k] for k in ST_COUNTS}))
    out = dict(metrics=metrics, steps=steps,
               launches={k: dispatch.launches.get(k, 0) for k in ST_ROWS},
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if rank == 0:
        out["g_params"] = {k: v.float().cpu() for k, v in
                           state.generator.state_dict().items()}
    del state, step
    torch.cuda.empty_cache()
    before = dict(counts)
    t0 = time.perf_counter()
    out["eval"] = evaluate(_st_cfg(ST_EVAL, True),
                           torch.load(tmp / "eval_gen.pt", weights_only=True),
                           device="cuda:0")
    out["eval_s"] = time.perf_counter() - t0
    out["eval_exchanges"] = {k: counts[k] - before[k] for k in ST_COUNTS}
    return out


def _st_train(torch, tmp, smi, ref):
    """Phase 14 (a) and (c): the spatial group's steps against path C's
    one process, and its evaluate against one process's."""
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.train.evaluate import evaluate

    torch.backends.cuda.matmul.allow_tf32 = False    # as main() and the
    torch.backends.cudnn.allow_tf32 = False          # ranks have them
    ecfg = _st_cfg(ST_EVAL, False)
    sd = build_generator(ecfg.model, device="cuda:0", seed=5).state_dict()
    torch.save(sd, tmp / "eval_gen.pt")
    t0 = time.perf_counter()
    want_eval = evaluate(ecfg, sd, device="cuda:0")
    one_eval_s = time.perf_counter() - t0
    del sd
    torch.save(ref["batches"], tmp / "batches.pt")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, ranks = _spawn_gloo(torch, tmp, _st_rank_jobs, lambda: None)
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    one = ref["metrics"]
    _require(r0["metrics"] == r1["metrics"],
             f"spatial training: the ranks return other metrics "
             f"{r0['metrics']} / {r1['metrics']}")
    gaps = {k: max(abs(m[k] - w[k]) / max(abs(w[k]), 1.0)
                   for m, w in zip(r0["metrics"], one)) for k in one[0]}
    param = torch.cat([(r0["g_params"][k] - v).abs().flatten()
                       for k, v in ref["g_params"].items()])
    param_max = param.max().item()
    param_frac = (param <= ST_PARAM_ATOL).float().mean().item()
    cfg = _st_cfg(ST_TRAIN, False)
    bound = 2 * len(one) * cfg.train.g_lr
    finite = all(np.isfinite(v) for m in r0["metrics"] for v in m.values())
    n_steps = len(one)
    launches_ok = all(r["launches"][k] == per * n_steps for r in ranks
                      for k, per in ST_ROWS.items())
    per = r0["steps"]
    eval_gap = {k: abs(r0["eval"][k] - w) / max(abs(w), 1e-12)
                for k, w in want_eval.items()}
    print(f"[14] (a) places512_deepfill 1x2048² bf16 over "
          f"train.mesh.spatial=2 (two gloo ranks on cuda:0, one row band of "
          f"1024 rows each), {n_steps} steps from step 0 (lazy R1) on path "
          f"C's batches against path C's one process: metrics finite "
          f"{finite}, max |a−b|/max(|b|,1) {max(gaps.values()):.3e} (tol "
          f"{ST_METRIC_TOL:.3e}; g_loss {gaps['g_loss']:.3e}, d_loss "
          f"{gaps['d_loss']:.3e}), G parameters max abs diff "
          f"{param_max:.3e} (bound {bound:.1e}), "
          f"{100 * param_frac:.4f} % within {ST_PARAM_ATOL} (need "
          f"{100 * ST_PARAM_FRAC} %); launches per rank over {n_steps} "
          f"steps {[r['launches'] for r in ranks]} (per step "
          f"{ST_ROWS}); ms per step {[round(s['ms'], 1) for s in per]} "
          f"(path C one process {[round(t, 1) for t in ref['step_ms']]}; "
          f"step 0 with R1 and cuDNN tuning of both ranks at once); "
          f"exchanges and buffer bytes per step of rank 0 "
          f"{[{k: v for k, v in s.items() if k != 'ms'} for s in per]} "
          f"(gloo stages each through the host: a check, not a rate of "
          f"NCCL); peak memory per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB (path C one "
          f"process {ref['peak_gib']:.2f}); {wall:.1f} s with spawn | {smi}")
    print(f"[14] (c) evaluate places512_deepfill float32 256², 2 batches of "
          f"2, over train.mesh.spatial=2: {r0['eval']} against one process "
          f"{want_eval}: relative gaps "
          f"{ {k: float(f'{v:.3e}') for k, v in eval_gap.items()} } (tol "
          f"{ST_EVAL_REL}); ranks equal {r0['eval'] == r1['eval']}; "
          f"exchanges {r0['eval_exchanges']}; {r0['eval_s']:.1f} s (one "
          f"process {one_eval_s:.1f} s, both with cuDNN tuning) | {smi}")
    _require(finite and launches_ok,
             f"spatial training: finite {finite}, launches "
             f"{[r['launches'] for r in ranks]}, expected per step {ST_ROWS}")
    _require(all(s["unsharded_steps"] == 0 and s["halo_exchanges"] > 0
                 and s["row_reduces"] > 0 for s in per),
             f"spatial training: exchanges {per}")
    _require(max(gaps.values()) <= ST_METRIC_TOL and param_max <= bound
             and param_frac >= ST_PARAM_FRAC,
             "the spatial group's steps disagree with one process")
    _require(r0["eval"] == r1["eval"] and set(r0["eval"]) == set(want_eval)
             and max(eval_gap.values()) <= ST_EVAL_REL,
             "evaluate over the spatial group disagrees with one process")
    return dict(metric_gaps=gaps, param_max=param_max,
                param_frac=param_frac, steps=per,
                launches=[r["launches"] for r in ranks],
                peak_gib=[r["peak_gib"] for r in ranks], wall_s=wall,
                eval=r0["eval"], eval_one=want_eval, eval_gaps=eval_gap,
                eval_exchanges=r0["eval_exchanges"])


def _sdpa_backward_ms(torch, q, k, valid, v, g):
    """SDPA's autograd backward over the same attention (additive −1e9
    mask; never called by the port), timed once after a warm-up, with the
    backend PyTorch's dispatcher picks: (backend, ms), or (reason, None)
    where no backend holds the call."""
    import torch.nn.functional as F

    mask = torch.where(valid, 0.0, -1e9).to(q.dtype)[:, None, None, :]
    leaves = [t[:, None].detach().requires_grad_(True) for t in (q, k, v)]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            y = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                               scale=10.0)
        ms = _time_ms(torch, lambda: torch.autograd.grad(
            y, leaves, g[:, None], retain_graph=True), 1)
    except RuntimeError as e:
        return f"refused: {str(e)[:80]}", None
    backend = "?"
    try:    # the backend PyTorch's dispatcher picks for this call
        from torch.nn.attention import SDPBackend

        choice = int(torch._fused_sdp_choice(*leaves, mask, 0.0, False,
                                             scale=10.0))
        backend = next((n for n, be in SDPBackend.__members__.items()
                        if int(be.value) == choice), backend)
    except (AttributeError, TypeError, RuntimeError, ImportError):
        pass
    del y, leaves, mask
    return backend, ms


def _st_kernels(torch, smi):
    """Phase 14 (b): the patch dQ and dK/dV kernels (rows 10, 11) at a
    member's shapes against their plain versions over chunks of query
    rows, with their times, the plain backward's, SDPA's autograd
    backward and the bounds."""
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        launch_dkv,
        launch_dq,
        patch_attention_bwd_plain,
    )

    b, lq, lk = ST_KERNEL_SHAPE
    d, dv = 1728, 3072
    q, k, v, g, valid = _patch_inputs(torch, 29, b, lq, lk, d, dv,
                                      torch.bfloat16, dead=False)
    got = _patch_kernels(torch, q, k, valid, v, g)
    torch.cuda.synchronize()
    errs = _patch_errors(torch, q, k, valid, v, g, got, ST_PLAIN_CHUNK)
    _patch_require(errs, False, f"patch backward B{b} Lq{lq} Lk{lk}")
    out, lse = got[0], got[1]
    del got
    delta = (g.float() * out.float()).sum(-1)

    def plain():
        dk = dv_ = None
        for c0 in range(0, lq, ST_PLAIN_CHUNK):
            sl = slice(c0, c0 + ST_PLAIN_CHUNK)
            dq, dk_c, dv_c = patch_attention_bwd_plain(
                q[:, sl], k, valid, v, out[:, sl], lse[:, sl], g[:, sl],
                softmax_scale=10.0)
            dk = dk_c.float() if dk is None else dk.add_(dk_c)
            dv_ = dv_c.float() if dv_ is None else dv_.add_(dv_c)
        return dk, dv_

    ms = {"dq": _time_ms(torch, lambda: launch_dq(
              q, k, valid, v, g, lse, delta, 10.0), 2),
          "dkv": _time_ms(torch, lambda: launch_dkv(
              q, k, valid, v, g, lse, delta, 10.0), 2)}
    plain_ms = _time_ms(torch, plain, 1)
    backend, sdpa_bwd = _sdpa_backward_ms(torch, q, k, valid, v, g)
    bounds = _patch_bounds(valid, lq, d, dv, 2)
    rows = {}
    for kname, err in (("dq", errs["dq"]), ("dkv", max(
            errs["dk"], errs["dv"], key=lambda e: e[0] / max(e[1], 1.0)))):
        n_bytes, n_ops = bounds[kname]
        bound, by = _bound_ms(n_bytes, n_ops, H100_BF16_FLOPS)
        rows[kname] = dict(
            ms=ms[kname], plain_ms=plain_ms, library_ms=sdpa_bwd,
            library=f"SDPA ({backend}), additive mask, autograd backward: "
                    "dq, dk and dv in one call, one timed run",
            bound_ms=bound, bound_by=by, max_abs_err=err[0],
            max_abs_err_of=err[1], tflops=n_ops / (ms[kname] * 1e-3) / 1e12,
            shape=f"B{b} Lq{lq} Lk{lk} d{d} dv{dv}")
        print(f"[14] (b) patch_attention_bwd_{kname} B{b} Lq{lq} Lk{lk} "
              f"d{d} dv{dv} bf16 (a spatial-2 member's shapes): max abs err "
              f"{err[0]:.3e} of max|ref| {err[1]:.3e} (tol "
              f"{BWD_BF16_TOL_FRAC} of it); kernel {ms[kname]:.2f} ms "
              f"({rows[kname]['tflops']:.1f} TFLOP/s of valid pairs), "
              f"bound {bound:.2f} by {by}; plain backward over chunks of "
              f"{ST_PLAIN_CHUNK} query rows {plain_ms:.2f}, SDPA "
              f"({backend}) autograd backward "
              f"{'n/a' if sdpa_bwd is None else f'{sdpa_bwd:.2f}'} | {smi}")
    del q, k, v, g, valid, out, lse, delta
    torch.cuda.empty_cache()
    return rows


def spatial_training(torch, smi, ref):
    """Phase 14: training and evaluating over the mesh's spatial axis: (a)
    the 2048² step over a spatial group of two ranks against path C's one
    process, (b) rows 10 and 11 at a member's shapes, (c) evaluate over
    the group against one process."""
    import pathlib
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_st_"))
    try:
        a = _st_train(torch, tmp, smi, ref)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    b = _st_kernels(torch, smi)
    wall = time.perf_counter() - t0
    print(f"[14] phase 14 took {wall:.1f} s")
    return dict(train_2048=a, kernels=b, phase_s=wall)


# the bench module's returned keys (gan_inpainting_tpu/bench.py:98-105,
# :169-176)
BENCH_INFER_KEYS = {"metric", "value", "unit", "total_images_per_sec",
                    "batch", "chips"}
BENCH_TRAIN_KEYS = {"metric", "value", "unit", "images_per_sec", "batch",
                    "chips"}
# (b): the infer256 operating point of the top-level bench.py (:134-139)
BENCH_INFER_POINT = dict(batch=128, iters=10, warmup=2)
# (c): steps per run; R1 (every 16th step) opens each of the 4 runs, and
# the same windows are timed again without R1 (step 0 always takes it
# while γ > 0)
BENCH_TRAIN_ITERS = 10
BENCH_NO_R1 = ["loss.r1_gamma=0"]


def _bench_command(torch, argv, keys, smi):
    """``cli.main(argv)`` in this process: one JSON line with ``keys`` and
    a finite, positive value; the launches of its run."""
    import contextlib
    import io

    from gan_inpainting_torch import cli
    from gan_inpainting_torch.ops import dispatch

    out = io.StringIO()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in dispatch.launches.items() if v}
    lines = out.getvalue().splitlines()
    _require(rc == 0 and len(lines) == 1,
             f"{' '.join(argv)}: rc {rc}, output {lines}")
    res = json.loads(lines[0])
    _require(set(res) == keys and np.isfinite(res["value"])
             and res["value"] > 0, f"{' '.join(argv)}: {res}")
    print(f"[15] (a) {' '.join(argv)} in {wall:.1f} s: {lines[0]}; "
          f"launches {launched} | {smi}")
    return dict(res, launches=launched, wall_s=wall)


def bench_phase(torch, smi, serve_ips, step_ms, launches_512, steps_512):
    """Phase 15: the bench module and CLI command (gan_inpainting_torch/
    bench.py): (a) ``bench --mode infer|train`` in this process, (b) the
    top-level bench.py's infer256 point, its launches, and its body on one
    pool batch against the same weights on the plain route, (c)
    ``places512_deepfill`` steps/s over windows that open with R1 and over
    the same windows without it, each launching per step what phase [4]'s
    ``steps_512`` steps launched (``launches_512``)."""
    from gan_inpainting_torch import bench
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.losses import adversarial
    from gan_inpainting_torch.ops import dispatch

    t0 = time.perf_counter()
    # ---- (a) the command -------------------------------------------------
    a_infer = _bench_command(torch, ["bench", "--config", "serve_v4_8",
                                     "--mode", "infer"], BENCH_INFER_KEYS,
                             smi)
    a_train = _bench_command(torch, ["bench", "--mode", "train",
                                     "data.batch_size=32"], BENCH_TRAIN_KEYS,
                             smi)
    torch.cuda.empty_cache()

    # ---- (b) infer256: serve_v4_8, 128×256², 10 batches, 2 warm passes ---
    cfg = get_config("serve_v4_8")
    point = BENCH_INFER_POINT
    t_b = time.perf_counter()
    dispatch.reset_launches()
    r_b = bench.bench_infer(cfg, **point)
    torch.cuda.synchronize()
    launched_b = {k: v for k, v in dispatch.launches.items() if v}
    wall_b = time.perf_counter() - t_b
    forwards = (point["warmup"] + 1) * point["iters"]
    for name in ("contextual_attention_fused", "fold_taps"):
        _require(launched_b.get(name, 0) == forwards,
                 f"bench_infer: {name} launched {launched_b.get(name, 0)} "
                 f"times in {forwards} forwards")
    _require(set(r_b) == BENCH_INFER_KEYS and np.isfinite(r_b["value"])
             and r_b["value"] > 0, f"bench_infer: {r_b}")
    # the body once more on the pool's first batch (the same draws), and
    # through the same weights on the plain route (model.kernel_backend=
    # xla: no kernel launched), holes within ±2 on ≥ 99.9 % as in [5]
    state = bench.create_state(cfg, seed=0, device="cuda")
    plain = build_generator(cfg.model, device="cuda", backend="xla")
    plain.load_state_dict(state.generator.state_dict())
    images, masks = bench.make_pool(cfg, point["batch"], 1,
                                    torch.device("cuda"))
    with torch.inference_mode():
        out = bench.bench_forward(state.generator.eval(), images[0],
                                  masks[0])
        dispatch.reset_launches()
        want = bench.bench_forward(plain.eval(), images[0], masks[0])
        torch.cuda.synchronize()
    _require(not any(dispatch.launches.values()),
             f"the plain route launched {dict(dispatch.launches)}")
    keep = (masks[0] <= 0).expand_as(images[0])
    _require(torch.equal(out[keep], images[0][keep]),
             "bench body changed known pixels")
    agree = _hole_agreement(out.cpu().numpy(), want.cpu().numpy(),
                            masks[0, ..., 0].cpu().numpy())
    _require(agree["within_2"] >= 0.999,
             f"bench body against the plain route: {agree}")
    del state, plain, images, masks, out, want, keep
    torch.cuda.empty_cache()
    print(f"[15] (b) bench_infer serve_v4_8 {point['batch']}x256² bf16, "
          f"{point['iters']} batches, {point['warmup']} warm passes, in "
          f"{wall_b:.1f} s: {r_b['value']:.1f} img/s (phase [3]'s device "
          f"forward at 64x256²: {serve_ips:.1f} img/s); launches "
          f"{launched_b}; known pixels bit-exact; holes against the plain "
          f"route {agree} | {smi}")

    # ---- (c) places512_deepfill, 8×512², 4 runs of 10 steps from 0 -------
    # with R1 at step 0 of each run, then the same runs without R1
    r1_calls = []
    r1_penalty = adversarial.r1_penalty

    def counted(*args, **kwargs):
        r1_calls.append(1)
        return r1_penalty(*args, **kwargs)

    steps = 4 * BENCH_TRAIN_ITERS
    # what [4]'s steps launched, scaled to the bench's 40 (R1 launches no
    # ported kernel: D has no attention)
    want = {k: v * steps // steps_512 for k, v in launches_512.items() if v}
    _require(all(v * steps % steps_512 == 0 for v in launches_512.values()),
             f"phase [4]'s launches are not per step: {launches_512}")
    runs = {}
    for case, over in (("r1", []), ("no_r1", BENCH_NO_R1)):
        cfg = apply_overrides(get_config("places512_deepfill"), over)
        r1_calls.clear()
        t_c = time.perf_counter()
        dispatch.reset_launches()
        adversarial.r1_penalty = counted
        try:
            r_c = bench.bench_train(cfg, iters=BENCH_TRAIN_ITERS)
        finally:
            adversarial.r1_penalty = r1_penalty
        torch.cuda.synchronize()
        launched_c = {k: v for k, v in dispatch.launches.items() if v}
        wall_c = time.perf_counter() - t_c
        _require(launched_c == want,
                 f"bench_train ({case}): launches {launched_c} in {steps} "
                 f"steps, phase [4]'s per step give {want}")
        n_r1 = 4 if case == "r1" else 0
        _require(len(r1_calls) == n_r1, f"bench_train ({case}): "
                 f"{len(r1_calls)} R1 passes in 4 runs, expected {n_r1}")
        _require(set(r_c) == BENCH_TRAIN_KEYS and np.isfinite(r_c["value"])
                 and r_c["value"] > 0, f"bench_train ({case}): {r_c}")
        ms = 1e3 / r_c["value"]
        runs[case] = dict(r_c, launches=launched_c, wall_s=wall_c,
                          r1_passes=len(r1_calls), ms_per_step=ms)
        print(f"[15] (c) bench_train places512_deepfill {case} "
              f"{cfg.data.batch_size}x512² bf16, best of 3 runs of "
              f"{BENCH_TRAIN_ITERS} steps (R1 γ {cfg.loss.r1_gamma} every "
              f"{cfg.loss.r1_interval}) "
              f"in {wall_c:.1f} s: {r_c['value']:.3f} steps/s = {ms:.1f} "
              f"ms/step; launches {launched_c} | {smi}")
    r1_ms = BENCH_TRAIN_ITERS * (runs["r1"]["ms_per_step"]
                                 - runs["no_r1"]["ms_per_step"])
    print(f"[15] (c) R1 costs the window {r1_ms:.1f} ms (R1 window − window "
          f"without R1); phase [4]'s step without R1: {step_ms:.1f} ms, the "
          f"bench's {runs['no_r1']['ms_per_step']:.1f} ms | {smi}")
    wall = time.perf_counter() - t0
    print(f"[15] phase 15 took {wall:.1f} s")
    return dict(cli_infer_256_b32=a_infer, cli_train_128_b32=a_train,
                infer_256_b128=dict(r_b, launches=launched_b, wall_s=wall_b,
                                    serve_64x256_forward_img_s=serve_ips,
                                    holes_vs_plain=agree),
                train_512_b8=dict(runs["r1"],
                                  no_r1=runs["no_r1"],
                                  r1_ms_per_window=r1_ms,
                                  phase4_no_r1_ms_per_step=step_ms),
                phase_s=wall)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    ends: dict[str, float] = {}

    def lap(phase: str) -> None:
        """Print and keep the script's seconds at the end of ``phase``."""
        torch.cuda.empty_cache()
        ends[phase] = time.perf_counter() - t_start
        print(f"[t] {phase} ended at {ends[phase]:.1f} s")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import gan_inpainting_torch  # noqa: F401  (fails outside the repo)
    from gan_inpainting_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] device {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
          f"cuDNN convs and matmuls")
    build_s = build.build_all()
    print(f"[1] built {', '.join(build.SOURCES)} with nvcc in "
          f"{build_s:.1f} s")
    for name, log in build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[1] ptxas {name}: {len(regs)} kernels, e.g. "
              f"{regs[0] if regs else 'no ptxas report'}")
    # the gated-conv kernels one by one, and the wgmma instructions in the
    # SASS of each bf16 variant
    hgmma = {fn: n for fn, n in build.sass_counts("gated_conv",
                                                  "HGMMA").items()}
    for fn, used, spills in build.ptxas_report("gated_conv"):
        short = fn[fn.find("gated_"):].split("EE")[0]   # name + template
        print(f"[1] ptxas gated_conv {short}: {used}; {spills}; "
              f"HGMMA in SASS {hgmma.get(fn, 0)}")
    for line in build.build_log.get("gated_conv", "").splitlines():
        if "warning" in line.lower() or "serialized" in line:
            print(f"[1] ptxas gated_conv: {line.strip()}")
    _require(all(n > 0 for fn, n in hgmma.items() if "wgmma" in fn)
             and any("wgmma" in fn for fn in hgmma),
             "the bf16 gated-conv kernels hold no HGMMA instruction")
    # the attention forwards' wgmma mainloop (csrc/attention_wgmma.cuh):
    # one instance per mode (0 fused, 1 patch) and cluster size
    for src in ("contextual_attention", "patch_attention"):
        hg = build.sass_counts(src, "HGMMA")
        tma = build.sass_counts(src, "UTMALDG")
        rows = [r for r in build.ptxas_report(src)
                if "attention_wgmma" in r[0]]
        for fn, used, spills in rows:
            short = fn[fn.find("attention_wgmma"):].split("EEv")[0]
            print(f"[1] ptxas {src} {short}: {used}; {spills}; HGMMA "
                  f"{hg.get(fn, 0)}, UTMALDG {tma.get(fn, 0)} in SASS")
        _require(len(rows) == 4 and all(
            hg.get(fn, 0) > 0 and tma.get(fn, 0) > 0
            and " 0 bytes spill stores" in spills
            for fn, _, spills in rows),
            f"the {src} wgmma forward lacks HGMMA or UTMALDG, or spills")
    # the patch backward's mainloop (csrc/attention_bwd_wgmma.cuh): dQ (0)
    # and dK/dV (1) at clusters of 1, 2, 4, 8 and 16, and the profiling
    # instances that count their phases' cycles (true) at 2 and 16
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        wgmma_bwd_clusters,
    )

    hg = build.sass_counts("patch_attention", "HGMMA")
    tma = build.sass_counts("patch_attention", "UTMALDG")
    rows = [r for r in build.ptxas_report("patch_attention")
            if "attention_bwd_kernel" in r[0]]
    for fn, used, spills in rows:
        short = fn[fn.find("attention_bwd_kernel"):].split("EEv")[0]
        print(f"[1] ptxas patch_attention {short}: {used}; {spills}; HGMMA "
              f"{hg.get(fn, 0)}, UTMALDG {tma.get(fn, 0)} in SASS")
    _require(len(rows) == 14 and all(
        hg.get(fn, 0) > 0 and tma.get(fn, 0) > 0
        and " 0 bytes spill stores" in spills for fn, _, spills in rows),
        "the patch wgmma backward lacks HGMMA or UTMALDG, or spills")
    # the fused backward's wgmma kernels (csrc/contextual_attention_bwd.cu):
    # the score tiles, the tap products at 64, 128 and 192 channels × dQ /
    # dK/dV
    hg = build.sass_counts("contextual_attention_bwd", "HGMMA")
    tma = build.sass_counts("contextual_attention_bwd", "UTMALDG")
    rows = [r for r in build.ptxas_report("contextual_attention_bwd")
            if "scores_kernel" in r[0] or "products_kernel" in r[0]]
    for fn, used, spills in rows:
        short = fn[fn.find("mat") + 4:].split("EE")[0]
        print(f"[1] ptxas contextual_attention_bwd {short}: {used}; "
              f"{spills}; HGMMA {hg.get(fn, 0)}, UTMALDG {tma.get(fn, 0)} "
              "in SASS")
    _require(len(rows) == 7 and all(
        hg.get(fn, 0) > 0 and tma.get(fn, 0) > 0
        and " 0 bytes spill stores" in spills for fn, _, spills in rows),
        "the fused wgmma backward lacks HGMMA or UTMALDG, or spills")
    resident = {w: wgmma_bwd_clusters(w, 1728, 3072) for w in ("dq", "dkv")}
    print(f"[1] patch backward at d1728 dv3072: clusters of 16 resident at "
          f"once {resident}")
    _require(all(n > 0 for n in resident.values()),
             "the patch backward's clusters of 16 do not fit the card")

    rng = np.random.default_rng(0)
    lap("[1] build")
    res256 = check_kernels(torch, "256² (B=8, 64x64x192)", 8, 64, 192, rng,
                           smi)
    res512 = check_kernels(torch, "512² (B=2, 128x128x192)", 2, 128, 192,
                           rng, smi)
    fold = check_fold(torch, rng, smi)
    bwd256 = check_backward(torch, "256² train (B=16, 64x64x192)", 16, 64,
                            192, rng, smi)
    bwd512 = check_backward(torch, "512² train (B=8, 128x128x192)", 8, 128,
                            192, rng, smi)
    # the published width's C 96 (the benchmark's cells): rows 1, 2, 4, 5
    # at the 64x256² serve bucket's map and the 8x512² train map, on a
    # generator of their own so that the rows above keep their draws
    rng96 = np.random.default_rng(96)
    res256_96 = check_kernels(torch, "64x256² serve (B=64, 64x64x96)", 64,
                              64, 96, rng96, smi)
    res512_96 = check_kernels(torch, "8x512² train (B=8, 128x128x96)", 8,
                              128, 96, rng96, smi)
    bwd512_96 = check_backward(torch, "512² train (B=8, 128x128x96)", 8,
                               128, 96, rng96, smi)
    conv = check_conv_kernels(torch, rng, smi)
    torch.cuda.empty_cache()
    patch = check_patch_kernels(torch, smi)
    routes = compare_routes(torch, smi)
    lap("[2] kernels")
    at_256, at_512, (img1, msk1, cpu_f32), fwd_ips = serve(torch, rng, smi)
    lap("[3] serve")
    tr = train(torch, smi)
    lap("[4] train")
    path_a, rates_a = serve_kernel_backend(torch, rng, smi, img1, msk1,
                                           cpu_f32)
    lap("[5] path A")
    path_b = partial_family(torch, rng, smi)
    lap("[6] path B")
    large = path_c(torch, rng, smi)
    st_ref = large.pop("_spatial_ref")      # phase 14's reference
    lap("[7] path C")
    service = serving_tier(torch, rng, smi)
    svc = service["mixed"]["launches_by_bucket"]
    lap("[8] serving tier")
    files = file_data(torch, smi)
    fl = files["launches"]            # phase 9's train() from the folder
    lap("[9] file data")
    dp = data_parallel(torch, rng, smi)
    # path F: each gloo rank's train() (4 steps and an eval; rank 0 also
    # the sample grid), counted in the rank's own process
    path_f = {f"path_f_rank{r}": launches
              for r, launches in enumerate(dp["b"]["launches"])}
    lap("[10] data parallel")
    aot = aot_artifacts(torch, rng, smi)
    lap("[11] aot")
    ma = model_axis(torch, rng, smi)
    ma_serve = ma["serve"]["pallas"]
    lap("[12] model axis")
    sp = spatial_axis(torch, rng, smi)
    lap("[13] spatial axis")
    st = spatial_training(torch, smi, st_ref)
    del st_ref
    lap("[14] spatial training")
    bn = bench_phase(torch, smi, fwd_ips, tr["ms_512"], tr["launches_512"],
                     tr["steps_512"])
    lap("[15] bench")

    def through_bench(kernel, infer=True, train=True):
        """Launches of ``kernel`` in phase 15's (b) and (c)."""
        return {"bench_infer_256_b128": bn["infer_256_b128"]["launches"].get(
                    kernel, 0) if infer else 0,
                "bench_train_512_b8": bn["train_512_b8"]["launches"].get(
                    kernel, 0) if train else 0}

    def through_spatial(kernel):
        """Launches per forward of ``kernel`` on path I (phase 13), by
        group and bucket: (a) the 2048² request, (c) serve_v4_8's."""
        got = {f"2048_spatial{n}": sp["serve_2048"][n]["launches"][kernel]
               for n in SP_GROUPS}
        for backend, by_bucket in sp["serve_v4_8"].items():
            for bucket, r in by_bucket.items():
                got[f"{bucket}_{backend}_spatial2"] = r["launches_two"][
                    kernel]
        return got

    def through_group(kernel):
        """Launches per forward of ``kernel`` through phase 12's group of
        two under pallas, by bucket."""
        return {bucket: r["launches_two"][kernel]
                for bucket, r in ma_serve.items()}

    def slice_forms(route):
        return [r for r in ma["slice_kernels"]
                if r["form"].startswith(route)]

    def through_aot(kernel):
        """Launches per forward of ``kernel`` through each exported
        bucket of phase 11 where it launched."""
        return {f"{case}@{bucket}": r["launches_per_forward"][kernel]
                for case, c in aot["cases"].items()
                for bucket, r in c["buckets"].items()
                if r["launches_per_forward"].get(kernel)}

    def by_path(name):
        return {k: v.get(name, 0) for k, v in path_f.items()}

    def row(name, kernel, res, launches, source, replaces, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, **res[kernel],
                    **extra)

    attn_src = "gan_inpainting_torch/csrc/attention_wgmma.cuh"
    fold_src = "gan_inpainting_torch/csrc/fold.cu"
    tpu_fa = "gan_inpainting_tpu/ops/pallas/fused_attention.py"
    bwd_src = "gan_inpainting_torch/csrc/contextual_attention_bwd.cu"
    conv_src = "gan_inpainting_torch/csrc/gated_conv.cu"
    tpu_bwd = "gan_inpainting_tpu/ops/pallas/fused_attention_bwd.py"
    l256, l512 = tr["launches_256"], tr["launches_512"]
    kernels = [
        row("contextual_attention_fused@256", "attention", res256,
            at_256["contextual_attention_fused"], attn_src, f"{tpu_fa}:136",
            launches_train=l256["contextual_attention_fused"],
            launches_service=svc[256]["contextual_attention_fused"],
            launches_aot=through_aot("contextual_attention_fused"),
            launches_model_axis=through_group("contextual_attention_fused"),
            launches_by_path=through_bench("contextual_attention_fused",
                                           train=False),
            train_with_lse_ms=bwd256["forward_with_lse_ms"],
            at_published_width=res256_96["attention"]),
        row("contextual_attention_fused@512", "attention", res512,
            at_512["contextual_attention_fused"], attn_src, f"{tpu_fa}:52",
            launches_train=l512["contextual_attention_fused"],
            launches_service=svc[512]["contextual_attention_fused"],
            launches_file_train=fl["contextual_attention_fused"],
            launches_by_path={
                **by_path("contextual_attention_fused"),
                **through_bench("contextual_attention_fused", infer=False)},
            launches_aot=through_aot("contextual_attention_fused"),
            train_with_lse_ms=bwd512["forward_with_lse_ms"],
            at_published_width=dict(
                res512_96["attention"],
                train_with_lse_ms=bwd512_96["forward_with_lse_ms"])),
        # the fold at B 8 (the 256² map) with the 64x256² serve bucket
        # under "at_64x256", and at the 8x512² train map
        row("fold_taps@256", "b8_256", fold, at_256["fold_taps"], fold_src,
            "gan_inpainting_tpu/ops/pallas/fold.py:32",
            launches_train=l256["fold_taps"], at_64x256=fold["b64_256"],
            launches_service=svc[256]["fold_taps"],
            launches_aot=through_aot("fold_taps"),
            launches_model_axis=through_group("fold_taps"),
            launches_by_path=through_bench("fold_taps", train=False)),
        row("fold_taps@512train", "b8_512train", fold, at_512["fold_taps"],
            fold_src, "gan_inpainting_tpu/ops/pallas/fold.py:32",
            launches_train=l512["fold_taps"],
            launches_service=svc[512]["fold_taps"],
            launches_file_train=fl["fold_taps"],
            launches_by_path={**by_path("fold_taps"),
                              **through_bench("fold_taps", infer=False)},
            launches_aot=through_aot("fold_taps")),
        # the fused backward: rows 4 (δ, the score tiles and the dQ
        # products; "replaces" _bwd_dq_kernel) and 5 (the dK/dV products),
        # at the 256² train shape with the 512² one under "at_512train";
        # launches from phase [4]'s 256² and 512² steps
    ]
    for kname in ("delta", "scores", "dq", "dkv"):
        name = f"contextual_attention_bwd_{kname}"
        kernels.append(row(
            f"{name}@256train", kname, bwd256, l256.get(name, 0), bwd_src,
            f"{tpu_bwd}:{223 if kname == 'dkv' else 148}",
            at_512train=dict(bwd512[kname], launches=l512.get(name, 0)),
            at_512train_published_width=dict(
                bwd512_96[kname], kernels_ms=bwd512_96["kernels_ms"],
                core_kernels_ms=bwd512_96["core_kernels_ms"]),
            launches_file_train=fl.get(name, 0),
            launches_by_path={**by_path(name), **through_bench(name)}))
    # the tap-gradient fold: the scatter that _bwd_dq_kernel (:148) and
    # _bwd_dkv_kernel (:223) do in-kernel, with the XLA halo merge and
    # norm correction (:311, :328)
    name = "contextual_attention_bwd_fold"
    kernels.append(row(
        f"{name}@256train", "fold", bwd256, l256.get(name, 0), fold_src,
        f"{tpu_bwd}:148", scatter_of=[f"{tpu_bwd}:{n}" for n in (
            148, 223, 311, 328)],
        at_512train=dict(bwd512["fold"], launches=l512.get(name, 0)),
        launches_file_train=fl.get(name, 0),
        launches_by_path={**by_path(name), **through_bench(name)}))
    kernels += [
        # launches: path A's three requests (two forwards with the fused
        # decoder, one without) and path B's three
        row("gated_conv_direct@192x2x192_3x3_64x64²", "direct_d1", conv,
            path_a["gated_conv_direct"], conv_src,
            "gan_inpainting_tpu/ops/pallas/direct_conv.py:48",
            launches_aot=through_aot("gated_conv_direct"),
            launches_model_axis=through_group("gated_conv_direct"),
            launches_spatial=through_spatial("gated_conv_direct"),
            at_model_axis_slices=slice_forms("direct"),
            also={k: conv[k] for k in (
                "direct_d16", "direct_stem", "direct_f96", "direct_f24",
                "direct_c384", "direct_relu")}),
        row("gated_matmul@96x2x192_3x3_s2_64x128²", "matmul_s2", conv,
            path_a["gated_matmul"], conv_src,
            "gan_inpainting_tpu/ops/pallas/fused_matmul.py:76",
            launches_aot=through_aot("gated_matmul"),
            launches_model_axis=through_group("gated_matmul"),
            launches_spatial=through_spatial("gated_matmul"),
            at_model_axis_slices=slice_forms("matmul"),
            also={"matmul_c48": conv["matmul_c48"]}),
        row("partial_epilogue@C48_64x256²", "partial_c48", conv,
            path_b["serve_launches"]["partial_epilogue"],
            "gan_inpainting_torch/csrc/partial_epilogue.cu",
            "gan_inpainting_tpu/ops/pallas/fused_matmul.py:207",
            launches_train=path_b["train_launches"]["partial_epilogue"],
            launches_aot=through_aot("partial_epilogue"),
            also={"partial_c192": conv["partial_c192"]}),
    ]
    # ms, bound, plain and library at B 2, L 16 384 (the dense plain
    # version fits there); the 2048² map's own shape under "at_2048_map".
    # launches: the 512² serve bucket and train steps ([3], [4]), path C's
    # one 1×2048² request and its two train steps ([7])
    tpu_pa = "gan_inpainting_tpu/ops/pallas/patch_attention.py"
    bwd_wgmma_src = "gan_inpainting_torch/csrc/attention_bwd_wgmma.cuh"
    trained = large["train_launches"]
    for name, kname, line in (("patch_attention_fwd", "fwd", 64),
                              ("patch_attention_bwd_dq", "dq", 156),
                              ("patch_attention_bwd_dkv", "dkv", 186)):
        by_path = dict(serve_512=at_512.get(name, 0),
                       train_512=l512.get(name, 0),
                       serve_2048=large["serve_launches"].get(name, 0),
                       train_2048=trained.get(name, 0))
        if kname == "fwd":
            by_path.update({f"spatial_{k}": v for k, v in
                            through_spatial(name).items()})
        kernels.append(row(
            f"{name}@B2_L16384", kname, patch, sum(by_path.values()),
            attn_src if kname == "fwd" else bwd_wgmma_src, f"{tpu_pa}:{line}",
            launches_by_path=by_path, launches_aot=through_aot(name)))
    # row 9 at the spatial axis's shapes (phase 13 (b)): a member's local
    # query rows against every key; launches: path I's 2048² requests
    sp_k = sp["kernel"]

    def through_spatial_training(name):
        """Launches of ``name`` by each rank of phase 14 (a)'s group over
        its steps."""
        return {f"train_2048_spatial2_rank{r}": launches[name]
                for r, launches in enumerate(st["train_2048"]["launches"])}

    kernels.append(dict(
        name="patch_attention_fwd@spatial_B1_Lq32768_Lk65536", route="cuda",
        source=attn_src, replaces=f"{tpu_pa}:64",
        launches=sum(sp["serve_2048"][n]["launches"]["patch_attention_fwd"]
                     for n in SP_GROUPS) + sum(through_spatial_training(
                         "patch_attention_fwd").values()),
        **sp_k["B1_Lq32768_Lk65536"],
        at_B8_Lq512_Lk1024=sp_k["B8_Lq512_Lk1024"],
        launches_by_path={**through_spatial("patch_attention_fwd"),
                          **through_spatial_training("patch_attention_fwd")}))
    # rows 10 and 11 at the same member's shapes (phase 14 (b)); launches:
    # phase 14 (a)'s spatial training, both ranks
    for kname, line in (("dq", 156), ("dkv", 186)):
        name = f"patch_attention_bwd_{kname}"
        by_rank = through_spatial_training(name)
        kernels.append(dict(
            name=f"{name}@spatial_B1_Lq32768_Lk65536", route="cuda",
            source=bwd_wgmma_src, replaces=f"{tpu_pa}:{line}",
            launches=sum(by_rank.values()), **st["kernels"][kname],
            launches_by_path=by_rank))
    print(json.dumps({"kernels": kernels, "card": smi, "large_map": {
        **large,
        "routes": routes,
        "patch_whole_backward_ms": patch["bwd_ms"],
        "patch_checks": patch["checks"]}, "train": {
        "places512_deepfill_8x512_ms_per_step": tr["ms_512"],
        "places512_deepfill_8x512_gated_conv_turns_ms": tr["gated_turns_512"],
        "celebahq256_attention_16x256_ms_per_step": tr["ms_256"],
        "phases_ms_512": tr["parts_512"], "phases_ms_256": tr["parts_256"],
        "partialconv256_16x256_ms_per_step": path_b["train_ms"]},
        "serve_64x256": {"serve_v4_8": rates_a,
                         "partialconv256": path_b["rates"]},
        "service": service, "file_data": files, "data_parallel": dp,
        "aot": aot, "model_axis": ma, "spatial_axis": sp,
        "spatial_training": st, "bench": bn, "phase_end_s": ends}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
