#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device and build: the card's name and power limit, and the build of
   every CUDA kernel from ``gan_inpainting_torch/csrc`` with nvcc;
2. kernels against their plain PyTorch versions on the card, at the
   256² serve shape (B=8, map 64×64×192) and the 512² shape (B=2, map
   128×128×192), in float32 and bfloat16, with times of the kernel, the
   plain version and one library call computing the same function; and
   the two attention backward kernels and the forward's log-sum-exp at
   the train shapes (256²: B=16, map 64×64×192; 512²: B=8, map
   128×128×192), with an all-hole sample;
3. the serve path: the pinned ``tex256_attn`` generator under the
   ``serve_v4_8`` model config, full width, through ``Inpainter`` on the
   card — launch counts, known pixels bit-exact, a float32 card-vs-CPU
   check, the latency of one 1×256² request and img/s at 64×256²
   bfloat16;
4. the train path: ``places512_deepfill`` at full width (512², batch 8,
   bfloat16, synthetic textured data) for 6 steps from step 0 through
   ``create_state`` / ``make_train_step`` — metrics finite, launch
   counts, parameters moved, the attention branch's gradient, a
   checkpoint round trip, steps/s split by CUDA events; the 256²
   attention config (``celebahq256_freeform`` with attention, batch 16)
   on one fixed batch with ``g_l1`` falling; and one float32 step of a
   small config on the card against the same step on the CPU;
5. one JSON line of per-kernel numbers, then the result line.

Float32 checks turn TF32 off for cuDNN convs and matmuls. Imports nothing
of JAX. Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

NPZ = "docs/artifacts/tex256_attn/generator_best.npz"
SERVE_OVERRIDES = ["model.fuse_upsample=true",
                   "infer.size_buckets=256,512",
                   "infer.batch_buckets=1,8,64"]
H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12    # HBM3
F32_TOL = 1e-3                # kernel vs plain, both float32 (see below)
BF16_TOL_FRAC = 2.0 ** -7     # of max|input|: weights and outputs in bf16
# backward kernels, as a fraction of the largest entry of the reference:
# float32 sums of up to L·C products in another order; bf16 p and dsr
BWD_F32_TOL_FRAC = 2e-4
BWD_BF16_TOL_FRAC = 2.0 ** -6
TRAIN_512 = ["data.synthetic_family=textured"]
TRAIN_256 = ["model.use_attention=true", "data.synthetic_family=textured"]


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
    taps_b = pb_ref.to(torch.bfloat16)
    fold_k = fold_taps(taps_b, hs, ws, rate)
    fold_p = fold_taps_plain(taps_b.float(), hs, ws, rate)
    errb_fold = (fold_k.float() - fold_p).abs().max().item()
    tolb_fold = BF16_TOL_FRAC * taps_b.float().abs().max().item()
    torch.cuda.synchronize()
    print(f"[2] {shape_name} attention max_abs_err f32 {err32:.3e} "
          f"(tol {F32_TOL:g}) bf16 {errb:.3e} (tol {tolb:.3e}); "
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
    attn_ops = 2.0 * bsz * lk * lk * (9 + 16) * c
    attn_bound, attn_by = _bound_ms(attn_bytes, attn_ops, H100_BF16_FLOPS)

    fold_ms = _time_ms(torch, lambda: fold_taps(taps_b, hs, ws, rate), reps)
    fold_plain_ms = _time_ms(
        torch, lambda: fold_taps_plain(taps_b, hs, ws, rate), reps)
    cols = taps_b.reshape(bsz, 4, 4, lk, c).permute(0, 4, 1, 2, 3) \
        .reshape(bsz, c * 16, lk).contiguous()
    fold_lib_ms = _time_ms(torch, lambda: F.fold(
        cols, (hw, hw), 4, padding=1, stride=2), reps)
    fold_bytes = bsz * 16 * lk * c * 2 + bsz * hw * hw * c * 2 + hw * hw * 4
    fold_ops = bsz * hw * hw * c * 5.0
    fold_bound, fold_by = _bound_ms(fold_bytes, fold_ops, H100_BF16_FLOPS)
    print(f"[2] {shape_name} bf16 ms: attention {attn_ms:.3f} ({variant} "
          f"G={group} cluster={cluster} kernel only {kernel_only_ms:.3f}, "
          f"core variant {core_ms:.3f} "
          f"err {err_core:.3e}, plain {attn_plain_ms:.3f}, sdpa "
          f"{attn_lib_ms:.3f}, bound {attn_bound:.4f} by {attn_by}); fold "
          f"{fold_ms:.4f} (plain {fold_plain_ms:.4f}, F.fold "
          f"{fold_lib_ms:.4f}, bound {fold_bound:.4f} by {fold_by}) | {smi}")
    print(f"[2] {shape_name} launches in these checks and timings "
          f"(not counted for the serve path): {dict(dispatch.launches)}")
    out["attention"] = dict(
        ms=attn_ms, variant=variant, group=group, cluster=cluster,
        kernel_only_ms=kernel_only_ms,
        core_variant_ms=core_ms, core_variant_max_abs_err=err_core,
        plain_ms=attn_plain_ms,
        library_ms=attn_lib_ms, bound_ms=attn_bound, bound_by=attn_by,
        max_abs_err=errb, max_abs_err_f32=err32)
    out["fold"] = dict(
        ms=fold_ms, plain_ms=fold_plain_ms, library_ms=fold_lib_ms,
        bound_ms=fold_bound, bound_by=fold_by, max_abs_err=errb_fold,
        max_abs_err_f32=f32_fold)
    return out


def check_backward(torch, shape_name, bsz, hw, c, rng, smi):
    """Phase 2, backward: the dQ and dK/dV kernels and the forward's lse
    against their plain versions at one train shape."""
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
        contextual_attention_bwd,
        contextual_attention_bwd_plain,
        launch_dkv,
        launch_dq,
        plan_bwd,
        prepare_bwd,
        tap_grads_mirror,
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

    def kernels(x, g, taps, lse):
        maps, gmaps, bias, rnorm, _ = prepare_bwd(x, hole[:x.shape[0]], g, 3,
                                                  rate)
        prep = (maps, gmaps, bias, rnorm, lse)
        dq, delta = launch_dq(*prep, taps, hs, ws, rate, scale)
        dk, dv, tn = launch_dkv(*prep, delta, hs, ws, rate, scale)
        return prep, (dq, delta), (dk, dv, tn)

    def worst(got, want):
        """max abs error and its tolerance base over a kernel's outputs"""
        return max(((a - b).abs().max().item()
                    / max(b.abs().max().item(), 1.0)) for a, b in zip(got,
                                                                      want))

    # ---- float32 (CUDA-core variant), three samples: no hole, all hole,
    # strokes; TF32 off --------------------------------------------------
    n32 = 3
    xs, gs, hl = x32[:n32], g32[:n32], hole[:n32]
    taps_k, lse_k = fused_attention_taps(xs, hl, want_lse=True)
    taps_p, lse_p = fused_attention_taps_plain(xs, hl, want_lse=True)
    lse_err32 = (lse_k - lse_p).abs().max().item()
    prep, dq_k, dkv_k = kernels(xs, gs, taps_p, lse_p)
    dq_m = tap_grads_mirror(*prep, taps_p, hs, ws, rate, scale, which="dq")
    dkv_m = tap_grads_mirror(*prep, taps_p, hs, ws, rate, scale, which="dkv")
    dq_err32, dkv_err32 = worst(dq_k, dq_m), worst(dkv_k, dkv_m)
    full_k = contextual_attention_bwd(xs, hl, taps_k, lse_k, gs)
    full_p = contextual_attention_bwd_plain(xs, hl, gs)
    full_err32 = ((full_k - full_p).abs().max().item()
                  / max(full_p.abs().max().item(), 1.0))
    _require(full_k[1].abs().max().item() == 0.0
             and bool(torch.isfinite(full_k).all()),
             f"all-hole gradient not exactly 0 at {shape_name}")
    del prep, dq_k, dkv_k, dq_m, dkv_m, taps_k, taps_p

    # ---- bfloat16 (tensor-core variant), the whole batch, against the
    # mirror in float32 on the same bf16 values -------------------------
    xb, gb = x32.to(torch.bfloat16), g32
    taps_b, lse_b = fused_attention_taps(xb, hole, want_lse=True)
    _, lse_bp = fused_attention_taps_plain(xb.float(), hole, want_lse=True)
    lse_errb = (lse_b - lse_bp).abs().max().item()
    prep, dq_k, dkv_k = kernels(xb, gb, taps_b, lse_b)
    maps, gmaps, bias, rnorm, _ = prep
    dq_m = tap_grads_mirror(maps.float(), gmaps.float(), bias, rnorm, lse_b,
                            taps_b.float(), hs, ws, rate, scale, which="dq")
    dq_errb = worst(dq_k, dq_m)
    del dq_m
    dkv_m = tap_grads_mirror(maps, gmaps, bias, rnorm, lse_b, taps_b, hs, ws,
                             rate, scale, which="dkv")
    dkv_errb = worst(dkv_k, dkv_m)
    del dkv_m
    _require(all(t[1].abs().max().item() == 0.0
                 for t in (dq_k[0], dkv_k[0], dkv_k[1])),
             f"all-hole tap gradients not exactly 0 at {shape_name}")
    torch.cuda.synchronize()
    print(f"[2] {shape_name} backward, error / max|reference|: f32 dq "
          f"{dq_err32:.3e} dkv {dkv_err32:.3e} whole {full_err32:.3e} (tol "
          f"{BWD_F32_TOL_FRAC:g}); bf16 dq {dq_errb:.3e} dkv {dkv_errb:.3e} "
          f"(tol {BWD_BF16_TOL_FRAC:.3e}); lse max abs err f32 "
          f"{lse_err32:.3e} bf16 {lse_errb:.3e} (tol 1e-3 / 2e-2); all-hole "
          f"sample exactly 0")
    _require(max(dq_err32, dkv_err32, full_err32) <= BWD_F32_TOL_FRAC
             and max(dq_errb, dkv_errb) <= BWD_BF16_TOL_FRAC
             and lse_err32 <= 1e-3 and lse_errb <= 2e-2,
             f"a backward kernel or lse disagrees at {shape_name}")

    # ---- times, bf16, the train batch -----------------------------------
    reps = 5 if lk <= 1024 else 2
    delta = dq_k[1]
    dq_ms = _time_ms(torch, lambda: launch_dq(
        maps, gmaps, bias, rnorm, lse_b, taps_b, hs, ws, rate, scale), reps)
    dkv_ms = _time_ms(torch, lambda: launch_dkv(
        maps, gmaps, bias, rnorm, lse_b, delta, hs, ws, rate, scale), reps)
    whole_ms = _time_ms(torch, lambda: contextual_attention_bwd(
        xb, hole, taps_b, lse_b, gb), reps)
    fwd_lse_ms = _time_ms(torch, lambda: fused_attention_taps(
        xb, hole, want_lse=True), reps)
    fwd_ms = _time_ms(torch, lambda: fused_attention_taps(xb, hole), reps)
    dq_plain_ms = _time_ms(torch, lambda: tap_grads_mirror(
        maps, gmaps, bias, rnorm, lse_b, taps_b, hs, ws, rate, scale,
        which="dq"), 2)
    dkv_plain_ms = _time_ms(torch, lambda: tap_grads_mirror(
        maps, gmaps, bias, rnorm, lse_b, taps_b, hs, ws, rate, scale,
        which="dkv"), 2)
    whole_plain_ms = _time_ms(torch, lambda: contextual_attention_bwd_plain(
        xb, hole, gb), 2)
    # library yardstick (never called by the port): autograd through SDPA
    # over materialized patch Q/K/V; it yields dQ, dK and dV in one call,
    # so both kernels are held against the same time
    q, k, valid, v, _ = _attention_inputs(xb, xb, hole, 3, rate)
    q, k, v = (t.detach()[:, None].requires_grad_(True) for t in (q, k, v))
    sdpa_mask = valid[:, None, None, :].clone()
    sdpa_mask[1] = True       # no all-masked rows: SDPA gives NaN there
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                         scale=scale)
    go = torch.randn_like(out)
    lib_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, (q, k, v), go, retain_graph=True), 2)
    del out, q, k, v, go

    taps = 4 * rate * rate
    map_bytes = 2 * maps.numel() * 2 + 3 * bsz * lk * 4
    dq_bound, dq_by = _bound_ms(
        map_bytes + taps_b.numel() * 2 + bsz * 9 * lk * c * 4,
        2.0 * bsz * lk * lk * c * (9 + taps + 9), H100_BF16_FLOPS)
    dkv_bound, dkv_by = _bound_ms(
        map_bytes + bsz * (9 + taps) * lk * c * 4,
        2.0 * bsz * lk * lk * c * (9 + 2 * taps + 9), H100_BF16_FLOPS)
    vq, gq, cq = plan_bwd(hs, ws, c, torch.bfloat16, "dq")
    vk, gk, ck = plan_bwd(hs, ws, c, torch.bfloat16, "dkv")
    print(f"[2] {shape_name} backward bf16 ms: dq {dq_ms:.3f} ({vq} G={gq} "
          f"cluster={cq}, mirror {dq_plain_ms:.3f}, bound {dq_bound:.4f} by "
          f"{dq_by}); dkv {dkv_ms:.3f} ({vk} G={gk} cluster={ck}, mirror "
          f"{dkv_plain_ms:.3f}, bound "
          f"{dkv_bound:.4f} by {dkv_by}); whole backward with prep and "
          f"epilogue {whole_ms:.3f} (plain autograd {whole_plain_ms:.3f}, "
          f"SDPA backward over patches {lib_ms:.3f}); forward with lse "
          f"{fwd_lse_ms:.3f} vs without {fwd_ms:.3f} | {smi}")
    return {
        "dq": dict(ms=dq_ms, variant=vq, group=gq, cluster=cq,
                   plain_ms=dq_plain_ms,
                   library_ms=lib_ms, bound_ms=dq_bound, bound_by=dq_by,
                   max_abs_err=dq_errb, max_abs_err_f32=dq_err32,
                   err_is="fraction of max|reference|"),
        "dkv": dict(ms=dkv_ms, variant=vk, group=gk, cluster=ck,
                    plain_ms=dkv_plain_ms,
                    library_ms=lib_ms, bound_ms=dkv_bound, bound_by=dkv_by,
                    max_abs_err=dkv_errb, max_abs_err_f32=dkv_err32,
                    err_is="fraction of max|reference|"),
        "whole_backward_ms": whole_ms, "whole_plain_ms": whole_plain_ms,
        "forward_with_lse_ms": fwd_lse_ms, "forward_ms": fwd_ms,
    }


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
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.tools.profile_train import (
        SectionTimer,
        time_steps,
    )

    at = state.step
    state.step = 1
    ms = time_steps(step_fn, state, batches, n)
    timer = SectionTimer()
    dispatch.set_section_hook(timer)
    state.step = 1
    for i in range(n):
        step_fn(state, batches[i % len(batches)])
    parts = {k: v / n for k, v in timer.totals().items()}
    dispatch.set_section_hook(None)
    state.step = at
    return ms, parts


def train(torch, smi):
    """Phase 4: the train path on the card."""
    import tempfile

    from gan_inpainting_torch.io.checkpoint import CheckpointManager
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import composite

    names = ("contextual_attention_fused", "fold_taps",
             "contextual_attention_bwd_dq", "contextual_attention_bwd_dkv")
    per_step = dict(zip(names, (2, 2, 1, 1)))

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
    n_steps = 6
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
    ms_512, parts_512 = _timed_steps(torch, step_fn, state, batches, 4)
    print(f"[4] attention-branch gradient Σ|g| {gsum:.4g}; checkpoint saved "
          f"and restored equal; {cfg.data.batch_size}x512² bf16 "
          f"{ms_512:.1f} ms/step = {1e3 / ms_512:.3f} steps/s (steps "
          f"without R1, after warm-up); phases ms "
          f"{ {k: round(v, 1) for k, v in parts_512.items()} }; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB "
          f"| {smi}")
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
        _require(launches_256.get(name, 0) == per_step[name] * n_fixed,
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
    return dict(launches_512=launches_512, launches_256=launches_256,
                ms_512=ms_512, ms_256=ms_256, parts_512=parts_512,
                parts_256=parts_256)


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
    for name in ("contextual_attention_fused", "fold_taps"):
        _require(at_256.get(name, 0) > 0 and at_512.get(name, 0) > 0,
                 f"serve path did not launch {name}")

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
    return at_256, at_512


def main() -> int:
    import torch

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

    rng = np.random.default_rng(0)
    res256 = check_kernels(torch, "256² (B=8, 64x64x192)", 8, 64, 192, rng,
                           smi)
    res512 = check_kernels(torch, "512² (B=2, 128x128x192)", 2, 128, 192,
                           rng, smi)
    bwd256 = check_backward(torch, "256² train (B=16, 64x64x192)", 16, 64,
                            192, rng, smi)
    bwd512 = check_backward(torch, "512² train (B=8, 128x128x192)", 8, 128,
                            192, rng, smi)
    torch.cuda.empty_cache()
    at_256, at_512 = serve(torch, rng, smi)
    torch.cuda.empty_cache()
    tr = train(torch, smi)

    def row(name, kernel, res, launches, source, replaces, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, **res[kernel],
                    **extra)

    attn_src = "gan_inpainting_torch/csrc/contextual_attention.cu"
    fold_src = "gan_inpainting_torch/csrc/fold.cu"
    tpu_fa = "gan_inpainting_tpu/ops/pallas/fused_attention.py"
    bwd_src = "gan_inpainting_torch/csrc/contextual_attention_bwd.cu"
    tpu_bwd = "gan_inpainting_tpu/ops/pallas/fused_attention_bwd.py"
    l256, l512 = tr["launches_256"], tr["launches_512"]
    kernels = [
        row("contextual_attention_fused@256", "attention", res256,
            at_256["contextual_attention_fused"], attn_src, f"{tpu_fa}:136",
            launches_train=l256["contextual_attention_fused"],
            train_with_lse_ms=bwd256["forward_with_lse_ms"]),
        row("contextual_attention_fused@512", "attention", res512,
            at_512["contextual_attention_fused"], attn_src, f"{tpu_fa}:52",
            launches_train=l512["contextual_attention_fused"],
            train_with_lse_ms=bwd512["forward_with_lse_ms"]),
        row("fold_taps@256", "fold", res256, at_256["fold_taps"], fold_src,
            "gan_inpainting_tpu/ops/pallas/fold.py:32",
            launches_train=l256["fold_taps"]),
        row("fold_taps@512", "fold", res512, at_512["fold_taps"], fold_src,
            "gan_inpainting_tpu/ops/pallas/fold.py:32",
            launches_train=l512["fold_taps"]),
        row("contextual_attention_bwd_dq@256train", "dq", bwd256,
            l256["contextual_attention_bwd_dq"], bwd_src, f"{tpu_bwd}:148"),
        row("contextual_attention_bwd_dq@512train", "dq", bwd512,
            l512["contextual_attention_bwd_dq"], bwd_src, f"{tpu_bwd}:148"),
        row("contextual_attention_bwd_dkv@256train", "dkv", bwd256,
            l256["contextual_attention_bwd_dkv"], bwd_src, f"{tpu_bwd}:223"),
        row("contextual_attention_bwd_dkv@512train", "dkv", bwd512,
            l512["contextual_attention_bwd_dkv"], bwd_src, f"{tpu_bwd}:223"),
    ]
    print(json.dumps({"kernels": kernels, "card": smi, "train": {
        "places512_deepfill_8x512_ms_per_step": tr["ms_512"],
        "celebahq256_attention_16x256_ms_per_step": tr["ms_256"],
        "phases_ms_512": tr["parts_512"], "phases_ms_256": tr["parts_256"]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
