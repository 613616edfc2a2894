#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device and build: the card's name and power limit, and the build of
   every CUDA kernel from ``gan_inpainting_torch/csrc`` with nvcc;
2. kernels against their plain PyTorch versions on the card, at the
   256² serve shape (B=8, map 64×64×192) and the 512² shape (B=2, map
   128×128×192), in float32 and bfloat16, with times of the kernel, the
   plain version and one library call computing the same function;
3. the serve path: the pinned ``tex256_attn`` generator under the
   ``serve_v4_8`` model config, full width, through ``Inpainter`` on the
   card — launch counts, known pixels bit-exact, a float32 card-vs-CPU
   check, the latency of one 1×256² request and img/s at 64×256²
   bfloat16;
4. one JSON line of per-kernel numbers, then the result line.

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
    at_256, at_512 = serve(torch, rng, smi)

    def row(name, kernel, res, launches, source, replaces):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, **res[kernel])

    attn_src = "gan_inpainting_torch/csrc/contextual_attention.cu"
    fold_src = "gan_inpainting_torch/csrc/fold.cu"
    tpu_fa = "gan_inpainting_tpu/ops/pallas/fused_attention.py"
    kernels = [
        row("contextual_attention_fused@256", "attention", res256,
            at_256["contextual_attention_fused"], attn_src, f"{tpu_fa}:136"),
        row("contextual_attention_fused@512", "attention", res512,
            at_512["contextual_attention_fused"], attn_src, f"{tpu_fa}:52"),
        row("fold_taps@256", "fold", res256, at_256["fold_taps"], fold_src,
            "gan_inpainting_tpu/ops/pallas/fold.py:32"),
        row("fold_taps@512", "fold", res512, at_512["fold_taps"], fold_src,
            "gan_inpainting_tpu/ops/pallas/fold.py:32"),
    ]
    print(json.dumps({"kernels": kernels, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
