"""Fused contextual attention: feature map in, tap-major patches out.

``fused_attention_taps`` replaces the Pallas kernels
``_fused_kernel_singlek`` (gan_inpainting_tpu/ops/pallas/fused_attention.py:136,
the 256² serve regime) and ``_fused_kernel`` (:52, the flash regime at 512²)
with ``csrc/contextual_attention.cu``. The host prep (:func:`_prepare`)
builds the r² sub-pixel parity maps with a one-cell halo, the hole bias
and the key reciprocal norms; the kernel builds every Q/K/V tile from the
maps, so no patch tensor and no (Lq, Lk) score matrix reaches device
memory.

The kernel has two variants (:func:`plan` picks): ``wgmma`` for bf16 maps
with C % 32 == 0 and rows of 32, 64 or a multiple of 128 cells (every
serve and train map of the configs): the cluster mainloop of
``csrc/attention_wgmma.cuh``, wgmma fed by TMA, d and dv split over a
cluster of up to 8 blocks, a flash recurrence over 128-key steps, so the
TPU's two regimes are one here too; and ``core``, float32 FMAs on the CUDA
cores, whole score rows of a group of query cells in shared memory, for
every other shape and for float32. The wgmma variant cuts each tap into
⌈C/64⌉ units of 64 channels; where C is not a multiple of 64 (the
published width's C 96) the last unit's TMA box reads zeros past C, so no
padded copy of the maps is made. :func:`fused_attention_mirror` is the
wgmma variant's arithmetic in PyTorch. Bound on an H100: 2·Lq·Lk·(9 +
16)·C operations per image against a few MB of maps and output — bounded
by operations.

With ``want_lse`` (training) the kernel also writes the per-query
log-sum-exp of the scores over the valid keys, (B, Lq) float32, 0 for a
query with no valid key: the residual the backward kernels
(ops/kernels/fused_attention_bwd.py) rebuild the weights from. Serving
does not ask for it.

The wrapper calls the op ``gan_inpainting::fused_attention_taps``
(ops/kernels/library.py): its CUDA implementation runs the prep and the
launch, and adds one to the launch count where it launches, under
:data:`KERNEL` and under the variant's own name (:data:`KERNEL_WGMMA`,
:data:`KERNEL_CORE`); its CPU
implementation is :func:`fused_attention_taps_plain`, an independent
derivation from the materialized patch formulation
(ops/contextual_attention.py), not from the parity trick.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import (
    count_launch,
    interpreting,
    use_kernel,
    wants_grad,
)
from gan_inpainting_torch.ops.kernels import build, library
from gan_inpainting_torch.ops.kernels.library import empty_lse
from gan_inpainting_torch.ops.kernels.patch_attention import (
    WGMMA_UNIT,
    wgmma_cluster,
)

KERNEL = "contextual_attention_fused"
KERNEL_WGMMA = "contextual_attention_fused_wgmma"
KERNEL_CORE = "contextual_attention_fused_core"
NEG_INF = -1e9
SMEM_BYTES = 232448      # shared memory one block may opt into on Hopper
_GROUPS = (32, 16, 8, 4, 2, 1)
_CLUSTERS = (1, 2, 4, 8)              # portable thread block cluster sizes
_DTYPES = (torch.float32, torch.bfloat16)


def _group(lk: int, c: int) -> int | None:
    lk_pad = -(-lk // 4) * 4
    for g in _GROUPS:
        if g * (lk_pad + c) * 4 <= SMEM_BYTES:
            return g
    return None


def plan_group(lk: int, c: int) -> int:
    """Query cells per block of the core variant: the largest G whose
    float32 score rows (G × Lk, padded to 4) plus one staged Q tap (G × C)
    fit in shared memory. Raises for an Lk no block can hold."""
    g = _group(lk, c)
    if g is not None:
        return g
    raise ValueError(
        f"fused attention: a score row of Lk={lk} keys (C={c}) does not fit "
        f"in {SMEM_BYTES} bytes of shared memory; larger maps need the "
        "flash variant: the patch-attention kernels")


def wgmma_takes(hs: int, ws: int, c: int, rate: int,
                dtype: torch.dtype) -> int | None:
    """Cluster size of the ``wgmma`` variant (csrc/attention_wgmma.cuh) for
    a map, or None where it does not take it: bf16, C % 32 == 0, 64-query
    tiles and 128-key steps that are TMA boxes of whole map rows (ws 32, 64
    or a multiple of 128, hs·ws % 128 == 0), and a cluster whose blocks
    each hold ≤ 4 of the 9·⌈C/64⌉ d units and ≤ 6 of the 4r²·⌈C/64⌉ dv
    units (a tap's last unit is zero-filled past C)."""
    if (dtype != torch.bfloat16 or c <= 0 or c % 32 or (hs * ws) % 128
            or not (ws in (32, 64) or ws % 128 == 0)):
        return None
    cpt = -(-c // WGMMA_UNIT)
    return wgmma_cluster(9 * cpt, 4 * rate * rate * cpt)


def _plan(hs: int, ws: int, c: int, dtype: torch.dtype,
          rate: int = 2) -> tuple[str, int, int] | None:
    cl = wgmma_takes(hs, ws, c, rate, dtype)
    if cl is not None:
        return "wgmma", 64, cl
    g = _group(hs * ws, c)
    return None if g is None else ("core", g, 1)


def plan(hs: int, ws: int, c: int, dtype: torch.dtype,
         rate: int = 2) -> tuple[str, int, int]:
    """(variant, G, cluster): the ``wgmma`` variant (64 query cells per
    cluster of blocks that split d and dv, a flash recurrence over the
    keys, so any map size) where :func:`wgmma_takes` holds; else ``core``
    with G query cells per block, their whole score rows in shared memory,
    and no cluster. Raises for a map neither holds."""
    return (_plan(hs, ws, c, dtype, rate)
            or ("core", plan_group(hs * ws, c), 1))


def fused_supported(shape, ksize: int, rate: int,
                    dtype: torch.dtype) -> bool:
    """Whether the fused kernel takes a (B, H, W, C) feature map on the
    card: ksize 3, H and W divisible by ``rate``, C % 4 == 0, a dtype it
    takes, and a map :func:`plan` can hold. Elsewhere contextual attention
    goes through the patch-attention kernels
    (ops/kernels/patch_attention.py)."""
    _, h, w, c = shape
    if (ksize != 3 or h % rate or w % rate or c % 4
            or dtype not in _DTYPES):
        return False
    return _plan(h // rate, w // rate, c, dtype, rate) is not None


# Largest bf16 map, in query cells (hs·ws), on which contextual attention
# that a backward follows takes the fused route: the fused route is the
# faster one at every size measured, up to 16 384 cells (the 1024² image),
# since its backward runs on materialized score tiles (wgmma + TMA,
# csrc/contextual_attention_bwd.cu). Measured on one NVIDIA H100 80GB
# HBM3, 700.00 W (tools/bench_attention.py --cases fused_bwd, B 2, C 192,
# bf16, forward + backward, the routes in turns fused, patch, patch,
# fused; two runs, the second of the kernels as they stand): at 1024
# cells 5.20 / 2.85 and 2.67 / 3.24 ms vs 7.54 / 9.75 and 5.75 / 7.11; at
# 2048 cells 4.00 / 4.03 and 2.21 / 2.07 vs 9.76 / 9.39 and 7.81 / 7.53;
# at 4096 cells 6.04 / 5.62 and 5.64 / 5.33 vs 21.31 / 21.03 and 20.91 /
# 20.62; at 8192 cells 18.67 / 18.19 and 18.76 / 17.97 vs 67.11 / 67.87
# and 67.77 / 67.61; at 16 384 cells 68.63 / 68.23 and 67.31 / 67.10 vs
# 244.58 / 244.60 and 246.17 / 244.88. Larger maps (the 2048² image's
# 65 536 cells) were not measured; there one sample's scores exceed the
# backward's scratch budget, so they stay on the patch route.
FUSED_MAX_CELLS = 16384
# The same for a float32 map: the fused forward's CUDA-core variant ties
# the patch route at 1024 cells, is faster at 2048 (8.53 / 9.38 vs 9.50 /
# 10.24 ms) and slower from 4096 up (52.46 / 51.99 vs 32.10 / 31.45),
# chip_smoke.py phase [2] on the same card; its backward is the core
# kernels'.
FUSED_MAX_CELLS_F32 = 2048
# The same for a bf16 forward that no backward follows (serving, the
# train step's forward without gradient): at 4096 cells the fused route's
# forward is the faster one. The 512² serve bucket's device forward
# (tools/bench_serve.py, the same card, both limits in turns a b b a):
# B 64 419.68 / 418.91 ms with the fused route vs 428.07 / 427.86 with
# the patch route, B 8 54.14 / 54.13 vs 55.35 / 55.32, B 1 8.14 / 8.12 vs
# 10.78 / 8.39. Above 4096 cells the routes' forwards tie (8192: 11.79 /
# 11.78 vs 12.14 / 12.18 ms; 16 384: 42.42 / 42.88 vs 42.12 / 42.25,
# chip_smoke.py phase [2]).
FUSED_MAX_CELLS_BF16_FORWARD = 4096


def fused_route(shape, ksize: int, rate: int, dtype: torch.dtype,
                backward: bool = True) -> bool:
    """Whether contextual attention with queries = keys takes the fused
    route: :func:`fused_supported` and at most :data:`FUSED_MAX_CELLS`
    cells for a bf16 map that a backward follows,
    :data:`FUSED_MAX_CELLS_BF16_FORWARD` for one that no backward follows
    (``backward`` False), :data:`FUSED_MAX_CELLS_F32` for float32."""
    _, h, w, _ = shape
    if dtype != torch.bfloat16:
        limit = FUSED_MAX_CELLS_F32
    else:
        limit = FUSED_MAX_CELLS if backward else FUSED_MAX_CELLS_BF16_FORWARD
    return (fused_supported(shape, ksize, rate, dtype)
            and (h // rate) * (w // rate) <= limit)


def _prepare(b_feat: torch.Tensor, hole_mask: torch.Tensor, ksize: int,
             rate: int):
    """Host prep → (maps, bias, rnorm, (hs, ws)).

    maps (B, r, r, hs+2, ws+2, C): maps[:, a, b][cell] =
    b_feat[(cell−1)·r + a, (cell−1)·r + b], zero outside, so map (0, 0) is
    the rate-downscaled map with a one-cell halo. bias (B, Lk) float32: 0
    for a valid key, −1e9 for a key whose window touches a hole. rnorm
    (B, Lk) float32: 1 / max(||key patch||, 1e-4), the patch norm taken as
    a window sum of per-cell squared norms.
    """
    from gan_inpainting_torch.ops.contextual_attention import (
        downscale_mask_max,
        key_validity,
    )

    bsz, h, w, c = b_feat.shape
    hs, ws = h // rate, w // rate
    s2d = b_feat.reshape(bsz, hs, rate, ws, rate, c).permute(0, 2, 4, 1, 3, 5)
    maps = F.pad(s2d, (0, 0, 1, 1, 1, 1)).contiguous()

    hole_s = downscale_mask_max(hole_mask.float(), rate)
    key_valid = key_validity(hole_s, ksize)
    bias = torch.where(key_valid, 0.0, NEG_INF).to(torch.float32)

    lo, hi = (ksize - 1) // 2, ksize // 2
    b_s = b_feat[:, ::rate, ::rate, :].float()
    px2 = torch.sum(b_s * b_s, -1)[:, None]                 # (B, 1, hs, ws)
    n2 = F.avg_pool2d(F.pad(px2, (lo, hi, lo, hi)), ksize, 1,
                      divisor_override=1)
    rnorm = 1.0 / torch.clamp(torch.sqrt(n2).reshape(bsz, hs * ws), min=1e-4)
    return maps, bias.contiguous(), rnorm.contiguous(), (hs, ws)


def fused_attention_taps_plain(b_feat: torch.Tensor, hole_mask: torch.Tensor,
                               *, ksize: int = 3, rate: int = 2,
                               softmax_scale: float = 10.0,
                               want_lse: bool = False):
    """The same function from the patch formulation: (B, 4r², Lq, C); with
    ``want_lse`` also the (B, Lq) float32 log-sum-exp of the scaled scores
    over the valid keys, 0 for a query with no valid key."""
    from gan_inpainting_torch.ops.contextual_attention import (
        _attention_inputs,
    )
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        patch_attention_plain,
    )

    q, k, valid, v, _ = _attention_inputs(b_feat, b_feat, hole_mask, ksize,
                                          rate)
    yp = patch_attention_plain(q, k, valid, v, softmax_scale=softmax_scale)
    bsz, lq, _ = yp.shape
    c = b_feat.shape[-1]
    taps = yp.reshape(bsz, lq, 4 * rate * rate, c).permute(0, 2, 1, 3) \
        .contiguous()
    if not want_lse:
        return taps
    scores = softmax_scale * torch.matmul(q.float(),
                                          k.float().transpose(1, 2))
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    return taps, torch.where(valid.any(-1, keepdim=True), lse, 0.0)


def fused_attention_mirror(maps, bias, rnorm, hs: int, ws: int, rate: int,
                           scale: float, *, cluster: int,
                           block_c: int = 128, unit: int = 64):
    """The wgmma variant's arithmetic (csrc/attention_wgmma.cuh, kFused) in
    PyTorch on prepared inputs (:func:`_prepare`) → (taps (B, 4r², Lq, C)
    in the maps' dtype, lse (B, Lq) float32).

    d is cut into ``unit``-wide (tap, channel) units in tap-major order,
    ⌈C/unit⌉ per tap, the last one narrower where ``unit`` does not divide
    C (the kernel's box reads zeros there, which add nothing); the
    ``cluster`` ranks hold units [r·n1/CL, (r+1)·n1/CL) and the scores of a
    step are their partial contractions summed in rank order. Steps of
    ``block_c`` keys: s = S·(rnorm·scale) + bias, running max m, α =
    exp(m_old − m_new), p = exp(s − m_new) on valid keys, the sum l
    rescaled by α and given p unrounded, every tap's accumulator rescaled
    by α and given bf16(p)·V_tap (p rounded to the maps' dtype), V_tap a
    shifted window of parity map (par, off). Then out = acc / l and lse = m
    + log l, both 0 where l = 0."""
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    mf = maps.float()
    qk = [mf[:, 0, 0, dp:dp + hs, dq:dq + ws].reshape(bsz, lk, c)
          for dp in range(3) for dq in range(3)]
    units = [(t, c0) for t in range(9) for c0 in range(0, c, unit)]
    n1 = len(units)
    ranks = [units[r * n1 // cluster:(r + 1) * n1 // cluster]
             for r in range(cluster)]
    half = rate // 2
    vt = []
    for tap in range(4 * rate * rate):
        vp, vq = divmod(tap, 2 * rate)
        pp, op = (vp - half + rate) % rate, (vp - half + rate) // rate
        pq, oq = (vq - half + rate) % rate, (vq - half + rate) // rate
        vt.append(mf[:, pp, pq, op:op + hs, oq:oq + ws].reshape(bsz, lk, c))
    m = torch.full((bsz, lk, 1), -1e30, device=maps.device)
    l_ = torch.zeros((bsz, lk, 1), device=maps.device)
    acc = torch.zeros((bsz, len(vt), lk, c), device=maps.device)
    for k0 in range(0, lk, block_c):
        ks = slice(k0, k0 + block_c)
        s = None
        for rank in ranks:
            part = torch.zeros((bsz, lk, min(block_c, lk - k0)),
                               device=maps.device)
            for t, c0 in rank:
                cs = slice(c0, c0 + unit)
                part = part + torch.matmul(qk[t][..., cs],
                                           qk[t][:, ks, cs].transpose(1, 2))
            s = part if s is None else s + part
        s = s * (rnorm[:, None, ks] * scale) + bias[:, None, ks]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(bias[:, None, ks] >= 0, torch.exp(s - m_new), 0.0)
        l_ = l_ * alpha + p.sum(-1, keepdim=True)
        pr = p.to(maps.dtype).float()
        acc = acc * alpha[:, None] + torch.stack(
            [torch.matmul(pr, v[:, ks]) for v in vt], 1)
        m = m_new
    inv = torch.where(l_ > 0, 1.0 / torch.clamp(l_, min=1e-30), 0.0)
    lse = torch.where(l_ > 0, m + torch.log(torch.clamp(l_, min=1e-30)),
                      0.0)
    return (acc * inv[:, None]).to(maps.dtype), lse[..., 0]


def _launch(maps: torch.Tensor, bias: torch.Tensor, rnorm: torch.Tensor,
            hs: int, ws: int, rate: int, scale: float,
            variant: str | None = None, want_lse: bool = False):
    """Launch the kernel on prepared inputs; ``variant`` overrides
    :func:`plan`'s choice (the card's tests run both). With ``want_lse``
    the kernel also writes the per-query log-sum-exp and the call returns
    (taps, lse (B, Lq) float32)."""
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    if tuple(maps.shape) != (bsz, rate, rate, hs + 2, ws + 2, c):
        raise ValueError(f"maps shape {tuple(maps.shape)} does not match "
                         f"hs={hs} ws={ws} rate={rate}")
    for name, t in (("bias", bias), ("rnorm", rnorm)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (bsz, lk)
                or t.device != maps.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 (B, Lk) on "
                             f"{maps.device}")
    if not maps.is_contiguous():
        raise ValueError("maps must be contiguous")
    if c % 4:
        raise ValueError(f"fused attention kernel needs C % 4 == 0, got {c}")
    chosen, group, cluster = plan(hs, ws, c, maps.dtype, rate)
    if variant is not None and variant != chosen:
        if variant == "core":
            group, cluster = plan_group(lk, c), 1
        else:
            raise ValueError(f"the {variant} variant does not take hs={hs} "
                             f"ws={ws} C={c} {maps.dtype}")
    variant = variant or chosen
    out = torch.empty((bsz, 4 * rate * rate, lk, c), dtype=maps.dtype,
                      device=maps.device)
    lse = (torch.empty((bsz, lk), dtype=torch.float32, device=maps.device)
           if want_lse else None)
    lib = build.library("contextual_attention")
    stream = torch.cuda.current_stream(maps.device).cuda_stream
    lse_ptr = lse.data_ptr() if want_lse else None
    if variant == "wgmma":
        fn = lib.gi_fused_attention_wgmma
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        with torch.cuda.device(maps.device):
            err = fn(maps.data_ptr(), bias.data_ptr(), rnorm.data_ptr(),
                     out.data_ptr(), lse_ptr, bsz, hs, ws, c, rate,
                     float(scale), cluster, stream)
    else:
        fn = lib.gi_fused_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        with torch.cuda.device(maps.device):
            err = fn(maps.data_ptr(), bias.data_ptr(), rnorm.data_ptr(),
                     out.data_ptr(), lse_ptr, bsz, hs, ws, c, rate,
                     float(scale), int(maps.dtype == torch.bfloat16), group,
                     stream)
    count_launch(KERNEL)
    count_launch(KERNEL_WGMMA if variant == "wgmma" else KERNEL_CORE)
    build.check(lib, err, KERNEL)
    return (out, lse) if want_lse else out


def _check_taps(b_feat, hole_mask, ksize):
    if ksize != 3:
        raise ValueError("the fused kernel builds 3x3 Q/K taps from a "
                         f"one-cell halo; got ksize={ksize}")
    if b_feat.dtype not in _DTYPES:
        raise TypeError(f"fused attention kernel takes {_DTYPES}, got "
                        f"{b_feat.dtype}")
    if hole_mask.device != b_feat.device:
        raise ValueError("hole_mask and b_feat must be on one device")


def _taps_mirror(b_feat, hole_mask, ksize, rate, softmax_scale, want_lse):
    """The kernel's mirror at the cluster its plan picks."""
    _check_taps(b_feat, hole_mask, ksize)
    maps, bias, rnorm, (hs, ws) = _prepare(b_feat, hole_mask, ksize, rate)
    cluster = plan(hs, ws, b_feat.shape[-1], b_feat.dtype, rate)[2]
    taps, lse = fused_attention_mirror(maps, bias, rnorm, hs, ws, rate,
                                       softmax_scale, cluster=cluster)
    return taps, (lse if want_lse else empty_lse(taps))


def _taps_cpu(b_feat, hole_mask, ksize, rate, softmax_scale, want_lse):
    """The op on the CPU: the plain version (the mirror inside
    ``interpret_kernels``)."""
    if interpreting():
        return _taps_mirror(b_feat, hole_mask, ksize, rate, softmax_scale,
                            want_lse)
    out = fused_attention_taps_plain(b_feat, hole_mask, ksize=ksize,
                                     rate=rate, softmax_scale=softmax_scale,
                                     want_lse=want_lse)
    return out if want_lse else (out, empty_lse(out))


def _taps_cuda(b_feat, hole_mask, ksize, rate, softmax_scale, want_lse):
    """The op on the card: host prep and one launch (the mirror inside
    ``interpret_kernels``)."""
    if interpreting():
        return _taps_mirror(b_feat, hole_mask, ksize, rate, softmax_scale,
                            want_lse)
    _check_taps(b_feat, hole_mask, ksize)
    maps, bias, rnorm, (hs, ws) = _prepare(b_feat, hole_mask, ksize, rate)
    out = _launch(maps, bias, rnorm, hs, ws, rate, softmax_scale,
                  want_lse=want_lse)
    return out if want_lse else (out, empty_lse(out))


def _taps_fake(b_feat, hole_mask, ksize, rate, softmax_scale, want_lse):
    bsz, h, w, c = b_feat.shape
    lq = (h // rate) * (w // rate)
    taps = b_feat.new_empty((bsz, 4 * rate * rate, lq, c))
    lse = (b_feat.new_empty((bsz, lq), dtype=torch.float32) if want_lse
           else empty_lse(b_feat))
    return taps, lse


_op = library.implement("fused_attention_taps",
                        source="contextual_attention", cpu=_taps_cpu,
                        cuda=_taps_cuda, fake=_taps_fake)


def fused_attention_taps(b_feat: torch.Tensor, hole_mask: torch.Tensor, *,
                         ksize: int = 3, rate: int = 2,
                         softmax_scale: float = 10.0,
                         want_lse: bool = False):
    """Contextual attention with queries = keys = ``b_feat`` (B, H, W, C),
    hole mask (B, H, W, 1) → tap-major output patches (B, 4r², Lq, C),
    Lq = (H/r)·(W/r). Fold them with ops/kernels/fold.py ``fold_taps``.
    ``want_lse`` (training) also returns the (B, Lq) float32 log-sum-exp
    the backward kernels rebuild the weights from. The op
    ``gan_inpainting::fused_attention_taps``; where a gradient is wanted
    and no kernel would launch, its CPU implementation runs under
    autograd."""
    bsz, h, w, c = b_feat.shape
    if h % rate or w % rate:
        raise ValueError(f"spatial dims {(h, w)} must divide rate={rate}")
    if tuple(hole_mask.shape) != (bsz, h, w, 1):
        raise ValueError(f"hole_mask {tuple(hole_mask.shape)} must be "
                         f"{(bsz, h, w, 1)}")
    args = (ksize, rate, float(softmax_scale), want_lse)
    if wants_grad(b_feat) and not use_kernel(b_feat):
        taps, lse = _taps_cpu(b_feat, hole_mask, *args)
    else:
        taps, lse = _op(b_feat, hole_mask, *args)
    return (taps, lse) if want_lse else taps


class _FusedPatchAttention(torch.autograd.Function):
    """The fused kernel's output in patch-major layout; the backward
    rebuilds Q, K, V with the plain front end and differentiates the
    patch-attention kernels (gan_inpainting_tpu/ops/pallas/
    fused_attention.py ``_fused_attention_bwd``). Saves (b_feat,
    hole_mask)."""

    @staticmethod
    def forward(ctx, b_feat, hole_mask, ksize, rate, softmax_scale):
        ctx.save_for_backward(b_feat, hole_mask)
        ctx.args = (ksize, rate, softmax_scale)
        return _patch_major(fused_attention_taps(
            b_feat, hole_mask, ksize=ksize, rate=rate,
            softmax_scale=softmax_scale))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from gan_inpainting_torch.ops.contextual_attention import (
            _attention_inputs,
        )
        from gan_inpainting_torch.ops.kernels.patch_attention import attend

        b_feat, hole_mask = ctx.saved_tensors
        ksize, rate, softmax_scale = ctx.args
        with torch.enable_grad():
            x = b_feat.detach().requires_grad_(True)
            q, k, valid, v, _ = _attention_inputs(x, x, hole_mask, ksize,
                                                  rate)
            yp = attend(q, k, valid, v, softmax_scale)
            (db,) = torch.autograd.grad(yp, x, g.to(yp.dtype))
        return db, None, None, None, None


def _patch_major(taps: torch.Tensor) -> torch.Tensor:
    bsz, n_taps, lq, c = taps.shape
    return taps.permute(0, 2, 1, 3).reshape(bsz, lq, n_taps * c)


def fused_patch_attention(b_feat: torch.Tensor, hole_mask: torch.Tensor, *,
                          ksize: int = 3, rate: int = 2,
                          softmax_scale: float = 10.0) -> torch.Tensor:
    """Attention output patches (B, Lq, 4r²C) straight from the feature
    map, queries = keys = ``b_feat`` (the unfolded entry of the JAX
    package). Check :func:`fused_supported` first. Where a gradient is
    wanted it goes through the patch-attention kernels."""
    if torch.is_grad_enabled() and b_feat.requires_grad:
        return _FusedPatchAttention.apply(b_feat.contiguous(), hole_mask,
                                          ksize, rate, softmax_scale)
    return _patch_major(fused_attention_taps(
        b_feat, hole_mask, ksize=ksize, rate=rate,
        softmax_scale=softmax_scale))
