"""Fused contextual attention: feature map in, tap-major patches out.

``fused_attention_taps`` replaces the Pallas kernels
``_fused_kernel_singlek`` (gan_inpainting_tpu/ops/pallas/fused_attention.py:136,
the 256² serve regime) and ``_fused_kernel`` (:52, the flash regime at 512²)
with one CUDA kernel, ``csrc/contextual_attention.cu``. The host prep
(:func:`_prepare`) builds the r² sub-pixel parity maps with a one-cell
halo, the hole bias and the key reciprocal norms; the kernel builds every
Q/K/V tile from the maps, so no patch tensor and no (Lq, Lk) score matrix
reaches device memory. The whole score row of a group of G query cells
sits in shared memory — one block's, or split over a cluster of blocks —
which is why the TPU's two regimes collapse into one here.

The kernel has two variants (:func:`plan` picks): ``mma``, bf16 tensor-core
tiles, for the serve shapes (bf16, C % 64 == 0, ws % 32 == 0, Lk % 256 ==
0), with the keys split over a cluster of up to 8 blocks where one block
cannot hold 32 score rows; and ``core``, float32 FMAs on the CUDA cores,
one block per group, for every other shape and for float32. Bound on an
H100: 2·Lq·Lk·(9 + 16)·C
operations per image against a few MB of maps and output — bounded by
operations.

With ``want_lse`` (training) the kernel also writes the per-query
log-sum-exp of the scores over the valid keys, (B, Lq) float32, 0 for a
query with no valid key: the residual the backward kernels
(ops/kernels/fused_attention_bwd.py) rebuild the weights from. Serving
does not ask for it.

On a CPU tensor the wrapper takes :func:`fused_attention_taps_plain`, an
independent derivation from the materialized patch formulation
(ops/contextual_attention.py), not from the parity trick.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import count_launch, use_kernel
from gan_inpainting_torch.ops.kernels import build

KERNEL = "contextual_attention_fused"
NEG_INF = -1e9
SMEM_BYTES = 232448      # shared memory one block may opt into on Hopper
_GROUPS = (32, 16, 8, 4, 2, 1)
_CLUSTERS = (1, 2, 4, 8)              # portable thread block cluster sizes
_VARIANTS = {"core": 0, "mma": 1}
_MMA_WARPS = 8
_DTYPES = (torch.float32, torch.bfloat16)


def plan_group(lk: int, c: int) -> int:
    """Query cells per block of the core variant: the largest G whose
    float32 score rows (G × Lk, padded to 4) plus one staged Q tap (G × C)
    fit in shared memory. Raises for an Lk no block can hold."""
    lk_pad = -(-lk // 4) * 4
    for g in _GROUPS:
        if g * (lk_pad + c) * 4 <= SMEM_BYTES:
            return g
    raise ValueError(
        f"fused attention: a score row of Lk={lk} keys (C={c}) does not fit "
        f"in {SMEM_BYTES} bytes of shared memory; larger maps need the "
        "flash variant (ROADMAP Queue 2)")


def _mma_smem_bytes(g: int, lb: int) -> int:
    """Shared memory of one mma block: float32 scores plus bf16 weights of
    G rows × lb keys, an 8×32 float staging tile per warp, and the rows'
    partial max and sum."""
    return 6 * g * lb + _MMA_WARPS * 8 * 32 * 4 + 2 * g * 4


def plan(hs: int, ws: int, c: int,
         dtype: torch.dtype) -> tuple[str, int, int]:
    """(variant, G, cluster): the tensor-core ``mma`` variant where its
    tiles fit the shape, with G query cells per cluster of blocks that
    split the Lk keys between them (the largest G, then the smallest
    cluster, whose per-block share of the score rows fits in shared
    memory); else ``core`` with G query cells per block and no cluster."""
    lk = hs * ws
    if (dtype == torch.bfloat16 and c % 64 == 0 and ws % 32 == 0
            and lk % 256 == 0):
        for g in (32, 16, 8):
            for cl in _CLUSTERS:
                if (lk % (256 * cl) == 0
                        and _mma_smem_bytes(g, lk // cl) <= SMEM_BYTES):
                    return "mma", g, cl
    return "core", plan_group(lk, c), 1


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
        _patch_attention_plain,
    )

    q, k, valid, v, _ = _attention_inputs(b_feat, b_feat, hole_mask, ksize,
                                          rate)
    yp = _patch_attention_plain(q, k, valid, v, softmax_scale)
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
    chosen, group, cluster = plan(hs, ws, c, maps.dtype)
    if variant is not None and variant != chosen:
        if variant == "core":
            group, cluster = plan_group(lk, c), 1
        else:
            raise ValueError(f"the mma variant does not take hs={hs} ws={ws} "
                             f"C={c} {maps.dtype}")
    variant = variant or chosen
    out = torch.empty((bsz, 4 * rate * rate, lk, c), dtype=maps.dtype,
                      device=maps.device)
    lse = (torch.empty((bsz, lk), dtype=torch.float32, device=maps.device)
           if want_lse else None)
    lib = build.library("contextual_attention")
    fn = lib.gi_fused_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(maps.device).cuda_stream
    with torch.cuda.device(maps.device):
        err = fn(maps.data_ptr(), bias.data_ptr(), rnorm.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if want_lse else None, bsz,
                 hs, ws, c, rate, float(scale),
                 int(maps.dtype == torch.bfloat16), _VARIANTS[variant], group,
                 cluster, stream)
    count_launch(KERNEL)
    build.check(lib, err, KERNEL)
    return (out, lse) if want_lse else out


def fused_attention_taps(b_feat: torch.Tensor, hole_mask: torch.Tensor, *,
                         ksize: int = 3, rate: int = 2,
                         softmax_scale: float = 10.0,
                         want_lse: bool = False):
    """Contextual attention with queries = keys = ``b_feat`` (B, H, W, C),
    hole mask (B, H, W, 1) → tap-major output patches (B, 4r², Lq, C),
    Lq = (H/r)·(W/r). Fold them with ops/kernels/fold.py ``fold_taps``.
    ``want_lse`` (training) also returns the (B, Lq) float32 log-sum-exp
    the backward kernels rebuild the weights from."""
    bsz, h, w, c = b_feat.shape
    if h % rate or w % rate:
        raise ValueError(f"spatial dims {(h, w)} must divide rate={rate}")
    if tuple(hole_mask.shape) != (bsz, h, w, 1):
        raise ValueError(f"hole_mask {tuple(hole_mask.shape)} must be "
                         f"{(bsz, h, w, 1)}")
    if not use_kernel(b_feat):
        return fused_attention_taps_plain(b_feat, hole_mask, ksize=ksize,
                                          rate=rate,
                                          softmax_scale=softmax_scale,
                                          want_lse=want_lse)
    if ksize != 3:
        raise ValueError("the fused kernel builds 3x3 Q/K taps from a "
                         f"one-cell halo; got ksize={ksize}")
    if b_feat.dtype not in _DTYPES:
        raise TypeError(f"fused attention kernel takes {_DTYPES}, got "
                        f"{b_feat.dtype}")
    if hole_mask.device != b_feat.device:
        raise ValueError("hole_mask and b_feat must be on one device")
    maps, bias, rnorm, (hs, ws) = _prepare(b_feat, hole_mask, ksize, rate)
    return _launch(maps, bias, rnorm, hs, ws, rate, softmax_scale,
                   want_lse=want_lse)
