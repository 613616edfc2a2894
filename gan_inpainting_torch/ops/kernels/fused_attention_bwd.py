"""Backward of the fused contextual attention (kernel + fold).

``contextual_attention_bwd`` replaces the Pallas kernels ``_bwd_dq_kernel``
(gan_inpainting_tpu/ops/pallas/fused_attention_bwd.py:148) and
``_bwd_dkv_kernel`` (:223) with two CUDA kernels in
``csrc/contextual_attention_bwd.cu``. Given the forward's residuals — the
feature map, the hole mask, the tap-major output ``o_taps`` and the
per-query log-sum-exp ``lse`` — and the gradient ``g`` of the folded
output, it returns the gradient of the feature map:

1. host prep (:func:`prepare_bwd`): the forward's parity maps, bias and
   reciprocal key norms, and ``g / overlap counts`` rounded to the feature
   dtype and laid out as the same halo-padded parity maps (the adjoint of
   the fold), so a query's ``do`` tap is read like a key's V tap;
2. the dQ kernel: δ and the 9 query-tap gradients; the dK/dV kernel: the 9
   key-tap gradients, the 4r² value-tap gradients and the per-key scalar of
   the key-norm correction — all as float32 per-tap buffers;
3. epilogue (:func:`fold_tap_grads`): the taps added onto the padded maps
   in a fixed order (query/key tap (dp, dq) of cell (i, j) lands on padded
   cell (i+dp, j+dq); value tap per its parity and offset), the norm
   correction, the halo crop and the inverse parity transpose.

No atomics touch device memory and the epilogue adds in a fixed order, so
the same inputs give the same bits on every run.

:func:`tap_grads_mirror` is the kernels' arithmetic written in PyTorch from
the same maps (the index algebra line by line); the CPU tests hold it
against :func:`contextual_attention_bwd_plain`, autograd through the
materialized patch formulation, which is the independent derivation and
what a CPU tensor takes. On a CUDA tensor the kernels launch or the call
raises. Bound on an H100: 2·L²·C·34 (dQ) and 2·L²·C·50 (dK/dV) operations
per image at rate 2 against tens of MB of maps and tap buffers — bounded by
operations.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import count_launch, use_kernel
from gan_inpainting_torch.ops.kernels import build
from gan_inpainting_torch.ops.kernels.fold import fold_counts_inv
from gan_inpainting_torch.ops.kernels.fused_attention import (
    _CLUSTERS,
    _DTYPES,
    _VARIANTS,
    SMEM_BYTES,
    _prepare,
)

KERNEL_DQ = "contextual_attention_bwd_dq"
KERNEL_DKV = "contextual_attention_bwd_dkv"
_MMA_STAGE_BYTES = 8 * 2 * 8 * 32 * 4     # per-warp u and dp staging tiles
_MMA_GROUPS = (32, 16, 8)
_CORE_GROUPS = (8, 4, 2, 1)


def v_tap_geometry(rate: int) -> list[tuple[int, int, int, int]]:
    """Value (and ``do``) tap (vp, vq) of the 2r×2r window → (parity_p,
    parity_q, off_p, off_q): it reads parity map (v − r//2) mod r at cell
    offset ⌊(v − r//2)/r⌋ + 1 of the halo-padded map."""
    half = rate // 2
    return [((vp - half) % rate, (vq - half) % rate,
             (vp - half) // rate + 1, (vq - half) // rate + 1)
            for vp in range(2 * rate) for vq in range(2 * rate)]


def _core_group(lk: int, c: int) -> int | None:
    lpad = -(-lk // 4) * 4
    for g in _CORE_GROUPS:
        if (g * (2 * lpad + c) + 3 * g) * 4 <= SMEM_BYTES:
            return g
    return None


def plan_bwd(hs: int, ws: int, c: int, dtype: torch.dtype,
             which: str) -> tuple[str, int, int]:
    """(variant, G, cluster) for the ``"dq"`` or ``"dkv"`` kernel: G rows
    whose shared-memory rows of L columns fit (dQ keeps dsr; dK/dV keeps
    dsr and p) — for the ``mma`` variant the largest G, then the smallest
    cluster of blocks that split the columns; ``core`` has no cluster.
    Raises for a map no block can hold."""
    lk = hs * ws
    n_rows = 1 if which == "dq" else 2
    if dtype == torch.bfloat16 and c % 64 == 0 and ws % 32 == 0:
        for g in _MMA_GROUPS:
            for cl in _CLUSTERS:
                if (lk % (128 * cl) == 0
                        and n_rows * g * (lk // cl) * 2 + _MMA_STAGE_BYTES
                        + 12 * g <= SMEM_BYTES):
                    return "mma", g, cl
    g = _core_group(lk, c)
    if g is not None:
        return "core", g, 1
    raise ValueError(
        f"fused attention backward: rows of L={lk} cells (C={c}) do not fit "
        f"in {SMEM_BYTES} bytes of shared memory; larger maps need the "
        "streaming patch-attention kernels (ROADMAP Queue 2)")


def prepare_bwd(b_feat: torch.Tensor, hole_mask: torch.Tensor,
                g: torch.Tensor, ksize: int, rate: int):
    """Host prep → (maps, gmaps, bias, rnorm, (hs, ws)): the forward's
    :func:`_prepare` plus the gradient parity maps, ``g / counts`` rounded
    to the feature dtype (the fold's adjoint) with a zero halo."""
    maps, bias, rnorm, (hs, ws) = _prepare(b_feat, hole_mask, ksize, rate)
    bsz, h, w, c = b_feat.shape
    inv = fold_counts_inv(hs, ws, rate, b_feat.device)
    dyn = (g.float() * inv[None, :, :, None]).to(b_feat.dtype)
    g2d = dyn.reshape(bsz, hs, rate, ws, rate, c).permute(0, 2, 4, 1, 3, 5)
    gmaps = F.pad(g2d, (0, 0, 1, 1, 1, 1)).contiguous()
    return maps, gmaps, bias, rnorm, (hs, ws)


def _tap(m: torch.Tensor, pp: int, pq: int, op: int, oq: int, hs: int,
         ws: int) -> torch.Tensor:
    """(B, L, C) tile of parity map (pp, pq) at cell offset (op, oq)."""
    b, c = m.shape[0], m.shape[-1]
    return m[:, pp, pq, op:op + hs, oq:oq + ws, :].reshape(b, hs * ws, c)


def tap_grads_mirror(maps, gmaps, bias, rnorm, lse, o_taps, hs: int, ws: int,
                     rate: int, scale: float, which: str = "both"):
    """What the two kernels compute, in PyTorch from the same maps →
    (dq_taps, dk_taps, dv_taps, tnorm, delta). Scores, p, dp, ds and every
    sum in float32; p is rounded to the map dtype for the dV product.
    ``which`` = "dq" returns (dq_taps, delta) only, "dkv" (dk_taps,
    dv_taps, tnorm) only: one kernel's share, scores recomputed as the
    kernel recomputes them."""
    geo = v_tap_geometry(rate)
    qk = [_tap(maps, 0, 0, dp, dq, hs, ws).float()
          for dp in range(3) for dq in range(3)]
    u = sum(torch.bmm(t, t.transpose(1, 2)) for t in qk)        # (B, Lq, Lk)
    rs = (rnorm * scale)[:, None, :]
    s = u * rs + bias[:, None, :]
    p = torch.where(bias[:, None, :] >= 0.0,
                    torch.exp(s - lse[:, :, None]), 0.0)
    do = [_tap(gmaps, *g_, hs, ws).float() for g_ in geo]
    v = [_tap(maps, *g_, hs, ws).float() for g_ in geo]
    delta = sum((d * o_taps[:, i].float()).sum(-1) for i, d in enumerate(do))
    dp_ = sum(torch.bmm(d, vt.transpose(1, 2)) for d, vt in zip(do, v))
    ds = p * (dp_ - delta[:, :, None])
    dsr = ds * rs
    if which != "dkv":
        dq_taps = torch.stack([torch.bmm(dsr, t) for t in qk], 1)
        if which == "dq":
            return dq_taps, delta
    tnorm = (ds * u).sum(1)
    dk_taps = torch.stack([torch.bmm(dsr.transpose(1, 2), t) for t in qk], 1)
    p_t = p.to(maps.dtype).float().transpose(1, 2)
    dv_taps = torch.stack([torch.bmm(p_t, d) for d in do], 1)
    if which == "dkv":
        return dk_taps, dv_taps, tnorm
    return dq_taps, dk_taps, dv_taps, tnorm, delta


def fold_tap_grads(maps, dq_taps, dk_taps, dv_taps, tnorm, rnorm, hs: int,
                   ws: int, rate: int, scale: float) -> torch.Tensor:
    """Epilogue: per-tap float32 gradients → (B, H, W, C) float32 gradient
    of the feature map. The key-norm correction is −scale·t_j·rnorm_j³ (0
    where the norm sat on its 1e-4 floor) times key j's 3×3 patch."""
    bsz, c = maps.shape[0], maps.shape[-1]
    d_maps = torch.zeros(maps.shape, dtype=torch.float32, device=maps.device)
    coef = torch.where(rnorm < 1e4, rnorm * rnorm * rnorm, 0.0)
    cmap = ((-scale) * tnorm * coef).reshape(bsz, hs, ws, 1)
    d00 = d_maps[:, 0, 0]
    b00 = maps[:, 0, 0]
    for dp in range(3):
        for dq in range(3):
            t = dp * 3 + dq
            win = (slice(None), slice(dp, dp + hs), slice(dq, dq + ws))
            d00[win] += (dq_taps[:, t] + dk_taps[:, t]).reshape(
                bsz, hs, ws, c)
            d00[win] += cmap * b00[win].float()
    for tap, (pp, pq, op, oq) in enumerate(v_tap_geometry(rate)):
        d_maps[:, pp, pq, op:op + hs, oq:oq + ws] += dv_taps[:, tap].reshape(
            bsz, hs, ws, c)
    dcrop = d_maps[:, :, :, 1:hs + 1, 1:ws + 1, :]
    return dcrop.permute(0, 3, 1, 4, 2, 5).reshape(
        bsz, rate * hs, rate * ws, c)


def contextual_attention_bwd_plain(b_feat: torch.Tensor,
                                   hole_mask: torch.Tensor, g: torch.Tensor,
                                   *, ksize: int = 3, rate: int = 2,
                                   softmax_scale: float = 10.0):
    """The same gradient by autograd through the materialized patch
    formulation (ops/contextual_attention.py)."""
    from gan_inpainting_torch.ops.contextual_attention import (
        contextual_attention_plain,
    )

    with torch.enable_grad():
        x = b_feat.detach().requires_grad_(True)
        y = contextual_attention_plain(x, x, hole_mask, ksize=ksize,
                                       rate=rate, softmax_scale=softmax_scale)
        (dx,) = torch.autograd.grad(y, x, g.to(y.dtype))
    return dx


def _check(maps, gmaps, bias, rnorm, lse, hs, ws, rate):
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    want = (bsz, rate, rate, hs + 2, ws + 2, c)
    for name, t in (("maps", maps), ("gmaps", gmaps)):
        if (tuple(t.shape) != want or t.dtype != maps.dtype
                or not t.is_contiguous() or t.device != maps.device):
            raise ValueError(f"{name} must be contiguous {want} "
                             f"{maps.dtype} on {maps.device}")
    if maps.dtype not in _DTYPES:
        raise TypeError(f"attention backward kernels take {_DTYPES}, got "
                        f"{maps.dtype}")
    for name, t in (("bias", bias), ("rnorm", rnorm), ("lse", lse)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (bsz, lk)
                or t.device != maps.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 (B, L) on "
                             f"{maps.device}")
    if c % 4:
        raise ValueError(f"attention backward kernels need C % 4 == 0, "
                         f"got {c}")


def _pick(hs, ws, c, dtype, which, variant):
    chosen, group, cluster = plan_bwd(hs, ws, c, dtype, which)
    if variant is not None and variant != chosen:
        group = _core_group(hs * ws, c)
        if variant != "core" or group is None:
            raise ValueError(f"the {variant} variant does not take hs={hs} "
                             f"ws={ws} C={c} {dtype}")
        chosen, cluster = "core", 1
    return chosen, group, cluster


def launch_dq(maps, gmaps, bias, rnorm, lse, o_taps, hs: int, ws: int,
              rate: int, scale: float, variant: str | None = None):
    """The dQ kernel on prepared inputs → (dq_taps (B, 9, L, C) float32,
    delta (B, L) float32)."""
    _check(maps, gmaps, bias, rnorm, lse, hs, ws, rate)
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    if (tuple(o_taps.shape) != (bsz, 4 * rate * rate, lk, c)
            or o_taps.dtype != maps.dtype or not o_taps.is_contiguous()):
        raise ValueError("o_taps must be the forward's contiguous "
                         f"(B, 4r², L, C) {maps.dtype} output")
    variant, group, cluster = _pick(hs, ws, c, maps.dtype, "dq", variant)
    dq_taps = torch.empty((bsz, 9, lk, c), dtype=torch.float32,
                          device=maps.device)
    delta = torch.empty((bsz, lk), dtype=torch.float32, device=maps.device)
    lib = build.library("contextual_attention_bwd")
    fn = lib.gi_attention_bwd_dq
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(maps.device).cuda_stream
    with torch.cuda.device(maps.device):
        err = fn(maps.data_ptr(), gmaps.data_ptr(), bias.data_ptr(),
                 rnorm.data_ptr(), lse.data_ptr(), o_taps.data_ptr(),
                 delta.data_ptr(), dq_taps.data_ptr(), bsz, hs, ws, c, rate,
                 float(scale), int(maps.dtype == torch.bfloat16),
                 _VARIANTS[variant], group, cluster, stream)
    count_launch(KERNEL_DQ)
    build.check(lib, err, KERNEL_DQ)
    return dq_taps, delta


def launch_dkv(maps, gmaps, bias, rnorm, lse, delta, hs: int, ws: int,
               rate: int, scale: float, variant: str | None = None):
    """The dK/dV kernel on prepared inputs and the dQ kernel's δ →
    (dk_taps (B, 9, L, C), dv_taps (B, 4r², L, C), tnorm (B, L)), float32."""
    _check(maps, gmaps, bias, rnorm, lse, hs, ws, rate)
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    if (delta.dtype != torch.float32 or tuple(delta.shape) != (bsz, lk)
            or not delta.is_contiguous() or delta.device != maps.device):
        raise ValueError("delta must be contiguous float32 (B, L)")
    variant, group, cluster = _pick(hs, ws, c, maps.dtype, "dkv", variant)
    dk_taps = torch.empty((bsz, 9, lk, c), dtype=torch.float32,
                          device=maps.device)
    dv_taps = torch.empty((bsz, 4 * rate * rate, lk, c), dtype=torch.float32,
                          device=maps.device)
    tnorm = torch.empty((bsz, lk), dtype=torch.float32, device=maps.device)
    lib = build.library("contextual_attention_bwd")
    fn = lib.gi_attention_bwd_dkv
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(maps.device).cuda_stream
    with torch.cuda.device(maps.device):
        err = fn(maps.data_ptr(), gmaps.data_ptr(), bias.data_ptr(),
                 rnorm.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dk_taps.data_ptr(), dv_taps.data_ptr(), tnorm.data_ptr(),
                 bsz, hs, ws, c, rate, float(scale),
                 int(maps.dtype == torch.bfloat16), _VARIANTS[variant],
                 group, cluster, stream)
    count_launch(KERNEL_DKV)
    build.check(lib, err, KERNEL_DKV)
    return dk_taps, dv_taps, tnorm


def contextual_attention_bwd(b_feat: torch.Tensor, hole_mask: torch.Tensor,
                             o_taps: torch.Tensor, lse: torch.Tensor,
                             g: torch.Tensor, *, ksize: int = 3,
                             rate: int = 2,
                             softmax_scale: float = 10.0) -> torch.Tensor:
    """d(fold(fused attention)) / d ``b_feat`` (B, H, W, C), in its dtype,
    from the forward's residuals and the output gradient ``g``."""
    if not use_kernel(b_feat):
        return contextual_attention_bwd_plain(
            b_feat, hole_mask, g, ksize=ksize, rate=rate,
            softmax_scale=softmax_scale)
    if ksize != 3:
        raise ValueError("the fused kernels build 3x3 Q/K taps from a "
                         f"one-cell halo; got ksize={ksize}")
    if g.shape != b_feat.shape or g.device != b_feat.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not match "
                         f"b_feat {tuple(b_feat.shape)} on {b_feat.device}")
    maps, gmaps, bias, rnorm, (hs, ws) = prepare_bwd(b_feat, hole_mask, g,
                                                     ksize, rate)
    dq_taps, delta = launch_dq(maps, gmaps, bias, rnorm, lse, o_taps, hs, ws,
                               rate, softmax_scale)
    dk_taps, dv_taps, tnorm = launch_dkv(maps, gmaps, bias, rnorm, lse, delta,
                                         hs, ws, rate, softmax_scale)
    return fold_tap_grads(maps, dq_taps, dk_taps, dv_taps, tnorm, rnorm, hs,
                          ws, rate, softmax_scale).to(b_feat.dtype)
