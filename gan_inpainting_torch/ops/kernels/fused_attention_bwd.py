"""Backward of the fused contextual attention (kernel + fold).

``contextual_attention_bwd`` replaces the Pallas kernels ``_bwd_dq_kernel``
(gan_inpainting_tpu/ops/pallas/fused_attention_bwd.py:148) and
``_bwd_dkv_kernel`` (:223) with the CUDA kernels of
``csrc/contextual_attention_bwd.cu``. Given the forward's residuals — the
feature map, the hole mask, the tap-major output ``o_taps`` and the
per-query log-sum-exp ``lse`` — and the gradient ``g`` of the folded
output, it returns the gradient of the feature map:

1. host prep (:func:`prepare_bwd`): the forward's parity maps, bias and
   reciprocal key norms, and ``g / overlap counts`` rounded to the feature
   dtype and laid out as the same halo-padded parity maps (the adjoint of
   the fold), so a query's ``do`` tap is read like a key's V tap;
2. the kernels (:func:`tap_grads`): δ, the 9 query-tap and 9 key-tap
   gradients, the 4r² value-tap gradients and the per-key scalar of the
   key-norm correction, all as float32 per-tap buffers;
3. epilogue (:func:`fold_tap_grads`): one launch of ``gi_fold_tap_grads``
   (csrc/fold.cu), where the JAX kernels scatter in-kernel and XLA merges
   the halo rows and adds the norm correction. Each output pixel gathers
   its taps in a fixed order (query/key tap (dp, dq) of cell (i, j) lands
   on padded cell (i+dp, j+dq), with the norm correction; value tap per
   its parity and offset) and is written once in the feature dtype, so the
   halo crop, the inverse parity transpose and the cast need no pass of
   their own. :func:`fold_tap_grads_plain` is the eager version (a CPU
   tensor takes it), :func:`fold_tap_grads_mirror` the kernel's gather.

Step 2 has two variants (:func:`plan_bwd`). ``wgmma`` (bf16 maps that the
TMA boxes take, see :func:`wgmma_bwd_takes`; a tap is ⌈C/64⌉ boxes of 64
channels, the last one zero-filled past C where 64 does not divide C, as
at the published width's C 96) materializes the scores: per
sample the L × L matrices are small beside the rows of taps (P and dS in
bf16: 4 MB at L 1024), so one launch forms p and dsr of every (128 query,
128 key) tile on the tensor cores and writes them as bf16 to a scratch,
and the gradients are dense tap products from it (dq = dsr·K, dk = dsrᵀ·Q,
dv = pᵀ·dO), one launch for dQ and one for dK/dV, after a small launch for
δ. The batch goes through in chunks of samples whose scratch stays under
:data:`SCRATCH_BUDGET_BYTES`; the samples are independent, so chunking is
exact. ``core`` (float32, and other shapes) is the CUDA-core pair of
kernels that keep G rows of L scores in shared memory.

No atomics touch device memory and the epilogue adds in a fixed order, so
the same inputs give the same bits on every run.

:func:`tap_grads_mirror` is the wgmma kernels' arithmetic written in
PyTorch from the same maps (float32 sums, p and dsr rounded to the map
dtype once before the products, t summed over 128-row tiles in order); the
CPU tests hold it against :func:`contextual_attention_bwd_plain`, autograd
through the materialized patch formulation, which is the independent
derivation and what a CPU tensor takes. :func:`tap_box` mirrors the
producers' TMA box arithmetic. On a CUDA tensor the kernels launch or the
call raises. Bound on an H100: 2·L²·C·(9 + 4r²) operations per image for
the scores and 2·L²·C·(9 + 9 + 4r²) for the products, against tens of MB
of maps, tap buffers and the scratch — bounded by operations. The
epilogue reads (18 + 4r²)·L·C float32 tap gradients and writes the
gradient once: bounded by bytes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import (
    count_launch,
    interpreting,
    use_kernel,
)
from gan_inpainting_torch.ops.kernels import build, fold
from gan_inpainting_torch.ops.kernels.fused_attention import (
    _DTYPES,
    SMEM_BYTES,
    _prepare,
)

KERNEL_DELTA = "contextual_attention_bwd_delta"
KERNEL_SCORES = "contextual_attention_bwd_scores"
KERNEL_DQ = "contextual_attention_bwd_dq"
KERNEL_DKV = "contextual_attention_bwd_dkv"
KERNEL_FOLD = "contextual_attention_bwd_fold"
TILE = 128              # score tile rows and columns; product tile rows
UNIT = 64               # channels per TMA box
# The p + dsr scratch of one backward (and the t partials), in bytes. One
# chunk holds the 8×512² train step's 8 samples (0.5 GiB at L 4096) and a
# 16 384-cell map's one sample (1 GiB); about 2 % of the card's 80 GB, so
# the 8×512² step (peak 22.9 GiB) keeps its headroom. A map whose one
# sample does not fit takes the core kernels or the patch route.
SCRATCH_BUDGET_BYTES = 3 << 29
_CORE_GROUPS = (8, 4, 2, 1)


class BwdPlan(NamedTuple):
    """``variant`` "wgmma" or "core"; ``rows`` per block (core: query or
    key cells; wgmma: the 128-row tile); ``chunk``: wgmma samples per
    scratch chunk (0 for core); ``units``: wgmma channel boxes per product
    block (:func:`product_units`)."""
    variant: str
    rows: int
    chunk: int
    units: int


def v_tap_geometry(rate: int) -> list[tuple[int, int, int, int]]:
    """Value (and ``do``) tap (vp, vq) of the 2r×2r window → (parity_p,
    parity_q, off_p, off_q): it reads parity map (v − r//2) mod r at cell
    offset ⌊(v − r//2)/r⌋ + 1 of the halo-padded map."""
    half = rate // 2
    return [((vp - half) % rate, (vq - half) % rate,
             (vp - half) // rate + 1, (vq - half) // rate + 1)
            for vp in range(2 * rate) for vq in range(2 * rate)]


def scratch_bytes_per_sample(lk: int) -> int:
    """p and dsr (bf16, L × L each) and t's partials (float32, L/128 × L)
    of one sample."""
    return 2 * lk * lk * 2 + -(-lk // TILE) * lk * 4


def product_units(c: int) -> int:
    """Channel boxes per block of the wgmma products (one m64n(64·units)
    tile), dividing a tap's ⌈C/64⌉ boxes: where 64 divides C, 3 if 192
    does and else 1, the plans those maps have always had; otherwise the
    largest of 3, 2, 1 that divides them. At C 96 one m64n128 tile a tap
    beat two m64n64 tiles on the H100 with the same bits (8×512²: dQ 0.67
    vs 0.93 ms, dK/dV 1.82 vs 2.56 ms; PERF.md §6)."""
    cpt = -(-c // UNIT)
    if c % UNIT == 0:
        return 3 if cpt % 3 == 0 else 1
    return next(u for u in (3, 2, 1) if cpt % u == 0)


def wgmma_bwd_takes(hs: int, ws: int, c: int, dtype: torch.dtype,
                    budget: int = SCRATCH_BUDGET_BYTES) -> bool:
    """Whether the wgmma kernels take the map: bf16, C % 32 == 0, 128-cell
    tiles and 64-cell stages that are TMA boxes of whole map rows or parts
    of one (ws 32, 64 or a multiple of 128, L % 128 == 0), and one sample's
    scratch within ``budget``. Independent of the batch size."""
    lk = hs * ws
    return (dtype == torch.bfloat16 and c % 32 == 0 and c > 0
            and lk % TILE == 0 and (ws in (32, 64) or ws % 128 == 0)
            and scratch_bytes_per_sample(lk) <= budget)


def _core_group(lk: int, c: int) -> int | None:
    lpad = -(-lk // 4) * 4
    for g in _CORE_GROUPS:
        if (g * (2 * lpad + c) + 3 * g) * 4 <= SMEM_BYTES:
            return g
    return None


def _plan_bwd(hs: int, ws: int, c: int, dtype: torch.dtype,
              budget: int) -> BwdPlan | None:
    lk = hs * ws
    if wgmma_bwd_takes(hs, ws, c, dtype, budget):
        return BwdPlan("wgmma", TILE,
                       budget // scratch_bytes_per_sample(lk),
                       product_units(c))
    g = _core_group(lk, c)
    return None if g is None else BwdPlan("core", g, 0, 0)


def plan_bwd(hs: int, ws: int, c: int, dtype: torch.dtype,
             budget: int = SCRATCH_BUDGET_BYTES) -> BwdPlan:
    """The backward's plan for an (hs, ws, C) map; the same for every
    batch size (a batch goes through in chunks of ``chunk`` samples).
    ``wgmma`` where :func:`wgmma_bwd_takes`, else ``core`` with the largest
    G whose float32 rows of L fit in shared memory. Raises for a map
    neither takes."""
    chosen = _plan_bwd(hs, ws, c, dtype, budget)
    if chosen is not None:
        return chosen
    raise ValueError(
        f"fused attention backward: an L={hs * ws} map (C={c}, {dtype}) "
        f"is taken neither by the wgmma kernels (scratch of "
        f"{scratch_bytes_per_sample(hs * ws)} bytes per sample against "
        f"{budget}) nor by the core kernels' shared memory; such maps take "
        "the patch-attention kernels (ROADMAP Queue 2 item 3)")


def bwd_supported(hs: int, ws: int, c: int, dtype: torch.dtype) -> bool:
    """Whether the backward kernels take the (hs, ws, C) map: C % 4 == 0,
    a dtype they take, and a :func:`plan_bwd`. Independent of the batch
    size. Elsewhere the gradient goes through the patch-attention kernels
    (ops/contextual_attention.py ``_FusedAttention``)."""
    return (c % 4 == 0 and dtype in _DTYPES
            and _plan_bwd(hs, ws, c, dtype, SCRATCH_BUDGET_BYTES) is not None)


def chunks(bsz: int, chunk: int) -> list[tuple[int, int]]:
    """[s0, s1) sample ranges of at most ``chunk`` samples covering B."""
    return [(s, min(s + chunk, bsz)) for s in range(0, bsz, chunk)]


def tap_box(kind: str, tap: int, cell0: int, cells: int, ws: int,
            rate: int, sample: int, unit: int):
    """The TMA box the producers request for ``cells`` cells from cell
    ``cell0`` of a tap, written as the CUDA producers compute it: the
    4-D map is (C, ws + 2, hs + 2, B·r²), so → ((channel, x, y, plane),
    (64, box width, box rows, 1)). ``kind`` "qk": Q/K tap ``tap`` of map
    (0, 0) at shift (tap // 3, tap % 3); "v": V / ``do`` tap ``tap`` of the
    2r × 2r window per :func:`v_tap_geometry`. ``unit`` runs over ⌈C/64⌉;
    the last box reaches past C where 64 does not divide C, and TMA fills
    those channels with zeros."""
    if kind == "qk":
        oy, ox, par = tap // 3, tap % 3, 0
    else:
        pp, pq, oy, ox = v_tap_geometry(rate)[tap]
        par = pp * rate + pq
    y, x = cell0 // ws, cell0 % ws
    bw = min(ws, cells)
    return ((unit * UNIT, x + ox, y + oy, sample * rate * rate + par),
            (UNIT, bw, cells // bw, 1))


def prepare_bwd(b_feat: torch.Tensor, hole_mask: torch.Tensor,
                g: torch.Tensor, ksize: int, rate: int):
    """Host prep → (maps, gmaps, bias, rnorm, (hs, ws)): the forward's
    :func:`_prepare` plus the gradient parity maps, ``g / counts`` rounded
    to the feature dtype (the fold's adjoint) with a zero halo."""
    maps, bias, rnorm, (hs, ws) = _prepare(b_feat, hole_mask, ksize, rate)
    bsz, h, w, c = b_feat.shape
    inv = fold.fold_counts_inv(hs, ws, rate, b_feat.device)
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
    """What the wgmma kernels compute, in PyTorch from the same maps →
    (dq_taps, dk_taps, dv_taps, tnorm, delta): u, dp, p, ds and δ as float32
    sums over the whole of d and dv; p and dsr rounded to the map dtype
    once, before every product (a no-op for float32); t = Σ_i ds·u as
    float32 column sums of 128-row tiles, added tile after tile. ``which``
    = "dq" returns (dq_taps, delta) only, "dkv" (dk_taps, dv_taps, tnorm)
    only."""
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
    del v
    ds = p * (dp_ - delta[:, :, None])
    del dp_
    dsr = (ds * rs).to(maps.dtype).float()
    if which != "dkv":
        dq_taps = torch.stack([torch.bmm(dsr, t) for t in qk], 1)
        if which == "dq":
            return dq_taps, delta
    bsz, lk = ds.shape[0], ds.shape[1]
    tnorm = torch.zeros((bsz, lk), dtype=torch.float32, device=ds.device)
    for r0 in range(0, lk, TILE):
        tnorm += (ds[:, r0:r0 + TILE] * u[:, r0:r0 + TILE]).sum(1)
    del ds, u
    dk_taps = torch.stack([torch.bmm(dsr.transpose(1, 2), t) for t in qk], 1)
    p_t = p.to(maps.dtype).float().transpose(1, 2)
    dv_taps = torch.stack([torch.bmm(p_t, d) for d in do], 1)
    if which == "dkv":
        return dk_taps, dv_taps, tnorm
    return dq_taps, dk_taps, dv_taps, tnorm, delta


def fold_tap_grads_plain(maps, dq_taps, dk_taps, dv_taps, tnorm, rnorm,
                         hs: int, ws: int, rate: int,
                         scale: float) -> torch.Tensor:
    """Epilogue in eager PyTorch: per-tap float32 gradients → (B, H, W, C)
    float32 gradient of the feature map. The key-norm correction is
    −scale·t_j·rnorm_j³ (0 where the norm sat on its 1e-4 floor) times key
    j's 3×3 patch."""
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


def _cells(i: torch.Tensor, j: torch.Tensor, hs: int, ws: int):
    """(rows i, columns j) of source cells → (cell index, clamped into the
    grid, and whether the cell exists), each (len(i), len(j))."""
    ok = ((i >= 0) & (i < hs))[:, None] & ((j >= 0) & (j < ws))[None, :]
    cell = i.clamp(0, hs - 1)[:, None] * ws + j.clamp(0, ws - 1)[None, :]
    return cell, ok


def fold_tap_grads_mirror(maps, dq_taps, dk_taps, dv_taps, tnorm, rnorm,
                          hs: int, ws: int, rate: int,
                          scale: float) -> torch.Tensor:
    """What ``gi_fold_tap_grads`` computes, in PyTorch: each output pixel
    (y, x), padded cell (I, J) = (y // r + 1, x // r + 1), gathers its
    sources. A parity-(0, 0) pixel adds, for each Q/K tap t = (dp, dq) in
    order whose source cell (I − dp, J − dq) exists, dq_t + dk_t, then
    −scale·tnorm·rnorm³·[rnorm < 1e4] of that cell times the (0, 0) map
    at (I, J). Every pixel then adds its 4 value taps in tap order, from
    cell (I − op, J − oq) as :func:`v_tap_geometry` places them, and the
    float32 sum is rounded once to the maps' dtype."""
    bsz, c = maps.shape[0], maps.shape[-1]
    dev = maps.device
    half = rate // 2
    y, x = torch.arange(rate * hs, device=dev), torch.arange(rate * ws,
                                                             device=dev)
    pp, pq = y % rate, x % rate
    rows, cols = y // rate + 1, x // rate + 1
    acc = torch.zeros((bsz, rate * hs, rate * ws, c), dtype=torch.float32,
                      device=dev)
    coef = torch.where(rnorm < 1e4, rnorm * rnorm * rnorm, 0.0)
    cm = (-scale) * tnorm * coef                                  # (B, L)
    b00 = maps[:, 0, 0].float()[:, rows[:, None], cols[None, :]]
    at00 = ((pp == 0)[:, None] & (pq == 0)[None, :])
    for t in range(9):
        cell, ok = _cells(rows - t // 3, cols - t % 3, hs, ws)
        grad = dq_taps[:, t, cell] + dk_taps[:, t, cell]
        term = cm[:, cell][..., None] * b00
        acc = torch.where((ok & at00)[None, :, :, None],
                          (acc + grad) + term, acc)
    vp0, vq0 = (pp + half) % rate, (pq + half) % rate
    op0, oq0 = (vp0 >= half).long(), (vq0 >= half).long()
    for a in (0, 1):
        for e in (0, 1):
            cell, ok = _cells(rows - op0 - a, cols - oq0 - e, hs, ws)
            tap = ((vp0 + a * rate) * 2 * rate)[:, None] + (vq0 + e * rate)[
                None, :]
            acc = acc + torch.where(ok[None, :, :, None],
                                    dv_taps[:, tap, cell], 0.0)
    return acc.to(maps.dtype)


def _check_fold_inputs(maps, dq_taps, dk_taps, dv_taps, tnorm, rnorm, hs,
                       ws, rate):
    bsz, c = maps.shape[0], maps.shape[-1]
    if (maps.dtype not in _DTYPES or not maps.is_contiguous() or c % 4
            or tuple(maps.shape) != (bsz, rate, rate, hs + 2, ws + 2, c)):
        raise ValueError(f"maps must be contiguous (B, r, r, hs+2, ws+2, C) "
                         f"in {_DTYPES} with C % 4 == 0, got "
                         f"{tuple(maps.shape)} {maps.dtype}")
    lk = hs * ws
    for name, t, shape in (
            ("dq_taps", dq_taps, (bsz, 9, lk, c)),
            ("dk_taps", dk_taps, (bsz, 9, lk, c)),
            ("dv_taps", dv_taps, (bsz, 4 * rate * rate, lk, c)),
            ("tnorm", tnorm, (bsz, lk)), ("rnorm", rnorm, (bsz, lk))):
        _check_float(name, t, shape, maps.device)


def fold_tap_grads(maps, dq_taps, dk_taps, dv_taps, tnorm, rnorm, hs: int,
                   ws: int, rate: int, scale: float) -> torch.Tensor:
    """Epilogue: per-tap float32 gradients → (B, H, W, C) gradient of the
    feature map in the maps' dtype, the float32 sum rounded once. On a CUDA
    tensor one launch of ``gi_fold_tap_grads`` (csrc/fold.cu), which reads
    each tap gradient once and writes the gradient once; on a CPU tensor
    :func:`fold_tap_grads_plain`."""
    if interpreting():
        return fold_tap_grads_mirror(maps, dq_taps, dk_taps, dv_taps, tnorm,
                                     rnorm, hs, ws, rate, scale)
    if not use_kernel(maps):
        return fold_tap_grads_plain(maps, dq_taps, dk_taps, dv_taps, tnorm,
                                    rnorm, hs, ws, rate, scale).to(maps.dtype)
    _check_fold_inputs(maps, dq_taps, dk_taps, dv_taps, tnorm, rnorm, hs, ws,
                       rate)
    bsz, c = maps.shape[0], maps.shape[-1]
    out = torch.empty((bsz, rate * hs, rate * ws, c), dtype=maps.dtype,
                      device=maps.device)
    lib = fold.library()
    with fold.on_device(maps):
        err = lib.gi_fold_tap_grads(
            maps.data_ptr(), dq_taps.data_ptr(), dk_taps.data_ptr(),
            dv_taps.data_ptr(), tnorm.data_ptr(), rnorm.data_ptr(),
            out.data_ptr(), bsz, hs, ws, c, rate, float(scale),
            int(maps.dtype == torch.bfloat16), _stream(maps))
    count_launch(KERNEL_FOLD)
    build.check(lib, err, KERNEL_FOLD)
    return out


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


def _check_maps(maps, gmaps, hs, ws, rate):
    if maps.device.type != "cuda":
        raise ValueError("the backward kernels take CUDA tensors (on the "
                         "CPU, tap_grads takes tap_grads_mirror)")
    bsz, c = maps.shape[0], maps.shape[-1]
    want = (bsz, rate, rate, hs + 2, ws + 2, c)
    for name, t in (("maps", maps), ("gmaps", gmaps)):
        if (tuple(t.shape) != want or t.dtype != maps.dtype
                or not t.is_contiguous() or t.device != maps.device):
            raise ValueError(f"{name} must be contiguous {want} "
                             f"{maps.dtype} on {maps.device}")
    if maps.dtype not in _DTYPES:
        raise TypeError(f"attention backward kernels take {_DTYPES}, got "
                        f"{maps.dtype}")


def _check(maps, gmaps, bias, rnorm, lse, hs, ws, rate):
    _check_maps(maps, gmaps, hs, ws, rate)
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    for name, t in (("bias", bias), ("rnorm", rnorm), ("lse", lse)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (bsz, lk)
                or t.device != maps.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 (B, L) on "
                             f"{maps.device}")
    if c % 4:
        raise ValueError(f"attention backward kernels need C % 4 == 0, "
                         f"got {c}")


def _check_float(name, t, shape, device):
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{name} must be contiguous float32 {tuple(shape)} "
                         f"on {device}")


def _fn(name: str, n_ptr: int, n_int: int, n_float: int, n_int2: int):
    lib = build.library("contextual_attention_bwd")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_int] * n_int2
                   + [ctypes.c_void_p])
    return lib, fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _wgmma_plan(maps, hs, ws) -> BwdPlan:
    chosen = plan_bwd(hs, ws, maps.shape[-1], maps.dtype)
    if chosen.variant != "wgmma":
        raise ValueError(f"the wgmma backward does not take hs={hs} ws={ws} "
                         f"C={maps.shape[-1]} {maps.dtype}")
    return chosen


def _check_scratch(scratch, tpart, bsz, lk, device):
    """The scores' outputs for a chunk of ``bsz`` samples: at least that
    much contiguous bf16 scratch and float32 partials on ``device``."""
    if (scratch.dtype != torch.bfloat16 or tpart.dtype != torch.float32
            or not scratch.is_contiguous() or not tpart.is_contiguous()
            or scratch.device != device or tpart.device != device
            or scratch.numel() < 2 * bsz * lk * lk
            or tpart.numel() < bsz * (lk // TILE) * lk):
        raise ValueError(f"scratch must be contiguous bf16 of at least "
                         f"(2B, L, L) and tpart float32 of (B, L/128, L), "
                         f"B={bsz}, L={lk}, on {device}")


def launch_delta(gmaps, o_taps, hs: int, ws: int, rate: int):
    """δ (B, L) float32 = Σ over the 4r² taps of do·o, one warp per query
    row (bf16 inputs, C % 8 == 0)."""
    bsz, c = gmaps.shape[0], gmaps.shape[-1]
    lk = hs * ws
    if (gmaps.device.type != "cuda" or gmaps.dtype != torch.bfloat16
            or not gmaps.is_contiguous()
            or tuple(gmaps.shape) != (bsz, rate, rate, hs + 2, ws + 2, c)
            or c % 8):
        raise ValueError("gmaps must be contiguous bf16 (B, r, r, hs+2, "
                         "ws+2, C) on a CUDA device, with C % 8 == 0")
    if (tuple(o_taps.shape) != (bsz, 4 * rate * rate, lk, c)
            or o_taps.dtype != gmaps.dtype or not o_taps.is_contiguous()
            or o_taps.device != gmaps.device):
        raise ValueError("o_taps must be the forward's contiguous "
                         f"(B, 4r², L, C) {gmaps.dtype} output")
    delta = torch.empty((bsz, lk), dtype=torch.float32, device=gmaps.device)
    lib, fn = _fn("gi_attention_bwd_delta", 3, 5, 0, 0)
    with torch.cuda.device(gmaps.device):
        err = fn(gmaps.data_ptr(), o_taps.data_ptr(), delta.data_ptr(), bsz,
                 hs, ws, c, rate, _stream(gmaps))
    count_launch(KERNEL_DELTA)
    build.check(lib, err, KERNEL_DELTA)
    return delta


def launch_scores(maps, gmaps, bias, rnorm, lse, delta, hs: int, ws: int,
                  rate: int, scale: float, scratch=None, tpart=None):
    """Score tiles of the B samples given (one chunk) → (scratch (2B, L, L)
    bf16: dsr of sample b at b, p at B + b; tpart (B, L/128, L) float32:
    the column sums of ds·u of each 128-row tile). ``scratch`` and
    ``tpart`` may be passed to reuse buffers of at least those sizes."""
    _check(maps, gmaps, bias, rnorm, lse, hs, ws, rate)
    _wgmma_plan(maps, hs, ws)
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    _check_float("delta", delta, (bsz, lk), maps.device)
    if scratch is None:
        scratch = torch.empty((2 * bsz, lk, lk), dtype=torch.bfloat16,
                              device=maps.device)
    if tpart is None:
        tpart = torch.empty((bsz, lk // TILE, lk), dtype=torch.float32,
                            device=maps.device)
    _check_scratch(scratch, tpart, bsz, lk, maps.device)
    lib, fn = _fn("gi_attention_bwd_scores", 8, 5, 1, 0)
    with torch.cuda.device(maps.device):
        err = fn(maps.data_ptr(), gmaps.data_ptr(), bias.data_ptr(),
                 rnorm.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 scratch.data_ptr(), tpart.data_ptr(), bsz, hs, ws, c, rate,
                 float(scale), _stream(maps))
    count_launch(KERNEL_SCORES)
    build.check(lib, err, KERNEL_SCORES)
    return scratch, tpart


def _launch_products(which: int, name: str, maps, gmaps, scratch, tpart,
                     hs, ws, rate, outs):
    _check_maps(maps, gmaps, hs, ws, rate)
    chosen = _wgmma_plan(maps, hs, ws)
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    _check_scratch(scratch, tpart, bsz, lk, maps.device)
    qk, dv, tnorm = outs
    lib, fn = _fn("gi_attention_bwd_products", 7, 5, 0, 2)
    with torch.cuda.device(maps.device):
        err = fn(maps.data_ptr(), gmaps.data_ptr(), scratch.data_ptr(),
                 tpart.data_ptr(), qk.data_ptr(),
                 0 if dv is None else dv.data_ptr(),
                 0 if tnorm is None else tnorm.data_ptr(), bsz, hs, ws, c,
                 rate, which, chosen.units, _stream(maps))
    count_launch(name)
    build.check(lib, err, name)


def launch_dq(maps, gmaps, scratch, tpart, hs: int, ws: int, rate: int,
              out=None):
    """dq taps (B, 9, L, C) float32 = dsr·K_t from the scores' scratch."""
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    if out is None:
        out = torch.empty((bsz, 9, lk, c), dtype=torch.float32,
                          device=maps.device)
    _check_float("dq_taps", out, (bsz, 9, lk, c), maps.device)
    _launch_products(0, KERNEL_DQ, maps, gmaps, scratch, tpart, hs, ws, rate,
                     (out, None, None))
    return out


def launch_dkv(maps, gmaps, scratch, tpart, hs: int, ws: int, rate: int,
               out=None):
    """(dk taps (B, 9, L, C) = dsrᵀ·Q_t, dv taps (B, 4r², L, C) = pᵀ·dO_t,
    tnorm (B, L) = the row tiles' partial sums in order), float32, from the
    scores' scratch."""
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    if out is None:
        dev = maps.device
        out = (torch.empty((bsz, 9, lk, c), dtype=torch.float32, device=dev),
               torch.empty((bsz, 4 * rate * rate, lk, c), dtype=torch.float32,
                           device=dev),
               torch.empty((bsz, lk), dtype=torch.float32, device=dev))
    for name, t, shape in zip(("dk_taps", "dv_taps", "tnorm"), out, (
            (bsz, 9, lk, c), (bsz, 4 * rate * rate, lk, c), (bsz, lk))):
        _check_float(name, t, shape, maps.device)
    _launch_products(1, KERNEL_DKV, maps, gmaps, scratch, tpart, hs, ws, rate,
                     out)
    return out


def _launch_core(which: str, maps, gmaps, bias, rnorm, lse, extra, hs, ws,
                 rate, scale):
    """The core kernels: ``which`` "dq" (extra = o_taps) → (dq_taps,
    delta); "dkv" (extra = delta) → (dk_taps, dv_taps, tnorm)."""
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    group = _core_group(lk, c)
    if group is None:
        raise ValueError(f"the core backward does not take L={lk} C={c}")
    dev = maps.device
    is_bf16 = int(maps.dtype == torch.bfloat16)
    if which == "dq":
        o_taps = extra
        if (tuple(o_taps.shape) != (bsz, 4 * rate * rate, lk, c)
                or o_taps.dtype != maps.dtype or not o_taps.is_contiguous()):
            raise ValueError("o_taps must be the forward's contiguous "
                             f"(B, 4r², L, C) {maps.dtype} output")
        dq_taps = torch.empty((bsz, 9, lk, c), dtype=torch.float32,
                              device=dev)
        delta = torch.empty((bsz, lk), dtype=torch.float32, device=dev)
        lib, fn = _fn("gi_attention_bwd_dq", 8, 5, 1, 2)
        with torch.cuda.device(dev):
            err = fn(maps.data_ptr(), gmaps.data_ptr(), bias.data_ptr(),
                     rnorm.data_ptr(), lse.data_ptr(), o_taps.data_ptr(),
                     delta.data_ptr(), dq_taps.data_ptr(), bsz, hs, ws, c,
                     rate, float(scale), is_bf16, group, _stream(maps))
        count_launch(KERNEL_DQ)
        build.check(lib, err, KERNEL_DQ)
        return dq_taps, delta
    delta = extra
    _check_float("delta", delta, (bsz, lk), dev)
    dk_taps = torch.empty((bsz, 9, lk, c), dtype=torch.float32, device=dev)
    dv_taps = torch.empty((bsz, 4 * rate * rate, lk, c), dtype=torch.float32,
                          device=dev)
    tnorm = torch.empty((bsz, lk), dtype=torch.float32, device=dev)
    lib, fn = _fn("gi_attention_bwd_dkv", 9, 5, 1, 2)
    with torch.cuda.device(dev):
        err = fn(maps.data_ptr(), gmaps.data_ptr(), bias.data_ptr(),
                 rnorm.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dk_taps.data_ptr(), dv_taps.data_ptr(), tnorm.data_ptr(),
                 bsz, hs, ws, c, rate, float(scale), is_bf16, group,
                 _stream(maps))
    count_launch(KERNEL_DKV)
    build.check(lib, err, KERNEL_DKV)
    return dk_taps, dv_taps, tnorm


def tap_grads(maps, gmaps, bias, rnorm, lse, o_taps, hs: int, ws: int,
              rate: int, scale: float, variant: str | None = None,
              budget: int = SCRATCH_BUDGET_BYTES):
    """The kernels on prepared inputs → (dq_taps, dk_taps, dv_taps, tnorm,
    delta), float32, as :func:`tap_grads_mirror`, which a CPU tensor takes.
    ``variant`` None takes :func:`plan_bwd`'s; "core" forces the core
    kernels (also on bf16). The wgmma variant runs δ once, then per chunk
    of samples (at most ``budget`` bytes of scratch) the scores, dQ and
    dK/dV launches. Inside ``interpret_kernels`` the mirror too."""
    if not use_kernel(maps):
        return tap_grads_mirror(maps, gmaps, bias, rnorm, lse, o_taps, hs,
                                ws, rate, scale)
    _check(maps, gmaps, bias, rnorm, lse, hs, ws, rate)
    bsz, c = maps.shape[0], maps.shape[-1]
    chosen = plan_bwd(hs, ws, c, maps.dtype, budget)
    if variant is not None and variant != chosen.variant:
        if variant != "core":
            raise ValueError(f"the {variant} variant does not take hs={hs} "
                             f"ws={ws} C={c} {maps.dtype}")
        chosen = chosen._replace(variant="core")
    if chosen.variant == "core":
        dq_taps, delta = _launch_core("dq", maps, gmaps, bias, rnorm, lse,
                                      o_taps, hs, ws, rate, scale)
        dk_taps, dv_taps, tnorm = _launch_core(
            "dkv", maps, gmaps, bias, rnorm, lse, delta, hs, ws, rate, scale)
        return dq_taps, dk_taps, dv_taps, tnorm, delta
    lk = hs * ws
    dev = maps.device
    delta = launch_delta(gmaps, o_taps, hs, ws, rate)
    dq_taps = torch.empty((bsz, 9, lk, c), dtype=torch.float32, device=dev)
    dk_taps = torch.empty_like(dq_taps)
    dv_taps = torch.empty((bsz, 4 * rate * rate, lk, c), dtype=torch.float32,
                          device=dev)
    tnorm = torch.empty((bsz, lk), dtype=torch.float32, device=dev)
    n = min(bsz, chosen.chunk)
    scratch = torch.empty((2 * n, lk, lk), dtype=torch.bfloat16, device=dev)
    tpart = torch.empty((n, lk // TILE, lk), dtype=torch.float32, device=dev)
    for s0, s1 in chunks(bsz, chosen.chunk):
        part = slice(s0, s1)
        sub = (maps[part], gmaps[part])
        launch_scores(*sub, bias[part], rnorm[part], lse[part], delta[part],
                      hs, ws, rate, scale, scratch, tpart)
        launch_dq(*sub, scratch, tpart, hs, ws, rate, dq_taps[part])
        launch_dkv(*sub, scratch, tpart, hs, ws, rate,
                   (dk_taps[part], dv_taps[part], tnorm[part]))
    return dq_taps, dk_taps, dv_taps, tnorm, delta


def contextual_attention_bwd(b_feat: torch.Tensor, hole_mask: torch.Tensor,
                             o_taps: torch.Tensor, lse: torch.Tensor,
                             g: torch.Tensor, *, ksize: int = 3,
                             rate: int = 2,
                             softmax_scale: float = 10.0) -> torch.Tensor:
    """d(fold(fused attention)) / d ``b_feat`` (B, H, W, C), in its dtype,
    from the forward's residuals and the output gradient ``g``."""
    if not (interpreting() or use_kernel(b_feat)):
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
    dq_taps, dk_taps, dv_taps, tnorm, _ = tap_grads(
        maps, gmaps, bias, rnorm, lse, o_taps, hs, ws, rate, softmax_scale)
    return fold_tap_grads(maps, dq_taps, dk_taps, dv_taps, tnorm, rnorm, hs,
                          ws, rate, softmax_scale)
