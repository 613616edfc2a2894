"""Patch attention: flash attention over materialized patch Q/K/V.

``patch_attention`` and ``patch_attention_bwd`` replace the Pallas kernels
``_fwd_kernel`` (gan_inpainting_tpu/ops/pallas/patch_attention.py:64),
``_bwd_dq_kernel`` (:156) and ``_bwd_dkv_kernel`` (:186) with CUDA kernels
in ``csrc/patch_attention.cu``: in bf16 the cluster mainloops of
``csrc/attention_wgmma.cuh`` (forward) and ``csrc/attention_bwd_wgmma.cuh``
(dQ, dK/dV), wgmma fed by TMA, 128 columns per step; in float32 a cluster
template on CUDA-core FMAs:

    s = scale·q·k + bias, bias −1e9 on an invalid key
    out[q] = Σ_k softmax_k(s)·valid_k·v[k]       0 where no key is valid
    lse[q] = logsumexp over the valid keys        0 where no key is valid

and, from (out, lse) and the output gradient g, with δ = rowsum(g∘out) in
float32 and p = exp(s − lse)·valid: dp = g·vᵀ, ds = p·(dp − δ)·scale,
dq = ds·k, dk = dsᵀ·q, dv = pᵀ·g. ``PatchAttention`` joins the two as an
autograd Function; the key validity gets no gradient.

This is the route of contextual attention wherever the fused kernels
(ops/kernels/fused_attention.py) do not take the map: f ≠ b, ksize ≠ 3,
and maps whose score rows do not fit shared memory (the 2048² image), and
the gradient where the fused backward's plan does not fit. The patch
widths are large there (d = 9C = 1728, dv = 4r²C = 3072 at C = 192, rate
2), so one row tile is shared by a cluster of up to 8 blocks (16 in the
bf16 backward), each holding a slice of d and of dv (:func:`plan`; the
designs are in the CUDA sources).
Bound on an H100: 2·Lq·Lk·(d + dv) operations (forward), 2·Lq·Lk·(2d + dv)
(dQ), 2·Lq·Lk·(2d + 2dv) (dK/dV) against (Lq + Lk)·(d + dv) input
elements — bounded by operations.

Beside the kernels: :func:`patch_attention_plain` (dense attention) and
:func:`patch_attention_bwd_plain` (the flash backward written as formulas,
not autograd), which a CPU tensor takes and the card's checks compare
with; and :func:`patch_attention_mirror`, the kernels' tiling in PyTorch
(column tiles, running max and sum, per-rank slices of d and dv summed in
rank order, weights rounded as the kernels round them), which the CPU tests
hold against the plain versions and the JAX Pallas forward. On a CUDA
tensor the wrappers launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import (
    count_launch,
    interpreting,
    use_kernel,
)
from gan_inpainting_torch.ops.kernels import build

KERNEL_FWD = "patch_attention_fwd"
KERNEL_DQ = "patch_attention_bwd_dq"
KERNEL_DKV = "patch_attention_bwd_dkv"
NEG_INF = -1e9
SMEM_BYTES = 232448
_CLUSTERS = (1, 2, 4, 8)
_DTYPES = (torch.float32, torch.bfloat16)
_WARPS = 8
# (rows per cluster, columns per step, accumulator fragments per warp of
# the d slice, of the dv slice) — csrc/patch_attention.cu ``Tiles`` of the
# CUDA-core template
_TILES = {
    ("fwd", torch.bfloat16): (64, 64, 0, 24),
    ("fwd", torch.float32): (64, 32, 0, 24),
    ("dq", torch.bfloat16): (64, 32, 16, 0),
    ("dq", torch.float32): (32, 32, 16, 0),
    ("dkv", torch.bfloat16): (32, 64, 8, 12),
    ("dkv", torch.float32): (32, 32, 8, 12),
}


def _a16(x: int) -> int:
    return -(-x // 16) * 16


def _slice_width(n: int, cl: int) -> int:
    """Widest 16-aligned slice of an n-wide dimension over cl blocks."""
    nch = -(-n // 16)
    return -(-nch // cl) * 16


def smem_bytes(which: str, dtype: torch.dtype, d: int, dv: int,
               cl: int) -> int:
    """Shared memory of one block (csrc/patch_attention.cu ``smem_layout``)."""
    br, bc, _, _ = _TILES[which, dtype]
    ts = 2 if dtype == torch.bfloat16 else 4
    ld1, ld2 = _slice_width(d, cl) + 8, _slice_width(dv, cl) + 8
    n_part = 1 if which == "fwd" else 2
    n_w = 2 if which == "dkv" else 1
    own = br // cl
    total = _a16(br * ld1 * ts)
    if which != "fwd":
        total += _a16(br * ld2 * ts)
    total += _a16(bc * ld1 * ts) + _a16(bc * ld2 * ts)
    total += _a16(2 * n_part * br * (bc + 4) * 4)
    total += _a16(2 * n_w * own * (bc + 8) * ts) + _a16(4 * own * 4)
    total += _a16(n_w * br * (bc + 8) * ts) + _a16(br * 4)
    return total


def _fits(which: str, dtype: torch.dtype, d: int, dv: int, cl: int) -> bool:
    br, _, f1, f2 = _TILES[which, dtype]
    wpr = _WARPS // (br // 16)
    if which != "fwd" and -(-_slice_width(d, cl) // 8 // wpr) > f1:
        return False
    if which != "dq" and -(-_slice_width(dv, cl) // 8 // wpr) > f2:
        return False
    return smem_bytes(which, dtype, d, dv, cl) <= SMEM_BYTES


# csrc/attention_wgmma.cuh: 64-wide units of d and dv per block of a cluster
WGMMA_UNIT = 64
WGMMA_MAX_D_UNITS = 4         # the block's resident slice of the Q tile
WGMMA_MAX_DV_UNITS = 6        # 3 per consumer warpgroup


def wgmma_cluster(n1: int, n2: int) -> int | None:
    """Smallest cluster of the wgmma forward whose blocks each hold at most
    4 of the n1 d units and 6 of the n2 dv units; None if 8 do not."""
    for cl in _CLUSTERS:
        if -(-n1 // cl) <= WGMMA_MAX_D_UNITS and \
                -(-n2 // cl) <= WGMMA_MAX_DV_UNITS:
            return cl
    return None


# csrc/attention_bwd_wgmma.cuh: the backward's clusters (16 is a
# non-portable size), accumulated units per block (3 per consumer
# warpgroup), ring depth, and shared-memory layout (``layout``)
WGMMA_BWD_CLUSTERS = (1, 2, 4, 8, 16)
WGMMA_BWD_MAX_ACC = 6
WGMMA_BWD_MAX_RING = 8
WGMMA_BWD_FLOAT_REGS = 3 * 32 + 64          # accumulators, S or dP
# the phases whose cycles the wgmma backward counts (``_launch_bwd``'s
# ``clocks``)
BWD_PHASES = ("s_dp_products", "partial_write", "exchange_1", "owned_rows",
              "exchange_2", "weight_copy", "grad_products")
_STAGE_BYTES = 128 * WGMMA_UNIT * 2          # 128 columns × one unit
_RES_BYTES = 64 * WGMMA_UNIT * 2             # 64 rows × one unit
_PARTIAL_BYTES = 64 * (128 + 8) * 4          # one float32 partial tile


def wgmma_bwd_smem(which: str, ring: int, du: int, dvu: int,
                   cl: int) -> int:
    """Shared memory of one block of the bf16 dQ / dK/dV kernel
    (``layout``): the ring, the du + dvu resident units, the S and dP
    partials, the published weight rows (ds; and p for dK/dV), the
    barriers and 1024 bytes of alignment slack."""
    n_pub = 1 if which == "dq" else 2
    return (ring * _STAGE_BYTES + (du + dvu) * _RES_BYTES
            + 2 * _PARTIAL_BYTES + n_pub * (64 // cl) * 128 * 2
            + 8 * (2 * ring + 3) + 1024)


def wgmma_bwd_fit(which: str, d: int, dv: int, cl: int) -> dict | None:
    """The bf16 dQ / dK/dV kernel's plan at cluster ``cl`` (``configure``
    in csrc/attention_bwd_wgmma.cuh), or None where it does not fit: per
    block ⌈n1/cl⌉ d and ⌈n2/cl⌉ dv units; the accumulated units (dQ: the d
    units; dK/dV: both) at most 6, 3 per consumer warpgroup, 96 float32
    registers beside 64 of S or dP; a ring of at least a whole step's
    stages (some feed the step's products, so they stay until its end)
    plus one, as deep as shared memory allows up to 8. Each consumer
    thread holds ``WGMMA_BWD_FLOAT_REGS`` float32 registers of tiles,
    whatever n_acc."""
    n1, n2 = -(-d // WGMMA_UNIT), -(-dv // WGMMA_UNIT)
    du, dvu = -(-n1 // cl), -(-n2 // cl)
    n_acc = du if which == "dq" else du + dvu
    min_ring = du + dvu + 1
    if n_acc > WGMMA_BWD_MAX_ACC:
        return None
    ring = WGMMA_BWD_MAX_RING
    while ring > min_ring and \
            wgmma_bwd_smem(which, ring, du, dvu, cl) > SMEM_BYTES:
        ring -= 1
    smem = wgmma_bwd_smem(which, ring, du, dvu, cl)
    if ring < min_ring or smem > SMEM_BYTES:
        return None
    return dict(cluster=cl, ring=ring, smem=smem, d_units=du, dv_units=dvu,
                acc_units_per_warpgroup=-(-n_acc // 2))


def plan(d: int, dv: int, dtype: torch.dtype,
         which: str = "fwd") -> tuple[str, int]:
    """(variant, cluster) of the ``"fwd"``, ``"dq"`` or ``"dkv"`` kernel.
    In bf16 each is ``wgmma``: the forward (csrc/attention_wgmma.cuh) with
    the smallest cluster :func:`wgmma_cluster` allows, dQ and dK/dV
    (csrc/attention_bwd_wgmma.cuh) with the smallest that
    :func:`wgmma_bwd_fit` admits. In float32 ``core``, the smallest
    cluster whose per-block slices of d and dv fit the accumulator
    registers and shared memory. Raises for widths no cluster holds; never
    falls back to another variant."""
    if dtype not in _DTYPES:
        raise TypeError(f"patch attention kernels take {_DTYPES}, got {dtype}")
    if dtype == torch.float32:
        return "core", _template_cluster(which, d, dv, dtype)
    if which == "fwd":
        cl = wgmma_cluster(-(-d // WGMMA_UNIT), -(-dv // WGMMA_UNIT))
    else:
        cl = next((c for c in WGMMA_BWD_CLUSTERS
                   if wgmma_bwd_fit(which, d, dv, c)), None)
    if cl is None:
        raise ValueError(f"patch attention {which}: widths d={d} dv={dv} "
                         f"({dtype}) exceed what a cluster of "
                         f"{8 if which == 'fwd' else 16} blocks holds")
    return "wgmma", cl


def _template_cluster(which: str, d: int, dv: int,
                      dtype: torch.dtype) -> int:
    for cl in _CLUSTERS:
        if _fits(which, dtype, d, dv, cl):
            return cl
    raise ValueError(f"patch attention {which}: widths d={d} dv={dv} "
                     f"({dtype}) exceed what a cluster of 8 blocks holds")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, key_valid, softmax_scale):
    """scale·q·kᵀ + bias in float32, (B, Lq, Lk)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    bias = torch.where(key_valid, 0.0, NEG_INF)[:, None, :]
    return s * softmax_scale + bias


def patch_attention_plain(q, k, key_valid, v, *, softmax_scale: float,
                          want_lse: bool = False):
    """Dense attention: materializes the (Lq, Lk) scores. Products in
    float32; the weights are rounded to V's dtype before the PV product.
    Returns (B, Lq, dv) in v's dtype, and with ``want_lse`` the (B, Lq)
    float32 log-sum-exp over the valid keys (0 where none is valid)."""
    s = _scores(q, k, key_valid, softmax_scale)
    valid = key_valid[:, None, :]
    attn = torch.softmax(s, dim=-1) * valid.to(s.dtype)
    out = torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)
    if not want_lse:
        return out
    lse = torch.logsumexp(s.masked_fill(~valid, float("-inf")), dim=-1)
    return out, torch.where(key_valid.any(-1, keepdim=True), lse, 0.0)


def patch_attention_bwd_plain(q, k, key_valid, v, out, lse, g, *,
                              softmax_scale: float, keep_float: bool = False):
    """The flash backward as formulas (not autograd), float32 throughout:
    p rebuilt from lse, dp, ds, then (dq, dk, dv) in the inputs' dtypes
    (float32 with ``keep_float``)."""
    s = _scores(q, k, key_valid, softmax_scale)
    p = torch.where(key_valid[:, None, :], torch.exp(s - lse[..., None]), 0.0)
    del s
    gf = g.float()
    dp = torch.matmul(gf, v.float().transpose(1, 2))
    delta = (gf * out.float()).sum(-1)
    ds = p * (dp - delta[..., None]) * softmax_scale
    del dp
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), gf)
    if keep_float:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _slices(n: int, cl: int, unit: int = 16) -> list[slice]:
    """The ranks' ``unit``-wide chunks of an n-wide dimension, clamped to
    n: rank r holds chunks [r·n_ch/cl, (r+1)·n_ch/cl)."""
    nch = -(-n // unit)
    return [slice(min(r * nch // cl * unit, n),
                  min((r + 1) * nch // cl * unit, n)) for r in range(cl)]


def patch_attention_mirror(q, k, key_valid, v, *, softmax_scale: float,
                           cluster: int, block_c: int, unit: int = 16,
                           out=None, lse=None, g=None):
    """The kernels' arithmetic in PyTorch. Forward (``g`` None): loops
    over key steps of ``block_c`` with the running max and sum, p =
    exp(s − m)·valid rounded to the inputs' dtype for the PV product (the
    sum takes it unrounded), the accumulator rescaled by exp(m_old − m_new)
    → (out, lse). The wgmma forward (csrc/attention_wgmma.cuh) is
    ``unit`` = 64, ``block_c`` = 128 and the cluster of :func:`plan`; the
    float32 template is ``unit`` 16, ``block_c`` 32. Backward: the dQ
    kernel's loop over key tiles and the dK/dV kernel's over query tiles →
    (dq, dk, dv), float32; the wgmma backward (csrc/attention_bwd_wgmma.cuh)
    is ``unit`` 64, ``block_c`` 128 and the cluster of :func:`plan`. Scores (and dp) are the sums, in rank order, of
    the ``cluster`` ranks' ``unit``-wide slices of d (dv); p and ds are
    rounded to the inputs' dtype before their products."""
    t = v.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    bsz, lq, _ = q.shape
    lk = k.shape[1]
    sd = _slices(q.shape[-1], cluster, unit)
    sdv = _slices(v.shape[-1], cluster, unit)

    def ranked(a, b_, slices):
        acc = None
        for sl in slices:
            part = torch.matmul(a[..., sl], b_[..., sl].transpose(1, 2))
            acc = part if acc is None else acc + part
        return acc

    def rnd(x):
        return x.to(t).float()

    bias = torch.where(key_valid, 0.0, NEG_INF)
    if g is None:
        m = torch.full((bsz, lq, 1), -1e30, device=q.device)
        l_ = torch.zeros((bsz, lq, 1), device=q.device)
        acc = torch.zeros((bsz, lq, v.shape[-1]), device=q.device)
        for c0 in range(0, lk, block_c):
            cs = slice(c0, c0 + block_c)
            s = ranked(qf, kf[:, cs], sd) * softmax_scale + bias[:, None, cs]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(key_valid[:, None, cs], torch.exp(s - m_new), 0.0)
            l_ = l_ * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(rnd(p), vf[:, cs])
            m = m_new
        inv = torch.where(l_ > 0, 1.0 / torch.clamp(l_, min=1e-30), 0.0)
        lse_ = torch.where(l_ > 0, m + torch.log(torch.clamp(l_, min=1e-30)),
                           0.0)
        return (acc * inv).to(t), lse_[..., 0]
    gf = g.float()
    delta = (gf * out.float()).sum(-1)
    dq = torch.zeros_like(qf)
    for c0 in range(0, lk, block_c):            # dQ: rows are queries
        cs = slice(c0, c0 + block_c)
        s = ranked(qf, kf[:, cs], sd) * softmax_scale + bias[:, None, cs]
        p = torch.where(key_valid[:, None, cs], torch.exp(s - lse[..., None]),
                        0.0)
        ds = p * (ranked(gf, vf[:, cs], sdv) - delta[..., None]) \
            * softmax_scale
        dq += torch.matmul(rnd(ds), kf[:, cs])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, lq, block_c):            # dK/dV: rows are keys
        cs = slice(c0, c0 + block_c)
        s = ranked(kf, qf[:, cs], sd) * softmax_scale + bias[..., None]
        p = torch.where(key_valid[..., None],
                        torch.exp(s - lse[:, None, cs]), 0.0)
        ds = p * (ranked(vf, gf[:, cs], sdv) - delta[:, None, cs]) \
            * softmax_scale
        dv += torch.matmul(rnd(p), gf[:, cs])
        dk += torch.matmul(rnd(ds), qf[:, cs])
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _mirror_tiles(which: str, d: int, dv: int, dtype: torch.dtype) -> dict:
    """:func:`patch_attention_mirror`'s tiling for the kernel that
    :func:`plan` picks: the wgmma kernels' 64-wide units and 128-column
    steps, the float32 template's 16 and 32, at the plan's cluster."""
    variant, cluster = plan(d, dv, dtype, which)
    unit, block_c = (WGMMA_UNIT, 128) if variant == "wgmma" else (16, 32)
    return dict(cluster=cluster, block_c=block_c, unit=unit)


def _check(q, k, key_valid, v, *extra):
    if q.dtype not in _DTYPES:
        raise TypeError(f"patch attention kernels take {_DTYPES}, got "
                        f"{q.dtype}")
    bsz, lq, d = q.shape
    _, lk, dv = v.shape
    want = {"k": (k, (bsz, lk, d)), "v": (v, (bsz, lk, dv))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {shape} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if key_valid.dtype != torch.bool or tuple(key_valid.shape) != (bsz, lk):
        raise ValueError(f"key_valid must be bool (B, Lk) = {(bsz, lk)}")
    for t in (q, k, key_valid, v, *extra):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError("patch attention kernels take contiguous "
                             f"tensors on {q.device}")


def _pick(which, d, dv, dtype, variant):
    chosen, cluster = plan(d, dv, dtype, which)
    if variant is not None and variant != chosen:
        if variant != "core":
            raise ValueError(f"the {variant} variant does not take {dtype}")
        chosen, cluster = "core", _template_cluster(which, d, dv, dtype)
    return chosen, cluster


def _fn(name: str, n_ptr: int, tail: int = 2, head: int = 0):
    """The C entry ``name``: ``head`` ints, n_ptr pointers, B, Lq, Lk, d,
    dv, scale, then ``tail`` ints (is_bf16 and cluster: the CUDA-core
    template; cluster: the wgmma backward) and the stream — or, with
    ``tail`` 0, cluster and the phase clocks pointer (the clocked wgmma
    backward)."""
    lib = build.library("patch_attention")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * head + [ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + ([ctypes.c_int] * tail if tail
                      else [ctypes.c_int, ctypes.c_void_p])
                   + [ctypes.c_void_p])
    return lib, fn


def wgmma_bwd_clusters(which: str, d: int, dv: int) -> int:
    """How many clusters of the planned bf16 dQ / dK/dV kernel the card
    holds at once (cudaOccupancyMaxActiveClusters); 0 = cannot launch."""
    _, cl = plan(d, dv, torch.bfloat16, which)
    lib = build.library("patch_attention")
    fn = lib.gi_patch_attention_bwd_wgmma_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = ctypes.c_int(0)
    err = fn(int(which == "dkv"), -(-d // 8) * 8, -(-dv // 8) * 8, cl,
             ctypes.byref(out))
    build.check(lib, err, f"patch attention {which} occupancy")
    return out.value


def _pad8(t: torch.Tensor) -> torch.Tensor:
    """t with its last dimension zero-padded to a multiple of 8 (rows of
    16 bytes, as a TMA tensor map needs)."""
    n = t.shape[-1]
    return t if n % 8 == 0 else F.pad(t, (0, -n % 8))


def launch_fwd(q, k, key_valid, v, softmax_scale: float, *,
               want_lse: bool = False, variant: str | None = None):
    """The forward kernel → out (B, Lq, dv) in v's dtype, and with
    ``want_lse`` the (B, Lq) float32 lse. ``variant`` overrides
    :func:`plan`'s choice (``core`` on bf16, for the card's tests)."""
    _check(q, k, key_valid, v)
    bsz, lq, d = q.shape
    _, lk, dv = v.shape
    variant, cluster = _pick("fwd", d, dv, q.dtype, variant)
    lse = (torch.empty((bsz, lq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    lse_ptr = lse.data_ptr() if want_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "wgmma":
        q, k, v = _pad8(q), _pad8(k), _pad8(v)
        dp, dvp = q.shape[-1], v.shape[-1]
        out = torch.empty((bsz, lq, dvp), dtype=v.dtype, device=q.device)
        lib = build.library("patch_attention")
        fn = lib.gi_patch_attention_fwd_wgmma
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k.data_ptr(), key_valid.data_ptr(),
                     v.data_ptr(), out.data_ptr(), lse_ptr, bsz, lq, lk, dp,
                     dvp, float(softmax_scale), cluster, stream)
        if dvp != dv:
            out = out[..., :dv].contiguous()
    else:
        out = torch.empty((bsz, lq, dv), dtype=v.dtype, device=q.device)
        lib, fn = _fn("gi_patch_attention_fwd", 6)
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k.data_ptr(), key_valid.data_ptr(),
                     v.data_ptr(), out.data_ptr(), lse_ptr, bsz, lq, lk, d,
                     dv, float(softmax_scale), int(q.dtype == torch.bfloat16),
                     cluster, stream)
    count_launch(KERNEL_FWD)
    build.check(lib, err, KERNEL_FWD)
    return (out, lse) if want_lse else out


def _bwd_inputs(g, lse, delta, bsz, lq, dv, dtype):
    if tuple(g.shape) != (bsz, lq, dv) or g.dtype != dtype:
        raise ValueError(f"g must be {(bsz, lq, dv)} {dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (bsz, lq):
            raise ValueError(f"{name} must be float32 (B, Lq)")


def _launch_bwd(which, q, k, key_valid, v, g, lse, delta, softmax_scale,
                variant, clocks=None):
    """The dQ (``which`` "dq") or dK/dV ("dkv") kernel → its gradients in
    the inputs' dtype. The wgmma kernels take rows of 16 bytes: d and dv
    are zero-padded to multiples of 8 and the gradients sliced back.
    ``clocks`` (profiling only: tools/bench_attention.py, the card
    tests): None, or a zeroed (8,) int64 CUDA tensor into which the wgmma
    kernel's clocked instance (cluster 2 or 16) adds its blocks' cycles per
    phase (see :data:`BWD_PHASES`) and their step count."""
    _check(q, k, key_valid, v, g, lse, delta)
    bsz, lq, d = q.shape
    _, lk, dv = v.shape
    _bwd_inputs(g, lse, delta, bsz, lq, dv, q.dtype)
    variant, cluster = _pick(which, d, dv, q.dtype, variant)
    wgmma = variant == "wgmma"
    if wgmma:
        q, k, v, g = _pad8(q), _pad8(k), _pad8(v), _pad8(g)
    outs = ([torch.empty_like(q)] if which == "dq"
            else [torch.empty_like(k), torch.empty_like(v)])
    if clocks is not None and (not wgmma or cluster not in (2, 16)):
        raise ValueError("phase clocks come from the wgmma kernels at "
                         "clusters of 2 and 16 only")
    ptrs = [q.data_ptr(), k.data_ptr(), key_valid.data_ptr(), v.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs)]
    if clocks is not None:
        head, ptrs = [int(which == "dkv")], ptrs + [None] * (2 - len(outs))
        lib, fn = _fn("gi_patch_attention_bwd_wgmma_clocked", 9, 0, 1)
        tail = [cluster, clocks.data_ptr()]
    elif wgmma:
        head, tail = [], [cluster]
        lib, fn = _fn(f"gi_patch_attention_{which}_wgmma", len(ptrs), 1)
    else:
        head, tail = [], [int(q.dtype == torch.bfloat16), cluster]
        lib, fn = _fn(f"gi_patch_attention_{which}", len(ptrs))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*head, *ptrs, bsz, lq, lk, q.shape[-1], v.shape[-1],
                 float(softmax_scale), *tail, stream)
    kernel = KERNEL_DQ if which == "dq" else KERNEL_DKV
    count_launch(kernel)
    build.check(lib, err, kernel)
    widths = (d,) if which == "dq" else (d, dv)
    return [t if t.shape[-1] == w else t[..., :w].contiguous()
            for t, w in zip(outs, widths)]


def launch_dq(q, k, key_valid, v, g, lse, delta, softmax_scale: float, *,
              variant: str | None = None):
    """The dQ kernel → dq (B, Lq, d) in q's dtype. ``delta`` = rowsum(g∘out)
    (B, Lq) float32. ``variant`` ``core`` overrides :func:`plan` on bf16
    (for the card's comparisons)."""
    return _launch_bwd("dq", q, k, key_valid, v, g, lse, delta,
                       softmax_scale, variant)[0]


def launch_dkv(q, k, key_valid, v, g, lse, delta, softmax_scale: float, *,
               variant: str | None = None):
    """The dK/dV kernel → (dk (B, Lk, d), dv (B, Lk, dv)) in the inputs'
    dtype."""
    dk, dv = _launch_bwd("dkv", q, k, key_valid, v, g, lse, delta,
                         softmax_scale, variant)
    return dk, dv


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def patch_attention(q, k, key_valid, v, *, softmax_scale: float,
                    want_lse: bool = False):
    """Patch attention: q (B, Lq, d), k (B, Lk, d) normalized keys,
    key_valid (B, Lk) bool, v (B, Lk, dv) → (B, Lq, dv) in v's dtype; rows
    with no valid key are exactly 0. ``want_lse`` also returns the (B, Lq)
    float32 log-sum-exp the backward rebuilds p from."""
    if interpreting():
        _check(q, k, key_valid, v)
        out, lse = patch_attention_mirror(
            q, k, key_valid, v, softmax_scale=softmax_scale,
            **_mirror_tiles("fwd", q.shape[-1], v.shape[-1], q.dtype))
        return (out, lse) if want_lse else out
    if not use_kernel(q):
        return patch_attention_plain(q, k, key_valid, v,
                                     softmax_scale=softmax_scale,
                                     want_lse=want_lse)
    return launch_fwd(q.contiguous(), k.contiguous(), key_valid.contiguous(),
                      v.contiguous(), softmax_scale, want_lse=want_lse)


def patch_attention_bwd(q, k, key_valid, v, out, lse, g, *,
                        softmax_scale: float):
    """(dq, dk, dv) of patch attention from the forward's (out, lse) and
    the output gradient ``g``; δ = rowsum(g∘out) is taken in float32."""
    if interpreting():
        _check(q, k, key_valid, v)
        d, dv = q.shape[-1], v.shape[-1]
        args = dict(softmax_scale=softmax_scale, out=out, lse=lse,
                    g=g.to(q.dtype))
        dq = patch_attention_mirror(q, k, key_valid, v, **args,
                                    **_mirror_tiles("dq", d, dv, q.dtype))[0]
        _, dk, dv_ = patch_attention_mirror(
            q, k, key_valid, v, **args, **_mirror_tiles("dkv", d, dv,
                                                        q.dtype))
        return dq.to(q.dtype), dk.to(q.dtype), dv_.to(q.dtype)
    if not use_kernel(q):
        return patch_attention_bwd_plain(q, k, key_valid, v, out, lse, g,
                                         softmax_scale=softmax_scale)
    q, k, key_valid, v = (t.contiguous() for t in (q, k, key_valid, v))
    g = g.to(q.dtype).contiguous()
    lse = lse.contiguous()
    delta = (g.float() * out.float()).sum(-1).contiguous()
    dq = launch_dq(q, k, key_valid, v, g, lse, delta, softmax_scale)
    dk, dv = launch_dkv(q, k, key_valid, v, g, lse, delta, softmax_scale)
    return dq, dk, dv


class PatchAttention(torch.autograd.Function):
    """Patch attention with the kernel backward; saves (q, k, key_valid,
    v, out, lse). The key validity gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, key_valid, v, softmax_scale):
        out, lse = patch_attention(q, k, key_valid, v,
                                   softmax_scale=softmax_scale, want_lse=True)
        ctx.save_for_backward(q, k, key_valid, v, out, lse)
        ctx.softmax_scale = softmax_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, key_valid, v, out, lse = ctx.saved_tensors
        dq, dk, dv = patch_attention_bwd(q, k, key_valid, v, out, lse, g,
                                         softmax_scale=ctx.softmax_scale)
        return dq, dk, None, dv, None


def attend(q, k, key_valid, v, softmax_scale: float):
    """Patch attention, through :class:`PatchAttention` where a gradient is
    wanted (no lse is written otherwise)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return PatchAttention.apply(q, k, key_valid, v, softmax_scale)
    return patch_attention(q, k, key_valid, v, softmax_scale=softmax_scale)
