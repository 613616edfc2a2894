"""Gated conv at any stride, and the plan, packing and launch of
``csrc/gated_conv.cu`` shared with ops/kernels/direct_conv.py.

``gated_conv_matmul`` replaces the Pallas kernel ``_gated_matmul_kernel``
(gan_inpainting_tpu/ops/pallas/fused_matmul.py:76, entry
``gated_conv_pallas``), which multiplies the rows of a materialized im2col:
the forms the implicit-GEMM wrapper does not take, the generators'
stride-2 convs and even windows. Here ``gi_gated_conv`` reads the strided
taps of the map itself (TMA boxes with element strides, or the gather), so
no im2col reaches device memory, and fuses the whole epilogue (bias,
activation, sigmoid gate, product), so the 2F-channel pre-activation does
not either. (The kernel over materialized im2col rows ran as fast, but
the im2col itself cost as much again: chip_smoke.py [2] times both.)

On an H100 the product is bounded by operations (2·M·K·2F at 989 TFLOP/s
in bf16). The bf16 kernel (wgmma fed by TMA, or by a cp.async gather where
no TMA box fits) and the float32 one (CUDA cores) are described in the
source note of ``csrc/gated_conv.cu``. Here: :func:`plan` picks the tiles
per (Cin, F, dtype), :func:`a_tile` the TMA box of a block's 128 pixels
per map, :func:`pack_weights` lays the weights out as the kernel reads
them, and :func:`packed_weights` keeps one packed copy per weight tensor
until the tensor changes. :func:`gated_conv_mirror` repeats the kernel's
index algebra (the walk over tiles, box rows, tap rows, packed rows and
column blocks) in PyTorch for the CPU tests.

On a CPU tensor the wrapper takes the plain version
(:func:`gan_inpainting_torch.ops.gated_conv.gated_conv_plain`: conv2d +
``gated_epilogue``). The gradient, as in the JAX package, recomputes
through that plain composition: no backward kernel.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import (
    count_launch,
    interpreting,
    use_kernel,
)
from gan_inpainting_torch.ops.gated_conv import (
    gated_conv_plain,
    gated_epilogue,
)
from gan_inpainting_torch.ops.kernels import build
from gan_inpainting_torch.ops.patches import same_pads

KERNEL = "gated_matmul"
SOURCE = "gated_conv"
ACTIVATIONS = {"none": 0, "elu": 1, "relu": 2, "leaky_relu": 3, "tanh": 4}
_DTYPES = (torch.float32, torch.bfloat16)
BLOCK_M = 128                 # output pixels per tile
SLAB = 32                     # K per stage of either kernel
WGMMA_BLOCK_F = (24, 48, 96)  # features per column block (wgmma N = 2·BF)


class GatedPlan(NamedTuple):
    """Tiles of one gated conv: ``kind`` "wgmma" (bf16) or "fma"
    (float32); the map's channels padded to ``cin_pad``; ``kpt`` K rows
    per tap in the packed weights; ``block_f`` features per column block
    and ``n_col`` column blocks; ``cluster`` blocks along M sharing each
    weight slab (bf16)."""
    kind: str
    cin_pad: int
    kpt: int
    block_f: int
    n_col: int
    cluster: int


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def plan(cin: int, features: int, dtype: torch.dtype) -> GatedPlan:
    """bf16: Cin padded to the 16-byte vector; K rows per tap padded to a
    whole 32-row slab where that wastes at most a third (48 → 64: TMA then
    feeds the slab), else to 8 (the stem); the smallest of 24 / 48 / 96
    features per block that holds F (96 and ⌈F / 96⌉ blocks above), the
    weight slab multicast over 4 blocks (2 at 24, so a slice stays a whole
    8-row swizzle atom). float32: Cin padded to 4, 32 or 64 features per
    block, whichever pads F less."""
    if dtype == torch.bfloat16:
        block_f = next((b for b in WGMMA_BLOCK_F if features <= b),
                       WGMMA_BLOCK_F[-1])
        cluster = 4 if (2 * block_f // 4) % 8 == 0 else 2
        cin8, cin32 = _rup(cin, 8), _rup(cin, SLAB)
        kpt = cin32 if 3 * cin32 <= 4 * cin8 else cin8
        return GatedPlan("wgmma", cin8, kpt, block_f,
                         -(-features // block_f), cluster)
    block_n = 32 if _rup(features, 32) < _rup(features, 64) else 64
    return GatedPlan("fma", _rup(cin, 4), _rup(cin, 4), block_n,
                     -(-features // block_n), 1)


def fill_bytes_per_flop(p: GatedPlan) -> float:
    """Bytes a block fills from L2 per FLOP it computes, per K stage: the
    A tile and this block's share of the weight slab (bf16), or the A tile
    and both weight halves (float32)."""
    n = 2 * p.block_f
    elem = 2 if p.kind == "wgmma" else 4
    filled = (BLOCK_M * SLAB + n * SLAB / p.cluster) * elem
    return filled / (2.0 * BLOCK_M * n * SLAB)


def a_tile(p: GatedPlan, batch: int, ho: int, wo: int,
           stride: int) -> tuple[int, int, int] | None:
    """(pixels along W, rows, images) of the TMA box holding a tile's 128
    output pixels, or None where the kernel gathers instead: float32, taps
    not aligned to the 32-row slab, or pixels that do not form a box."""
    if p.kind != "wgmma" or p.kpt % SLAB:
        return None
    if wo % BLOCK_M == 0:
        tile = (BLOCK_M, 1, 1)
    elif BLOCK_M % wo == 0:
        rows = BLOCK_M // wo
        if ho % rows == 0:
            tile = (wo, rows, 1)
        elif rows % ho == 0:
            tile = (wo, ho, rows // ho)
        else:
            return None
    else:
        return None
    return tile if max(tile[0], tile[1]) * stride <= 256 else None


def pad_channels(x: torch.Tensor, cin_pad: int) -> torch.Tensor:
    """Zero channels up to ``cin_pad`` on the last axis (the 4-channel stem
    input; a no-op at every other width of the generators)."""
    return x if x.shape[-1] == cin_pad else F.pad(
        x, (0, cin_pad - x.shape[-1]))


def pack_weights(weight: torch.Tensor, p: GatedPlan) -> torch.Tensor:
    """(2F, Cin, k, k), features first → the kernel's layout, K in (tap,
    channel) order, ``kpt`` rows per tap (zero rows past Cin) and zero rows
    up to a whole slab:

    * wgmma: (slabs, n_col·2·block_f, 32), K-major — slab s holds K rows
      32·s … 32·s + 31; packed row j·2·BF + i is feature j·BF + i of
      column block j and row j·2·BF + BF + i its gate (zero past F). One
      TMA box (32, rows, 1) loads a block's share of a slab.
    * fma: (K_pad, 2, n_col·block_f), half 0 the features and half 1 the
      gates, zero columns past F.
    """
    f2, cin, kh, kw = weight.shape
    f = f2 // 2
    k_dim = kh * kw * p.kpt
    w = weight.reshape(2, f, cin, kh, kw).permute(3, 4, 2, 0, 1)
    fp = p.block_f * p.n_col
    w = F.pad(w, (0, fp - f, 0, 0, 0, p.kpt - cin)).reshape(k_dim, 2, fp)
    w = F.pad(w, (0, 0, 0, 0, 0, _rup(k_dim, SLAB) - k_dim))
    if p.kind == "fma":
        return w.contiguous()
    # (K_pad, 2, n_col, BF) → (slabs, n_col, 2, BF, 32)
    w = w.reshape(-1, SLAB, 2, p.n_col, p.block_f).permute(0, 3, 2, 4, 1)
    return w.reshape(-1, p.n_col * 2 * p.block_f, SLAB).contiguous()


_packed: dict[int, tuple] = {}
_packed_lock = threading.Lock()   # the service's dispatcher thread, callers


def packed_weights(weight: torch.Tensor, p: GatedPlan,
                   dtype: torch.dtype) -> torch.Tensor:
    """:func:`pack_weights` of ``weight`` in ``dtype``, kept per weight
    tensor and (dtype, plan), and repacked when (data_ptr, _version)
    changes — an optimizer's in-place step bumps ``_version`` — so a
    served layer packs once, whichever thread serves it. Inference tensors,
    which keep no version, are packed per call."""
    if weight.is_inference():
        return pack_weights(weight.detach().to(dtype), p)
    state = (weight.data_ptr(), weight._version)
    with _packed_lock:
        hit = _packed.get(id(weight))
        if hit is None or hit[0]() is not weight or hit[1] != state:
            ref = weakref.ref(weight,
                              lambda _, i=id(weight): _packed.pop(i, None))
            hit = _packed[id(weight)] = (ref, state, {})
        layouts = hit[2]
        if (dtype, p) not in layouts:
            layouts[(dtype, p)] = pack_weights(weight.detach().to(dtype), p)
        return layouts[(dtype, p)]


class ConvGeom(NamedTuple):
    """A gated conv's geometry as the kernel takes it: window, stride,
    dilation, low-side TF-SAME pads and the output map."""
    k: int
    stride: int
    dilation: int
    pad_y: int
    pad_x: int
    ho: int
    wo: int


def conv_geom(h: int, w: int, k: int, stride: int,
              dilation: int) -> ConvGeom:
    eff = (k - 1) * dilation + 1
    return ConvGeom(k, stride, dilation, same_pads(h, eff, stride)[0],
                    same_pads(w, eff, stride)[0], -(-h // stride),
                    -(-w // stride))


def tap_rows(x: torch.Tensor, g: ConvGeom, kpt: int) -> torch.Tensor:
    """(B, H, W, C) → (B·Ho·Wo, k²·kpt): each output pixel's window in
    (tap, channel) order as the kernel reads it — input pixel (oy·s −
    pad_y + ky·d, ox·s − pad_x + kx·d), zero outside the map (the TF-SAME
    pads, the odd pixel on the high side at stride 2) and in channels C …
    kpt − 1."""
    b, h, w, c = x.shape
    taps = torch.arange(g.k) * g.dilation
    iy = (torch.arange(g.ho) * g.stride - g.pad_y)[:, None] + taps
    ix = (torch.arange(g.wo) * g.stride - g.pad_x)[:, None] + taps
    xp = F.pad(x, (0, kpt - c))
    rows = xp[:, iy.clamp(0, h - 1)][:, :, :, ix.clamp(0, w - 1)]
    inside = (((iy >= 0) & (iy < h))[:, :, None, None, None]
              & ((ix >= 0) & (ix < w))[None, None, :, :, None])
    rows = torch.where(inside, rows, torch.zeros((), dtype=x.dtype))
    # (B, Ho, ky, Wo, kx, kpt) → (B, Ho, Wo, ky, kx, kpt)
    return rows.permute(0, 1, 3, 2, 4, 5).reshape(b * g.ho * g.wo, -1)


def gated_conv_mirror(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                      features: int, g: ConvGeom, p: GatedPlan,
                      activation: str) -> torch.Tensor:
    """What ``gi_gated_conv`` computes from its own operands, in float32:
    x (B, H, W, cin_pad) and ``wp`` from :func:`pack_weights`. Tile groups
    are walked as the persistent kernel walks them (C blocks along M × one
    column block each; every output written once is asserted); on the TMA
    path each tile's box rows must be its 128 consecutive pixels
    (asserted). Returns (B, Ho, Wo, F)."""
    b = x.shape[0]
    m_total = b * g.ho * g.wo
    tile = a_tile(p, b, g.ho, g.wo, g.stride)
    a = tap_rows(x.float(), g, p.kpt)
    if p.kind == "wgmma":
        k_pad = wp.shape[0] * SLAB
        # (slabs, n_col·2·BF, 32) → (K_pad, 2, n_col·BF)
        wk = wp.float().permute(0, 2, 1).reshape(k_pad, p.n_col, 2,
                                                 p.block_f)
        wk = wk.transpose(1, 2).reshape(k_pad, 2, -1)
    else:
        wk = wp.float()
    a = F.pad(a, (0, wk.shape[0] - a.shape[1]))
    out = torch.full((m_total, features), float("nan"))
    groups = -(-m_total // (BLOCK_M * p.cluster)) * p.n_col
    for q in range(groups):
        col = q % p.n_col
        n = torch.arange(col * p.block_f, min((col + 1) * p.block_f,
                                              features))
        for rank in range(p.cluster):
            m0 = (q // p.n_col * p.cluster + rank) * BLOCK_M
            rows = m0 + torch.arange(BLOCK_M)
            if tile is not None:
                _check_box(tile, g, b, m0, rows)
            rows = rows[rows < m_total]
            if not len(rows) or not len(n):
                continue
            pre = a[rows] @ wk[:, :, n].reshape(wk.shape[0], -1)
            y = gated_epilogue(torch.cat(
                [pre[:, :len(n)] + bias[n].float(),
                 pre[:, len(n):] + bias[features + n].float()], -1),
                activation)
            assert out[rows[:, None], n].isnan().all(), "tile written twice"
            out[rows[:, None], n] = y
    assert not out.isnan().any(), "a tile was not written"
    return out.reshape(b, g.ho, g.wo, features)


def _check_box(tile, g: ConvGeom, batch: int, m0: int, rows: torch.Tensor):
    """The TMA box of the tile at pixel ``m0`` lists its pixels in the
    order of ``rows``: (images, rows, pixels along W), W fastest."""
    tw, th, _ = tile
    r = rows - m0
    b0, rem = divmod(m0, g.ho * g.wo)
    oy0, ox0 = divmod(rem, g.wo)
    bb, oy, ox = b0 + r // (tw * th), oy0 + r // tw % th, ox0 + r % tw
    inside = (bb < batch) & (oy < g.ho) & (ox < g.wo)
    assert torch.equal(((bb * g.ho + oy) * g.wo + ox)[inside],
                       rows[inside]), "box order != pixel order"
    assert bool(inside[rows < batch * g.ho * g.wo].all()), \
        "a pixel outside its tile's box"


def _check(x, weight, bias, activation):
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[1] != x.shape[3]:
        raise ValueError(f"x {tuple(x.shape)} / weight {tuple(weight.shape)}:"
                         " want (B, H, W, Cin) and (2F, Cin, k, k)")
    if weight.shape[0] % 2 or bias.shape != (weight.shape[0],):
        raise ValueError(f"a gated conv needs 2F outputs and a (2F,) bias, "
                         f"got {tuple(weight.shape)}, {tuple(bias.shape)}")
    if weight.shape[2] != weight.shape[3]:
        raise ValueError("square windows only")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")


def _check_cuda(x, weight, bias):
    """The kernels take float32 or bf16 maps; the weights in x's dtype, or
    float32 parameters that the packing casts (a layer's master weights)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"gated conv kernels take {_DTYPES}, got {x.dtype}")
    if weight.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"weight {weight.dtype} must match x {x.dtype}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must be on one device")


def launch_gated(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                 features: int, g: ConvGeom, p: GatedPlan,
                 activation: str, counter: str) -> torch.Tensor:
    """Launch ``gi_gated_conv`` on a contiguous (B, H, W, cin_pad) map with
    weights from :func:`pack_weights`; adds one to ``counter``'s launches.
    Returns (B, Ho, Wo, F)."""
    b, h, w, cin = x.shape
    if x.data_ptr() % 16:
        x = x.clone()                 # TMA and the 16-byte gather
    tile = a_tile(p, b, g.ho, g.wo, g.stride) or (0, 0, 0)
    out = torch.empty((b, g.ho, g.wo, features), dtype=x.dtype,
                      device=x.device)
    lib = build.library(SOURCE)
    fn = lib.gi_gated_conv
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 21
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, h, w, cin, g.ho, g.wo, features, g.k,
                 g.stride, g.dilation, g.pad_y, g.pad_x, p.kpt, p.block_f,
                 p.n_col, p.cluster, *tile, ACTIVATIONS[activation],
                 int(x.dtype == torch.bfloat16), stream)
    count_launch(counter)
    build.check(lib, err, counter)
    return out


def launch_strided(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                   features: int, k: int, stride: int, dilation: int,
                   p: GatedPlan, activation: str) -> torch.Tensor:
    """The kernel on a contiguous (B, H, W, cin_pad) map at any stride."""
    g = conv_geom(x.shape[1], x.shape[2], k, stride, dilation)
    return launch_gated(x, wp, bias, features, g, p, activation, KERNEL)


class _GatedConv(torch.autograd.Function):
    """A forward kernel with the plain composition's gradient, recomputed
    from the saved (x, weight, bias), as the JAX kernels' custom VJP."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, dilation, activation, fwd):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (stride, dilation, activation)
        return fwd()

    @staticmethod
    def backward(ctx, g):
        stride, dilation, activation = ctx.args
        leaves = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            y = gated_conv_plain(*leaves, stride=stride, dilation=dilation,
                                 activation=activation)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves) + (None,) * 4


def forward_mirror(x, weight, bias, stride, dilation, activation):
    """The forward of ``interpret_kernels``: :func:`gated_conv_mirror` on
    the operands the kernel would get, on the CPU (the mirror walks its
    tiles there), returned on x's device in x's dtype."""
    f = weight.shape[0] // 2
    p = plan(x.shape[3], f, x.dtype)
    g = conv_geom(x.shape[1], x.shape[2], weight.shape[2], stride, dilation)
    out = gated_conv_mirror(pad_channels(x, p.cin_pad).cpu(),
                            pack_weights(weight.detach().to(x.dtype), p).cpu(),
                            bias.cpu(), f, g, p, activation)
    return out.to(x.device, x.dtype)


def _forward_matmul(x, weight, bias, stride, dilation, activation):
    f = weight.shape[0] // 2
    p = plan(x.shape[3], f, x.dtype)
    return launch_strided(pad_channels(x, p.cin_pad),
                          packed_weights(weight, p, x.dtype), bias, f,
                          weight.shape[2], stride, dilation, p, activation)


def gated_conv_matmul(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, *, stride: int = 1,
                      dilation: int = 1,
                      activation: str = "elu") -> torch.Tensor:
    """x: (B, H, W, Cin), weight: (2F, Cin, k, k) in x's dtype (or float32
    master weights), bias: (2F,) → (B, Ho, Wo, F), TF-SAME. Kernel on a
    CUDA tensor, plain on the CPU."""
    _check(x, weight, bias, activation)
    if not (interpreting() or use_kernel(x)):
        return gated_conv_plain(x, weight, bias, stride=stride,
                                dilation=dilation, activation=activation)
    _check_cuda(x, weight, bias)
    x = x.contiguous()
    bias32 = bias.float().contiguous()
    fwd = forward_mirror if interpreting() else _forward_matmul
    return _GatedConv.apply(x, weight, bias, stride, dilation, activation,
                            lambda: fwd(x, weight, bias32, stride, dilation,
                                        activation))
