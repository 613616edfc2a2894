"""Gated conv as a fused gated matmul over a materialized im2col.

``gated_conv_matmul`` replaces the Pallas kernel ``_gated_matmul_kernel``
(gan_inpainting_tpu/ops/pallas/fused_matmul.py:76, entry
``gated_conv_pallas``). Host prep in PyTorch: :func:`_im2col` gathers the
(M, k²·Cin) patch rows (TF-SAME, the odd pixel on the high side at stride
2) and :func:`pack_weights` lays both weight halves out as the kernel reads
them. On a CUDA tensor the product and the whole epilogue — bias,
activation, sigmoid gate, product — run in ``gi_gated_matmul`` of
``csrc/gated_conv.cu`` (one mainloop shared with the implicit-GEMM entry in
ops/kernels/direct_conv.py); the 2F-channel pre-activation never reaches
device memory. It takes any stride and dilation, and is where
``gated_conv(..., backend="pallas")`` sends what the implicit-GEMM kernel
refuses (the generators' stride-2 convs).

On an H100 the product is bounded by operations (2·M·K·2F at 989 TFLOP/s
in bf16) and the bytes of x, the weights and the output. The im2col adds a
write and a read of M·K elements on top: traffic of this route, not of
the function, so it is reported beside the bound and not inside it. The
kernel's tiles, variants and packing are described in the source note of
``csrc/gated_conv.cu``.

On a CPU tensor the wrapper takes the plain version
(:func:`gan_inpainting_torch.ops.gated_conv.gated_conv_plain`: conv2d +
``gated_epilogue``). The gradient, as in the JAX package, recomputes
through that plain composition: no backward kernel. An input whose channel
count is no multiple of the kernel's 16-byte gather vector (the 4-channel
stem in bf16) is padded with zero channels first, and the packed weights
with zero rows.
``gated_matmul_mirror`` repeats the kernel's index algebra (im2col order
against packed-weight order) in PyTorch for the CPU tests.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import count_launch, use_kernel
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


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def plan(cin: int, features: int,
         dtype: torch.dtype) -> tuple[int, int, int, int]:
    """(Cin_pad, KC, BN, FP) for a gated conv of ``cin`` channels: Cin
    padded to the kernel's 16-byte gather vector, the depth of one K chunk,
    the feature columns per block (32 where that pads F less, else 64) and
    F padded to them."""
    kc, vec = (64, 8) if dtype == torch.bfloat16 else (32, 4)
    block_n = 32 if _rup(features, 32) < _rup(features, 64) else 64
    return _rup(cin, vec), kc, block_n, _rup(features, block_n)


def pad_channels(x: torch.Tensor, cin_pad: int) -> torch.Tensor:
    """Zero channels up to ``cin_pad`` on the last axis (the 4-channel stem
    input; a no-op at every other width of the generators)."""
    return x if x.shape[-1] == cin_pad else F.pad(
        x, (0, cin_pad - x.shape[-1]))


def pack_weights(weight: torch.Tensor, kc: int, fp: int,
                 cin_pad: int | None = None) -> torch.Tensor:
    """(2F, Cin, k, k), features first → (K_pad, 2, FP) in (tap, channel)
    row order over ``cin_pad`` channels (zero rows for the padded ones),
    zero rows up to a whole number of ``kc`` chunks and zero columns from F
    to FP."""
    f2, cin, kh, kw = weight.shape
    f = f2 // 2
    cin_pad = cin if cin_pad is None else cin_pad
    k_dim = kh * kw * cin_pad
    w = weight.reshape(2, f, cin, kh, kw).permute(3, 4, 2, 0, 1)
    w = F.pad(w, (0, fp - f, 0, 0, 0, cin_pad - cin)).reshape(k_dim, 2, fp)
    return F.pad(w, (0, 0, 0, 0, 0, _rup(k_dim, kc) - k_dim)).contiguous()


def _im2col(x: torch.Tensor, window: int, stride: int, dilation: int):
    """(B, H, W, C) → (B, Ho, Wo, window²·C) with TF-SAME padding, taps
    outermost and channels innermost on the last axis."""
    _, h, w, _ = x.shape
    eff = (window - 1) * dilation + 1
    ph, pw = same_pads(h, eff, stride), same_pads(w, eff, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    b, _, _, c = xp.shape
    sb, sh, sw, sc = xp.stride()
    # one strided view over the padded map, (B, Ho, Wo, k, k, C), made
    # contiguous by the reshape: a single copy instead of k² slices and a
    # concatenation
    taps = xp.as_strided(
        (b, ho, wo, window, window, c),
        (sb, sh * stride, sw * stride, sh * dilation, sw * dilation, sc))
    return taps.reshape(b, ho, wo, window * window * c), (ho, wo)


def gated_matmul_mirror(x2d: torch.Tensor, wp: torch.Tensor,
                        bias: torch.Tensor, features: int,
                        activation: str) -> torch.Tensor:
    """What the kernel computes from its own operands, in float32: rows of
    the im2col times the packed halves, bias, gate."""
    k_dim = x2d.shape[1]
    pre = torch.cat([x2d.float() @ wp[:k_dim, h, :features].float()
                     for h in (0, 1)], -1) + bias.float()
    return gated_epilogue(pre, activation)


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
    if x.dtype not in _DTYPES:
        raise TypeError(f"gated conv kernels take {_DTYPES}, got {x.dtype}")
    if weight.dtype != x.dtype:
        raise TypeError(f"weight {weight.dtype} must match x {x.dtype}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must be on one device")


def launch_matmul(x2d: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                  features: int, block_n: int,
                  activation: str) -> torch.Tensor:
    """Launch ``gi_gated_matmul`` on contiguous (M, K) rows, K a multiple
    of the gather vector, with weights packed by :func:`pack_weights`."""
    m, k_dim = x2d.shape
    out = torch.empty((m, features), dtype=x2d.dtype, device=x2d.device)
    lib = build.library(SOURCE)
    fn = lib.gi_gated_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), m, k_dim, features, wp.shape[2], block_n,
                 ACTIVATIONS[activation], int(x2d.dtype == torch.bfloat16),
                 stream)
    count_launch(KERNEL)
    build.check(lib, err, KERNEL)
    return out


class _GatedConv(torch.autograd.Function):
    """A forward kernel with the plain composition's gradient, recomputed
    from the saved (x, weight, bias), as the JAX kernels' custom VJP."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, dilation, activation, fwd):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (stride, dilation, activation)
        return fwd(x, weight, bias, stride, dilation, activation)

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


def _forward_matmul(x, weight, bias, stride, dilation, activation):
    b = x.shape[0]
    f = weight.shape[0] // 2
    cin_pad, kc, bn, fp = plan(x.shape[3], f, x.dtype)
    cols, (ho, wo) = _im2col(pad_channels(x, cin_pad), weight.shape[2],
                             stride, dilation)
    x2d = cols.reshape(b * ho * wo, cols.shape[-1])
    out = launch_matmul(x2d, pack_weights(weight, kc, fp, cin_pad),
                        bias.float().contiguous(), f, bn, activation)
    return out.reshape(b, ho, wo, f)


def gated_conv_matmul(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, *, stride: int = 1,
                      dilation: int = 1,
                      activation: str = "elu") -> torch.Tensor:
    """x: (B, H, W, Cin), weight: (2F, Cin, k, k) in x's dtype, bias: (2F,)
    → (B, Ho, Wo, F), TF-SAME. Kernel on a CUDA tensor, plain on the CPU."""
    _check(x, weight, bias, activation)
    if not use_kernel(x):
        return gated_conv_plain(x, weight, bias, stride=stride,
                                dilation=dilation, activation=activation)
    _check_cuda(x, weight, bias)
    return _GatedConv.apply(x.contiguous(), weight, bias, stride, dilation,
                            activation, _forward_matmul)
