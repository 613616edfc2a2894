"""Implicit-GEMM gated conv: no im2col in device memory.

``gated_conv_direct`` replaces the Pallas kernel ``_kernel``
(gan_inpainting_tpu/ops/pallas/direct_conv.py:48, entry
``gated_conv_direct``): stride 1, odd window, any dilation — every gated
conv of the generators but the stride-2 encoder convs. On a CUDA tensor it
launches ``gi_gated_conv`` of ``csrc/gated_conv.cu``: k² tap products of
(pixels, Cin) × (Cin, F) for the feature half and the gate half into
float32 accumulators, then ``act(f + b_f) · sigmoid(g + b_g)``, so neither
the patches nor the 2F-channel pre-activation reach device memory.

On an H100 it is bounded by operations (2·M·k²·Cin·2F at 989 TFLOP/s in
bf16; the activations are read and written once). The TPU kernel keeps a
row group and its dilation halo resident in fast memory; a block's shared
memory cannot hold that at dilation 16, so here, per tap and 32-channel
slab, TMA copies the shifted box of a block's 128 pixels with zeros
outside the map (the bf16 kernel: wgmma tiles, the weight slab multicast
over a cluster of blocks; a 16-byte gather where no box fits, as at the
8-channel stem and Cin = 48) — reuse across taps comes from L2. Tiles,
variants and the weight packing are in the source note of
``csrc/gated_conv.cu``; the plan, the packing, the packed-weight cache and
the launch are shared with ops/kernels/gated_matmul.py.

On a CPU tensor the wrapper takes the plain version (conv2d +
``gated_epilogue``); inside ``interpret_kernels`` the kernel's mirror
(``gated_matmul.forward_mirror``). The gradient recomputes through the
plain composition, as the JAX kernel's custom VJP does.
"""

from __future__ import annotations

import torch

from gan_inpainting_torch.ops.dispatch import interpreting, use_kernel
from gan_inpainting_torch.ops.gated_conv import gated_conv_plain
from gan_inpainting_torch.ops.kernels.gated_matmul import (
    GatedPlan,
    _check,
    _check_cuda,
    _GatedConv,
    conv_geom,
    forward_mirror,
    launch_gated,
    packed_weights,
    pad_channels,
    plan,
)

KERNEL = "gated_conv_direct"


def direct_conv_supported(x_shape, k: int, stride: int, dilation: int,
                          features: int = 1) -> bool:
    """True for the forms the implicit-GEMM kernel takes: stride 1, odd
    window, and index ranges that fit its 32-bit pixel arithmetic."""
    b, h, w, cin = x_shape
    return (stride == 1 and k % 2 == 1 and dilation >= 1
            and b * h * w < 2 ** 31 and k * k * cin < 2 ** 24
            and h + k * dilation < 2 ** 24 and w + k * dilation < 2 ** 24)


def launch_direct(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                  features: int, k: int, dilation: int, p: GatedPlan,
                  activation: str) -> torch.Tensor:
    """Launch the kernel on a contiguous (B, H, W, cin_pad) map with
    weights packed by ``pack_weights`` for plan ``p``."""
    g = conv_geom(x.shape[1], x.shape[2], k, 1, dilation)
    return launch_gated(x, wp, bias, features, g, p, activation, KERNEL)


def _forward_direct(x, weight, bias, dilation, activation):
    f = weight.shape[0] // 2
    p = plan(x.shape[3], f, x.dtype)
    return launch_direct(pad_channels(x, p.cin_pad),
                         packed_weights(weight, p, x.dtype), bias, f,
                         weight.shape[2], dilation, p, activation)


def gated_conv_direct(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, *, stride: int = 1,
                      dilation: int = 1,
                      activation: str = "elu") -> torch.Tensor:
    """x: (B, H, W, Cin), weight: (2F, Cin, k, k) in x's dtype (or float32
    master weights), bias: (2F,) → (B, H, W, F). Stride must be 1 and k
    odd: check :func:`direct_conv_supported` first. Kernel on a CUDA
    tensor, plain on the CPU."""
    _check(x, weight, bias, activation)
    if not direct_conv_supported(x.shape, weight.shape[2], stride, dilation,
                                 weight.shape[0] // 2):
        raise ValueError(
            f"gated_conv_direct takes stride 1 and an odd window, got "
            f"stride={stride} k={weight.shape[2]} x={tuple(x.shape)}")
    if not (interpreting() or use_kernel(x)):
        return gated_conv_plain(x, weight, bias, stride=1, dilation=dilation,
                                activation=activation)
    _check_cuda(x, weight, bias)
    x = x.contiguous()
    bias32 = bias.float().contiguous()
    if interpreting():
        def fwd():
            return forward_mirror(x, weight, bias32, 1, dilation, activation)
    else:
        def fwd():
            return _forward_direct(x, weight, bias32, dilation, activation)
    return _GatedConv.apply(x, weight, bias, 1, dilation, activation, fwd)
