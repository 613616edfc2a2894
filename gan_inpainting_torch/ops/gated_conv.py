"""Gated convolution (DeepFill-v2): ``act(conv_f(x)) * sigmoid(conv_g(x))``
with conv_f/conv_g as one conv of 2F output channels, split down the middle.

Backends (``model.kernel_backend``, resolved by ops/dispatch.py):

* ``xla``    — :func:`gated_conv_plain`: one conv (cuDNN on the card, with
  the bias fused) and the eager elementwise epilogue. The reference
  semantics, and what the kernels are held against.
* ``pallas`` — a hand-written CUDA kernel with the bias, activation and
  gate fused into its epilogue: the implicit-GEMM kernel
  (ops/kernels/direct_conv.py) for stride 1 and an odd window, else the
  gated matmul over an im2col (ops/kernels/gated_matmul.py). On a CUDA
  tensor this route launches a kernel or raises; on a CPU tensor the
  wrappers take the plain version.
* ``auto``   — what ``AUTO_CUDA["gated_conv"]`` says.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.conv import conv2d
from gan_inpainting_torch.ops.dispatch import resolve_backend


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    # F.elu goes through expm1, as jax.nn.elu does
    return {
        "elu": F.elu,
        "relu": F.relu,
        "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
        "none": lambda x: x,
        "tanh": torch.tanh,
    }[name]


def gated_epilogue(y: torch.Tensor, activation: str = "elu") -> torch.Tensor:
    """(…, 2F) pre-activation → (…, F) gated output."""
    features, gate = torch.chunk(y, 2, dim=-1)
    return _activation(activation)(features) * torch.sigmoid(gate)


def gated_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, stride: int = 1,
                     dilation: int = 1,
                     activation: str = "elu") -> torch.Tensor:
    """The library composition: conv2d with bias, then the epilogue."""
    y = conv2d(x, weight, bias, stride=stride, dilation=dilation)
    return gated_epilogue(y, activation)


def gated_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               stride: int = 1, dilation: int = 1, activation: str = "elu",
               backend: str = "auto") -> torch.Tensor:
    """x: (B, H, W, Cin), weight: (2F, Cin, k, k) → (B, Ho, Wo, F)."""
    if resolve_backend(backend, op="gated_conv") == "pallas":
        # prefer the implicit-GEMM kernel (no k² expansion in device
        # memory); strided and even-window forms go to the im2col kernel
        from gan_inpainting_torch.ops.kernels.direct_conv import (
            direct_conv_supported,
            gated_conv_direct,
        )
        if direct_conv_supported(x.shape, weight.shape[2], stride, dilation,
                                 weight.shape[0] // 2):
            return gated_conv_direct(x, weight, bias, dilation=dilation,
                                     activation=activation)
        from gan_inpainting_torch.ops.kernels.gated_matmul import (
            gated_conv_matmul,
        )
        return gated_conv_matmul(x, weight, bias, stride=stride,
                                 dilation=dilation, activation=activation)
    return gated_conv_plain(x, weight, bias, stride=stride,
                            dilation=dilation, activation=activation)
