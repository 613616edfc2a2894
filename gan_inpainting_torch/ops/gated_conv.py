"""Gated convolution (DeepFill-v2): ``act(conv_f(x)) * sigmoid(conv_g(x))``
with conv_f/conv_g as one conv of 2F output channels, split down the middle.

The JAX package sends this op to XLA's conv on every backend; the port
sends it to cuDNN (or the CPU conv) with the bias fused into the conv.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.conv import conv2d


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


def gated_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               stride: int = 1, dilation: int = 1,
               activation: str = "elu") -> torch.Tensor:
    """x: (B, H, W, Cin), weight: (2F, Cin, k, k) → (B, Ho, Wo, F)."""
    y = conv2d(x, weight, bias, stride=stride, dilation=dilation)
    return gated_epilogue(y, activation)
