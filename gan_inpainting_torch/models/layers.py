"""Conv building block of the generators: plain or gated conv, NHWC.

Parameters are float32 ``weight`` (Cout, Cin, k, k) and ``bias`` (Cout,),
cast to the compute dtype per call; a gated conv owns one conv of 2F
outputs. ``pre_upsample`` fuses a preceding nearest-2x upsample into the
conv (ops/upsample_conv.py): same parameter, same math.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gan_inpainting_torch.ops.conv import conv2d
from gan_inpainting_torch.ops.gated_conv import (
    _activation,
    gated_conv,
    gated_epilogue,
)
from gan_inpainting_torch.ops.upsample_conv import upsample2x_conv2d_epilogue

_NOT_PORTED = ("{} convs are not ported yet (ROADMAP Queue 1, Slice D: "
               "ops/partial_conv.py and ops/s2d_conv.py)")


class InpaintConv(nn.Module):
    """forward(x, valid) -> (y, valid_out). ``valid`` (1 = known pixel) is
    threaded through for partial convs; plain and gated convs pass it on,
    stride-resized."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, conv_kind: str = "plain",
                 activation: str = "elu",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pre_upsample: bool = False, s2d: bool = False):
        super().__init__()
        if conv_kind == "partial" or s2d:
            raise NotImplementedError(
                _NOT_PORTED.format("partial" if conv_kind == "partial"
                                   else "s2d"))
        if conv_kind not in ("plain", "gated"):
            raise ValueError(f"unknown conv_kind {conv_kind!r}")
        if pre_upsample and (kernel_size != 3 or stride != 1 or dilation != 1):
            raise ValueError("pre_upsample requires a plain/gated 3x3 "
                             "stride-1 undilated conv")
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.conv_kind = conv_kind
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.pre_upsample = pre_upsample
        cout = 2 * features if conv_kind == "gated" else features
        self.weight = nn.Parameter(
            torch.empty(cout, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Variance-scaling (fan-in, truncated normal) weights, zero bias:
        the JAX package's initializer, drawn from ``generator``."""
        fan_in = self.weight.shape[1] * self.kernel_size ** 2
        # std of a unit normal truncated to ±2
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.bias.zero_()

    def _epilogue(self, y: torch.Tensor) -> torch.Tensor:
        if self.conv_kind == "gated":
            return gated_epilogue(y, self.activation)
        return _activation(self.activation)(y)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None):
        x = x.to(self.compute_dtype)
        if self.pre_upsample:
            # parity kernels from the float32 param, cast once inside
            bias = self.bias.to(self.compute_dtype)
            y = upsample2x_conv2d_epilogue(
                x, self.weight, lambda m: self._epilogue(m + bias))
            return y, valid
        weight = self.weight.to(self.compute_dtype)
        if self.conv_kind == "gated":
            y = gated_conv(x, weight, self.bias, stride=self.stride,
                           dilation=self.dilation, activation=self.activation)
        else:
            y = self._epilogue(conv2d(x, weight, self.bias, stride=self.stride,
                                      dilation=self.dilation))
        return y, _resize_valid(valid, self.stride)


def _resize_valid(valid: torch.Tensor | None, stride: int):
    if valid is None or stride == 1:
        return valid
    return valid[:, ::stride, ::stride, :]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


class SNConv(nn.Module):
    """Discriminator conv, optionally spectrally normalized (Miyato et
    al.): one power-iteration step per call, in float32, on the kernel
    reshaped to (fan_in, Cout) in the JAX package's HWIO order, so the
    singular vector ``u`` (Cout,) carries over between the packages. ``u``
    is a buffer — training state that is checkpointed, not a parameter —
    and moves only when the call passes ``update_stats``. Gradients stop
    through ``u`` and ``v`` but not through σ = vᵀWu.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 5,
                 stride: int = 2, use_sn: bool = False,
                 activation: str = "leaky_relu",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.use_sn = use_sn
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        if use_sn:
            self.register_buffer("u", torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator | None = None):
        InpaintConv.reset_parameters(self, generator)
        if self.use_sn:
            with torch.no_grad():
                self.u.copy_(torch.randn(self.u.shape, generator=generator))

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        weight = self.weight
        if self.use_sn:
            # (Cout, Cin, kh, kw) → (kh·kw·Cin, Cout)
            w = weight.float().permute(2, 3, 1, 0).reshape(
                -1, weight.shape[0])
            with torch.no_grad():
                v = _l2_normalize(w @ self.u)
                u_new = _l2_normalize(w.t() @ v)
            sigma = torch.dot(v, w @ u_new)
            if update_stats:
                self.u = u_new
            weight = weight / sigma.to(weight.dtype)
        x = x.to(self.compute_dtype)
        y = conv2d(x, weight.to(self.compute_dtype), self.bias,
                   stride=self.stride)
        return _activation(self.activation)(y)
