"""Partial convolution (Liu et al., ECCV'18), NHWC.

Mask-aware conv: features are convolved over *valid* pixels only and
re-normalized by the live fraction of the window; the validity mask dilates
by one receptive field per layer.

    y = conv(x * valid) * (k*k / sum_window(valid)) + b   where sum > 0
    y = 0                                                 where sum == 0
    valid' = sum_window(valid) > 0

``valid`` is a VALIDITY mask (1 = known), i.e. ``1 - hole`` in the
package's hole convention.

Backends (``model.kernel_backend``, resolved by ops/dispatch.py): the
feature conv is cuDNN's under both; the window count is a one-channel conv
of ones. ``xla`` runs the epilogue as eager elementwise passes
(:func:`partial_conv_epilogue_plain`), ``pallas`` as one hand-written CUDA
kernel (ops/kernels/partial_epilogue.py), which on a CUDA tensor launches
or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.conv import conv2d
from gan_inpainting_torch.ops.dispatch import resolve_backend
from gan_inpainting_torch.ops.kernels.partial_epilogue import (
    partial_conv_epilogue,
    partial_conv_epilogue_plain,
)
from gan_inpainting_torch.ops.patches import same_pads

def _window_counts(valid: torch.Tensor, window: int, stride: int,
                   dilation: int) -> torch.Tensor:
    """Per-output-pixel count of valid input pixels under the (dilated)
    window, TF-SAME padded with zeros: (B, H, W, 1) → (B, Ho, Wo, 1)
    float32. Sums of at most window² ones, so exact."""
    h, w = valid.shape[1], valid.shape[2]
    eff = (window - 1) * dilation + 1
    ph, pw = same_pads(h, eff, stride), same_pads(w, eff, stride)
    v = F.pad(valid.float().permute(0, 3, 1, 2),
              (pw[0], pw[1], ph[0], ph[1]))
    ones = torch.ones((1, 1, window, window), dtype=torch.float32,
                      device=valid.device)
    return F.conv2d(v, ones, stride=stride,
                    dilation=dilation).permute(0, 2, 3, 1)


def partial_conv(x: torch.Tensor, valid: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, *, stride: int = 1, dilation: int = 1,
                 backend: str = "auto"):
    """x: (B, H, W, Cin) features, valid: (B, H, W, 1), weight: (Cout, Cin,
    k, k), bias: (Cout,) → (y, valid_out): (B, Ho, Wo, Cout) and the
    dilated validity mask (B, Ho, Wo, 1), both in x's dtype."""
    backend = resolve_backend(backend, op="partial_conv")
    k = weight.shape[2]
    counts = _window_counts(valid, k, stride, dilation)
    raw = conv2d(x * valid.to(x.dtype), weight, stride=stride,
                 dilation=dilation)
    if backend == "pallas":
        return partial_conv_epilogue(raw, counts, bias, k)
    return partial_conv_epilogue_plain(raw, counts, bias, k)
