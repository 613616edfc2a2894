"""NHWC convolution with TF-SAME padding.

Activations stay NHWC at every public function, as in the JAX package. The
conv itself runs on an NCHW view of the same memory (``permute`` is free),
which PyTorch treats as channels_last — the layout cuDNN prefers — so no
copy is made on the way in or out. Weights are OIHW.

``F.conv2d(padding="same")`` refuses stride > 1, and TF-SAME puts the odd
padding pixel on the high side, so the padding is explicit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.patches import same_pads


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, *, stride: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin), weight: (Cout, Cin, kh, kw) → (B, Ho, Wo, Cout),
    TF-SAME padded. Output dtype follows x."""
    kh, kw = weight.shape[2:]
    ph = same_pads(x.shape[1], (kh - 1) * dilation + 1, stride)
    pw = same_pads(x.shape[2], (kw - 1) * dilation + 1, stride)
    conv_pad: tuple[int, int] | int = 0
    if ph[0] == ph[1] and pw[0] == pw[1]:
        conv_pad = (ph[0], pw[0])          # symmetric: let the conv pad
    else:
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    if bias is not None:
        bias = bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias,
                 stride=stride, padding=conv_pad, dilation=dilation)
    return y.permute(0, 2, 3, 1)
