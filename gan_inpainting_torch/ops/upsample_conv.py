"""Fused nearest-2x-upsample + SAME 3x3 conv at low-resolution FLOPs.

After a nearest 2x upsample, output parity (p, q) of a 3x3 conv reads only
two distinct low-res cells per axis, with the taps summed by linearity:

    rows touched  p=0: {i-1: W0,       i: W1+W2}
                  p=1: {i:   W0+W1, i+1: W2}      (same along columns)

so the block is one low-res VALID 2x2 conv over x padded by one cell,
emitting the four parity kernels as channel groups, then a depth-to-space
interleave: the same parameter and math as ``conv2d(_upsample2x(x), w)``
at 4/9 of the MACs. Group ``g = 2p + q``'s map is the conv output shifted
by (p, q) cells.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def parity_kernels(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) → (4·Cout, Cin, 2, 2) effective parity kernels.

    Group g = 2p + q holds the 2x2 kernel producing output parity (p, q).
    Built in the weight's own dtype (pass the float32 param and cast the
    result, so the tap sums round once).
    """
    if tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"parity_kernels needs a 3x3 kernel, got "
                         f"{tuple(weight.shape[2:])}")
    w0, w1, w2 = weight[:, :, 0], weight[:, :, 1], weight[:, :, 2]  # (O,I,3)
    rows = (torch.stack([w0, w1 + w2], 2),              # p = 0: rows (i-1, i)
            torch.stack([w0 + w1, w2], 2))              # p = 1: rows (i, i+1)
    groups = []
    for p in (0, 1):
        r = rows[p]                                     # (O, I, 2, 3)
        c0, c1, c2 = r[..., 0], r[..., 1], r[..., 2]
        groups.append(torch.stack([c0, c1 + c2], -1))   # q = 0
        groups.append(torch.stack([c0 + c1, c2], -1))   # q = 1
    return torch.cat(groups, 0)                         # (4·O, I, 2, 2)


def upsample2x_conv2d_epilogue(
        x: torch.Tensor, weight: torch.Tensor,
        epilogue: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """nearest-2x upsample of ``x`` (B, H, W, Cin), SAME 3x3 conv with
    ``weight`` (Cout, Cin, 3, 3), then ``epilogue`` (any elementwise map on
    the last dim, e.g. bias + gated activation). The epilogue runs on each
    low-res parity map before the interleave — pointwise maps commute with
    depth-to-space. Returns (B, 2H, 2W, C')."""
    b, h, w, _ = x.shape
    cout = weight.shape[0]
    k4 = parity_kernels(weight).to(x.dtype)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    full = F.conv2d(xp.permute(0, 3, 1, 2), k4).permute(0, 2, 3, 1)
    maps = [epilogue(full[:, p:p + h, q:q + w,
                          (2 * p + q) * cout:(2 * p + q + 1) * cout])
            for p in (0, 1) for q in (0, 1)]
    cfin = maps[0].shape[-1]
    y = torch.stack(maps, dim=3).reshape(b, h, w, 2, 2, cfin)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cfin)

