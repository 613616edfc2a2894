"""Space-to-depth stem convolution: an exact 5×5 stride-1 conv evaluated in
the cell domain.

The generators' stem convs run 5×5 stride-1 over a 4- or 5-channel input at
full resolution, a contraction too thin for matrix units. Exact rewrite:
space-to-depth the input by 2 (4C channels at half resolution) and
decompose the OUTPUT by pixel parity — each parity (p, q) of a 5×5 stride-1
SAME conv is a 3×3 conv over the cell grid whose taps re-read the original
parameter:

    y[2i+p, 2j+q] = Σ_{dy,dx} W[dy,dx]·x[2i+p+dy-2, 2j+q+dx-2]
    with u = p+dy-2 = 2(a-1)+r  →  cell tap a ∈ {0,1,2}, sub-pixel r,
    i.e. Wc[a,b,(r,s,·),(p,q,·)] = W[2a+r-p, 2b+s-q]  (zero when out of
    [0,5)).

One conv (3×3, 4C→4·Cout at half resolution) replaces the full-resolution
conv at 1.44× the MACs. Same parameters, same math (a pointwise epilogue
commutes with the parity interleave): a compute-path rewrite behind
``model.s2d_stem``, not a model change. Whether it pays on an H100 has not
been measured.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.conv import conv2d


def cell_kernel(weight: torch.Tensor) -> torch.Tensor:
    """(F, C, 5, 5) → (4F, 4C, 3, 3) cell-domain kernel; out channels
    ordered ((p, q), f), in channels ((r, s), c), matching the
    space-to-depth flatten order."""
    f, c = weight.shape[:2]
    k7 = F.pad(weight, (1, 1, 1, 1))                    # index + 1

    def tap(a, b, p, q):                                # (F, (r, s, C))
        return torch.stack([
            torch.stack([k7[:, :, 2 * a + r - p + 1, 2 * b + s - q + 1]
                         for s in (0, 1)], 1)
            for r in (0, 1)], 1).reshape(f, 4 * c)

    groups = [torch.stack([torch.stack([tap(a, b, p, q) for b in range(3)],
                                       -1) for a in range(3)], -2)
              for p in (0, 1) for q in (0, 1)]          # each (F, 4C, 3, 3)
    return torch.cat(groups, 0)


def s2d_conv5x5_epilogue(
        x: torch.Tensor, weight: torch.Tensor,
        epilogue: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Exact 5×5 stride-1 SAME conv via the cell-domain decomposition.

    ``epilogue`` is any pointwise map over the conv-output channel dim
    (bias + activation, or the gated split); it runs on the half-resolution
    layout (…, 4, F2) → (…, 4, Fout).

    x: (B, H, W, C) with even H, W; weight: (F2, C, 5, 5). Returns
    (B, H, W, Fout).
    """
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d conv needs even spatial dims, got {(h, w)}")
    if tuple(weight.shape[2:]) != (5, 5):
        raise ValueError(f"s2d stem expects a 5x5 kernel, got "
                         f"{tuple(weight.shape[2:])}")
    f2 = weight.shape[0]
    xs = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(b, h // 2, w // 2, 4 * c)
    wc = cell_kernel(weight).to(x.dtype)
    ys = conv2d(xs, wc)                                 # (B, h2, w2, 4·F2)
    ys = epilogue(ys.reshape(b, h // 2, w // 2, 4, f2))
    fo = ys.shape[-1]
    ys = ys.reshape(b, h // 2, w // 2, 2, 2, fo)
    return ys.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, fo)
