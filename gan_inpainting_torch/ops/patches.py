"""Patch extraction / overlap-add folding on NHWC tensors.

Same layout as the JAX package: element ``[b, i, j, p, q, c]`` of the
patches is ``x_padded[b, i*stride + p, j*stride + q, c]``. Both directions
are written as ``window²`` strided slices, which is what the plain
(reference) attention path needs; the CUDA path never builds patches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """TF-style SAME padding (lo, hi) for one spatial dim: the odd pixel
    goes on the high side."""
    out = -(-size // stride)  # ceil
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def extract_patches(x: torch.Tensor, window: int,
                    stride: int) -> torch.Tensor:
    """(B, H, W, C) → (B, Ho, Wo, k, k, C) square patches, SAME padded."""
    b, h, w, c = x.shape
    ph, pw = same_pads(h, window, stride), same_pads(w, window, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    ho = (xp.shape[1] - window) // stride + 1
    wo = (xp.shape[2] - window) // stride + 1
    parts = [xp[:, p:p + (ho - 1) * stride + 1:stride,
                q:q + (wo - 1) * stride + 1:stride, :]
             for p in range(window) for q in range(window)]
    return torch.stack(parts, dim=3).reshape(b, ho, wo, window, window, c)


def fold_patches(patches: torch.Tensor, stride: int,
                 out_hw: tuple[int, int]):
    """Overlap-add, the transpose of :func:`extract_patches`.

    Returns the (B, H, W, C) sum and the (H, W, 1) overlap counts.
    """
    b, ho, wo, k, k2, c = patches.shape
    if k != k2:
        raise ValueError(f"patches must be square, got {k}x{k2}")
    h, w = out_hw
    ph, pw = same_pads(h, k, stride), same_pads(w, k, stride)
    hp, wp = h + ph[0] + ph[1], w + pw[0] + pw[1]
    out = patches.new_zeros((b, hp, wp, c))
    cnt = patches.new_zeros((hp, wp, 1))
    for p in range(k):
        for q in range(k):
            rs = slice(p, p + (ho - 1) * stride + 1, stride)
            cs = slice(q, q + (wo - 1) * stride + 1, stride)
            out[:, rs, cs, :] += patches[:, :, :, p, q, :]
            cnt[rs, cs, :] += 1
    out = out[:, ph[0]:ph[0] + h, pw[0]:pw[0] + w, :]
    cnt = cnt[ph[0]:ph[0] + h, pw[0]:pw[0] + w, :]
    return out, cnt


def fold_band(patches: torch.Tensor, stride: int,
              width: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """Overlap-add of one row band's patches, rows uncropped: the band's
    share of :func:`fold_patches` on a map whose rows split into bands of
    ``stride``-aligned cells.

    ``patches`` (B, hb, W/stride, k, k, C) are the patches of cell rows
    ``[i0, i0 + hb)``; returns their (B, pad_lo + hb·stride + pad_hi,
    width, C) sum, whose row 0 is map row ``i0·stride − pad_lo``, and
    ``(pad_lo, pad_hi)``, the map's TF-SAME row pads: the rows the band
    spills above and below its own ``hb·stride`` rows. Columns are
    cropped as :func:`fold_patches` crops them. At k = 2·stride (the
    attention's value patches) the pads are (stride // 2, stride −
    stride // 2), one row each way at stride 2. Counts are the caller's:
    they are the whole map's, not the band's."""
    b, hb, wo, k, k2, c = patches.shape
    if k != k2:
        raise ValueError(f"patches must be square, got {k}x{k2}")
    pads = same_pads(hb * stride, k, stride)
    if pads[0] + pads[1] != k - stride:
        raise ValueError(f"fold_band needs a window of at least the stride "
                         f"({k} < {stride})")
    pw = same_pads(width, k, stride)
    out = patches.new_zeros((b, (hb - 1) * stride + k,
                             width + pw[0] + pw[1], c))
    for p in range(k):
        for q in range(k):
            rs = slice(p, p + (hb - 1) * stride + 1, stride)
            cs = slice(q, q + (wo - 1) * stride + 1, stride)
            out[:, rs, cs, :] += patches[:, :, :, p, q, :]
    return out[:, :, pw[0]:pw[0] + width, :], pads
