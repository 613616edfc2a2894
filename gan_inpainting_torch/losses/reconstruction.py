"""L1 reconstruction losses: hole/valid-weighted L1, the spatially
discounted weighting of DeepFill v1, and total variation over the hole.

Both divide by a sum over the batch (of weights, of hole pixels). Under
data parallelism that sum is the mean of the ranks' sums, so the mean of
the ranks' losses is the loss of the global batch, as in the JAX step
that GSPMD shards; in one process it is the batch's own sum.

Over the mesh's spatial axis (``bands``, a spatial group whose members
each hold one row band of the images, parallel/spatial.py) a member's
loss is its band's partial sum over the whole map's normalizer: the
normalizer's band sums are summed over the group first, then averaged
over the data axis. The spatial discount is computed from the whole mask,
which every member holds (``whole_mask``), and cut to the band: exact,
with no exchange. Total variation's vertical pairs that straddle a band's
lower edge take the first row of the band below (a halo of one row, with
its gradient), so each pair counts once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gan_inpainting_torch.parallel.sharding import mean_over_ranks
from gan_inpainting_torch.parallel.spatial import SpatialGroup, band, halo


def _max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k stride-1 window max of (B, H, W, 1), −inf padded."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, 1, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def spatial_discount_mask(mask: torch.Tensor, gamma: float = 0.9,
                          iters: int = 24) -> torch.Tensor:
    """Per-pixel discount weights (B, H, W, 1) float32: 1 on known pixels,
    gamma^d on hole pixels, d the Chebyshev distance to the nearest known
    pixel (rounds of 3×3 dilation of the known region), saturating at
    ``iters``."""
    reach = 1.0 - mask.float()
    dist = 1.0 - reach          # hole pixels start at distance 1
    for _ in range(iters):
        reach = _max_pool_same(reach, 3)
        dist = dist + (1.0 - reach)     # +1 for every round not yet reached
    return torch.pow(torch.as_tensor(gamma, dtype=torch.float32,
                                     device=mask.device), dist)


def l1_loss(output: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
            *, hole_weight: float = 6.0, valid_weight: float = 1.0,
            discount_gamma: float = 0.0, bands: SpatialGroup | None = None,
            whole_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted mean absolute error. output/target (B, H, W, 3) in [-1, 1];
    mask (B, H, W, 1), 1 = hole; with ``discount_gamma`` > 0 the hole
    weights are multiplied by the spatial discount. With ``bands`` the
    three are this member's row band and ``whole_mask`` the whole mask
    (module docstring)."""
    output, target, mask = output.float(), target.float(), mask.float()
    weights = hole_weight * mask + valid_weight * (1.0 - mask)
    if discount_gamma > 0.0:
        whole = mask if bands is None else whole_mask.float()
        disc = band(spatial_discount_mask(whole, discount_gamma), bands)
        weights = weights * torch.where(mask > 0, disc, 1.0)
    err = torch.abs(output - target)
    return torch.sum(weights * err) / (
        mean_over_ranks(torch.sum(weights), bands) * err.shape[-1] + 1e-8)


def tv_loss(comp: torch.Tensor, mask: torch.Tensor, *,
            dilation: int = 1, bands: SpatialGroup | None = None,
            whole_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Anisotropic total variation of the composited image over pixel pairs
    whose both ends lie in the hole region grown by ``dilation`` pixels,
    divided by that region's element count (Liu et al. ECCV'18, eq. 9).
    With ``bands``, ``comp`` and ``mask`` are this member's row band and
    ``whole_mask`` the whole mask (module docstring)."""
    comp, region = comp.float(), mask.float()
    below = comp         # comp, with bands and the next band's first row
    if bands is not None:
        region = whole_mask.float()
    if dilation > 0:
        region = _max_pool_same(region, 2 * dilation + 1)
    if bands is not None:
        # the band's region and the next band's first row (zeros below the
        # map); the comp rows they pair with come through a halo
        h, i = comp.shape[1], bands.index
        region = F.pad(region, (0, 0, 0, 0, 0, 1))[:, i * h:(i + 1) * h + 1]
        below = halo(comp, bands, 0, 1)
    pair_v = region[:, 1:, :, :] * region[:, :-1, :, :]
    diff_v = torch.abs(below[:, 1:, :, :] - below[:, :-1, :, :])
    if bands is not None:
        region = region[:, :-1]
    pair_h = region[:, :, 1:, :] * region[:, :, :-1, :]
    diff_h = torch.abs(comp[:, :, 1:, :] - comp[:, :, :-1, :])
    num = torch.sum(pair_h * diff_h) + torch.sum(pair_v * diff_v)
    return num / (mean_over_ranks(torch.sum(region), bands) * comp.shape[-1]
                  + 1e-8)
