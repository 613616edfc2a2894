"""L1 reconstruction losses: hole/valid-weighted L1, the spatially
discounted weighting of DeepFill v1, and total variation over the hole.

Both divide by a sum over the batch (of weights, of hole pixels). Under
data parallelism that sum is the mean of the ranks' sums, so the mean of
the ranks' losses is the loss of the global batch, as in the JAX step
that GSPMD shards; in one process it is the batch's own sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gan_inpainting_torch.parallel.sharding import mean_over_ranks


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
            discount_gamma: float = 0.0) -> torch.Tensor:
    """Weighted mean absolute error. output/target (B, H, W, 3) in [-1, 1];
    mask (B, H, W, 1), 1 = hole; with ``discount_gamma`` > 0 the hole
    weights are multiplied by the spatial discount."""
    output, target, mask = output.float(), target.float(), mask.float()
    weights = hole_weight * mask + valid_weight * (1.0 - mask)
    if discount_gamma > 0.0:
        disc = spatial_discount_mask(mask, discount_gamma)
        weights = weights * torch.where(mask > 0, disc, 1.0)
    err = torch.abs(output - target)
    return torch.sum(weights * err) / (
        mean_over_ranks(torch.sum(weights)) * err.shape[-1] + 1e-8)


def tv_loss(comp: torch.Tensor, mask: torch.Tensor, *,
            dilation: int = 1) -> torch.Tensor:
    """Anisotropic total variation of the composited image over pixel pairs
    whose both ends lie in the hole region grown by ``dilation`` pixels,
    divided by that region's element count (Liu et al. ECCV'18, eq. 9)."""
    comp, region = comp.float(), mask.float()
    if dilation > 0:
        region = _max_pool_same(region, 2 * dilation + 1)
    pair_h = region[:, :, 1:, :] * region[:, :, :-1, :]
    pair_v = region[:, 1:, :, :] * region[:, :-1, :, :]
    diff_h = torch.abs(comp[:, :, 1:, :] - comp[:, :, :-1, :])
    diff_v = torch.abs(comp[:, 1:, :, :] - comp[:, :-1, :, :])
    num = torch.sum(pair_h * diff_h) + torch.sum(pair_v * diff_v)
    return num / (mean_over_ranks(torch.sum(region)) * comp.shape[-1]
                  + 1e-8)
