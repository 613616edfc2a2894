"""PSNR / SSIM. SSIM per Wang et al. 2004 with the standard 11×11 Gaussian
window (σ 1.5), K1 = 0.01, K2 = 0.03. Inputs are in [-1, 1], so ``max_val``
defaults to 2.

Everything runs in float32, and the SSIM filters with TF32 off: the
variance uses the cancellation form E[x²] − μ², whose terms are of order 1
while c2 = 0.0036, so a reduced-precision filter puts rounding noise of
c2's size into flat windows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 2.0):
    """Per-image PSNR in dB. a, b: (..., H, W, C) → (...,)."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(mse, min=1e-12))


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2(x: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Depthwise valid-mode 2-D filter of (B, H, W, C), full float32."""
    c = x.shape[-1]
    kernel = torch.from_numpy(window).to(x.device)[None, None].repeat(
        c, 1, 1, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=c)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 2.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM per image. a, b: (B, H, W, C) → (B,)."""
    a, b = a.float(), b.float()
    window = _gaussian_kernel(filter_size, filter_sigma)
    mu_a, mu_b = _filter2(a, window), _filter2(b, window)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = _filter2(a * a, window) - mu_aa
    sigma_bb = _filter2(b * b, window) - mu_bb
    sigma_ab = _filter2(a * b, window) - mu_ab
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    luminance = (2.0 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    contrast = (2.0 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    return torch.mean(luminance * contrast, dim=(-3, -2, -1))
