"""Image normalization at the serving boundary (uint8 ↔ [-1, 1] float32)."""

from __future__ import annotations

import torch


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → float32 [-1,1]."""
    return images_u8.to(torch.float32) / 127.5 - 1.0


def denormalize(images: torch.Tensor) -> torch.Tensor:
    """float32 [-1,1] → uint8 [0,255]. Rounds half to even, as
    ``jnp.round`` does (``torch.round`` has the same rule)."""
    x = torch.clamp((images + 1.0) * 127.5, 0.0, 255.0)
    return torch.round(x).to(torch.uint8)
