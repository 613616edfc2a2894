"""Preprocessing: image normalization (uint8 ↔ [-1, 1] float32) and the
train batch — crop, flip, mask synthesis and masking on the device, so the
host supplies only uint8 batches."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gan_inpainting_torch.configs.base import MaskConfig
from gan_inpainting_torch.data.masks import random_mask_batch


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → float32 [-1,1]."""
    return images_u8.to(torch.float32) / 127.5 - 1.0


def denormalize(images: torch.Tensor) -> torch.Tensor:
    """float32 [-1,1] → uint8 [0,255]. Rounds half to even, as
    ``jnp.round`` does (``torch.round`` has the same rule)."""
    x = torch.clamp((images + 1.0) * 127.5, 0.0, 255.0)
    return torch.round(x).to(torch.uint8)


class Batch(NamedTuple):
    """One training/eval batch, float32 NHWC on the device.

    image:  (B, H, W, 3) in [-1, 1], the ground truth
    mask:   (B, H, W, 1) in {0, 1}, 1 marks the hole
    masked: (B, H, W, 3), the image with the hole zeroed
    """

    image: torch.Tensor
    mask: torch.Tensor
    masked: torch.Tensor


def make_train_batch(images_u8: torch.Tensor, generator: torch.Generator,
                     mask_cfg: MaskConfig, progress: float = 1.0,
                     flip: bool = False, crop: int = 0) -> Batch:
    """uint8 images (B, H, W, 3) on their device → a :class:`Batch` there:
    a random ``crop``×``crop`` window per sample (``data.random_crop``; the
    loader supplies the 9/8 source), normalization, a per-sample horizontal
    ``flip``, fresh masks of the config's kind at the curriculum's
    ``progress``, and ``masked = image · (1 − mask)``. Every draw comes
    from ``generator`` (CPU), in this order: crop offsets, flips, masks."""
    b, h, w = images_u8.shape[:3]
    device = images_u8.device
    if crop and (h, w) != (crop, crop):
        if h < crop or w < crop:
            raise ValueError(
                f"random_crop target {crop} exceeds source {(h, w)}")
        oy = torch.randint(0, h - crop + 1, (b,), generator=generator)
        ox = torch.randint(0, w - crop + 1, (b,), generator=generator)
        images_u8 = torch.stack([
            img[y:y + crop, x:x + crop]
            for img, y, x in zip(images_u8, oy.tolist(), ox.tolist())])
        h = w = crop
    if flip:
        bits = torch.rand((b,), generator=generator) < 0.5
        images_u8 = torch.where(bits.to(device)[:, None, None, None],
                                images_u8.flip(2), images_u8)
    image = normalize(images_u8)
    mask = random_mask_batch(generator, b, h, w, mask_cfg, progress, device)
    return Batch(image=image, mask=mask, masked=image * (1.0 - mask))
