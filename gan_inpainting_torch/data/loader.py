"""Dataset iterators. Only the ``synthetic`` backend is ported: uint8
batches rendered on the device from a seed. The ``folder`` backend (image
files, the native JPEG loader) waits for a later slice (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Iterator

import torch

from gan_inpainting_torch.configs.base import DataConfig
from gan_inpainting_torch.data.synthetic import synthetic_batch_u8
from gan_inpainting_torch.utils.rng import STREAM_DATA, stream_generator


def source_size(cfg: DataConfig, split: str = "train") -> int:
    """Side of the images a split is supplied at: with ``random_crop`` the
    train split gets 9/8 of the train size and the batch maker crops."""
    if split == "train" and cfg.random_crop:
        return cfg.image_size * 9 // 8
    return cfg.image_size


def make_dataset(cfg: DataConfig, seed: int, split: str = "train",
                 batch_size: int | None = None, device="cpu",
                 start: int = 0) -> Iterator[torch.Tensor]:
    """Endless iterator of (B, S, S, 3) uint8 batches on ``device``.
    ``synthetic_size`` is the virtual dataset length: after that many
    images the stream wraps, as epochs over a finite folder would. The
    eval split draws from a disjoint stream. ``start`` skips batches (a
    resumed run continues where it stopped)."""
    if cfg.dataset != "synthetic":
        raise NotImplementedError(
            f"data.dataset={cfg.dataset!r}: only 'synthetic' is ported "
            "(ROADMAP Queue 1: data/loader.py, data/native_loader.py)")
    batch_size = batch_size or (cfg.batch_size if split == "train"
                                else cfg.eval_batch_size)
    size = source_size(cfg, split)
    per_epoch = max(cfg.synthetic_size // batch_size, 1)
    split_id = 0 if split == "train" else 1

    def it():
        step = start
        while True:
            gen = stream_generator(seed, STREAM_DATA, step % per_epoch,
                                   split_id)
            yield synthetic_batch_u8(gen, batch_size, size,
                                     cfg.synthetic_family, device)
            step += 1

    return it()
