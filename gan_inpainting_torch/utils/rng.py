"""Random streams: one ``torch.Generator`` per (seed, stream, step).

Every consumer (parameter init, masks, data, eval) derives its generator
from the run's seed, a stable stream id and a step counter, so a resumed
run draws exactly what the uninterrupted one would have drawn, whatever
was drawn before. Generators live on the CPU: the draws are small
parameter sets, rasterized on the device afterwards.
"""

from __future__ import annotations

import hashlib

import torch

# Stable stream ids. Never renumber: resumed runs derive draws from them.
STREAM_PARAMS = 0
STREAM_MASKS = 1
STREAM_DATA = 2
STREAM_TRAIN = 3
STREAM_EVAL = 4


def stream_generator(seed: int, stream_id: int, step: int = 0,
                     extra: int = 0) -> torch.Generator:
    """The generator of one stream at one step, seeded by a hash of
    (seed, stream, step, extra) so that neighbouring steps do not give
    neighbouring seeds."""
    digest = hashlib.sha256(
        f"{seed}/{stream_id}/{step}/{extra}".encode()).digest()
    return torch.Generator().manual_seed(
        int.from_bytes(digest[:8], "little") & (2 ** 63 - 1))


def uniform(generator: torch.Generator, shape, low=0.0, high=1.0):
    """float32 uniform draws in [low, high) from ``generator`` (CPU)."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return low + (high - low) * u
