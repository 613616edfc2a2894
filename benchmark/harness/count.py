"""The benchmark's own counts of operations and bytes, and the table of
peaks they are held against.

Model FLOPs are counted on the reference (``FlopCounterMode`` over the
plain model on the ``meta`` device, so no memory and no time on the
card), as published: nearest upsampling then a 3x3 conv in the decoder,
and contextual attention over the (query, valid key) pairs the masks
give. The attention's products are taken out of the traced count and
added from the formula, so the count never depends on how the program
computes either.

Kernel bounds (the least time the chip could take) are the larger of
operations over the peak rate and bytes over the memory bandwidth, each
input byte read once and each output byte written once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import deepfill
from benchmark.reference import train as ref_train

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

RATE, KSIZE = 2, 3
K_TAPS = KSIZE * KSIZE          # units of C in a key / query
V_TAPS = 4 * RATE * RATE        # units of C in a value patch


def valid_keys(masks: torch.Tensor) -> torch.Tensor:
    """(B,) valid keys of each image's attention, from its (B, H, W, 1)
    hole mask: the generator attends on the 1/4 map at stride ``RATE``."""
    hole = deepfill.downscale_mask_max(masks.float(), 4)
    return deepfill.key_validity(deepfill.downscale_mask_max(hole, RATE),
                                 KSIZE).sum(1)


def attention_cells(size: int) -> int:
    """Query (and key) cells of one image's attention at image ``size``."""
    return (size // 4 // RATE) ** 2


def attention_fwd_flops(size: int, channels: int, n_valid) -> float:
    """Scores and weighted values over the valid pairs: 2 operations per
    multiply-add, K_TAPS + V_TAPS units of C per pair. ``n_valid`` is the
    valid key count of one image or the sum over several."""
    return 2.0 * attention_cells(size) * float(n_valid) \
        * (K_TAPS + V_TAPS) * channels


def attention_fwd_bytes(size: int, channels: int, batch: int) -> float:
    """The bf16 feature map and the float32 hole map read, the bf16 value
    taps written."""
    h = size // 4
    cells = attention_cells(size)
    return batch * (h * h * channels * 2 + h * h * 4
                    + V_TAPS * cells * channels * 2)


def attention_bwd_bound_s(size: int, channels: int, batch: int,
                          n_valid) -> float:
    """The attention backward's bound (rows 4, 5 and 5b of the kernel
    table): scores, dP and dQ products (K_TAPS + V_TAPS + K_TAPS units of
    C per pair) and the dK, dV products (K_TAPS + V_TAPS units) by
    operations; the fold of the tap gradients by bytes (34 float32 tap
    buffers read, the bf16 parity map, two float32 vectors per cell and
    the bf16 feature map, the bf16 gradient written)."""
    cells = attention_cells(size)
    pairs = 2.0 * cells * float(n_valid)
    t_ops = pairs * channels * ((K_TAPS + V_TAPS + K_TAPS)
                                + (K_TAPS + V_TAPS)) / PEAK_BF16_FLOPS
    h = size // 4
    fold_bytes = batch * ((2 * K_TAPS + V_TAPS) * cells * channels * 4
                          + cells * channels * 2 + 2 * cells * 4
                          + h * h * channels * 2)
    return t_ops + fold_bytes / PEAK_BYTES_PER_S


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_BF16_FLOPS)


def _no_attention(x, hole, rate=RATE, q=None):
    return x


def _meta_params(shapes: dict) -> dict:
    return {k: torch.empty(s, device="meta", requires_grad=True)
            for k, (s, _) in shapes.items()}


def generator_conv_flops(f: int, size: int) -> float:
    """FLOPs of one image's generator forward at ``size``, without the
    attention's products."""
    params = _meta_params(deepfill.generator_shapes(f))
    x = torch.empty((1, size, size, 3), device="meta")
    m = torch.empty((1, size, size, 1), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        deepfill.generator(params, x, m, f, attention=_no_attention)
    return float(fc.get_total_flops())


def train_step_flops(h: ref_train.Hyper, batch: int, size: int,
                     r1: bool) -> float:
    """FLOPs of one training step of ``batch`` images (with or without
    the R1 pass), without the attention's products: the attention runs
    twice forward (the fake, then G's loss) and once backward per step."""
    g = _meta_params(deepfill.generator_shapes(h.base_features))
    d = _meta_params(deepfill.discriminator_shapes(h.disc_features,
                                                   h.disc_layers))
    s = ref_train.State(g, d, h)
    s.step = 0 if r1 else 1
    image = torch.empty((batch, size, size, 3), device="meta")
    mask = torch.empty((batch, size, size, 1), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_train.train_step(s, image, mask, attention=_no_attention)
    return float(fc.get_total_flops())
