"""Overlap-add fold of the fused attention kernel's tap-major output.

``fold_taps`` replaces the Pallas kernel ``_fold_kernel``
(gan_inpainting_tpu/ops/pallas/fold.py:32). On a CUDA tensor it launches
the CUDA kernel in ``csrc/fold.cu`` (one thread per four channels of an
output pixel, float32 sum, times the reciprocal overlap counts). That
kernel reads every tap element once and writes every output element once,
so on an H100 it is bounded by bytes: (16 + 4)·Lq·C elements per image at
rate 2. On a CPU
tensor it takes :func:`fold_taps_plain`, the patch-major fold of
ops/patches.py divided by the counts. The JAX package sends cell grids
above 2048 cells to an XLA fold instead; the port uses the kernel at every
size.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gan_inpainting_torch.ops.dispatch import count_launch, use_kernel
from gan_inpainting_torch.ops.kernels import build
from gan_inpainting_torch.ops.patches import fold_patches

KERNEL = "fold_taps"
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=32)
def fold_counts_inv(hs: int, ws: int, rate: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(r·hs, r·ws) float32 reciprocal overlap counts (geometry only)."""
    ones = torch.ones((1, hs, ws, 2 * rate, 2 * rate, 1))
    _, cnt = fold_patches(ones, rate, (rate * hs, rate * ws))
    inv = 1.0 / torch.clamp(cnt[..., 0], min=1.0)
    return inv.to(device=device, dtype=torch.float32).contiguous()


def fold_taps_plain(taps: torch.Tensor, hs: int, ws: int,
                    rate: int) -> torch.Tensor:
    """(B, 4r², hs·ws, C) → (B, r·hs, r·ws, C) through the patch-major fold
    divided by the overlap counts."""
    b, _, _, c = taps.shape
    pm = taps.permute(0, 2, 1, 3).reshape(b, hs, ws, 2 * rate, 2 * rate, c)
    y, cnt = fold_patches(pm, rate, (rate * hs, rate * ws))
    return y / torch.clamp(cnt, min=1.0).to(y.dtype)


def _check(taps: torch.Tensor, hs: int, ws: int, rate: int) -> None:
    if taps.dim() != 4:
        raise ValueError(f"taps must be (B, 4r², Lq, C), got {tuple(taps.shape)}")
    b, n_taps, lq, c = taps.shape
    if n_taps != 4 * rate * rate or lq != hs * ws:
        raise ValueError(f"taps {tuple(taps.shape)} do not match hs={hs} "
                         f"ws={ws} rate={rate}")


def fold_taps(taps: torch.Tensor, hs: int, ws: int,
              rate: int) -> torch.Tensor:
    """Overlap-add (B, 4r², hs·ws, C) tap-major patches (window 2r, stride
    r, SAME) into (B, r·hs, r·ws, C), divided by the overlap counts."""
    _check(taps, hs, ws, rate)
    if not use_kernel(taps):
        return fold_taps_plain(taps, hs, ws, rate)
    if taps.dtype not in _DTYPES:
        raise TypeError(f"fold_taps kernel takes {_DTYPES}, got {taps.dtype}")
    if not taps.is_contiguous():
        raise ValueError("fold_taps kernel needs contiguous taps")
    b, _, _, c = taps.shape
    if c % 4 or b * rate * rate * hs * ws * c >= 2 ** 31:
        raise ValueError(f"fold_taps kernel needs C % 4 == 0 and under 2^31 "
                         f"output elements, got C={c}, {tuple(taps.shape)}")
    inv = fold_counts_inv(hs, ws, rate, taps.device)
    out = torch.empty((b, rate * hs, rate * ws, c), dtype=taps.dtype,
                      device=taps.device)
    lib = build.library("fold")
    fn = lib.gi_fold_taps
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(taps.device).cuda_stream
    with torch.cuda.device(taps.device):
        err = fn(taps.data_ptr(), inv.data_ptr(), out.data_ptr(), b, hs, ws,
                 c, rate, int(taps.dtype == torch.bfloat16), stream)
    count_launch(KERNEL)
    build.check(lib, err, KERNEL)
    return out
