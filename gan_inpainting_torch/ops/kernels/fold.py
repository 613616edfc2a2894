"""Overlap-add fold of the fused attention kernel's tap-major output.

``fold_taps`` replaces the Pallas kernel ``_fold_kernel``
(gan_inpainting_tpu/ops/pallas/fold.py:32). On a CUDA tensor it launches
``gi_fold_taps`` of ``csrc/fold.cu``: one block per output row, one
16-byte vector of one output pixel per thread (8 bytes or less only where
C or the pointers' alignment leave no wider vector, :func:`fold_vector`),
its at most four source taps found in closed form (:func:`fold_pairs`: two
(tap, cell) pairs per axis, the row's pair uniform over the block), all
loads issued before the float32 sum, times the exact reciprocal overlap
count (1, ½ or ¼, :func:`fold_inv`) computed in the kernel. It reads every
tap element once and writes every output element once, so on an H100 it is
bounded by bytes: (16 + 4)·Lq·C elements per image at rate 2. On a CPU
tensor it takes :func:`fold_taps_plain`, the patch-major fold of
ops/patches.py divided by the counts; :func:`fold_taps_mirror` is the
kernel's gather written in PyTorch, which the CPU tests hold against both.
The JAX package sends cell grids above 2048 cells to an XLA fold instead;
the port uses the kernel at every size.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from gan_inpainting_torch.ops.dispatch import (
    count_launch,
    interpreting,
    use_kernel,
)
from gan_inpainting_torch.ops.kernels import build
from gan_inpainting_torch.ops.patches import fold_patches

KERNEL = "fold_taps"
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of csrc/fold.cu and their argument types (each returns a
# cudaError_t as int)
_SIGNATURES = {
    "gi_fold_taps": [_P, _P] + [_I] * 7 + [_P],
    "gi_fold_tap_grads": [_P] * 7 + [_I] * 5 + [ctypes.c_float, _I, _P],
}


@functools.cache
def library() -> ctypes.CDLL:
    """``csrc/fold.cu``'s library, built on first use, its entries'
    argument types set once."""
    lib = build.library("fold")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def on_device(t: torch.Tensor):
    """``torch.cuda.device(t.device)`` where it is not the current device
    already (one card: a no-op context)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


@functools.lru_cache(maxsize=32)
def fold_counts_inv(hs: int, ws: int, rate: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(r·hs, r·ws) float32 reciprocal overlap counts (geometry only)."""
    ones = torch.ones((1, hs, ws, 2 * rate, 2 * rate, 1))
    _, cnt = fold_patches(ones, rate, (rate * hs, rate * ws))
    inv = 1.0 / torch.clamp(cnt[..., 0], min=1.0)
    return inv.to(device=device, dtype=torch.float32).contiguous()


def fold_pairs(n_out: int, n_cells: int, rate: int):
    """The kernel's closed form along one axis: for each output index a =
    0 … n_out−1, its two (window offset, cell) candidates (p0, i0) and (p0
    + r, i0 − 1), with na = a + r//2, p0 = na % r, i0 = na // r, and
    whether each cell exists → (p0, i0, valid0, valid1), each (n_out,)."""
    na = torch.arange(n_out) + rate // 2
    i0 = na // rate
    return na % rate, i0, i0 < n_cells, i0 >= 1


def fold_inv(hs: int, ws: int, rate: int) -> torch.Tensor:
    """(r·hs, r·ws) float32 1 / (valid rows · valid columns), as the kernel
    computes it: ½ per axis with two valid candidates, else 1."""
    _, _, r0, r1 = fold_pairs(rate * hs, hs, rate)
    _, _, c0, c1 = fold_pairs(rate * ws, ws, rate)
    half_r = torch.where(r0 & r1, 0.5, 1.0)
    half_c = torch.where(c0 & c1, 0.5, 1.0)
    return (half_r[:, None] * half_c[None, :]).float()


def fold_taps_plain(taps: torch.Tensor, hs: int, ws: int,
                    rate: int) -> torch.Tensor:
    """(B, 4r², hs·ws, C) → (B, r·hs, r·ws, C) through the patch-major fold
    divided by the overlap counts."""
    b, _, _, c = taps.shape
    pm = taps.permute(0, 2, 1, 3).reshape(b, hs, ws, 2 * rate, 2 * rate, c)
    y, cnt = fold_patches(pm, rate, (rate * hs, rate * ws))
    return y / torch.clamp(cnt, min=1.0).to(y.dtype)


def fold_taps_mirror(taps: torch.Tensor, hs: int, ws: int,
                     rate: int) -> torch.Tensor:
    """What ``gi_fold_taps`` computes, in PyTorch: each output pixel gathers
    its four (row pair × column pair) candidates from :func:`fold_pairs`, a
    missing cell as 0, sums them in float32 in the order (p0, q0), (p0,
    q1), (p1, q0), (p1, q1), and scales by :func:`fold_inv`."""
    _check(taps, hs, ws, rate)
    win = 2 * rate
    dev = taps.device
    p0, i0, r0, r1 = (t.to(dev) for t in fold_pairs(rate * hs, hs, rate))
    q0, j0, c0, c1 = (t.to(dev) for t in fold_pairs(rate * ws, ws, rate))
    acc = torch.zeros((taps.shape[0], rate * hs, rate * ws, taps.shape[-1]),
                      device=taps.device)
    for p, i, rv in ((p0, i0, r0), (p0 + rate, i0 - 1, r1)):
        for q, j, cv in ((q0, j0, c0), (q0 + rate, j0 - 1, c1)):
            tap = p[:, None] * win + q[None, :]
            cell = (i.clamp(0, hs - 1)[:, None] * ws
                    + j.clamp(0, ws - 1)[None, :])
            ok = (rv[:, None] & cv[None, :])[None, :, :, None]
            acc = acc + torch.where(ok, taps[:, tap, cell].float(), 0.0)
    inv = fold_inv(hs, ws, rate).to(taps.device)
    return (acc * inv[None, :, :, None]).to(taps.dtype)


def _check(taps: torch.Tensor, hs: int, ws: int, rate: int) -> None:
    if taps.dim() != 4:
        raise ValueError(f"taps must be (B, 4r², Lq, C), got {tuple(taps.shape)}")
    b, n_taps, lq, c = taps.shape
    if n_taps != 4 * rate * rate or lq != hs * ws:
        raise ValueError(f"taps {tuple(taps.shape)} do not match hs={hs} "
                         f"ws={ws} rate={rate}")


def fold_vector(c: int, dtype: torch.dtype, *ptrs: int) -> int:
    """Elements per vector of the kernel: the widest of 16, 8, 4 or 2 bytes
    (at least one element) that divides C and every pointer's alignment."""
    for nbytes in (16, 8, 4, 2):
        n = nbytes // dtype.itemsize
        if n >= 1 and c % n == 0 and all(p % nbytes == 0 for p in ptrs):
            return n
    return 1


def fold_taps(taps: torch.Tensor, hs: int, ws: int,
              rate: int) -> torch.Tensor:
    """Overlap-add (B, 4r², hs·ws, C) tap-major patches (window 2r, stride
    r, SAME) into (B, r·hs, r·ws, C), divided by the overlap counts."""
    _check(taps, hs, ws, rate)
    if interpreting():
        return fold_taps_mirror(taps, hs, ws, rate)
    if not use_kernel(taps):
        return fold_taps_plain(taps, hs, ws, rate)
    if taps.dtype not in _DTYPES:
        raise TypeError(f"fold_taps kernel takes {_DTYPES}, got {taps.dtype}")
    if not taps.is_contiguous():
        raise ValueError("fold_taps kernel needs contiguous taps")
    b, _, _, c = taps.shape
    if b * rate * hs >= 2 ** 31 or rate * hs * rate * ws * c >= 2 ** 31:
        raise ValueError(f"fold_taps kernel takes under 2^31 output rows "
                         f"and elements per image, got {tuple(taps.shape)}")
    out = torch.empty((b, rate * hs, rate * ws, c), dtype=taps.dtype,
                      device=taps.device)
    vec = fold_vector(c, taps.dtype, taps.data_ptr(), out.data_ptr())
    lib = library()
    with on_device(taps):
        err = lib.gi_fold_taps(
            taps.data_ptr(), out.data_ptr(), b, hs, ws, c, rate,
            int(taps.dtype == torch.bfloat16), vec,
            torch.cuda.current_stream(taps.device).cuda_stream)
    count_launch(KERNEL)
    build.check(lib, err, KERNEL)
    return out
