"""Partial-conv epilogue: renormalize, bias, zero-fill, mask update.

``partial_conv_epilogue`` replaces the Pallas kernel
``_partial_epilogue_kernel`` (gan_inpainting_tpu/ops/pallas/fused_matmul.py:
207, entry ``partial_conv_epilogue_pallas``). Per output pixel of the raw
feature conv, with ``count`` = valid pixels under its window:

    scale     = k² / count        where count > 0, else 0
    y         = raw · scale + b   where count > 0, else exactly 0
    valid_out = count > 0         (in raw's dtype, exactly 0 or 1)

On a CUDA tensor it launches ``csrc/partial_epilogue.cu``: one pass over
``raw`` with 16-byte loads along the channels, float32 arithmetic, both
outputs written from that pass. On an H100 it is bounded by bytes
(2·M·C·itemsize + 8·M: raw in, y out, one count in and one valid out per
pixel); the plain version below makes five or six passes. The activation is
not fused: the layer applies it afterwards, as in the JAX package.

On a CPU tensor the wrapper takes :func:`partial_conv_epilogue_plain`.
The gradient is that of the plain epilogue, written out: ``d raw = g ·
scale`` where ``count > 0``, ``d bias`` = the sum of ``g`` over those
pixels, nothing for the counts.
"""

from __future__ import annotations

import ctypes

import torch

from gan_inpainting_torch.ops.dispatch import count_launch, use_kernel
from gan_inpainting_torch.ops.kernels import build

KERNEL = "partial_epilogue"
_DTYPES = (torch.float32, torch.bfloat16)


def partial_conv_epilogue_plain(raw: torch.Tensor, counts: torch.Tensor,
                                bias: torch.Tensor, window: int):
    """raw: (B, Ho, Wo, C), counts: (B, Ho, Wo, 1), bias: (C,) →
    (y, valid_out)."""
    counts = counts.float()
    any_valid = counts > 0.0
    scale = torch.where(any_valid,
                        (window * window) / torch.clamp(counts, min=1.0), 0.0)
    y = raw * scale.to(raw.dtype) + bias.to(raw.dtype)
    y = torch.where(any_valid, y, torch.zeros((), dtype=raw.dtype,
                                              device=raw.device))
    return y, any_valid.to(raw.dtype)


def epilogue_grads(g: torch.Tensor, counts: torch.Tensor, window: int,
                   bias_dtype: torch.dtype = torch.float32):
    """(d raw, d bias) of the epilogue for an upstream gradient ``g`` of
    ``y``: the plain epilogue's own gradient."""
    counts = counts.float()
    any_valid = counts > 0.0
    scale = torch.where(any_valid,
                        (window * window) / torch.clamp(counts, min=1.0), 0.0)
    d_raw = g * scale.to(g.dtype)
    d_bias = torch.where(any_valid, g, torch.zeros((), dtype=g.dtype,
                                                   device=g.device))
    d_bias = d_bias.sum(dim=(0, 1, 2), dtype=torch.float32)
    return d_raw, d_bias.to(bias_dtype)


def _launch(raw: torch.Tensor, counts: torch.Tensor, bias: torch.Tensor,
            window: int):
    b, ho, wo, c = raw.shape
    y = torch.empty_like(raw)
    valid = torch.empty((b, ho, wo, 1), dtype=raw.dtype, device=raw.device)
    lib = build.library("partial_epilogue")
    fn = lib.gi_partial_epilogue
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p])
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    with torch.cuda.device(raw.device):
        err = fn(raw.data_ptr(), counts.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), valid.data_ptr(), b * ho * wo, c,
                 float(window * window), int(raw.dtype == torch.bfloat16),
                 stream)
    count_launch(KERNEL)
    build.check(lib, err, KERNEL)
    return y, valid


class _PartialEpilogue(torch.autograd.Function):

    @staticmethod
    def forward(ctx, raw, counts, bias, window):
        ctx.save_for_backward(counts)
        ctx.window, ctx.bias_dtype = window, bias.dtype
        y, valid = _launch(raw, counts, bias.float().contiguous(), window)
        ctx.mark_non_differentiable(valid)
        return y, valid

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_valid):
        (counts,) = ctx.saved_tensors
        d_raw, d_bias = epilogue_grads(g, counts, ctx.window, ctx.bias_dtype)
        return d_raw, None, d_bias, None


def partial_conv_epilogue(raw: torch.Tensor, counts: torch.Tensor,
                          bias: torch.Tensor, window: int):
    """(y, valid_out) as :func:`partial_conv_epilogue_plain`: the kernel on
    a CUDA tensor, the plain version on a CPU tensor and inside
    ``interpret_kernels`` (the kernel has no mirror)."""
    if raw.dim() != 4 or counts.shape != raw.shape[:3] + (1,) \
            or bias.shape != raw.shape[3:]:
        raise ValueError(f"raw {tuple(raw.shape)}, counts "
                         f"{tuple(counts.shape)}, bias {tuple(bias.shape)}: "
                         "want (B, Ho, Wo, C), (B, Ho, Wo, 1), (C,)")
    if not use_kernel(raw):
        return partial_conv_epilogue_plain(raw, counts, bias, window)
    if raw.dtype not in _DTYPES:
        raise TypeError(f"partial epilogue kernel takes {_DTYPES}, got "
                        f"{raw.dtype}")
    if counts.device != raw.device or bias.device != raw.device:
        raise ValueError("raw, counts and bias must be on one device")
    return _PartialEpilogue.apply(raw.contiguous(),
                                  counts.float().contiguous(), bias, window)
