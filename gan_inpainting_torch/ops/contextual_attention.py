"""Contextual attention (Yu et al. CVPR'18, kept in DeepFill-v2's
refinement branch), NHWC.

1. Downscale f, b, mask by ``rate`` for matching.
2. Keys = L2-normalized ksize×ksize patches of b_small (stride 1), norms
   floored at 1e-4; queries = the same patches of f_small, unnormalized.
3. Keys whose window touches the hole get an additive −1e9 bias.
4. Softmax over keys, then the weights are multiplied by key validity, so
   a query whose keys are all holes gives exactly 0. Output patches =
   attention @ V, V = (2·rate)² patches of full-res b at stride ``rate``.
5. Overlap-add the output patches back to (H, W) and divide by the exact
   overlap counts.

Under the ``pallas`` backend (what ``auto`` resolves to for this op,
ops/dispatch.py) on a CUDA tensor the op follows the JAX package's routing
(gan_inpainting_tpu/ops/contextual_attention.py:154-181) with the card's
own limits:

* f is b, the fused kernel holds the map (``fused_supported``) and the
  map has at most ``FUSED_MAX_CELLS`` cells for a bf16 map that a
  backward follows (``FUSED_MAX_CELLS_BF16_FORWARD`` for one that no
  backward follows, ``FUSED_MAX_CELLS_F32`` for float32), the largest
  measured sizes at which the fused route was the faster (``fused_route``):
  the fused attention kernel plus the fold kernel (ops/kernels/); where a
  gradient is wanted it is :class:`_FusedAttention`, whose backward runs
  the fused backward kernels where their plan holds (``bwd_supported``)
  and otherwise differentiates the patch composition through the
  patch-attention kernels;
* anything else (f ≠ b, ksize ≠ 3, larger maps, maps beyond the fused
  kernel's shared memory): the plain front end builds Q, K, V, the patch-attention kernels
  (ops/kernels/patch_attention.py) attend, the plain fold ÷ counts folds,
  and autograd differentiates front end and fold around the kernels.

On a CPU tensor, and under the ``xla`` backend on any device, it runs the
plain composition below, which materializes the patches and the (Lq, Lk)
score matrix and is differentiated by autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import (
    interpreting,
    resolve_backend,
    section,
    use_kernel,
)
from gan_inpainting_torch.ops.kernels.patch_attention import (
    attend,
    patch_attention_plain,
)
from gan_inpainting_torch.ops.patches import extract_patches, fold_patches

NEG_INF = -1e9


def downscale_mask_max(mask: torch.Tensor, rate: int) -> torch.Tensor:
    """Conservative hole-mask downscale of (B, H, W, 1): max over each
    rate×rate window, so thin strokes cannot vanish."""
    if rate == 1:
        return mask
    y = F.max_pool2d(mask.permute(0, 3, 1, 2), rate, rate)
    return y.permute(0, 2, 3, 1)


def key_validity(hole_s: torch.Tensor, ksize: int) -> torch.Tensor:
    """(B, hs, ws, 1) downscaled hole map → (B, hs·ws) bool: key j is valid
    iff its ksize window holds no hole cell. The window max pads with −inf
    on ((k−1)//2, k//2), so cells outside the map are not holes."""
    lo, hi = (ksize - 1) // 2, ksize // 2
    x = F.pad(hole_s.permute(0, 3, 1, 2), (lo, hi, lo, hi),
              value=float("-inf"))
    hole_max = F.max_pool2d(x, ksize, 1)
    return (hole_max <= 0.0).reshape(hole_s.shape[0], -1)


def _attention_inputs(f, b, hole_mask, ksize: int, rate: int):
    """Plain front-end: Q, K (normalized), key validity, V patches."""
    bsz, h, w, c = f.shape
    if h % rate or w % rate:
        raise ValueError(f"spatial dims {(h, w)} must divide rate={rate}")
    hs, ws = h // rate, w // rate

    v = extract_patches(b, 2 * rate, rate)             # (B,hs,ws,2r,2r,C)
    v = v.reshape(bsz, hs * ws, 4 * rate * rate * c)

    b_s = b[:, ::rate, ::rate, :]
    k_raw = extract_patches(b_s, ksize, 1)
    k_raw = k_raw.reshape(bsz, hs * ws, ksize * ksize * c)
    if f is b:
        q = k_raw
    else:
        q = extract_patches(f[:, ::rate, ::rate, :], ksize, 1)
        q = q.reshape(bsz, hs * ws, ksize * ksize * c)
    knorm = torch.sqrt(torch.sum(torch.square(k_raw.float()), -1,
                                 keepdim=True))
    k = k_raw / torch.clamp(knorm, min=1e-4).to(k_raw.dtype)

    hole_s = downscale_mask_max(hole_mask.float(), rate)
    key_valid = key_validity(hole_s, ksize)
    return q, k, key_valid, v, (hs, ws)


def contextual_attention_plain(f, b, hole_mask, *, ksize: int = 3,
                               rate: int = 2, softmax_scale: float = 10.0):
    """The plain composition: patches, dense attention, fold ÷ counts."""
    bsz, h, w, c = f.shape
    q, k, key_valid, v, (hs, ws) = _attention_inputs(f, b, hole_mask, ksize,
                                                     rate)
    yp = patch_attention_plain(q, k, key_valid, v,
                               softmax_scale=softmax_scale)
    return _fold(yp, (bsz, h, w, c), rate).to(f.dtype)


def _fold(yp, shape, rate: int):
    """(B, Lq, 4r²C) output patches → (B, H, W, C): plain fold ÷ counts."""
    bsz, h, w, c = shape
    yp = yp.reshape(bsz, h // rate, w // rate, 2 * rate, 2 * rate, c)
    y, cnt = fold_patches(yp, rate, (h, w))
    return y / torch.clamp(cnt, min=1.0).to(y.dtype)


def _patch_route(f, b, hole_mask, ksize: int, rate: int,
                 softmax_scale: float):
    """Plain front end → patch-attention kernels → plain fold ÷ counts,
    differentiated by autograd around the kernels' Function."""
    q, k, key_valid, v, _ = _attention_inputs(f, b, hole_mask, ksize, rate)
    yp = attend(q, k, key_valid, v, softmax_scale)
    return _fold(yp, f.shape, rate)


class _FusedAttention(torch.autograd.Function):
    """Fused kernel + fold on a CUDA feature map, with a kernel backward.
    Where the fused backward's plan holds, the forward saves (b_feat,
    hole_mask, o_taps, lse) and the backward runs the two fused backward
    kernels; elsewhere it saves (b_feat, hole_mask) only and the backward
    differentiates the patch composition, whose attention runs the patch
    kernels (forward with lse, dQ, dK/dV), as the JAX package's
    ``_fused_folded_bwd`` does. The hole mask gets no gradient."""

    @staticmethod
    def forward(ctx, b_feat, hole_mask, ksize, rate, softmax_scale):
        from gan_inpainting_torch.ops.kernels.fold import fold_taps
        from gan_inpainting_torch.ops.kernels.fused_attention import (
            fused_attention_taps,
        )
        from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
            bwd_supported,
        )

        _, h, w, c = b_feat.shape
        hs, ws = h // rate, w // rate
        ctx.args = (ksize, rate, softmax_scale)
        ctx.in_kernel = bwd_supported(hs, ws, c, b_feat.dtype)
        if ctx.in_kernel:
            taps, lse = fused_attention_taps(
                b_feat, hole_mask, ksize=ksize, rate=rate,
                softmax_scale=softmax_scale, want_lse=True)
            ctx.save_for_backward(b_feat, hole_mask, taps, lse)
        else:
            taps = fused_attention_taps(b_feat, hole_mask, ksize=ksize,
                                        rate=rate,
                                        softmax_scale=softmax_scale)
            ctx.save_for_backward(b_feat, hole_mask)
        return fold_taps(taps, hs, ws, rate)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
            contextual_attention_bwd,
        )

        ksize, rate, softmax_scale = ctx.args
        with section("attention_backward"):
            if ctx.in_kernel:
                b_feat, hole_mask, taps, lse = ctx.saved_tensors
                db = contextual_attention_bwd(
                    b_feat, hole_mask, taps, lse, g, ksize=ksize, rate=rate,
                    softmax_scale=softmax_scale)
            else:
                b_feat, hole_mask = ctx.saved_tensors
                with torch.enable_grad():
                    x = b_feat.detach().requires_grad_(True)
                    y = _patch_route(x, x, hole_mask, ksize, rate,
                                     softmax_scale)
                    (db,) = torch.autograd.grad(y, x, g.to(y.dtype))
        return db, None, None, None, None


def contextual_attention(f, b, hole_mask, *, ksize: int = 3, rate: int = 2,
                         softmax_scale: float = 10.0,
                         backend: str = "auto") -> torch.Tensor:
    """Contextual attention.

    Args:
      f: (B, H, W, C) foreground features (queries; typically ``is b``).
      b: (B, H, W, C) background features (keys/values).
      hole_mask: (B, H, W, 1), 1 = hole. Keys inside the hole are excluded.

    Returns:
      (B, H, W, C) attended features, in f's dtype.
    """
    backend = resolve_backend(backend, op="contextual_attention")
    if backend == "xla" or not (interpreting() or use_kernel(b)):
        return contextual_attention_plain(f, b, hole_mask, ksize=ksize,
                                          rate=rate,
                                          softmax_scale=softmax_scale)
    from gan_inpainting_torch.ops.kernels.fused_attention import fused_route

    backward = torch.is_grad_enabled() and b.requires_grad
    if f is not b or not fused_route(b.shape, ksize, rate, b.dtype,
                                     backward=backward):
        return _patch_route(f, b, hole_mask, ksize, rate,
                            softmax_scale).to(f.dtype)
    from gan_inpainting_torch.ops.kernels.fold import fold_taps
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        fused_attention_taps,
    )

    if backward:
        return _FusedAttention.apply(b.contiguous(), hole_mask, ksize, rate,
                                     softmax_scale).to(f.dtype)
    # serving: nothing is saved and no log-sum-exp is written
    _, h, w, _ = b.shape
    taps = fused_attention_taps(b, hole_mask, ksize=ksize, rate=rate,
                                softmax_scale=softmax_scale)
    return fold_taps(taps, h // rate, w // rate, rate).to(f.dtype)
