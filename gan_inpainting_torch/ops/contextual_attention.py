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

On a CUDA tensor with f is b (the generator's use) the op runs the fused
attention kernel plus the fold kernel (ops/kernels/); where a gradient is
wanted it is a ``torch.autograd.Function`` whose backward runs the two
backward kernels (ops/kernels/fused_attention_bwd.py). On a CPU tensor it
runs the plain composition below, which materializes the patches and the
(Lq, Lk) score matrix and is differentiated by autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gan_inpainting_torch.ops.dispatch import section, use_kernel
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


def _patch_attention_plain(q, k, key_valid, v, softmax_scale: float):
    """Dense attention over patch vectors: materializes (Lq, Lk) scores.
    Products in float32 (as the JAX path's ``preferred_element_type``);
    the weights are rounded to V's dtype before the PV product."""
    scores = torch.matmul(q.float(), k.float().transpose(1, 2))
    bias = torch.where(key_valid, 0.0, NEG_INF)[:, None, :]
    attn = torch.softmax(softmax_scale * scores + bias, dim=-1)
    attn = attn * key_valid[:, None, :].to(attn.dtype)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def contextual_attention_plain(f, b, hole_mask, *, ksize: int = 3,
                               rate: int = 2, softmax_scale: float = 10.0):
    """The plain composition: patches, dense attention, fold ÷ counts."""
    bsz, h, w, c = f.shape
    q, k, key_valid, v, (hs, ws) = _attention_inputs(f, b, hole_mask, ksize,
                                                     rate)
    yp = _patch_attention_plain(q, k, key_valid, v, softmax_scale)
    yp = yp.reshape(bsz, hs, ws, 2 * rate, 2 * rate, c)
    y, cnt = fold_patches(yp, rate, (h, w))
    y = y / torch.clamp(cnt, min=1.0).to(y.dtype)
    return y.to(f.dtype)


class _FusedAttention(torch.autograd.Function):
    """Kernel + fold on a CUDA feature map, with the kernel backward. The
    forward saves (b_feat, hole_mask, o_taps, lse); the hole mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, b_feat, hole_mask, ksize, rate, softmax_scale):
        from gan_inpainting_torch.ops.kernels.fold import fold_taps
        from gan_inpainting_torch.ops.kernels.fused_attention import (
            fused_attention_taps,
        )

        _, h, w, _ = b_feat.shape
        taps, lse = fused_attention_taps(
            b_feat, hole_mask, ksize=ksize, rate=rate,
            softmax_scale=softmax_scale, want_lse=True)
        ctx.save_for_backward(b_feat, hole_mask, taps, lse)
        ctx.args = (ksize, rate, softmax_scale)
        return fold_taps(taps, h // rate, w // rate, rate)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
            contextual_attention_bwd,
        )

        b_feat, hole_mask, taps, lse = ctx.saved_tensors
        ksize, rate, softmax_scale = ctx.args
        with section("attention_backward"):
            db = contextual_attention_bwd(
                b_feat, hole_mask, taps, lse, g, ksize=ksize, rate=rate,
                softmax_scale=softmax_scale)
        return db, None, None, None, None


def contextual_attention(f, b, hole_mask, *, ksize: int = 3, rate: int = 2,
                         softmax_scale: float = 10.0) -> torch.Tensor:
    """Contextual attention.

    Args:
      f: (B, H, W, C) foreground features (queries; typically ``is b``).
      b: (B, H, W, C) background features (keys/values).
      hole_mask: (B, H, W, 1), 1 = hole. Keys inside the hole are excluded.

    Returns:
      (B, H, W, C) attended features, in f's dtype.
    """
    if not use_kernel(b):
        return contextual_attention_plain(f, b, hole_mask, ksize=ksize,
                                          rate=rate,
                                          softmax_scale=softmax_scale)
    if f is not b:
        raise NotImplementedError(
            "contextual attention with f != b on CUDA needs the patch "
            "attention kernel (ROADMAP Queue 2: patch_attention.py)")
    from gan_inpainting_torch.ops.kernels.fold import fold_taps
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        fused_attention_taps,
    )

    if torch.is_grad_enabled() and b.requires_grad:
        return _FusedAttention.apply(b.contiguous(), hole_mask, ksize, rate,
                                     softmax_scale).to(f.dtype)
    # serving: nothing is saved and no log-sum-exp is written
    _, h, w, _ = b.shape
    taps = fused_attention_taps(b, hole_mask, ksize=ksize, rate=rate,
                                softmax_scale=softmax_scale)
    return fold_taps(taps, h // rate, w // rate, rate).to(f.dtype)
