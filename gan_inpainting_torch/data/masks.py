"""Mask synthesis. Convention: **mask == 1 marks the hole**, 0 = known.

Each family is split in two: *draw* the parameters of a batch from a
``torch.Generator`` (on the CPU: a few numbers per sample), and *rasterize*
parameters on the device. The second half is the JAX package's geometry
and is held against it on the same parameters; the first cannot reproduce
JAX's PRNG and is tested by its distributions.

Center masks: a rectangle of side ``center_frac · size``, centred or
uniformly jittered. Free-form masks: the DeepFill-v2 brush walk as capsule
distance fields — per stroke a start point, a chain of segments with
random angle and length, and a brush width; a pixel is in the hole iff its
distance to any valid segment is at most width/2. Stroke and segment
counts are drawn up to ``max_strokes``/``max_segments``.
"""

from __future__ import annotations

import math

import torch

from gan_inpainting_torch.configs.base import MaskConfig
from gan_inpainting_torch.utils.rng import uniform


def _pixel_grid(height: int, width: int, device):
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    return ys.expand(height, width), xs.expand(height, width)


# ---------------------------------------------------------------------------
# Center masks
# ---------------------------------------------------------------------------


def rect_mask(y0, x0, hole_h: float, hole_w: float, height: int, width: int,
              device="cpu") -> torch.Tensor:
    """Rasterize rectangles [y0, y0+hole_h) × [x0, x0+hole_w): y0, x0 (B,)
    → (B, H, W, 1) float32 in {0, 1}."""
    ys, xs = _pixel_grid(height, width, device)
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    y0, x0 = y0.reshape(-1, 1, 1), x0.reshape(-1, 1, 1)
    inside = ((ys >= y0) & (ys < y0 + hole_h)
              & (xs >= x0) & (xs < x0 + hole_w))
    return inside.float()[..., None]


def center_mask(height: int, width: int, frac: float = 0.5,
                jitter: bool = False, *, batch: int = 1,
                generator: torch.Generator | None = None,
                device="cpu") -> torch.Tensor:
    """Rectangular hole masks (B, H, W, 1); jitter draws integer corners
    uniformly from ``generator``."""
    hole_h = max(1, int(round(height * frac)))
    hole_w = max(1, int(round(width * frac)))
    if jitter:
        y0 = torch.randint(0, height - hole_h + 1, (batch,),
                           generator=generator)
        x0 = torch.randint(0, width - hole_w + 1, (batch,),
                           generator=generator)
    else:
        y0 = torch.full((batch,), (height - hole_h) // 2)
        x0 = torch.full((batch,), (width - hole_w) // 2)
    return rect_mask(y0, x0, hole_h, hole_w, height, width, device)


def difficulty(cfg: MaskConfig, progress: float) -> float:
    """Curriculum scale in [start_scale, 1] at ``progress`` in [0, 1]."""
    scale = cfg.curriculum_start_scale
    return min(max(scale + (1.0 - scale) * progress, scale), 1.0)


def _center_curriculum(generator, height: int, width: int, cfg: MaskConfig,
                       progress: float, batch: int, device):
    if progress >= 1.0:
        return center_mask(height, width, cfg.center_frac, cfg.center_jitter,
                           batch=batch, generator=generator, device=device)
    # shrink the hole around its centre; only the bounds move
    frac = cfg.center_frac * difficulty(cfg, progress)
    hole_h, hole_w = height * frac, width * frac
    if cfg.center_jitter:
        y0 = uniform(generator, (batch,)) * (height - hole_h)
        x0 = uniform(generator, (batch,)) * (width - hole_w)
    else:
        y0 = torch.full((batch,), (height - hole_h) * 0.5)
        x0 = torch.full((batch,), (width - hole_w) * 0.5)
    return rect_mask(y0, x0, hole_h, hole_w, height, width, device)


# ---------------------------------------------------------------------------
# Free-form stroke masks
# ---------------------------------------------------------------------------


def sample_strokes(generator: torch.Generator, cfg: MaskConfig, height: int,
                   width: int, batch: int = 1) -> dict[str, torch.Tensor]:
    """Draw the brush-walk parameters of ``batch`` masks (CPU tensors):
    n_strokes (B,) in 1..V, n_segs (B, V) in 1..K, starts (B, V, 2) as
    (y, x), base angles and lengths (B, V, K), widths (B, V)."""
    v, k = cfg.max_strokes, cfg.max_segments
    return {
        "n_strokes": torch.randint(1, v + 1, (batch,), generator=generator),
        "n_segs": torch.randint(1, k + 1, (batch, v), generator=generator),
        "starts": uniform(generator, (batch, v, 2))
        * torch.tensor([height, width], dtype=torch.float32),
        "angles": uniform(generator, (batch, v, k), 0.0, 2.0 * math.pi),
        "lengths": uniform(generator, (batch, v, k), 1.0, cfg.max_step),
        "widths": uniform(generator, (batch, v), cfg.min_width,
                          cfg.max_width),
    }


def stroke_segments(params: dict[str, torch.Tensor], height: int,
                    width: int):
    """Walk geometry from drawn parameters → a, b (B, S, 2) segment ends,
    w (B, S) brush widths, valid (B, S) bool; S = max_strokes ·
    max_segments. Angles alternate direction each segment (DeepFill-v2);
    vertices are clipped to the image."""
    angles, lengths = params["angles"], params["lengths"]
    bsz, v, k = angles.shape
    flip = torch.where(torch.arange(k) % 2 == 0, 0.0, math.pi)
    angles = angles + flip
    deltas = torch.stack([lengths * torch.sin(angles),
                          lengths * torch.cos(angles)], -1)
    starts = params["starts"][:, :, None, :]
    verts = torch.cat([starts, starts + torch.cumsum(deltas, 2)], 2)
    lim = torch.tensor([height - 1, width - 1], dtype=torch.float32)
    verts = torch.minimum(torch.clamp(verts, min=0.0), lim)
    a = verts[:, :, :-1].reshape(bsz, v * k, 2)
    b = verts[:, :, 1:].reshape(bsz, v * k, 2)
    w = params["widths"].repeat_interleave(k, 1)
    stroke_idx = torch.arange(v).repeat_interleave(k)
    seg_idx = torch.arange(k).repeat(v)
    valid = ((stroke_idx[None] < params["n_strokes"][:, None])
             & (seg_idx[None] < params["n_segs"][:, stroke_idx]))
    return a, b, w, valid


def rasterize_strokes(a, b, w, valid, height: int, width: int,
                      device="cpu") -> torch.Tensor:
    """Capsule rasterization: (B, S, …) segments → (B, H, W, 1) float32 in
    {0, 1}. A pixel is hit by segment i iff its squared distance to the
    segment is at most (w_i / 2)² and the segment is valid."""
    a, b, w = (torch.as_tensor(t, dtype=torch.float32, device=device)
               for t in (a, b, w))
    valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
    ys, xs = _pixel_grid(height, width, device)
    mask = torch.zeros((a.shape[0], height, width), dtype=torch.bool,
                       device=device)
    for i in range(a.shape[1]):
        ay, ax = a[:, i, 0, None, None], a[:, i, 1, None, None]
        dby = b[:, i, 0, None, None] - ay
        dbx = b[:, i, 1, None, None] - ax
        seg_len2 = torch.clamp(dby * dby + dbx * dbx, min=1e-6)
        t = torch.clamp(((ys - ay) * dby + (xs - ax) * dbx) / seg_len2,
                        0.0, 1.0)
        dy = ys - (ay + t * dby)
        dx = xs - (ax + t * dbx)
        radius = w[:, i, None, None] * 0.5
        mask |= ((dy * dy + dx * dx <= radius * radius)
                 & valid[:, i, None, None])
    return mask.float()[..., None]


def freeform_mask(generator: torch.Generator, height: int, width: int,
                  cfg: MaskConfig, progress: float = 1.0, *, batch: int = 1,
                  device="cpu") -> torch.Tensor:
    """Free-form stroke masks (B, H, W, 1); the curriculum thins early
    strokes."""
    a, b, w, valid = stroke_segments(
        sample_strokes(generator, cfg, height, width, batch), height, width)
    return rasterize_strokes(a, b, w * difficulty(cfg, progress), valid,
                             height, width, device)


def random_mask_batch(generator: torch.Generator, batch: int, height: int,
                      width: int, cfg: MaskConfig, progress: float = 1.0,
                      device="cpu") -> torch.Tensor:
    """(B, H, W, 1) float32 masks of the config's ``kind`` (center |
    freeform | mixed). ``progress`` in [0, 1] drives the curriculum: hole
    difficulty ramps from ``curriculum_start_scale`` to full size; at 1.0
    the masks are the non-curriculum ones."""
    if cfg.kind == "center":
        return _center_curriculum(generator, height, width, cfg, progress,
                                  batch, device)
    if cfg.kind == "freeform":
        return freeform_mask(generator, height, width, cfg, progress,
                             batch=batch, device=device)
    if cfg.kind == "mixed":
        use_ff = uniform(generator, (batch,)) < cfg.freeform_prob
        cm = _center_curriculum(generator, height, width, cfg, progress,
                                batch, device)
        fm = freeform_mask(generator, height, width, cfg, progress,
                           batch=batch, device=device)
        return torch.where(use_ff.to(device)[:, None, None, None], fm, cm)
    raise ValueError(f"unknown mask kind {cfg.kind!r}")
