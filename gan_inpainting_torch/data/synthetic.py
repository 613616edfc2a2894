"""Procedural synthetic datasets, made from a seed: no file is read.

Two families, as in the JAX package. ``blobs``: a smooth colour gradient,
five soft elliptical blobs and one hard rectangle. ``textured``: two global
high-frequency textures (oriented near-square-wave stripes and a checker)
mixed by smooth multi-octave value noise, plus two hard-edged shapes filled
with their own stripes — any hole's content is coherent with texture
visible elsewhere, so copying (contextual attention) beats interpolation.

Each family is split into *draw* (``*_params``: a few numbers per image
from a ``torch.Generator`` on the CPU) and *render* (``*_image``: the
fields on the device), so the render can be held against the JAX package
on the same parameters.
"""

from __future__ import annotations

import functools
import math

import torch

from gan_inpainting_torch.utils.rng import uniform

_OCTAVES = (4, 8, 16, 32)


def _unit_grid(size: int, device):
    ys = torch.arange(size, dtype=torch.float32, device=device)[:, None] / size
    xs = torch.arange(size, dtype=torch.float32, device=device)[None, :] / size
    return ys.expand(size, size), xs.expand(size, size)


def _to(params: dict, device) -> dict:
    return {k: ([t.to(device) for t in v] if isinstance(v, list)
                else v.to(device)) for k, v in params.items()}


# ---------------------------------------------------------------------------
# blobs
# ---------------------------------------------------------------------------


def synthetic_params(generator: torch.Generator, batch: int) -> dict:
    u = functools.partial(uniform, generator)
    return {
        "grad": u((batch, 3, 3), -1.0, 1.0),
        "blob_color": u((batch, 5, 3), -1.0, 1.0),
        "blob_center": u((batch, 5, 2), 0.1, 0.9),
        "blob_sigma": u((batch, 5, 2), 0.03, 0.25),
        "rect_color": u((batch, 3), -1.0, 1.0),
        "rect_pos": u((batch, 2), 0.1, 0.6),
        "rect_size": u((batch, 2), 0.1, 0.3),
    }


def synthetic_image(params: dict, size: int, device="cpu") -> torch.Tensor:
    """(B, size, size, 3) float32 in [-1, 1] from :func:`synthetic_params`."""
    p = _to(params, device)
    ys, xs = _unit_grid(size, device)
    ys3, xs3 = ys[None, :, :, None], xs[None, :, :, None]
    g = p["grad"][:, None, None]                      # (B, 1, 1, 3, 3)
    img = g[..., 0] * ys3 + g[..., 1] * xs3 + g[..., 2] * 0.3
    for i in range(p["blob_color"].shape[1]):
        cy, cx = (p["blob_center"][:, i, j, None, None] for j in (0, 1))
        sy, sx = (p["blob_sigma"][:, i, j, None, None] for j in (0, 1))
        d2 = ((ys - cy) / sy) ** 2 + ((xs - cx) / sx) ** 2
        alpha = torch.exp(-d2)[..., None]
        img = img * (1.0 - alpha) + p["blob_color"][:, i, None, None] * alpha
    y0, x0 = (p["rect_pos"][:, j, None, None] for j in (0, 1))
    hh, ww = (p["rect_size"][:, j, None, None] for j in (0, 1))
    inside = (ys >= y0) & (ys < y0 + hh) & (xs >= x0) & (xs < x0 + ww)
    img = torch.where(inside[..., None], p["rect_color"][:, None, None], img)
    return torch.clamp(img, -1.0, 1.0)


# ---------------------------------------------------------------------------
# textured
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _cubic_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) weights of a cubic (Keys, a = −0.5) resize with
    half-pixel centres, each output's weights renormalized over the taps
    that fall inside the input — the rule of ``jax.image.resize``."""
    scale = n_out / n_in
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float64)[None]).abs()
    x = x / max(1.0 / scale, 1.0)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    w = torch.where(x >= 2.0, 0.0, torch.where(x >= 1.0, far, near))
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / total, 0.0)
    return w.float()


def value_noise(lattice: torch.Tensor, size: int) -> torch.Tensor:
    """(B, g, g, C) lattice → (B, size, size, C), cubic upsampling."""
    my = _cubic_matrix(lattice.shape[1], size).to(lattice.device)
    mx = _cubic_matrix(lattice.shape[2], size).to(lattice.device)
    return torch.einsum("yi,xj,bijc->byxc", my, mx, lattice)


def stripe_field(ys, xs, size: int, theta, period_px, phase,
                 sharpness: float = 4.0):
    """Oriented near-square-wave stripes in [-1, 1]; the period is in
    pixels, so the texture stays high-frequency at every size."""
    u = xs * torch.cos(theta) + ys * torch.sin(theta)
    wave = torch.sin(2.0 * math.pi * size * u / period_px + phase)
    return torch.tanh(sharpness * wave)


def _stripe_params(p: torch.Tensor):
    """(B, 3) uniform draws → theta, period (6–24 px), phase, each
    (B, 1, 1)."""
    theta = p[:, 0, None, None] * math.pi
    period = 6.0 + p[:, 1, None, None] * 18.0
    phase = p[:, 2, None, None] * (2.0 * math.pi)
    return theta, period, phase


def textured_params(generator: torch.Generator, batch: int,
                    size: int) -> dict:
    u = functools.partial(uniform, generator)
    return {
        "stripe1": u((batch, 3)),
        "stripe2a": u((batch, 3)),
        "stripe2b": u((batch, 3)),
        "mix": [u((batch, min(g, size), min(g, size), 1), -1.0, 1.0)
                for g in _OCTAVES],
        "color": u((batch, 2, 3), -1.0, 1.0),
        "cast": u((batch, 4, 4, 3), -1.0, 1.0),
        "shape_geo": u((batch, 2, 4)),
        "shape_stripe": u((batch, 2, 3)),
        "shape_color": u((batch, 2, 2, 3), -1.0, 1.0),
    }


def _two_color(c: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """c (B, 2, 3), field (B, H, W) → the field coloured along c0…c1."""
    f = field[..., None]
    return (c[:, 0, None, None] * (1.0 + f) * 0.5
            + c[:, 1, None, None] * (1.0 - f) * 0.5)


def textured_image(params: dict, size: int, device="cpu") -> torch.Tensor:
    """(B, size, size, 3) float32 in [-1, 1] from :func:`textured_params`."""
    p = _to(params, device)
    ys, xs = _unit_grid(size, device)
    t1 = stripe_field(ys, xs, size, *_stripe_params(p["stripe1"]))
    th2, pd2, ph2 = _stripe_params(p["stripe2a"])
    _, pd2b, ph2b = _stripe_params(p["stripe2b"])
    t2 = (stripe_field(ys, xs, size, th2, pd2, ph2)
          * stripe_field(ys, xs, size, th2 + math.pi / 2, pd2b, ph2b))
    noise = sum(value_noise(lat, size)[..., 0] * 0.5 ** i
                for i, lat in enumerate(p["mix"]))
    w = torch.sigmoid(3.0 * noise)
    img = _two_color(p["color"], w * t1 + (1.0 - w) * t2)
    img = img + 0.3 * value_noise(p["cast"], size)
    for i, rect in enumerate((True, False)):
        geo = p["shape_geo"][:, i]
        fill = _two_color(p["shape_color"][:, i], stripe_field(
            ys, xs, size, *_stripe_params(p["shape_stripe"][:, i])))
        cy = 0.15 + 0.6 * geo[:, 0, None, None]
        cx = 0.15 + 0.6 * geo[:, 1, None, None]
        hy = 0.08 + 0.17 * geo[:, 2, None, None]
        hx = 0.08 + 0.17 * geo[:, 3, None, None]
        if rect:
            inside = ((ys - cy).abs() < hy) & ((xs - cx).abs() < hx)
        else:
            inside = ((ys - cy) / hy) ** 2 + ((xs - cx) / hx) ** 2 < 1.0
        img = torch.where(inside[..., None], fill, img)
    return torch.clamp(img, -1.0, 1.0)


def synthetic_batch(generator: torch.Generator, batch: int, size: int,
                    family: str = "blobs", device="cpu") -> torch.Tensor:
    """(B, size, size, 3) float32 in [-1, 1]."""
    if family == "blobs":
        return synthetic_image(synthetic_params(generator, batch), size,
                               device)
    if family == "textured":
        return textured_image(textured_params(generator, batch, size), size,
                              device)
    raise ValueError(f"unknown synthetic family {family!r} "
                     "(expected one of ['blobs', 'textured'])")


def synthetic_batch_u8(generator: torch.Generator, batch: int, size: int,
                       family: str = "blobs", device="cpu") -> torch.Tensor:
    """uint8 variant, what a file loader would yield."""
    x = synthetic_batch(generator, batch, size, family, device)
    return torch.round(torch.clamp((x + 1.0) * 127.5, 0, 255)).to(torch.uint8)
