"""Adversarial losses: hinge, BCE (vanilla GAN), LSGAN, and the R1 penalty.

All take PatchGAN logit maps of any shape and reduce with a full mean in
float32. Over the mesh's spatial axis a member holds one of ``bands`` equal
row bands of the logit map: its "mean" is then its band's sum over the
whole map's count, a partial sum whose total over the spatial group is the
mean (parallel/spatial.py).

* hinge — L_D = E[relu(1 − D(x))] + E[relu(1 + D(G))]; L_G = −E[D(G)]
* bce   — the original GAN on logits
* lsgan — least squares (Mao et al.)
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

KINDS = ("hinge", "bce", "lsgan")


def band_mean(x: torch.Tensor, bands: int = 1) -> torch.Tensor:
    """The mean of a whole map of which ``x`` is one of ``bands`` equal row
    bands: the band's sum over the whole map's count (``torch.mean`` for
    one band)."""
    if bands == 1:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * bands)


def _bce_with_logits(logits: torch.Tensor, target: float,
                     bands: int) -> torch.Tensor:
    # softplus form of −t·log σ(x) − (1−t)·log(1−σ(x))
    return band_mean(F.softplus(logits) - target * logits, bands)


def d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
           kind: str = "hinge", bands: int = 1) -> torch.Tensor:
    real, fake = real_logits.float(), fake_logits.float()
    if kind == "hinge":
        return (band_mean(F.relu(1.0 - real), bands)
                + band_mean(F.relu(1.0 + fake), bands))
    if kind == "bce":
        return (_bce_with_logits(real, 1.0, bands)
                + _bce_with_logits(fake, 0.0, bands))
    if kind == "lsgan":
        return 0.5 * (band_mean((real - 1.0) ** 2, bands)
                      + band_mean(fake ** 2, bands))
    raise ValueError(f"unknown adversarial kind {kind!r}")


def g_loss(fake_logits: torch.Tensor, kind: str = "hinge",
           bands: int = 1) -> torch.Tensor:
    fake = fake_logits.float()
    if kind == "hinge":
        return -band_mean(fake, bands)
    if kind == "bce":
        return _bce_with_logits(fake, 1.0, bands)
    if kind == "lsgan":
        return 0.5 * band_mean((fake - 1.0) ** 2, bands)
    raise ValueError(f"unknown adversarial kind {kind!r}")


def r1_penalty(score_fn: Callable[[torch.Tensor], torch.Tensor],
               images: torch.Tensor) -> torch.Tensor:
    """0.5 · E_batch[‖∇_x score(x)‖²], the R1 regularizer (Mescheder et
    al. 2018) on real data; the caller multiplies by γ. ``score_fn`` maps
    an image batch to per-sample logits, each depending on its own sample
    only, so the gradient of the sum holds the per-sample gradients. The
    result stays differentiable (``create_graph``): in the D loss it makes
    the update second-order through the D forward."""
    imgs = images.detach().float().requires_grad_(True)
    with torch.enable_grad():
        total = score_fn(imgs).float().sum()
        (grads,) = torch.autograd.grad(total, imgs, create_graph=True)
    per_sample = grads.float().square().flatten(1).sum(1)
    return 0.5 * per_sample.mean()
