"""Adversarial losses: hinge, BCE (vanilla GAN), LSGAN, and the R1 penalty.

All take PatchGAN logit maps of any shape and reduce with a full mean in
float32.

* hinge — L_D = E[relu(1 − D(x))] + E[relu(1 + D(G))]; L_G = −E[D(G)]
* bce   — the original GAN on logits
* lsgan — least squares (Mao et al.)
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

KINDS = ("hinge", "bce", "lsgan")


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    # softplus form of −t·log σ(x) − (1−t)·log(1−σ(x))
    return torch.mean(F.softplus(logits) - target * logits)


def d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
           kind: str = "hinge") -> torch.Tensor:
    real, fake = real_logits.float(), fake_logits.float()
    if kind == "hinge":
        return torch.mean(F.relu(1.0 - real)) + torch.mean(F.relu(1.0 + fake))
    if kind == "bce":
        return _bce_with_logits(real, 1.0) + _bce_with_logits(fake, 0.0)
    if kind == "lsgan":
        return 0.5 * (torch.mean((real - 1.0) ** 2) + torch.mean(fake ** 2))
    raise ValueError(f"unknown adversarial kind {kind!r}")


def g_loss(fake_logits: torch.Tensor, kind: str = "hinge") -> torch.Tensor:
    fake = fake_logits.float()
    if kind == "hinge":
        return -torch.mean(fake)
    if kind == "bce":
        return _bce_with_logits(fake, 1.0)
    if kind == "lsgan":
        return 0.5 * torch.mean((fake - 1.0) ** 2)
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
