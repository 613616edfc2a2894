"""Plain float32 training step of DeepFill v2 with a PatchGAN: hinge
losses, hole-weighted L1 on both stages, lazy R1 on real images, Adam and
an EMA of the generator.

One step, in this order: the generator's fake without gradient; the D
loss on the batch-concatenated (real, fake) pass, plus γ·k·R1 on every
k-th step (R1 = 0.5 · mean over the batch of ‖∇ₓ Σ D(x)‖², a double
backward); Adam on D; the G loss against the updated D (−mean D(G) plus
the L1 of the fine and the coarse output, hole pixels weighted 6, known
1); Adam on G; the EMA of G's parameters.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from benchmark.reference import deepfill


@dataclasses.dataclass(frozen=True)
class Hyper:
    base_features: int = 48
    disc_features: int = 64
    disc_layers: int = 4
    g_lr: float = 1e-4
    d_lr: float = 4e-4
    beta1: float = 0.5
    beta2: float = 0.9
    eps: float = 1e-8
    r1_gamma: float = 0.1
    r1_interval: int = 16
    l1_weight: float = 1.0
    l1_hole_weight: float = 6.0
    l1_valid_weight: float = 1.0
    gan_weight: float = 1.0
    ema_decay: float = 0.999


class Adam:
    """Adam with bias correction, as ``torch.optim.Adam`` (eps outside
    the square root), on a dict of leaves."""

    def __init__(self, params: dict, lr, beta1, beta2, eps):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = self.v[k].sqrt() / c2 ** 0.5 + self.eps
                p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def l1(output, target, mask, h: Hyper):
    w = h.l1_hole_weight * mask + h.l1_valid_weight * (1.0 - mask)
    err = torch.abs(output - target)
    return torch.sum(w * err) / (torch.sum(w) * err.shape[-1] + 1e-8)


def hinge_d(real, fake):
    return torch.mean(F.relu(1.0 - real)) + torch.mean(F.relu(1.0 + fake))


class State:
    """Both networks' float32 leaves, their Adams, the EMA and the step."""

    def __init__(self, g_params: dict, d_params: dict, h: Hyper):
        self.h = h
        self.g = {k: v.detach().float().clone().requires_grad_(True)
                  for k, v in g_params.items()}
        self.d = {k: v.detach().float().clone().requires_grad_(True)
                  for k, v in d_params.items()}
        self.g_opt = Adam(self.g, h.g_lr, h.beta1, h.beta2, h.eps)
        self.d_opt = Adam(self.d, h.d_lr, h.beta1, h.beta2, h.eps)
        self.ema = {k: v.detach().clone() for k, v in self.g.items()}
        self.step = 0


def train_step(s: State, image, mask, q=None, attention=None) -> dict:
    """One step on a batch: image (B, H, W, 3) in [-1, 1], mask (B, H, W,
    1), 1 = hole. Returns the step's losses as floats-to-be (0-d
    tensors). ``attention`` replaces the contextual attention (the FLOP
    count runs it without its products)."""
    h = s.h
    gen_kw = dict(f=h.base_features, q=q)
    if attention is not None:
        gen_kw["attention"] = attention
    disc_kw = dict(f=h.disc_features, layers=h.disc_layers, q=q)
    masked = image * (1.0 - mask)
    out = {}

    # ---- D step -----------------------------------------------------------
    with torch.no_grad():
        _, fine = deepfill.generator(s.g, masked, mask, **gen_kw)
        fake = fine * mask + image * (1.0 - mask)
    d_leaves = list(s.d.values())
    loss = None
    if h.r1_gamma > 0 and s.step % h.r1_interval == 0:
        x = image.detach().clone().requires_grad_(True)
        score = deepfill.discriminator(s.d, x, mask, **disc_kw).sum()
        (gx,) = torch.autograd.grad(score, x, create_graph=True)
        r1 = 0.5 * gx.square().flatten(1).sum(1).mean()
        out["d_r1"] = r1.detach()
        loss = (h.r1_gamma * h.r1_interval) * r1
    logits = deepfill.discriminator(s.d, torch.cat([image, fake], 0),
                                    torch.cat([mask, mask], 0), **disc_kw)
    real, fk = logits.chunk(2, 0)
    d_loss = hinge_d(real, fk)
    loss = d_loss if loss is None else d_loss + loss
    grads = torch.autograd.grad(loss, d_leaves)
    out["d_loss"] = loss.detach()
    s.d_opt.step(s.d, dict(zip(s.d, grads)))

    # ---- G step, against the updated D --------------------------------------
    g_leaves = list(s.g.values())
    coarse, fine = deepfill.generator(s.g, masked, mask, **gen_kw)
    comp = fine * mask + image * (1.0 - mask)
    adv = -torch.mean(deepfill.discriminator(s.d, comp, mask, **disc_kw))
    rec = l1(fine, image, mask, h) + l1(coarse, image, mask, h)
    total = h.gan_weight * adv + h.l1_weight * rec
    grads = torch.autograd.grad(total, g_leaves)
    out["g_loss"] = total.detach()
    s.g_opt.step(s.g, dict(zip(s.g, grads)))

    with torch.no_grad():
        for k, p in s.g.items():
            s.ema[k].mul_(h.ema_decay).add_(p, alpha=1.0 - h.ema_decay)
    s.step += 1
    return out


def train_batch(images_u8, gen: torch.Generator, m: dict, flip: bool,
                device):
    """The batch a step trains on, from uint8 images (B, H, W, 3): each
    image flipped left-right where a uniform draw is below 0.5 (drawn
    first), then the free-form masks, all from ``gen`` (CPU). Returns
    (image in [-1, 1], mask)."""
    b, hgt, wid = images_u8.shape[:3]
    if flip:
        bits = torch.rand((b,), generator=gen) < 0.5
        images_u8 = torch.where(bits.to(device)[:, None, None, None],
                                images_u8.flip(2), images_u8)
    image = images_u8.float() / 127.5 - 1.0
    mask = deepfill.rasterize(deepfill.sample_strokes(gen, m, hgt, wid, b),
                              hgt, wid, device)
    return image, mask
