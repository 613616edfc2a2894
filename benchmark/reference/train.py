"""Plain float32 training step of DeepFill v2 with a PatchGAN: hinge
losses, hole-weighted L1 on both stages, lazy R1 on real images, Adam and
an EMA of the generator.

One step, in this order: the generator's fake without gradient; the D
loss on the batch-concatenated (real, fake) pass, plus γ·k·R1 on every
k-th step (R1 = 0.5 · mean over the batch of ‖∇ₓ Σ D(x)‖², a double
backward); Adam on D; the G loss against the updated D (−mean D(G) plus
the L1 of the fine and the coarse output, hole pixels weighted 6, known
1); Adam on G; the EMA of G's parameters.

A configuration that names this file as its ``reference`` is trained:
``published``, ``hyper``, ``weights``, ``State``, ``train_step``,
``train_batch``, ``counts``, ``fp8`` and ``float32_exact`` are what a
training driver asks of it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from benchmark.reference import deepfill
from benchmark.reference.deepfill import float32_exact, fp8  # noqa: F401


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


def hyper(cfg) -> Hyper:
    """The reference's hyperparameters, read from the program's config."""
    m, lc, tc = cfg.model, cfg.loss, cfg.train
    return Hyper(
        base_features=m.base_features, disc_features=m.disc_features,
        disc_layers=m.disc_layers, g_lr=tc.g_lr, d_lr=tc.d_lr,
        beta1=tc.beta1, beta2=tc.beta2, r1_gamma=lc.r1_gamma,
        r1_interval=lc.r1_interval, l1_weight=lc.l1_weight,
        l1_hole_weight=lc.l1_hole_weight, l1_valid_weight=lc.l1_valid_weight,
        gan_weight=lc.gan_weight, ema_decay=tc.g_ema_decay)


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


def _flips_and_masks(gen: torch.Generator, m: dict, flip: bool, b: int,
                     hgt: int, wid: int, device):
    """A step's draws from its CPU generator, in the batch build's order:
    the flip bits (None without flips), then the free-form masks."""
    bits = torch.rand((b,), generator=gen) < 0.5 if flip else None
    mask = deepfill.rasterize(deepfill.sample_strokes(gen, m, hgt, wid, b),
                              hgt, wid, device)
    return bits, mask


def train_batch(images_u8, gen: torch.Generator, m: dict, flip: bool,
                device):
    """The batch a step trains on, from uint8 images (B, H, W, 3): each
    image flipped left-right where a uniform draw is below 0.5 (drawn
    first), then the free-form masks, all from ``gen`` (CPU). Returns
    (image in [-1, 1], mask)."""
    b, hgt, wid = images_u8.shape[:3]
    bits, mask = _flips_and_masks(gen, m, flip, b, hgt, wid, device)
    if bits is not None:
        images_u8 = torch.where(bits.to(device)[:, None, None, None],
                                images_u8.flip(2), images_u8)
    return images_u8.float() / 127.5 - 1.0, mask


# ---------------------------------------------------------------------------
# The training reference's interface beyond the step (benchmark/README.md)
# ---------------------------------------------------------------------------


def published(program_config: dict) -> dict:
    """The keys of the configuration file's ``published`` that this
    reference works out from the program's config (a plain dict): the
    generator's width and its parameter count at that width."""
    f = program_config["model"]["base_features"]
    return {"base_features": f, "parameters_g": sum(
        math.prod(s) for s, _ in deepfill.generator_shapes(f).values())}


def weights(file_cfg: dict, program_cfg, seed: int, device):
    """(G, D) weights of a run, drawn from ``seed`` on ``device``
    (fan-in truncated normal, G's times the file's ``weight_gain``; zero
    biases), under the program's ``state_dict`` names."""
    from benchmark.harness.inputs import make_params

    m = program_cfg.model
    g = make_params(deepfill.generator_shapes(m.base_features), seed, device,
                    "g", file_cfg.get("weight_gain", 1.0))
    d = make_params(deepfill.discriminator_shapes(m.disc_features,
                                                  m.disc_layers),
                    seed, device, "d")
    return g, d


def counts(program_cfg, generators, r1_steps: int, device) -> dict:
    """The benchmark's counts of training steps, one per CPU generator in
    ``generators`` (each step's masks drawn from it again as
    :func:`train_batch` draws them), ``r1_steps`` of them with R1:
    ``model_flops`` (the reference step's FLOPs without the attention's
    products, plus the attention over its valid pairs twice forward and
    once backward) and ``attn_bwd_bound_s`` (kernel table rows 4, 5, 5b)."""
    from benchmark.harness import count
    from benchmark.harness.inputs import mask_params

    h = hyper(program_cfg)
    b, s = program_cfg.data.batch_size, program_cfg.data.image_size
    f = program_cfg.model.base_features
    m = mask_params(program_cfg)
    steps = len(generators)
    flops = (r1_steps * count.train_step_flops(h, b, s, True)
             + (steps - r1_steps) * count.train_step_flops(h, b, s, False))
    bwd = 0.0
    for gen in generators:
        _, mask = _flips_and_masks(gen, m, program_cfg.data.random_flip, b,
                                   s, s, device)
        nv = float(count.valid_keys(mask).sum())
        # two forwards (the fake, G's loss), one backward
        flops += 4 * count.attention_fwd_flops(s, 4 * f, nv)
        bwd += count.attention_bwd_bound_s(s, 4 * f, b, nv)
    return {"model_flops": flops, "attn_bwd_bound_s": bwd}
