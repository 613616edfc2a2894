"""The alternating D/G train step.

    train_step(state, batch) -> metrics        (updates ``state`` in place)

Order, as in the JAX package: G forward without gradient → D step on the
batch-concatenated (real, fake) pass, whose spectral-norm vectors move
exactly once → R1 on the real images on every k-th step, weighted γ·k →
G step against the *updated* D (adversarial + L1, optional TV and feature
matching) → EMA of the generator. Metrics come back as 0-d tensors on the
device, so a step does not wait for the card.
"""

from __future__ import annotations

from typing import Callable

import torch

from gan_inpainting_torch.configs.base import Config
from gan_inpainting_torch.data.pipeline import Batch
from gan_inpainting_torch.losses import adversarial
from gan_inpainting_torch.losses.reconstruction import l1_loss, tv_loss
from gan_inpainting_torch.ops.dispatch import section
from gan_inpainting_torch.train.state import (
    GANTrainState,
    clip_by_global_norm,
    make_lr_schedule,
)


def composite(fine: torch.Tensor, image: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Paste the generated hole into the known image."""
    mask = mask.to(fine.dtype)
    return fine * mask + image.to(fine.dtype) * (1.0 - mask)


def _micro(batch: Batch, accum: int) -> list[Batch]:
    return [Batch(*parts) for parts in zip(*(t.chunk(accum) for t in batch))]


def make_train_step(cfg: Config) -> Callable[[GANTrainState, Batch], dict]:
    """Build the train step of a config."""
    if cfg.loss.perceptual_weight > 0 or cfg.loss.style_weight > 0:
        raise NotImplementedError(
            "loss.perceptual_weight / loss.style_weight > 0: the VGG "
            "perceptual and style losses are not ported yet (ROADMAP Queue "
            "1: losses/perceptual.py)")
    lc, tc = cfg.loss, cfg.train
    adv_kind = lc.adversarial
    accum = tc.grad_accum
    g_lr = make_lr_schedule(cfg, tc.g_lr)
    d_lr = make_lr_schedule(cfg, tc.d_lr)
    r1_every = max(lc.r1_interval, 1)
    zero = torch.zeros((), dtype=torch.float32)

    def d_loss_terms(state: GANTrainState, mb: Batch, fake: torch.Tensor):
        disc = state.discriminator
        r1 = zero.to(mb.image.device)
        reg = None
        if lc.r1_gamma > 0 and state.step % r1_every == 0:
            # lazy R1: the grad-of-grad pass runs on every k-th step only,
            # with γ·k keeping the expected pressure equal. It reads the
            # spectral vectors before this step's update, so it comes first
            r1 = adversarial.r1_penalty(lambda x: disc(x, mb.mask), mb.image)
            reg = (lc.r1_gamma * r1_every) * r1
        both = torch.cat([mb.image, fake], 0)
        masks2 = torch.cat([mb.mask, mb.mask], 0)
        logits = disc(both, masks2, update_stats=True)
        real_logits, fake_logits = logits.chunk(2, 0)
        loss = adversarial.d_loss(real_logits, fake_logits, adv_kind)
        if reg is not None:
            loss = loss + reg
        return loss, {"d_loss": loss, "d_real": real_logits.mean(),
                      "d_fake": fake_logits.mean(), "d_r1": r1}

    def g_loss_terms(state: GANTrainState, mb: Batch):
        """G total loss and its parts on one (micro-)batch, D frozen."""
        disc = state.discriminator
        gen = state.generator(mb.masked, mb.mask)
        comp = composite(gen.fine, mb.image, mb.mask)
        use_fm = lc.feature_match_weight > 0
        if use_fm:
            logits, fake_feats = disc(comp, mb.mask, return_features=True)
            with torch.no_grad():
                _, real_feats = disc(mb.image, mb.mask, return_features=True)
        else:
            logits = disc(comp, mb.mask)
        adv = adversarial.g_loss(logits, adv_kind)
        l1_args = dict(hole_weight=lc.l1_hole_weight,
                       valid_weight=lc.l1_valid_weight,
                       discount_gamma=lc.spatial_discount)
        rec = l1_loss(gen.fine, mb.image, mb.mask, **l1_args)
        if gen.coarse is not None:
            rec = rec + l1_loss(gen.coarse, mb.image, mb.mask, **l1_args)
        total = lc.gan_weight * adv + lc.l1_weight * rec
        none = zero.to(rec.device)
        aux = {"g_adv": adv, "g_l1": rec, "g_perceptual": none,
               "g_style": none}
        if lc.tv_weight > 0:
            tv = tv_loss(comp, mb.mask)
            total = total + lc.tv_weight * tv
            aux["g_tv"] = tv
        if use_fm:
            fm = sum(torch.mean(torch.abs(ff.float() - rf.float()))
                     for ff, rf in zip(fake_feats, real_feats))
            fm = fm / len(fake_feats)
            total = total + lc.feature_match_weight * fm
            aux["g_fm"] = fm
        aux["g_loss"] = total
        return total, aux

    def apply(opt: torch.optim.Adam, params, grads, lr: float) -> None:
        if accum > 1:
            torch._foreach_div_(grads, accum)
        if tc.grad_clip > 0:
            clip_by_global_norm(grads, tc.grad_clip)
        for p, g in zip(params, grads):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)

    def add(total, grads):
        if total is None:
            return list(grads)
        torch._foreach_add_(total, grads)
        return total

    def mean_metrics(parts: list[dict]) -> dict:
        return {k: torch.stack([p[k] for p in parts]).mean()
                for k in parts[0]}

    def step(state: GANTrainState, batch: Batch) -> dict:
        if batch.image.shape[0] % accum:
            raise ValueError(f"train.grad_accum={accum} does not divide "
                             f"batch size {batch.image.shape[0]}")
        gen, disc = state.generator, state.discriminator
        g_params = list(gen.parameters())
        d_params = list(disc.parameters())
        mbs = _micro(batch, accum) if accum > 1 else [batch]

        # ---------------- D step ------------------------------------------
        # under accumulation the spectral vectors advance once per
        # micro-batch, the one difference from the full-batch step
        d_grads, d_parts = None, []
        for mb in mbs:
            with torch.no_grad(), section("g_forward_detached"):
                out = gen(mb.masked, mb.mask)
                fake = composite(out.fine, mb.image, mb.mask)
            with section("d_step"):
                loss, aux = d_loss_terms(state, mb, fake)
                d_grads = add(d_grads, torch.autograd.grad(loss, d_params))
            d_parts.append({k: v.detach() for k, v in aux.items()})
        with section("optimizer"):
            apply(state.d_opt, d_params, d_grads, d_lr(state.step))

        # ---------------- G step, against the updated D -------------------
        g_grads, g_parts = None, []
        for mb in mbs:
            with section("g_forward"):
                total, aux = g_loss_terms(state, mb)
            with section("g_backward"):
                g_grads = add(g_grads, torch.autograd.grad(total, g_params))
            g_parts.append({k: v.detach() for k, v in aux.items()})
        with section("optimizer"):
            apply(state.g_opt, g_params, g_grads, g_lr(state.step))

        if tc.g_ema_decay > 0:
            with torch.no_grad(), section("optimizer"):
                ema = [state.g_ema[k] for k in gen.state_dict()]
                torch._foreach_mul_(ema, tc.g_ema_decay)
                torch._foreach_add_(ema, list(gen.state_dict().values()),
                                    alpha=1.0 - tc.g_ema_decay)
        state.step += 1
        metrics = {**mean_metrics(d_parts), **mean_metrics(g_parts)}
        if lc.r1_gamma <= 0:
            del metrics["d_r1"]
        return metrics

    return step
