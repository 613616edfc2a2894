"""The alternating D/G train step.

    train_step(state, batch) -> metrics        (updates ``state`` in place)

Order, as in the JAX package: G forward without gradient → D step on the
batch-concatenated (real, fake) pass, whose spectral-norm vectors move
exactly once → R1 on the real images on every k-th step, weighted γ·k →
G step against the *updated* D (adversarial + L1, optional VGG perceptual
and style, TV and feature matching) → EMA of the generator. Metrics come
back as 0-d tensors on the device, so a step does not wait for the card.

Under data parallelism each rank runs the step on its slice of the global
batch; the gradients are averaged over ranks once per optimizer step
(``parallel/sharding.py``), and the L1 and TV losses divide by the global
batch's normalizers, so the ranks step as one process would on the whole
batch. The metrics stay the rank's own. Over a model axis the gradients
are first reduced over the model group: those of the channel-sharded
convs' weights (``model.tp_shard``), each nonzero on its member's rows
only, summed, every other one averaged, so every member holds the same
whole gradient before the mean over the data axis.

Over the spatial axis (``train.mesh.spatial`` = n, parallel/spatial.py)
the members of a spatial group share the batch slice and each cuts its
row band of ``image``, ``mask`` and ``masked`` from it; the generator,
the discriminator and the VGG trunk run on the bands (their exchanges
carry gradients), and every loss is the band's partial sum over the
whole map's normalizers (losses/). Each member's gradient is then its
band's part, and the group's sum is the whole gradient: the sum goes
before the mean over the data axis and before the clip. The metrics are
summed over the group, so every member returns the whole batch's. Where
some layer has no band form at the batch's size
(:func:`band_multiple`), the step runs unsharded on every member, is counted
(``unsharded_steps``) and the group averages its gradients, the JAX
package's ``shard_batch`` rule of sharding only what divides.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from gan_inpainting_torch.configs.base import Config
from gan_inpainting_torch.data.pipeline import Batch
from gan_inpainting_torch.losses import adversarial
from gan_inpainting_torch.losses.perceptual import (
    init_vgg,
    perceptual_and_style_loss,
)
from gan_inpainting_torch.losses.reconstruction import l1_loss, tv_loss
from gan_inpainting_torch.models.generator import sliced_parameters
from gan_inpainting_torch.parallel.sharding import (
    _count,
    all_reduce_mean_,
    reduce_over_model_,
    spatial_group,
)
from gan_inpainting_torch.parallel.spatial import band, row_bands, splits
from gan_inpainting_torch.train.state import (
    GANTrainState,
    clip_by_global_norm,
    make_lr_schedule,
)
from gan_inpainting_torch.utils.spans import section, transfer


def composite(fine: torch.Tensor, image: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Paste the generated hole into the known image."""
    mask = mask.to(fine.dtype)
    return fine * mask + image.to(fine.dtype) * (1.0 - mask)


def _micro(batch: Batch, accum: int) -> list[Batch]:
    return [Batch(*parts) for parts in zip(*(t.chunk(accum) for t in batch))]


def band_multiple(cfg: Config) -> int:
    """The rows each band of a train step must be a multiple of
    (:func:`~gan_inpainting_torch.parallel.spatial.splits`): the
    generators halve the rows twice (and the mask at 1/4 must stay
    aligned), the discriminator ``disc_layers`` times and the VGG trunk's
    pools three times, each on even bands."""
    need = max(4, 2 ** cfg.model.disc_layers)
    if cfg.loss.perceptual_weight > 0 or cfg.loss.style_weight > 0:
        need = max(need, 8)
    return need


def make_train_step(cfg: Config) -> Callable[[GANTrainState, Batch], dict]:
    """Build the train step of a config."""
    lc, tc = cfg.loss, cfg.train
    use_vgg = lc.perceptual_weight > 0 or lc.style_weight > 0
    if use_vgg and not lc.vgg_weights_path:
        warnings.warn(
            "perceptual/style loss enabled but loss.vgg_weights_path is "
            "empty: falling back to a fixed-seed randomly initialized VGG "
            "(test-only behavior). Set the path of a converted VGG16 .npz "
            "for training.", stacklevel=2)
    vggs: dict[torch.device, torch.nn.Module] = {}

    def vgg_on(device: torch.device):
        # built at the first step, on the device the batch lives on
        if device not in vggs:
            vggs[device] = init_vgg(lc.vgg_weights_path, device=device)
        return vggs[device]

    adv_kind = lc.adversarial
    accum = tc.grad_accum
    g_lr = make_lr_schedule(cfg, tc.g_lr)
    d_lr = make_lr_schedule(cfg, tc.d_lr)
    r1_every = max(lc.r1_interval, 1)
    zero = torch.zeros((), dtype=torch.float32)

    def d_loss_terms(state: GANTrainState, mb: Batch, fake: torch.Tensor,
                     n: int):
        disc = state.discriminator
        r1 = transfer(zero, mb.image.device)
        reg = None
        if lc.r1_gamma > 0 and state.step % r1_every == 0:
            # lazy R1: the grad-of-grad pass runs on every k-th step only,
            # with γ·k keeping the expected pressure equal. It reads the
            # spectral vectors before this step's update, so it comes first
            with section("r1"):
                r1 = adversarial.r1_penalty(lambda x: disc(x, mb.mask),
                                            mb.image)
            reg = (lc.r1_gamma * r1_every) * r1
        both = torch.cat([mb.image, fake], 0)
        masks2 = torch.cat([mb.mask, mb.mask], 0)
        logits = disc(both, masks2, update_stats=True)
        real_logits, fake_logits = logits.chunk(2, 0)
        loss = adversarial.d_loss(real_logits, fake_logits, adv_kind, n)
        if reg is not None:
            loss = loss + reg
        return loss, {"d_loss": loss,
                      "d_real": adversarial.band_mean(real_logits, n),
                      "d_fake": adversarial.band_mean(fake_logits, n),
                      "d_r1": r1}

    def g_loss_terms(state: GANTrainState, mb: Batch, whole_mask, bands):
        """G total loss and its parts on one (micro-)batch, D frozen; on
        this member's row band with ``bands`` (``whole_mask`` the
        micro-batch's whole mask)."""
        disc = state.discriminator
        n = 1 if bands is None else bands.size
        gen = state.generator(mb.masked, mb.mask)
        comp = composite(gen.fine, mb.image, mb.mask)
        use_fm = lc.feature_match_weight > 0
        if use_fm:
            logits, fake_feats = disc(comp, mb.mask, return_features=True)
            with torch.no_grad():
                _, real_feats = disc(mb.image, mb.mask, return_features=True)
        else:
            logits = disc(comp, mb.mask)
        adv = adversarial.g_loss(logits, adv_kind, n)
        l1_args = dict(hole_weight=lc.l1_hole_weight,
                       valid_weight=lc.l1_valid_weight,
                       discount_gamma=lc.spatial_discount, bands=bands,
                       whole_mask=whole_mask)
        rec = l1_loss(gen.fine, mb.image, mb.mask, **l1_args)
        if gen.coarse is not None:
            rec = rec + l1_loss(gen.coarse, mb.image, mb.mask, **l1_args)
        perc = style = transfer(zero, rec.device)
        if use_vgg:
            perc, style = perceptual_and_style_loss(
                vgg_on(comp.device), comp, mb.image, bands)
        total = (lc.gan_weight * adv + lc.l1_weight * rec
                 + lc.perceptual_weight * perc + lc.style_weight * style)
        aux = {"g_adv": adv, "g_l1": rec, "g_perceptual": perc,
               "g_style": style}
        if lc.tv_weight > 0:
            tv = tv_loss(comp, mb.mask, bands=bands, whole_mask=whole_mask)
            total = total + lc.tv_weight * tv
            aux["g_tv"] = tv
        if use_fm:
            fm = sum(adversarial.band_mean(torch.abs(ff.float()
                                                     - rf.float()), n)
                     for ff, rf in zip(fake_feats, real_feats))
            fm = fm / len(fake_feats)
            total = total + lc.feature_match_weight * fm
            aux["g_fm"] = fm
        aux["g_loss"] = total
        return total, aux

    def apply(opt: torch.optim.Adam, params, grads, lr: float,
              banded: bool, sliced=()) -> None:
        # the model group's gradient (the sliced weights' whole one),
        # then the spatial group's sum and the mean over the data axis, so
        # that the clip reads the global batch's norm, as GSPMD's
        # all-reduce gives it in the JAX step
        reduce_over_model_(grads, [id(p) in sliced for p in params])
        all_reduce_mean_(grads, bands_summed=banded)
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

    group = spatial_group()           # this rank's, made by create_state

    def step(state: GANTrainState, batch: Batch) -> dict:
        if batch.image.shape[0] % accum:
            raise ValueError(f"train.grad_accum={accum} does not divide "
                             f"batch size {batch.image.shape[0]}")
        gen, disc = state.generator, state.discriminator
        g_params = list(gen.parameters())
        d_params = list(disc.parameters())
        mbs = _micro(batch, accum) if accum > 1 else [batch]
        bands = group
        if group is not None and not splits(
                batch.image.shape[1], group.size, band_multiple(cfg)):
            bands = None
            _count("unsharded_steps")
        n = 1 if bands is None else bands.size
        # (this member's row bands, the whole mask) of each micro-batch
        mbs = [(Batch(*(band(t, bands) for t in mb)), mb.mask)
               for mb in mbs]

        with row_bands(bands, gen, disc):
            # ---------------- D step --------------------------------------
            # under accumulation the spectral vectors advance once per
            # micro-batch, the one difference from the full-batch step
            d_grads, d_parts = None, []
            for mb, _ in mbs:
                with torch.no_grad(), section("g_forward_detached"):
                    out = gen(mb.masked, mb.mask)
                    fake = composite(out.fine, mb.image, mb.mask)
                with section("d_step"):
                    loss, aux = d_loss_terms(state, mb, fake, n)
                    d_grads = add(d_grads,
                                  torch.autograd.grad(loss, d_params))
                d_parts.append({k: v.detach() for k, v in aux.items()})
            with section("d_optimizer"):
                apply(state.d_opt, d_params, d_grads, d_lr(state.step),
                      bands is not None)

            # ---------------- G step, against the updated D ---------------
            g_grads, g_parts = None, []
            for mb, whole_mask in mbs:
                with section("g_forward"):
                    total, aux = g_loss_terms(state, mb, whole_mask, bands)
                with section("g_backward"):
                    g_grads = add(g_grads,
                                  torch.autograd.grad(total, g_params))
                g_parts.append({k: v.detach() for k, v in aux.items()})
        with section("g_optimizer"):
            apply(state.g_opt, g_params, g_grads, g_lr(state.step),
                  bands is not None, {id(p) for p in sliced_parameters(gen)})

        if tc.g_ema_decay > 0:
            with torch.no_grad(), section("ema"):
                ema = [state.g_ema[k] for k in gen.state_dict()]
                torch._foreach_mul_(ema, tc.g_ema_decay)
                torch._foreach_add_(ema, list(gen.state_dict().values()),
                                    alpha=1.0 - tc.g_ema_decay)
        state.step += 1
        metrics = {**mean_metrics(d_parts), **mean_metrics(g_parts)}
        if lc.r1_gamma <= 0:
            del metrics["d_r1"]
        if bands is not None:
            # the bands' partial sums → the whole batch's values
            total = torch.stack([v.float() for v in metrics.values()])
            bands.all_reduce_(total)
            metrics = dict(zip(metrics, total.unbind()))
        return metrics

    return step
