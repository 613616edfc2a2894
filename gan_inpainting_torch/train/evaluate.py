"""Eval loop: mean PSNR / SSIM of the composited output on held-out
batches (the eval split of ``data.dataset``) with fresh masks drawn from
the run's seed, and the multi-scale SWD (metrics/swd.py) over the pooled
composites when ``eval.metrics`` asks for ``swd``."""

from __future__ import annotations

import torch

from gan_inpainting_torch.configs.base import Config
from gan_inpainting_torch.data.loader import make_dataset
from gan_inpainting_torch.data.pipeline import Batch, make_train_batch
from gan_inpainting_torch.metrics.image import psnr, ssim
from gan_inpainting_torch.metrics.swd import swd
from gan_inpainting_torch.models.generator import build_generator
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.train.step import composite
from gan_inpainting_torch.utils.rng import STREAM_EVAL, stream_generator

_METRIC_FNS = {"psnr": psnr, "ssim": ssim}


def make_eval_step(cfg: Config, device: str | torch.device | None = None):
    """``eval_step(g_state_dict, batch) -> {metric: sum over the batch}``
    on a generator of its own, so evaluating the EMA never touches the
    training modules. With ``swd`` in ``eval.metrics`` the result also
    holds ``_composite``, the composited images as float16 (the SWD
    descriptors are normalized anyway), for :func:`evaluate` to pool.
    ``eval_step.generator`` is that generator module (the loop's sample
    grid runs it too)."""
    names = tuple(cfg.eval.metrics)
    unknown = [n for n in names if n not in _METRIC_FNS and n != "swd"]
    if unknown:
        raise ValueError(f"unknown eval metrics {unknown}; "
                         f"have {sorted(_METRIC_FNS) + ['swd']}")
    scalar_names = tuple(n for n in names if n in _METRIC_FNS)
    want_swd = "swd" in names
    gen = build_generator(cfg.model, device=device, seed=None)
    gen.eval()

    @torch.no_grad()
    def eval_step(g_state_dict, batch: Batch) -> dict[str, torch.Tensor]:
        gen.load_state_dict(g_state_dict)
        out = gen(batch.masked, batch.mask)
        comp = composite(out.fine, batch.image, batch.mask).float()
        res = {n: torch.sum(_METRIC_FNS[n](comp, batch.image))
               for n in scalar_names}
        if want_swd:
            res["_composite"] = comp.to(torch.float16)
        return res

    eval_step.generator = gen
    return eval_step


def evaluate(cfg: Config, g_state_dict, seed: int = 0, eval_step=None,
             device: str | torch.device | None = None) -> dict[str, float]:
    """Mean metrics over ``data.num_eval_batches`` held-out batches; with
    ``swd`` asked for, ``swd_<res>`` per pyramid level and ``swd_avg``
    over the first ``eval.swd_max_images`` composites against their
    ground truth, the draws from a generator seeded ``seed + 1234``."""
    device = resolve_device(device)
    if eval_step is None:
        eval_step = make_eval_step(cfg, device)
    it = make_dataset(cfg.data, seed=cfg.train.seed, split="eval",
                      device=device)
    sums: dict[str, float] = {}
    count = 0
    swd_cap = cfg.eval.swd_max_images
    reals: list[torch.Tensor] = []
    comps: list[torch.Tensor] = []
    for i in range(cfg.data.num_eval_batches):
        batch = make_train_batch(
            next(it), stream_generator(seed + 777, STREAM_EVAL, i), cfg.mask)
        for name, value in eval_step(g_state_dict, batch).items():
            if name == "_composite":
                if sum(c.shape[0] for c in comps) < swd_cap:
                    comps.append(value)
                    reals.append(batch.image.to(torch.float16))
                continue
            sums[name] = sums.get(name, 0.0) + float(value)
        count += cfg.data.eval_batch_size
    it.close()                  # a folder stream's decoder threads end here
    out = {name: total / count for name, total in sums.items()}
    if comps:
        real = torch.cat(reals)[:swd_cap].float()
        fake = torch.cat(comps)[:swd_cap].float()
        gen = torch.Generator(device=device).manual_seed(seed + 1234)
        out.update({k: float(v) for k, v in swd(real, fake, gen).items()})
    return out
