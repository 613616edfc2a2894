"""Eval loop: mean PSNR / SSIM of the composited output on held-out
batches (the eval split of ``data.dataset``) with fresh masks drawn from
the run's seed, and the multi-scale SWD (metrics/swd.py) over the pooled
composites when ``eval.metrics`` asks for ``swd``.

Over the mesh's spatial axis the members of a spatial group generate
their row bands of each eval batch (parallel/spatial.py) and gather the
output's rows, so every member holds the whole images and the metrics —
SSIM's windows cross band edges — are the whole images' (counted once,
from spatial index 0). A size whose rows do not split into bands of a
multiple of 4 rows runs whole on every member (``unsharded_forwards``)."""

from __future__ import annotations

import torch

from gan_inpainting_torch.configs.base import Config
from gan_inpainting_torch.data.loader import make_dataset
from gan_inpainting_torch.data.pipeline import Batch, make_train_batch
from gan_inpainting_torch.metrics.image import psnr, ssim
from gan_inpainting_torch.metrics.swd import swd
from gan_inpainting_torch.models.generator import build_generator
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.parallel.multihost import (
    data_index,
    data_size,
    process_batch_slice,
)
from gan_inpainting_torch.parallel.sharding import (
    _count,
    all_gather_rows,
    reduce_metrics,
    spatial_group,
    use_mesh,
)
from gan_inpainting_torch.parallel.spatial import band, row_bands, splits
from gan_inpainting_torch.train.step import composite
from gan_inpainting_torch.utils.rng import STREAM_EVAL, stream_generator

_METRIC_FNS = {"psnr": psnr, "ssim": ssim}


def make_eval_step(cfg: Config, device: str | torch.device | None = None):
    """``eval_step(g_state_dict, batch) -> {metric: sum over the batch}``
    on a generator of its own, so evaluating the EMA never touches the
    training modules. With ``swd`` in ``eval.metrics`` the result also
    holds ``_composite``, the composited images as float16 (the SWD
    descriptors are normalized anyway), for :func:`evaluate` to pool.
    ``eval_step.generator`` is that generator module, and
    ``eval_step.generate(g_state_dict, batch)`` its whole output image
    (the loop's sample grid runs it too). Over ranks it is channel-sharded
    over this rank's model group as the train state's generator is
    (``model.tp_shard``), and over a spatial group it runs on row bands
    and gathers the output's rows (module docstring)."""
    names = tuple(cfg.eval.metrics)
    unknown = [n for n in names if n not in _METRIC_FNS and n != "swd"]
    if unknown:
        raise ValueError(f"unknown eval metrics {unknown}; "
                         f"have {sorted(_METRIC_FNS) + ['swd']}")
    scalar_names = tuple(n for n in names if n in _METRIC_FNS)
    want_swd = "swd" in names
    gen = build_generator(cfg.model, device=device, seed=None,
                          model_group=use_mesh(cfg.train.mesh))
    gen.eval()
    group = spatial_group()

    @torch.no_grad()
    def generate(g_state_dict, batch: Batch) -> torch.Tensor:
        gen.load_state_dict(g_state_dict)
        rows = batch.image.shape[1]
        if group is None:
            return gen(batch.masked, batch.mask).fine
        if not splits(rows, group.size):
            _count("unsharded_forwards")
            return gen(batch.masked, batch.mask).fine
        with row_bands(group, gen):
            fine = gen(band(batch.masked, group),
                       band(batch.mask, group)).fine
        return group.gather_rows(fine)

    @torch.no_grad()
    def eval_step(g_state_dict, batch: Batch) -> dict[str, torch.Tensor]:
        fine = generate(g_state_dict, batch)
        comp = composite(fine, batch.image, batch.mask).float()
        res = {n: torch.sum(_METRIC_FNS[n](comp, batch.image))
               for n in scalar_names}
        if want_swd:
            res["_composite"] = comp.to(torch.float16)
        return res

    eval_step.generator = gen
    eval_step.generate = generate
    return eval_step


def evaluate(cfg: Config, g_state_dict, seed: int = 0, eval_step=None,
             device: str | torch.device | None = None) -> dict[str, float]:
    """Mean metrics over ``data.num_eval_batches`` held-out batches; with
    ``swd`` asked for, ``swd_<res>`` per pyramid level and ``swd_avg``
    over the first ``eval.swd_max_images`` composites against their
    ground truth, the draws from a generator seeded ``seed + 1234``.

    Over several ranks each data index evaluates its slice of every eval
    batch from data and mask streams of its own (index 0's are one
    process's), which its model peers share; the metric sums are added
    over the data axis, so the means cover every slice's images once, and
    the SWD pools the first ⌈cap / data⌉ composites of each data index,
    gathered in data order and cut to the cap. The members of a spatial
    group share their data index's slice and compute its row bands
    (module docstring). Every rank returns the same numbers."""
    device = resolve_device(device)
    use_mesh(cfg.train.mesh)
    if eval_step is None:
        eval_step = make_eval_step(cfg, device)
    local_bs, seed_offset = process_batch_slice(cfg.data.eval_batch_size)
    it = make_dataset(cfg.data, seed=cfg.train.seed + seed_offset,
                      split="eval", batch_size=local_bs, device=device)
    sums: dict[str, float] = {}
    count = 0
    swd_cap = cfg.eval.swd_max_images
    local_cap = -(-swd_cap // data_size())
    reals: list[torch.Tensor] = []
    comps: list[torch.Tensor] = []
    for i in range(cfg.data.num_eval_batches):
        batch = make_train_batch(
            next(it), stream_generator(seed + 777, STREAM_EVAL, i,
                                       extra=data_index()), cfg.mask)
        for name, value in eval_step(g_state_dict, batch).items():
            if name == "_composite":
                if sum(c.shape[0] for c in comps) < local_cap:
                    comps.append(value)
                    reals.append(batch.image.to(torch.float16))
                continue
            sums[name] = sums.get(name, 0.0) + float(value)
        count += cfg.data.eval_batch_size
    it.close()                  # a folder stream's decoder threads end here
    sums = reduce_metrics(sums, average=False)
    out = {name: total / count for name, total in sums.items()}
    if comps:
        real = all_gather_rows(torch.cat(reals)[:local_cap])[:swd_cap]
        fake = all_gather_rows(torch.cat(comps)[:local_cap])[:swd_cap]
        gen = torch.Generator(device=device).manual_seed(seed + 1234)
        out.update({k: float(v) for k, v in
                    swd(real.float(), fake.float(), gen).items()})
    return out
