"""Training loop: data, step, periodic logging / eval / sample grids /
checkpoints, and resume from the latest checkpoint. All math lives in the
step.

Every random draw of step ``n`` (data batch, crop, flip, masks) comes from
a generator derived from (seed, stream, n), so a resumed run continues
exactly as the uninterrupted one would. Under data parallelism each data
index derives its own: its data stream from ``seed + index · 1 000 003``,
its masks with ``extra = index``, shared by its model and spatial peers;
data index 0 draws what a single process draws.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import NamedTuple

import numpy as np
import torch

from gan_inpainting_torch.configs.base import Config
from gan_inpainting_torch.data.loader import make_dataset
from gan_inpainting_torch.data.pipeline import denormalize, make_train_batch
from gan_inpainting_torch.io.checkpoint import CheckpointManager
from gan_inpainting_torch.io.metrics_writer import MetricsWriter
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.parallel.multihost import (
    data_index,
    ensure_initialized,
    initialized,
    is_main,
    model_size,
    process_batch_slice,
    spatial_size,
)
from gan_inpainting_torch.parallel.sharding import (
    barrier,
    counts,
    reduce_metrics,
    use_mesh,
)
from gan_inpainting_torch.train.evaluate import evaluate, make_eval_step
from gan_inpainting_torch.train.state import (
    GANTrainState,
    broadcast_state,
    create_state,
    ema_generator_params,
    warm_start,
)
from gan_inpainting_torch.train.step import composite, make_train_step
from gan_inpainting_torch.utils.rng import (
    STREAM_EVAL,
    STREAM_MASKS,
    stream_generator,
)


class RankSetup(NamedTuple):
    device: torch.device
    n_ranks: int
    local_batch: int    # this rank's rows of ``data.batch_size``
    seed_offset: int    # added to ``train.seed`` for its data stream
    state: GANTrainState


def setup_rank(cfg: Config, device: str | torch.device | None = None,
               seed: int | None = None) -> RankSetup:
    """This rank's side of a training run, as ``train`` and
    ``bench.bench_train`` start one: the device (CUDA unless the caller
    asks for another), the process group where ``torchrun`` launched one,
    ``train.mesh``'s groups, this rank's slice of the global batch, and
    the state drawn from ``seed`` (``train.seed`` when None)."""
    device = resolve_device(device)
    n_ranks = ensure_initialized(device)
    use_mesh(cfg.train.mesh)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)   # the eager ops between the kernels
    # each rank feeds its slice of the global batch from a stream of its
    # own; one process takes the whole batch with the seed untouched
    local_batch, seed_offset = process_batch_slice(cfg.data.batch_size)
    state = create_state(cfg, seed=seed, device=device)
    return RankSetup(device, n_ranks, local_batch, seed_offset, state)


def train(cfg: Config, *, resume: bool = True, verbose: bool = True,
          device: str | torch.device | None = None):
    """Run ``cfg.train.steps`` of GAN training on ``device`` (CUDA unless
    the caller asks for another; under ``torchrun``, this rank's card);
    returns (state, last metrics as floats). Scalars stream to
    ``<workdir>/metrics.jsonl`` and, with the sample grid of every eval, to
    TensorBoard under ``<workdir>/tb`` where it imports
    (io/metrics_writer.py).

    Over several ranks (a ``torchrun`` launch, or a process group the
    caller set up) each rank trains its slice of ``data.batch_size`` from
    data and mask streams of its own, the gradients averaged over ranks;
    logged metrics and evals are reduced over ranks, and only rank 0
    writes (record, samples, checkpoints) and prints. ``train.mesh`` must
    cover the world as ``data × model`` (``create_state``); the ranks of a
    model group train the same slice, the generator channel-sharded over
    them under ``model.tp_shard``, and the record then also counts the
    channel gathers and the bytes they all-reduce. The ranks of a spatial
    group train the same slice too, each on its row bands
    (train/step.py); the record then counts the row exchanges, their
    bytes and the steps that ran unsharded, and the sample grid holds the
    whole images."""
    device, n_ranks, local_batch, seed_offset, state = setup_rank(
        cfg, device)
    main = is_main()
    verbose = verbose and main
    ckpt = CheckpointManager(cfg.train.workdir, cfg.train.max_checkpoints)
    barrier()                   # no rank looks before every rank is here
    if resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        broadcast_state(state)
        if verbose:
            print(f"[train] resumed from step {state.step}")
    elif cfg.train.init_from:
        warm_start(state, cfg)
        if verbose:
            print(f"[train] warm-started params from {cfg.train.init_from}")
    if verbose and initialized():
        print(f"[train] data parallel over {n_ranks} rank(s), "
              f"{local_batch} images each, model axis {model_size()}, "
              f"spatial axis {spatial_size()}, "
              f"backend {torch.distributed.get_backend()}")

    # best-eval-PSNR retention: a second single-slot manager and a small
    # json of the best metrics; every rank reads the same reduced eval, so
    # all agree on a new best, and rank 0 writes it
    track_best = cfg.train.keep_best and "psnr" in cfg.eval.metrics
    best_ckpt = best_path = None
    best_psnr = float("-inf")
    if track_best:
        best_ckpt = CheckpointManager(cfg.train.workdir, max_to_keep=1,
                                      subdir="checkpoints_best")
        best_path = pathlib.Path(cfg.train.workdir) / "best.json"
        if resume and best_path.exists():
            best_psnr = json.loads(best_path.read_text()).get(
                "psnr", float("-inf"))

    writer = MetricsWriter(cfg.train.workdir) if main else None
    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg, device)
    data = make_dataset(cfg.data, seed=cfg.train.seed + seed_offset,
                        split="train", batch_size=local_batch, device=device,
                        start=state.step)
    scalars: dict[str, float] = {}
    t_last = time.perf_counter()
    steps_since_log = 0
    reduces_before = counts["all_reduce_mean_"]
    gathers_before = {k: counts[k] for k in _GATHER_COUNTS + _ROW_COUNTS}
    # the channel gathers since the last log
    window = dict(counts, _step=state.step)
    cur_steps = cfg.mask.curriculum_steps
    try:
        for step in range(state.step, cfg.train.steps):
            progress = min(1.0, step / cur_steps) if cur_steps else 1.0
            batch = make_train_batch(
                next(data), stream_generator(cfg.train.seed, STREAM_MASKS,
                                             step, extra=data_index()),
                cfg.mask, progress, flip=cfg.data.random_flip,
                crop=cfg.data.image_size if cfg.data.random_crop else 0)
            metrics = train_step(state, batch)
            steps_since_log += 1

            next_step = step + 1
            last = next_step == cfg.train.steps
            if next_step % cfg.train.log_every == 0 or last:
                scalars = reduce_metrics(metrics)
                now = time.perf_counter()    # the values above waited
                sps = steps_since_log / max(now - t_last, 1e-9)
                t_last, steps_since_log = now, 0
                scalars["steps_per_sec"] = sps
                scalars["images_per_sec"] = sps * cfg.data.batch_size
                if initialized():
                    scalars["world_size"] = n_ranks
                    scalars["grad_all_reduces"] = (
                        counts["all_reduce_mean_"] - reduces_before)
                if model_size() > 1:
                    scalars["model_axis"] = model_size()
                    scalars.update({k: counts[k] - gathers_before[k]
                                    for k in _GATHER_COUNTS})
                    scalars["channel_gather_bytes_per_step"] = (
                        counts["channel_gather_bytes"]
                        - window["channel_gather_bytes"]) / max(
                        next_step - window["_step"], 1)
                if spatial_size() > 1:
                    scalars["spatial_axis"] = spatial_size()
                    scalars.update({k: counts[k] - gathers_before[k]
                                    for k in _ROW_COUNTS})
                    scalars["row_exchange_bytes_per_step"] = sum(
                        counts[k] - window[k] for k in _ROW_BYTES) / max(
                        next_step - window["_step"], 1)
                # blocking host <-> device copies of the batch and the step
                scalars["host_syncs_per_step"] = (
                    counts["host_syncs"] - window["host_syncs"]) / max(
                    next_step - window["_step"], 1)
                window = dict(counts, _step=next_step)
                if main:
                    writer.scalars(next_step, scalars)
                if verbose:
                    msg = " ".join(f"{k}={v:.4g}" for k, v in scalars.items())
                    print(f"[train] step {next_step}: {msg}")

            if next_step % cfg.train.eval_every == 0 or last:
                ev = evaluate(cfg, ema_generator_params(state),
                              eval_step=eval_step, device=device)
                if main:
                    writer.scalars(next_step,
                                   {f"eval_{k}": v for k, v in ev.items()})
                if verbose:
                    print(f"[train] eval@{next_step}: {ev}")
                if track_best and ev.get("psnr", float("-inf")) > best_psnr:
                    best_psnr = ev["psnr"]
                    if main:
                        best_ckpt.save(next_step, state, cfg)
                        best_path.write_text(json.dumps(
                            {"step": next_step, **ev}, indent=2) + "\n")
                    if verbose:
                        print(f"[train] new best psnr {best_psnr:.3f} "
                              f"@ {next_step} -> checkpoints_best")
                if main or (cfg.model.tp_shard and model_size() > 1
                            or spatial_size() > 1):
                    # a sharded generator's model and spatial peers join
                    # its exchanges
                    _dump_samples(cfg, state, writer, next_step, eval_step,
                                  device)
                # the window counts the train steps' exchanges, not the
                # eval's
                window = dict(counts, _step=next_step)

            if next_step % cfg.train.checkpoint_every == 0 or last:
                if main:
                    ckpt.save(next_step, state, cfg)
                barrier()       # the file is whole before any rank reads it
    finally:
        data.close()            # a folder stream's decoder threads end here
        if writer is not None:
            writer.close()
    return state, scalars


# the model axis's collectives, logged beside grad_all_reduces
_GATHER_COUNTS = ("channel_gathers", "channel_gather_bytes",
                  "input_grad_all_reduces", "model_grad_reduces")
# the spatial axis's row exchanges (parallel/spatial.py), their buffer
# bytes, and the steps that ran unsharded
_ROW_BYTES = ("halo_bytes", "row_gather_bytes", "spill_bytes",
              "row_reduce_bytes", "band_sum_bytes")
_ROW_COUNTS = ("halo_exchanges", "row_gathers", "spill_adds", "row_reduces",
               "band_sums", "unsharded_steps") + _ROW_BYTES


@torch.no_grad()
def _dump_samples(cfg: Config, state, writer: MetricsWriter, step: int,
                  eval_step, device, n: int = 4) -> np.ndarray:
    """Write a (masked | output | composite | target) grid of ``n`` eval
    images (at most an eval batch, which the eval split holds), side by
    side on the width axis, as TensorBoard images, where ``writer`` is
    given; masks from the run's eval stream at ``step``. The EMA generator
    runs on the eval step's module. Returns the (n, H, 4W, 3) uint8
    grid."""
    it = make_dataset(cfg.data, seed=cfg.train.seed, split="eval",
                      batch_size=min(n, cfg.data.eval_batch_size),
                      device=device)
    images = next(it)
    it.close()
    batch = make_train_batch(
        images, stream_generator(cfg.train.seed, STREAM_EVAL, step),
        cfg.mask)
    out = eval_step.generate(ema_generator_params(state), batch).float()
    comp = composite(out, batch.image, batch.mask)
    grid = torch.cat([denormalize(t) for t in (batch.masked, out, comp,
                                               batch.image)], dim=2)
    grid = grid.cpu().numpy()
    if writer is not None:
        writer.images(step, "samples", grid)
    return grid
