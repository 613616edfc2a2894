"""Training loop: data, step, periodic logging / eval / checkpoints, and
resume from the latest checkpoint. All math lives in the step.

Every random draw of step ``n`` (data batch, crop, flip, masks) comes from
a generator derived from (seed, stream, n), so a resumed run continues
exactly as the uninterrupted one would.
"""

from __future__ import annotations

import json
import pathlib
import time

import torch

from gan_inpainting_torch.configs.base import Config
from gan_inpainting_torch.data.loader import make_dataset
from gan_inpainting_torch.data.pipeline import make_train_batch
from gan_inpainting_torch.io.checkpoint import CheckpointManager
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.train.evaluate import evaluate, make_eval_step
from gan_inpainting_torch.train.state import (
    create_state,
    ema_generator_params,
    warm_start,
)
from gan_inpainting_torch.train.step import make_train_step
from gan_inpainting_torch.utils.rng import STREAM_MASKS, stream_generator


def train(cfg: Config, *, resume: bool = True, verbose: bool = True,
          device: str | torch.device | None = None):
    """Run ``cfg.train.steps`` of GAN training on ``device`` (CUDA unless
    the caller asks for another); returns (state, last metrics as floats).
    Scalars stream to ``<workdir>/metrics.jsonl``. Raises for a
    ``train.mesh`` above one device (``create_state``)."""
    device = resolve_device(device)
    state = create_state(cfg, device=device)
    ckpt = CheckpointManager(cfg.train.workdir, cfg.train.max_checkpoints)
    if resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        if verbose:
            print(f"[train] resumed from step {state.step}")
    elif cfg.train.init_from:
        warm_start(state, cfg)
        if verbose:
            print(f"[train] warm-started params from {cfg.train.init_from}")

    # best-eval-PSNR retention: a second single-slot manager and a small
    # json of the best metrics
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

    log = open(pathlib.Path(cfg.train.workdir) / "metrics.jsonl", "a",
               buffering=1)

    def write(step: int, values: dict) -> None:
        log.write(json.dumps({"step": step, "time": time.time(),
                              **values}) + "\n")

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg, device)
    data = make_dataset(cfg.data, seed=cfg.train.seed, split="train",
                        device=device, start=state.step)
    scalars: dict[str, float] = {}
    t_last = time.perf_counter()
    steps_since_log = 0
    cur_steps = cfg.mask.curriculum_steps
    try:
        for step in range(state.step, cfg.train.steps):
            progress = min(1.0, step / cur_steps) if cur_steps else 1.0
            batch = make_train_batch(
                next(data), stream_generator(cfg.train.seed, STREAM_MASKS,
                                             step),
                cfg.mask, progress, flip=cfg.data.random_flip,
                crop=cfg.data.image_size if cfg.data.random_crop else 0)
            metrics = train_step(state, batch)
            steps_since_log += 1

            next_step = step + 1
            last = next_step == cfg.train.steps
            if next_step % cfg.train.log_every == 0 or last:
                scalars = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()    # float() above waited for the card
                sps = steps_since_log / max(now - t_last, 1e-9)
                t_last, steps_since_log = now, 0
                scalars["steps_per_sec"] = sps
                scalars["images_per_sec"] = sps * cfg.data.batch_size
                write(next_step, scalars)
                if verbose:
                    msg = " ".join(f"{k}={v:.4g}" for k, v in scalars.items())
                    print(f"[train] step {next_step}: {msg}")

            if next_step % cfg.train.eval_every == 0 or last:
                ev = evaluate(cfg, ema_generator_params(state),
                              eval_step=eval_step, device=device)
                write(next_step, {f"eval_{k}": v for k, v in ev.items()})
                if verbose:
                    print(f"[train] eval@{next_step}: {ev}")
                if track_best and ev.get("psnr", float("-inf")) > best_psnr:
                    best_psnr = ev["psnr"]
                    best_ckpt.save(next_step, state, cfg)
                    best_path.write_text(json.dumps(
                        {"step": next_step, **ev}, indent=2) + "\n")
                    if verbose:
                        print(f"[train] new best psnr {best_psnr:.3f} "
                              f"@ {next_step} -> checkpoints_best")

            if next_step % cfg.train.checkpoint_every == 0 or last:
                ckpt.save(next_step, state, cfg)
    finally:
        log.close()
    return state, scalars
