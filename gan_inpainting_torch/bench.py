"""Throughput benchmarks, as the JAX package's ``bench`` module defines
them:

* infer — masked images/sec through the generator (normalize → generator
  → composite → denormalize on uint8 batches staged on the device);
* train — G+D train steps/sec of a config, masks drawn in the step.

Used by the CLI (``python -m gan_inpainting_torch bench --mode
infer|train``). Every function runs on the CUDA card unless ``device``
names another device, and raises when there is none.

The names, parameters and returned keys are the JAX module's; the timing
is PyTorch's: the device is synchronized before each read of the clock,
where JAX runs the iterations in one ``lax.scan`` and reads a scalar back.
"""

from __future__ import annotations

import time

import torch

from gan_inpainting_torch.configs.base import Config
from gan_inpainting_torch.data.masks import random_mask_batch
from gan_inpainting_torch.data.pipeline import (
    denormalize,
    make_train_batch,
    normalize,
)
from gan_inpainting_torch.data.synthetic import synthetic_batch_u8
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.parallel.multihost import data_index, world
from gan_inpainting_torch.parallel.sharding import barrier
from gan_inpainting_torch.train.loop import setup_rank
from gan_inpainting_torch.train.state import create_state
from gan_inpainting_torch.train.step import make_train_step
from gan_inpainting_torch.utils.rng import STREAM_MASKS, stream_generator


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for off the
    card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_pool(cfg: Config, batch: int, iters: int,
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` distinct (image, mask) batches on ``device``, in the forms
    a serving request arrives in: (iters, B, S, S, 3) uint8 ``blobs``
    images and (iters, B, S, S, 1) float32 masks of ``cfg.mask`` at full
    difficulty, all drawn from one generator seeded 7."""
    size = cfg.data.image_size
    gen = torch.Generator().manual_seed(7)
    images, masks = [], []
    for _ in range(iters):
        images.append(synthetic_batch_u8(gen, batch, size, device=device))
        masks.append(random_mask_batch(gen, batch, size, size, cfg.mask,
                                       1.0, device=device))
    return torch.stack(images), torch.stack(masks)


def bench_forward(generator: torch.nn.Module, images_u8: torch.Tensor,
                  masks: torch.Tensor) -> torch.Tensor:
    """The timed body of :func:`bench_infer`: the image and mask rounded
    to bf16 before the generator, whatever ``model.dtype_policy`` says
    (unlike ``infer/inpaint.py serve_forward``, which feeds float32), then
    the composite on the raw uint8 input."""
    image = normalize(images_u8).to(torch.bfloat16)
    mask16 = masks.to(torch.bfloat16)
    out = generator(image * (1 - mask16), mask16)
    out_u8 = denormalize(out.fine.float())
    return torch.where(masks <= 0.0, images_u8, out_u8)


def bench_infer(cfg: Config, *, batch: int = 32, iters: int = 10,
                warmup: int = 2,
                device: str | torch.device | None = None) -> dict:
    """Inpaint throughput of the raw (not EMA) generator of
    ``create_state(cfg, seed=0)``, built from ``cfg.model`` as given (no
    serve formulation applied), on ``iters`` distinct batches of
    ``batch`` staged on the device before timing: ``warmup`` untimed
    passes over the pool, then one timed pass. One device per process, so
    ``chips`` is 1."""
    device = resolve_device(device)
    state = create_state(cfg, seed=0, device=device)
    generator = state.generator.eval()
    size = cfg.data.image_size
    with torch.inference_mode():
        images, masks = make_pool(cfg, batch, iters, device)
        for _ in range(warmup):
            for i in range(iters):
                bench_forward(generator, images[i], masks[i])
        _sync(device)
        t0 = time.perf_counter()
        for i in range(iters):
            bench_forward(generator, images[i], masks[i])
        _sync(device)
        dt = time.perf_counter() - t0

    ips = batch * iters / dt
    return {
        "metric": f"{size}x{size} inpaint images/sec/chip",
        "value": ips,
        "unit": "images/sec/chip",
        "total_images_per_sec": ips,
        "batch": batch,
        "chips": 1,
    }


def bench_train(cfg: Config, *, iters: int = 10,
                device: str | torch.device | None = None) -> dict:
    """G+D steps/sec over ``iters`` steps: one untimed run, then the best
    of 3 timed runs. Every run covers steps ``0 … iters-1`` (the step
    counter is reset before it), so the lazy R1 pass falls on the same
    steps in every run, as in JAX's scan from one state; parameters and
    Adam moments carry on from run to run, since only the time is kept.

    Under ``torchrun`` the ranks train as ``train`` does: each data index
    takes its rows of one global uint8 batch (``blobs``, seeded 2) and
    draws its masks of step ``s`` from stream (0, masks, s, its data
    index); the model and spatial axes follow from ``train.mesh``. Every
    run is bracketed by barriers; each rank returns its own time, and the
    CLI prints rank 0's."""
    device, _, local_batch, _, state = setup_rank(cfg, device, seed=0)
    train_step = make_train_step(cfg)

    size = cfg.data.image_size
    images = synthetic_batch_u8(torch.Generator().manual_seed(2),
                                cfg.data.batch_size, size, device=device)
    lo = data_index() * local_batch
    images = images[lo:lo + local_batch]

    def run() -> float:
        state.step = 0
        barrier()
        _sync(device)
        t0 = time.perf_counter()
        for step in range(iters):
            batch = make_train_batch(
                images, stream_generator(0, STREAM_MASKS, step,
                                         extra=data_index()), cfg.mask)
            train_step(state, batch)
        _sync(device)
        barrier()
        return time.perf_counter() - t0

    run()                                   # untimed: cuDNN's search
    dt = min(run() for _ in range(3))
    sps = iters / dt
    return {
        "metric": "G+D train steps/sec",
        "value": sps,
        "unit": "steps/sec",
        "images_per_sec": sps * cfg.data.batch_size,
        "batch": cfg.data.batch_size,
        "chips": world(),
    }


def run_bench(cfg: Config, mode: str = "infer",
              device: str | torch.device | None = None) -> dict:
    if mode == "infer":
        return bench_infer(cfg, device=device)
    if mode == "train":
        return bench_train(cfg, device=device)
    raise ValueError(f"unknown bench mode {mode!r}")
