"""Train state: both networks, both Adams, spectral-norm vectors, the EMA
generator and the step count — everything a train step changes, in one
object that checkpoints as one ``state_dict``.

PyTorch idiom: the step updates the state in place (modules, optimizer
moments, EMA tensors), where the JAX package returns a new pytree.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Callable

import torch
from torch import nn

from gan_inpainting_torch.configs.base import Config
from gan_inpainting_torch.models.discriminator import build_discriminator
from gan_inpainting_torch.models.generator import build_generator
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.parallel.mesh import train_mesh
from gan_inpainting_torch.parallel.multihost import world
from gan_inpainting_torch.parallel.sharding import (
    broadcast_module_state,
    use_mesh,
)


@dataclasses.dataclass
class GANTrainState:
    step: int
    generator: nn.Module
    discriminator: nn.Module      # its SNConv ``u`` buffers are the SN state
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    g_ema: dict[str, torch.Tensor]    # {} when train.g_ema_decay == 0

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "g_params": self.generator.state_dict(),
            "d_params": self.discriminator.state_dict(),
            "g_opt": self.g_opt.state_dict(),
            "d_opt": self.d_opt.state_dict(),
            "g_ema": dict(self.g_ema),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.generator.load_state_dict(sd["g_params"])
        self.discriminator.load_state_dict(sd["d_params"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        if set(sd["g_ema"]) != set(self.g_ema):
            raise ValueError("checkpoint and config disagree on whether the "
                             "generator EMA is tracked (train.g_ema_decay)")
        for k, v in sd["g_ema"].items():
            self.g_ema[k].copy_(v)


def ema_generator_params(state: GANTrainState) -> dict[str, torch.Tensor]:
    """The generator ``state_dict`` eval and serving should use: the EMA
    when tracked, else the raw parameters."""
    return state.g_ema if state.g_ema else state.generator.state_dict()


def make_lr_schedule(cfg: Config, base_lr: float) -> Callable[[int], float]:
    """Learning rate at update ``count`` (0-based) for ``train.lr_schedule``
    (constant | cosine | linear) after ``train.warmup_steps`` of linear
    warm-up from 0."""
    tc = cfg.train
    if tc.lr_schedule not in ("constant", "cosine", "linear"):
        raise ValueError(f"train.lr_schedule={tc.lr_schedule!r}: want "
                         "constant|cosine|linear")
    horizon = max((tc.lr_decay_steps or tc.steps) - tc.warmup_steps, 1)
    end = base_lr * tc.lr_end_factor

    def main(count: int) -> float:
        if tc.lr_schedule == "constant":
            return base_lr
        frac = min(max(count, 0), horizon) / horizon
        if tc.lr_schedule == "cosine":
            cos = 0.5 * (1.0 + math.cos(math.pi * frac))
            return base_lr * ((1.0 - tc.lr_end_factor) * cos
                              + tc.lr_end_factor)
        return base_lr + frac * (end - base_lr)

    def schedule(count: int) -> float:
        if count < tc.warmup_steps:
            return base_lr * count / tc.warmup_steps
        return main(count - tc.warmup_steps)

    return schedule


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm`` (untouched when already below it)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


def make_optimizers(cfg: Config, generator: nn.Module,
                    discriminator: nn.Module):
    def adam(module: nn.Module, lr: float) -> torch.optim.Adam:
        return torch.optim.Adam(module.parameters(), lr=lr,
                                betas=(cfg.train.beta1, cfg.train.beta2),
                                eps=1e-8)

    return (adam(generator, cfg.train.g_lr),
            adam(discriminator, cfg.train.d_lr))


def broadcast_state(state: GANTrainState) -> GANTrainState:
    """Make every rank's state rank 0's (parameters, spectral vectors, both
    Adams, the EMA); nothing to do in a world of one."""
    if world() > 1:
        broadcast_module_state([state.generator, state.discriminator],
                               optimizers=(state.g_opt, state.d_opt),
                               extra=state.g_ema.values())
    return state


def create_state(cfg: Config, seed: int | None = None,
                 device: str | torch.device | None = None) -> GANTrainState:
    """Initialize G, D (seeded), the optimizers and the EMA for a config, on
    ``device`` (CUDA unless the caller asks for another), equal on every
    rank. ``train.mesh`` must cover the world as ``data × model ×
    spatial`` (``ValueError`` otherwise, ``parallel/mesh.py``); with
    ``model.tp_shard`` the generator is channel-sharded over this rank's
    model group (``use_mesh``), its parameters whole. Over a spatial axis
    the modules stay whole: the train step puts them on the row bands of
    this rank's spatial group for each batch that splits."""
    train_mesh(cfg.train.mesh, world())
    group = use_mesh(cfg.train.mesh)
    device = resolve_device(device)
    if device.type == "cuda":
        # a run repeats a few fixed shapes: let cuDNN search once per shape
        # (its heuristic pick for the dilation-16 convs is far slower)
        torch.backends.cudnn.benchmark = True
    seed = cfg.train.seed if seed is None else seed
    generator = build_generator(cfg.model, device=device, seed=seed,
                                model_group=group)
    discriminator = build_discriminator(cfg.model, device=device,
                                        seed=seed + 1)
    g_opt, d_opt = make_optimizers(cfg, generator, discriminator)
    # the EMA starts as a copy of the raw parameters
    g_ema = ({k: v.detach().clone()
              for k, v in generator.state_dict().items()}
             if cfg.train.g_ema_decay > 0 else {})
    return broadcast_state(GANTrainState(
        step=0, generator=generator, discriminator=discriminator,
        g_opt=g_opt, d_opt=d_opt, g_ema=g_ema))


def warm_start(state: GANTrainState, cfg: Config) -> GANTrainState:
    """Graft parameters from ``cfg.train.init_from`` (another run's
    workdir) into a fresh state: G parameters and, with
    ``train.init_from_d``, D parameters and spectral vectors come from the
    source checkpoint; step and optimizer states stay fresh. A source of
    another architecture fails loudly."""
    from gan_inpainting_torch.io.checkpoint import CheckpointManager

    subdir = ("checkpoints_best" if cfg.train.init_from_best
              else "checkpoints")
    if not (pathlib.Path(cfg.train.init_from) / subdir).is_dir():
        raise FileNotFoundError(
            f"train.init_from={cfg.train.init_from!r}: no {subdir}/ there "
            "(expected another run's workdir)")
    raw = CheckpointManager(cfg.train.init_from, subdir=subdir).restore_raw(
        map_location=state.device)
    try:
        state.generator.load_state_dict(raw["g_params"])
        if state.g_ema:
            # a source without an EMA starts it from the grafted parameters
            src = raw.get("g_ema") or raw["g_params"]
            for k in state.g_ema:
                state.g_ema[k].copy_(src[k])
        if cfg.train.init_from_d:
            state.discriminator.load_state_dict(raw["d_params"])
    except (RuntimeError, KeyError) as err:
        raise ValueError(
            f"train.init_from={cfg.train.init_from!r}: the source does not "
            f"match this config's architecture: {err}") from err
    return broadcast_state(state)
