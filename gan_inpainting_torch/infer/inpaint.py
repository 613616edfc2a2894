"""Inference: ``inpaint(image, mask)`` and the bucketed batch server.

normalize → generator → composite on the raw uint8 input (known pixels
bit-exact) → uint8. Inputs are padded up to the nearest configured
(batch, size) bucket, as in the JAX package, so every request runs one of a
fixed set of shapes; non-square images pad H and W to the square bucket of
the larger side and are cropped back.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gan_inpainting_torch.configs.base import Config, InferConfig
from gan_inpainting_torch.data.pipeline import denormalize, normalize
from gan_inpainting_torch.models.generator import build_generator
from gan_inpainting_torch.ops.dispatch import resolve_device


def _bucket(value: int, buckets) -> int:
    for b in sorted(buckets):
        if value <= b:
            return b
    raise ValueError(f"{value} exceeds largest bucket {max(buckets)}; "
                     f"configure a larger bucket in InferConfig")


def make_forward_fn(cfg: Config, state_dict,
                    device: str | torch.device | None = None):
    """The serve forward ``(images_u8, masks) → uint8`` on ``device``.

    images_u8: (B, H, W, 3) uint8 tensor; masks: (B, H, W, 1) float32,
    1 = hole; both on ``device``.
    """
    gen = build_generator(cfg.model, device=device, seed=None)
    gen.load_state_dict(state_dict)
    gen.eval()

    @torch.inference_mode()
    def fwd(images_u8: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        image = normalize(images_u8)
        masked = image * (1.0 - masks)
        fine = gen(masked, masks).fine.float()
        # composite on raw uint8: known pixels bit-exact
        return torch.where(masks <= 0.0, images_u8, denormalize(fine))

    fwd.generator = gen      # for profiling tools
    return fwd


class Inpainter:
    """Serves inpaint requests from a generator ``state_dict`` (see
    :func:`gan_inpainting_torch.io.convert.params_from_jax`) or, through
    :meth:`from_npz`, from an exported artifact. Runs on CUDA unless
    ``device`` says otherwise."""

    def __init__(self, cfg: Config, state_dict,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every request runs one of a fixed set of bucket shapes, so
            # cuDNN's per-shape algorithm search pays once per bucket (as
            # the JAX package compiles once per bucket); its heuristic
            # choice for the dilation-16 convs is ~300x slower on an H100
            # (PERF.md)
            torch.backends.cudnn.benchmark = True
        self.state_dict = state_dict
        # one generator per decoder formulation: eager PyTorch needs no
        # program per bucket shape
        self._forward = functools.lru_cache(maxsize=None)(
            self._build_forward)

    @classmethod
    def from_npz(cls, path: str, overrides: list[str] | None = None,
                 device: str | torch.device | None = None) -> "Inpainter":
        """Serve from a portable export artifact: the generator params plus
        the embedded config. ``overrides`` apply on top of that config."""
        from gan_inpainting_torch.configs.base import apply_overrides
        from gan_inpainting_torch.io.convert import params_from_jax
        from gan_inpainting_torch.io.export import load_generator

        cfg, params = load_generator(path)
        if overrides:
            cfg = apply_overrides(cfg, list(overrides))
        return cls(cfg, params_from_jax(params), device=device)

    @classmethod
    def from_checkpoint(cls, cfg: Config, workdir: str | None = None, *,
                        best: bool = False, step: int | None = None,
                        device: str | torch.device | None = None,
                        ) -> "Inpainter":
        """Serve from a training checkpoint under ``workdir`` (default
        ``cfg.train.workdir``): the EMA generator when the run tracked one,
        else the raw parameters. The model is the checkpoint's own saved
        one; ``cfg`` supplies the serving knobs (``infer``)."""
        from gan_inpainting_torch.configs.base import config_from_dict
        from gan_inpainting_torch.io.checkpoint import CheckpointManager

        subdir = "checkpoints_best" if best else "checkpoints"
        ckpt = CheckpointManager(workdir or cfg.train.workdir, subdir=subdir)
        saved = config_from_dict(ckpt.restore_config(step))
        raw = ckpt.restore_raw(step)
        params = raw["g_ema"] or raw["g_params"]
        return cls(dataclasses.replace(cfg, model=saved.model), params,
                   device=device)

    # ------------------------------------------------------------------
    def _cfg_for_size(self, size: int) -> Config:
        """Size-dependent formulation: buckets above
        ``infer.fuse_upsample_max_size`` use the unfused decoder. Same
        weights and math either way."""
        cfg = self.cfg
        if (cfg.model.fuse_upsample
                and size > cfg.infer.fuse_upsample_max_size):
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model,
                                               fuse_upsample=False))
        return cfg

    def _build_forward(self, fuse_upsample: bool):
        cfg = dataclasses.replace(
            self.cfg, model=dataclasses.replace(self.cfg.model,
                                                fuse_upsample=fuse_upsample))
        return make_forward_fn(cfg, self.state_dict, self.device)

    # ------------------------------------------------------------------
    def inpaint_batch(self, images_u8, masks) -> np.ndarray:
        """Batched API. images: (B,H,W,3) uint8; masks: (B,H,W[,1]), 1=hole."""
        images_u8 = np.asarray(images_u8, np.uint8)
        masks = np.asarray(masks, np.float32)
        if masks.ndim == 3:
            masks = masks[..., None]
        b, h, w, _ = images_u8.shape
        if masks.shape[:3] != (b, h, w):
            raise ValueError(
                f"mask shape {masks.shape[:3]} does not match images "
                f"{(b, h, w)}")
        icfg: InferConfig = self.cfg.infer
        bb = _bucket(b, icfg.batch_buckets)
        sb = _bucket(max(h, w), icfg.size_buckets)
        if sb != h or sb != w:
            # padded area is "known" (mask 0): context, cropped off below
            widths = ((0, 0), (0, sb - h), (0, sb - w), (0, 0))
            images_u8 = np.pad(images_u8, widths)
            masks = np.pad(masks, widths)
        if bb != b:
            reps = ((0, bb - b),) + ((0, 0),) * 3
            images_u8 = np.pad(images_u8, reps)
            masks = np.pad(masks, reps)
        fwd = self._forward(self._cfg_for_size(sb).model.fuse_upsample)
        out = fwd(
            torch.from_numpy(images_u8).to(self.device),
            torch.from_numpy(masks).to(self.device))
        return out[:b, :h, :w, :].cpu().numpy()

    def __call__(self, image, mask) -> np.ndarray:
        """Single-image API: (H,W,3) uint8 + (H,W[,1]) mask → (H,W,3) uint8."""
        out = self.inpaint_batch(np.asarray(image)[None],
                                 np.asarray(mask)[None])
        return out[0]

    def warmup(self):
        """Run every configured bucket once (kernel build, cuDNN plans)."""
        for b in self.cfg.infer.batch_buckets:
            for s in self.cfg.infer.size_buckets:
                img = np.zeros((b, s, s, 3), np.uint8)
                msk = np.zeros((b, s, s, 1), np.float32)
                self.inpaint_batch(img, msk)


def inpaint(image, mask, *, inpainter: Inpainter | None = None,
            npz: str | None = None, cfg: Config | None = None,
            workdir: str | None = None,
            device: str | torch.device | None = None) -> np.ndarray:
    """One-shot ``inpaint(image, mask)``: with an :class:`Inpainter`, from
    an export ``npz``, or from the latest checkpoint of ``cfg``'s (or
    ``workdir``'s) training run."""
    if inpainter is None:
        if npz is not None:
            inpainter = Inpainter.from_npz(npz, device=device)
        else:
            if cfg is None:
                from gan_inpainting_torch.configs.base import get_config

                cfg = get_config("celeba128_center")
            inpainter = Inpainter.from_checkpoint(cfg, workdir,
                                                  device=device)
    return inpainter(image, mask)
