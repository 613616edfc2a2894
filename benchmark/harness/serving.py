"""What the serving drivers share: the program built as users serve it
(an ``Inpainter`` on the benchmark's generator weights, ``kernel_backend``
and the formulation per size bucket as the configuration states), the
inputs, the counts over served images and the comparison of served images
with the reference's."""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark.harness import count, inputs, spec
from benchmark.reference import deepfill


def build(run):
    """(program config, generator weights, Inpainter) of a serving cell."""
    from gan_inpainting_torch.infer.inpaint import Inpainter

    cfg = spec.program_config(run.cell, run.extra_overrides)
    gain = spec.config(run.cell["config"]).get("weight_gain", 1.0)
    params = inputs.generator_params(cfg.model.base_features, run.seed,
                                     run.device, gain)
    return cfg, params, Inpainter(cfg, params, device=run.device)


def pool(run, cfg, n: int, size: int, stream: str):
    """n distinct requests as host arrays: uint8 images (n, S, S, 3) and
    float32 masks (n, S, S, 1), 1 = hole."""
    imgs = inputs.images_u8(n, size, run.seed, run.device, stream)
    msks = inputs.masks(n, size, inputs.mask_params(cfg), run.seed,
                        run.device, stream)
    return imgs.cpu().numpy(), msks.cpu().numpy()


def free(*objs) -> None:
    """Drop the program's state and give its memory back to the card."""
    for o in objs:
        close = getattr(o, "close", None)
        if close is not None:
            close()
    del objs
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def image_flops(f: int, size: int, masks: np.ndarray) -> np.ndarray:
    """Model FLOPs of serving each image of ``masks`` (n, S, S, 1) at
    bucket ``size``: the convs as published plus attention over its valid
    pairs."""
    conv = count.generator_conv_flops(f, size)
    n_valid = count.valid_keys(torch.from_numpy(masks)).double().numpy()
    return conv + np.array([count.attention_fwd_flops(size, 4 * f, v)
                            for v in n_valid])


def reference_u8(params, imgs: np.ndarray, masks: np.ndarray, f: int,
                 device, block: int, q=None) -> np.ndarray:
    """The reference's served images, float32 with TF32 off, in blocks."""
    outs = []
    with torch.no_grad(), deepfill.float32_exact():
        for i in range(0, len(imgs), block):
            x = torch.from_numpy(imgs[i:i + block]).to(device)
            m = torch.from_numpy(masks[i:i + block]).to(device)
            outs.append(deepfill.inpaint_u8(params, x, m, f, q).cpu().numpy())
    return np.concatenate(outs)


def compare(got: np.ndarray, imgs: np.ndarray, masks: np.ndarray,
            ref: np.ndarray) -> dict:
    """``known_changed``: known pixels (mask 0) whose served value is not
    the input's (the composite keeps them exactly); ``hole_mad_worst``:
    the largest, over the images, of the mean absolute difference in
    uint8 levels between served and reference hole pixels."""
    hole = np.broadcast_to(masks > 0, got.shape)
    known_changed = int(((got != imgs) & ~hole).sum())
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    worst = 0.0
    for d, h in zip(diff, hole):
        if h.any():
            worst = max(worst, float(d[h].mean()))
    return {"known_changed": known_changed, "hole_mad_worst": worst}


def readings(driver, imgs, masks, got, q=None) -> dict:
    """The compared numbers of served images ``got`` against the float32
    reference; with ``q`` the reference computed at that precision takes
    the program's place (the control)."""
    run = driver.run
    f, block = driver.cfg.model.base_features, int(run.params["ref_block"])
    ref = reference_u8(driver.params, imgs, masks, f, run.device, block)
    if q is not None:
        got = reference_u8(driver.params, imgs, masks, f, run.device, block, q)
    return compare(got, imgs, masks, ref)
