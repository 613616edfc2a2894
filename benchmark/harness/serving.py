"""What the serving drivers share: the program built as users serve it
(an ``Inpainter`` on the weights that the configuration's reference
makes, ``kernel_backend`` and the formulation per size bucket as the
configuration states), the inputs, and the comparison of served images
with the reference's. The model is reached only through the reference
module the configuration names (``spec.reference``)."""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark.harness import inputs, spec


def build(run):
    """(program config, reference module, weights, Inpainter) of a serving
    cell."""
    from gan_inpainting_torch.infer.inpaint import Inpainter

    cfg = spec.program_config(run.cell, run.extra_overrides)
    ref = spec.reference(run.cell["config"])
    params = ref.weights(spec.config(run.cell["config"]), cfg, run.seed,
                         run.device)
    return cfg, ref, params, Inpainter(cfg, params, device=run.device)


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


def reference_u8(driver, imgs: np.ndarray, masks: np.ndarray,
                 q=None) -> np.ndarray:
    """The reference's served images on the driver's weights, float32 with
    TF32 off, in blocks of ``ref_block`` images."""
    ref, device = driver.ref, driver.run.device
    block = int(driver.run.params["ref_block"])
    outs = []
    with torch.no_grad(), ref.float32_exact():
        for i in range(0, len(imgs), block):
            x = torch.from_numpy(imgs[i:i + block]).to(device)
            m = torch.from_numpy(masks[i:i + block]).to(device)
            outs.append(ref.served(driver.params, x, m, driver.cfg, q)
                        .cpu().numpy())
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
    ref = reference_u8(driver, imgs, masks)
    if q is not None:
        got = reference_u8(driver, imgs, masks, q)
    return compare(got, imgs, masks, ref)


def calibration(driver, imgs, masks, got) -> dict:
    """The compared numbers, with the spread of the hole differences
    beside them, of the program's served images (the lower reading), of
    the reference in float8 in the program's place (the control, the
    upper one) and of two faults: half of the images left unfilled, one
    answer swapped for another's."""
    ref = reference_u8(driver, imgs, masks)
    ctl = reference_u8(driver, imgs, masks, driver.ref.fp8)
    half = got.copy()
    n = len(half) // 2
    half[n:] = imgs[n:] * (masks[n:] <= 0)
    swapped = got.copy()
    swapped[0] = got[1]
    hole = np.broadcast_to(masks > 0, got.shape)
    out = {}
    for name, x in (("program", got), ("control_fp8", ctl),
                    ("fault_half", half), ("fault_swapped", swapped)):
        out[name] = compare(x, imgs, masks, ref)
        diff = np.abs(x.astype(np.int16) - ref.astype(np.int16))[hole]
        out[name].update(hole_mad_all=float(diff.mean()),
                         hole_maxdiff=int(diff.max()),
                         hole_share_ge2=float((diff >= 2).mean()))
    return out
