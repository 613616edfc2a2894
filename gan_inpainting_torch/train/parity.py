"""Quality-parity harness: a fixed-seed eval fingerprint per named config.

:func:`run_parity` evaluates every named config with fixed-seed generator
params on the fixed-seed eval stream and returns PSNR / SSIM (and SWD
where the config asks for it). The run is deterministic by construction,
so any drift is a change of behaviour: the ``parity`` command and the
tests diff it against this package's ``parity_pinned.json``, whose pins
are keyed by device type (``cpu``, ``cuda``), since bf16 arithmetic
differs between the CPU and the card.

The port's fixed-seed params and synthetic draws come from
``torch.Generator``, so its pins do not equal the JAX package's
(``parity_pinned.json`` at the repository root). Across packages the same
weights are held on the same images instead: a folder corpus and center
masks, which involve no draw (tests/test_torch_parity.py).
"""

from __future__ import annotations

import json
import pathlib

import torch

from gan_inpainting_torch.ops.dispatch import resolve_device

PINNED_PATH = pathlib.Path(__file__).resolve().parents[1] / \
    "parity_pinned.json"

# eval cut to keep the harness fast on the CPU; fixed here so that pins
# stay comparable
_EVAL_OVERRIDES = [
    "data.eval_batch_size=4",
    "data.num_eval_batches=2",
]


def run_parity(configs: list[str] | None = None,
               max_image_size: int | None = None,
               device: str | torch.device | None = None) -> dict:
    """Pinned metrics per named config, fixed seeds end to end, on
    ``device`` (CUDA unless the caller asks for another).

    ``max_image_size`` caps the image size (CPU runs of the 512² configs);
    a capped entry is recorded under a size-suffixed key, ``name@size``,
    so it never collides with a full-size pin."""
    from gan_inpainting_torch.configs.base import (
        apply_overrides,
        get_config,
        list_configs,
    )
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.train.evaluate import evaluate

    device = resolve_device(device)
    if device.type == "cuda":
        # as create_state and Inpainter do: cuDNN's heuristic pick for the
        # dilation-16 convs is far slower than its tuned one
        torch.backends.cudnn.benchmark = True
    results: dict[str, dict] = {}
    for name in configs or list_configs():
        cfg = apply_overrides(get_config(name), _EVAL_OVERRIDES)
        key = name
        if max_image_size and cfg.data.image_size > max_image_size:
            cfg = apply_overrides(cfg, [f"data.image_size={max_image_size}"])
            key = f"{name}@{max_image_size}"
        params = build_generator(cfg.model, device=device,
                                 seed=0).state_dict()
        metrics = evaluate(cfg, params, seed=0, device=device)
        results[key] = {k: round(float(v), 4) for k, v in metrics.items()}
    return results


def check_parity(results: dict, pinned_path=PINNED_PATH,
                 tol_db: float = 0.1,
                 device: str | torch.device | None = None) -> list[str]:
    """Compare results against the pins of ``device``'s type; returns the
    drift messages. PSNR within ``tol_db``; SSIM within 0.005; SWD within
    2 % of the pin, at least 0.1 (SWD sits in the tens to hundreds, so a
    relative band is the analogue of ±0.1 dB)."""
    platform = resolve_device(device).type
    pinned = json.loads(pathlib.Path(pinned_path).read_text()).get(platform)
    if pinned is None:
        return [f"no pins for device type {platform!r}; run "
                f"`gan_inpainting_torch parity --update --device "
                f"{platform}` once"]
    problems = []
    for name, metrics in results.items():
        if name not in pinned:
            problems.append(f"{name}: no pinned entry")
            continue
        for metric, value in metrics.items():
            want = pinned[name].get(metric)
            if want is None:
                problems.append(f"{name}.{metric}: not pinned")
                continue
            if metric == "psnr":
                tol = tol_db
            elif metric.startswith("swd"):
                tol = max(0.02 * abs(want), 0.1)
            else:
                tol = 0.005
            if abs(value - want) > tol:
                problems.append(f"{name}.{metric}: {value} vs pinned {want} "
                                f"(tol {tol})")
    return problems


def update_pins(results: dict, pinned_path=PINNED_PATH,
                device: str | torch.device | None = None) -> str:
    """Write ``results`` over the pins of ``device``'s type; returns it."""
    platform = resolve_device(device).type
    path = pathlib.Path(pinned_path)
    pins = json.loads(path.read_text()) if path.exists() else {}
    pins.setdefault(platform, {}).update(results)
    path.write_text(json.dumps(pins, indent=2, sort_keys=True) + "\n")
    return platform
