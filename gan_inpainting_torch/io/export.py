"""The portable generator artifact: one ``.npz`` file.

Generator params flattened to ``path/to/leaf -> array`` entries (flax
names, HWIO kernels) plus the config JSON under ``__config_json__``, the
layout the JAX package writes and reads, so an artifact of either package
serves in the other. :func:`load_generator` reads it with numpy alone and
hands back the nested tree
(:func:`gan_inpainting_torch.io.convert.params_from_jax` turns it into a
``state_dict``); :func:`export_generator` writes a port ``state_dict``
through :func:`gan_inpainting_torch.io.convert.params_to_jax`, and
:func:`export_from_checkpoint` a training checkpoint's generator.

CLI: ``python -m gan_inpainting_torch export --output g.npz`` and
``infer --weights g.npz``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from gan_inpainting_torch.configs.base import Config, config_from_dict

_CONFIG_KEY = "__config_json__"
_SEP = "/"


def _flatten(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def export_generator(cfg: Config, state_dict, path: str,
                     store_dtype: str | None = None) -> None:
    """Write a generator ``state_dict`` and ``cfg`` to ``path`` (.npz).

    ``store_dtype="float16"`` stores the float32 leaves as float16 (the
    in-repo pinned artifacts); :func:`load_generator` widens them back."""
    from gan_inpainting_torch.io.convert import params_to_jax

    # params_to_jax admits only kernel / bias / u leaves, so no param path
    # can be the reserved config key
    flat = _flatten(params_to_jax(state_dict))
    if store_dtype is not None:
        dt = np.dtype(store_dtype)
        flat = {k: (v.astype(dt) if v.dtype == np.float32 else v)
                for k, v in flat.items()}
    payload = {_CONFIG_KEY: np.frombuffer(
        json.dumps(dataclasses.asdict(cfg), default=str).encode(), np.uint8)}
    payload.update(flat)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_generator(path: str) -> tuple[Config, dict]:
    """Read an exported artifact → ``(cfg, params)``, params a nested dict
    of numpy arrays in the JAX layout. Leaves stored as float16 (the
    in-repo pinned artifacts) are widened to the float32 the models use."""
    with np.load(path) as data:
        if _CONFIG_KEY not in data:
            raise ValueError(
                f"{path} is not a generator export (missing config)")
        cfg = config_from_dict(json.loads(bytes(data[_CONFIG_KEY]).decode()))
        params = _unflatten(
            {k: (data[k].astype(np.float32)
                 if data[k].dtype == np.float16 else data[k])
             for k in data.files if k != _CONFIG_KEY})
    return cfg, params


def export_from_checkpoint(cfg: Config, path: str,
                           workdir: str | None = None,
                           use_ema: bool = True, best: bool = False,
                           store_dtype: str | None = None) -> None:
    """Export the latest (or ``best``) checkpoint's generator to ``path``:
    the EMA when ``use_ema`` and the run tracked one, else the raw
    parameters. The artifact embeds the checkpoint's own config, so
    ``cfg`` only locates the workdir (``train.workdir``)."""
    from gan_inpainting_torch.io.checkpoint import CheckpointManager

    subdir = "checkpoints_best" if best else "checkpoints"
    ckpt = CheckpointManager(workdir or cfg.train.workdir, subdir=subdir)
    saved_cfg = config_from_dict(ckpt.restore_config())
    raw = ckpt.restore_raw()
    params = raw["g_params"]
    if use_ema and raw.get("g_ema"):
        params = raw["g_ema"]
    export_generator(saved_cfg, params, path, store_dtype=store_dtype)
