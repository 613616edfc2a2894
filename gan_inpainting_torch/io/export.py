"""Read the portable generator artifact: one ``.npz`` file.

The JAX package writes generator params flattened to ``path/to/leaf ->
array`` entries (flax names, HWIO kernels) plus the config JSON under
``__config_json__``. This module reads that file with numpy alone and hands
back the same nested tree; :func:`gan_inpainting_torch.io.convert.params_from_jax`
turns it into a ``state_dict``.
"""

from __future__ import annotations

import json

import numpy as np

from gan_inpainting_torch.configs.base import Config, config_from_dict

_CONFIG_KEY = "__config_json__"
_SEP = "/"


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


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
