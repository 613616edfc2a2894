"""Carry JAX/flax generator params (as numpy) into the port.

Flax names ``stack/conv{i}/{kernel,bias}`` map to the port's modules
``stack.conv{i}.{weight,bias}``. Kernels go from HWIO to OIHW. A gated conv
stays one conv with 2F outputs, so the feature/gate split (first half
features, second half gate) keeps its channel order.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix: str = "") -> dict:
    if not isinstance(tree, Mapping):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    return out


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """Nested (or ``/``-flattened) flax param tree of arrays → a float32
    ``state_dict`` for the port's generators."""
    state = {}
    for path, value in _flatten(params).items():
        parts = path.split(_SEP)
        leaf = parts[-1]
        arr = np.array(value, np.float32)          # a writable copy
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{path}: expected an HWIO kernel, got "
                                 f"shape {arr.shape}")
            arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"{path}: unknown param leaf {leaf!r}")
        state[".".join(parts[:-1] + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return state

