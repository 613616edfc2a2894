"""Carry JAX/flax params and train state (as numpy) into the port.

Flax names ``stack/conv{i}/{kernel,bias}`` map to the port's modules
``stack.conv{i}.{weight,bias}``. Kernels go from HWIO to OIHW. A gated conv
stays one conv with 2F outputs, so the feature/gate split (first half
features, second half gate) keeps its channel order. The discriminator's
spectral vectors (flax collection ``spectral``, ``conv{i}/u``) become the
``conv{i}.u`` buffers, and ``optax.adam``'s ``mu``/``nu``/``count`` become
the ``exp_avg``/``exp_avg_sq``/``step`` of ``torch.optim.Adam``. The same
mapping carries a partial-conv ``DilatedGenerator`` tree (its layers own a
plain (k, k, Cin, Cout) kernel) and the VGG16 feature extractor's
``conv{block}_{i}/{kernel,bias}`` (losses/perceptual.py), in memory or from
the converted ``.npz`` the JAX package reads. :func:`params_to_jax` goes
the other way, for the export artifact.
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
    ``state_dict`` for the port's generators and discriminator (whose
    spectral ``u`` vectors may be merged into the same tree)."""
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
        elif leaf not in ("bias", "u"):
            raise ValueError(f"{path}: unknown param leaf {leaf!r}")
        state[".".join(parts[:-1] + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return state


def params_to_jax(state_dict) -> dict:
    """A port ``state_dict`` → the nested flax tree of float32 numpy
    arrays that :func:`params_from_jax` reads: OIHW ``weight`` → HWIO
    ``kernel``, ``bias`` and ``u`` as they are. The inverse of
    :func:`params_from_jax`, exactly."""
    tree: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        leaf = parts[-1]
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if arr.ndim != 4:
                raise ValueError(f"{key}: expected an OIHW kernel, got "
                                 f"shape {arr.shape}")
            arr = arr.transpose(2, 3, 1, 0)          # OIHW -> HWIO
            leaf = "kernel"
        elif leaf not in ("bias", "u"):
            raise ValueError(f"{key}: unknown param leaf {leaf!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def vgg_state_from_npz(path: str, like: Mapping) -> dict[str, torch.Tensor]:
    """The converted VGG16 ``.npz`` (flat keys ``conv{block}_{i}/kernel``
    HWIO and ``…/bias``) → a ``state_dict`` with the keys and shapes of
    ``like``. Extra layers in the file (blocks 4 and 5) are ignored; a
    missing or misshapen one raises."""
    with np.load(path) as data:
        names = sorted({k.rsplit(".", 1)[0] for k in like})
        missing = [f"{n}/{leaf}" for n in names for leaf in ("kernel", "bias")
                   if f"{n}/{leaf}" not in data]
        if missing:
            raise KeyError(f"{path} is missing {missing}: not a converted "
                           "VGG16 weights file")
        state = params_from_jax({f"{n}/{leaf}": data[f"{n}/{leaf}"]
                                 for n in names
                                 for leaf in ("kernel", "bias")})
    for k, v in state.items():
        if v.shape != like[k].shape:
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, want "
                             f"{tuple(like[k].shape)}")
    return state


def _merge(a, b) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, Mapping) else v
    return out


def discriminator_from_jax(d_params, d_stats=None) -> dict[str, torch.Tensor]:
    """Flax discriminator params plus its ``spectral`` collection → the
    port's discriminator ``state_dict``."""
    return params_from_jax(_merge(d_params, d_stats or {}))


def load_adam_from_jax(opt: torch.optim.Adam, module: torch.nn.Module, mu,
                       nu, count: int) -> None:
    """Fill ``opt`` (over ``module.parameters()``) with an ``optax.adam``
    state: ``mu``/``nu`` trees shaped like the flax params, ``count`` the
    number of updates taken."""
    first = params_from_jax(mu)
    second = params_from_jax(nu)
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": first[name].to(p.device),
            "exp_avg_sq": second[name].to(p.device),
        }


def load_state_from_jax(state, jax_state: Mapping) -> None:
    """Copy a JAX train state, given as nested dicts of numpy arrays, into
    a port :class:`~gan_inpainting_torch.train.state.GANTrainState` built
    for the same config. Keys: ``step``, ``g_params``, ``d_params``,
    ``d_stats``, ``g_ema`` ({} when not tracked), and ``g_opt``/``d_opt``
    as ``{"mu", "nu", "count"}``."""
    state.step = int(jax_state["step"])
    state.generator.load_state_dict(params_from_jax(jax_state["g_params"]))
    state.discriminator.load_state_dict(discriminator_from_jax(
        jax_state["d_params"], jax_state.get("d_stats")))
    for opt, module, key in ((state.g_opt, state.generator, "g_opt"),
                             (state.d_opt, state.discriminator, "d_opt")):
        o = jax_state[key]
        load_adam_from_jax(opt, module, o["mu"], o["nu"], int(o["count"]))
    if state.g_ema:
        for k, v in params_from_jax(jax_state["g_ema"]).items():
            state.g_ema[k].copy_(v)
