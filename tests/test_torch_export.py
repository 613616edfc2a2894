"""The port's export artifact (io/export.py, io/convert.py params_to_jax)
against the JAX package's: one npz layout read and written by both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.configs.base import apply_overrides as j_overrides
from gan_inpainting_tpu.configs.base import get_config as j_get_config
from gan_inpainting_tpu.infer.inpaint import Inpainter as JInpainter
from gan_inpainting_tpu.io.export import export_generator as j_export
from gan_inpainting_tpu.io.export import load_generator as j_load
from gan_inpainting_tpu.models.generator import (
    build_generator as j_build_generator,
)

from gan_inpainting_torch.configs.base import apply_overrides, config_from_dict
from gan_inpainting_torch.infer.inpaint import Inpainter
from gan_inpainting_torch.io.convert import params_from_jax, params_to_jax
from gan_inpainting_torch.io.export import (
    export_from_checkpoint,
    export_generator,
    load_generator,
)

SERVE = ["infer.batch_buckets=2", "infer.size_buckets=32"]


def _jax_params(jcfg, seed, size=32):
    """A flax param tree of the config's generator, drawn with numpy."""
    shapes = jax.eval_shape(
        j_build_generator(jcfg.model).init, jax.random.key(0),
        jnp.zeros((1, size, size, 3)), jnp.zeros((1, size, size, 1)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(
                       np.float32), shapes["params"])


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _requests():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    masks = np.zeros((2, 32, 32), np.float32)
    masks[0, 8:24, 8:24] = 1.0
    masks[1, 4:20, 12:30] = 1.0
    return imgs, masks


def _agree(a, b, imgs, masks):
    """uint8 outputs within ±1, known pixels bit-exact in both."""
    keep = np.broadcast_to(masks[..., None] == 0, imgs.shape)
    for out in (a, b):
        np.testing.assert_array_equal(out[keep], imgs[keep])
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("name,extra", [
    ("celebahq256_freeform", ["model.use_attention=true"]),
    ("partialconv256", []),
    ("celeba128_center", []),
])
def test_params_to_jax_inverts_params_from_jax(name, extra):
    jcfg = j_overrides(j_get_config(name), ["model.base_features=8"] + extra)
    params = _jax_params(jcfg, 1)
    state = params_from_jax(params)
    back = params_to_jax(state)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert b.dtype == np.float32 and b.shape == a.shape, path
        np.testing.assert_array_equal(a, b)
    # and the other way round, from a port state_dict
    again = params_from_jax(back)
    assert list(again) == list(state)
    assert all(torch.equal(again[k], state[k]) for k in state)


@pytest.mark.parametrize("store_dtype", [None, "float16"])
def test_port_npz_loads_in_jax(tiny_config, tmp_path, store_dtype):
    jcfg = j_overrides(tiny_config, SERVE)
    state = params_from_jax(_jax_params(jcfg, 2))
    path = tmp_path / "g.npz"
    export_generator(_port_cfg(jcfg), state, str(path),
                     store_dtype=store_dtype)
    cfg2, params2 = j_load(str(path))
    assert cfg2 == jcfg
    back = params_from_jax(params2)
    tol = 0.0 if store_dtype is None else 1e-3
    for k, v in state.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=tol,
                                   atol=tol / 10)
    imgs, masks = _requests()
    want = JInpainter.from_npz(str(path)).inpaint_batch(imgs, masks)
    got = Inpainter.from_npz(str(path), device="cpu").inpaint_batch(
        imgs, masks)
    _agree(got, want, imgs, masks)
    if store_dtype is None:     # the artifact serves the state it was given
        direct = Inpainter(_port_cfg(jcfg), state,
                           device="cpu").inpaint_batch(imgs, masks)
        np.testing.assert_array_equal(got, direct)


def test_jax_npz_loads_in_port(tiny_config, tmp_path):
    jcfg = j_overrides(tiny_config, SERVE)
    params = _jax_params(jcfg, 3)
    path = tmp_path / "g.npz"
    j_export(jcfg, params, str(path))
    cfg, loaded = load_generator(str(path))
    assert cfg == _port_cfg(jcfg)
    imgs, masks = _requests()
    want = JInpainter(jcfg, params).inpaint_batch(imgs, masks)
    got = Inpainter.from_npz(str(path), device="cpu").inpaint_batch(
        imgs, masks)
    _agree(got, want, imgs, masks)


def test_foreign_npz_rejected(tmp_path):
    path = tmp_path / "foreign.npz"
    np.savez(path, w=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="not a generator export"):
        load_generator(str(path))
    with pytest.raises(ValueError, match="not a generator export"):
        Inpainter.from_npz(str(path), device="cpu")
    # nor can a port state_dict write a leaf onto the reserved config key
    with pytest.raises(ValueError, match="unknown param leaf"):
        export_generator(_port_cfg(j_get_config("celeba128_center")),
                         {"__config_json__": torch.zeros(3)},
                         str(tmp_path / "bad.npz"))


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """Two port train steps of a tiny config that tracks an EMA."""
    from gan_inpainting_torch.train.loop import train

    workdir = tmp_path_factory.mktemp("run")
    cfg = apply_overrides(_port_cfg(j_get_config("celeba128_center")), [
        "data.image_size=32", "data.batch_size=2", "data.eval_batch_size=2",
        "data.num_eval_batches=1", "model.base_features=8",
        "model.disc_features=8", "model.disc_layers=2",
        "model.dtype_policy=f32", "train.steps=2", "train.g_ema_decay=0.5",
        "train.log_every=1", f"train.workdir={workdir}"] + SERVE)
    state, _ = train(cfg, verbose=False, device="cpu")
    return cfg, state


@pytest.mark.parametrize("use_ema", [True, False])
def test_export_from_checkpoint(trained_run, tmp_path, use_ema):
    cfg, state = trained_run
    want = state.g_ema if use_ema else state.generator.state_dict()
    other = state.generator.state_dict() if use_ema else state.g_ema
    path = tmp_path / "g.npz"
    export_from_checkpoint(cfg, str(path), use_ema=use_ema)
    saved, params = load_generator(str(path))
    assert saved == cfg
    got = params_from_jax(params)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not all(torch.equal(got[k], other[k]) for k in want)
    # the JAX package reads it as well, and Inpainter.from_checkpoint
    # serves the same weights under the same use_ema
    jcfg, jparams = j_load(str(path))
    assert jcfg.model == j_overrides(j_get_config("celeba128_center"), [
        "model.base_features=8", "model.disc_features=8",
        "model.disc_layers=2", "model.dtype_policy=f32"]).model
    assert all(torch.equal(v, want[k])
               for k, v in params_from_jax(jparams).items())
    inp = Inpainter.from_checkpoint(cfg, use_ema=use_ema, device="cpu")
    assert all(torch.equal(inp.state_dict[k], want[k]) for k in want)
    # the best-PSNR slot holds the last step too (one eval, at step 2)
    export_from_checkpoint(cfg, str(path), use_ema=use_ema, best=True)
    got = params_from_jax(load_generator(str(path))[1])
    assert all(torch.equal(got[k], want[k]) for k in want)
