"""The port's SWD (metrics/swd.py) against the JAX package's on the same
draws, its properties, and the eval loop's ``swd`` keys."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_torch.configs.base import apply_overrides, get_config
from gan_inpainting_torch.metrics import swd as t_swd

# the JAX package's metrics/__init__ binds the name ``swd`` to the function
j_swd = importlib.import_module("gan_inpainting_tpu.metrics.swd")


def _textured(seed, n=8, h=32, w=None):
    """Smooth random images in (-1, 1), as numpy float32 (N, H, W, 3)."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((n, h + 4, (w or h) + 4, 3))
    box = sum(noise[:, i:i + h, j:j + (w or h)] for i in range(5)
              for j in range(5)) / 25.0
    return np.tanh(2.0 * box).astype(np.float32)


def _jax_draws(key, level_shapes, ppi=64, ps=7, n_proj=128):
    """The draws JAX ``swd`` makes from ``key``, per level, as torch
    tensors in :func:`swd_draws`'s form."""
    out = []
    for i, (b, h, w, c) in enumerate(level_shapes):
        kp, kd = jax.random.split(jax.random.fold_in(key, i))
        ky, kx, _ = jax.random.split(kp, 3)
        n = b * ppi
        ys = jax.random.randint(ky, (n,), 0, h - ps + 1)
        xs = jax.random.randint(kx, (n,), 0, w - ps + 1)
        dirs = jax.random.normal(kd, (ps * ps * c, n_proj), jnp.float32)
        out.append(tuple(torch.from_numpy(np.asarray(a).astype(dt))
                         for a, dt in ((ys, np.int64), (xs, np.int64),
                                       (dirs, np.float32))))
    return out


@pytest.mark.parametrize("shape", [(4, 32, 32), (2, 40, 24)])
def test_pyramid_matches_jax(shape):
    x = _textured(0, *shape)
    want = j_swd.laplacian_pyramid(jnp.asarray(x), 3)
    got = t_swd.laplacian_pyramid(torch.from_numpy(x), 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_descriptors_match_jax():
    x = _textured(1, 4, 32)
    key = jax.random.key(3)
    level = np.array(j_swd.laplacian_pyramid(jnp.asarray(x), 2)[1])
    want = j_swd._patch_descriptors(jnp.asarray(level), key, 16, 7)
    ky, kx, _ = jax.random.split(key, 3)
    ys = torch.from_numpy(np.asarray(
        jax.random.randint(ky, (64,), 0, level.shape[1] - 6)).astype(np.int64))
    xs = torch.from_numpy(np.asarray(
        jax.random.randint(kx, (64,), 0, level.shape[2] - 6)).astype(np.int64))
    got = t_swd._patch_descriptors(torch.from_numpy(level), ys, xs, 16, 7)
    assert tuple(got.shape) == want.shape == (64, 147)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("n,size,fake", [(8, 32, "other"), (4, 64, "blur")])
def test_swd_matches_jax_on_the_same_draws(n, size, fake):
    real = _textured(2, n, size)
    other = (_textured(3, n, size) if fake == "other"
             else np.array(j_swd._blur(jnp.asarray(real))))
    key = jax.random.key(5)
    want = j_swd.swd(jnp.asarray(real), jnp.asarray(other), key)
    levels = t_swd.laplacian_pyramid(torch.from_numpy(real), len(want) - 1)
    draws = _jax_draws(key, [tuple(lv.shape) for lv in levels])
    got = t_swd.swd(torch.from_numpy(real), torch.from_numpy(other),
                    draws=draws)
    assert set(got) == set(want)
    for name in want:
        w, g = float(want[name]), float(got[name])
        assert g > 0 and abs(g - w) <= 1e-3 * abs(w), (name, g, w)


def test_swd_identical_sets_is_zero():
    x = torch.from_numpy(_textured(4))
    res = t_swd.swd(x, x, torch.Generator().manual_seed(2))
    assert set(res) == {"swd_32", "swd_16", "swd_avg"}
    for name, value in res.items():
        assert abs(float(value)) <= 1e-4, name


def test_swd_orders_distribution_shift():
    """Mode collapse and blur rank above a second draw of the same
    distribution."""
    real = _textured(5, 32)
    same = torch.from_numpy(_textured(6, 32))
    collapsed = torch.from_numpy(np.repeat(real[:1], 32, axis=0))
    real = torch.from_numpy(real)
    box = torch.full((3, 1, 7, 7), 1.0 / 49.0)
    blurred = torch.nn.functional.conv2d(real.permute(0, 3, 1, 2), box,
                                         padding=3, groups=3)
    blurred = blurred.permute(0, 2, 3, 1)

    def d(fake):
        return float(t_swd.swd(real, fake, torch.Generator().manual_seed(4),
                               patches_per_image=128)["swd_avg"])

    near, collapse, blur = d(same), d(collapsed), d(blurred)
    assert collapse > 2.0 * near, (near, collapse)
    assert blur > 1.4 * near, (near, blur)


def test_swd_draws_come_from_the_generator():
    a, b = (torch.from_numpy(_textured(s)) for s in (7, 8))
    r1 = t_swd.swd(a, b, torch.Generator().manual_seed(9))
    r2 = t_swd.swd(a, b, torch.Generator().manual_seed(9))
    r3 = t_swd.swd(a, b, torch.Generator().manual_seed(10))
    assert all(float(r1[k]) == float(r2[k]) for k in r1)
    assert float(r1["swd_avg"]) != float(r3["swd_avg"])
    with pytest.raises(ValueError, match="generator or draws"):
        t_swd.swd(a, b)


def test_evaluate_returns_swd_within_the_cap(monkeypatch):
    """celebahq256_freeform asks for swd: evaluate pools at most
    eval.swd_max_images composites and returns swd_avg and swd_<res>."""
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.train import evaluate as ev

    cfg = apply_overrides(get_config("celebahq256_freeform"), [
        "model.base_features=8", "model.dtype_policy=f32",
        "data.image_size=32", "data.eval_batch_size=4",
        "data.num_eval_batches=2", "eval.swd_max_images=6"])
    assert "swd" in cfg.eval.metrics
    pooled = []

    def spy(real, fake, generator=None, **kw):
        pooled.append((tuple(real.shape), tuple(fake.shape)))
        return t_swd.swd(real, fake, generator, **kw)

    monkeypatch.setattr(ev, "swd", spy)
    g = build_generator(cfg.model, device="cpu", seed=0).state_dict()
    res = ev.evaluate(cfg, g, device="cpu")
    assert pooled == [((6, 32, 32, 3), (6, 32, 32, 3))]
    assert {"psnr", "ssim", "swd_avg", "swd_32", "swd_16"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())
    assert res["swd_avg"] > 0.0
    # the draws come from seed + 1234: the same call gives the same values
    assert ev.evaluate(cfg, g, device="cpu") == res
    # without swd in eval.metrics there are no swd keys and no composite
    cfg2 = apply_overrides(cfg, ["eval.metrics=psnr,ssim"])
    assert "_composite" not in ev.make_eval_step(cfg2, "cpu")(g, _batch(cfg2))
    assert not [k for k in ev.evaluate(cfg2, g, device="cpu") if "swd" in k]


def _batch(cfg):
    from gan_inpainting_torch.data.pipeline import make_train_batch

    imgs = torch.from_numpy(((_textured(11, 2) + 1) * 127.5).astype(np.uint8))
    return make_train_batch(imgs, torch.Generator().manual_seed(0), cfg.mask)
