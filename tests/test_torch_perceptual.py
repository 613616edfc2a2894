"""The VGG perceptual and style losses against the JAX package on the CPU.

The flax ``init_vgg`` params (seed 7) are carried across by
``io/convert.py`` and both sides see the same numpy images. Float32 compute
on both sides, tolerance 1e-4 on features (seven convs deep) and 1e-5
relative on the scalar losses; the bfloat16 trunk, which the train step
uses, is held to 2 % (each side rounds activations to bf16 at its own
places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.losses.perceptual import gram_matrix as j_gram
from gan_inpainting_tpu.losses.perceptual import init_vgg as j_init_vgg
from gan_inpainting_tpu.losses.perceptual import (
    perceptual_and_style_loss as j_loss,
)

from gan_inpainting_torch.io.convert import params_from_jax, vgg_state_from_npz
from gan_inpainting_torch.losses.perceptual import (
    VGG16Features,
    gram_matrix,
    init_vgg,
    perceptual_and_style_loss,
)


def _images(seed, b=2, size=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def _pair(dtype_j, dtype_t):
    model, params = j_init_vgg(compute_dtype=dtype_j)
    params_np = {k: {n: np.asarray(a) for n, a in v.items()}
                 for k, v in params.items()}
    vgg = VGG16Features(compute_dtype=dtype_t)
    vgg.load_state_dict(params_from_jax(params_np), strict=True)
    return model, params, params_np, vgg.requires_grad_(False)


def test_vgg_features_match_flax():
    model, params, _, vgg = _pair(jnp.float32, torch.float32)
    x = _images(0)
    want = model.apply({"params": params}, jnp.asarray(x))
    got = vgg(torch.from_numpy(x))
    assert [tuple(f.shape) for f in got] == [(2, 16, 16, 64), (2, 8, 8, 128),
                                             (2, 4, 4, 256)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_gram_matrix_matches_jax():
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    np.testing.assert_allclose(gram_matrix(torch.from_numpy(feat)).numpy(),
                               np.asarray(j_gram(jnp.asarray(feat))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype_j,dtype_t,rtol", [
    (jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-2)])
def test_perceptual_and_style_loss_match_jax(dtype_j, dtype_t, rtol):
    model, params, _, vgg = _pair(dtype_j, dtype_t)
    out, tgt = _images(2), _images(3)
    want_p, want_s = j_loss(lambda p, x: model.apply({"params": p}, x),
                            params, jnp.asarray(out), jnp.asarray(tgt))
    o = torch.from_numpy(out).requires_grad_(True)
    t = torch.from_numpy(tgt).requires_grad_(True)
    got_p, got_s = perceptual_and_style_loss(vgg, o, t)
    assert got_p.dtype == got_s.dtype == torch.float32
    np.testing.assert_allclose(float(got_p), float(want_p), rtol=rtol)
    np.testing.assert_allclose(float(got_s), float(want_s), rtol=rtol)
    (got_p + got_s).backward()
    assert o.grad is not None and o.grad.abs().max() > 0
    assert t.grad is None                       # the target is a constant


def test_converted_npz_round_trip(tmp_path):
    """A converted-weights file written from the flax params (plus a block
    the three-block trunk does not read) loads into the same features."""
    _, _, params_np, vgg = _pair(jnp.float32, torch.float32)
    flat = {f"{name}/{leaf}": arr for name, leaves in params_np.items()
            for leaf, arr in leaves.items()}
    flat["conv4_1/kernel"] = np.zeros((3, 3, 256, 512), np.float32)
    flat["conv4_1/bias"] = np.zeros(512, np.float32)
    path = tmp_path / "vgg16.npz"
    np.savez(path, **flat)
    loaded = init_vgg(str(path), compute_dtype=torch.float32, device="cpu")
    assert not any(p.requires_grad for p in loaded.parameters())
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, loaded.state_dict()[k]), k
    x = torch.from_numpy(_images(4))
    for a, b in zip(vgg(x), loaded(x)):
        assert torch.equal(a, b)
    del flat["conv2_2/bias"]
    np.savez(path, **flat)
    with pytest.raises(KeyError, match="conv2_2/bias"):
        vgg_state_from_npz(str(path), vgg.state_dict())
    flat["conv2_2/bias"] = np.zeros(7, np.float32)
    np.savez(path, **flat)
    with pytest.raises(ValueError, match="conv2_2.bias"):
        vgg_state_from_npz(str(path), vgg.state_dict())


def test_random_vgg_is_seeded_and_frozen():
    a = init_vgg(device="cpu")
    b = init_vgg(device="cpu")
    assert a.compute_dtype == torch.bfloat16
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert not any(p.requires_grad for p in a.parameters())
    assert float(a.state_dict()["conv1_1.weight"].std()) > 0
