"""Discriminator, losses and image metrics of the port against the JAX
package on the CPU, float32, from converted parameters and numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.losses import adversarial as j_adv
from gan_inpainting_tpu.losses import reconstruction as j_rec
from gan_inpainting_tpu.metrics import image as j_image
from gan_inpainting_tpu.models.discriminator import (
    PatchDiscriminator as JPatchDiscriminator,
)
from gan_inpainting_tpu.models.layers import SNConv as JSNConv

from gan_inpainting_torch.io.convert import discriminator_from_jax
from gan_inpainting_torch.losses import adversarial, reconstruction
from gan_inpainting_torch.metrics import image
from gan_inpainting_torch.models.discriminator import PatchDiscriminator
from gan_inpainting_torch.models.layers import SNConv


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("use_sn", [False, True])
def test_snconv_matches_flax(use_sn):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 9, 3)).astype(np.float32)
    jmod = JSNConv(features=6, kernel_size=5, stride=2, use_sn=use_sn,
                   compute_dtype=jnp.float32)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    params = _np(variables["params"])
    stats = _np(variables.get("spectral", {}))
    mod = SNConv(3, 6, 5, 2, use_sn=use_sn, compute_dtype=torch.float32)
    mod.load_state_dict(discriminator_from_jax(params, stats))
    want = jmod.apply(variables, jnp.asarray(x))
    got = mod(_t(x))
    # 1e-5: one float32 conv over 75 taps
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if not use_sn:
        return
    assert torch.equal(mod.u, _t(stats["u"]))      # not updated by default
    want, mutated = jmod.apply(variables, jnp.asarray(x), update_stats=True,
                               mutable=["spectral"])
    got = mod(_t(x), update_stats=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.u.numpy(),
                               np.asarray(mutated["spectral"]["u"]),
                               rtol=1e-5, atol=1e-6)
    assert "u" in mod.state_dict() and "u" not in dict(mod.named_parameters())

    # the gradient flows through σ but not through u and v
    def j_loss(p):
        return jnp.sum(jnp.sin(jmod.apply(
            {"params": p, "spectral": variables["spectral"]},
            jnp.asarray(x))))
    j_grad = jax.grad(j_loss)(variables["params"])
    mod.load_state_dict(discriminator_from_jax(params, stats))
    torch.sum(torch.sin(mod(_t(x)))).backward()
    np.testing.assert_allclose(
        mod.weight.grad.numpy(),
        np.asarray(j_grad["kernel"]).transpose(3, 2, 0, 1),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spectral_norm", [False, True])
def test_patch_discriminator_matches_flax(spectral_norm):
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 1)) < 0.3).astype(np.float32)
    jmod = JPatchDiscriminator(base_features=8, num_layers=3,
                               spectral_norm=spectral_norm,
                               compute_dtype=jnp.float32)
    variables = jmod.init(jax.random.key(1), jnp.asarray(img),
                          jnp.asarray(mask))
    mod = PatchDiscriminator(8, 3, spectral_norm, torch.float32)
    mod.load_state_dict(discriminator_from_jax(
        _np(variables["params"]), _np(variables.get("spectral", {}))))
    if spectral_norm:
        (want, want_feats), mutated = jmod.apply(
            variables, jnp.asarray(img), jnp.asarray(mask),
            update_stats=True, return_features=True, mutable=["spectral"])
    else:
        want, want_feats = jmod.apply(variables, jnp.asarray(img),
                                      jnp.asarray(mask), return_features=True)
    got, feats = mod(_t(img), _t(mask), update_stats=True,
                     return_features=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert len(feats) == len(want_feats) == 3
    for a, b in zip(feats, want_feats):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    if spectral_norm:
        for name, sub in mutated["spectral"].items():
            np.testing.assert_allclose(getattr(mod, name).u.numpy(),
                                       np.asarray(sub["u"]), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("kind", ["hinge", "bce", "lsgan"])
def test_adversarial_losses_match_jax(kind):
    rng = np.random.default_rng(2)
    real = (2 * rng.standard_normal((4, 5, 5, 1))).astype(np.float32)
    fake = (2 * rng.standard_normal((4, 5, 5, 1))).astype(np.float32)
    np.testing.assert_allclose(
        adversarial.d_loss(_t(real), _t(fake), kind).item(),
        float(j_adv.d_loss(jnp.asarray(real), jnp.asarray(fake), kind)),
        rtol=1e-6)
    np.testing.assert_allclose(
        adversarial.g_loss(_t(fake), kind).item(),
        float(j_adv.g_loss(jnp.asarray(fake), kind)), rtol=1e-6)
    with pytest.raises(ValueError):
        adversarial.d_loss(_t(real), _t(fake), "wgan")


def test_r1_penalty_matches_jax_and_is_differentiable():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 6, 6, 2)).astype(np.float32)
    w = rng.standard_normal((2,)).astype(np.float32)

    def j_score(wv):
        return lambda im: jnp.sum(jnp.tanh(im * wv) ** 2, axis=(1, 2))

    want = j_adv.r1_penalty(j_score(jnp.asarray(w)), jnp.asarray(x))
    want_grad = jax.grad(lambda wv: j_adv.r1_penalty(
        j_score(wv), jnp.asarray(x)))(jnp.asarray(w))
    wt = _t(w).requires_grad_(True)
    got = adversarial.r1_penalty(
        lambda im: torch.sum(torch.tanh(im * wt) ** 2, dim=(1, 2)), _t(x))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()          # second order, through the inner gradient
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-6)


def _images(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    c = np.clip(a + 0.2 * rng.standard_normal(a.shape), -1, 1)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[0, 4:17, 6:20] = 1
    mask[1, :, :9] = 1
    return a, c.astype(np.float32), mask


@pytest.mark.parametrize("gamma", [0.0, 0.9])
def test_l1_loss_and_discount_match_jax(gamma):
    a, c, mask = _images(4)
    got = reconstruction.l1_loss(_t(a), _t(c), _t(mask), hole_weight=6.0,
                                 valid_weight=1.0, discount_gamma=gamma)
    want = j_rec.l1_loss(jnp.asarray(a), jnp.asarray(c), jnp.asarray(mask),
                         hole_weight=6.0, valid_weight=1.0,
                         discount_gamma=gamma)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    disc = reconstruction.spatial_discount_mask(_t(mask), 0.9, iters=5)
    np.testing.assert_allclose(
        disc.numpy(),
        np.asarray(j_rec.spatial_discount_mask(jnp.asarray(mask), 0.9,
                                               iters=5)), rtol=1e-6)


@pytest.mark.parametrize("dilation", [0, 1, 2])
def test_tv_loss_matches_jax(dilation):
    a, _, mask = _images(5)
    got = reconstruction.tv_loss(_t(a), _t(mask), dilation=dilation)
    want = j_rec.tv_loss(jnp.asarray(a), jnp.asarray(mask), dilation=dilation)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_psnr_and_ssim_match_jax():
    a, c, _ = _images(6, b=3, s=32)
    np.testing.assert_allclose(
        image.psnr(_t(a), _t(c)).numpy(),
        np.asarray(j_image.psnr(jnp.asarray(a), jnp.asarray(c))), rtol=1e-5)
    # 1e-4: the variance terms cancel to ~c2, which amplifies float32
    # rounding of the 121-tap filters
    np.testing.assert_allclose(
        image.ssim(_t(a), _t(c)).numpy(),
        np.asarray(j_image.ssim(jnp.asarray(a), jnp.asarray(c))),
        rtol=1e-4, atol=1e-5)
    assert image.ssim(_t(a), _t(a)).numpy() == pytest.approx(1.0, abs=1e-5)
    assert image.psnr(_t(a), _t(a)).min().item() > 100
    assert image.ssim(_t(a).bfloat16(), _t(c)).dtype == torch.float32
