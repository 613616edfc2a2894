"""The port's ops against the JAX package's, on identical numpy inputs.

Tolerances are float32: 1e-5 for exact rearrangements (patches, pads,
max-pools, bit-identical arithmetic), 1e-4 where a conv or a sum runs in
another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.ops import conv as jconv
from gan_inpainting_tpu.ops import patches as jpatches
from gan_inpainting_tpu.ops import upsample_conv as jup
from gan_inpainting_tpu.ops.contextual_attention import (
    downscale_mask_max as j_downscale_mask_max,
)
from gan_inpainting_tpu.ops.gated_conv import (
    _activation as j_activation,
    gated_conv_xla as j_gated_conv_xla,
)
from gan_inpainting_tpu.models.generator import _upsample2x as j_upsample2x

from gan_inpainting_torch.models.generator import _upsample2x
from gan_inpainting_torch.ops import contextual_attention as tca
from gan_inpainting_torch.ops import conv as tconv
from gan_inpainting_torch.ops import gated_conv as tgated
from gan_inpainting_torch.ops import patches as tpatches
from gan_inpainting_torch.ops import upsample_conv as tup

EXACT = dict(rtol=1e-5, atol=1e-5)
CONV = dict(rtol=1e-4, atol=1e-4)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("size,window,stride", [
    (8, 3, 1), (9, 3, 2), (8, 3, 2), (7, 4, 2), (16, 5, 1), (6, 2, 3)])
def test_same_pads(size, window, stride):
    assert tpatches.same_pads(size, window, stride) == jpatches.same_pads(
        size, window, stride)


@pytest.mark.parametrize("h,w,k,stride,dilation", [
    (8, 8, 3, 1, 1),
    (9, 7, 3, 2, 1),     # odd sizes, stride 2: extra pad on the high side
    (8, 10, 3, 2, 1),    # even sizes, stride 2
    (11, 11, 5, 1, 1),
    (12, 12, 3, 1, 4),   # dilated
    (6, 6, 4, 1, 1),     # even kernel: asymmetric pad at stride 1
])
def test_conv2d_matches_jax(h, w, k, stride, dilation):
    x = _normal(0, (2, h, w, 5))
    kern = _normal(1, (k, k, 5, 6))
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(kern), stride=stride,
                        dilation=dilation)
    got = tconv.conv2d(torch.from_numpy(x), _oihw(kern), stride=stride,
                       dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV)


@pytest.mark.parametrize("activation", ["elu", "relu", "leaky_relu", "none"])
@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_gated_conv_matches_jax(activation, stride, dilation):
    x = _normal(2, (2, 10, 10, 4))
    kern = _normal(3, (3, 3, 4, 12))
    bias = _normal(4, (12,))
    want = j_gated_conv_xla(jnp.asarray(x), jnp.asarray(kern),
                            jnp.asarray(bias), stride=stride,
                            dilation=dilation, activation=activation)
    got = tgated.gated_conv(torch.from_numpy(x), _oihw(kern),
                            torch.from_numpy(bias), stride=stride,
                            dilation=dilation, activation=activation)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV)


def test_parity_kernels_match_jax():
    kern = _normal(5, (3, 3, 4, 6))
    want = np.asarray(jup.parity_kernels(jnp.asarray(kern)))   # (2,2,I,4O)
    got = tup.parity_kernels(_oihw(kern)).numpy()               # (4O,I,2,2)
    np.testing.assert_allclose(got.transpose(2, 3, 1, 0), want, **EXACT)


@pytest.mark.parametrize("h,w", [(6, 6), (5, 7)])
def test_upsample_conv_matches_explicit_and_jax(h, w):
    x = _normal(6, (2, h, w, 4))
    kern = _normal(7, (3, 3, 4, 6))
    xt, wt = torch.from_numpy(x), _oihw(kern)
    explicit = tconv.conv2d(_upsample2x(xt), wt)
    fused = tup.upsample2x_conv2d_epilogue(xt, wt, lambda m: m)
    np.testing.assert_allclose(fused.numpy(), explicit.numpy(), **CONV)
    want = jup.upsample2x_conv2d(jnp.asarray(x), jnp.asarray(kern))
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), **CONV)
    np.testing.assert_array_equal(
        _upsample2x(xt).numpy(), np.asarray(j_upsample2x(jnp.asarray(x))))


def test_upsample_conv_gated_epilogue_matches_jax():
    x = _normal(8, (1, 6, 6, 4))
    kern = _normal(9, (3, 3, 4, 10))
    bias = _normal(10, (10,))
    jb = jnp.asarray(bias)

    def jepi(m):
        f, g = jnp.split(m + jb, 2, axis=-1)
        return j_activation("elu")(f) * (1 / (1 + jnp.exp(-g)))

    want = jup.upsample2x_conv2d_epilogue(jnp.asarray(x), jnp.asarray(kern),
                                          jepi)
    tb = torch.from_numpy(bias)
    got = tup.upsample2x_conv2d_epilogue(
        torch.from_numpy(x), _oihw(kern),
        lambda m: tgated.gated_epilogue(m + tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV)


@pytest.mark.parametrize("h,w,window,stride", [
    (8, 8, 3, 1), (8, 8, 4, 2), (7, 9, 3, 2), (6, 6, 2, 1)])
def test_extract_and_fold_patches_match_jax(h, w, window, stride):
    x = _normal(11, (2, h, w, 3))
    want = jpatches.extract_patches(jnp.asarray(x), window, stride)
    got = tpatches.extract_patches(torch.from_numpy(x), window, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pt = _normal(12, tuple(want.shape))
    jy, jcnt = jpatches.fold_patches(jnp.asarray(pt), stride, (h, w))
    ty, tcnt = tpatches.fold_patches(torch.from_numpy(pt), stride, (h, w))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **EXACT)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))


@pytest.mark.parametrize("rate", [1, 2, 4])
def test_downscale_mask_max_matches_jax(rate):
    rng = np.random.default_rng(13)
    mask = (rng.random((2, 16, 16, 1)) > 0.9).astype(np.float32)
    want = j_downscale_mask_max(jnp.asarray(mask), rate)
    got = tca.downscale_mask_max(torch.from_numpy(mask), rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
