"""The space-to-depth stem conv against the JAX package and against the
port's own plain 5×5 conv, float32 on the CPU. ``cell_kernel`` only
rearranges the parameter, so it must agree exactly; the conv within 1e-5
(the same products summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.ops.s2d_conv import cell_kernel as j_cell_kernel
from gan_inpainting_tpu.ops.s2d_conv import (
    s2d_conv5x5_epilogue as j_s2d_conv,
)

from gan_inpainting_torch.ops.conv import conv2d
from gan_inpainting_torch.ops.gated_conv import gated_epilogue
from gan_inpainting_torch.ops.s2d_conv import cell_kernel, s2d_conv5x5_epilogue


def _oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("c,f", [(4, 6), (5, 16), (1, 2)])
def test_cell_kernel_matches_jax(c, f):
    rng = np.random.default_rng(c + f)
    k = rng.standard_normal((5, 5, c, f)).astype(np.float32)
    want = np.asarray(j_cell_kernel(jnp.asarray(k)))          # (3,3,4C,4F)
    got = cell_kernel(_oihw(k))                               # (4F,4C,3,3)
    assert got.shape == (4 * f, 4 * c, 3, 3)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


@pytest.mark.parametrize("h,w", [(16, 16), (10, 14)])
@pytest.mark.parametrize("gated", [False, True])
def test_s2d_conv_matches_jax_and_plain_conv(h, w, gated):
    rng = np.random.default_rng(h + w)
    c, f2 = 5, 12
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    k = (0.2 * rng.standard_normal((5, 5, c, f2))).astype(np.float32)
    bias = rng.standard_normal(f2).astype(np.float32)

    def j_epilogue(m):
        m = m + jnp.asarray(bias)
        if not gated:
            return jnp.tanh(m)
        a, g = jnp.split(m, 2, axis=-1)
        return jnp.tanh(a) * (1.0 / (1.0 + jnp.exp(-g)))

    def epilogue(m):
        m = m + torch.from_numpy(bias)
        return gated_epilogue(m, "tanh") if gated else torch.tanh(m)

    want = np.asarray(j_s2d_conv(jnp.asarray(x), jnp.asarray(k), j_epilogue))
    xt, wt = torch.from_numpy(x), _oihw(k)
    got = s2d_conv5x5_epilogue(xt, wt, epilogue)
    plain = epilogue(conv2d(xt, wt))
    assert got.shape == (2, h, w, f2 // 2 if gated else f2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_s2d_conv_refuses_odd_sizes_and_other_windows():
    w5 = torch.zeros(4, 3, 5, 5)
    with pytest.raises(ValueError, match="even"):
        s2d_conv5x5_epilogue(torch.zeros(1, 7, 8, 3), w5, lambda m: m)
    with pytest.raises(ValueError, match="5x5"):
        s2d_conv5x5_epilogue(torch.zeros(1, 8, 8, 3), torch.zeros(4, 3, 3, 3),
                             lambda m: m)
