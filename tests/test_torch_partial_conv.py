"""The port's partial conv against the JAX package on the CPU, float32.

Inputs come from numpy (seeded). The JAX side runs its XLA composition and
its Pallas epilogue kernel in interpret mode. Tolerance 1e-5: one conv and
a handful of float32 elementwise steps; the window counts are small
integers and must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gan_inpainting_tpu.ops.pallas.fused_matmul import (
    partial_conv_epilogue_pallas,
)
from gan_inpainting_tpu.ops.partial_conv import _window_counts as j_counts
from gan_inpainting_tpu.ops.partial_conv import partial_conv as j_partial_conv
from gan_inpainting_tpu.ops.partial_conv import partial_conv_epilogue_xla

from gan_inpainting_torch.ops import dispatch
from gan_inpainting_torch.ops.kernels.partial_epilogue import (
    epilogue_grads,
    partial_conv_epilogue,
)
from gan_inpainting_torch.ops.partial_conv import (
    _window_counts,
    partial_conv,
    partial_conv_epilogue_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _valid(rng, b, h, w, hole=True):
    valid = (rng.random((b, h, w, 1)) > 0.4).astype(np.float32)
    if hole:
        valid[0, : h // 2 + 2, : w // 2 + 3] = 0.0   # windows with no pixel
    return valid


@pytest.mark.parametrize("h,w", [(16, 16), (13, 17), (7, 10)])
@pytest.mark.parametrize("window,stride,dilation", [
    (3, 1, 1), (3, 2, 1), (5, 1, 1), (3, 1, 2), (5, 2, 1), (3, 2, 2)])
def test_window_counts_match_jax(h, w, window, stride, dilation):
    rng = np.random.default_rng(h * w + window)
    valid = _valid(rng, 2, h, w)
    want = np.asarray(j_counts(jnp.asarray(valid), window, stride, dilation))
    got = _window_counts(torch.from_numpy(valid), window, stride, dilation)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["xla", "pallas", "auto"])
@pytest.mark.parametrize("window,stride,dilation", [
    (3, 1, 1), (3, 2, 1), (5, 1, 1), (3, 1, 4)])
def test_partial_conv_matches_jax(backend, window, stride, dilation):
    rng = np.random.default_rng(window + stride + dilation)
    b, h, w, cin, cout = 2, 14, 18, 5, 8
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    valid = _valid(rng, b, h, w)
    kernel = (0.2 * rng.standard_normal((window, window, cin, cout))).astype(
        np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_y, want_v = j_partial_conv(
            jnp.asarray(x), jnp.asarray(valid), jnp.asarray(kernel),
            jnp.asarray(bias), stride=stride, dilation=dilation,
            backend="xla" if backend == "auto" else backend)
    before = dict(dispatch.launches)
    got_y, got_v = partial_conv(
        torch.from_numpy(x), torch.from_numpy(valid),
        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(bias), stride=stride, dilation=dilation,
        backend=backend)
    assert dispatch.launches == before          # CPU: the plain version
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # a window with no valid pixel: exactly 0 out and invalid
    dead = np.asarray(want_v)[..., 0] == 0
    assert dead.any() and (~dead).any()
    assert (got_y.numpy()[dead] == 0).all()
    assert set(np.unique(got_v.numpy())) == {0.0, 1.0}


def _epilogue_case(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((2, 9, 11, 12)).astype(dtype)
    counts = rng.integers(0, 10, (2, 9, 11, 1)).astype(np.float32)
    counts[0, :3] = 0.0
    bias = rng.standard_normal(12).astype(np.float32)
    return raw, counts, bias


def test_epilogue_matches_jax_xla_and_pallas_interpret():
    raw, counts, bias = _epilogue_case()
    args = tuple(jnp.asarray(a) for a in (raw, counts, bias))
    want = partial_conv_epilogue_xla(*args, 3)
    with pltpu.force_tpu_interpret_mode():
        want_p = partial_conv_epilogue_pallas(*args, 3)
    targs = tuple(torch.from_numpy(a) for a in (raw, counts, bias))
    for fn in (partial_conv_epilogue_plain, partial_conv_epilogue):
        y, v = fn(*targs, 3)
        for w_y, w_v in (want, want_p):
            np.testing.assert_allclose(y.numpy(), np.asarray(w_y), **TOL)
            np.testing.assert_array_equal(v.numpy(), np.asarray(w_v))
        assert (y.numpy()[counts[..., 0] == 0] == 0).all()


def test_epilogue_zero_count_ignores_raw_garbage():
    raw, counts, bias = _epilogue_case(1)
    raw[counts[..., 0] == 0] = 1e30
    y, v = partial_conv_epilogue_plain(*(torch.from_numpy(a) for a in
                                         (raw, counts, bias)), 3)
    assert (y.numpy()[counts[..., 0] == 0] == 0).all()
    assert (v.numpy()[counts[..., 0] == 0] == 0).all()


def test_epilogue_gradient_formula_matches_jax_grad():
    """The backward the CUDA ``Function`` takes (``epilogue_grads``) against
    ``jax.grad`` of the XLA epilogue and autograd of the plain version."""
    raw, counts, bias = _epilogue_case(2)
    rng = np.random.default_rng(3)
    g = rng.standard_normal(raw.shape).astype(np.float32)

    def loss(r, b_):
        y, _ = partial_conv_epilogue_xla(r, jnp.asarray(counts), b_, 3)
        return jnp.sum(y * jnp.asarray(g))

    want_raw, want_bias = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(raw), jnp.asarray(bias))
    d_raw, d_bias = epilogue_grads(torch.from_numpy(g),
                                   torch.from_numpy(counts), 3)
    np.testing.assert_allclose(d_raw.numpy(), np.asarray(want_raw), **TOL)
    np.testing.assert_allclose(d_bias.numpy(), np.asarray(want_bias),
                               rtol=1e-5, atol=1e-4)
    r = torch.from_numpy(raw).requires_grad_(True)
    b_ = torch.from_numpy(bias).requires_grad_(True)
    y, _ = partial_conv_epilogue(r, torch.from_numpy(counts), b_, 3)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(r.grad.numpy(), d_raw.numpy(), **TOL)
    np.testing.assert_allclose(b_.grad.numpy(), d_bias.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_epilogue_wrapper_checks_shapes():
    raw, counts, bias = (torch.from_numpy(a) for a in _epilogue_case())
    with pytest.raises(ValueError, match="counts"):
        partial_conv_epilogue(raw, counts[..., 0], bias, 3)
    with pytest.raises(ValueError, match="bias"):
        partial_conv_epilogue(raw, counts, bias[:5], 3)
