"""The port's gated conv and its backend switch against the JAX package on
the CPU, float32.

Inputs come from numpy (seeded). The JAX side runs ``gated_conv_xla`` and,
in Pallas interpret mode, ``gated_conv_direct`` and ``gated_conv_pallas``.
Tolerance 2e-4, the JAX kernel tests' own (tests/kernels/test_direct_conv.py).
On the CPU every backend value of the port takes the plain version; the
PyTorch mirror of the CUDA kernels' index algebra (im2col order against the
packed-weight order) is held against it here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gan_inpainting_tpu.ops.gated_conv import gated_conv_xla
from gan_inpainting_tpu.ops.pallas.direct_conv import (
    gated_conv_direct as j_direct,
)
from gan_inpainting_tpu.ops.pallas.fused_matmul import _im2col as j_im2col
from gan_inpainting_tpu.ops.pallas.fused_matmul import gated_conv_pallas

from gan_inpainting_torch.ops import dispatch
from gan_inpainting_torch.ops.gated_conv import gated_conv, gated_conv_plain
from gan_inpainting_torch.ops.kernels.direct_conv import (
    direct_conv_supported,
    gated_conv_direct,
)
from gan_inpainting_torch.ops.kernels.gated_matmul import (
    _im2col,
    gated_conv_matmul,
    gated_matmul_mirror,
    pack_weights,
    pad_channels,
    plan,
)

TOL = dict(rtol=2e-4, atol=2e-4)
ACTS = ["elu", "relu", "leaky_relu", "tanh", "none"]


def _case(seed, b, h, w, cin, f, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    kernel = (rng.standard_normal((k, k, cin, 2 * f))
              / np.sqrt(k * k * cin)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(2 * f)).astype(np.float32)
    return x, kernel, bias


def _torch(x, kernel, bias):
    return (torch.from_numpy(x),
            torch.from_numpy(np.ascontiguousarray(
                kernel.transpose(3, 2, 0, 1))), torch.from_numpy(bias))


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("k,stride,dilation", [
    (3, 1, 1), (3, 2, 1), (5, 1, 1), (3, 1, 2), (3, 1, 4), (5, 2, 1)])
def test_gated_conv_matches_jax_xla(activation, k, stride, dilation):
    x, kernel, bias = _case(k + stride + dilation, 2, 16, 16, 5, 6, k)
    want = np.asarray(gated_conv_xla(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
        stride=stride, dilation=dilation, activation=activation))
    before = dict(dispatch.launches)
    for backend in ("auto", "xla", "pallas"):
        got = gated_conv(*_torch(x, kernel, bias), stride=stride,
                         dilation=dilation, activation=activation,
                         backend=backend)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert dispatch.launches == before          # CPU: the plain version


@pytest.mark.parametrize("activation", ["elu", "relu"])
@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 2), (5, 1), (3, 4)])
def test_direct_wrapper_matches_jax_direct_interpret(activation, k, dilation):
    x, kernel, bias = _case(k * dilation, 1, 16, 16, 8, 8, k)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_direct(
            jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
            dilation=dilation, activation=activation))
    got = gated_conv_direct(*_torch(x, kernel, bias), dilation=dilation,
                            activation=activation)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("activation", ["elu", "leaky_relu"])
@pytest.mark.parametrize("k,stride,dilation", [(3, 2, 1), (3, 1, 2),
                                               (5, 2, 1)])
def test_matmul_wrapper_matches_jax_pallas_interpret(activation, k, stride,
                                                     dilation):
    x, kernel, bias = _case(k + stride, 1, 16, 16, 8, 8, k)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gated_conv_pallas(
            jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
            stride=stride, dilation=dilation, activation=activation))
    got = gated_conv_matmul(*_torch(x, kernel, bias), stride=stride,
                            dilation=dilation, activation=activation)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("h,w", [(16, 16), (13, 17)])
@pytest.mark.parametrize("window,stride,dilation", [
    (3, 1, 1), (3, 2, 1), (5, 1, 1), (3, 1, 2), (5, 2, 2)])
def test_im2col_matches_jax(h, w, window, stride, dilation):
    rng = np.random.default_rng(h + window)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    want, (ho, wo) = j_im2col(jnp.asarray(x), window, stride, dilation)
    got, hw = _im2col(torch.from_numpy(x), window, stride, dilation)
    assert hw == (ho, wo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,f,k,stride,dilation", [
    (5, 6, 5, 1, 1),       # a thin 5x5 stem: channels padded to the vector
    (16, 24, 3, 1, 2),     # F padded to 32
    (48, 48, 3, 2, 1),     # a stride-2 encoder conv
    (8, 70, 3, 1, 1),      # F above one 64-column block
])
def test_kernel_index_algebra_mirror_matches_plain(dtype, cin, f, k, stride,
                                                   dilation):
    """im2col rows times the packed weight halves, as the CUDA kernels
    index them, against conv2d + epilogue."""
    x, kernel, bias = _case(cin + f, 2, 12, 10, cin, f, k)
    xt, wt, bt = _torch(x, kernel, bias)
    cin_pad, kc, bn, fp = plan(cin, f, dtype)
    vec = 8 if dtype == torch.bfloat16 else 4
    assert cin_pad % vec == 0 and 0 <= cin_pad - cin < vec
    wp = pack_weights(wt, kc, fp, cin_pad)
    k_dim = k * k * cin_pad
    assert wp.shape == (-(-k_dim // kc) * kc, 2, fp) and fp % bn == 0
    assert wp[k_dim:].abs().max() == 0 if wp.shape[0] > k_dim else True
    assert wp[..., f:].abs().max() == 0 if fp > f else True
    # rows of the padded channels are zero
    assert wp[:k_dim].reshape(k * k, cin_pad, 2, fp)[:, cin:].abs().sum() == 0
    cols, (ho, wo) = _im2col(pad_channels(xt, cin_pad), k, stride, dilation)
    got = gated_matmul_mirror(cols.reshape(-1, k_dim), wp, bt, f, "elu")
    want = gated_conv_plain(xt, wt, bt, stride=stride, dilation=dilation,
                            activation="elu")
    np.testing.assert_allclose(got.reshape(2, ho, wo, f).numpy(),
                               want.numpy(), **TOL)


def test_plan_for_the_generator_widths():
    bf, f32 = torch.bfloat16, torch.float32
    assert plan(4, 48, bf) == (8, 64, 64, 64)       # the stem, padded to 8
    assert plan(4, 48, f32) == (4, 32, 64, 64)
    assert plan(5, 48, f32) == (8, 32, 64, 64)      # an odd Cin
    assert plan(48, 96, bf) == (48, 64, 32, 96)
    assert plan(192, 192, bf) == (192, 64, 64, 192)
    assert plan(48, 24, bf) == (48, 64, 32, 32)
    assert plan(6, 24, f32) == (8, 32, 32, 32)
    assert plan(384, 192, bf) == (384, 64, 64, 192)
    assert plan(96, 96, f32) == (96, 32, 32, 96)
    x = torch.ones(1, 2, 2, 5)
    assert pad_channels(x, 8).shape == (1, 2, 2, 8)
    assert pad_channels(x, 8)[..., 5:].abs().sum() == 0
    assert pad_channels(x, 5) is x


def test_direct_conv_supported_and_refusals():
    assert direct_conv_supported((2, 16, 16, 8), 3, 1, 16, 8)
    assert not direct_conv_supported((2, 16, 16, 8), 3, 2, 1, 8)
    assert not direct_conv_supported((2, 16, 16, 8), 4, 1, 1, 8)
    x, kernel, bias = _case(0, 1, 8, 8, 4, 4, 3)
    xt, wt, bt = _torch(x, kernel, bias)
    with pytest.raises(ValueError, match="stride 1"):
        gated_conv_direct(xt, wt, bt, stride=2)
    with pytest.raises(ValueError, match="activation"):
        gated_conv_matmul(xt, wt, bt, activation="gelu")
    with pytest.raises(ValueError, match="2F"):
        gated_conv_matmul(xt, wt[:5], bt[:5])


def test_resolve_backend_and_override():
    from gan_inpainting_tpu.ops.dispatch import AUTO_TPU

    assert set(dispatch.AUTO_CUDA) == set(AUTO_TPU)
    assert set(dispatch.AUTO_CUDA.values()) <= {"xla", "pallas"}
    assert dispatch.AUTO_CUDA["contextual_attention"] == "pallas"
    assert dispatch.resolve_backend("xla", "gated_conv") == "xla"
    assert dispatch.resolve_backend("pallas", "gated_conv") == "pallas"
    for op, want in dispatch.AUTO_CUDA.items():
        assert dispatch.resolve_backend("auto", op) == want
    assert dispatch.resolve_backend("auto") == "pallas"
    assert dispatch.resolve_backend("auto", "an_op_without_a_row") == "pallas"
    with pytest.raises(ValueError, match="backend must be"):
        dispatch.resolve_backend("cuda", "gated_conv")
    with dispatch.override_backend("pallas"):
        assert dispatch.resolve_backend("xla", "gated_conv") == "pallas"
        with dispatch.override_backend("xla"):
            assert dispatch.resolve_backend("pallas", "partial_conv") == "xla"
        assert dispatch.resolve_backend("auto", "gated_conv") == "pallas"
    assert dispatch.resolve_backend("xla", "gated_conv") == "xla"


def test_gated_conv_gradients_match_under_every_backend():
    x, kernel, bias = _case(7, 1, 8, 8, 4, 4, 3)
    grads = []
    for backend in ("xla", "pallas"):
        leaves = [t.requires_grad_(True) for t in _torch(x, kernel, bias)]
        gated_conv(*leaves, dilation=2, backend=backend).square().sum() \
            .backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_bench_conv_reads_the_layer_forms_off_the_generator():
    """tools/bench_conv.py times what the model runs: 29 stride-1 and 6
    stride-2 kernel-routed gated convs per serve_v4_8 forward (fused
    decoder), every form keyed by (Cin, F, k, stride, dilation, map)."""
    from gan_inpainting_torch.tools.bench_conv import gated_layers

    layers = gated_layers("serve_v4_8", 64, device="cpu")
    assert sum(n for n, *_ in layers) == 35
    assert sum(n for n, _, _, _, stride, _, _ in layers if stride == 2) == 6
    forms = {tuple(form): n for n, *form in layers}
    assert forms[(4, 48, 5, 1, 1, 64)] == 3           # the three stems
    assert forms[(192, 192, 3, 1, 16, 16)] == 2
    assert forms[(384, 192, 3, 1, 1, 16)] == 1        # after the concat
    assert forms[(48, 24, 3, 1, 1, 64)] == 2
