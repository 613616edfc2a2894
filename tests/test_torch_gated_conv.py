"""The port's gated conv and its backend switch against the JAX package on
the CPU, float32.

Inputs come from numpy (seeded). The JAX side runs ``gated_conv_xla`` and,
in Pallas interpret mode, ``gated_conv_direct`` and ``gated_conv_pallas``.
Tolerance 2e-4, the JAX kernel tests' own (tests/kernels/test_direct_conv.py).
On the CPU every backend value of the port takes the plain version; the
PyTorch mirror of the CUDA kernel's index algebra (the tile walk, the TMA
box rows, the tap rows against JAX's im2col, the packed-weight order) is
held against it here, with the plan and the packed-weight cache.
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
    GatedPlan,
    a_tile,
    conv_geom,
    fill_bytes_per_flop,
    gated_conv_matmul,
    gated_conv_mirror,
    pack_weights,
    packed_weights,
    pad_channels,
    plan,
    tap_rows,
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
def test_kernel_tap_rows_match_jax_im2col(h, w, window, stride, dilation):
    """The windows the kernel reads (TF-SAME pads, the odd pixel on the
    high side at stride 2) are the JAX kernel's im2col rows."""
    rng = np.random.default_rng(h + window)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    want, (ho, wo) = j_im2col(jnp.asarray(x), window, stride, dilation)
    g = conv_geom(h, w, window, stride, dilation)
    assert (g.ho, g.wo) == (ho, wo)
    got = tap_rows(torch.from_numpy(x), g, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(got.shape))
    # channels past C read as zeros (taps padded to a whole slab)
    wide = tap_rows(torch.from_numpy(x), g, 8).reshape(-1, window ** 2, 8)
    assert wide[..., 3:].abs().sum() == 0


MIRROR_CASES = [
    # cin, f, k, stride, dilation, b, h, w
    (5, 6, 5, 1, 1, 2, 12, 10),      # a thin 5x5 stem: channels padded
    (8, 48, 5, 1, 1, 1, 8, 16),      # the 8-channel stem form: gathered
    (16, 24, 3, 1, 2, 2, 12, 10),    # F = 24 (wgmma N 48, cluster 2)
    (48, 24, 3, 1, 3, 1, 8, 16),     # Cin 48, taps padded to 64, box
    (48, 48, 3, 2, 1, 2, 12, 10),    # a stride-2 Cin = 48 encoder conv
    (8, 70, 3, 1, 1, 2, 12, 10),     # F above one 64-column block
    (96, 96, 3, 1, 1, 2, 8, 16),     # TMA box (16, 8, 1), N 192
    (192, 192, 3, 1, 16, 3, 4, 8),   # box (8, 4, 4), ragged M, two column
                                     # blocks, dilation beyond the map
    (384, 192, 3, 1, 4, 1, 8, 8),    # box (8, 8, 2), half a block
    (96, 192, 3, 2, 1, 2, 16, 16),   # stride 2, box (8, 8, 2) of strided
                                     # taps, the high-side pad
    (48, 96, 3, 2, 1, 1, 15, 13),    # stride 2 over an odd map: gathered
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,f,k,stride,dilation,b,h,w", MIRROR_CASES)
def test_kernel_index_algebra_mirror_matches_plain(dtype, cin, f, k, stride,
                                                   dilation, b, h, w):
    """The CUDA kernel as it indexes its operands — the persistent walk over
    tile groups, the TMA box rows (checked against the pixel order) or the
    gathered rows, the taps padded per slab, the packed weight rows and
    column blocks — against conv2d + epilogue, in float32."""
    x, kernel, bias = _case(cin + f, b, h, w, cin, f, k)
    xt, wt, bt = _torch(x, kernel, bias)
    p = plan(cin, f, dtype)
    vec = 8 if dtype == torch.bfloat16 else 4
    assert p.cin_pad % vec == 0 and 0 <= p.cin_pad - cin < vec
    assert p.kpt in (p.cin_pad, -(-cin // 32) * 32)
    wp = pack_weights(wt, p)
    k_dim = k * k * p.kpt
    k_pad = -(-k_dim // 32) * 32
    fp = p.block_f * p.n_col
    if p.kind == "wgmma":
        assert wp.shape == (k_pad // 32, 2 * fp, 32)
        # (slabs, n_col·2·BF, 32) → (K_pad, 2, F padded): K-major slabs,
        # each column block its features then its gates
        rows = wp.permute(0, 2, 1).reshape(k_pad, p.n_col, 2, p.block_f)
        rows = rows.transpose(1, 2).reshape(k_pad, 2, fp)
    else:
        assert wp.shape == (k_pad, 2, fp) and fp % p.block_f == 0
        rows = wp
    assert rows[k_dim:].abs().sum() == 0 and rows[..., f:].abs().sum() == 0
    # rows of the padded channels are zero
    assert rows[:k_dim].reshape(k * k, p.kpt, 2, fp)[:, cin:] \
        .abs().sum() == 0
    want = gated_conv_plain(xt, wt, bt, stride=stride, dilation=dilation,
                            activation="elu")
    ho, wo = want.shape[1:3]
    got = gated_conv_mirror(pad_channels(xt, p.cin_pad), wp, bt, f,
                            conv_geom(h, w, k, stride, dilation), p, "elu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_tma_boxes_for_the_generator_maps():
    """Which forms the bf16 kernel feeds by TMA: taps aligned to the 32-row
    slab (Cin 48 padded to 64) and 128 pixels forming a box."""
    bf = torch.bfloat16
    p192, p96, p48, p8 = (plan(c, 192 if c == 192 else 96, bf)
                          for c in (192, 96, 48, 8))
    assert a_tile(p192, 64, 64, 64, 1) == (64, 2, 1)
    assert a_tile(p192, 64, 16, 16, 1) == (16, 8, 1)
    assert a_tile(p96, 64, 128, 128, 1) == (128, 1, 1)
    assert a_tile(p96, 64, 64, 64, 2) == (64, 2, 1)          # box 128 x 4
    assert a_tile(p96, 16, 128, 128, 2) == (128, 1, 1)       # box 256
    assert a_tile(p192, 2, 4, 8, 1) == (8, 4, 4)
    assert a_tile(p192, 1, 13, 17, 1) is None                # odd map
    assert a_tile(p192, 1, 6, 48, 1) is None                 # 128 % 48
    assert a_tile(p48, 16, 256, 256, 1) == (128, 1, 1)       # Cin 48 → 64
    assert a_tile(p48, 1, 1, 1000, 1) is None
    assert a_tile(p8, 8, 256, 256, 1) is None                # the stem
    assert a_tile(plan(192, 192, torch.float32), 64, 64, 64, 1) is None


def test_plan_for_the_generator_widths():
    bf, f32 = torch.bfloat16, torch.float32
    assert plan(4, 48, bf) == ("wgmma", 8, 8, 48, 1, 4)    # the stem
    assert plan(4, 48, f32) == ("fma", 4, 4, 64, 1, 1)
    assert plan(5, 48, f32) == ("fma", 8, 8, 64, 1, 1)     # an odd Cin
    assert plan(48, 96, bf) == ("wgmma", 48, 64, 96, 1, 4)
    assert plan(192, 192, bf) == ("wgmma", 192, 192, 96, 2, 4)
    assert plan(48, 24, bf) == ("wgmma", 48, 64, 24, 1, 2)
    assert plan(6, 24, f32) == ("fma", 8, 8, 32, 1, 1)
    assert plan(384, 192, bf) == ("wgmma", 384, 384, 96, 2, 4)
    assert plan(96, 96, f32) == ("fma", 96, 96, 32, 3, 1)
    assert plan(8, 70, bf) == ("wgmma", 8, 8, 96, 1, 4)
    assert plan(16, 8, bf).kpt == 16 and plan(24, 8, bf).kpt == 32
    assert isinstance(plan(8, 8, bf), GatedPlan)
    # at least 128 FLOP per byte filled at 192 -> 2x192 (and 96 -> 2x96);
    # the earlier 128 x (64 + 64) tiles filled 64
    assert 1 / fill_bytes_per_flop(plan(192, 192, bf)) > 139
    assert 1 / fill_bytes_per_flop(plan(96, 96, bf)) > 139
    assert 1 / fill_bytes_per_flop(plan(48, 48, bf)) > 80
    assert 1 / fill_bytes_per_flop(plan(48, 24, bf)) > 40
    x = torch.ones(1, 2, 2, 5)
    assert pad_channels(x, 8).shape == (1, 2, 2, 8)
    assert pad_channels(x, 8)[..., 5:].abs().sum() == 0
    assert pad_channels(x, 5) is x


def test_packed_weights_are_cached_until_the_weight_changes():
    """One packed copy per weight tensor: reused while (data_ptr, version,
    dtype, plan) hold, repacked after an in-place update (an optimizer
    step) or for another dtype."""
    _, kernel, _ = _case(3, 1, 4, 4, 16, 24, 3)
    w = torch.nn.Parameter(torch.from_numpy(np.ascontiguousarray(
        kernel.transpose(3, 2, 0, 1))))
    p = plan(16, 24, torch.bfloat16)
    first = packed_weights(w, p, torch.bfloat16)
    assert first.dtype == torch.bfloat16
    assert torch.equal(first, pack_weights(w.detach().bfloat16(), p))
    assert packed_weights(w, p, torch.bfloat16) is first
    opt = torch.optim.Adam([w], lr=0.1)
    w.grad = torch.ones_like(w)
    opt.step()
    second = packed_weights(w, p, torch.bfloat16)
    assert second is not first
    assert torch.equal(second, pack_weights(w.detach().bfloat16(), p))
    assert not torch.equal(second, first)
    with torch.no_grad():
        w.mul_(2.0)
    assert torch.equal(packed_weights(w, p, torch.bfloat16),
                       pack_weights(w.detach().bfloat16(), p))
    p32 = plan(16, 24, torch.float32)
    assert packed_weights(w, p32, torch.float32).shape == \
        pack_weights(w.detach(), p32).shape
    # another layout of the same weight is kept beside the first
    assert packed_weights(w, p, torch.bfloat16) is \
        packed_weights(w, p, torch.bfloat16)


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
