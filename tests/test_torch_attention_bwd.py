"""Gradient of contextual attention: the port's autograd on the CPU against
``jax.grad`` of the JAX package (XLA path and, once, the Pallas in-kernel
backward in interpret mode), and the PyTorch mirror of the CUDA backward
kernels' index algebra against the plain (patch formulation) gradient.
Float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gan_inpainting_tpu.ops.contextual_attention import (
    _attention_inputs as j_attention_inputs,
    contextual_attention as j_contextual_attention,
)

from gan_inpainting_torch.ops.contextual_attention import contextual_attention
from gan_inpainting_torch.ops.kernels.fused_attention import (
    fused_attention_taps_plain,
)
from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
    contextual_attention_bwd,
    contextual_attention_bwd_plain,
    fold_tap_grads,
    plan_bwd,
    prepare_bwd,
    tap_grads_mirror,
    v_tap_geometry,
)


def _case(seed, b, h, w, c, hole_p=0.05):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, h, w, c)).astype(np.float32)
    hole = (rng.random((b, h, w, 1)) < hole_p).astype(np.float32)
    return f, hole


def _jax_grad(f, hole, rate, backend):
    def loss(x):
        return jnp.sum(jnp.sin(j_contextual_attention(
            x, x, jnp.asarray(hole), rate=rate, backend=backend)))
    return np.asarray(jax.grad(loss)(jnp.asarray(f)))


def _torch_grad(f, hole, rate):
    x = torch.from_numpy(f).requires_grad_(True)
    y = contextual_attention(x, x, torch.from_numpy(hole), rate=rate)
    torch.sum(torch.sin(y)).backward()
    return x.grad.numpy()


# 5e-4: the tolerance the JAX package holds its own kernels to against its
# XLA path; softmax at scale 10 amplifies float32 rounding of the scores
@pytest.mark.parametrize("b,h,w,c,rate,hole_p", [
    (2, 16, 16, 8, 2, 0.05), (1, 12, 20, 4, 2, 0.05), (1, 8, 8, 4, 1, 0.05),
    (1, 32, 32, 4, 4, 0.003)],
    ids=["square", "non_square", "rate1", "rate4"])
def test_attention_gradient_matches_jax_xla(b, h, w, c, rate, hole_p):
    f, hole = _case(b * h + c, b, h, w, c, hole_p)
    assert 0 < hole.sum() < hole.size
    got = _torch_grad(f, hole, rate)
    want = _jax_grad(f, hole, rate, "xla")
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_all_hole_sample_has_exactly_zero_gradient():
    f, hole = _case(3, 2, 16, 16, 8)
    hole[1] = 1.0
    got = _torch_grad(f, hole, 2)
    assert np.abs(got[0]).max() > 0
    assert np.array_equal(got[1], np.zeros_like(got[1]))
    np.testing.assert_allclose(got, _jax_grad(f, hole, 2, "xla"),
                               rtol=5e-4, atol=5e-4)


def test_attention_gradient_matches_pallas_inkernel_backward():
    """The JAX side through _bwd_dq_kernel / _bwd_dkv_kernel, as its own
    tests run them on the CPU."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal((2, 64, 64, 8)).astype(np.float32)
    hole = (rng.random((2, 64, 64, 1)) > 0.6).astype(np.float32)
    hole[:, :40, :40] = 0.0            # leave keys whose window has no hole
    with pltpu.force_tpu_interpret_mode():
        want = _jax_grad(f, hole, 2, "pallas")
    got = _torch_grad(f, hole, 2)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


# the mirror against the plain gradient: both float32 on the same inputs;
# 2e-4 of the largest gradient entry (different summation order)
@pytest.mark.parametrize("b,h,w,c,rate", [
    (3, 16, 16, 8, 2), (2, 12, 20, 4, 2), (1, 14, 14, 4, 2),
    (1, 16, 16, 4, 4), (1, 8, 8, 4, 1)],
    ids=["holes", "non_square", "odd_cells", "rate4", "rate1"])
def test_backward_mirror_matches_plain(b, h, w, c, rate):
    f, hole = _case(b + h, b, h, w, c, hole_p=0.02)
    if b >= 3:
        hole[0], hole[1] = 0.0, 1.0
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal(f.shape).astype(np.float32))
    f, hole = torch.from_numpy(f), torch.from_numpy(hole)
    taps, lse = fused_attention_taps_plain(f, hole, rate=rate, want_lse=True)
    maps, gmaps, bias, rnorm, (hs, ws) = prepare_bwd(f, hole, g, 3, rate)
    dq, dk, dv, tnorm, delta = tap_grads_mirror(
        maps, gmaps, bias, rnorm, lse, taps, hs, ws, rate, 10.0)
    assert dq.shape == dk.shape == (b, 9, hs * ws, c)
    assert dv.shape == (b, 4 * rate * rate, hs * ws, c)
    got = fold_tap_grads(maps, dq, dk, dv, tnorm, rnorm, hs, ws, rate, 10.0)
    want = contextual_attention_bwd_plain(f, hole, g, rate=rate)
    tol = 2e-4 * max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= tol
    if b >= 3:
        assert got[1].abs().max().item() == 0.0
        assert torch.isfinite(got).all()
    # on a CPU tensor the op's backward is the plain version
    again = contextual_attention_bwd(f, hole, taps, lse, g, rate=rate)
    assert torch.equal(again, want)


def test_gradient_maps_are_the_fold_adjoint():
    """<fold(taps), g> == Σ_taps <taps, do tap read from the gradient
    parity maps>: the tap geometry of ``do`` is the fold's transpose."""
    from gan_inpainting_torch.ops.kernels.fold import fold_taps_plain

    rng = np.random.default_rng(2)
    for rate, hs, ws in ((2, 5, 7), (1, 4, 4), (4, 3, 3)):
        c = 3
        taps = torch.from_numpy(rng.standard_normal(
            (2, 4 * rate * rate, hs * ws, c)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(
            (2, rate * hs, rate * ws, c)).astype(np.float32))
        f = torch.zeros_like(g)
        _, gmaps, _, _, _ = prepare_bwd(f, torch.zeros(2, rate * hs,
                                                       rate * ws, 1), g, 3,
                                        rate)
        lhs = (fold_taps_plain(taps, hs, ws, rate) * g).sum()
        rhs = sum((taps[:, t] * gmaps[:, pp, pq, op:op + hs, oq:oq + ws]
                   .reshape(2, hs * ws, c)).sum()
                  for t, (pp, pq, op, oq) in enumerate(v_tap_geometry(rate)))
        np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-4)


def test_plain_lse_is_the_logsumexp_of_the_jax_scores():
    f, hole = _case(5, 3, 16, 16, 8, hole_p=0.03)
    hole[2] = 1.0
    q, k, valid, _, _ = j_attention_inputs(
        jnp.asarray(f), jnp.asarray(f), jnp.asarray(hole), 3, 2)
    scores = 10.0 * jnp.einsum("bqd,bkd->bqk", q, k)
    scores = jnp.where(valid[:, None, :], scores, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    _, lse = fused_attention_taps_plain(torch.from_numpy(f),
                                        torch.from_numpy(hole),
                                        want_lse=True)
    lse = lse.numpy()
    np.testing.assert_allclose(lse[:2], want[:2], rtol=1e-5, atol=1e-4)
    # no valid key: 0, so that exp(s − lse) cannot overflow downstream
    assert np.array_equal(lse[2], np.zeros_like(lse[2]))


def test_backward_plan_fits_the_train_shapes():
    # (variant, rows, blocks per cluster) at the 256² and 512² train maps
    assert plan_bwd(32, 32, 192, torch.bfloat16, "dq") == ("mma", 32, 1)
    assert plan_bwd(32, 32, 192, torch.bfloat16, "dkv") == ("mma", 32, 1)
    assert plan_bwd(64, 64, 192, torch.bfloat16, "dq") == ("mma", 32, 2)
    assert plan_bwd(64, 64, 192, torch.bfloat16, "dkv") == ("mma", 32, 4)
    assert plan_bwd(64, 64, 192, torch.float32, "dq") == ("core", 4, 1)
    assert plan_bwd(7, 7, 4, torch.bfloat16, "dkv")[0] == "core"
    assert plan_bwd(128, 128, 64, torch.bfloat16, "dkv") == ("mma", 16, 8)
    with pytest.raises(ValueError, match="ROADMAP"):
        plan_bwd(256, 256, 192, torch.float32, "dq")
