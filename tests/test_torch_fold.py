"""The two overlap-add folds of csrc/fold.cu, through their PyTorch mirrors
on the CPU:

* ``gi_fold_taps`` (the attention forward's fold): ``fold_taps_mirror``,
  the kernel's closed-form gather, against the JAX Pallas fold in
  interpret mode and against the port's plain fold; the kernel's inverse
  overlap counts against ``fold_counts_inv``; the vector width it takes;
* ``gi_fold_tap_grads`` (the fused backward's epilogue):
  ``fold_tap_grads_mirror``, the kernel's per-pixel gather table, against
  the eager ``fold_tap_grads_plain``; and the port's whole fused backward
  (host prep, the kernels' mirror, the fold's mirror) against the JAX
  in-kernel backward in interpret mode.

Float32 throughout; each tolerance is stated where it is used.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gan_inpainting_tpu.ops.pallas.fold import fold_taps_pallas
from gan_inpainting_tpu.ops.pallas.fused_attention_bwd import (
    fused_folded_bwd_inkernel,
)

from gan_inpainting_torch.ops.dispatch import launches
from gan_inpainting_torch.ops.kernels.fold import (
    fold_counts_inv,
    fold_inv,
    fold_taps_mirror,
    fold_taps_plain,
    fold_vector,
)
from gan_inpainting_torch.ops.kernels.fused_attention import (
    fused_attention_taps_plain,
)
from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
    fold_tap_grads,
    fold_tap_grads_mirror,
    fold_tap_grads_plain,
    prepare_bwd,
    tap_grads_mirror,
)

GRIDS = [(6, 6), (4, 7), (5, 3)]


# 1e-5: the mirror sums at most four taps per output in float32, the plain
# fold and the Pallas kernel the same taps in another order
@pytest.mark.parametrize("hs,ws", GRIDS, ids=["square", "non_square", "odd"])
@pytest.mark.parametrize("rate", [1, 2, 4])
def test_fold_mirror_matches_jax_fold_kernel_and_plain(rate, hs, ws):
    rng = np.random.default_rng(rate * 100 + hs * 10 + ws)
    taps = rng.standard_normal(
        (2, 4 * rate * rate, hs * ws, 5)).astype(np.float32)
    got = fold_taps_mirror(torch.from_numpy(taps), hs, ws, rate)
    assert got.shape == (2, rate * hs, rate * ws, 5)
    with pltpu.force_tpu_interpret_mode():
        want = fold_taps_pallas(jnp.asarray(taps), hs, ws, rate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), fold_taps_plain(torch.from_numpy(taps), hs, ws,
                                     rate).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate", [1, 2, 3, 4])
def test_closed_form_inverse_counts_are_exact(rate):
    for hs, ws in [(1, 1), (1, 5), *GRIDS, (32, 32)]:
        assert torch.equal(fold_inv(hs, ws, rate),
                           fold_counts_inv(hs, ws, rate))


def test_fold_vector_width():
    """16-byte vectors where C and the pointers allow, else narrower (the
    CPU tests' C = 4 and 5 take the 8-, 4- and 2-byte paths on the card)."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert fold_vector(192, bf16, 0, 256) == 8
    assert fold_vector(192, f32, 0, 256) == 4
    assert fold_vector(4, bf16, 0, 256) == 4
    assert fold_vector(4, f32, 0, 256) == 4
    assert fold_vector(5, bf16, 0, 256) == 1
    assert fold_vector(6, f32, 0, 256) == 2
    assert fold_vector(192, bf16, 0, 8) == 4        # an 8-byte aligned view


def _tap_grads(seed, b, h, w, c, rate):
    """Real tap gradients of one fused backward (the kernels' mirror):
    sample 0 has no hole, sample 1 is all hole."""
    rng = np.random.default_rng(seed)
    f = np.maximum(rng.standard_normal((b, h, w, c)), 0).astype(np.float32)
    hole = (rng.random((b, h, w, 1)) < 0.05).astype(np.float32)
    hole[0], hole[1] = 0.0, 1.0
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f, hole, g = (torch.from_numpy(a) for a in (f, hole, g))
    taps, lse = fused_attention_taps_plain(f, hole, rate=rate, want_lse=True)
    maps, gmaps, bias, rnorm, (hs, ws) = prepare_bwd(f, hole, g, 3, rate)
    dq, dk, dv, tnorm, _ = tap_grads_mirror(maps, gmaps, bias, rnorm, lse,
                                            taps, hs, ws, rate, 10.0)
    return maps, dq, dk, dv, tnorm, rnorm, hs, ws


# 1e-6 of the largest entry: the mirror adds the same float32 terms as the
# eager epilogue in the same order per pixel
@pytest.mark.parametrize("b,h,w,c,rate", [
    (3, 16, 16, 8, 2), (3, 12, 20, 4, 2), (3, 14, 14, 4, 2),
    (3, 16, 16, 4, 4), (3, 8, 12, 4, 1)],
    ids=["square", "non_square", "odd_cells", "rate4", "rate1"])
def test_tap_grad_fold_mirror_matches_plain(b, h, w, c, rate):
    args = (*_tap_grads(h * w + c, b, h, w, c, rate), rate, 10.0)
    want = fold_tap_grads_plain(*args)
    got = fold_tap_grads_mirror(*args)
    assert got.shape == want.shape == (b, h, w, c)
    assert want.abs().max().item() > 0.1
    tol = 1e-6 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    assert got[1].abs().max().item() == 0.0
    # on a CPU tensor the wrapper takes the plain version and counts nothing
    before = dict(launches)
    assert torch.equal(fold_tap_grads(*args), want)
    assert launches == before


def test_fused_backward_pipeline_matches_jax_inkernel_backward():
    """The port's fused backward on the CPU — host prep, the kernels'
    mirror, the fold's mirror — against the JAX package's
    ``fused_folded_bwd_inkernel`` (Pallas in interpret mode) on the same
    residuals. 5e-4: the tolerance the JAX package holds its own kernels to
    against its XLA path."""
    rate, scale = 2, 10.0
    rng = np.random.default_rng(9)
    f = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    hole = (rng.random((2, 32, 32, 1)) > 0.7).astype(np.float32)
    hole[:, :12, :12] = 0.0
    g = rng.standard_normal(f.shape).astype(np.float32)
    ft, ht, gt = (torch.from_numpy(a) for a in (f, hole, g))
    taps, lse = fused_attention_taps_plain(ft, ht, rate=rate, want_lse=True)
    maps, gmaps, bias, rnorm, (hs, ws) = prepare_bwd(ft, ht, gt, 3, rate)
    dq, dk, dv, tnorm, _ = tap_grads_mirror(maps, gmaps, bias, rnorm, lse,
                                            taps, hs, ws, rate, scale)
    got = fold_tap_grads_mirror(maps, dq, dk, dv, tnorm, rnorm, hs, ws, rate,
                                scale)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_folded_bwd_inkernel(
            jnp.asarray(f), jnp.asarray(hole), 3, rate, scale,
            jnp.asarray(taps.numpy()), jnp.asarray(lse.numpy()),
            jnp.asarray(g)))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)
