"""Contextual attention: the port against the JAX package on the CPU.

* the port's plain ``contextual_attention`` against the JAX XLA path;
* the port's plain taps and fold against the JAX fused Pallas kernel and
  Pallas fold, run in interpret mode as tests/kernels/ runs them;
* a line-by-line torch mirror of the CUDA kernels' index algebra
  (csrc/contextual_attention.cu, csrc/fold.cu) over the port's host prep,
  against the plain versions — the kernels themselves run only on a card.

Masks include all-hole and no-hole samples. Float32 tolerance 2e-4, as the
JAX kernel tests use: scores at softmax scale 10 amplify summation-order
differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gan_inpainting_tpu.ops.contextual_attention import (
    contextual_attention as j_contextual_attention,
)
from gan_inpainting_tpu.ops.pallas.fold import fold_taps_pallas
from gan_inpainting_tpu.ops.pallas.fused_attention import (
    _prepare as j_prepare,
    _raw_fused_taps,
    fused_attention_map,
)

from gan_inpainting_torch.ops.contextual_attention import contextual_attention
from gan_inpainting_torch.ops.dispatch import launches
from gan_inpainting_torch.ops.kernels.fold import (
    fold_taps,
    fold_taps_mirror,
    fold_taps_plain,
)
from gan_inpainting_torch.ops.kernels.fused_attention import (
    _prepare,
    fused_attention_mirror,
    fused_attention_taps,
    fused_attention_taps_plain,
    plan,
    plan_group,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _case(seed, b, h, w, c, hole_frac=0.3):
    """Features and a hole mask; sample 0 of a batch ≥ 3 has no hole and
    sample 1 is all hole."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, h, w, c)).astype(np.float32)
    hole = (rng.random((b, h, w, 1)) < hole_frac).astype(np.float32)
    if b >= 3:
        hole[0] = 0.0
        hole[1] = 1.0
    return f, hole


@pytest.mark.parametrize("b,h,w,c,rate", [
    (3, 16, 16, 8, 2),
    (3, 12, 20, 4, 2),    # non-square
    (1, 16, 16, 4, 1),
    (1, 16, 16, 4, 4),
])
def test_plain_matches_jax_xla(b, h, w, c, rate):
    f, hole = _case(b * h + c, b, h, w, c)
    want = j_contextual_attention(jnp.asarray(f), jnp.asarray(f),
                                  jnp.asarray(hole), rate=rate, backend="xla")
    ft = torch.from_numpy(f)
    got = contextual_attention(ft, ft, torch.from_numpy(hole), rate=rate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if b >= 3:
        np.testing.assert_array_equal(got[1].numpy(), 0.0)   # all hole


def test_plain_f_not_b_matches_jax_xla():
    f, hole = _case(1, 1, 16, 16, 4)
    bg, _ = _case(2, 1, 16, 16, 4)
    want = j_contextual_attention(jnp.asarray(f), jnp.asarray(bg),
                                  jnp.asarray(hole), backend="xla")
    got = contextual_attention(torch.from_numpy(f), torch.from_numpy(bg),
                               torch.from_numpy(hole))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hole_kind", ["random", "none", "all"])
def test_plain_taps_match_jax_fused_kernel(hole_kind):
    # the shape tests/kernels/test_fused_attention.py runs the kernel at
    f, hole = _case(3, 1, 64, 64, 8)
    hole = {"random": hole, "none": 0 * hole, "all": 0 * hole + 1}[hole_kind]
    with pltpu.force_tpu_interpret_mode():
        want, _ = _raw_fused_taps(jnp.asarray(f), jnp.asarray(hole), 3, 2,
                                  10.0)
    got = fused_attention_taps(torch.from_numpy(f), torch.from_numpy(hole))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if hole_kind == "all":
        np.testing.assert_array_equal(got.numpy(), 0.0)


def test_plain_fold_matches_jax_fold_kernel():
    rng = np.random.default_rng(4)
    taps = rng.standard_normal((2, 16, 8 * 8, 5)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = fold_taps_pallas(jnp.asarray(taps), 8, 8, 2)
    got = fold_taps(torch.from_numpy(taps), 8, 8, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_contextual_attention_matches_jax_fused_map():
    f, hole = _case(5, 3, 32, 32, 8)
    with pltpu.force_tpu_interpret_mode():
        want = fused_attention_map(jnp.asarray(f), jnp.asarray(hole))
    ft = torch.from_numpy(f)
    got = contextual_attention(ft, ft, torch.from_numpy(hole))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prepare_matches_jax_prepare():
    f, hole = _case(6, 3, 16, 24, 4)
    j_maps, j_bias, j_rnorm, _, j_hw = j_prepare(jnp.asarray(f),
                                                 jnp.asarray(hole), 3, 2)
    maps, bias, rnorm, hw = _prepare(torch.from_numpy(f),
                                     torch.from_numpy(hole), 3, 2)
    assert hw == j_hw
    np.testing.assert_array_equal(maps.numpy(), np.asarray(j_maps))
    np.testing.assert_array_equal(bias.numpy(), np.asarray(j_bias))
    np.testing.assert_allclose(rnorm.numpy(), np.asarray(j_rnorm), rtol=1e-6)


# ---------------------------------------------------------------------------
# torch mirrors of the CUDA kernels' index algebra
# ---------------------------------------------------------------------------


# The wgmma variant's tiling (fused_attention_mirror: d units split over
# the cluster's ranks and summed in rank order, steps of block_c keys with
# the flash rescale) in float32 against the plain version, 2e-4: the same
# sums in another order. cluster 2 with 16-key steps walks several steps
# and splits the (tap, channel) units unevenly.
@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("b,h,w,c,rate", [
    (3, 16, 16, 8, 2), (1, 12, 20, 4, 2), (1, 16, 16, 4, 4),
    (3, 16, 16, 96, 2)])    # the published width: 64 + 32 channels a tap
def test_kernel_index_algebra_matches_plain(b, h, w, c, rate, cluster):
    f, hole = _case(7 + h, b, h, w, c)
    ft, ht = torch.from_numpy(f), torch.from_numpy(hole)
    maps, bias, rnorm, (hs, ws) = _prepare(ft, ht, 3, rate)
    taps, lse = fused_attention_mirror(
        maps, bias, rnorm, hs, ws, rate, 10.0, cluster=cluster,
        block_c=128 if cluster == 1 else 16, unit=64 if cluster == 1 else 2)
    want, want_lse = fused_attention_taps_plain(ft, ht, rate=rate,
                                                want_lse=True)
    np.testing.assert_allclose(taps.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5,
                               atol=1e-4)
    folded = fold_taps_mirror(taps, hs, ws, rate)
    np.testing.assert_allclose(folded.numpy(),
                               fold_taps_plain(taps, hs, ws, rate).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    f, hole = _case(8, 1, 16, 16, 4)
    ft, ht = torch.from_numpy(f), torch.from_numpy(hole)
    before = dict(launches)
    taps = fused_attention_taps(ft, ht)
    torch.testing.assert_close(taps, fused_attention_taps_plain(ft, ht),
                               rtol=0, atol=0)
    torch.testing.assert_close(fold_taps(taps, 8, 8, 2),
                               fold_taps_plain(taps, 8, 8, 2), rtol=0, atol=0)
    assert launches == before


def test_plan_group_sizes_and_limit():
    assert plan_group(1024, 192) == 32      # 256² serve map
    assert plan_group(4096, 192) == 8       # 512² serve map
    with pytest.raises(ValueError, match="flash variant"):
        plan_group(60000, 192)
    # the wgmma variant for the bf16 maps of the configs (64-query tiles,
    # d and dv over a cluster: 8 blocks at C 192, 4 at C 64), CUDA cores
    # otherwise
    assert plan(32, 32, 192, torch.bfloat16) == ("wgmma", 64, 8)
    assert plan(64, 64, 192, torch.bfloat16) == ("wgmma", 64, 8)
    assert plan(128, 64, 192, torch.bfloat16) == ("wgmma", 64, 8)
    assert plan(256, 128, 192, torch.bfloat16) == ("wgmma", 64, 8)
    assert plan(32, 32, 64, torch.bfloat16) == ("wgmma", 64, 4)
    assert plan(32, 96, 192, torch.bfloat16) == ("core", 16, 1)  # 96-cell rows
    assert plan(32, 32, 192, torch.float32) == ("core", 32, 1)
    assert plan(8, 8, 192, torch.bfloat16) == ("core", 32, 1)
    assert plan(64, 48, 192, torch.bfloat16) == ("core", 16, 1)


# C % 32 == 0 takes the wgmma variant at ⌈C/64⌉ units a tap, the last one
# zero-filled past C: at the published width's C 96, 18 d and 32 dv units,
# a cluster of 8 (≤ 3 d and 4 dv units a block). Float32 and other widths
# keep the CUDA cores.
@pytest.mark.parametrize("hs,ws,c,dtype,want", [
    (32, 32, 96, torch.bfloat16, ("wgmma", 64, 8)),     # 256² serve map
    (64, 64, 96, torch.bfloat16, ("wgmma", 64, 8)),     # 512² train map
    (32, 32, 32, torch.bfloat16, ("wgmma", 64, 4)),
    (32, 32, 160, torch.bfloat16, ("wgmma", 64, 8)),
    (32, 32, 96, torch.float32, ("core", 32, 1)),
    (64, 64, 96, torch.float32, ("core", 8, 1)),
    (32, 32, 48, torch.bfloat16, ("core", 32, 1)),      # C % 32 != 0
    (32, 96, 96, torch.bfloat16, ("core", 16, 1)),      # 96-cell rows
], ids=["c96_256", "c96_512", "c32", "c160", "f32_c96_256", "f32_c96_512",
        "c48", "c96_ws96"])
def test_plan_takes_ragged_channel_units(hs, ws, c, dtype, want):
    assert plan(hs, ws, c, dtype) == want


# The wgmma variant's tiling against the JAX fused Pallas kernel in
# interpret mode, with lse, at the sizes the JAX kernel tests use (a
# 32² or 64² map at rate 2: L 256 or 1024 cells, C 8, an all-hole
# sample). float32: 2e-4 (sums in another order); bf16 maps: 2^-7 of the
# largest input, where the JAX kernel and the mirror both round the
# unnormalized p to bf16 before the PV products, and lse within 1e-3.
@pytest.mark.parametrize("dtype,hw,cluster,block_c", [
    ("float32", 32, 1, 128), ("bfloat16", 32, 2, 64),
    ("bfloat16", 64, 8, 128)], ids=["f32", "bf16_cl2", "bf16_cl8"])
def test_wgmma_mirror_matches_jax_fused_kernel(dtype, hw, cluster, block_c):
    f, hole = _case(11 + hw, 3, hw, hw, 8, hole_frac=0.02)
    fj = jnp.asarray(f).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse, _ = _raw_fused_taps(fj, jnp.asarray(hole), 3, 2,
                                            10.0, want_lse=True)
    ft = torch.from_numpy(f).to(getattr(torch, dtype))
    maps, bias, rnorm, (hs, ws) = _prepare(ft, torch.from_numpy(hole), 3, 2)
    taps, lse = fused_attention_mirror(maps, bias, rnorm, hs, ws, 2, 10.0,
                                       cluster=cluster, block_c=block_c,
                                       unit=4)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(taps.numpy(), want, **TOL)
    else:
        tol = 2.0 ** -7 * ft.float().abs().max().item()
        assert np.abs(taps.float().numpy() - want).max() <= tol
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=1e-3)
    assert taps[1].abs().max().item() == 0.0
    assert lse[1].abs().max().item() == 0.0
