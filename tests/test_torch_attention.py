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
    fold_counts_inv,
    fold_taps,
    fold_taps_plain,
)
from gan_inpainting_torch.ops.kernels.fused_attention import (
    _prepare,
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


def _mirror_attention_kernel(maps, bias, rnorm, hs, ws, rate, scale,
                             cluster=1):
    """csrc/contextual_attention.cu step by step, vectorized over blocks;
    ``cluster`` blocks each own Lk/cluster keys of a row, and the
    softmax combines their partial maxima and sums."""
    bsz, c = maps.shape[0], maps.shape[-1]
    lk = hs * ws
    m00 = maps[:, 0, 0]
    s = torch.zeros(bsz, lk, lk)
    for t in range(9):
        dp, dq = divmod(t, 3)
        tap = m00[:, dp:dp + hs, dq:dq + ws].reshape(bsz, lk, c)
        s += tap @ tap.transpose(1, 2)
    s = s * (rnorm * scale)[:, None, :] + bias[:, None, :]
    m = torch.stack([part.max(-1).values for part in s.chunk(cluster, -1)],
                    -1).max(-1, keepdim=True).values
    p = torch.where(bias[:, None, :] >= 0, torch.exp(s - m), 0.0)
    l = torch.stack([part.sum(-1) for part in p.chunk(cluster, -1)],
                    -1).sum(-1, keepdim=True)
    p = p * torch.where(l > 0, 1.0 / torch.clamp(l, min=1e-30), 0.0)
    half = rate // 2
    out = []
    for vp in range(2 * rate):
        for vq in range(2 * rate):
            par_p, off_p = (vp - half + rate) % rate, (vp - half + rate) // rate
            par_q, off_q = (vq - half + rate) % rate, (vq - half + rate) // rate
            v = maps[:, par_p, par_q, off_p:off_p + hs, off_q:off_q + ws]
            out.append(p @ v.reshape(bsz, lk, c))
    return torch.stack(out, 1)


def _mirror_fold_kernel(taps, inv, hs, ws, rate):
    """csrc/fold.cu: each output gathers its (p, q, i, j) contributors."""
    bsz, _, _, c = taps.shape
    hh, ww, half = rate * hs, rate * ws, rate // 2
    out = torch.zeros(bsz, hh, ww, c)
    for y in range(hh):
        for x in range(ww):
            for p in range(2 * rate):
                ny = y + half - p
                if ny < 0 or ny % rate or ny // rate >= hs:
                    continue
                for q in range(2 * rate):
                    nx = x + half - q
                    if nx < 0 or nx % rate or nx // rate >= ws:
                        continue
                    cell = (ny // rate) * ws + nx // rate
                    out[:, y, x] += taps[:, p * 2 * rate + q, cell]
            out[:, y, x] *= inv[y, x]
    return out


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("b,h,w,c,rate", [
    (3, 16, 16, 8, 2), (1, 12, 20, 4, 2), (1, 16, 16, 4, 4)])
def test_kernel_index_algebra_matches_plain(b, h, w, c, rate, cluster):
    f, hole = _case(7 + h, b, h, w, c)
    ft, ht = torch.from_numpy(f), torch.from_numpy(hole)
    maps, bias, rnorm, (hs, ws) = _prepare(ft, ht, 3, rate)
    taps = _mirror_attention_kernel(maps, bias, rnorm, hs, ws, rate, 10.0,
                                    cluster)
    want = fused_attention_taps_plain(ft, ht, rate=rate)
    np.testing.assert_allclose(taps.numpy(), want.numpy(), **TOL)
    folded = _mirror_fold_kernel(taps, fold_counts_inv(hs, ws, rate), hs, ws,
                                 rate)
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
    # tensor-core tiles for the bf16 serve shapes, CUDA cores otherwise;
    # larger maps split their keys over a cluster of blocks
    assert plan(32, 32, 192, torch.bfloat16) == ("mma", 32, 1)
    assert plan(64, 64, 192, torch.bfloat16) == ("mma", 32, 4)
    assert plan(128, 64, 192, torch.bfloat16) == ("mma", 32, 8)
    assert plan(256, 128, 192, torch.bfloat16) == ("mma", 8, 8)
    assert plan(32, 32, 192, torch.float32) == ("core", 32, 1)
    assert plan(8, 8, 192, torch.bfloat16) == ("core", 32, 1)
    assert plan(64, 48, 192, torch.bfloat16) == ("core", 16, 1)
