"""Patch attention and the routes through it: the port on the CPU against
the JAX package.

* the plain forward (out and lse) and the plain backward formulas, joined
  by the port's autograd Function, against ``_patch_attention_xla``,
  ``patch_attention_pallas`` in interpret mode and ``jax.grad`` of both;
* the PyTorch mirror of the CUDA kernels' tiling (column tiles, running
  max and sum, the cluster's slices of d and dv) against the plain
  versions;
* contextual attention with f ≠ b and with ksize 5 (the patch route),
  the fused-forward / patch-backward fallback, and one train step with
  the route forced onto the patch path, against JAX;
* the route predicates at the map sizes the configs reach.

Float32: 2e-4 forward and 5e-4 gradients, the tolerances the JAX package
holds its own patch kernel to (tests/kernels/test_patch_attention.py);
softmax at scale 10 amplifies float32 rounding of the scores. Rows and
samples with no valid key give exactly 0, output and gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gan_inpainting_tpu.configs.base import apply_overrides as j_overrides
from gan_inpainting_tpu.data.pipeline import Batch as JBatch
from gan_inpainting_tpu.ops.contextual_attention import (
    _patch_attention_xla,
    contextual_attention as j_contextual_attention,
)
from gan_inpainting_tpu.ops.pallas.patch_attention import (
    patch_attention_pallas,
)
from gan_inpainting_tpu.train.state import create_state as j_create_state
from gan_inpainting_tpu.train.step import make_train_step as j_make_step

import gan_inpainting_torch.ops.contextual_attention as ca
from gan_inpainting_torch.configs.base import config_from_dict
from gan_inpainting_torch.data.pipeline import Batch
from gan_inpainting_torch.io.convert import (
    load_state_from_jax,
    params_from_jax,
)
from gan_inpainting_torch.ops.dispatch import launches
from gan_inpainting_torch.ops.kernels import fused_attention as fa
from gan_inpainting_torch.ops.kernels import fused_attention_bwd as fab
from gan_inpainting_torch.ops.kernels import patch_attention as pa
from gan_inpainting_torch.ops.kernels.patch_attention import (
    PatchAttention,
    attend,
    patch_attention,
    patch_attention_bwd,
    patch_attention_bwd_plain,
    patch_attention_mirror,
    patch_attention_plain,
    plan,
)
from gan_inpainting_torch.train.state import create_state
from gan_inpainting_torch.train.step import make_train_step

FWD = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=5e-4, atol=5e-4)
SCALE = 10.0


def _inputs(seed, b, lq, lk, d, dv, dead_sample=False, dtype=np.float32):
    """q, k (unit-norm rows), v, key validity; with ``dead_sample`` the
    last sample has no valid key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, d)).astype(dtype)
    k = rng.standard_normal((b, lk, d))
    k = (k / np.linalg.norm(k, axis=-1, keepdims=True)).astype(dtype)
    v = rng.standard_normal((b, lk, dv)).astype(dtype)
    valid = rng.random((b, lk)) < 0.7
    if dead_sample:
        valid[-1] = False
    return q, k, v, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_lse(q, k, valid):
    s = SCALE * jnp.einsum("bqd,bkd->bqk", q, k)
    s = jnp.where(valid[:, None, :], s, -jnp.inf)
    lse = jax.nn.logsumexp(s, axis=-1)
    return np.asarray(jnp.where(valid.any(-1, keepdims=True), lse, 0.0))


SHAPES = [(2, 64, 64, 36, 48), (2, 130, 70, 36, 48)]
IDS = ["tiny", "padded"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_forward_matches_jax(shape):
    b, lq, lk, d, dv = shape
    q, k, v, valid = _inputs(lq + lk, b, lq, lk, d, dv, dead_sample=True)
    want_xla = np.asarray(_patch_attention_xla(q, k, valid, v, SCALE))
    with pltpu.force_tpu_interpret_mode():
        want_pal = np.asarray(patch_attention_pallas(
            q, k, valid, v, softmax_scale=SCALE, block_q=64, block_k=64))
    tq, tk, tv, tvalid = _t(q, k, v, valid)
    out, lse = patch_attention_plain(tq, tk, tvalid, tv, softmax_scale=SCALE,
                                     want_lse=True)
    np.testing.assert_allclose(out.numpy(), want_xla, **FWD)
    np.testing.assert_allclose(out.numpy(), want_pal, **FWD)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, valid),
                               rtol=1e-5, atol=1e-4)
    assert np.array_equal(out[-1].numpy(), np.zeros_like(out[-1].numpy()))
    assert np.array_equal(lse[-1].numpy(), np.zeros(lq, np.float32))
    # a CPU tensor takes the plain version and launches nothing
    before = dict(launches)
    again, lse2 = patch_attention(tq, tk, tvalid, tv, softmax_scale=SCALE,
                                  want_lse=True)
    assert torch.equal(again, out) and torch.equal(lse2, lse)
    assert launches == before


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_function_gradient_matches_jax_grad(shape):
    """The autograd Function on CPU tensors (plain forward, backward
    formulas) against jax.grad through the Pallas kernels in interpret
    mode and through the XLA path."""
    b, lq, lk, d, dv = shape
    q, k, v, valid = _inputs(lq * 3 + lk, b, lq, lk, d, dv, dead_sample=True)

    def loss(fn):
        return lambda q_, k_, v_: jnp.sum(jnp.sin(fn(q_, k_, v_)))

    def pallas(q_, k_, v_):
        return patch_attention_pallas(q_, k_, valid, v_, softmax_scale=SCALE,
                                      block_q=64, block_k=64)

    with pltpu.force_tpu_interpret_mode():
        want_pal = jax.grad(loss(pallas), argnums=(0, 1, 2))(q, k, v)
    want_xla = jax.grad(loss(lambda q_, k_, v_: _patch_attention_xla(
        q_, k_, valid, v_, SCALE)), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tvalid = _t(q, k, v, valid)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    y = attend(tq, tk, tvalid, tv, SCALE)
    assert y.grad_fn is not None and "PatchAttention" in type(
        y.grad_fn).__name__
    torch.sum(torch.sin(y)).backward()
    got = (tq.grad, tk.grad, tv.grad)
    for name, g, wp, wx in zip("qkv", got, want_pal, want_xla):
        assert np.abs(np.asarray(wx)).max() > 0.1
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), **GRAD,
                                   err_msg=f"d{name} vs Pallas")
        np.testing.assert_allclose(g.numpy(), np.asarray(wx), **GRAD,
                                   err_msg=f"d{name} vs XLA")
        assert torch.isfinite(g).all()
        assert g[-1].abs().max().item() == 0.0, f"d{name} of the dead sample"


# the mirror against the plain versions, float32 on the same inputs: 2e-4
# of the largest entry (the same sums in another order); bf16: 2^-6 (the
# mirror rounds p and ds to bf16 for their products, as the kernels do)
@pytest.mark.parametrize("dtype,cluster,block_c", [
    (torch.float32, 1, 32), (torch.float32, 2, 64), (torch.float32, 8, 32),
    (torch.bfloat16, 4, 64)], ids=["f32_cl1", "f32_cl2", "f32_cl8",
                                   "bf16_cl4"])
def test_kernel_tiling_mirror_matches_plain(dtype, cluster, block_c):
    q, k, v, valid = _inputs(cluster, 2, 70, 45, 36, 48, dead_sample=True)
    tq, tk, tv, tvalid = _t(q, k, v, valid)
    tq, tk, tv = (t.to(dtype) for t in (tq, tk, tv))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 70, 48)).astype(np.float32)).to(dtype)
    out, lse = patch_attention_plain(tq.float(), tk.float(), tvalid,
                                     tv.float(), softmax_scale=SCALE,
                                     want_lse=True)
    m_out, m_lse = patch_attention_mirror(tq, tk, tvalid, tv,
                                          softmax_scale=SCALE,
                                          cluster=cluster, block_c=block_c)
    frac = 2e-4 if dtype == torch.float32 else 2.0 ** -6
    assert (m_out.float() - out).abs().max().item() <= frac * max(
        out.abs().max().item(), 1.0)
    assert (m_lse - lse).abs().max().item() <= 1e-4
    want = patch_attention_bwd_plain(tq.float(), tk.float(), tvalid,
                                     tv.float(), out, lse, g.float(),
                                     softmax_scale=SCALE, keep_float=True)
    got = patch_attention_mirror(tq, tk, tvalid, tv, softmax_scale=SCALE,
                                 cluster=cluster, block_c=block_c,
                                 out=out.to(dtype), lse=lse, g=g)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        tol = frac * max(b_.abs().max().item(), 1.0)
        assert (a - b_).abs().max().item() <= tol, name
        assert a[-1].abs().max().item() == 0.0, name
    assert m_out[-1].abs().max().item() == 0.0


def _feature_case(seed, b=2, h=16, w=16, c=8, hole_p=0.1):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    hole = (rng.random((b, h, w, 1)) < hole_p).astype(np.float32)
    hole[-1] = 1.0                    # all hole: output and gradient 0
    return f, g, hole


@pytest.mark.parametrize("shared,ksize", [(False, 3), (True, 5)],
                         ids=["f_not_b", "ksize5"])
def test_patch_route_matches_jax_pallas(shared, ksize):
    """The route the card takes for f ≠ b and ksize ≠ 3 — plain front end,
    the patch-attention Function, plain fold — on CPU tensors, forward and
    gradient against the JAX package under ``backend="pallas"``."""
    f, b, hole = _feature_case(ksize, hole_p=0.05)
    if shared:
        b = f

    def jfn(f_, b_):
        return j_contextual_attention(f_, f_ if shared else b_,
                                      jnp.asarray(hole), ksize=ksize,
                                      backend="pallas")

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfn(jnp.asarray(f), jnp.asarray(b)))
        want_g = jax.grad(lambda f_, b_: jnp.sum(jnp.sin(jfn(f_, b_))),
                          argnums=(0, 1))(jnp.asarray(f), jnp.asarray(b))
    tf, tb, th = _t(f, b, hole)
    tf.requires_grad_(True)
    tb = tf if shared else tb.requires_grad_(True)
    y = ca._patch_route(tf, tb, th, ksize, 2, SCALE)
    np.testing.assert_allclose(y.detach().numpy(), want, **FWD)
    assert y[-1].abs().max().item() == 0.0
    # the op itself on CPU tensors (plain composition) agrees too
    np.testing.assert_allclose(
        ca.contextual_attention(tf, tb, th, ksize=ksize).detach().numpy(),
        want, **FWD)
    torch.sum(torch.sin(y)).backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(
        want_g[0] + want_g[1]) if shared else np.asarray(want_g[0]), **GRAD)
    if not shared:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_g[1]),
                                   **GRAD)
        assert tb.grad[-1].abs().max().item() == 0.0


def test_fused_forward_patch_backward_matches_jax(monkeypatch):
    """``_FusedAttention`` where the fused backward's plan does not hold:
    the forward is the fused route, the gradient goes through the patch
    Function. Against JAX's ``_fused_folded_bwd`` fallback, selected by its
    own switch, read at call time."""
    f, g, hole = _feature_case(11, h=32, w=32)   # JAX's fused path holds
    monkeypatch.setenv("INPAINT_FUSED_BWD", "0")
    with pltpu.force_tpu_interpret_mode():
        want_y, vjp = jax.vjp(lambda x: j_contextual_attention(
            x, x, jnp.asarray(hole), backend="pallas"), jnp.asarray(f))
        (want_g,) = vjp(jnp.asarray(g))
    monkeypatch.setattr(ca, "use_kernel", lambda x: True)
    monkeypatch.setattr(fab, "bwd_supported", lambda *a: False)
    seen = []
    real = PatchAttention.forward
    monkeypatch.setattr(PatchAttention, "forward", staticmethod(
        lambda ctx, *a: seen.append(1) or real(ctx, *a)))
    tf, tg, th = _t(f, g, hole)
    tf.requires_grad_(True)
    y = ca.contextual_attention(tf, tf, th)
    assert "_FusedAttention" in type(y.grad_fn).__name__ and not seen
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **FWD)
    y.backward(tg)
    assert seen == [1]
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_g), **GRAD)
    assert tf.grad[-1].abs().max().item() == 0.0


def test_fused_patch_attention_is_the_patch_major_output():
    f, g, hole = _feature_case(4, b=2, h=12, w=16, c=4)
    tf, th = _t(f, hole)
    x = tf.clone().requires_grad_(True)
    got = fa.fused_patch_attention(x, th)
    assert got.shape == (2, 6 * 8, 16 * 4)
    q, k, valid, v, _ = ca._attention_inputs(tf, tf, th, 3, 2)
    want = patch_attention_plain(q, k, valid, v, softmax_scale=SCALE)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **FWD)
    gp = torch.from_numpy(np.random.default_rng(1).standard_normal(
        got.shape).astype(np.float32))
    (dx,) = torch.autograd.grad(got, x, gp)
    y = tf.clone().requires_grad_(True)
    q, k, valid, v, _ = ca._attention_inputs(y, y, th, 3, 2)
    (dy,) = torch.autograd.grad(
        patch_attention_plain(q, k, valid, v, softmax_scale=SCALE), y, gp)
    np.testing.assert_allclose(dx.numpy(), dy.numpy(), **GRAD)
    assert dx[-1].abs().max().item() == 0.0


@pytest.mark.parametrize("image,fused,bwd,route,bf16_serve_route", [
    (256, True, True, (True, True), True),
    (512, True, True, (True, False), True),
    (1024, True, True, (True, False), False),
    (2048, False, False, (False, False), False)])
def test_route_predicates_at_the_config_maps(image, fused, bwd, route,
                                             bf16_serve_route):
    """The attention branch sees a C = 192 map at a quarter of the image,
    matched at rate 2: 256² → 64² (L 1024) … 2048² → 512² (L 65 536). Where
    a backward follows, the fused route is taken up to the measured 16 384
    cells in bf16 (the 1024² image) and 2048 in float32 (``route``: bf16,
    float32); a bf16 forward alone takes it up to 4096 (serving the 512²
    image); ``fused``: whether the float32 fused kernel holds the map (the
    bf16 one holds all four)."""
    hw = image // 4
    hs = hw // 2
    for dtype, routed in zip((torch.bfloat16, torch.float32), route):
        # the bf16 wgmma variant's flash recurrence takes every config map;
        # ``fused`` is whether the float32 core variant's score rows fit
        held = fused or dtype == torch.bfloat16
        assert fa.fused_supported((1, hw, hw, 192), 3, 2, dtype) is held
        assert fa.fused_route((1, hw, hw, 192), 3, 2, dtype) is routed
        assert fa.fused_route((1, hw, hw, 192), 3, 2, dtype,
                              backward=False) is (
            bf16_serve_route if dtype == torch.bfloat16 else routed)
        assert fab.bwd_supported(hs, hs, 192, dtype) is bwd
        assert not fa.fused_supported((1, hw, hw, 192), 5, 2, dtype)
        if held:
            fa.plan(hs, hs, 192, dtype)              # no raise where True
        else:
            with pytest.raises(ValueError, match="patch-attention"):
                fa.plan(hs, hs, 192, dtype)
        if not bwd:
            with pytest.raises(ValueError, match="patch-attention"):
                fab.plan_bwd(hs, hs, 192, dtype)
    # rate must divide the map; C % 4 and the dtype must suit the kernel
    assert not fa.fused_supported((1, 18, 18, 192), 3, 4, torch.float32)
    assert not fa.fused_supported((1, 16, 16, 6), 3, 2, torch.float32)
    assert not fa.fused_supported((1, 16, 16, 8), 3, 2, torch.float16)
    # a float32 map the fused forward holds and its backward does not
    assert fa.fused_supported((1, 344, 344, 32), 3, 2, torch.float32)
    assert not fab.bwd_supported(172, 172, 32, torch.float32)


# The wgmma forward's tiling (64-wide units of d over the cluster's ranks,
# 128-key steps; 32 walks several steps at these sizes) against the plain
# version and the JAX Pallas _fwd_kernel in interpret mode, float32: 2e-4
# of the largest entry; on bf16 inputs against the plain version in
# float32 on the same values: 2^-7 (p rounded to bf16 unnormalized, as the
# kernel and _fwd_kernel round it); lse within 1e-4 / 1e-3.
@pytest.mark.parametrize("dtype,cluster,block_c", [
    (torch.float32, 1, 128), (torch.float32, 2, 32),
    (torch.bfloat16, 4, 32)], ids=["f32_cl1", "f32_cl2", "bf16_cl4"])
def test_wgmma_forward_mirror_matches_plain_and_jax(dtype, cluster, block_c):
    b, lq, lk, d, dv = 2, 130, 70, 136, 200        # ragged in every tile
    q, k, v, valid = _inputs(7 + cluster, b, lq, lk, d, dv, dead_sample=True)
    tq, tk, tv, tvalid = _t(q, k, v, valid)
    tq, tk, tv = (t.to(dtype) for t in (tq, tk, tv))
    out, lse = patch_attention_mirror(tq, tk, tvalid, tv, softmax_scale=SCALE,
                                      cluster=cluster, block_c=block_c,
                                      unit=64)
    want, want_lse = patch_attention_plain(tq.float(), tk.float(), tvalid,
                                           tv.float(), softmax_scale=SCALE,
                                           want_lse=True)
    frac = 2e-4 if dtype == torch.float32 else 2.0 ** -7
    assert (out.float() - want).abs().max().item() <= frac * max(
        want.abs().max().item(), 1.0)
    assert (lse - want_lse).abs().max().item() <= (
        1e-4 if dtype == torch.float32 else 1e-3)
    assert out[-1].abs().max().item() == 0.0
    assert lse[-1].abs().max().item() == 0.0
    if dtype == torch.float32:
        with pltpu.force_tpu_interpret_mode():
            want_pal = np.asarray(patch_attention_pallas(
                q, k, valid, v, softmax_scale=SCALE, block_q=64,
                block_k=64))
        np.testing.assert_allclose(out.numpy(), want_pal, **FWD)


def test_patch_kernel_plans_at_full_width():
    # d = 9C, dv = 16C at C = 192: a cluster of 8 blocks in the bf16
    # forward and the float32 kernels, of 16 in the bf16 backward
    for which in ("fwd", "dq", "dkv"):
        assert plan(1728, 3072, torch.bfloat16, which) == (
            "wgmma", 8 if which == "fwd" else 16)
        assert plan(1728, 3072, torch.float32, which) == ("core", 8)
        assert plan(36, 48, torch.float32, which) == ("core", 1)
    with pytest.raises(ValueError, match="cluster of 8"):
        plan(4800, 3072, torch.bfloat16, "fwd")      # ksize 5 at C = 192
    with pytest.raises(TypeError):
        plan(36, 48, torch.float16)


# The wgmma backward's arithmetic (csrc/attention_bwd_wgmma.cuh): S and dP
# as float32 sums of the cluster's 64-wide slices in rank order, 128
# columns per step, p and ds rounded to the inputs' dtype before their
# products. Against the plain formulas on the same values and, in float32,
# jax.vjp through the JAX Pallas backward kernels in interpret mode: 2e-4
# of the largest entry in float32 (sums in another order), 2^-6 on bf16
# inputs (p and ds rounded to bf16, which the formulas do not). Shapes
# ragged in every tile (L against 64 rows and 128 columns, d and dv
# against 64-wide units), the last sample with no valid key.
@pytest.mark.parametrize("dtype,cluster", [
    (torch.float32, 1), (torch.float32, 2), (torch.bfloat16, 4)],
    ids=["f32_cl1", "f32_cl2", "bf16_cl4"])
def test_wgmma_backward_mirror_matches_plain_and_jax(dtype, cluster):
    b, lq, lk, d, dv = 2, 130, 70, 136, 200
    q, k, v, valid = _inputs(11 + cluster, b, lq, lk, d, dv,
                             dead_sample=True)
    g = np.random.default_rng(12).standard_normal((b, lq, dv)).astype(
        np.float32)
    tq, tk, tv, tvalid, tg = _t(q, k, v, valid, g)
    tq, tk, tv, tg = (t.to(dtype) for t in (tq, tk, tv, tg))
    out, lse = patch_attention_plain(tq.float(), tk.float(), tvalid,
                                     tv.float(), softmax_scale=SCALE,
                                     want_lse=True)
    got = patch_attention_mirror(tq, tk, tvalid, tv, softmax_scale=SCALE,
                                 cluster=cluster, block_c=128, unit=64,
                                 out=out.to(dtype), lse=lse, g=tg)
    want = patch_attention_bwd_plain(tq.float(), tk.float(), tvalid,
                                     tv.float(), out.to(dtype).float(), lse,
                                     tg.float(), softmax_scale=SCALE,
                                     keep_float=True)
    frac = 2e-4 if dtype == torch.float32 else 2.0 ** -6
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert w.abs().max().item() > 0.1, name
        assert (a - w).abs().max().item() <= frac * max(
            w.abs().max().item(), 1.0), name
        assert a[-1].abs().max().item() == 0.0, name
    if dtype == torch.float32:
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(lambda q_, k_, v_: patch_attention_pallas(
                q_, k_, valid, v_, softmax_scale=SCALE, block_q=64,
                block_k=64), q, k, v)
            want_pal = vjp(g)
        for name, a, w in zip(("dq", "dk", "dv"), got, want_pal):
            w = np.asarray(w)
            assert np.abs(a.numpy() - w).max() <= 2e-4 * max(
                np.abs(w).max(), 1.0), name


# The bf16 backward's plan (csrc/attention_bwd_wgmma.cuh ``configure``,
# mirrored by ``wgmma_bwd_fit``): per block of 232 448 bytes, a ring of
# 16 KB stages, 8 KB resident units, two float32 partial tiles of 64 × 136,
# the published rows, 8 bytes per barrier and 1 KB of slack. At d 1728 /
# dv 3072 (27 and 48 units) a cluster of 8 cannot hold dQ's 10 resident
# units, 68 KB of partials and 5 stages, nor dK/dV's 10 accumulated units;
# 16 blocks hold 2 + 3 units with a ring of 7.
@pytest.mark.parametrize("which,d,dv,cluster,ring,smem", [
    ("dq", 1728, 3072, 16, 7, 7 * 16384 + 5 * 8192 + 69632 + 1024 + 136
     + 1024),
    ("dkv", 1728, 3072, 16, 7, 7 * 16384 + 5 * 8192 + 69632 + 2048 + 136
     + 1024),
    ("dq", 200, 300, 2, 6, 6 * 16384 + 5 * 8192 + 69632 + 8192 + 120
     + 1024),
    ("dkv", 200, 300, 2, 6, 6 * 16384 + 5 * 8192 + 69632 + 16384 + 120
     + 1024)], ids=["dq_full", "dkv_full", "dq_ragged", "dkv_ragged"])
def test_wgmma_backward_layout_and_plan(which, d, dv, cluster, ring, smem):
    assert plan(d, dv, torch.bfloat16, which) == ("wgmma", cluster)
    fit = pa.wgmma_bwd_fit(which, d, dv, cluster)
    assert (fit["ring"], fit["smem"]) == (ring, smem)
    assert smem <= 232448
    # ≤ 3 accumulated units per consumer warpgroup; the tiles' registers
    # leave room under setmaxnreg 232
    assert fit["acc_units_per_warpgroup"] <= 3
    assert pa.WGMMA_BWD_FLOAT_REGS == 160
    # every smaller cluster fails, and one stage more would not fit
    for smaller in (c for c in (1, 2, 4, 8) if c < cluster):
        assert pa.wgmma_bwd_fit(which, d, dv, smaller) is None
    assert pa.wgmma_bwd_smem(which, ring + 1, fit["d_units"],
                             fit["dv_units"], cluster) > 232448
    # wider than a cluster of 16 holds: ksize 5 at C 192 (d 4800), and for
    # dK/dV dv 4800 (more than 6 accumulated units per block)
    with pytest.raises(ValueError, match="cluster of 16"):
        plan(4800, 3072, torch.bfloat16, which)
    if which == "dkv":
        with pytest.raises(ValueError, match="cluster of 16"):
            plan(1728, 4800, torch.bfloat16, which)


def test_cpu_backward_wrapper_takes_the_formulas():
    q, k, v, valid = _inputs(9, 2, 20, 24, 12, 16, dead_sample=True)
    tq, tk, tv, tvalid = _t(q, k, v, valid)
    out, lse = patch_attention(tq, tk, tvalid, tv, softmax_scale=SCALE,
                               want_lse=True)
    g = torch.ones_like(out)
    before = dict(launches)
    got = patch_attention_bwd(tq, tk, tvalid, tv, out, lse, g,
                              softmax_scale=SCALE)
    want = patch_attention_bwd_plain(tq, tk, tvalid, tv, out, lse, g,
                                     softmax_scale=SCALE)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    assert launches == before


def test_train_step_on_the_patch_route_matches_jax(tiny_config, monkeypatch):
    """One train step of a width-8 attention config with the port's route
    forced onto the patch path (the fused kernel refused), against the JAX
    package's step on the same converted state and batch."""
    jcfg = j_overrides(tiny_config, [
        "model.generator=coarse_to_fine", "model.conv_kind=gated",
        "model.use_attention=true", "model.dtype_policy=f32"])
    # jitted: an eager flax init dispatches op by op, several times slower
    jstate = jax.jit(lambda key: j_create_state(jcfg, key))(
        jax.random.key(0))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    state = create_state(cfg, device="cpu")
    np_state = {
        "step": int(jstate.step),
        **{k: jax.tree.map(np.asarray, getattr(jstate, k))
           for k in ("g_params", "d_params", "d_stats", "g_ema")}}
    for part in ("g_opt", "d_opt"):
        adam = [x for x in jax.tree_util.tree_leaves(
            getattr(jstate, part), is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(x, "mu")][0]
        np_state[part] = {"mu": jax.tree.map(np.asarray, adam.mu),
                          "nu": jax.tree.map(np.asarray, adam.nu),
                          "count": int(adam.count)}
    load_state_from_jax(state, np_state)

    calls = []
    monkeypatch.setattr(ca, "use_kernel", lambda x: True)
    monkeypatch.setattr(fa, "fused_supported", lambda *a: False)
    monkeypatch.setattr(ca, "attend", lambda *a: calls.append(
        torch.is_grad_enabled()) or attend(*a))

    rng = np.random.default_rng(0)
    bsz, s = cfg.data.batch_size, cfg.data.image_size
    image = np.clip(np.kron(rng.uniform(-1, 1, (bsz, s // 4, s // 4, 3)),
                            np.ones((1, 4, 4, 1)))
                    + 0.1 * rng.standard_normal((bsz, s, s, 3)),
                    -1, 1).astype(np.float32)
    mask = np.kron(rng.random((bsz, s // 8, s // 8, 1)) < 0.25,
                   np.ones((1, 8, 8, 1))).astype(np.float32)
    jb = JBatch(image=jnp.asarray(image), mask=jnp.asarray(mask),
                masked=jnp.asarray(image * (1 - mask)))
    tb = Batch(*_t(image, mask, image * (1 - mask)))
    jstate, jm = j_make_step(jcfg, donate=False)(jstate, jb,
                                                 jax.random.key(0))
    tm = make_train_step(cfg)(state, tb)
    # the D step's no-grad G forward, then the G forward with a gradient
    assert calls == [False, True]
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.g_params))
    got = state.generator.state_dict()
    assert max((got[k] - want[k]).abs().max().item() for k in want) <= 2e-6
