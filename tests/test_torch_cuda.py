"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. On a machine with a
card (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Float32 tolerance 2e-4 at these small shapes; bfloat16 runs the kernel on
bf16 inputs against the plain version in float32 on the same values, with
2^-7 of the largest input as the tolerance (weights and outputs rounded to
bf16). TF32 is off. The backward kernels and the trainer follow below,
each with its tolerance, then the gated-conv kernels, the partial-conv
epilogue kernel and the patch-attention kernels with the routes into them.
"""

import numpy as np
import pytest
import torch

from gan_inpainting_torch.ops import dispatch
from gan_inpainting_torch.ops.contextual_attention import (
    contextual_attention,
    contextual_attention_plain,
)
from gan_inpainting_torch.ops.kernels.fold import fold_taps, fold_taps_plain
from gan_inpainting_torch.ops.kernels.fused_attention import (
    _launch,
    _prepare,
    fused_attention_taps,
    fused_attention_taps_plain,
    plan,
)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, b, h, w, c, device):
    rng = np.random.default_rng(seed)
    f = np.maximum(rng.standard_normal((b, h, w, c)), 0).astype(np.float32)
    hole = (rng.random((b, h, w, 1)) < 0.3).astype(np.float32)
    if b >= 3:
        hole[0], hole[1] = 0.0, 1.0      # no hole, all hole
    return (torch.from_numpy(f).to(device), torch.from_numpy(hole).to(device))


SHAPES = [
    (3, 16, 16, 8, 2),
    (2, 12, 20, 4, 2),      # non-square
    (1, 14, 14, 4, 2),      # Lk = 49: padded score rows
    (1, 16, 16, 4, 4),
    (1, 16, 16, 4, 1),
    (2, 64, 64, 192, 2),    # the 256² serve map, two images
]


@pytest.mark.parametrize("b,h,w,c,rate", SHAPES)
def test_attention_kernel_matches_plain(cuda, b, h, w, c, rate):
    f, hole = _case(b + h + c, b, h, w, c, cuda)
    got = fused_attention_taps(f, hole, rate=rate)
    want = fused_attention_taps_plain(f, hole, rate=rate)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    if b >= 3:
        assert got[1].abs().max().item() == 0.0
    fb = f.to(torch.bfloat16)
    got_b = fused_attention_taps(fb, hole, rate=rate)
    want_b = fused_attention_taps_plain(fb.float(), hole, rate=rate)
    tol = 2.0 ** -7 * fb.float().abs().max().item()
    assert (got_b.float() - want_b).abs().max().item() <= tol


@pytest.mark.parametrize("b,h,w,c,group,cluster", [
    (2, 64, 64, 192, 64, 8),     # 256² serve map
    (1, 64, 128, 128, 64, 8),    # Lk = 2048, non-square
    (2, 128, 128, 64, 64, 4),    # Lk = 4096, the 512² regime
    (1, 128, 256, 64, 64, 4),    # Lk = 8192, 128-cell rows
])
@pytest.mark.parametrize("variant", ["wgmma", "core"])
def test_both_variants_match_plain_in_bf16(cuda, b, h, w, c, group, cluster,
                                           variant):
    f, hole = _case(h + w + c, b, h, w, c, cuda)
    hole[0, : h // 2] = 1.0              # a large hole as well
    if b > 1:
        hole[1] = 1.0                    # and one with no valid key
    fb = f.to(torch.bfloat16)
    assert plan(h // 2, w // 2, c, torch.bfloat16) == ("wgmma", group,
                                                       cluster)
    maps, bias, rnorm, (hs, ws) = _prepare(fb, hole, 3, 2)
    got = _launch(maps, bias, rnorm, hs, ws, 2, 10.0, variant=variant)
    want = fused_attention_taps_plain(fb.float(), hole)
    tol = 2.0 ** -7 * fb.float().abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


# The wgmma forward at the table widths (C 192, d 1728, dv 3072, a cluster
# of 8) at B 1, 3 and 8 and rows of 32 and 64 cells: taps within 2^-7 of
# the largest input, lse within 1e-3, the all-hole sample exactly 0.
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("hw", [64, 128], ids=["ws32", "ws64"])
def test_wgmma_forward_matches_plain_with_lse(cuda, b, hw):
    f, hole = _case(b * hw, b, hw, hw, 192, cuda)
    fb = f.to(torch.bfloat16)
    assert plan(hw // 2, hw // 2, 192, torch.bfloat16)[0] == "wgmma"
    dispatch.reset_launches()
    got, lse = fused_attention_taps(fb, hole, want_lse=True)
    assert dispatch.launches["contextual_attention_fused"] == 1
    want, want_lse = fused_attention_taps_plain(fb.float(), hole,
                                                want_lse=True)
    tol = 2.0 ** -7 * fb.float().abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-3
    if b >= 3:
        assert got[1].abs().max().item() == 0.0
        assert lse[1].abs().max().item() == 0.0


# The published width's C 96 on the wgmma forward (⌈96/64⌉ = 2 units a
# tap, the second zero-filled past channel 96 by TMA): the 64×256² serve
# bucket's map and the 8×512² train map with lse. Each variant against the
# plain version (taps within 2^-7 of the largest input, lse within 1e-3),
# the wgmma variant against the core one within the sum of the two, and
# each launch counted under its variant's name.
@pytest.mark.parametrize("b,hw", [(64, 64), (8, 128)],
                         ids=["serve256_b64", "train512_b8"])
def test_wgmma_forward_at_the_published_width(cuda, b, hw):
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        KERNEL_CORE,
        KERNEL_WGMMA,
    )

    f, hole = _case(b + hw, b, hw, hw, 96, cuda)
    hole[1] = 1.0
    fb = f.to(torch.bfloat16)
    hs = hw // 2
    assert plan(hs, hs, 96, torch.bfloat16) == ("wgmma", 64, 8)
    maps, bias, rnorm, _ = _prepare(fb, hole, 3, 2)
    dispatch.reset_launches()
    got, lse = _launch(maps, bias, rnorm, hs, hs, 2, 10.0, want_lse=True)
    assert dispatch.launches[KERNEL_WGMMA] == 1
    assert dispatch.launches.get(KERNEL_CORE, 0) == 0
    core, core_lse = _launch(maps, bias, rnorm, hs, hs, 2, 10.0,
                             variant="core", want_lse=True)
    assert dispatch.launches[KERNEL_CORE] == 1
    assert dispatch.launches["contextual_attention_fused"] == 2
    want, want_lse = fused_attention_taps_plain(fb.float(), hole,
                                                want_lse=True)
    tol = 2.0 ** -7 * fb.float().abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol
    assert (core.float() - want).abs().max().item() <= tol
    assert (got.float() - core.float()).abs().max().item() <= 2 * tol
    assert (lse - want_lse).abs().max().item() <= 1e-3
    assert (core_lse - want_lse).abs().max().item() <= 1e-3
    assert got[1].abs().max().item() == 0.0
    assert lse[1].abs().max().item() == 0.0


# C 192 takes 16-byte vectors, C 4 16 (float32) and 8 bytes (bf16), C 5
# one element per thread (fold_vector)
@pytest.mark.parametrize("b,h,w,c,rate", SHAPES + [(2, 10, 14, 5, 2)])
def test_fold_kernel_matches_plain(cuda, b, h, w, c, rate):
    hs, ws = h // rate, w // rate
    rng = np.random.default_rng(h * w)
    taps = torch.from_numpy(rng.standard_normal(
        (b, 4 * rate * rate, hs * ws, c)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(fold_taps(taps, hs, ws, rate),
                               fold_taps_plain(taps, hs, ws, rate),
                               rtol=1e-5, atol=1e-5)
    tb = taps.to(torch.bfloat16)
    got = fold_taps(tb, hs, ws, rate).float()
    want = fold_taps_plain(tb.float(), hs, ws, rate)
    assert (got - want).abs().max().item() <= 2.0 ** -7 * 4


def test_contextual_attention_on_cuda_uses_both_kernels(cuda):
    f, hole = _case(1, 3, 32, 32, 8, cuda)
    dispatch.reset_launches()
    got = contextual_attention(f, f, hole)
    assert dispatch.launches["contextual_attention_fused"] == 1
    assert dispatch.launches["fold_taps"] == 1
    torch.testing.assert_close(got, contextual_attention_plain(f, f, hole),
                               rtol=2e-4, atol=2e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    f, hole = _case(2, 1, 16, 16, 4, cuda)
    with pytest.raises(TypeError):
        fused_attention_taps(f.half(), hole)
    with pytest.raises(ValueError, match="ksize"):
        fused_attention_taps(f, hole, ksize=5)
    with pytest.raises(ValueError, match="C % 4"):
        fused_attention_taps(f[..., :3].contiguous(), hole)
    # f ≠ b is taken: by the patch-attention kernels, not the fused one
    b = f.flip(1).contiguous()
    dispatch.reset_launches()
    got = contextual_attention(f, b, hole)
    assert dispatch.launches.get("patch_attention_fwd") == 1
    assert dispatch.launches.get("contextual_attention_fused", 0) == 0
    torch.testing.assert_close(got, contextual_attention_plain(f, b, hole),
                               rtol=2e-4, atol=2e-4)
    taps = torch.zeros(1, 16, 64, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fold_taps(taps.transpose(2, 3).contiguous().transpose(2, 3), 8, 8, 2)


# ---------------------------------------------------------------------------
# backward kernels
# ---------------------------------------------------------------------------
# Float32: the core kernels against their PyTorch mirror on the same maps,
# 2e-4 relative to the largest tap gradient (sums of up to L·C products in
# another order). bfloat16: the kernels on bf16 maps against the mirror in
# float32 on the same bf16 values (p and dsr rounded to bf16 once, as the
# wgmma kernels round them); 2^-6 of the largest tap gradient.

BWD_SHAPES = [
    (3, 16, 16, 8, 2),
    (2, 12, 20, 4, 2),      # non-square
    (1, 14, 14, 4, 2),      # L = 49: padded rows
    (1, 16, 16, 4, 4),
    (1, 16, 16, 4, 1),
    (2, 64, 64, 64, 2),     # wgmma: ws 32, 8 row tiles
    (1, 128, 128, 64, 2),   # L = 4096: ws 64
    (1, 128, 256, 64, 2),   # L = 8192, non-square: ws 128
]


def _bwd_case(seed, b, h, w, c, rate, device, dtype):
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        prepare_bwd,
    )

    rng = np.random.default_rng(seed)
    f = np.maximum(rng.standard_normal((b, h, w, c)), 0).astype(np.float32)
    hole = (rng.random((b, h, w, 1)) < 0.02).astype(np.float32)
    if b >= 3:
        hole[0], hole[1] = 0.0, 1.0
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f, hole, g = (torch.from_numpy(a).to(device) for a in (f, hole, g))
    f = f.to(dtype)
    taps, lse = fused_attention_taps_plain(f.float(), hole, rate=rate,
                                           want_lse=True)
    prep = prepare_bwd(f, hole, g, 3, rate)
    return f, hole, g, taps.to(dtype), lse.contiguous(), prep


def test_forward_kernel_emits_lse(cuda):
    for b, h, w, c, rate in BWD_SHAPES:
        f, hole, _, _, lse, _ = _bwd_case(h + c, b, h, w, c, rate, cuda,
                                          torch.float32)
        _, got = fused_attention_taps(f, hole, rate=rate, want_lse=True)
        torch.testing.assert_close(got, lse, rtol=1e-4, atol=1e-4)
        if f.shape[-1] % 64 == 0:
            fb = f.to(torch.bfloat16)
            _, got_b = fused_attention_taps(fb, hole, rate=rate,
                                            want_lse=True)
            _, want_b = fused_attention_taps_plain(fb.float(), hole,
                                                   rate=rate, want_lse=True)
            torch.testing.assert_close(got_b, want_b, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("b,h,w,c,rate", BWD_SHAPES)
@pytest.mark.parametrize("dtype,variant", [
    (torch.float32, "core"), (torch.bfloat16, "core"),
    (torch.bfloat16, "wgmma")])
def test_backward_kernels_match_mirror(cuda, b, h, w, c, rate, dtype,
                                       variant):
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        plan_bwd,
        tap_grads,
        tap_grads_mirror,
    )

    hs, ws = h // rate, w // rate
    if variant == "wgmma" and plan_bwd(hs, ws, c, dtype).variant != "wgmma":
        pytest.skip("shape not taken by the wgmma variant")
    f, hole, g, taps, lse, (maps, gmaps, bias, rnorm, _) = _bwd_case(
        h * c, b, h, w, c, rate, cuda, dtype)
    want = tap_grads_mirror(maps, gmaps, bias, rnorm, lse, taps, hs, ws,
                            rate, 10.0)
    got = tap_grads(maps, gmaps, bias, rnorm, lse, taps, hs, ws, rate, 10.0,
                    variant=variant)
    torch.cuda.synchronize()
    frac = 2e-4 if dtype == torch.float32 else 2.0 ** -6
    for name, a, ref in zip(("dq", "dk", "dv", "tnorm", "delta"), got, want):
        tol = frac * max(ref.abs().max().item(), 1.0)
        err = (a - ref).abs().max().item()
        assert err <= tol, (name, err, tol)
    if b >= 3:      # the all-hole sample: exactly 0
        for a in got[:3]:
            assert a[1].abs().max().item() == 0.0


@pytest.mark.parametrize("image,bsz", [(256, 16), (512, 8)])
def test_wgmma_backward_at_the_train_shapes(cuda, image, bsz):
    """The bf16 train maps (C 192 at a quarter of the image, rate 2): the
    wgmma kernels against the mirror within 2^-6 of the largest entry, an
    all-hole sample at exactly 0, two runs bit-identical, and a budget that
    forces chunks of 3 samples giving the same bits as one chunk."""
    _wgmma_backward_at(cuda, image, bsz, 192)


# The same at the published width's C 96: two boxes a tap, the second
# zero-filled past channel 96, the products one m64n128 tile a tap; and the
# core kernels on the same bf16 maps within 2^-6 of the mirror as well.
@pytest.mark.parametrize("image,bsz", [(256, 16), (512, 8)])
def test_wgmma_backward_at_the_published_width(cuda, image, bsz):
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        tap_grads,
        tap_grads_mirror,
    )

    got, args = _wgmma_backward_at(cuda, image, bsz, 96)
    dispatch.reset_launches()
    core = tap_grads(*args, variant="core")
    assert dispatch.launches.get("contextual_attention_bwd_scores", 0) == 0
    want = tap_grads_mirror(*args)
    for name, a, c_, ref in zip(("dq", "dk", "dv", "tnorm", "delta"), got,
                                core, want):
        tol = 2.0 ** -6 * max(ref.abs().max().item(), 1.0)
        assert (c_ - ref).abs().max().item() <= tol, name
        assert (a - c_).abs().max().item() <= 2 * tol, name


def _wgmma_backward_at(cuda, image, bsz, c):
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        plan_bwd,
        prepare_bwd,
        scratch_bytes_per_sample,
        tap_grads,
        tap_grads_mirror,
    )

    hw, rate = image // 4, 2
    hs = hw // rate
    rng = np.random.default_rng(image)
    f = torch.from_numpy(np.maximum(rng.standard_normal(
        (bsz, hw, hw, c)), 0).astype(np.float32)).to(cuda)
    hole = torch.from_numpy((rng.random((bsz, hw, hw, 1)) < 0.05).astype(
        np.float32)).to(cuda)
    hole[1] = 1.0
    g = torch.from_numpy(rng.standard_normal(f.shape).astype(
        np.float32)).to(cuda)
    fb = f.to(torch.bfloat16)
    taps, lse = fused_attention_taps(fb, hole, want_lse=True)
    maps, gmaps, bias, rnorm, _ = prepare_bwd(fb, hole, g, 3, rate)
    args = (maps, gmaps, bias, rnorm, lse, taps, hs, hs, rate, 10.0)
    assert plan_bwd(hs, hs, c, torch.bfloat16).chunk >= bsz
    dispatch.reset_launches()
    got = tap_grads(*args)
    assert {k: dispatch.launches[k] for k in (
        "contextual_attention_bwd_delta", "contextual_attention_bwd_scores",
        "contextual_attention_bwd_dq", "contextual_attention_bwd_dkv")} == {
        "contextual_attention_bwd_delta": 1,
        "contextual_attention_bwd_scores": 1,
        "contextual_attention_bwd_dq": 1, "contextual_attention_bwd_dkv": 1}
    again = tap_grads(*args)
    chunked = tap_grads(*args, budget=3 * scratch_bytes_per_sample(hs * hs))
    torch.cuda.synchronize()
    for a, b_, c_ in zip(got, again, chunked):
        assert torch.equal(a, b_) and torch.equal(a, c_)
    for a in got[:4]:
        assert torch.isfinite(a).all()
        assert a[1].abs().max().item() == 0.0
    for which, idx in (("dq", (0, 4)), ("dkv", (1, 2, 3))):
        want = tap_grads_mirror(*args, which=which)
        for i, ref in zip(idx, want):
            err = (got[i] - ref).abs().max().item()
            assert err <= 2.0 ** -6 * max(ref.abs().max().item(), 1.0), (
                which, i, err)
        del want
    return got, args


# the tap-gradient fold against the eager epilogue on the same tap
# gradients: float32 1e-5 of the largest entry (the same float32 terms in
# the same order per pixel); bf16 maps 2^-7 of it (the output rounded once
# to bf16)
@pytest.mark.parametrize("b,h,w,c,rate", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_grad_fold_kernel_matches_plain(cuda, b, h, w, c, rate, dtype):
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        fold_tap_grads,
        fold_tap_grads_plain,
        tap_grads_mirror,
    )

    hs, ws = h // rate, w // rate
    f, hole, g, taps, lse, (maps, gmaps, bias, rnorm, _) = _bwd_case(
        h + c, b, h, w, c, rate, cuda, dtype)
    dq, dk, dv, tnorm, _ = tap_grads_mirror(maps, gmaps, bias, rnorm, lse,
                                            taps, hs, ws, rate, 10.0)
    args = (maps, dq, dk, dv, tnorm, rnorm, hs, ws, rate, 10.0)
    dispatch.reset_launches()
    got = fold_tap_grads(*args)
    again = fold_tap_grads(*args)
    assert dispatch.launches["contextual_attention_bwd_fold"] == 2
    want = fold_tap_grads_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    assert torch.equal(got, again)
    frac = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    tol = frac * max(want.abs().max().item(), 1.0)
    assert (got.float() - want).abs().max().item() <= tol
    if b >= 3:
        assert got[1].abs().max().item() == 0.0
    with pytest.raises(ValueError, match="dq_taps"):
        fold_tap_grads(maps, dq[:, :8], dk, dv, tnorm, rnorm, hs, ws, rate,
                       10.0)


@pytest.mark.parametrize("b,h,w,c,rate", BWD_SHAPES)
def test_attention_autograd_on_cuda_matches_plain(cuda, b, h, w, c, rate):
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        contextual_attention_bwd_plain,
    )

    f, hole, g, _, _, _ = _bwd_case(h + w, b, h, w, c, rate, cuda,
                                    torch.float32)
    from gan_inpainting_torch.ops.kernels.fused_attention import fused_route

    x = f.clone().requires_grad_(True)
    dispatch.reset_launches()
    y = contextual_attention(x, x, hole, rate=rate)
    # a non-contiguous upstream gradient, as a following permute would give
    y.backward(g.transpose(1, 2).contiguous().transpose(1, 2))
    # maps above the measured threshold take the patch kernels
    kind = ("contextual_attention_bwd" if fused_route(f.shape, 3, rate,
                                                      f.dtype)
            else "patch_attention_bwd")
    assert dispatch.launches[f"{kind}_dq"] == 1
    assert dispatch.launches[f"{kind}_dkv"] == 1
    if kind == "contextual_attention_bwd":
        assert dispatch.launches["contextual_attention_bwd_fold"] == 1
    want = contextual_attention_bwd_plain(f, hole, g, rate=rate)
    tol = 2e-4 * max(want.abs().max().item(), 1.0)
    assert (x.grad - want).abs().max().item() <= tol
    assert torch.isfinite(x.grad).all()
    if b >= 3:
        assert x.grad[1].abs().max().item() == 0.0
    with torch.no_grad():
        dispatch.reset_launches()
        contextual_attention(x, x, hole, rate=rate)
        assert dispatch.launches.get(f"{kind}_dq", 0) == 0


# ---------------------------------------------------------------------------
# the trainer on the card
# ---------------------------------------------------------------------------

SMALL_TRAIN = ["model.use_attention=true", "model.base_features=16",
               "model.disc_features=16", "data.image_size=64",
               "data.batch_size=2", "data.synthetic_family=textured",
               "loss.r1_interval=2"]


def _small_train(device, overrides):
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.data.loader import make_dataset
    from gan_inpainting_torch.data.pipeline import make_train_batch
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step
    from gan_inpainting_torch.utils.rng import stream_generator

    cfg = apply_overrides(get_config("celebahq256_freeform"),
                          SMALL_TRAIN + overrides)
    state = create_state(cfg, device=device)
    images = next(make_dataset(cfg.data, seed=0, device=device))
    batch = make_train_batch(images, stream_generator(0, 1, 0), cfg.mask)
    return cfg, state, make_train_step(cfg), batch


def test_f32_train_steps_on_cuda_match_cpu(cuda):
    """Two float32 steps (the second without R1), kernels on the card
    against the plain versions on the CPU. One Adam step moves a parameter
    by at most lr = 4e-4; 1e-4 absolute covers a near-zero gradient whose
    rounding noise decides the direction."""
    f32 = ["model.dtype_policy=f32", "model.spectral_norm=true"]
    _, s_cpu, f_cpu, b_cpu = _small_train("cpu", f32)
    _, s_gpu, f_gpu, b_gpu = _small_train(cuda, f32)
    for a, b in zip(b_cpu, b_gpu):      # the same batch on both devices
        torch.testing.assert_close(a, b.cpu(), rtol=1e-5, atol=1e-5)
    dispatch.reset_launches()
    for _ in range(2):
        m_cpu, m_gpu = f_cpu(s_cpu, b_cpu), f_gpu(s_gpu, b_gpu)
        for k in m_cpu:
            assert float(m_gpu[k]) == pytest.approx(float(m_cpu[k]),
                                                    rel=1e-3, abs=1e-4), k
    assert dispatch.launches["contextual_attention_bwd_dq"] == 2
    assert dispatch.launches["contextual_attention_fused"] == 4
    sd_c, sd_g = s_cpu.state_dict(), s_gpu.state_dict()
    for part in ("g_params", "d_params", "g_ema"):
        for k, v in sd_c[part].items():
            assert (sd_g[part][k].cpu() - v).abs().max().item() <= 1e-4, k


def test_published_width_runs_the_wgmma_kernels(cuda):
    """At the published width (base_features 24: C 96 at the attention) a
    serve_v4_8 forward of a 256² batch launches the wgmma forward and no
    core forward, and one places512_deepfill step at 2×512² launches the
    wgmma forward twice and the backward's δ, scores, dQ and dK/dV once each
    (the core backward would count dQ and dK/dV without scores)."""
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.data.loader import make_dataset
    from gan_inpainting_torch.data.pipeline import make_train_batch
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        KERNEL_CORE,
        KERNEL_WGMMA,
    )
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step
    from gan_inpainting_torch.utils.rng import stream_generator

    width = ["model.base_features=24"]
    cfg = apply_overrides(get_config("serve_v4_8"), width)
    gen = build_generator(cfg.model, device=cuda, seed=1)
    rng = np.random.default_rng(0)
    mask = torch.zeros(2, 256, 256, 1, device=cuda)
    mask[:, 64:160, 32:192] = 1.0
    masked = torch.from_numpy(rng.uniform(-1, 1, (2, 256, 256, 3)).astype(
        np.float32)).to(cuda) * (1 - mask)
    dispatch.reset_launches()
    with torch.no_grad():
        gen(masked, mask)
    torch.cuda.synchronize()
    assert dispatch.launches[KERNEL_WGMMA] == 1
    assert dispatch.launches.get(KERNEL_CORE, 0) == 0

    cfg = apply_overrides(get_config("places512_deepfill"),
                          width + ["data.batch_size=2"])
    state = create_state(cfg, device=cuda)
    images = next(make_dataset(cfg.data, seed=0, device=cuda))
    batch = make_train_batch(images, stream_generator(0, 1, 0), cfg.mask)
    dispatch.reset_launches()
    make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    launched = {k: v for k, v in dispatch.launches.items() if v}
    assert launched.get(KERNEL_WGMMA) == 2 and KERNEL_CORE not in launched
    assert {k: launched.get(f"contextual_attention_bwd_{k}") for k in (
        "delta", "scores", "dq", "dkv")} == dict(delta=1, scores=1, dq=1,
                                                 dkv=1), launched


def test_bf16_training_on_cuda_drives_l1_down(cuda):
    # the reconstruction loss alone drives G (a GAN on two images at this
    # learning rate wanders: g_l1 ended at 0.74 and at 0.84 in two runs)
    _, state, step, batch = _small_train(cuda, ["train.g_lr=0.001",
                                                "loss.gan_weight=0.0"])
    l1 = []
    for _ in range(60):
        metrics = step(state, batch)
        l1.append(float(metrics["g_l1"]))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert min(l1[-5:]) < 0.9 * l1[0], (l1[0], l1[-5:])


def test_checkpoint_resume_on_cuda(cuda, tmp_path):
    """A run resumed on the card ends bit for bit where the uninterrupted
    run ends only if every kernel is deterministic; cuDNN's autotuned
    algorithms are not bound to be, so the check is closeness, and that
    the restored state equals the saved one exactly."""
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.io.checkpoint import CheckpointManager
    from gan_inpainting_torch.train.loop import train
    from gan_inpainting_torch.train.state import create_state

    def cfg_for(workdir, steps):
        return apply_overrides(get_config("celebahq256_freeform"),
                               SMALL_TRAIN + [
            f"train.steps={steps}", "train.checkpoint_every=2",
            "train.eval_every=100", "data.num_eval_batches=1",
            "data.eval_batch_size=2", f"train.workdir={workdir}"])

    full, _ = train(cfg_for(tmp_path / "a", 4), verbose=False)
    train(cfg_for(tmp_path / "b", 2), verbose=False)
    saved = CheckpointManager(tmp_path / "b").restore_raw()
    fresh = create_state(cfg_for(tmp_path / "b", 2))
    CheckpointManager(tmp_path / "b").restore(fresh)
    for k, v in saved["g_params"].items():
        assert torch.equal(v, fresh.generator.state_dict()[k].cpu())
    resumed, _ = train(cfg_for(tmp_path / "b", 4), verbose=False)
    assert resumed.step == full.step == 4
    for a, b in zip(full.generator.parameters(),
                    resumed.generator.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-3)


# ---------------------------------------------------------------------------
# gated-conv kernels and the partial-conv epilogue kernel
# ---------------------------------------------------------------------------
# Gated convs: float32 (CUDA-core variant, full float32 products) against
# the plain version (cuDNN conv with TF32 off + eager epilogue), 2e-4 of the
# largest reference entry; bfloat16 (tensor-core variant) on bf16 inputs
# against the plain version in float32 on the same bf16 values, 2^-7 of the
# largest reference entry (the output is rounded to bf16).

GATED_SHAPES = [
    # b, h, w, cin, f, k, stride, dilation
    (2, 16, 16, 16, 16, 3, 1, 1),
    (1, 13, 17, 5, 6, 5, 1, 1),      # a stem's form: padded Cin, odd sizes
    (2, 12, 20, 48, 24, 3, 1, 2),    # chunks straddle taps, F padded to 32
    (1, 8, 8, 8, 8, 3, 1, 1),        # K = 72: under two chunks of the ring
    (1, 32, 32, 192, 192, 3, 1, 16),  # full width, dilation beyond the map
    (1, 9, 11, 24, 70, 3, 1, 4),     # F above 64: two column blocks
    (1, 6, 6, 4, 4, 1, 1, 1),        # K = 4 (8 padded): one chunk
    (2, 16, 16, 48, 96, 3, 2, 1),    # stride 2: the im2col kernel
    (1, 15, 13, 5, 7, 5, 2, 1),      # stride 2, odd everything
    (1, 16, 16, 8, 8, 4, 1, 1),      # even window: the im2col kernel
    (2, 8, 16, 96, 96, 3, 1, 1),     # bf16: TMA box (16, 8, 1), N 192
    (3, 4, 8, 192, 192, 3, 1, 2),    # box (8, 4, 4), ragged M, 2 columns
    (2, 16, 16, 96, 192, 3, 2, 1),   # stride 2 at Cin 96, high-side pad
    (1, 8, 8, 384, 40, 3, 1, 1),     # box (8, 8, 2), half a block, F 40
]


def _gated_case(seed, b, h, w, cin, f, k, device, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(
        np.float32)).to(device)
    wgt = torch.from_numpy((rng.standard_normal((2 * f, cin, k, k))
                            / np.sqrt(k * k * cin)).astype(np.float32))
    bias = torch.from_numpy(0.5 * rng.standard_normal(2 * f).astype(
        np.float32))
    return x.to(dtype), wgt.to(device).to(dtype), bias.to(device)


@pytest.mark.parametrize("b,h,w,cin,f,k,stride,dilation", GATED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["elu", "relu"])
def test_gated_conv_kernels_match_plain(cuda, b, h, w, cin, f, k, stride,
                                        dilation, dtype, activation):
    from gan_inpainting_torch.ops.gated_conv import (
        gated_conv,
        gated_conv_plain,
    )

    x, wgt, bias = _gated_case(h * w + cin, b, h, w, cin, f, k, cuda, dtype)
    dispatch.reset_launches()
    got = gated_conv(x, wgt, bias, stride=stride, dilation=dilation,
                     activation=activation, backend="pallas")
    direct = stride == 1 and k % 2 == 1
    assert dispatch.launches.get("gated_conv_direct", 0) == int(direct)
    assert dispatch.launches.get("gated_matmul", 0) == int(not direct)
    want = gated_conv_plain(x.float(), wgt.float(), bias, stride=stride,
                            dilation=dilation, activation=activation)
    assert got.dtype == dtype and got.shape == want.shape
    frac = 2e-4 if dtype == torch.float32 else 2.0 ** -7
    tol = frac * max(want.abs().max().item(), 1.0)
    assert (got.float() - want).abs().max().item() <= tol
    # under "xla" nothing is launched
    dispatch.reset_launches()
    gated_conv(x, wgt, bias, stride=stride, dilation=dilation,
               activation=activation, backend="xla")
    assert not any(dispatch.launches.values())


@pytest.mark.parametrize("activation", ["leaky_relu", "tanh", "none"])
@pytest.mark.parametrize("block_n", [0, 1])
def test_gated_conv_activations_and_block_widths(cuda, activation, block_n):
    """Both column-block widths of each variant at F = 40 (float32 32 / 64,
    bf16 48 / 96), whichever plan() would pick, on the TMA path (Cin 32,
    16x16 map) and on the gather (Cin 24)."""
    from gan_inpainting_torch.ops.gated_conv import gated_conv_plain
    from gan_inpainting_torch.ops.kernels.direct_conv import launch_direct
    from gan_inpainting_torch.ops.kernels.gated_matmul import (
        pack_weights,
        plan,
    )

    for dtype, widths in ((torch.float32, (32, 64)),
                          (torch.bfloat16, (48, 96))):
        for cin in (32, 24):
            x, wgt, bias = _gated_case(3, 2, 16, 16, cin, 40, 3, cuda, dtype)
            bf = widths[block_n]
            p = plan(cin, 40, dtype)._replace(block_f=bf,
                                              n_col=-(-40 // bf))
            got = launch_direct(x, pack_weights(wgt, p), bias, 40, 3, 2, p,
                                activation)
            want = gated_conv_plain(x.float(), wgt.float(), bias,
                                    dilation=2, activation=activation)
            frac = 2e-4 if dtype == torch.float32 else 2.0 ** -7
            tol = frac * max(want.abs().max().item(), 1.0)
            assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.parametrize("stride", [1, 2])
def test_gated_conv_function_gradients_match_plain(cuda, stride):
    from gan_inpainting_torch.ops.gated_conv import gated_conv

    x, wgt, bias = _gated_case(5, 2, 16, 16, 16, 8, 3, cuda, torch.float32)
    g = torch.randn(2, 16 // stride, 16 // stride, 8, device=cuda)
    grads = {}
    for backend in ("xla", "pallas"):
        leaves = [t.clone().requires_grad_(True) for t in (x, wgt, bias)]
        y = gated_conv(*leaves, stride=stride, backend=backend)
        y.backward(g)
        grads[backend] = [t.grad for t in leaves]
    for a, b_ in zip(grads["xla"], grads["pallas"]):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
    # a frozen input (the stem sees the image) still gets weight gradients
    wl = wgt.clone().requires_grad_(True)
    gated_conv(x, wl, bias, stride=stride, backend="pallas").backward(g)
    torch.testing.assert_close(wl.grad, grads["xla"][1], rtol=1e-5,
                               atol=1e-5)


def test_gated_conv_kernels_refuse_other_dtypes(cuda):
    from gan_inpainting_torch.ops.gated_conv import gated_conv

    x, wgt, bias = _gated_case(6, 1, 8, 8, 8, 8, 3, cuda, torch.float32)
    with pytest.raises(TypeError):
        gated_conv(x.half(), wgt.half(), bias, backend="pallas")
    with pytest.raises(TypeError, match="match"):
        gated_conv(x, wgt.to(torch.bfloat16), bias, backend="pallas")
    with pytest.raises(TypeError):
        gated_conv(x.half(), wgt.half(), bias, stride=2, backend="pallas")
    with pytest.raises(ValueError, match="one device"):
        gated_conv(x, wgt, bias.cpu(), backend="pallas")


PARTIAL_SHAPES = [(2, 16, 16, 8), (1, 13, 17, 5), (3, 9, 7, 24),
                  (2, 32, 32, 48), (1, 8, 8, 192), (1, 5, 6, 1)]


@pytest.mark.parametrize("b,h,w,c", PARTIAL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_epilogue_kernel_matches_plain(cuda, b, h, w, c, dtype):
    """float32: 1e-6 (the same three float32 steps); bfloat16: the kernel
    rounds once where the plain version rounds scale, product and sum, so
    2^-7 of the largest reference entry. ``valid_out`` and the zero-count
    pixels are exact."""
    from gan_inpainting_torch.ops.kernels.partial_epilogue import (
        partial_conv_epilogue,
        partial_conv_epilogue_plain,
    )

    rng = np.random.default_rng(b * h * w * c)
    raw = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(
        np.float32)).to(cuda).to(dtype)
    counts = torch.from_numpy(rng.integers(0, 10, (b, h, w, 1)).astype(
        np.float32)).to(cuda)
    counts[0, : h // 2] = 0.0
    raw[0, 0] = 1e30              # finite garbage where count = 0
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(cuda)
    dispatch.reset_launches()
    y, valid = partial_conv_epilogue(raw, counts, bias, 3)
    assert dispatch.launches["partial_epilogue"] == 1
    want_y, want_v = partial_conv_epilogue_plain(raw.float(), counts, bias, 3)
    assert y.dtype == valid.dtype == dtype and valid.shape == (b, h, w, 1)
    assert torch.equal(valid.float(), want_v)
    dead = (counts == 0).expand_as(raw)
    assert (y[dead] == 0).all()
    tol = (1e-6 if dtype == torch.float32 else 2.0 ** -7) * max(
        want_y.abs().max().item(), 1.0)
    assert (y.float() - want_y).abs().max().item() <= tol


def test_partial_epilogue_function_gradients(cuda):
    from gan_inpainting_torch.ops.kernels.partial_epilogue import (
        partial_conv_epilogue,
        partial_conv_epilogue_plain,
    )

    rng = np.random.default_rng(9)
    raw = torch.from_numpy(rng.standard_normal((2, 9, 11, 12)).astype(
        np.float32)).to(cuda)
    counts = torch.from_numpy(rng.integers(0, 10, (2, 9, 11, 1)).astype(
        np.float32)).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(12).astype(np.float32)).to(
        cuda)
    g = torch.randn_like(raw)
    grads = []
    for fn in (partial_conv_epilogue_plain, partial_conv_epilogue):
        r, b_ = raw.clone().requires_grad_(True), bias.clone().requires_grad_(
            True)
        y, valid = fn(r, counts, b_, 3)
        assert not valid.requires_grad
        y.backward(g)
        grads.append((r.grad, b_.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        partial_conv_epilogue(raw.half(), counts, bias, 3)


def test_generators_on_cuda_agree_across_backends(cuda):
    """A small float32 gated attention generator and a partial-conv one:
    ``pallas`` launches its kernels and agrees with ``xla`` on the card."""
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.models.generator import build_generator

    rng = np.random.default_rng(0)
    masked = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)).to(cuda)
    mask = torch.zeros(2, 64, 64, 1, device=cuda)
    mask[:, 16:40, 8:48] = 1.0
    masked = masked * (1 - mask)
    small = ["model.base_features=16", "model.dtype_policy=f32"]
    for name, extra, expect in (
            ("serve_v4_8", [], {"gated_conv_direct": 29, "gated_matmul": 6}),
            ("celebahq256_freeform", [], {"gated_conv_direct": 28,
                                          "gated_matmul": 4}),
            ("partialconv256", [], {"partial_epilogue": 16})):
        cfg = apply_overrides(get_config(name), small + extra)
        outs = {}
        for backend in ("xla", "pallas"):
            gen = build_generator(cfg.model, device=cuda, seed=1,
                                  backend=backend)
            dispatch.reset_launches()
            with torch.no_grad():
                outs[backend] = gen(masked, mask).fine
            if backend == "pallas":
                for kname, n in expect.items():
                    assert dispatch.launches.get(kname, 0) == n, (
                        name, kname, dict(dispatch.launches))
        torch.testing.assert_close(outs["pallas"], outs["xla"], rtol=2e-4,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# patch-attention kernels
# ---------------------------------------------------------------------------
# Float32 (core variant) against the plain versions, 2e-4 of the largest
# entry (sums in another order). bfloat16 inputs against the plain versions
# in float32 on the same values: 2^-7 of the largest entry for the forward
# (p rounded to bf16 before the PV product), 2^-6 for the gradients (p and
# ds rounded to bf16 for their products, which the JAX backward does not).

PATCH_SHAPES = [
    (2, 64, 64, 36, 48),        # d, dv not multiples of 16
    (2, 130, 70, 36, 64),       # Lq, Lk ragged against every tile
    (1, 200, 333, 72, 128),
    (2, 96, 96, 1728, 3072),    # the full widths at C = 192: clusters of 8
]


def _patch_case(seed, b, lq, lk, d, dv, device, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, d))
    k = (k / np.linalg.norm(k, axis=-1, keepdims=True)).astype(np.float32)
    v = rng.standard_normal((b, lk, dv)).astype(np.float32)
    g = rng.standard_normal((b, lq, dv)).astype(np.float32)
    valid = rng.random((b, lk)) < 0.7
    valid[-1] = False                    # a sample with no valid key
    q, k, v, g = (torch.from_numpy(a).to(device, dtype) for a in (q, k, v, g))
    return q, k, torch.from_numpy(valid).to(device), v, g


def _rel(got, want):
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1.0))


@pytest.mark.parametrize("b,lq,lk,d,dv", PATCH_SHAPES)
@pytest.mark.parametrize("dtype,variant", [
    (torch.float32, "core"), (torch.bfloat16, "core"),
    (torch.bfloat16, None)], ids=["f32-core", "bf16-core", "bf16-planned"])
def test_patch_attention_kernels_match_plain(cuda, b, lq, lk, d, dv, dtype,
                                             variant):
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        launch_dkv,
        launch_dq,
        launch_fwd,
        patch_attention_bwd_plain,
        patch_attention_plain,
    )

    q, k, valid, v, g = _patch_case(lq + d, b, lq, lk, d, dv, cuda, dtype)
    # planned: the wgmma forward and backward
    out_k, lse_k = launch_fwd(q, k, valid, v, 10.0, want_lse=True,
                              variant=variant)
    out_p, lse_p = patch_attention_plain(q.float(), k.float(), valid,
                                         v.float(), softmax_scale=10.0,
                                         want_lse=True)
    f_tol = 2e-4 if dtype == torch.float32 else 2.0 ** -7
    b_tol = 2e-4 if dtype == torch.float32 else 2.0 ** -6
    torch.cuda.synchronize()
    assert out_k.dtype == dtype and _rel(out_k, out_p) <= f_tol
    assert (lse_k - lse_p).abs().max().item() <= 1e-3
    assert out_k[-1].abs().max().item() == 0.0
    assert lse_k[-1].abs().max().item() == 0.0
    # the backward from the plain forward's residuals
    out = out_p.to(dtype)
    delta = (g.float() * out.float()).sum(-1)
    dq = launch_dq(q, k, valid, v, g, lse_p, delta, 10.0, variant=variant)
    dk, dv_ = launch_dkv(q, k, valid, v, g, lse_p, delta, 10.0,
                         variant=variant)
    want = patch_attention_bwd_plain(q.float(), k.float(), valid, v.float(),
                                     out.float(), lse_p, g.float(),
                                     softmax_scale=10.0, keep_float=True)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv_), want):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        assert _rel(got, ref) <= b_tol, (name, _rel(got, ref))
        assert got[-1].abs().max().item() == 0.0, name


# The wgmma forward where L is not a multiple of its 128-key step nor of
# its 64-row tile and d, dv are not multiples of 64 (nor dv of 8: the
# wrapper pads V), at B 1, 3 and 8; then the backward kernels from that
# forward's own out and lse.
@pytest.mark.parametrize("b,L", [(1, 1000), (3, 1000), (8, 1000), (1, 4097),
                                 (3, 4097)])
def test_wgmma_patch_forward_ragged_and_its_backward(cuda, b, L):
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        launch_dkv,
        launch_dq,
        launch_fwd,
        patch_attention_bwd_plain,
        patch_attention_plain,
        plan,
    )

    d, dv = 200, 300
    assert plan(d, dv, torch.bfloat16)[0] == "wgmma"
    q, k, valid, v, g = _patch_case(b + L, b, L, L, d, dv, cuda,
                                    torch.bfloat16)
    if b == 1:                           # revive the only sample
        valid[0] = torch.arange(L, device=cuda) % 3 != 0
    out_k, lse_k = launch_fwd(q, k, valid, v, 10.0, want_lse=True)
    out_p, lse_p = patch_attention_plain(q.float(), k.float(), valid,
                                         v.float(), softmax_scale=10.0,
                                         want_lse=True)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) <= 2.0 ** -7
    assert (lse_k - lse_p).abs().max().item() <= 1e-3
    if b > 1:
        assert out_k[-1].abs().max().item() == 0.0
        assert lse_k[-1].abs().max().item() == 0.0
    delta = (g.float() * out_k.float()).sum(-1)
    dq = launch_dq(q, k, valid, v, g, lse_k, delta, 10.0)
    dk, dv_ = launch_dkv(q, k, valid, v, g, lse_k, delta, 10.0)
    want = patch_attention_bwd_plain(q.float(), k.float(), valid, v.float(),
                                     out_k.float(), lse_k, g.float(),
                                     softmax_scale=10.0, keep_float=True)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv_), want):
        assert _rel(got, ref) <= 2.0 ** -6, (name, _rel(got, ref))


# The wgmma dQ and dK/dV (clusters of 2 at d 200 / dv 300, dv padded to
# 304 for the tensor maps) where L is ragged against the 64-row tiles and
# the 128-column steps, from the plain forward's residuals; with B > 1 the
# last sample has no valid key and its gradients are exactly 0.
@pytest.mark.parametrize("b,L", [(3, 1000), (1, 4097), (2, 4097)])
def test_wgmma_patch_backward_ragged_with_a_dead_sample(cuda, b, L):
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        _launch_bwd,
        launch_dkv,
        launch_dq,
        patch_attention_bwd_plain,
        patch_attention_plain,
        plan,
    )

    d, dv = 200, 300
    assert plan(d, dv, torch.bfloat16, "dq") == ("wgmma", 2)
    assert plan(d, dv, torch.bfloat16, "dkv") == ("wgmma", 2)
    q, k, valid, v, g = _patch_case(2 * L + b, b, L, L, d, dv, cuda,
                                    torch.bfloat16)
    if b == 1:                           # revive the only sample
        valid[0] = torch.arange(L, device=cuda) % 5 != 0
    out, lse = patch_attention_plain(q.float(), k.float(), valid, v.float(),
                                     softmax_scale=10.0, want_lse=True)
    out = out.to(torch.bfloat16)
    delta = (g.float() * out.float()).sum(-1)
    dispatch.reset_launches()
    dq = launch_dq(q, k, valid, v, g, lse, delta, 10.0)
    dk, dv_ = launch_dkv(q, k, valid, v, g, lse, delta, 10.0)
    assert dispatch.launches["patch_attention_bwd_dq"] == 1
    assert dispatch.launches["patch_attention_bwd_dkv"] == 1
    # the profiling instance: the same dq, and every block of every cluster
    # walks ⌈L / 128⌉ steps through its phase clocks
    clocks = torch.zeros(8, dtype=torch.int64, device=cuda)
    dq_clocked = _launch_bwd("dq", q, k, valid, v, g, lse, delta, 10.0, None,
                             clocks=clocks)[0]
    blocks = -(-L // 64) * 2 * b
    assert clocks[7].item() == blocks * -(-L // 128)
    assert (clocks[:7] > 0).all()
    assert torch.equal(dq_clocked, dq)
    want = patch_attention_bwd_plain(q.float(), k.float(), valid, v.float(),
                                     out.float(), lse, g.float(),
                                     softmax_scale=10.0, keep_float=True)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv_), want):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got, ref) <= 2.0 ** -6, (name, _rel(got, ref))
        if b > 1:
            assert got[-1].abs().max().item() == 0.0, name


def test_fused_backward_from_the_wgmma_forward(cuda):
    """The fused backward kernels fed by the wgmma forward's taps and lse
    (the train path), against the mirror on the same residuals."""
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        prepare_bwd,
        tap_grads,
        tap_grads_mirror,
    )

    b, h, w, c, rate = 3, 64, 64, 64, 2
    hs, ws = h // rate, w // rate
    f, hole = _case(5, b, h, w, c, cuda)
    fb = f.to(torch.bfloat16)
    g = torch.randn(f.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(5))
    taps, lse = fused_attention_taps(fb, hole, want_lse=True)
    maps, gmaps, bias, rnorm, _ = prepare_bwd(fb, hole, g, 3, rate)
    args = (maps, gmaps, bias, rnorm, lse, taps, hs, ws, rate, 10.0)
    want = tap_grads_mirror(*args)
    got = tap_grads(*args)
    torch.cuda.synchronize()
    for name, a, ref in zip(("dq", "dk", "dv", "tnorm", "delta"), got, want):
        tol = 2.0 ** -6 * max(ref.abs().max().item(), 1.0)
        assert (a - ref).abs().max().item() <= tol, name
    assert got[0][1].abs().max().item() == 0.0


def test_patch_attention_autograd_on_cuda(cuda):
    from gan_inpainting_torch.ops.kernels.patch_attention import (
        attend,
        patch_attention_plain,
    )

    q, k, valid, v, g = _patch_case(3, 2, 100, 90, 72, 64, cuda,
                                    torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dispatch.reset_launches()
    y = attend(leaves[0], leaves[1], valid, leaves[2], 10.0)
    y.backward(g)
    # reset_launches keeps the names earlier tests launched, at 0
    assert {name: n for name, n in dispatch.launches.items() if n} == {
        "patch_attention_fwd": 1, "patch_attention_bwd_dq": 1,
        "patch_attention_bwd_dkv": 1}
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    patch_attention_plain(ref[0], ref[1], valid, ref[2],
                          softmax_scale=10.0).backward(g)
    for a, b_ in zip(leaves, ref):
        assert _rel(a.grad, b_.grad) <= 2e-4


@pytest.mark.parametrize("case", ["f_not_b", "ksize5", "no_fused_bwd"])
def test_contextual_attention_patch_routes_on_cuda(cuda, case, monkeypatch):
    """Every route into the patch kernels: f ≠ b, ksize ≠ 3, and the fused
    forward whose backward plan is refused."""
    from gan_inpainting_torch.ops.kernels import fused_attention_bwd as fab
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        contextual_attention_bwd_plain,
    )

    f, hole = _case(7, 3, 32, 32, 8, cuda)
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.standard_normal(f.shape).astype(
        np.float32)).to(cuda)
    ksize = 5 if case == "ksize5" else 3
    if case == "no_fused_bwd":
        monkeypatch.setattr(fab, "bwd_supported", lambda *a: False)
    x = f.clone().requires_grad_(True)
    other = x.flip(2) if case == "f_not_b" else x
    dispatch.reset_launches()
    y = contextual_attention(x, other, hole, ksize=ksize)
    y.backward(g)
    fused = 1 if case == "no_fused_bwd" else 0
    assert dispatch.launches.get("contextual_attention_fused", 0) == fused
    assert dispatch.launches.get("contextual_attention_bwd_dq", 0) == 0
    for name in ("patch_attention_fwd", "patch_attention_bwd_dq",
                 "patch_attention_bwd_dkv"):
        assert dispatch.launches.get(name) == 1, name
    want_y = contextual_attention_plain(f, f.flip(2) if case == "f_not_b"
                                        else f, hole, ksize=ksize)
    torch.testing.assert_close(y.detach(), want_y, rtol=2e-4, atol=2e-4)
    if case == "f_not_b":
        ref = f.clone().requires_grad_(True)
        contextual_attention_plain(ref, ref.flip(2), hole).backward(g)
        want = ref.grad
    else:
        want = contextual_attention_bwd_plain(f, hole, g, ksize=ksize)
    assert _rel(x.grad, want) <= 2e-4
    assert x.grad[1].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interpret_kernels_launches_nothing_on_the_card(cuda, dtype):
    """Inside interpret_kernels a CUDA feature map takes the mirrors (no
    launch) and agrees with the kernels; after it the kernels launch."""
    from gan_inpainting_torch.utils.debug import interpret_kernels

    f, hole = _case(11, 3, 32, 32, 64, cuda)
    f = f.to(dtype)
    g = torch.randn(f.shape, device=cuda, generator=torch.Generator(
        cuda).manual_seed(0)).to(dtype)

    def run():
        x = f.clone().requires_grad_(True)
        y = contextual_attention(x, x, hole)
        (dx,) = torch.autograd.grad(y, x, g)
        return y.float(), dx.float()

    dispatch.reset_launches()
    with interpret_kernels():
        y_i, dx_i = run()
    assert not any(dispatch.launches.values())
    y_k, dx_k = run()
    assert dispatch.launches["contextual_attention_fused"] == 1
    frac = 2e-4 if dtype == torch.float32 else 2.0 ** -6
    for a, b in ((y_i, y_k), (dx_i, dx_k)):
        assert (a - b).abs().max().item() <= frac * max(
            b.abs().max().item(), 1.0)


def _op_case(name, device):
    """Small inputs on the card for one op of ops/kernels/library.py, in
    the dtypes its kernel takes (bf16 at C 64 for the wgmma variants)."""
    from gan_inpainting_torch.ops.kernels.gated_matmul import kernel_weights

    gen = torch.Generator(device).manual_seed(0)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, device=device, generator=gen).to(dtype)

    x = torch.relu(t(2, 16, 16, 64, dtype=torch.bfloat16))
    hole = (torch.rand((2, 16, 16, 1), device=device, generator=gen)
            < 0.3).float()
    xc = t(2, 12, 12, 8, dtype=torch.bfloat16)
    w, b = t(48, 8, 3, 3) * 0.2, t(48)
    valid = torch.rand((2, 70), device=device, generator=gen) < 0.7
    return {
        "fused_attention_taps": (x, hole, 3, 2, 10.0, True),
        "fold_taps": (t(2, 16, 64, 64, dtype=torch.bfloat16), 8, 8, 2),
        "gated_conv_direct": (xc, w, kernel_weights(w, xc), b, 2, "elu"),
        "gated_conv_matmul": (xc, w, kernel_weights(w, xc), b, 2, 1,
                              "relu"),
        "partial_epilogue": (t(2, 8, 8, 48), torch.randint(
            0, 10, (2, 8, 8, 1), device=device,
            generator=gen).float(), t(48), 3),
        "patch_attention": (t(2, 64, 72, dtype=torch.bfloat16),
                            t(2, 70, 72, dtype=torch.bfloat16), valid,
                            t(2, 70, 96, dtype=torch.bfloat16), 10.0, True),
    }[name]


@pytest.mark.parametrize("name", [
    "fused_attention_taps", "fold_taps", "gated_conv_direct",
    "gated_conv_matmul", "partial_epilogue", "patch_attention"])
def test_kernel_ops_pass_opcheck_on_the_card(cuda, name):
    """Each serving kernel's torch.library op (ops/kernels/library.py) on
    the card: schema, the fake implementation against the launch, and the
    traced dispatch; the launch is counted by the CUDA implementation."""
    from gan_inpainting_torch.ops.kernels import library

    library.load_all()
    op = getattr(torch.ops.gan_inpainting, name).default
    args = _op_case(name, cuda)
    kernel = {"fused_attention_taps": "contextual_attention_fused",
              "gated_conv_matmul": "gated_matmul",
              "patch_attention": "patch_attention_fwd"}.get(name, name)
    dispatch.reset_launches()
    op(*args)
    torch.cuda.synchronize()
    assert dispatch.launches.get(kernel) == 1
    torch.library.opcheck(op, args)
