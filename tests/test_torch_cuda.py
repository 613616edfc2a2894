"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. On a machine with a
card (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Float32 tolerance 2e-4 at these small shapes; bfloat16 runs the kernel on
bf16 inputs against the plain version in float32 on the same values, with
2^-7 of the largest input as the tolerance (weights and outputs rounded to
bf16). TF32 is off. The backward kernels and the trainer follow below,
each with its tolerance.
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
    (2, 64, 64, 192, 32, 1),     # 256² serve map
    (1, 64, 128, 128, 32, 2),    # Lk = 2048, non-square
    (2, 128, 128, 64, 32, 4),    # Lk = 4096, the 512² regime
    (1, 128, 256, 64, 32, 8),    # Lk = 8192
])
@pytest.mark.parametrize("variant", ["mma", "core"])
def test_both_variants_match_plain_in_bf16(cuda, b, h, w, c, group, cluster,
                                           variant):
    f, hole = _case(h + w + c, b, h, w, c, cuda)
    hole[0, : h // 2] = 1.0              # a large hole as well
    if b > 1:
        hole[1] = 1.0                    # and one with no valid key
    fb = f.to(torch.bfloat16)
    assert plan(h // 2, w // 2, c, torch.bfloat16) == ("mma", group, cluster)
    maps, bias, rnorm, (hs, ws) = _prepare(fb, hole, 3, 2)
    got = _launch(maps, bias, rnorm, hs, ws, 2, 10.0, variant=variant)
    want = fused_attention_taps_plain(fb.float(), hole)
    tol = 2.0 ** -7 * fb.float().abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.parametrize("b,h,w,c,rate", SHAPES)
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
    with pytest.raises(NotImplementedError):
        contextual_attention(f, f.clone(), hole)
    taps = torch.zeros(1, 16, 64, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fold_taps(taps.transpose(2, 3).contiguous().transpose(2, 3), 8, 8, 2)


# ---------------------------------------------------------------------------
# backward kernels
# ---------------------------------------------------------------------------
# Float32: both kernels (core variant) against their PyTorch mirror on the
# same maps, 2e-4 relative to the largest tap gradient (sums of up to
# L·C products in another order). bfloat16: kernels on bf16 maps against
# the mirror in float32 on the same bf16 values; 2^-6 of the largest tap
# gradient (p, and in the mma variant dsr, are rounded to bf16).

BWD_SHAPES = [
    (3, 16, 16, 8, 2),
    (2, 12, 20, 4, 2),      # non-square
    (1, 14, 14, 4, 2),      # L = 49: padded rows
    (1, 16, 16, 4, 4),
    (1, 16, 16, 4, 1),
    (2, 64, 64, 64, 2),     # mma shape, G = 32, one block
    (1, 128, 128, 64, 2),   # L = 4096: the 512² train regime, clusters 2/4
    (1, 128, 256, 64, 2),   # L = 8192, non-square: clusters 4/8
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
    (torch.bfloat16, "mma")])
def test_backward_kernels_match_mirror(cuda, b, h, w, c, rate, dtype,
                                       variant):
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        launch_dkv,
        launch_dq,
        plan_bwd,
        tap_grads_mirror,
    )

    hs, ws = h // rate, w // rate
    if variant == "mma" and plan_bwd(hs, ws, c, dtype, "dq")[0] != "mma":
        pytest.skip("shape not taken by the mma variant")
    f, hole, g, taps, lse, (maps, gmaps, bias, rnorm, _) = _bwd_case(
        h * c, b, h, w, c, rate, cuda, dtype)
    want = tap_grads_mirror(maps.float(), gmaps.float(), bias, rnorm, lse,
                            taps.float(), hs, ws, rate, 10.0)
    if dtype == torch.bfloat16:
        # the mirror rounds p to the maps' dtype: give it bf16 there
        want_p = tap_grads_mirror(maps, gmaps, bias, rnorm, lse, taps, hs,
                                  ws, rate, 10.0)
        want = want[:2] + (want_p[2],) + want[3:]
    dq, delta = launch_dq(maps, gmaps, bias, rnorm, lse, taps, hs, ws, rate,
                          10.0, variant=variant)
    dk, dv, tn = launch_dkv(maps, gmaps, bias, rnorm, lse, delta, hs, ws,
                            rate, 10.0, variant=variant)
    torch.cuda.synchronize()
    frac = 2e-4 if dtype == torch.float32 else 2.0 ** -6
    for name, got, ref in zip(("dq", "dk", "dv", "tnorm", "delta"),
                              (dq, dk, dv, tn, delta), want):
        tol = frac * max(ref.abs().max().item(), 1.0)
        err = (got - ref).abs().max().item()
        assert err <= tol, (name, err, tol)
    if b >= 3:      # the all-hole sample: exactly 0
        assert dq[1].abs().max().item() == 0.0
        assert dk[1].abs().max().item() == 0.0
        assert dv[1].abs().max().item() == 0.0


@pytest.mark.parametrize("b,h,w,c,rate", BWD_SHAPES)
def test_attention_autograd_on_cuda_matches_plain(cuda, b, h, w, c, rate):
    from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
        contextual_attention_bwd_plain,
    )

    f, hole, g, _, _, _ = _bwd_case(h + w, b, h, w, c, rate, cuda,
                                    torch.float32)
    x = f.clone().requires_grad_(True)
    dispatch.reset_launches()
    y = contextual_attention(x, x, hole, rate=rate)
    # a non-contiguous upstream gradient, as a following permute would give
    y.backward(g.transpose(1, 2).contiguous().transpose(1, 2))
    assert dispatch.launches["contextual_attention_bwd_dq"] == 1
    assert dispatch.launches["contextual_attention_bwd_dkv"] == 1
    want = contextual_attention_bwd_plain(f, hole, g, rate=rate)
    tol = 2e-4 * max(want.abs().max().item(), 1.0)
    assert (x.grad - want).abs().max().item() <= tol
    assert torch.isfinite(x.grad).all()
    if b >= 3:
        assert x.grad[1].abs().max().item() == 0.0
    with torch.no_grad():
        dispatch.reset_launches()
        contextual_attention(x, x, hole, rate=rate)
        assert dispatch.launches["contextual_attention_bwd_dq"] == 0


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
