"""The training slice against the JAX package on the CPU, float32: one and
two train steps of a tiny coarse-to-fine gated attention config from the
same converted state and the same numpy batch; gradient accumulation;
overfitting one batch; checkpoint and resume; serving from a checkpoint.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.configs.base import apply_overrides as j_overrides
from gan_inpainting_tpu.data.pipeline import Batch as JBatch
from gan_inpainting_tpu.train.state import create_state as j_create_state
from gan_inpainting_tpu.train.step import make_train_step as j_make_step

from gan_inpainting_torch.configs.base import config_from_dict
from gan_inpainting_torch.data.pipeline import Batch
from gan_inpainting_torch.io.convert import (
    discriminator_from_jax,
    load_state_from_jax,
    params_from_jax,
)
from gan_inpainting_torch.train.state import (
    clip_by_global_norm,
    create_state,
    ema_generator_params,
    make_lr_schedule,
)
from gan_inpainting_torch.train.step import make_train_step

ATTN = ["model.generator=coarse_to_fine", "model.conv_kind=gated",
        "model.use_attention=true", "loss.r1_gamma=0.1",
        "train.g_ema_decay=0.999", "model.dtype_policy=f32"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam(opt_state):
    found = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu")]
    assert len(found) == 1
    return {"mu": _np(found[0].mu), "nu": _np(found[0].nu),
            "count": int(found[0].count)}


def _jax_state_as_numpy(state):
    return {"step": int(state.step), "g_params": _np(state.g_params),
            "d_params": _np(state.d_params), "d_stats": _np(state.d_stats),
            "g_ema": _np(state.g_ema), "g_opt": _adam(state.g_opt),
            "d_opt": _adam(state.d_opt)}


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _numpy_batch(cfg, seed=0):
    """Smooth random images with a blocky random hole mask."""
    rng = np.random.default_rng(seed)
    b, s = cfg.data.batch_size, cfg.data.image_size
    low = rng.uniform(-1, 1, (b, s // 4, s // 4, 3)).astype(np.float32)
    image = np.clip(np.kron(low, np.ones((1, 4, 4, 1), np.float32))
                    + 0.1 * rng.standard_normal((b, s, s, 3)), -1, 1)
    image = image.astype(np.float32)
    mask = np.kron((rng.random((b, s // 8, s // 8, 1)) < 0.25),
                   np.ones((1, 8, 8, 1))).astype(np.float32)
    return image, mask


def _batches(image, mask):
    jb = JBatch(image=jnp.asarray(image), mask=jnp.asarray(mask),
                masked=jnp.asarray(image * (1 - mask)))
    tb = Batch(image=torch.from_numpy(image), mask=torch.from_numpy(mask),
               masked=torch.from_numpy(image * (1 - mask)))
    return jb, tb


def _assert_params_close(module_sd, jax_tree, atol, convert=params_from_jax):
    want = convert(jax_tree)
    assert set(want) == set(module_sd)
    worst = max((module_sd[k] - want[k]).abs().max().item() for k in want)
    assert worst <= atol, worst


def _pair(tiny_config, overrides):
    jcfg = j_overrides(tiny_config, overrides)
    jstate = j_create_state(jcfg, jax.random.key(0))
    cfg = _port_cfg(jcfg)
    state = create_state(cfg, device="cpu")
    load_state_from_jax(state, _jax_state_as_numpy(jstate))
    return jcfg, jstate, cfg, state


# metrics: rtol 1e-4 (float32 sums in another order through two networks;
# measured worst 4e-6). Parameters after Adam steps of size lr = 1e-4…4e-4:
# 2e-6 absolute — an Adam update is lr·m/(√v+ε), so where a gradient is
# near 0 its rounding noise can move a parameter by a fraction of lr;
# measured worst 1.5e-7
METRIC_RTOL, PARAM_ATOL = 1e-4, 2e-6


@pytest.mark.parametrize("extra", [
    [], ["loss.tv_weight=0.1", "loss.feature_match_weight=10.0",
         "model.spectral_norm=true", "train.grad_clip=1.0",
         "loss.adversarial=lsgan", "loss.spatial_discount=0.9"]],
    ids=["attention_r1_ema", "sn_tv_fm_clip"])
def test_two_train_steps_match_jax(tiny_config, extra):
    jcfg, jstate, cfg, state = _pair(tiny_config, ATTN + extra)
    jstep = j_make_step(jcfg, donate=False)
    step = make_train_step(cfg)
    for i in range(2):          # the second step covers the Adam moments
        jb, tb = _batches(*_numpy_batch(cfg, seed=i))
        jstate, jm = jstep(jstate, jb, jax.random.key(i))
        tm = step(state, tb)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=METRIC_RTOL, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        assert float(tm["d_r1"]) > 0
        assert state.step == int(jstate.step) == i + 1
        _assert_params_close(state.generator.state_dict(),
                             _np(jstate.g_params), PARAM_ATOL)
        _assert_params_close(
            state.discriminator.state_dict(),
            (_np(jstate.d_params), _np(jstate.d_stats)), PARAM_ATOL,
            convert=lambda t: discriminator_from_jax(*t))
        _assert_params_close(state.g_ema, _np(jstate.g_ema), PARAM_ATOL)
    assert ema_generator_params(state) is state.g_ema


def test_lazy_r1_applies_on_interval(tiny_config):
    _, _, cfg, state = _pair(tiny_config, ATTN + ["loss.r1_interval=2"])
    step = make_train_step(cfg)
    _, tb = _batches(*_numpy_batch(cfg))
    r1 = [float(step(state, tb)["d_r1"]) for _ in range(3)]
    assert r1[0] > 0 and r1[1] == 0 and r1[2] > 0


def test_grad_accum_matches_jax_and_full_batch(tiny_config):
    jcfg, jstate, cfg, state = _pair(tiny_config,
                                     ATTN + ["train.grad_accum=2"])
    jb, tb = _batches(*_numpy_batch(cfg))
    jstate, jm = j_make_step(jcfg, donate=False)(jstate, jb,
                                                 jax.random.key(0))
    tm = make_train_step(cfg)(state, tb)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
    _assert_params_close(state.generator.state_dict(), _np(jstate.g_params),
                         PARAM_ATOL)
    # without spectral norm, mean-reduced losses of equal micro-batches
    # average to the full batch: accumulation changes only the hole-weighted
    # L1's normalizer, per micro-batch instead of per batch
    _, _, cfg1, state1 = _pair(tiny_config, ATTN)
    tm1 = make_train_step(cfg1)(state1, tb)
    for k in ("d_loss", "d_real", "d_fake", "g_adv"):
        np.testing.assert_allclose(float(tm[k]), float(tm1[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


PARTIAL = ["model.conv_kind=partial", "loss.adversarial=hinge",
           "loss.gan_weight=0.0", "loss.l1_hole_weight=6.0",
           "loss.perceptual_weight=0.05", "loss.style_weight=120.0",
           "loss.tv_weight=0.1"]


def test_partialconv_train_step_matches_jax(tiny_config):
    """One step of a tiny ``partialconv256``-shaped config: partial convs,
    perceptual + style (seeded random VGG, carried across) + TV +
    hole-weighted L1, no adversarial term."""
    import warnings

    from gan_inpainting_tpu.losses.perceptual import init_vgg as j_init_vgg

    import gan_inpainting_torch.train.step as step_mod
    from gan_inpainting_torch.losses.perceptual import VGG16Features

    jcfg, jstate, cfg, state = _pair(tiny_config, PARTIAL)
    assert cfg.model.conv_kind == "partial" and cfg.loss.gan_weight == 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jstep = j_make_step(jcfg, donate=False)
        step = make_train_step(cfg)
    assert sum("randomly initialized VGG" in str(w.message)
               for w in caught) == 2        # both packages warn

    # the port draws its random VGG from its own generator: give it the
    # flax one's (seed 7) weights, in the trunk's bfloat16 as both run it
    _, vgg_params = j_init_vgg()

    def same_vgg(path, device=None):
        vgg = VGG16Features()
        vgg.load_state_dict(params_from_jax(_np(vgg_params)), strict=True)
        return vgg.to(device).requires_grad_(False)

    orig, step_mod.init_vgg = step_mod.init_vgg, same_vgg
    try:
        jb, tb = _batches(*_numpy_batch(cfg))
        jstate, jm = jstep(jstate, jb, jax.random.key(0))
        tm = step(state, tb)
    finally:
        step_mod.init_vgg = orig
    assert set(tm) == set(jm) and "g_tv" in tm
    assert float(tm["g_perceptual"]) > 0 and float(tm["g_style"]) > 0
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
    # parameters: the first Adam step moves each entry by lr·sign(g) =
    # ±1e-4. The VGG trunk runs in bfloat16 in both packages, each rounding
    # at its own places, so where a gradient is near 0 its sign can differ
    # and the entry lands 2·lr apart (measured: 20 of 91 427 entries). All
    # other entries agree to the file's limit.
    want = params_from_jax(_np(jstate.g_params))
    got = state.generator.state_dict()
    assert set(want) == set(got)
    gaps = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    assert gaps.max().item() <= 2.1e-4, gaps.max().item()
    assert (gaps <= PARAM_ATOL).float().mean().item() >= 0.999
    _assert_params_close(
        state.discriminator.state_dict(),
        (_np(jstate.d_params), _np(jstate.d_stats)), PARAM_ATOL,
        convert=lambda t: discriminator_from_jax(*t))


def test_overfit_one_batch_drives_l1_down(tiny_config):
    cfg = _port_cfg(j_overrides(tiny_config, [
        "loss.gan_weight=0.1", "train.g_lr=0.002"]))
    state = create_state(cfg, device="cpu")
    step = make_train_step(cfg)
    image, mask = _numpy_batch(cfg)
    batch = Batch(torch.from_numpy(image), torch.from_numpy(mask),
                  torch.from_numpy(image * (1 - mask)))
    first = float(step(state, batch)["g_l1"])
    for _ in range(79):
        metrics = step(state, batch)
    assert float(metrics["g_l1"]) < 0.5 * first


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
def test_lr_schedules_match_optax(tiny_config, kind):
    from gan_inpainting_tpu.train.state import make_lr_schedule as j_sched

    for warm in (0, 5):
        jcfg = j_overrides(tiny_config, [
            f"train.lr_schedule={kind}", f"train.warmup_steps={warm}",
            "train.steps=40", "train.lr_end_factor=0.1"])
        want = j_sched(jcfg, 3e-4)
        got = make_lr_schedule(_port_cfg(jcfg), 3e-4)
        for count in (0, 1, 4, 5, 6, 20, 39, 40, 100):
            w = float(want(count)) if callable(want) else want
            assert got(count) == pytest.approx(w, rel=1e-5, abs=1e-12)


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in grads]
        clip_by_global_norm(got, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def _tiny_train_cfg(tiny_config, workdir, steps):
    return _port_cfg(j_overrides(tiny_config, ATTN + [
        "loss.r1_interval=2", "data.synthetic_family=textured",
        "mask.kind=freeform", "data.random_crop=true",
        f"train.steps={steps}", "train.checkpoint_every=2",
        "train.eval_every=2", f"train.workdir={workdir}"]))


def test_checkpoint_resume_is_bit_for_bit(tiny_config, tmp_path):
    from gan_inpainting_torch.train.loop import train

    full, _ = train(_tiny_train_cfg(tiny_config, tmp_path / "a", 4),
                    device="cpu", verbose=False)
    train(_tiny_train_cfg(tiny_config, tmp_path / "b", 2), device="cpu",
          verbose=False)
    resumed, _ = train(_tiny_train_cfg(tiny_config, tmp_path / "b", 4),
                       device="cpu", verbose=False)
    assert resumed.step == full.step == 4
    a, b = full.state_dict(), resumed.state_dict()
    for part in ("g_params", "d_params", "g_ema"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for part in ("g_opt", "d_opt"):
        for idx, st in a[part]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, b[part]["state"][idx][k]), (part, k)
    assert (tmp_path / "b" / "checkpoints" / "step_4.json").exists()
    assert (tmp_path / "b" / "best.json").exists()


def test_checkpoint_manager_keeps_last_n(tiny_config, tmp_path):
    from gan_inpainting_torch.io.checkpoint import CheckpointManager

    cfg = _tiny_train_cfg(tiny_config, tmp_path, 1)
    state = create_state(cfg, device="cpu")
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore_raw()
    for step in (1, 2, 3):
        state.step = step
        mgr.save(step, state, cfg)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert config_from_dict(mgr.restore_config()) == cfg
    other = create_state(cfg, seed=5, device="cpu")
    mgr.restore(other, 2)
    assert other.step == 2
    for k, v in state.generator.state_dict().items():
        assert torch.equal(v, other.generator.state_dict()[k])


def test_inpainter_from_checkpoint_serves_the_ema(tiny_config, tmp_path):
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.io.checkpoint import CheckpointManager

    cfg = _tiny_train_cfg(tiny_config, tmp_path, 1)
    cfg = dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, size_buckets=(32,), batch_buckets=(1,)))
    state = create_state(cfg, device="cpu")
    for v in state.g_ema.values():          # make the EMA differ from raw
        v.mul_(0.5)
    CheckpointManager(tmp_path).save(7, state, cfg)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    mask = np.zeros((32, 32), np.float32)
    mask[8:24, 8:24] = 1
    got = Inpainter.from_checkpoint(cfg, device="cpu")(img, mask)
    ema = Inpainter(cfg, state.g_ema, device="cpu")(img, mask)
    raw = Inpainter(cfg, state.generator.state_dict(), device="cpu")(img, mask)
    assert np.array_equal(got, ema) and not np.array_equal(got, raw)
    assert np.array_equal(got[mask == 0], img[mask == 0])


def test_warm_start_grafts_parameters(tiny_config, tmp_path):
    from gan_inpainting_torch.io.checkpoint import CheckpointManager
    from gan_inpainting_torch.train.state import warm_start

    src_cfg = _tiny_train_cfg(tiny_config, tmp_path / "src", 1)
    src = create_state(src_cfg, seed=3, device="cpu")
    CheckpointManager(tmp_path / "src").save(1, src, src_cfg)
    cfg = dataclasses.replace(src_cfg, train=dataclasses.replace(
        src_cfg.train, init_from=str(tmp_path / "src")))
    state = warm_start(create_state(cfg, device="cpu"), cfg)
    assert state.step == 0
    for k, v in src.generator.state_dict().items():
        assert torch.equal(v, state.generator.state_dict()[k])
        assert torch.equal(v, state.g_ema[k])
    for k, v in src.discriminator.state_dict().items():
        assert torch.equal(v, state.discriminator.state_dict()[k])
    wide = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, base_features=16))
    with pytest.raises(ValueError, match="architecture"):
        warm_start(create_state(wide, device="cpu"), wide)


@pytest.mark.parametrize("mesh", ["model=2", "spatial=4", "data=2",
                                  "data=-1"])
def test_mesh_above_one_device_raises(tiny_config, tmp_path, mesh):
    """A ``train.mesh`` the run cannot hold raises in ``create_state`` and
    ``train`` instead of training on fewer cards without a word: in one
    process ``data = 2`` fails the world-size check and ``model = 2`` the
    mesh's divisibility (launch two ranks for either); the spatial axis
    serves but does not train yet. ``data = -1`` (every rank) trains. Serving an npz whose
    config carries a mesh is not affected."""
    from gan_inpainting_torch.train.loop import train

    cfg = _port_cfg(j_overrides(tiny_config, [f"train.mesh.{mesh}",
                                              f"train.workdir={tmp_path}",
                                              "train.steps=0"]))
    if mesh == "data=-1":
        assert create_state(cfg, device="cpu").step == 0
        return
    err, match = {
        "data=2": (ValueError, "needs more than the 1"),
        "model=2": (ValueError, "not divisible by model"),
        "spatial=4": (ValueError, r"not divisible by model\*spatial=4"),
    }[mesh]
    for fn in (lambda: create_state(cfg, device="cpu"),
               lambda: train(cfg, device="cpu", verbose=False)):
        with pytest.raises(err, match=match):
            fn()
    assert not any(tmp_path.iterdir())       # nothing was written
