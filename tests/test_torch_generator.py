"""The port's generators against the flax generators on the same params.

Params are drawn with numpy (seeded) in the flax tree's shapes, go through
``params_from_jax`` and load strictly into the port's module. Float32 on both sides; outputs
are tanh images, tolerance 1e-4 (deep conv stacks summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.configs.base import apply_overrides as j_overrides
from gan_inpainting_tpu.configs.base import get_config as j_get_config
from gan_inpainting_tpu.models.generator import (
    build_generator as j_build_generator,
)

from gan_inpainting_torch.configs.base import apply_overrides, get_config
from gan_inpainting_torch.io.convert import params_from_jax
from gan_inpainting_torch.io.export import load_generator
from gan_inpainting_torch.models.generator import build_generator

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(name, overrides):
    jcfg = j_overrides(j_get_config(name), overrides)
    tcfg = apply_overrides(get_config(name), overrides)
    return jcfg, tcfg


def _inputs(b, size, seed=0):
    rng = np.random.default_rng(seed)
    image = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    mask = np.zeros((b, size, size, 1), np.float32)
    mask[:, size // 4:size // 2, size // 8:3 * size // 4] = 1.0
    mask[-1, -5:, :] = 1.0
    return image * (1.0 - mask), mask


def _run_both(name, overrides, size=32, b=2, port_only=()):
    jcfg, tcfg = _pair(name, overrides + ["model.base_features=8",
                                          "model.dtype_policy=f32"])
    tcfg = apply_overrides(tcfg, list(port_only))
    masked, mask = _inputs(b, size)
    jgen = j_build_generator(jcfg.model)
    # the param tree's shapes from an abstract trace, values from numpy (an
    # eager flax init compiles every op and takes most of this file's time)
    shapes = jax.eval_shape(jgen.init, jax.random.key(0),
                            jnp.asarray(masked), jnp.asarray(mask))["params"]
    rng = np.random.default_rng(1)

    def draw(s):
        fan_in = np.prod(s.shape[:-1]) if len(s.shape) == 4 else 100.0
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    params_np = jax.tree_util.tree_map(draw, shapes)
    want = jgen.apply({"params": params_np}, jnp.asarray(masked),
                      jnp.asarray(mask))
    gen = build_generator(tcfg.model, device="cpu")
    gen.load_state_dict(params_from_jax(params_np), strict=True)
    with torch.no_grad():
        got = gen(torch.from_numpy(masked), torch.from_numpy(mask))
    return want, got, params_np, gen


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("attention", [True, False])
def test_coarse_to_fine_matches_flax(fuse, attention):
    want, got, _, _ = _run_both("celebahq256_freeform", [
        f"model.fuse_upsample={fuse}", f"model.use_attention={attention}"])
    assert got.fine.dtype == torch.float32
    np.testing.assert_allclose(got.coarse.numpy(), np.asarray(want.coarse),
                               **TOL)
    np.testing.assert_allclose(got.fine.numpy(), np.asarray(want.fine), **TOL)


@pytest.mark.parametrize("conv_kind", ["plain", "gated"])
@pytest.mark.parametrize("fuse", [False, True])
def test_dilated_matches_flax(conv_kind, fuse):
    want, got, _, _ = _run_both("celeba128_center", [
        f"model.conv_kind={conv_kind}", f"model.fuse_upsample={fuse}"])
    assert got.coarse is None and want.coarse is None
    np.testing.assert_allclose(got.fine.numpy(), np.asarray(want.fine), **TOL)


def test_bf16_head_keeps_compute_dtype():
    _, tcfg = _pair("celeba128_center", ["model.base_features=8",
                                         "model.bf16_head=true"])
    gen = build_generator(tcfg.model, device="cpu")
    masked, mask = _inputs(1, 16)
    with torch.no_grad():
        out = gen(torch.from_numpy(masked), torch.from_numpy(mask))
    assert out.fine.dtype == torch.bfloat16


def test_params_round_trip():
    """flax tree → state_dict → flax tree is the identity: every leaf maps
    to one key, OIHW transposes back to HWIO, nothing is left over."""
    _, _, params_np, gen = _run_both("celebahq256_freeform", [])
    state = params_from_jax(params_np)
    assert set(state) == set(gen.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(params_np)
    assert len(leaves) == len(state)
    for path, leaf in leaves:
        *mods, name = [k.key for k in path]
        key = ".".join(mods + ["weight" if name == "kernel" else "bias"])
        back = state[key].numpy()
        if name == "kernel":
            back = back.transpose(2, 3, 1, 0)              # OIHW -> HWIO
        np.testing.assert_array_equal(back, leaf)
    # HWIO -> OIHW keeps the gated conv's feature/gate channel order
    k = params_np["coarse"]["conv0"]["kernel"]
    np.testing.assert_array_equal(state["coarse.conv0.weight"][5].numpy(),
                                  k[..., 5].transpose(2, 0, 1))


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("fuse", [False, True])
def test_partial_dilated_matches_flax(backend, fuse):
    """``partialconv256``'s generator family: every layer but the head is a
    partial conv, decoder blocks upsample explicitly and repeat ``valid``
    (``fuse_upsample`` does not apply to them); every ``kernel_backend``
    value gives the same output on the CPU."""
    want, got, _, gen = _run_both(
        "partialconv256", [f"model.fuse_upsample={fuse}"],
        port_only=[f"model.kernel_backend={backend}"])
    kinds = [m.conv_kind for m in gen.body.children()]
    assert kinds == ["partial"] * 16 + ["plain"]
    assert all(m.backend == backend for m in gen.body.children())
    assert not any(m.pre_upsample for m in gen.body.children())
    assert got.coarse is None and want.coarse is None
    np.testing.assert_allclose(got.fine.numpy(), np.asarray(want.fine), **TOL)


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_coarse_to_fine_partial_matches_flax(backend):
    want, got, _, _ = _run_both(
        "celebahq256_freeform", ["model.conv_kind=partial",
                                 "model.use_attention=true"],
        port_only=[f"model.kernel_backend={backend}"])
    np.testing.assert_allclose(got.coarse.numpy(), np.asarray(want.coarse),
                               **TOL)
    np.testing.assert_allclose(got.fine.numpy(), np.asarray(want.fine), **TOL)


@pytest.mark.parametrize("name,extra", [
    ("celebahq256_freeform", ["model.use_attention=true"]),
    ("celebahq256_freeform", ["model.fuse_upsample=true"]),
    ("celeba128_center", []),
    ("partialconv256", []),        # partial stems stay full-resolution convs
])
def test_s2d_stem_matches_flax(name, extra):
    want, got, _, gen = _run_both(name, extra + ["model.s2d_stem=true"])
    stems = [m for m in gen.modules() if getattr(m, "s2d", False)]
    assert len(stems) == {"celebahq256_freeform": 2 + ("model.use_attention"
                          "=true" in extra), "celeba128_center": 1,
                          "partialconv256": 0}[name]
    # against the flax s2d path, and (same params, same math) the plain stem
    np.testing.assert_allclose(got.fine.numpy(), np.asarray(want.fine), **TOL)
    _, plain, _, _ = _run_both(name, extra)
    np.testing.assert_allclose(got.fine.numpy(), plain.fine.numpy(), **TOL)


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_kernel_backend_values_agree_on_the_cpu(backend):
    """A gated attention generator under each ``kernel_backend`` value, and
    through ``build_generator(backend=...)``, against flax."""
    want, got, params_np, _ = _run_both(
        "celebahq256_freeform", ["model.use_attention=true"],
        port_only=[f"model.kernel_backend={backend}"])
    np.testing.assert_allclose(got.fine.numpy(), np.asarray(want.fine), **TOL)
    _, tcfg = _pair("celebahq256_freeform", [
        "model.use_attention=true", "model.base_features=8",
        "model.dtype_policy=f32"])
    gen = build_generator(tcfg.model, device="cpu", backend=backend)
    assert gen.backend == backend and gen.coarse.conv0.backend == backend
    gen.load_state_dict(params_from_jax(params_np), strict=True)
    masked, mask = _inputs(2, 32)
    with torch.no_grad():
        again = gen(torch.from_numpy(masked), torch.from_numpy(mask))
    assert torch.equal(again.fine, got.fine)


def test_unknown_conv_kind_and_misplaced_rewrites_raise():
    from gan_inpainting_torch.models.layers import InpaintConv

    with pytest.raises(ValueError, match="conv_kind"):
        InpaintConv(4, 8, conv_kind="sparse")
    with pytest.raises(ValueError, match="s2d"):
        InpaintConv(4, 8, kernel_size=5, conv_kind="partial", s2d=True)
    with pytest.raises(ValueError, match="pre_upsample"):
        InpaintConv(4, 8, conv_kind="partial", pre_upsample=True)


@pytest.mark.parametrize("name", ["tex256_attn", "qual256_stab", "qual512"])
def test_pinned_artifacts_load_strictly(name):
    """Every pinned export loads into the generator its embedded config
    describes, widened from float16 to float32, key for key."""
    from gan_inpainting_tpu.io.export import load_generator as j_load

    path = f"docs/artifacts/{name}/generator_best.npz"
    cfg, params = load_generator(path)
    jcfg, jparams = j_load(path)
    assert cfg.model.base_features == jcfg.model.base_features == 48
    assert cfg.model.use_attention == jcfg.model.use_attention
    gen = build_generator(cfg.model, device="cpu", seed=None)
    state = params_from_jax(params)
    gen.load_state_dict(state, strict=True)
    assert all(t.dtype == torch.float32 for t in state.values())
    for path_, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        key = ".".join(k.key for k in path_[:-1])
        if path_[-1].key == "bias":
            np.testing.assert_array_equal(state[key + ".bias"].numpy(), leaf)
