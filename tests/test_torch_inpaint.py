"""The port's serving API: end to end against JAX on the pinned weights,
and the API contract of tests/integration/test_inpaint_api.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.configs.base import apply_overrides as j_overrides
from gan_inpainting_tpu.data.pipeline import denormalize as j_denormalize
from gan_inpainting_tpu.infer.inpaint import make_forward_fn as j_forward_fn
from gan_inpainting_tpu.io.export import load_generator as j_load_generator

from gan_inpainting_torch.configs.base import apply_overrides, get_config
from gan_inpainting_torch.data.pipeline import denormalize, normalize
from gan_inpainting_torch.infer.inpaint import Inpainter, inpaint
from gan_inpainting_torch.models.generator import build_generator

NPZ = "docs/artifacts/tex256_attn/generator_best.npz"
SERVE = ["model.fuse_upsample=true", "model.dtype_policy=f32"]


def _image(seed, h, w=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w or h, 3), dtype=np.uint8)


def _stroke_mask(seed, size):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((size, size), np.float32)
    for _ in range(4):
        cy, cx = rng.integers(0, size, 2)
        r = rng.integers(size // 16, size // 6)
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1.0
    mask[size // 3:size // 3 + 3, :] = 1.0          # a thin stroke
    return mask


def test_pinned_npz_full_width_matches_jax():
    """tex256_attn at full width (48), f32 on both sides, 128² batch 1 (the
    generator is fully convolutional): uint8 within ±1, known pixels
    bit-exact."""
    img = _image(0, 128)[None]
    mask = _stroke_mask(1, 128)[None, ..., None]

    jcfg, jparams = j_load_generator(NPZ)
    jcfg = j_overrides(jcfg, SERVE)
    want = np.asarray(jax.jit(j_forward_fn(jcfg))(
        jparams, jnp.asarray(img), jnp.asarray(mask)))

    inp = Inpainter.from_npz(NPZ, overrides=SERVE + [
        "infer.size_buckets=128", "infer.batch_buckets=1"], device="cpu")
    assert inp.cfg.model.base_features == 48 and inp.cfg.model.use_attention
    got = inp.inpaint_batch(img, mask)

    assert got.shape == want.shape and got.dtype == np.uint8
    known = np.broadcast_to(mask == 0, img.shape)
    np.testing.assert_array_equal(got[known], img[known])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_partialconv256_served_matches_jax(backend):
    """``partialconv256`` (dilated generator, partial convs) at width 8,
    float32, 64² batch 2, through both packages' serve forwards on the same
    numpy-drawn params: uint8 within ±1, known pixels bit-exact."""
    from gan_inpainting_tpu.configs.base import get_config as j_get_config
    from gan_inpainting_tpu.models.generator import (
        build_generator as j_build_generator,
    )

    from gan_inpainting_torch.io.convert import params_from_jax

    small = ["model.base_features=8", "model.dtype_policy=f32"]
    jcfg = j_overrides(j_get_config("partialconv256"), small)
    cfg = apply_overrides(get_config("partialconv256"), small + [
        f"model.kernel_backend={backend}", "infer.size_buckets=64",
        "infer.batch_buckets=2"])
    img = np.stack([_image(0, 64), _image(1, 64)])
    mask = np.stack([_stroke_mask(2, 64), _stroke_mask(3, 64)])[..., None]
    shapes = jax.eval_shape(
        j_build_generator(jcfg.model).init, jax.random.key(0),
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1)))["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(
                       np.float32), shapes)
    want = np.asarray(jax.jit(j_forward_fn(jcfg))(
        params, jnp.asarray(img), jnp.asarray(mask)))
    inp = Inpainter(cfg, params_from_jax(params), device="cpu")
    got = inp.inpaint_batch(img, mask)
    assert got.shape == want.shape and got.dtype == np.uint8
    known = np.broadcast_to(mask == 0, img.shape)
    np.testing.assert_array_equal(got[known], img[known])
    assert (got[~known] != img[~known]).any()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()


def test_normalize_denormalize():
    u8 = torch.arange(256, dtype=torch.uint8)
    np.testing.assert_array_equal(denormalize(normalize(u8)).numpy(),
                                  u8.numpy())
    # same float32 arithmetic as the JAX pipeline over a dense sweep
    x = np.linspace(-1.01, 1.01, 200_001, dtype=np.float32)
    want = np.asarray(j_denormalize(jnp.asarray(x)))
    np.testing.assert_array_equal(denormalize(torch.from_numpy(x)).numpy(),
                                  want)
    # torch.round, like jnp.round, rounds half to even
    np.testing.assert_array_equal(
        torch.round(torch.tensor([0.5, 1.5, 2.5, 253.5])).numpy(),
        [0, 2, 2, 254])


@pytest.fixture()
def tiny_inpainter():
    cfg = apply_overrides(get_config("celebahq256_freeform"), [
        "model.base_features=8", "model.use_attention=true",
        "model.dtype_policy=f32", "infer.batch_buckets=1,4",
        "infer.size_buckets=32,64"])
    gen = build_generator(cfg.model, device="cpu", seed=3)
    return Inpainter(cfg, gen.state_dict(), device="cpu")


def test_known_pixels_preserved_and_holes_generated(tiny_inpainter):
    img = _image(2, 32)
    mask = np.zeros((32, 32), np.float32)
    mask[4:28, 4:28] = 1.0
    out = tiny_inpainter(img, mask)
    assert out.shape == img.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out[mask == 0], img[mask == 0])
    assert (out[mask == 1] != img[mask == 1]).any()


def test_batched_api_and_mask_channel(tiny_inpainter):
    imgs = np.stack([_image(i, 32) for i in range(3)])
    masks = np.zeros((3, 32, 32, 1), np.float32)
    masks[:, 8:24, 8:24] = 1.0
    out = tiny_inpainter.inpaint_batch(imgs, masks)
    assert out.shape == imgs.shape
    keep = np.broadcast_to(masks == 0, imgs.shape)
    np.testing.assert_array_equal(out[keep], imgs[keep])
    # batch padding does not leak across samples
    np.testing.assert_array_equal(out[1], tiny_inpainter(imgs[1],
                                                         masks[1, ..., 0]))


@pytest.mark.parametrize("h,w", [(48, 48), (24, 40), (40, 24)])
def test_size_bucket_pad_and_crop(tiny_inpainter, h, w):
    img = _image(4, h, w)
    mask = np.zeros((h, w), np.float32)
    mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = 1.0
    out = tiny_inpainter(img, mask)
    assert out.shape == img.shape
    np.testing.assert_array_equal(out[mask == 0], img[mask == 0])


def test_oversize_and_mismatch_raise(tiny_inpainter):
    with pytest.raises(ValueError, match="bucket"):
        tiny_inpainter(_image(5, 128), np.zeros((128, 128), np.float32))
    with pytest.raises(ValueError, match="mask shape"):
        tiny_inpainter.inpaint_batch(_image(5, 32)[None],
                                     np.zeros((1, 16, 16), np.float32))


def test_fuse_upsample_off_above_size_threshold(tiny_inpainter):
    cfg = apply_overrides(tiny_inpainter.cfg, [
        "model.fuse_upsample=true", "infer.fuse_upsample_max_size=32"])
    inp = Inpainter(cfg, tiny_inpainter.state_dict, device="cpu")
    assert inp._cfg_for_size(32).model.fuse_upsample is True
    assert inp._cfg_for_size(64).model.fuse_upsample is False
    img = _image(6, 64)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    np.testing.assert_array_equal(inp(img, mask), tiny_inpainter(img, mask))
    # the fused decoder at 32² agrees with the unfused one within rounding
    small = _image(7, 32)
    diff = np.abs(inp(small, mask[:32, :32]).astype(int)
                  - tiny_inpainter(small, mask[:32, :32]).astype(int))
    assert diff.max() <= 1


def test_warmup_runs_every_bucket(tiny_inpainter):
    tiny_inpainter.warmup()
    assert tiny_inpainter._forward.cache_info().currsize == 1


def test_inpaint_needs_a_model(tmp_path):
    # with neither an Inpainter nor an npz it serves the latest checkpoint
    # of the run's workdir, and says so when there is none
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        inpaint(_image(8, 32), np.zeros((32, 32), np.float32),
                workdir=str(tmp_path), device="cpu")
