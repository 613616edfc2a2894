"""Masks, synthetic images and the train batch of the port. Rasterization
and rendering are held against the JAX package on the same parameters
(float32, CPU); the port's own draws are tested by their distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.configs.base import MaskConfig as JMaskConfig
from gan_inpainting_tpu.data import masks as j_masks
from gan_inpainting_tpu.data import synthetic as j_syn

from gan_inpainting_torch.configs.base import DataConfig, MaskConfig
from gan_inpainting_torch.data import masks, synthetic
from gan_inpainting_torch.data.loader import make_dataset, source_size
from gan_inpainting_torch.data.pipeline import make_train_batch
from gan_inpainting_torch.utils.rng import stream_generator


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_center_mask_matches_jax():
    for frac in (0.5, 0.3):
        want = np.asarray(j_masks.center_mask(jax.random.key(0), 32, 48, frac))
        got = masks.center_mask(32, 48, frac)
        assert got.shape == (1, 32, 48, 1)
        assert np.array_equal(got[0].numpy(), want)
    # jittered corners: the raster of JAX's own corner draw
    key = jax.random.key(3)
    want = np.asarray(j_masks.center_mask(key, 32, 32, 0.5, jitter=True))
    ys, xs = np.nonzero(want[..., 0])
    got = masks.rect_mask([ys.min()], [xs.min()], 16, 16, 32, 32)
    assert np.array_equal(got[0].numpy(), want)
    jit = masks.center_mask(32, 32, 0.5, True, batch=64, generator=_gen())
    assert torch.all(jit.sum((1, 2, 3)) == 256)
    assert len({int(m[..., 0].nonzero()[0, 0]) for m in jit}) > 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stroke_rasterization_matches_jax(seed):
    jcfg = JMaskConfig(kind="freeform")
    key = jax.random.key(seed)
    a, b, w, valid = (np.array(t) for t in
                      j_masks._sample_strokes(key, jcfg, 64, 64))
    want = np.asarray(j_masks.freeform_mask(key, 64, 64, jcfg))
    got = masks.rasterize_strokes(a[None], b[None], w[None], valid[None],
                                  64, 64)
    # a pixel exactly on a capsule's rim may round either way
    assert (got[0].numpy() != want).mean() < 1e-3
    assert 0 < want.mean() < 1


def test_stroke_walk_geometry():
    cfg = MaskConfig(kind="freeform", max_strokes=3, max_segments=4)
    params = masks.sample_strokes(_gen(1), cfg, 40, 50, batch=5)
    a, b, w, valid = masks.stroke_segments(params, 40, 50)
    assert a.shape == b.shape == (5, 12, 2) and w.shape == valid.shape == (5, 12)
    # segments of one stroke chain: each starts where the last one ended
    chain = a.reshape(5, 3, 4, 2)[:, :, 1:], b.reshape(5, 3, 4, 2)[:, :, :-1]
    assert torch.equal(*chain)
    assert a.min() >= 0 and a[..., 0].max() <= 39 and a[..., 1].max() <= 49
    per_stroke = valid.reshape(5, 3, 4).sum(-1)
    drawn = (per_stroke > 0).sum(-1)
    assert torch.equal(drawn, params["n_strokes"])
    for i in range(5):
        n = int(params["n_strokes"][i])
        assert torch.equal(per_stroke[i, :n], params["n_segs"][i, :n])
    # unclipped segments have the drawn lengths
    seg = (b - a).norm(dim=-1).reshape(5, 3, 4)
    inside = ((a > 0) & (b > 0)).all(-1).reshape(5, 3, 4) \
        & (b[..., 0] < 39).reshape(5, 3, 4) & (b[..., 1] < 49).reshape(5, 3, 4) \
        & (a[..., 0] < 39).reshape(5, 3, 4) & (a[..., 1] < 49).reshape(5, 3, 4)
    torch.testing.assert_close(seg[inside], params["lengths"][inside],
                               rtol=1e-4, atol=1e-4)


def test_mask_draw_distributions():
    cfg = MaskConfig(kind="freeform")
    params = masks.sample_strokes(_gen(2), cfg, 128, 128, batch=2000)
    n = params["n_strokes"].float()
    assert n.min() == 1 and n.max() == cfg.max_strokes
    assert abs(n.mean().item() - (1 + cfg.max_strokes) / 2) < 0.2
    assert params["n_segs"].min() == 1
    assert params["n_segs"].max() == cfg.max_segments
    w = params["widths"]
    assert cfg.min_width <= w.min() and w.max() < cfg.max_width
    assert abs(w.mean().item() - (cfg.min_width + cfg.max_width) / 2) < 0.3
    # hole fraction of the port's masks against the JAX package's, same config
    got = masks.random_mask_batch(_gen(3), 96, 128, 128, cfg).mean().item()
    jcfg = JMaskConfig(kind="freeform")
    want = float(j_masks.random_mask_batch(jax.random.key(0), 96, 128, 128,
                                           jcfg).mean())
    assert abs(got - want) < 0.05, (got, want)


def test_random_mask_kinds_and_curriculum():
    for kind in ("center", "freeform", "mixed"):
        cfg = MaskConfig(kind=kind, center_jitter=True)
        m = masks.random_mask_batch(_gen(4), 16, 32, 32, cfg)
        assert m.shape == (16, 32, 32, 1) and m.dtype == torch.float32
        assert set(m.unique().tolist()) <= {0.0, 1.0}
        easy = masks.random_mask_batch(_gen(4), 16, 32, 32, cfg, progress=0.0)
        assert easy.mean() < m.mean()
    mixed = masks.random_mask_batch(
        _gen(5), 200, 32, 32, MaskConfig(kind="mixed", freeform_prob=0.5))
    is_center = (mixed.sum((1, 2, 3)) == 256) & (mixed[:, 8:24, 8:24].mean(
        (1, 2, 3)) == 1)
    assert 60 < is_center.sum() < 140
    # shrunk centre hole: the JAX package's traced-progress rectangle
    cfg = MaskConfig(kind="center")
    got = masks.random_mask_batch(_gen(), 1, 32, 32, cfg, progress=0.5)
    want = j_masks.random_mask(jax.random.key(0), 32, 32,
                               JMaskConfig(kind="center"),
                               progress=jnp.float32(0.5))
    assert np.array_equal(got[0].numpy(), np.asarray(want))
    assert masks.difficulty(cfg, 0.5) == pytest.approx(0.7)
    with pytest.raises(ValueError):
        masks.random_mask_batch(_gen(), 1, 8, 8, MaskConfig(kind="nope"))


def test_cubic_value_noise_matches_jax_resize():
    rng = np.random.default_rng(0)
    for grid, size in ((4, 32), (8, 64), (16, 16), (4, 30)):
        lat = rng.uniform(-1, 1, (grid, grid, 2)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(lat), (size, size, 2),
                                           method="cubic"))
        got = synthetic.value_noise(torch.from_numpy(lat)[None], size)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_stripe_field_matches_jax():
    ys, xs = synthetic._unit_grid(48, "cpu")
    jy = jax.lax.broadcasted_iota(jnp.float32, (48, 48), 0) / 48
    jx = jax.lax.broadcasted_iota(jnp.float32, (48, 48), 1) / 48
    want = j_syn._stripe_field(jy, jx, 48, 0.7, 9.0, 1.3)
    got = synthetic.stripe_field(ys, xs, 48, torch.tensor(0.7),
                                 torch.tensor(9.0), torch.tensor(1.3))
    # tanh(4·sin(…)) of a float32 phase of up to ~30 rad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("family", ["blobs", "textured"])
def test_synthetic_families(family):
    x = synthetic.synthetic_batch(_gen(6), 4, 64, family)
    assert x.shape == (4, 64, 64, 3) and x.dtype == torch.float32
    assert x.min() >= -1 and x.max() <= 1
    assert torch.equal(x, synthetic.synthetic_batch(_gen(6), 4, 64, family))
    assert not torch.equal(x[0], x[1])
    u8 = synthetic.synthetic_batch_u8(_gen(6), 4, 64, family)
    assert u8.dtype == torch.uint8
    assert (u8.float() - (x + 1) * 127.5).abs().max() <= 0.5
    # same statistics as the JAX family: mean and per-pixel spread
    big = synthetic.synthetic_batch(_gen(7), 64, 64, family)
    ref = np.asarray(j_syn.synthetic_batch(jax.random.key(0), 64, 64, family))
    assert abs(big.mean().item() - ref.mean()) < 0.1
    assert abs(big.std().item() - ref.std()) < 0.1
    if family == "textured":    # high-frequency: neighbours differ a lot
        def hf(a):
            return np.abs(np.diff(a, axis=2)).mean()
        assert abs(hf(big.numpy()) - hf(ref)) < 0.05
    with pytest.raises(ValueError, match="unknown synthetic family"):
        synthetic.synthetic_batch(_gen(), 1, 8, "nope")


def test_blobs_render_matches_a_direct_evaluation():
    """One pixel of the blobs family evaluated by hand from the drawn
    parameters (the JAX package's formula)."""
    p = synthetic.synthetic_params(_gen(8), 1)
    img = synthetic.synthetic_image(p, 32)[0]
    y, x = 11, 23
    ys, xs = y / 32, x / 32
    g = p["grad"][0]
    val = g[:, 0] * ys + g[:, 1] * xs + g[:, 2] * 0.3
    for i in range(5):
        cy, cx = p["blob_center"][0, i]
        sy, sx = p["blob_sigma"][0, i]
        alpha = torch.exp(-(((ys - cy) / sy) ** 2 + ((xs - cx) / sx) ** 2))
        val = val * (1 - alpha) + p["blob_color"][0, i] * alpha
    y0, x0 = p["rect_pos"][0]
    hh, ww = p["rect_size"][0]
    if y0 <= ys < y0 + hh and x0 <= xs < x0 + ww:
        val = p["rect_color"][0]
    torch.testing.assert_close(img[y, x], val.clamp(-1, 1), rtol=1e-5,
                               atol=1e-5)


def test_make_train_batch_and_dataset():
    cfg = DataConfig(image_size=32, batch_size=4, synthetic_size=8,
                     random_crop=True, synthetic_family="textured")
    assert source_size(cfg) == 36 and source_size(cfg, "eval") == 32
    it = make_dataset(cfg, seed=0)
    first, second, third = next(it), next(it), next(it)
    assert first.shape == (4, 36, 36, 3) and first.dtype == torch.uint8
    assert torch.equal(first, third) and not torch.equal(first, second)
    assert torch.equal(next(make_dataset(cfg, seed=0, start=1)), second)
    assert not torch.equal(next(make_dataset(cfg, seed=0, split="eval"))[
        :, :32, :32], first[:, :32, :32])
    mcfg = MaskConfig(kind="freeform")
    batch = make_train_batch(first, stream_generator(0, 1, 0), mcfg,
                             flip=True, crop=32)
    assert batch.image.shape == (4, 32, 32, 3)
    assert batch.mask.shape == (4, 32, 32, 1)
    assert torch.equal(batch.masked, batch.image * (1 - batch.mask))
    assert batch.image.min() >= -1 and batch.image.max() <= 1
    again = make_train_batch(first, stream_generator(0, 1, 0), mcfg,
                             flip=True, crop=32)
    assert all(torch.equal(a, b) for a, b in zip(batch, again))
    other = make_train_batch(first, stream_generator(0, 1, 1), mcfg,
                             flip=True, crop=32)
    assert not torch.equal(other.mask, batch.mask)
    # each crop is a window of its source, possibly mirrored
    src = first[0].float() / 127.5 - 1.0
    windows = src.unfold(0, 32, 1).unfold(1, 32, 1).permute(0, 1, 3, 4, 2)
    img = batch.image[0]
    assert any(torch.equal(wd, cand) for cand in (img, img.flip(1))
               for row in windows for wd in row)
    with pytest.raises(ValueError, match="exceeds"):
        make_train_batch(first, _gen(), mcfg, crop=64)
    with pytest.raises(FileNotFoundError, match="no images"):
        next(make_dataset(DataConfig(dataset="folder",
                                     root="/nonexistent_dir_xyz"), seed=0))
    with pytest.raises(ValueError, match="unknown dataset"):
        make_dataset(DataConfig(dataset="lmdb"), seed=0)
