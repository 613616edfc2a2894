"""The port's folder backend (data/loader.py, data/native_loader.py) against
the JAX package's on the same files: decode, the native JPEG loader, the
PIL fall-backs, the split, the batch stream for one seed, the decode-once
cache, the ``start=`` skip and the decoder threads' lifetime. Corpora are
written at test time."""

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gan_inpainting_tpu.configs.base import DataConfig as JDataConfig
from gan_inpainting_tpu.data import loader as jloader
from gan_inpainting_tpu.data import native_loader as jnative

from gan_inpainting_torch.configs.base import DataConfig
from gan_inpainting_torch.data import loader, native_loader
from gan_inpainting_torch.data.loader import make_dataset

N_FILES = 40                # 38 train, 2 eval (every 20th)


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    for i in range(N_FILES):
        h, w = (40, 52) if i % 3 else (56, 44)      # both crop directions
        arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        arr[0, 0] = (i, i, i)
        Image.fromarray(arr).save(root / f"im_{i:03d}.jpg", quality=92)
    return root


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(1)
    for i in range(6):
        arr = rng.integers(0, 255, (36, 50, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"im_{i:03d}.png")
    return root


def _cfgs(root, **kw):
    return (DataConfig(dataset="folder", root=str(root), image_size=32,
                       batch_size=4, **kw),
            JDataConfig(dataset="folder", root=str(root), image_size=32,
                        batch_size=4, **kw))


@pytest.mark.parametrize("suffix", [".jpg", ".png"])
def test_load_image_matches_jax(jpeg_dir, png_dir, suffix):
    root = jpeg_dir if suffix == ".jpg" else png_dir
    for path in sorted(root.glob(f"*{suffix}"))[:4]:
        for size in (32, 24):
            np.testing.assert_array_equal(loader._load_image(path, size),
                                          jloader._load_image(path, size))


def test_native_decode_matches_jax(jpeg_dir):
    if not native_loader.available():
        pytest.skip("g++ or libjpeg missing: the PIL path decodes")
    assert native_loader._LIB.parent.name == "_build"
    assert native_loader._LIB.parent.parent.name == "gan_inpainting_torch"
    paths = [str(p) for p in sorted(jpeg_dir.glob("*.jpg"))[:6]]
    got, ok = native_loader.load_batch(paths, 32)
    want, jok = jnative.load_batch(paths, 32)
    assert ok.all() and jok.all()
    np.testing.assert_array_equal(got, want)
    # the bound tests/unit/test_native_loader.py::test_native_close_to_pil
    # holds the two resamplers (area and bilinear) to
    pil = np.stack([loader._load_image(p, 32) for p in sorted(
        jpeg_dir.glob("*.jpg"))[:6]])
    assert np.abs(got.astype(int) - pil.astype(int)).mean() < 12.0


def test_corrupt_jpeg_goes_to_pil(jpeg_dir, tmp_path):
    good = sorted(jpeg_dir.glob("*.jpg"))[0]
    bad = tmp_path / "not_really.jpg"      # a PNG under a JPEG name
    Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (40, 40, 3), dtype=np.uint8)).save(bad, format="PNG")
    batch = loader._load_batch([good, bad], 32)
    np.testing.assert_array_equal(batch[1], loader._load_image(bad, 32))
    np.testing.assert_array_equal(batch, jloader._load_batch([good, bad], 32))
    if native_loader.available():
        _, ok = native_loader.load_batch([str(good), str(bad)], 32)
        assert ok[0] and not ok[1]


def test_png_batch_goes_to_pil(png_dir, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the native loader read a PNG batch")

    monkeypatch.setattr(native_loader, "load_batch", refuse)
    files = sorted(png_dir.glob("*.png"))[:3]
    np.testing.assert_array_equal(
        loader._load_batch(files, 32),
        np.stack([loader._load_image(p, 32) for p in files]))


def test_split_matches_jax(jpeg_dir):
    cfg, jcfg = _cfgs(jpeg_dir, loader_threads=1)
    ev = loader.split_files(cfg, "eval")
    tr = loader.split_files(cfg, "train")
    assert [p.name for p in ev] == ["im_000.jpg", "im_020.jpg"]
    assert len(tr) == N_FILES - 2 and not set(ev) & set(tr)
    got = next(make_dataset(cfg, seed=3, split="eval", batch_size=2))
    want = next(jloader.make_dataset(jcfg, seed=3, split="eval",
                                     batch_size=2))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["threads1", "cache"])
def test_batches_match_jax(jpeg_dir, tmp_path, mode):
    kw = (dict(loader_threads=1, loader_cache="off") if mode == "threads1"
          else dict(loader_threads=3, loader_cache="on",
                    loader_cache_dir=str(tmp_path / "cache")))
    cfg, jcfg = _cfgs(jpeg_dir, **kw)
    it = make_dataset(cfg, seed=5)
    jit = jloader.make_dataset(jcfg, seed=5)
    for _ in range(12):               # 9 batches per epoch: two epochs
        got, want = next(it), next(jit)
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    it.close()


def test_cache_reused_and_rebuilt_on_change(jpeg_dir, tmp_path):
    import shutil

    root = tmp_path / "imgs"
    shutil.copytree(jpeg_dir, root)
    cfg, _ = _cfgs(root, loader_cache="on",
                   loader_cache_dir=str(tmp_path / "cache"))
    first = next(make_dataset(cfg, seed=0))
    cache_dir = tmp_path / "cache"
    built = sorted(p.name for p in cache_dir.glob("*.u8"))
    assert len(built) == 1 and len(list(cache_dir.glob("*.json"))) == 1
    assert torch.equal(next(make_dataset(cfg, seed=0)), first)
    assert sorted(p.name for p in cache_dir.glob("*.u8")) == built
    time.sleep(0.01)
    Image.fromarray(np.zeros((40, 52, 3), np.uint8)).save(
        root / "im_001.jpg", quality=92)          # a train file, new mtime
    next(make_dataset(cfg, seed=0))
    assert len(list(cache_dir.glob("*.u8"))) == 2


@pytest.mark.parametrize("cache", ["off", "on"])
def test_start_skips_batches(jpeg_dir, tmp_path, cache):
    cfg, _ = _cfgs(jpeg_dir, loader_threads=1, loader_cache=cache,
                   loader_cache_dir=str(tmp_path / "cache"))
    it = make_dataset(cfg, seed=7)
    stream = [next(it) for _ in range(13)]
    it.close()
    for start in (1, 6, 9, 12):       # within, at and past an epoch's end
        resumed = make_dataset(cfg, seed=7, start=start)
        assert torch.equal(next(resumed), stream[start]), start
        resumed.close()


def test_missing_dir_raises():
    cfg = DataConfig(dataset="folder", root="/nonexistent_xyz",
                     image_size=32)
    with pytest.raises(FileNotFoundError):
        next(make_dataset(cfg, seed=0))


def test_split_smaller_than_a_batch_raises(jpeg_dir):
    # two eval files: the JAX iterator spins forever on such a split
    cfg, _ = _cfgs(jpeg_dir)
    with pytest.raises(ValueError, match="fewer than a batch"):
        next(make_dataset(cfg, seed=0, split="eval", batch_size=4))


def _settled_thread_count(limit: int, timeout: float = 10.0) -> int:
    end = time.time() + timeout
    while threading.active_count() > limit and time.time() < end:
        time.sleep(0.05)
    return threading.active_count()


def test_decoder_threads_end_with_their_iterator(jpeg_dir):
    cfg, _ = _cfgs(jpeg_dir, loader_threads=3, loader_cache="off",
                   prefetch_batches=2)
    base = threading.active_count()
    for i in range(4):                 # as repeated evals would
        it = make_dataset(cfg, seed=i)
        next(it)
        assert threading.active_count() == base + 4   # producer, 3 decoders
        if i % 2:
            it.close()
        del it                         # collected: the same as closing
        assert _settled_thread_count(base) == base, i
