"""A training run's record in the port: ``MetricsWriter`` (jsonl against the
JAX package's writer, TensorBoard events), the eval sample grid
(``train/loop.py _dump_samples``) and a CPU train fed from a folder that
writes both."""

import json

import numpy as np
import pytest
from PIL import Image

from gan_inpainting_tpu.io.metrics_writer import MetricsWriter as JWriter

from gan_inpainting_torch.configs.base import apply_overrides, get_config
from gan_inpainting_torch.data.loader import make_dataset
from gan_inpainting_torch.data.pipeline import denormalize, make_train_batch
from gan_inpainting_torch.io.metrics_writer import MetricsWriter
from gan_inpainting_torch.train.evaluate import make_eval_step
from gan_inpainting_torch.train.loop import _dump_samples, train
from gan_inpainting_torch.train.state import create_state
from gan_inpainting_torch.utils.rng import STREAM_EVAL, stream_generator

EVENTS = [(1, {"g_loss": 0.5, "d_loss": np.float32(1.25)}),
          (2, {"steps_per_sec": 3, "images_per_sec": 12.0}),
          (2, {"eval_psnr": 21.5, "eval_ssim": 0.75})]


def _tb_tags(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(logdir), size_guidance={"images": 0})
    acc.Reload()
    return acc


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(80):                      # 76 train, 4 eval
        arr = rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"im_{i:03d}.jpg", quality=92)
    return root


def _cfg(image_dir, work):
    return apply_overrides(get_config("celebahq256_freeform"), [
        "model.base_features=8", "model.disc_features=8",
        "model.use_attention=true", "model.dtype_policy=f32",
        "data.image_size=32", "data.batch_size=2", "data.eval_batch_size=4",
        "data.num_eval_batches=1", "data.dataset=folder",
        f"data.root={image_dir}", "data.loader_cache=off",
        "data.loader_threads=1",
        f"train.workdir={work}", "train.steps=2", "train.log_every=1",
        "train.eval_every=2", "train.checkpoint_every=2"])


def test_jsonl_records_match_jax(tmp_path):
    ours = MetricsWriter(str(tmp_path / "ours"), use_tensorboard=False)
    theirs = JWriter(str(tmp_path / "jax"), use_tensorboard=False)
    for step, values in EVENTS:
        ours.scalars(step, values)
        theirs.scalars(step, values)
    ours.close()
    theirs.close()
    assert not (tmp_path / "ours" / "tb").exists()
    recs = [[json.loads(line) for line in
             (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
            for d in ("ours", "jax")]
    assert len(recs[0]) == len(EVENTS)
    for a, b in zip(*recs):
        assert abs(a.pop("time") - b.pop("time")) < 60
        assert a == b


def test_tensorboard_events_written(tmp_path):
    writer = MetricsWriter(str(tmp_path))   # tensorboard is installed
    for step, values in EVENTS:
        writer.scalars(step, values)
    grid = np.random.default_rng(0).integers(0, 255, (2, 8, 32, 3),
                                             dtype=np.uint8)
    writer.images(2, "samples", grid)
    writer.close()
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    acc = _tb_tags(tmp_path / "tb")
    assert {"g_loss", "eval_psnr"} <= set(acc.Tags()["scalars"])
    assert [e.value for e in acc.Scalars("eval_psnr")] == [21.5]
    assert acc.Tags()["images"]


def test_dump_samples_grid(image_dir, tmp_path):
    cfg = _cfg(image_dir, tmp_path)
    state = create_state(cfg, device="cpu")
    writer = MetricsWriter(str(tmp_path), use_tensorboard=False)
    grid = _dump_samples(cfg, state, writer, 3, make_eval_step(cfg, "cpu"),
                         "cpu")
    writer.close()
    s = cfg.data.image_size
    assert grid.shape == (4, s, 4 * s, 3) and grid.dtype == np.uint8
    images = next(make_dataset(cfg.data, seed=cfg.train.seed, split="eval",
                               batch_size=4))
    batch = make_train_batch(
        images, stream_generator(cfg.train.seed, STREAM_EVAL, 3), cfg.mask)
    np.testing.assert_array_equal(grid[:, :, :s],
                                  denormalize(batch.masked).numpy())
    np.testing.assert_array_equal(grid[:, :, 3 * s:], images.numpy())
    hole = batch.mask[..., 0].numpy() > 0.5
    # the composite keeps the known pixels of the target
    np.testing.assert_array_equal(grid[:, :, 2 * s:3 * s][~hole],
                                  images.numpy()[~hole])


def test_train_from_folder_writes_the_record(image_dir, tmp_path):
    cfg = _cfg(image_dir, tmp_path / "run")
    state, scalars = train(cfg, device="cpu", verbose=False)
    assert state.step == 2 and np.isfinite(scalars["g_loss"])
    recs = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "g_loss" in r] == [1, 2]
    evals = [r for r in recs if "eval_psnr" in r]
    assert len(evals) == 1 and evals[0]["step"] == 2
    assert np.isfinite(evals[0]["eval_psnr"])
    assert (tmp_path / "run" / "checkpoints").exists()
    acc = _tb_tags(tmp_path / "run" / "tb")
    assert "eval_psnr" in acc.Tags()["scalars"]
    (tag,) = acc.Tags()["images"]
    assert "samples" in tag
