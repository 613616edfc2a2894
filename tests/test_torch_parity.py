"""The port's quality-parity harness (train/parity.py): its own ``cpu`` pins,
the ``celeba128_center`` fingerprint against them, and ``evaluate`` of one
set of weights in both packages on one folder corpus."""

import json

import jax
import numpy as np
import pytest
from PIL import Image

from gan_inpainting_tpu.configs.base import apply_overrides as j_apply
from gan_inpainting_tpu.configs.base import get_config as j_get
from gan_inpainting_tpu.train.evaluate import evaluate as j_evaluate
from gan_inpainting_tpu.train.state import create_state as j_create_state

from gan_inpainting_torch.configs.base import (
    apply_overrides,
    get_config,
    list_configs,
)
from gan_inpainting_torch.io.convert import params_from_jax
from gan_inpainting_torch.train.evaluate import evaluate
from gan_inpainting_torch.train.parity import (
    PINNED_PATH,
    check_parity,
    run_parity,
)

# the same float32 weights on the same decoded images and center masks:
# the packages differ only by the order of float32 sums
PSNR_TOL_DB = 0.01
SSIM_TOL = 1e-3


def test_pinned_file_covers_every_config():
    pinned = json.loads(PINNED_PATH.read_text())["cpu"]
    for name in list_configs():
        assert name in pinned, name
        assert {"psnr", "ssim"} <= set(pinned[name])
        if get_config(name).data.image_size > 256:
            assert {"psnr", "ssim"} <= set(pinned[f"{name}@256"])


def test_celeba128_fingerprint_matches_pinned():
    results = run_parity(["celeba128_center"], device="cpu")
    assert not check_parity(results, device="cpu"), results


def test_check_parity_reports_drift(tmp_path):
    results = {"celeba128_center": {"psnr": 20.0, "ssim": 0.5,
                                    "swd_avg": 100.0}}
    pins = tmp_path / "pins.json"
    pins.write_text(json.dumps({"cpu": {"celeba128_center": {
        "psnr": 20.09, "ssim": 0.506, "swd_avg": 101.9}}}))
    problems = check_parity(results, pins, device="cpu")
    assert len(problems) == 1 and "ssim" in problems[0]
    assert check_parity({"other": {}}, pins, device="cpu") == [
        "other: no pinned entry"]
    assert "no pins for device type 'cpu'" in check_parity(
        results, _write(tmp_path / "none.json", {"cuda": {}}),
        device="cpu")[0]


def _write(path, obj):
    path.write_text(json.dumps(obj))
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:72, 0:88]
    for i in range(80):                      # eval split: 4 files
        base = rng.integers(40, 215, 3)
        img = base + 30 * np.sin(xx / (5 + i % 7))[..., None] \
            + rng.normal(0, 8, (72, 88, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / f"{i:03d}.jpg", quality=92)
    return root


def test_evaluate_matches_jax_on_a_folder(corpus):
    overrides = ["data.dataset=folder", f"data.root={corpus}",
                 "data.image_size=64", "data.eval_batch_size=4",
                 "data.num_eval_batches=2", "data.loader_threads=1",
                 "data.loader_cache=off", "model.base_features=16",
                 "model.dtype_policy=f32"]
    jcfg = j_apply(j_get("celeba128_center"), overrides)
    cfg = apply_overrides(get_config("celeba128_center"), overrides)
    assert cfg.mask.kind == "center" and not cfg.mask.center_jitter
    g_params = jax.jit(lambda key: j_create_state(jcfg, key))(
        jax.random.key(0)).g_params
    want = j_evaluate(jcfg, g_params)
    got = evaluate(cfg, params_from_jax(jax.device_get(g_params)),
                   device="cpu")
    assert set(got) == set(want) == {"psnr", "ssim"}
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_TOL_DB, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_TOL, (got, want)
