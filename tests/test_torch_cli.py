"""The port's CLI (``python -m gan_inpainting_torch``): every subcommand
through ``main([...])`` on the CPU (``--device cpu``), and the refusal to
run on the CPU without being asked."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from gan_inpainting_torch.cli import main
from gan_inpainting_torch.configs.base import apply_overrides, get_config
from gan_inpainting_torch.infer.inpaint import Inpainter
from gan_inpainting_torch.io.export import export_generator
from gan_inpainting_torch.models.generator import build_generator

COMMANDS = ("configs", "train", "eval", "infer", "export", "mask", "serve",
            "profile", "parity")
# celebahq256_freeform with attention at width 8 (eval.metrics has swd)
TINY = ["model.base_features=8", "model.disc_features=8",
        "model.use_attention=true", "model.dtype_policy=f32",
        "data.image_size=32", "data.batch_size=2", "data.eval_batch_size=2",
        "data.num_eval_batches=1", "infer.batch_buckets=1,4",
        "infer.size_buckets=32,64"]


def _cfg():
    return apply_overrides(get_config("celebahq256_freeform"), TINY)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    cfg = _cfg()
    path = tmp_path_factory.mktemp("art") / "g.npz"
    gen = build_generator(cfg.model, device="cpu", seed=5)
    export_generator(cfg, gen.state_dict(), str(path))
    return str(path)


def _write_pair(root, stem, h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = 255
    (root / "images").mkdir(exist_ok=True)
    (root / "masks").mkdir(exist_ok=True)
    Image.fromarray(img).save(root / "images" / f"{stem}.png")
    Image.fromarray(mask).save(root / "masks" / f"{stem}.png")
    return img, mask > 127


def test_help_lists_every_command(capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    for cmd in COMMANDS:
        assert cmd in out, cmd


@pytest.mark.parametrize("argv", [
    ["train"], ["eval"], ["export", "--output", "g.npz"],
    ["mask", "--output", "m.png"], ["serve"], ["profile"], ["parity"],
    ["infer", "--image", "i.png", "--mask", "m.png", "--output", "o.png"],
], ids=lambda a: a[0])
def test_commands_raise_without_cuda(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_configs_lists_all(capsys):
    assert main(["configs"]) == 0
    out = capsys.readouterr().out.split()
    assert {"celeba128_center", "celebahq256_freeform", "places512_deepfill",
            "places512_sn_vgg", "serve_v4_8", "partialconv256"} <= set(out)


def test_mask_subcommand(tmp_path):
    out = tmp_path / "m.png"
    assert main(["mask", "--config", "celeba128_center", "--device", "cpu",
                 "--output", str(out), "data.image_size=64"]) == 0
    m = np.asarray(Image.open(out))
    assert m.shape == (64, 64) and set(np.unique(m)) <= {0, 255}
    assert (m == 255).any() and (m == 0).any()

    def draw(seed, name):
        outdir = tmp_path / name
        assert main(["mask", "--config", "celebahq256_freeform", "--device",
                     "cpu", "--n", "3", "--seed", str(seed), "--output",
                     str(outdir), "data.image_size=64"]) == 0
        files = sorted(outdir.glob("mask_*.png"))
        assert len(files) == 3
        return [np.asarray(Image.open(f)) for f in files]

    a, b, c = draw(7, "a"), draw(7, "b"), draw(8, "c")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert all((x == 255).any() for x in a)


def test_infer_a_file_and_a_directory(tmp_path, npz, capsys):
    inp = Inpainter.from_npz(npz, device="cpu")
    img, hole = _write_pair(tmp_path, "a", 32, 32, 0)
    out = tmp_path / "out.png"
    assert main(["infer", "--device", "cpu", "--weights", npz, "--image",
                 str(tmp_path / "images" / "a.png"), "--mask",
                 str(tmp_path / "masks" / "a.png"), "--output",
                 str(out)]) == 0
    got = np.asarray(Image.open(out))
    np.testing.assert_array_equal(got, inp(img, hole.astype(np.float32)))

    pairs = {"a": (img, hole), "b": _write_pair(tmp_path, "b", 24, 40, 1),
             "c": _write_pair(tmp_path, "c", 64, 64, 2),
             "d": _write_pair(tmp_path, "d", 32, 32, 3)}
    outdir = tmp_path / "outdir"
    assert main(["infer", "--device", "cpu", "--weights", npz, "--image",
                 str(tmp_path / "images"), "--mask", str(tmp_path / "masks"),
                 "--output", str(outdir)]) == 0
    assert "wrote 4 images" in capsys.readouterr().out
    for stem, (im, h) in pairs.items():
        got = np.asarray(Image.open(outdir / f"{stem}.png"))
        assert got.shape == im.shape
        np.testing.assert_array_equal(got[~h], im[~h])
        want = inp(im, h.astype(np.float32))
        diff = np.abs(got.astype(int) - want.astype(int))[h]
        assert float((diff <= 1).mean()) >= 0.999
    (tmp_path / "masks" / "d.png").unlink()
    with pytest.raises(FileNotFoundError, match="no mask for d.png"):
        main(["infer", "--device", "cpu", "--weights", npz, "--image",
              str(tmp_path / "images"), "--mask", str(tmp_path / "masks"),
              "--output", str(outdir)])


def test_train_export_and_eval(tmp_path, capsys):
    work = tmp_path / "run"
    common = ["--config", "celebahq256_freeform", "--device", "cpu"]
    overrides = TINY + [f"train.workdir={work}"]
    assert main(["train", *common, *overrides, "train.steps=2",
                 "train.log_every=1"]) == 0
    capsys.readouterr()
    paths = {}
    for flag in ("", "--raw"):
        paths[flag] = str(tmp_path / f"g{flag}.npz")
        assert main(["export", *common, "--output", paths[flag],
                     *([flag] if flag else []), *overrides]) == 0
    ema = Inpainter.from_npz(paths[""], device="cpu").state_dict
    raw = Inpainter.from_npz(paths["--raw"], device="cpu").state_dict
    assert not all(torch.equal(ema[k], raw[k]) for k in ema)
    capsys.readouterr()
    assert main(["eval", "--device", "cpu", "--weights", paths[""]]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"psnr", "ssim", "swd_avg", "swd_32", "swd_16"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())
    # the checkpoint's EMA gives the same numbers as its export
    assert main(["eval", *common, *overrides]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res


def test_profile_writes_a_trace(tmp_path, capsys):
    work = tmp_path / "prof"
    assert main(["profile", "--config", "celebahq256_freeform", "--device",
                 "cpu", "--steps", "1", *TINY, f"train.workdir={work}"]) == 0
    trace = work / "profile" / "trace.json"
    assert trace.exists()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert "[train] step 1:" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["infer", "--image", "i.png", "--mask", "m.png", "--output", "o.png",
     "--aot", "artifact"],
    ["serve", "--aot", "artifact"],
    ["export", "--output", "g.npz", "--aot"],
], ids=lambda a: a[0])
def test_aot_raises(argv):
    with pytest.raises(NotImplementedError, match="Queue 1, io/aot.py"):
        main(argv + ["--device", "cpu"])


def test_serve_answers_over_http(npz, monkeypatch):
    """``serve --weights`` on an ephemeral port: one request and /healthz,
    then a shutdown of the server ends the command and closes the
    service."""
    from gan_inpainting_torch.infer import service as svc

    made = []
    real = svc.make_http_server

    def capture(service, host, port):
        made.append(real(service, host, port))
        return made[-1]

    monkeypatch.setattr(svc, "make_http_server", capture)
    rc = []
    thread = threading.Thread(target=lambda: rc.append(main(
        ["serve", "--device", "cpu", "--weights", npz, "--port", "0"])))
    thread.start()
    try:
        for _ in range(600):
            if made:
                break
            thread.join(timeout=0.05)
        port = made[0].server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["requests"] == 0
    finally:
        if made:
            made[0].shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive() and rc == [0]


def test_parity_command(tmp_path, capsys, monkeypatch):
    from gan_inpainting_torch.train import parity

    argv = ["parity", "--device", "cpu", "--configs", "celeba128_center"]
    assert main(argv) == 0                   # the package's own cpu pins
    res = json.loads(capsys.readouterr().out)
    assert set(res["celeba128_center"]) == {"psnr", "ssim"}
    # the same fingerprint again, without evaluating it again
    monkeypatch.setattr(parity, "run_parity", lambda *a: res)
    pins = tmp_path / "pins.json"
    assert main([*argv, "--pinned", str(pins), "--update"]) == 0
    assert json.loads(pins.read_text()) == {"cpu": res}
    drift = {"cpu": {"celeba128_center": {"psnr": res["celeba128_center"][
        "psnr"] + 0.5, "ssim": res["celeba128_center"]["ssim"]}}}
    pins.write_text(json.dumps(drift))
    capsys.readouterr()
    assert main([*argv, "--pinned", str(pins)]) == 1
    assert "DRIFT: celeba128_center.psnr" in capsys.readouterr().err
