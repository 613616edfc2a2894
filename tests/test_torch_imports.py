"""The port stands alone: it imports neither JAX nor the JAX package, its
kernel modules import without nvcc, and its entry points do not fall back
to the CPU on their own."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_imports_no_jax():
    res = _run("""
        import sys
        import gan_inpainting_torch
        from gan_inpainting_torch.configs.base import get_config
        from gan_inpainting_torch.models.generator import build_generator
        from gan_inpainting_torch.ops.kernels import build, fold, fused_attention
        import importlib, pkgutil
        for info in pkgutil.walk_packages(gan_inpainting_torch.__path__,
                                          "gan_inpainting_torch."):
            if not info.name.endswith("__main__"):
                importlib.import_module(info.name)
        assert "gan_inpainting_torch.ops.kernels.fused_attention_bwd" in sys.modules
        assert "gan_inpainting_torch.train.loop" in sys.modules
        assert "gan_inpainting_torch.cli" in sys.modules
        assert "gan_inpainting_torch.tools.profile_train" in sys.modules
        import chip_smoke
        import torch
        gen = build_generator(get_config("serve_v4_8").model, device="cpu")
        assert sum(p.numel() for p in gen.parameters()) > 16_000_000
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "orbax", "gan_inpainting_tpu"))
        assert not bad, bad
        assert not build._libs, "a kernel was built at import"
        print("clean")
    """)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal path needs none")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    from gan_inpainting_torch.configs.base import get_config
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.ops.dispatch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("serve_v4_8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_generator(cfg.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Inpainter(cfg, {})
    from gan_inpainting_torch.models.discriminator import build_discriminator
    from gan_inpainting_torch.train.evaluate import evaluate
    from gan_inpainting_torch.train.loop import train
    from gan_inpainting_torch.train.state import create_state

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_discriminator(cfg.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate(cfg, {})
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_take_plain_versions_on_cpu():
    from gan_inpainting_torch.ops.dispatch import launches, use_kernel
    from gan_inpainting_torch.ops.kernels.fold import fold_taps
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        fused_attention_taps,
    )

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    hole = torch.zeros(1, 8, 8, 1)
    before = dict(launches)
    taps = fused_attention_taps(x, hole)
    assert taps.shape == (1, 16, 16, 4)
    assert fold_taps(taps, 4, 4, 2).shape == (1, 8, 8, 4)
    assert launches == before
    # the backward on a CPU tensor is autograd through the plain version
    xg = x.clone().requires_grad_(True)
    from gan_inpainting_torch.ops.contextual_attention import (
        contextual_attention,
    )
    contextual_attention(xg, xg, hole).sum().backward()
    assert xg.grad is not None and launches == before
    assert use_kernel(x) is False
    with pytest.raises(ValueError, match="no implementation"):
        use_kernel(x.to("meta"))


def test_cli_lists_configs_and_trains_on_the_cpu(tmp_path):
    res = _run("""
        import sys
        from gan_inpainting_torch.cli import main
        assert main(["configs"]) == 0
        rc = main(["train", "--config", "celebahq256_freeform", "--device",
                   "cpu", "model.use_attention=true",
                   "model.base_features=8", "model.disc_features=8",
                   "data.image_size=32", "data.batch_size=2",
                   "data.eval_batch_size=2", "data.num_eval_batches=1",
                   "train.steps=2", "train.log_every=1",
                   "train.workdir=%s"])
        assert rc == 0
        assert not [m for m in sys.modules if m.split(".")[0] in
                    ("jax", "flax", "optax", "gan_inpainting_tpu")]
    """ % tmp_path)
    assert res.returncode == 0, res.stderr
    assert "places512_deepfill" in res.stdout
    assert "[train] step 2:" in res.stdout
    assert (tmp_path / "checkpoints" / "step_2.pt").exists()
    assert (tmp_path / "metrics.jsonl").exists()
