"""The port's sanitizer switches (utils/debug.py): ``debug_mode`` (NaN
checks, anomaly detection) and ``interpret_kernels`` (every kernel wrapper
takes its kernel's mirror), modelled on tests/unit/test_debug_utils.py."""

import contextlib

import numpy as np
import pytest
import torch

from gan_inpainting_torch.ops import dispatch
from gan_inpainting_torch.ops.contextual_attention import (
    contextual_attention,
    contextual_attention_plain,
)
from gan_inpainting_torch.ops.gated_conv import gated_conv, gated_conv_plain
from gan_inpainting_torch.ops.kernels import (
    fold,
    fused_attention,
    fused_attention_bwd,
    gated_matmul,
    partial_epilogue,
    patch_attention,
)
from gan_inpainting_torch.utils.debug import debug_mode, interpret_kernels

# tests/test_torch_attention.py (forward) and test_torch_attention_bwd.py
# (gradient) hold the float32 attention to these
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
BWD_TOL = dict(rtol=5e-4, atol=5e-4)

MIRRORS = [
    (fused_attention, "fused_attention_mirror"),
    (fold, "fold_taps_mirror"),
    (fused_attention_bwd, "tap_grads_mirror"),
    (fused_attention_bwd, "fold_tap_grads_mirror"),
    (gated_matmul, "gated_conv_mirror"),
    (patch_attention, "patch_attention_mirror"),
    (partial_epilogue, "partial_conv_epilogue_plain"),
]


def _attention_inputs(seed=0, b=2, h=16, w=16, c=8):
    rng = np.random.default_rng(seed)
    feat = torch.from_numpy(rng.standard_normal((b, h, w, c),
                                                dtype=np.float32))
    mask = np.zeros((b, h, w, 1), np.float32)
    mask[0, 4:10, 3:12] = 1.0
    mask[1] = 1.0                       # an all-hole sample
    return feat, torch.from_numpy(mask)


def test_debug_mode_toggles_and_restores():
    before = (torch.is_anomaly_enabled(),
              torch.is_anomaly_check_nan_enabled())
    with debug_mode():
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == before
    with debug_mode(nans=False, checks=False):
        assert not torch.is_anomaly_enabled()
        torch.log(torch.tensor(-1.0))       # no NaN check asked for
    with pytest.raises(RuntimeError):
        with debug_mode():
            raise RuntimeError("leaves the block")
    assert torch.is_anomaly_enabled() == before[0]


def test_debug_mode_catches_nan():
    with debug_mode():
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor(-1.0))
        # views and fresh buffers are not checked; their values are
        x = torch.empty(4)
        x.fill_(2.0)
        assert float(torch.sqrt(x[:2]).sum()) > 0
    torch.log(torch.tensor(-1.0))           # restored: no raise


def test_debug_mode_catches_nan_in_backward():
    x = torch.tensor([0.0], requires_grad=True)
    with debug_mode(nans=False):
        y = torch.sqrt(x) * 0.0             # d/dx sqrt at 0 is inf; · 0 NaN
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()


def test_debug_mode_passes_a_clean_train_step():
    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.data.loader import make_dataset
    from gan_inpainting_torch.data.pipeline import make_train_batch
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    cfg = apply_overrides(get_config("celebahq256_freeform"), [
        "model.base_features=8", "model.disc_features=8",
        "model.use_attention=true", "model.dtype_policy=f32",
        "data.image_size=32", "data.batch_size=2"])
    state = create_state(cfg, device="cpu")
    images = next(make_dataset(cfg.data, seed=0))
    batch = make_train_batch(images, torch.Generator().manual_seed(0),
                             cfg.mask)
    with debug_mode():
        metrics = make_train_step(cfg)(state, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_interpret_kernels_toggles_and_restores():
    assert not dispatch.interpreting()
    with interpret_kernels():
        assert dispatch.interpreting()
        assert not dispatch.use_kernel(torch.zeros(1))
    assert not dispatch.interpreting()
    with pytest.raises(KeyError):
        with interpret_kernels():
            raise KeyError("leaves the block")
    assert not dispatch.interpreting()


def test_interpret_kernels_sends_each_wrapper_to_its_mirror(monkeypatch):
    calls = {name: 0 for _, name in MIRRORS}
    for module, name in MIRRORS:
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, name, spy)

    def drive():
        feat, mask = _attention_inputs()
        x = feat.clone().requires_grad_(True)
        y = contextual_attention(x, x, mask)            # the fused route
        other = torch.flip(feat, (2,)).requires_grad_(True)
        z = contextual_attention(other, x, mask)        # f ≠ b: patch route
        (y.sum() + z.sum()).backward()
        rng = np.random.default_rng(1)
        xc = torch.from_numpy(rng.standard_normal((2, 8, 8, 6),
                                                  dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal((8, 6, 3, 3),
                                                 dtype=np.float32) * 0.2)
        bias = torch.zeros(8)
        for stride in (1, 2):
            gated_conv(xc, w, bias, stride=stride, backend="pallas")
        partial_epilogue.partial_conv_epilogue(
            torch.ones(1, 4, 4, 8), torch.full((1, 4, 4, 1), 9.0),
            torch.zeros(8), 9)

    plain = "partial_conv_epilogue_plain"       # the kernel has no mirror
    drive()
    assert calls.pop(plain) == 1
    assert not any(calls.values()), calls       # CPU: the plain versions
    calls[plain] = 0
    before = dict(dispatch.launches)
    with interpret_kernels():
        drive()
    assert dispatch.launches == before          # nothing launched
    assert all(calls.values()), calls
    assert calls["gated_conv_mirror"] == 2
    assert calls["patch_attention_mirror"] >= 3  # forward, dQ, dK/dV


@pytest.mark.parametrize("route", ["fused", "patch"])
def test_interpret_attention_matches_plain(route):
    feat, mask = _attention_inputs(seed=3)
    q = feat if route == "fused" else torch.roll(feat, 3, dims=1)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        feat.shape, dtype=np.float32))
    outs = []
    for attention, ctx in ((contextual_attention, interpret_kernels),
                           (contextual_attention_plain, None)):
        x = feat.clone().requires_grad_(True)
        with ctx() if ctx else contextlib.nullcontext():
            y = attention(x if route == "fused" else q, x, mask)
            (dx,) = torch.autograd.grad(y, x, g)
        outs.append((y.detach().numpy(), dx.numpy()))
    (y, dx), (y_ref, dx_ref) = outs
    np.testing.assert_allclose(y, y_ref, **FWD_TOL)
    np.testing.assert_allclose(dx, dx_ref, **BWD_TOL)
    assert np.abs(y[1]).max() == 0.0            # the all-hole sample


def test_interpret_gated_conv_matches_plain():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 5),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((12, 5, 3, 3),
                                             dtype=np.float32) * 0.3)
    b = torch.from_numpy(rng.standard_normal(12, dtype=np.float32))
    for stride, dilation in ((1, 1), (1, 2), (2, 1)):
        want = gated_conv_plain(x, w, b, stride=stride, dilation=dilation)
        with interpret_kernels():
            got = gated_conv(x, w, b, stride=stride, dilation=dilation,
                             backend="pallas")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
