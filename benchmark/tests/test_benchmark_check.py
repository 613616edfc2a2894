"""The check that decides ``correct``: the reference agrees with the
program where it should, and the check fails the control and each fault
a cell can have. Each test drives the rest of a run (set-up, window,
release, check) on the CPU, skipping the look for a card, at a size a
test run holds; the program's timed path is broken underneath where a
fault is planted.

The ``gpu`` tests take the control at a cell's own size on the card:
``python -m pytest benchmark/tests -m gpu``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import drivers, serving, spec
from benchmark.harness.trace import Tracer

SERVE_TINY = ["model.base_features=8", "infer.size_buckets=32",
              "infer.batch_buckets=1,4"]
SERVE_PARAMS = {"size": 32, "batch": 4, "pool_batches": 2, "ref_block": 4,
                "warm_calls": 1}
TRAIN_TINY = ["model.base_features=8", "model.disc_features=8",
              "data.image_size=32", "data.batch_size=2"]
TRAIN_PARAMS = {"pool_batches": 4}


def run_cpu(cell, overrides, params, seed=5):
    return bench_run.run_cell(cell, seed, 0.3, False, torch.device("cpu"),
                              overrides, params)


def driver_cpu(cell, overrides, params, seed=5, seconds=0.3):
    c = spec.workload(cell)
    run = drivers.Run(cell, c, {**spec.cell_params(c), **params}, seed,
                      seconds, torch.device("cpu"), Tracer(False),
                      tuple(overrides))
    d = drivers.load(run.params["driver"])(run)
    d.setup()
    d.measure()
    d.release()
    return run, d


def failed(run, values) -> bool:
    return any(c["value"] > c["limit"] for c in drivers.verdict(run, values))


def fp8(cell: str):
    """The float8 control of the cell's configuration's reference."""
    return spec.reference(spec.workload(cell)["config"]).fp8


# ---- the readings and counts of a seed, pinned --------------------------------


@pytest.fixture
def one_thread():
    """One CPU thread, so the reference's float32 sums run in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_readings_and_counts_of_a_seed_are_pinned(one_thread):
    """Seed 5 at the tiny CPU size: the weights, the reference's served
    images and training readings, and the counts over a fixed window, as
    the harness gave them before the drivers reached the model through the
    configuration's reference (bit for bit)."""
    run, d = driver_cpu("serve256_batch64", SERVE_TINY, SERVE_PARAMS)
    imgs, masks, _ = d.compared()
    assert hashlib.sha256(serving.reference_u8(d, imgs, masks).tobytes()) \
        .hexdigest() == ("3ad698b278a568ec9603e888eea19b3f"
                         "c47cccf5ca182bac892c2faf027d54c7")
    assert sum(float(v.double().sum()) for v in d.params.values()) \
        == -71.83526932539758
    assert d.counts({"calls": 5}) == {
        "model_flops": 1952000000.0,
        "attn_fwd_bound_s": 1.2379701492537312e-07}

    run, d = driver_cpu("train512_r1", TRAIN_TINY, TRAIN_PARAMS)
    ref = d.reference()
    assert ref["losses"] == [
        {"d_loss": 2.0064330101013184, "g_loss": 0.7262361645698547},
        {"d_loss": 2.0025410652160645, "g_loss": 0.6471816897392273},
        {"d_loss": 1.986368179321289, "g_loss": 0.8939773440361023}]
    assert sum(ref["first"].values()) == 1.8920019273794715
    assert sum(ref["changes"].values()) == 0.43258567322172325
    assert d.counts({"first_step": 16, "steps": 3, "r1_steps": 1}) == {
        "model_flops": 2402580480.0,
        "attn_bwd_bound_s": 1.3411343283582091e-07}


# ---- the reference against the program --------------------------------------


def test_serving_float32_program_matches_the_reference_exactly():
    r = run_cpu("serve256_batch64", SERVE_TINY + ["model.dtype_policy=f32"],
                SERVE_PARAMS)
    assert r["correct"]
    assert r["checked"]["known_changed"]["value"] == 0
    assert r["checked"]["hole_mad_worst"]["value"] == 0.0


def test_training_float32_program_follows_the_reference():
    r = run_cpu("train512_r1", TRAIN_TINY + ["model.dtype_policy=f32"],
                TRAIN_PARAMS)
    assert r["correct"]
    for c in r["checked"].values():
        assert c["value"] < 1e-4


def test_served_bf16_program_passes_at_full_width():
    r = run_cpu("serve256_batch64", ["model.base_features=24",
                                     "infer.size_buckets=64",
                                     "infer.batch_buckets=1,4"],
                dict(SERVE_PARAMS, size=64))
    assert r["correct"], r["checked"]


# ---- the control ------------------------------------------------------------


def test_the_float8_control_fails_serving_at_full_width():
    """The reference with its operands in float8 e4m3, in the program's
    place, at the served width (24) on 64² images."""
    run, d = driver_cpu("serve256_batch64", ["model.base_features=24",
                                             "infer.size_buckets=64",
                                             "infer.batch_buckets=1,4"],
                        dict(SERVE_PARAMS, size=64))
    assert failed(run, d.readings(q=fp8("serve256_batch64")))


def test_the_float8_control_fails_training():
    """At 16 features on 64² images: at 8 on 32² float8 moves the worst
    first gradient only 0.37-0.44 (the limit is 2)."""
    run, d = driver_cpu("train512_r1", ["model.base_features=16",
                                        "model.disc_features=16",
                                        "data.image_size=64",
                                        "data.batch_size=2"], TRAIN_PARAMS)
    assert not failed(run, d.readings())
    assert failed(run, d.readings(q=fp8("train512_r1")))


# ---- the faults -------------------------------------------------------------


def _break_inpaint(monkeypatch, how):
    from gan_inpainting_torch.infer.inpaint import Inpainter

    real = Inpainter.inpaint_batch

    def broken(self, images_u8, masks):
        out = real(self, images_u8, masks).copy()
        n = len(out)
        if how == "half":          # half of the batch left unfilled
            keep = np.asarray(masks).reshape(out.shape[:3] + (1,)) <= 0
            out[n // 2:] = np.asarray(images_u8)[n // 2:] * keep[n // 2:]
        elif how == "altered":     # an answer altered where it is made
            out[0] = 255 - out[0]
        return out

    monkeypatch.setattr(Inpainter, "inpaint_batch", broken)


@pytest.mark.parametrize("how", ["half", "altered"])
def test_serving_faults_are_caught(monkeypatch, how):
    _break_inpaint(monkeypatch, how)
    r = run_cpu("serve256_batch64", SERVE_TINY, SERVE_PARAMS)
    assert not r["correct"], r["checked"]


def _break_step(monkeypatch, how):
    import gan_inpainting_torch.train.step as step_mod
    from gan_inpainting_torch.data.pipeline import Batch

    real = step_mod.make_train_step

    def make(cfg):
        step = real(cfg)

        def broken(state, batch):
            if how == "half":      # half the batch left out
                return step(state, Batch(*(t[:len(t) // 2] for t in batch)))
            # the state returned unchanged: parameters, EMA, moments
            g = {k: v.clone() for k, v in state.generator.state_dict().items()}
            d = {k: v.clone() for k, v in
                 state.discriminator.state_dict().items()}
            ema = {k: v.clone() for k, v in state.g_ema.items()}
            out = step(state, batch)
            state.generator.load_state_dict(g)
            state.discriminator.load_state_dict(d)
            for k, v in ema.items():
                state.g_ema[k].copy_(v)
            for opt in (state.g_opt, state.d_opt):
                for st in opt.state.values():
                    st["exp_avg"].zero_()
            return out
        return broken

    monkeypatch.setattr(step_mod, "make_train_step", make)


@pytest.mark.parametrize("how", ["half", "unchanged"])
def test_training_faults_are_caught(monkeypatch, how):
    _break_step(monkeypatch, how)
    r = run_cpu("train512_r1", TRAIN_TINY, TRAIN_PARAMS)
    assert not r["correct"], r["checked"]


# ---- on the card, at the cells' own sizes -----------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["serve256_batch64", "serve512_batch64",
                                  "train512_r1"])
def test_the_float8_control_fails_at_the_cells_size(card, cell):
    c = spec.workload(cell)
    params = spec.cell_params(c)
    for seed in (1, 2, 3):
        run = drivers.Run(cell, c, params, seed, 2.0, card, Tracer(False))
        d = drivers.load(params["driver"])(run)
        d.setup()
        d.measure()
        d.release()
        assert not failed(run, d.readings())
        assert failed(run, d.readings(q=fp8(cell)))
