"""The port's throughput benchmarks (``gan_inpainting_torch/bench.py``)
on the CPU: the timed body against the JAX bench's body on the same
params and inputs, the returned keys against the JAX module's, the step
windows of ``bench_train``, the staged pool, and ``bench_train`` over two
spawned gloo ranks.

JAX is imported inside the tests alone: the rank workers import this
module and must import only torch, numpy and the port.
"""

import ast
import dataclasses
import multiprocessing
import pathlib
import pickle

import numpy as np
import pytest
import torch

from gan_inpainting_torch import bench
from gan_inpainting_torch.configs.base import (
    apply_overrides,
    config_from_dict,
    get_config,
)
from gan_inpainting_torch.io.convert import params_from_jax
from gan_inpainting_torch.models.generator import build_generator
from test_torch_parallel import (
    TINY,
    WORLD,
    _assert_same,
    _rank_main,
    _state_dict_cpu,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
# the body's config: gated coarse-to-fine with contextual attention
BODY = ["model.use_attention=true", "model.base_features=8",
        "data.image_size=64"]
# uint8 outputs of the port's body against JAX's, hole pixels: float32
# within this many levels everywhere; bf16 within BF16_LEVELS on at least
# BF16_FRAC of them (conv sums in another order, rounded to bf16)
F32_LEVELS = 1
BF16_LEVELS, BF16_FRAC = 2, 0.999
# the drawn kernels' scale over 1/sqrt(fan_in): at 1 the gated stacks
# shrink the signal and every hole pixel lands within 109–154; at 2 they
# span 66–210 (at 3 they saturate at 0 and 255)
GAIN = 2.0


def _tiny(overrides=()):
    return apply_overrides(get_config("celeba128_center"),
                           TINY + list(overrides))


def _u8_and_masks(b, s, seed=0):
    """Smooth uint8 images and blocky binary hole masks (B, S, S, 1)."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 255, (b, s // 8, s // 8, 3))
    image = np.kron(low, np.ones((1, 8, 8, 1))) + rng.normal(0, 8,
                                                             (b, s, s, 3))
    image = np.clip(np.round(image), 0, 255).astype(np.uint8)
    mask = np.kron(rng.random((b, s // 8, s // 8, 1)) < 0.3,
                   np.ones((1, 8, 8, 1))).astype(np.float32)
    return image, mask


def _jax_returned_keys(fn_name):
    """The keys of the dict that ``fn_name`` returns in the JAX module."""
    tree = ast.parse((REPO / "gan_inpainting_tpu" / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = [n for n in ast.walk(fn)
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(ret) == 1
    return {k.value for k in ret[0].value.keys}


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_body_matches_jax_bench_body(policy):
    """The port's ``bench_forward`` against the body of JAX's
    ``bench_infer`` (its ``scan`` body, written out here), same params."""
    import jax
    import jax.numpy as jnp

    from gan_inpainting_tpu.configs.base import apply_overrides as j_apply
    from gan_inpainting_tpu.configs.base import get_config as j_get
    from gan_inpainting_tpu.data.pipeline import denormalize as j_denorm
    from gan_inpainting_tpu.data.pipeline import normalize as j_norm
    from gan_inpainting_tpu.models.generator import build_generator as j_gen

    overrides = BODY + [f"model.dtype_policy={policy}"]
    jcfg = j_apply(j_get("celebahq256_freeform"), overrides)
    cfg = apply_overrides(get_config("celebahq256_freeform"), overrides)
    images, masks = _u8_and_masks(2, 64)
    jgen = j_gen(jcfg.model)
    shapes = jax.eval_shape(jgen.init, jax.random.key(0),
                            jnp.zeros((2, 64, 64, 3), jnp.bfloat16),
                            jnp.zeros((2, 64, 64, 1), jnp.bfloat16))
    rng = np.random.default_rng(1)

    def draw(s):
        fan_in = np.prod(s.shape[:-1]) if len(s.shape) == 4 else 100.0
        return (GAIN * rng.standard_normal(s.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map(draw, shapes["params"])

    @jax.jit
    def jax_body(image_u8, mask):
        image = j_norm(image_u8).astype(jnp.bfloat16)
        mask16 = mask.astype(jnp.bfloat16)
        out = jgen.apply({"params": params}, image * (1 - mask16), mask16)
        out_u8 = j_denorm(out.fine.astype(jnp.float32))
        return jnp.where(mask <= 0.0, image_u8, out_u8)

    want = np.asarray(jax_body(images, masks))
    gen = build_generator(cfg.model, device="cpu")
    gen.load_state_dict(params_from_jax(params), strict=True)
    gen.eval()
    with torch.inference_mode():
        got = bench.bench_forward(gen, torch.from_numpy(images),
                                  torch.from_numpy(masks)).numpy()
    assert got.dtype == np.uint8 and got.shape == images.shape
    hole = np.broadcast_to(masks > 0, images.shape)
    np.testing.assert_array_equal(got[~hole], images[~hole])
    np.testing.assert_array_equal(want[~hole], images[~hole])
    diff = np.abs(got.astype(int) - want.astype(int))[hole]
    assert diff.size > 1000
    if policy == "f32":
        assert diff.max() <= F32_LEVELS, diff.max()
    else:
        assert (diff <= BF16_LEVELS).mean() >= BF16_FRAC, (
            (diff <= BF16_LEVELS).mean())


def test_body_feeds_the_generator_bf16():
    """Under ``dtype_policy=f32`` too, the generator gets the masked image
    and the mask in bf16, as JAX's bench body passes them (the serve
    body passes float32)."""
    cfg = apply_overrides(get_config("celebahq256_freeform"),
                          BODY + ["model.dtype_policy=f32",
                                  "data.image_size=32"])
    gen = build_generator(cfg.model, device="cpu", seed=0).eval()
    seen = []
    gen.register_forward_pre_hook(
        lambda module, args: seen.append([a.dtype for a in args]))
    images, masks = _u8_and_masks(1, 32)
    with torch.inference_mode():
        out = bench.bench_forward(gen, torch.from_numpy(images),
                                  torch.from_numpy(masks))
    assert seen == [[torch.bfloat16, torch.bfloat16]]
    assert out.dtype == torch.uint8


def test_bench_infer_keys_match_jax():
    r = bench.bench_infer(_tiny(), batch=2, iters=2, warmup=1, device="cpu")
    assert set(r) == _jax_returned_keys("bench_infer")
    assert r["metric"] == "32x32 inpaint images/sec/chip"
    assert r["unit"] == "images/sec/chip"
    assert r["chips"] == 1 and r["batch"] == 2
    assert r["value"] > 0 and r["total_images_per_sec"] == r["value"]


def test_bench_train_keys_match_jax():
    r = bench.bench_train(_tiny(), iters=2, device="cpu")
    assert set(r) == _jax_returned_keys("bench_train")
    assert r["metric"] == "G+D train steps/sec"
    assert r["unit"] == "steps/sec"
    assert r["chips"] == 1 and r["batch"] == 4
    assert r["value"] > 0
    assert r["images_per_sec"] == pytest.approx(r["value"] * 4)


def test_run_bench_dispatches_and_refuses_other_modes(monkeypatch):
    monkeypatch.setattr(bench, "bench_infer", lambda cfg, device: "infer")
    monkeypatch.setattr(bench, "bench_train", lambda cfg, device: "train")
    assert bench.run_bench(_tiny(), device="cpu") == "infer"
    assert bench.run_bench(_tiny(), "train", device="cpu") == "train"
    with pytest.raises(ValueError, match="unknown bench mode 'eval'"):
        bench.run_bench(_tiny(), "eval", device="cpu")


def test_bench_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (bench.bench_infer, bench.bench_train):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(_tiny())


def test_every_run_covers_the_same_steps(monkeypatch):
    """Each of the 4 runs (one untimed, 3 timed) takes steps 0, 1, 2: R1
    (every 2nd step) at steps 0 and 2 of each, 8 passes in all, and the
    masks of steps 0–2 each time."""
    taken, drawn = [], []
    make_step, stream = bench.make_train_step, bench.stream_generator

    def counting_step(cfg):
        step = make_step(cfg)

        def run(state, batch):
            at = state.step
            metrics = step(state, batch)
            taken.append((at, float(metrics["d_r1"]) > 0))
            return metrics
        return run

    def counting_stream(seed, stream_id, step, extra=0):
        drawn.append(step)
        return stream(seed, stream_id, step, extra=extra)

    monkeypatch.setattr(bench, "make_train_step", counting_step)
    monkeypatch.setattr(bench, "stream_generator", counting_stream)
    bench.bench_train(_tiny(["loss.r1_gamma=0.1", "loss.r1_interval=2"]),
                      iters=3, device="cpu")
    assert [at for at, _ in taken] == [0, 1, 2] * 4
    assert [at for at, r1 in taken if r1] == [0, 2] * 4
    assert drawn == [0, 1, 2] * 4


def test_pool_holds_distinct_batches():
    cfg = apply_overrides(get_config("serve_v4_8"), ["data.image_size=32"])
    images, masks = bench.make_pool(cfg, batch=2, iters=3,
                                    device=torch.device("cpu"))
    assert images.shape == (3, 2, 32, 32, 3) and images.dtype == torch.uint8
    assert masks.shape == (3, 2, 32, 32, 1) and masks.dtype == torch.float32
    assert set(masks.unique().tolist()) == {0.0, 1.0}
    for i in range(3):
        for j in range(i + 1, 3):
            assert not torch.equal(images[i], images[j]), (i, j)
            assert not torch.equal(masks[i], masks[j]), (i, j)
    again = bench.make_pool(cfg, batch=2, iters=3,
                            device=torch.device("cpu"))
    assert torch.equal(images, again[0]) and torch.equal(masks, again[1])


def _job_bench(cfg_dict):
    """``bench_train`` on this rank; its result and the state it trained."""
    from gan_inpainting_torch.train import loop

    made = []
    create = loop.create_state

    def keep(*args, **kwargs):
        made.append(create(*args, **kwargs))
        return made[-1]

    loop.create_state = keep
    try:
        res = bench.bench_train(config_from_dict(cfg_dict), iters=2,
                                device="cpu")
    finally:
        loop.create_state = create
    return res, _state_dict_cpu(made[0])


def test_bench_train_over_two_ranks(tmp_path):
    cfg = _tiny(["loss.r1_gamma=0.1", "loss.r1_interval=2"])
    jobs = {"bench": (_job_bench, (dataclasses.asdict(cfg),))}
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path / "store"), jobs,
                               str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    errors = [f.read_text() for f in sorted(tmp_path.glob("error*.txt"))]
    assert not alive and not errors and all(
        p.exitcode == 0 for p in procs), (errors,
                                          [p.exitcode for p in procs])
    (r0, s0), (r1, s1) = [
        pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())["bench"]
        for r in range(WORLD)]
    for r in (r0, r1):
        assert r["chips"] == WORLD and r["batch"] == 4 and r["value"] > 0
    # 4 runs of 2 steps, every one from step 0
    assert s0["step"] == s1["step"] == 2
    _assert_same(s0, s1, "ranks after bench_train")
