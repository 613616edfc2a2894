"""Data parallelism of the port (``gan_inpainting_torch/parallel/``) on
the CPU: two spawned ranks over gloo against one process and against the
JAX package's step on a ``data = 2`` mesh of its virtual CPU devices.

The rank workers are spawned (a fresh interpreter each) and import only
``torch``, numpy and the port: this module imports JAX inside the tests
alone, never at its top. One spawn runs every rank job of the file (a
module fixture); each test reads its part.
"""

import dataclasses
import multiprocessing
import os
import pathlib
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

from gan_inpainting_torch.configs.base import (
    apply_overrides,
    config_from_dict,
    get_config,
)
from gan_inpainting_torch.parallel import multihost
from gan_inpainting_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    train_mesh,
)

WORLD = 2
# conftest.py's tiny_config, which a module fixture cannot take
TINY = ["data.image_size=32", "data.batch_size=4", "data.eval_batch_size=4",
        "data.num_eval_batches=1", "model.base_features=8",
        "model.disc_features=8", "model.disc_layers=2",
        "model.dtype_policy=f32", "train.steps=2", "train.log_every=1",
        "train.eval_every=1000", "train.checkpoint_every=1000"]
# test_torch_train.py's attention config: gated coarse-to-fine with
# contextual attention, R1 on every step, the EMA
ATTN = ["model.generator=coarse_to_fine", "model.conv_kind=gated",
        "model.use_attention=true", "loss.r1_gamma=0.1",
        "train.g_ema_decay=0.999", "model.dtype_policy=f32"]
ACCUM = ATTN + ["train.grad_accum=2", "model.spectral_norm=true",
                "loss.tv_weight=0.1"]
TRAIN = ATTN + ["loss.r1_interval=2", "data.synthetic_family=textured",
                "mask.kind=freeform", "data.random_crop=true",
                "train.checkpoint_every=2", "train.eval_every=2"]
EVAL = ["eval.metrics=psnr,ssim,swd", "data.num_eval_batches=2",
        "eval.swd_max_images=3"]
# the 2-rank step against one process on the whole batch: per tensor,
# max |a − b| ≤ this · max |b| (the same float32 sums, split at the batch
# halves and added back in another order)
ONE_PROCESS_REL = 1e-6


def _jcfg(overrides):
    from gan_inpainting_tpu.configs.base import apply_overrides as j_apply
    from gan_inpainting_tpu.configs.base import get_config as j_get

    return j_apply(j_get("celeba128_center"), TINY + overrides)


def _cfg(overrides):
    return apply_overrides(get_config("celeba128_center"), TINY + overrides)


# ---------------------------------------------------------------------------
# rank jobs (run in the spawned workers)
# ---------------------------------------------------------------------------


def _state_dict_cpu(state):
    sd = state.state_dict()
    return {k: ({n: t.clone() for n, t in v.items()}
                if k in ("g_params", "d_params", "g_ema") else v)
            for k, v in sd.items()}


def _half(arrays, r):
    from gan_inpainting_torch.data.pipeline import Batch

    image, mask = (a[r * (len(a) // WORLD):(r + 1) * (len(a) // WORLD)]
                   for a in arrays)
    image, mask = torch.from_numpy(image), torch.from_numpy(mask)
    return Batch(image, mask, image * (1 - mask))


def _job_steps(cfg_dict, state_file, batches):
    """Steps on this rank's halves of numpy global batches from a saved
    state; per step the reduced metrics and the whole state."""
    from gan_inpainting_torch.parallel.sharding import reduce_metrics
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    cfg = config_from_dict(cfg_dict)
    state = create_state(cfg, device="cpu")
    for _ in range(1200):       # written by the main process, renamed whole
        if os.path.exists(state_file):
            break
        time.sleep(0.1)
    else:
        raise TimeoutError(state_file)
    state.load_state_dict(torch.load(state_file, weights_only=True))
    step = make_train_step(cfg)
    out = []
    for arrays in batches:
        metrics = reduce_metrics(step(state, _half(arrays, multihost.rank())))
        out.append((metrics, _state_dict_cpu(state)))
    return out


def _job_train(cfg_dict, root):
    """train() over the ranks: 4 steps at once, and 2 then 4 resumed; who
    wrote, and this rank's first batch."""
    from gan_inpainting_torch.train import loop

    cfg = config_from_dict(cfg_dict)
    writers, saves, first = [], [], []
    real_writer, real_batch = loop.MetricsWriter, loop.make_train_batch
    real_save = loop.CheckpointManager.save

    def writer(*args, **kwargs):
        writers.append(args)
        return real_writer(*args, **kwargs)

    def make_batch(*args, **kwargs):
        batch = real_batch(*args, **kwargs)
        if not first:
            first.append(batch.image.clone())
        return batch

    def save(self, step, *args):
        if self.path.name == "checkpoints":       # not the best slot
            saves.append(step)
        return real_save(self, step, *args)

    loop.MetricsWriter, loop.make_train_batch = writer, make_batch
    loop.CheckpointManager.save = save

    def run(name, steps):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps=steps, workdir=str(pathlib.Path(root) / name)))
        state, scalars = loop.train(c, device="cpu", verbose=False)
        return _state_dict_cpu(state), scalars

    whole, scalars = run("whole", 4)
    run("resumed", 2)
    resumed, _ = run("resumed", 4)
    return dict(whole=whole, resumed=resumed, scalars=scalars,
                writers=len(writers), saves=saves, first=first[0])


def _job_evaluate(cfg_dict, sd_file):
    from gan_inpainting_torch.train.evaluate import evaluate

    return evaluate(config_from_dict(cfg_dict),
                    torch.load(sd_file, weights_only=True), device="cpu")


def _job_slices():
    from gan_inpainting_torch.parallel.sharding import (
        all_gather_rows,
        reduce_metrics,
    )

    r = multihost.rank()
    with pytest.raises(ValueError, match="not divisible"):
        multihost.process_batch_slice(3)
    with pytest.raises(ValueError, match="data must be -1 or 2"):
        train_mesh(MeshConfig(data=1), multihost.world())
    rows = torch.full((2, 3), float(r + 1), dtype=torch.float16)
    return dict(slice=multihost.process_batch_slice(8),
                mesh=train_mesh(MeshConfig(), multihost.world()).data,
                gathered=all_gather_rows(rows),
                mean=reduce_metrics({"a": torch.tensor(float(r)), "b": 1.0}),
                total=reduce_metrics({"a": float(r)}, average=False))


def _rank_main(rank, init_file, jobs, out_dir):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD)
    try:
        results = {name: fn(*args) for name, (fn, args) in jobs.items()}
    except BaseException:
        pathlib.Path(out_dir, f"error{rank}.txt").write_text(
            traceback.format_exc())
        raise
    finally:
        torch.distributed.destroy_process_group()
    with open(pathlib.Path(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# the main process
# ---------------------------------------------------------------------------


def _numpy_batches(cfg, n):
    from test_torch_train import _numpy_batch

    return [_numpy_batch(cfg, seed=i) for i in range(n)]


def _port_state_from_jax(jcfg):
    """JAX's seeded state, converted: the port state both sides start from."""
    import jax

    from gan_inpainting_tpu.train.state import create_state as j_create
    from test_torch_train import _jax_state_as_numpy

    from gan_inpainting_torch.io.convert import load_state_from_jax
    from gan_inpainting_torch.train.state import create_state

    # jitted: one compile instead of an op-by-op initialization
    jstate = jax.jit(lambda key: j_create(jcfg, key))(jax.random.key(0))
    state = create_state(config_from_dict(dataclasses.asdict(jcfg)),
                         device="cpu")
    load_state_from_jax(state, _jax_state_as_numpy(jstate))
    return jstate, state


def _jax_data2_step(jcfg, jstate, arrays):
    """JAX's train step on a data=2 mesh of its virtual CPU devices (as
    tests/distributed/test_mesh_parity.py runs it): metrics and state."""
    import jax

    from gan_inpainting_tpu.parallel.mesh import MeshConfig as JMesh
    from gan_inpainting_tpu.parallel.mesh import build_mesh as j_build_mesh
    from gan_inpainting_tpu.parallel.sharding import replicated, shard_batch
    from gan_inpainting_tpu.train.step import make_train_step as j_make_step
    from test_torch_train import _batches

    mesh = j_build_mesh(JMesh(data=2, model=1), devices=jax.devices()[:2])
    jstate = jax.device_put(jstate, replicated(mesh))
    with jax.set_mesh(mesh):
        jstate, jm = j_make_step(jcfg, donate=False)(
            jstate, shard_batch(mesh, _batches(*arrays)[0]),
            jax.random.key(0))
    return ({k: float(v) for k, v in jm.items()}, jax.device_get(jstate))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once and run every job; returns per job the
    list of the ranks' results, with what the main process set up. The
    JAX side runs here while the ranks work: their "step" job waits for
    the state file that JAX's state is converted into."""
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.train.state import create_state

    tmp = tmp_path_factory.mktemp("ranks")
    setup = {name: dict(cfg=_cfg(o)) for name, o in (
        ("step", ATTN), ("accum", ACCUM), ("train", TRAIN),
        ("evaluate", EVAL))}
    for name, n in (("step", 1), ("accum", 2)):
        setup[name].update(batches=_numpy_batches(setup[name]["cfg"], n),
                           file=tmp / f"{name}.pt")
    torch.save(create_state(setup["accum"]["cfg"], device="cpu")
               .state_dict(), setup["accum"]["file"])
    setup["train"]["root"] = tmp
    gen = build_generator(setup["evaluate"]["cfg"].model, device="cpu",
                          seed=3)
    setup["evaluate"]["sd"] = gen.state_dict()
    torch.save(gen.state_dict(), tmp / "gen.pt")
    args = {name: dataclasses.asdict(setup[name]["cfg"]) for name in setup}
    jobs = {  # in order; "step" last, since its state comes from JAX
        "accum": (_job_steps, (args["accum"], str(setup["accum"]["file"]),
                               setup["accum"]["batches"])),
        "train": (_job_train, (args["train"], str(tmp))),
        "evaluate": (_job_evaluate, (args["evaluate"], str(tmp / "gen.pt"))),
        "slices": (_job_slices, ()),
        "step": (_job_steps, (args["step"], str(setup["step"]["file"]),
                              setup["step"]["batches"])),
    }
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), jobs, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jcfg = _jcfg(ATTN)
        jstate, state = _port_state_from_jax(jcfg)
        part = tmp / "step.pt.part"
        torch.save(state.state_dict(), part)
        part.rename(setup["step"]["file"])
        setup["step"]["jax"] = _jax_data2_step(
            jcfg, jstate, setup["step"]["batches"][0])
    finally:
        for p in procs:
            p.join(timeout=300)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
    errors = [f.read_text() for f in sorted(tmp.glob("error*.txt"))]
    assert not alive and not errors and all(
        p.exitcode == 0 for p in procs), (alive, errors,
                                          [p.exitcode for p in procs])
    results = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
               for r in range(WORLD)]
    return {name: dict(setup.get(name, {}), ranks=[res[name]
                                                   for res in results])
            for name in jobs}


def _assert_same(a: dict, b: dict, what: str):
    """Two states bit for bit: parameters, buffers (spectral vectors), the
    EMA and both Adams."""
    for part in ("g_params", "d_params", "g_ema"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (what, part, k)
    for part in ("g_opt", "d_opt"):
        for idx, st in a[part]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, b[part]["state"][idx][k]), (
                    what, part, idx, k)
    assert a["step"] == b["step"]


@pytest.mark.parametrize("mesh, n, want", [
    (dict(data=-1, model=2), 8, (4, 2, 1)),
    (dict(data=3, model=2), 8, (3, 2, 1)),
    (dict(data=-1, model=2, spatial=2), 8, (2, 2, 2)),
    (dict(data=5, model=2), 8, ValueError),
    (dict(data=-1, model=3), 8, ValueError),
    (dict(data=-1, model=2, spatial=3), 8, ValueError),
    (dict(data=-1), 1, (1, 1, 1)),
    (dict(data=2), 1, ValueError),
], ids=["model2", "prefix", "spatial", "too_big", "model_not_dividing",
        "product_not_dividing", "one", "two_of_one"])
def test_mesh_resolve_matches_jax(mesh, n, want):
    """The cases of tests/distributed/test_mesh_parity.py::
    test_mesh_construction through both packages' ``resolve``; the port
    builds every mesh for serving, its devices the first data × model ×
    spatial in order, and trains over it (a spatial axis included) with
    the same layout of the ranks."""
    from gan_inpainting_tpu.parallel.mesh import MeshConfig as JMeshConfig

    if want is ValueError:
        for m in (JMeshConfig(**mesh), MeshConfig(**mesh)):
            with pytest.raises(ValueError):
                m.resolve(n)
        return
    assert MeshConfig(**mesh).resolve(n) == JMeshConfig(**mesh).resolve(n) \
        == want
    devices = [torch.device("cpu")] * n
    built = build_mesh(MeshConfig(**mesh), devices)
    assert (built.data, len(built.devices)) == (
        want[0], want[0] * want[1] * want[2])
    if want[0] * want[1] * want[2] == n:
        ranks = train_mesh(MeshConfig(**mesh), n)
        assert (ranks.data, ranks.model, ranks.spatial) == want
        assert ranks.groups == build_mesh(MeshConfig(**mesh),
                                          range(n)).groups


def test_process_batch_slice_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.ensure_initialized("cpu") == 1
    assert not multihost.initialized()
    assert multihost.process_batch_slice(16) == (16, 0)
    assert multihost.process_batch_slice(3) == (3, 0)
    assert (multihost.rank(), multihost.world()) == (0, 1)
    assert multihost.is_main()


def test_process_batch_slice_two_ranks(ranks):
    for r, res in enumerate(ranks["slices"]["ranks"]):
        assert res["slice"] == (4, r * 1_000_003)
        assert res["mesh"] == WORLD
        want = torch.tensor([[1.0] * 3] * 2 + [[2.0] * 3] * 2,
                            dtype=torch.float16)
        assert torch.equal(res["gathered"], want)
        assert res["mean"] == {"a": 0.5, "b": 1.0}
        assert res["total"] == {"a": 1.0}


def test_local_rank_beyond_the_cards_raises(monkeypatch):
    from gan_inpainting_torch.ops.dispatch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device() == torch.device("cuda:1")
    assert resolve_device("cuda:0") == torch.device("cuda:0")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2"):
        resolve_device()
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device() == torch.device("cuda")


def test_two_rank_step_matches_one_process_and_jax(ranks):
    """One step of two ranks, each on its half of a global batch: equal to
    each other bit for bit, to one port process on the whole batch within
    ONE_PROCESS_REL, and to the JAX step on a data=2 mesh within the
    single-step tolerances of test_torch_train.py."""
    from test_torch_train import (
        METRIC_RTOL,
        PARAM_ATOL,
        _assert_params_close,
        _batches,
        _np,
    )

    from gan_inpainting_torch.io.convert import discriminator_from_jax
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    job = ranks["step"]
    (m0, s0), = job["ranks"][0]
    (m1, s1), = job["ranks"][1]
    _assert_same(s0, s1, "rank 0 vs rank 1")
    assert m0 == m1

    # one process, the whole batch
    cfg = job["cfg"]
    state = create_state(cfg, device="cpu")
    state.load_state_dict(torch.load(job["file"], weights_only=True))
    _, tb = _batches(*job["batches"][0])
    one = {k: float(v) for k, v in make_train_step(cfg)(state, tb).items()}
    assert set(one) == set(m0)
    for k in one:
        np.testing.assert_allclose(m0[k], one[k], rtol=ONE_PROCESS_REL,
                                   atol=1e-7, err_msg=k)
    ref = state.state_dict()
    for part in ("g_params", "d_params", "g_ema"):
        scale = max(v.abs().max().item() for v in ref[part].values())
        gap = max((s0[part][k] - v).abs().max().item()
                  for k, v in ref[part].items())
        assert gap <= ONE_PROCESS_REL * scale, (part, gap, scale)

    # JAX on a data=2 mesh of its virtual CPU devices
    jm, jstate = job["jax"]
    for k in jm:
        np.testing.assert_allclose(m0[k], jm[k], rtol=METRIC_RTOL,
                                   atol=1e-6, err_msg=k)
    _assert_params_close(s0["g_params"], _np(jstate.g_params), PARAM_ATOL)
    _assert_params_close(
        s0["d_params"], (_np(jstate.d_params), _np(jstate.d_stats)),
        PARAM_ATOL, convert=lambda t: discriminator_from_jax(*t))
    _assert_params_close(s0["g_ema"], _np(jstate.g_ema), PARAM_ATOL)


def test_ranks_bit_identical_with_accum_and_r1(ranks):
    """Two steps with gradient accumulation, R1 on every step, spectral
    norm, TV and the EMA: the ranks' parameters, spectral vectors, Adam
    states and EMA are equal bit for bit after each step, and they moved."""
    r0, r1 = ranks["accum"]["ranks"]
    start = torch.load(ranks["accum"]["file"], weights_only=True)
    for i, ((m0, s0), (m1, s1)) in enumerate(zip(r0, r1)):
        _assert_same(s0, s1, f"step {i}")
        assert m0 == m1 and m0["d_r1"] > 0 and m0["g_tv"] > 0
        assert s0["step"] == i + 1
    assert any(not torch.equal(start["d_params"][k], v)
               for k, v in r0[-1][1]["d_params"].items() if k.endswith("u"))


def test_two_rank_train_writes_once_and_resumes(ranks):
    """train() over two ranks: rank 0 alone writes (metrics, samples,
    checkpoints); images_per_sec counts the global batch; the ranks draw
    different batches; a resumed run ends where the uninterrupted one
    does, on both ranks."""
    job = ranks["train"]
    r0, r1 = job["ranks"]
    assert r0["writers"] == 3 and r1["writers"] == 0     # one per train()
    assert r0["saves"] == [2, 4, 2, 4] and r1["saves"] == []
    assert r0["first"].shape == r1["first"].shape
    assert not torch.equal(r0["first"], r1["first"])
    _assert_same(r0["whole"], r1["whole"], "rank 0 vs rank 1")
    _assert_same(r0["whole"], r0["resumed"], "whole vs resumed")
    _assert_same(r1["whole"], r1["resumed"], "whole vs resumed, rank 1")
    timed = ("steps_per_sec", "images_per_sec")     # each rank's clock
    assert {k: v for k, v in r0["scalars"].items() if k not in timed} == {
        k: v for k, v in r1["scalars"].items() if k not in timed}
    import json

    recs = [json.loads(ln) for ln in (job["root"] / "whole" / "metrics.jsonl")
            .read_text().splitlines()]
    logged = [r for r in recs if "g_loss" in r]
    assert [r["step"] for r in logged] == [1, 2, 3, 4]
    assert [r["step"] for r in recs if "eval_psnr" in r] == [2, 4]
    for r in logged:
        assert r["world_size"] == WORLD
        assert r["grad_all_reduces"] == 2 * r["step"]
        assert r["host_syncs_per_step"] == 0     # no card: nothing copied
        assert r["images_per_sec"] == pytest.approx(
            r["steps_per_sec"] * job["cfg"].data.batch_size)


def test_two_rank_evaluate_pools_the_rank_slices(ranks):
    """evaluate over two ranks equals, on every rank, the metrics of the
    ranks' slices pooled in one process: each rank's eval stream and masks,
    sums over both, SWD over the first ⌈3 / 2⌉ composites of each rank in
    rank order, cut to eval.swd_max_images = 3."""
    from gan_inpainting_torch.data.loader import make_dataset
    from gan_inpainting_torch.data.pipeline import make_train_batch
    from gan_inpainting_torch.metrics.swd import swd
    from gan_inpainting_torch.train.evaluate import make_eval_step
    from gan_inpainting_torch.utils.rng import STREAM_EVAL, stream_generator

    job = ranks["evaluate"]
    cfg = job["cfg"]
    got0, got1 = job["ranks"]
    assert got0 == got1
    eval_step = make_eval_step(cfg, "cpu")
    sums, reals, comps = {}, [], []
    local = cfg.data.eval_batch_size // WORLD
    for r in range(WORLD):
        it = make_dataset(cfg.data, seed=cfg.train.seed + r * 1_000_003,
                          split="eval", batch_size=local)
        rr, rc = [], []
        for i in range(cfg.data.num_eval_batches):
            batch = make_train_batch(
                next(it), stream_generator(777, STREAM_EVAL, i, extra=r),
                cfg.mask)
            res = eval_step(job["sd"], batch)
            rc.append(res.pop("_composite"))
            rr.append(batch.image.to(torch.float16))
            for k, v in res.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        reals.append(torch.cat(rr)[:2])
        comps.append(torch.cat(rc)[:2])
    count = cfg.data.num_eval_batches * cfg.data.eval_batch_size
    want = {k: v / count for k, v in sums.items()}
    gen = torch.Generator().manual_seed(1234)
    want.update({k: float(v) for k, v in swd(
        torch.cat(reals)[:3].float(), torch.cat(comps)[:3].float(),
        gen).items()})
    assert set(got0) == set(want) and "swd_avg" in want
    for k in want:
        assert got0[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k


def test_inpainter_over_two_cpu_replicas():
    """Two replicas: the bucket rounds up to a multiple of 2 and is split
    between them; known pixels exact, the output within 1 level of one
    replica's."""
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.models.generator import build_generator

    cfg = apply_overrides(get_config("celeba128_center"), TINY + ATTN + [
        "infer.size_buckets=32", "infer.batch_buckets=1,3"])
    sd = build_generator(cfg.model, device="cpu", seed=0).state_dict()
    one = Inpainter(cfg, sd, device="cpu")
    two = Inpainter(cfg, sd, devices=["cpu", "cpu"])
    assert two.devices == (torch.device("cpu"),) * 2
    seen = []
    real_run = two._run

    def run(i, fuse, images, masks, *rest):
        seen.append((i, images.shape[0]))
        return real_run(i, fuse, images, masks, *rest)

    two._run = run
    rng = np.random.default_rng(0)
    for b in (1, 3):
        imgs = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        masks = np.zeros((b, 32, 32), np.float32)
        masks[:, 8:24, 4:20] = 1
        seen.clear()
        got = two.inpaint_batch(imgs, masks)
        # 1 → bucket 1 → 2 (one image each); 3 → bucket 3 → 4 (2 each)
        shard = 1 if b == 1 else 2
        assert sorted(seen) == [(0, shard), (1, shard)]
        assert got.shape == imgs.shape
        assert np.array_equal(got[masks == 0], imgs[masks == 0])
        want = one.inpaint_batch(imgs, masks)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    two.close()
    with pytest.raises(ValueError, match="empty"):
        Inpainter(cfg, sd, devices=[])
