"""The mesh's model axis (``train.mesh.model``, ``model.tp_shard``) and
``model.remat_stages`` on the CPU: two spawned gloo ranks forming one model
group against one process and against the JAX package's step on a
``(data, model) = (1, 2)`` mesh of its virtual CPU devices; each sharded
conv kind against its whole layer, and the ``Inpainter`` over a group of
devices, through model groups of threads.

As in tests/test_torch_parallel.py, whose rank runner and helpers this
module reuses: one module-scoped spawn runs every rank job, the workers
import only torch, numpy and the port, and JAX is imported inside the
tests alone.
"""

import dataclasses
import multiprocessing
import pathlib
import pickle
import shutil
import threading

import numpy as np
import pytest
import torch
from test_torch_parallel import (
    ATTN,
    ONE_PROCESS_REL,
    WORLD,
    _assert_same,
    _cfg,
    _jcfg,
    _numpy_batches,
    _port_state_from_jax,
    _rank_main,
    _state_dict_cpu,
)

from gan_inpainting_torch.configs.base import config_from_dict
from gan_inpainting_torch.models.generator import (
    build_generator,
    sliced_parameters,
)
from gan_inpainting_torch.models.layers import InpaintConv
from gan_inpainting_torch.parallel import multihost
from gan_inpainting_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    train_mesh,
)
from gan_inpainting_torch.parallel.sharding import ThreadModelGroup, counts

MODEL2 = ["train.mesh.model=2", "model.tp_shard=true"]
ACCUM = ATTN + MODEL2 + ["train.grad_accum=2", "model.spectral_norm=true",
                         "loss.tv_weight=0.1"]
TRAIN = ATTN + ["data.synthetic_family=textured", "mask.kind=freeform",
                "eval.metrics=psnr,ssim,swd", "eval.swd_max_images=3",
                "train.checkpoint_every=2", "train.eval_every=2"]
# sharded layers against whole ones, float32: per tensor, max |a − b| ≤
# this · max |b| (the same sums split at the channel slices, and the input
# gradient's two partial sums added in another order)
LAYER_REL = 1e-5
# the remat step against the plain one: of max |g| per tensor (the same
# forward recomputed: the same values)
REMAT_REL = 1e-6


def _tp(cfg):
    """``cfg`` in one process: the model axis dropped, tp_shard kept (no
    group, so nothing shards)."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, mesh=MeshConfig()))


def _whole(arrays):
    from gan_inpainting_torch.data.pipeline import Batch

    image, mask = (torch.from_numpy(a) for a in arrays)
    return Batch(image, mask, image * (1 - mask))


# ---------------------------------------------------------------------------
# rank jobs (run in the spawned workers)
# ---------------------------------------------------------------------------


def _wait(path):
    import os
    import time

    for _ in range(1200):       # written by the main process, renamed whole
        if os.path.exists(path):
            return
        time.sleep(0.1)
    raise TimeoutError(path)


def _job_steps(cfg_dict, state_file, batches):
    """Steps of the model group on whole numpy batches from a saved state:
    per step the reduced metrics, the whole state and the channel gathers
    issued."""
    from gan_inpainting_torch.parallel.sharding import reduce_metrics
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    cfg = config_from_dict(cfg_dict)
    state = create_state(cfg, device="cpu")
    _wait(state_file)
    state.load_state_dict(torch.load(state_file, weights_only=True))
    step = make_train_step(cfg)
    out = []
    for arrays in batches:
        before = dict(counts)
        metrics = reduce_metrics(step(state, _whole(arrays)))
        out.append((metrics, _state_dict_cpu(state),
                    {k: counts[k] - before[k] for k in counts}))
    return out


def _job_remat(cfg_dict, batches):
    """One step from the seeded state with and without remat_stages: the
    states and the collectives each issued."""
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    out = {}
    for remat in (False, True):
        cfg = config_from_dict(cfg_dict)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat_stages=remat))
        state = create_state(cfg, device="cpu")
        before = dict(counts)
        make_train_step(cfg)(state, _whole(batches[0]))
        out[remat] = (_state_dict_cpu(state),
                      {k: counts[k] - before[k] for k in counts},
                      len(sliced_parameters(state.generator)) // 2)
    return out


def _job_train(cfg_dict, root):
    """train() of the model group: 2 steps with an eval and a checkpoint,
    resumed to 3; and a model=1 run's checkpoint resumed to 3 here."""
    from gan_inpainting_torch.train import loop

    cfg = config_from_dict(cfg_dict)
    first, writers = [], []
    real_batch, real_writer = loop.make_train_batch, loop.MetricsWriter

    def make_batch(*args, **kwargs):
        batch = real_batch(*args, **kwargs)
        if not first:
            first.append(batch.image.clone())
        return batch

    def writer(*args, **kwargs):
        writers.append(args)
        return real_writer(*args, **kwargs)

    loop.make_train_batch, loop.MetricsWriter = make_batch, writer

    def run(name, steps):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps=steps, workdir=str(pathlib.Path(root) / name)))
        state, _ = loop.train(c, device="cpu", verbose=False)
        return _state_dict_cpu(state)

    at2 = run("tp", 2)
    at3 = run("tp", 3)
    _wait(pathlib.Path(root) / "from1.done")
    if multihost.is_main():     # the model=1 run stays at step 2
        shutil.copytree(pathlib.Path(root) / "from1",
                        pathlib.Path(root) / "from1_tp")
    torch.distributed.barrier()
    from1 = run("from1_tp", 3)
    return dict(at2=at2, at3=at3, from1=from1, first=first[0],
                writers=len(writers))


def _job_evaluate(cfg_dict, sd_file):
    from gan_inpainting_torch.train.evaluate import evaluate

    return evaluate(config_from_dict(cfg_dict),
                    torch.load(sd_file, weights_only=True), device="cpu")


def _job_layout():
    """The batch slice, stream key and data-axis collectives of a
    (data, model) = (2, 1) and a (1, 2) world."""
    from gan_inpainting_torch.parallel.sharding import (
        all_gather_rows,
        model_group,
        reduce_metrics,
        use_mesh,
    )

    r = multihost.rank()
    rows = torch.full((2, 3), float(r + 1))
    out = {}
    for model in (1, 2):
        group = use_mesh(MeshConfig(model=model))
        out[model] = dict(
            slice=multihost.process_batch_slice(8),
            index=(multihost.data_index(), multihost.model_index()),
            group=None if group is None else (group.index, group.size),
            same_group=group is model_group(),
            gathered=all_gather_rows(rows),
            mean=reduce_metrics({"a": float(r)}))
    with pytest.raises(ValueError, match="needs more than the 2"):
        use_mesh(MeshConfig(data=2, model=2))
    return out


# ---------------------------------------------------------------------------
# the main process
# ---------------------------------------------------------------------------


def _jax_tp_step(jcfg, jstate, arrays):
    """JAX's train step with tp_shard on a (1, 2) mesh of its virtual CPU
    devices (as tests/distributed/test_mesh_parity.py runs it)."""
    import jax

    from gan_inpainting_tpu.parallel.mesh import MeshConfig as JMesh
    from gan_inpainting_tpu.parallel.mesh import build_mesh as j_build_mesh
    from gan_inpainting_tpu.parallel.sharding import replicated, shard_batch
    from gan_inpainting_tpu.train.step import make_train_step as j_make_step
    from test_torch_train import _batches

    mesh = j_build_mesh(JMesh(data=1, model=2), devices=jax.devices()[:2])
    jstate = jax.device_put(jstate, replicated(mesh))
    with jax.set_mesh(mesh):
        jstate, jm = j_make_step(jcfg, donate=False)(
            jstate, shard_batch(mesh, _batches(*arrays)[0]),
            jax.random.key(0))
    return ({k: float(v) for k, v in jm.items()}, jax.device_get(jstate))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks of one model group once and run every job;
    returns per job the ranks' results with what the main process set up.
    Meanwhile the main process converts JAX's state for the "step" job,
    trains the model=1 run the "train" job resumes, and takes JAX's step."""
    from gan_inpainting_torch.train.loop import train

    tmp = tmp_path_factory.mktemp("tp_ranks")
    setup = {name: dict(cfg=_cfg(o)) for name, o in (
        ("step", ATTN + MODEL2), ("remat", ACCUM),
        ("train", TRAIN + MODEL2),
        ("evaluate", ["eval.metrics=psnr,ssim,swd",
                      "data.num_eval_batches=2", "eval.swd_max_images=3",
                      "model.generator=coarse_to_fine",
                      "model.conv_kind=gated"] + MODEL2))}
    for name in ("step", "remat"):
        setup[name]["batches"] = _numpy_batches(setup[name]["cfg"], 1)
    setup["step"]["file"] = tmp / "step.pt"
    gen = build_generator(setup["evaluate"]["cfg"].model, device="cpu",
                          seed=3)
    setup["evaluate"]["sd"] = gen.state_dict()
    torch.save(gen.state_dict(), tmp / "gen.pt")
    args = {name: dataclasses.asdict(setup[name]["cfg"]) for name in setup}
    jobs = {  # in order: the jobs that wait on the main process last
        "layout": (_job_layout, ()),
        "evaluate": (_job_evaluate, (args["evaluate"], str(tmp / "gen.pt"))),
        "remat": (_job_remat, (args["remat"], setup["remat"]["batches"])),
        "step": (_job_steps, (args["step"], str(setup["step"]["file"]),
                              setup["step"]["batches"])),
        "train": (_job_train, (args["train"], str(tmp))),
    }
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), jobs, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # the mesh is JAX's step's argument, not its config's
        jcfg = _jcfg(ATTN + ["model.tp_shard=true"])
        jstate, state = _port_state_from_jax(jcfg)
        part = tmp / "step.pt.part"
        torch.save(state.state_dict(), part)
        part.rename(setup["step"]["file"])
        one = _tp(setup["train"]["cfg"])
        one = dataclasses.replace(one, train=dataclasses.replace(
            one.train, steps=2, workdir=str(tmp / "from1")))
        train(one, device="cpu", verbose=False)
        (tmp / "from1.done").touch()
        setup["train"]["one"] = one
        setup["step"]["jax"] = _jax_tp_step(jcfg, jstate,
                                            setup["step"]["batches"][0])
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
    return {name: dict(setup.get(name, {}), root=tmp,
                       ranks=[res[name] for res in results])
            for name in jobs}


def _close(a: dict, b: dict, rel: float, parts=("g_params", "d_params",
                                               "g_ema")):
    """Per part, the largest gap within ``rel`` of the largest entry."""
    for part in parts:
        scale = max(v.abs().max().item() for v in b[part].values())
        gap = max((a[part][k] - v).abs().max().item()
                  for k, v in b[part].items())
        assert gap <= rel * scale, (part, gap, scale)


@pytest.mark.parametrize("mesh, n, want", [
    (dict(data=-1, model=2), 8, ((0, 1), (2, 3), (4, 5), (6, 7))),
    (dict(data=3, model=2), 8, ((0, 1), (2, 3), (4, 5))),
    (dict(data=-1, model=4), 8, ((0, 1, 2, 3), (4, 5, 6, 7))),
    (dict(data=5, model=2), 8, ValueError),
    (dict(data=-1, model=3), 8, ValueError),
    (dict(data=-1, model=2, spatial=2), 8, ((0, 1, 2, 3), (4, 5, 6, 7))),
], ids=["model2", "prefix", "model4", "too_big", "model_not_dividing",
        "spatial"])
def test_model_axis_mesh_matches_jax(mesh, n, want):
    """build_mesh with a model axis against the JAX package's: the same
    axis sizes and the same devices in each group of a data index (its
    devices reshaped to (data, model, spatial)); the JAX ValueErrors; with
    a spatial axis each group holds model × spatial devices, spatial
    index fastest."""
    import jax

    from gan_inpainting_tpu.parallel.mesh import MeshConfig as JMesh
    from gan_inpainting_tpu.parallel.mesh import build_mesh as j_build_mesh

    if isinstance(want, type):
        with pytest.raises(want):
            build_mesh(MeshConfig(**mesh), range(n))
        with pytest.raises(ValueError):
            j_build_mesh(JMesh(**mesh), devices=jax.devices()[:n])
        return
    built = build_mesh(MeshConfig(**mesh), range(n))
    assert built.groups == want
    jmesh = j_build_mesh(JMesh(**mesh), devices=jax.devices()[:n])
    ids = {d.id: i for i, d in enumerate(jax.devices()[:n])}
    jgroups = tuple(tuple(ids[d.id] for d in row.reshape(-1))
                    for row in jmesh.devices)
    assert jgroups == want
    assert (built.data, built.model, built.spatial) == jmesh.devices.shape


def test_train_mesh_with_a_model_axis():
    assert train_mesh(MeshConfig(model=2), 4).groups == ((0, 1), (2, 3))
    assert train_mesh(MeshConfig(data=2, model=2), 4).data == 2
    with pytest.raises(ValueError, match="data must be -1 or 2"):
        train_mesh(MeshConfig(data=1, model=2), 4)
    with pytest.raises(ValueError, match="not divisible by model"):
        train_mesh(MeshConfig(model=2), 3)


def test_layout_slices_streams_and_data_collectives(ranks):
    """(data, model) = (2, 1): each rank its half of the batch from a
    stream of its own, as before the model axis; (1, 2): both ranks the
    whole batch from data index 0's stream, one model group, and the
    pooled rows and metrics its member 0's (SWD rows counted once, the
    same numbers on every rank)."""
    for r, res in enumerate(ranks["layout"]["ranks"]):
        dp, tp = res[1], res[2]
        assert dp["slice"] == (4, r * 1_000_003)
        assert dp["index"] == (r, 0) and dp["group"] is None
        assert dp["gathered"].shape == (4, 3)
        assert dp["mean"] == {"a": 0.5}
        assert tp["slice"] == (8, 0)
        assert tp["index"] == (0, r) and tp["group"] == (r, 2)
        assert tp["same_group"]
        # member 0's rows and values, on both ranks
        assert torch.equal(tp["gathered"], torch.full((2, 3), 1.0))
        assert tp["mean"] == {"a": 0.0}


def test_model_group_step_matches_one_process_and_jax(ranks):
    """One tp_shard step of the (1, 2) model group on the whole batch: the
    ranks equal bit for bit, equal to one unsharded process within
    ONE_PROCESS_REL, and to JAX's tp_shard step on a (1, 2) mesh within
    test_torch_train.py's single-step tolerances. Each sharded conv
    gathers twice (the D step's forward and the G step's), its input
    gradient is summed once, and each network's gradients are reduced
    over the model group once."""
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
    (m0, s0, c0), = job["ranks"][0]
    (m1, s1, c1), = job["ranks"][1]
    _assert_same(s0, s1, "rank 0 vs rank 1")
    assert m0 == m1 and c0 == c1

    cfg = _tp(job["cfg"])
    state = create_state(cfg, device="cpu")
    state.load_state_dict(torch.load(job["file"], weights_only=True))
    n_sharded = len(sliced_parameters(state.generator)) // 2
    assert n_sharded == 0            # one process: nothing shards
    _, tb = _batches(*job["batches"][0])
    one = {k: float(v) for k, v in make_train_step(cfg)(state, tb).items()}
    assert set(one) == set(m0)
    for k in one:
        np.testing.assert_allclose(m0[k], one[k], rtol=ONE_PROCESS_REL,
                                   atol=1e-7, err_msg=k)
    _close(s0, state.state_dict(), ONE_PROCESS_REL)
    group = ThreadModelGroup.members(2)[0]
    n_sharded = len(sliced_parameters(build_generator(
        job["cfg"].model, device="cpu", model_group=group))) // 2
    assert c0["channel_gathers"] == 2 * n_sharded > 0
    assert c0["input_grad_all_reduces"] > 0
    assert c0["model_grad_reduces"] == 2 and c0["all_reduce_mean_"] == 2

    jm, jstate = job["jax"]
    for k in jm:
        np.testing.assert_allclose(m0[k], jm[k], rtol=METRIC_RTOL,
                                   atol=1e-6, err_msg=k)
    _assert_params_close(s0["g_params"], _np(jstate.g_params), PARAM_ATOL)
    _assert_params_close(
        s0["d_params"], (_np(jstate.d_params), _np(jstate.d_stats)),
        PARAM_ATOL, convert=lambda t: discriminator_from_jax(*t))
    _assert_params_close(s0["g_ema"], _np(jstate.g_ema), PARAM_ATOL)


def test_model_group_remat_accum_sn(ranks):
    """grad_accum 2, spectral norm, TV, R1 and the EMA over the model
    group, with and without remat_stages: the ranks bit-identical, remat
    within REMAT_REL of the plain step, and its recomputed forward
    reissuing every gather of the G step (2 → 3 per conv and micro-batch:
    the D step's forward takes no gradient, so it is not checkpointed)."""
    r0, r1 = ranks["remat"]["ranks"]
    for remat in (False, True):
        _assert_same(r0[remat][0], r1[remat][0], f"remat={remat}")
    plain, with_remat = r0[False], r0[True]
    _close(with_remat[0], plain[0], REMAT_REL)
    n = plain[2]
    assert plain[1]["channel_gathers"] == 2 * 2 * n
    assert with_remat[1]["channel_gathers"] == 2 * 3 * n
    assert with_remat[1]["input_grad_all_reduces"] == \
        plain[1]["input_grad_all_reduces"]


def test_model_group_train_evaluates_and_resumes(ranks):
    """train() over the model group: rank 0 alone writes, both ranks draw
    the same batch, the record counts the gathers and their bytes per
    step; resumed to step 3 bit for bit on both ranks; a model=1 run's
    checkpoint resumes at model=2 close to the model=1 resume, and the
    model=2 checkpoint loads into one process bit for bit."""
    import json

    from gan_inpainting_torch.io.checkpoint import CheckpointManager
    from gan_inpainting_torch.train.loop import train
    from gan_inpainting_torch.train.state import create_state

    job = ranks["train"]
    r0, r1 = job["ranks"]
    assert r0["writers"] == 3 and r1["writers"] == 0
    assert torch.equal(r0["first"], r1["first"])
    for k in ("at2", "at3", "from1"):
        _assert_same(r0[k], r1[k], k)
    recs = [json.loads(ln) for ln in (job["root"] / "tp" / "metrics.jsonl")
            .read_text().splitlines()]
    logged = [r for r in recs if "g_loss" in r]
    assert [r["step"] for r in logged] == [1, 2, 3]
    assert [r["step"] for r in recs if "eval_swd_avg" in r] == [2, 3]
    per_step = logged[0]["channel_gather_bytes_per_step"]
    for r in logged:
        assert r["world_size"] == 2 and r["model_axis"] == 2
        assert r["channel_gather_bytes_per_step"] == per_step > 0
    assert logged[1]["channel_gathers"] == 2 * logged[0]["channel_gathers"]

    # the model=2 checkpoint in one process, bit for bit
    one = job["one"]
    state = create_state(one, device="cpu")
    CheckpointManager(str(job["root"] / "tp")).restore(state, step=2)
    _assert_same(_state_dict_cpu(state), r0["at2"], "model=2 checkpoint")
    # the model=1 checkpoint resumed at model=2 against model=1
    more = dataclasses.replace(one, train=dataclasses.replace(
        one.train, steps=3))
    state, _ = train(more, device="cpu", verbose=False)
    _close(r0["from1"], _state_dict_cpu(state), ONE_PROCESS_REL)


def test_model_group_evaluate_matches_one_process(ranks):
    """evaluate at model=2: the same images once (data axis of 1), so
    PSNR, SSIM and SWD of model=1 in one process, to float32 sums in
    another order."""
    from gan_inpainting_torch.train.evaluate import evaluate

    job = ranks["evaluate"]
    got0, got1 = job["ranks"]
    assert got0 == got1 and "swd_avg" in got0
    want = evaluate(_tp(job["cfg"]), job["sd"], device="cpu")
    assert set(got0) == set(want)
    for k in want:
        assert got0[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k


# ---------------------------------------------------------------------------
# in one process: model groups of threads
# ---------------------------------------------------------------------------


def _members(fn, n=2):
    """``fn(group)`` on n threads, one per member; their results."""
    groups = ThreadModelGroup.members(n, timeout=60.0)
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = fn(groups[i])
        except BaseException as e:  # noqa: BLE001 — asserted below
            groups[i].abort()
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


@pytest.mark.parametrize("kind, kwargs", [
    ("plain", dict(kernel_size=3)),
    ("plain_s2", dict(kernel_size=3, stride=2)),
    ("gated", dict(kernel_size=3, conv_kind="gated", dilation=2)),
    ("gated_s2", dict(kernel_size=3, conv_kind="gated", stride=2)),
    ("partial", dict(kernel_size=3, conv_kind="partial", dilation=2)),
    ("s2d", dict(kernel_size=5, conv_kind="gated", s2d=True)),
    ("pre_upsample", dict(kernel_size=3, conv_kind="gated",
                          pre_upsample=True)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_sharded_conv_kind_matches_whole_layer(kind, kwargs):
    """Each conv kind and rewrite sharded over two members: every member's
    output equals the whole layer's, its input gradient too (the partial
    sums added), and the sliced weight gradients summed over the members
    are the whole layer's."""
    cin, feats = 12, 16
    whole = InpaintConv(cin, feats, compute_dtype=torch.float32, **kwargs)
    whole.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        whole.bias.normal_(generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, cin))
                         .astype(np.float32))
    valid = torch.from_numpy((rng.random((2, 16, 16, 1)) > 0.3)
                             .astype(np.float32))
    g_out = None

    def grads(layer, x):
        nonlocal g_out
        x = x.clone().requires_grad_(True)
        y, v = layer(x, valid)
        if g_out is None:
            g_out = torch.from_numpy(np.random.default_rng(1)
                                     .standard_normal(tuple(y.shape))
                                     .astype(np.float32))
        return (y, v) + torch.autograd.grad(
            y, [x, layer.weight, layer.bias], g_out)

    want = grads(whole, x)

    def member(group):
        layer = InpaintConv(cin, feats, compute_dtype=torch.float32,
                            model_group=group, **kwargs)
        layer.load_state_dict(whole.state_dict())
        return grads(layer, x)

    got = _members(member)
    assert torch.equal(got[0][0], got[1][0])
    for i, name in enumerate(("y", "valid", "dx")):
        if want[i] is None:
            assert got[0][i] is None
            continue
        gap = (got[0][i] - want[i]).abs().max().item()
        assert gap <= LAYER_REL * want[i].abs().max().item(), (name, gap)
        assert torch.equal(got[0][i], got[1][i]), name
    for i in (3, 4):          # weight, bias: zero off each member's rows
        total = got[0][i] + got[1][i]
        assert ((got[0][i] != 0) & (got[1][i] != 0)).sum() == 0
        gap = (total - want[i]).abs().max().item()
        assert gap <= LAYER_REL * want[i].abs().max().item(), gap


def test_thread_model_group_exchanges_under_contention():
    """Eight members (as many as a large card group) exchanging 200 times
    each with a short switch interval: every gather is every member's
    tensor of that round in member order, every sum the round's sum, on
    every member: no member overwrites a slot another still reads."""
    import sys

    n, rounds = 8, 200
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def member(group):
            bad = 0
            for i in range(rounds):
                got = group.gather(torch.full((2, 3), float(
                    100 * i + group.index)))
                want = torch.arange(n, dtype=torch.float32).repeat_interleave(
                    3) + 100 * i
                bad += not torch.equal(got, want.expand(2, -1))
                t = torch.tensor([float(i + group.index)])
                group.all_reduce_(t)
                bad += t.item() != n * i + n * (n - 1) / 2
            return bad

        assert _members(member, n) == [0] * n
    finally:
        sys.setswitchinterval(prev)


def test_unsplittable_layer_raises_with_its_name():
    cfg = _cfg(ATTN + MODEL2)
    three = ThreadModelGroup.members(3)[0]
    with pytest.raises(ValueError, match=r"coarse\.conv0: 8 output features"):
        build_generator(cfg.model, device="cpu", model_group=three)
    # tp_shard off, or a group of one: nothing shards
    off = dataclasses.replace(cfg.model, tp_shard=False)
    assert not sliced_parameters(build_generator(off, device="cpu",
                                                 model_group=three))
    one = ThreadModelGroup.members(1)[0]
    assert not sliced_parameters(build_generator(cfg.model, device="cpu",
                                                 model_group=one))


def test_remat_stages_gradients_match():
    """A float32 G loss's gradients with and without remat_stages within
    REMAT_REL of max|g| per tensor; each of the five stacks checkpointed
    where a gradient is taken, none under no_grad."""
    from gan_inpainting_torch.losses.reconstruction import l1_loss
    from gan_inpainting_torch.models import generator as gen_mod

    cfg = _tp(_cfg(ATTN))
    image, mask = (torch.from_numpy(a) for a in _numpy_batches(cfg, 1)[0])
    masked = image * (1 - mask)
    calls = []
    real = gen_mod.checkpoint

    def counted(*args, **kwargs):
        calls.append(kwargs["use_reentrant"])
        return real(*args, **kwargs)

    out = {}
    gen_mod.checkpoint = counted
    try:
        for remat in (False, True):
            mc = dataclasses.replace(cfg.model, remat_stages=remat)
            gen = build_generator(mc, device="cpu", seed=0)
            res = gen(masked, mask)
            loss = l1_loss(res.fine, image, mask) + l1_loss(res.coarse,
                                                            image, mask)
            out[remat] = torch.autograd.grad(loss, list(gen.parameters()))
            with torch.no_grad():
                gen(masked, mask)
    finally:
        gen_mod.checkpoint = real
    assert calls == [False] * 5
    for a, b in zip(out[True], out[False]):
        assert (a - b).abs().max() <= REMAT_REL * b.abs().max()


def _serve_cfg(overrides):
    return _cfg(overrides + ["infer.size_buckets=32,64",
                             "infer.fuse_upsample_max_size=32",
                             "infer.batch_buckets=1,3"])


@pytest.mark.parametrize("overrides", [
    ATTN + ["model.fuse_upsample=true"],
    ["model.conv_kind=partial", "model.dtype_policy=f32"],
], ids=["serve_v4_8_tiny", "partial_dilated"])
def test_inpainter_over_a_model_group(overrides):
    """An Inpainter whose replicas are groups of two devices against one
    replica at model=1: known pixels exact, the rest within 1 level, at a
    fused-decoder and an unfused size; 4 devices are 2 groups (the bucket
    rounds up to a multiple of 2), ``device=`` runs a group on one
    device, and a count not divisible by the model axis raises the mesh's
    ValueError."""
    from gan_inpainting_torch.infer.inpaint import Inpainter

    one_cfg = _serve_cfg(overrides)
    cfg = _serve_cfg(overrides + MODEL2)
    sd = build_generator(one_cfg.model, device="cpu", seed=0).state_dict()
    one = Inpainter(one_cfg, sd, device="cpu")
    pair = Inpainter(cfg, sd, devices=["cpu", "cpu"])
    quad = Inpainter(cfg, sd, devices=["cpu"] * 4)
    pinned = Inpainter(cfg, sd, device="cpu")
    assert len(pair.groups) == 1 and len(pair.groups[0]) == 2
    assert len(quad.groups) == 2 and len(pinned.groups[0]) == 2
    rng = np.random.default_rng(0)
    seen = []
    real_run = quad._run

    def run(i, fuse, images, *rest):
        seen.append((i, images.shape[0]))
        return real_run(i, fuse, images, *rest)

    quad._run = run
    for b, s in ((1, 32), (3, 64), (3, 40)):
        imgs = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
        masks = np.zeros((b, s, s), np.float32)
        masks[:, s // 4:3 * s // 4, 4:s // 2] = 1
        want = one.inpaint_batch(imgs, masks)
        for inp in (pair, quad, pinned):
            got = inp.inpaint_batch(imgs, masks)
            assert got.shape == imgs.shape
            assert np.array_equal(got[masks == 0], imgs[masks == 0])
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # 1 → 2 (one each); 3 → 4 (two each)
    assert sorted(seen) == [(0, 1), (0, 2), (0, 2), (1, 1), (1, 2), (1, 2)]
    for inp in (pair, quad, pinned, one):
        inp.close()
    with pytest.raises(ValueError, match="not divisible by model"):
        Inpainter(cfg, sd, devices=["cpu"] * 3)


def test_inpainter_group_failure_raises_and_recovers():
    """A member that fails mid-forward: the request raises the member's
    own error (not the others' broken exchange), and the group serves the
    next request."""
    from gan_inpainting_torch.infer.inpaint import Inpainter

    cfg = _serve_cfg(ATTN + MODEL2)
    sd = build_generator(cfg.model, device="cpu", seed=0).state_dict()
    inp = Inpainter(cfg, sd, devices=["cpu", "cpu"])
    imgs = np.zeros((1, 32, 32, 3), np.uint8)
    masks = np.ones((1, 32, 32), np.float32)
    inp.inpaint_batch(imgs, masks)
    fuse = inp._cfg_for_size(32).model.fuse_upsample
    conv = inp._forwards[0][1](fuse).generator.refine_dec.conv1
    real = conv.forward

    def broken(*args):
        raise RuntimeError("member 1 failed")

    conv.forward = broken
    with pytest.raises(RuntimeError, match="member 1 failed"):
        inp.inpaint_batch(imgs, masks)
    conv.forward = real
    assert inp.inpaint_batch(imgs, masks).shape == imgs.shape
    inp.close()
