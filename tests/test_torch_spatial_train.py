"""Training and evaluating over the mesh's spatial axis on the CPU.

The row exchanges' first and second derivatives on spatial groups of
threads (parallel/spatial.py ``ThreadSpatialGroup``) against autograd on
the whole map, with halos taller than a band and the map's edge members;
then four spawned gloo ranks, as tests/test_torch_tensor_parallel.py
spawns its two: first as two worlds of two (each one spatial group of a
``train.mesh.spatial=2`` run), then as one world of four (``(data,
spatial) = (2, 2)`` and ``(model, spatial) = (2, 2)``). The ranks' train
steps are held against the JAX package's step on ``(1, 1, 2)`` and
``(2, 1, 2)`` meshes of its virtual CPU devices and against the port's
one process on the whole batch; the exchanges of ranks
(``ProcessSpatialGroup``) against those of threads; a size with no band
form runs unsharded; ``evaluate`` and ``train()`` over the axis. The
workers import only torch, numpy and the port; JAX runs in the main
process while they work.
"""

import contextlib
import copy
import dataclasses
import multiprocessing
import os
import pathlib
import pickle
import threading
import time
import traceback

import numpy as np
import pytest
import torch
from test_torch_parallel import ATTN, _cfg, _jcfg, _state_dict_cpu

from gan_inpainting_torch.configs.base import config_from_dict
from gan_inpainting_torch.parallel.sharding import counts
from gan_inpainting_torch.parallel.spatial import (
    ThreadSpatialGroup,
    add_spill,
    gather_rows,
    group_sum,
    halo,
    reduce_rows,
)

SPATIAL2 = ["train.mesh.spatial=2"]
# the step's cases: JAX's tiny_config (dilated, plain convs, BCE); the
# gated coarse-to-fine generator with contextual attention on the sharded
# route (the 8-row 1/4-res map in bands of 4 cell-aligned rows), lazy R1
# on step 0, the spatial discount, TV and feature matching; a tiny
# partialconv256 (partial convs, VGG perceptual and style, TV)
CASES = {
    "tiny": [],
    "attention": ATTN + ["loss.r1_interval=2", "loss.spatial_discount=0.9",
                         "loss.tv_weight=0.1",
                         "loss.feature_match_weight=10.0"],
    "partial": ["model.conv_kind=partial", "loss.adversarial=hinge",
                "loss.gan_weight=0.0", "loss.l1_hole_weight=6.0",
                "loss.perceptual_weight=0.05", "loss.style_weight=120.0",
                "loss.tv_weight=0.1"],
}
MODEL2 = ["train.mesh.model=2", "model.tp_shard=true"]
# a size with no band form: 24 rows in bands of 12, which the third
# stride-2 conv of a 3-layer discriminator cannot halve evenly
UNALIGNED = ["data.image_size=24", "model.disc_layers=3"]
EVAL = ["model.generator=coarse_to_fine", "model.conv_kind=gated",
        "model.use_attention=true", "eval.metrics=psnr,ssim,swd",
        "data.num_eval_batches=2", "eval.swd_max_images=3"]
TRAIN = ATTN + ["loss.r1_interval=2", "data.synthetic_family=textured",
                "mask.kind=freeform", "train.eval_every=2",
                "train.checkpoint_every=2", "eval.metrics=psnr,ssim"]
# against JAX's step on the same mesh shape: the limits of JAX's own
# spatial test (tests/distributed/test_spatial.py, its mesh against one
# device): metrics rtol, G parameters atol
JAX_RTOL, JAX_ATOL = 5e-4, 5e-4
# against the port's one process on the whole batch, float32: the metrics
# within rtol (the same sums, split at the bands and added back over the
# group in another order), the parameters within
# tests/test_torch_train.py's PARAM_ATOL (an Adam update is
# lr·m/(√v + ε), so where a gradient is near 0 its rounding noise can move
# a parameter by a fraction of lr = 1e-4…4e-4)
ONE_RTOL, ONE_ATOL = 1e-5, 2e-6
# the partial case runs its VGG trunk in bfloat16 (both packages do), and
# a band's convs round a feature one bf16 step apart from the whole map's
# here and there: its metrics within
# tests/test_torch_train.py::test_partialconv_train_step_matches_jax's
# rtol against JAX, and where a gradient is near 0 the sign of an Adam
# update can differ, so a G parameter moves at most 2·g_lr apart per step
# (the D parameters see no VGG: ONE_ATOL). The same case with a float32
# trunk ("partial32") is held to ONE_RTOL / ONE_ATOL throughout.
PARTIAL_RTOL, PARTIAL_MAX = 1e-4, 2 * 2 * 1e-4 * 1.05
# the first step's reduced gradients against one process's, leaf by leaf,
# relative to the leaf's and the optimizer's largest magnitude: float32
# reordering (measured ≤ 1.1e-5), and the partial case's G gradients,
# which pass through its bf16 VGG trunk, within a bf16 step (measured
# ≤ 8.5e-4 of the leaf)
GRAD_RTOL, PARTIAL_GRAD_RTOL = 5e-5, 2.0 ** -8
# the exchanges' derivatives against whole-map autograd, float64
EXCHANGE_ATOL = 1e-12


# ---------------------------------------------------------------------------
# the exchanges' derivatives (threads, float64)
# ---------------------------------------------------------------------------


def _threads(n, fn, timeout=60.0):
    """``fn(group)`` on n threads, one per member of a spatial group;
    their results in member order."""
    groups = ThreadSpatialGroup.members(n, timeout=timeout)
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


def _pad_rows(x, lo, hi):
    return torch.nn.functional.pad(x, (0, 0, 0, 0, lo, hi))


def _whole_halo(xs, lo, hi):
    n, bh = len(xs), xs[0].shape[1]
    pad = _pad_rows(torch.cat(xs, 1), lo, hi)
    return [pad[:, i * bh:i * bh + lo + bh + hi] for i in range(n)]


def _whole_spill(es, up, down):
    n, bh = len(es), es[0].shape[1] - up - down
    total = sum(_pad_rows(e, i * bh, (n - 1 - i) * bh)
                for i, e in enumerate(es))
    return [total[:, up + i * bh:up + (i + 1) * bh] for i in range(n)]


def _whole_reduce(gs):
    n, bh = len(gs), gs[0].shape[1] // len(gs)
    total = sum(gs)
    return [total[:, i * bh:(i + 1) * bh] for i in range(n)]


# (name, member function, whole-map function, member input rows of a
# band of bh rows)
EXCHANGES = {
    "halo": (lambda x, g, a, b: halo(x, g, a, b),
             lambda xs, a, b: _whole_halo(xs, a, b),
             lambda bh, a, b, n: bh),
    "add_spill": (lambda e, g, a, b: add_spill(e, g, a, b),
                  lambda es, a, b: _whole_spill(es, a, b),
                  lambda bh, a, b, n: a + bh + b),
    "gather_rows": (lambda x, g, a, b: gather_rows(x, g),
                    lambda xs, a, b: [torch.cat(xs, 1)] * len(xs),
                    lambda bh, a, b, n: bh),
    "reduce_rows": (lambda x, g, a, b: reduce_rows(x, g),
                    lambda xs, a, b: _whole_reduce(xs),
                    lambda bh, a, b, n: n * bh),
    "group_sum": (lambda x, g, a, b: group_sum(x, g),
                  lambda xs, a, b: [sum(xs)] * len(xs),
                  lambda bh, a, b, n: bh),
}
# (n, band rows, rows above, rows below): bands taller and shorter than
# the halo or spill (several hops), one-row bands, a one-sided halo
SHAPES = [(2, 4, 1, 2), (3, 2, 3, 5), (4, 1, 2, 0)]


def _exchange_inputs(name, n, bh, a, b, seed=0):
    rng = np.random.default_rng(seed)
    rows = EXCHANGES[name][2](bh, a, b, n)
    xs = [rng.standard_normal((2, rows, 3, 2)) for _ in range(n)]
    out_rows = {"halo": a + bh + b, "add_spill": bh,
                "gather_rows": n * bh, "reduce_rows": bh,
                "group_sum": rows}[name]
    cs = [rng.standard_normal((2, out_rows, 3, 2)) for _ in range(n)]
    ds = [rng.standard_normal((2, rows, 3, 2)) for _ in range(n)]
    return xs, cs, ds


def _derivatives(name, member, group, x, c, d, a, b):
    """This member's first and second derivatives: L = Σ c·tanh(y) of its
    exchange's output, then S = Σ d·(∂L/∂x)² — each summed over the
    group by the exchanges themselves."""
    x = torch.from_numpy(x).requires_grad_(True)
    y = member(x, group, a, b)
    loss = (torch.from_numpy(c) * torch.tanh(y)).sum()
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    (gg,) = torch.autograd.grad((torch.from_numpy(d) * g * g).sum(), x)
    return y.detach(), g.detach(), gg


def _reference(name, xs, cs, ds, a, b):
    whole = EXCHANGES[name][1]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    ys = whole(leaves, a, b)
    loss = sum((torch.from_numpy(c) * torch.tanh(y)).sum()
               for c, y in zip(cs, ys))
    gs = torch.autograd.grad(loss, leaves, create_graph=True)
    second = sum((torch.from_numpy(d) * g * g).sum() for d, g in zip(ds, gs))
    ggs = torch.autograd.grad(second, leaves)
    return ([y.detach() for y in ys], [g.detach() for g in gs], ggs)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "n{}_h{}_{}_{}"
                         .format(*s))
@pytest.mark.parametrize("name", list(EXCHANGES))
def test_exchange_derivatives_match_the_whole_map(name, shape):
    """Each exchange as an autograd function over a group of threads: its
    output, its gradient (the transpose: halo ↔ spill add, gather ↔
    reduce-scatter, group sum ↔ group sum) and a second derivative taken
    through the gradient's own exchanges, on every member (the edge
    members' zero rows beyond the map included), against autograd on the
    whole map, float64."""
    n, bh, a, b = shape
    xs, cs, ds = _exchange_inputs(name, n, bh, a, b)
    member = EXCHANGES[name][0]
    got = _threads(n, lambda g: _derivatives(
        name, member, g, xs[g.index], cs[g.index], ds[g.index], a, b))
    want = _reference(name, xs, cs, ds, a, b)
    for i in range(n):
        for j, part in enumerate(("y", "dx", "d2x")):
            gap = (got[i][j] - want[j][i]).abs().max().item()
            assert gap <= EXCHANGE_ATOL, (name, i, part, gap)


def test_band_forms_of_the_discriminator_and_vgg_match_the_whole_map():
    """The discriminator (5×5 stride-2 convs, the stride-1 head) and the
    VGG trunk (3×3 convs, 2×2 pools) on row bands of a group of two:
    every band's output rows are the whole map's, and their input
    gradients through the halos' backward the whole map's, float32."""
    from gan_inpainting_torch.losses.perceptual import init_vgg
    from gan_inpainting_torch.models.discriminator import PatchDiscriminator
    from gan_inpainting_torch.models.layers import SNConv
    from gan_inpainting_torch.parallel.spatial import band, row_bands

    gen = torch.Generator().manual_seed(0)
    disc = PatchDiscriminator(8, 3, spectral_norm=True,
                              compute_dtype=torch.float32)
    for m in disc.modules():
        if isinstance(m, SNConv):
            m.reset_parameters(gen)
    vgg = init_vgg(compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 24, 3))
                             .astype(np.float32))
    mask = torch.from_numpy((rng.random((2, 32, 24, 1)) < 0.3)
                            .astype(np.float32))

    def run(group, x, m):
        # each member its own modules, as each rank holds its own
        d, v = copy.deepcopy(disc), copy.deepcopy(vgg)
        x = x.clone().requires_grad_(True)
        with row_bands(group, d, v):
            logits = d(x, m)
            feats = v(x)
        outs = [logits] + feats
        loss = sum((o * o).sum() for o in outs)
        (dx,) = torch.autograd.grad(loss, x)
        return [o.detach() for o in outs], dx

    want, want_dx = run(None, image, mask)
    got = _threads(2, lambda g: run(g, band(image, g), band(mask, g)))
    for i, (outs, dx) in enumerate(got):
        for o, w in zip(outs, want):
            h = o.shape[1]
            assert torch.allclose(o, w[:, i * h:(i + 1) * h], rtol=1e-5,
                                  atol=1e-5)
        h = dx.shape[1]
        assert torch.allclose(dx, want_dx[:, i * h:(i + 1) * h], rtol=1e-4,
                              atol=1e-5)


def test_rows_split_names_the_layers_that_need_even_bands():
    from gan_inpainting_torch.parallel.spatial import splits
    from gan_inpainting_torch.train.step import band_multiple

    def rows_split(cfg, rows, n):
        return splits(rows, n, band_multiple(cfg))

    tiny = _cfg([])                      # disc_layers 2: bands of 4
    assert band_multiple(tiny) == 4
    assert rows_split(tiny, 32, 2) and rows_split(tiny, 32, 8)
    assert not rows_split(tiny, 32, 1) and not rows_split(tiny, 36, 2)
    assert not rows_split(_cfg(UNALIGNED), 24, 2)
    vgg = _cfg(CASES["partial"])         # the trunk's pools: bands of 8
    assert band_multiple(vgg) == 8
    assert rows_split(vgg, 32, 2) and not rows_split(vgg, 32, 8)
    # the generators alone (serving, evaluate): bands of 4
    assert splits(32, 8) and not splits(36, 2) and not splits(32, 1)


# ---------------------------------------------------------------------------
# rank jobs (run in the spawned workers)
# ---------------------------------------------------------------------------


def _wait(path):
    for _ in range(3000):       # written by the main process, renamed whole
        if os.path.exists(path):
            return
        time.sleep(0.1)
    raise TimeoutError(path)


def _slice(arrays, cfg):
    """This rank's data slice of a numpy global batch, as a Batch."""
    from gan_inpainting_torch.data.pipeline import Batch
    from gan_inpainting_torch.parallel import multihost

    n, i = multihost.data_size(), multihost.data_index()
    image, mask = (torch.from_numpy(a[i * (len(a) // n):
                                      (i + 1) * (len(a) // n)])
                   for a in arrays)
    return Batch(image, mask, image * (1 - mask))


@contextlib.contextmanager
def _first_grads(step_mod, into: list):
    """Within the block, keep the step's first two reduced gradient lists
    (the first step's D, then G), as ``all_reduce_mean_`` leaves them: the
    spatial group's sum (or mean, unsharded), then the data axis's mean."""
    real = step_mod.all_reduce_mean_

    def recording(grads, *args, **kwargs):
        real(grads, *args, **kwargs)
        if len(into) < 2:
            into.append([g.detach().float().clone() for g in grads])

    step_mod.all_reduce_mean_ = recording
    try:
        yield
    finally:
        step_mod.all_reduce_mean_ = real


def _job_steps(cfg_dict, state_file, batches, vgg_file=None,
               vgg_f32=False):
    """Steps of this rank's spatial group on its data slice of numpy
    global batches from a saved state: per step the reduced metrics and
    the collectives issued, then the whole state with the first step's
    reduced gradients."""
    import gan_inpainting_torch.train.step as step_mod
    from gan_inpainting_torch.losses.perceptual import VGG16Features
    from gan_inpainting_torch.parallel.sharding import reduce_metrics
    from gan_inpainting_torch.train.state import create_state

    cfg = config_from_dict(cfg_dict)
    state = create_state(cfg, device="cpu")
    if state_file is not None:
        _wait(state_file)
        state.load_state_dict(torch.load(state_file, weights_only=True))
    if vgg_file is not None:
        _wait(vgg_file)
        sd = torch.load(vgg_file, weights_only=True)

        def same_vgg(path, device=None):
            vgg = VGG16Features(compute_dtype=torch.float32 if vgg_f32
                                else torch.bfloat16)
            vgg.load_state_dict(sd)
            return vgg.to(device).requires_grad_(False)

        step_mod.init_vgg = same_vgg
    step = step_mod.make_train_step(cfg)
    out, grads = [], []
    with _first_grads(step_mod, grads):
        for arrays in batches:
            before = dict(counts)
            metrics = reduce_metrics(step(state, _slice(arrays, cfg)))
            out.append((metrics, {k: counts[k] - before[k] for k in counts}))
    return out, dict(_state_dict_cpu(state), first_grads=grads)


def _job_exchanges():
    """Every exchange and its derivatives on this rank's spatial group (a
    ``ProcessSpatialGroup``), float64, for each case of the thread test."""
    from gan_inpainting_torch.parallel.mesh import MeshConfig
    from gan_inpainting_torch.parallel.sharding import (
        spatial_group,
        use_mesh,
    )

    use_mesh(MeshConfig(spatial=2))
    group = spatial_group()
    out = {}
    for name, member in ((k, v[0]) for k, v in EXCHANGES.items()):
        for shape in [(2, 4, 1, 2), (2, 2, 3, 5), (2, 1, 2, 0)]:
            n, bh, a, b = shape
            xs, cs, ds = _exchange_inputs(name, n, bh, a, b)
            i = group.index
            out[name, shape] = _derivatives(name, member, group, xs[i],
                                            cs[i], ds[i], a, b)
    return out


def _job_evaluate(cfg_dict, sd_file):
    from gan_inpainting_torch.train.evaluate import evaluate

    before = dict(counts)
    res = evaluate(config_from_dict(cfg_dict),
                   torch.load(sd_file, weights_only=True), device="cpu")
    return res, {k: counts[k] - before[k] for k in counts}


def _job_train(cfg_dict, root):
    """train() of the spatial group: 2 steps with an eval, a sample grid
    and a checkpoint; who wrote."""
    from gan_inpainting_torch.train import loop

    cfg = config_from_dict(cfg_dict)
    writers = []
    real_writer = loop.MetricsWriter

    def writer(*args, **kwargs):
        writers.append(args)
        return real_writer(*args, **kwargs)

    loop.MetricsWriter = writer
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, workdir=str(pathlib.Path(root) / "sp_train")))
    state, scalars = loop.train(cfg, device="cpu", verbose=False)
    return dict(state=_state_dict_cpu(state), scalars=scalars,
                writers=len(writers))


def _rank_main(rank, tmp, pair_jobs, quad_jobs):
    """Rank ``rank`` of four: first rank ``rank % 2`` of the world of two
    ``rank // 2`` (its jobs in ``pair_jobs[rank // 2]``), then of the
    world of four."""
    import torch.distributed as dist

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    results = {}
    try:
        for world, store, jobs in (
                (2, f"pair{rank // 2}", pair_jobs[rank // 2]),
                (4, "quad", quad_jobs)):
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp}/{store}",
                rank=rank % world, world_size=world)
            try:
                results.update({name: fn(*args)
                                for name, (fn, args) in jobs.items()})
            finally:
                dist.destroy_process_group()
    except BaseException:
        pathlib.Path(tmp, f"error{rank}.txt").write_text(
            traceback.format_exc())
        raise
    with open(pathlib.Path(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# the main process
# ---------------------------------------------------------------------------


def _jax_mesh_steps(jcfg, jstate, batches, axes):
    """JAX's train step on a (data, model, spatial) mesh of its virtual
    CPU devices (as tests/distributed/test_spatial.py runs it): per step
    the metrics, then the state."""
    import jax

    from gan_inpainting_tpu.parallel.mesh import MeshConfig as JMesh
    from gan_inpainting_tpu.parallel.mesh import build_mesh as j_build_mesh
    from gan_inpainting_tpu.parallel.sharding import replicated, shard_batch
    from gan_inpainting_tpu.train.step import make_train_step as j_make_step
    from test_torch_train import _batches

    d, m, s = axes
    mesh = j_build_mesh(JMesh(data=d, model=m, spatial=s),
                        devices=jax.devices()[:d * m * s])
    jstate = jax.device_put(jstate, replicated(mesh))
    step = j_make_step(jcfg, donate=False)
    out = []
    with jax.set_mesh(mesh):
        for i, arrays in enumerate(batches):
            jstate, jm = step(jstate, shard_batch(mesh, _batches(*arrays)[0]),
                              jax.random.key(i))
            out.append({k: float(v) for k, v in jm.items()})
    return out, jax.device_get(jstate)


def _one_process(cfg, state_sd, batches, vgg_sd=None, vgg_f32=False):
    """The port's step in one process on the whole batches: per step the
    metrics, then the state with the first step's gradients."""
    import gan_inpainting_torch.train.step as step_mod
    from gan_inpainting_torch.losses.perceptual import VGG16Features
    from gan_inpainting_torch.train.state import create_state
    from test_torch_tensor_parallel import _tp, _whole

    cfg = _tp(cfg)
    state = create_state(cfg, device="cpu")
    if state_sd is not None:
        # a copy: Adam's load keeps the moment tensors it is given
        state.load_state_dict(copy.deepcopy(state_sd))
    real = step_mod.init_vgg
    if vgg_sd is not None:
        def same_vgg(path, device=None):
            vgg = VGG16Features(compute_dtype=torch.float32 if vgg_f32
                                else torch.bfloat16)
            vgg.load_state_dict(vgg_sd)
            return vgg.to(device).requires_grad_(False)

        step_mod.init_vgg = same_vgg
    grads = []
    try:
        step = step_mod.make_train_step(cfg)
        with _first_grads(step_mod, grads):
            metrics = [{k: float(v) for k, v in step(state,
                                                     _whole(a)).items()}
                       for a in batches]
    finally:
        step_mod.init_vgg = real
    return metrics, dict(_state_dict_cpu(state), first_grads=grads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks once and run every job; meanwhile the main
    process converts JAX's states into the files the step jobs wait on
    and takes JAX's steps. Returns per job the ranks' results (pair jobs:
    the two ranks of their world) with what the main process set up."""
    import jax
    from gan_inpainting_tpu.losses.perceptual import init_vgg as j_init_vgg
    from test_torch_parallel import _numpy_batches, _port_state_from_jax
    from test_torch_train import _np

    from gan_inpainting_torch.io.convert import params_from_jax
    from gan_inpainting_torch.models.generator import build_generator

    tmp = tmp_path_factory.mktemp("spatial_ranks")
    setup = {}
    for case, ov in CASES.items():
        for mesh, extra in (("sp2", SPATIAL2),
                            ("dp2sp2", SPATIAL2 + ["train.mesh.data=2"])):
            cfg = _cfg(ov + extra)
            setup[f"{case}_{mesh}"] = dict(
                case=case, cfg=cfg, file=tmp / f"{case}.pt",
                batches=_numpy_batches(cfg, 2),
                vgg=tmp / "vgg.pt" if case == "partial" else None)
    setup["partial32_sp2"] = dict(setup["partial_sp2"], f32=True)
    tp_cfg = _cfg(CASES["attention"] + SPATIAL2 + MODEL2)
    setup["tp_sp2"] = dict(case="attention", cfg=tp_cfg,
                           file=tmp / "attention.pt",
                           batches=_numpy_batches(tp_cfg, 2), vgg=None)
    un_cfg = _cfg(UNALIGNED + SPATIAL2)
    setup["unaligned"] = dict(cfg=un_cfg, batches=[
        _numpy_batches(un_cfg, 2)[i] for i in range(2)])
    ev_cfg = _cfg(EVAL + SPATIAL2)
    gen = build_generator(ev_cfg.model, device="cpu", seed=3)
    torch.save(gen.state_dict(), tmp / "gen.pt")
    setup["evaluate"] = dict(cfg=ev_cfg, sd=gen.state_dict())
    setup["train"] = dict(cfg=_cfg(TRAIN + SPATIAL2))

    def steps(name):
        job = setup[name]
        return (_job_steps, (dataclasses.asdict(job["cfg"]),
                             str(job["file"]) if "file" in job else None,
                             job["batches"],
                             None if job.get("vgg") is None
                             else str(job["vgg"]), job.get("f32", False)))

    pair_jobs = [
        {"exchanges": (_job_exchanges, ()),
         "unaligned": steps("unaligned"),
         "evaluate": (_job_evaluate, (dataclasses.asdict(ev_cfg),
                                      str(tmp / "gen.pt"))),
         "train": (_job_train, (dataclasses.asdict(setup["train"]["cfg"]),
                                str(tmp))),
         "tiny_sp2": steps("tiny_sp2")},
        {"attention_sp2": steps("attention_sp2"),
         "partial_sp2": steps("partial_sp2"),
         "partial32_sp2": steps("partial32_sp2")},
    ]
    quad_jobs = {name: steps(name) for name in (
        "tiny_dp2sp2", "attention_dp2sp2", "partial_dp2sp2", "tp_sp2")}
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp), pair_jobs, quad_jobs))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        # JAX's seeded state per case, converted: the state files the step
        # jobs wait on (the mesh is JAX's step's argument)
        jstates = {}
        _, vgg_params = j_init_vgg()
        vgg_sd = params_from_jax(_np(vgg_params))
        torch.save(vgg_sd, tmp / "vgg.part")
        (tmp / "vgg.part").rename(tmp / "vgg.pt")
        for case, ov in CASES.items():
            jcfg = _jcfg(ov)
            jstate, state = _port_state_from_jax(jcfg)
            jstates[case] = (jcfg, jstate, state.state_dict())
            torch.save(state.state_dict(), tmp / f"{case}.part")
            (tmp / f"{case}.part").rename(tmp / f"{case}.pt")
        for name, job in setup.items():
            if "case" not in job:
                continue
            jcfg, jstate, sd = jstates[job["case"]]
            job["one"] = _one_process(job["cfg"], sd, job["batches"],
                                      vgg_sd if job["vgg"] else None,
                                      job.get("f32", False))
        for name, axes in (("tiny_sp2", (1, 1, 2)),
                           ("tiny_dp2sp2", (2, 1, 2)),
                           ("attention_sp2", (1, 1, 2)),
                           ("attention_dp2sp2", (2, 1, 2)),
                           ("partial_dp2sp2", (2, 1, 2))):
            job = setup[name]
            jcfg, jstate, _ = jstates[job["case"]]
            job["jax"] = _jax_mesh_steps(jcfg, jstate, job["batches"], axes)
        setup["unaligned"]["one"] = _one_process(
            un_cfg, None, setup["unaligned"]["batches"])
        del jax
    finally:
        for p in procs:
            p.join(timeout=600)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
    errors = [f.read_text() for f in sorted(tmp.glob("error*.txt"))]
    assert not alive and not errors and all(
        p.exitcode == 0 for p in procs), (alive, errors,
                                          [p.exitcode for p in procs])
    results = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
               for r in range(4)]
    out = {}
    for pair, jobs in enumerate(pair_jobs):
        for name in jobs:
            out[name] = dict(setup.get(name, {}), root=tmp, ranks=[
                results[2 * pair][name], results[2 * pair + 1][name]])
    for name in quad_jobs:
        out[name] = dict(setup[name], root=tmp,
                         ranks=[res[name] for res in results])
    return out


def _close_parts(a: dict, b: dict, atol: float,
                 parts=("g_params", "d_params", "g_ema")):
    for part in parts:
        assert set(a[part]) == set(b[part]), part
        gap = max(((a[part][k] - v).abs().max().item()
                   for k, v in b[part].items()), default=0.0)
        assert gap <= atol, (part, gap)


def _close_grads(a: dict, b: dict, rtol: float, parts=("d", "g")):
    """The first step's reduced D and G gradients, leaf by leaf: the
    largest difference within ``rtol`` of the leaf's largest magnitude
    plus the optimizer's (a leaf whose terms nearly cancel keeps the
    rounding of the terms). A group that averaged where it should sum (or
    summed where it should average) is off by its size on every leaf."""
    for name, got, want in zip(("d", "g"), a["first_grads"],
                               b["first_grads"]):
        if name not in parts:
            continue
        assert len(got) == len(want), name
        top = max(y.abs().max().item() for y in want)
        for i, (x, y) in enumerate(zip(got, want)):
            assert x.shape == y.shape, (name, i)
            gap = (x - y).abs().max().item()
            assert gap <= rtol * (y.abs().max().item() + top), (name, i, gap)


def _same_on_ranks(job):
    """Every rank of the job returned the same metrics and state (a
    spatial group's members apply the same summed update)."""
    from test_torch_parallel import _assert_same

    (steps0, sd0), *rest = job["ranks"]
    for steps, sd in rest:
        _assert_same(sd0, sd, "rank 0 vs another")
        assert [m for m, _ in steps] == [m for m, _ in steps0]
        for got, want in zip(sd["first_grads"], sd0["first_grads"]):
            assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("case, mesh", [
    (case, mesh) for case in CASES for mesh in ("sp2", "dp2sp2")] + [
    ("partial32", "sp2")], ids=lambda v: v)
def test_spatial_step_matches_one_process(ranks, case, mesh):
    """Two steps over spatial groups of two ranks, each rank on one row
    band of its data slice, against the port's one process on the whole
    batches from the same converted state: every rank equal, the metrics
    and the state within float32 reordering (the partial case's bf16 VGG
    trunk within a sign flip of a near-zero gradient's Adam update); the
    row exchanges ran (the attention case's row gathers and their
    reduce-scatter), nothing unsharded, and each optimizer's gradients
    were summed over the group in one reduce: the first step's reduced D
    and G gradients are one process's, leaf by leaf."""
    job = ranks[f"{case}_{mesh}"]
    _same_on_ranks(job)
    (steps, sd), one = job["ranks"][0], job["one"]
    rtol = PARTIAL_RTOL if case == "partial" else ONE_RTOL
    for i, ((got, moved), want) in enumerate(zip(steps, one[0])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        assert moved["halo_exchanges"] > 0 and moved["unsharded_steps"] == 0
        assert moved["all_reduce_mean_"] == 2
        assert (moved["row_gathers"] > 0) == (case == "attention")
        assert moved["band_sums"] > 0
        assert (moved["row_reduces"] > 0) == (case == "attention")
    if case == "partial":
        _close_grads(sd, one[1], GRAD_RTOL, parts=("d",))
        _close_grads(sd, one[1], PARTIAL_GRAD_RTOL, parts=("g",))
        _close_parts(sd, one[1], PARTIAL_MAX, parts=("g_params", "g_ema"))
        _close_parts(sd, one[1], ONE_ATOL, parts=("d_params",))
    else:
        _close_grads(sd, one[1], GRAD_RTOL)
        _close_parts(sd, one[1], ONE_ATOL)


@pytest.mark.parametrize("name", ["tiny_sp2", "tiny_dp2sp2",
                                  "attention_sp2", "attention_dp2sp2",
                                  "partial_dp2sp2"])
def test_spatial_step_matches_jax_on_its_mesh(ranks, name):
    """The ranks' two steps against JAX's ``make_train_step`` on the same
    mesh shape, ``(1, 1, 2)`` or ``(2, 1, 2)`` of its virtual CPU devices,
    from the same state and batches: the metrics within rtol 5e-4 and the
    G parameters within atol 5e-4 (tests/distributed/test_spatial.py's
    own limits for a spatial mesh against one device); the lazy R1 ran on
    step 0 only."""
    from test_torch_train import _assert_params_close, _np

    from gan_inpainting_torch.io.convert import discriminator_from_jax

    job = ranks[name]
    (steps, sd), (jm, jstate) = job["ranks"][0], job["jax"]
    for i, ((got, _), want) in enumerate(zip(steps, jm)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=JAX_RTOL,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    if job["case"] == "attention":
        assert steps[0][0]["d_r1"] > 0 and steps[1][0]["d_r1"] == 0
    _assert_params_close(sd["g_params"], _np(jstate.g_params), JAX_ATOL)
    _assert_params_close(
        sd["d_params"], (_np(jstate.d_params), _np(jstate.d_stats)),
        JAX_ATOL, convert=lambda t: discriminator_from_jax(*t))


def test_model_and_spatial_axes_together(ranks):
    """(model, spatial) = (2, 2) with ``tp_shard``: each rank computes its
    channel slices of its row band (halos from its spatial peers, channel
    gathers from its model peers); two steps against one process within
    float32 reordering, every rank equal."""
    job = ranks["tp_sp2"]
    _same_on_ranks(job)
    (steps, sd), one = job["ranks"][0], job["one"]
    for i, ((got, moved), want) in enumerate(zip(steps, one[0])):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=ONE_RTOL,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        assert moved["channel_gathers"] > 0 and moved["halo_exchanges"] > 0
        assert moved["model_grad_reduces"] == 2
    _close_parts(sd, one[1], ONE_ATOL)


def test_unaligned_size_runs_unsharded_and_averages(ranks):
    """24-row images with a 3-layer discriminator: no band form, so each
    step runs whole on both members (counted), with no row exchange, and
    the group averages the members' equal gradients: one process's
    steps, and its first step's reduced gradients."""
    job = ranks["unaligned"]
    _same_on_ranks(job)
    (steps, sd), one = job["ranks"][0], job["one"]
    for (got, moved), want in zip(steps, one[0]):
        assert moved["unsharded_steps"] == 1
        assert moved["halo_exchanges"] == moved["band_sums"] == 0
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    _close_grads(sd, one[1], GRAD_RTOL)
    _close_parts(sd, one[1], ONE_ATOL)


@pytest.mark.parametrize("name", list(EXCHANGES))
def test_process_group_exchanges_match_threads(ranks, name):
    """The exchanges of ranks (zero-filled ``all_reduce`` buffers) give
    the outputs and the first and second derivatives the thread group
    gives, on both members, for every shape of a group of two."""
    got = ranks["exchanges"]["ranks"]
    for shape in [(2, 4, 1, 2), (2, 2, 3, 5), (2, 1, 2, 0)]:
        n, bh, a, b = shape
        xs, cs, ds = _exchange_inputs(name, n, bh, a, b)
        member = EXCHANGES[name][0]
        want = _threads(n, lambda g: _derivatives(
            name, member, g, xs[g.index], cs[g.index], ds[g.index], a, b))
        for i in range(n):
            for w, g in zip(want[i], got[i][name, shape]):
                assert (w - g).abs().max() <= EXCHANGE_ATOL, (shape, i)


def test_evaluate_over_the_spatial_axis_matches_one_process(ranks):
    """evaluate over a spatial group of two: the members generate their
    bands and gather the output, so PSNR, SSIM (windows across the band
    edge) and SWD are one process's; both ranks return the same
    numbers."""
    from gan_inpainting_torch.train.evaluate import evaluate
    from test_torch_tensor_parallel import _tp

    job = ranks["evaluate"]
    (got0, moved), (got1, _) = job["ranks"]
    assert got0 == got1 and "swd_avg" in got0
    assert moved["row_gathers"] > 0 and moved["unsharded_forwards"] == 0
    want = evaluate(_tp(job["cfg"]), job["sd"], device="cpu")
    assert set(got0) == set(want)
    for k in want:
        assert got0[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


def test_train_over_the_spatial_axis_records_its_exchanges(ranks):
    """train() over a spatial group of two: both ranks end with the same
    state, rank 0 alone writes, and the record counts the axis, its row
    exchanges and their bytes per step, with no unsharded step."""
    import json

    from test_torch_parallel import _assert_same

    job = ranks["train"]
    r0, r1 = job["ranks"]
    _assert_same(r0["state"], r1["state"], "rank 0 vs rank 1")
    assert r0["writers"] == 1 and r1["writers"] == 0
    recs = [json.loads(ln) for ln in (job["root"] / "sp_train"
                                      / "metrics.jsonl").read_text()
            .splitlines()]
    logged = [r for r in recs if "g_loss" in r]
    assert [r["step"] for r in logged] == [1, 2]
    assert [r["step"] for r in recs if "eval_psnr" in r] == [2]
    for r in logged:
        assert r["spatial_axis"] == 2 and r["world_size"] == 2
        assert r["row_exchange_bytes_per_step"] > 0
        assert r["unsharded_steps"] == 0 and r["halo_exchanges"] > 0
