"""The mesh's spatial axis in serving (``train.mesh.spatial``) on the CPU:
row bands over threads of one process (parallel/spatial.py), each conv
form on bands against its whole layer, the spatial attention branch
against the JAX package's ``_spatial_attention`` on meshes of its 8
virtual CPU devices, and the ``Inpainter`` over spatial groups against
the JAX ``Inpainter`` on the same mesh shape and against the port's
one-device output. Same seeds, numpy inputs and (through
``params_from_jax``) weights on both sides; the counterpart of
tests/distributed/test_spatial.py.
"""

import importlib
import sys
import threading

import numpy as np
import pytest
import torch
from test_torch_parallel import TINY, _cfg, _jcfg

from gan_inpainting_torch.configs.base import apply_overrides, get_config
from gan_inpainting_torch.infer.inpaint import Inpainter
from gan_inpainting_torch.io.convert import params_from_jax
from gan_inpainting_torch.models.layers import InpaintConv
from gan_inpainting_torch.ops.patches import fold_band, fold_patches
from gan_inpainting_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    train_mesh,
)
from gan_inpainting_torch.parallel.sharding import counts
from gan_inpainting_torch.parallel.spatial import ThreadSpatialGroup

_ca = importlib.import_module("gan_inpainting_torch.ops.contextual_attention")

ATTN = ["model.generator=coarse_to_fine", "model.conv_kind=gated",
        "model.use_attention=true"]
# each conv form on bands against the whole layer, float32: max |a − b| ≤
# this · max |b| (the same sums over the same rows; cuDNN may pick another
# algorithm for the band's shape)
LAYER_REL = 1e-5
# the spatial attention branch against JAX and the one-device op, float32
ATTN_ATOL = 1e-5


def _members(n, fn, timeout=60.0):
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


def _bands(x, n):
    h = x.shape[1] // n
    return [x[:, i * h:(i + 1) * h].contiguous() for i in range(n)]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [(1, 1, 8), (2, 1, 4), (1, 2, 2)],
                         ids=lambda a: "x".join(map(str, a)))
def test_spatial_mesh_layout_matches_jax(axes):
    """build_mesh with a spatial axis against the JAX package's
    ``build_mesh(...).devices``: the same axis sizes and, per data index,
    the same devices in member order (spatial index fastest, then model);
    ``train_mesh`` over data × model × spatial ranks lays the ranks out
    the same way, and over more ranks raises."""
    import jax

    from gan_inpainting_tpu.parallel.mesh import MeshConfig as JMesh
    from gan_inpainting_tpu.parallel.mesh import build_mesh as j_build_mesh

    d, m, s = axes
    cfg = MeshConfig(data=d, model=m, spatial=s)
    built = build_mesh(cfg, range(8))
    jmesh = j_build_mesh(JMesh(data=d, model=m, spatial=s),
                         devices=jax.devices()[:8])
    ids = {dev.id: i for i, dev in enumerate(jax.devices()[:8])}
    assert (built.data, built.model, built.spatial) == jmesh.devices.shape
    assert built.groups == tuple(
        tuple(ids[dev.id] for dev in row.reshape(-1))
        for row in jmesh.devices)
    for r, dev in enumerate(built.groups[0]):
        assert jmesh.devices[0, r // s, r % s].id == dev
    ranks = train_mesh(cfg, d * m * s)
    assert (ranks.data, ranks.model, ranks.spatial) == axes
    assert ranks.groups == built.groups
    if d * m * s < 8:
        with pytest.raises(ValueError, match="data must be -1 or 2"):
            train_mesh(cfg, 8)


def test_evaluate_refuses_the_spatial_axis():
    """``evaluate`` of a spatial config in one process (no ranks, as
    without torchrun) evaluates the whole map on its one device: the
    numbers of the same config without the axis (the ranks' evaluate over
    the axis is in tests/test_torch_spatial_train.py)."""
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.train.evaluate import evaluate

    one = _cfg(["eval.metrics=psnr,ssim"])
    cfg = _cfg(["eval.metrics=psnr,ssim", "train.mesh.spatial=2"])
    sd = build_generator(one.model, device="cpu", seed=2).state_dict()
    assert evaluate(cfg, sd, device="cpu") == evaluate(one, sd,
                                                       device="cpu")


# ---------------------------------------------------------------------------
# the row exchanges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, bh", [(8, 1), (8, 2), (5, 3), (2, 8)])
def test_halo_matches_the_zero_padded_map(n, bh):
    """Every (lo, hi) up to 16 rows over bands of 1–8 rows: each member's
    halo is the map padded with zero rows, sliced at its band (from as many
    neighbours as it takes), under a short switch interval so the threads
    interleave; gather_rows is the map."""
    rng = np.random.default_rng(bh)
    x = torch.from_numpy(rng.standard_normal((2, n * bh, 3, 2))
                         .astype(np.float32))
    pad = torch.nn.functional.pad(x, (0, 0, 0, 0, 16, 16))
    bands = _bands(x, n)
    before = counts["halo_exchanges"]

    def member(group):
        bad = []
        i = group.index
        for lo in range(17):
            for hi in range(17):
                got = group.halo(bands[i], lo, hi)
                want = pad[:, 16 + i * bh - lo:16 + (i + 1) * bh + hi]
                if not torch.equal(got, want):
                    bad.append((lo, hi))
        if not torch.equal(group.gather_rows(bands[i]), x):
            bad.append("gather")
        return bad

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert _members(n, member) == [[]] * n
    finally:
        sys.setswitchinterval(prev)
    assert counts["halo_exchanges"] - before == n * (17 * 17 - 1)


@pytest.mark.parametrize("rate, n", [(1, 4), (2, 4), (2, 8), (3, 2)])
def test_band_fold_and_spill_match_the_whole_fold(rate, n):
    """Each member's fold of its cells' (2r × 2r, stride r) patches onto
    its band and the rows it spills into, plus the neighbours' spill, is
    the whole map's fold on its band."""
    rng = np.random.default_rng(rate)
    hs, ws, c = 2 * n, 5, 3
    k = 2 * rate
    patches = torch.from_numpy(rng.standard_normal((2, hs, ws, k, k, c))
                               .astype(np.float32))
    want, _ = fold_patches(patches, rate, (hs * rate, ws * rate))
    hb = hs // n

    def member(group):
        i = group.index
        ext, (up, down) = fold_band(patches[:, i * hb:(i + 1) * hb], rate,
                                    ws * rate)
        assert ext.shape[1] == up + hb * rate + down
        return group.add_spill(ext, up, down)

    got = torch.cat(_members(n, member), 1)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


# ---------------------------------------------------------------------------
# each conv form on bands
# ---------------------------------------------------------------------------

FORMS = {
    "plain": dict(kernel_size=3),
    "gated": dict(kernel_size=3, conv_kind="gated"),
    "partial": dict(kernel_size=3, conv_kind="partial"),
    "plain_s2": dict(kernel_size=3, stride=2),
    "gated_s2": dict(kernel_size=3, conv_kind="gated", stride=2),
    "partial_s2": dict(kernel_size=3, conv_kind="partial", stride=2),
    "gated_d2": dict(kernel_size=3, conv_kind="gated", dilation=2),
    "gated_d4": dict(kernel_size=3, conv_kind="gated", dilation=4),
    "gated_d8": dict(kernel_size=3, conv_kind="gated", dilation=8),
    "gated_d16": dict(kernel_size=3, conv_kind="gated", dilation=16),
    "partial_d16": dict(kernel_size=3, conv_kind="partial", dilation=16),
    "stem5": dict(kernel_size=5, conv_kind="gated"),
    "s2d": dict(kernel_size=5, conv_kind="gated", s2d=True),
    "pre_upsample": dict(kernel_size=3, conv_kind="gated",
                         pre_upsample=True),
}


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("form", list(FORMS))
def test_conv_form_on_bands_matches_whole_layer(form, n):
    """Each conv form over n row bands of a 16-row map (at n = 8 bands of
    2 rows, so the dilated halos span up to 8 neighbours) against the
    whole layer, float32, within LAYER_REL of max |ref|; the validity
    mask too."""
    cin, feats = 6, 8
    whole = InpaintConv(cin, feats, compute_dtype=torch.float32,
                        **FORMS[form])
    whole.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        whole.bias.normal_(generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 16, 12, cin))
                         .astype(np.float32))
    valid = torch.from_numpy((rng.random((2, 16, 12, 1)) > 0.3)
                             .astype(np.float32))
    with torch.no_grad():
        want_y, want_v = whole(x, valid)
    xs, vs = _bands(x, n), _bands(valid, n)

    def member(group):
        layer = InpaintConv(cin, feats, compute_dtype=torch.float32,
                            spatial_group=group, **FORMS[form])
        layer.load_state_dict(whole.state_dict())
        with torch.no_grad():
            return layer(xs[group.index], vs[group.index])

    got = _members(n, member)
    y = torch.cat([g[0] for g in got], 1)
    assert y.shape == want_y.shape
    assert (y - want_y).abs().max() <= LAYER_REL * want_y.abs().max()
    v = torch.cat([g[1] for g in got], 1)
    assert torch.equal(v, want_v)


# ---------------------------------------------------------------------------
# contextual attention over the spatial axis
# ---------------------------------------------------------------------------


def _attn_case(seed=0, shape=(2, 32, 24, 8)):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32)
    mask = (rng.random(shape[:3] + (1,)) < 0.3).astype(np.float32)
    return f, mask


def _port_attention(f, mask, data, n, backend="pallas"):
    """The op over ``data`` batch shards × a spatial group of ``n`` each
    (the port gathers channels after every sharded conv, so a model axis
    changes nothing here): the bands concatenated."""
    out = []
    for fb, mb in zip(np.split(f, data), np.split(mask, data)):
        ft, mt = torch.from_numpy(fb), torch.from_numpy(mb)
        fs, ms = _bands(ft, n), _bands(mt, n)

        def member(group):
            x = fs[group.index]
            return _ca.contextual_attention(
                x, x, ms[group.index], ksize=3, rate=2, backend=backend,
                spatial_group=group)

        out.append(torch.cat(_members(n, member), 1))
    return torch.cat(out).numpy()


@pytest.mark.parametrize("axes", [(1, 1, 8), (2, 1, 4), (2, 2, 2)],
                         ids=lambda a: "x".join(map(str, a)))
def test_spatial_attention_matches_jax_shard_map(axes):
    """The spatial branch (kernel route and ``xla``) against JAX
    ``_spatial_attention`` with its XLA inner on the same mesh, and
    against the one-device dense op, within ATTN_ATOL; every member
    gathers the map and adds its neighbours' spill."""
    import jax
    import jax.numpy as jnp

    from gan_inpainting_tpu.parallel.mesh import MeshConfig as JMesh
    from gan_inpainting_tpu.parallel.mesh import build_mesh as j_build_mesh

    j_ca = importlib.import_module(
        "gan_inpainting_tpu.ops.contextual_attention")
    f, mask = _attn_case()
    d, m, s = axes
    mesh = j_build_mesh(JMesh(data=d, model=m, spatial=s),
                        devices=jax.devices()[:8])
    with jax.set_mesh(mesh):
        want = np.asarray(jax.jit(lambda f, mk: j_ca._spatial_attention(
            f, f, mk, ksize=3, rate=2, softmax_scale=10.0, backend="xla",
            n_sp=s))(jnp.asarray(f), jnp.asarray(mask)))
    dense = _ca.contextual_attention_plain(
        torch.from_numpy(f), torch.from_numpy(f), torch.from_numpy(mask),
        ksize=3, rate=2).numpy()
    before = counts["spill_adds"]
    for backend in ("pallas", "xla"):
        got = _port_attention(f, mask, d, s, backend)
        np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=0)
        np.testing.assert_allclose(got, dense, atol=ATTN_ATOL, rtol=0)
    assert counts["spill_adds"] - before == 2 * d * s


def test_spatial_attention_runs_local_queries_on_global_keys(monkeypatch):
    """The kernel's wrapper gets this member's query rows alone, a tensor
    of their own, against every key: Lq = Lk / n (a stand-in that records
    the shapes, as tests/distributed/test_spatial.py does)."""
    calls, lock = [], threading.Lock()
    real = _ca.attend

    def standin(q, k, key_valid, v, softmax_scale):
        with lock:
            calls.append((tuple(q.shape), tuple(k.shape),
                          q.is_contiguous() and q.storage_offset() == 0))
        return real(q, k, key_valid, v, softmax_scale)

    monkeypatch.setattr(_ca, "attend", standin)
    f, mask = _attn_case()
    got = _port_attention(f, mask, 1, 8)
    lk = (32 // 2) * (24 // 2)
    assert len(calls) == 8
    assert all(q == (2, lk // 8, 72) and k == (2, lk, 72) and own
               for q, k, own in calls)
    dense = _ca.contextual_attention_plain(
        *(torch.from_numpy(a) for a in (f, f, mask)), ksize=3,
        rate=2).numpy()
    np.testing.assert_allclose(got, dense, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("shape, n", [((2, 36, 24, 8), 4),
                                      ((2, 24, 24, 8), 8)],
                         ids=["36rows_4", "24rows_8"])
def test_unshardable_map_takes_the_gathered_route(monkeypatch, shape, n):
    """Bands that split a query-cell row (9 rows over 4 members; 3 over 8:
    JAX's ``(H / rate) % n != 0``, which runs XLA dense there) gather the
    map and run the op as one device would: no query block narrower than
    the map, the one-device result. (36 rows do not split into 8 equal
    bands, the port's only layout.)"""
    calls = []
    real = _ca.attend

    def standin(q, k, key_valid, v, softmax_scale):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, key_valid, v, softmax_scale)

    monkeypatch.setattr(_ca, "attend", standin)
    f, mask = _attn_case(1, shape)
    before = counts["row_gathers"]
    got = _port_attention(f, mask, 1, n)
    assert not _ca.spatial_shardable(shape[1] // n, 2)
    assert all(lq == lk for lq, lk in calls)
    assert counts["row_gathers"] - before == 2 * n
    want = _ca.contextual_attention(
        *(torch.from_numpy(a) for a in (f, f, mask)), ksize=3,
        rate=2).numpy()
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the Inpainter over spatial groups
# ---------------------------------------------------------------------------


def _jax_params(jcfg, size):
    import jax
    import jax.numpy as jnp

    from gan_inpainting_tpu.models.generator import (
        build_generator as j_build_generator,
    )

    shapes = jax.eval_shape(
        j_build_generator(jcfg.model).init, jax.random.key(0),
        jnp.zeros((1, size, size, 3)), jnp.zeros((1, size, size, 1)))
    rng = np.random.default_rng(4)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(
                       np.float32), shapes["params"])


def _request(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    masks = np.zeros((b, h, w), np.float32)
    masks[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = 1.0
    masks[:, 2:4, :] = 1.0                     # a thin stroke at the top
    return imgs, masks


SERVE_CASES = {
    "dilated_1x1x8": ([], (1, 1, 8), 32, (2, 32, 32)),
    "attention_2x1x4": (ATTN, (2, 1, 4), 32, (2, 32, 32)),
    "attention_1x1x8": (ATTN, (1, 1, 8), 64, (1, 64, 64)),
    "nonsquare_1x1x8": ([], (1, 1, 8), 32, (2, 24, 32)),
    "partialconv256_1x1x4": (None, (1, 1, 4), 32, (2, 32, 32)),
    "tp_shard_1x2x2": (ATTN + ["model.tp_shard=true"], (1, 2, 2), 32,
                       (2, 32, 32)),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_inpainter_over_a_spatial_group_matches_jax(case):
    """The Inpainter over a (data, model, spatial) mesh of CPU devices
    against the JAX Inpainter on the same mesh shape of its virtual
    devices and against the port's one-device output: float32, uint8
    within 1, known pixels exact; the row exchanges counted."""
    import jax

    from gan_inpainting_tpu.configs.base import (
        apply_overrides as j_overrides,
    )
    from gan_inpainting_tpu.configs.base import get_config as j_get
    from gan_inpainting_tpu.infer.inpaint import Inpainter as JInpainter
    from gan_inpainting_tpu.parallel.mesh import MeshConfig as JMesh
    from gan_inpainting_tpu.parallel.mesh import build_mesh as j_build_mesh

    overrides, (d, m, s), size, (b, h, w) = SERVE_CASES[case]
    serve = [f"infer.size_buckets={size}", "infer.batch_buckets=2"]
    if overrides is None:             # partialconv256 at width 8, float32
        small = ["model.base_features=8", "model.dtype_policy=f32"] + serve
        jcfg = j_overrides(j_get("partialconv256"), small)
        one_cfg = apply_overrides(get_config("partialconv256"), small)
    else:
        jcfg, one_cfg = _jcfg(overrides + serve), _cfg(overrides + serve)
    mesh = [f"train.mesh.data={d}", f"train.mesh.model={m}",
            f"train.mesh.spatial={s}"]
    cfg = apply_overrides(one_cfg, mesh)
    params = _jax_params(jcfg, size)
    imgs, masks = _request(b, h, w)

    jmesh = j_build_mesh(JMesh(data=d, model=m, spatial=s),
                         devices=jax.devices()[:8])
    jinp = JInpainter(j_overrides(jcfg, mesh), params, mesh=jmesh)
    with jax.set_mesh(jmesh):
        want = jinp.inpaint_batch(imgs, masks)
    one = Inpainter(one_cfg, params_from_jax(params), device="cpu")
    alone = one.inpaint_batch(imgs, masks)
    inp = Inpainter(cfg, params_from_jax(params),
                    devices=["cpu"] * (d * m * s))
    assert [len(g) for g in inp.groups] == [m * s] * d
    before = dict(counts)
    got = inp.inpaint_batch(imgs, masks)
    inp.close()
    one.close()
    assert got.shape == imgs.shape
    known = masks == 0
    np.testing.assert_array_equal(got[known], imgs[known])
    for ref in (want, alone):
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert counts["halo_exchanges"] > before["halo_exchanges"]
    assert counts["unsharded_forwards"] == before["unsharded_forwards"]
    if overrides is not None and "model.use_attention=true" in overrides:
        assert counts["row_gathers"] > before["row_gathers"]


def test_unaligned_bucket_runs_unsharded_and_is_counted():
    """A size bucket with S % (4·spatial) != 0 (40 at spatial 4) runs
    whole on the spatial index-0 member and is counted; the aligned
    bucket (32) is row-sharded. Both as one device serves them."""
    cfg = _cfg(ATTN + ["infer.size_buckets=32,40", "infer.batch_buckets=1"])
    from gan_inpainting_torch.models.generator import build_generator

    sd = build_generator(cfg.model, device="cpu", seed=0).state_dict()
    one = Inpainter(cfg, sd, device="cpu")
    inp = Inpainter(apply_overrides(cfg, ["train.mesh.spatial=4"]), sd,
                    device="cpu")
    assert len(inp.groups[0]) == 4
    assert inp.row_sharded(32) and not inp.row_sharded(40)
    for size, sharded in ((32, True), (40, False), (36, False)):
        imgs, masks = _request(1, size, size, seed=size)
        before = dict(counts)
        got = inp.inpaint_batch(imgs, masks)
        assert counts["unsharded_forwards"] - before[
            "unsharded_forwards"] == (0 if sharded else 1)
        assert (counts["halo_exchanges"] > before["halo_exchanges"]) \
            == sharded
        np.testing.assert_array_equal(got, one.inpaint_batch(imgs, masks))
    inp.close()
    one.close()


def test_spatial_group_failure_raises_and_recovers():
    """A member that fails mid-forward: the request raises the member's
    own error (not the others' broken exchange), every member returns,
    and the group serves the next request."""
    cfg = _cfg(ATTN + ["infer.size_buckets=32", "infer.batch_buckets=1",
                       "train.mesh.spatial=4"])
    from gan_inpainting_torch.models.generator import build_generator

    sd = build_generator(cfg.model, device="cpu", seed=0).state_dict()
    inp = Inpainter(cfg, sd, device="cpu")
    imgs, masks = _request(1, 32, 32)
    want = inp.inpaint_batch(imgs, masks)
    fuse = inp._cfg_for_size(32).model.fuse_upsample
    conv = inp._forwards[0][2](fuse, True).generator.refine_dec.conv1
    real = conv.forward

    def broken(*args):
        raise RuntimeError("member 2 failed")

    conv.forward = broken
    with pytest.raises(RuntimeError, match="member 2 failed"):
        inp.inpaint_batch(imgs, masks)
    conv.forward = real
    np.testing.assert_array_equal(inp.inpaint_batch(imgs, masks), want)
    inp.close()


def test_spatial_exchanges_refuse_a_gradient():
    """The exchanges carry gradients now (their transposes are held
    against whole-map autograd in tests/test_torch_spatial_train.py): on
    a group of one, a halo's backward drops the zero rows beyond the map
    and a gather's is the identity."""
    from gan_inpainting_torch.parallel.spatial import gather_rows, halo

    group = ThreadSpatialGroup.members(1)[0]
    x = torch.arange(4.0).reshape(1, 2, 2, 1).requires_grad_(True)
    y = halo(x, group, 1, 1)
    assert y.shape == (1, 4, 2, 1) and y.requires_grad
    (g,) = torch.autograd.grad((y * y).sum() + gather_rows(x, group).sum(),
                               x)
    assert torch.equal(g, 2 * x.detach() + 1)


def test_cli_infer_over_a_spatial_group(tmp_path):
    """``infer --weights ... train.mesh.spatial=2 --device cpu``: two
    members on the one device, the output as one device gives it; an
    AOT export under the spatial config warns that its programs run on
    one device."""
    from PIL import Image

    from gan_inpainting_torch.cli import main
    from gan_inpainting_torch.io.aot import export_serving
    from gan_inpainting_torch.io.export import export_generator
    from gan_inpainting_torch.models.generator import build_generator

    cfg = apply_overrides(get_config("celeba128_center"), TINY + [
        "infer.size_buckets=32", "infer.batch_buckets=1"])
    sd = build_generator(cfg.model, device="cpu", seed=3).state_dict()
    npz = tmp_path / "g.npz"
    export_generator(cfg, sd, str(npz))
    imgs, masks = _request(1, 32, 32)
    Image.fromarray(imgs[0]).save(tmp_path / "a.png")
    Image.fromarray((masks[0] * 255).astype(np.uint8)).save(tmp_path / "m.png")
    out = tmp_path / "out.png"
    assert main(["infer", "--device", "cpu", "--weights", str(npz),
                 "--image", str(tmp_path / "a.png"), "--mask",
                 str(tmp_path / "m.png"), "--output", str(out),
                 "train.mesh.spatial=2"]) == 0
    one = Inpainter(cfg, sd, device="cpu")
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  one(imgs[0], masks[0]))
    one.close()
    with pytest.warns(UserWarning, match="spatial=2 is not applied"):
        manifest = export_serving(
            apply_overrides(cfg, ["train.mesh.spatial=2"]), sd,
            str(tmp_path / "aot"), buckets=[(1, 32)], device="cpu")
    assert manifest["devices_per_program"] == 1
