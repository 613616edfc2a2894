"""AOT serving artifacts of the port (gan_inpainting_torch/io/aot.py) on
the CPU: export → load → run, against the live port ``Inpainter`` (bit for
bit) and the JAX package's serve forward on the artifact's own
``params.npz`` (uint8 within ±1, known pixels bit-exact), modelled on
tests/unit/test_aot.py; the kernel ops of ops/kernels/library.py under
``torch.library.opcheck`` and as nodes of the exported graphs.

Exports take seconds each here, so the artifacts are module-scoped."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_inpainting_tpu.configs.base import apply_overrides as j_overrides
from gan_inpainting_tpu.configs.base import get_config as j_get_config
from gan_inpainting_tpu.infer.inpaint import make_forward_fn as j_forward_fn
from gan_inpainting_tpu.io.export import _unflatten as j_unflatten

from gan_inpainting_torch.configs.base import apply_overrides, get_config
from gan_inpainting_torch.infer.inpaint import Inpainter
from gan_inpainting_torch.io.aot import AotInpainter, export_serving
from gan_inpainting_torch.models.generator import build_generator
from gan_inpainting_torch.ops.kernels import library
from gan_inpainting_torch.ops.kernels.gated_matmul import kernel_weights

# celebahq256_freeform with attention at width 8, float32
TINY = ["model.base_features=8", "model.disc_features=8",
        "model.use_attention=true", "model.dtype_policy=f32",
        "data.image_size=32", "data.batch_size=2", "data.eval_batch_size=2",
        "data.num_eval_batches=1", "infer.batch_buckets=1,4",
        "infer.size_buckets=32"]


def _cfg(extra=()):
    return apply_overrides(get_config("celebahq256_freeform"),
                           TINY + list(extra))


def _batch(seed, b, h, w):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    masks = np.zeros((b, h, w), np.float32)
    masks[:, h // 4:3 * h // 4, w // 5:4 * w // 5] = 1.0
    masks[:, 2, :] = 1.0                               # a thin stroke
    return imgs, masks


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = _cfg()
    state_dict = build_generator(cfg.model, device="cpu", seed=3).state_dict()
    outdir = tmp_path_factory.mktemp("aot") / "art"
    manifest = export_serving(cfg, state_dict, str(outdir), device="cpu")
    return cfg, state_dict, outdir, manifest


def test_manifest_and_files(exported):
    cfg, state_dict, outdir, manifest = exported
    assert manifest["platform"] == "cpu" and manifest["capability"] is None
    assert manifest["torch_version"] == torch.__version__
    assert sorted(map(tuple, manifest["buckets"])) == [(1, 32), (4, 32)]
    assert manifest["kernel_backend"] == {
        "contextual_attention": "pallas", "gated_conv": "xla",
        "partial_conv": "pallas"}
    assert manifest["formulation"]["4x32"] == {"fuse_upsample": False}
    assert manifest["kernels"] == {}       # the CPU runs the plain versions
    assert manifest["packed"] == {"1x32": {}, "4x32": {}}  # convs: cuDNN
    loaded = json.loads((outdir / "manifest.json").read_text())
    assert loaded["config"]["data"]["image_size"] == cfg.data.image_size
    # params.npz carries the JAX package's leaf names
    with np.load(outdir / "params.npz") as data:
        names = set(data.files)
    assert names and all(n.endswith(("/kernel", "/bias")) for n in names)
    assert len(names) == len(state_dict)
    # no program holds the generator's tensors, nor example inputs with
    # them: they are its inputs
    for b, s in manifest["buckets"]:
        program = outdir / f"fwd_{b}x{s}.pt2"
        ep = torch.export.load(str(program))
        assert not ep.state_dict and not ep.constants
        assert ep.example_inputs is None
        assert program.stat().st_size < (outdir / "params.npz").stat().st_size
        inputs = [spec.arg.name for spec in ep.graph_signature.input_specs]
        assert sum(n.startswith("params") for n in inputs) == len(state_dict)


def test_aot_matches_live_inpainter(exported):
    cfg, state_dict, outdir, _ = exported
    imgs, masks = _batch(0, 4, 32, 32)
    live = Inpainter(cfg, state_dict, device="cpu").inpaint_batch(imgs, masks)
    aot = AotInpainter(str(outdir), device="cpu").inpaint_batch(imgs,
                                                                  masks)
    np.testing.assert_array_equal(aot, live)


def test_aot_matches_jax_on_its_params(exported):
    """JAX's serve forward on the artifact's params.npz, unflattened by
    the JAX package's io/export.py: within ±1, known pixels bit-exact."""
    _, _, outdir, _ = exported
    imgs, masks = _batch(1, 4, 32, 32)
    with np.load(outdir / "params.npz") as data:
        jparams = j_unflatten({k: data[k] for k in data.files})
    jcfg = j_overrides(j_get_config("celebahq256_freeform"), TINY)
    want = np.asarray(jax.jit(j_forward_fn(jcfg))(
        jparams, jnp.asarray(imgs), jnp.asarray(masks[..., None])))
    got = AotInpainter(str(outdir), device="cpu").inpaint_batch(imgs,
                                                                  masks)
    known = np.broadcast_to(masks[..., None] == 0, imgs.shape)
    np.testing.assert_array_equal(got[known], imgs[known])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_aot_bucketing_and_composite(exported):
    _, _, outdir, _ = exported
    aot = AotInpainter(str(outdir), device="cpu")
    # batch 3 pads into the 4-bucket; non-square 24×32 pads to 32²
    imgs, masks = _batch(2, 3, 24, 32)
    out = aot.inpaint_batch(imgs, masks)
    assert out.shape == imgs.shape and out.dtype == np.uint8
    keep = masks[0] == 0
    for i in range(3):
        np.testing.assert_array_equal(out[i][keep], imgs[i][keep])
    np.testing.assert_array_equal(aot(imgs[0], masks[0]), out[0])


def test_aot_rejects_oversize_format_and_platform(exported, tmp_path):
    _, _, outdir, manifest = exported
    aot = AotInpainter(str(outdir), device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        aot.inpaint_batch(np.zeros((8, 32, 32, 3), np.uint8),
                          np.zeros((8, 32, 32), np.float32))
    with pytest.raises(ValueError, match="bucket"):
        aot.inpaint_batch(np.zeros((1, 64, 64, 3), np.uint8),
                          np.zeros((1, 64, 64), np.float32))
    # a doctored copy of the manifest: another format, another platform
    doctored = tmp_path / "art"
    doctored.mkdir()
    for changes, match in (({"format": 99}, "format"),
                           ({"platform": "cuda", "capability": [9, 0]},
                            "exported for 'cuda'")):
        (doctored / "manifest.json").write_text(
            json.dumps({**manifest, **changes}))
        with pytest.raises(ValueError, match=match):
            AotInpainter(str(doctored), device="cpu")
    (doctored / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        AotInpainter(str(doctored), device="meta")


def test_aot_cli_and_service(tmp_path, capsys):
    from PIL import Image

    from gan_inpainting_torch.cli import main
    from gan_inpainting_torch.infer.service import InpaintService
    from gan_inpainting_torch.io.checkpoint import CheckpointManager
    from gan_inpainting_torch.train.state import create_state

    cfg = _cfg([f"train.workdir={tmp_path / 'run'}"])
    CheckpointManager(cfg.train.workdir).save(
        0, create_state(cfg, device="cpu"), cfg)
    outdir = tmp_path / "aot"
    assert main(["export", "--config", "celebahq256_freeform", "--device",
                 "cpu", "--output", str(outdir), "--aot", "--aot-buckets",
                 "2x32", *TINY, f"train.workdir={tmp_path / 'run'}"]) == 0
    assert "wrote AOT artifact (1 buckets, platform cpu)" in \
        capsys.readouterr().out

    aot = AotInpainter(str(outdir), device="cpu")
    assert aot.cfg.infer.batch_buckets == (2,)
    assert aot.cfg.infer.size_buckets == (32,)
    assert aot.devices == (torch.device("cpu"),)
    imgs, masks = _batch(3, 2, 32, 32)
    keep = masks[0] == 0
    # the micro-batching service takes an AotInpainter as it is
    service = InpaintService(aot, max_wait_ms=1.0)
    try:
        service.ready(60)
        out = service.inpaint(imgs[0], masks[0])
    finally:
        service.close()
    np.testing.assert_array_equal(out[keep], imgs[0][keep])
    np.testing.assert_array_equal(out, aot.inpaint_batch(imgs[:1],
                                                         masks[:1])[0])

    Image.fromarray(imgs[0]).save(tmp_path / "in.png")
    Image.fromarray((masks[0] * 255).astype(np.uint8)).save(
        tmp_path / "m.png")
    assert main(["infer", "--device", "cpu", "--aot", str(outdir),
                 "--image", str(tmp_path / "in.png"), "--mask",
                 str(tmp_path / "m.png"), "--output",
                 str(tmp_path / "out.png")]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out.png")),
                                  out)


def test_aot_service_groups_past_the_buckets_of_a_size(tmp_path):
    """The artifact presents every exported batch at every exported size,
    so the service groups up to its largest batch whatever the size; two
    requests at a size whose only bucket holds one image share one
    dispatch, which the artifact serves one image at a time."""
    from gan_inpainting_torch.infer.service import InpaintService

    cfg = _cfg(["infer.size_buckets=16,32"])
    sd = build_generator(cfg.model, device="cpu", seed=7).state_dict()
    export_serving(cfg, sd, str(tmp_path / "art"), buckets=[(2, 16), (1, 32)],
                   device="cpu")
    aot = AotInpainter(str(tmp_path / "art"), device="cpu")
    assert aot.cfg.infer.batch_buckets == (1, 2)
    imgs, masks = _batch(8, 2, 32, 32)
    service = InpaintService(aot, max_wait_ms=5000.0)
    try:
        service.ready(60)
        futures = [service.submit(imgs[i], masks[i]) for i in range(2)]
        outs = [f.result(60) for f in futures]
        stats = service.stats
    finally:
        service.close()
    assert stats["requests"] == 2 and stats["dispatches"] == 1
    for i in range(2):
        np.testing.assert_array_equal(
            outs[i], aot.inpaint_batch(imgs[i:i + 1], masks[i:i + 1])[0])
    np.testing.assert_array_equal(aot.inpaint_batch(imgs, masks),
                                  np.stack(outs))


def test_each_bucket_is_exported_in_the_live_formulation(tmp_path):
    """A bucket above ``infer.fuse_upsample_max_size`` is exported with the
    unfused decoder, as the live Inpainter serves it (the JAX module traces
    one formulation for every bucket), and the manifest says so; both
    programs agree with the live Inpainter bit for bit."""
    cfg = _cfg(["model.fuse_upsample=true", "infer.fuse_upsample_max_size=32",
                "infer.size_buckets=32,64"])
    sd = build_generator(cfg.model, device="cpu", seed=6).state_dict()
    got = export_serving(cfg, sd, str(tmp_path / "art"),
                         buckets=[(1, 32), (1, 64)], device="cpu")
    assert got["formulation"] == {"1x32": {"fuse_upsample": True},
                                  "1x64": {"fuse_upsample": False}}
    aot = AotInpainter(str(tmp_path / "art"), device="cpu")
    live = Inpainter(cfg, sd, device="cpu")
    for size in (32, 64):
        imgs, masks = _batch(size, 1, size, size)
        np.testing.assert_array_equal(aot.inpaint_batch(imgs, masks),
                                      live.inpaint_batch(imgs, masks))


@pytest.mark.parametrize("config,extra,want", [
    ("celebahq256_freeform", ["model.kernel_backend=pallas"],
     {"gated_conv_direct", "gated_conv_matmul", "fused_attention_taps",
      "fold_taps"}),
    ("partialconv256", ["model.kernel_backend=pallas",
                        "model.base_features=8", "model.dtype_policy=f32",
                        "data.image_size=32", "infer.batch_buckets=1",
                        "infer.size_buckets=32"],
     {"partial_epilogue"}),
], ids=["gated_pallas", "partialconv256_pallas"])
def test_exported_graphs_call_the_kernel_ops(exported, tmp_path, config,
                                             extra, want):
    """The serving kernels are nodes of the exported programs: fused
    attention and fold under ``auto`` (the module's artifact), the gated
    convs under ``pallas``, the partial-conv epilogue for
    ``partialconv256`` under ``pallas``; each such program still agrees
    with the live Inpainter bit for bit."""
    _, _, _, manifest = exported
    assert manifest["ops"]["1x32"] == ["fused_attention_taps", "fold_taps"]
    overrides = (TINY if config == "celebahq256_freeform" else []) + extra
    cfg = apply_overrides(get_config(config), overrides)
    sd = build_generator(cfg.model, device="cpu", seed=4).state_dict()
    got = export_serving(cfg, sd, str(tmp_path / "art"), buckets=[(1, 32)],
                         device="cpu")
    assert set(got["ops"]["1x32"]) == want
    assert got["kernel_backend"]["gated_conv" if "gated_conv_direct" in want
                                 else "partial_conv"] == "pallas"
    # the gated convs' packed weights are inputs, read by the ops alone
    packed = got["packed"]["1x32"]
    assert bool(packed) == ("gated_conv_direct" in want)
    assert set(packed) <= set(sd)
    ep = torch.export.load(str(tmp_path / "art" / "fwd_1x32.pt2"))
    inputs = [n for n in ep.graph.nodes if n.op == "placeholder"
              and n.name.startswith("packed")]
    assert len(inputs) == len(packed)
    assert all(u.target.namespace == "gan_inpainting"
               for n in inputs for u in n.users)
    imgs, masks = _batch(5, 1, 32, 32)
    np.testing.assert_array_equal(
        AotInpainter(str(tmp_path / "art"),
                     device="cpu").inpaint_batch(imgs, masks),
        Inpainter(cfg, sd, device="cpu").inpaint_batch(imgs, masks))


def _op_cases():
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x = torch.relu(t(2, 8, 8, 4))
    hole = torch.from_numpy((rng.random((2, 8, 8, 1)) < 0.3)
                            .astype(np.float32))
    w, b = t(6, 4, 3, 3) * 0.2, t(6)
    valid = torch.from_numpy(rng.random((2, 7)) < 0.7)
    counts = torch.from_numpy(rng.integers(0, 10, (2, 8, 8, 1))
                              .astype(np.float32))
    return {
        "fused_attention_taps": (x, hole, 3, 2, 10.0, True),
        "fold_taps": (t(2, 16, 16, 4), 4, 4, 2),
        "gated_conv_direct": (x, w, kernel_weights(w, x), b, 2, "elu"),
        "gated_conv_matmul": (x, w, kernel_weights(w, x), b, 2, 1, "relu"),
        "partial_epilogue": (t(2, 8, 8, 5), counts, t(5), 3),
        "patch_attention": (t(2, 6, 12), t(2, 7, 12), valid, t(2, 7, 16),
                            10.0, False),
    }


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_opcheck_on_the_cpu(name):
    """Schema, fake against real, and the traced dispatch of each op."""
    library.load_all()
    op = getattr(torch.ops.gan_inpainting, name).default
    torch.library.opcheck(op, _op_cases()[name])
