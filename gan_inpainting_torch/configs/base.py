"""Config system: frozen dataclasses + the named configs.

A copy of the JAX package's ``configs/base.py`` (same sections, fields,
defaults, registry and override syntax), so the config JSON embedded in
every exported ``.npz`` parses identically here. The rationale behind each
default is documented beside the original; the measurements quoted there
were taken on TPUs and are not the port's.

``MeshConfig`` lives in ``parallel/mesh.py``, which copies the JAX
package's dataclass (the JAX module imports jax): embedded configs carry it
under ``train.mesh`` and parse in both packages. The port trains over
the data and model axes and serves over all three; a ``spatial`` axis
above 1 raises in training and evaluation (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any

from gan_inpainting_torch.parallel.mesh import MeshConfig


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Mask synthesis. Convention: mask==1 marks the hole to inpaint."""

    kind: str = "center"          # center | freeform | mixed
    center_frac: float = 0.5
    center_jitter: bool = False
    max_strokes: int = 8
    max_segments: int = 8
    min_width: float = 6.0
    max_width: float = 24.0
    max_step: float = 40.0
    freeform_prob: float = 0.5
    curriculum_steps: int = 0
    curriculum_start_scale: float = 0.4


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"    # synthetic | folder
    root: str = ""
    image_size: int = 128
    batch_size: int = 16
    eval_batch_size: int = 16
    num_eval_batches: int = 16
    synthetic_size: int = 512
    synthetic_family: str = "blobs"   # blobs | textured
    loader_threads: int = 2
    prefetch_batches: int = 4
    loader_cache: str = "auto"    # auto | on | off
    loader_cache_dir: str = ""
    random_flip: bool = True
    random_crop: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    generator: str = "dilated"    # dilated | coarse_to_fine
    conv_kind: str = "plain"      # plain | gated | partial
    base_features: int = 48
    use_attention: bool = False
    attention_rate: int = 2
    disc_features: int = 64
    disc_layers: int = 4
    spectral_norm: bool = False
    dtype_policy: str = "bf16"    # bf16 | f32
    # auto | xla | pallas, the JAX package's values: "pallas" = the port's
    # hand-written CUDA kernels, "xla" = the library composition (cuDNN +
    # eager elementwise), "auto" = per op (ops/dispatch.py AUTO_CUDA)
    kernel_backend: str = "auto"
    # decoder upsample+conv blocks evaluated as low-res parity convs
    # (ops/upsample_conv.py): same math and parameters
    fuse_upsample: bool = False
    # 5x5 stem convs evaluated in the space-to-depth cell domain
    # (ops/s2d_conv.py): same math and parameters
    s2d_stem: bool = False
    bf16_head: bool = False
    # each generator stack checkpointed where a gradient is taken: its
    # activations recomputed in the backward instead of kept
    remat_stages: bool = False
    # channel-shard the generator convs over train.mesh.model
    # (models/layers.py; no effect on a model axis of 1)
    tp_shard: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    adversarial: str = "hinge"    # hinge | bce | lsgan
    l1_weight: float = 1.0
    l1_hole_weight: float = 6.0
    l1_valid_weight: float = 1.0
    spatial_discount: float = 0.0
    perceptual_weight: float = 0.0
    style_weight: float = 0.0
    vgg_weights_path: str = ""
    gan_weight: float = 1.0
    tv_weight: float = 0.0
    r1_gamma: float = 0.0
    r1_interval: int = 1
    feature_match_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 10_000
    g_lr: float = 1e-4
    d_lr: float = 4e-4
    beta1: float = 0.5
    beta2: float = 0.9
    grad_clip: float = 0.0
    seed: int = 0
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_end_factor: float = 0.0
    grad_accum: int = 1
    init_from: str = ""
    init_from_best: bool = False
    init_from_d: bool = True
    g_ema_decay: float = 0.0
    log_every: int = 50
    eval_every: int = 1000
    checkpoint_every: int = 1000
    max_checkpoints: int = 3
    keep_best: bool = True
    workdir: str = "/tmp/gan_inpainting_tpu"
    mesh: MeshConfig = MeshConfig()


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    metrics: tuple[str, ...] = ("psnr", "ssim")
    swd_max_images: int = 256


@dataclasses.dataclass(frozen=True)
class InferConfig:
    batch_buckets: tuple[int, ...] = (1, 8, 64)
    size_buckets: tuple[int, ...] = (128, 256, 512)
    donate_input: bool = True
    # serving evaluates the fused-upsample decoder only at sizes up to this
    # bucket and the plain upsample+conv above it; same params either way
    fuse_upsample_max_size: int = 256


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "celeba128_center"
    data: DataConfig = DataConfig()
    mask: MaskConfig = MaskConfig()
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    eval: EvalConfig = EvalConfig()
    infer: InferConfig = InferConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _celeba128_center() -> Config:
    return Config(
        name="celeba128_center",
        data=DataConfig(image_size=128, batch_size=16),
        mask=MaskConfig(kind="center", center_frac=0.5),
        model=ModelConfig(generator="dilated", conv_kind="plain",
                          base_features=48, use_attention=False),
        loss=LossConfig(adversarial="bce", l1_weight=1.0),
    )


def _celebahq256_freeform() -> Config:
    return Config(
        name="celebahq256_freeform",
        data=DataConfig(image_size=256, batch_size=16),
        mask=MaskConfig(kind="freeform", max_strokes=8, max_segments=8,
                        min_width=12.0, max_width=40.0, max_step=80.0),
        model=ModelConfig(generator="coarse_to_fine", conv_kind="gated",
                          base_features=48, use_attention=False),
        loss=LossConfig(adversarial="hinge", l1_weight=1.0, r1_gamma=0.1),
        train=TrainConfig(g_ema_decay=0.999),
        eval=EvalConfig(metrics=("psnr", "ssim", "swd")),
    )


def _places512_deepfill() -> Config:
    return Config(
        name="places512_deepfill",
        data=DataConfig(image_size=512, batch_size=8),
        mask=MaskConfig(kind="freeform", max_strokes=12, max_segments=8,
                        min_width=16.0, max_width=64.0, max_step=120.0),
        model=ModelConfig(generator="coarse_to_fine", conv_kind="gated",
                          base_features=48, use_attention=True,
                          attention_rate=2),
        loss=LossConfig(adversarial="hinge", l1_weight=1.0,
                        r1_gamma=0.1, r1_interval=16),
        train=TrainConfig(g_ema_decay=0.999),
        eval=EvalConfig(metrics=("psnr", "ssim", "swd")),
    )


def _places512_sn_vgg() -> Config:
    return Config(
        name="places512_sn_vgg",
        data=DataConfig(image_size=512, batch_size=8),
        mask=MaskConfig(kind="mixed", freeform_prob=0.5,
                        max_strokes=12, max_segments=8,
                        min_width=16.0, max_width=64.0, max_step=120.0,
                        curriculum_steps=5000),
        model=ModelConfig(generator="coarse_to_fine", conv_kind="gated",
                          base_features=48, use_attention=True,
                          spectral_norm=True),
        loss=LossConfig(adversarial="hinge", l1_weight=1.0,
                        perceptual_weight=0.05, style_weight=120.0,
                        r1_gamma=0.1, r1_interval=16),
        train=TrainConfig(g_ema_decay=0.999),
        eval=EvalConfig(metrics=("psnr", "ssim", "swd")),
    )


def _serve_v4_8() -> Config:
    return Config(
        name="serve_v4_8",
        data=DataConfig(image_size=256, batch_size=64),
        mask=MaskConfig(kind="freeform"),
        model=ModelConfig(generator="coarse_to_fine", conv_kind="gated",
                          base_features=48, use_attention=True,
                          fuse_upsample=True),
        train=TrainConfig(mesh=MeshConfig(data=-1, model=1)),
        infer=InferConfig(batch_buckets=(1, 8, 16, 32, 64, 256),
                          size_buckets=(256, 512)),
    )


def _partialconv256() -> Config:
    return Config(
        name="partialconv256",
        data=DataConfig(image_size=256, batch_size=16),
        mask=MaskConfig(kind="freeform", max_strokes=8, max_segments=8,
                        min_width=12.0, max_width=40.0, max_step=80.0),
        model=ModelConfig(generator="dilated", conv_kind="partial",
                          base_features=48),
        loss=LossConfig(adversarial="hinge", gan_weight=0.0,
                        l1_weight=1.0, l1_hole_weight=6.0,
                        perceptual_weight=0.05, style_weight=120.0,
                        tv_weight=0.1),
    )


_REGISTRY = {
    "celeba128_center": _celeba128_center,
    "celebahq256_freeform": _celebahq256_freeform,
    "partialconv256": _partialconv256,
    "places512_deepfill": _places512_deepfill,
    "places512_sn_vgg": _places512_sn_vgg,
    "serve_v4_8": _serve_v4_8,
}


def config_from_dict(d: dict) -> Config:
    """Rebuild a :class:`Config` from ``dataclasses.asdict`` output (the
    form embedded in export artifacts). JSON turns tuples into lists; field
    types are restored from the dataclass declarations. Fields the artifact
    lacks keep their defaults."""

    def build(cls, values: dict):
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in values:
                continue
            v = values[f.name]
            ftype = hints.get(f.name, f.type)
            if (isinstance(ftype, type) and dataclasses.is_dataclass(ftype)
                    and isinstance(v, dict)):
                kwargs[f.name] = build(ftype, v)
            elif isinstance(v, list):
                default = f.default
                elem = (type(default[0]) if isinstance(default, tuple)
                        and default else str)
                kwargs[f.name] = tuple(elem(e) for e in v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    return build(Config, d)


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> Config:
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; have {list_configs()}")
    return _REGISTRY[name]()


# ---------------------------------------------------------------------------
# Overrides: "section.key=value"
# ---------------------------------------------------------------------------


def _parse_value(existing: Any, raw: str) -> Any:
    if isinstance(existing, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(existing, int):
        return int(raw)
    if isinstance(existing, float):
        return float(raw)
    if isinstance(existing, tuple):
        elems = [s for s in raw.split(",") if s]
        elem_type = type(existing[0]) if existing else str
        return tuple(elem_type(e) for e in elems)
    return raw


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        path, raw = item.split("=", 1)
        cfg = _replace_path(cfg, path.split("."), raw)
    return cfg


def _replace_path(obj, parts: list[str], raw: str):
    key = parts[0]
    if not hasattr(obj, key):
        raise KeyError(f"config has no field {key!r} on {type(obj).__name__}")
    if len(parts) == 1:
        value = _parse_value(getattr(obj, key), raw)
        return dataclasses.replace(obj, **{key: value})
    child = _replace_path(getattr(obj, key), parts[1:], raw)
    return dataclasses.replace(obj, **{key: child})
