"""Generators, NHWC in and out, with the JAX package's module names (so
flax param paths map one to one onto ``state_dict`` keys).

* :class:`DilatedGenerator` — single-stage encoder-decoder with a dilated
  bottleneck (rates 2/4/8/16).
* :class:`CoarseToFineGenerator` — DeepFill-style two stages: a coarse
  network, then a refinement stage with parallel conv and
  contextual-attention branches.

Both take the masked image (B, H, W, 3) in [-1, 1] and the hole mask
(B, H, W, 1), 1 = hole, and return the full image in [-1, 1] with the tanh
heads in float32 (unless ``bf16_head``). Upsampling is nearest + conv.

``model.tp_shard`` over a model axis of n > 1 (a ``model_group``, see
parallel/sharding.py): every conv of every stack whose output features are
a multiple of 8 is channel-sharded (models/layers.py), the JAX package's
``shard_channels`` rule; the 3-feature output heads, contextual attention
and everything outside the stacks run whole on every member.
``model.remat_stages``: each stack runs under ``torch.utils.checkpoint``
where a gradient is taken, its activations recomputed in the backward
instead of kept (``nn.remat`` of each stack in the JAX package).

Over the mesh's spatial axis (a ``spatial_group`` of n > 1, see
parallel/spatial.py; in serving and in training) the generator takes one
row band of the image, and every activation stays a row band: each conv
of every stack, the heads included, takes its halo from the neighbouring
bands (models/layers.py), and contextual attention gathers the map it
needs (ops/contextual_attention.py); the exchanges carry gradients.
Everything else is band-local as it stands — the concatenations, the
pasted coarse result, the nearest 2× upsample, ``tanh`` — and so are
``downscale_mask_max(mask, 4)`` and ``valid[:, ::4, ::4]`` because every
band starts at a multiple of 4 rows (the caller's split:
infer/inpaint.py, train/step.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from gan_inpainting_torch.models.layers import InpaintConv
from gan_inpainting_torch.ops.contextual_attention import (
    contextual_attention,
    downscale_mask_max,
)
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.parallel.sharding import ModelGroup
from gan_inpainting_torch.parallel.spatial import SpatialGroup
from gan_inpainting_torch.utils.dtypes import DTypePolicy


class GeneratorOutput(NamedTuple):
    coarse: torch.Tensor | None  # stage-1 output, None for single-stage
    fine: torch.Tensor           # final output in [-1, 1]


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


class _Stack(nn.Module):
    """A sequence of InpaintConvs (``conv0``, ``conv1``, …) threading the
    validity mask; with a ``model_group``, those whose output features are
    a multiple of 8 are channel-sharded over it; with a ``spatial_group``
    every one takes a row band."""

    def __init__(self, specs: Sequence[dict], in_features: int,
                 conv_kind: str, compute_dtype: torch.dtype,
                 fuse_upsample: bool = False, s2d_stem: bool = False,
                 backend: str = "auto", model_group: ModelGroup | None = None,
                 spatial_group: SpatialGroup | None = None,
                 name: str = "body"):
        super().__init__()
        self.upsample: list[bool] = []
        self.explicit_upsample: list[bool] = []
        cin = in_features
        for i, spec in enumerate(specs):
            spec = dict(spec)
            kind = spec.pop("conv_kind", conv_kind)
            rewritable = kind in ("plain", "gated")
            s2d = (s2d_stem and rewritable and spec.get("kernel_size") == 5
                   and spec.get("stride", 1) == 1
                   and spec.get("dilation", 1) == 1
                   and not spec.get("upsample", False))
            up = spec.pop("upsample", False)
            # 3x3 stride-1 undilated plain/gated decoder blocks fuse the
            # upsample into a low-res parity conv; others (partial convs
            # among them) upsample explicitly
            fuse = (up and fuse_upsample and rewritable
                    and spec.get("kernel_size", 3) == 3
                    and spec.get("stride", 1) == 1
                    and spec.get("dilation", 1) == 1)
            self.upsample.append(up)
            self.explicit_upsample.append(up and not fuse)
            shard = spec["features"] % 8 == 0
            self.add_module(f"conv{i}", InpaintConv(
                cin, conv_kind=kind, compute_dtype=compute_dtype,
                pre_upsample=fuse, s2d=s2d, backend=backend,
                model_group=model_group if shard else None,
                spatial_group=spatial_group, name=f"{name}.conv{i}",
                **spec))
            cin = spec["features"]

    def forward(self, x, valid=None):
        for i, (up, explicit) in enumerate(zip(self.upsample,
                                               self.explicit_upsample)):
            if up and valid is not None:
                valid = valid.repeat_interleave(2, 1).repeat_interleave(2, 2)
            if explicit:
                x = _upsample2x(x)
            x, valid = getattr(self, f"conv{i}")(x, valid)
        return x, valid


def _encoder_specs(f: int) -> list[dict]:
    return [
        dict(features=f, kernel_size=5),
        dict(features=2 * f, stride=2),
        dict(features=2 * f),
        dict(features=4 * f, stride=2),
        dict(features=4 * f),
        dict(features=4 * f),
    ]


def _dilation_specs(f: int) -> list[dict]:
    return [dict(features=4 * f, dilation=d) for d in (2, 4, 8, 16)]


def _decoder_specs(f: int) -> list[dict]:
    return [
        dict(features=4 * f),
        dict(features=4 * f),
        dict(features=2 * f, upsample=True),
        dict(features=2 * f),
        dict(features=f, upsample=True),
        dict(features=f // 2),
        # output head: plain conv, no gate, no activation
        dict(features=3, conv_kind="plain", activation="none"),
    ]


def _head(x: torch.Tensor, bf16_head: bool) -> torch.Tensor:
    return torch.tanh(x if bf16_head else x.float())


def _run(stack: _Stack, remat: bool, x, valid):
    """A stack's forward; under ``remat``, where a gradient is taken,
    checkpointed (its activations recomputed in the backward). The whole
    stack is recomputed, so every model peer reissues every gather."""
    if remat and torch.is_grad_enabled():
        with set_checkpoint_early_stop(False):
            return checkpoint(stack, x, valid, use_reentrant=False)
    return stack(x, valid)


class DilatedGenerator(nn.Module):
    """Single-stage dilated encoder-decoder."""

    def __init__(self, base_features: int = 48, conv_kind: str = "plain",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fuse_upsample: bool = False, s2d_stem: bool = False,
                 bf16_head: bool = False, backend: str = "auto",
                 model_group: ModelGroup | None = None,
                 remat_stages: bool = False,
                 spatial_group: SpatialGroup | None = None):
        super().__init__()
        f = base_features
        self.bf16_head = bf16_head
        self.remat_stages = remat_stages
        self.body = _Stack(
            _encoder_specs(f) + _dilation_specs(f) + _decoder_specs(f), 4,
            conv_kind, compute_dtype, fuse_upsample, s2d_stem, backend,
            model_group, spatial_group, "body")

    def forward(self, masked, mask) -> GeneratorOutput:
        x = torch.cat([masked, mask.to(masked.dtype)], -1)
        x, _ = _run(self.body, self.remat_stages, x, 1.0 - mask)
        return GeneratorOutput(coarse=None, fine=_head(x, self.bf16_head))


class CoarseToFineGenerator(nn.Module):
    """Two-stage DeepFill-style generator with contextual attention."""

    def __init__(self, base_features: int = 48, conv_kind: str = "gated",
                 use_attention: bool = True, attention_rate: int = 2,
                 attention_ksize: int = 3, softmax_scale: float = 10.0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fuse_upsample: bool = False, s2d_stem: bool = False,
                 bf16_head: bool = False, backend: str = "auto",
                 model_group: ModelGroup | None = None,
                 remat_stages: bool = False,
                 spatial_group: SpatialGroup | None = None):
        super().__init__()
        f = base_features
        self.backend = backend
        self.spatial_group = spatial_group
        self.remat_stages = remat_stages
        self.use_attention = use_attention
        self.attention_rate = attention_rate
        self.attention_ksize = attention_ksize
        self.softmax_scale = softmax_scale
        self.bf16_head = bf16_head

        def stack(name, specs, cin):
            return _Stack(specs, cin, conv_kind, compute_dtype,
                          fuse_upsample, s2d_stem, backend, model_group,
                          spatial_group, name)

        enc = _encoder_specs(f) + _dilation_specs(f)
        self.coarse = stack("coarse", enc + _decoder_specs(f), 4)
        self.refine_conv = stack("refine_conv", enc, 4)
        if use_attention:
            self.refine_attn_enc = stack("refine_attn_enc", [
                dict(features=f, kernel_size=5),
                dict(features=2 * f, stride=2),
                dict(features=2 * f),
                dict(features=4 * f, stride=2),
                dict(features=4 * f, activation="relu"),
            ], 4)
            self.refine_attn_post = stack(
                "refine_attn_post",
                [dict(features=4 * f), dict(features=4 * f)], 4 * f)
        self.refine_dec = stack("refine_dec", _decoder_specs(f),
                                8 * f if use_attention else 4 * f)

    def forward(self, masked, mask) -> GeneratorOutput:
        mask = mask.to(masked.dtype)
        valid = 1.0 - mask

        # ---- stage 1: coarse -------------------------------------------
        remat = self.remat_stages
        x1, _ = _run(self.coarse, remat, torch.cat([masked, mask], -1),
                     valid)
        coarse = _head(x1, self.bf16_head)

        # ---- stage 2: refinement on the pasted coarse result -----------
        pasted = coarse.to(masked.dtype) * mask + masked * valid
        x2 = torch.cat([pasted, mask], -1)
        conv_branch, _ = _run(self.refine_conv, remat, x2, valid)
        if self.use_attention:
            xa, _ = _run(self.refine_attn_enc, remat, x2, valid)
            # hole mask at the branch's 1/4 resolution, max-pooled so thin
            # strokes cannot vanish
            xa = contextual_attention(
                xa, xa, downscale_mask_max(mask, 4),
                ksize=self.attention_ksize, rate=self.attention_rate,
                softmax_scale=self.softmax_scale, backend=self.backend,
                spatial_group=self.spatial_group)
            xa, _ = _run(self.refine_attn_post, remat, xa,
                         valid[:, ::4, ::4, :])
            x2 = torch.cat([conv_branch, xa], -1)
        else:
            x2 = conv_branch
        x2, _ = _run(self.refine_dec, remat, x2, valid[:, ::4, ::4, :])
        return GeneratorOutput(coarse=coarse, fine=_head(x2, self.bf16_head))


def build_generator(model_cfg, device: str | torch.device | None = None,
                    seed: int | None = 0, backend: str | None = None,
                    model_group: ModelGroup | None = None,
                    spatial_group: SpatialGroup | None = None
                    ) -> nn.Module:
    """The generator a ModelConfig describes, on ``device`` (CUDA unless
    the caller asks for another). Weights are drawn from ``seed`` with a
    ``torch.Generator``; load a state_dict over them to serve trained ones.
    ``backend`` overrides ``model_cfg.kernel_backend`` (ops/dispatch.py).
    With ``model_cfg.tp_shard`` and a ``model_group`` of more than one
    member, the stacks' convs are channel-sharded over it; the parameters
    stay whole either way. ``remat_stages`` checkpoints each stack where a
    gradient is taken. With a ``spatial_group`` of more than one member it
    takes one row band of each image.
    """
    device = resolve_device(device)
    policy = DTypePolicy.from_name(model_cfg.dtype_policy)
    if not model_cfg.tp_shard or (model_group is not None
                                  and model_group.size == 1):
        model_group = None
    if spatial_group is not None and spatial_group.size == 1:
        spatial_group = None
    common = dict(
        base_features=model_cfg.base_features,
        conv_kind=model_cfg.conv_kind,
        compute_dtype=policy.compute_dtype,
        fuse_upsample=model_cfg.fuse_upsample,
        s2d_stem=model_cfg.s2d_stem,
        bf16_head=model_cfg.bf16_head,
        backend=backend or model_cfg.kernel_backend,
        model_group=model_group,
        remat_stages=model_cfg.remat_stages,
        spatial_group=spatial_group,
    )
    if model_cfg.generator == "dilated":
        gen = DilatedGenerator(**common)
    elif model_cfg.generator == "coarse_to_fine":
        gen = CoarseToFineGenerator(
            use_attention=model_cfg.use_attention,
            attention_rate=model_cfg.attention_rate, **common)
    else:
        raise ValueError(f"unknown generator {model_cfg.generator!r}")
    if seed is not None:
        g = torch.Generator().manual_seed(seed)
        for m in gen.modules():
            if isinstance(m, InpaintConv):
                m.reset_parameters(g)
    return gen.to(device)


def sliced_parameters(module: nn.Module) -> list[nn.Parameter]:
    """The parameters of ``module``'s channel-sharded convs: each member's
    gradient of them is nonzero on its own rows only."""
    return [p for m in module.modules()
            if isinstance(m, InpaintConv) and m.model_group is not None
            for p in (m.weight, m.bias)]
