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
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from gan_inpainting_torch.models.layers import InpaintConv
from gan_inpainting_torch.ops.contextual_attention import (
    contextual_attention,
    downscale_mask_max,
)
from gan_inpainting_torch.ops.dispatch import resolve_device
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
    validity mask."""

    def __init__(self, specs: Sequence[dict], in_features: int,
                 conv_kind: str, compute_dtype: torch.dtype,
                 fuse_upsample: bool = False, s2d_stem: bool = False,
                 backend: str = "auto"):
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
            self.add_module(f"conv{i}", InpaintConv(
                cin, conv_kind=kind, compute_dtype=compute_dtype,
                pre_upsample=fuse, s2d=s2d, backend=backend, **spec))
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


class DilatedGenerator(nn.Module):
    """Single-stage dilated encoder-decoder."""

    def __init__(self, base_features: int = 48, conv_kind: str = "plain",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fuse_upsample: bool = False, s2d_stem: bool = False,
                 bf16_head: bool = False, backend: str = "auto"):
        super().__init__()
        f = base_features
        self.bf16_head = bf16_head
        self.body = _Stack(
            _encoder_specs(f) + _dilation_specs(f) + _decoder_specs(f), 4,
            conv_kind, compute_dtype, fuse_upsample, s2d_stem, backend)

    def forward(self, masked, mask) -> GeneratorOutput:
        x = torch.cat([masked, mask.to(masked.dtype)], -1)
        x, _ = self.body(x, 1.0 - mask)
        return GeneratorOutput(coarse=None, fine=_head(x, self.bf16_head))


class CoarseToFineGenerator(nn.Module):
    """Two-stage DeepFill-style generator with contextual attention."""

    def __init__(self, base_features: int = 48, conv_kind: str = "gated",
                 use_attention: bool = True, attention_rate: int = 2,
                 attention_ksize: int = 3, softmax_scale: float = 10.0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fuse_upsample: bool = False, s2d_stem: bool = False,
                 bf16_head: bool = False, backend: str = "auto"):
        super().__init__()
        f = base_features
        self.backend = backend
        self.use_attention = use_attention
        self.attention_rate = attention_rate
        self.attention_ksize = attention_ksize
        self.softmax_scale = softmax_scale
        self.bf16_head = bf16_head

        def stack(specs, cin):
            return _Stack(specs, cin, conv_kind, compute_dtype,
                          fuse_upsample, s2d_stem, backend)

        enc = _encoder_specs(f) + _dilation_specs(f)
        self.coarse = stack(enc + _decoder_specs(f), 4)
        self.refine_conv = stack(enc, 4)
        if use_attention:
            self.refine_attn_enc = stack([
                dict(features=f, kernel_size=5),
                dict(features=2 * f, stride=2),
                dict(features=2 * f),
                dict(features=4 * f, stride=2),
                dict(features=4 * f, activation="relu"),
            ], 4)
            self.refine_attn_post = stack(
                [dict(features=4 * f), dict(features=4 * f)], 4 * f)
        self.refine_dec = stack(_decoder_specs(f),
                                8 * f if use_attention else 4 * f)

    def forward(self, masked, mask) -> GeneratorOutput:
        mask = mask.to(masked.dtype)
        valid = 1.0 - mask

        # ---- stage 1: coarse -------------------------------------------
        x1, _ = self.coarse(torch.cat([masked, mask], -1), valid)
        coarse = _head(x1, self.bf16_head)

        # ---- stage 2: refinement on the pasted coarse result -----------
        pasted = coarse.to(masked.dtype) * mask + masked * valid
        x2 = torch.cat([pasted, mask], -1)
        conv_branch, _ = self.refine_conv(x2, valid)
        if self.use_attention:
            xa, _ = self.refine_attn_enc(x2, valid)
            # hole mask at the branch's 1/4 resolution, max-pooled so thin
            # strokes cannot vanish
            xa = contextual_attention(
                xa, xa, downscale_mask_max(mask, 4),
                ksize=self.attention_ksize, rate=self.attention_rate,
                softmax_scale=self.softmax_scale, backend=self.backend)
            xa, _ = self.refine_attn_post(xa, valid[:, ::4, ::4, :])
            x2 = torch.cat([conv_branch, xa], -1)
        else:
            x2 = conv_branch
        x2, _ = self.refine_dec(x2, valid[:, ::4, ::4, :])
        return GeneratorOutput(coarse=coarse, fine=_head(x2, self.bf16_head))


def build_generator(model_cfg, device: str | torch.device | None = None,
                    seed: int | None = 0,
                    backend: str | None = None) -> nn.Module:
    """The generator a ModelConfig describes, on ``device`` (CUDA unless
    the caller asks for another). Weights are drawn from ``seed`` with a
    ``torch.Generator``; load a state_dict over them to serve trained ones.
    ``backend`` overrides ``model_cfg.kernel_backend`` (ops/dispatch.py).

    ``tp_shard`` and ``remat_stages`` are accepted and ignored: one card
    shards nothing, and rematerialization only changes differentiation.
    """
    device = resolve_device(device)
    policy = DTypePolicy.from_name(model_cfg.dtype_policy)
    common = dict(
        base_features=model_cfg.base_features,
        conv_kind=model_cfg.conv_kind,
        compute_dtype=policy.compute_dtype,
        fuse_upsample=model_cfg.fuse_upsample,
        s2d_stem=model_cfg.s2d_stem,
        bf16_head=model_cfg.bf16_head,
        backend=backend or model_cfg.kernel_backend,
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
