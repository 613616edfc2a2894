"""VGG perceptual and style losses (Liu et al., ECCV'18 usage).

A VGG16 feature extractor (convs through pool3 by default: the layers the
partial-conv paper's losses use), NHWC, with the JAX package's module names
(``conv{block}_{i}``), so its flax params map one to one onto the
``state_dict``. Weights are *injected*: there is no download. They are

* weight-0-able from config (``loss.perceptual_weight`` /
  ``loss.style_weight``),
* loadable from the converted ``.npz`` the JAX package reads
  (``conv{block}_{i}/kernel`` HWIO, ``…/bias``), through
  :func:`gan_inpainting_torch.io.convert.vgg_state_from_npz`,
* drawn from a fixed seed otherwise, so that tests and smoke runs exercise
  the whole code path without pretrained weights.

Perceptual = Σ_l mean|φ_l(out) − φ_l(gt)|; style = Σ_l mean|G(φ_l(out)) −
G(φ_l(gt))| with G the channel Gram matrix normalized by C·H·W.

Over the mesh's spatial axis (``bands``, a spatial group whose members
each hold one row band of the images, parallel/spatial.py) the trunk runs
on the bands: each 3×3 conv halos its band by one row each way, and the
2×2 pools stay inside even bands. A Gram matrix is the group's sum of the
bands' products (a group sum with its gradient) over the whole map's
H·W·C, the same on every member; the perceptual means are band sums over
the whole map's count. Each member's losses are then partial sums whose
group totals are the losses: the style term, which every member computes
whole, counts 1 / n on each.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gan_inpainting_torch.models.layers import InpaintConv
from gan_inpainting_torch.ops.conv import conv2d
from gan_inpainting_torch.losses.adversarial import band_mean
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.parallel.spatial import (
    SpatialGroup,
    group_sum,
    halo,
    row_bands,
)

# torchvision VGG16 conv layout: (block, convs-in-block)
_VGG16_LAYOUT: Sequence[tuple[int, int]] = ((1, 2), (2, 2), (3, 3))
_WIDTHS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_SEED = 7


class _VGGConv(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel_size = 3
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))


class VGG16Features(nn.Module):
    """VGG16 trunk returning the feature map after each block's pool."""

    def __init__(self, num_blocks: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.spatial_group: SpatialGroup | None = None
        self.layout = tuple(_VGG16_LAYOUT[:num_blocks])
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD),
                             persistent=False)
        cin = 3
        for block, n_convs in self.layout:
            for i in range(n_convs):
                self.add_module(f"conv{block}_{i + 1}",
                                _VGGConv(cin, _WIDTHS[block]))
                cin = _WIDTHS[block]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, H, W, 3) in [-1, 1]. Returns the list of block features."""
        x = (x.float() + 1.0) * 0.5
        x = ((x - self.mean) / self.std).to(self.compute_dtype)
        feats = []
        group = self.spatial_group
        for block, n_convs in self.layout:
            for i in range(n_convs):
                conv = getattr(self, f"conv{block}_{i + 1}")
                # conv, then the bias add, each rounded to the compute
                # dtype, as the flax module does
                if group is None:
                    y = conv2d(x, conv.weight.to(x.dtype))
                else:
                    h = x.shape[1]
                    y = conv2d(halo(x, group, 1, 1),
                               conv.weight.to(x.dtype))[:, 1:1 + h]
                x = F.relu(y + conv.bias.to(x.dtype))
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            feats.append(x)
        return feats


def init_vgg(weights_path: str = "", num_blocks: int = 3,
             compute_dtype: torch.dtype = torch.bfloat16,
             device: str | torch.device | None = None) -> VGG16Features:
    """The frozen feature extractor on ``device``: converted weights when a
    path is given, else a fixed-seed random initialization (the JAX
    package's initializer; not its random numbers)."""
    device = resolve_device(device)
    model = VGG16Features(num_blocks=num_blocks, compute_dtype=compute_dtype)
    g = torch.Generator().manual_seed(VGG_SEED)
    for m in model.modules():
        if isinstance(m, _VGGConv):
            InpaintConv.reset_parameters(m, g)
    if weights_path:
        from gan_inpainting_torch.io.convert import vgg_state_from_npz

        model.load_state_dict(vgg_state_from_npz(weights_path,
                                                 model.state_dict()))
    return model.to(device).requires_grad_(False)


def gram_matrix(feat: torch.Tensor,
                bands: SpatialGroup | None = None) -> torch.Tensor:
    """Channel Gram matrix, normalized by C·H·W. feat: (B, H, W, C); with
    ``bands`` this member's row band of it, the matrix the whole map's."""
    b, h, w, c = feat.shape
    x = feat.float().reshape(b, h * w, c)
    g = torch.matmul(x.transpose(1, 2), x)
    if bands is None:
        return g / (h * w * c)
    return group_sum(g, bands) / (bands.size * h * w * c)


def perceptual_and_style_loss(vgg: nn.Module, output: torch.Tensor,
                              target: torch.Tensor,
                              bands: SpatialGroup | None = None):
    """(perceptual, style) scalars in float32; no gradient reaches
    ``target``. With ``bands`` the images are this member's row band and
    the two its partial sums (module docstring)."""
    n = 1 if bands is None else bands.size
    with row_bands(bands, vgg):
        f_out = vgg(output)
        with torch.no_grad():
            f_tgt = vgg(target)
    perc = output.new_zeros((), dtype=torch.float32)
    style = output.new_zeros((), dtype=torch.float32)
    for fo, ft in zip(f_out, f_tgt):
        perc = perc + band_mean(torch.abs(fo.float() - ft.float()), n)
        gap = torch.mean(torch.abs(gram_matrix(fo, bands)
                                   - gram_matrix(ft, bands)))
        style = style + (gap if bands is None else gap / n)
    return perc, style
