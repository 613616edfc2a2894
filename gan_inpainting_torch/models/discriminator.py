"""PatchGAN / SN-PatchGAN discriminator.

A stack of 5×5 stride-2 convs emitting a patch-level logit map
(B, h', w', 1): each logit judges one receptive-field patch (Isola et al.).
With ``spectral_norm`` every conv is spectrally normalized and the model is
the SN-PatchGAN of DeepFill v2. The input is ``concat(image, mask)``, so D
can focus on hole regions. Logits are float32 whatever the compute dtype.
Module names (``conv{i}``, ``head``) are the JAX package's, so flax param
paths map one to one onto ``state_dict`` keys.

Over the mesh's spatial axis (its convs put on a spatial group's row
bands by ``parallel/spatial.py row_bands``, as the train step does) the
discriminator takes one row band of its input and every conv halos its
band (models/layers.py ``band_form``: the 5×5 stride-2 convs on even
bands, the stride-1 head on any), so the logit map is the band's rows of
the whole map's; the losses' means over it are band sums over the whole
map's count (losses/adversarial.py). The bands must halve evenly through
every stride-2 conv: ``2 ** num_layers`` must divide the band's rows.
"""

from __future__ import annotations

import torch
from torch import nn

from gan_inpainting_torch.models.layers import SNConv
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.utils.dtypes import DTypePolicy


class PatchDiscriminator(nn.Module):
    def __init__(self, base_features: int = 64, num_layers: int = 4,
                 spectral_norm: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_layers = num_layers
        f = base_features
        cin = 4
        for i in range(num_layers):
            width = min(f * 2 ** i, 4 * f)
            self.add_module(f"conv{i}", SNConv(
                cin, width, kernel_size=5, stride=2, use_sn=spectral_norm,
                compute_dtype=compute_dtype))
            cin = width
        self.head = SNConv(cin, 1, kernel_size=5, stride=1,
                           use_sn=spectral_norm, activation="none",
                           compute_dtype=compute_dtype)

    def forward(self, image, mask, update_stats: bool = False,
                return_features: bool = False):
        """Patch logit map (float32); with ``return_features`` also the
        per-layer activations, for the feature-matching loss."""
        x = torch.cat([image, mask.to(image.dtype)], -1)
        feats = []
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(x, update_stats=update_stats)
            feats.append(x)
        logits = self.head(x, update_stats=update_stats).float()
        if return_features:
            return logits, tuple(feats)
        return logits


def build_discriminator(model_cfg, device: str | torch.device | None = None,
                        seed: int | None = 0) -> PatchDiscriminator:
    """The discriminator a ModelConfig describes, on ``device`` (CUDA
    unless the caller asks for another), weights and spectral vectors
    drawn from ``seed``."""
    device = resolve_device(device)
    policy = DTypePolicy.from_name(model_cfg.dtype_policy)
    disc = PatchDiscriminator(
        base_features=model_cfg.disc_features,
        num_layers=model_cfg.disc_layers,
        spectral_norm=model_cfg.spectral_norm,
        compute_dtype=policy.compute_dtype)
    if seed is not None:
        g = torch.Generator().manual_seed(seed)
        for m in disc.modules():
            if isinstance(m, SNConv):
                m.reset_parameters(g)
    return disc.to(device)
