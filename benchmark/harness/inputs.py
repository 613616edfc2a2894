"""Everything a run feeds both sides, made from ``--seed``: the weights,
the images and the masks. Weights and images are drawn on the run's
device by a generator there, in a few large calls; the masks' brush
parameters come from a CPU generator (as the program draws them) and are
rasterized on the device by the reference's code."""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

from benchmark.reference import deepfill

# the std of a unit normal truncated to +-2
_TRUNC_STD = 0.87962566103423978


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed (any
    whole number) and the stream's name and indices."""
    digest = hashlib.sha256("/".join(map(str, (seed, *parts))).encode())
    return int.from_bytes(digest.digest()[:8], "little") & (2 ** 63 - 1)


def device_generator(seed: int, device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *parts))


def cpu_generator(seed: int, *parts) -> torch.Generator:
    return torch.Generator().manual_seed(derive(seed, *parts))


def make_params(shapes: dict, seed: int, device, stream: str,
                gain: float = 1.0) -> dict:
    """Fan-in variance-scaling weights (a normal truncated to +-2 std,
    times ``gain``) and zero biases for ``shapes`` ({name: (shape,
    fan_in)}, fan_in 0 for a bias), all weights from one draw on
    ``device``."""
    sizes = {k: math.prod(s) for k, (s, fan) in shapes.items() if fan}
    flat = torch.empty(sum(sizes.values()), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=device_generator(seed, device,
                                                           stream))
    out, off = {}, 0
    for k, (shape, fan) in shapes.items():
        if not fan:
            out[k] = torch.zeros(shape, device=device)
            continue
        n = sizes[k]
        std = gain * math.sqrt(1.0 / fan) / _TRUNC_STD
        out[k] = flat[off:off + n].view(shape).mul_(std)
        off += n
    return out


def generator_params(f: int, seed: int, device, gain: float = 1.0) -> dict:
    return make_params(deepfill.generator_shapes(f), seed, device, "g", gain)


def discriminator_params(f: int, layers: int, seed: int, device) -> dict:
    return make_params(deepfill.discriminator_shapes(f, layers), seed,
                       device, "d")


def images_u8(n: int, size: int, seed: int, device, stream: str):
    """n distinct (size, size, 3) uint8 images: smooth colour fields at
    1/16 resolution, upsampled, with fine noise on top."""
    g = device_generator(seed, device, "images", stream)
    low = torch.rand((n, 3, max(size // 16, 2), max(size // 16, 2)),
                     generator=g, device=device) * 255.0
    img = F.interpolate(low, size=(size, size), mode="bilinear",
                        align_corners=False)
    noise = torch.rand((n, 3, size, size), generator=g, device=device)
    img = img + (noise - 0.5) * 32.0
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()


def masks(n: int, size: int, mask_cfg: dict, seed: int, device,
          stream: str) -> torch.Tensor:
    """n free-form masks (n, size, size, 1) float32, 1 = hole."""
    return deepfill.freeform_masks(cpu_generator(seed, "masks", stream),
                                   mask_cfg, n, size, device)


def mask_params(program_cfg) -> dict:
    m = program_cfg.mask
    return {"max_strokes": m.max_strokes, "max_segments": m.max_segments,
            "min_width": m.min_width, "max_width": m.max_width,
            "max_step": m.max_step}
