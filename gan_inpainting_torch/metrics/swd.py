"""Sliced Wasserstein distance over a Laplacian pyramid (GAN quality).

PSNR / SSIM (metrics/image.py) score each image against its ground truth;
a GAN can also fail as a distribution (texture drift, mode collapse) in
ways a paired metric misses. The multi-scale sliced Wasserstein distance
of Karras et al. 2018 (ProGAN §5) needs no pretrained network: take local
patch descriptors from each level of a Laplacian pyramid of both image
sets, project them onto random unit directions and compare the sorted 1-D
projections. Values are reported ×1e3.

Every random draw (patch positions per level, projection directions per
level) is made in :func:`swd_draws`, from one ``torch.Generator``;
:func:`_patch_descriptors` and :func:`sliced_wasserstein` take them as
arguments, so the same draws can be fed to another implementation. As in
the JAX package, one set of patch positions per level serves both the real
and the fake set. The blur is a depthwise ``F.conv2d`` and the projection a
``torch.matmul``, both in float32 (TF32 off).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

# 5-tap binomial kernel, the Burt–Adelson pyramid filter
_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


@functools.lru_cache(maxsize=None)
def _pyr_kernel() -> np.ndarray:
    return np.outer(_BINOMIAL5, _BINOMIAL5).astype(np.float32)


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 5×5 binomial blur with zero SAME padding. x: (B, H, W, C)."""
    c = x.shape[-1]
    k = torch.from_numpy(_pyr_kernel()).to(x.device)[None, None]
    with _no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2), k.repeat(c, 1, 1, 1), padding=2,
                     groups=c)
    return y.permute(0, 2, 3, 1)


def _up(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear upsample to ``hw`` with half-pixel centres (the JAX
    package's ``jax.image.resize(..., "bilinear")``)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def laplacian_pyramid(x: torch.Tensor, n_levels: int) -> list[torch.Tensor]:
    """Band-pass levels, finest first; the last entry is the low-pass base.
    x: (B, H, W, C); level i has spatial size ⌈H / 2^i⌉."""
    levels = []
    cur = x.float()
    for _ in range(n_levels - 1):
        low = _blur(cur)[:, ::2, ::2, :]
        levels.append(cur - _up(low, cur.shape[1:3]))
        cur = low
    levels.append(cur)
    return levels


def _n_levels(size: int, min_res: int, patch_size: int) -> int:
    size = max(size, min_res, patch_size)
    n = 1
    while size // 2 >= max(min_res, patch_size):
        n += 1
        size //= 2
    return n


def swd_draws(level_shapes, generator: torch.Generator, *,
              patches_per_image: int = 64, patch_size: int = 7,
              n_proj: int = 128) -> list[tuple[torch.Tensor, ...]]:
    """The random draws of :func:`swd`, per pyramid level of shape (B, H,
    W, C): patch rows ``ys`` and columns ``xs`` ((B·patches_per_image,)
    int64, top-left corners) and Gaussian directions ``dirs`` ((ps²·C,
    n_proj) float32, normalized in :func:`sliced_wasserstein`), on the
    generator's device."""
    dev = generator.device
    draws = []
    for b, h, w, c in level_shapes:
        n = b * patches_per_image
        ys = torch.randint(0, h - patch_size + 1, (n,), generator=generator,
                           device=dev)
        xs = torch.randint(0, w - patch_size + 1, (n,), generator=generator,
                           device=dev)
        dirs = torch.randn((patch_size * patch_size * c, n_proj),
                           generator=generator, device=dev)
        draws.append((ys, xs, dirs))
    return draws


def _patch_descriptors(level: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor, patches_per_image: int,
                       patch_size: int) -> torch.Tensor:
    """Patches of one pyramid level at the drawn corners, image i taking
    draws i·patches_per_image …: (B, H, W, C) → (B·patches_per_image,
    patch_size²·C), each channel normalized to zero mean and unit std over
    the whole descriptor set so levels of other dynamic ranges weigh
    alike."""
    b, _, _, c = level.shape
    n = b * patches_per_image
    d = torch.arange(patch_size, device=level.device)
    bs = torch.arange(b, device=level.device).repeat_interleave(
        patches_per_image)
    rows = ys.to(level.device)[:, None, None] + d[None, :, None]
    cols = xs.to(level.device)[:, None, None] + d[None, None, :]
    patches = level[bs[:, None, None], rows, cols]      # (n, ps, ps, C)
    mean = patches.mean(dim=(0, 1, 2), keepdim=True)
    std = patches.std(dim=(0, 1, 2), correction=0, keepdim=True)
    patches = (patches - mean) / torch.clamp(std, min=1e-8)
    return patches.reshape(n, patch_size * patch_size * c)


def sliced_wasserstein(a: torch.Tensor, b: torch.Tensor,
                       dirs: torch.Tensor) -> torch.Tensor:
    """SWD between two descriptor sets a, b: (N, D), over the unit
    directions of ``dirs`` (D, n_proj): the mean over directions and ranks
    of |sorted a·u − sorted b·u|, the exact 1-D Wasserstein-1 distance per
    direction."""
    if a.shape != b.shape:
        raise ValueError(f"descriptor sets differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    dirs = dirs.to(a.device, torch.float32)
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=0,
                                                       keepdim=True),
                              min=1e-12)
    with _no_tf32():
        pa = torch.sort(a @ dirs, dim=0).values
        pb = torch.sort(b @ dirs, dim=0).values
    return torch.mean(torch.abs(pa - pb))


def swd(real: torch.Tensor, fake: torch.Tensor,
        generator: torch.Generator | None = None, *, draws=None,
        min_res: int = 16, patches_per_image: int = 64, patch_size: int = 7,
        n_proj: int = 128) -> dict[str, torch.Tensor]:
    """Multi-scale SWD between two image sets (×1e3, lower is better).

    real, fake: (N, H, W, C), any float range (the descriptors are
    channel-normalized). Levels go down to ``min_res``. The draws come
    from ``generator`` unless given as ``draws`` (:func:`swd_draws`'s
    form). Returns ``{"swd_<res>": value}`` per level and ``"swd_avg"``,
    0-d float32 tensors."""
    if real.shape != fake.shape:
        raise ValueError(f"image sets differ: {tuple(real.shape)} vs "
                         f"{tuple(fake.shape)}")
    n_levels = _n_levels(min(real.shape[1], real.shape[2]), min_res,
                         patch_size)
    pyr_r = laplacian_pyramid(real, n_levels)
    pyr_f = laplacian_pyramid(fake, n_levels)
    if draws is None:
        if generator is None:
            raise ValueError("swd needs a generator or draws")
        draws = swd_draws([tuple(lv.shape) for lv in pyr_r], generator,
                          patches_per_image=patches_per_image,
                          patch_size=patch_size, n_proj=n_proj)
    out = {}
    vals = []
    for lr, lf, (ys, xs, dirs) in zip(pyr_r, pyr_f, draws, strict=True):
        da = _patch_descriptors(lr, ys, xs, patches_per_image, patch_size)
        db = _patch_descriptors(lf, ys, xs, patches_per_image, patch_size)
        v = sliced_wasserstein(da, db, dirs) * 1e3
        out[f"swd_{lr.shape[1]}"] = v
        vals.append(v)
    out["swd_avg"] = torch.mean(torch.stack(vals))
    return out
