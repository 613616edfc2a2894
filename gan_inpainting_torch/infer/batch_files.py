"""Directory-batch inference: inpaint a folder of images.

Pairs images with masks by filename stem, groups them by size bucket, and
drives :meth:`Inpainter.inpaint_batch` with full batches, so a folder run
gets the serving path's batches instead of one dispatch per file.
"""

from __future__ import annotations

import pathlib

import numpy as np

from gan_inpainting_torch.infer.inpaint import Inpainter, _bucket

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _list_images(root: pathlib.Path) -> list[pathlib.Path]:
    return sorted(p for p in root.iterdir()
                  if p.suffix.lower() in _EXTS and p.is_file())


def _pair_mask(mask_dir: pathlib.Path, image: pathlib.Path) -> pathlib.Path:
    for ext in (image.suffix,) + _EXTS:
        cand = mask_dir / (image.stem + ext)
        if cand.exists():
            return cand
    raise FileNotFoundError(
        f"no mask for {image.name} in {mask_dir} (looked for stem "
        f"{image.stem!r} with extensions {_EXTS})")


def inpaint_dir(inpainter: Inpainter, image_dir: pathlib.Path,
                mask_dir: pathlib.Path, out_dir: pathlib.Path,
                *, batch_size: int | None = None) -> int:
    """Inpaint every image in ``image_dir`` against its filename-paired
    mask in ``mask_dir`` (> 127 is a hole); writes PNGs of the same stems
    into ``out_dir``. Returns the number of images written."""
    from PIL import Image

    image_dir, mask_dir, out_dir = (pathlib.Path(image_dir),
                                    pathlib.Path(mask_dir),
                                    pathlib.Path(out_dir))
    if not mask_dir.is_dir():
        raise NotADirectoryError(f"--mask must be a directory when --image "
                                 f"is one (got {mask_dir})")
    images = _list_images(image_dir)
    if not images:
        raise FileNotFoundError(f"no images ({'/'.join(_EXTS)}) in "
                                f"{image_dir}")
    out_dir.mkdir(parents=True, exist_ok=True)
    if batch_size is None:
        batch_size = max(inpainter.cfg.infer.batch_buckets)

    # group by size bucket so every dispatch is one bucket shape
    buckets: dict[int, list[tuple[pathlib.Path, np.ndarray, np.ndarray]]] = {}
    for path in images:
        img = np.asarray(Image.open(path).convert("RGB"))
        mask = (np.asarray(
            Image.open(_pair_mask(mask_dir, path)).convert("L")) > 127)
        if mask.shape != img.shape[:2]:
            raise ValueError(f"{path.name}: mask shape {mask.shape} does "
                             f"not match image {img.shape[:2]}")
        sb = _bucket(max(img.shape[:2]), inpainter.cfg.infer.size_buckets)
        buckets.setdefault(sb, []).append(
            (path, img, mask.astype(np.float32)))

    written = 0
    for sb in sorted(buckets):
        group = buckets[sb]
        for lo in range(0, len(group), batch_size):
            chunk = group[lo:lo + batch_size]
            n = len(chunk)
            batch_img = np.zeros((n, sb, sb, 3), np.uint8)
            batch_msk = np.zeros((n, sb, sb, 1), np.float32)
            for i, (_, img, mask) in enumerate(chunk):
                h, w = img.shape[:2]
                batch_img[i, :h, :w] = img
                batch_msk[i, :h, :w, 0] = mask
            out = inpainter.inpaint_batch(batch_img, batch_msk)
            for i, (path, img, _) in enumerate(chunk):
                h, w = img.shape[:2]
                Image.fromarray(out[i, :h, :w]).save(
                    out_dir / (path.stem + ".png"))
                written += 1
    return written
