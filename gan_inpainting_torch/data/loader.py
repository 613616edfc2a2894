"""Dataset iterators: endless uint8 (B, S, S, 3) batches on the device.

Two backends behind :func:`make_dataset`, as in the JAX package:

* ``synthetic``: images rendered on the device from a seed
  (data/synthetic.py); no host IO.
* ``folder``: the image files under ``data.root`` (CelebA-HQ, Places2 or a
  user's own), center-cropped and resized on the host: JPEG batches by the
  native libjpeg loader (data/native_loader.py), anything else (and a JPEG
  the native loader fails on) by PIL. Every 20th file of the sorted list
  is the eval split. Each epoch is a permutation from
  ``np.random.default_rng(seed)``, so the port takes the same files in the
  same batches as the JAX package. Without the decode-once cache one index
  producer feeds ``loader_threads`` decoders and a ``prefetch_batches``
  queue; with more than one decoder the order of batches within an epoch
  is not fixed, only the set. The iterator stops its threads when it is
  closed or collected.

Mask synthesis and normalization happen on the device (data/pipeline.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from gan_inpainting_torch.configs.base import DataConfig
from gan_inpainting_torch.data.synthetic import synthetic_batch_u8
from gan_inpainting_torch.utils.rng import STREAM_DATA, stream_generator

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
_CACHE_DIR = "~/.cache/gan_inpainting_torch"


def source_size(cfg: DataConfig, split: str = "train") -> int:
    """Side of the images a split is supplied at: with ``random_crop`` the
    train split gets 9/8 of the train size and the batch maker crops."""
    if split == "train" and cfg.random_crop:
        return cfg.image_size * 9 // 8
    return cfg.image_size


def _synthetic_iter(cfg: DataConfig, seed: int, batch_size: int, size: int,
                    split: str, device, start: int) -> Iterator[torch.Tensor]:
    # synthetic_size is the virtual dataset length: after that many images
    # the stream wraps, as epochs over a finite folder would
    per_epoch = max(cfg.synthetic_size // batch_size, 1)
    split_id = 0 if split == "train" else 1
    step = start
    while True:
        gen = stream_generator(seed, STREAM_DATA, step % per_epoch, split_id)
        yield synthetic_batch_u8(gen, batch_size, size, cfg.synthetic_family,
                                 device)
        step += 1


def _load_image(path: pathlib.Path, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        # center crop to a square, then resize
        w, h = im.size
        s = min(w, h)
        left, top = (w - s) // 2, (h - s) // 2
        im = im.crop((left, top, left + s, top + s))
        im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def _load_batch(files: list[pathlib.Path], size: int) -> np.ndarray:
    """Decode a batch: the native loader where every file is a JPEG, with
    PIL as the second opinion on a file it fails on; PIL for the rest."""
    from gan_inpainting_torch.data import native_loader

    jpeg = all(p.suffix.lower() in (".jpg", ".jpeg") for p in files)
    if jpeg and native_loader.available():
        batch, ok = native_loader.load_batch([str(p) for p in files], size)
        for i in np.flatnonzero(~ok):
            batch[i] = _load_image(files[i], size)
        return batch
    return np.stack([_load_image(p, size) for p in files])


def _cache_wanted(cfg: DataConfig) -> bool:
    if cfg.loader_cache == "on":
        return True
    if cfg.loader_cache == "off":
        return False
    if cfg.loader_cache != "auto":
        raise ValueError(f"loader_cache must be auto|on|off, "
                         f"got {cfg.loader_cache!r}")
    return cfg.image_size <= 256


def _cache_array(files: list[pathlib.Path], size: int,
                 cache_dir: str) -> np.memmap:
    """Decode-once uint8 cache: one (N, size, size, 3) memmap per (file
    list, size), named by a digest of a manifest (paths, mtimes, size) that
    is kept beside it, so a changed dataset gets a new cache. Built under a
    temporary name and renamed, so a killed build leaves no cache."""
    base = pathlib.Path(cache_dir or os.path.expanduser(_CACHE_DIR))
    base.mkdir(parents=True, exist_ok=True)
    manifest = {
        "size": size,
        "files": [[str(p), p.stat().st_mtime_ns] for p in files],
    }
    digest = hashlib.sha256(
        json.dumps(manifest, sort_keys=True).encode()).hexdigest()[:24]
    data_path = base / f"{digest}_{size}.u8"
    shape = (len(files), size, size, 3)
    if not data_path.exists():
        tmp = data_path.with_suffix(f".building{os.getpid()}")
        mm = np.memmap(tmp, dtype=np.uint8, mode="w+", shape=shape)
        chunk = 64
        for start in range(0, len(files), chunk):
            mm[start:start + chunk] = _load_batch(
                files[start:start + chunk], size)
        mm.flush()
        del mm
        (base / f"{digest}_{size}.json").write_text(json.dumps(manifest))
        os.replace(tmp, data_path)
    return np.memmap(data_path, dtype=np.uint8, mode="r", shape=shape)


def split_files(cfg: DataConfig, split: str) -> list[pathlib.Path]:
    """The image files of a split: every 20th of the sorted list is eval."""
    root = pathlib.Path(cfg.root)
    files = sorted(p for p in root.rglob("*")
                   if p.suffix.lower() in _IMG_EXTS)
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return [p for i, p in enumerate(files)
            if (i % 20 == 0) == (split == "eval")]


def _index_batches(n: int, batch_size: int, seed: int,
                   start: int) -> Iterator[np.ndarray]:
    """File indices per batch: an epoch is a permutation and its tail
    short of a batch is dropped. ``start`` skips batches by drawing the
    skipped epochs' permutations, without decoding them."""
    per_epoch = n // batch_size
    rng = np.random.default_rng(seed)
    for _ in range(start // per_epoch):
        rng.permutation(n)
    first = start % per_epoch * batch_size
    while True:
        idx = rng.permutation(n)
        for s in range(first, n - batch_size + 1, batch_size):
            yield idx[s:s + batch_size]
        first = 0


def _folder_iter(cfg: DataConfig, seed: int, batch_size: int, split: str,
                 size: int, device: torch.device,
                 start: int = 0) -> Iterator[torch.Tensor]:
    files = split_files(cfg, split)
    if len(files) < batch_size:
        raise ValueError(f"the {split} split of {cfg.root} holds "
                         f"{len(files)} images, fewer than a batch of "
                         f"{batch_size}")
    batches = _index_batches(len(files), batch_size, seed, start)
    # to a card: from a pinned buffer per batch, without waiting; the
    # caching host allocator keeps the buffer until its copy has run
    pin = device.type == "cuda"

    def staged(batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(batch)
        return t.pin_memory() if pin else t

    if _cache_wanted(cfg):
        cache = _cache_array(files, size, cfg.loader_cache_dir)
        for ids in batches:
            yield staged(np.ascontiguousarray(cache[ids])).to(
                device, non_blocking=pin)

    n_threads = max(int(cfg.loader_threads), 1)
    stop = threading.Event()
    idx_q: queue.Queue = queue.Queue(maxsize=2 * n_threads)
    out_q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch_batches, 1))

    def put(q: queue.Queue, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def index_producer():
        for ids in batches:
            if not put(idx_q, ids):
                return

    def decoder():
        while not stop.is_set():
            try:
                ids = idx_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                item = staged(_load_batch([files[i] for i in ids], size))
            except Exception as e:  # noqa: BLE001 — raised in the consumer
                item = e
            if not put(out_q, item):
                return

    threads = [threading.Thread(target=index_producer, daemon=True)]
    threads += [threading.Thread(target=decoder, daemon=True)
                for _ in range(n_threads)]
    for t in threads:
        t.start()
    try:
        while True:
            item = out_q.get()
            if isinstance(item, Exception):
                raise item
            yield item.to(device, non_blocking=pin)
    finally:
        stop.set()
        for t in threads:
            t.join()


def make_dataset(cfg: DataConfig, seed: int, split: str = "train",
                 batch_size: int | None = None, device="cpu",
                 start: int = 0) -> Iterator[torch.Tensor]:
    """Endless iterator of (B, S, S, 3) uint8 batches on ``device``. The
    eval split draws from a disjoint stream (synthetic) or files (folder).
    ``start`` skips batches: a resumed run continues where it stopped (the
    JAX package restarts a folder stream on resume)."""
    batch_size = batch_size or (cfg.batch_size if split == "train"
                                else cfg.eval_batch_size)
    size = source_size(cfg, split)
    device = torch.device(device)
    if cfg.dataset == "synthetic":
        return _synthetic_iter(cfg, seed, batch_size, size, split, device,
                               start)
    if cfg.dataset == "folder":
        return _folder_iter(cfg, seed, batch_size, split, size, device, start)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
