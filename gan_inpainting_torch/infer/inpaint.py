"""Inference: ``inpaint(image, mask)`` and the bucketed batch server.

normalize → generator → composite on the raw uint8 input (known pixels
bit-exact) → uint8. Inputs are padded up to the nearest configured
(batch, size) bucket, as in the JAX package, so every request runs one of a
fixed set of shapes; non-square images pad H and W to the square bucket of
the larger side and are cropped back.

An :class:`Inpainter` serves over its config's mesh, which is every local
card by default, as the JAX package's is: one generator replica per group
of ``train.mesh.model`` consecutive devices (one per device without a
model axis), each fed by a persistent worker thread under
``torch.cuda.device`` of its card, the bucket rounded up to a multiple of
the replicas and split into equal contiguous shards that run at once.
PyTorch keeps cuDNN's tuned plans per thread, so a replica is tuned on its
own thread by the first batch of each bucket it runs (``warmup``). One
replica runs in the caller's thread.

Under ``model.tp_shard`` a replica's group computes one forward together,
as a ``(data, model)`` mesh does under GSPMD: member m, on the group's
m-th device with a thread of its own, holds a generator whose stacks'
convs compute its slice of the output channels from weights sliced once
(models/layers.py); after each such conv every member receives every
slice by a peer copy and concatenates them in member order
(parallel/sharding.py ``ThreadModelGroup``, no ``torch.distributed``);
the rest runs whole on every member, and member 0's output is served.
Without ``tp_shard`` the members would compute the same thing, so a group
runs on its first model index alone.

Over the mesh's spatial axis (``train.mesh.spatial`` = n > 1) each
replica's group holds ``model × n`` members, member ``r`` at model index
``r // n`` and spatial index ``r % n`` (parallel/mesh.py), each on a
thread and a device of its own, as the JAX ``Inpainter`` row-shards a
bucket over its spatial mesh (gan_inpainting_tpu/infer/inpaint.py:
114-151). The padded bucket is split into n row bands: member (j, i)
takes band i, every activation of its forward stays band i (models/
generator.py: conv halos from the neighbouring bands, contextual
attention over the gathered map), its row exchanges run among the
members of model index j (parallel/spatial.py ``ThreadSpatialGroup``)
and its channel gathers among those of spatial index i; the bands of
model index 0 are concatenated in order. Bands stay whole and aligned
through both stride-2 levels and the ``::4`` slices only where
``S % (4·n) == 0`` for a size bucket S; any other bucket runs unsharded
on the spatial index-0 members and is counted
(``sharding.counts["unsharded_forwards"]``), where JAX's GSPMD shards the
rows unevenly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import queue
import threading
import weakref
from concurrent.futures import Future

import numpy as np
import torch

from gan_inpainting_torch.configs.base import Config, InferConfig
from gan_inpainting_torch.data.pipeline import denormalize, normalize
from gan_inpainting_torch.models.generator import build_generator
from gan_inpainting_torch.ops.dispatch import resolve_device
from gan_inpainting_torch.parallel.mesh import build_mesh
from gan_inpainting_torch.parallel.sharding import (
    ModelGroup,
    ThreadModelGroup,
    _count,
)
from gan_inpainting_torch.parallel.spatial import ThreadSpatialGroup, splits
from gan_inpainting_torch.utils.spans import section, transfer


def _bucket(value: int, buckets) -> int:
    for b in sorted(buckets):
        if value <= b:
            return b
    raise ValueError(f"{value} exceeds largest bucket {max(buckets)}; "
                     f"configure a larger bucket in InferConfig")


def serve_forward(generator, images_u8: torch.Tensor,
                  masks: torch.Tensor) -> torch.Tensor:
    """The serve body, shared by the live forward and the AOT programs
    (io/aot.py): normalize → ``generator(masked, masks)`` → composite on
    the raw uint8 input → uint8.

    images_u8: (B, H, W, 3) uint8 tensor; masks: (B, H, W, 1) float32,
    1 = hole; both on the generator's device.
    """
    image = normalize(images_u8)
    masked = image * (1.0 - masks)
    fine = generator(masked, masks).fine.float()
    # composite on raw uint8: known pixels bit-exact
    return torch.where(masks <= 0.0, images_u8, denormalize(fine))


def make_forward_fn(cfg: Config, state_dict,
                    device: str | torch.device | None = None,
                    model_group: ModelGroup | None = None,
                    spatial_group: ThreadSpatialGroup | None = None):
    """The serve forward ``(images_u8, masks) → uint8`` on ``device``
    (:func:`serve_forward` under ``inference_mode``), as member
    ``model_group.index`` of a channel-sharded group and member
    ``spatial_group.index`` of a row-sharded one where they are given (its
    members call their forwards together, each on its row band)."""
    gen = build_generator(cfg.model, device=device, seed=None,
                          model_group=model_group,
                          spatial_group=spatial_group)
    gen.load_state_dict(state_dict)
    gen.eval()

    @torch.inference_mode()
    def fwd(images_u8: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        return serve_forward(gen, images_u8, masks)

    fwd.generator = gen      # for profiling tools
    return fwd


def serve_config(cfg: Config, size: int) -> Config:
    """The formulation a size bucket is served with: buckets above
    ``infer.fuse_upsample_max_size`` use the unfused decoder. Same weights
    and math either way."""
    if (cfg.model.fuse_upsample
            and size > cfg.infer.fuse_upsample_max_size):
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, fuse_upsample=False))
    return cfg


def device_scope(device: torch.device):
    """``torch.cuda.device`` of a card (a ``cuda`` device without an index
    means the calling thread's current card); a null context off the
    card."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(torch.cuda.current_device()
                             if device.index is None else device.index)


def _run_jobs(jobs: queue.SimpleQueue, device: torch.device) -> None:
    """A replica's worker thread: run each (fn, args, future) under the
    replica's card until a None arrives. It holds no reference to the
    Inpainter, so a dropped Inpainter can be collected and stop it."""
    with device_scope(device):
        while (job := jobs.get()) is not None:
            fn, args, fut = job
            try:
                fut.set_result(fn(*args))
            except Exception as e:  # noqa: BLE001 — raised by the caller
                fut.set_exception(e)
            del job, fn, args, fut


def _start_worker(device: torch.device, name: str):
    jobs: queue.SimpleQueue = queue.SimpleQueue()
    thread = threading.Thread(target=_run_jobs, args=(jobs, device),
                              daemon=True, name=name)
    thread.start()
    return jobs, thread


def _stop_workers(workers) -> None:
    for jobs, _ in workers:
        jobs.put(None)
    for _, thread in workers:
        # the collector may run this on a worker thread itself
        if thread is not threading.current_thread():
            thread.join()


class Inpainter:
    """Serves inpaint requests from a generator ``state_dict`` (see
    :func:`gan_inpainting_torch.io.convert.params_from_jax`) or, through
    :meth:`from_npz`, from an exported artifact.

    Where it runs, with n = ``cfg.train.mesh.model`` ×
    ``cfg.train.mesh.spatial``: an explicit ``devices`` list gives one
    replica on each n consecutive devices (a device may repeat; a count
    not divisible by n raises the mesh's ``ValueError``); an explicit
    ``device`` one replica there (its n members share it); otherwise
    ``cfg.train.mesh`` over the local cards (``data = -1``, the default,
    is every card; ``data = d`` the first d·n; more than the cards raises
    the mesh's ``ValueError``), and an error when there is no card.
    ``close()`` stops the replicas' threads (collecting the Inpainter does
    too)."""

    def __init__(self, cfg: Config, state_dict,
                 device: str | torch.device | None = None,
                 devices=None):
        self.cfg = cfg
        axes = dataclasses.replace(cfg.train.mesh, data=-1)
        if devices is not None:
            devices = tuple(torch.device(d) for d in devices)
            if not devices:
                raise ValueError("devices is empty")
            mesh = build_mesh(axes, devices)
        elif device is not None:
            mesh = build_mesh(axes, (resolve_device(device),)
                              * (axes.model * axes.spatial))
        else:
            resolve_device(None)            # raises without a card
            cards = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
            mesh = build_mesh(cfg.train.mesh, cards)
        self.devices = mesh.devices
        self.device = self.devices[0]
        # the members that compute: every model index under channel
        # sharding, else model index 0; each with its spatial indices
        self.model_axis = mesh.model if cfg.model.tp_shard else 1
        self.spatial = mesh.spatial
        self.groups = tuple(g[:self.model_axis * self.spatial]
                            for g in mesh.groups)
        if any(d.type == "cuda" for d in self.devices):
            # every request runs one of a fixed set of bucket shapes, so
            # cuDNN's per-shape algorithm search pays once per bucket (as
            # the JAX package compiles once per bucket); its heuristic
            # choice for the dilation-16 convs is ~300x slower on an H100
            # (PERF.md)
            torch.backends.cudnn.benchmark = True
        self.state_dict = state_dict
        # each member's (model group, spatial group): member r = j·n + i
        # shares a model group with the members of spatial index i and a
        # spatial group with those of model index j
        self._axes = [self._member_axes() for _ in self.groups]
        # one generator per member, decoder formulation and row sharding:
        # eager PyTorch needs no program per bucket shape. _forward is the
        # first replica's first member's whole-map one (profiling tools
        # call it)
        self._forwards = [
            [functools.lru_cache(maxsize=None)(functools.partial(
                self._build_forward, replica=i, member=m))
             for m in range(len(g))]
            for i, g in enumerate(self.groups)]
        self._forward = self._forwards[0][0]
        # a thread per replica (where there are several) runs its member 0;
        # a thread per further member runs that member
        self._workers, self._member_workers = [], []
        for i, group in enumerate(self.groups):
            if len(self.groups) > 1:
                self._workers.append(_start_worker(group[0],
                                                   f"inpaint-replica-{i}"))
            self._member_workers.append([
                _start_worker(dev, f"inpaint-replica-{i}-member-{m}")
                for m, dev in enumerate(group) if m > 0])
        self.close = weakref.finalize(
            self, _stop_workers,
            self._workers + [w for ws in self._member_workers for w in ws])

    @classmethod
    def from_npz(cls, path: str, overrides: list[str] | None = None,
                 device: str | torch.device | None = None,
                 devices=None) -> "Inpainter":
        """Serve from a portable export artifact: the generator params plus
        the embedded config. ``overrides`` apply on top of that config."""
        from gan_inpainting_torch.configs.base import apply_overrides
        from gan_inpainting_torch.io.convert import params_from_jax
        from gan_inpainting_torch.io.export import load_generator

        cfg, params = load_generator(path)
        if overrides:
            cfg = apply_overrides(cfg, list(overrides))
        return cls(cfg, params_from_jax(params), device=device,
                   devices=devices)

    @classmethod
    def from_checkpoint(cls, cfg: Config, workdir: str | None = None, *,
                        use_ema: bool = True, best: bool = False,
                        step: int | None = None,
                        device: str | torch.device | None = None,
                        devices=None) -> "Inpainter":
        """Serve from a training checkpoint under ``workdir`` (default
        ``cfg.train.workdir``): with ``use_ema`` the EMA generator when the
        run tracked one, else the raw parameters; ``best`` takes the
        best-eval-PSNR slot (``checkpoints_best``). The model is the
        checkpoint's own saved one; ``cfg`` supplies the serving knobs
        (``infer``, and the mesh with ``model.tp_shard``: how the model
        is laid over the devices, not what it computes)."""
        from gan_inpainting_torch.configs.base import config_from_dict
        from gan_inpainting_torch.io.checkpoint import CheckpointManager

        subdir = "checkpoints_best" if best else "checkpoints"
        ckpt = CheckpointManager(workdir or cfg.train.workdir, subdir=subdir)
        saved = config_from_dict(ckpt.restore_config(step))
        raw = ckpt.restore_raw(step)
        params = (raw["g_ema"] if use_ema and raw["g_ema"]
                  else raw["g_params"])
        model = dataclasses.replace(saved.model,
                                    tp_shard=cfg.model.tp_shard)
        return cls(dataclasses.replace(cfg, model=model), params,
                   device=device, devices=devices)

    # ------------------------------------------------------------------
    def _cfg_for_size(self, size: int) -> Config:
        """The formulation of a size bucket (:func:`serve_config`)."""
        return serve_config(self.cfg, size)

    def _member_axes(self) -> list[tuple]:
        """One replica's (model group, spatial group) per member, None
        where an axis has one member."""
        m, n = self.model_axis, self.spatial
        models = [ThreadModelGroup.members(m) if m > 1 else [None] * m
                  for _ in range(n)]
        rows = [ThreadSpatialGroup.members(n) if n > 1 else [None] * n
                for _ in range(m)]
        return [(models[r % n][r // n], rows[r // n][r % n])
                for r in range(m * n)]

    def _exchanges(self, replica: int):
        return [g for axes in self._axes[replica] for g in axes
                if g is not None]

    def row_sharded(self, size: int) -> bool:
        """True where a size bucket splits into row bands that stay whole
        and aligned through both stride-2 levels and the ``::4`` slices
        (:func:`~gan_inpainting_torch.parallel.spatial.splits`)."""
        return splits(size, self.spatial)

    def _build_forward(self, fuse_upsample: bool, rows: bool = False,
                       *, replica: int, member: int = 0):
        cfg = dataclasses.replace(
            self.cfg, model=dataclasses.replace(self.cfg.model,
                                                fuse_upsample=fuse_upsample))
        model_group, spatial_group = self._axes[replica][member]
        return make_forward_fn(cfg, self.state_dict,
                               self.groups[replica][member], model_group,
                               spatial_group if rows else None)

    def _run_member(self, replica: int, member: int, fuse_upsample: bool,
                    images_u8, masks) -> torch.Tensor:
        """One member's forward of its replica's shard (its row band where
        the bucket is row-sharded), on its device; a failure releases
        every member of the replica from its exchanges."""
        dev = self.groups[replica][member]
        rows = self.row_sharded(images_u8.shape[1])
        if rows:
            band = images_u8.shape[1] // self.spatial
            i = member % self.spatial
            images_u8, masks = (np.ascontiguousarray(a[:, i * band:
                                                       (i + 1) * band])
                                for a in (images_u8, masks))
        try:
            # the whole-map forward's cache key is (fuse_upsample,) alone
            fwd = self._forwards[replica][member]
            fwd = fwd(fuse_upsample, True) if rows else fwd(fuse_upsample)
            with section("inpaint.h2d"):
                images, masks = (transfer(torch.from_numpy(a), dev)
                                 for a in (images_u8, masks))
            with section("inpaint.forward"):
                return fwd(images, masks)
        except BaseException:
            for group in self._exchanges(replica):
                group.abort()
            raise

    def _run(self, replica: int, fuse_upsample: bool, images_u8, masks,
             rows: int, h: int, w: int) -> np.ndarray:
        """One replica's shard: the forward on its group (member 0 in this
        thread, the others on theirs; an unsharded bucket on the spatial
        index-0 members alone), the row bands of model index 0 in order,
        their first ``rows`` outputs cropped to (h, w) and brought to the
        host."""
        n = self.spatial
        members = range(1, len(self.groups[replica]))
        if n > 1 and not self.row_sharded(images_u8.shape[1]):
            members = [m for m in members if m % n == 0]
            _count("unsharded_forwards")
        futures = {}
        for m in members:
            jobs, _ = self._member_workers[replica][m - 1]
            fut: Future = Future()
            jobs.put((self._run_member, (replica, m, fuse_upsample,
                                         images_u8, masks), fut))
            futures[m] = fut
        errors, bands = [], {}
        try:
            bands[0] = self._run_member(replica, 0, fuse_upsample,
                                        images_u8, masks)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)
        for m, fut in futures.items():
            try:
                bands[m] = fut.result()
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)
        if errors:
            for group in self._exchanges(replica):
                group.reset()
            # the first failure, not the others' broken barrier
            raise next((e for e in errors if not isinstance(
                e, threading.BrokenBarrierError)), errors[0])
        # model index 0's bands: members 0 .. n − 1 (member 0 alone when
        # the bucket ran unsharded)
        with section("inpaint.d2h"):
            out = [transfer(bands[m][:rows], "cpu").numpy()
                   for m in range(n) if m in bands]
        with section("inpaint.crop"):
            out = out[0] if len(out) == 1 else np.concatenate(out, 1)
            return out[:, :h, :w, :]

    # ------------------------------------------------------------------
    def inpaint_batch(self, images_u8, masks) -> np.ndarray:
        """Batched API. images: (B,H,W,3) uint8; masks: (B,H,W[,1]), 1=hole.
        Spanned as ``inpaint.prepare`` (checks, bucket pad),
        ``inpaint.h2d``, ``inpaint.forward`` (its launch), ``inpaint.d2h``
        (the wait included) and ``inpaint.crop``."""
        with section("inpaint.prepare"):
            images_u8, masks, fuse, b, h, w = self._prepare(images_u8, masks)
        n = len(self.groups)
        if n == 1:
            return self._run(0, fuse, images_u8, masks, b, h, w)
        shard = len(images_u8) // n
        futures = []
        for i, (jobs, _) in enumerate(self._workers):
            part = slice(i * shard, (i + 1) * shard)
            fut: Future = Future()
            rows = min(shard, max(b - i * shard, 0))
            jobs.put((self._run, (i, fuse, images_u8[part], masks[part],
                                  rows, h, w), fut))
            futures.append(fut)
        # wait for every shard, then raise the first error
        outs, errors = [], []
        for fut in futures:
            try:
                outs.append(fut.result())
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
        if errors:
            raise errors[0]
        return np.concatenate(outs)

    def _prepare(self, images_u8, masks):
        """The request as arrays padded to its bucket, checked; the size
        bucket's decoder formulation; the request's (B, H, W)."""
        images_u8 = np.asarray(images_u8, np.uint8)
        masks = np.asarray(masks, np.float32)
        if masks.ndim == 3:
            masks = masks[..., None]
        b, h, w, _ = images_u8.shape
        if masks.shape[:3] != (b, h, w):
            raise ValueError(
                f"mask shape {masks.shape[:3]} does not match images "
                f"{(b, h, w)}")
        icfg: InferConfig = self.cfg.infer
        n = len(self.groups)
        # the bucket rounds up to a multiple of the replicas, so every
        # shard is whole (gan_inpainting_tpu/infer/inpaint.py:175-176)
        bb = -(-_bucket(b, icfg.batch_buckets) // n) * n
        sb = _bucket(max(h, w), icfg.size_buckets)
        if sb != h or sb != w:
            # padded area is "known" (mask 0): context, cropped off below
            widths = ((0, 0), (0, sb - h), (0, sb - w), (0, 0))
            images_u8 = np.pad(images_u8, widths)
            masks = np.pad(masks, widths)
        if bb != b:
            reps = ((0, bb - b),) + ((0, 0),) * 3
            images_u8 = np.pad(images_u8, reps)
            masks = np.pad(masks, reps)
        fuse = self._cfg_for_size(sb).model.fuse_upsample
        return images_u8, masks, fuse, b, h, w

    def __call__(self, image, mask) -> np.ndarray:
        """Single-image API: (H,W,3) uint8 + (H,W[,1]) mask → (H,W,3) uint8."""
        out = self.inpaint_batch(np.asarray(image)[None],
                                 np.asarray(mask)[None])
        return out[0]

    def warmup(self):
        """Run every configured bucket once (kernel build, cuDNN plans)."""
        for b in self.cfg.infer.batch_buckets:
            for s in self.cfg.infer.size_buckets:
                img = np.zeros((b, s, s, 3), np.uint8)
                msk = np.zeros((b, s, s, 1), np.float32)
                self.inpaint_batch(img, msk)


def inpaint(image, mask, *, inpainter: Inpainter | None = None,
            npz: str | None = None, cfg: Config | None = None,
            workdir: str | None = None,
            device: str | torch.device | None = None) -> np.ndarray:
    """One-shot ``inpaint(image, mask)``: with an :class:`Inpainter`, from
    an export ``npz``, or from the latest checkpoint of ``cfg``'s (or
    ``workdir``'s) training run."""
    if inpainter is None:
        if npz is not None:
            inpainter = Inpainter.from_npz(npz, device=device)
        else:
            if cfg is None:
                from gan_inpainting_torch.configs.base import get_config

                cfg = get_config("celeba128_center")
            inpainter = Inpainter.from_checkpoint(cfg, workdir,
                                                  device=device)
    return inpainter(image, mask)
