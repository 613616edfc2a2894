"""AOT serving artifacts through ``torch.export``: the counterpart of the
JAX package's ``io/aot.py`` (``export_serving``, ``AotInpainter``).

The ``.npz`` export (io/export.py) hands over the weights; this module
hands over the program: each (batch, size) serve bucket's forward —
normalize → generator → composite on the raw uint8 → denormalize, the
body the live ``Inpainter`` runs (``infer/inpaint.py serve_forward``) — is
traced ahead of time with ``torch.export`` and saved, so a serving
process runs inpainting from the artifact and the port's kernel ops alone,
with no model code and no tracing.

Artifact layout (a directory)::

    manifest.json        format, platform, buckets, formulations, pins
    params.npz           generator params under the JAX package's names
    fwd_<B>x<S>.pt2      one exported program per bucket

The weights are an input of every program (a dict through
``torch.func.functional_call``), not constants in it, so one weights file
feeds every bucket, as in the JAX package; ``params.npz`` is flattened with
the JAX leaf names (``io/convert.py params_to_jax``), so it reads in
either package as the ``.npz`` export does. Where the gated convs take
the kernels (``kernel_backend=pallas``), their weights in the kernel's
packed layout are a second input: ``AotInpainter`` packs them once at load
with ``pack_weights``, as the live path keeps one packed copy per
parameter (traced into each program, the packing took 2.7–4.4 ms per
64×256² forward on an H100, more than the forward's spread: PERF.md §5).

Where the port departs from the JAX module:

* each bucket is exported in the formulation the live ``Inpainter`` serves
  that size with (``serve_config``: the unfused decoder above
  ``infer.fuse_upsample_max_size``), recorded per bucket in the manifest;
  the JAX module traces one formulation for every size (ROADMAP Queue 3);
* a JAX program carries its kernels; a torch program calls them by op name
  (``gan_inpainting::*``, ops/kernels/library.py). A ``cuda`` artifact
  therefore pins the build hash of every kernel library its programs call,
  and the card's compute capability, and loading raises on a mismatch
  ("re-export with this build") — what keeps a saved artifact a frozen
  program. The manifest also records the torch version and each op's
  resolved ``kernel_backend``.

The programs run on the platform they were exported on (a ``cuda``
artifact on the card, a ``cpu`` artifact on the CPU); the first run of a
bucket on the card still tunes cuDNN's plans, as the live path's does.

An artifact is one device per program, as the JAX module's is (it builds
no mesh): exported under a config with ``train.mesh.spatial`` above 1,
``export_serving`` warns that the row split is not applied and the
manifest records ``devices_per_program`` 1; row-sharded serving is the
live ``Inpainter``'s.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings

import numpy as np
import torch

from gan_inpainting_torch.configs.base import Config, config_from_dict
from gan_inpainting_torch.io.export import _CONFIG_KEY, _flatten, _unflatten
from gan_inpainting_torch.ops.dispatch import (
    AUTO_CUDA,
    resolve_backend,
    resolve_device,
)
from gan_inpainting_torch.ops.kernels import library

_MANIFEST = "manifest.json"
_PARAMS = "params.npz"
_FORMAT = 1


def _bucket_file(batch: int, size: int) -> str:
    return f"fwd_{batch}x{size}.pt2"


class _ServeProgram(torch.nn.Module):
    """What one bucket's program computes: ``(params, images_u8, masks) →
    uint8``. The generator is held outside the module tree, so that
    ``torch.export`` lifts none of its tensors into the program: they come
    in as ``params`` through ``functional_call``."""

    def __init__(self, generator: torch.nn.Module):
        super().__init__()
        self.__dict__["generator"] = generator

    def forward(self, params, packed, images_u8, masks):
        from gan_inpainting_torch.infer.inpaint import serve_forward
        from gan_inpainting_torch.ops.kernels.gated_matmul import (
            given_packed,
        )

        def gen(masked, m):
            return torch.func.functional_call(self.generator, params,
                                              (masked, m))

        with given_packed({id(params[k]): t for k, t in packed.items()}):
            return serve_forward(gen, images_u8, masks)


def _kernel_packs(generator) -> dict[str, list]:
    """The gated convs whose weights the kernels take packed (the backend
    resolves to ``pallas``; the upsample and s2d rewrites do not go
    through them): parameter name → [Cin, F, dtype name]."""
    from gan_inpainting_torch.models.layers import InpaintConv

    return {f"{name}.weight": [m.weight.shape[1], m.weight.shape[0] // 2,
                               str(m.compute_dtype).removeprefix("torch.")]
            for name, m in generator.named_modules()
            if isinstance(m, InpaintConv) and m.conv_kind == "gated"
            and not (m.pre_upsample or m.s2d)
            and resolve_backend(m.backend, "gated_conv") == "pallas"}


def _pack(params: dict, packs: dict[str, list]) -> dict:
    """The packed copies ``packs`` names (see :func:`_kernel_packs`)."""
    from gan_inpainting_torch.ops.kernels.gated_matmul import (
        pack_weights,
        plan,
    )

    out = {}
    for name, (cin, features, dtype) in packs.items():
        dt = getattr(torch, dtype)
        out[name] = pack_weights(params[name].to(dt),
                                 plan(cin, features, dt))
    return out


def export_serving(cfg: Config, state_dict, outdir: str, *,
                   buckets: list[tuple[int, int]] | None = None,
                   device: str | torch.device | None = None) -> dict:
    """Write an AOT serving artifact of the generator ``state_dict`` (the
    port's names, as ``Inpainter`` takes it) to ``outdir``, its programs
    for ``device`` (the card unless the caller asks for another).

    ``buckets``: explicit ``(batch, size)`` list; defaults to the config's
    ``infer.batch_buckets`` × ``data.image_size``. Returns the manifest.
    """
    from gan_inpainting_torch.infer.inpaint import serve_config
    from gan_inpainting_torch.io.convert import params_to_jax
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.ops.kernels import build

    device = resolve_device(device)
    if cfg.train.mesh.spatial > 1:
        warnings.warn(
            f"train.mesh.spatial={cfg.train.mesh.spatial} is not applied: an "
            "AOT artifact runs each bucket's program whole on one device, "
            "as the JAX package's does; serve row-sharded through the live "
            "Inpainter", stacklevel=2)
    if buckets is None:
        buckets = [(b, cfg.data.image_size) for b in cfg.infer.batch_buckets]
    buckets = [(int(b), int(s)) for b, s in buckets]
    os.makedirs(outdir, exist_ok=True)
    params = {k: v.detach().to(device, torch.float32)
              for k, v in state_dict.items()}
    formulation, ops, packed, seconds = {}, {}, {}, {}
    for batch, size in buckets:
        t0 = time.perf_counter()
        bcfg = serve_config(cfg, size)
        # on the meta device: the program can only read the params input
        gen = build_generator(bcfg.model, device="meta", seed=None).eval()
        img = torch.zeros((batch, size, size, 3), dtype=torch.uint8,
                          device=device)
        msk = torch.zeros((batch, size, size, 1), dtype=torch.float32,
                          device=device)
        key = f"{batch}x{size}"
        packed[key] = _kernel_packs(gen)
        with torch.no_grad():
            ep = torch.export.export(
                _ServeProgram(gen),
                (params, _pack(params, packed[key]), img, msk), strict=False)
        if ep.state_dict or ep.constants:
            raise RuntimeError(
                f"bucket {batch}x{size}: the exported program holds "
                f"tensors {sorted(ep.state_dict)[:4]} "
                f"{sorted(ep.constants)[:4]}; the weights must be inputs")
        # the example inputs would carry the weights into every file
        ep.example_inputs = None
        torch.export.save(ep, os.path.join(outdir,
                                           _bucket_file(batch, size)))
        formulation[key] = {"fuse_upsample": bcfg.model.fuse_upsample}
        ops[key] = library.ops_in(ep.graph)
        seconds[key] = time.perf_counter() - t0

    flat = _flatten(params_to_jax(state_dict))
    with open(os.path.join(outdir, _PARAMS), "wb") as f:
        np.savez(f, **flat)

    sources = sorted({library.SOURCES[op] for names in ops.values()
                      for op in names})
    manifest = {
        "format": _FORMAT,
        "platform": device.type,
        "capability": (list(torch.cuda.get_device_capability(device))
                       if device.type == "cuda" else None),
        "torch_version": torch.__version__,
        "kernel_backend": {op: resolve_backend(cfg.model.kernel_backend, op)
                           for op in AUTO_CUDA},
        "buckets": [[b, s] for b, s in buckets],
        "devices_per_program": 1,
        "formulation": formulation,
        "ops": ops,
        "packed": packed,
        "export_seconds": seconds,
        # the CPU implementations are the plain versions: no library
        "kernels": ({name: build.build_hash(name) for name in sources}
                    if device.type == "cuda" else {}),
        "config": dataclasses.asdict(cfg),
    }
    with open(os.path.join(outdir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    return manifest


class AotInpainter:
    """Serve from an AOT artifact: the live
    :class:`~gan_inpainting_torch.infer.inpaint.Inpainter`'s bucketing and
    padding, but every bucket's program was traced at export — no model
    code, no tracing. Runs on ``device`` (the card unless the caller asks
    for another), which must be the artifact's platform: an artifact
    serves one device per program, as the JAX module's does, whatever mesh
    its config names (a whole, unsharded generator was traced)."""

    def __init__(self, path: str, device: str | torch.device | None = None):
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"{path}: unsupported artifact format "
                             f"{manifest.get('format')!r}")
        self.device = resolve_device(device)
        self.devices = (self.device,)
        if manifest["platform"] != self.device.type:
            raise ValueError(
                f"{path} was exported for {manifest['platform']!r} but this "
                f"process runs {self.device.type!r}; re-export on the "
                f"target platform")
        if self.device.type == "cuda":
            self._check_card(path, manifest)
            # one cuDNN plan search per bucket shape, as Inpainter does
            torch.backends.cudnn.benchmark = True
        library.load_all()

        self.path = path
        self.manifest = manifest
        self.buckets = [tuple(b) for b in manifest["buckets"]]
        # an infer config of the exported buckets, so that InpaintService
        # groups requests into buckets this artifact has programs for
        cfg = config_from_dict(manifest["config"])
        self.cfg = dataclasses.replace(cfg, infer=dataclasses.replace(
            cfg.infer,
            batch_buckets=tuple(sorted({b for b, _ in self.buckets})),
            size_buckets=tuple(sorted({s for _, s in self.buckets}))))
        from gan_inpainting_torch.io.convert import params_from_jax

        with np.load(os.path.join(path, _PARAMS)) as data:
            tree = _unflatten({k: data[k] for k in data.files
                               if k != _CONFIG_KEY})
        self.params = {k: v.to(self.device)
                       for k, v in params_from_jax(tree).items()}
        # the gated convs' weights in the kernels' layout, packed once
        packs: dict[str, list] = {}
        for names in manifest["packed"].values():
            packs.update(names)
        packed = _pack(self.params, packs)
        self.packed = {tuple(int(v) for v in key.split("x")):
                       {name: packed[name] for name in names}
                       for key, names in manifest["packed"].items()}
        self._programs: dict[tuple[int, int], torch.nn.Module] = {}

    def _check_card(self, path: str, manifest: dict) -> None:
        from gan_inpainting_torch.ops.kernels import build

        have = list(torch.cuda.get_device_capability(self.device))
        if manifest["capability"] != have:
            raise ValueError(
                f"{path} was exported for compute capability "
                f"{manifest['capability']} but this card is {have}; "
                f"re-export on the target card")
        stale = {name: (pinned, build.build_hash(name))
                 for name, pinned in manifest["kernels"].items()
                 if build.build_hash(name) != pinned}
        if stale:
            raise ValueError(
                f"{path} pins kernel builds that differ from this "
                f"checkout's (library: exported, here): {stale}; re-export "
                f"with this build")

    def _load(self, batch: int, size: int):
        key = (batch, size)
        if key not in self._programs:
            fname = os.path.join(self.path, _bucket_file(batch, size))
            self._programs[key] = torch.export.load(fname).module()
        return self._programs[key]

    def _pick_bucket(self, b: int, s: int) -> tuple[int, int]:
        fits = [(bb, bs) for bb, bs in self.buckets if bb >= b and bs >= s]
        if not fits:
            raise ValueError(
                f"no exported bucket fits batch={b} size={s}; have "
                f"{sorted(self.buckets)}")
        return min(fits)

    def inpaint_batch(self, images_u8, masks) -> np.ndarray:
        """Batched API: (B,H,W,3) uint8 + (B,H,W[,1]) masks, 1 = hole."""
        images_u8 = np.asarray(images_u8, np.uint8)
        masks = np.asarray(masks, np.float32)
        if masks.ndim == 3:
            masks = masks[..., None]
        b, h, w, _ = images_u8.shape
        if masks.shape[:3] != (b, h, w):
            raise ValueError(f"mask shape {masks.shape[:3]} does not match "
                             f"images {(b, h, w)}")
        # self.cfg presents every exported batch at every exported size, so
        # the service may group more requests than the buckets of their size
        # hold: serve those in chunks of the largest batch exported there
        cap = max((bb for bb, bs in self.buckets if bs >= max(h, w)),
                  default=b)
        if cap < b <= max(bb for bb, _ in self.buckets):
            return np.concatenate([
                self.inpaint_batch(images_u8[i:i + cap], masks[i:i + cap])
                for i in range(0, b, cap)])
        bb, sb = self._pick_bucket(b, max(h, w))
        if sb != h or sb != w:
            widths = ((0, 0), (0, sb - h), (0, sb - w), (0, 0))
            images_u8 = np.pad(images_u8, widths)
            masks = np.pad(masks, widths)
        if bb != b:
            reps = ((0, bb - b),) + ((0, 0),) * 3
            images_u8 = np.pad(images_u8, reps)
            masks = np.pad(masks, reps)
        program = self._load(bb, sb)
        with torch.inference_mode():
            out = program(self.params, self.packed[(bb, sb)],
                          torch.from_numpy(images_u8).to(self.device),
                          torch.from_numpy(masks).to(self.device))
        return out[:b, :h, :w, :].cpu().numpy()

    def __call__(self, image, mask) -> np.ndarray:
        """Single-image API, mirroring ``Inpainter.__call__``."""
        out = self.inpaint_batch(np.asarray(image)[None],
                                 np.asarray(mask)[None])
        return out[0]

    def warmup(self):
        """Load and first-run every exported bucket (the card's cuDNN
        plans are tuned there)."""
        for bb, sb in self.buckets:
            self.inpaint_batch(np.zeros((bb, sb, sb, 3), np.uint8),
                               np.zeros((bb, sb, sb, 1), np.float32))
