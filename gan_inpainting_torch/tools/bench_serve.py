"""Time serving at one size bucket through Inpainter, on one CUDA card.

    python -m gan_inpainting_torch.tools.bench_serve [--size 512]
        [--batches 1,8,64] [--reps 5] [--turns 2]
        [--fused-max-cells 2048,4096] [--backend auto,pallas]
        [--config partialconv256]

Serves the pinned tex256_attn generator (bf16, as ``chip_smoke.py`` [3]
serves it) — or, with ``--config``, that config's generator from a seeded
initialization — under each ``model.kernel_backend`` value of
``--backend`` at one size bucket and each batch bucket, on random uint8
images with a rectangular hole, and prints one JSON line per backend and
batch: the ms
of ``inpaint_batch`` (host uint8 in and out) and of the device forward
alone (CUDA events), per turn; the contextual-attention kernels launched
by one forward (which route the map took); and the card's name and power
limit. With ``--fused-max-cells``, each value is set as the route limit
of a bf16 forward (``fused_attention.FUSED_MAX_CELLS_BF16_FORWARD``) in
its turns (a b b a), so the two routes are compared in one process.

It uses only entry points that every version of the port has
(``Inpainter``, ``dispatch.launches``), so two versions can be timed in
turns on one card: run this file as a script with ``PYTHONPATH`` at the
other checkout, e.g. ``PYTHONPATH=../parent python
gan_inpainting_torch/tools/bench_serve.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

NPZ = "docs/artifacts/tex256_attn/generator_best.npz"
OVERRIDES = ["model.fuse_upsample=true", "infer.size_buckets=256,512",
             "infer.batch_buckets=1,8,64"]
ATTENTION = ("contextual_attention_fused", "fold_taps", "patch_attention_fwd")


def _inputs(b: int, s: int):
    rng = np.random.default_rng(b)
    img = rng.integers(0, 256, (b, s, s, 3), np.uint8)
    msk = np.zeros((b, s, s), np.float32)
    msk[:, s // 4:s // 2, s // 8:s // 2] = 1.0
    return img, msk


def bench(inp, b: int, s: int, reps: int, order) -> dict:
    """ms of inpaint_batch and of the device forward at batch b, size s,
    in the turns ``order`` (values of the bf16 forward's route limit, None =
    as shipped)."""
    from gan_inpainting_torch.ops import dispatch
    from gan_inpainting_torch.ops.kernels import fused_attention

    # the limit a bf16 forward without backward reads (one limit for both
    # in versions before it was split)
    name = ("FUSED_MAX_CELLS_BF16_FORWARD"
            if hasattr(fused_attention, "FUSED_MAX_CELLS_BF16_FORWARD")
            else "FUSED_MAX_CELLS")
    shipped = getattr(fused_attention, name)
    img, msk = _inputs(b, s)
    dev_img = torch.from_numpy(img).cuda()
    dev_msk = torch.from_numpy(msk[..., None]).cuda()
    fwd = inp._forward(inp._cfg_for_size(s).model.fuse_upsample)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    res = {}
    for cells in order:
        setattr(fused_attention, name, shipped if cells is None else cells)
        key = "shipped" if cells is None else f"max_cells_{cells}"
        r = res.setdefault(key, {"api_ms": [], "fwd_ms": []})
        if "launches" not in r:            # first use: cuDNN plans, kernels
            inp.inpaint_batch(img, msk)
            dispatch.reset_launches()
            fwd(dev_img, dev_msk)
            torch.cuda.synchronize()
            r["launches"] = {k: dispatch.launches.get(k, 0)
                             for k in ATTENTION}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            inp.inpaint_batch(img, msk)
        r["api_ms"].append((time.perf_counter() - t0) * 1e3 / reps)
        start.record()
        for _ in range(reps):
            fwd(dev_img, dev_msk)
        end.record()
        torch.cuda.synchronize()
        r["fwd_ms"].append(start.elapsed_time(end) / reps)
    setattr(fused_attention, name, shipped)
    res["limit"] = {name: shipped}
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--fused-max-cells", default=None,
                    help="two comma-separated values taken in turns a b b a")
    ap.add_argument("--backend", default="auto",
                    help="comma-separated model.kernel_backend values")
    ap.add_argument("--config", default=None,
                    help="serve this config's generator from seed 0 instead "
                    "of the pinned npz")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    from gan_inpainting_torch.infer.inpaint import Inpainter

    if args.fused_max_cells:
        a, b = (int(x) for x in args.fused_max_cells.split(","))
        order = [a, b, b, a] * (args.turns // 2) or [a, b]
    else:
        order = [None] * args.turns
    for backend in args.backend.split(","):
        overrides = OVERRIDES + [f"model.kernel_backend={backend}"]
        if args.config:
            from gan_inpainting_torch.configs.base import (
                apply_overrides,
                get_config,
            )
            from gan_inpainting_torch.models.generator import build_generator

            cfg = apply_overrides(get_config(args.config), overrides[1:])
            params = build_generator(cfg.model, device="cuda",
                                     seed=0).state_dict()
            inp = Inpainter(cfg, params, device="cuda")
        else:
            inp = Inpainter.from_npz(NPZ, overrides=overrides, device="cuda")
        for b in (int(x) for x in args.batches.split(",")):
            res = bench(inp, b, args.size, args.reps, order)
            print(json.dumps(dict(config=args.config or "tex256_attn",
                                  backend=backend, batch=b, size=args.size,
                                  reps=args.reps, card=smi, **res)),
                  flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
