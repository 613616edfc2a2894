"""CLI: ``python -m gan_inpainting_torch <cmd> [--config NAME] [--device
DEV] [section.key=value ...]``.

Subcommands: ``configs``, ``train``, ``eval``, ``infer``, ``export``,
``mask``, ``serve``, ``profile``, ``parity`` and ``bench``, with the JAX
package's flags. Every command but ``configs`` runs on the CUDA card unless
``--device`` names another device, and raises when there is no card and
none is named (``export`` only moves weights between files, but checks
the same). ``export --aot`` writes an AOT serving artifact (io/aot.py:
one ``torch.export`` program per bucket beside the weights), and ``infer
--aot DIR`` / ``serve --aot DIR`` serve from one. ``bench --mode
infer|train`` prints one JSON line of throughput (bench.py): inpainted
images/sec of the config's generator, or its G+D train steps/sec.

Cards: ``torchrun --nproc-per-node N -m gan_inpainting_torch train ...``
trains over N cards, one rank each (``eval`` under ``torchrun`` reduces
over its ranks the same way, ``bench --mode train`` times the ranks'
steps, ``bench --mode infer`` one card per rank); only rank 0 prints.
``serve`` and ``infer`` serve over every local card of the config's mesh
unless ``--device`` pins one; ``eval`` without ``torchrun`` runs on one
card. The overrides ``train.mesh.model=M model.tp_shard=true`` add the
mesh's model axis: the N ranks form N / M model groups of M neighbouring
cards that train one batch slice each with the generator's convs
channel-sharded over the group, and ``serve`` / ``infer`` run each
replica over a group of M cards (with ``--device``, M members on that
one device). ``serve`` and ``infer`` also take ``train.mesh.spatial=S``:
each replica splits a request's rows over S cards (parallel/spatial.py),
and an S that needs more than the local cards raises the mesh's
``ValueError``; with ``--device`` the S members share that device.
``train`` and ``eval`` take it under ``torchrun --nproc-per-node
D·M·S``: each group of S neighbouring ranks trains (evaluates) one batch
slice, every rank on one row band of every activation, the row exchanges
and their gradients passed between the ranks (train/step.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

from gan_inpainting_torch.configs.base import (
    apply_overrides,
    get_config,
    list_configs,
)

def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", default="celeba128_center",
                   choices=list_configs())
    p.add_argument("--device", default=None,
                   help="torch device; default: CUDA (under torchrun the "
                   "rank's card; serve and infer: every card of the "
                   "config's mesh), and an error when there is none")
    p.add_argument("overrides", nargs="*",
                   help="config overrides, e.g. train.steps=100; "
                   "train.mesh.model=2 model.tp_shard=true shards the "
                   "generator's convs over groups of 2 cards; "
                   "train.mesh.spatial=2 splits each image's rows over 2 "
                   "cards (train and eval: launch data x model x spatial "
                   "ranks with torchrun)")


def _add_model_source(p: argparse.ArgumentParser, aot: bool = True):
    p.add_argument("--best", action="store_true",
                   help="use the best-PSNR retention checkpoint")
    p.add_argument("--weights", default=None,
                   help="exported .npz artifact instead of a checkpoint "
                   "(its embedded config wins; overrides still apply)")
    if aot:
        p.add_argument("--aot", default=None, metavar="DIR",
                       help="AOT artifact directory (export --aot): "
                       "exported programs, no model code or tracing")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="gan_inpainting_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("configs", help="list the named configs")

    p_train = sub.add_parser("train", help="run GAN training")
    _add_common(p_train)
    p_train.add_argument("--no-resume", action="store_true",
                         help="ignore checkpoints in the workdir")

    p_eval = sub.add_parser(
        "eval", help="eval.metrics (PSNR/SSIM/SWD) on held-out data")
    _add_common(p_eval)
    _add_model_source(p_eval, aot=False)

    p_inf = sub.add_parser(
        "infer", help="inpaint one image file, or a directory of "
        "filename-paired images and masks")
    _add_common(p_inf)
    p_inf.add_argument("--image", required=True,
                       help="image file, or directory of images")
    p_inf.add_argument("--mask", required=True,
                       help="mask file/directory; pixels > 127 are the "
                       "hole; directory masks pair with images by filename")
    p_inf.add_argument("--output", required=True,
                       help="output file (single) or directory (batch)")
    _add_model_source(p_inf)

    p_exp = sub.add_parser(
        "export", help="write the generator to a portable .npz artifact, "
        "or (--aot) an AOT serving artifact directory")
    _add_common(p_exp)
    p_exp.add_argument("--output", required=True,
                       help="output .npz path (or directory with --aot)")
    p_exp.add_argument("--best", action="store_true",
                       help="export the best-PSNR retention checkpoint")
    p_exp.add_argument("--raw", action="store_true",
                       help="export raw params even when EMA is tracked")
    p_exp.add_argument("--aot", action="store_true",
                       help="AOT artifact: a torch.export program per serve "
                       "bucket + params (io/aot.py), for --device")
    p_exp.add_argument("--aot-buckets", default=None,
                       help="comma-separated BxS bucket list, e.g. "
                       "1x256,8x256 (default: infer.batch_buckets at the "
                       "config's image size)")

    p_msk = sub.add_parser(
        "mask", help="write random mask PNGs (the config's mask.* family) "
        "for use with infer --mask; drawn from a torch.Generator seeded "
        "with --seed, so not the JAX package's PNGs bit for bit")
    _add_common(p_msk)
    p_msk.add_argument("--output", required=True,
                       help="output PNG; with --n > 1, a directory")
    p_msk.add_argument("--n", type=int, default=1)
    p_msk.add_argument("--seed", type=int, default=0)

    p_srv = sub.add_parser(
        "serve", help="batched HTTP inpainting service (infer/service.py)")
    _add_common(p_srv)
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8763)
    p_srv.add_argument("--max-wait-ms", type=float, default=5.0,
                       help="micro-batcher straggler window")
    p_srv.add_argument("--max-queue", type=int, default=None,
                       help="in-flight request bound before 429s "
                       "(default: 8 full batches)")
    _add_model_source(p_srv)

    p_prof = sub.add_parser(
        "profile", help="torch.profiler trace around N train steps "
        "(Chrome trace under <train.workdir>/profile)")
    _add_common(p_prof)
    p_prof.add_argument("--steps", type=int, default=5)

    p_par = sub.add_parser(
        "parity", help="pinned PSNR/SSIM/SWD fingerprint across named "
        "configs, fixed seeds (train/parity.py)")
    p_par.add_argument("--configs", nargs="*", default=None)
    p_par.add_argument("--max-image-size", type=int, default=None,
                       help="cap image size (CPU runs of 512² configs)")
    p_par.add_argument("--update", action="store_true",
                       help="rewrite the pins of this device type with "
                       "these results")
    p_par.add_argument("--pinned", default=None,
                       help="pinned-metrics file (default: the package's "
                       "parity_pinned.json)")
    p_par.add_argument("--device", default=None,
                       help="torch device; default: CUDA, and an error when "
                       "there is none")

    p_bench = sub.add_parser(
        "bench", help="throughput: inpaint images/sec or G+D train "
        "steps/sec (bench.py), one JSON line")
    _add_common(p_bench)
    p_bench.add_argument("--mode", choices=["infer", "train"],
                         default="infer")
    return parser


def _inpainter(args, cfg, device):
    """The Inpainter of the command's model source, on ``device`` (None:
    every local card of the config's mesh)."""
    from gan_inpainting_torch.infer.inpaint import Inpainter

    if getattr(args, "aot", None):
        from gan_inpainting_torch.io.aot import AotInpainter

        return AotInpainter(args.aot, device=device)
    if args.weights:
        return Inpainter.from_npz(args.weights, overrides=args.overrides,
                                  device=device)
    return Inpainter.from_checkpoint(cfg, best=args.best, device=device)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.cmd == "configs":
        for name in list_configs():
            print(name)
        return 0

    from gan_inpainting_torch.ops.dispatch import resolve_device

    device = resolve_device(args.device)

    if args.cmd == "parity":
        from gan_inpainting_torch.train.parity import (
            PINNED_PATH,
            check_parity,
            run_parity,
            update_pins,
        )

        pinned = pathlib.Path(args.pinned) if args.pinned else PINNED_PATH
        results = run_parity(args.configs, args.max_image_size, device)
        print(json.dumps(results, indent=2))
        if args.update:
            platform = update_pins(results, pinned, device)
            print(f"pinned[{platform}] -> {pinned}")
            return 0
        problems = check_parity(results, pinned, device=device)
        for p in problems:
            print(f"DRIFT: {p}", file=sys.stderr)
        return 1 if problems else 0

    cfg = apply_overrides(get_config(args.config), args.overrides)

    if args.cmd in ("train", "eval", "bench"):
        from gan_inpainting_torch.parallel import multihost

        joined = not multihost.initialized()
        multihost.ensure_initialized(device)      # a torchrun launch
        try:
            if args.cmd == "train":
                from gan_inpainting_torch.train.loop import train

                train(cfg, resume=not args.no_resume, device=device)
            elif args.cmd == "bench":
                from gan_inpainting_torch.bench import run_bench

                res = run_bench(cfg, mode=args.mode, device=device)
                if multihost.is_main():
                    print(json.dumps(res))
            else:
                from gan_inpainting_torch.train.evaluate import evaluate

                inp = _inpainter(args, cfg, device)
                res = evaluate(inp.cfg, inp.state_dict, device=device)
                if multihost.is_main():
                    print(json.dumps(res))
        finally:
            if joined:
                multihost.shutdown()
        return 0

    if args.cmd == "infer":
        import numpy as np
        from PIL import Image

        inpainter = _inpainter(args, cfg, args.device)
        image_path = pathlib.Path(args.image)
        if image_path.is_dir():
            from gan_inpainting_torch.infer.batch_files import inpaint_dir

            n = inpaint_dir(inpainter, image_path, pathlib.Path(args.mask),
                            pathlib.Path(args.output))
            print(f"wrote {n} images to {args.output}")
            return 0
        image = np.array(Image.open(image_path).convert("RGB"))
        # > 127, as in the directory and HTTP paths
        mask = np.asarray(Image.open(args.mask).convert("L")) > 127
        Image.fromarray(inpainter(image, mask.astype(np.float32))).save(
            args.output)
        print(f"wrote {args.output}")
        return 0

    if args.cmd == "mask":
        import numpy as np
        import torch
        from PIL import Image

        from gan_inpainting_torch.data.masks import random_mask_batch

        size = cfg.data.image_size
        masks = random_mask_batch(torch.Generator().manual_seed(args.seed),
                                  args.n, size, size, cfg.mask,
                                  device=device)
        masks = (masks[..., 0] > 0.5).cpu().numpy().astype(np.uint8) * 255
        out = pathlib.Path(args.output)
        if args.n == 1:
            Image.fromarray(masks[0]).save(out)
            print(f"wrote {out}")
        else:
            out.mkdir(parents=True, exist_ok=True)
            for i in range(args.n):
                Image.fromarray(masks[i]).save(out / f"mask_{i:04d}.png")
            print(f"wrote {args.n} masks to {out}")
        return 0

    if args.cmd == "export":
        if args.aot:
            from gan_inpainting_torch.infer.inpaint import Inpainter
            from gan_inpainting_torch.io.aot import export_serving

            inp = Inpainter.from_checkpoint(cfg, use_ema=not args.raw,
                                            best=args.best, device=device)
            buckets = None
            if args.aot_buckets:
                buckets = [tuple(int(v) for v in spec.split("x"))
                           for spec in args.aot_buckets.split(",")]
            manifest = export_serving(inp.cfg, inp.state_dict, args.output,
                                      buckets=buckets, device=device)
            print(f"wrote AOT artifact ({len(manifest['buckets'])} buckets, "
                  f"platform {manifest['platform']}) to {args.output}")
            return 0
        from gan_inpainting_torch.io.export import export_from_checkpoint

        export_from_checkpoint(cfg, args.output, use_ema=not args.raw,
                               best=args.best)
        print(f"wrote {args.output}")
        return 0

    if args.cmd == "serve":
        from gan_inpainting_torch.infer.service import serve

        serve(_inpainter(args, cfg, args.device), host=args.host,
              port=args.port, max_wait_ms=args.max_wait_ms,
              max_queue=args.max_queue)
        return 0

    if args.cmd == "profile":
        from gan_inpainting_torch.train.loop import train
        from gan_inpainting_torch.utils.debug import trace

        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, steps=args.steps, eval_every=10 ** 9,
                checkpoint_every=10 ** 9))
        with trace(cfg.train.workdir, device):
            train(cfg, resume=False, device=device)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
