"""CLI: ``python -m gan_inpainting_torch <cmd> [--config NAME]
[section.key=value ...]``.

Subcommands: ``configs`` (list the named configs) and ``train``. The
serving commands wait for the serving tier (ROADMAP Queue 1, Slice B).
"""

from __future__ import annotations

import argparse

from gan_inpainting_torch.configs.base import (
    apply_overrides,
    get_config,
    list_configs,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gan_inpainting_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("configs", help="list the named configs")
    p_train = sub.add_parser("train", help="run GAN training")
    p_train.add_argument("--config", default="celeba128_center",
                         choices=list_configs())
    p_train.add_argument("--device", default=None,
                         help="torch device; default: CUDA, and an error "
                         "when there is none")
    p_train.add_argument("--no-resume", action="store_true",
                         help="ignore checkpoints in the workdir")
    p_train.add_argument("overrides", nargs="*",
                         help="config overrides, e.g. train.steps=100")
    args = parser.parse_args(argv)

    if args.cmd == "configs":
        for name in list_configs():
            print(name)
        return 0

    from gan_inpainting_torch.train.loop import train

    cfg = apply_overrides(get_config(args.config), args.overrides)
    train(cfg, resume=not args.no_resume, device=args.device)
    return 0
