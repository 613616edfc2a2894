"""Where the serve forward's device time goes, on one CUDA card.

    python -m gan_inpainting_torch.tools.profile_serve [--batch 64]
        [--size 256] [--reps 3] [--no-autotune]
        [--backend auto|xla|pallas] [--config NAME]

Loads the pinned tex256_attn generator under the serve_v4_8 model override
(bf16) — or, with ``--config NAME`` (e.g. ``partialconv256``), builds that
config's generator at full width from seed 0 — runs the forward on
synthetic uint8 inputs under ``model.kernel_backend=<--backend>``, and
prints:

* device ms per generator stage and per conv layer (CUDA events around
  each module, one synchronise per layer — for attribution, not speed);
* the total device ms of one unhooked forward (CUDA events, ``--reps``);
* the top CUDA kernels by device time from ``torch.profiler``.

``Inpainter`` turns on ``torch.backends.cudnn.benchmark`` (per-shape
autotuning of conv algorithms); ``--no-autotune`` turns it off again, to
show cuDNN's heuristic choices.
"""

from __future__ import annotations

import argparse
import collections

import numpy as np
import torch

NPZ = "docs/artifacts/tex256_attn/generator_best.npz"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-autotune", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "xla", "pallas"))
    ap.add_argument("--config", default=None,
                    help="serve this named config from a seeded "
                    "initialization instead of the pinned npz")
    args = ap.parse_args(argv)

    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.models.layers import InpaintConv

    overrides = [f"model.kernel_backend={args.backend}",
                 f"infer.size_buckets={args.size}",
                 f"infer.batch_buckets={args.batch}"]
    if args.config is None:
        inp = Inpainter.from_npz(
            NPZ, overrides=["model.fuse_upsample=true"] + overrides,
            device="cuda")
    else:
        cfg = apply_overrides(get_config(args.config), overrides)
        gen = build_generator(cfg.model, device="cuda", seed=0)
        inp = Inpainter(cfg, gen.state_dict(), device="cuda")
        del gen
    print(f"config {inp.cfg.name}: {inp.cfg.model.generator}/"
          f"{inp.cfg.model.conv_kind}, kernel_backend={args.backend}")
    if args.no_autotune:
        torch.backends.cudnn.benchmark = False
    fwd = inp._forward(inp._cfg_for_size(args.size).model.fuse_upsample)
    gen = fwd.generator
    rng = np.random.default_rng(0)
    b, s = args.batch, args.size
    img = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), np.uint8)).cuda()
    msk = torch.zeros(b, s, s, 1, device="cuda")
    msk[:, s // 4:s // 2, s // 8:s // 2] = 1.0

    fwd(img, msk)                                   # first use: plans
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.reps):
        fwd(img, msk)
    end.record()
    torch.cuda.synchronize()
    total = start.elapsed_time(end) / args.reps
    print(f"forward {b}x{s}² bf16: {total:.2f} ms = {b * 1e3 / total:.1f} "
          f"img/s (cudnn.benchmark={torch.backends.cudnn.benchmark}, "
          f"{torch.cuda.get_device_name(0)})")
    _print_gflop(inp, img[:1], msk[:1], s)

    # ---- per-module attribution: events recorded in stream order, one
    # synchronise at the end, so the card stays as busy as unhooked ------
    events: dict[str, list] = collections.OrderedDict()
    hooks = []
    modules = [(n, m) for n, m in gen.named_modules()
               if isinstance(m, InpaintConv) or n.count(".") == 0 and n]

    def record(name, slot):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, [None, None])[slot] = ev
        return hook

    for name, mod in modules:
        hooks.append(mod.register_forward_pre_hook(record(name, 0)))
        hooks.append(mod.register_forward_hook(record(name, 1)))
    fwd(img, msk)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    times = {n: a.elapsed_time(b) for n, (a, b) in events.items()}
    stages = {n: t for n, t in times.items() if "." not in n}
    print("stage ms: " + ", ".join(f"{n} {t:.2f}" for n, t in stages.items())
          + f"; outside the stages (attention, heads, composite) "
          f"{total - sum(stages.values()):.2f}")
    for name, mod in modules:
        if isinstance(mod, InpaintConv):
            print(f"  {name}: {times[name]:.3f} ms  k{mod.kernel_size} "
                  f"s{mod.stride} d{mod.dilation} "
                  f"{tuple(mod.weight.shape[:2])} "
                  f"{'up' if mod.pre_upsample else ''}")

    # ---- kernels by device time -------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd(img, msk)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_cat: collections.Counter = collections.Counter()
    for e in kernels:
        by_cat[_category(e.name)] += e.time_range.elapsed_us() / 1e3
    window = (max(e.time_range.end for e in kernels)
              - min(e.time_range.start for e in kernels)) / 1e3
    busy = sum(by_cat.values())
    print(f"device kernels {busy:.2f} ms over a {window:.2f} ms window "
          f"(idle {100 * (1 - busy / window):.1f} %): " + ", ".join(
              f"{c} {t:.2f} ms ({100 * t / busy:.1f} %)"
              for c, t in by_cat.most_common()))
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=args.top,
                                    max_name_column_width=90))


def _print_gflop(inp, img, msk, size: int) -> None:
    """GFLOP per image of each decoder formulation: the convs as
    ``FlopCounterMode`` counts them on this forward, plus the attention
    kernel's 2·Lq·Lk·(k² + 4r²)·C from its shapes (the counter does not see
    a ctypes launch). Elementwise work is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    m = inp.cfg.model
    from gan_inpainting_torch.ops.dispatch import resolve_backend

    if (m.conv_kind == "gated"
            and resolve_backend(m.kernel_backend, "gated_conv") == "pallas"):
        print("GFLOP per image: not counted under the gated-conv kernels "
              "(the counter does not see ctypes launches); run --backend xla")
        return
    lk = (size // 4 // m.attention_rate) ** 2 if m.use_attention else 0
    attn = 2.0 * lk * lk * (9 + 4 * m.attention_rate ** 2) \
        * 4 * m.base_features / 1e9
    for fuse in (True, False):
        counter = FlopCounterMode(display=False)
        with counter:
            inp._forward(fuse)(img, msk)
        convs = counter.get_total_flops() / 1e9
        print(f"GFLOP per {size}² image, fuse_upsample={fuse}: convs "
              f"{convs:.2f} + attention {attn:.2f} = {convs + attn:.2f}")


def _category(kernel: str) -> str:
    if "fused_attention" in kernel or "attention_wgmma" in kernel:
        return "attention"
    if "fold_kernel" in kernel:
        return "fold"
    if "gated_conv_kernel" in kernel or "gated_wgmma_kernel" in kernel:
        return "gated conv kernel"
    if "partial_epilogue_kernel" in kernel:
        return "partial epilogue kernel"
    if any(s in kernel for s in ("conv", "Conv", "xmma", "cutlass", "cudnn",
                                 "gemm")):
        return "conv"
    return "elementwise/copy"


if __name__ == "__main__":
    main()
