"""Time the gated-conv kernels at the generators' layer shapes, on one CUDA
card.

    python -m gan_inpainting_torch.tools.bench_conv [--config serve_v4_8]
        [--size 256] [--batch 64] [--reps 10]

The layer forms are read off the generator itself: one forward of the
config's model at batch 1 records, for every gated conv that
``kernel_backend=pallas`` sends to a kernel, its (Cin → 2·F, window, stride,
dilation, input map) and how often the form occurs. For every distinct form
it prints, in bf16: ms of the hand-written kernel alone (weights packed,
at stride 2 on the strided taps of the map) under each tile
choice the plan can make (24, 48 or 96 features per block; the plan's own
marked *), with each choice's TFLOP/s and fill FLOP per byte, and how A is
fed (TMA box or gather); ms through ``gated_conv(backend="pallas")``
(packed weights cached), ms of the plain version (cuDNN conv + eager
epilogue) and of the conv with bias alone. The last line sums each column
over one forward's layers.
"""

from __future__ import annotations

import argparse

import torch


def gated_layers(config: str, size: int, device="cuda") -> list[tuple]:
    """(count per forward, Cin, F, k, stride, dilation, input map side) of
    every kernel-routed gated conv of ``config``'s generator at a
    ``size``² image, from forward hooks on its InpaintConv modules."""
    from collections import Counter

    from gan_inpainting_torch.configs.base import get_config
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.models.layers import InpaintConv

    gen = build_generator(get_config(config).model, device=device, seed=0,
                          backend="xla").eval()
    forms = Counter()

    def record(mod, args):
        forms[(mod.weight.shape[1], mod.weight.shape[0] // 2,
               mod.kernel_size, mod.stride, mod.dilation,
               args[0].shape[1])] += 1

    for mod in gen.modules():
        if (isinstance(mod, InpaintConv) and mod.conv_kind == "gated"
                and not (mod.pre_upsample or mod.s2d)):
            mod.register_forward_pre_hook(record)
    mask = torch.zeros(1, size, size, 1, device=device)
    mask[:, size // 4: size // 2, size // 4: size // 2] = 1.0
    with torch.inference_mode():
        gen(torch.zeros(1, size, size, 3, device=device), mask)
    return [(n, *form) for form, n in forms.items()]


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="serve_v4_8")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    from gan_inpainting_torch.ops.conv import conv2d
    from gan_inpainting_torch.ops.gated_conv import (
        gated_conv,
        gated_conv_plain,
    )
    from gan_inpainting_torch.ops.kernels import gated_matmul as gm
    from gan_inpainting_torch.ops.kernels.direct_conv import launch_direct

    torch.backends.cudnn.benchmark = True
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    layers = gated_layers(args.config, args.size)
    print(f"{torch.cuda.get_device_name(0)}, {args.config} at {args.size}², "
          f"batch {args.batch}, bf16; ms; per tile choice: BF kernel ms "
          f"TFLOP/s FLOP-per-fill-byte (* = the plan's)")
    total = dict(kernel=0.0, wrapper=0.0, plain=0.0, conv=0.0)
    for n, cin, f, k, stride, dil, side in layers:
        x = torch.randn((args.batch, side, side, cin), generator=g,
                        device=dev).to(bf16)
        w = (torch.randn((2 * f, cin, k, k), generator=g, device=dev)
             / (k * k * cin) ** 0.5).to(bf16)
        bias = torch.zeros(2 * f, device=dev)
        kw = dict(stride=stride, dilation=dil, activation="elu")
        out_side = -(-side // stride)
        flops = 2.0 * args.batch * out_side ** 2 * k * k * cin * 2 * f
        chosen = gm.plan(cin, f, bf16)
        # every column-block width: the plan for F = BF, then F's blocks
        choices = [gm.plan(cin, bf, bf16)._replace(n_col=-(-f // bf))
                   for bf in gm.WGMMA_BLOCK_F]
        xp = gm.pad_channels(x, chosen.cin_pad)
        cells, kernel_ms = [], {}
        for p in choices:
            wp = gm.pack_weights(w, p)
            if stride == 1 and k % 2:
                run = (lambda wp=wp, p=p: launch_direct(
                    xp, wp, bias, f, k, dil, p, "elu"))
            else:
                run = (lambda wp=wp, p=p: gm.launch_strided(
                    xp, wp, bias, f, k, stride, dil, p, "elu"))
            kernel_ms[p] = _time_ms(run, args.reps)
            cells.append(f"{p.block_f}{'*' if p == chosen else ' '} "
                         f"{kernel_ms[p]:.3f} {flops / kernel_ms[p] / 1e9:.0f} "
                         f"{1 / gm.fill_bytes_per_flop(p):.0f}")
        tile = gm.a_tile(chosen, args.batch, out_side, out_side, stride)
        wrapper = _time_ms(lambda: gated_conv(x, w, bias, backend="pallas",
                                              **kw), args.reps)
        plain = _time_ms(lambda: gated_conv_plain(x, w, bias, **kw),
                         args.reps)
        conv = _time_ms(lambda: conv2d(x, w, bias, stride=stride,
                                       dilation=dil), args.reps)
        a_path = f"TMA {tile}" if tile else "gather"
        print(f"{n}  {cin:>3}->2x{f:<3} k{k} s{stride} d{dil:<2} {side:>3}²  "
              f"{' | '.join(cells)} | A {a_path} | wrapper {wrapper:.3f} "
              f"plain {plain:.3f} conv {conv:.3f}")
        for key, val in (("kernel", kernel_ms[chosen]), ("wrapper", wrapper),
                         ("plain", plain), ("conv", conv)):
            total[key] += n * val
    print(f"per forward ({sum(ly[0] for ly in layers)} layers): " "planned "
          "kernel {kernel:.2f}, wrapper {wrapper:.2f}, plain {plain:.2f}, "
          "conv alone {conv:.2f}".format(**total))


if __name__ == "__main__":
    main()
