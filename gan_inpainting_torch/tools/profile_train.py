"""Where one train step's device time goes, on one CUDA card.

    python -m gan_inpainting_torch.tools.profile_train
        [--config places512_deepfill] [--steps 3] [--top 30] [overrides …]

Builds the config's train state from its seed (full width, bf16 unless
overridden), makes synthetic textured batches on the card, warms up
(kernel build, cuDNN autotuning), then prints:

* ms per step and steps/s over ``--steps`` steps (host clock around a
  synchronise), with and without the R1 pass;
* the step's phases by CUDA events (``utils.spans.SpanRecorder`` with
  event pairs): generator forward without gradient, D step, G forward,
  G backward, the attention backward inside it, the optimizers, the
  EMA, and each phase's host ms net of its blocking copies;
* device kernels of one step from ``torch.profiler``, grouped as convs,
  elementwise and copies, attention forward, fold, attention backward,
  optimizer, and the top kernels by device time.
"""

from __future__ import annotations

import argparse
import collections
import time

import torch


def category(kernel: str) -> str:
    if "attention_bwd" in kernel or any(
            f"mat::{k}_kernel" in kernel for k in ("delta", "scores",
                                                   "products")):
        return "attention backward"
    if "fused_attention" in kernel or "attention_wgmma" in kernel:
        return "attention forward"
    if "fold_kernel" in kernel:
        return "fold"
    if "gated_conv_kernel" in kernel or "gated_wgmma_kernel" in kernel:
        return "gated conv kernel"
    if "partial_epilogue_kernel" in kernel:
        return "partial epilogue kernel"
    if "multi_tensor" in kernel or "adam" in kernel.lower():
        return "optimizer"
    if any(s in kernel for s in ("conv", "Conv", "xmma", "cutlass", "cudnn",
                                 "gemm", "wgrad", "dgrad", "nchwToNhwc",
                                 "nhwcToNchw")):
        return "conv"
    return "elementwise/copy"


def time_steps(step_fn, state, batches, n: int) -> float:
    """Mean host ms per step over ``n`` steps ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step_fn(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="places512_deepfill")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gan_inpainting_torch.configs.base import apply_overrides, get_config
    from gan_inpainting_torch.data.loader import make_dataset
    from gan_inpainting_torch.data.pipeline import make_train_batch
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step
    from gan_inpainting_torch.utils.rng import STREAM_MASKS, stream_generator
    from gan_inpainting_torch.utils.spans import SpanRecorder, set_section_hook

    cfg = apply_overrides(get_config(args.config),
                          ["data.synthetic_family=textured"] + args.overrides)
    state = create_state(cfg, device="cuda")
    step_fn = make_train_step(cfg)
    data = make_dataset(cfg.data, seed=cfg.train.seed, device="cuda")
    batches = [make_train_batch(
        next(data), stream_generator(cfg.train.seed, STREAM_MASKS, i),
        cfg.mask, flip=cfg.data.random_flip) for i in range(2)]
    k = max(cfg.loss.r1_interval, 1)
    t0 = time.perf_counter()
    step_fn(state, batches[0])              # step 0: with R1; build, plans
    step_fn(state, batches[1])
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.data.batch_size}x{cfg.data.image_size}² "
          f"{cfg.model.dtype_policy} on {torch.cuda.get_device_name(0)}; "
          f"first two steps (kernel build, cuDNN autotuning) "
          f"{time.perf_counter() - t0:.1f} s")

    state.step = 1                          # steps without the R1 pass
    ms = time_steps(step_fn, state, batches, args.steps)
    state.step = 1
    print(f"step without R1: {ms:.1f} ms = {1e3 / ms:.3f} steps/s")
    if cfg.loss.r1_gamma > 0:
        state.step = 0
        ms_r1 = time_steps(step_fn, state, batches, 1)
        mean = (ms_r1 + (k - 1) * ms) / k
        print(f"step with R1 (every {k}th): {ms_r1:.1f} ms; mean over an "
              f"R1 period {mean:.1f} ms = {1e3 / mean:.3f} steps/s")

    recorder = SpanRecorder(events=True)
    set_section_hook(recorder)
    state.step = 1
    for i in range(args.steps):
        step_fn(state, batches[i % 2])
    set_section_hook(None)
    parts = {n: t / args.steps for n, t in recorder.device_ms().items()}
    print("phases, ms per step (CUDA events; attention_backward lies "
          "inside g_backward): "
          + ", ".join(f"{n} {t:.1f}" for n, t in parts.items()))
    host = recorder.summary()["spans"]
    print("phases, host ms per step net of the blocking copies inside "
          "them: " + ", ".join(
              f"{n} {1e3 * v['net_of_sync_s'] / args.steps:.1f}"
              for n, v in host.items()))

    state.step = 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batches[0])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_cat: collections.Counter = collections.Counter()
    for e in kernels:
        by_cat[category(e.name)] += e.time_range.elapsed_us() / 1e3
    window = (max(e.time_range.end for e in kernels)
              - min(e.time_range.start for e in kernels)) / 1e3
    busy = sum(by_cat.values())
    print(f"device kernels of one step {busy:.1f} ms over a {window:.1f} ms "
          f"window (idle {100 * (1 - busy / window):.1f} %): " + ", ".join(
              f"{c} {t:.1f} ms ({100 * t / busy:.1f} %)"
              for c, t in by_cat.most_common()))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=args.top,
                                    max_name_column_width=90))


if __name__ == "__main__":
    main()
