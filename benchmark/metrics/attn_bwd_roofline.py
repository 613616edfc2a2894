"""The contextual attention backward's share of its roofline (rows 4, 5
and 5b of the kernel table: scores, dQ and dK/dV products, the fold of
the tap gradients): the bound of the window's backwards over the device
time of the kernels named below: the wgmma kernels (bf16 maps with
C % 32 == 0, the published width's 96 channels among them, in ceil(C/64)
64-channel boxes a tap: delta, score tiles, products), the CUDA-core
kernel that computes the same gradients for float32 maps and other
widths, and the fold of the tap gradients."""

from benchmark.harness.kernels import device_seconds

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "train_img_per_s"
KERNELS = (r"\bdelta_kernel\b", r"\bscores_kernel\b", r"\bproducts_kernel\b",
           r"\battention_bwd_core_kernel\b",
           r"\battention_bwd_fold_kernel\b")


def read(ctx):
    t = device_seconds(ctx.trace, KERNELS)
    bound = ctx.counts.get("attn_bwd_bound_s")
    if not t or not bound:
        return None
    return 100.0 * bound / t
