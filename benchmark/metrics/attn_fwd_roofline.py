"""The contextual attention forward's share of its roofline: the bound of
the window's forwards (valid-pair operations over the bf16 peak, or its
bytes over the bandwidth, whichever is larger, per call) over the device
time of the kernels named below: the fused forward in its wgmma variant
(bf16 maps with C % 32 == 0, the published width's 96 channels among
them, in ceil(C/64) 64-channel boxes a tap, the last zero-filled past C)
and in its CUDA-core variant (float32 maps and other widths)."""

from benchmark.harness.kernels import device_seconds

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "serve_img_per_s"
KERNELS = (r"\battention_wgmma_kernel\b", r"\bfused_attention_core_kernel\b")


def read(ctx):
    t = device_seconds(ctx.trace, KERNELS)
    bound = ctx.counts.get("attn_fwd_bound_s")
    if not t or not bound:
        return None
    return 100.0 * bound / t
