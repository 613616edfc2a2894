"""Model FLOPs of the images served in the window (the benchmark's own
count: convs as published, attention over valid pairs) over the window
times the card's bf16 dense peak."""

from benchmark.harness.count import PEAK_BF16_FLOPS

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "model step"
MOVES = "serve_img_per_s"


def read(ctx):
    flops = ctx.counts.get("model_flops")
    if not flops:
        return None
    return 100.0 * flops / (ctx.record["seconds"] * PEAK_BF16_FLOPS)
