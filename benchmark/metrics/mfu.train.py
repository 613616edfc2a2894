"""Model FLOPs of the window's steps (the benchmark's own count on the
reference step: G and D forward and backward, R1 on the steps that take
it, attention over valid pairs) over the window times the card's bf16
dense peak."""

from benchmark.harness.count import PEAK_BF16_FLOPS

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "model step"
MOVES = "train_img_per_s"


def read(ctx):
    flops = ctx.counts.get("model_flops")
    if not flops:
        return None
    return 100.0 * flops / (ctx.record["seconds"] * PEAK_BF16_FLOPS)
