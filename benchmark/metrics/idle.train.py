"""The share of the traced window in which no operation ran on the card
(kernels, copies and sets, as the profiler's trace shows them)."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "train_img_per_s"


def read(ctx):
    if not ctx.trace:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
