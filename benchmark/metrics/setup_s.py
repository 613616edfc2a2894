"""Set-up: process start to the window's start (imports, the CUDA
context, weights and inputs made from the seed, building the program,
the kernels' build in a cold checkout, warm-up and cuDNN's search)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(ctx):
    return ctx.setup_s
