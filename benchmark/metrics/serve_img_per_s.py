"""Images returned over the whole window, divided by the window (the
last call's return closes it)."""

UNIT, BETTER, SOURCE = "img/s", "higher", "host_clock"


def read(ctx):
    r = ctx.record
    return r["images"] / r["seconds"]
