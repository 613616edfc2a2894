"""Batch x steps completed over the whole window: the host issues steps
without waiting for the card, and the window closes when the card has
finished the last."""

UNIT, BETTER, SOURCE = "img/s", "higher", "host_clock"


def read(ctx):
    r = ctx.record
    return r["images"] / r["seconds"]
