"""Median host ms of a ``step(x)`` call over the window's requests (it
returns after enqueuing the step and D4C's one host sync): where it
nears the request's device time, the host sets the pace."""

from . import percentile


def read(ctx):
    return percentile([r[3] for r in ctx.window["requests"]], 50)
