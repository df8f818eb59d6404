"""95th percentile, over every request dispatched in the window (the
drivers finish those still in flight at its end), of the ms from its
dispatch to its outputs being usable on the host."""

from . import percentile


def read(ctx):
    reqs = ctx.window["requests"]
    return percentile([(r[1] - r[0]) * 1e3 for r in reqs], 95) \
        if reqs else None
