"""Median, over the traced ``span:step`` ranges, of the host ms inside the
step's ``span:sync.*`` ranges: the time the host waits on the card within
a step (the rest of the step is enqueue)."""

import statistics

from . import _program


def install(ctx):
    _program.install(ctx)


def read(ctx):
    steps = _program.steps(ctx.trace)
    if not steps:
        return None
    syncs = [r for r in ctx.trace.ranges if r[0].startswith("span:sync.")]
    return statistics.median(
        sum(e - s for _, s, e in syncs if lo <= s and e <= hi)
        for _, lo, hi in steps) / 1e3
