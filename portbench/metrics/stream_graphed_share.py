"""Share of the streaming synthesizer's renders replayed from a CUDA
graph, in percent: the rise of the program's counter
``world_tpu_torch.models.realtime.counts["graphed"]`` over that of
``["renders"]`` while the traced buffers ran.  None where the counter
has no ``"graphed"`` key (a program that replays no graph)."""

import importlib

from . import _program

KEY = "stream_counts.graphed"


def install(ctx):
    if _program.install(ctx) is None:
        return
    counts = getattr(importlib.import_module(
        "world_tpu_torch.models.realtime"), "counts", None)
    if counts is None:
        return
    snaps = ctx.captured.setdefault(KEY, [])
    ctx.tracer.hooks.append(lambda on: snaps.append(dict(counts)))


def read(ctx):
    snaps = ctx.captured.get(KEY, [])
    if len(snaps) < 2 or "graphed" not in snaps[1]:
        return None
    before, after = snaps[0], snaps[1]          # tracing on, then first off
    renders = after.get("renders", 0) - before.get("renders", 0)
    if renders <= 0:
        return None
    return 100.0 * (after["graphed"] - before.get("graphed", 0)) / renders
