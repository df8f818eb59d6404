"""Pulses a render of the streaming synthesizer carries: the rise of the
program's counter ``world_tpu_torch.models.realtime.counts["pulses"]``
over that of ``["renders"]`` while the traced buffers ran."""

import importlib

from . import _program


def install(ctx):
    if _program.install(ctx) is None:
        return
    counts = getattr(importlib.import_module(
        "world_tpu_torch.models.realtime"), "counts", None)
    if counts is None:
        return
    snaps = ctx.captured.setdefault("stream_counts", [])
    ctx.tracer.hooks.append(lambda on: snaps.append(dict(counts)))


def read(ctx):
    snaps = ctx.captured.get("stream_counts", [])
    if len(snaps) < 2:
        return None
    before, after = snaps[0], snaps[1]          # tracing on, then first off
    renders = after.get("renders", 0) - before.get("renders", 0)
    if renders <= 0:
        return None
    return (after.get("pulses", 0) - before.get("pulses", 0)) / renders
