"""Device ms per request of the kernels launched inside StageClock's
``dio`` range (traced run)."""

from . import stage_ms


def read(ctx):
    return stage_ms(ctx, "dio")
