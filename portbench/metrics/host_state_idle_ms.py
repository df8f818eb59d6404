"""Card-idle ms a traced request spends in long-form's host state: the
traced span's idle gaps (trace.gaps of the device intervals) intersected
with the ``span:longform.chunk``, ``.collect`` and ``.stitch`` ranges."""

from ..trace import gaps
from . import _program


def install(ctx):
    _program.install(ctx)


def read(ctx):
    t = ctx.trace
    spans = [] if t is None or t.span is None else _program.host_state(t)
    if not spans:
        return None
    idle = gaps([(s, e) for _, s, e, _ in t.device], *t.span)
    us = sum(max(0.0, min(e, b) - max(s, a))
             for s, e in idle for _, a, b in spans)
    return us / t.requests / 1e3
