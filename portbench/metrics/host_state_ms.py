"""Host ms a traced request spends in long-form's host state: its
``span:longform.chunk``, ``.collect`` and ``.stitch`` ranges (building
the chunk rows, taking the batches' results and joining them, stitching
the core frames)."""

from . import _program


def install(ctx):
    _program.install(ctx)


def read(ctx):
    t = ctx.trace
    spans = [] if t is None else _program.host_state(t)
    if not spans:
        return None
    return sum(e - s for _, s, e in spans) / t.requests / 1e3
