"""Percent of the traced span in which nothing ran on the card: 1 - the
union of kernel, copy and set intervals over the span."""

from ..trace import union_us


def read(ctx):
    t = ctx.trace
    if t is None or t.span is None or not t.device:
        return None
    lo, hi = t.span
    busy = union_us([(s, e) for _, s, e, _ in t.device], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
