"""Host ms a delivered buffer costs the thread that serves the streams:
the traced ``span:stream.add`` and ``span:stream.synthesis2`` ranges (the
streaming synthesizer's add_parameters and synthesis2 calls, held ones
included) over the buffers delivered while they ran (the traced
requests).  32 streams in real time leave 0.091 ms a buffer (64 samples
at 22,050 Hz over 32)."""

from . import _program


def install(ctx):
    _program.install(ctx)


def read(ctx):
    t = ctx.trace
    spans = [] if t is None else (t.owned("span:stream.add")
                                  + t.owned("span:stream.synthesis2"))
    if not spans:
        return None
    return sum(e - s for _, s, e in spans) / t.requests / 1e3
