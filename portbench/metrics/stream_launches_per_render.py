"""Card kernels (not copies or sets) launched inside the traced
``span:stream.render`` ranges, per render: the launches of one render of
the streaming synthesizer (world_tpu_torch/models/realtime.py: the row
gather, the upload, the responses, the OLA kernel and the download)."""

import bisect

from . import _program


def install(ctx):
    _program.install(ctx)


def read(ctx):
    t = ctx.trace
    renders = [] if t is None else sorted(
        (s, e) for _, s, e in t.owned("span:stream.render"))
    if not renders:
        return None
    starts = [s for s, _ in renders]
    n = 0
    for name, _, _, launch in t.device:
        if launch is None or name.startswith(("Memcpy", "Memset")):
            continue
        k = bisect.bisect_right(starts, launch) - 1
        n += k >= 0 and launch <= renders[k][1]
    return n / len(renders)
