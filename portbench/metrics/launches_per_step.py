"""Card kernels (not copies or sets) launched inside the traced
``span:step`` ranges, per step."""

from . import _program


def install(ctx):
    _program.install(ctx)


def read(ctx):
    steps = _program.steps(ctx.trace)
    if not steps:
        return None
    kernels = [d for d in ctx.trace.launched_in("span:step")
               if not d[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / len(steps)
