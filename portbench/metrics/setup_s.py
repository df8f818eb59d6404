"""Seconds from process start to the first timed request: imports,
CUDA set-up, loading (and on a checkout's first run, building) the
program's kernels, making the inputs and the warm-up."""


def read(ctx):
    return ctx.setup_s
