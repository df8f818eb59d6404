"""torch.cuda.max_memory_allocated() over the window (reset at its
start), in GiB."""


def read(ctx):
    peak = ctx.window["peak_bytes"]
    return None if peak is None else peak / 2 ** 30
