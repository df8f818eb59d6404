"""Host syncs a batch step takes: the rise of the program's sync counters
(world_tpu_torch.device.sync.counts) at the step's sites (every site but
long-form's ``longform.*``, which lie outside the step) while the traced
requests ran, over the ``span:step`` ranges the trace holds."""

from . import _program


def install(ctx):
    device = _program.install(ctx)
    if device is None:
        return
    snaps = ctx.captured.setdefault("sync_counts", [])
    ctx.tracer.hooks.append(lambda on: snaps.append(dict(device.sync.counts)))


def read(ctx):
    snaps = ctx.captured.get("sync_counts", [])
    steps = _program.steps(ctx.trace)
    if len(snaps) < 2 or not steps:
        return None
    before, after = snaps[0], snaps[1]       # tracing on, then first off
    n = sum(v - before.get(k, 0) for k, v in after.items()
            if not k.startswith("longform."))
    return n / len(steps)
