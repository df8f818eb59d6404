"""One reader per metric, in a file named after it: ``read(ctx)``
returns the metric's value, or None where the run has nothing to read
(the harness then leaves the metric out of the line).  A reader may also
define ``install(ctx)``, called before set-up in a traced run, to hook
what it reads.  ``ctx`` is run.Context."""

import numpy as np

from .. import work


def stage_ms(ctx, stage):
    """Device ms per traced request of what the StageClock range
    ``stage`` launched."""
    t = ctx.trace
    us = None if t is None else t.device_us("stage:" + stage)
    return None if us is None else us / t.requests / 1e3


def capture(ctx, module, name):
    """Record the arguments of each call of ``module.name`` (a program
    function that a model module calls by that name) while the traced
    requests run, under ctx.captured[name]."""
    import importlib
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    calls = ctx.captured.setdefault(name, [])
    live = []

    def recorded(*args):
        if live:
            calls.append(args)
        return real(*args)

    setattr(mod, name, recorded)
    ctx.tracer.hooks.append(
        lambda on: live.append(True) if on else live.clear())


def roofline(ctx, stage, name, count):
    """Percent of the least time that the captured calls' work needs
    (``count(*args)`` -> (bytes, operations)) over the device time of the
    ``stage`` ranges."""
    t = ctx.trace
    calls = ctx.captured.get(name)
    us = None if t is None else t.device_us("stage:" + stage)
    if not calls or not us:
        return None
    least = sum(work.bound_s(*count(*args)) for args in calls)
    return 100.0 * least / (us / 1e6)


def percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))
