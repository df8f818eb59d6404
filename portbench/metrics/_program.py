"""What the readers of the program's own tracing share.  The program
(world_tpu_torch/device.py) marks its layer boundaries as ``span:<name>``
ranges and its host syncs as ``span:sync.<site>`` ranges while its
tracing is on, and counts each sync by site in ``sync.counts``.  A
program without them (an older checkout) gives these readers nothing to
read: they return None."""

import importlib


def install(ctx):
    """Turn the program's tracing on and off with the profiler: on as it
    starts (the tracer's hooks), off as it stops.  Past the cutoff the
    program's ranges still name the idle gaps of the breakdown, and the
    readers leave them out (Trace.owned).  Returns world_tpu_torch.device,
    or None where it has no tracing."""
    device = importlib.import_module("world_tpu_torch.device")
    if not hasattr(device, "set_tracing"):
        return None
    tracer = ctx.tracer

    def hook(on):
        prof = tracer.prof
        if on:
            device.set_tracing(True)
        elif not getattr(prof, "stops_program_tracing", False):
            stop = prof.stop

            def stop_and_off():
                device.set_tracing(False)
                return stop()

            prof.stop = stop_and_off
            prof.stops_program_tracing = True

    tracer.hooks.append(hook)
    return device


def steps(trace):
    """The traced requests' ``span:step`` ranges: [(name, start, end)]."""
    return [] if trace is None else trace.owned("span:step")


# Long-form's host work between and around its batch steps.
HOST_STATE = ("span:longform.chunk", "span:longform.collect",
              "span:longform.stitch")


def host_state(trace):
    """The traced requests' host-state ranges (HOST_STATE)."""
    return [r for name in HOST_STATE for r in trace.owned(name)]
