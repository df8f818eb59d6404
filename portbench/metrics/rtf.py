"""Real (unpadded) audio seconds of every request dispatched in the
window, over the seconds from the window's start to the last of their
completions.  The drivers finish the requests still in flight at the
window's end, so that time is at least the window's: all the work over
all the window's time, and a stall or a request that straddles the end
counts in full."""


def read(ctx):
    w = ctx.window
    reqs = w["requests"]
    if not reqs:
        return None
    end = max(max(r[1] for r in reqs), w["t1"])
    return sum(r[2] for r in reqs) / (end - w["t0"])
