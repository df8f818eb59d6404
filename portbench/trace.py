"""The traced run's instrumentation, all of it the benchmark's own.

- StageClock's marks (world_tpu_torch/device.py: ``harvest``,
  ``harvest.refine``, ``dio``, ``stonemask``, ``cheaptrick``, ``d4c``,
  ...) become ``torch.profiler`` ranges named ``stage:<name>``, with no
  synchronisation (the program's own clock synchronises around every
  stage; it is not used).
- The benchmark's host spans around its calls into the program
  (``span:dispatch``, ``span:wait_outputs``, ``span:analyze_long``) and one
  ``span:traced`` around the traced requests.
- The hand-kernel wrappers' ``.launches`` counters, read before and after.

A fixed number of whole requests from the steady middle of the window is
profiled (the cell's ``trace``: ``skip`` requests, then ``requests``).
``Trace`` holds the result as plain data: device intervals with the
host time of their launch, and the host ranges.
"""

import contextlib
import importlib
import json
import pkgutil
from pathlib import Path

KERNELS = json.loads((Path(__file__).resolve().parent / "kernels.json")
                     .read_text())


class Trace:
    """What the profiler recorded over the traced requests, in
    microseconds of one clock.

    device:  [(name, start, end, launch)]: kernels, copies and sets on the
             card; ``launch`` is the host time of the API call that
             launched it, or None where the trace holds no such call;
    ranges:  [(name, start, end)] host ranges (stage:*, span:*), in the
             order they opened;
    span:    (start, end) of the traced requests;
    cutoff:  host time of the next request's dispatch (None where none
             was dispatched before the trace stopped): ranges that open
             after it belong to later requests;
    requests: how many requests were traced.
    """

    def __init__(self, device, ranges, span, cutoff, requests):
        self.device = device
        self.ranges = ranges
        self.span = span
        self.cutoff = cutoff
        self.requests = requests

    def owned(self, name):
        """The traced requests' ranges called ``name``."""
        return [r for r in self.ranges if r[0] == name
                and (self.cutoff is None or r[1] < self.cutoff)]

    def launched_in(self, name):
        """Device events launched inside the traced requests' ``name``
        ranges."""
        spans = self.owned(name)
        return [d for d in self.device if d[3] is not None
                and any(s <= d[3] <= e for _, s, e in spans)]

    def device_us(self, name):
        """Device microseconds of what the ``name`` ranges launched, or
        None where the trace holds no such range."""
        if not self.owned(name):
            return None
        return sum(e - s for _, s, e, _ in self.launched_in(name))


def union_us(intervals, lo, hi):
    """Length of the union of ``intervals`` [(start, end)] inside
    [lo, hi]."""
    total, reach = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= reach:
            continue
        total += e - max(s, reach)
        reach = e
    return total


def gaps(intervals, lo, hi):
    """The idle gaps [(start, end)] between ``intervals`` inside
    [lo, hi]."""
    out, reach = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if s > reach:
            out.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        out.append((reach, hi))
    return out


def from_kineto(events, requests):
    """A Trace from the profiler's raw events (``prof.profiler.
    kineto_results.events()``).  A device event is matched to the runtime
    call that launched it by correlation id."""
    launch_at, device, ranges, span, cutoff = {}, [], [], None, None
    for ev in events:
        name = ev.name()
        start = ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        on_card = "CUDA" in str(ev.device_type())
        if on_card:
            if not ev.is_user_annotation():
                device.append((name, start, end, ev.correlation_id()))
        elif name.startswith(("stage:", "span:")):
            if name == "span:traced":
                span = (start, end)
            elif name == "span:cutoff":
                cutoff = start
            else:
                ranges.append((name, start, end))
        elif name.startswith("cu"):
            launch_at[ev.correlation_id()] = start
    device = [(n, s, e, launch_at.get(c)) for n, s, e, c in device]
    ranges.sort(key=lambda r: r[1])
    return Trace(device, ranges, span, cutoff, requests)


def launch_counters():
    """{wrapper: launches} of every hand-kernel wrapper of the program
    (each function of world_tpu_torch.ops.* with a ``launches``
    counter)."""
    ops = importlib.import_module("world_tpu_torch.ops")
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"world_tpu_torch.ops.{info.name}")
        for attr, fn in vars(mod).items():
            n = getattr(fn, "launches", None)
            if isinstance(n, int) and getattr(fn, "__module__", None) \
                    == mod.__name__:
                out[f"{info.name}.{attr}"] = n
    return out


def launch_check(before, after, trace):
    """For each hand kernel (``kernels.json``: its symbol and the wrappers
    that launch it), the launches its wrappers counted while the profiler
    ran against the launches of that symbol the trace holds:
    {symbol: [counted, traced]}."""
    out = {}
    for symbol, wrappers in KERNELS.items():
        counted = sum(after.get(w, 0) - before.get(w, 0) for w in wrappers)
        traced = sum(1 for name, _, _, launch in trace.device
                     if launch is not None and symbol in name)
        if counted or traced:
            out[symbol] = [counted, traced]
    return out


class Tracer:
    """Profiles requests ``skip`` .. ``skip + requests - 1`` of a window.
    The driver calls ``span(name)`` around its calls into the program,
    ``begin(i)`` before dispatching request i and ``done(i)`` once its
    outputs are on the host."""

    def __init__(self, skip, requests):
        self.skip, self.requests = skip, requests
        self.prof = self.outer = None
        self.trace = self.counters = self.launches = None
        self.hooks = []         # called with True / False as tracing starts / stops

    def install(self):
        """Turn StageClock's marks into profiler ranges."""
        from torch.profiler import record_function

        from world_tpu_torch.device import StageClock

        @contextlib.contextmanager
        def marked(clock, name):
            with record_function("stage:" + name):
                yield

        StageClock.__call__ = marked

    def span(self, name):
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function("span:" + name)

    def begin(self, i):
        if i == self.skip + self.requests and self.prof is not None:
            with self.span("cutoff"):
                pass
            for hook in self.hooks:
                hook(False)
        if i != self.skip:
            return
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        self.counters = launch_counters()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.outer = record_function("span:traced")
        self.outer.__enter__()
        for hook in self.hooks:
            hook(True)

    def done(self, i):
        if self.prof is None or i != self.skip + self.requests - 1:
            return
        import torch
        for hook in self.hooks:
            hook(False)
        self.outer.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.trace = from_kineto(events, self.requests)
        self.launches = launch_check(self.counters, launch_counters(),
                                     self.trace)
        self.prof = None
