"""Tracing/profiling hooks (port of world_tpu/utils/profiling.py).

The reference's profiling is printf wall-clock timers per stage
(test/test.cpp:49-59).  Here: torch.profiler traces exported as Chrome
traces (chrome://tracing, Perfetto), holding the program's own spans,
stages and host syncs (world_tpu_torch/device.py) beside the card's
kernels and copies, and a stage timer that reports frames/s and
real-time factor.
"""

import contextlib
import json
import os

import torch

from ..device import StageClock, resolve_device, set_tracing


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed work (the CPU, and the card when there is
    one), with the program's tracing on, and write
    ``log_dir``/trace.json.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        was = set_tracing(True)
        try:
            yield prof
        finally:
            set_tracing(was)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Wall-clock stage timing with audio-relative rates, printed as one
    JSON line per stage (the structured version of test.cpp's printfs).
    On a card (``device``: the GPU unless given) the device is
    synchronized around each stage, so a stage's time includes its
    device work."""

    def __init__(self, audio_seconds, log=print, device=None):
        self.audio_seconds = audio_seconds
        self.log = log
        self.records = {}
        self._clock = StageClock({}, resolve_device(device))

    @contextlib.contextmanager
    def stage(self, name, frames=None):
        with self._clock(name):
            yield
        dt = self._clock.timings[name] / 1e3
        rec = {"stage": name, "ms": round(dt * 1000, 2),
               "rtf": round(self.audio_seconds / dt, 2) if dt else None}
        if frames:
            rec["frames_per_s"] = round(frames / dt, 1)
        self.records[name] = rec
        self.log(json.dumps(rec))
