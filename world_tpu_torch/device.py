"""Device resolution, host-device copies, the IEEE-division helper and
the port's tracing, shared by the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise instead of quietly
running on the CPU.

Tracing.  ``span(name)`` marks a layer boundary, ``StageClock`` a stage,
``sync(site)`` a host sync.  With tracing off (the default) a span or a
stage is a shared no-op; with it on (``set_tracing(True)``, or
``utils.profiling.trace()``) each is a ``torch.profiler`` range named
``span:<name>``, ``stage:<name>`` or ``span:sync.<site>``, on the
profiler's clock beside the card's kernels and copies.  Ranges nest by
containment on the calling thread; any profiler trace carries them.
``sync`` counts its site whether tracing is on or not.
"""

import collections
import contextlib
import time

import numpy as np
import torch


def resolve_device(device=None):
    """The torch.device an entry point runs on.  ``None`` means the GPU,
    and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "world_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(x, device, dtype=None):
    """numpy array / tensor / sequence -> tensor on ``device``; keeps the
    input's floating dtype unless ``dtype`` is given."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    arr = np.asarray(x)
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype is None and arr.dtype.kind != "f":
        dtype = torch.float64
    return torch.as_tensor(arr, dtype=dtype, device=device)


def upload(arr, dtype, device):
    """numpy array -> tensor of ``dtype`` on ``device``.  On a card the
    copy goes through pinned memory and is non_blocking, so the host does
    not wait for the work already queued on the stream.  The span
    ``upload``."""
    with span("upload"):
        if device.type == "cpu":
            return torch.as_tensor(arr, dtype=dtype)
        host = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
        host.numpy()[...] = arr
        return host.to(device, non_blocking=True)


def download(tensors, device):
    """Start copying ``tensors`` (on ``device``) to the host: non_blocking
    into pinned memory, with a CUDA event recorded behind the copies.
    Returns (host tensors, event); the event is None on the CPU, where
    the tensors are returned as they are.  The span ``download``."""
    with span("download"):
        if device.type == "cpu":
            return list(tensors), None
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return host, event


def div(a, c):
    """``a / c`` for a Python scalar ``c``, as IEEE division.

    PyTorch's CUDA true division by a Python (CPU) scalar multiplies by
    the reciprocal, which is 1 ulp off and shifts analysis windows by a
    sample.  Dividing by a 0-dim tensor on ``a``'s device takes the
    tensor-tensor kernel, which divides."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


_tracing = False
_NO_RANGE = contextlib.nullcontext()


def set_tracing(on):
    """Turn the program's tracing on or off for the whole process.
    Returns whether it was on."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    return was


def tracing():
    """Whether the program's tracing is on."""
    return _tracing


def _mark(prefix, name):
    """The profiler range ``prefix + name`` with tracing on; with it off,
    a shared no-op context (no allocation)."""
    if not _tracing:
        return _NO_RANGE
    return torch.profiler.record_function(prefix + name)


def span(name):
    """The range ``span:<name>`` around a layer's work (a no-op with
    tracing off)."""
    return _mark("span:", name)


def sync(site, n=1):
    """Context of a block that reads from the card ``n`` times, making the
    host wait for the work queued before it (a device-to-host read, a
    boolean-mask index, an upload from pageable memory).  Adds ``n`` to
    ``sync.counts[site]``; with tracing on the block is also the range
    ``span:sync.<site>``.  Sites are ``<stage>.<what>``."""
    sync.counts[site] += n
    return _mark("span:sync.", site)


sync.counts = collections.Counter()     # host syncs by site


class StageClock:
    """Marks named stages.  With tracing on, each stage is the profiler
    range ``stage:<name>``, with no synchronisation.  Given a dict as
    ``timings``, it also records each stage's wall milliseconds there,
    with the device synchronized around the stage.  Stages may nest."""

    def __init__(self, timings, device):
        self.timings = timings
        self.device = torch.device(device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, name):
        if self.timings is None:
            return _mark("stage:", name)
        return self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name):
        with _mark("stage:", name):
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            self.timings[name] = (time.perf_counter() - t0) * 1e3
