"""Device resolution, host-device copies and the IEEE-division helper
shared by the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise instead of quietly
running on the CPU.
"""

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
    not wait for the work already queued on the stream."""
    if device.type == "cpu":
        return torch.as_tensor(arr, dtype=dtype)
    host = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = arr
    return host.to(device, non_blocking=True)


def download(tensors, device):
    """Start copying ``tensors`` (on ``device``) to the host: non_blocking
    into pinned memory, with a CUDA event recorded behind the copies.
    Returns (host tensors, event); the event is None on the CPU, where
    the tensors are returned as they are."""
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


class StageClock:
    """Times named stages into ``timings`` (wall milliseconds, with the
    device synchronized around each stage); a no-op when ``timings`` is
    None.  Stages may nest."""

    def __init__(self, timings, device):
        self.timings = timings
        self.device = torch.device(device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name):
        if self.timings is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.timings[name] = (time.perf_counter() - t0) * 1e3
