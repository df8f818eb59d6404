"""Sequential prefix sum along rows: csrc/scan.cu and its plain version.

``cumsum_rows(x (B, L))`` returns ``y[b, i] = x[b, 0] + ... + x[b, i]``
summed in order from zero in float64 and rounded to x's dtype on each
write: the reference's order of additions for synthesis's phase sum
(GetPulseLocationsForTimeBase in src/synthesis.cpp), whose rounding
places pulses where the sum ties a period boundary.  torch.cumsum on
the card is a parallel scan, which adds in another order.

On a CUDA tensor the wrapper launches the kernel (always; there is no
fallback).  On a CPU tensor it runs the plain version, torch.cumsum of
the float64 row on the CPU, which loops over each row in order (for
float32 rows the same bits as torch.cumsum of the float32 row, which
also accumulates in double).
"""

import ctypes
import functools

import torch

from . import _cuda

_DTYPES = (torch.float32, torch.float64)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry, its argument types set once."""
    fn = _cuda.load("scan").scan_rows_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cumsum_rows_plain(x):
    """The plain version, on the CPU (a CUDA tensor's rows are summed on a
    host copy and the result copied back)."""
    y = torch.cumsum(x.to("cpu", torch.float64), dim=1)
    return y.to(x.device, x.dtype)


def cumsum_rows(x):
    """Sequential prefix sum of each row of the contiguous float32/float64
    (B, L) tensor ``x``."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32/float64, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, L), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return cumsum_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    B, L = x.shape
    if x.numel() == 0:
        return out
    args = (x.element_size(), x.data_ptr(), out.data_ptr(), B, L,
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        rc = _entry()(*args)
    else:
        with torch.cuda.device(x.device):
            rc = _entry()(*args)
    if rc != 0:
        raise RuntimeError(f"scan kernel launch failed: cudaError {rc}")
    cumsum_rows.launches += 1
    return out


cumsum_rows.launches = 0      # kernel launches (CUDA path only)
