"""Pitch-synchronous overlap-add: the port of the JAX package's only TPU
kernel, world_tpu/ops/pallas_ola.py::_ola_kernel.

Two entries, one CUDA kernel source (csrc/ola.cu) with two index modes:

``ola_accumulate(responses (B, P, fft), offsets (B, P), *, y_padded)``
    the JAX signature and contract: offsets in any order, padded pulses
    carrying all-zero responses (the general mode).
``ola_accumulate_ragged(responses (N, fft), offsets (N,), row_ptr (B+1,),
*, y_padded)``
    real pulses only, rows given as CSR starts, offsets ascending within
    each row (the ragged mode; batch synthesis calls this one).

On a CUDA tensor each launches the kernel (always; there is no
fallback).  On a CPU tensor each runs its plain version: one
``scatter_add_`` per pulse slot, in pulse order — the same function bit
for bit, because no index collides within one slot.  The kernel's bound
is bytes (every response sample read once, every output sample written
once); its design is described in csrc/ola.cu.
"""

import ctypes
import functools

import torch

from . import _cuda

_DTYPES = (torch.float32, torch.float64)
TILES = (512, 1024, 2048)       # output samples per block the kernel has


def tile_for(fft):
    """Output samples per block: half the response length, at least 512.
    Tuned on the card with world_tpu_torch/tools/ola_bench.py --sweep
    (PERF.md): narrower tiles give more blocks where pulses are dense,
    until the grid outgrows one wave of resident blocks."""
    return min(max(TILES[0], fft // 2), TILES[-1])


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry, its argument types set once."""
    fn = _cuda.load("ola").ola_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(responses, offsets, row_ptr, out, B, P, fft, y_padded, *,
           tile=None):
    """Launch csrc/ola.cu on the current stream of ``out``'s device (no
    checks: the entries below make them).  ``row_ptr`` None selects the
    general mode; ``tile`` (one of TILES) defaults to ``tile_for(fft)``,
    which the entries use."""
    dev = out.device
    args = (responses.element_size(), tile or tile_for(fft),
            responses.data_ptr(), offsets.data_ptr(),
            None if row_ptr is None else row_ptr.data_ptr(), out.data_ptr(),
            B, P, fft, y_padded)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        rc = _entry()(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = _entry()(*args, stream)
    if rc != 0:
        raise RuntimeError(f"ola kernel launch failed: cudaError {rc}")


def _check_common(responses, y_padded, *index):
    """dtype, device and layout checks; ``index`` holds (name, tensor)
    pairs of the int32 index tensors."""
    if responses.dtype not in _DTYPES:
        raise TypeError(f"responses must be float32/float64, "
                        f"got {responses.dtype}")
    dev = responses.device
    for name, t in index:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"responses and {name} on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not responses.is_contiguous():
        raise ValueError("responses must be contiguous")
    if responses.shape[-1] > y_padded:
        raise ValueError(f"fft {responses.shape[-1]} > y_padded {y_padded}")
    if dev.type != "cpu" and dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def _check(responses, offsets, y_padded):
    if responses.dim() != 3 or offsets.shape != responses.shape[:2]:
        raise ValueError(f"shapes: responses {tuple(responses.shape)} "
                         f"(B, P, fft), offsets {tuple(offsets.shape)} (B, P)")
    _check_common(responses, y_padded, ("offsets", offsets))


def _check_ragged(responses, offsets, row_ptr, y_padded):
    if (responses.dim() != 2 or offsets.shape != responses.shape[:1]
            or row_ptr.dim() != 1 or row_ptr.numel() < 1):
        raise ValueError(f"shapes: responses {tuple(responses.shape)} "
                         f"(N, fft), offsets {tuple(offsets.shape)} (N,), "
                         f"row_ptr {tuple(row_ptr.shape)} (B+1,)")
    _check_common(responses, y_padded, ("offsets", offsets),
                  ("row_ptr", row_ptr))


def ola_plain(responses, offsets, y_padded):
    """The plain version: sequential per-pulse scatter-add."""
    B, P, fft = responses.shape
    y = torch.zeros((B, y_padded), dtype=responses.dtype,
                    device=responses.device)
    ar = torch.arange(fft, device=responses.device)
    offs = offsets.to(torch.int64)
    for p in range(P):
        y.scatter_add_(1, offs[:, p:p + 1] + ar, responses[:, p])
    return y


def ola_ragged_plain(responses, offsets, row_ptr, y_padded):
    """The plain version of the ragged mode: the k-th pulse of every row
    is scatter-added at step k, so each row sums its pulses in order.
    Raises on a bad ``row_ptr``, an offset out of range, or offsets that
    do not ascend within a row."""
    N, fft = responses.shape
    B = row_ptr.numel() - 1
    dev = responses.device
    counts = torch.diff(row_ptr.to(torch.int64))
    if int(row_ptr[0]) != 0 or int(row_ptr[-1]) != N or bool(
            (counts < 0).any()):
        raise ValueError("row_ptr must rise from 0 to the number of pulses")
    y = torch.zeros(B * y_padded, dtype=responses.dtype, device=dev)
    if N == 0:
        return y.view(B, y_padded)
    offs = offsets.to(torch.int64)
    if int(offs.min()) < 0 or int(offs.max()) > y_padded - fft:
        raise ValueError(f"offsets outside [0, {y_padded - fft}]")
    row = torch.repeat_interleave(torch.arange(B, device=dev), counts)
    if bool(((offs[1:] < offs[:-1]) & (row[1:] == row[:-1])).any()):
        raise ValueError("offsets must ascend within each row")
    slot = torch.arange(N, device=dev) - row_ptr.to(torch.int64)[row]
    start = row * y_padded + offs
    ar = torch.arange(fft, device=dev)
    for k in range(int(counts.max())):
        sel = (slot == k).nonzero(as_tuple=True)[0]
        y.scatter_add_(0, (start[sel, None] + ar).reshape(-1),
                       responses[sel].reshape(-1))
    return y.view(B, y_padded)


def ola_accumulate(responses, offsets, *, y_padded):
    """Scatter-add ``responses[b, p]`` (B, P, fft) at ``offsets[b, p]``
    (int32 (B, P), any order) into a (B, y_padded) waveform, in pulse
    order.

    Offsets MUST already satisfy 0 <= off <= y_padded - fft (clamp and
    zero-fill invalid pulses before calling)."""
    _check(responses, offsets, y_padded)
    B, P, fft = responses.shape
    ola_accumulate.last_shape = (B, P, fft, y_padded)
    if responses.device.type == "cpu":
        return ola_plain(responses, offsets, y_padded)
    out = torch.empty((B, y_padded), dtype=responses.dtype,
                      device=responses.device)
    if B == 0:
        return out
    launch(responses, offsets, None, out, B, P, fft, y_padded)
    ola_accumulate.launches += 1
    return out


ola_accumulate.launches = 0      # kernel launches (CUDA path only)
ola_accumulate.last_shape = None  # (B, P, fft, y_padded) of the last call


def ola_accumulate_ragged(responses, offsets, row_ptr, *, y_padded):
    """Scatter-add the N real pulses ``responses`` (N, fft) at ``offsets``
    (int32 (N,)) into a (B, y_padded) waveform, row b taking pulses
    ``row_ptr[b]:row_ptr[b+1]`` (int32 (B+1,)) in order.

    Contract: 0 <= off <= y_padded - fft and offsets ascending within
    each row.  On the card it is not checked (a check would need a host
    sync); the plain version raises on a violation."""
    _check_ragged(responses, offsets, row_ptr, y_padded)
    N, fft = responses.shape
    B = row_ptr.numel() - 1
    ola_accumulate_ragged.last_shape = (B, N, fft, y_padded)
    if responses.device.type == "cpu":
        return ola_ragged_plain(responses, offsets, row_ptr, y_padded)
    out = torch.empty((B, y_padded), dtype=responses.dtype,
                      device=responses.device)
    if B == 0:
        return out
    launch(responses, offsets, row_ptr, out, B, N, fft, y_padded)
    ola_accumulate_ragged.launches += 1
    return out


ola_accumulate_ragged.launches = 0      # kernel launches (CUDA path only)
ola_accumulate_ragged.last_shape = None  # (B, N, fft, y_padded), last call
