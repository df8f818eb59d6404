"""Pitch-synchronous overlap-add: the port of the JAX package's only TPU
kernel, world_tpu/ops/pallas_ola.py::_ola_kernel.

``ola_accumulate`` keeps the JAX signature and contract.  On a CUDA
tensor it launches the hand-written kernel in csrc/ola.cu (always; there
is no fallback).  On a CPU tensor it runs the plain version: one
``scatter_add_`` per pulse, in pulse order — the same function bit for
bit, because no index collides within a pulse.

The kernel's bound is bytes (every response sample read once, every
output sample written once); its design — one thread per output sample,
pulses summed in order without atomics — is described in csrc/ola.cu.
"""

import ctypes

import torch

from . import _cuda

_DTYPES = {torch.float32: "ola_accumulate_f32",
           torch.float64: "ola_accumulate_f64"}


def _check(responses, offsets, y_padded):
    if responses.dtype not in _DTYPES:
        raise TypeError(f"responses must be float32/float64, "
                        f"got {responses.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError(f"offsets must be int32, got {offsets.dtype}")
    if responses.dim() != 3 or offsets.shape != responses.shape[:2]:
        raise ValueError(f"shapes: responses {tuple(responses.shape)} "
                         f"(B, P, fft), offsets {tuple(offsets.shape)} (B, P)")
    if responses.device != offsets.device:
        raise ValueError("responses and offsets on different devices")
    if not (responses.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("responses and offsets must be contiguous")
    if responses.shape[2] > y_padded:
        raise ValueError(f"fft {responses.shape[2]} > y_padded {y_padded}")


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


def ola_accumulate(responses, offsets, *, y_padded):
    """Scatter-add ``responses[b, p]`` (B, P, fft) at ``offsets[b, p]``
    (int32 (B, P)) into a (B, y_padded) waveform, in pulse order.

    Offsets MUST already satisfy 0 <= off <= y_padded - fft (clamp and
    zero-fill invalid pulses before calling)."""
    _check(responses, offsets, y_padded)
    B, P, fft = responses.shape
    ola_accumulate.last_shape = (B, P, fft, y_padded)
    if responses.device.type == "cpu":
        return ola_plain(responses, offsets, y_padded)
    if responses.device.type != "cuda":
        raise ValueError(f"unsupported device {responses.device}")
    out = torch.empty((B, y_padded), dtype=responses.dtype,
                      device=responses.device)
    if B == 0:
        return out
    fn = getattr(_cuda.load("ola"), _DTYPES[responses.dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(responses.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(responses.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                B, P, fft, y_padded, stream)
    if rc != 0:
        raise RuntimeError(f"ola kernel launch failed: cudaError {rc}")
    ola_accumulate.launches += 1
    return out


ola_accumulate.launches = 0      # kernel launches (CUDA path only)
ola_accumulate.last_shape = None  # (B, P, fft, y_padded) of the last call
