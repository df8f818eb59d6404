"""Whole-signal frequency-domain filtering of the F0 estimators: Dio
low-passes each band with a Nuttall window (reference
src/dio.cpp:296-343); Harvest band-passes with a cosine-modulated
Nuttall (src/harvest.cpp:99-148).

The reference's convolution writes each spectral product into bin
fft_size-i-1 *while iterating*, so at i = n/2-1 it clobbers the Nyquist
bin before using it and at i = n/2 it clobbers bin n/2-1 with the
(already corrupt) Nyquist product.  The port reproduces that quirk.
"""

import math

import torch

from .common import nuttall_window_masked
from .fftpack import irfft_unnormalized


def _convolve_with_quirk(y_spectrum, filter_spectrum, fft_size):
    """Spectral product with the reference's top-bin corruption: the
    value that ends up at bins half-1 and half is
    y[half] * (y[half-1] * h[half-1]) (src/dio.cpp:317-328)."""
    half = fft_size // 2
    prod = y_spectrum * filter_spectrum
    corrupt = (y_spectrum[..., half] * prod[..., half - 1]).unsqueeze(-1)
    k = torch.arange(half + 1, device=prod.device)
    return torch.where((k == half - 1) | (k == half), corrupt, prod)


def _shift_left(sig, shift, y_length):
    """Circular left shift of each channel by ``shift`` (C,) samples,
    truncated to y_length: sig (B, C, n) -> (B, C, y_length)."""
    src = (torch.arange(y_length, device=sig.device)
           + shift[:, None]) % sig.shape[-1]
    return torch.gather(sig, -1, src.expand(sig.shape[0], -1, -1))


def filtered_signal_dio(half_average_length, fft_size, y_spectrum,
                        y_length):
    """Low-pass every band by a Nuttall window of 4*half_average_length
    samples, then compensate its group delay of 2*half_average_length
    samples.  half_average_length (C,) int; y_spectrum (B, fft_size//2+1).
    Returns (B, C, y_length)."""
    lpf = nuttall_window_masked((half_average_length * 4).to(
        y_spectrum.real.dtype), fft_size)
    prod = _convolve_with_quirk(y_spectrum[:, None, :],
                                torch.fft.rfft(lpf)[None], fft_size)
    return _shift_left(irfft_unnormalized(prod, fft_size),
                       half_average_length * 2, y_length)


def filtered_signal_harvest(boundary_f0, fft_size, fs, y_spectrum, y_length,
                            filter_length_half):
    """Band-pass every channel: Nuttall window times a cosine carrier at
    boundary_f0, applied as a spectral product, then circularly shifted
    left by the filter's group delay and truncated to y_length.

    boundary_f0 (C,) and filter_length_half (C,) int; fs a 0-dim tensor;
    y_spectrum (B, fft_size//2+1).  Returns (B, C, y_length)."""
    dtype, dev = boundary_f0.dtype, boundary_f0.device
    n = filter_length_half * 2 + 1
    w = nuttall_window_masked(n.to(dtype), fft_size)
    i = torch.arange(fft_size, device=dev) - filter_length_half[:, None]
    bpf = w * torch.cos((2.0 * math.pi) * boundary_f0[:, None] * i / fs)
    bpf = torch.where(torch.arange(fft_size, device=dev) < n[:, None], bpf,
                      torch.zeros_like(bpf))
    bpf_spectrum = torch.fft.rfft(bpf)
    prod = _convolve_with_quirk(y_spectrum[:, None, :], bpf_spectrum[None],
                                fft_size)
    return _shift_left(irfft_unnormalized(prod, fft_size),
                       filter_length_half + 1, y_length)
