"""FFT conventions matching the reference WORLD library (Ooura's FFT
behind an FFTW-like plan API, reference src/fft.cpp:26-72):

* ``r2c`` forward  == the unnormalized forward DFT of a real signal
  (``torch.fft.rfft``).
* ``c2r`` backward == the *unnormalized* inverse, ``irfft(spec) * n``,
  with the imaginary parts of the DC and Nyquist bins dropped
  (src/fft.cpp:26-35).  cuFFT's c2r assumes a Hermitian input, so the
  drop is explicit here rather than left to the library.
"""

import torch


def rfft(x, n=None):
    """Forward real FFT along the last axis."""
    return torch.fft.rfft(x, n=n, dim=-1)


def _drop_edge_imag(spec):
    half = spec.shape[-1] - 1
    k = torch.arange(half + 1, device=spec.device)
    interior = (k > 0) & (k < half)
    real = torch.complex(spec.real, torch.zeros_like(spec.real))
    return torch.where(interior, spec, real)


def irfft_unnormalized(spec, n):
    """Backward c2r, reference convention: unnormalized (irfft * n), the
    DC and Nyquist imaginary parts dropped."""
    assert (spec.shape[-1] - 1) * 2 == n, (spec.shape, n)
    return torch.fft.irfft(_drop_edge_imag(spec), n=n, dim=-1) * n
