"""Shared DSP blocks: windows, spectral smoothing, minimum phase
(reference src/common.cpp), batched over leading dims.

The JAX package reads analysis windows through slab tables and
static-shift box sums to avoid gathers on the TPU; on the GPU the plain
formulations are the port: a clamped gather for windows, the cumulative
integral for smoothing.
"""

import math

import torch

from ..device import div
from .matlab import interp1q

PI = 3.1415926535897932384
EPS = 2.2204460492503131e-16
SAFE_GUARD_MINIMUM = 1e-12


def get_suitable_fft_size(n):
    """Next power of two (reference src/common.cpp:51-54)."""
    return int(2 ** (int(math.log(n) / math.log(2.0)) + 1))


def _nuttall(t):
    return (0.355768 - 0.487396 * torch.cos((2 * PI) * t)
            + 0.144232 * torch.cos((4 * PI) * t)
            - 0.012604 * torch.cos((6 * PI) * t))


def nuttall_window(n, total=None, dtype=torch.float64, device="cpu"):
    """Nuttall window of static length n (src/common.cpp:113-121),
    zero-padded to ``total`` when given."""
    i = torch.arange(n if total is None else total, dtype=dtype,
                     device=device)
    w = _nuttall(div(i, n - 1.0))
    if total is not None:
        w = torch.where(i < n, w, torch.zeros_like(w))
    return w


def nuttall_window_masked(n, total):
    """Nuttall windows of per-row lengths ``n`` (float tensor (...,)),
    each padded to ``total``: returns (..., total)."""
    i = torch.arange(total, dtype=n.dtype, device=n.device)
    w = _nuttall(i / (n.unsqueeze(-1) - 1.0))
    return torch.where(i < n.unsqueeze(-1), w, torch.zeros_like(w))


def window_slice(x, starts, max_len, rows=None):
    """Edge-clamped contiguous window reads
    ``x[b, clip(start + arange(max_len), 0, L-1)]``.

    x: (B, L); starts: integer (B, ...), or (N,) with the row of each
    window in ``rows`` (N,).  Returns starts.shape + (max_len,)."""
    B, L = x.shape
    idx = (starts.unsqueeze(-1)
           + torch.arange(max_len, device=x.device)).clamp(0, L - 1)
    if rows is None:
        rows = torch.arange(B, device=x.device).reshape(
            (B,) + (1,) * (starts.dim() - 1))
    return x.reshape(-1)[idx + (rows * L).unsqueeze(-1)]


def dc_correction(spectrum, f0, fs, fft_size):
    """Mirror the spectrum below f0 back onto the 0..f0 band
    (src/common.cpp:56-75).  spectrum: (..., fft_size//2+1); f0: (...)."""
    nbins = fft_size // 2 + 1
    dtype = spectrum.dtype
    dev = spectrum.device
    delta = torch.full((), fs / fft_size, dtype=dtype, device=dev)
    upper_limit = 2 + div(f0 * fft_size, fs).to(torch.int64)
    k = torch.arange(nbins, dtype=dtype, device=dev)
    # interp1Q(f0, -delta, input, ...) at queries k*delta: sample the
    # spectrum on the descending axis starting at f0.
    replica = interp1q(f0.unsqueeze(-1), -delta, spectrum, k * delta)
    mask = torch.arange(nbins, device=dev) < (upper_limit - 1).unsqueeze(-1)
    return torch.where(mask, spectrum + replica, spectrum)


def _mirror_extend(spectrum, half, b_max):
    """Spectrum on positions -b_max .. half+b_max by edge reflection
    (reference src/common.cpp:27-46)."""
    assert b_max <= half, (b_max, half)
    pre = spectrum[..., 1:b_max + 1].flip(-1)
    suf = spectrum[..., half - b_max:half].flip(-1)
    return torch.cat([pre, spectrum, suf], dim=-1)


def linear_smoothing(spectrum, width, fs, fft_size, b_max):
    """Rectangular smoothing of width ``width`` Hz (src/common.cpp:77-111),
    by the reference's cumulative-integral formulation.

    The C++ mirrors boundary = int(width*fft/fs)+1 bins; a static
    ``b_max`` >= every runtime boundary adds a constant prefix to the
    integral that cancels in (high-low)/width.  The integral is always
    taken in float64: in float32 the difference of two large running sums
    cancels catastrophically (negative power, then NaN after the log).
    spectrum: (..., fft_size//2+1); width: (...).
    """
    half = fft_size // 2
    dtype = spectrum.dtype
    spectrum = spectrum.to(torch.float64)
    width = width.to(torch.float64).unsqueeze(-1)
    dev = spectrum.device
    delta = torch.full((), fs / fft_size, dtype=torch.float64, device=dev)
    mirrored = _mirror_extend(spectrum, half, b_max)
    origin = -(b_max - 0.5) * delta
    freq = torch.arange(half + 1, dtype=torch.float64, device=dev) * delta
    segment = torch.cumsum(mirrored * delta, dim=-1)
    low = interp1q(origin, delta, segment, freq - width / 2.0)
    high = interp1q(origin, delta, segment, freq + width / 2.0)
    return ((high - low) / width).to(dtype)


def minimum_phase_spectrum(log_spectrum, fft_size):
    """Minimum-phase spectrum from a half log-power spectrum
    (src/common.cpp:182-220): mirror -> cepstrum -> fold -> FFT -> exp.
    log_spectrum: (..., fft_size//2+1) real; returns complex, same shape.
    """
    half = fft_size // 2
    mirrored = torch.cat([log_spectrum, log_spectrum[..., 1:half].flip(-1)],
                         dim=-1)
    cep = torch.fft.rfft(mirrored, dim=-1)
    k = torch.arange(half + 1, device=log_spectrum.device)
    scale = torch.where((k > 0) & (k < half), 2.0, 1.0).to(
        log_spectrum.dtype)
    folded_half = cep * scale
    folded = torch.cat(
        [folded_half,
         torch.zeros(folded_half.shape[:-1] + (fft_size - half - 1,),
                     dtype=folded_half.dtype, device=folded_half.device)],
        dim=-1)
    spec = torch.fft.fft(folded, dim=-1)[..., : half + 1] / fft_size
    return torch.polar(torch.exp(spec.real), spec.imag)
