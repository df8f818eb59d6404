"""Codec: compression of the spectral envelope and the band
aperiodicity (reference src/codec.cpp), batched over any leading dims.

The envelope codec resamples the log envelope onto a mel axis and takes
a DCT-II, realised as an even-odd permuted half-size real FFT with
twiddle weights; decoding runs the inverse through conj(FFT) as the
reference's InverseComplexFFT does.  Aperiodicity is sampled in dB at
the 3 kHz coarse grid.
"""

import numpy as np
import torch

from .. import config
from ..config import get_number_of_aperiodicities
from ..device import as_tensor, div, resolve_device
from ..ops.matlab import interp1, interp1q


def _freq_to_mel(f):
    return config.K_M0 * torch.log(div(f, config.K_F0) + 1.0)


def _mel_to_freq(m):
    return config.K_F0 * (torch.exp(div(m, config.K_M0)) - 1.0)


def _mel_range(fs):
    floor_mel = config.K_M0 * np.log(config.K_FLOOR_FREQUENCY / config.K_F0
                                     + 1.0)
    ceil_mel = config.K_M0 * np.log(min(fs / 2.0, config.K_CEIL_FREQUENCY)
                                    / config.K_F0 + 1.0)
    return floor_mel, ceil_mel


def _freq_axis(fs, fft_size, dtype, device):
    """Bin frequencies 0 .. fs/2 of an fft_size real FFT."""
    fs_t = torch.full((), float(fs), dtype=dtype, device=device)
    return torch.arange(fft_size // 2 + 1, dtype=dtype,
                        device=device) * fs_t / fft_size


def code_aperiodicity_batch(aperiodicity, fs, fft_size):
    """CodeAperiodicity (src/codec.cpp:217-236): (..., K) -> (..., n_aper)."""
    dtype, dev = aperiodicity.dtype, aperiodicity.device
    n_aper = get_number_of_aperiodicities(fs)
    coarse_axis = (torch.arange(n_aper, dtype=dtype, device=dev) + 1.0) \
        * config.K_FREQUENCY_INTERVAL
    fs_t = torch.full((), float(fs), dtype=dtype, device=dev)
    return interp1q(0.0, fs_t / fft_size, 20.0 * torch.log10(aperiodicity),
                    coarse_axis)


def decode_aperiodicity_batch(coded, fs, fft_size):
    """DecodeAperiodicity (src/codec.cpp:238-266): (..., n_aper) ->
    (..., fft_size//2+1)."""
    dtype, dev = coded.dtype, coded.device
    n_aper = get_number_of_aperiodicities(fs)
    coarse_axis = torch.cat([
        torch.arange(n_aper + 1, dtype=dtype, device=dev)
        * config.K_FREQUENCY_INTERVAL,
        torch.full((1,), fs / 2.0, dtype=dtype, device=dev)])
    lead = coded.shape[:-1]
    edges = torch.cat([
        torch.full(lead + (1,), -60.0, dtype=dtype, device=dev), coded,
        torch.full(lead + (1,), -config.K_MY_SAFE_GUARD_MINIMUM, dtype=dtype,
                   device=dev)], -1)
    ap = interp1(coarse_axis, edges, _freq_axis(fs, fft_size, dtype, dev))
    ap = torch.pow(10.0, ap / 20.0)
    unvoiced = coded.mean(-1, keepdim=True) > -0.5  # CheckVUV (:31-41)
    return torch.where(unvoiced, torch.full_like(
        ap, 1.0 - config.K_MY_SAFE_GUARD_MINIMUM), ap)


def code_spectral_envelope_batch(spectrogram, fs, fft_size,
                                 number_of_dimensions):
    """CodeSpectralEnvelope (src/codec.cpp:268-297): (..., K) ->
    (..., number_of_dimensions)."""
    dtype, dev = spectrogram.dtype, spectrogram.device
    max_dim = fft_size // 2
    floor_mel, ceil_mel = _mel_range(fs)
    i = torch.arange(max_dim, dtype=dtype, device=dev)
    mel_axis = (ceil_mel - floor_mel) * i / max_dim + floor_mel
    freq_axis = _freq_to_mel(_freq_axis(fs, fft_size, dtype, dev))
    mel = interp1(freq_axis, torch.log(spectrogram), mel_axis)
    # DCT-II as a half-size real FFT of the even-odd permuted sequence
    # (src/codec.cpp:71-91), weighted by twiddles.
    perm = np.empty(max_dim, np.int64)
    perm[: max_dim // 2] = np.arange(max_dim // 2) * 2
    perm[max_dim // 2:] = max_dim - np.arange(max_dim // 2) * 2 - 1
    spec = torch.fft.rfft(mel[..., torch.as_tensor(perm, device=dev)])
    nb = spec.shape[-1]
    k = np.arange(nb)
    w = 2.0 * np.exp(1j * k * config.K_PI / fft_size) / np.sqrt(fft_size)
    w[0] /= np.sqrt(2.0)
    w_re = torch.as_tensor(w.real, dtype=dtype, device=dev)
    w_im = torch.as_tensor(w.imag, dtype=dtype, device=dev)
    cep = (spec.real * w_re - spec.imag * w_im) / np.sqrt(max_dim)
    if number_of_dimensions > nb:
        cep = torch.nn.functional.pad(cep, (0, number_of_dimensions - nb))
    return cep[..., :number_of_dimensions]


def decode_spectral_envelope_batch(coded, fs, fft_size):
    """DecodeSpectralEnvelope (src/codec.cpp:299-324): (..., dims) ->
    (..., fft_size//2+1)."""
    dtype, dev = coded.dtype, coded.device
    dims = coded.shape[-1]
    max_dim = fft_size // 2
    floor_mel, ceil_mel = _mel_range(fs)
    i = torch.arange(max_dim, dtype=dtype, device=dev)
    mel_axis = torch.cat([
        torch.zeros(1, dtype=dtype, device=dev),
        _mel_to_freq((ceil_mel - floor_mel) * i / max_dim + floor_mel),
        torch.full((1,), fs / 2.0, dtype=dtype, device=dev)])
    k = np.arange(dims)
    w = np.exp(1j * k * config.K_PI / fft_size) * np.sqrt(fft_size)
    w[0] /= np.sqrt(2.0)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    scale = torch.as_tensor(np.conj(w) * np.sqrt(max_dim), dtype=cdtype,
                            device=dev)
    inp = torch.nn.functional.pad(coded.to(cdtype) * scale,
                                  (0, max_dim - dims))
    # InverseComplexFFT == conj(forward DFT) (src/fft.cpp:36-46); only
    # the real part is read, which the conjugate leaves as it is.
    out = torch.fft.fft(inp).real
    h = max_dim // 2
    # mel[1 + 2j] = out[j], mel[2 + 2j] = out[max_dim - 1 - j]; the ends
    # repeat their neighbours.
    inner = torch.stack([out[..., :h], out[..., h:].flip(-1)],
                        -1).flatten(-2)
    mel = torch.cat([inner[..., :1], inner, inner[..., -1:]], -1)
    sp = interp1(mel_axis, mel, _freq_axis(fs, fft_size, dtype, dev))
    return torch.exp(sp / max_dim)


def code_aperiodicity(aperiodicity, fs, fft_size=None, device=None):
    """Coded band aperiodicity (frames, n_aper) of (frames, K)."""
    ap = as_tensor(aperiodicity, resolve_device(device))
    if fft_size is None:
        fft_size = 2 * (ap.shape[-1] - 1)
    return code_aperiodicity_batch(ap, fs, fft_size)


def decode_aperiodicity(coded, fs, fft_size, device=None):
    """Full-resolution aperiodicity (frames, fft_size//2+1)."""
    return decode_aperiodicity_batch(
        as_tensor(coded, resolve_device(device)), fs, fft_size)


def code_spectral_envelope(spectrogram, fs, number_of_dimensions,
                           fft_size=None, device=None):
    """Mel-cepstral coding (frames, number_of_dimensions) of the
    envelope (frames, K)."""
    sp = as_tensor(spectrogram, resolve_device(device))
    if fft_size is None:
        fft_size = 2 * (sp.shape[-1] - 1)
    return code_spectral_envelope_batch(sp, fs, fft_size,
                                        number_of_dimensions)


def decode_spectral_envelope(coded, fs, fft_size, number_of_dimensions=None,
                             device=None):
    """Envelope (frames, fft_size//2+1) from its coding; with
    ``number_of_dimensions`` only that many leading coefficients are
    read."""
    coded = as_tensor(coded, resolve_device(device))
    if number_of_dimensions is not None:
        coded = coded[..., :number_of_dimensions]
    return decode_spectral_envelope_batch(coded, fs, fft_size)
