"""CheapTrick spectral-envelope estimation (reference src/cheaptrick.cpp),
batched over utterances and frames.

Every frame is an F0-adaptive windowed FFT, DC correction, linear
smoothing and cepstral liftering.  The window (half length
round(1.5*fs/f0)) fits inside fft_size because f0 >= 3*fs/(fft_size-3)
is enforced as the reference does (low/unvoiced frames use
kDefaultF0 = 500).

RNG: rng_mode="exact" reproduces the reference's serial xorshift dither
stream (src/cheaptrick.cpp:127-128,150) via GF(2) jumps; "fast" draws
from a torch generator; "none" disables dither.
"""

import torch

from .. import config
from ..device import as_tensor, div, resolve_device
from ..ops import common, fftpack
from ..ops import rng as rng_ops
from ..ops.matlab import matlab_round


def _windowed_waveform(x, fs, f0, positions, fft_size, dither):
    """F0-adaptive Hann-ish windows with mean removal
    (src/cheaptrick.cpp:87-142).  x (B, L); f0/positions (B, F);
    dither (B, F, fft_size).  Returns (B, F, fft_size) zero-padded."""
    dtype, dev = x.dtype, x.device
    half = matlab_round(1.5 * fs / f0)
    win_len = 2 * half + 1
    i = torch.arange(fft_size, device=dev)
    base = i - half[..., None]
    in_window = i < win_len[..., None]
    origin = matlab_round(positions * fs + 0.001)
    seg = common.window_slice(x, origin - half, fft_size)
    pos = div(div(base.to(dtype), 1.5), fs)
    window = 0.5 * torch.cos(config.K_PI * pos * f0[..., None]) + 0.5
    zero = torch.zeros((), dtype=dtype, device=dev)
    window = torch.where(in_window, window, zero)
    window = window / torch.sqrt((window ** 2).sum(-1, keepdim=True))
    waveform = seg * window + dither * config.K_MY_SAFE_GUARD_MINIMUM
    waveform = torch.where(in_window, waveform, zero)
    coeff = waveform.sum(-1, keepdim=True) / window.sum(-1, keepdim=True)
    return torch.where(in_window, waveform - window * coeff, zero)


def _smoothing_with_recovery(smoothed_power, f0, fs, fft_size, q1):
    """Cepstral liftering: smoothing lifter sinc(pi f0 q) x compensation
    lifter (1-2q1)+2q1 cos(2 pi q f0) (reference src/cheaptrick.cpp:22-57).
    smoothed_power (..., half+1); f0 (...)."""
    half = fft_size // 2
    dtype, dev = smoothed_power.dtype, smoothed_power.device
    f0 = f0[..., None]
    quefrency = div(torch.arange(1, half + 1, dtype=dtype, device=dev), fs)
    arg = config.K_PI * f0 * quefrency
    one = torch.ones(f0.shape, dtype=dtype, device=dev)
    smoothing = torch.cat([one, torch.sin(arg) / arg], -1)
    compensation = torch.cat(
        [one, (1.0 - 2.0 * q1)
         + 2.0 * q1 * torch.cos(2.0 * config.K_PI * quefrency * f0)], -1)
    log_power = torch.log(smoothed_power)
    mirrored = torch.cat([log_power, log_power[..., 1:half].flip(-1)], -1)
    cep = torch.fft.rfft(mirrored).real
    lifted = cep * smoothing * compensation / fft_size
    envelope = fftpack.irfft_unnormalized(
        torch.complex(lifted, torch.zeros_like(lifted)), fft_size)
    return torch.exp(envelope[..., : half + 1])


def f0_cap_for(f0_ceil):
    """Smoothing-bin cap for a declared F0 ceiling: kCeilF0 * 1.1 = 880
    bounds every default F0 track (harvest's widened band tops out at
    f0_ceil * 1.1, src/harvest.cpp:1149-1150)."""
    return max(config.K_CEIL_F0 * 1.1, float(f0_ceil) * 1.1) \
        if f0_ceil else config.K_CEIL_F0 * 1.1


def cheap_trick_batch(x, temporal_positions, f0, fs, fft_size, q1=-0.15,
                      rng_mode="exact", f0_cap=config.K_CEIL_F0 * 1.1,
                      frames=None):
    """CheapTrick over B utterances: x (B, L); temporal_positions and f0
    (B, F).  ``frames`` = (offset, total) says the F columns are frames
    offset.. of utterances of ``total`` frames (a frame shard; fast mode
    only), so they draw the dither those frames draw unsharded.
    Returns (B, F, fft_size//2 + 1)."""
    dtype, dev = x.dtype, x.device
    B, n_frames = f0.shape
    half = fft_size // 2
    f0_floor = config.get_f0_floor_for_cheaptrick(fs, fft_size)
    # Mirror width of the smoothing: widths are 2*f0/3 with f0 capped.
    b_max = int((2.0 * f0_cap / 3.0) * fft_size / fs) + 2

    f0_eff = torch.where(f0 <= f0_floor,
                         torch.full((), config.K_DEFAULT_F0, dtype=dtype,
                                    device=dev), f0)
    win_lens = 2 * matlab_round(1.5 * fs / f0_eff) + 1

    if rng_mode == "exact":
        # Per frame the stream is: win_len window draws, then half+1
        # spectral draws (reference consumption order).
        counts = win_lens + (half + 1)
        offsets = torch.cumsum(counts, 1) - counts
        draws = rng_ops.randn_blocks_at(offsets, fft_size + half + 1).to(dtype)
        idx = torch.arange(fft_size, device=dev)
        win_dither = torch.where(idx < win_lens[..., None],
                                 draws[..., :fft_size],
                                 torch.zeros((), dtype=dtype, device=dev))
        spec_dither = torch.gather(
            draws, -1,
            win_lens[..., None] + torch.arange(half + 1, device=dev))
    elif rng_mode == "fast":
        win_dither = rng_ops.fast_normal_frames(
            0, n_frames, (fft_size,), dtype, dev, frames).expand(B, -1, -1)
        spec_dither = rng_ops.fast_normal_frames(
            4, n_frames, (half + 1,), dtype, dev, frames).expand(B, -1, -1)
    elif rng_mode == "none":
        win_dither = torch.zeros((B, n_frames, fft_size), dtype=dtype,
                                 device=dev)
        spec_dither = torch.zeros((B, n_frames, half + 1), dtype=dtype,
                                  device=dev)
    else:
        raise ValueError(f"rng_mode {rng_mode!r}")

    waveform = _windowed_waveform(x, fs, f0_eff, temporal_positions,
                                  fft_size, win_dither)
    spectrum = torch.fft.rfft(waveform)
    power = spectrum.real ** 2 + spectrum.imag ** 2
    # f0 is clamped at the cap for the DC-correction/smoothing bins (the
    # cap is sized from the caller's f0_ceil).
    f0_b = torch.minimum(f0_eff, torch.full((), f0_cap, dtype=dtype,
                                            device=dev))
    power = common.dc_correction(power, f0_b, fs, fft_size)
    power = common.linear_smoothing(power, div(f0_b * 2.0, 3.0), fs,
                                    fft_size, b_max)
    power = power + spec_dither.abs() * config.K_EPS
    return _smoothing_with_recovery(power, f0_eff, fs, fft_size, q1)


def cheap_trick(x, fs, temporal_positions, f0, option=None, rng_mode="exact",
                f0_ceil=None, device=None):
    """Spectral envelope estimation of one utterance
    (reference src/cheaptrick.cpp:200-229).

    ``f0_ceil``: the estimator ceiling the f0 track was produced with, if
    above the default kCeilF0 (800); sizes the smoothing cap.
    Returns the spectrogram (f0_length, fft_size//2 + 1).
    """
    dev = resolve_device(device)
    option = (option or config.CheapTrickOption()).resolve(fs)
    x = as_tensor(x, dev)
    tp = as_tensor(temporal_positions, dev, x.dtype)
    f0 = as_tensor(f0, dev, x.dtype)
    return cheap_trick_batch(x[None], tp[None], f0[None], fs,
                             option.fft_size, q1=option.q1,
                             rng_mode=rng_mode,
                             f0_cap=f0_cap_for(f0_ceil))[0]
