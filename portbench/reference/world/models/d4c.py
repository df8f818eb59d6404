"""D4C band-aperiodicity estimation (reference src/d4c.cpp), batched over
utterances and frames.

A LoveTrain VUV/energy gate runs on every frame; D4CGeneralBody then runs
only on the frames that pass it, selected with a mask: a static group
delay from two offset Blackman-window centroids and a smoothed power
spectrum, from which a coarse aperiodicity per 3 kHz band is read off a
sorted cumulative power tail.  RNG consumption order (LoveTrain windows
for voiced frames, then centroid1/centroid2/smoothed windows for passing
frames) matches the reference stream in exact mode.
"""

import numpy as np
import torch

from .. import config
from ..device import as_tensor, div, resolve_device
from ..ops import common
from ..ops import rng as rng_ops
from ..ops.matlab import interp1, matlab_round
from .cheaptrick import f0_cap_for

HANNING = 1
BLACKMAN = 2


def _windowed_waveform(x, fs, rows, f0, positions, window_type,
                       window_length_ratio, max_len, dither):
    """F0-adaptive windows with mean removal (src/d4c.cpp:21-84) for N
    frames: rows/f0/positions (N,), dither (N, max_len) at scale
    kSafeGuardD4C.  Returns (N, max_len), zero-padded."""
    dtype, dev = x.dtype, x.device
    half = matlab_round(window_length_ratio * fs / f0 / 2.0)
    win_len = 2 * half + 1
    i = torch.arange(max_len, device=dev)
    base = i - half[:, None]
    in_win = i < win_len[:, None]
    origin = matlab_round(positions * fs + 0.001)
    seg = common.window_slice(x, origin - half, max_len, rows=rows)
    pos = div(div(2.0 * base.to(dtype), window_length_ratio), fs)
    arg = config.K_PI * pos * f0[:, None]
    if window_type == HANNING:
        window = 0.5 * torch.cos(arg) + 0.5
    else:
        window = 0.42 + 0.5 * torch.cos(arg) + 0.08 * torch.cos(arg * 2)
    zero = torch.zeros((), dtype=dtype, device=dev)
    window = torch.where(in_win, window, zero)
    waveform = seg * window + dither * config.K_SAFE_GUARD_D4C
    waveform = torch.where(in_win, waveform, zero)
    coeff = waveform.sum(-1, keepdim=True) / window.sum(-1, keepdim=True)
    return torch.where(in_win, waveform - window * coeff, zero)


def _love_train(x, fs, fft_size, boundaries, rows, f0, positions, dither):
    """Cumulative band-power ratio for VUV detection
    (src/d4c.cpp:227-252)."""
    b0, b1, b2 = boundaries
    waveform = _windowed_waveform(x, fs, rows, f0, positions, BLACKMAN,
                                  3.0, fft_size, dither)
    spec = torch.fft.rfft(waveform)
    power = spec.real ** 2 + spec.imag ** 2
    k = torch.arange(power.shape[-1], device=x.device)
    power = torch.where(k <= b0, torch.zeros_like(power), power)
    cum = torch.cumsum(power, -1)
    return cum[:, b1] / cum[:, b2]


def _centroid(x, fs, fft_size, rows, f0, positions, dither):
    """Energy centroid (src/d4c.cpp:90-120)."""
    waveform = _windowed_waveform(x, fs, rows, f0, positions, BLACKMAN,
                                  4.0, fft_size, dither)
    power = (waveform ** 2).sum(-1, keepdim=True)
    waveform = waveform / torch.sqrt(power)
    spec1 = torch.fft.rfft(waveform)
    ramp = torch.arange(fft_size, dtype=x.dtype, device=x.device) + 1.0
    spec2 = torch.fft.rfft(waveform * ramp)
    return spec1.real * spec2.real + spec1.imag * spec2.imag


def _coarse_aperiodicity(static_group_delay, fs, fft_size, n_bands, window,
                         window_length):
    """Per-band sorted cumulative power tail of the windowed group delay
    (src/d4c.cpp:194-225).  static_group_delay (N, fft_size//2+1)."""
    boundary = int(fft_size * 8.0 / window_length + 0.5)
    half_window = window_length // 2
    half = fft_size // 2
    # Band centres depend only on static parameters; Python float is IEEE
    # double, so int(3000*(b+1)*fft/fs) reproduces the C++ static_cast.
    segs = [static_group_delay[:, c - half_window:c + half_window + 1]
            for c in (int(config.K_FREQUENCY_INTERVAL * (band + 1)
                          * fft_size / fs) for band in range(n_bands))]
    seg = torch.stack(segs, 1) * window
    spec = torch.fft.rfft(seg, n=fft_size)
    power = spec.real ** 2 + spec.imag ** 2
    total = power.sum(-1)
    top = torch.sort(power, dim=-1).values[..., half - boundary:]
    return 10.0 * torch.log10((total - top.sum(-1)) / total)


def _d4c_body(x, fs, fft_size, n_bands, window, window_length, f0_cap,
              b_max, rows, f0s, positions, dithers):
    """D4CGeneralBody (src/d4c.cpp:293-321) on N passing frames: coarse
    aperiodicity per band, before the frequency-axis interpolation."""
    dtype = x.dtype
    f0s = torch.minimum(f0s, torch.full((), f0_cap, dtype=dtype,
                                        device=x.device))
    c1 = _centroid(x, fs, fft_size, rows, f0s, positions - 0.25 / f0s,
                   dithers[:, 0])
    c2 = _centroid(x, fs, fft_size, rows, f0s, positions + 0.25 / f0s,
                   dithers[:, 1])
    waveform = _windowed_waveform(x, fs, rows, f0s, positions, HANNING,
                                  4.0, fft_size, dithers[:, 2])
    spec = torch.fft.rfft(waveform)
    static_centroid = common.dc_correction(c1 + c2, f0s, fs, fft_size)
    smoothed = common.dc_correction(spec.real ** 2 + spec.imag ** 2, f0s,
                                    fs, fft_size)
    smoothed = common.linear_smoothing(smoothed, f0s, fs, fft_size, b_max)
    # Guard the division for float32: the smoothed power of a silent
    # window can underflow to 0.
    smoothed = torch.clamp(smoothed, min=torch.finfo(dtype).tiny * 1e8)
    sgd = static_centroid / smoothed
    sgd = common.linear_smoothing(sgd, f0s / 2.0, fs, fft_size, b_max)
    sgd = sgd - common.linear_smoothing(sgd, f0s, fs, fft_size, b_max)
    coarse = _coarse_aperiodicity(sgd, fs, fft_size, n_bands, window,
                                  window_length)
    return torch.clamp(coarse + div(f0s - 100.0, 50.0)[:, None], max=0.0)


def d4c_batch(x, temporal_positions, f0, fs, fft_size,
              threshold=config.K_THRESHOLD, rng_mode="exact",
              f0_cap=config.K_CEIL_F0 * 1.1, frames=None):
    """D4C over B utterances: x (B, L); temporal_positions and f0 (B, F).
    fft_size is the OUTPUT resolution (CheapTrick's).  ``frames`` as in
    cheap_trick_batch (a frame shard's place in its utterances).  Returns
    the aperiodicity (B, F, fft_size//2+1)."""
    dtype, dev = x.dtype, x.device
    B, n_frames = f0.shape
    half_out = fft_size // 2
    fft_lt = config.get_fft_size_for_d4c_love_train(fs)
    fft_d4c = config.get_fft_size_for_d4c(fs)
    n_bands = config.get_number_of_aperiodicities(fs)
    # LoveTrain cumulative-power boundaries at 100/4000/7900 Hz
    # (src/d4c.cpp:270-272), clamped to Nyquist at low rates where the
    # reference reads past the spectrum (a documented divergence from
    # reference UB, as in the JAX package).
    boundaries = tuple(min(int(np.ceil(f * fft_lt / fs)), fft_lt // 2)
                       for f in (100.0, 4000.0, 7900.0))
    window_length = int(config.K_FREQUENCY_INTERVAL * fft_d4c / fs) * 2 + 1
    window = common.nuttall_window(window_length, dtype=dtype, device=dev)

    voiced = f0 != 0.0
    f0_lt = torch.clamp(f0, min=40.0)
    f0_body = torch.clamp(f0, min=config.K_FLOOR_F0_D4C)

    # RNG draws in the reference's sequential consumption order; counts
    # use the same expressions as the window halves.
    lt_counts = torch.where(voiced, 2 * matlab_round(3.0 * fs / f0_lt / 2.0)
                            + 1, torch.zeros((), dtype=torch.int64,
                                             device=dev))
    max_lt = 2 * int(round(1.5 * fs / 40.0)) + 2
    body_win = 2 * matlab_round(4.0 * fs / f0_body / 2.0) + 1
    max_body = 2 * int(round(2.0 * fs / config.K_FLOOR_F0_D4C)) + 2
    if rng_mode == "exact":
        lt_offsets = torch.cumsum(lt_counts, 1) - lt_counts
        lt_dither = rng_ops.randn_blocks_at(lt_offsets, max_lt).to(dtype)
    elif rng_mode == "fast":
        lt_dither = rng_ops.fast_normal_frames(
            1, n_frames, (max_lt,), dtype, dev, frames).expand(B, -1, -1)
    elif rng_mode == "none":
        lt_dither = torch.zeros((B, n_frames, max_lt), dtype=dtype,
                                device=dev)
    else:
        raise ValueError(f"rng_mode {rng_mode!r}")

    rows = torch.arange(B, device=dev)[:, None].expand(B, n_frames)
    ap0 = _love_train(
        x, fs, fft_lt, boundaries, rows.reshape(-1), f0_lt.reshape(-1),
        temporal_positions.reshape(-1),
        torch.nn.functional.pad(lt_dither, (0, fft_lt - max_lt)).reshape(
            -1, fft_lt)).reshape(B, n_frames)
    ap0 = torch.where(voiced, ap0, torch.zeros_like(ap0))
    passing = voiced & (ap0 > threshold)

    # D4CGeneralBody only for frames passing the gate
    # (src/d4c.cpp:385-395); the rest keep the default row.
    n_pass = int(passing.sum())
    if rng_mode == "exact":
        body_counts = torch.where(passing, 3 * body_win,
                                  torch.zeros_like(body_win))
        body_offsets = (lt_counts.sum(1, keepdim=True)
                        + torch.cumsum(body_counts, 1) - body_counts)
        flat_offsets = (body_offsets[..., None]
                        + body_win[..., None] * torch.arange(3, device=dev))
        body_dither = rng_ops.randn_blocks_at(flat_offsets[passing],
                                              max_body).to(dtype)
    elif rng_mode == "fast":
        # Gathered by frame index, not by rank among the batch's passing
        # frames, so a frame's draws do not depend on the other rows.
        frame = torch.arange(n_frames, device=dev).expand(B, n_frames)
        body_dither = rng_ops.fast_normal_frames(
            2, n_frames, (3, max_body), dtype, dev, frames)[frame[passing]]
    else:
        body_dither = torch.zeros((n_pass, 3, max_body), dtype=dtype,
                                  device=dev)
    body_dither = torch.nn.functional.pad(body_dither,
                                          (0, fft_d4c - max_body))
    b_max = int(f0_cap * fft_d4c / fs) + 2
    coarse = torch.zeros((B, n_frames, n_bands), dtype=dtype, device=dev)
    # Below 12 kHz there is no coarse band (fs=8000: n_bands 0); passing
    # frames then interpolate between the two edge values alone.
    if n_pass and n_bands:
        coarse[passing] = _d4c_body(
            x, fs, fft_d4c, n_bands, window, window_length, f0_cap, b_max,
            rows[passing], f0_body[passing], temporal_positions[passing],
            body_dither)

    # Assemble [-60, coarse..., -eps] and interpolate onto the output axis
    # (src/d4c.cpp:330-338,372-394).
    edges = torch.cat(
        [torch.full((B, n_frames, 1), -60.0, dtype=dtype, device=dev), coarse,
         torch.full((B, n_frames, 1), -config.K_MY_SAFE_GUARD_MINIMUM,
                    dtype=dtype, device=dev)], -1)
    coarse_axis = torch.cat(
        [torch.arange(n_bands + 1, dtype=dtype, device=dev)
         * config.K_FREQUENCY_INTERVAL,
         torch.full((1,), fs / 2.0, dtype=dtype, device=dev)])
    freq_axis = torch.arange(half_out + 1, dtype=dtype, device=dev) * float(
        fs) / fft_size
    ap = interp1(coarse_axis, edges, freq_axis)
    ap = torch.pow(10.0, div(ap, 20.0))
    default = torch.full((), 1.0 - config.K_MY_SAFE_GUARD_MINIMUM,
                         dtype=dtype, device=dev)
    return torch.where(passing[..., None], ap, default)


def d4c(x, fs, temporal_positions, f0, fft_size=None, option=None,
        rng_mode="exact", f0_ceil=None, device=None):
    """D4C aperiodicity of one utterance (reference src/d4c.cpp:342-403).

    fft_size is the *output* spectral resolution (CheapTrick's fft_size).
    Returns aperiodicity (f0_length, fft_size//2 + 1).
    """
    dev = resolve_device(device)
    option = option or config.D4COption()
    if fft_size is None:
        fft_size = config.get_fft_size_for_cheaptrick(fs)
    x = as_tensor(x, dev)
    tp = as_tensor(temporal_positions, dev, x.dtype)
    f0 = as_tensor(f0, dev, x.dtype)
    return d4c_batch(x[None], tp[None], f0[None], fs, fft_size,
                     threshold=option.threshold, rng_mode=rng_mode,
                     f0_cap=f0_cap_for(f0_ceil))[0]
