"""Harvest F0 estimator (reference src/harvest.cpp), batched over
utterances.

Internally always a 1 ms frame period with 40 channels/octave on a
~8 kHz decimated signal, then nearest-neighbour resampled to the
requested period (src/harvest.cpp:1223-1255):

  A. decimate (MATLAB-compatible edge extension) + whole-signal rfft;
     for every channel a cosine-modulated Nuttall band-pass, four
     zero-crossing streams, interp1 -> raw candidates.
  B. channel-run collapse into per-frame candidate lists, +/-3 frame
     overlap smear, then the instantaneous-frequency refinement of every
     valid (frame, candidate) pair: in float64 full FFTs bucketed by
     power-of-two size, the formulation that bit-matches the reference;
     in float32 the JAX package's direct 6-bin DFT on frame-centred
     windows (ops/refine.py, one kernel on the card).
  C. neighbour-consistency pruning (ops/refine.py, one kernel on the
     card).
  D. contour fixing and per-section zero-phase smoothing
     (models/harvest_contour.py).
"""

import math

import numpy as np
import torch

from .. import config
from ..device import StageClock, as_tensor, div, resolve_device, sync
from ..ops import common
from ..ops.common import get_suitable_fft_size
from ..ops.filterbank import filtered_signal_harvest
from ..ops.matlab import decimate, interp1, matlab_round
from ..ops.refine import harvest_refine, remove_unreliable
from ..ops.zerocross import four_zero_crossing_streams
from .harvest_contour import fix_and_smooth

BIG = 2 ** 30
# (pairs x fft_size) elements per refine chunk.
_REFINE_ELEMENTS_CUDA = 1 << 25
_REFINE_ELEMENTS_CPU = 1 << 22


def _waveform_and_spectrum(x, y_length, fft_size, decimation_ratio):
    """Decimate with MATLAB-compatible edge extension, remove DC, rfft
    (src/harvest.cpp:43-93).  x (B, L).  Returns (y, y_spectrum)."""
    if decimation_ratio == 1:
        y = x[:, :y_length]
    else:
        lag = int(math.ceil(140.0 / decimation_ratio) * decimation_ratio)
        B = x.shape[0]
        padded = torch.cat([x[:, :1].expand(B, lag), x,
                            x[:, -1:].expand(B, lag)], 1)
        new_y = decimate(padded, decimation_ratio)
        y = new_y[:, lag // decimation_ratio:lag // decimation_ratio
                  + y_length]
    y = y - y.mean(1, keepdim=True)
    return y, torch.fft.rfft(y, n=fft_size)


def _raw_candidates(boundaries, y_spectrum, y_length, fs_t, fft_size,
                    positions, f0_floor, f0_ceil):
    """Raw F0 candidate contour of every channel (src/harvest.cpp:
    99-293): band-pass, four crossing streams, interp1 at the frame
    positions, mean over the streams.  Returns (B, C, F)."""
    flh = matlab_round(fs_t / boundaries * 2.0)
    filtered = filtered_signal_harvest(boundaries, fft_size, fs_t,
                                       y_spectrum, y_length, flh)
    locs, ints, n_pairs = four_zero_crossing_streams(filtered, y_length, fs_t)
    interp = interp1(locs, ints, positions, n_valid=n_pairs)
    candidate = interp.sum(-2) / 4.0
    b = boundaries[:, None]
    bad = ((candidate > b * 1.1) | (candidate < b * 0.9)
           | (candidate > f0_ceil) | (candidate < f0_floor))
    valid = (n_pairs >= 3).all(-1)[..., None]
    return torch.where(valid & ~bad, candidate, torch.zeros_like(candidate))


def _detect_official_candidates(raw, max_candidates):
    """Collapse voiced channel runs (>= 10 channels) into per-frame
    candidate lists (src/harvest.cpp:348-412).  raw (B, C, F).
    Returns ((B, F, max_candidates), candidate count per utterance (B,))."""
    n_ch = raw.shape[1]
    ch = torch.arange(n_ch, device=raw.device)[:, None]
    vuv = (raw > 0.0) & (ch != 0) & (ch != n_ch - 1)
    prev = torch.cat([torch.zeros_like(vuv[:, :1]), vuv[:, :-1]], 1)
    starts = vuv & ~prev
    ends = ~vuv & prev
    csum = torch.cumsum(raw, 1)
    csum_prev = torch.cat([torch.zeros_like(raw[:, :1]), csum[:, :-1]], 1)
    # latest run start at or before each channel
    latest = torch.cummax(torch.where(starts, ch, -1), 1).values
    st_csum = torch.where(latest >= 0,
                          torch.gather(csum_prev, 1, latest.clamp(min=0)),
                          torch.zeros_like(raw))
    length = ch - latest.clamp(min=0)
    mean = (csum_prev - st_csum) / length.clamp(min=1).to(raw.dtype)
    keep = ends & (length >= 10)
    # Kept run means into slots, in channel order.
    key = torch.where(keep, ch, BIG).transpose(1, 2)           # (B, F, C)
    skey, sidx = torch.sort(key, dim=-1, stable=True)
    skey, sidx = skey[..., :max_candidates], sidx[..., :max_candidates]
    smean = torch.gather(mean.transpose(1, 2), -1, sidx)
    cands = torch.where(skey < BIG, smean, torch.zeros_like(smean))
    if cands.shape[-1] < max_candidates:
        cands = torch.nn.functional.pad(
            cands, (0, max_candidates - cands.shape[-1]))
    return cands, keep.sum(1).amax(1)


def _overlap_candidates(cands, n_cands):
    """Smear candidates +/-3 frames into slots j + C*q
    (src/harvest.cpp:417-429), C = n_cands per utterance: slot s of frame
    f reads column s % C of frame f - shift(s // C), shift = 0,1,2,3,
    -1,-2,-3."""
    B, n_frames, m = cands.shape
    dev = cands.device
    c = n_cands.clamp(min=1)[:, None]
    s = torch.arange(m, device=dev)[None, :]
    q = s // c
    col = s % c
    shift = torch.where(q <= 3, q, -(q - 3))
    f = torch.arange(n_frames, device=dev)[None, :, None]
    src = f - shift[:, None, :]
    ok = (q < 7)[:, None, :] & (src >= 0) & (src < n_frames)
    rows = torch.arange(B, device=dev)[:, None, None]
    val = cands[rows, src.clamp(0, n_frames - 1), col[:, None, :]]
    keep = ok & (n_cands > 0)[:, None, None]
    return torch.where(keep, val, torch.zeros_like(val))


def _refine_pairs(y, rows, fs_t, fft_size, positions, f0, f0_floor,
                  f0_ceil):
    """GetRefinedF0 for N (frame, candidate) pairs at one fft size
    (src/harvest.cpp:434-617).  y (B, Ly); rows/positions/f0 (N,).
    Returns (refined, score), each (N,)."""
    dtype, dev = y.dtype, y.device
    half_window = (1.5 * fs_t / f0 + 1.0).to(torch.int64)
    win_len = 2 * half_window + 1
    wlt = (win_len.to(dtype) / fs_t)[:, None]
    i = torch.arange(fft_size, device=dev)
    in_win = i < win_len[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    # GetBaseIndex (harvest variant): one rounded origin, then +i
    # (src/harvest.cpp:434-441).
    bt0 = -half_window.to(dtype) / fs_t
    basic_index = matlab_round((positions + bt0) * fs_t + 0.001)
    base_index = basic_index[:, None] + i
    tmp = (base_index.to(dtype) - 1.0) / fs_t - positions[:, None]
    main_window = (0.42 + 0.5 * torch.cos(2.0 * config.K_PI * tmp / wlt)
                   + 0.08 * torch.cos(4.0 * config.K_PI * tmp / wlt))
    main_window = torch.where(in_win, main_window, zero)
    nxt = torch.roll(main_window, -1, -1)
    prv = torch.roll(main_window, 1, -1)
    diff_window = -(nxt - prv) / 2.0
    diff_window = torch.where(i == 0, -nxt / 2.0, diff_window)
    diff_window = torch.where(i == (win_len - 1)[:, None], prv / 2.0,
                              diff_window)
    diff_window = torch.where(in_win, diff_window, zero)

    seg = common.window_slice(y, basic_index - 1, fft_size, rows=rows)
    seg = torch.where(in_win, seg, zero)
    main_spec = torch.fft.rfft(seg * main_window)
    diff_spec = torch.fft.rfft(seg * diff_window)
    power = main_spec.real ** 2 + main_spec.imag ** 2
    numer = (main_spec.real * diff_spec.imag
             - main_spec.imag * diff_spec.real)

    # FixF0, harvest flavour: single pass, data-dependent harmonic count
    # (src/harvest.cpp:507-536,571-573).
    n_harm = torch.clamp((fs_t / 2.0 / f0).to(torch.int64), max=6)[:, None]
    harm = torch.arange(1, 7, dtype=dtype, device=dev)
    active = torch.arange(6, device=dev) < n_harm
    index = matlab_round(f0[:, None] * fft_size / fs_t * harm)
    index = index.clamp(0, fft_size // 2)
    ps = torch.gather(power, -1, index)
    nm = torch.gather(numer, -1, index)
    inst = torch.where(ps == 0.0, zero,
                       index.to(dtype) * fs_t / fft_size
                       + div(nm / ps * fs_t, 2.0 * config.K_PI))
    amp = torch.where(active, torch.sqrt(ps), zero)
    refined = (amp * inst * active).sum(-1) / (
        (amp * harm).sum(-1) + config.K_MY_SAFE_GUARD_MINIMUM)
    dev_sum = torch.where(active, torch.abs((inst / harm - f0[:, None])
                                            / f0[:, None]), zero).sum(-1)
    score = 1.0 / (dev_sum / n_harm[:, 0].clamp(min=1)
                   + config.K_MY_SAFE_GUARD_MINIMUM)
    ok = (refined >= f0_floor) & (refined <= f0_ceil) & (score >= 2.5)
    return torch.where(ok, refined, zero), torch.where(ok, score, zero)


def _refine_buckets(fs, f0_floor, f0_ceil):
    hw_min = int(1.5 * fs / f0_ceil + 1.0)
    hw_max = int(1.5 * fs / f0_floor + 1.0)
    lo = 2 ** (2 + int(math.log(hw_min * 2.0 + 1.0) / config.K_LOG2))
    hi = 2 ** (2 + int(math.log(hw_max * 2.0 + 1.0) / config.K_LOG2))
    sizes, s = [], lo
    while s <= hi:
        sizes.append(s)
        s *= 2
    return sizes


def _refine_all(y, fs_t, positions, cands, f0_floor, f0_ceil, sizes,
                fs_static):
    """Refine every valid (frame, candidate) pair.  cands (B, F, M);
    ``fs_static`` is y's rate as a Python float.  Returns (refined,
    scores), each (B, F, M).

    float64: the bucketed-FFT formulation, bucketed by the pair's fft
    size (the golden path, as JAX keeps it).  float32: JAX's direct 6-bin
    DFT on frame-centred windows (ops/refine.harvest_refine), with JAX's
    window bound: candidates reach down to f0_floor 0.9 0.9 (the x0.9
    channel widening and the +-10% acceptance band)."""
    if cands.dtype == torch.float32:
        hw_max = int(1.5 * fs_static / (f0_floor * 0.9 * 0.9) + 1.0) + 1
        return harvest_refine(y.contiguous(), positions.contiguous(),
                              cands.contiguous(), fs_static, f0_floor,
                              f0_ceil, hw_max)
    dev = y.device
    usable = cands > 0.0
    rows, frames, _ = usable.nonzero(as_tuple=True)
    f0 = cands[usable]
    pos = positions[frames]
    # The bucket exponent in float64, as the reference's double math.
    hw = (1.5 * fs_t / f0 + 1.0).to(torch.int64)
    pair_fft = 2 ** (2 + torch.floor(
        torch.log(hw.to(torch.float64) * 2.0 + 1.0)
        / config.K_LOG2).to(torch.int64))
    refined = torch.zeros_like(f0)
    scores = torch.zeros_like(f0)
    budget = (_REFINE_ELEMENTS_CUDA if dev.type == "cuda"
              else _REFINE_ELEMENTS_CPU)
    for fft_size in sizes:
        sel = (pair_fft == fft_size).nonzero(as_tuple=True)[0]
        chunk = max(1, budget // fft_size)
        for a in range(0, sel.shape[0], chunk):
            p = sel[a:a + chunk]
            r, s = _refine_pairs(y, rows[p], fs_t, fft_size, pos[p], f0[p],
                                 f0_floor, f0_ceil)
            refined[p] = r
            scores[p] = s
    out_r = torch.zeros_like(cands)
    out_s = torch.zeros_like(cands)
    out_r[usable] = refined
    out_s[usable] = scores
    return out_r, out_s


def _candidate_stage(x, fs, f0_floor, f0_ceil, channels_in_octave, speed,
                     clock):
    """Stages A-B up to the refinement, at the 1 ms internal frame
    period.  x (B, L).  Returns (y (B, Ly) decimated, its rate as a
    Python float, y's rate as a 0-dim tensor, positions (F1,),
    candidates (B, F1, slots))."""
    dtype, dev = x.dtype, x.device
    x_length = x.shape[1]
    adj_floor = f0_floor * 0.9
    adj_ceil = f0_ceil * 1.1
    n_channels = 1 + int(math.log(adj_ceil / adj_floor)
                         / config.K_LOG2 * channels_in_octave)
    boundaries_np = adj_floor * 2.0 ** (
        (np.arange(n_channels) + 1) / channels_in_octave)

    decimation_ratio = max(min(speed, 12), 1)
    y_length = int(math.ceil(x_length / decimation_ratio))
    actual_fs = fs / decimation_ratio
    fft_size = get_suitable_fft_size(
        y_length + 5 + 2 * int(2.0 * actual_fs / boundaries_np[0]))
    with clock("harvest.decimate"):
        y, y_spectrum = _waveform_and_spectrum(x, y_length, fft_size,
                                               decimation_ratio)

    f0_length = config.get_samples_for_harvest(fs, x_length, 1.0)
    positions = div(torch.arange(f0_length, dtype=dtype, device=dev), 1000.0)
    fs_t = torch.full((), actual_fs, dtype=dtype, device=dev)
    with sync("harvest.boundaries"):
        boundaries = torch.as_tensor(boundaries_np, dtype=dtype, device=dev)
    with clock("harvest.filterbank"):
        raw = _raw_candidates(boundaries, y_spectrum, y_length, fs_t,
                              fft_size, positions, f0_floor, f0_ceil)
        max_candidates = int(round(n_channels / 10.0)) * 7
        cands0, n_cands = _detect_official_candidates(raw, max_candidates)
        cands = _overlap_candidates(cands0, n_cands)
    return y, actual_fs, fs_t, positions, cands


def _harvest_candidates(x, fs, f0_floor, f0_ceil, channels_in_octave,
                        speed, clock):
    """Stages A-C at the 1 ms internal frame period.  x (B, L).
    Returns (candidates, scores), each (B, F1, slots)."""
    y, actual_fs, fs_t, positions, cands = _candidate_stage(
        x, fs, f0_floor, f0_ceil, channels_in_octave, speed, clock)
    with clock("harvest.refine"):
        sizes = _refine_buckets(actual_fs, f0_floor, f0_ceil)
        refined, scores = _refine_all(y, fs_t, positions, cands, f0_floor,
                                      f0_ceil, sizes, actual_fs)
        return remove_unreliable(refined, scores)


def harvest_batch(x, fs, frame_period=5.0, f0_floor=config.K_FLOOR_F0,
                  f0_ceil=config.K_CEIL_F0, clock=None):
    """Harvest over B utterances of equal length, x (B, L)
    (reference src/harvest.cpp:1223-1255): 1 ms-internal analysis,
    contour fix + smoothing, then nearest-neighbour resampling to
    ``frame_period``.  Returns (temporal_positions (F,), f0 (B, F)).
    ``clock`` (device.StageClock) times the parts when given."""
    dtype, dev = x.dtype, x.device
    x_length = x.shape[1]
    dimension_ratio = int(round(fs / 8000.0))
    clock = clock or StageClock(None, dev)
    cands, scores = _harvest_candidates(x, fs, f0_floor, f0_ceil, 40.0,
                                        dimension_ratio, clock)
    with clock("harvest.contour"):
        basic_f0 = fix_and_smooth(cands, scores)

    f0_length = config.get_samples_for_harvest(fs, x_length, frame_period)
    # Host float64 positions cast once (src/harvest.cpp:1248): computed
    # on the device they can land 1 ulp off and flip .5-rounding.
    with sync("harvest.positions"):
        temporal_positions = torch.as_tensor(
            np.arange(f0_length, dtype=np.float64) * frame_period / 1000.0,
            dtype=dtype, device=dev)
    if frame_period == 1.0:
        return temporal_positions, basic_f0[:, :f0_length]
    # matlab_round (half away from zero), not torch.round (half to even):
    # fractional periods like 2.5 ms hit exact x.5 positions.
    idx = matlab_round(temporal_positions * 1000.0).clamp(
        max=basic_f0.shape[1] - 1)
    return temporal_positions, basic_f0[:, idx]


def harvest(x, fs, option=None, device=None):
    """Harvest F0 estimation of one utterance (reference
    src/harvest.cpp:1223-1255).  Returns (temporal_positions, f0) at
    option.frame_period ms."""
    option = option or config.HarvestOption()
    x = as_tensor(x, resolve_device(device))
    tp, f0 = harvest_batch(x[None], fs, option.frame_period,
                           option.f0_floor, option.f0_ceil)
    return tp, f0[0]
