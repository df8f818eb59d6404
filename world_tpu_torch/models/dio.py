"""Dio F0 estimator (reference src/dio.cpp), batched over utterances.

  A. optional decimation, DC removal and a 50 Hz low-cut, one
     whole-signal rfft per utterance;
  B. per band a Nuttall low-pass, four zero-crossing streams, interp1
     onto the frame grid; candidate = mean of the streams, scored by
     their spread; the best band per frame;
  C. the four-step contour fix.  Steps 3 and 4 are walks along the
     frames (the reference's section-by-section loops chain head to
     tail, which one walk with an "active" flag reproduces): on the card
     one launch of csrc/dio_fix.cu (ops/contour.py), on the CPU its
     plain version, the Python loops over frames below, vectorised over
     utterances.

The JAX package's float32 path replaces B's crossing lists by frame-block
summaries (a TPU workaround, proved bit-equal to this form by
tests/test_f0.py); the port runs B's plain form for both dtypes.
"""

import math

import numpy as np
import torch

from .. import config
from ..device import StageClock, as_tensor, div, resolve_device, sync
from ..ops.common import get_suitable_fft_size
from ..ops.contour import dio_fix_walks
from ..ops.filterbank import filtered_signal_dio
from ..ops.matlab import decimate, interp1, matlab_round
from ..ops.zerocross import four_zero_crossing_streams


def _design_low_cut_filter(n, fft_size):
    """50 Hz low-cut as 1 - normalized Hann (reference src/dio.cpp:40-53),
    stored rotated so the filter is zero-phase.  Host float64."""
    w = 0.5 - 0.5 * np.cos(np.arange(1, n + 1) * 2.0 * np.pi / (n + 1))
    lcf = np.zeros(fft_size)
    lcf[:n] = -w / w.sum()
    shift = (n - 1) // 2
    lcf[fft_size - shift:] = lcf[:shift]
    lcf[: n - shift] = lcf[shift:n]
    lcf[n - shift: n] = 0.0
    lcf[0] += 1.0
    return lcf


def _spectrum_for_estimation(x, y_length, actual_fs, fft_size,
                             decimation_ratio):
    """Decimated, DC-removed, low-cut-filtered spectrum of each row of
    x (B, L) (src/dio.cpp:60-106).  Returns (B, fft_size//2+1)."""
    base = decimate(x, decimation_ratio) if decimation_ratio != 1 else x
    y = torch.nn.functional.pad(base, (0, y_length - base.shape[1]))
    y = y - y.mean(1, keepdim=True)
    cutoff_in_sample = int(round(actual_fs / config.K_CUT_OFF))
    with sync("dio.lowcut"):
        lcf = torch.as_tensor(_design_low_cut_filter(cutoff_in_sample * 2 + 1,
                                                     fft_size),
                              dtype=x.dtype, device=x.device)
    return torch.fft.rfft(y, n=fft_size) * torch.fft.rfft(lcf)


def _band_candidates(boundaries, y_spectrum, y_length, fs_t, fft_size,
                     positions, f0_floor, f0_ceil):
    """Candidate contour and score of every band (src/dio.cpp:441-544).
    boundaries (C,); y_spectrum (B, K).  Returns (B, C, F) each."""
    hal = matlab_round(fs_t / boundaries / 2.0)
    filtered = filtered_signal_dio(hal, fft_size, y_spectrum, y_length)
    locs, ints, n_pairs = four_zero_crossing_streams(filtered, y_length, fs_t)
    interp = interp1(locs, ints, positions, n_valid=n_pairs)  # (B, C, 4, F)
    candidate = interp.mean(-2)
    dev = interp - candidate.unsqueeze(-2)
    score = torch.sqrt(div((dev * dev).sum(-2), 3.0))
    b = boundaries[:, None]
    bad = ((candidate > b) | (candidate < b / 2.0)
           | (candidate > f0_ceil) | (candidate < f0_floor))
    ok = (n_pairs >= 3).all(-1).unsqueeze(-1) & ~bad
    candidate = torch.where(ok, candidate, torch.zeros_like(candidate))
    score = torch.where(ok, score, torch.full_like(score,
                                                   config.K_MAXIMUM_VALUE))
    return candidate, score / (candidate + config.K_MY_SAFE_GUARD_MINIMUM)


def _select_best(current, past, cands, allowed_range):
    """SelectBestF0 (src/dio.cpp:190-209), per row: current/past (B,),
    cands (B, C).  Returns (B,)."""
    reference = (current * 3.0 - past) / 2.0
    err = torch.abs(reference[:, None] - cands)
    best = torch.gather(cands, 1, err.argmin(1, keepdim=True))[:, 0]
    return torch.where(torch.abs(1.0 - best / reference) > allowed_range,
                       torch.zeros_like(best), best)


def _fix_step1(best, voice_range_minimum, allowed_range):
    """Zero out jumps (src/dio.cpp:132-150).  best (B, F)."""
    n = best.shape[-1]
    i = torch.arange(n, device=best.device)
    zero = torch.zeros_like(best)
    base = torch.where((i < voice_range_minimum)
                       | (i >= n - voice_range_minimum), zero, best)
    prev = torch.nn.functional.pad(base[:, :-1], (1, 0))
    keep = torch.abs((base - prev) / (config.K_MY_SAFE_GUARD_MINIMUM + base)) \
        < allowed_range
    return torch.where((i >= voice_range_minimum) & keep, base, zero)


def _fix_step2(f0_step1, voice_range_minimum):
    """Zero frames whose +/-center window holds a zero
    (src/dio.cpp:156-169).  f0_step1 (B, F)."""
    center = (voice_range_minimum - 1) // 2
    n = f0_step1.shape[-1]
    ok = f0_step1 != 0.0
    allok = ok
    for j in range(-center, center + 1):
        if j:
            allok = allok & torch.roll(ok, -j, -1)
    i = torch.arange(n, device=f0_step1.device)
    middle = (i >= center) & (i < n - center)
    return torch.where(middle & ~allok, torch.zeros_like(f0_step1), f0_step1)


def _fix_step3(f0_step2, candidates, allowed_range):
    """Forward re-selection from each voiced->unvoiced boundary
    (src/dio.cpp:215-231).  f0_step2 (B, F); candidates (B, F, C)."""
    nz = f0_step2 != 0.0
    # a negative boundary at t-1 makes t the first frame written
    start = torch.nn.functional.pad(nz[:, :-1] & ~nz[:, 1:], (1, 0))
    out = [f0_step2[:, 0]]
    prev1, prev2 = f0_step2[:, 0], torch.zeros_like(f0_step2[:, 0])
    active = torch.zeros_like(nz[:, 0])
    for t in range(1, f0_step2.shape[1]):
        active = active | start[:, t]
        sel = _select_best(prev1, prev2, candidates[:, t], allowed_range)
        val = torch.where(active, sel, f0_step2[:, t])
        active = active & (val != 0.0)
        prev1, prev2 = val, prev1
        out.append(val)
    return torch.stack(out, 1)


def _fix_step4(f0_step3, f0_step2, candidates, allowed_range):
    """Backward re-selection from each unvoiced->voiced boundary
    (src/dio.cpp:237-253): boundaries from f0_step2, values from
    f0_step3.  Frame 0 is never rewritten."""
    nz = f0_step2 != 0.0
    # a positive boundary at t+1 makes t the first frame written
    start = torch.nn.functional.pad(~nz[:, :-1] & nz[:, 1:], (0, 1))
    n = f0_step3.shape[1]
    out = [f0_step3[:, n - 1]]
    next1, next2 = f0_step3[:, n - 1], torch.zeros_like(f0_step3[:, 0])
    active = torch.zeros_like(nz[:, 0])
    for t in range(n - 2, -1, -1):
        active = active | start[:, t]
        if t:
            sel = _select_best(next1, next2, candidates[:, t], allowed_range)
            val = torch.where(active, sel, f0_step3[:, t])
        else:
            val = f0_step3[:, 0]
        active = active & (val != 0.0)
        next1, next2 = val, next1
        out.append(val)
    return torch.stack(out[::-1], 1)


def dio_batch(x, fs, frame_period=5.0, f0_floor=config.K_FLOOR_F0,
              f0_ceil=config.K_CEIL_F0, channels_in_octave=2.0, speed=1,
              allowed_range=0.1, clock=None):
    """Dio over B utterances of equal length, x (B, L) (reference
    src/dio.cpp:578-635).  Returns (temporal_positions (F,), f0 (B, F)).
    ``clock`` (device.StageClock) times the contour fix as "dio.fix"."""
    dtype, dev = x.dtype, x.device
    clock = clock or StageClock(None, dev)
    x_length = x.shape[1]
    number_of_bands = 1 + int(math.log(f0_ceil / f0_floor) / config.K_LOG2
                              * channels_in_octave)
    boundaries_np = f0_floor * 2.0 ** (
        (np.arange(number_of_bands) + 1) / channels_in_octave)

    decimation_ratio = max(min(speed, 12), 1)
    y_length = 1 + x_length // decimation_ratio
    actual_fs = fs / decimation_ratio
    fft_size = get_suitable_fft_size(
        y_length + int(round(actual_fs / config.K_CUT_OFF)) * 2 + 1
        + 4 * int(1.0 + actual_fs / boundaries_np[0] / 2.0))
    y_spectrum = _spectrum_for_estimation(x, y_length, actual_fs, fft_size,
                                          decimation_ratio)

    f0_length = config.get_samples_for_dio(fs, x_length, frame_period)
    # Host float64 constants in the reference's order (i * fp) / 1000
    # (src/dio.cpp:610), cast once: computed on the device they can land
    # 1 ulp off and flip .5-rounding (every odd frame at 44.1 kHz).
    with sync("dio.positions"):
        temporal_positions = torch.as_tensor(
            np.arange(f0_length, dtype=np.float64) * frame_period / 1000.0,
            dtype=dtype, device=dev)
    fs_t = torch.full((), actual_fs, dtype=dtype, device=dev)
    with sync("dio.boundaries"):
        boundaries = torch.as_tensor(boundaries_np, dtype=dtype, device=dev)
    cands, scores = _band_candidates(
        boundaries, y_spectrum, y_length, fs_t, fft_size,
        temporal_positions, f0_floor, f0_ceil)
    best = torch.gather(cands, 1, scores.argmin(1, keepdim=True))[:, 0]

    voice_range_minimum = int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1
    if f0_length <= voice_range_minimum:
        return temporal_positions, torch.zeros_like(best)
    with clock("dio.fix"):
        step1 = _fix_step1(best, voice_range_minimum, allowed_range)
        step2 = _fix_step2(step1, voice_range_minimum)
        return temporal_positions, dio_fix_walks(step2, cands,
                                                 allowed_range)


def dio(x, fs, option=None, device=None):
    """Dio F0 estimation of one utterance (reference
    src/dio.cpp:643-648).  Returns (temporal_positions, f0), each
    (f0_length,)."""
    option = option or config.DioOption()
    x = as_tensor(x, resolve_device(device))
    tp, f0 = dio_batch(x[None], fs, option.frame_period, option.f0_floor,
                       option.f0_ceil, option.channels_in_octave,
                       option.speed, option.allowed_range)
    return tp, f0[0]
