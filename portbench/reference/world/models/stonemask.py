"""StoneMask F0 refinement (reference src/stonemask.cpp), batched over
utterances, in the JAX package's two formulations.

float32 (world_tpu/models/stonemask.py: _stone_mask_impl's float32
branch): each frame's 2, then 6 harmonic bins as direct DFTs of one
contiguous, edge-clamped window, all frames in one call of
ops/stonemask.stonemask_refine (one kernel launch on the card, no host
sync).

float64 (the golden path): each voiced frame's window takes its sample
indices from a per-sample matlab_round and its FFT size from its own F0,
2^(2+floor(log2(2*half_window+1))); frames are grouped by that size and
each group runs as one batched rfft over its frames only (_refine).
"""

import math

import torch

from .. import config
from ..device import as_tensor, div, resolve_device
from ..ops.matlab import matlab_round
from ..ops.stonemask import stonemask_refine

# (frames x fft_size) elements per refine chunk.
_REFINE_ELEMENTS_CUDA = 1 << 24
_REFINE_ELEMENTS_CPU = 1 << 21


def _fft_sizes(fs):
    """Every fft size reachable for f0 in (kFloorF0StoneMask, fs/12]."""
    hw_min = int(1.5 * fs / (fs / 12.0) + 1.0)
    hw_max = int(1.5 * fs / config.K_FLOOR_F0_STONEMASK + 1.0)
    lo, hi = (2 ** (2 + int(math.log(hw * 2.0 + 1.0) / config.K_LOG2))
              for hw in (hw_min, hw_max))
    sizes, s = [], lo
    while s <= hi:
        sizes.append(s)
        s *= 2
    return sizes


def max_len(fs):
    """The float32 path's window bound, JAX's window buffer max(sizes) //
    2: at least the longest window of a usable frame (the kernel writes
    NaN for a longer one)."""
    return max(_fft_sizes(fs)) // 2


def _fix_f0(power, numerator, fft_size, fs_t, f0, n_harmonics):
    """Amplitude-weighted instantaneous-frequency average
    (src/stonemask.cpp:96-118).  power/numerator (N, fft_size//2+1);
    f0 (N,).  Returns (N,)."""
    dtype = power.dtype
    half = power.shape[-1] - 1
    harm = torch.arange(1, n_harmonics + 1, dtype=dtype, device=power.device)
    # Clamped below too: a rejected first pass can be <= 0 (its second
    # pass is discarded by the caller).
    index = matlab_round(f0[:, None] * fft_size / fs_t * harm).clamp(0, half)
    ps = torch.gather(power, -1, index)
    inst = torch.where(
        ps == 0.0, torch.zeros((), dtype=dtype, device=power.device),
        index.to(dtype) * fs_t / fft_size
        + div(torch.gather(numerator, -1, index) / ps * fs_t,
              2.0 * config.K_PI))
    amp = torch.sqrt(ps)
    return (amp * inst).sum(-1) / ((amp * harm).sum(-1)
                                   + config.K_MY_SAFE_GUARD_MINIMUM)


def _refine(x, rows, fs_t, fft_size, positions, f0):
    """GetRefinedF0 (src/stonemask.cpp:24-91,120-150) of N float64 frames
    at one fft size, in the reference's formulation: each sample's index
    rounded on its own, a full rfft.  x (B, L); rows/positions/f0 (N,).
    Returns (N,)."""
    dtype, dev = x.dtype, x.device
    f64 = torch.float64
    L = x.shape[1]
    half_window = (1.5 * fs_t / f0 + 1.0).to(torch.int64)
    fs64 = fs_t.to(f64)
    pos = positions.to(f64)[:, None]
    zero = torch.zeros((), dtype=f64, device=dev)
    win_len = (2 * half_window + 1)[:, None]
    wlt = win_len.to(f64) / fs64
    i = torch.arange(fft_size, device=dev)
    in_win = i < win_len
    base_time = (i - half_window[:, None]).to(f64) / fs64
    index_raw = matlab_round((pos + base_time) * fs64)
    tmp = (index_raw.to(f64) - 1.0) / fs64 - pos
    main_window = (0.42 + 0.5 * torch.cos(2.0 * config.K_PI * tmp / wlt)
                   + 0.08 * torch.cos(4.0 * config.K_PI * tmp / wlt))
    main_window = torch.where(in_win, main_window, zero)
    # centered difference, halves at the edges (src/stonemask.cpp:49-55)
    nxt = torch.roll(main_window, -1, -1)
    prv = torch.roll(main_window, 1, -1)
    diff_window = -(nxt - prv) / 2.0
    diff_window = torch.where(i == 0, -nxt / 2.0, diff_window)
    diff_window = torch.where(i == win_len - 1, prv / 2.0, diff_window)
    diff_window = torch.where(in_win, diff_window, zero)

    # The reference rounds each sample's index on its own, so indices can
    # step off the contiguous ramp at .5 boundaries: gather them.
    src = (index_raw - 1).clamp(0, L - 1) + (rows * L)[:, None]
    seg = torch.where(in_win, x.reshape(-1)[src].to(f64), zero)
    main_spec = torch.fft.rfft((seg * main_window).to(dtype))
    diff_spec = torch.fft.rfft((seg * diff_window).to(dtype))
    power = main_spec.real ** 2 + main_spec.imag ** 2
    numerator = (main_spec.real * diff_spec.imag
                 - main_spec.imag * diff_spec.real)

    t0 = _fix_f0(power, numerator, fft_size, fs_t, f0, 2)
    bad = (t0 <= 0.0) | (t0 > f0 * 2.0)
    t1 = _fix_f0(power, numerator, fft_size, fs_t, t0, 6)
    return torch.where(bad, torch.zeros_like(t1), t1)


def stone_mask_batch(x, fs, temporal_positions, f0):
    """StoneMask over B utterances (reference src/stonemask.cpp:
    170-218): x (B, L); temporal_positions (F,) or (B, F); f0 (B, F).
    Returns the refined f0 (B, F)."""
    dtype, dev = x.dtype, x.device
    tp = temporal_positions.expand_as(f0)
    if dtype == torch.float32:
        return stonemask_refine(x.contiguous(), tp.contiguous(),
                                f0.contiguous(), float(fs), max_len(fs))
    fs_t = torch.full((), float(fs), dtype=dtype, device=dev)
    usable = (f0 > config.K_FLOOR_F0_STONEMASK) & (f0 <= div(fs_t, 12.0))
    rows, frames = usable.nonzero(as_tuple=True)
    f0_u = f0[rows, frames]
    pos = tp[rows, frames]
    # The frame's fft-size exponent in float64, as the reference's
    # double math (the half window as _refine computes it).
    hw = (1.5 * fs_t / f0_u + 1.0).to(torch.int64)
    frame_fft = 2 ** (2 + torch.floor(
        torch.log(hw.to(torch.float64) * 2.0 + 1.0)
        / config.K_LOG2).to(torch.int64))
    refined = torch.zeros_like(f0_u)
    budget = (_REFINE_ELEMENTS_CUDA if dev.type == "cuda"
              else _REFINE_ELEMENTS_CPU)
    for fft_size in _fft_sizes(fs):
        sel = (frame_fft == fft_size).nonzero(as_tuple=True)[0]
        chunk = max(1, budget // fft_size)
        for a in range(0, sel.shape[0], chunk):
            p = sel[a:a + chunk]
            refined[p] = _refine(x, rows[p], fs_t, fft_size, pos[p], f0_u[p])
    # Keep the input where the correction is over-large
    # (src/stonemask.cpp:185-208); unusable frames give 0.
    refined = torch.where(torch.abs(refined - f0_u) > f0_u * 0.2, f0_u,
                          refined)
    out = torch.zeros_like(f0)
    out[rows, frames] = refined
    return out


def stone_mask(x, fs, temporal_positions, f0, device=None):
    """Refine an F0 contour of one utterance by instantaneous frequency
    (reference src/stonemask.cpp:212-218).  Returns (f0_length,)."""
    x = as_tensor(x, resolve_device(device))
    tp = as_tensor(temporal_positions, x.device, x.dtype)
    f0 = as_tensor(f0, x.device, x.dtype)
    return stone_mask_batch(x[None], fs, tp, f0[None])[0]
