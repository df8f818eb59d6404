"""Harvest's float32 instantaneous-frequency refinement and the pruning
pass after it: csrc/refine.cu and the plain versions.

``harvest_refine(y (B, Ly), positions (F,), cands (B, F, M), fs_t,
f0_floor, f0_ceil, hw_max)``
    GetRefinedF0 (src/harvest.cpp:434-617) of every (frame, candidate)
    pair as the JAX package computes it in float32
    (world_tpu/models/harvest.py: _refine_frame_direct, :265-435, called
    from _refine_all's float32 branch, :487-594): only the <= 6 harmonic
    DFT bins, each a direct dot over a FRAME-centred window.  ``y`` is
    the decimated signal at rate ``fs_t`` (a Python float), ``positions``
    the frame times in seconds, ``cands`` the candidate F0s (<= 0: no
    candidate), ``hw_max`` the most window half-width a pair uses (JAX:
    int(1.5 fs / (f0_floor 0.9 0.9) + 1) + 1).  Returns (refined,
    scores), each (B, F, M), zero where ``cands <= 0`` or the pair fails
    the range and score test.

``remove_unreliable(cands (B, F, M), scores (B, F, M))``
    RemoveUnreliableCandidates (src/harvest.cpp:652-688; JAX:
    world_tpu/models/harvest.py: _remove_unreliable, :602-621), float32
    or float64: a nonzero candidate of an interior frame with no
    candidate of frame f - 1 or f + 1 within 5% (|a - b| / a, the limit
    in the tensors' type) is zeroed with its score.  Returns new
    (cands, scores); every frame's test sees the values before any was
    zeroed.

For a pair of frame position p and candidate f0, with c0 = round(p fs +
0.001), hw = int(1.5 fs / f0 + 1) and j = 0..min(hw, hw_max):
  the samples  y[clip(c0 - 1 +- j)];
  the window   Blackman at cos(a +- j d), a = 2 pi ((c0 - 1)/fs - p) /
               (win_len / fs), d = 2 pi / win_len, win_len = 2 hw + 1,
               taken as cos a cos(j d) -+ sin a sin(j d); and its
               one-sided difference, whose j = 0 neighbours cross the
               halves;
  the folds    x(j) +- x(-j) of window times samples, so that every dot
               runs over j >= 0 only;
  the dots     cos / sin(2 pi index_h j / fft) of the folds, index_h =
               round(h f0 fft / fs), fft = 2^(2 + floor(log2 win_len)),
               h = 1..6;
then each harmonic's instantaneous frequency and amplitude, their
weighted mean (refined) and the inverse mean deviation (score), in JAX's
order of operations.

What differs from the JAX package is the trigonometry, not the
formulation.  JAX grows cos / sin(d j) and cos / sin(omega j) by radix-16
angle addition (a TPU economy with ~1e-5 chain error); here every angle
is reduced exactly: cos / sin(j d) is taken in float64 of 2 pi (j /
win_len) and rounded once (for hw <= hw_max read from one table of
every window length, window_table), cos a / sin a are float64 cosines
of the float32 a rounded once, and the DFT's phase (index_h j) mod fft
indexes one table of cos / sin(2 pi k / 2^L) built in float64 and
rounded to float32 once per device (phase_table).  The kernel uses the
same tables and the same float64 angles, and the plain version sums in
the kernel's order (warp_sum over LANES lanes a pair; the harmonics one
after another), because a score whose active harmonic sits near a
spectral null moves by percents with the order of the dots' sums.

On a CUDA tensor each wrapper launches its kernel (always; there is no
fallback): a build or launch failure raises.  On a CPU tensor it runs
the plain version.  Neither the wrappers nor the kernels sync with the
host.
"""

import ctypes
import functools
import math

import numpy as np
import torch

from .. import config
from ..device import div, upload
from . import _cuda
from .matlab import matlab_round

N_HARMONICS = 6
# Most hw_max the kernel takes: its dynamic shared memory (the staged
# phase table and eight warps' frame samples and slot lists, 146 KB at
# 1200) stays below the 227 KB a block may hold.
MAX_HW = 1200
# Pairs a chunk of the plain version: its largest tensors are (pairs, 6,
# hw_max + 1), ~10 MB each at the default floor.
PLAIN_CHUNK = 2048


def fft_log2(win_len):
    """log2 of the pair's fft size, 2 + floor(log2(win_len)), from the
    int64 tensor ``win_len`` (odd, >= 3).  JAX takes exp2(2 +
    floor(log(win_len) / log 2)) in float32; for odd win_len >= 3 the
    quotient is at least 1e-3 above its floor, so the two agree."""
    return torch.frexp(win_len.to(torch.float64))[1].to(torch.int64) + 1


def table_log2(hw_max):
    """log2 of the phase table's length: the fft size of the widest
    window the kernel holds whole, win_len = 2 hw_max + 1."""
    return 2 + int(math.floor(math.log2(2 * hw_max + 1)))


@functools.lru_cache(maxsize=None)
def _host_table(log2):
    k = np.arange(1 << log2, dtype=np.float64)
    angle = k / float(1 << log2) * (2.0 * config.K_PI)
    return np.stack([np.cos(angle), np.sin(angle)]).astype(np.float32)


def _window_trig(j, win_len):
    """float32 cos / sin(2 pi j / win_len), taken in float64 of the
    fraction j / win_len and rounded once."""
    angle = j.to(torch.float64) / win_len.to(torch.float64) * (
        2.0 * config.K_PI)
    return torch.cos(angle).float(), torch.sin(angle).float()


def window_row(hw):
    """Row ``hw``'s first entry in the window table: the rows hw = 1, 2,
    ... hold j = 0..hw each, one after another."""
    return (hw - 1) * (hw + 2) // 2


@functools.lru_cache(maxsize=None)
def _host_window_table(hw_max):
    hw = torch.arange(1, hw_max + 1)
    lengths = hw + 1
    rows = torch.repeat_interleave(hw, lengths)
    j = torch.arange(int(lengths.sum())) - torch.repeat_interleave(
        window_row(hw), lengths)
    c, s = _window_trig(j, 2 * rows + 1)
    return torch.stack([c, s], 1).numpy()


@functools.lru_cache(maxsize=None)
def _device_table(what, device):
    """``what``: ("phase", log2) or ("kernel", hw_max), uploaded once a
    device."""
    kind, n = what
    if kind == "phase":
        host = _host_table(n)
    else:
        host = np.concatenate([_host_table(table_log2(n)).ravel(),
                               _host_window_table(n).ravel()])
    return upload(host, torch.float32, device)


def phase_table(log2, device):
    """(2, 2^log2) float32: cos and sin of 2 pi k / 2^log2, in float64
    rounded once; built once a device (the copy to a card through pinned
    memory, without a sync)."""
    return _device_table(("phase", log2), torch.device(device))


def window_table(hw_max, device):
    """(window_row(hw_max + 1), 2) float32: cos and sin of 2 pi j / (2 hw
    + 1) for hw = 1..hw_max and j = 0..hw (row hw from window_row(hw)),
    in float64 rounded once; built once a device."""
    return kernel_table(hw_max, device)[2 << table_log2(hw_max):].view(
        -1, 2)


def kernel_table(hw_max, device):
    """The kernel's ``table`` argument: phase_table(table_log2(hw_max))
    and then window_table(hw_max), one float32 buffer."""
    return _device_table(("kernel", hw_max), torch.device(device))


# Lanes a pair in the kernel (csrc/refine.cu: kLanes).
LANES = 4


def warp_sum(t, lanes=LANES):
    """Sum over the last axis (j) in the kernel's order: lane l of the
    pair's ``lanes`` adds the terms j = l, l + lanes, ... to 0 in turn,
    then the lanes' partials meet in an xor butterfly (l + (l ^ lanes /
    2), then ^ lanes / 4, ..., ^ 1)."""
    t = torch.nn.functional.pad(t, (0, -t.shape[-1] % lanes))
    t = t.unflatten(-1, (-1, lanes))
    acc = torch.zeros_like(t[..., 0, :])
    for i in range(t.shape[-2]):
        acc = acc + t[..., i, :]
    lane = torch.arange(lanes, device=t.device)
    off = lanes // 2
    while off:
        acc = acc + acc[..., lane ^ off]
        off //= 2
    return acc[..., 0]


def _blackman(c2):
    # cos(2a) = 2 cos^2(a) - 1, as JAX writes it.
    return 0.42 + 0.5 * c2 + 0.08 * (2.0 * c2 * c2 - 1.0)


def _refine_pairs(y, rows, c0, pos, f0, hw, fs, f0_floor, f0_ceil, hw_max,
                  table, log2_max, wtable):
    """The plain version on N pairs: y (B, Ly); rows, c0, hw (N,) int64;
    pos, f0 (N,) float32; fs a 0-dim float32 tensor.  Returns (refined,
    score), each (N,)."""
    dev, dtype = y.device, y.dtype
    zero = torch.zeros((), dtype=dtype, device=dev)
    j = torch.arange(hw_max + 1, device=dev)
    win_len = 2 * hw + 1
    wlt = win_len.to(dtype) / fs
    in_win = j <= hw[:, None]

    t0 = (c0 - 1).to(dtype) / fs - pos
    a = (2.0 * config.K_PI) * t0 / wlt
    ca = torch.cos(a.double()).float()[:, None]
    sa = torch.sin(a.double()).float()[:, None]
    # The window table's row for hw <= hw_max (as the kernel reads it),
    # float64 of the rest rounded once (as the kernel computes it).
    inside = (hw <= hw_max)[:, None]
    hw_in = hw.clamp(max=hw_max)[:, None]
    at = window_row(hw_in) + torch.minimum(j, hw_in)
    cosj, sinj = _window_trig(j, win_len[:, None])
    cosj = torch.where(inside, wtable[at, 0], cosj)
    sinj = torch.where(inside, wtable[at, 1], sinj)
    w_p = torch.where(in_win, _blackman(ca * cosj - sa * sinj), zero)
    w_m = torch.where(in_win, _blackman(ca * cosj + sa * sinj), zero)

    # The difference window -(w[j+1] - w[j-1]) / 2: zero w past hw gives
    # the one-sided edges; only the j = 0 neighbours cross the halves.
    z1 = torch.zeros_like(w_p[:, :1])
    nxt_p = torch.cat([w_p[:, 1:], z1], 1)
    prv_p = torch.cat([w_m[:, 1:2], w_p[:, :-1]], 1)
    dw_p = torch.where(in_win, -(nxt_p - prv_p) / 2.0, zero)
    nxt_m = torch.cat([w_p[:, 1:2], w_m[:, :-1]], 1)
    prv_m = torch.cat([w_m[:, 1:], z1], 1)
    dw_m = torch.where(in_win, -(nxt_m - prv_m) / 2.0, zero)

    last = y.shape[1] - 1
    seg_p = y[rows[:, None], (c0[:, None] - 1 + j).clamp(0, last)]
    seg_m = y[rows[:, None], (c0[:, None] - 1 - j).clamp(0, last)]
    minus = j > 0
    pm = seg_p * w_p
    mm = torch.where(minus, seg_m * w_m, zero)
    pd = seg_p * dw_p
    md = torch.where(minus, seg_m * dw_m, zero)
    xm_e, xm_o, xd_e, xd_o = pm + mm, pm - mm, pd + md, pd - md

    log2 = fft_log2(win_len)
    fft = (1 << log2)[:, None]
    fft_f = fft.to(dtype)
    n_harm = torch.clamp((fs / 2.0 / f0).to(torch.int64), max=N_HARMONICS)
    harm = torch.arange(1, N_HARMONICS + 1, dtype=dtype, device=dev)
    active = torch.arange(N_HARMONICS, device=dev) < n_harm[:, None]
    index = matlab_round(f0[:, None] * fft_f / fs * harm)
    index = torch.minimum(index.clamp(min=0), fft // 2)

    # (index j) mod fft, read at the table's scale 2^log2_max / fft.
    k = (index[:, :, None] * j) % fft[:, :, None]
    k = k << (log2_max - log2)[:, None, None]
    cos_t, sin_t = table[0][k], table[1][k]
    main_re = warp_sum(cos_t * xm_e[:, None])
    main_im = -warp_sum(sin_t * xm_o[:, None])
    diff_re = warp_sum(cos_t * xd_e[:, None])
    diff_im = -warp_sum(sin_t * xd_o[:, None])
    power = main_re * main_re + main_im * main_im
    numer = main_re * diff_im - main_im * diff_re

    inst = torch.where(power == 0.0, zero,
                       index.to(dtype) * fs / fft_f
                       + div(numer / power * fs, 2.0 * config.K_PI))
    amp = torch.where(active, torch.sqrt(power), zero)
    dev_h = torch.where(active, torch.abs((inst / harm - f0[:, None])
                                          / f0[:, None]), zero)
    num = den = dev_sum = torch.zeros_like(f0)
    for h in range(N_HARMONICS):
        num = num + amp[:, h] * inst[:, h] * active[:, h]
        den = den + amp[:, h] * harm[h]
        dev_sum = dev_sum + dev_h[:, h]
    refined = num / (den + config.K_MY_SAFE_GUARD_MINIMUM)
    score = 1.0 / (dev_sum / n_harm.clamp(min=1)
                   + config.K_MY_SAFE_GUARD_MINIMUM)
    ok = (refined >= f0_floor) & (refined <= f0_ceil) & (score >= 2.5)
    return torch.where(ok, refined, zero), torch.where(ok, score, zero)


def harvest_refine_plain(y, positions, cands, fs_t, f0_floor, f0_ceil,
                         hw_max):
    """The plain version: the usable pairs, PLAIN_CHUNK at a time, in
    tensor ops, the dots summed in the kernel's order (warp_sum)."""
    dev, dtype = y.device, y.dtype
    refined = torch.zeros_like(cands)
    scores = torch.zeros_like(cands)
    rows, frames, slots = (cands > 0.0).nonzero(as_tuple=True)
    if rows.numel() == 0:
        return refined, scores
    fs = torch.full((), fs_t, dtype=dtype, device=dev)
    c0 = matlab_round(positions * fs + 0.001)[frames]
    f0 = cands[rows, frames, slots]
    # Pairs below f0_floor 0.81 have windows past hw_max (cut there, as
    # JAX cuts them) and ffts past the table's; the table grows to them.
    hw = (1.5 * fs / f0 + 1.0).to(torch.int64)
    log2_max = max(table_log2(hw_max), int(fft_log2(2 * hw + 1).max()))
    table = phase_table(log2_max, dev)
    wtable = window_table(hw_max, dev)
    r_out, s_out = [], []
    for a in range(0, rows.numel(), PLAIN_CHUNK):
        s = slice(a, a + PLAIN_CHUNK)
        r, sc = _refine_pairs(y, rows[s], c0[s], positions[frames[s]],
                              f0[s], hw[s], fs, f0_floor, f0_ceil, hw_max,
                              table, log2_max, wtable)
        r_out.append(r)
        s_out.append(sc)
    refined[rows, frames, slots] = torch.cat(r_out)
    scores[rows, frames, slots] = torch.cat(s_out)
    return refined, scores


def _check(y, positions, cands, hw_max):
    """The wrapper's checks; True for CUDA tensors (the kernel), False for
    CPU ones (the plain version)."""
    for name, t in (("y", y), ("positions", positions), ("cands", cands)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != y.device:
            raise ValueError("inputs on different devices")
    if y.dim() != 2 or positions.dim() != 1 or cands.dim() != 3:
        raise ValueError(f"shapes: y {tuple(y.shape)}, positions "
                         f"{tuple(positions.shape)}, cands "
                         f"{tuple(cands.shape)} (want (B, Ly), (F,), "
                         f"(B, F, M))")
    B, F, _ = cands.shape
    if y.shape[0] != B or positions.shape[0] != F or y.shape[1] == 0:
        raise ValueError(f"shapes: y {tuple(y.shape)}, positions "
                         f"{tuple(positions.shape)}, cands "
                         f"{tuple(cands.shape)} disagree")
    if not isinstance(hw_max, int) or not 1 <= hw_max <= MAX_HW:
        raise ValueError(f"hw_max must be an int in 1..{MAX_HW}, got "
                         f"{hw_max!r}")
    if y.device.type == "cpu":
        return False
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    for name, t in (("y", y), ("positions", positions), ("cands", cands)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


def harvest_refine(y, positions, cands, fs_t, f0_floor, f0_ceil, hw_max):
    """Refined F0 and score of every (frame, candidate) pair of ``cands``
    (B, F, M).  Returns (refined, scores), each (B, F, M)."""
    if not _check(y, positions, cands, hw_max):
        return harvest_refine_plain(y, positions, cands, fs_t, f0_floor,
                                    f0_ceil, hw_max)
    refined = torch.empty_like(cands)
    scores = torch.empty_like(cands)
    if cands.numel() == 0:
        return refined, scores
    entry = _cuda.entry("refine", "harvest_refine",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
                        + (ctypes.c_float,) * 3 + (ctypes.c_void_p,))
    table = kernel_table(hw_max, y.device)
    B, F, M = cands.shape
    _cuda.launch("harvest_refine", entry, y.device, y.data_ptr(),
                 positions.data_ptr(), cands.data_ptr(), table.data_ptr(),
                 refined.data_ptr(), scores.data_ptr(), B, y.shape[1], F, M,
                 hw_max, table_log2(hw_max), float(fs_t), float(f0_floor),
                 float(f0_ceil))
    harvest_refine.launches += 1
    return refined, scores


harvest_refine.launches = 0      # kernel launches (CUDA path only)


def remove_unreliable_plain(cands, scores):
    """The plain version: zero candidates with no close neighbour in the
    adjacent frames (src/harvest.cpp:652-688), over (B, F, M, M)
    distance tensors."""
    nxt = torch.cat([cands[:, 1:], cands[:, -1:]], 1)
    prv = torch.cat([cands[:, :1], cands[:, :-1]], 1)

    def min_err(a, b):
        # min over b's candidates of |a - b_j| / a, capped at 1.0
        e = torch.abs(a[..., :, None] - b[..., None, :]) / a[..., :, None]
        return torch.clamp(e.amin(-1), max=1.0)

    bad = torch.minimum(min_err(cands, nxt), min_err(cands, prv)) > 0.05
    j = torch.arange(cands.shape[1], device=cands.device)
    interior = ((j > 0) & (j < cands.shape[1] - 1))[None, :, None]
    kill = bad & interior & (cands != 0.0)
    return (torch.where(kill, torch.zeros_like(cands), cands),
            torch.where(kill, torch.zeros_like(scores), scores))


def remove_unreliable(cands, scores):
    """``cands`` and ``scores`` (B, F, M), float32 or float64, with the
    unreliable candidates and their scores zeroed.  Returns new tensors
    (cands, scores)."""
    if cands.dtype not in (torch.float32, torch.float64) or \
            scores.dtype != cands.dtype:
        raise TypeError(f"cands and scores must be one of float32 and "
                        f"float64, got {cands.dtype} and {scores.dtype}")
    if cands.dim() != 3 or scores.shape != cands.shape:
        raise ValueError(f"shapes: cands {tuple(cands.shape)}, scores "
                         f"{tuple(scores.shape)} (want two equal (B, F, M))")
    if scores.device != cands.device:
        raise ValueError("inputs on different devices")
    if cands.device.type == "cpu":
        return remove_unreliable_plain(cands, scores)
    if cands.device.type != "cuda":
        raise ValueError(f"unsupported device {cands.device}")
    if not (cands.is_contiguous() and scores.is_contiguous()):
        raise ValueError("cands and scores must be contiguous")
    out_c = torch.empty_like(cands)
    out_s = torch.empty_like(scores)
    if cands.numel() == 0:
        return out_c, out_s
    entry = _cuda.entry("refine", "harvest_remove_unreliable",
                        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
                        + (ctypes.c_void_p,))
    B, F, M = cands.shape
    _cuda.launch("harvest_remove_unreliable", entry, cands.device,
                 cands.data_ptr(), scores.data_ptr(), out_c.data_ptr(),
                 out_s.data_ptr(), B, F, M, cands.element_size())
    remove_unreliable.launches += 1
    return out_c, out_s


remove_unreliable.launches = 0   # kernel launches (CUDA path only)


def remove_threshold_plain(a):
    """The plain version of remove_threshold, in torch ops."""
    limit = torch.tensor(0.05, dtype=a.dtype, device=a.device)
    inf = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    t = limit * a
    over = t / a > limit
    t = torch.where(over, torch.nextafter(t, torch.zeros_like(t)), t)
    up = torch.nextafter(t, inf)
    t = torch.where(~over & ~(up / a > limit), up, t)
    return torch.where((a > 0) & (a < inf), t, inf)


def remove_threshold(a):
    """The reliability pass's threshold t(a) (csrc/refine.cu:
    remove_threshold) of each element of ``a`` (float32 or float64, 1-D),
    for the tests: !(d > t(a)) exactly when !(d / a > 0.05), the quotient
    and 0.05 in a's type.  For a finite a > 0, fl(0.05 a) moved by at most
    one unit in the last place, checked by the division; +inf for a < 0,
    +inf or NaN.  On a CUDA tensor the kernel's own device function, on a
    CPU one its plain version."""
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"a must be float32 or float64, got {a.dtype}")
    if a.dim() != 1 or a.numel() >= 2 ** 31:
        raise ValueError(f"a must be 1-D, below 2^31 elements, got "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return remove_threshold_plain(a)
    if a.device.type != "cuda" or not a.is_contiguous():
        raise ValueError("a must be a contiguous CUDA or CPU tensor")
    t = torch.empty_like(a)
    if a.numel() == 0:
        return t
    entry = _cuda.entry("refine", "harvest_remove_threshold",
                        (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2
                        + (ctypes.c_void_p,))
    _cuda.launch("harvest_remove_threshold", entry, a.device, a.data_ptr(),
                 t.data_ptr(), a.numel(), a.element_size())
    remove_threshold.launches += 1
    return t


remove_threshold.launches = 0    # kernel launches (CUDA path only)
