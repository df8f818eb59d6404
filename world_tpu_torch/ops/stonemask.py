"""StoneMask's float32 refinement: csrc/stonemask.cu and its plain version.

``stonemask_refine(x (B, L), positions (B, F), f0 (B, F), fs_t, max_len)``
    StoneMask (src/stonemask.cpp:170-218) of every frame as the JAX
    package computes it in float32 (world_tpu/models/stonemask.py:
    _stone_mask_impl's float32 branch, :193-211, running _refine_direct,
    :110-168, on one contiguous window a frame).  ``x`` holds the rows'
    signals at rate ``fs_t`` (a Python float), ``positions`` the frame
    times in seconds, ``f0`` the F0 track to refine; ``max_len`` is the
    window buffer JAX sizes by the fft sizes (max(sizes) // 2), at least
    the longest window of a usable frame (window_bound); the kernel
    sizes nothing by it and writes NaN for a longer window.  Returns the
    refined F0 (B, F): 0 where the frame is not usable (f0 <= 40 or
    f0 > fs / 12, or NaN), the input F0 where the refinement moved it by
    more than 20% or its first pass failed.

For a usable frame of position p and F0 f0, in float32 as JAX computes
it (every product and quotient rounded on its own, IEEE division):
  hw = int(1.5 fs / f0 + 1), win_len = 2 hw + 1, wlt = win_len / fs;
  idx0 = matlab_round((p - hw / fs) fs);
  the samples   seg[i] = x[clip(idx0 - 1 + i, 0, L - 1)], i < win_len;
  the window    w[i] = 0.42 + 0.5 cos(2 pi tmp / wlt) + 0.08 cos(4 pi tmp
                / wlt), tmp = ((idx0 + i) - 1) / fs - p, 2 pi and 4 pi the
                float32 constants; and its centred difference
                d[i] = -(w[i + 1] - w[i - 1]) / 2, w zero outside the
                window (so halved at both edges);
  the bins      fft = exp2(e), e = 2 + floor(log2 win_len), index_h =
                clamp(matlab_round(f fft / fs h), 0, int(fft / 2)),
                omega_h = (2 pi / fft) index_h;
  the dots      cos / sin(omega_h i) against seg w and seg d;
then each bin's instantaneous frequency and amplitude and their weighted
mean, in JAX's order: first at f = f0 with 2 bins (t0), then, unless t0
<= 0 or t0 > 2 f0, at f = t0 with 6 bins.

The transcendentals: each cos / sin takes its float32 argument, is
evaluated in float64 and rounded to float32 once (the plain version by
torch's cos / sin, the kernel by its own branch-free Cody-Waite reduction
and fdlibm polynomials, csrc/stonemask.cu: sincos_once; the two part only
where a float64 value lies within its error of a float32 rounding
boundary).  JAX rounds the same float32 arguments (the phases of a frame's
samples stay below ~240 rad) and takes float32 cos / sin of them, which
land within an ulp of these.  exp2 is JAX's
own lowering, exp(ln 2 e) with ln 2 e a float32 product, its exp taken
so too: that is not the power of two everywhere (2^13 comes out 4 ulps
above 8192, 2^15 8 below 32768), and taking 2^e instead moves the
refined F0 of frames with an 8192-point fft (below ~70 Hz at 44.1 and 48
kHz) by up to 2e-4 relative from JAX's.

Each dot is summed in the kernel's order: lane l of a warp's 32 adds the
terms i = l, l + 32, ... in turn, then the lanes meet in an xor
butterfly (refine.warp_sum(t, LANES)).  The plain version sums so too, so
that the kernel and the plain version agree on the card (0 frames differ
on every recorded and seeded input, tests/test_torch_cuda.py).

On a CUDA tensor the wrapper launches the kernel (always; there is no
fallback): a build or launch failure raises.  On a CPU tensor it runs
the plain version.  Neither the wrapper nor the kernel syncs with the
host.
"""

import ctypes
import math

import torch

from .. import config
from ..device import div
from . import _cuda
from .matlab import matlab_round
from .refine import warp_sum

LANES = 32                       # lanes a frame (csrc/stonemask.cu: a warp)
# Most max_len the kernel takes: it takes a window's sample index as a
# float32, exact below 2^24 (csrc/stonemask.cu: kMaxLen).
MAX_LEN = 1 << 24
# The plain version's frames a chunk: its largest tensors are (frames, 6,
# window), ~6 MB each at 48 kHz.
PLAIN_CHUNK = 256
TWO_PI = 2.0 * config.K_PI      # rounded to float32 where it meets one
FOUR_PI = 4.0 * config.K_PI
LN2 = math.log(2.0)


def window_bound(fs_t):
    """Samples of the longest window a usable frame (f0 > 40 Hz) takes at
    rate ``fs_t``: 2 int(1.5 fs / 40 + 1) + 1, the float64 figure JAX
    sizes max_len by (its float32 half-width, from the least float32
    above 40, is not larger at any integer rate up to 400 kHz)."""
    return 2 * int(1.5 * fs_t / config.K_FLOOR_F0_STONEMASK + 1.0) + 1


def fft_size(win_len):
    """The frame's fft size from the int64 tensor ``win_len`` (odd, >= 3)
    as JAX's float32 exp2 gives it: e = 2 + floor(log2(win_len)) (JAX
    takes log(win_len) / log 2 in float32, at least 1e-3 above its floor
    for odd win_len), then exp(ln 2 e), ln 2 e rounded to float32 and its
    exp evaluated in float64 and rounded once."""
    e = torch.frexp(win_len.to(torch.float64))[1] + 1
    arg = LN2 * e.to(torch.float32)
    return torch.exp(arg.double()).float()


def _cos_sin(arg):
    """float32 cos and sin of the float32 ``arg``, each evaluated in
    float64 and rounded once."""
    a = arg.double()
    return torch.cos(a).float(), torch.sin(a).float()


def _fix_f0(xm, xd, f, fft_f, fs, n_harmonics):
    """One FixF0 pass (src/stonemask.cpp:96-118) over N frames: xm, xd
    (N, n) the windowed samples, f and fft_f (N,).  Returns (N,)."""
    dev, dtype = xm.device, xm.dtype
    zero = torch.zeros((), dtype=dtype, device=dev)
    harm = torch.arange(1, n_harmonics + 1, dtype=dtype, device=dev)
    half = (fft_f / 2.0).to(torch.int64)[:, None]
    index = matlab_round(f[:, None] * fft_f[:, None] / fs * harm)
    index = torch.minimum(index, half).clamp(min=0)
    two_pi = torch.full((), TWO_PI, dtype=dtype, device=dev)
    omega = (two_pi / fft_f)[:, None] * index.to(dtype)
    i = torch.arange(xm.shape[1], device=dev).to(dtype)
    c, s = _cos_sin(omega[:, :, None] * i)
    m_re = warp_sum(c * xm[:, None], LANES)
    m_im = -warp_sum(s * xm[:, None], LANES)
    d_re = warp_sum(c * xd[:, None], LANES)
    d_im = -warp_sum(s * xd[:, None], LANES)
    ps = m_re * m_re + m_im * m_im
    numer = m_re * d_im - m_im * d_re
    inst = torch.where(ps == 0.0, zero,
                       index.to(dtype) * fs / fft_f[:, None]
                       + div(numer / ps * fs, TWO_PI))
    amp = torch.sqrt(ps)
    num = den = torch.zeros_like(f)
    for h in range(n_harmonics):
        num = num + amp[:, h] * inst[:, h]
        den = den + amp[:, h] * harm[h]
    return num / (den + config.K_MY_SAFE_GUARD_MINIMUM)


def windowed(x, rows, pos, f0, fs):
    """The windowed samples of N usable frames: x (B, L); rows (N,)
    int64; pos, f0 (N,) float32; fs a 0-dim float32 tensor.  Returns (xm,
    xd) (N, n), the samples times the window and times its difference,
    zero past each frame's window (n: the longest window, rounded up to
    the lanes), and the frames' fft sizes (N,)."""
    dev, dtype = x.device, x.dtype
    zero = torch.zeros((), dtype=dtype, device=dev)
    hw = (1.5 * fs / f0 + 1.0).to(torch.int64)
    win_len = 2 * hw + 1
    wlt = win_len.to(dtype) / fs
    idx0 = matlab_round((pos - hw.to(dtype) / fs) * fs)
    n = -(-int(win_len.max()) // LANES) * LANES
    i = torch.arange(n, device=dev)
    in_win = i < win_len[:, None]
    tmp = ((idx0[:, None] + i).to(dtype) - 1.0) / fs - pos[:, None]
    c1, _ = _cos_sin(TWO_PI * tmp / wlt[:, None])
    c2, _ = _cos_sin(FOUR_PI * tmp / wlt[:, None])
    w = torch.where(in_win, 0.42 + 0.5 * c1 + 0.08 * c2, zero)
    # Zero past both ends: the edge terms -nxt / 2 and prv / 2.
    z1 = torch.zeros_like(w[:, :1])
    nxt = torch.cat([w[:, 1:], z1], 1)
    prv = torch.cat([z1, w[:, :-1]], 1)
    d = torch.where(in_win, -(nxt - prv) / 2.0, zero)
    last = x.shape[1] - 1
    seg = x[rows[:, None], (idx0[:, None] - 1 + i).clamp(0, last)]
    seg = torch.where(in_win, seg, zero)
    return seg * w, seg * d, fft_size(win_len)


def refine_frames(x, rows, pos, f0, fs):
    """The plain version on N usable frames (arguments as ``windowed``).
    Returns (StoneMask's value, whether the first pass failed), each
    (N,)."""
    xm, xd, fft_f = windowed(x, rows, pos, f0, fs)
    t0 = _fix_f0(xm, xd, f0, fft_f, fs, 2)
    bad = (t0 <= 0.0) | (t0 > f0 * 2.0)
    t1 = _fix_f0(xm, xd, t0, fft_f, fs, 6)
    refined = torch.where(bad, torch.zeros_like(t1), t1)
    # Keep the input where the correction is over-large
    # (src/stonemask.cpp:185-208).
    over = torch.abs(refined - f0) > f0 * 0.2
    return torch.where(over, f0, refined), bad


def usable_frames(f0, fs):
    """StoneMask's usable frames: 40 < f0 <= fs / 12 (IEEE division)."""
    return (f0 > config.K_FLOOR_F0_STONEMASK) & (f0 <= div(fs, 12.0))


def stonemask_refine_plain(x, positions, f0, fs_t, max_len):
    """The plain version: the usable frames, PLAIN_CHUNK at a time, in
    tensor ops, the dots summed in the kernel's order."""
    dev, dtype = x.device, x.dtype
    out = torch.zeros_like(f0)
    fs = torch.full((), fs_t, dtype=dtype, device=dev)
    rows, frames = usable_frames(f0, fs).nonzero(as_tuple=True)
    parts = []
    for a in range(0, rows.numel(), PLAIN_CHUNK):
        r, fr = rows[a:a + PLAIN_CHUNK], frames[a:a + PLAIN_CHUNK]
        parts.append(refine_frames(x, r, positions[r, fr], f0[r, fr],
                                   fs)[0])
    if parts:
        out[rows, frames] = torch.cat(parts)
    return out


def _check(x, positions, f0, fs_t, max_len):
    """The wrapper's checks; True for CUDA tensors (the kernel), False for
    CPU ones (the plain version)."""
    for name, t in (("x", x), ("positions", positions), ("f0", f0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("inputs on different devices")
    if x.dim() != 2 or positions.shape != f0.shape or f0.dim() != 2 \
            or f0.shape[0] != x.shape[0] or x.shape[1] == 0:
        raise ValueError(f"shapes: x {tuple(x.shape)}, positions "
                         f"{tuple(positions.shape)}, f0 {tuple(f0.shape)} "
                         f"(want (B, L), (B, F), (B, F))")
    if not (isinstance(fs_t, (int, float)) and math.isfinite(fs_t)
            and fs_t > 0):
        raise ValueError(f"fs_t must be a positive number, got {fs_t!r}")
    least = window_bound(fs_t)
    if not isinstance(max_len, int) or not least <= max_len <= MAX_LEN:
        raise ValueError(f"max_len must be an int in {least}..{MAX_LEN} at "
                         f"fs {fs_t}, got {max_len!r}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("positions", positions), ("f0", f0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


def stonemask_refine(x, positions, f0, fs_t, max_len):
    """StoneMask's refined F0 of every frame of ``f0`` (B, F).  Returns
    (B, F)."""
    if not _check(x, positions, f0, fs_t, max_len):
        return stonemask_refine_plain(x, positions, f0, fs_t, max_len)
    out = torch.empty_like(f0)
    if f0.numel() == 0:
        return out
    entry = _cuda.entry("stonemask", "stonemask_refine",
                        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
                        + (ctypes.c_float, ctypes.c_void_p))
    B, F = f0.shape
    _cuda.launch("stonemask_refine", entry, x.device, x.data_ptr(),
                 positions.data_ptr(), f0.data_ptr(), out.data_ptr(), B,
                 x.shape[1], F, max_len, float(fs_t))
    stonemask_refine.launches += 1
    return out


stonemask_refine.launches = 0    # kernel launches (CUDA path only)
