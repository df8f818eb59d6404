"""WORLD's real-time synthesis of one utterance fed one frame a call, in
plain numpy and PyTorch: the samples that ``Synthesis2``
(src/synthesisrealtime.cpp) delivers, ``buffer_size`` at a time, when
``AddParameters`` takes one frame at a time and the caller drains every
buffer after each push (test/test.cpp:300-339).

For each frame, as AddParameters does (src/synthesisrealtime.cpp:
480-519): the chunk's time base (GetTimeBase, :341-378), its coarse axis
starting from the previous chunk's last F0 (``handoff_f0``), and its
pulse locations (GetPulseLocationsForTimeBase, :298-339), the phase
summed on from the previous chunk's (``handoff_phase``), one rounding a
step as the C++ running sum; each pulse's V/UV from its chunk
(GetCurrentVUV, :230-241).  Synthesis2 delivers window k while
``buffer_size * (k + 1)`` is below the last pulse's location
(CheckSynthesizer, :415-426), and window k consumes the pulses whose
location lies in it.  Each consumed pulse's response (GetOneFrameSegment,
:246-281, the real-time flavour: the envelope and the safe aperiodicity
interpolated linearly between the two frames around the pulse, no
fractional shift, the safe-guard epsilon inside the voiced aperiodic log,
DC removed from the second half only, :428-440) takes the noise up to
the next pulse, is zeroed below the start of the window that consumes it
(the ring add of Synthesis2, :577-600, never reaches below the buffer's
index 0) and is added at its location.

Departures from synthesisrealtime.cpp:

- no ring buffer, lookahead, response cache or kernel: every frame is
  known, so the pulses of all the frames are walked first and the
  responses are rendered in blocks of pulses and added with
  ``index_add_``; the ring's capacity never binds when every buffer is
  drained after each push;
- the noise.  ``rng_mode="exact"`` reads WORLD's own random sequence
  (``ops.rng.randn_blocks_at``: the xorshift128 draws of
  src/matlabfunctions.cpp, at the stream position that the consumed
  noise lengths before the pulse give, reseeded at the stream's start).
  ``rng_mode="fast"`` is a noise that WORLD does not have, the program's
  own: normals that are a pure function of (seed 3, the pulse's 1-based
  index in the stream), a PCG hash (Jarzynski and Olano, "Hash Functions
  for GPU Rendering", 2020) and Box-Muller, written here again in
  float64;
- the SeekSynthesizer call at the end of Synthesis2 passes samples where
  seconds are expected and matches no frame (:601): nothing here;
- the arithmetic is float64, as the C++'s double; ``dtype`` float32 is
  for the control, which renders in float32 from frames rounded by the
  caller.

It imports nothing of world_tpu_torch, of the JAX package or of JAX.
"""

import math

import numpy as np
import torch

from .world import config
from .world.ops import fftpack
from .world.ops import rng as ref_rng
from .world.ops.common import minimum_phase_spectrum
from .world.ops.matlab import fftshift

FAST_SEED = 3
_MASK = 0xFFFFFFFF
# Pulses rendered at once.
BLOCK = 2048


def dc_remover(fft_size):
    """GetDCRemover(fft_size / 2) (src/synthesisrealtime.cpp:428-440),
    summed in the C++'s order, behind a zero first half: (fft_size,)."""
    n = fft_size // 2
    w = np.zeros(n)
    total = 0.0
    for i in range(n // 2):
        w[i] = 0.5 - 0.5 * math.cos(2.0 * config.K_PI * (i + 1.0)
                                    / (1.0 + n))
        w[n - i - 1] = w[i]
        total += w[i] * 2.0
    w /= total
    return np.concatenate([np.zeros(n), w])


def pulses(f0, fs, frame_period):
    """The pulses of ``f0`` pushed one frame a chunk: (locations int64
    (P,) ascending, V/UV float64 (P,)).  ``frame_period`` in ms."""
    fp = frame_period / 1000.0
    two_pi = 2.0 * config.K_PI
    f0 = np.asarray(f0, np.float64)
    handoff_f0, handoff_phase = 0.0, 0.0
    locs, vuvs = [], []
    for k in range(len(f0)):
        if k == 0:
            # cumulative_frame < 1: no time base yet (:503-508).
            handoff_f0 = f0[0]
            continue
        start = max(0, int(math.ceil((k - 1) * fp * fs)))
        n = int(math.ceil(k * fp * fs)) - start
        t0, t1 = (k - 1) * fp, (k - 1 + 1) * fp
        time_axis = (np.arange(n) + start) / fs
        s = (time_axis - t0) / (t1 - t0)
        if0 = handoff_f0 + s * (f0[k] - handoff_f0)
        v0, v1 = float(handoff_f0 != 0.0), float(f0[k] != 0.0)
        ivuv = np.where(v0 + s * (v1 - v0) > 0.5, 1.0, 0.0)
        if0 = np.where(ivuv == 0.0, config.K_DEFAULT_F0, if0)
        total = np.empty(n + 1)
        total[0] = handoff_phase
        total[1:] = two_pi * if0 / fs
        total = np.cumsum(total)          # sequential, as the C++'s sum
        handoff_phase = total[n]
        wrap = np.fmod(total, two_pi)
        at = np.flatnonzero(np.abs(np.diff(wrap)) > config.K_PI)
        loc = np.floor((time_axis[at] - 1.0 / fs) * fs + 0.5)
        loc = loc.astype(np.int64)
        vuv_store = np.append(ivuv, ivuv[-1])
        locs.append(loc)
        vuvs.append(vuv_store[loc - start + 1])
        handoff_f0 = f0[k]
    if not locs:
        return np.zeros(0, np.int64), np.zeros(0)
    return np.concatenate(locs), np.concatenate(vuvs)


def buffers(last_location, buffer_size):
    """How many buffers Synthesis2 delivers when the last pulse is at
    ``last_location``."""
    return max(0, -(-(last_location - buffer_size) // buffer_size))


def hash32(x):
    """PCG output hash of uint32 values held in int64 arrays."""
    state = (x * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return ((word >> 22) ^ word) & _MASK


def fast_noise(refs, n):
    """The fast mode's ``n`` normals of each pulse index in ``refs``
    (int64 (P,)): float64 (P, n), cosines of the pairs first, then
    sines."""
    key = hash32((refs & _MASK) ^ hash32(np.int64(FAST_SEED)))
    j = np.arange((n + 1) // 2, dtype=np.int64)
    u1 = (hash32(key[:, None] ^ (2 * j)).astype(np.float64) + 0.5) \
        / 2.0 ** 32
    u2 = hash32(key[:, None] ^ (2 * j + 1)).astype(np.float64) / 2.0 ** 32
    r = np.sqrt(-2.0 * np.log(u1))
    theta = (2.0 * math.pi) * u2
    return np.concatenate([r * np.cos(theta), r * np.sin(theta)], 1)[:, :n]


def responses(env, ap, vuv, noise, noise_size, dc, fft_size):
    """The real-time flavour's responses of a block of pulses: env, ap
    (B, fft/2 + 1) interpolated, ap squared; vuv, noise_size (B,); noise
    (B, fft); dc (fft,).  Returns (B, fft)."""
    half = fft_size // 2
    i = torch.arange(fft_size, device=env.device)
    logspec = torch.log(env * (1.0 - ap) + config.K_MY_SAFE_GUARD_MINIMUM) \
        / 2.0
    periodic = fftshift(fftpack.irfft_unnormalized(
        minimum_phase_spectrum(logspec, fft_size), fft_size))
    dc_part = periodic[:, half:].sum(-1, keepdim=True)
    periodic = torch.where(i >= half, periodic, 0.0) - dc_part * dc
    silent = (vuv <= 0.5) | (ap[:, 0] > 0.999)
    periodic = torch.where(silent[:, None], 0.0, periodic)

    inside = i < noise_size[:, None]
    noise = torch.where(inside, noise, 0.0)
    mean = noise.sum(-1, keepdim=True) / noise_size[:, None]
    noise = torch.where(inside, noise - mean, 0.0)
    voiced_log = torch.log(env * ap + config.K_MY_SAFE_GUARD_MINIMUM) / 2.0
    ap_log = torch.where((vuv != 0.0)[:, None], voiced_log,
                         torch.log(env) / 2.0)
    aperiodic = fftshift(fftpack.irfft_unnormalized(
        minimum_phase_spectrum(ap_log, fft_size)
        * torch.fft.rfft(noise), fft_size))
    return (periodic * torch.sqrt(noise_size.to(env.dtype))[:, None]
            + aperiodic) / fft_size


def stream(f0, sp, ap, fs, frame_period, fft_size, buffer_size,
           rng_mode="fast", dtype=torch.float64, device="cpu"):
    """What Synthesis2 delivers for the frames f0 (F,), sp and ap (F,
    fft/2 + 1) pushed one at a time: (samples (buffer_size * n,) numpy
    float64, n buffers)."""
    dev = torch.device(device)
    fp = frame_period / 1000.0
    locs, vuv = pulses(f0, fs, frame_period)
    n_buf = buffers(int(locs[-1]) if len(locs) else 0, buffer_size)
    n_out = n_buf * buffer_size
    used = locs < n_out                 # every pulse but the last
    sizes = np.diff(locs)[used[:-1]] if len(locs) else locs
    locs, vuv = locs[used], vuv[used]
    y = torch.zeros(n_out + fft_size, dtype=dtype, device=dev)
    if not len(locs):
        return y[:n_out].cpu().numpy().astype(np.float64), n_buf

    t = locs / fs
    lo = (t / fp).astype(np.int64)
    hi = np.ceil(t / fp).astype(np.int64)
    w = t / fp - lo
    nxt = np.where(lo == hi, lo, lo + 1)
    env_rows = np.abs(np.asarray(sp, np.float64))
    ap_rows = np.clip(np.asarray(ap, np.float64), 0.001, 1.0 - 1e-12)
    if rng_mode == "exact":
        starts = np.cumsum(sizes) - sizes
    def tensor(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    dc = tensor(dc_remover(fft_size))
    half = fft_size // 2
    for a in range(0, len(locs), BLOCK):
        b = slice(a, a + BLOCK)
        wb = w[b][:, None]
        env = (1.0 - wb) * env_rows[lo[b]] + wb * env_rows[nxt[b]]
        apb = ((1.0 - wb) * ap_rows[lo[b]] + wb * ap_rows[nxt[b]]) ** 2
        if rng_mode == "exact":
            noise = ref_rng.randn_blocks_at(
                torch.as_tensor(starts[b], device=dev), fft_size)
        elif rng_mode == "fast":
            noise = torch.as_tensor(
                fast_noise(np.arange(a, a + len(lo[b])) + 1, fft_size),
                device=dev)
        else:
            raise ValueError(f"rng_mode {rng_mode!r}")
        resp = responses(tensor(env), tensor(apb), tensor(vuv[b]),
                         noise.to(dtype),
                         torch.as_tensor(sizes[b], device=dev), dc, fft_size)
        # Sample j of a response lands at loc - fft/2 + 1 + j; below the
        # start of the consuming window it is dropped.
        first = locs[b] - half + 1
        window = buffer_size * (locs[b] // buffer_size)
        at = torch.as_tensor(first, device=dev)[:, None] \
            + torch.arange(fft_size, device=dev)
        keep = at >= torch.as_tensor(window, device=dev)[:, None]
        resp = torch.where(keep, resp, 0.0)
        at = torch.where(keep, at, 0)
        y.index_add_(0, at.reshape(-1), resp.reshape(-1))
    return y[:n_out].cpu().numpy().astype(np.float64), n_buf
