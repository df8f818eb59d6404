"""WORLD synthesis (batch), reference src/synthesis.cpp.

A pulse train is derived from the F0 contour (per-sample phase
accumulation; a pulse wherever the wrapped phase jumps by more than pi).
For each pulse a minimum-phase periodic response plus a noise-excited
aperiodic response is rendered, and the responses of the real pulses
are overlap-added by the port's CUDA kernel in its ragged mode
(ops/ola.py) for both dtypes.  The phase is summed in the reference's
order by the port's sequential scan kernel (ops/scan.py).

Where the JAX package compacts pulses with a keyed sort into a
fixed-capacity array and renders capacity-sized chunks, the port takes
the pulses with ``nonzero`` and renders only the real ones.
"""

import numpy as np
import torch

from .. import config
from ..device import as_tensor, div, resolve_device
from ..ops import fftpack
from ..ops import rng as rng_ops
from ..ops.common import minimum_phase_spectrum
from ..ops.matlab import fftshift, interp1
from ..ops.ola import ola_accumulate_ragged
from ..ops.scan import cumsum_rows

# Pulses rendered per chunk are bounded so (pulses x fft_size) stays
# below this many elements per intermediate.
_RENDER_ELEMENTS = 1 << 24


def _dc_remover(fft_size, dtype, device):
    """Hann-ish normalized DC removal kernel (src/synthesis.cpp:323-335)."""
    i = np.arange(fft_size // 2)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (i + 1.0) / (1.0 + fft_size))
    w = w / (2.0 * w.sum())
    return torch.as_tensor(np.concatenate([w, w[::-1]]), dtype=dtype,
                           device=device)


def _time_base(f0, fs_t, frame_period_s, y_length, lowest_f0):
    """Per-sample f0/vuv interpolation and pulse detection
    (src/synthesis.cpp:224-321), batched over rows of f0 (B, F).
    Returns (is_pulse, fractional shift, vuv), each (B, y_length-1)."""
    dtype, dev = f0.dtype, f0.device
    f0_length = f0.shape[1]
    coarse_time = torch.arange(f0_length + 1, dtype=dtype,
                               device=dev) * frame_period_s
    zero = torch.zeros((), dtype=dtype, device=dev)
    cf0 = torch.where(f0 < lowest_f0, zero, f0)
    cvuv = torch.where(cf0 == 0.0, zero, zero + 1.0)
    cf0 = torch.cat([cf0, (cf0[:, -1] * 2 - cf0[:, -2])[:, None]], 1)
    cvuv = torch.cat([cvuv, (cvuv[:, -1] * 2 - cvuv[:, -2])[:, None]], 1)

    time_axis = torch.arange(y_length, dtype=dtype, device=dev) / fs_t
    if0 = interp1(coarse_time, cf0, time_axis)
    ivuv = interp1(coarse_time, cvuv, time_axis)
    ivuv = torch.where(ivuv > 0.5, zero + 1.0, zero)
    if0 = torch.where(ivuv == 0.0, zero + config.K_DEFAULT_F0, if0)

    increment = (2.0 * config.K_PI) * if0 / fs_t
    # Summed in the reference's order (ops/scan.py): where the sum ties a
    # period boundary, its rounding places the pulse.
    total_phase = cumsum_rows(increment.contiguous())
    wrap_phase = torch.remainder(total_phase, 2.0 * config.K_PI)
    jump = torch.abs(torch.diff(wrap_phase, dim=1))
    is_pulse = jump > config.K_PI  # pulse at sample i, i < y_length-1

    y1 = wrap_phase[:, :-1] - 2.0 * config.K_PI
    y2 = wrap_phase[:, 1:]
    shift = (-y1 / (y2 - y1)) / fs_t
    return is_pulse, shift, ivuv[:, :-1]


def _lerp_frames(values, rows, current_time, frame_period_s):
    """Two-frame linear interpolation of a spectral track
    (src/synthesis.cpp:141-179).  values (B, F, K); rows/current_time
    (N,) per pulse.  Returns (N, K)."""
    f0_length = values.shape[1]
    t = div(current_time, frame_period_s)
    lo = torch.floor(t).to(torch.int64).clamp(max=f0_length - 1)
    hi = torch.ceil(t).to(torch.int64).clamp(max=f0_length - 1)
    w = (t - torch.floor(t))[:, None]
    v_lo = values[rows, lo]
    v_hi = values[rows, hi]
    return torch.where((lo == hi)[:, None], v_lo,
                       (1.0 - w) * v_lo + w * v_hi)


def _render(sp_abs, ap_safe, rows, current_time, vuv, shift, noise,
            noise_size, fs_t, fft_size, frame_period_s, dc_remover):
    """Periodic + aperiodic response of N pulses (src/synthesis.cpp:
    19-139,184-222).  Returns (N, fft_size)."""
    dtype, dev = sp_abs.dtype, sp_abs.device
    half = fft_size // 2
    env = _lerp_frames(sp_abs, rows, current_time, frame_period_s)
    ap = _lerp_frames(ap_safe, rows, current_time, frame_period_s) ** 2

    # periodic response (src/synthesis.cpp:106-139)
    logspec = torch.log(env * (1.0 - ap)
                        + config.K_MY_SAFE_GUARD_MINIMUM) / 2.0
    mp = minimum_phase_spectrum(logspec, fft_size)
    coefficient = (2.0 * config.K_PI) * shift * fs_t / fft_size
    k = torch.arange(half + 1, dtype=dtype, device=dev)
    re2 = torch.cos(coefficient[:, None] * k)
    im2 = torch.sqrt(1.0 - re2 ** 2)  # == sin for arguments in [0, pi)
    shifted = torch.complex(mp.real * re2 + mp.imag * im2,
                            mp.imag * re2 - mp.real * im2)
    periodic = fftshift(fftpack.irfft_unnormalized(shifted, fft_size))
    dc = periodic[:, half:].sum(-1, keepdim=True)
    i = torch.arange(fft_size, device=dev)
    periodic = torch.where(i < half, torch.zeros_like(periodic),
                           periodic) - dc * dc_remover
    skip = (vuv <= 0.5) | (ap[:, 0] > 0.999)
    periodic = torch.where(skip[:, None], torch.zeros_like(periodic),
                           periodic)

    # aperiodic response (src/synthesis.cpp:19-69)
    in_noise = i < noise_size[:, None]
    noise = torch.where(in_noise, noise, torch.zeros_like(noise))
    mean = noise.sum(-1, keepdim=True) / noise_size.clamp(min=1)[:, None]
    noise = torch.where(in_noise, noise - mean, torch.zeros_like(noise))
    noise_spec = torch.fft.rfft(noise)
    ap_log = torch.where((vuv != 0.0)[:, None], torch.log(env * ap) / 2.0,
                         torch.log(env) / 2.0)
    mp_ap = minimum_phase_spectrum(ap_log, fft_size)
    aperiodic = fftshift(fftpack.irfft_unnormalized(mp_ap * noise_spec,
                                                    fft_size))
    sqrt_noise = torch.sqrt(noise_size.to(dtype))[:, None]
    return (periodic * sqrt_noise + aperiodic) / fft_size


def synthesis_batch(f0, spectrogram, aperiodicity, fs, frame_period,
                    y_length, fft_size, rng_mode="exact", max_pulses=None):
    """Batch synthesis of B utterances: f0 (B, F), spectrogram and
    aperiodicity (B, F, fft_size//2+1), all on one device and dtype.
    ``max_pulses``, when set, is a capacity: each row renders its first
    ``max_pulses`` pulses and drops the rest (the kept pulses render as
    they would without it).  Returns (B, y_length)."""
    dtype, dev = spectrogram.dtype, spectrogram.device
    B = f0.shape[0]
    frame_period_s = frame_period / 1000.0
    lowest_f0 = fs / fft_size + 1.0
    fs_t = torch.full((), float(fs), dtype=dtype, device=dev)

    is_pulse, shift_all, vuv_all = _time_base(f0, fs_t, frame_period_s,
                                              y_length, lowest_f0)
    rows, samples = is_pulse.nonzero(as_tuple=True)   # row-major, ascending
    row_ptr = torch.nn.functional.pad(torch.cumsum(is_pulse.sum(1), 0),
                                      (1, 0))
    # Noise length: up to the row's next pulse, 0 for its last pulse.
    same_row = rows[1:] == rows[:-1]
    ns = torch.zeros_like(samples)
    ns[:-1] = torch.where(same_row, samples[1:] - samples[:-1], 0)
    slot = torch.arange(samples.shape[0], device=dev) - row_ptr[rows]
    if rng_mode == "exact":
        # Each row's noise stream starts at 0: exclusive cumsum per row.
        start = torch.cumsum(ns, 0) - ns
        start = start - start[row_ptr[rows]]
    if max_pulses is not None:
        keep = slot < max_pulses
        rows, samples, ns, slot = (a[keep] for a in (rows, samples, ns,
                                                     slot))
        if rng_mode == "exact":
            start = start[keep]
        row_ptr = torch.nn.functional.pad(
            torch.cumsum(is_pulse.sum(1).clamp(max=max_pulses), 0), (1, 0))

    if rng_mode == "exact":
        noise = rng_ops.randn_blocks_at(start, fft_size).to(dtype)
    elif rng_mode == "fast":
        # One draw per pulse slot within its row, up to the capacity
        # (by default the JAX step's, world_tpu/parallel/pipeline.py:
        # 198-199), so a row's noise does not depend on the other rows.
        # Without max_pulses, slots past it (tracks averaging above
        # 1500 Hz, whose extra pulses the JAX step drops) reuse the draws
        # cyclically.
        capacity = (min(y_length, int(y_length / fs * 1500) + 64)
                    if max_pulses is None else max_pulses)
        noise = rng_ops.fast_normal(3, (capacity, fft_size), dtype,
                                    dev)[slot % capacity]
    elif rng_mode == "none":
        noise = torch.zeros((samples.shape[0], fft_size), dtype=dtype,
                            device=dev)
    else:
        raise ValueError(f"rng_mode {rng_mode!r}")

    sp_abs = spectrogram.abs()
    ap_safe = aperiodicity.clamp(0.001, 1.0 - config.K_MY_SAFE_GUARD_MINIMUM)
    dc_rem = _dc_remover(fft_size, dtype, dev)
    current_time = samples.to(dtype) / fs_t
    vuv = vuv_all[rows, samples]
    shift = shift_all[rows, samples]

    n = samples.shape[0]
    chunk = max(1, _RENDER_ELEMENTS // fft_size)
    rendered = [
        _render(sp_abs, ap_safe, rows[a:a + chunk], current_time[a:a + chunk],
                vuv[a:a + chunk], shift[a:a + chunk], noise[a:a + chunk],
                ns[a:a + chunk], fs_t, fft_size, frame_period_s, dc_rem)
        for a in range(0, n, chunk)]
    if len(rendered) == 1:
        responses = rendered[0]
    elif rendered:
        responses = torch.cat(rendered)
    else:
        responses = torch.zeros((0, fft_size), dtype=dtype, device=dev)

    # OLA with out-of-range drop (src/synthesis.cpp:370-386): offsets
    # >= -(fft_size-1) land in a left pad, so clamping never engages and
    # the slice below drops what falls outside [0, y_length).  Offsets
    # ascend within each row, as the ragged kernel requires.
    pad_l = fft_size
    y_padded = y_length + 2 * fft_size
    offs = (samples - fft_size // 2 + 1 + pad_l).clamp(0, y_padded - fft_size)
    y = ola_accumulate_ragged(responses, offs.to(torch.int32),
                              row_ptr.to(torch.int32), y_padded=y_padded)
    return y[:, pad_l:pad_l + y_length]


def synthesis(f0, spectrogram, aperiodicity, fs, frame_period=5.0,
              y_length=None, fft_size=None, max_pulses=None,
              rng_mode="exact", device=None):
    """Synthesis of one utterance (reference src/synthesis.cpp:339-399).

    Returns the waveform of length ``y_length`` (default:
    (f0_length-1)*frame_period*fs/1000 + 1, as in test/test.cpp:252-254).
    ``max_pulses`` is the JAX package's static pulse capacity: pulses past
    the first ``max_pulses`` are dropped.  None renders every pulse.
    """
    dev = resolve_device(device)
    spectrogram = as_tensor(spectrogram, dev)
    f0 = as_tensor(f0, dev, spectrogram.dtype)
    aperiodicity = as_tensor(aperiodicity, dev, spectrogram.dtype)
    f0_length = f0.shape[0]
    if fft_size is None:
        fft_size = 2 * (spectrogram.shape[1] - 1)
    if y_length is None:
        y_length = int((f0_length - 1) * frame_period / 1000.0 * fs) + 1
    return synthesis_batch(f0[None], spectrogram[None], aperiodicity[None],
                           fs, frame_period, y_length, fft_size,
                           rng_mode=rng_mode, max_pulses=max_pulses)[0]
