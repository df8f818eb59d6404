"""Streaming (real-time) synthesizer (port of world_tpu/models/realtime.py).

Reference src/synthesisrealtime.cpp: parameters arrive in chunks through
a ring buffer; Synthesis2 renders exactly buffer_size samples per call,
carrying pulse phase and F0 across chunk boundaries.

The host state -- ring-buffer bookkeeping, each chunk's time base and
pulse locations, the pulse walk -- is numpy float64 for both dtypes, as
in the JAX package: a float32 time base on the device would move pulses.
The per-pulse response (the realtime flavour: no fractional shift, the
safe-guard epsilon inside the voiced aperiodic log, DC removed from the
second half only) is rendered for every pulse of a dispatch in one
batched pass on the device, in the synthesizer's dtype.  With span
rendering the responses, each zeroed below the start of the window that
consumes it, are overlap-added on the device by the OLA kernel's general
mode (ops/ola.ola_accumulate), and only the span comes back.

Asynchrony without threads: a render is launched on the current CUDA
stream, its span (or its response rows) is copied with non_blocking into
pinned host memory, and a CUDA event is recorded.  A render is pending
while its event has not completed; a window that needs a pending render
waits on its event, or, with hold_on_miss, synthesis2 returns False
without consuming state.  On the CPU everything is synchronous.

Not ported, because it exists only for the JAX package's TPU round
trip of ~30 ms per device interaction: the render worker thread and its
fetch pool, span buckets and the fixed span lane count (eager PyTorch
compiles nothing per shape), the warm-up compile of every bucket, and
the donated device parameter ring (here each chunk keeps its own device
rows, freed when the ring pruning drops the chunk).
"""

import collections
import math
import time

import numpy as np
import torch

from .. import config
from ..device import download, resolve_device, upload
from ..ops import fftpack
from ..ops import rng as rng_ops
from ..ops.common import minimum_phase_spectrum
from ..ops.matlab import fftshift
from ..ops.ola import ola_accumulate

_MASK = 0xFFFFFFFF
_FAST_SEED = 3


def _np_interp1(x, y, xi):
    """interp1 with histc semantics (matches ops.matlab.interp1), numpy."""
    k = np.clip(np.searchsorted(x, xi, side="right"), 1, len(x) - 1)
    x0 = x[k - 1]
    s = (xi - x0) / (x[k] - x0)
    return y[k - 1] + s * (y[k] - y[k - 1])


def _dc_remover_half(n):
    """GetDCRemover(fft_size/2) (src/synthesisrealtime.cpp:428-440)."""
    i = np.arange(n // 2)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (i + 1.0) / (1.0 + n))
    w = w / (2.0 * w.sum())
    return np.concatenate([w, w[::-1]])


def _hash32(x):
    """PCG output hash of uint32 values held in int64 tensors or Python
    ints (Jarzynski and Olano, "Hash Functions for GPU Rendering", 2020).
    Every product stays below 2**62."""
    state = (x * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return ((word >> 22) ^ word) & _MASK


def fast_noise(seed, refs, n, dtype):
    """Fast-mode noise: n normals for each pulse reference in ``refs``
    (int64 (P,)), a pure function of (seed, ref) made in a fixed number
    of tensor ops (a counter hash, then Box-Muller), so how pulses are
    grouped into renders cannot change the audio.  Returns (P, n)."""
    dev = refs.device
    key = _hash32((refs & _MASK) ^ _hash32(seed))
    j = torch.arange((n + 1) // 2, device=dev, dtype=torch.int64)
    u1 = (_hash32(key[:, None] ^ (2 * j)).to(torch.float64)
          + 0.5) / 2.0 ** 32
    u2 = _hash32(key[:, None] ^ (2 * j + 1)).to(torch.float64) / 2.0 ** 32
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)],
                     -1)[:, :n].to(dtype)


def render_responses(envs, aps, vuvs, noise, noise_sizes, dc_remover,
                     fft_size):
    """GetOneFrameSegment, realtime flavour (src/synthesisrealtime.cpp:
    246-281), for P pulses at once: envs/aps (P, fft/2+1), vuvs (P,),
    noise (P, fft), noise_sizes int64 (P,), dc_remover (fft,) zero in its
    first half.  Returns (P, fft)."""
    half = fft_size // 2
    logspec = torch.log(envs * (1.0 - aps)
                        + config.K_MY_SAFE_GUARD_MINIMUM) / 2.0
    mp = minimum_phase_spectrum(logspec, fft_size)
    periodic = fftshift(fftpack.irfft_unnormalized(mp, fft_size))
    dc = periodic[:, half:].sum(-1, keepdim=True)
    i = torch.arange(fft_size, device=envs.device)
    periodic = torch.where(i >= half, periodic,
                           torch.zeros_like(periodic)) - dc * dc_remover
    skip = (vuvs <= 0.5) | (aps[:, 0] > 0.999)
    periodic = torch.where(skip[:, None], torch.zeros_like(periodic),
                           periodic)

    in_noise = i < noise_sizes[:, None]
    noise = torch.where(in_noise, noise, torch.zeros_like(noise))
    mean = noise.sum(-1, keepdim=True) / noise_sizes.clamp(min=1)[:, None]
    noise = torch.where(in_noise, noise - mean, torch.zeros_like(noise))
    noise_spec = torch.fft.rfft(noise)
    ap_log = torch.where((vuvs != 0.0)[:, None],
                         torch.log(envs * aps
                                   + config.K_MY_SAFE_GUARD_MINIMUM) / 2.0,
                         torch.log(envs) / 2.0)
    mp_ap = minimum_phase_spectrum(ap_log, fft_size)
    aperiodic = fftshift(fftpack.irfft_unnormalized(mp_ap * noise_spec,
                                                    fft_size))
    sqrt_noise = torch.sqrt(noise_sizes.to(envs.dtype))[:, None]
    return (periodic * sqrt_noise + aperiodic) / fft_size


class _Chunk:
    __slots__ = ("f0_length", "f0_origin", "spectrogram", "aperiodicity",
                 "interpolated_vuv", "pulse_locations",
                 "pulse_locations_index", "number_of_pulses", "start_sample",
                 "params")

    def __init__(self):
        self.number_of_pulses = 0
        self.interpolated_vuv = None
        self.pulse_locations = None
        self.pulse_locations_index = None
        self.params = None       # device (2, F, fft/2+1): |sp|, clipped ap


class _Render:
    """One dispatched render: "span" (its waveform lands in the span
    accumulator at ``base``) or "rows" (one response per key).  ``host``
    holds the result once ``event`` (None on the CPU) has completed."""
    __slots__ = ("kind", "base", "host", "event", "bid", "keys", "locs")

    def __init__(self, kind, base, host, event):
        self.kind, self.base, self.host, self.event = kind, base, host, event

    def done(self):
        return self.event is None or self.event.query()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


def _pending(v):
    return isinstance(v, tuple) and v[0] == "pending"


class StreamingSynthesizer:
    """WorldSynthesizer / AddParameters / Synthesis2 / IsLocked
    (reference src/world/synthesisrealtime.h, src/synthesisrealtime.cpp),
    rendering on ``device`` (the GPU unless given).

    Arguments are the JAX package's except its ``param_ring_rows``:
    ``lookahead_pulses`` future pulses are rendered per dispatch and
    cached, so one render covers many windows; ahead-only renders wait
    for ``dispatch_min_pulses`` pulses (doubling from 1 at the start of a
    stream); ``hold_on_miss`` makes synthesis2 return False without
    consuming state while the window's render is pending, a held window
    forcing its render after ``hold_force_ms``; ``span_render`` overlap-
    adds batches of at least ``span_min_pulses`` pulses on the device
    (False keeps the per-pulse rows, added on the host);
    ``device_params`` ("auto": float32 only) keeps each chunk's
    parameter rows on the device and interpolates them there."""

    def __init__(self, fs, frame_period, fft_size, buffer_size,
                 number_of_pointers, rng_mode="exact", dtype=np.float64,
                 lookahead_pulses=256, hold_on_miss=False,
                 dispatch_min_pulses=None, hold_force_ms=15.0,
                 span_render=True, span_min_pulses=8,
                 device_params="auto", device=None):
        if rng_mode not in ("exact", "fast", "none"):
            raise ValueError(f"rng_mode {rng_mode!r}")
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.float32, np.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        if hold_on_miss and lookahead_pulses <= 0:
            # The hold path renders the missing window through the
            # lookahead walk; at lookahead 0 it would hold forever.
            raise ValueError(
                "hold_on_miss requires lookahead_pulses >= 1 (the hold "
                "path renders the missing window via the lookahead walk)")
        self.device = resolve_device(device)
        self.fs = fs
        self.frame_period = frame_period / 1000.0
        self.fft_size = fft_size
        self.buffer_size = buffer_size
        self.number_of_pointers = number_of_pointers
        self.rng_mode = rng_mode
        self.lookahead_pulses = lookahead_pulses
        self.hold_on_miss = hold_on_miss
        self.dispatch_min = (max(1, min(lookahead_pulses, 64) // 2)
                             if dispatch_min_pulses is None
                             else dispatch_min_pulses)
        self.hold_force_ms = hold_force_ms
        self.span_render = span_render
        self.span_min_pulses = max(1, span_min_pulses)
        self.device_params = (self.dtype == np.float32
                              if device_params == "auto"
                              else bool(device_params))
        self._tdtype = (torch.float32 if self.dtype == np.float32
                        else torch.float64)
        self._dc_remover = None
        self.buffer = np.zeros(buffer_size * 2 + fft_size, self.dtype)
        self.chunks = {}
        self._inflight = collections.deque()
        self._next_bid = 0
        self.renders = 0      # renders launched (diagnostics)
        self.refresh()

    # -- ring-buffer state ---------------------------------------------
    def refresh(self):
        """RefreshSynthesizer (src/synthesisrealtime.cpp:521-542)."""
        self._flush()
        self._failed = None
        self.chunks.clear()
        self.handoff_phase = 0.0
        self.handoff_f0 = 0.0
        self.cumulative_frame = -1
        self.last_location = 0
        self.current_pointer = 0
        self.current_pointer2 = 0
        self.head_pointer = 0
        self.handoff = 0
        self.i = 0
        self.synthesized_sample = 0
        self.buffer[:] = 0.0
        self._draw_counter = 0
        self._fast_step = 0
        # key -> response row (ndarray), ("span", pulse location) once the
        # pulse's audio is in the span accumulator, or ("pending", bid).
        self._resp_cache = {}
        # Landed spans cover samples [_acc_start, _acc_start + len(_acc)).
        self._acc = np.zeros(0, self.dtype)
        self._acc_start = 0
        self._staged = {}  # key -> pulse params awaiting dispatch
        self._hold_t0 = None
        self.holds = 0  # hold_on_miss "not yet" returns (diagnostics)
        # Dispatch-threshold ramp: 1, 2, 4, ... pulses up to dispatch_min.
        self._ramp = 1
        self._primed = False
        # The lookahead walk re-runs only when pulses arrived, a window
        # missed, or consumption drew a capped horizon closer.
        self._pulse_epoch = 0
        self._walk_epoch = -1
        self._walk_exhausted = False
        self._consumed_since_walk = 0

    def close(self):
        """Take in every in-flight render and release the device buffers
        (each chunk's parameter rows).  A closed synthesizer can be used
        again: rows are uploaded anew when a render needs them."""
        while self._inflight:
            render = self._inflight.popleft()
            render.wait()
            self._absorb(render)
        for c in self.chunks.values():
            c.params = None
        self._dc_remover = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def is_locked(self):
        """IsLocked (src/synthesisrealtime.cpp:566-575)."""
        full = (self.head_pointer - self.current_pointer2
                == self.number_of_pointers)
        starved = (self.synthesized_sample + self.buffer_size
                   >= self.last_location)
        return full and starved

    def _upload_params(self, chunk):
        rows = np.stack([np.abs(chunk.spectrogram),
                         np.clip(chunk.aperiodicity, 0.001, 1.0 - 1e-12)])
        return upload(rows.astype(self.dtype), self._tdtype, self.device)

    def add_parameters(self, f0, spectrogram, aperiodicity):
        """AddParameters (src/synthesisrealtime.cpp:480-519).
        Returns False when the ring is full."""
        if self.head_pointer - self.current_pointer2 \
                == self.number_of_pointers:
            return False
        f0 = np.asarray(f0, self.dtype)
        chunk = _Chunk()
        chunk.f0_length = len(f0)
        chunk.f0_origin = self.cumulative_frame + 1
        self.cumulative_frame += len(f0)
        chunk.spectrogram = np.asarray(spectrogram, self.dtype)
        chunk.aperiodicity = np.asarray(aperiodicity, self.dtype)
        if self.device_params:
            chunk.params = self._upload_params(chunk)
        self.chunks[self.head_pointer] = chunk

        if self.cumulative_frame < 1:
            self.handoff_f0 = f0[-1]
            self.head_pointer += 1
            self.handoff = 1
            return True

        start_sample = max(0, int(np.ceil(
            (self.cumulative_frame - len(f0)) * self.frame_period * self.fs)))
        end_sample = int(np.ceil(
            self.cumulative_frame * self.frame_period * self.fs))
        n = end_sample - start_sample
        chunk.start_sample = start_sample
        self._get_time_base(f0, chunk, start_sample, n)
        # GetTimeBase stores the interpolated f0 into handoff_f0, but
        # AddParameters then overwrites it with the raw last frame value
        # (src/synthesisrealtime.cpp:372,515).
        self.handoff_f0 = f0[-1]
        self.head_pointer += 1
        self.handoff = 1
        self._pulse_epoch += 1
        # Before the stream's first render, start rendering the new
        # pulses now, so the first synthesis2 finds its window in flight.
        if self.lookahead_pulses > 0 and not self._primed:
            params, keys = self._collect_lookahead()
            if keys:
                self._submit(keys, params)
        return True

    def _get_time_base(self, f0, chunk, start_sample, n):
        """GetTimeBase (src/synthesisrealtime.cpp:341-378)."""
        h = self.handoff
        cum0 = max(0, self.cumulative_frame - len(f0))
        coarse_time = np.empty(len(f0) + h)
        coarse_f0 = np.empty(len(f0) + h)
        coarse_vuv = np.empty(len(f0) + h)
        if h:
            coarse_f0[0] = self.handoff_f0
            coarse_time[0] = cum0 * self.frame_period
            coarse_vuv[0] = 0.0 if self.handoff_f0 == 0 else 1.0
        coarse_time[h:] = (np.arange(len(f0)) + cum0 + h) * self.frame_period
        coarse_f0[h:] = f0
        coarse_vuv[h:] = np.where(f0 == 0.0, 0.0, 1.0)

        time_axis = (np.arange(n) + start_sample) / self.fs
        if0 = _np_interp1(coarse_time, coarse_f0, time_axis)
        ivuv = _np_interp1(coarse_time, coarse_vuv, time_axis)
        ivuv = np.where(ivuv > 0.5, 1.0, 0.0)
        if0 = np.where(ivuv == 0.0, config.K_DEFAULT_F0, if0)
        vuv_store = np.empty(n + 1)
        vuv_store[:n] = ivuv
        vuv_store[n] = ivuv[-1]
        chunk.interpolated_vuv = vuv_store

        # GetPulseLocationsForTimeBase (src/synthesisrealtime.cpp:298-339)
        if h:
            # Accumulate starting from handoff_phase, one rounding per
            # step, like the C++ running sum.
            total = np.cumsum(np.concatenate(
                [[self.handoff_phase], 2.0 * np.pi * if0[: n - 1 + h]
                 / self.fs]))
        else:
            total = np.cumsum(2.0 * np.pi * if0 / self.fs)
        self.handoff_phase = total[n - 1 + h]
        wrap = np.mod(total, 2.0 * np.pi)
        jumps = np.abs(np.diff(wrap)) > np.pi
        pulse_samples = np.where(jumps)[0]
        # With a handoff the pulse time is time_axis[i] - handoff/fs
        # (src/synthesisrealtime.cpp:322-328).
        locs = time_axis[pulse_samples] - h / self.fs if len(pulse_samples) \
            else np.empty(0)
        chunk.pulse_locations = locs
        # matlab_round, not np.round: half-to-even differs at exact .5
        # (src/synthesisrealtime.cpp:326-328); locations are >= 0.
        idx = np.floor(locs * self.fs + 0.5).astype(np.int64)
        chunk.pulse_locations_index = idx
        chunk.number_of_pulses = len(idx)
        if len(idx):
            self.last_location = int(idx[-1])

    # -- pulse walk ------------------------------------------------------
    def _chunk(self, pointer):
        return self.chunks.get(pointer)

    def _seek(self, current_location):
        """SeekSynthesizer (src/synthesisrealtime.cpp:101-117), called
        with seconds from the consumption walk."""
        frame = int(current_location / self.frame_period)
        tmp_pointer = self.current_pointer2
        for i in range(self.head_pointer - self.current_pointer2):
            p = tmp_pointer + i
            c = self._chunk(p)
            if c.f0_origin <= frame < c.f0_origin + c.f0_length:
                tmp_pointer = p
                break
        # ClearRingBuffer frees pulse arrays but keeps chunk metadata
        # (src/synthesisrealtime.cpp:81-99); chunks fully out of reach are
        # dropped, with their device rows.  Clearing is bounded by the
        # consumption pointer, so a lookahead never loses pulses.
        reach = min(self.current_pointer, tmp_pointer)
        for p in range(self.current_pointer2, reach):
            c = self._chunk(p)
            if c is not None:
                c.number_of_pulses = 0
                c.pulse_locations = None
                c.pulse_locations_index = None
        for p in [k for k in self.chunks if k < reach - 1]:
            del self.chunks[p]
        self.current_pointer2 = tmp_pointer

    def _frame_pointer(self, frame):
        """Non-mutating SeekSynthesizer lookup: the ring pointer whose
        chunk contains ``frame`` (for the lookahead walk, which must not
        move current_pointer2 past frames still to be consumed)."""
        for p in range(self.current_pointer2, self.head_pointer):
            c = self._chunk(p)
            if c is not None and \
                    c.f0_origin <= frame < c.f0_origin + c.f0_length:
                return p
        return self.current_pointer2

    def _search(self, frame, which, pointer=None):
        """SearchPointer (src/synthesisrealtime.cpp:119-136)."""
        p = self.current_pointer2 if pointer is None else pointer
        c = self._chunk(p)
        index = frame - c.f0_origin
        arr = c.spectrogram if which == 0 else c.aperiodicity
        front = arr[index]
        if index == c.f0_length - 1:
            nc = self._chunk(p + 1)
            nxt = (nc.spectrogram if which == 0 else nc.aperiodicity)[0]
        else:
            nxt = arr[index + 1]
        return front, nxt

    def _pulse_params(self, loc, pointer, ns, ref, ahead):
        """A pulse's render parameters (env, ap, vuv, ref, noise_size,
        location, lo, hi, w): the frame bracket lo, hi (lo + 1, or lo at
        an exact frame, then w = 0) with the envelope and aperiodicity
        lerped between them on the host (src/synthesisrealtime.cpp:
        246-281) -- None when the device interpolates them -- and the
        vuv (GetCurrentVUV, src/synthesisrealtime.cpp:230-241).  The
        consumption walk seeks; ``ahead`` pulses use the non-mutating
        lookup."""
        t = loc / self.fs
        fp = self.frame_period
        lo = int(t / fp)
        if ahead:
            p2 = self._frame_pointer(lo)
        else:
            self._seek(t)
            p2 = None
        hi = int(np.ceil(t / fp))
        w = t / fp - lo
        env = ap = None
        if not self.device_params:
            sf, sn = self._search(lo, 0, p2)
            af, an = self._search(lo, 1, p2)
            if lo == hi:
                env = np.abs(sf)
                ap = np.clip(af, 0.001, 1 - 1e-12) ** 2
            else:
                env = (1 - w) * np.abs(sf) + w * np.abs(sn)
                ap = ((1 - w) * np.clip(af, 0.001, 1 - 1e-12)
                      + w * np.clip(an, 0.001, 1 - 1e-12)) ** 2
        c = self._chunk(pointer)
        start_sample = max(0, int(np.ceil(
            (c.f0_origin - 1) * self.frame_period * self.fs)))
        vuv = float(c.interpolated_vuv[loc - start_sample + 1])
        return (env, ap, vuv, ref, ns, loc, lo, lo if lo == hi else lo + 1,
                w)

    def _rng_ref(self, noise_size):
        """Allocate the pulse's RNG reference in stream order (mutates
        the counters; _predict_rng mirrors this)."""
        ref, (self._draw_counter, self._fast_step) = self._predict_rng(
            self.rng_mode, (self._draw_counter, self._fast_step),
            noise_size)
        return ref

    @staticmethod
    def _predict_rng(rng_mode, counters, noise_size):
        """(ref, next counters) of a pulse with ``noise_size``."""
        draw, fast = counters
        if rng_mode == "exact":
            return draw, (draw + max(noise_size, 0), fast)
        if rng_mode == "fast":
            return fast + 1, (draw, fast + 1)
        return 0, counters

    def _next_pulse_index_at(self, pointer, i):
        """GetNextPulseLocationIndex (src/synthesisrealtime.cpp:380-393)
        at an explicit walk position."""
        c = self._chunk(pointer)
        if i < c.number_of_pulses - 1:
            return int(c.pulse_locations_index[i + 1])
        if pointer == self.head_pointer - 1:
            return 0
        for k in range(1, self.number_of_pointers):
            c = self._chunk(pointer + k)
            if c is not None and c.number_of_pulses != 0:
                return int(c.pulse_locations_index[0])
        return 0

    def _advance_at(self, pointer, i):
        """UpdateSynthesizer's walk step (src/synthesisrealtime.cpp:
        395-413) without mutating: returns (pointer, i, ok)."""
        c = self._chunk(pointer)
        if i < c.number_of_pulses - 1:
            return pointer, i + 1, True
        if pointer == self.head_pointer - 1:
            return pointer, i, False
        for k in range(1, self.number_of_pointers):
            c = self._chunk(pointer + k)
            if c is not None and c.number_of_pulses != 0:
                return pointer + k, 0, True
        return pointer, i, False

    def _window_probe(self):
        """Non-mutating mirror of the next window walk: 'ready' when
        every response it needs has landed, 'pending' when some are
        still rendering, 'missing' when some were never dispatched."""
        ptr, i = self.current_pointer, self.i
        counters = (self._draw_counter, self._fast_step)
        loc = int(self._chunk(ptr).pulse_locations_index[i])
        end = self.synthesized_sample + self.buffer_size
        state = "ready"
        while loc < end:
            tmp = self._next_pulse_index_at(ptr, i)
            ns = tmp - loc
            ref, counters = self._predict_rng(self.rng_mode, counters, ns)
            v = self._resp_cache.get((ptr, i, ns, ref))
            if v is None:
                return "missing"
            if _pending(v):
                state = "pending"
            loc = tmp
            ptr, i, ok = self._advance_at(ptr, i)
            if not ok:
                break
        return state

    def _collect_lookahead(self, base=0):
        """Walk future pulses (all but the last known one, whose noise
        size needs the next pulse) with predicted RNG references; returns
        (params, keys) of those neither cached nor rendering, at most
        lookahead_pulses - base."""
        ptr, i = self.current_pointer, self.i
        counters = (self._draw_counter, self._fast_step)
        exhausted = False
        params, keys = [], []
        steps = 4 * self.lookahead_pulses
        while len(keys) + base < self.lookahead_pulses and steps > 0:
            steps -= 1
            ca = self._chunk(ptr)
            if ca is None or ca.number_of_pulses == 0:
                exhausted = True
                break
            loc = int(ca.pulse_locations_index[i])
            tmp = self._next_pulse_index_at(ptr, i)
            if tmp == 0:
                exhausted = True
                break
            ns = tmp - loc
            ref, counters = self._predict_rng(self.rng_mode, counters, ns)
            key = (ptr, i, ns, ref)
            if key not in self._resp_cache:
                p = self._staged.get(key)
                if p is None:
                    p = self._staged[key] = self._pulse_params(
                        loc, ptr, ns, ref, ahead=True)
                params.append(p)
                keys.append(key)
            ptr, i, ok = self._advance_at(ptr, i)
            if not ok:
                exhausted = True
                break
        self._walk_epoch = self._pulse_epoch
        self._walk_exhausted = exhausted
        self._consumed_since_walk = 0
        return params, keys

    # -- rendering -------------------------------------------------------
    def _dc(self):
        if self._dc_remover is None:
            half = self.fft_size // 2
            self._dc_remover = torch.as_tensor(
                np.concatenate([np.zeros(half), _dc_remover_half(half)]),
                dtype=self._tdtype, device=self.device)
        return self._dc_remover

    def _device_rows(self, lo_min, hi_max):
        """Device parameter rows of frames [lo_min, hi_max], gathered
        from the chunks that hold them: ((2, F, fft/2+1), first frame)."""
        parts, first, nxt = [], None, None
        for p in sorted(self.chunks):
            c = self.chunks[p]
            end = c.f0_origin + c.f0_length
            if end <= lo_min or c.f0_origin > hi_max:
                continue
            if nxt is not None and c.f0_origin != nxt:
                break
            if c.params is None:
                c.params = self._upload_params(c)
            parts.append(c.params)
            first = c.f0_origin if first is None else first
            nxt = end
        if first is None or first > lo_min or nxt <= hi_max:
            raise RuntimeError(f"frames {lo_min}-{hi_max} are not held by "
                               "the synthesizer's chunks")
        return (parts[0] if len(parts) == 1 else torch.cat(parts, 1)), first

    def _noise(self, refs_dev, refs):
        fft, dt = self.fft_size, self._tdtype
        if self.rng_mode == "exact":
            return rng_ops.randn_blocks_at(
                refs_dev, fft, bounds=(int(refs.min()), int(refs.max()))
            ).to(dt)
        if self.rng_mode == "fast":
            return fast_noise(_FAST_SEED, refs_dev, fft, dt)
        return torch.zeros((len(refs), fft), dtype=dt, device=self.device)

    def _render_dispatch(self, pulses):
        """Launch one render of ``pulses`` (tuples of _pulse_params) and
        return its _Render.  Batches of at least span_min_pulses pulses
        are overlap-added on the device into one span (span_render);
        smaller ones, or all with span_render=False, come back as
        response rows for the host to add."""
        fft = self.fft_size
        span = self.span_render and len(pulses) >= self.span_min_pulses
        if span:
            # The walk is in location order, but a batch can mix a retry
            # with later pulses; placing needs ascending locations.
            pulses = sorted(pulses, key=lambda pl: pl[5])
        meta = np.array([pl[2:9] for pl in pulses], np.float64).T
        vuv, refs, ns, locs, lo, hi, w = meta
        base = int(locs[0]) - fft // 2 + 1
        offs = locs - fft // 2 + 1 - base
        bs = self.buffer_size
        # Zero each response below the window that consumes its pulse:
        # the reference's ring add never reaches below buffer index 0
        # (src/synthesisrealtime.cpp:577-600).
        clips = np.maximum(0, bs * (locs // bs) - (locs - fft // 2 + 1))
        # Every per-pulse scalar in one upload (integers are exact in
        # float64).
        dev = upload(np.stack([ns, refs, offs, clips, lo, hi, vuv, w]),
                     torch.float64, self.device)
        ns_d, refs_d, offs_d, clips_d, lo_d, hi_d = dev[:6].to(torch.int64)
        vuv_d, w_d = dev[6:].to(self._tdtype)
        if pulses[0][0] is not None:
            envs, aps = upload(np.stack(
                [np.stack([pl[0] for pl in pulses]),
                 np.stack([pl[1] for pl in pulses])]), self._tdtype,
                self.device)
        else:
            rows, first = self._device_rows(int(lo.min()), int(hi.max()))
            w_c = w_d[:, None]
            lo_r, hi_r = rows[:, lo_d - first], rows[:, hi_d - first]
            envs = (1.0 - w_c) * lo_r[0] + w_c * hi_r[0]
            aps = ((1.0 - w_c) * lo_r[1] + w_c * hi_r[1]) ** 2
        resp = render_responses(envs, aps, vuv_d, self._noise(refs_d, refs),
                                ns_d, self._dc(), fft)
        if span:
            i = torch.arange(fft, device=self.device)
            resp = torch.where(i[None, :] >= clips_d[:, None], resp,
                               torch.zeros_like(resp))
            out = ola_accumulate(resp[None], offs_d.to(torch.int32)[None],
                                 y_padded=int(offs[-1]) + fft)[0]
            kind = "span"
        else:
            out, kind = resp, "rows"
        (host,), event = download([out], self.device)
        return _Render(kind, base, host, event)

    def _submit(self, keys, params):
        """Launch a render of ``params`` and mark its keys pending.  A
        launch that raises is reported at the next drain or wait, as a
        failed render is, and its keys stay missing, so the walk
        dispatches them again."""
        bid = self._next_bid
        self._next_bid += 1
        self._primed = True
        if self._ramp < self.dispatch_min:
            self._ramp *= 2
        try:
            render = self._render_dispatch(params)
        except Exception as e:  # noqa: BLE001 -- raised again at the drain
            self._failed = e
            return bid
        render.bid, render.keys = bid, keys
        render.locs = [p[5] for p in params]
        self._inflight.append(render)
        self.renders += 1
        for k in keys:
            self._resp_cache[k] = ("pending", bid)
            self._staged.pop(k, None)
        return bid

    def _raise_failed(self):
        if self._failed is not None:
            e, self._failed = self._failed, None
            raise e

    def _absorb(self, render):
        if render.kind == "span":
            self._span_sink(render.base, render.host.numpy())
            for k, loc in zip(render.keys, render.locs):
                self._resp_cache[k] = ("span", loc)
        else:
            rows = render.host.numpy()
            for k, row in zip(render.keys, rows):
                self._resp_cache[k] = row

    def _drain(self):
        """Take in every render that has landed (without waiting)."""
        self._raise_failed()
        while self._inflight and self._inflight[0].done():
            self._absorb(self._inflight.popleft())

    def _wait(self, bid):
        """Block until render ``bid`` (and every earlier one) landed."""
        self._raise_failed()
        while self._inflight and self._inflight[0].bid <= bid:
            render = self._inflight.popleft()
            render.wait()
            self._absorb(render)

    def _flush(self):
        """Wait for every in-flight render and discard its result."""
        while self._inflight:
            self._inflight.popleft().wait()

    def warmup(self, max_pulses=None):
        """Build the OLA kernel and run one render at each lane count
        1..max_pulses (default lookahead_pulses), so that cuFFT's plans
        exist before real time.  Its renders touch no stream state."""
        n = max(max_pulses or max(self.lookahead_pulses, 1), 1)
        ones = np.ones(self.fft_size // 2 + 1, self.dtype)
        half = self.fft_size // 2
        for lanes in range(1, n + 1):
            self._render_dispatch(
                [(ones, ones, 0.0, 0, 0, half + k, 0, 0, 0.0)
                 for k in range(lanes)]).wait()
        return self

    @property
    def _dispatch_threshold(self):
        return min(self.dispatch_min, self._ramp)

    # -- span accumulator ------------------------------------------------
    def _span_sink(self, base, wave):
        """Add a landed span.  Contributions below _acc_start would hit
        samples already emitted and are zeros by construction (the
        per-pulse clip), so they are dropped."""
        rel = base - self._acc_start
        if rel < 0:
            wave = wave[-rel:]
            rel = 0
        end = rel + len(wave)
        if end > len(self._acc):
            self._acc = np.concatenate(
                [self._acc,
                 np.zeros(max(end - len(self._acc), 8192), self.dtype)])
        self._acc[rel:end] += wave

    def _acc_emit(self, start, n):
        """Add the span accumulator's [start, start+n) samples into
        self.buffer[:n] and drop the consumed prefix now and then."""
        rel = start - self._acc_start
        if rel >= len(self._acc):
            return
        take = min(n, len(self._acc) - rel)
        self.buffer[:take] += self._acc[rel: rel + take]
        if rel + take >= 1 << 15:
            self._acc = self._acc[rel + take:].copy()
            self._acc_start = start + take

    def synthesis2(self):
        """Synthesis2 (src/synthesisrealtime.cpp:577-603).  On success
        the first buffer_size samples of self.buffer are the new audio.

        Ahead renders are launched without waiting; a window whose
        responses are not in yet waits for them (reference semantics),
        or with hold_on_miss returns False without consuming state."""
        self._drain()
        # CheckSynthesizer (src/synthesisrealtime.cpp:415-426)
        if self.synthesized_sample + self.buffer_size >= self.last_location:
            return False
        c = self._chunk(self.current_pointer)
        while c is not None and c.number_of_pulses == 0:
            if self.current_pointer == self.head_pointer:
                break
            self.current_pointer += 1
            c = self._chunk(self.current_pointer)
        if c is None or c.number_of_pulses == 0:
            return False

        if self.hold_on_miss:
            state = self._window_probe()
            if state != "ready":
                now = time.perf_counter()
                if self._hold_t0 is None:
                    self._hold_t0 = now
                if state == "missing":
                    # Batch arriving pulses for up to hold_force_ms (or
                    # until the dispatch threshold), then render.
                    force = 1e3 * (now - self._hold_t0) \
                        >= self.hold_force_ms
                    if force or self._walk_epoch != self._pulse_epoch:
                        params, keys = self._collect_lookahead()
                        if keys and (force
                                     or len(keys)
                                     >= self._dispatch_threshold):
                            self._submit(keys, params)
                            self._hold_t0 = now
                self._drain()
                state = self._window_probe()
                if state != "ready":
                    self.holds += 1
                    return False
            self._hold_t0 = None

        bs, fft = self.buffer_size, self.fft_size
        self.buffer[: bs + fft] = self.buffer[bs: 2 * bs + fft]

        c = self._chunk(self.current_pointer)
        current_location = int(c.pulse_locations_index[self.i])
        window, to_render, render_keys = [], [], []
        while current_location < self.synthesized_sample + bs:
            pointer, i = self.current_pointer, self.i
            tmp = self._next_pulse_index_at(pointer, i)
            noise_size = tmp - current_location
            ref = self._rng_ref(noise_size)
            key = (pointer, i, noise_size, ref)
            window.append((current_location, key))
            if key in self._resp_cache:
                self._seek(current_location / self.fs)
            else:
                to_render.append(self._pulse_params(
                    current_location, pointer, noise_size, ref, ahead=False))
                render_keys.append(key)
            current_location = tmp
            self._consumed_since_walk += 1
            self.current_pointer, self.i, ok = self._advance_at(pointer, i)
            if not ok:
                break

        # Lookahead: render future pulses ahead of consumption, so one
        # render covers many windows.  The walk is skipped when nothing
        # changed since the last one.
        need_walk = bool(to_render) or (
            self._walk_epoch != self._pulse_epoch
            or (not self._walk_exhausted
                and 2 * self._consumed_since_walk >= self.lookahead_pulses))
        ahead_params, ahead_keys = [], []
        if self.lookahead_pulses and need_walk:
            ahead_params, ahead_keys = self._collect_lookahead(
                base=len(to_render))

        # A window miss forces a render (taking the lookahead along);
        # ahead-only renders wait for the dispatch threshold.
        if to_render or len(ahead_params) >= self._dispatch_threshold:
            bid = self._submit(render_keys + ahead_keys,
                               to_render + ahead_params)
            if to_render:
                self._wait(bid)
        for loc, key in window:
            resp = self._resp_cache.pop(key)
            if _pending(resp):
                self._wait(resp[1])
                resp = self._resp_cache.pop(key)
            if isinstance(resp, tuple):
                continue  # span pulse: its audio is in _acc
            offset = loc - self.synthesized_sample - fft // 2 + 1
            lo = max(0, -offset)
            self.buffer[lo + offset: fft + offset] += resp[lo:]
        self._acc_emit(self.synthesized_sample, bs)
        if len(self._resp_cache) > 4 * max(self.lookahead_pulses, 64):
            self._prune_cache()
        self.synthesized_sample += bs
        # The reference calls SeekSynthesizer(synthesized_sample) here with
        # samples where seconds are expected, so it never matches a frame
        # and is a no-op (src/synthesisrealtime.cpp:601); keep that.
        return True

    def _prune_cache(self):
        """Drop stale entries: materialized rows (rendered again if a
        walk needs them) and landed span markers of pulses the stream
        has passed, whose windows were consumed.  A pending marker is
        kept: its render lands and replaces it."""
        passed = self.synthesized_sample + self.buffer_size
        for k in [k for k, v in self._resp_cache.items()
                  if isinstance(v, np.ndarray)
                  or (v[0] == "span" and v[1] < passed)]:
            del self._resp_cache[k]
        self._staged.clear()
        self._walk_epoch = -1  # force a fresh lookahead walk
