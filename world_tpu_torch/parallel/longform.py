"""Long-form audio: chunked analysis with halos, and streaming synthesis
(port of world_tpu/parallel/longform.py).

The reference FFTs the whole signal inside Dio and Harvest, which does
not scale to hour-long 48 kHz audio.  Long waveforms are cut into equal
chunks padded with an analysis halo on each side, every chunk is one row
of the port's batched analysis stages (the ones make_batch_step runs:
Dio -> StoneMask or Harvest -> CheapTrick -> D4C, then the codec when
``codec_dims`` is set), and each chunk's frame grid is aligned to the
global grid, so stitching is slicing.  Chunking and stitching are host
numpy, as in the JAX package.  Chunking approximates whole-signal
analysis at the halo level; the default 0.45 s halo covers Harvest's
longest influence radius (world_tpu/parallel/longform.py explains the
budget), and tests/test_torch_longform.py holds chunked against
whole-signal away from chunk edges.

Rows run in batches of ``batch_lanes``; at most two batches are in
flight ahead of the host copy of their results (pinned memory, CUDA
events), so device memory grows with the batch, not with the signal.
On a mesh (parallel.pipeline.make_mesh) the chunk rows ride 'data': each
batch is padded to a multiple of n_data, run through the sharded step,
gathered, and stitched on every rank.

Long parameter tracks are synthesized through StreamingSynthesizer
(reference src/synthesisrealtime.cpp), which carries the pulse phase
across chunk boundaries exactly.
"""

import collections
import math

import numpy as np
import torch

from .. import config
from ..device import download, upload
from ..models.realtime import StreamingSynthesizer
from .pipeline import get_batch_step, run_global, step_device

# Batches dispatched ahead of the host copy of their results.
IN_FLIGHT = 2


class _Batch:
    """A dispatched batch's results on their way to the host."""

    def __init__(self, outs, dev):
        self.host, self.event = download(outs, dev)

    def result(self):
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def analyze_long(x, fs, *, frame_period=5.0, chunk_seconds=8.0,
                 halo_seconds=0.45, f0_method="harvest", rng_mode="fast",
                 mesh=None, codec_dims=None, batch_lanes=None, device=None):
    """Analyze arbitrarily long audio in fixed-size halo-padded chunks on
    ``device`` (the GPU unless given).

    Returns numpy (temporal_positions, f0, sp, ap) covering the whole
    signal on the global frame grid.  ``codec_dims`` codes sp/ap on the
    device (sp as (frames, codec_dims) mel-cepstrum, ap as coarse bands).
    ``batch_lanes`` runs the chunk rows in batches of that size (all in
    one batch when unset).  int16 input goes to the device as int16 and is
    converted there to float32 (exact /2**15, the wavread scaling);
    float32 input runs in float32, anything else in float64.  With
    ``mesh``, every rank calls it with the same signal and gets the whole
    result; the device is the mesh's."""
    dev = step_device(mesh, device)
    x = np.asarray(x)
    n = len(x)
    fp_s = frame_period / 1000.0
    n_frames = config.get_samples_for_dio(fs, n, frame_period)

    halo_f = int(math.ceil(halo_seconds / fp_s))
    core_f = max(1, int(round(chunk_seconds / fp_s)))
    local_f = core_f + 2 * halo_f
    # chunk samples cover the last local frame's analysis window too
    chunk_len = int(math.ceil((local_f - 1) * fp_s * fs)) + 1
    if config.get_samples_for_dio(fs, chunk_len, frame_period) != local_f:
        raise ValueError(f"a chunk of {chunk_len} samples does not give "
                         f"{local_f} frames at {fs} Hz")

    n_chunks = max(1, int(math.ceil(n_frames / core_f)))
    starts_f = np.arange(n_chunks) * core_f - halo_f     # global frame idx
    start_samples = np.round(starts_f * fp_s * fs).astype(np.int64)

    chunks = np.zeros((n_chunks, chunk_len), x.dtype)
    for c, s0 in enumerate(start_samples):
        lo, hi = max(0, s0), min(n, s0 + chunk_len)
        if hi > lo:
            chunks[c, lo - s0: hi - s0] = x[lo:hi]

    int_in = x.dtype == np.int16
    dtype = torch.float32 if (x.dtype == np.float32 or int_in) \
        else torch.float64
    step = get_batch_step(fs, chunk_len, frame_period=frame_period,
                          rng_mode=rng_mode, mesh=mesh, f0_method=f0_method,
                          with_synthesis=False, codec_dims=codec_dims,
                          device=dev)

    def run(rows):
        if int_in:
            xb = upload(rows, torch.int16, dev).to(torch.float32) / 32768.0
        else:
            xb = upload(rows, dtype, dev)
        return _Batch(run_global(step, xb, mesh)[:3], dev)

    lanes = batch_lanes if batch_lanes else n_chunks
    parts, inflight = [], collections.deque()
    for b0 in range(0, n_chunks, lanes):
        if len(inflight) == IN_FLIGHT:
            parts.append(inflight.popleft().result())
        inflight.append(run(chunks[b0: b0 + lanes]))
    parts.extend(b.result() for b in inflight)
    f0c, spc, apc = (np.concatenate([p[i] for p in parts])
                     for i in range(3))

    # Stitch: core frames only.
    f0 = np.zeros(n_frames, f0c.dtype)
    sp = np.zeros((n_frames, spc.shape[2]), spc.dtype)
    ap = np.zeros((n_frames, apc.shape[2]), apc.dtype)
    for c in range(n_chunks):
        g0 = c * core_f
        g1 = min(n_frames, g0 + core_f)
        l0 = g0 - starts_f[c]                    # == halo_f except chunk 0
        f0[g0:g1] = f0c[c, l0: l0 + g1 - g0]
        sp[g0:g1] = spc[c, l0: l0 + g1 - g0]
        ap[g0:g1] = apc[c, l0: l0 + g1 - g0]

    tp = np.arange(n_frames) * fp_s
    return tp, f0, sp, ap


def synthesize_long(f0, sp, ap, fs, *, frame_period=5.0, buffer_size=4096,
                    frames_per_push=512, rng_mode="fast", device=None):
    """Synthesize a long parameter track chunk by chunk through the
    streaming synthesizer on ``device`` (the GPU unless given): exact
    pulse-phase handoff across chunks.  float32 sp runs in float32,
    anything else in float64.  Returns the waveform (numpy)."""
    f0 = np.asarray(f0)
    sp = np.asarray(sp)
    ap = np.asarray(ap)
    fft_size = 2 * (sp.shape[1] - 1)
    out = []
    with StreamingSynthesizer(
            fs, frame_period, fft_size, buffer_size, number_of_pointers=16,
            rng_mode=rng_mode,
            dtype=np.float32 if sp.dtype == np.float32 else np.float64,
            device=device) as synth:
        n_frames = len(f0)
        pushed = 0
        while True:
            pushed0 = pushed
            while (pushed < n_frames
                   and synth.add_parameters(
                       f0[pushed: pushed + frames_per_push],
                       sp[pushed: pushed + frames_per_push],
                       ap[pushed: pushed + frames_per_push])):
                pushed += frames_per_push
            progressed = False
            while synth.synthesis2():
                out.append(synth.buffer[:buffer_size].copy())
                progressed = True
            if pushed >= n_frames and not progressed:
                break
            if not progressed and pushed == pushed0:
                # No frames accepted and no samples rendered: the stream
                # is wedged (is_locked() covers the queue-full case; this
                # also catches any other stall) -- stop, do not spin.
                break
    return np.concatenate(out) if out else np.zeros(0)
