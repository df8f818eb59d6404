"""Batched analysis + synthesis step (port of
world_tpu/parallel/pipeline.py).

Utterances are padded/bucketed to fixed lengths on the host and run as
one batch: Dio -> StoneMask (or Harvest) -> CheapTrick -> D4C -> codec
-> Synthesis, each stage batched over the utterances.  The device mesh
is a later slice of the port; asking for it raises NotImplementedError.
"""

import numpy as np
import torch

from .. import config
from ..device import StageClock, as_tensor, resolve_device
from ..models.cheaptrick import cheap_trick_batch
from ..models.codec import (code_aperiodicity_batch,
                            code_spectral_envelope_batch)
from ..models.d4c import d4c_batch
from ..models.dio import dio_batch
from ..models.harvest import harvest_batch
from ..models.stonemask import stone_mask_batch
from ..models.synthesis import synthesis_batch


def pad_and_bucket(waveforms, bucket_sizes):
    """Pad ragged utterances to the smallest admissible bucket length.

    Returns a dict bucket_length -> (stacked float32 array, lengths,
    indices), so each bucket runs as one batch shape.
    """
    buckets = {}
    for i, w in enumerate(waveforms):
        n = len(w)
        for b in sorted(bucket_sizes):
            if n <= b:
                buckets.setdefault(b, []).append((i, w))
                break
        else:
            raise ValueError(f"utterance {i} longer than largest bucket")
    out = {}
    for b, items in buckets.items():
        arr = np.zeros((len(items), b), np.float32)
        lengths = np.zeros(len(items), np.int32)
        idx = []
        for row, (i, w) in enumerate(items):
            arr[row, : len(w)] = w
            lengths[row] = len(w)
            idx.append(i)
        out[b] = (arr, lengths, np.asarray(idx))
    return out


def make_batch_step(fs, x_length, frame_period=5.0, rng_mode="fast",
                    mesh=None, f0_method="dio", with_synthesis=True,
                    codec_dims=None, device=None):
    """Build a batched analysis(+synthesis) step on ``device`` (the GPU
    unless given).

    Returns step(x_batch (B, x_length), timings=None) ->
    (f0 (B,F), sp (B,F,K), ap (B,F,K), y (B,y_length) or None).
    f0_method "dio" refines Dio's track with StoneMask; "harvest" runs
    Harvest.  With ``codec_dims`` set, sp and ap leave the step coded:
    sp as (B,F,codec_dims) mel-cepstrum, ap as (B,F,n_aper) coarse dB
    bands (synthesis still uses the full tensors).  with_synthesis=False
    skips resynthesis and returns y=None.  The batch's dtype rules
    (float32 is the production path).  Given a dict as ``timings``, the
    step synchronizes around each stage and records its wall
    milliseconds under the stage's name (parts of a stage as
    "<stage>.<part>").
    """
    if f0_method not in ("dio", "harvest"):
        raise ValueError(f"f0_method {f0_method!r}")
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet")
    dev = resolve_device(device)
    option = config.CheapTrickOption().resolve(fs)
    fft_size = option.fft_size
    f0_length = config.get_samples_for_dio(fs, x_length, frame_period)
    y_length = int((f0_length - 1) * frame_period / 1000.0 * fs) + 1

    def f0_stage(x, clock):
        if f0_method == "harvest":
            with clock("harvest"):
                tp, f0 = harvest_batch(x, fs, frame_period,
                                       config.K_FLOOR_F0, config.K_CEIL_F0,
                                       clock=clock)
            return tp.expand_as(f0), f0
        with clock("dio"):
            tp, f0 = dio_batch(x, fs, frame_period, config.K_FLOOR_F0,
                               config.K_CEIL_F0, channels_in_octave=2.0,
                               speed=1, allowed_range=0.1, clock=clock)
        tp = tp.expand_as(f0)
        with clock("stonemask"):
            f0 = stone_mask_batch(x, fs, tp, f0)
        return tp, f0

    def step(x_batch, timings=None):
        x = as_tensor(x_batch, dev)
        if x.dim() != 2 or x.shape[1] != x_length:
            raise ValueError(f"expected (B, {x_length}), got "
                             f"{tuple(x.shape)}")
        clock = StageClock(timings, dev)
        tp, f0 = f0_stage(x, clock)
        with clock("cheaptrick"):
            sp = cheap_trick_batch(x, tp, f0, fs, fft_size, q1=option.q1,
                                   rng_mode=rng_mode)
        with clock("d4c"):
            ap = d4c_batch(x, tp, f0, fs, fft_size,
                           threshold=config.K_THRESHOLD, rng_mode=rng_mode)
        sp_out, ap_out = sp, ap
        if codec_dims is not None:
            with clock("codec"):
                sp_out = code_spectral_envelope_batch(sp, fs, fft_size,
                                                      codec_dims)
                ap_out = code_aperiodicity_batch(ap, fs, fft_size)
        y = None
        if with_synthesis:
            with clock("synthesis"):
                y = synthesis_batch(f0, sp, ap, fs, frame_period, y_length,
                                    fft_size, rng_mode=rng_mode)
        return f0, sp_out, ap_out, y

    return step


_STEP_CACHE = {}
# A leak backstop for long-lived processes sweeping many shapes.
_STEP_CACHE_MAX = 64


def get_batch_step(fs, x_length, frame_period=5.0, rng_mode="fast",
                   mesh=None, f0_method="dio", with_synthesis=True,
                   codec_dims=None, device=None):
    """Memoized make_batch_step."""
    dev = resolve_device(device)
    key = (fs, x_length, frame_period, rng_mode, mesh, f0_method,
           with_synthesis, codec_dims, str(dev))
    if key not in _STEP_CACHE:
        while len(_STEP_CACHE) >= _STEP_CACHE_MAX:
            _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
        _STEP_CACHE[key] = make_batch_step(
            fs, x_length, frame_period=frame_period, rng_mode=rng_mode,
            mesh=mesh, f0_method=f0_method, with_synthesis=with_synthesis,
            codec_dims=codec_dims, device=dev)
    return _STEP_CACHE[key]


def corpus_metrics(f0_batch, lengths, fs, frame_period):
    """Corpus-level reductions of a batch: voiced frames, mean F0 over
    them, audio seconds.  Returns 0-dim tensors."""
    f0_batch = torch.as_tensor(f0_batch)
    voiced = f0_batch > 0
    n_voiced = voiced.sum()
    return {
        "voiced_frames": n_voiced,
        "mean_f0": torch.where(voiced, f0_batch,
                               torch.zeros_like(f0_batch)).sum()
        / n_voiced.clamp(min=1),
        "audio_seconds": torch.as_tensor(lengths).sum().to(torch.float64)
        / fs,
    }
