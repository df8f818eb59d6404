"""Batched analysis + synthesis step (port of
world_tpu/parallel/pipeline.py).

Utterances are padded/bucketed to fixed lengths on the host and run as
one batch: Harvest -> CheapTrick -> D4C -> Synthesis, each stage batched
over the utterances.  Dio, the on-device codec and the device mesh are
later slices of the port; asking for them raises NotImplementedError.
"""

import numpy as np

from .. import config
from ..device import StageClock, as_tensor, resolve_device
from ..models.cheaptrick import cheap_trick_batch
from ..models.d4c import d4c_batch
from ..models.harvest import harvest_batch
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
                    mesh=None, f0_method="harvest", with_synthesis=True,
                    codec_dims=None, device=None):
    """Build a batched analysis(+synthesis) step on ``device`` (the GPU
    unless given).

    Returns step(x_batch (B, x_length), timings=None) ->
    (f0 (B,F), sp (B,F,K), ap (B,F,K), y (B,y_length) or None).
    The batch's dtype rules (float32 is the production path).  Given a
    dict as ``timings``, the step synchronizes around each stage and
    records its wall milliseconds under the stage's name (Harvest's parts
    as "harvest.<part>").
    """
    if f0_method != "harvest":
        raise NotImplementedError(f"f0_method={f0_method!r} is not ported "
                                  "yet")
    if codec_dims is not None:
        raise NotImplementedError("codec_dims is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet")
    dev = resolve_device(device)
    option = config.CheapTrickOption().resolve(fs)
    fft_size = option.fft_size
    f0_length = config.get_samples_for_harvest(fs, x_length, frame_period)
    y_length = int((f0_length - 1) * frame_period / 1000.0 * fs) + 1

    def step(x_batch, timings=None):
        x = as_tensor(x_batch, dev)
        if x.dim() != 2 or x.shape[1] != x_length:
            raise ValueError(f"expected (B, {x_length}), got "
                             f"{tuple(x.shape)}")
        clock = StageClock(timings, dev)
        with clock("harvest"):
            tp, f0 = harvest_batch(x, fs, frame_period, config.K_FLOOR_F0,
                                   config.K_CEIL_F0, clock=clock)
            tp = tp.expand_as(f0)
        with clock("cheaptrick"):
            sp = cheap_trick_batch(x, tp, f0, fs, fft_size, q1=option.q1,
                                   rng_mode=rng_mode)
        with clock("d4c"):
            ap = d4c_batch(x, tp, f0, fs, fft_size,
                           threshold=config.K_THRESHOLD, rng_mode=rng_mode)
        y = None
        if with_synthesis:
            with clock("synthesis"):
                y = synthesis_batch(f0, sp, ap, fs, frame_period, y_length,
                                    fft_size, rng_mode=rng_mode)
        return f0, sp, ap, y

    return step


_STEP_CACHE = {}
# A leak backstop for long-lived processes sweeping many shapes.
_STEP_CACHE_MAX = 64


def get_batch_step(fs, x_length, frame_period=5.0, rng_mode="fast",
                   mesh=None, f0_method="harvest", with_synthesis=True,
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
