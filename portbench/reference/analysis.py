"""One row of the batch step, in the reference: the stages that
world_tpu_torch.parallel.pipeline.make_batch_step runs, for a single
padded row (a row's outputs depend on that row alone: the step shares
its fast-mode draws across rows)."""

import numpy as np
import torch

from .world import config
from .world.models.cheaptrick import cheap_trick_batch
from .world.models.codec import (code_aperiodicity_batch,
                                 code_spectral_envelope_batch)
from .world.models.d4c import d4c_batch
from .world.models.dio import dio_batch
from .world.models.harvest import harvest_batch
from .world.models.stonemask import stone_mask_batch
from .world.models.synthesis import synthesis_batch

FRAME_PERIOD = 5.0


def fft_size(fs):
    return config.CheapTrickOption().resolve(fs).fft_size


def y_length(fs, x_length):
    f0_length = config.get_samples_for_dio(fs, x_length, FRAME_PERIOD)
    return int((f0_length - 1) * FRAME_PERIOD / 1000.0 * fs) + 1


def f0_track(x, fs, method):
    """(temporal positions (1, F), f0 (1, F)) of the padded row ``x``
    (1, L): Harvest's, or Dio's refined by StoneMask."""
    if method == "harvest":
        tp, f0 = harvest_batch(x, fs, FRAME_PERIOD, config.K_FLOOR_F0,
                               config.K_CEIL_F0)
        return tp.expand_as(f0), f0
    tp, f0 = dio_batch(x, fs, FRAME_PERIOD, config.K_FLOOR_F0,
                       config.K_CEIL_F0, channels_in_octave=2.0, speed=1,
                       allowed_range=0.1)
    tp = tp.expand_as(f0)
    return tp, stone_mask_batch(x, fs, tp, f0)


def envelopes(x, f0, fs, codec_dims=None, rng_mode="fast"):
    """(sp, ap) of the row ``x`` (1, L) on the track ``f0`` (1, F), and
    their coded forms (None without ``codec_dims``)."""
    option = config.CheapTrickOption().resolve(fs)
    # The step's time axis, as Dio and Harvest make it: host float64
    # i * 5 / 1000, cast once to the row's type.
    tp = torch.as_tensor(np.arange(f0.shape[1], dtype=np.float64)
                         * FRAME_PERIOD / 1000.0, dtype=x.dtype,
                         device=x.device)[None]
    sp = cheap_trick_batch(x, tp, f0, fs, option.fft_size, q1=option.q1,
                           rng_mode=rng_mode)
    ap = d4c_batch(x, tp, f0, fs, option.fft_size,
                   threshold=config.K_THRESHOLD, rng_mode=rng_mode)
    if codec_dims is None:
        return sp, ap, None
    coded = (code_spectral_envelope_batch(sp, fs, option.fft_size,
                                          codec_dims),
             code_aperiodicity_batch(ap, fs, option.fft_size))
    return sp, ap, coded


def synthesize(f0, sp, ap, fs, x_length, rng_mode="fast"):
    """The step's synthesis of (1, F) f0 and (1, F, K) sp / ap."""
    return synthesis_batch(f0, sp, ap, fs, FRAME_PERIOD,
                           y_length(fs, x_length), fft_size(fs),
                           rng_mode=rng_mode)
