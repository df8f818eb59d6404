"""world_tpu_torch: the WORLD vocoder on PyTorch and CUDA (port of the
JAX package world_tpu, which stays the reference).

Ported so far: Dio, StoneMask, Harvest, CheapTrick, D4C, Synthesis, the
streaming synthesizer, the codec, wav/parameter I/O, the batched step,
long-form analysis/synthesis, the corpus runner and the command-line
tools.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no device given and no GPU they raise.  The overlap-add of synthesis is a hand-written
CUDA kernel (csrc/ola.cu), built with nvcc at first use.

    dio, stone_mask, harvest           -- F0 estimation / refinement
    cheap_trick                        -- spectral envelope
    d4c                                -- band aperiodicity
    synthesis                          -- waveform synthesis
    StreamingSynthesizer               -- real-time (streaming) synthesis
    code_/decode_spectral_envelope, code_/decode_aperiodicity
    analyze / synthesize               -- full pipeline conveniences
    make_batch_step / get_batch_step   -- batched analysis + synthesis
    parallel.analyze_long / synthesize_long  -- long-form audio
    io.audio / io.parameterio          -- wav and parameter files
    io.native                          -- threaded wav batch loader (g++)
    utils.corpus                       -- corpus runners (checkpoint/resume)
    utils.distributed / utils.profiling  -- process groups, traces
    tools (python -m world_tpu_torch.tools)  -- the reference examples
"""

__version__ = "0.1.0"

import dataclasses

import torch

from . import io  # noqa: F401  (world_tpu_torch.io.audio / .parameterio)
from .config import (CheapTrickOption, D4COption, DioOption, HarvestOption,
                     get_f0_floor_for_cheaptrick, get_fft_size_for_cheaptrick,
                     get_number_of_aperiodicities, get_samples_for_dio,
                     get_samples_for_harvest)
from .device import as_tensor, resolve_device
from .models.cheaptrick import cheap_trick
from .models.codec import (code_aperiodicity, code_spectral_envelope,
                           decode_aperiodicity, decode_spectral_envelope)
from .models.d4c import d4c
from .models.dio import dio
from .models.harvest import harvest
from .models.realtime import StreamingSynthesizer
from .models.stonemask import stone_mask
from .models.synthesis import synthesis
from .parallel.pipeline import get_batch_step, make_batch_step

__all__ = [
    "dio", "stone_mask", "harvest", "cheap_trick", "d4c", "synthesis",
    "StreamingSynthesizer", "code_aperiodicity", "decode_aperiodicity",
    "code_spectral_envelope", "decode_spectral_envelope",
    "DioOption", "HarvestOption", "CheapTrickOption", "D4COption",
    "analyze", "synthesize", "WorldParameters",
    "make_batch_step", "get_batch_step",
    "get_fft_size_for_cheaptrick", "get_f0_floor_for_cheaptrick",
    "get_number_of_aperiodicities", "get_samples_for_dio",
    "get_samples_for_harvest",
]


@dataclasses.dataclass
class WorldParameters:
    """Analysis result: the three WORLD parameters plus metadata."""
    temporal_positions: torch.Tensor
    f0: torch.Tensor
    spectrogram: torch.Tensor
    aperiodicity: torch.Tensor
    fs: int
    frame_period: float
    fft_size: int


def analyze(x, fs, frame_period=5.0, f0_method="harvest", rng_mode="exact",
            f0_option=None, device=None):
    """Full analysis: F0 -> spectral envelope -> aperiodicity.

    f0_method: "harvest" (quality, the reference test.cpp default) or
    "dio" (fast; refined with StoneMask).  f0_option optionally overrides
    the HarvestOption/DioOption (its frame_period is forced to
    ``frame_period``).
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    if f0_method == "harvest":
        opt = f0_option or HarvestOption()
        tp, f0 = harvest(x, fs, dataclasses.replace(
            opt, frame_period=frame_period), device=dev)
    elif f0_method == "dio":
        opt = f0_option or DioOption()
        tp, f0 = dio(x, fs, dataclasses.replace(
            opt, frame_period=frame_period), device=dev)
        f0 = stone_mask(x, fs, tp, f0, device=dev)
    else:
        raise ValueError(f0_method)
    option = CheapTrickOption().resolve(fs)
    sp = cheap_trick(x, fs, tp, f0, option, rng_mode=rng_mode, device=dev)
    ap = d4c(x, fs, tp, f0, option.fft_size, rng_mode=rng_mode, device=dev)
    return WorldParameters(tp, f0, sp, ap, fs, frame_period,
                           option.fft_size)


def synthesize(params, y_length=None, rng_mode="exact", device=None):
    """Resynthesize a waveform from WorldParameters."""
    return synthesis(params.f0, params.spectrogram, params.aperiodicity,
                     params.fs, params.frame_period, y_length=y_length,
                     fft_size=params.fft_size, rng_mode=rng_mode,
                     device=device)
