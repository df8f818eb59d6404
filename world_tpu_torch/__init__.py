"""world_tpu_torch: the WORLD vocoder on PyTorch and CUDA (port of the
JAX package world_tpu, which stays the reference).

This slice covers the main path, Harvest -> CheapTrick -> D4C ->
Synthesis, plus the batched step.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; with no device given and no GPU they
raise.  The overlap-add of synthesis is a hand-written CUDA kernel
(csrc/ola.cu), built with nvcc at first use.

    harvest                            -- F0 estimation
    cheap_trick                        -- spectral envelope
    d4c                                -- band aperiodicity
    synthesis                          -- waveform synthesis
    analyze / synthesize               -- full pipeline conveniences
    make_batch_step / get_batch_step   -- batched analysis + synthesis
"""

__version__ = "0.1.0"

import dataclasses

import torch

from .config import (CheapTrickOption, D4COption, HarvestOption,
                     get_f0_floor_for_cheaptrick, get_fft_size_for_cheaptrick,
                     get_number_of_aperiodicities, get_samples_for_harvest)
from .device import as_tensor, resolve_device
from .models.cheaptrick import cheap_trick
from .models.d4c import d4c
from .models.harvest import harvest
from .models.synthesis import synthesis
from .parallel.pipeline import get_batch_step, make_batch_step

__all__ = [
    "harvest", "cheap_trick", "d4c", "synthesis",
    "HarvestOption", "CheapTrickOption", "D4COption",
    "analyze", "synthesize", "WorldParameters",
    "make_batch_step", "get_batch_step",
    "get_fft_size_for_cheaptrick", "get_f0_floor_for_cheaptrick",
    "get_number_of_aperiodicities", "get_samples_for_harvest",
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

    f0_method: "harvest" (the reference test.cpp default; "dio" lands in
    a later slice of the port).  f0_option optionally overrides the
    HarvestOption (its frame_period is forced to ``frame_period``).
    """
    if f0_method != "harvest":
        raise NotImplementedError(f"f0_method={f0_method!r} is not ported "
                                  "yet")
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    opt = f0_option or HarvestOption()
    tp, f0 = harvest(x, fs, dataclasses.replace(opt,
                                                frame_period=frame_period),
                     device=dev)
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
