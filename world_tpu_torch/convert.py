"""Carry the JAX package's analysis output across to the port.

There are no learned weights; what crosses over is an analysis: the
JAX package's (temporal_positions, f0, spectrogram, aperiodicity) as
numpy arrays become the port's WorldParameters.
"""

import numpy as np

from . import WorldParameters
from .device import as_tensor, resolve_device


def world_parameters_from_numpy(tp, f0, sp, ap, fs, frame_period, fft_size,
                                device=None):
    """numpy analysis arrays -> WorldParameters on ``device`` (the GPU
    unless given).  Dtypes are kept; the envelope's dtype rules."""
    dev = resolve_device(device)
    sp = np.asarray(sp)
    if sp.shape[-1] != fft_size // 2 + 1:
        raise ValueError(f"spectrogram has {sp.shape[-1]} bins, fft_size "
                         f"{fft_size} needs {fft_size // 2 + 1}")
    sp_t = as_tensor(sp, dev)
    return WorldParameters(
        temporal_positions=as_tensor(tp, dev, sp_t.dtype),
        f0=as_tensor(f0, dev, sp_t.dtype),
        spectrogram=sp_t,
        aperiodicity=as_tensor(ap, dev, sp_t.dtype),
        fs=int(fs), frame_period=float(frame_period),
        fft_size=int(fft_size))
