"""A plain reference for analyze_long's stitching, shared by
tests/test_torch_longform.py (CPU) and tests/test_torch_cuda.py (card):
each batch's step outputs recorded as analyze_long makes them, joined by
np.concatenate and sliced into zero-filled outputs chunk by chunk.
Imports neither jax nor the JAX package.
"""

import math

import numpy as np

from world_tpu_torch.parallel import longform


def record_steps(monkeypatch):
    """Make analyze_long record each batch's (f0, sp, ap) step outputs, as
    host numpy copies, into the returned list."""
    seen = []
    real = longform.run_global

    def recorded(step, xb, mesh):
        out = real(step, xb, mesh)
        seen.append([t.detach().cpu().numpy().copy() for t in out[:3]])
        return out

    monkeypatch.setattr(longform, "run_global", recorded)
    return seen


def plain_stitch(seen, n_frames, frame_period=5.0, chunk_seconds=8.0,
                 halo_seconds=0.45):
    """(f0, sp, ap) over the global frames: the recorded batches joined,
    and each chunk's core frames sliced into zero-filled outputs."""
    fp_s = frame_period / 1000.0
    halo_f = int(math.ceil(halo_seconds / fp_s))
    core_f = max(1, int(round(chunk_seconds / fp_s)))
    joined = [np.concatenate([p[i] for p in seen]) for i in range(3)]
    outs = [np.zeros((n_frames,) + j.shape[2:], j.dtype) for j in joined]
    for c in range(joined[0].shape[0]):
        g0, g1 = c * core_f, min(n_frames, (c + 1) * core_f)
        for o, j in zip(outs, joined):
            o[g0:g1] = j[c, halo_f: halo_f + g1 - g0]
    return outs
