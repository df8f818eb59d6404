"""F0 contour walks: csrc/dio_fix.cu, csrc/harvest_contour.cu and their
plain versions.

``dio_fix_walks(step2 (B, F), cands (B, C, F), allowed_range)``
    Dio's FixStep3 then FixStep4 (src/dio.cpp:215-253): the forward
    re-selection from each voiced->unvoiced boundary of ``step2``, then
    the backward one from each unvoiced->voiced boundary, both picking
    among the C band candidates of each frame.  ``cands`` is read in the
    (B, C, F) layout that models/dio.py's band stage makes.
``harvest_fix_step3(step2 (B, F), cands (B, F, S), scores (B, F, S),
allowed_range=0.18, cap=None)``
    Harvest's FixStep3 (src/harvest.cpp:791-995): every voiced section
    of ``step2`` extended both ways (ExtendF0), the long-enough ones kept
    (ExtendSub), and the kept ones merged in start order (MergeF0).
    ``cap`` keeps the first ``cap`` sections only.

The JAX package runs these walks as device loops (lax.scan and
lax.while_loop in world_tpu/models/dio.py:155-203 and
world_tpu/models/harvest_contour.py:114-306); the plain versions are the
port's loops over frames and sections (models/dio.py,
models/harvest_contour.py), which launch kernels at every step.  Each
kernel runs one whole walk per row in one launch; csrc/ describes their
designs.

On a CUDA tensor each wrapper launches its kernel (always; there is no
fallback): a build or launch failure raises.  On a CPU tensor it runs the
plain version.  The kernels equal the plain versions bit for bit, with
one exception the Harvest kernel's source sets out: it sums ExtendSub's
spans and MergeF0's scores in frame order (the reference's), where the
plain version uses torch.sum, so the two can part only where such a sum
decides a comparison to within its rounding.
"""

import ctypes

import torch


_DTYPES = (torch.float32, torch.float64)
WALK_STEPS = 101      # ExtendF0's steps: a 100-frame threshold, inclusive


def _on_card(step2, *rest):
    """Checks common to the wrappers."""
    if step2.dtype not in _DTYPES:
        raise TypeError(f"step2 must be float32/float64, got {step2.dtype}")
    if step2.dim() != 2:
        raise ValueError(f"step2 must be (B, F), got {tuple(step2.shape)}")
    for t in rest:
        if t.dtype != step2.dtype:
            raise TypeError(f"dtypes differ: {t.dtype} and {step2.dtype}")
        if t.device != step2.device:
            raise ValueError("inputs on different devices")


def dio_fix_walks_plain(step2, cands, allowed_range):
    """The plain version: models/dio.py's frame loops."""
    from ..models import dio
    cands_bfc = cands.transpose(1, 2)
    step3 = dio._fix_step3(step2, cands_bfc, allowed_range)
    return dio._fix_step4(step3, step2, cands_bfc, allowed_range)


def dio_fix_walks(step2, cands, allowed_range):
    """Dio's FixStep3 + FixStep4 of ``step2`` (B, F) from the band
    candidates ``cands`` (B, C, F).  Returns (B, F)."""
    _on_card(step2, cands)
    B, F = step2.shape
    if cands.dim() != 3 or cands.shape[0] != B or cands.shape[2] != F:
        raise ValueError(f"shapes: step2 {tuple(step2.shape)}, cands "
                         f"{tuple(cands.shape)} (want (B, C, F))")
    return dio_fix_walks_plain(step2, cands, allowed_range)


def harvest_fix_step3_plain(step2, cands, scores, allowed_range=0.18,
                            cap=None):
    """The plain version: models/harvest_contour.py's loops."""
    from ..models import harvest_contour
    return harvest_contour._fix_step3(step2, cands, scores, allowed_range,
                                      cap=cap)


def section_capacity(n_frames, cap=None):
    """Sections a row of ``n_frames`` can hold (voiced runs inside frames
    1..F-2 with a gap between), or ``cap`` if smaller; at least 1."""
    most = max((n_frames + 1) // 2, 1)
    return most if cap is None else max(min(cap, most), 1)


def harvest_scratch(n_frames, kmax):
    """(int32 elements, float elements) of one row's scratch, in the
    layout csrc/harvest_contour.cu reads: the section count, K and a
    counter of frame groups, then seven section lists of ``kmax``; two
    walks' values and frame scores per section, the sections' span sums,
    and four frame rows."""
    return 3 + 7 * kmax, (4 * WALK_STEPS + 1) * kmax + 4 * n_frames


def harvest_fix_step3(step2, cands, scores, allowed_range=0.18, cap=None):
    """Harvest's FixStep3 of ``step2`` (B, F) from the candidates and
    scores (B, F, S).  Returns (B, F)."""
    _on_card(step2, cands, scores)
    B, F = step2.shape
    for name, t in (("cands", cands), ("scores", scores)):
        if t.dim() != 3 or t.shape[:2] != (B, F):
            raise ValueError(f"shapes: step2 {tuple(step2.shape)}, {name} "
                             f"{tuple(t.shape)} (want (B, F, S))")
    if cands.shape != scores.shape or cands.shape[2] == 0:
        raise ValueError(f"cands {tuple(cands.shape)} and scores "
                         f"{tuple(scores.shape)}: want the same (B, F, S), "
                         f"S > 0")
    if cap is not None and cap < 1:
        raise ValueError(f"cap must be a positive int or None, got {cap}")
    return harvest_fix_step3_plain(step2, cands, scores, allowed_range,
                                   cap)


