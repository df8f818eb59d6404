"""Frozen work counts and the roofline arithmetic (copies of
world_tpu_torch/tools/ola_bench.py:bound, refine_bench.py:work and
stonemask_bench.py:work as of the commit that added this benchmark; the
helpers they call come from the frozen reference copy).  A roofline share
is the least time the work needs on the card, the larger of operations
over the peak rate and bytes over the peak bandwidth (``peaks.json``),
over the device time that did it."""

import json
from pathlib import Path

import torch

from .reference.world.ops import refine, stonemask

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())

# float32 operations of one (pair, j) term of Harvest's refinement: the
# window and its mirror (6), two Blackman sums (14), the difference window
# (4), the four folds (8) and the 6 harmonics' 4 dot multiply-adds (48).
# The float64 cos / sin of the window's angle and the table reads are not
# counted.
OPS_PER_TERM = 80
# StoneMask: a window sample's index time (3), Blackman angles (4), window
# (4), difference (2) and products with the sample (2); each (bin, sample)
# term's phase product and 4 dots' multiply-adds (9); a cos or sincos as
# 20 float32 operations.
WINDOW_OPS = 15
BIN_OPS = 9
TRIG_OPS = 20


def bound_s(nbytes, n_ops, dtype="float32"):
    """The least seconds ``nbytes`` and ``n_ops`` need on the card."""
    return max(nbytes / PEAKS["bytes_per_s"],
               n_ops / PEAKS["ops_per_s"][dtype])


def harvest_refine(y, positions, cands, fs_t, f0_floor, f0_ceil, hw_max):
    """(bytes, operations) of one refinement call on these arguments, and
    of the reliability pass after it (its two inputs read and two outputs
    written once): the terms are the usable pairs' min(hw, hw_max) + 1,
    hw in float32 as the kernel takes it."""
    f0 = cands[cands > 0.0]
    fs = torch.full((), fs_t, dtype=torch.float32, device=f0.device)
    hw = (1.5 * fs / f0 + 1.0).to(torch.int64).clamp(max=hw_max)
    terms = int((hw + 1).sum())
    table = 2 << refine.table_log2(hw_max)
    nbytes = 4 * (y.numel() + positions.numel() + 3 * cands.numel() + table)
    nbytes += 4 * 4 * cands.numel()
    return nbytes, terms * OPS_PER_TERM


def stonemask_refine(x, positions, f0, fs_t, max_len):
    """(bytes, operations) of one StoneMask refinement call: the usable
    frames' windows (win_len in float32), their first pass's 2 bins and,
    where the first pass holds (the plain version's refine_frames says),
    the second's 6."""
    fs = torch.full((), fs_t, dtype=torch.float32, device=f0.device)
    rows, frames = stonemask.usable_frames(f0, fs).nonzero(as_tuple=True)
    f0_u = f0[rows, frames]
    win_len = 2 * (1.5 * fs / f0_u + 1.0).to(torch.int64) + 1
    _, bad = stonemask.refine_frames(x, rows, positions[rows, frames], f0_u,
                                     fs)
    samples = int(win_len.sum())
    bins = 2 * samples + 6 * int(win_len[~bad].sum())
    ops = samples * (WINDOW_OPS + 2 * TRIG_OPS) + bins * (BIN_OPS + TRIG_OPS)
    nbytes = 4 * (x.numel() + 3 * f0.numel())
    return nbytes, ops
