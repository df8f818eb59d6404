"""Time Harvest's float32 refinement kernel (csrc/refine.cu) on the card
against its plain version and its bound.

    python world_tpu_torch/tools/refine_bench.py [--out FILE]

records the wrapper's arguments from 16-row float32 Harvest batch steps
of the golden utterances (rows at gains 0.5-1.5) at 22.05 and 48 kHz and
from the first Harvest batch of 300 s of 48 kHz int16 through
``analyze_long`` (contour_bench.path_calls), then ``measure``s the kernel
on them, one JSON line per case.

chip_smoke.py records the wrapper's arguments on the paths that call it
and hands them to ``measure``, which holds the kernel to its plain
version (``compare``, ``GATES``) and reports:
  device_ms        device time per launch (torch.profiler, ola_bench's
                   device_ms; inputs warm in L2), and cold after an L2
                   overwrite;
  ms, host_us      CUDA events around back-to-back calls; host
                   microseconds per wrapper call;
  plain_ms         the plain version (tensor ops over chunks of pairs) on
                   the same tensors, CUDA events;
  bound_ms         this run's operations (OPS_PER_TERM float32 operations
                   for each (pair, j) term of the usable pairs' windows)
                   over the peak float32 rate, against the bytes (y,
                   positions, cands and the phase table read once, two
                   outputs written once) over the memory rate;
  bound_share      bound_ms / device_ms (ms where the profiler gave
                   none);
  library_ms       null: no single PyTorch call computes this function.
Needs a CUDA device.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# float32 operations of one (pair, j) term: the window and its mirror
# (cos a cos(jd) -+ sin a sin(jd): 6; two Blackman sums: 14), the
# difference window (4), the four folds (8) and the 6 harmonics' 4 dot
# multiply-adds (48).  The float64 cos / sin of the window's angle and
# the table reads are not counted.
OPS_PER_TERM = 80
# The kernel against its plain version.  Both sum in one order, so they
# can part only where a float64 cosine of the card and one of the host
# round to different float32s: surviving masks equal except where a
# score is within ``margin`` (relative) of 2.5 or an F0 of a range limit;
# F0 and score relative errors where both survive.
GATES = {"margin": 1e-4, "f0_rel": 1e-5, "score_rel": 1e-3}


def compare(got, want, f0_floor, f0_ceil):
    """Statistics of the kernel's (refined, scores) ``got`` against the
    plain version's ``want`` (tensors of one shape, any device)."""
    import torch

    (r, s), (pr, ps) = got, want
    live, plain_live = r > 0, pr > 0
    differ = live != plain_live
    m = GATES["margin"]

    def marginal(f0, score):
        return (((score - 2.5).abs() <= m * 2.5)
                | ((f0 - f0_floor).abs() <= m * abs(f0_floor))
                | ((f0 - f0_ceil).abs() <= m * abs(f0_ceil)))

    # A pair one version keeps and the other drops, excused by the values
    # of the version that keeps it.
    excused = (live & marginal(r, s)) | (plain_live & marginal(pr, ps))
    both = live & plain_live
    zero = torch.zeros((), dtype=r.dtype, device=r.device)

    def rel(a, b):
        return (a[both] / b[both] - 1.0).abs().max() if both.any() else zero

    return {"shape": list(r.shape), "survivors": int(plain_live.sum()),
            "masks_differ": int(differ.sum()),
            "masks_differ_unexcused": int((differ & ~excused).sum()),
            "f0_rel_max": float(rel(r, pr)),
            "score_rel_max": float(rel(s, ps)),
            "max_abs_err": float((r[both] - pr[both]).abs().max())
            if both.any() else 0.0}


def within_gates(stats):
    return (stats["masks_differ_unexcused"] == 0
            and stats["f0_rel_max"] <= GATES["f0_rel"]
            and stats["score_rel_max"] <= GATES["score_rel"])


def work(args):
    """(bytes, operations, terms) of one call on these arguments: the
    terms are the usable pairs' min(hw, hw_max) + 1, hw in float32 as
    the kernel takes it."""
    import torch

    from world_tpu_torch.ops import refine

    y, positions, cands, fs_t, _, _, hw_max = args
    f0 = cands[cands > 0.0]
    fs = torch.full((), fs_t, dtype=torch.float32, device=f0.device)
    hw = (1.5 * fs / f0 + 1.0).to(torch.int64).clamp(max=hw_max)
    terms = int((hw + 1).sum())
    table = 2 << refine.table_log2(hw_max)
    nbytes = 4 * (y.numel() + positions.numel() + 3 * cands.numel() + table)
    return nbytes, terms * OPS_PER_TERM, terms


def measure(torch, args, kwargs, flush):
    """The kernel on the recorded card tensors ``args``/``kwargs`` against
    its plain version: the comparison, times and bound."""
    from world_tpu_torch.ops import refine
    from world_tpu_torch.tools import ola_bench as bench

    def run():
        return refine.harvest_refine(*args, **kwargs)

    def plain():
        return refine.harvest_refine_plain(*args, **kwargs)

    got, want = run(), plain()
    torch.cuda.synchronize()
    stats = compare(got, want, args[4], args[5])
    nbytes, n_ops, terms = work(args)
    bound_ms, bound_by = bench.bound(nbytes, n_ops, "float32")
    out = dict(stats, within_gates=within_gates(stats), gates=GATES,
               pairs=int((args[2] > 0).sum()), hw_max=args[6],
               terms=terms, bytes=nbytes, operations=n_ops,
               device_ms=bench.device_ms(torch, run),
               flush_cold_device_ms=bench.device_ms(torch, run, flush=flush),
               ms=bench.event_ms(torch, run),
               host_us=bench.host_us(torch, run, reps=20),
               plain_ms=bench.event_ms(torch, plain, 2),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               library_device_ms=None)
    # the profiler's device time, or the events' where it gave none
    out["bound_share"] = bound_ms / (out["device_ms"] or out["ms"])
    return out


@contextlib.contextmanager
def recording(recorded):
    """Within the block, the first call of the refinement wrapper from
    Harvest leaves its (args, kwargs) in ``recorded["harvest_refine"]``;
    the wrapper still counts its launches."""
    from world_tpu_torch.models import harvest

    real = harvest.harvest_refine

    def record(*args, **kwargs):
        recorded.setdefault("harvest_refine", (args, kwargs))
        return real(*args, **kwargs)

    harvest.harvest_refine = record
    try:
        yield recorded
    finally:
        harvest.harvest_refine = real


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("refine_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from world_tpu_torch.tools import contour_bench
    from world_tpu_torch.tools import ola_bench as bench

    cases = contour_bench.path_calls(torch, recording, methods=("harvest",))
    card = bench.card_name()
    flush = bench.l2_flush(torch)
    with open(args.out, "a") if args.out else contextlib.nullcontext() as f:
        for case, rec in cases.items():
            line = json.dumps({"card": card, "case": case, **measure(
                torch, *rec["harvest_refine"], flush)})
            print(line, flush=True)
            if f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
