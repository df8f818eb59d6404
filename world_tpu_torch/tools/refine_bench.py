"""Time Harvest's refinement kernels (csrc/refine.cu: harvest_refine and
harvest_remove_unreliable) on the card against their plain versions and
their bounds.

    python world_tpu_torch/tools/refine_bench.py [--root DIR]
        [--inputs FILE] [--remove-only] [--sass] [--longform]
        [--out FILE]

records the refinement wrapper's arguments from 16-row float32 Harvest
batch steps of the golden utterances (rows at gains 0.5-1.5) at 22.05 and
48 kHz and from the first Harvest batch of 300 s of 48 kHz int16 through
``analyze_long`` (contour_bench.path_calls), and the kernel's outputs
there (the reliability pass's inputs), then ``measure``s the refinement
and ``measure_remove``s the reliability pass on them, one JSON line per
case (the reliability pass also on the first row in float64, the shape
of the float64 exact path's; ``--remove-only`` times it alone).
``--root`` imports world_tpu_torch from another checkout (for example
the parent commit, unpacked with ``git archive``; the script
form only), so that its kernels, or a checkout's eager pass where it has
no remove kernel, are timed by the same code; ``--inputs`` saves the
recorded tensors to FILE, or loads them where FILE exists, so that every
checkout is timed on the same tensors.  ``--sass`` counts the
instructions of each kernel in the checkout's build (cuobjdump -sass)
and reads its registers and spills (``sass_counts``);
``--longform`` times analyze_long on that 300 s signal after a warm-up:
wall s, audio seconds per wall second, peak device memory.

chip_smoke.py records the wrappers' arguments on the paths that call them
and hands them to ``measure`` and ``measure_remove``, which hold each
kernel to its plain version (``compare`` at ``GATES``; the remove kernel
torch.equal) and report:
  device_ms        device time per launch (torch.profiler, ola_bench's
                   device_ms; inputs warm in L2), and cold after an L2
                   overwrite; CUDA events where the profiler's traces
                   did not hold every launch, as ``device_ms_read``
                   ("profiler" or "cuda events") says;
  ms, host_us      CUDA events around back-to-back calls; host
                   microseconds per wrapper call;
  plain_ms         the plain version on the same tensors, CUDA events;
  bound_ms         the refinement: this run's operations (OPS_PER_TERM
                   float32 operations for each (pair, j) term of the
                   usable pairs' windows) over the peak float32 rate,
                   against the bytes (y, positions, cands and the phase
                   table read once, two outputs written once) over the
                   memory rate; the remove pass: its bytes (two inputs
                   read once, two outputs written once);
  bound_share      bound_ms / device_ms;
  library_ms       null: no single PyTorch call computes these functions.
Needs a CUDA device.
"""

import argparse
import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
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
# SASS opcode prefixes --sass counts: IEEE float32 division checks (one a
# division) and reciprocal seeds, square-root seeds, float64 multiplies
# (sincos), shuffles, shared-memory loads and stores, spill loads and
# stores, calls (slow paths), warp reductions.
SASS_CLASSES = ("FCHK", "MUFU.RCP", "MUFU.RSQ", "DFMA", "DMUL", "SHFL",
                "LDS", "STS", "LDL", "STL", "CALL", "REDUX")
# float64 SASS opcodes: the float64 pipe's arithmetic and comparisons
# (besides these, every opcode with .F64, a conversion, counts as one).
F64_PREFIXES = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET")


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
            "bit_equal": bool(torch.equal(r, pr) and torch.equal(s, ps)),
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


def timed(torch, fn, flush, plain=None, plain_reps=2):
    """Device ms (warm and cold; CUDA events where the profiler gave
    none, as ``device_ms_read`` says), event ms, host us, plain ms of
    ``fn``."""
    from world_tpu_torch.tools import ola_bench as bench

    ms = bench.event_ms(torch, fn)
    warm = bench.device_ms(torch, fn)
    cold = bench.device_ms(torch, fn, flush=flush)
    return {"device_ms": ms if warm is None else warm,
            "device_ms_read": "cuda events" if warm is None else "profiler",
            "flush_cold_device_ms": cold, "ms": ms,
            "host_us": bench.host_us(torch, fn, reps=20),
            "plain_ms": bench.event_ms(torch, plain, plain_reps)
            if plain else None}


def measure(torch, args, kwargs, flush):
    """The refinement kernel on the recorded card tensors
    ``args``/``kwargs`` against its plain version: the comparison, times
    and bound."""
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
               **timed(torch, run, flush, plain),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               library_device_ms=None)
    out["bound_share"] = bound_ms / out["device_ms"]
    return out


def measure_remove(torch, args, flush):
    """The reliability pass on the recorded card tensors ``args``
    (cands, scores): the remove kernel against its plain version
    (torch.equal, NaN where the plain version has NaN), or, in a
    checkout without the kernel, that checkout's eager pass
    (models/harvest.py: _remove_unreliable); times, the bytes bound and
    the pass's device memory past its inputs and outputs."""
    from world_tpu_torch.ops import refine
    from world_tpu_torch.tools import ola_bench as bench

    cands, scores = args
    kernel = hasattr(refine, "remove_unreliable")
    if kernel:
        def run():
            return refine.remove_unreliable(cands, scores)

        def plain():
            return refine.remove_unreliable_plain(cands, scores)
    else:
        from world_tpu_torch.models import harvest

        def run():
            return harvest._remove_unreliable(cands, scores)
        plain = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = run()
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base - sum(
        t.numel() * t.element_size() for t in got)
    out = {"what": "kernel" if kernel else "eager pass",
           "shape": list(cands.shape), "dtype": str(cands.dtype),
           "temp_bytes": temp}
    if kernel:
        want = plain()
        out["equal"] = all(
            torch.equal(g.isnan(), w.isnan())
            and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
            for g, w in zip(got, want))
        out["max_abs_err"] = 0.0 if out["equal"] else float(max(
            (g - w).abs().nan_to_num().max() for g, w in zip(got, want)))
        out["zeroed"] = int(((cands != 0) & (got[0] == 0)).sum())
    nbytes = 4 * cands.numel() * cands.element_size()
    bound_ms, bound_by = bench.bound(nbytes, 0, "float32")
    out.update(timed(torch, run, flush, plain), bytes=nbytes,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               library_device_ms=None)
    out["bound_share"] = bound_ms / out["device_ms"]
    return out


@contextlib.contextmanager
def recording(recorded):
    """Within the block, the first call from Harvest of the refinement
    wrapper and of the reliability pass's leave their (args, kwargs) in
    ``recorded["harvest_refine"]`` and ``recorded["remove_unreliable"]``;
    the wrappers still count their launches.  (A checkout without the
    remove wrapper records the refinement only.)"""
    from world_tpu_torch.models import harvest

    names = [n for n in ("harvest_refine", "remove_unreliable")
             if hasattr(harvest, n)]
    real = {n: getattr(harvest, n) for n in names}

    def recorder(name):
        def record(*args, **kwargs):
            recorded.setdefault(name, (args, kwargs))
            return real[name](*args, **kwargs)
        return record

    for n in names:
        setattr(harvest, n, recorder(n))
    try:
        yield recorded
    finally:
        for n in names:
            setattr(harvest, n, real[n])


def record_inputs(torch):
    """{case: {"harvest_refine": (args, kwargs), "remove": (cands,
    scores)}} on the card: the refinement's arguments in path_calls' float32
    Harvest runs, and its outputs there (what the reliability pass
    takes)."""
    from world_tpu_torch.ops import refine
    from world_tpu_torch.tools import contour_bench

    cases = {}
    for case, rec in contour_bench.path_calls(
            torch, recording, methods=("harvest",)).items():
        args, kwargs = rec["harvest_refine"]
        cases[case] = {"harvest_refine": rec["harvest_refine"],
                       "remove": refine.harvest_refine(*args, **kwargs)}
    torch.cuda.synchronize()
    return cases


def _moved(torch, obj, device):
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_moved(torch, o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _moved(torch, v, device) for k, v in obj.items()}
    return obj


def _opcodes(sass):
    """{function: [opcode, ...]} of cuobjdump -sass output."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and name:
            out[name].append(m.group(1))
    return out


def _ptxas(log):
    """{function: {"registers", "stack", "spill_stores", "spill_loads"}}
    from nvcc -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_counts(root, source="refine", probe=None):
    """{function: counts} of the checkout ``root``'s csrc/<source>.cu
    built for sm_90a with the source's flags: ptxas's registers, stack
    and spills (-Xptxas -v), and from cuobjdump -sass every instruction,
    the opcode prefixes SASS_CLASSES and the float64 instructions
    (F64_PREFIXES, and every conversion to or from float64).  ``probe``
    is the text of another .cu file, ``{source}`` in it standing for the
    source's path (to #include it); it is built with the same flags and
    its extern "C" functions are counted too.  A build that fails raises
    RuntimeError with nvcc's log."""
    from world_tpu_torch.ops import _cuda

    src = Path(root) / "world_tpu_torch" / "csrc" / f"{source}.cu"
    flags = [f for f in _cuda.NVCC_FLAGS + _cuda.SOURCE_FLAGS.get(source, ())
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cuobjdump = str(Path(_cuda.nvcc()).with_name("cuobjdump"))
    out = {}
    with tempfile.TemporaryDirectory() as td:
        builds = [(src, False)]
        if probe is not None:
            path = Path(td) / "probe.cu"
            path.write_text(probe.replace("{source}", str(src)))
            builds.append((path, True))
        for path, is_probe in builds:
            cubin = Path(td) / f"{path.stem}.cubin"
            proc = subprocess.run([_cuda.nvcc(), *flags, "-cubin", "-o",
                                   str(cubin), str(path)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {path.name}:\n{proc.stderr}")
            sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                                  check=True, capture_output=True,
                                  text=True).stdout
            ptxas = _ptxas(proc.stdout + proc.stderr)
            for fn, ops in _opcodes(sass).items():
                if is_probe and fn.startswith("_Z"):
                    continue  # the source's own functions, built again
                c = collections.Counter(instructions=len(ops))
                for op in ops:
                    if op.startswith(F64_PREFIXES) or ".F64" in op:
                        c["float64"] += 1
                    c.update(cls for cls in SASS_CLASSES
                             if op.startswith(cls))
                out[fn] = dict(ptxas.get(fn, {}), **c)
    return out


def longform(torch, seconds=300.0):
    """analyze_long of contour_bench.longform_int16(seconds) (Harvest,
    6.25 s chunks, codec 64, 16 a batch) after one warm-up run: wall s,
    audio s per wall s, peak device memory."""
    import time

    from world_tpu_torch.parallel import analyze_long
    from world_tpu_torch.tools.contour_bench import longform_int16

    x = longform_int16(seconds, 48000)

    def run():
        analyze_long(x, 48000, chunk_seconds=6.25, f0_method="harvest",
                     codec_dims=64, batch_lanes=16, device="cuda")
        torch.cuda.synchronize()

    run()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    return {"audio_s": seconds, "wall_s": wall, "rtf": seconds / wall,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import world_tpu_torch from")
    ap.add_argument("--inputs", default=None,
                    help="save the recorded tensors here, or load them")
    ap.add_argument("--sass", action="store_true",
                    help="also count the kernels' SASS instructions")
    ap.add_argument("--longform", action="store_true",
                    help="also time analyze_long on 300 s of 48 kHz")
    ap.add_argument("--remove-only", action="store_true",
                    help="time only the reliability pass")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("refine_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or REPO)
    sys.path.insert(0, root)
    import world_tpu_torch
    if Path(world_tpu_torch.__file__).resolve().parents[1] != Path(root):
        print("refine_bench: --root needs the script form, python "
              "world_tpu_torch/tools/refine_bench.py", file=sys.stderr)
        return 2
    from world_tpu_torch.tools import ola_bench as bench

    if args.inputs and os.path.exists(args.inputs):
        cases = _moved(torch, torch.load(args.inputs), "cuda")
    else:
        cases = record_inputs(torch)
        if args.inputs:
            torch.save(_moved(torch, cases, "cpu"), args.inputs)
    card = bench.card_name()
    flush = bench.l2_flush(torch)
    lines = []
    for case, rec in cases.items():
        line = {"root": root, "card": card, "case": case}
        if not args.remove_only:
            line.update(measure(torch, *rec["harvest_refine"], flush))
        # The float32 call, and its first row in float64: the float64 exact
        # path's (1, F, M) shape.
        line["remove"] = measure_remove(torch, rec["remove"], flush)
        line["remove_row0_f64"] = measure_remove(
            torch, [t[:1].double() for t in rec["remove"]], flush)
        lines.append(line)
    if args.sass:
        lines.append({"root": root, "card": card, "sass": sass_counts(root)})
    if args.longform:
        lines.append({"root": root, "card": card,
                      "longform_48k": longform(torch)})
    with open(args.out, "a") if args.out else contextlib.nullcontext() as f:
        for line in lines:
            text = json.dumps(line)
            print(text, flush=True)
            if f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
