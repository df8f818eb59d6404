"""Time StoneMask's float32 refinement kernel (csrc/stonemask.cu:
stonemask_refine) on the card against its plain version and its bounds.

    python world_tpu_torch/tools/stonemask_bench.py [--root DIR]
        [--inputs FILE] [--sass] [--out FILE]

records the wrapper's arguments from 16-row float32 Dio batch steps of
the golden utterances (rows at gains 0.5-1.5) at 22.05 and 48 kHz
(contour_bench.path_calls: dio_22k, dio_48k) and from the first batch of
chip_smoke.py's corpus (corpus_batched: ``corpus_first_batch``), and
``measure``s the kernel on them, one JSON line per case, with the
kernel's launches in its step and the launch's shape (``launch_shape``).
``--root`` imports world_tpu_torch from another checkout (for example
the parent commit, unpacked with ``git archive``; the script form only),
so that its kernel is timed by the same code; ``--inputs`` saves the
recorded tensors to FILE, or loads them where FILE exists, so that every
checkout is timed on the same tensors.  ``--sass`` reports the
kernel's registers and spills (ptxas) and SASS instruction counts, and
those of ``term_probe``, one (bin, sample) term (TERM_PROBE), whose
float64 instructions are a term's (refine_bench.sass_counts).

chip_smoke.py records the wrapper's arguments on the paths that call it
and hands them to ``measure``, which holds the kernel to its plain
version (``compare`` at ``GATES``) and reports:
  device_ms        device time per launch (torch.profiler, ola_bench's
                   device_ms; inputs warm in L2), and cold after an L2
                   overwrite; CUDA events where the profiler's traces
                   did not hold every launch, as ``device_ms_read`` says;
  ms, host_us      CUDA events around back-to-back calls; host
                   microseconds per wrapper call;
  plain_ms         the plain version on the same tensors, CUDA events;
  bound_ms         this run's operations over the peak float32 rate
                   (WINDOW_OPS for each sample of a usable frame's window,
                   BIN_OPS for each (bin, sample) term of its passes: 2
                   bins, and 6 more where the first pass holds; each cos
                   or sincos counted as TRIG_OPS), against the bytes (x,
                   positions and f0 read once, the output written once)
                   over the memory rate;
  bound_share      bound_ms / device_ms;
  library_ms       null: no single PyTorch call computes this function.
Needs a CUDA device (``seeded_frames`` and ``glide``, the tests' inputs,
are numpy only).
"""

import argparse
import contextlib
import ctypes
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]

# float32 operations a window sample costs: its index time (3), the two
# Blackman angles (4), the window (4), its difference (2) and the two
# products with the sample (2); and each (bin, sample) term: the phase
# product and the 4 dots' multiply-adds (9).
WINDOW_OPS = 15
BIN_OPS = 9
# A cos or a sincos counted as 20 float32 operations: the range
# reduction and polynomial of a float32 evaluation (an estimate; the
# kernel takes them in float64, which the bound does not charge).
TRIG_OPS = 20
# The kernel against its plain version on the card: VUV equal on every
# frame and F0 within f0_rel (the port's gate against JAX).  Both sum in
# one order, so they part only where a float64 cos / sin of the kernel
# (its own polynomials) and of torch round to different float32s; on
# every recorded call they were bit-equal (PERF.md).
GATES = {"f0_rel": 1e-6}
# One (bin, sample) term as the kernel computes it, built beside the
# source by --sass (refine_bench.sass_counts' probe): its float64
# instructions are a term's.  A source without sincos_once fails to build.
TERM_PROBE = """
#include "{source}"
extern "C" __global__ void term_probe(const float* a, const float* m,
                                      const float* d, float* acc) {
  const int t = threadIdx.x;
  float s, c;
  sincos_once(a[t], &s, &c);
  acc[4 * t] += c * m[t];
  acc[4 * t + 1] += s * m[t];
  acc[4 * t + 2] += c * d[t];
  acc[4 * t + 3] += s * d[t];
}
"""


def glide(fs, seed, seconds=1.0):
    """A seeded voiced signal whose pitch glides from 42 Hz to fs / 12.5
    (log), with its pitch at each sample; a silent stretch at 45-50%."""
    rs = np.random.RandomState(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    pitch = 42.0 * (fs / 12.5 / 42.0) ** (t / seconds)
    phase = 2 * np.pi * np.cumsum(pitch) / fs
    n_harm = np.maximum(1, np.minimum(10, (fs / 2 / pitch).astype(int) - 1))
    x = sum(np.where(h <= n_harm, np.sin(h * phase + rs.uniform(0, 6.3)),
                     0.0) / h for h in range(1, 11))
    x = 0.3 * x + 1e-3 * rs.randn(n)
    x[int(0.45 * n):int(0.5 * n)] = 0.0
    return x.astype(np.float32), pitch


def seeded_frames(fs, seed=0, n=160):
    """(x, pos, f0) of one row: frames along the glide at F0s 2% about
    its pitch; frames whose F0 sits on an fft-size boundary (hw = 2^k,
    where fft doubles) and the float32 values beside it; windows clamped
    at both signal edges; frames inside the silent stretch (the last
    three)."""
    rs = np.random.RandomState(seed + 100)
    x, pitch = glide(fs, seed)
    L = len(x)
    idx = rs.randint(0, L, n)
    pos = list(idx / fs)
    f0 = list(pitch[idx] * (1.0 + 0.02 * rs.randn(n)))
    for k in range(3, 12):
        f_b = np.float32(1.5 * fs / (2 ** k - 1))
        if not 40.0 < f_b <= fs / 12.0:
            continue
        at = np.argmin(np.abs(pitch - f_b)) / fs
        for f in (np.nextafter(f_b, np.float32(0)), f_b,
                  np.nextafter(f_b, np.float32(1e9))):
            pos.append(at)
            f0.append(f)
    for p in (-0.004, 0.0, 0.002, (L - 1) / fs, L / fs + 0.004):
        pos.append(p)
        f0.append(pitch[min(max(int(p * fs), 0), L - 1)])
    for p in (0.465, 0.47, 0.475):
        pos.append(p)
        f0.append(150.0)
    return x, np.array(pos, np.float32), np.array(f0, np.float32)


def compare(got, want):
    """Statistics of the kernel's output ``got`` against the plain
    version's ``want`` (tensors of one shape, any device)."""
    import torch

    both = (got > 0) & (want > 0)
    rel = (got[both] / want[both] - 1.0).abs()
    return {"shape": list(got.shape), "voiced": int((want > 0).sum()),
            "vuv_differ": int(((got > 0) != (want > 0)).sum()),
            "frames_differ": int((got != want).sum()),
            "f0_rel_max": float(rel.max()) if both.any() else 0.0,
            "bit_equal": bool(torch.equal(got, want)),
            "max_abs_err": float((got - want).abs().max())
            if got.numel() else 0.0}


def within_gates(stats):
    return (stats["vuv_differ"] == 0
            and stats["f0_rel_max"] <= GATES["f0_rel"])


def work(args):
    """(bytes, operations, frames, samples) of one call on these
    arguments: the usable frames' windows (win_len in float32 as the
    kernel takes it), their first pass's 2 bins and, where the first
    pass holds (the plain version's refine_frames says), the second's 6."""
    import torch

    from world_tpu_torch.ops import stonemask

    x, positions, f0, fs_t, _ = args
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
    return nbytes, ops, int(rows.numel()), samples


def measure(torch, args, kwargs, flush):
    """The kernel on the recorded card tensors ``args``/``kwargs``
    against its plain version: the comparison, times and bound."""
    from world_tpu_torch.ops import stonemask
    from world_tpu_torch.tools import ola_bench as bench
    from world_tpu_torch.tools.refine_bench import timed

    def run():
        return stonemask.stonemask_refine(*args, **kwargs)

    def plain():
        return stonemask.stonemask_refine_plain(*args, **kwargs)

    got, want = run(), plain()
    torch.cuda.synchronize()
    stats = compare(got, want)
    nbytes, n_ops, frames, samples = work(args)
    bound_ms, bound_by = bench.bound(nbytes, n_ops, "float32")
    out = dict(stats, within_gates=within_gates(stats), gates=GATES,
               usable_frames=frames, window_samples=samples,
               max_len=args[4], bytes=nbytes, operations=n_ops,
               **timed(torch, run, flush, plain),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               library_device_ms=None)
    out["bound_share"] = bound_ms / out["device_ms"]
    return out


@contextlib.contextmanager
def recording(recorded):
    """Within the block, the first call from StoneMask of the wrapper
    leaves its (args, kwargs) in ``recorded["stonemask_refine"]``, and
    the kernel launches of all its calls add up in
    ``recorded["stonemask_launches"]``; the wrapper still counts its
    launches."""
    from world_tpu_torch.models import stonemask

    real = stonemask.stonemask_refine

    def record(*args, **kwargs):
        recorded.setdefault("stonemask_refine", (args, kwargs))
        before = real.launches
        out = real(*args, **kwargs)
        recorded["stonemask_launches"] = (
            recorded.get("stonemask_launches", 0) + real.launches - before)
        return out

    stonemask.stonemask_refine = record
    try:
        yield recorded
    finally:
        stonemask.stonemask_refine = real


def corpus_first_batch():
    """The first batch chip_smoke.py's corpus runner dispatches (its
    sorted first bucket, 22.05 kHz at 2 s): batch_invariance's
    corpus_signals' first 16 files at 22.05 kHz of at most 44,100
    samples, as 16-bit wavs store them, zero rows past the last, (16,
    44100) float32."""
    from world_tpu_torch.tools.batch_invariance import (
        BATCH, BUCKETS, as_wav_samples, corpus_signals)

    fs = 22050
    b = int(np.ceil(BUCKETS[0] * fs))
    rows = np.zeros((BATCH, b), np.float32)
    picked = [x for f, x in corpus_signals() if f == fs and len(x) <= b]
    for j, x in enumerate(picked[:BATCH]):
        rows[j, :len(x)] = as_wav_samples(x)
    return fs, rows


def record_inputs(torch):
    """{case: {"call": (args, kwargs), "launches": n}} on the card: the
    wrapper's arguments in path_calls' float32 Dio steps (dio_22k,
    dio_48k) and in the Dio step of the corpus's first batch
    (corpus_batched), and the kernel's launches in each step."""
    from world_tpu_torch.parallel import pipeline
    from world_tpu_torch.tools import contour_bench

    recs = contour_bench.path_calls(torch, recording, methods=("dio",))
    fs, rows = corpus_first_batch()
    with recording({}) as rec:
        pipeline.make_batch_step(fs, rows.shape[1], f0_method="dio",
                                 with_synthesis=False, device="cuda")(rows)
    recs["corpus_batched"] = rec
    cases = {case: {"call": rec["stonemask_refine"],
                    "launches": rec["stonemask_launches"]}
             for case, rec in recs.items()}
    torch.cuda.synchronize()
    return cases


def launch_shape(torch, shape, device):
    """The kernel's launch for (B, F) = ``shape`` frames on the CUDA
    ``device`` as its source's stonemask_launch_shape gives it: warps a
    block, resident blocks an SM, resident warps an SM, the SMs, the
    grid's blocks."""
    from world_tpu_torch.ops import _cuda

    fn = _cuda.entry("stonemask", "stonemask_launch_shape",
                     (ctypes.c_int,) * 2 + (ctypes.POINTER(ctypes.c_int),) * 4)
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        rc = fn(*shape, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"stonemask_launch_shape: cudaError {rc}")
    warps, per_sm, sms, blocks = (v.value for v in vals)
    return {"warps_per_block": warps, "blocks_per_sm": per_sm,
            "warps_per_sm": warps * per_sm, "sms": sms, "blocks": blocks}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import world_tpu_torch from")
    ap.add_argument("--inputs", default=None,
                    help="save the recorded tensors here, or load them")
    ap.add_argument("--sass", action="store_true",
                    help="also count the kernel's SASS instructions")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("stonemask_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or REPO)
    sys.path.insert(0, root)
    import world_tpu_torch
    if Path(world_tpu_torch.__file__).resolve().parents[1] != Path(root):
        print("stonemask_bench: --root needs the script form, python "
              "world_tpu_torch/tools/stonemask_bench.py", file=sys.stderr)
        return 2
    from world_tpu_torch.tools import ola_bench as bench
    from world_tpu_torch.tools.refine_bench import _moved, sass_counts

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
        call_args, kwargs = rec["call"]
        lines.append({"root": root, "card": card, "case": case,
                      "launches_per_step": rec["launches"],
                      "launch": launch_shape(torch, call_args[2].shape,
                                             call_args[2].device),
                      **measure(torch, call_args, kwargs, flush)})
    if args.sass:
        lines.append({"root": root, "card": card, "sass": sass_counts(
            root, "stonemask", probe=TERM_PROBE)})
    with open(args.out, "a") if args.out else contextlib.nullcontext() as f:
        for line in lines:
            text = json.dumps(line)
            print(text, flush=True)
            if f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
