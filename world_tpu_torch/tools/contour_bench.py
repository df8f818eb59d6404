"""Time the contour-walk kernels (csrc/dio_fix.cu, csrc/harvest_contour.cu)
on the card against their plain versions and their bounds.

    python world_tpu_torch/tools/contour_bench.py [--root DIR]
        [--inputs FILE] [--out FILE]

records each wrapper's arguments from 16-row float32 batch steps of the
golden utterances (rows at gains 0.5-1.5) at 22.05 and 48 kHz, Dio's and
Harvest's, and from the first Harvest batch of 300 s of 48 kHz int16
through ``analyze_long`` (chip_smoke.py's longform_48k: 16 chunks of
6.25 s), then ``measure``s that checkout's kernels on them, one JSON line
per case.  ``--root`` imports world_tpu_torch from another checkout (for
example the parent commit, unpacked with ``git archive``), so its
kernels are timed by the same code; ``--inputs`` saves the recorded
tensors to FILE, or loads them where FILE exists, so that every checkout
is timed on the same tensors.

chip_smoke.py records each wrapper's arguments on the paths that call it
and hands them to ``measure``, which checks the kernel against its plain
version (torch.equal) and reports:
  device_ms        device time per launch (torch.profiler, ola_bench's
                   device_ms; inputs warm in L2), and cold after an L2
                   overwrite;
  ms, host_us      CUDA events around back-to-back calls; host
                   microseconds per wrapper call;
  plain_ms         the plain version (the Python loops) on the same
                   tensors, CUDA events;
  bound_ms         bytes (inputs read once, the output written once) over
                   the memory rate against this run's operations over the
                   peak rate;
  chain_bound_ms   the dependent divides on the longest chain of this
                   run's data times one dependent divide's latency on the
                   card (tools/div_chain.cu): a Dio row's SelectBestF0
                   calls (one IEEE divide each), a Harvest row's longest
                   walk plus its sections' ExtendSub means;
  step_ns          device_ms over the chain's steps (chain_divides): the
                   time per dependent step;
  library_ms       null: no single PyTorch call computes these functions.
Needs a CUDA device.
"""

import argparse
import contextlib
import ctypes
import functools
import json
import os
import sys
from pathlib import Path

import numpy as np

DIV_SRC = Path(__file__).with_name("div_chain.cu")
REPO = Path(__file__).resolve().parents[2]


def build_div():
    """Compile tools/div_chain.cu (nvcc, the kernels' flags) unless it is
    built.  Returns (library path, compiler log or None)."""
    from world_tpu_torch.ops import _cuda
    return _cuda.compile_shared(_cuda.nvcc(), _cuda.NVCC_FLAGS, DIV_SRC)


@functools.lru_cache(maxsize=None)
def div_latency_ns(torch, dtype_name, n=1 << 20, reps=5):
    """Nanoseconds per dependent IEEE divide of ``dtype_name`` on the
    card: the chain at 2n and at n divides (CUDA events, the least of
    ``reps`` each), the difference over n."""
    fn = ctypes.CDLL(str(build_div()[0])).div_chain_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, dtype=getattr(torch, dtype_name), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def best_ms(count):
        times = []
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            rc = fn(out.element_size(), out.data_ptr(), count, 3.0, stream)
            t1.record()
            if rc != 0:
                raise RuntimeError(f"div chain launch: cudaError {rc}")
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"div chain gave {float(out)}")
        return min(times)

    best_ms(n)                                   # warm-up
    return (best_ms(2 * n) - best_ms(n)) * 1e6 / n


def dio_chain_steps(step2, cands, allowed_range):
    """(most SelectBestF0 calls in one row, calls in all rows) of Dio's
    walks on these inputs, from the plain walks on the CPU."""
    from world_tpu_torch.models import dio

    s2 = step2.cpu()
    c = cands.cpu().transpose(1, 2)
    s3 = dio._fix_step3(s2, c, allowed_range)
    s4 = dio._fix_step4(s3, s2, c, allowed_range).numpy()
    s2, s3 = s2.numpy(), s3.numpy()
    per_row = []
    for r2, r3, r4 in zip(s2, s3, s4):
        voiced = r2 != 0
        n, active = 0, False
        for t in range(1, len(r2)):
            active = active or (voiced[t - 1] and not voiced[t])
            n += active
            active = active and r3[t] != 0
        active = False
        for t in range(len(r2) - 2, 0, -1):
            active = active or (not voiced[t] and voiced[t + 1])
            n += active
            active = active and r4[t] != 0
        per_row.append(int(n))
    return max(per_row, default=0), sum(per_row)


def harvest_chain_steps(step2, cands, allowed_range=0.18, cap=None):
    """(the longest chain of one row: its longest walk's steps plus its
    section count; walk steps in all rows) of Harvest's FixStep3 on these
    inputs, from the plain walks on the CPU.  A walk of n_steps that last
    hit h frames out takes min(n_steps, h + 4) steps."""
    import torch

    from world_tpu_torch.models import harvest_contour as hc

    s2, c = step2.cpu(), cands.cpu()
    B, F = s2.shape
    st, ed, count = hc._section_bounds(s2, cap)
    K = st.shape[1]
    valid = torch.arange(K) < count[:, None]
    rows = torch.arange(B)[:, None]
    st, ed = st.clamp(0, F - 1), ed.clamp(0, F - 1)
    steps = []
    for origin, last, shift in ((ed, torch.clamp(ed + 100, max=F - 2), 1),
                                (st, torch.clamp(st - 100, min=1), -1)):
        _, shifted = hc._extend(s2[rows, origin], origin, last, shift, c,
                                allowed_range)
        n = torch.minimum(torch.abs(last - origin) + 1,
                          torch.abs(shifted - origin) + 4)
        steps.append(torch.where(valid, n, torch.zeros_like(n)))
    steps = torch.stack(steps, -1).numpy()
    longest = steps.max(axis=(1, 2)) if K else np.zeros(B, int)
    chain = longest + valid.sum(1).numpy()
    return int(chain.max(initial=0)), int(steps.sum())


def measure(torch, name, args, kwargs, flush):
    """The kernel of wrapper ``name`` (ops/contour.py) on the recorded
    card tensors ``args``/``kwargs`` against its plain version, its
    times and bounds."""
    from world_tpu_torch.ops import contour
    from world_tpu_torch.tools import ola_bench as bench

    kernel = getattr(contour, name)
    plain = getattr(contour, name + "_plain")

    def run():
        return kernel(*args, **kwargs)

    got = run()
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    step2 = args[0]
    B, F = step2.shape
    elt = step2.element_size()
    dtype = str(step2.dtype).split(".")[-1]
    differs = (got != want).any(1).nonzero().flatten().tolist()
    if name == "dio_fix_walks":
        C = args[1].shape[1]
        longest, total = dio_chain_steps(*args)
        nbytes = B * F * (C + 2) * elt
        n_ops = total * (3 * C + 7)       # per call: C errors, 7 more
        divides = longest
    else:
        S = args[1].shape[2]
        cap = kwargs.get("cap")
        divides, total = harvest_chain_steps(args[0], args[1],
                                             kwargs.get("allowed_range",
                                                        0.18), cap)
        nbytes = B * F * (2 * S + 2) * elt
        # per walk step: S errors (sub, abs, divide) and compares, S frame
        # score compares; the frame-score pass: 4 per (frame, slot)
        n_ops = total * 5 * S + 4 * B * F * S
    bound_ms, bound_by = bench.bound(nbytes, n_ops, dtype)
    latency = div_latency_ns(torch, dtype)
    out = {
        "shape": [list(a.shape) for a in args if hasattr(a, "shape")],
        "dtype": dtype, "equal": bool(torch.equal(got, want)),
        "max_abs_err": float((got - want).abs().max()) if got.numel()
        else 0.0,
        "rows_differing": differs,
        "frames_differing": int((got != want).sum()),
        "device_ms": bench.device_ms(torch, run),
        "flush_cold_device_ms": bench.device_ms(torch, run, flush=flush),
        "ms": bench.event_ms(torch, run),
        "host_us": bench.host_us(torch, run, reps=20),
        "plain_ms": bench.event_ms(torch, lambda: plain(*args, **kwargs),
                                   2),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "operations": n_ops, "chain_divides": divides,
        "div_latency_ns": latency,
        "chain_bound_ms": divides * latency * 1e-6,
        "library_ms": None, "library_device_ms": None, "step_ns": None,
    }
    if divides and out["device_ms"] is not None:
        out["step_ns"] = out["device_ms"] * 1e6 / divides
    return out


@contextlib.contextmanager
def recording(recorded):
    """Within the block, the first call of each contour wrapper from the
    F0 stages leaves its (args, kwargs) in ``recorded[wrapper name]``."""
    from world_tpu_torch.models import dio, harvest_contour

    patched = [(m, n, getattr(m, n)) for m, n in (
        (dio, "dio_fix_walks"), (harvest_contour, "harvest_fix_step3"))]
    for module, name, real in patched:
        def record(*args, _name=name, _real=real, **kwargs):
            recorded.setdefault(_name, (args, kwargs))
            return _real(*args, **kwargs)
        setattr(module, name, record)
    try:
        yield recorded
    finally:
        for module, name, real in patched:
            setattr(module, name, real)


def longform_int16(seconds=300.0, fs=48000, seed=20261016):
    """chip_smoke.py's longform_48k signal (bench.py:217-225): the 48 kHz
    golden utterance tiled to ``seconds``, as int16 at a level in 0.4-0.8
    drawn from ``seed``."""
    x48 = np.fromfile(REPO / "tests" / "goldens_fs48" / "x.f64")
    n = int(seconds * fs)
    base = np.tile(x48, -(-n // len(x48)))[:n]
    scale = 0.4 + 0.4 * np.random.default_rng(seed).random()
    return (np.clip(base * scale, -0.999, 0.999) * 32767).astype(np.int16)


def path_calls(torch, record, methods=("dio", "harvest")):
    """{case: what the context ``record(recorded)`` (this module's
    recording, or iir_bench's) recorded} on the card, for the float32
    batch steps of 16 rows of the golden utterances at gains 0.5-1.5
    (``{method}_22k``, ``{method}_48k``; no synthesis) and, where Harvest
    is among ``methods``, analyze_long on longform_int16()
    (harvest_longform)."""
    from world_tpu_torch.parallel import analyze_long, pipeline

    cases = {}
    for tag, gold, fs in (("22k", "goldens", 22050),
                          ("48k", "goldens_fs48", 48000)):
        x = np.fromfile(REPO / "tests" / gold / "x.f64")
        xb = (x[None] * np.linspace(0.5, 1.5, 16)[:, None]).astype(
            np.float32)
        for method in methods:
            with record({}) as rec:
                pipeline.make_batch_step(fs, xb.shape[1], f0_method=method,
                                         with_synthesis=False,
                                         device="cuda")(xb)
            cases[f"{method}_{tag}"] = rec
    if "harvest" in methods:
        with record({}) as rec:
            analyze_long(longform_int16(), 48000, chunk_seconds=6.25,
                         f0_method="harvest", codec_dims=64,
                         batch_lanes=16, device="cuda")
        cases["harvest_longform"] = rec
    torch.cuda.synchronize()
    return cases


def record_inputs(torch):
    """{case: (wrapper name, args, kwargs)} on the card: the calls of
    path_calls' batch steps (dio_22k, harvest_22k, dio_48k, harvest_48k)
    and long-form batch (harvest_longform)."""
    cases = {}
    for case, rec in path_calls(torch, recording).items():
        name = "dio_fix_walks" if case.startswith("dio") else (
            "harvest_fix_step3")
        cases[case] = (name, *rec[name])
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import world_tpu_torch from")
    ap.add_argument("--inputs", default=None,
                    help="save the recorded tensors here, or load them")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("contour_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or REPO)
    sys.path.insert(0, root)
    import world_tpu_torch
    if Path(world_tpu_torch.__file__).resolve().parents[1] != Path(root):
        print("contour_bench: --root needs the script form, python "
              "world_tpu_torch/tools/contour_bench.py", file=sys.stderr)
        return 2
    from world_tpu_torch.tools import ola_bench as bench

    if args.inputs and os.path.exists(args.inputs):
        saved = torch.load(args.inputs)
        cases = {k: (name, [a.cuda() if torch.is_tensor(a) else a
                            for a in a_], kw)
                 for k, (name, a_, kw) in saved.items()}
    else:
        cases = record_inputs(torch)
        if args.inputs:
            torch.save({k: (name, [a.cpu() if torch.is_tensor(a) else a
                                   for a in a_], kw)
                        for k, (name, a_, kw) in cases.items()},
                       args.inputs)
    card = bench.card_name()
    flush = bench.l2_flush(torch)
    with open(args.out, "a") if args.out else contextlib.nullcontext() as f:
        for case, (name, a_, kw) in cases.items():
            line = json.dumps({"root": root, "card": card, "case": case,
                               "wrapper": name,
                               **measure(torch, name, a_, kw, flush)})
            print(line, flush=True)
            if f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
