"""Time the IIR kernels (csrc/iir.cu: iir_zero_phase, lti_state_scan) and
the RNG span kernel (csrc/xorshift.cu: randn_span) on the card against
their plain versions and their bounds, and the default entry points that
run them.

    python world_tpu_torch/tools/iir_bench.py [--root DIR] [--reps 3]
        [--kernels] [--out FILE]

times ``W.analyze(x, fs)`` then ``W.synthesize(p)`` with their defaults
(float64, Harvest, the reference RNG, on the card) on the golden
utterances at 22.05 and 48 kHz: wall seconds of ``--reps`` synchronized
calls after one discarded, the real-time factor of their median, and the
top-level torch calls of one call (a TorchFunctionMode's count), one
JSON line a rate.  ``--kernels`` also times iir_zero_phase and
randn_span on every call those runs and one float64 exact Harvest batch
step of 16 rows at each rate make, and lti_state_scan on the first call
of each state size in the float32 Harvest paths of
contour_bench.path_calls (the batch step of 16 rows at each rate, and
chip_smoke.py's longform_48k signal through analyze_long) and on
LAYOUT_CASES (``kernel_times``: device ms, event ms, the output's
digest), one line a call.  ``--root`` imports world_tpu_torch from
another checkout (for example the parent commit, unpacked with ``git
archive``), so both are timed by the same code on the same inputs, and
equal digests show equal outputs.

chip_smoke.py records each wrapper's arguments on the paths that call it
(``recording``) and hands them to ``measure``, which checks the kernel
against its plain version on the same card tensors (NaN at the same
places, torch.equal elsewhere) and reports:
  device_ms        device time per launch (torch.profiler, ola_bench's
                   device_ms; inputs warm in L2);
  ms, host_us      CUDA events around back-to-back calls; host
                   microseconds per wrapper call;
  plain_ms         the plain version (the Python loops) on the same
                   tensors, CUDA events around one call (its output is
                   the one compared);
  bound_ms         bytes (inputs read once, the output written once) over
                   the memory rate against this run's operations over the
                   peak rate (float64 or float32; integer operations at
                   the float32 lanes' one instruction a cycle, 33.5e12 a
                   second: the integer units are no faster);
  chain_bound_ms   the dependent steps of one lane (samples x 2 passes,
                   or blocks; randn_span: the 12 xorshift steps of one
                   draw, the least any order needs, since every draw's
                   state can be reached by jumps) times one step's
                   latency on the card (tools/iir_chain.cu: a multiply
                   and the recurrence's dependent adds, or an xorshift
                   step);
  chain_share      chain_bound_ms / device_ms (ms where the profiler
                   recorded no device time);
  library_ms       null: no PyTorch call computes these recurrences in the
                   reference's order, nor the reference's stream.
Needs a CUDA device.
"""

import argparse
import contextlib
import ctypes
import functools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

CHAIN_SRC = Path(__file__).with_name("iir_chain.cu")
REPO = Path(__file__).resolve().parents[2]
# Integer operations a second: the float32 lanes' rate (ola_bench's 67e12
# counts a fused multiply-add twice), one instruction a lane a cycle.
PEAK_INT_OPS_PER_S = 33.5e12
# Dependent adds after the multiply on one step's critical path:
# decimate's stage through w0, the biquad through y1; the state scan's
# is its state size.
CHAIN_ADDS = {"decimate": 3, "smooth": 2}
# Operations a sample of one pass: (multiplies + adds).
SAMPLE_OPS = {"decimate": 13, "smooth": 9}
RECORD_CALLS = 8        # calls of each wrapper kept per recording
SEED = 20261016         # LAYOUT_CASES' inputs
# (lanes, blocks, S) beyond the SM count, where the state-scan kernel puts
# several lanes in a block: the card test's smoothing sections and 200
# long lanes (random p from SEED, the real tables).
LAYOUT_CASES = ((1616, 14, 4), (200, 300, 3))


def build_chain():
    """Compile tools/iir_chain.cu (nvcc, the kernels' flags and the IIR
    source's -fmad=false) unless it is built.  Returns (library path,
    compiler log or None)."""
    from world_tpu_torch.ops import _cuda
    return _cuda.compile_shared(_cuda.nvcc(), _cuda.NVCC_FLAGS
                                + _cuda.SOURCE_FLAGS["iir"], CHAIN_SRC)


def _chain_ns(torch, launch, n, reps, check):
    """Nanoseconds per step of a one-thread chain: ``launch(count)`` runs
    count steps; the chain at 2n and at n steps (CUDA events, the least
    of ``reps`` each), the difference over n.  ``check()`` raises on a
    bad result."""
    def best_ms(count):
        times = []
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            rc = launch(count)
            t1.record()
            if rc != 0:
                raise RuntimeError(f"chain launch: cudaError {rc}")
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        check()
        return min(times)

    best_ms(n)                                   # warm-up
    return (best_ms(2 * n) - best_ms(n)) * 1e6 / n


@functools.lru_cache(maxsize=None)
def step_latency_ns(torch, dtype_name, adds, n=1 << 20, reps=5):
    """Nanoseconds per step of a multiply then ``adds`` dependent adds of
    ``dtype_name`` on the card."""
    fn = ctypes.CDLL(str(build_chain()[0])).iir_chain_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, dtype=getattr(torch, dtype_name), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check():
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"iir chain gave {float(out)}")
    return _chain_ns(torch, lambda count: fn(
        out.element_size(), adds, out.data_ptr(), count, 0.5, 1.0, stream),
        n, reps, check)


@functools.lru_cache(maxsize=None)
def xorshift_step_ns(torch, n=1 << 20, reps=5):
    """Nanoseconds per xorshift128 step of the reference RNG on the card
    (one thread, each step's w waiting on the last)."""
    fn = ctypes.CDLL(str(build_chain()[0])).xorshift_chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    return _chain_ns(torch, lambda count: fn(out.data_ptr(), count, stream),
                     n, reps, lambda: None)


@contextlib.contextmanager
def recording(recorded):
    """Within the block, the calls of the IIR and RNG span wrappers from
    the ops and models that call them leave their (args, kwargs) in
    ``recorded[wrapper name]`` (a list: the first RECORD_CALLS calls)."""
    from world_tpu_torch.models import harvest_contour
    from world_tpu_torch.ops import matlab, rng

    patched = [(m, n, getattr(m, n)) for m, n in (
        (matlab, "iir_zero_phase"), (harvest_contour, "iir_zero_phase"),
        (matlab, "lti_state_scan"), (rng, "randn_span"))]
    for module, name, real in patched:
        def record(*args, _name=name, _real=real, **kwargs):
            calls = recorded.setdefault(_name, [])
            if len(calls) < RECORD_CALLS:
                calls.append((args, kwargs))
            return _real(*args, **kwargs)
        setattr(module, name, record)
    try:
        yield recorded
    finally:
        for module, name, real in patched:
            setattr(module, name, real)


def _wrappers(name):
    from world_tpu_torch.ops import iir, rng
    module = rng if name == "randn_span" else iir
    return getattr(module, name), getattr(module, name + "_plain")


def _work(name, args):
    """(bytes, operations, ops dtype, chain steps, chain, what) of one
    call on these arguments; chain is (dtype, adds) of the recurrences'
    step, "xorshift" for the draws."""
    x = args[0]
    elt = x.element_size()
    if name == "iir_zero_phase":
        recurrence = args[1]
        n = x.shape[-1]
        lanes = x.numel() // max(n, 1)
        return (2 * x.numel() * elt, 2 * x.numel() * SAMPLE_OPS[recurrence],
                "float64", 2 * n, ("float64", CHAIN_ADDS[recurrence]),
                f"{recurrence} r={args[2] if len(args) > 2 else None} "
                f"lanes={lanes}")
    if name == "lti_state_scan":
        AL = args[1]
        S = AL.shape[0]
        nblk = x.shape[-2]
        dtype = str(x.dtype).split(".")[-1]
        return (2 * x.numel() * elt + AL.numel() * elt,
                2 * S * x.numel(), dtype, nblk, (dtype, S),
                f"S={S} nblk={nblk}")
    # randn_span: per set bit of a start, 128 rows of 4 ANDs, 3 XORs, a
    # popc and the bit's placing (2); per draw 12 steps of 8 and 2 more.
    # Its chain: the 12 steps of one draw.
    starts = x.cpu()
    bits = sum(int(s).bit_count() for s in starts.tolist())
    n_bits = max(1, int(args[1]).bit_length())
    ops = bits * 128 * 10 + starts.numel() * 64 * (12 * 8 + 2)
    nbytes = starts.numel() * (8 + 64 * 8) + n_bits * 128 * 16
    return nbytes, ops, "int", 12, "xorshift", f"lanes={starts.numel()}"


def measure(torch, name, args, kwargs, plain_reps=1):
    """The kernel of wrapper ``name`` on the recorded card tensors
    ``args``/``kwargs`` against its plain version, its times and
    bounds."""
    from world_tpu_torch.tools import ola_bench as bench

    kernel, plain = _wrappers(name)

    def run():
        return kernel(*args, **kwargs)

    got = run()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = plain(*args, **kwargs)
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1)
    if plain_reps > 1:
        plain_ms = min(plain_ms, bench.event_ms(
            torch, lambda: plain(*args, **kwargs), plain_reps))
    nan = torch.isnan(want)
    equal = bool(torch.equal(torch.isnan(got), nan)
                 and torch.equal(got[~nan], want[~nan]))
    diff = (got[~nan] - want[~nan]).abs()
    nbytes, n_ops, ops_dtype, steps, chain, what = _work(name, args)
    bytes_ms = nbytes / bench.PEAK_BYTES_PER_S * 1e3
    rate = (PEAK_INT_OPS_PER_S if ops_dtype == "int"
            else bench.PEAK_OPS_PER_S[ops_dtype])
    ops_ms = n_ops / rate * 1e3
    lat = (xorshift_step_ns(torch) if chain == "xorshift"
           else step_latency_ns(torch, *chain))
    out = {
        "shape": [list(a.shape) for a in args if hasattr(a, "shape")],
        "dtype": str(got.dtype).split(".")[-1], "what": what,
        "equal": equal,
        "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
        "nan_count": int(nan.sum()),
        "device_ms": bench.device_ms(torch, run),
        "ms": bench.event_ms(torch, run),
        "host_us": bench.host_us(torch, run, reps=50),
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "operations": n_ops,
        "library_ms": None, "library_device_ms": None,
        "chain_steps": steps, "step_latency_ns": lat,
        "chain_bound_ms": steps * lat * 1e-6,
    }
    # the profiler's device time, or the events' where it gave none
    out["chain_share"] = out["chain_bound_ms"] / (out["device_ms"]
                                                  or out["ms"])
    return out


def count_torch_calls(torch, fn):
    """(fn(), the top-level torch calls it made: the calls a
    TorchFunctionMode sees, those inside another call not counted)."""
    from torch.overrides import TorchFunctionMode

    class Counter(TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.calls += 1
            return func(*args, **(kwargs or {}))

    with Counter() as counter:
        out = fn()
    return out, counter.calls


def kernel_times(torch, name, args, kwargs):
    """Device ms (torch.profiler) and event ms of the wrapper ``name`` on
    recorded card arguments, and a digest of its output."""
    import hashlib

    from world_tpu_torch.tools import ola_bench as bench

    kernel = _wrappers(name)[0]

    def run():
        return kernel(*args, **kwargs)

    out = run()
    shape = [list(a.shape) for a in args if hasattr(a, "shape")]
    return {"kernel": name, "what": _work(name, args)[-1], "shape": shape,
            "device_ms": bench.device_ms(torch, run),
            "ms": bench.event_ms(torch, run),
            "digest": hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()}


def layout_args(torch, lanes, nblk, S):
    """(p, AL) on the card: p (lanes, nblk, S) float32 from SEED, AL
    decimation's 3-state table or the smoothing's 4-state one."""
    from world_tpu_torch.models import harvest_contour
    from world_tpu_torch.ops import matlab

    AL = (matlab._decimate_block_tables(2, 128) if S == 3
          else harvest_contour._biquad_tables())[3]
    rs = np.random.default_rng(SEED)
    p = rs.standard_normal((lanes, nblk, S)).astype(np.float32)
    return (torch.as_tensor(p, device="cuda"),
            torch.as_tensor(np.asarray(AL), dtype=torch.float32,
                            device="cuda"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import world_tpu_torch from")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--kernels", action="store_true",
                    help="also time the kernels on the calls recorded")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("iir_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or REPO)
    sys.path.insert(0, root)
    import world_tpu_torch as W
    if Path(W.__file__).resolve().parents[1] != Path(root):
        print("iir_bench: --root needs the script form, python "
              "world_tpu_torch/tools/iir_bench.py", file=sys.stderr)
        return 2
    from world_tpu_torch.tools import ola_bench as bench

    card = bench.card_name()
    with open(args.out, "a") if args.out else contextlib.nullcontext() as f:
        def emit(**fields):
            line = json.dumps({"root": root, "card": card, **fields})
            print(line, flush=True)
            if f:
                f.write(line + "\n")

        for gold, fs in (("goldens", 22050), ("goldens_fs48", 48000)):
            x = np.fromfile(REPO / "tests" / gold / "x.f64")

            def run():
                y = W.synthesize(W.analyze(x, fs))
                torch.cuda.synchronize()
                return y

            recorded = {}
            with recording(recorded):
                run()
            walls = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                run()
                walls.append(time.perf_counter() - t0)
            _, calls = count_torch_calls(torch, run)
            wall = float(np.median(walls))
            emit(case="analyze_synthesize", fs=fs, audio_s=len(x) / fs,
                 wall_s=walls, wall_s_median=wall, rtf=len(x) / fs / wall,
                 torch_calls=calls)
            if not args.kernels:
                continue
            gains = np.linspace(0.5, 1.5, 16)[:, None]
            xb = torch.as_tensor(x[None] * gains, device="cuda")
            step = W.make_batch_step(fs, xb.shape[1], rng_mode="exact",
                                     f0_method="harvest", device="cuda")
            batch = {}
            with recording(batch):
                step(xb)
            for case, rec in (("analyze_synthesize", recorded),
                              ("f64_exact_step16", batch)):
                for name in ("iir_zero_phase", "randn_span"):
                    for i, (a, kw) in enumerate(rec.get(name, [])):
                        emit(case=case, fs=fs, call=i,
                             **kernel_times(torch, name, a, kw))
        if not args.kernels:
            return 0
        import contour_bench    # beside this script: --root may predate it

        for case, rec in contour_bench.path_calls(torch, recording,
                                                  ("harvest",)).items():
            first = {}
            for a, kw in rec.get("lti_state_scan", []):
                first.setdefault(f"S{a[1].shape[0]}", (a, kw))
            for key, (a, kw) in sorted(first.items()):
                emit(case=case, call=key,
                     **kernel_times(torch, "lti_state_scan", a, kw))
        for lanes, nblk, S in LAYOUT_CASES:
            emit(case="layout", call=f"S{S}", **kernel_times(
                torch, "lti_state_scan", layout_args(torch, lanes, nblk, S),
                {}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
