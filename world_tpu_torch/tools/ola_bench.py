"""Time the overlap-add kernel (csrc/ola.cu) on the card, device alone.

    python world_tpu_torch/tools/ola_bench.py [--root DIR] [--sweep]
        [--out FILE]

For each shape of PERF.md's kernel table, in float32 and float64, in the
general mode (``ola_accumulate``) and, where the package has it, the
ragged mode (``ola_accumulate_ragged``), it checks the kernel against its
plain version and reports:
  device_ms       device time per launch: the summed durations of the
                  kernels torch.profiler records over 30 launches, inputs
                  warm in L2 from the previous launch;
  device_ms_cold  the same with the 50 MB L2 overwritten before each
                  launch (the overwrite's own kernels left out);
  host_us         host microseconds per wrapper call (200 calls, no sync
                  between them);
  ms              CUDA events around 20 back-to-back calls;
and the same for the one-call yardstick ``torch.index_add``, beside the
bound from the real pulses' bytes.  ``--root`` imports world_tpu_torch
from another checkout (for example the parent commit, unpacked with
``git archive``), so an older kernel is timed by the same code.
``--sweep`` also times every tile the kernel has.  Prints
one JSON line per case; needs a CUDA device.  chip_smoke.py uses the
same functions.
"""

import argparse
import json
import os
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
# H100 SXM peak operations per second outside the tensor cores.
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
L2_BYTES = 50 * 2 ** 20
# (B, P, fft, y_padded, sorted offsets): the main path's nominal shapes
# at 22.05 and 48 kHz (P: the largest real pulse count of the batch),
# the JAX package's pulse capacity at both, and fft 512.
TABLE = ((16, 134, 1024, 19468, True), (16, 98, 2048, 37697, True),
         (16, 1249, 1024, 19468, False), (16, 1114, 2048, 37697, False),
         (16, 300, 512, 8000, False))


def card_name():
    """``name, power.limit`` of the first card as nvidia-smi prints it."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps=20):
    """Mean milliseconds per call from CUDA events around ``reps`` calls
    (the host's enqueue rate when it is slower than the device)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, reps=200):
    """Host microseconds per call over ``reps`` calls with no sync
    between them (fewer than the launch queue holds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def _device_events(torch, run):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(torch, fn, reps=30, flush=None, tries=3):
    """Device milliseconds per call: the durations of the kernels and
    copies torch.profiler records over ``reps`` calls, summed, over reps.
    With ``flush``, it runs before each call and its kernels are left
    out.  A trace whose event count is not reps times one call's is
    taken again (the profiler drops or leaks events now and then); None
    ("not measured") after ``tries`` such traces."""
    per_call = len(_device_events(torch, fn))
    skip = set()
    if flush is not None:
        skip = {e.name for e in _device_events(torch, flush)}

    def run():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    for _ in range(tries):
        evs = [e for e in _device_events(torch, run) if e.name not in skip]
        if evs and len(evs) == per_call * reps:
            return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / reps
    return None


def l2_flush(torch):
    """A callable that overwrites twice the L2's size on the card."""
    buf = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device="cuda")
    buf.zero_()
    return buf.neg_


def random_inputs(torch, B, P, fft, y_padded, dtype, seed, sort_offsets):
    """(B, P, fft) responses and (B, P) int32 offsets made on the card
    from ``seed``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    resp = torch.randn((B, P, fft), generator=gen, dtype=dtype,
                       device="cuda")
    offs = torch.randint(0, y_padded - fft + 1, (B, P), generator=gen,
                         device="cuda", dtype=torch.int32)
    if sort_offsets:
        offs = torch.sort(offs, 1).values.contiguous()
    return resp, offs


def to_ragged(torch, resp, offs):
    """Every padded pulse as a real one: (N, fft), (N,), row_ptr."""
    B, P, fft = resp.shape
    row_ptr = torch.arange(B + 1, dtype=torch.int32, device=resp.device) * P
    return resp.reshape(B * P, fft), offs.reshape(-1), row_ptr


def to_padded(torch, resp, offs, row_ptr):
    """The general mode's (B, P, fft) / (B, P) layout of ragged inputs:
    missing pulses carry zero responses at offset 0."""
    counts = torch.diff(row_ptr.long())
    B, P = counts.numel(), int(counts.max()) if counts.numel() else 0
    rows = torch.repeat_interleave(torch.arange(B, device=resp.device),
                                   counts)
    slot = torch.arange(resp.shape[0], device=resp.device) - \
        row_ptr.long()[rows]
    pr = torch.zeros((B, P, resp.shape[1]), dtype=resp.dtype,
                     device=resp.device)
    po = torch.zeros((B, P), dtype=torch.int32, device=resp.device)
    pr[rows, slot] = resp
    po[rows, slot] = offs
    return pr, po


def bound(nbytes, n_adds, dtype_name):
    """(bound ms, what bounds it): bytes over the memory rate against one
    add per response sample over the peak rate."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_adds / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def measure(torch, ola, mode, inputs, y_padded, flush, *, plain=True,
            library=True, tile=None):
    """Kernel against its plain version on the card, and its times.

    mode "general": inputs (resp (B, P, fft), offs (B, P));
    mode "ragged": inputs (resp (N, fft), offs (N,), row_ptr (B+1,)).
    ``tile`` calls ola.launch with that tile instead of the entry (which
    picks the tile from fft), to time another tile of the same kernel."""
    if mode == "general":
        resp, offs = inputs
        B, P, fft = resp.shape
        rows = torch.arange(B, device="cuda")[:, None].expand(B, P)
        n_real = int((resp != 0).any(-1).sum())
        index_bytes = offs.numel() * 4

        def entry():
            return ola.ola_accumulate(resp, offs, y_padded=y_padded)

        def run_plain():
            return ola.ola_plain(resp, offs, y_padded)
    else:
        resp, offs, row_ptr = inputs
        fft = resp.shape[1]
        B = row_ptr.numel() - 1
        P = resp.shape[0]
        rows = torch.repeat_interleave(torch.arange(B, device="cuda"),
                                       torch.diff(row_ptr.long()))
        n_real = P
        index_bytes = offs.numel() * 4 + row_ptr.numel() * 4

        def entry():
            return ola.ola_accumulate_ragged(resp, offs, row_ptr,
                                             y_padded=y_padded)

        def run_plain():
            return ola.ola_ragged_plain(resp, offs, row_ptr, y_padded)
    fn = entry
    if tile is not None:
        rp = None if mode == "general" else row_ptr

        def fn():
            out = torch.empty((B, y_padded), dtype=resp.dtype,
                              device="cuda")
            ola.launch(resp, offs, rp, out, B, P, fft, y_padded, tile=tile)
            return out
    got = fn()
    want = run_plain()
    torch.cuda.synchronize()
    name = str(resp.dtype).split(".")[-1]
    elt = resp.element_size()
    nbytes = n_real * fft * elt + index_bytes + B * y_padded * elt
    bound_ms, bound_by = bound(nbytes, n_real * fft, name)
    rec = {
        "mode": mode, "shape": [B, P, fft, y_padded], "dtype": name,
        "pulses": n_real, "equal": bool(torch.equal(got, want)),
        "max_abs_err": float((got - want).abs().max()) if got.numel()
        else 0.0,
        "device_ms": device_ms(torch, fn),
        "device_ms_cold": device_ms(torch, fn, flush=flush),
        "host_us": host_us(torch, fn), "ms": event_ms(torch, fn),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "l2_resident": nbytes <= L2_BYTES,
    }
    if plain:
        rec["plain_ms"] = event_ms(torch, run_plain, 3)
    if library:
        targets = ((rows.reshape(-1) * y_padded
                    + offs.reshape(-1).long())[:, None]
                   + torch.arange(fft, device="cuda")).reshape(-1)
        zeros = torch.zeros(B * y_padded, dtype=resp.dtype, device="cuda")
        flat = resp.reshape(-1)

        def lib():
            return torch.index_add(zeros, 0, targets, flat)

        rec["index_add_max_abs_err"] = float(
            (lib().reshape(B, y_padded) - want).abs().max())
        rec.update(library_ms=event_ms(torch, lib),
                   library_device_ms=device_ms(torch, lib),
                   library_device_ms_cold=device_ms(torch, lib, flush=flush),
                   library_host_us=host_us(torch, lib))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import world_tpu_torch from")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every tile")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ola_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    from world_tpu_torch.ops import ola

    card = card_name()
    flush = l2_flush(torch)
    ragged = hasattr(ola, "ola_accumulate_ragged")
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps({"root": root, "card": card, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    try:
        for dtype in (torch.float32, torch.float64):
            for seed, (B, P, fft, yp, srt) in enumerate(TABLE):
                resp, offs = random_inputs(torch, B, P, fft, yp, dtype,
                                           seed, srt)
                emit(measure(torch, ola, "general", (resp, offs), yp, flush,
                             plain=False))
                if not ragged:
                    continue
                ragged_in = to_ragged(
                    torch, resp, torch.sort(offs, 1).values.contiguous())
                emit(measure(torch, ola, "ragged", ragged_in, yp, flush,
                             plain=False))
                if not args.sweep:
                    continue
                for mode, inp in (("general", (resp, offs)),
                                  ("ragged", ragged_in)):
                    for tile in ola.TILES:
                        emit({"sweep": True, "tile": tile, **measure(
                            torch, ola, mode, inp, yp, flush, plain=False,
                            library=False, tile=tile)})
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
