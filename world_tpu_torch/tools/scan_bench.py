"""Time the sequential scan kernel (csrc/scan.cu) and the batch synthesis
around it on the card.

    python world_tpu_torch/tools/scan_bench.py [--root DIR] [--out FILE]

Synthesis: ``synthesis_batch`` of the golden Dio track with the golden
CheapTrick sp and D4C ap (22.05 kHz) and of the 48 kHz golden Harvest
track, at 1 and 16 rows, float64 exact mode (the CLI's and
``W.synthesis``'s default) and float32 fast mode (the batch step's):
wall milliseconds per call, synchronized, median and min of 10 after
one discarded call.  ``--root`` imports world_tpu_torch from another
checkout (for example the parent commit, unpacked with ``git archive``),
so its synthesis is timed by the same code.

Scan (where the package has ops/scan.py): the kernel on each
synthesis's phase increments against its plain version (torch.equal),
with device_ms (torch.profiler), ms (CUDA events), the plain version's
ms, ``torch.cumsum`` on the card as the library call, and the bound.
Prints one JSON line per case; needs a CUDA device.  chip_smoke.py uses
``measure_scan``.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CASES = (("goldens", "dio_f0", 1), ("goldens", "dio_f0", 16),
         ("goldens_fs48", "harvest_f0", 1), ("goldens_fs48", "harvest_f0", 16))


def load(name):
    """The golden arrays of tests/<name>/ by its manifest's shapes."""
    d = REPO / "tests" / name
    shapes, scalars = {}, {}
    for line in (d / "manifest.txt").read_text().splitlines():
        parts = line.split()
        if parts[0] == "scalar":
            scalars[parts[1]] = int(parts[2])
        else:
            shapes[parts[0]] = tuple(int(p) for p in parts[1:])

    def get(key):
        return np.fromfile(d / f"{key}.f64").reshape(shapes[key])
    return get, scalars


def measure_scan(torch, scan, x, flush):
    """The scan kernel on the (B, L) card tensor ``x`` against its plain
    version, and its times (ola_bench's timers)."""
    from world_tpu_torch.tools import ola_bench as bench

    got = scan.cumsum_rows(x)
    want = scan.cumsum_rows_plain(x)
    lib = torch.cumsum(x, dim=1)
    torch.cuda.synchronize()
    name = str(x.dtype).split(".")[-1]
    nbytes = 2 * x.numel() * x.element_size()
    bytes_ms = nbytes / bench.PEAK_BYTES_PER_S * 1e3
    ops_ms = x.numel() / bench.PEAK_OPS_PER_S["float64"] * 1e3
    return {
        "shape": list(x.shape), "dtype": name,
        "equal": bool(torch.equal(got, want)),
        "max_abs_err": float((got - want).abs().max()),
        "library_max_abs_err": float((lib - want).abs().max()),
        "device_ms": bench.device_ms(torch, lambda: scan.cumsum_rows(x)),
        "ms": bench.event_ms(torch, lambda: scan.cumsum_rows(x)),
        "host_us": bench.host_us(torch, lambda: scan.cumsum_rows(x)),
        "plain_ms": bench.event_ms(
            torch, lambda: scan.cumsum_rows_plain(x), 5),
        "library_ms": bench.event_ms(
            torch, lambda: torch.cumsum(x, dim=1)),
        "library_device_ms": bench.device_ms(
            torch, lambda: torch.cumsum(x, dim=1)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "flush_cold_device_ms": bench.device_ms(
            torch, lambda: scan.cumsum_rows(x), flush=flush),
    }


def synthesis_inputs(torch, gold, track, rows, dtype):
    """f0, sp, ap (rows, F, ...) on the card, rows 1.. at gains 0.5-1.5
    on sp; fs, frame period, y_length, fft size."""
    get, scalars = load(gold)
    fs = scalars["fs"]
    f0, sp, ap = get(track), get("cheaptrick_sp"), get("d4c_ap")
    gains = np.concatenate([[1.0], np.linspace(0.5, 1.5, rows - 1)])
    y_length = len(get("synthesis_y"))

    def up(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    return (up(np.tile(f0, (rows, 1))),
            up(sp[None] * gains[:, None, None] ** 2),
            up(np.tile(ap, (rows, 1, 1))), fs, 5.0, y_length,
            2 * (sp.shape[1] - 1))


def wall_ms(torch, fn, reps=10):
    """(median, min) wall ms per synchronized call, after one discarded."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), float(min(times))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import world_tpu_torch from")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("scan_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or REPO)
    sys.path.insert(0, root)
    from world_tpu_torch.models import synthesis
    from world_tpu_torch.tools import ola_bench as bench

    try:
        from world_tpu_torch.ops import scan
    except ImportError:
        scan = None
    card = bench.card_name()
    flush = bench.l2_flush(torch)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps({"root": root, "card": card, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    # Every synthesis is timed before the first profiler session: after
    # one, each launch costs more host time for the rest of the process.
    recs, scan_inputs = [], []
    for gold, track, rows in CASES:
        for dtype, mode in ((torch.float64, "exact"),
                            (torch.float32, "fast")):
            f0, sp, ap_, fs, fp, yl, fft = synthesis_inputs(
                torch, gold, track, rows, dtype)

            def run():
                return synthesis.synthesis_batch(f0, sp, ap_, fs, fp, yl,
                                                 fft, rng_mode=mode)
            med, best = wall_ms(torch, run)
            recs.append({"case": "synthesis", "golden": gold,
                         "track": track, "rows": rows,
                         "dtype": str(dtype)[6:], "rng_mode": mode,
                         "wall_ms_median": med, "wall_ms_min": best})
            if scan is not None:
                recorded = {}
                real = synthesis.cumsum_rows

                def record(x):
                    recorded["x"] = x
                    return real(x)
                synthesis.cumsum_rows = record
                try:
                    run()
                finally:
                    synthesis.cumsum_rows = real
                scan_inputs.append(recorded["x"])
    try:
        for i, rec in enumerate(recs):
            if scan is not None:
                rec["scan"] = measure_scan(torch, scan, scan_inputs[i],
                                           flush)
            emit(rec)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
