"""The readings that the check's limits are set from (check.py), on the
card at the cell's own size.

    python portbench/control.py --workload <cell> --seeds 1,2,3
        [--seconds 2] [--control 1] [--out FILE]

For each seed, in one process: the cell's inputs, a short window at the
cell's own load, and the check's numbers for the program's checked rows
(the lower readings) and, with ``--control 1``, for the control in the
program's place on the same rows (the upper readings: the reference in
float32 with bfloat16 between stages).  One JSON line per seed.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def readings(cell_name, seed, seconds, with_control, device="cuda",
             cell=None):
    from portbench.run import load_json

    cell = cell or load_json(HERE / "workloads" / f"{cell_name}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    drv = importlib.import_module(
        f"portbench.drivers.{cell['driver']}").Driver(cell, config, seed,
                                                      device)
    drv.setup()
    drv.window(seconds, None)
    drv.release()
    t = time.perf_counter()
    out = {"seed": seed, "program": drv.check(device)}
    out["program_s"] = time.perf_counter() - t
    if with_control:
        t = time.perf_counter()
        out["control"] = drv.check(device, control=True)
        out["control_s"] = time.perf_counter() - t
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = str(HERE.parent)
    if Path(sys.path[0]).resolve() == HERE:
        sys.path[0] = root
    else:
        sys.path.insert(0, root)
    from portbench.run import fixed_caches
    fixed_caches()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, args.seconds,
                                   bool(args.control)))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
