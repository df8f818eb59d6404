"""Profile one batched step of the port on the card.

    python -m world_tpu_torch.tools.profile_step [--fs 22050|48000]
        [--batch 16] [--f0-method dio|harvest] [--codec-dims N]
        [--dtype float32|float64] [--rng-mode fast|exact|none]
        [--reps 7] [--out profile_22050.json]
    python world_tpu_torch/tools/profile_step.py --root DIR [...]

Drives make_batch_step with the given F0 method (Dio, the step's
default, or Harvest), RNG mode (fast by default; exact is the reference
stream, as analyze() and synthesize() default to) and optional on-device
codec on rows of the golden utterance in float32 (the production batch
step) or float64 (the exact path's type) and reports, after two warm-up
steps: the wall ms of ``--reps`` synchronized steps and per-stage ms
(synchronized stage clock, ``--reps`` further steps; medians), and for
one more step
from torch.profiler the device-busy ms (sum of kernel and copy times on
the card), the device idle share, the number of kernels launched and the
kernels that take most device time; and, from a third step traced on the
host alone, the top-level torch ops each stage issues (``stage_ops``).
``--root`` imports world_tpu_torch from another checkout (for example
the parent commit, unpacked with ``git archive``; the script form
only), so its steps are timed by the same code.  Needs a CUDA device.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
GOLDENS = {22050: "goldens", 48000: "goldens_fs48"}


def stage_ops(step, x):
    """Top-level torch ops per stage of one ``step(x)``: the aten ops that
    torch.profiler records directly inside a stage of the step's
    StageClock (not inside another op; a span between them, such as a
    host sync's, is looked through), counted for that stage and every
    stage around it.  Host-side tracing only, with the program's tracing
    on."""
    from torch.profiler import ProfilerActivity, profile

    from world_tpu_torch import device

    was = device.set_tracing(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(x)
    finally:
        device.set_tracing(was)
    counts = collections.Counter()
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        p = e.cpu_parent
        while p is not None and p.name.startswith("span:"):
            p = p.cpu_parent
        if p is None or not p.name.startswith("stage:"):
            continue
        while p is not None:
            if p.name.startswith("stage:"):
                counts[p.name[len("stage:"):]] += 1
            p = p.cpu_parent
    return dict(counts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fs", type=int, default=22050, choices=sorted(GOLDENS))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--f0-method", default="dio", choices=("dio", "harvest"))
    ap.add_argument("--codec-dims", type=int, default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--rng-mode", default="fast",
                    choices=("fast", "exact", "none"))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--root", default=None,
                    help="checkout to import world_tpu_torch from")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    root = Path(args.root or REPO).resolve()
    sys.path.insert(0, str(root))
    import world_tpu_torch
    if Path(world_tpu_torch.__file__).resolve().parents[1] != root:
        print("profile_step: --root needs the script form, python "
              "world_tpu_torch/tools/profile_step.py", file=sys.stderr)
        return 2
    from world_tpu_torch.parallel.pipeline import make_batch_step

    x = np.fromfile(REPO / "tests" / GOLDENS[args.fs] / "x.f64").astype(
        args.dtype)
    gains = np.linspace(0.5, 1.5, args.batch).astype(args.dtype)
    xb = torch.as_tensor(x[None] * gains[:, None], device="cuda")
    step = make_batch_step(args.fs, len(x), rng_mode=args.rng_mode,
                           f0_method=args.f0_method,
                           codec_dims=args.codec_dims, device="cuda")
    for _ in range(2):
        step(xb)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        step(xb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    stage_runs = []
    for _ in range(args.reps):
        stage_runs.append({})
        step(xb, timings=stage_runs[-1])
    stages = {k: float(np.median([r[k] for r in stage_runs]))
              for k in stage_runs[0]}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(xb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    ops = stage_ops(step, xb)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result = {
        "card": card, "root": str(root), "fs": args.fs,
        "batch": args.batch, "f0_method": args.f0_method,
        "codec_dims": args.codec_dims, "dtype": args.dtype,
        "rng_mode": args.rng_mode,
        "audio_s": args.batch * len(x) / args.fs,
        "step_ms_median": float(np.median(step_ms)), "step_ms": step_ms,
        "stage_ms": stages, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels
        else "not measured",
        "kernels_launched": len(kernels),
        "top_kernels": [{"name": n[:120], "count": c, "ms": ms}
                        for n, (c, ms) in top],
        "stage_ops": ops,
    }
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
