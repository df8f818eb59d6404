"""Profile one batched step of the port on the card.

    python -m world_tpu_torch.tools.profile_step [--fs 22050|48000]
        [--batch 16] [--out profile_22050.json]

Drives make_batch_step(f0_method="harvest", rng_mode="fast") on rows of
the golden utterance in float32 and reports, for one step after warm-up:
wall ms, per-stage ms (synchronized stage clock, a separate step), and
from torch.profiler the device-busy ms (sum of kernel and copy times on
the card), the device idle share, the number of kernels launched and the
kernels that take most device time.  Needs a CUDA device.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

GOLDENS = {22050: "goldens", 48000: "goldens_fs48"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fs", type=int, default=22050, choices=sorted(GOLDENS))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from world_tpu_torch.parallel.pipeline import make_batch_step

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    x = np.fromfile(os.path.join(root, "tests", GOLDENS[args.fs],
                                 "x.f64")).astype(np.float32)
    gains = np.linspace(0.5, 1.5, args.batch).astype(np.float32)
    xb = torch.as_tensor(x[None] * gains[:, None], device="cuda")
    step = make_batch_step(args.fs, len(x), rng_mode="fast", device="cuda")
    for _ in range(2):
        step(xb)
    torch.cuda.synchronize()
    stages = {}
    step(xb, timings=stages)

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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result = {
        "card": card, "fs": args.fs, "batch": args.batch,
        "audio_s": args.batch * len(x) / args.fs,
        "wall_ms": wall_ms, "stage_ms": stages,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels
        else "not measured",
        "kernels_launched": len(kernels),
        "top_kernels": [{"name": n[:120], "count": c, "ms": ms}
                        for n, (c, ms) in top],
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
