"""Profile the streaming synthesizer, and time long-form analysis per
batch size, on the card.

    python -m world_tpu_torch.tools.profile_stream [--fs 22050|48000]
        [--buffer 64] [--out FILE]
    python -m world_tpu_torch.tools.profile_stream --longform-lanes 4,8,16
        [--seconds 300] [--out FILE]

The first form streams the golden utterance's parameters (all up front,
float32, fast mode, 200 pointers, as chip_smoke.py's stream_f32) once to
warm up, then once under torch.profiler, and reports: wall ms, renders,
kernels launched on the card and per render, device-busy ms (kernel and
copy times summed), the device idle share of the wall time, and the
kernels that take most device time.

The second runs analyze_long on chip_smoke.py's long-form input (the
48 kHz golden utterance tiled to ``--seconds``, int16, Harvest, 6.25 s
chunks, codec 64) at each batch size: wall seconds, audio seconds per
wall second and peak device memory, after one warm-up run at each size.

One JSON line per measurement; needs a CUDA device.
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

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDENS = {22050: "goldens", 48000: "goldens_fs48"}


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def golden(rate, name):
    return np.fromfile(os.path.join(ROOT, "tests", GOLDENS[rate],
                                    name + ".f64"))


def profile_stream(fs, bs):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from world_tpu_torch.models.realtime import StreamingSynthesizer

    f0 = golden(fs, "harvest_f0").astype(np.float32)
    sp, ap = (golden(fs, k).astype(np.float32).reshape(len(f0), -1)
              for k in ("cheaptrick_sp", "d4c_ap"))
    fft = 2 * (sp.shape[1] - 1)

    def run():
        s = StreamingSynthesizer(fs, 5.0, fft, bs, 200, rng_mode="fast",
                                 dtype=np.float32, device="cuda")
        assert s.add_parameters(f0, sp, ap)
        n = 0
        while s.synthesis2():
            n += bs
        s.close()
        return s, n

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s, n = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "what": "stream", "fs": fs, "buffer": bs, "audio_s": n / fs,
        "wall_ms": wall_ms, "renders": s.renders,
        "kernels_launched": len(kernels),
        "kernels_per_render": len(kernels) / max(s.renders, 1),
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels
        else "not measured",
        "top_kernels": [{"name": k[:100], "count": c, "ms": ms}
                        for k, (c, ms) in top]}


def longform_lanes(lanes, seconds):
    from world_tpu_torch.parallel import analyze_long

    fs = 48000
    x = golden(fs, "x")
    base = np.tile(x, int(np.ceil(seconds * fs / len(x))))[
        : int(seconds * fs)]
    rng = np.random.default_rng(20261016)
    out = []
    for n in lanes:
        times = []
        for _ in range(2):          # the first run warms the caches
            scale = 0.4 + 0.4 * rng.random()
            xi = (np.clip(base * scale, -0.999, 0.999)
                  * 32767).astype(np.int16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            analyze_long(xi, fs, chunk_seconds=6.25, f0_method="harvest",
                         codec_dims=64, batch_lanes=n, device="cuda")
            times.append(time.perf_counter() - t0)
        out.append({"what": "longform", "seconds": seconds,
                    "batch_lanes": n, "wall_s": times,
                    "rtf": seconds / times[-1],
                    "peak_device_bytes": torch.cuda.max_memory_allocated()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fs", type=int, default=22050, choices=sorted(GOLDENS))
    ap.add_argument("--buffer", type=int, default=64)
    ap.add_argument("--longform-lanes", default=None,
                    help="comma-separated batch_lanes to time instead")
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stream: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = card_name()
    if args.longform_lanes:
        recs = longform_lanes([int(v) for v in
                               args.longform_lanes.split(",")],
                              args.seconds)
    else:
        recs = [profile_stream(args.fs, args.buffer)]
    lines = [json.dumps({"card": card, **r}) for r in recs]
    print("\n".join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
