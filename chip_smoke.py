#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (world_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  device    torch version, card name, nvidia-smi name and power limit
  build     nvcc builds of every csrc/*.cu kernel, started together
  kernels   each kernel against its plain PyTorch version on the card
            (max abs diff must be 0) at the main path's nominal shapes,
            with kernel / plain / library times and the bound (the larger
            of bytes over the memory rate and adds over the peak rate)
  window_starts  fs-derived window positions on the card == on the CPU
  main_22k  make_batch_step(22050, ...) at batch 16 in float32 fast mode,
            gated against the C++ goldens; launches of every kernel
  main_48k  the same at 48 kHz (fft 2048)
  kernels_at_path  each kernel against its plain version at the shapes
            the two main-path runs gave it
Then the kernels summary line, the nvidia-smi line, and the final
{"ok": true, "device": ...} line.  Any failed gate raises: the script
exits non-zero and prints no final line.  Without a CUDA device, or
without the repository around it, it exits non-zero at once.
"""

import concurrent.futures
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
# H100 SXM peak operations per second outside the tensor cores.
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
BATCH = 16


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def load_goldens(name):
    """tests/<name>/*.f64 by the manifest's shapes (numpy only)."""
    d = ROOT / "tests" / name
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


def nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps, warm=1):
    """Mean milliseconds per call from CUDA events around ``reps`` calls."""
    for _ in range(warm):
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


def ola_case(torch, ola, B, P, fft, y_padded, dtype, seed, sort_offsets):
    """Kernel vs plain version on the card for one shape; times both and
    the one-call library yardstick (index_add over the flat targets)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    resp = torch.randn((B, P, fft), generator=gen, dtype=dtype,
                       device="cuda")
    offs = torch.randint(0, y_padded - fft + 1, (B, P), generator=gen,
                         device="cuda", dtype=torch.int32)
    if sort_offsets:
        offs = torch.sort(offs, 1).values.contiguous()
    got = ola.ola_accumulate(resp, offs, y_padded=y_padded)
    want = ola.ola_plain(resp, offs, y_padded)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    targets = (torch.arange(B, device="cuda")[:, None, None] * y_padded
               + offs[..., None].long()
               + torch.arange(fft, device="cuda")).reshape(-1)
    zeros = torch.zeros(B * y_padded, dtype=dtype, device="cuda")
    flat = resp.reshape(-1)
    lib = torch.index_add(zeros, 0, targets, flat).reshape(B, y_padded)
    lib_err = float((lib - want).abs().max())
    nbytes = (resp.numel() * resp.element_size() + offs.numel() * 4
              + B * y_padded * resp.element_size())
    name = str(dtype).split(".")[-1]
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = resp.numel() / PEAK_OPS_PER_S[name] * 1e3   # one add each
    return {
        "shape": [B, P, fft, y_padded], "dtype": name,
        "sorted_offsets": sort_offsets, "max_abs_err": err,
        "index_add_max_abs_err": lib_err,
        "ms": cuda_ms(torch, lambda: ola.ola_accumulate(
            resp, offs, y_padded=y_padded), 20),
        "plain_ms": cuda_ms(torch, lambda: ola.ola_plain(
            resp, offs, y_padded), 3),
        "library_ms": cuda_ms(torch, lambda: torch.index_add(
            zeros, 0, targets, flat), 20),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes,
    }


def envelope_db(y, ref):
    n = (min(len(y), len(ref)) // 256) * 256
    re = ref[:n].reshape(-1, 256).std(axis=1)
    ye = y[:n].reshape(-1, 256).std(axis=1)
    act = re > re.max() * 0.03
    return 20 * np.abs(np.log10(ye[act] / re[act]))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def window_starts(torch, get, fs):
    """fs-derived window positions computed on the card must equal the
    CPU's: true division by fs on the card goes through a 0-dim device
    tensor (device.div), not the reciprocal multiply PyTorch uses for a
    Python scalar divisor."""
    from world_tpu_torch.device import div
    from world_tpu_torch.ops.matlab import matlab_round

    f0 = get("harvest_f0").astype(np.float32)
    tp = get("harvest_tp").astype(np.float32)

    def starts(dev):
        f = torch.as_tensor(f0, device=dev)
        t = torch.as_tensor(tp, device=dev)
        f_eff = torch.where(f <= 100.0, torch.full((), 500.0, device=dev), f)
        ct = matlab_round(t * fs + 0.001) - matlab_round(1.5 * fs / f_eff)
        half = matlab_round(4.0 * fs / f_eff / 2.0)
        d4c = matlab_round((t - 0.25 / f_eff) * fs + 0.001) - half
        ms = div(torch.arange(4000, dtype=torch.float32, device=dev), 1000.0)
        pos = div(div(2.0 * torch.arange(-300, 300, device=dev).to(
            torch.float32), 3.0), fs)
        return [a.cpu() for a in (ct, d4c, ms, pos)]

    on_card, on_cpu = starts("cuda"), starts("cpu")
    same = [bool(torch.equal(a, b)) for a, b in zip(on_card, on_cpu)]
    ms_scalar = torch.arange(4000, dtype=torch.float32, device="cuda") / 1000.0
    n_recip = int((ms_scalar.cpu() != on_cpu[2]).sum())
    emit("window_starts", equal=same,
         python_scalar_division_mismatches=n_recip)
    check(all(same), f"window starts differ between card and CPU: {same}")


def main_path(torch, W, ola, kernels, get, scalars, tag, card):
    fs = scalars["fs"]
    x = get("x").astype(np.float32)
    duration = len(x) / fs
    rng = np.random.default_rng(20261016)

    def fresh():
        gains = np.concatenate([[1.0], 0.5 + rng.random(BATCH - 1)])
        return torch.as_tensor(x[None, :] * gains[:, None].astype(np.float32),
                               device="cuda")

    step = W.make_batch_step(fs, len(x), rng_mode="fast",
                             f0_method="harvest", device="cuda")
    for k in kernels:
        k.launches = 0
    step(fresh())                                   # warm-up
    torch.cuda.synchronize()
    times, stages = [], []
    for _ in range(5):
        xb = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f0, sp, ap, y = step(xb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    shape = ola.ola_accumulate.last_shape
    for _ in range(3):
        tm = {}
        step(fresh(), timings=tm)
        stages.append(tm)
    stage_ms = {s: float(np.median([t[s] for t in stages]))
                for s in stages[0]}

    f0_0 = f0[0].double().cpu().numpy()
    sp_0 = sp[0].double().cpu().numpy()
    y_np = y.double().cpu().numpy()
    ref_f0 = get("harvest_f0")
    vuv = float(((f0_0 > 0) == (ref_f0 > 0)).mean())
    v = (f0_0 > 0) & (ref_f0 > 0)
    cents = float(np.sqrt(np.mean(
        (1200 * np.log2(f0_0[v] / ref_f0[v])) ** 2)))
    sp_db = float(np.median(np.abs(10 * np.log10(
        sp_0 / get("cheaptrick_sp")))))
    env = envelope_db(y_np[0], get("synthesis_y"))
    step_s = float(np.median(times))
    result = {
        "card": card, "batch": BATCH, "audio_s_per_row": duration,
        "step_ms_median": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "rtf": BATCH * duration / step_s, "stage_ms": stage_ms,
        "launches": launches, "ola_shape": list(shape),
        "vuv_agreement": vuv, "cents_rms": cents, "sp_median_db": sp_db,
        "envelope_median_db": float(np.median(env)),
        "envelope_max_db": float(env.max()),
        "finite": bool(all(torch.isfinite(t).all() for t in (f0, sp, ap, y))),
        "shapes": [list(t.shape) for t in (f0, sp, ap, y)],
    }
    emit(tag, **result)
    check(result["finite"], f"{tag}: non-finite output")
    check(tuple(y.shape) == (BATCH, len(get("synthesis_y"))),
          f"{tag}: y shape {tuple(y.shape)}")
    check(vuv > 0.99, f"{tag}: VUV agreement {vuv}")
    check(cents < 0.1, f"{tag}: {cents} cents RMS")
    check(sp_db < 0.01, f"{tag}: sp median {sp_db} dB")
    check(np.median(env) < 0.5, f"{tag}: envelope median {np.median(env)}")
    for name, n in launches.items():
        check(n > 0, f"{tag}: kernel {name} never launched on the main path")
    return result


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "world_tpu_torch").is_dir() or \
            not (ROOT / "tests" / "goldens").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import world_tpu_torch as W
    from world_tpu_torch.ops import _cuda, ola

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card)

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _cuda.CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(_cuda.build, sources)))
    emit("build", seconds=time.perf_counter() - t0, sources=sources,
         ptxas={k: [ln for ln in (v[1] or "").splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in logs.items()})
    kernels = [ola.ola_accumulate]

    cases = []
    for dtype in (torch.float32, torch.float64):
        cases.append(ola_case(torch, ola, BATCH, 1249, 1024, 19468, dtype,
                              1, False))
        cases.append(ola_case(torch, ola, BATCH, 1114, 2048, 37697, dtype,
                              2, False))
        cases.append(ola_case(torch, ola, BATCH, 300, 512, 8000, dtype, 3,
                              False))
    emit("kernels", card=card, ola_accumulate=cases)
    for c in cases:
        check(c["max_abs_err"] == 0.0, f"ola kernel != plain: {c}")

    window_starts(torch, load_goldens("goldens")[0], 22050)

    runs = {}
    for tag, gold in (("main_22k", "goldens"), ("main_48k", "goldens_fs48")):
        get, scalars = load_goldens(gold)
        runs[tag] = main_path(torch, W, ola, kernels, get, scalars, tag, card)

    # Each kernel at the shapes the main path gave it; the kernels line
    # reports the 22.05 kHz one.
    at_paths = {tag: ola_case(torch, ola, *r["ola_shape"], torch.float32,
                              4, True) for tag, r in runs.items()}
    emit("kernels_at_path", card=card, ola_accumulate=at_paths)
    for c in at_paths.values():
        check(c["max_abs_err"] == 0.0, f"ola kernel != plain: {c}")
    at_path = at_paths["main_22k"]
    print(json.dumps({"kernels": [{
        "name": "ola_accumulate", "route": "cuda",
        "source": "world_tpu_torch/csrc/ola.cu",
        "replaces": "world_tpu/ops/pallas_ola.py:33",
        "launches": sum(r["launches"]["ola_accumulate"]
                        for r in runs.values()),
        "max_abs_err": at_path["max_abs_err"], "ms": at_path["ms"],
        "plain_ms": at_path["plain_ms"], "bound_ms": at_path["bound_ms"],
        "bound_by": at_path["bound_by"],
        "library_ms": at_path["library_ms"],
        "shape": at_path["shape"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
