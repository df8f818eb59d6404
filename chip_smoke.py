#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (world_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each, in this order:
  device    torch version, card name, nvidia-smi name and power limit
  build     nvcc builds of every csrc/*.cu kernel, started together
  window_starts  fs-derived window positions on the card == on the CPU
  main_22k  make_batch_step(22050, ..., f0_method="harvest") at batch 16
            in float32 fast mode, gated against the C++ goldens;
            launches of every kernel (the ragged mode must have launched)
  main_48k  the same at 48 kHz (fft 2048)
  dio_22k   the JAX package's default step, make_batch_step(22050, ...,
            f0_method="dio", codec_dims=64): Dio -> StoneMask ->
            CheapTrick -> D4C -> codec -> Synthesis at batch 16, float32
            fast mode; F0 gated against the golden StoneMask track, coded
            sp/ap against the codec of a full step, ragged kernel launched
  dio_48k   the same at 48 kHz
  dio_vs_cpu  row 0 of dio_22k's batch, rng_mode "none", on the card
            against the same step on the CPU
  dio_exact float64 Dio and StoneMask on the card against the goldens
  codec_exact  the four codec functions, float64, on the card against
            the goldens
  kernels   the overlap-add kernel in both modes (general: padded
            (B, P, fft) with offsets in any order; ragged: real pulses
            with CSR rows and ascending offsets) against its plain
            PyTorch version on the card (torch.equal, max abs diff 0) at
            the shapes of PERF.md's table, float32 and float64, with
            device-only times (torch.profiler, inputs warm in L2 and after
            an L2 flush), host us per call, CUDA-event times, the plain
            and index_add times and the bound from the real pulses'
            bytes (world_tpu_torch/tools/ola_bench.py)
  kernels_at_path  both modes on the offsets and row_ptr the four path
            runs (main_*, dio_*) gave the ragged kernel
Then the kernels summary line (launches summed over the four path
runs), the nvidia-smi line, and the final
{"ok": true, "device": ...} line.  Any failed gate raises: the script
exits non-zero and prints no final line.  Without a CUDA device, or
without the repository around it, it exits non-zero at once.
"""

import concurrent.futures
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
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


def drive(torch, ola, step, fresh):
    """One warm-up step that records the ragged overlap-add's real inputs
    (for kernels_at_path), then the kernel counts set to 0, five timed
    steps, the counts read, and three stage-timed steps.  Returns (the
    last timed step's outputs, step seconds, launches, stage ms,
    recorded inputs)."""
    from world_tpu_torch.models import synthesis

    real = synthesis.ola_accumulate_ragged
    recorded = {}

    def record(responses, offsets, row_ptr, *, y_padded):
        recorded.update(inputs=(responses, offsets, row_ptr),
                        y_padded=y_padded)
        return real(responses, offsets, row_ptr, y_padded=y_padded)

    synthesis.ola_accumulate_ragged = record
    try:
        step(fresh())                               # warm-up
    finally:
        synthesis.ola_accumulate_ragged = real
    torch.cuda.synchronize()
    for k in all_kernels(ola):
        k.launches = 0
    times = []
    for _ in range(5):
        xb = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = step(xb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in all_kernels(ola)}
    stages = []
    for _ in range(3):
        tm = {}
        step(fresh(), timings=tm)
        stages.append(tm)
    stage_ms = {s: float(np.median([t[s] for t in stages]))
                for s in stages[0]}
    return outs, times, launches, stage_ms, recorded


def batch_maker(torch, x, seed=20261016):
    """Batches of the utterance: row 0 unscaled, rows 1-15 at gains in
    0.5-1.5 drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def fresh():
        gains = np.concatenate([[1.0], 0.5 + rng.random(BATCH - 1)])
        return torch.as_tensor(x[None, :] * gains[:, None].astype(np.float32),
                               device="cuda")
    return fresh


def f0_stats(f0, ref):
    """(VUV agreement, cents RMS over frames voiced in both)."""
    vuv = float(((f0 > 0) == (ref > 0)).mean())
    v = (f0 > 0) & (ref > 0)
    return vuv, float(np.sqrt(np.mean((1200 * np.log2(f0[v] / ref[v])) ** 2)))


def main_path(torch, W, ola, get, scalars, tag, card):
    """Batch-16 Harvest step on the card, gated against the goldens."""
    fs = scalars["fs"]
    x = get("x").astype(np.float32)
    duration = len(x) / fs
    step = W.make_batch_step(fs, len(x), rng_mode="fast",
                             f0_method="harvest", device="cuda")
    (f0, sp, ap, y), times, launches, stage_ms, recorded = drive(
        torch, ola, step, batch_maker(torch, x))

    f0_0 = f0[0].double().cpu().numpy()
    sp_0 = sp[0].double().cpu().numpy()
    y_np = y.double().cpu().numpy()
    vuv, cents = f0_stats(f0_0, get("harvest_f0"))
    sp_db = float(np.median(np.abs(10 * np.log10(
        sp_0 / get("cheaptrick_sp")))))
    env = envelope_db(y_np[0], get("synthesis_y"))
    step_s = float(np.median(times))
    result = {
        "card": card, "batch": BATCH, "audio_s_per_row": duration,
        "step_ms_median": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "rtf": BATCH * duration / step_s, "stage_ms": stage_ms,
        "launches": launches,
        "ola_ragged_shape": list(ola.ola_accumulate_ragged.last_shape),
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
    for k in path_kernels(ola):
        check(launches[k.__name__] > 0,
              f"{tag}: kernel {k.__name__} never launched on the main path")
    return result, recorded


CODEC_DIMS = 64


def dio_path(torch, W, ola, get, scalars, tag, card):
    """Batch-16 step as the JAX package runs it by default (Dio ->
    StoneMask -> CheapTrick -> D4C -> codec -> Synthesis), float32 fast
    mode, on the card.  Gates: finite outputs, shapes, row 0's F0 against
    the golden StoneMask track (VUV > 0.99, < 1 cent RMS), the ragged
    kernel launched, and the coded sp/ap against the codec of a second
    step's full sp/ap on the same batch (rtol/atol 2e-4).  Row 0's
    envelope against the golden synthesis (made from Harvest's F0) is
    reported, not gated."""
    from world_tpu_torch.models import codec

    fs = scalars["fs"]
    x = get("x").astype(np.float32)
    duration = len(x) / fs
    fft = W.get_fft_size_for_cheaptrick(fs)
    n_aper = W.get_number_of_aperiodicities(fs)
    step = W.make_batch_step(fs, len(x), rng_mode="fast", f0_method="dio",
                             codec_dims=CODEC_DIMS, device="cuda")
    (f0, sp_c, ap_c, y), times, launches, stage_ms, recorded = drive(
        torch, ola, step, batch_maker(torch, x))

    # The same batch through the step without the codec: the fast RNG is
    # seeded per call, so both steps see the same dither.
    xb = batch_maker(torch, x)()
    f0_a, sp_a, ap_a, _ = step(xb)
    full = W.make_batch_step(fs, len(x), rng_mode="fast", f0_method="dio",
                             device="cuda")
    _, sp, ap, _ = full(xb)
    want_sp = codec.code_spectral_envelope_batch(sp, fs, fft, CODEC_DIMS)
    want_ap = codec.code_aperiodicity_batch(ap, fs, fft)

    def coded_err(got, want):
        return float(((got - want).abs()
                      - 2e-4 * want.abs()).max()), float(
                          (got - want).abs().max())

    sp_slack, sp_err = coded_err(sp_a, want_sp)
    ap_slack, ap_err = coded_err(ap_a, want_ap)

    f0_0 = f0[0].double().cpu().numpy()
    vuv, cents = f0_stats(f0_0, get("stonemask_f0"))
    env = envelope_db(y.double().cpu().numpy()[0], get("synthesis_y"))
    step_s = float(np.median(times))
    F = len(get("stonemask_f0"))
    shapes = [tuple(t.shape) for t in (f0, sp_c, ap_c, y)]
    result = {
        "card": card, "batch": BATCH, "audio_s_per_row": duration,
        "codec_dims": CODEC_DIMS,
        "step_ms_median": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "rtf": BATCH * duration / step_s, "stage_ms": stage_ms,
        "launches": launches,
        "ola_ragged_shape": list(ola.ola_accumulate_ragged.last_shape),
        "vuv_agreement": vuv, "cents_rms": cents,
        "coded_sp_max_abs_err": sp_err, "coded_ap_max_abs_err": ap_err,
        "info_envelope_vs_harvest_golden_median_db": float(np.median(env)),
        "info_envelope_vs_harvest_golden_max_db": float(env.max()),
        "finite": bool(all(torch.isfinite(t).all()
                           for t in (f0, sp_c, ap_c, y))),
        "shapes": [list(t) for t in shapes],
    }
    emit(tag, **result)
    check(result["finite"], f"{tag}: non-finite output")
    check(shapes == [(BATCH, F), (BATCH, F, CODEC_DIMS), (BATCH, F, n_aper),
                     (BATCH, len(get("synthesis_y")))],
          f"{tag}: shapes {shapes}")
    check(vuv > 0.99, f"{tag}: VUV agreement {vuv}")
    check(cents < 1.0, f"{tag}: {cents} cents RMS")
    check(sp_slack <= 2e-4 and ap_slack <= 2e-4,
          f"{tag}: coded sp/ap differ from the codec of the full step "
          f"({sp_err}, {ap_err})")
    for k in path_kernels(ola):
        check(launches[k.__name__] > 0,
              f"{tag}: kernel {k.__name__} never launched on the Dio path")
    return result, recorded


def dio_vs_cpu(torch, W, get, scalars):
    """Row 0 of the 22.05 kHz batch through the Dio step, rng_mode
    "none", on the card and on the CPU (the port on both)."""
    fs = scalars["fs"]
    x = get("x").astype(np.float32)[None]

    def run(device):
        step = W.make_batch_step(fs, x.shape[1], rng_mode="none",
                                 f0_method="dio", device=device)
        return [t.double().cpu().numpy()[0] for t in step(x)]

    (f0, sp, _, y), (f0_c, sp_c, _, y_c) = run("cuda"), run("cpu")
    vuv, cents = f0_stats(f0, f0_c)
    sp_db = float(np.median(np.abs(10 * np.log10(sp / sp_c))))
    env = float(np.median(envelope_db(y, y_c)))
    emit("dio_vs_cpu", vuv_agreement=vuv, cents_rms=cents, sp_median_db=sp_db,
         envelope_median_db=env)
    check(vuv >= 0.99, f"dio_vs_cpu: VUV agreement {vuv}")
    check(cents < 0.1, f"dio_vs_cpu: {cents} cents RMS")
    check(sp_db < 0.01, f"dio_vs_cpu: sp median {sp_db} dB")
    check(env < 0.5, f"dio_vs_cpu: envelope median {env} dB")


def dio_exact(torch, W, get, scalars):
    """float64 Dio and StoneMask on the card against the goldens at
    tests/test_f0.py's gates."""
    fs = scalars["fs"]
    tp, f0 = W.dio(get("x"), fs, device="cuda")
    tp, f0 = tp.cpu().numpy(), f0.cpu().numpy()
    tp_err = float(np.abs(tp - get("dio_tp")).max())
    ref = get("dio_f0")
    v = (f0 > 0) & (ref > 0)
    dio_vuv = float(((f0 > 0) == (ref > 0)).mean())
    dio_max = float((1200 * np.abs(np.log2(f0[v] / ref[v]))).max())
    sm = W.stone_mask(get("x"), fs, get("dio_tp"), get("dio_f0"),
                      device="cuda").cpu().numpy()
    ref = get("stonemask_f0")
    v = (sm > 0) & (ref > 0)
    sm_vuv = float(((sm > 0) == (ref > 0)).mean())
    sm_max = float((1200 * np.abs(np.log2(sm[v] / ref[v]))).max())
    emit("dio_exact", tp_max_abs_err=tp_err, dio_vuv=dio_vuv,
         dio_max_cents=dio_max, stonemask_vuv=sm_vuv,
         stonemask_max_cents=sm_max)
    check(tp_err <= 1e-12, f"dio_exact: tp error {tp_err}")
    check(dio_vuv == 1.0 and dio_max < 0.1,
          f"dio_exact: Dio VUV {dio_vuv}, {dio_max} cents")
    check(sm_vuv == 1.0 and sm_max < 0.1,
          f"dio_exact: StoneMask VUV {sm_vuv}, {sm_max} cents")


def codec_exact(torch, W, get, scalars):
    """The four codec functions in float64 on the card against the
    goldens at tests/test_codec.py's tolerances."""
    fs, fft, dims = scalars["fs"], scalars["fft_size"], scalars["sp_dim"]

    def run(fn, *args):
        return fn(*args, device="cuda").cpu().numpy()

    got = {
        "coded_ap": run(W.code_aperiodicity, get("d4c_ap"), fs, fft),
        "decoded_ap": run(W.decode_aperiodicity, get("coded_ap"), fs, fft),
        "coded_sp": run(W.code_spectral_envelope, get("cheaptrick_sp"), fs,
                        dims, fft),
        "decoded_sp": run(W.decode_spectral_envelope, get("coded_sp"), fs,
                          fft)}
    err = {k: float(np.abs(v - get(k)).max()) for k, v in got.items()}
    rel = float((np.abs(got["decoded_sp"] - get("decoded_sp"))
                 / np.abs(get("decoded_sp"))).max())
    emit("codec_exact", max_abs_err=err, decoded_sp_max_rel_err=rel)
    check(err["coded_ap"] <= 1e-9, f"codec_exact: coded ap {err}")
    check(err["decoded_ap"] <= 1e-10, f"codec_exact: decoded ap {err}")
    check(err["coded_sp"] <= 1e-9, f"codec_exact: coded sp {err}")
    check(rel <= 1e-9, f"codec_exact: decoded sp rel {rel}")


def all_kernels(ola):
    """Every kernel wrapper of the port (each counts its launches)."""
    return [ola.ola_accumulate, ola.ola_accumulate_ragged]


def path_kernels(ola):
    """The wrappers the main path must launch: batch synthesis calls the
    ragged mode; the general mode's caller (streaming) is not ported."""
    return [ola.ola_accumulate_ragged]


def check_cases(cases, what):
    for c in cases:
        check(c["equal"] and c["max_abs_err"] == 0.0,
              f"{what}: kernel != plain: {c}")


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
    from world_tpu_torch.tools import ola_bench as bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_name()
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

    window_starts(torch, load_goldens("goldens")[0], 22050)

    runs, replays = {}, {}
    for tag, gold in (("main_22k", "goldens"), ("main_48k", "goldens_fs48")):
        get, scalars = load_goldens(gold)
        runs[tag], replays[tag] = main_path(torch, W, ola, get, scalars, tag,
                                            card)
    for tag, gold in (("dio_22k", "goldens"), ("dio_48k", "goldens_fs48")):
        get, scalars = load_goldens(gold)
        runs[tag], replays[tag] = dio_path(torch, W, ola, get, scalars, tag,
                                           card)
    get, scalars = load_goldens("goldens")
    dio_vs_cpu(torch, W, get, scalars)
    dio_exact(torch, W, get, scalars)
    codec_exact(torch, W, get, scalars)

    # Kernel timing (torch.profiler) comes after the main-path steps, so
    # that the steps' host-bound times see no profiler state.  Both modes
    # at the shapes of PERF.md's table, float32 and float64:
    # general with the table's offsets (unsorted at capacity and fft
    # 512), ragged with the same offsets sorted per row.
    flush = bench.l2_flush(torch)
    cases = []
    for dtype in (torch.float32, torch.float64):
        for seed, (B, P, fft, yp, srt) in enumerate(bench.TABLE):
            resp, offs = bench.random_inputs(torch, B, P, fft, yp, dtype,
                                             seed, srt)
            cases.append(bench.measure(torch, ola, "general", (resp, offs),
                                       yp, flush))
            soffs = torch.sort(offs, 1).values.contiguous()
            cases.append(bench.measure(torch, ola, "ragged",
                                       bench.to_ragged(torch, resp, soffs),
                                       yp, flush))
    emit("kernels", card=card, ola=cases)
    check_cases(cases, "kernels")


    # Both modes on the inputs each path's ragged call received (the
    # general mode on their padded layout); the kernels line reports the
    # 22.05 kHz Harvest path's and counts the launches of every path.
    at_paths = {}
    for tag, rec in replays.items():
        inputs, yp = rec["inputs"], rec["y_padded"]
        at_paths[tag] = {
            "ragged": bench.measure(torch, ola, "ragged", inputs, yp, flush),
            "general": bench.measure(torch, ola, "general",
                                     bench.to_padded(torch, *inputs), yp,
                                     flush)}
    emit("kernels_at_path", card=card, ola=at_paths)
    check_cases([c for v in at_paths.values() for c in v.values()],
                "kernels_at_path")

    def line(name, c, on_path):
        return {
            "name": name, "route": "cuda",
            "source": "world_tpu_torch/csrc/ola.cu",
            "replaces": "world_tpu/ops/pallas_ola.py:33",
            "launches": sum(r["launches"][name] for r in runs.values()),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "device_ms": c["device_ms"], "host_us": c["host_us"],
            "library_device_ms": c["library_device_ms"],
            "shape": c["shape"], "on_main_path": on_path}

    at_22k = at_paths["main_22k"]
    print(json.dumps({"kernels": [
        line("ola_accumulate_ragged", at_22k["ragged"], True),
        line("ola_accumulate", at_22k["general"], False)]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
