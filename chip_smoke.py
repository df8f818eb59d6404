#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (world_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each, in this order:
  device    torch version, card name, nvidia-smi name and power limit
  build     nvcc builds of every csrc/*.cu kernel and of the dependent-add,
            dependent-divide and IIR/xorshift-chain microbenchmarks,
            started together; each kernel's -Xptxas -v registers,
            shared memory and spills
  window_starts  fs-derived window positions on the card == on the CPU
  main_22k  make_batch_step(22050, ..., f0_method="harvest") at batch 16
            in float32 fast mode, gated against the C++ goldens;
            launches of every kernel (the ragged mode, the scan,
            Harvest's refinement, reliability-pass and contour kernels
            and the block-LTI state scan must have launched, the
            refinement and the reliability pass once a step);
            stage ms
  main_48k  the same at 48 kHz (fft 2048)
  dio_22k   the JAX package's default step, make_batch_step(22050, ...,
            f0_method="dio", codec_dims=64): Dio -> StoneMask ->
            CheapTrick -> D4C -> codec -> Synthesis at batch 16, float32
            fast mode; F0 gated against the golden StoneMask track, coded
            sp/ap against the codec of a full step, the ragged and scan
            kernels and Dio's contour kernel launched (Dio at its default
            speed 1 does not decimate), StoneMask's refinement kernel
            once a step; stage ms
  dio_48k   the same at 48 kHz
  dio_vs_cpu  row 0 of dio_22k's batch, rng_mode "none", on the card
            against the same step on the CPU
  dio_exact float64 Dio and StoneMask on the card against the goldens
  codec_exact  the four codec functions, float64, on the card against
            the goldens
  exact_path  the package's default entry points, W.analyze(x, fs) then
            W.synthesize(p) (float64, Harvest, the reference RNG) on the
            card at 22.05 kHz (tests/vaiueo2d.wav) and 48 kHz
            (tests/goldens_fs48/x.f64): f0, sp, ap and y against the
            goldens at the float64 gates of tests/test_torch_pipeline.py
            and tests/test_torch_crossrate.py; wall s and RTF of a
            second call, its top-level torch calls (below 20,000 at 22.05
            kHz) and kernel launches (iir_zero_phase and randn_span at
            least once)
  kernels   the overlap-add kernel in both modes (general: padded
            (B, P, fft) with offsets in any order; ragged: real pulses
            with CSR rows and ascending offsets) against its plain
            PyTorch version on the card (torch.equal, max abs diff 0) at
            the shapes of PERF.md's table, float32 and float64, with
            device-only times (torch.profiler, inputs warm in L2 and after
            an L2 flush), host us per call, CUDA-event times, the plain
            and index_add times and the bound from the real pulses'
            bytes (world_tpu_torch/tools/ola_bench.py)
  stream_exact_22k  StreamingSynthesizer, float64 exact mode, from the
            golden Harvest F0, CheapTrick sp and D4C ap: all parameters at
            once (1 pointer, buffer 64) against synthesis2_y and frame by
            frame (100 pointers) against synthesis3_y, SNR > 80 dB; the
            general mode (ola_accumulate) launched
  stream_span_vs_rows  float64, span_render=True (the kernel) against
            span_render=False (rows added on the host), 22.05 and 48 kHz,
            SNR > 200 dB
  stream_vs_cpu_48k  float32, rng_mode "none", card against the port on
            the CPU, SNR > 60 dB
  stream_f32  float32 fast mode, all parameters up front, buffers 64 and
            4096, 22.05 and 48 kHz: audio seconds per wall second (median
            and best of 5 after a discarded first run), renders per
            stream, general-mode launches; power against synthesis2_y
            within 0.5-2x at 22.05 kHz
  stream_frame_feed  the reference's real-time scenario: one 5 ms frame
            per add_parameters, buffer 64, hold_on_miss, dispatch_min 2,
            hold_force_ms 8: per-call ms p50/p99, holds, the lag of the
            audio behind a paced feed; its audio against the all-up-front
            float32 run with the same RNG, SNR > 80 dB
  longform_check  analyze_long (4 s chunks) of 12 s at 16 kHz against
            whole-signal analysis on the card, Dio (0.2 s halo) and
            Harvest (float32): VUV > 0.99, 95th percentile cents < 1,
            median sp dB < 0.1 on interior frames
  longform_48k  analyze_long of 300 s of 48 kHz int16 (Harvest, 6.25 s
            chunks, codec 64, LONGFORM_LANES rows per batch): audio
            seconds per wall second, peak device memory, batches in
            flight; finite, shapes; on the first 60 s the int16 + codec
            run against the float32 uncoded run coded afterwards (rtol/atol
            2e-3)
  longform_synth  synthesize_long (buffer 4096, 512-frame pushes, float32
            fast) of the 48 kHz analysis of 60 s: audio seconds per wall
            second; length, continuity, general-mode launches
  cli_manip the CLI's `test vaiueo2d.wav out.wav 2.0 1.5` (float64 on
            the card): 01/02/03out.wav, and the 0.7
            stretch, within 1 LSB of tests/goldens_manip/ with < 1% of
            samples differing; both OLA modes, the scan and Harvest's
            contour kernel launched in the phase
  cli_verify  `verify` on the card: PASS at the JAX CLI's gates
  cli_examples  f0analysis -> spanalysis -d 40 -> apanalysis -c ->
            readandsynthesis, and analysis -> synthesis, on the card and
            on the CPU: the wavs within 1 LSB of each other
  corpus_ref  the per-file CorpusRunner (Harvest, fast mode) and the
            batched runner writing tagged .f0/.sp/.ap, on the 5 shortest
            files at each rate of the corpus below: every file read back
            through io/parameterio with its rate, fft size and frames
  corpus_batched  BatchedCorpusRunner(fs=None, bucket_seconds=[2, 4, 8],
            batch_size=16, f0_method="dio", output_format="npz",
            codec_dims=64) over ~200 seeded mixed-rate wavs (~15 min of
            audio, 22.05 and 48 kHz) and one broken wav: audio seconds
            per wall second, peak device memory, batches; the native
            loader; 4 files' batches rolled by a row, and each file
            alone, within BATCH_ATOL; a second runner skips every file
  mesh_nccl the mesh on nccl in this process (a world of one rank,
            make_mesh(1, 1)): the Harvest and Dio (codec 64) steps on the
            main_*/dio_* batches, analyze_long on longform_check's signal
            and allreduce_metrics, each bit-equal to the unsharded call;
            step ms, peak memory, the ragged and scan kernels launched
  mesh_2rank_card  two ranks spawned on this card over gloo: mesh (1, 2)
            on the Harvest step (22.05 kHz), mesh (2, 1) on the Dio step
            with codec 64 (48 kHz), mesh (1, 2) on the Dio analysis step
            (codec 64, 4 s rows at 48 kHz): sharded against unsharded
            within BATCH_ATOL and y above 60 dB, shard shapes, one
            all_gather per synthesis step and none in the analysis step,
            the analysis step's per-rank peak below the unsharded one's,
            the kernels launched and equal to their plain versions on the
            recorded inputs; step ms, the gather's ms
  scaling   `python -m world_tpu_torch.tools scaling --devices 1,2
            --seconds 1 --iters 3`: two rows (the second two ranks on
            this card: contention, not scaling)
  kernels_at_path  both modes on the offsets and row_ptr the four path
            runs (main_*, dio_*) gave the ragged kernel, and the general
            mode on one stream_f32 span render's inputs at each rate
  scan_kernel  the sequential scan kernel (synthesis's phase sum) on the
            increments the four path runs (float32) and cli_manip
            (float64) gave it, against its plain version (torch.equal),
            with its times, torch.cumsum's, the bound, and the chain bound
            (row length x the latency of one dependent double add,
            world_tpu_torch/tools/dadd_chain.cu)
  contour_kernels  the contour-walk kernels on the arguments their
            wrappers received: Dio's (dio_fix_walks) in dio_22k, dio_48k
            and dio_exact (float64), Harvest's (harvest_fix_step3) in
            main_22k, main_48k, the first batch of longform_48k and
            cli_manip (float64); each against its plain version
            (torch.equal), with its times, the plain version's, the
            bytes bound and the chain bound (dependent divides x the
            latency of one, world_tpu_torch/tools/div_chain.cu)
  iir_kernels  the IIR kernels and the RNG span kernel on the arguments
            their wrappers received (world_tpu_torch/tools/iir_bench.py):
            iir_zero_phase (float64 decimation and smoothing) in
            exact_path and cli_manip; lti_state_scan (the block-LTI
            state) in main_22k, main_48k and the first batch of
            longform_48k; randn_span in exact_path's four
            calls a rate, stream_exact_22k and cli_manip; each against
            its plain version (NaN at the same places, torch.equal
            elsewhere), with its times, the plain version's, the bytes or
            operations bound, the chain bound (dependent steps x the
            latency of one, world_tpu_torch/tools/iir_chain.cu: the
            recurrences' steps, and for randn_span the 12 xorshift steps
            of one draw) and the kernel's share of it
  refine_kernel  Harvest's float32 refinement kernel (harvest_refine)
            on the arguments its wrapper received in main_22k, main_48k
            and the first batch of longform_48k, against its plain
            version at world_tpu_torch/tools/refine_bench.py's GATES
            (surviving masks equal but for scores within 1e-4 of 2.5 or
            F0s of a range limit, F0 relative <= 1e-5, score relative <=
            1e-3), with its device ms (torch.profiler; CUDA-event ms
            where a trace did not hold every launch, as device_ms_read
            says), the plain version's ms, the operations and bytes bounds, the share of the bound
            and its launches on the paths; and the reliability pass's
            kernel (harvest_remove_unreliable) on its wrapper's
            arguments in those phases and in exact_22k / exact_48k
            (float64), against its plain version (torch.equal), with
            the same times, its bytes bound and its launches
  stonemask_kernel  StoneMask's float32 refinement kernel
            (stonemask_refine) on the arguments its wrapper received in
            dio_22k, dio_48k and corpus_batched's first batch, against
            its plain version at world_tpu_torch/tools/stonemask_bench.py's
            GATES (VUV equal, F0 relative <= 1e-6), with its device ms,
            the plain version's ms, the operations and bytes bounds, the
            share of the bound and its launches on the paths
  stage_ops the top-level torch ops each stage of one batch step issues
            (world_tpu_torch/tools/profile_step.py: stage_ops) for the
            four batch steps and the float64 exact Harvest step at 22.05
            kHz, and the kernels' launches in it (STAGE_OPS_LIMITS):
            dio.fix at most 50 ops and one dio_fix_walks launch,
            stonemask at most 6 and one stonemask_refine launch,
            harvest.contour at most 350 (400 in float64) and one
            harvest_fix_step3 launch, harvest.refine at most 6 ops and
            one harvest_refine and one harvest_remove_unreliable launch
            in float32 (at most 960 and one remove launch in float64),
            harvest.decimate at most 50, with
            four lti_state_scan launches a float32 Harvest step and two
            iir_zero_phase launches a float64 one
Then the kernels summary line (ragged, scan, contour, refinement,
reliability-pass, StoneMask and state-scan launches summed over the four batch
runs, exact_path, the cli_* phases and the mesh phases, general launches over the streaming, long-form and cli_*
phases, iir_zero_phase and randn_span launches over exact_path and the
cli_* phases; lti_state_scan's entry also names longform_48k's 3-state
case beside main_22k's; harvest_remove_unreliable's gives its device ms
and bound share at main_48k, longform_48k and exact_22k beside
main_22k's; each entry says how its device_ms was read),
the nvidia-smi line, and the final
{"ok": true, "device": ...} line.  Any failed gate raises: the script
exits non-zero and prints no final line.  Without a CUDA device, or
without the repository around it, it exits non-zero at once.
"""

import concurrent.futures
import contextlib
import functools
import json
import sys
import tempfile
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
    from world_tpu_torch.tools import iir_bench, refine_bench, stonemask_bench
    from world_tpu_torch.tools.contour_bench import recording

    recorded = {}
    with recording_ola(recorded), recording_scan(recorded), \
            recording(recorded), iir_bench.recording(recorded), \
            refine_bench.recording(recorded), \
            stonemask_bench.recording(recorded):
        step(fresh())                               # warm-up
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


@contextlib.contextmanager
def recording_ola(recorded):
    """Within the block, synthesis's calls of the ragged overlap-add leave
    their inputs in ``recorded["inputs"]`` and ``recorded["y_padded"]``
    (the last call's)."""
    from world_tpu_torch.models import synthesis

    real = synthesis.ola_accumulate_ragged

    def record(responses, offsets, row_ptr, *, y_padded):
        recorded.update(inputs=(responses, offsets, row_ptr),
                        y_padded=y_padded)
        return real(responses, offsets, row_ptr, y_padded=y_padded)

    synthesis.ola_accumulate_ragged = record
    try:
        yield recorded
    finally:
        synthesis.ola_accumulate_ragged = real


@contextlib.contextmanager
def recording_scan(recorded):
    """Within the block, synthesis's calls of the scan kernel's wrapper
    leave their input in ``recorded["scan"]`` (the last call's)."""
    from world_tpu_torch.models import synthesis

    real = synthesis.cumsum_rows

    def record(x):
        recorded["scan"] = x
        return real(x)

    synthesis.cumsum_rows = record
    try:
        yield recorded
    finally:
        synthesis.cumsum_rows = real


# The contour kernels' arguments in the phases that are not batch runs:
# CONTOUR_INPUTS[phase][wrapper name] = (args, kwargs).
CONTOUR_INPUTS = {}
# The IIR and RNG span wrappers' calls in those phases:
# IIR_INPUTS[phase][wrapper name] = [(args, kwargs), ...].
IIR_INPUTS = {}
# The refinement and reliability-pass wrappers' first calls there:
# REFINE_INPUTS[phase][wrapper name] = (args, kwargs).
REFINE_INPUTS = {}
# StoneMask's refinement wrapper's first call there:
# STONEMASK_INPUTS[phase]["stonemask_refine"] = (args, kwargs).
STONEMASK_INPUTS = {}


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
    for k in path_kernels(ola, "harvest"):
        check(launches[k.__name__] > 0,
              f"{tag}: kernel {k.__name__} never launched on the main path")
    for name in ("harvest_refine", "remove_unreliable"):
        check(launches[name] == len(times),
              f"{tag}: {name} launched {launches[name]} times in "
              f"{len(times)} steps")
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
    for k in path_kernels(ola, "dio"):
        check(launches[k.__name__] > 0,
              f"{tag}: kernel {k.__name__} never launched on the Dio path")
    check(launches["stonemask_refine"] == len(times),
          f"{tag}: stonemask_refine launched {launches['stonemask_refine']} "
          f"times in {len(times)} steps")
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
    from world_tpu_torch.tools.contour_bench import recording

    fs = scalars["fs"]
    with recording(CONTOUR_INPUTS.setdefault("dio_exact", {})):
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


# The default entry points' runs: (phase, goldens, VUV above, and sp
# held as dB (median, max) at 22.05 kHz, tests/test_torch_pipeline.py's
# gate, or as relative error (median, max) at 48 kHz,
# tests/test_torch_crossrate.py's).  Both: < 1 cent RMS, ap within 1e-5
# (the D4C golden gate), y above 100 dB.
EXACT_RATES = (("exact_22k", "goldens", 0.99, ("db", 1e-9, 1e-3)),
               ("exact_48k", "goldens_fs48", 0.98, ("rel", 1e-6, 1e-2)))
EXACT_CALLS_MOST = 20000    # top-level torch calls of one 22.05 kHz pass


def exact_path(torch, W, ola, tag, gold, vuv_min, sp_gate):
    """W.analyze(x, fs) then W.synthesize(p) with their defaults (float64,
    Harvest, the reference RNG, on the card): a first call that records
    the IIR and RNG span wrappers' inputs, a timed second call with the
    kernel counts set to 0 before it and read after, and a third that
    counts its top-level torch calls; the second's outputs against the
    goldens.  Returns the launches."""
    from world_tpu_torch.io.audio import wavread
    from world_tpu_torch.tools import iir_bench, refine_bench

    get, sc = load_goldens(gold)
    fs = sc["fs"]
    if gold == "goldens":
        x, wav_fs, _ = wavread(ROOT / "tests" / "vaiueo2d.wav")
        check(wav_fs == fs, f"{tag}: wav at {wav_fs} Hz")
    else:
        x = get("x")

    def run():
        p = W.analyze(x, fs)
        y = W.synthesize(p)
        torch.cuda.synchronize()
        return p, y

    with iir_bench.recording(IIR_INPUTS.setdefault(tag, {})), \
            refine_bench.recording(REFINE_INPUTS.setdefault(tag, {})):
        run()
    zero_counts(ola)
    t0 = time.perf_counter()
    p, y = run()
    wall = time.perf_counter() - t0
    launches = read_counts(ola)
    _, calls = iir_bench.count_torch_calls(torch, run)

    f0 = p.f0.cpu().numpy()
    vuv, cents = f0_stats(f0, get("harvest_f0"))
    sp, ref_sp = p.spectrogram.cpu().numpy(), get("cheaptrick_sp")
    kind, med_most, max_most = sp_gate
    sp_err = (10 * np.abs(np.log10(sp) - np.log10(ref_sp)) if kind == "db"
              else np.abs(sp - ref_sp) / ref_sp)
    ap_err = float(np.abs(p.aperiodicity.cpu().numpy()
                          - get("d4c_ap")).max())
    ref_y, y = get("synthesis_y"), y.cpu().numpy()
    same_len = len(y) == len(ref_y)
    snr = float(10 * np.log10(np.sum(ref_y ** 2)
                              / np.sum((ref_y - y) ** 2))) if same_len \
        else None
    result = {
        "fs": fs, "samples": len(x), "dtype": str(p.f0.dtype),
        "device": str(p.f0.device), "wall_s": wall,
        "rtf": len(x) / fs / wall, "torch_calls": calls,
        "launches": launches, "vuv_agreement": vuv, "cents_rms": cents,
        f"sp_{kind}_median": float(np.median(sp_err)),
        f"sp_{kind}_max": float(sp_err.max()), "ap_max_abs_err": ap_err,
        "y_snr_db": snr}
    emit(tag, **result)
    check(result["device"].startswith("cuda"), f"{tag}: not on the card")
    check(vuv > vuv_min and cents < 1.0,
          f"{tag}: VUV {vuv}, {cents} cents RMS")
    check(np.median(sp_err) < med_most and sp_err.max() < max_most,
          f"{tag}: sp {kind} {np.median(sp_err)}, {sp_err.max()}")
    check(ap_err < 1e-5, f"{tag}: ap {ap_err}")
    check(same_len and snr > 100.0, f"{tag}: y {snr} dB")
    if fs == 22050:
        check(calls < EXACT_CALLS_MOST,
              f"{tag}: {calls} top-level torch calls")
    for k in path_kernels(ola, "harvest", exact=True):
        check(launches[k.__name__] > 0, f"{tag}: {k.__name__} never "
              "launched")
    return launches


STREAM_RATES = (("22k", "goldens"), ("48k", "goldens_fs48"))
LONGFORM_LANES = 16
SNR_CAP = 999.0


def snr_db(ref, y):
    """SNR of ``y`` against ``ref`` over the samples where ``ref`` is
    nonzero, both cut to ref's length; SNR_CAP when they are equal."""
    out = np.zeros(len(ref))
    m = min(len(ref), len(y))
    out[:m] = y[:m]
    v = ref != 0
    err = np.sum((ref[v] - out[v]) ** 2)
    if err == 0:
        return SNR_CAP
    return float(10 * np.log10(np.sum(ref[v] ** 2) / err))


def golden_params(get, dtype):
    return tuple(get(k).astype(dtype)
                 for k in ("harvest_f0", "cheaptrick_sp", "d4c_ap"))


def frames_of(params, step):
    n = len(params[0])
    return [tuple(a[i: i + step] for a in params) for i in range(0, n, step)]


def stream(W, fs, fft, feed, bs, n_pointers, dev, **kw):
    """A StreamingSynthesizer fed the (f0, sp, ap) chunks of ``feed``,
    drained after each.  Returns (audio, synthesizer, seconds)."""
    t0 = time.perf_counter()
    s = W.StreamingSynthesizer(fs, 5.0, fft, bs, n_pointers, device=dev,
                               **kw)
    out = []
    for f0, sp, ap in feed:
        check(s.add_parameters(f0, sp, ap), "stream: ring full")
        while s.synthesis2():
            out.append(s.buffer[:bs].copy())
    s.close()
    return np.concatenate(out), s, time.perf_counter() - t0


def stream_exact(W, ola, dev):
    """float64 exact streaming on the card against the reference's own
    streaming outputs."""
    get, sc = load_goldens("goldens")
    fs, fft = sc["fs"], sc["fft_size"]
    p = golden_params(get, np.float64)
    ola.ola_accumulate.launches = 0
    y_all, s_all, t_all = stream(W, fs, fft, [p], 64, 1, dev)
    y_fr, s_fr, t_fr = stream(W, fs, fft, frames_of(p, 1), 64, 100, dev)
    launches = ola.ola_accumulate.launches
    snr_all = snr_db(get("synthesis2_y"), y_all)
    snr_fr = snr_db(get("synthesis3_y"), y_fr)
    emit("stream_exact_22k", seconds=t_all + t_fr,
         snr_all_at_once_db=snr_all, snr_frame_by_frame_db=snr_fr,
         renders=[s_all.renders, s_fr.renders], ola_accumulate=launches)
    check(snr_all > 80.0, f"stream_exact_22k: all at once {snr_all} dB")
    check(snr_fr > 80.0, f"stream_exact_22k: frame by frame {snr_fr} dB")
    check(dev == "cpu" or launches > 0,
          "stream_exact_22k: ola_accumulate never launched")
    return launches


def stream_span_vs_rows(W, ola, dev):
    """Span render (the general-mode kernel) against rows added on the
    host, float64, all parameters at once."""
    t0 = time.perf_counter()
    ola.ola_accumulate.launches = 0
    res = {}
    for tag, gold in STREAM_RATES:
        get, sc = load_goldens(gold)
        p = golden_params(get, np.float64)
        y_span, _, _ = stream(W, sc["fs"], sc["fft_size"], [p], 64, 1, dev)
        y_rows, _, _ = stream(W, sc["fs"], sc["fft_size"], [p], 64, 1, dev,
                              span_render=False)
        res[tag] = snr_db(y_rows, y_span)
    launches = ola.ola_accumulate.launches
    emit("stream_span_vs_rows", seconds=time.perf_counter() - t0,
         snr_db=res, ola_accumulate=launches)
    for tag, v in res.items():
        check(v > 200.0, f"stream_span_vs_rows {tag}: {v} dB")
    return launches


def stream_vs_cpu(W, ola, dev):
    """float32, rng "none", 7 frames per push: card against CPU."""
    get, sc = load_goldens("goldens_fs48")
    p = golden_params(get, np.float32)
    kw = dict(rng_mode="none", dtype=np.float32)
    ola.ola_accumulate.launches = 0
    y, s, t = stream(W, sc["fs"], sc["fft_size"], frames_of(p, 7), 64, 100,
                     dev, **kw)
    launches = ola.ola_accumulate.launches
    y_cpu, _, t_cpu = stream(W, sc["fs"], sc["fft_size"], frames_of(p, 7),
                             64, 100, "cpu", **kw)
    v = snr_db(y_cpu.astype(np.float64), y.astype(np.float64))
    emit("stream_vs_cpu_48k", seconds=t + t_cpu, snr_db=v,
         renders=s.renders, ola_accumulate=launches)
    check(len(y) == len(y_cpu), "stream_vs_cpu_48k: lengths differ")
    check(v > 60.0, f"stream_vs_cpu_48k: {v} dB")
    return launches


def record_general(realtime, fn):
    """Run ``fn`` recording the inputs of the largest ola_accumulate call
    the streaming render makes."""
    real = realtime.ola_accumulate
    rec = {}

    def record(responses, offsets, *, y_padded):
        if responses.shape[1] > rec.get("pulses", 0):
            rec.update(pulses=responses.shape[1], y_padded=y_padded,
                       inputs=(responses, offsets))
        return real(responses, offsets, y_padded=y_padded)

    realtime.ola_accumulate = record
    try:
        out = fn()
    finally:
        realtime.ola_accumulate = real
    return out, rec


def stream_f32(W, ola, dev, runs=5):
    """All parameters up front, float32 fast mode (bench.py:329-348):
    one discarded run, then ``runs`` timed runs with fresh content."""
    from world_tpu_torch.models import realtime

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20261016)
    res, recorded, total = {}, {}, 0
    for tag, gold in STREAM_RATES:
        get, sc = load_goldens(gold)
        fs, fft = sc["fs"], sc["fft_size"]
        f0, sp, ap = golden_params(get, np.float32)
        for bs in (64, 4096):
            kw = dict(rng_mode="fast", dtype=np.float32)
            (y0, _, _), rec = record_general(realtime, lambda: stream(
                W, fs, fft, [(f0, sp, ap)], bs, 200, dev, **kw))
            if bs == 64:
                recorded[tag] = rec
            ola.ola_accumulate.launches = 0
            times, renders = [], []
            for _ in range(runs):
                scale = np.float32(0.5 + rng.random())
                y, s, t = stream(W, fs, fft, [(f0, sp * scale, ap)], bs, 200,
                                 dev, **kw)
                times.append(t)
                renders.append(s.renders)
            launches = ola.ola_accumulate.launches
            total += launches
            audio_s = len(y) / fs
            res[f"{tag}_buf{bs}"] = {
                "audio_s": audio_s, "seconds": times,
                "rtf_median": audio_s / float(np.median(times)),
                "rtf_best": audio_s / float(np.min(times)),
                "renders_per_stream": renders, "ola_accumulate": launches}
            if tag == "22k" and bs == 64:
                ref = get("synthesis2_y")
                v = ref != 0
                m = min(len(ref), len(y0))
                out = np.zeros(len(ref))
                out[:m] = y0[:m]
                res["power_ratio_22k"] = float(np.sum(out[v] ** 2)
                                               / np.sum(ref[v] ** 2))
    emit("stream_f32", seconds=time.perf_counter() - t_phase, **res,
         span_inputs={k: [r.get("pulses"), r.get("y_padded")]
                      for k, r in recorded.items()})
    ratio = res["power_ratio_22k"]
    check(0.5 < ratio < 2.0, f"stream_f32: power ratio {ratio}")
    check(dev == "cpu" or total > 0, "stream_f32: ola_accumulate never "
          "launched")
    return total, recorded


def frame_feed(s, params, paced):
    """The real-time scenario (bench.py:356-406) through synthesizer
    ``s`` (refreshed first): one 5 ms frame per add_parameters, 64-sample
    buffers drained as they become available.  Returns (audio, call ms,
    per-buffer lag ms behind the feed's frame it needs, holds, renders)."""
    f0, sp, ap = params
    fs, bs, frame_s = s.fs, s.buffer_size, 0.005
    s.refresh()
    renders0 = s.renders
    y_total = int((len(f0) - 1) * frame_s * fs) + 1
    out, call_ms, avail, feed_t = [], [], [], []
    t0 = time.perf_counter()

    def pump():
        t1 = time.perf_counter()
        ok = s.synthesis2()
        t2 = time.perf_counter()
        call_ms.append(1e3 * (t2 - t1))
        if ok:
            out.append(s.buffer[:bs].copy())
            avail.append(t2 - t0)
        return ok

    for i in range(len(f0)):
        if paced:   # frame i arrives at t0 + 5 ms * i
            while time.perf_counter() - t0 < i * frame_s:
                if not pump():
                    time.sleep(2e-4)
        while not s.add_parameters(f0[i: i + 1], sp[i: i + 1],
                                   ap[i: i + 1]):
            pump()
        feed_t.append(time.perf_counter() - t0)
        while pump():
            pass
    deadline = time.perf_counter() + 20.0
    while len(out) * bs < y_total - bs and time.perf_counter() < deadline:
        if not pump():
            if s.synthesized_sample + bs >= s.last_location:
                break
            time.sleep(2e-4)
    nb = len(avail)
    need = np.minimum((np.ceil(np.arange(1, nb + 1) * bs / (frame_s * fs))
                       + 1).astype(int), len(feed_t) - 1)
    lag_ms = 1e3 * (np.asarray(avail) - np.asarray(feed_t)[need])
    return (np.concatenate(out), np.asarray(call_ms), lag_ms, s.holds,
            s.renders - renders0)


def stream_frame_feed(W, ola, dev):
    """The reference's real-time scenario on the card."""
    t_phase = time.perf_counter()
    get, sc = load_goldens("goldens")
    fs, fft = sc["fs"], sc["fft_size"]
    p = golden_params(get, np.float32)
    t0 = time.perf_counter()
    s = W.StreamingSynthesizer(
        fs, 5.0, fft, 64, 250, rng_mode="fast", dtype=np.float32,
        hold_on_miss=True, dispatch_min_pulses=2, hold_force_ms=8.0,
        device=dev).warmup()
    warmup_s = time.perf_counter() - t0
    frame_feed(s, p, paced=False)                  # discarded
    ola.ola_accumulate.launches = 0
    y, call_ms, _, holds, renders = frame_feed(s, p, paced=False)
    yp, call_p, lag_ms, holds_p, renders_p = frame_feed(s, p, paced=True)
    launches = ola.ola_accumulate.launches
    s.close()
    y_ref, _, _ = stream(W, fs, fft, [p], 64, 250, dev, rng_mode="fast",
                         dtype=np.float32)
    v = snr_db(y_ref.astype(np.float64), y.astype(np.float64))
    v_paced = snr_db(y_ref.astype(np.float64), yp.astype(np.float64))
    prime = min(32, len(lag_ms) // 2)
    emit("stream_frame_feed", seconds=time.perf_counter() - t_phase,
         warmup_s=warmup_s,
         unpaced={"call_ms_p50": float(np.percentile(call_ms, 50)),
                  "call_ms_p99": float(np.percentile(call_ms, 99)),
                  "call_ms_max": float(call_ms.max()), "calls": len(call_ms),
                  "holds": holds, "renders": renders, "snr_db": v},
         paced={"call_ms_p50": float(np.percentile(call_p, 50)),
                "call_ms_p99": float(np.percentile(call_p, 99)),
                "call_ms_max": float(call_p.max()), "holds": holds_p,
                "renders": renders_p, "snr_db": v_paced,
                "priming_lag_ms_max": float(lag_ms[:prime].max()),
                "lag_ms_p50": float(np.percentile(lag_ms[prime:], 50)),
                "lag_ms_p99": float(np.percentile(lag_ms[prime:], 99)),
                "lag_ms_max": float(lag_ms[prime:].max())},
         ola_accumulate=launches)
    check(v > 80.0, f"stream_frame_feed: {v} dB against all-up-front")
    check(v_paced > 80.0, f"stream_frame_feed paced: {v_paced} dB")
    return launches


def long_vowelish(fs, seconds, seed=1):
    """tests/test_longform.py::_long_vowelish (that module imports JAX)."""
    rng = np.random.RandomState(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    f0 = 130.0 + 25.0 * np.sin(2 * np.pi * 0.4 * t)
    phase = np.cumsum(2 * np.pi * f0 / fs)
    x = np.sin(phase) + 0.4 * np.sin(2 * phase + 0.3) \
        + 0.15 * np.sin(3 * phase + 1.1) + 0.003 * rng.randn(n)
    return 0.3 * x / np.abs(x).max()


def chunk_stats(f0_c, sp_c, f0, sp, chunk_seconds):
    """tests/test_longform.py's interior-frame statistics: (frames voiced
    in both, VUV agreement, 95th percentile cents, median sp dB)."""
    f0_c, sp_c, f0, sp = (np.asarray(a, np.float64)
                          for a in (f0_c, sp_c, f0, sp))
    n = len(f0)
    core = int(round(chunk_seconds / 0.005))
    interior = np.ones(n, bool)
    for b in range(0, n, core):
        interior[max(0, b - 2): b + 3] = False
    both = (f0 > 0) & (f0_c > 0) & interior
    vuv = float(((f0 > 0) == (f0_c > 0))[interior].mean())
    cents = float(np.percentile(1200 * np.abs(np.log2(f0_c[both]
                                                      / f0[both])), 95))
    db = float(np.median(np.abs(10 * np.log10(sp_c[both] / sp[both]))))
    return {"both": int(both.sum()), "n": n, "vuv": vuv, "cents_p95": cents,
            "sp_median_db": db}


def longform_check(W, dev, fs=16000, seconds=12.0, chunk=4.0):
    """Chunked against whole-signal analysis on the card."""
    from world_tpu_torch.parallel import analyze_long

    t0 = time.perf_counter()
    x = long_vowelish(fs, seconds)
    _, f0_c, sp_c, _ = analyze_long(x, fs, chunk_seconds=chunk,
                                    halo_seconds=0.2, f0_method="dio",
                                    device=dev)
    p = W.analyze(x, fs, f0_method="dio", device=dev)
    dio = chunk_stats(f0_c, sp_c, p.f0.cpu().numpy(),
                      p.spectrogram.cpu().numpy(), chunk)
    x32 = x.astype(np.float32)
    _, f0_c, sp_c, _ = analyze_long(x32, fs, chunk_seconds=chunk,
                                    f0_method="harvest", device=dev)
    tp, f0 = W.harvest(x32, fs, device=dev)
    sp = W.cheap_trick(x32, fs, tp, f0, device=dev)
    harvest = chunk_stats(f0_c, sp_c, f0.cpu().numpy(), sp.cpu().numpy(),
                          chunk)
    emit("longform_check", seconds=time.perf_counter() - t0, dio=dio,
         harvest=harvest)
    for name, r in (("dio", dio), ("harvest", harvest)):
        check(r["both"] > r["n"] // 2 and r["vuv"] > 0.99
              and r["cents_p95"] < 1.0 and r["sp_median_db"] < 0.1,
              f"longform_check {name}: {r}")


def longform_48k(torch, W, dev, seconds=300.0, lanes=LONGFORM_LANES):
    """300 s of 48 kHz int16 (bench.py:217-225) through analyze_long."""
    from world_tpu_torch.models import codec
    from world_tpu_torch.parallel import analyze_long, longform
    from world_tpu_torch.tools import iir_bench, refine_bench
    from world_tpu_torch.tools.contour_bench import longform_int16, recording

    t_phase = time.perf_counter()
    fs = 48000
    xi = longform_int16(seconds, fs)
    kw = dict(chunk_seconds=6.25, f0_method="harvest", device=dev)
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    in_flight = []
    real_init = longform._Batch.__init__

    def init(self, outs, d):
        in_flight.append(1)
        real_init(self, outs, d)

    real_result = longform._Batch.result

    def result(self):
        in_flight.append(-1)
        return real_result(self)

    longform._Batch.__init__, longform._Batch.result = init, result
    try:
        t0 = time.perf_counter()
        with recording(CONTOUR_INPUTS.setdefault("longform_48k", {})), \
                iir_bench.recording(IIR_INPUTS.setdefault("longform_48k",
                                                          {})), \
                refine_bench.recording(REFINE_INPUTS.setdefault(
                    "longform_48k", {})):
            tp, f0, sp, ap = analyze_long(xi, fs, codec_dims=CODEC_DIMS,
                                          batch_lanes=lanes, **kw)
        wall = time.perf_counter() - t0
    finally:
        longform._Batch.__init__, longform._Batch.result = (real_init,
                                                            real_result)
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else None
    n_aper = W.get_number_of_aperiodicities(fs)
    F = W.get_samples_for_dio(fs, len(xi), 5.0)
    shapes = [list(a.shape) for a in (f0, sp, ap)]
    finite = bool(all(np.isfinite(a).all() for a in (f0, sp, ap)))

    # The first 60 s: int16 + codec against float32 uncoded, coded after
    # (rng "none": the fast dither of a chunk depends on its batch row).
    n60 = 60 * fs
    kw60 = dict(kw, rng_mode="none", batch_lanes=lanes)
    _, f0_b, csp_b, cap_b = analyze_long(xi[:n60], fs, codec_dims=CODEC_DIMS,
                                         **kw60)
    _, f0_a, sp_a, ap_a = analyze_long(
        (xi[:n60].astype(np.float64) / 32768.0).astype(np.float32), fs,
        **kw60)
    fft = W.get_fft_size_for_cheaptrick(fs)
    csp_a = codec.code_spectral_envelope(sp_a.astype(np.float64), fs,
                                         CODEC_DIMS, fft, device=dev)
    cap_a = codec.code_aperiodicity(ap_a.astype(np.float64), fs, fft,
                                    device=dev)

    def slack(got, want):
        want = want.cpu().numpy()
        return float((np.abs(got - want) - 2e-3 * np.abs(want)).max())

    coded = {"sp_slack": slack(csp_b, csp_a), "ap_slack": slack(cap_b, cap_a),
             "f0_max_abs_diff": float(np.abs(f0_b - f0_a).max())}
    emit("longform_48k", seconds=time.perf_counter() - t_phase,
         audio_s=seconds, wall_s=wall, rtf=seconds / wall,
         batch_lanes=lanes, batches=in_flight.count(1),
         batches_in_flight_max=int(np.cumsum(in_flight).max()),
         peak_device_bytes=peak, shapes=shapes, finite=finite,
         first_60s=coded)
    check(finite, "longform_48k: non-finite output")
    check(shapes == [[F], [F, CODEC_DIMS], [F, n_aper]],
          f"longform_48k: shapes {shapes}")
    check(coded["sp_slack"] <= 2e-3 and coded["ap_slack"] <= 2e-3,
          f"longform_48k: coded first 60 s differ: {coded}")
    check(int(np.cumsum(in_flight).max()) <= longform.IN_FLIGHT,
          "longform_48k: too many batches in flight")


def longform_synth(W, ola, dev, seconds=60.0):
    """synthesize_long of the 48 kHz analysis of 60 s."""
    from world_tpu_torch.parallel import analyze_long, synthesize_long

    t_phase = time.perf_counter()
    fs = 48000
    x = long_vowelish(fs, seconds).astype(np.float32)
    _, f0, sp, ap = analyze_long(x, fs, chunk_seconds=6.25,
                                 f0_method="dio", batch_lanes=LONGFORM_LANES,
                                 device=dev)
    ola.ola_accumulate.launches = 0
    t0 = time.perf_counter()
    y = synthesize_long(f0, sp, ap, fs, device=dev)
    wall = time.perf_counter() - t0
    launches = ola.ola_accumulate.launches
    seg = y[: (len(y) // 2048) * 2048].reshape(-1, 2048).astype(np.float64)
    rms = seg.std(axis=1)
    emit("longform_synth", seconds=time.perf_counter() - t_phase,
         audio_s=len(y) / fs, wall_s=wall, rtf=len(y) / fs / wall,
         length_ratio=len(y) / len(x),
         rms_min_over_median=float(rms.min() / np.median(rms)),
         finite=bool(np.isfinite(y).all()), ola_accumulate=launches)
    check(len(y) > 0.9 * len(x), "longform_synth: short output")
    check(np.isfinite(y).all(), "longform_synth: non-finite output")
    check(rms.min() > 0.05 * np.median(rms), "longform_synth: dropouts")
    check(dev == "cpu" or launches > 0,
          "longform_synth: ola_accumulate never launched")
    return launches


def wav_lsb(path, ref_path):
    """(max |difference| in LSB, share of samples differing, lengths
    equal) between two 16-bit wavs."""
    import wave

    def read(p):
        with wave.open(str(p)) as w:
            return np.frombuffer(w.readframes(w.getnframes()),
                                 np.int16).astype(np.int64)
    a, b = read(path), read(ref_path)
    if len(a) != len(b):
        return None, None, False
    d = a - b
    return int(np.abs(d).max()), float((d != 0).mean()), True


def check_lsb(res, what):
    lsb, share, same_len = res
    check(same_len and lsb <= 1 and share < 0.01,
          f"{what}: {lsb} LSB, {share} of samples differ (length "
          f"{'equal' if same_len else 'differs'})")


def zero_counts(ola):
    for k in all_kernels(ola):
        k.launches = 0


def read_counts(ola):
    return {k.__name__: k.launches for k in all_kernels(ola)}


# The float64 input of the scan kernel in cli_manip's last synthesis.
SCAN_INPUTS = {}


def cli_manip(W, ola, tmp):
    """test.cpp's pipeline through the CLI on the card in float64:
    `test vaiueo2d.wav out.wav 2.0 1.5` and the 0.7 stretch against the
    reference binary's wavs (tests/goldens_manip/), within 1 LSB and < 1%
    of samples differing (tests/test_manipulation.py's gate)."""
    import io
    import os

    from world_tpu_torch.io.audio import wavread, wavwrite
    from world_tpu_torch.tools import cli, iir_bench
    from world_tpu_torch.tools.contour_bench import recording

    t0 = time.perf_counter()
    gold = ROOT / "tests" / "goldens_manip"
    wav = ROOT / "tests" / "vaiueo2d.wav"
    cwd = os.getcwd()
    zero_counts(ola)
    os.chdir(tmp)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log, \
                recording_scan(SCAN_INPUTS), recording(
                    CONTOUR_INPUTS.setdefault("cli_manip", {})), \
                iir_bench.recording(IIR_INPUTS.setdefault("cli_manip", {})):
            rc = cli.main(["test", str(wav), "out.wav", "2.0", "1.5"])
        x, fs, _ = wavread(wav)
        p = W.analyze(x, fs, f0_option=W.HarvestOption(f0_floor=40.0),
                      device="cuda")
        sp = cli.parameter_modification_stretch(p.spectrogram, fs, 0.7,
                                                device="cuda")
        y = W.synthesis(p.f0, sp, p.aperiodicity, fs, p.frame_period,
                        fft_size=p.fft_size, device="cuda")
        wavwrite(y.cpu().numpy(), fs, "stretch07.wav")
    finally:
        os.chdir(cwd)
    launches = read_counts(ola)
    res = {f"{v}out": wav_lsb(tmp / f"{v}out.wav", gold / f"{v}out.wav")
           for v in ("01", "02", "03")}
    res["stretch07"] = wav_lsb(tmp / "stretch07.wav",
                               gold / "01out_stretch07.wav")
    emit("cli_manip", seconds=time.perf_counter() - t0, rc=rc,
         dtype=str(p.spectrogram.dtype),
         wavs={k: {"max_lsb": v[0], "share_differing": v[1]}
               for k, v in res.items()},
         timings=[ln for ln in log.getvalue().splitlines()
                  if "msec" in ln], launches=launches)
    check(rc == 0, f"cli_manip: rc {rc}")
    for k, v in res.items():
        check_lsb(v, f"cli_manip {k}")
    for k in path_kernels(ola, "harvest", exact=True) + [ola.ola_accumulate]:
        check(launches[k.__name__] > 0,
              f"cli_manip: {k.__name__} never launched")
    return launches


def cli_verify(ola):
    """`verify` on the card: the float64 exact pipeline against the
    goldens at the JAX CLI's gates."""
    import io

    from world_tpu_torch.tools import cli

    t0 = time.perf_counter()
    zero_counts(ola)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main(["verify"])
    launches = read_counts(ola)
    text = out.getvalue().strip().splitlines()
    metrics = json.loads("\n".join(text[:-1]))
    emit("cli_verify", seconds=time.perf_counter() - t0, rc=rc,
         verdict=text[-1], metrics=metrics, launches=launches)
    check(rc == 0 and text[-1] == "PASS", f"cli_verify: {text[-1]}")
    check(metrics["device"].startswith("cuda"), "cli_verify: not on the card")
    return launches


EXAMPLES = (
    ("f0analysis", "{wav}", "-o", "a.f0"),
    ("spanalysis", "{wav}", "a.f0", "-d", "40", "-o", "a.sp"),
    ("apanalysis", "{wav}", "a.f0", "-c", "-o", "a.ap"),
    ("readandsynthesis", "a.f0", "a.sp", "a.ap", "-o", "rs.wav"),
    ("analysis", "{wav}", "raw.f0", "raw.sp", "raw.ap"),
    ("synthesis", "raw.f0", "raw.sp", "raw.ap", "raw.wav"))


def cli_examples(ola, tmp):
    """The reference examples through the CLI on the card and, with
    WORLD_TPU_PLATFORM=cpu, on the CPU: every wav within 1 LSB and < 1%
    of samples differing, and the parameter files side by side."""
    import os

    from world_tpu_torch.io import parameterio
    from world_tpu_torch.tools import cli

    t0 = time.perf_counter()
    wav = str(ROOT / "tests" / "vaiueo2d.wav")
    cwd = os.getcwd()
    dirs = {"cuda": tmp / "card", "cpu": tmp / "cpu"}
    seconds, launches = {}, None
    try:
        for where, d in dirs.items():
            d.mkdir()
            os.chdir(d)
            if where == "cpu":
                os.environ[cli.PLATFORM_VAR] = "cpu"
            else:
                zero_counts(ola)
            t1 = time.perf_counter()
            for argv in EXAMPLES:
                rc = cli.main([a.format(wav=wav) for a in argv])
                check(rc == 0, f"cli_examples {where} {argv[0]}: rc {rc}")
            seconds[where] = time.perf_counter() - t1
            if where == "cuda":
                launches = read_counts(ola)
    finally:
        os.environ.pop(cli.PLATFORM_VAR, None)
        os.chdir(cwd)
    card, cpu = dirs["cuda"], dirs["cpu"]
    wavs = {k: wav_lsb(card / k, cpu / k) for k in ("rs.wav", "raw.wav")}
    f0 = [parameterio.read_f0(d / "a.f0")[1] for d in (card, cpu)]
    sp = [parameterio.read_spectral_envelope(d / "a.sp")[0]
          for d in (card, cpu)]
    ap = [parameterio.read_aperiodicity(d / "a.ap")[0] for d in (card, cpu)]
    raw_f0 = [np.fromfile(d / "raw.f0") for d in (card, cpu)]
    emit("cli_examples", seconds=seconds, launches=launches,
         wavs={k: {"max_lsb": v[0], "share_differing": v[1]}
               for k, v in wavs.items()},
         f0_max_abs_diff=float(np.abs(f0[0] - f0[1]).max()),
         coded_sp_max_abs_diff=float(np.abs(sp[0] - sp[1]).max()),
         coded_ap_max_abs_diff=float(np.abs(ap[0] - ap[1]).max()),
         raw_f0_max_abs_diff=float(np.abs(raw_f0[0] - raw_f0[1]).max()),
         seconds_total=time.perf_counter() - t0)
    for k, v in wavs.items():
        check_lsb(v, f"cli_examples {k} card vs CPU")
    return launches


CORPUS_FILES = 200


def make_corpus(d, n_files=CORPUS_FILES):
    """``n_files`` 16-bit mono wavs of batch_invariance.corpus_signals
    (half at 22.05 kHz and half at 48 kHz, the golden utterances tiled and
    cut to 1-8 s at gains 0.3-1.5, seeded), plus one broken wav.  Returns
    (paths, audio seconds of the good files)."""
    from world_tpu_torch.io.audio import wavwrite
    from world_tpu_torch.tools.batch_invariance import corpus_signals

    paths, seconds = [], 0.0
    for i, (fs, x) in enumerate(corpus_signals(n_files)):
        p = d / f"c{i:03d}_{fs}.wav"
        wavwrite(x, fs, str(p))
        paths.append(p)
        seconds += len(x) / fs
    broken = d / "broken.wav"
    broken.write_bytes(b"RIFF\x10\x00\x00\x00WAVEnot a wav at all")
    return [str(p) for p in paths] + [str(broken)], seconds


def quiet(msg):
    print(msg, file=sys.stderr, flush=True)


def corpus_ref(W, tmp, paths):
    """The per-file CorpusRunner (Harvest, fast mode, float64 from the
    wav reader) and the batched runner writing the tagged reference
    format, on the five shortest files at each rate: every tagged
    .f0/.sp/.ap read back through io/parameterio with the file's rate,
    fft size, frame count and valid values."""
    from world_tpu_torch import config
    from world_tpu_torch.io import parameterio
    from world_tpu_torch.io.audio import peek_header
    from world_tpu_torch.tools.batch_invariance import BUCKETS
    from world_tpu_torch.utils.corpus import BatchedCorpusRunner, CorpusRunner

    t0 = time.perf_counter()
    headers = {p: peek_header(p) for p in paths[:-1]}
    picked = []
    for fs in (22050, 48000):
        mine = sorted((n, p) for p, (n, f) in headers.items() if f == fs)
        picked += [p for _, p in mine[:5]]
    runs = {
        "per_file": CorpusRunner(str(tmp / "ref_file"), f0_method="harvest",
                                 rng_mode="fast", log=quiet, device="cuda"),
        "batched": BatchedCorpusRunner(
            str(tmp / "ref_batched"), fs=None, bucket_seconds=list(BUCKETS),
            batch_size=16, output_format="ref", log=quiet, device="cuda")}
    metrics, tracks, problems = {}, {}, []
    for name, runner in runs.items():
        t1 = time.perf_counter()
        m = runner.run(picked)
        metrics[name] = dict(m, seconds=time.perf_counter() - t1)
        tracks[name] = []
        for p in picked:
            n, fs = headers[p]
            stem = Path(runner.out_dir) / Path(p).stem
            fft = config.get_fft_size_for_cheaptrick(fs)
            nf = config.get_samples_for_dio(fs, n, 5.0)
            _, f0 = parameterio.read_f0(f"{stem}.f0")
            sp, sp_meta = parameterio.read_spectral_envelope(f"{stem}.sp")
            ap, ap_meta = parameterio.read_aperiodicity(f"{stem}.ap")
            tracks[name].append(f0)
            for meta in (sp_meta, ap_meta):
                if (meta["fs"], meta["fft_size"]) != (fs, fft):
                    problems.append(f"{name} {stem.name}: header {meta}")
            if not (f0.shape == (nf,) and sp.shape == ap.shape
                    == (nf, fft // 2 + 1)):
                problems.append(f"{name} {stem.name}: shapes {f0.shape} "
                                f"{sp.shape} {ap.shape}")
            if not (np.isfinite(sp).all() and (sp > 0).all()
                    and (ap > 0).all() and (ap <= 1).all()
                    and (f0 > 0).mean() > 0.3):
                problems.append(f"{name} {stem.name}: values")
    agree = [f0_stats(a, b) for a, b in zip(tracks["per_file"],
                                            tracks["batched"])]
    emit("corpus_ref", seconds=time.perf_counter() - t0, files=len(picked),
         metrics=metrics,
         info_per_file_f64_vs_batched_f32={
             "vuv_min": min(v for v, _ in agree),
             "cents_rms_max": max(c for _, c in agree)},
         problems=problems)
    for name, m in metrics.items():
        check(m["utterances_done"] == len(picked)
              and m["utterances_failed"] == 0, f"corpus_ref {name}: {m}")
    check(not problems, f"corpus_ref: {problems}")


def corpus_batched(torch, W, tmp, paths, audio_s):
    """The JAX package's production corpus configuration on the card:
    BatchedCorpusRunner(fs=None, bucket_seconds=[2, 4, 8], batch_size=16,
    f0_method="dio", output_format="npz", codec_dims=64), float32 fast
    mode, the native loader; then for 4 files (one per rate in each of
    two buckets) the batch that held it rolled by one row and the file
    alone in a batch of 1 against what the runner wrote, and a second
    runner on the checkpoint."""
    from world_tpu_torch import config
    from world_tpu_torch.io.audio import peek_header, wavread
    from world_tpu_torch.io.parameterio import read_npz
    from world_tpu_torch.tools import stonemask_bench
    from world_tpu_torch.tools.batch_invariance import BUCKETS, picked_batches
    from world_tpu_torch.utils.corpus import BatchedCorpusRunner

    t0 = time.perf_counter()
    kw = dict(fs=None, bucket_seconds=list(BUCKETS), batch_size=16,
              f0_method="dio", output_format="npz", codec_dims=CODEC_DIMS,
              log=quiet, device="cuda")
    out = tmp / "npz"
    runner = BatchedCorpusRunner(str(out), **kw)
    dispatched = []
    real = runner._dispatch

    def dispatch(step, rows):
        dispatched.append(rows.shape)
        return real(step, rows)

    runner._dispatch = dispatch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with stonemask_bench.recording(STONEMASK_INPUTS.setdefault(
            "corpus_batched", {})):
        m = runner.run(paths)
    peak = torch.cuda.max_memory_allocated()

    # Invariance: a file's parameters do not depend on its batch.  Each
    # picked file's batch, as the runner formed it (its bucket's files in
    # order, 16 at a time, zero rows after the last), runs again rolled
    # by one row, and the file runs alone (a batch of 1).
    files = paths[:-1]
    headers = [peek_header(p) for p in files]
    diffs = []
    for fs, b, i, r, batch in picked_batches(headers):
        rows = np.zeros((16, b), np.float32)
        for j, k in enumerate(batch):
            x, _, _ = wavread(files[k])
            rows[j, :len(x)] = x
        step = W.get_batch_step(fs, b, rng_mode="fast", f0_method="dio",
                                with_synthesis=False, codec_dims=CODEC_DIMS,
                                device="cuda")
        runs = {"rolled": [t[(r + 1) % 16].cpu().numpy()
                           for t in step(np.roll(rows, 1, axis=0))[:3]],
                "alone": [t[0].cpu().numpy()
                          for t in step(rows[r][None])[:3]]}
        nf = config.get_samples_for_dio(fs, headers[i][0], 5.0)
        got = read_npz(str(out / f"{Path(files[i]).stem}.npz"))
        d = {"file": Path(files[i]).name, "bucket": b, "row": r}
        for how, outs in runs.items():
            d[how] = {key: float(np.abs(got[key] - a[:nf]).max())
                      for key, a in zip(("f0", "coded_sp", "coded_ap"), outs)}
            d[how]["vuv_equal"] = bool(
                ((got["f0"] > 0) == (outs[0][:nf] > 0)).all())
        diffs.append(d)
    m2 = BatchedCorpusRunner(str(out), **kw).run(paths)
    emit("corpus_batched", seconds=time.perf_counter() - t0,
         files=len(paths), audio_s_made=audio_s,
         metrics={k: m[k] for k in (
             "utterances_done", "utterances_failed", "utterances_skipped",
             "audio_seconds", "frames", "wall_seconds", "frames_per_second",
             "realtime_factor", "loader")},
         batches_dispatched=len(dispatched),
         batch_shapes=sorted({tuple(s) for s in dispatched}),
         peak_device_bytes=peak, invariance=diffs,
         resume={k: m2[k] for k in ("utterances_done", "utterances_skipped",
                                    "utterances_failed")})
    good = len(paths) - 1
    check(m["utterances_done"] == good and m["utterances_failed"] == 1,
          f"corpus_batched: {m}")
    check(m["loader"] == "native", f"corpus_batched: loader {m['loader']}")
    check(len(diffs) == 4, f"corpus_batched: picked {len(diffs)} files")
    for d in diffs:
        for how in ("rolled", "alone"):
            check(d[how]["vuv_equal"]
                  and all(d[how][k] <= v for k, v in BATCH_ATOL.items()),
                  f"corpus_batched: {how} vs the runner's batch {d}")
    check(m2["utterances_done"] == 0 and m2["utterances_skipped"] == good + 1,
          f"corpus_batched resume: {m2}")


# A file's batch rolled by one row, and the file alone in a batch of 1,
# against the runner's output for it, float32, max abs difference (f0 in
# Hz, coded ap in dB).  Read on the H100 by
# world_tpu_torch/tools/batch_invariance.py on the same corpus (PERF.md,
# PR 5): this tree at most 3.1e-5 Hz, 2.2e-4 and 0.019 dB (the rounding
# of cuFFT and of the reductions at another batch count or row
# alignment); the parent commit, whose fast-mode dither was drawn over
# the batch, the same f0 and coded sp but 0.12-2.9 dB of coded ap in 7
# of its 8 readings.  Dio draws no dither and CheapTrick's barely moves
# the coded sp, so those two limits hold rounding only; the coded ap
# limit sits between this tree's readings and the parent's.
BATCH_ATOL = {"f0": 1e-4, "coded_sp": 5e-4, "coded_ap": 0.04}


# The mesh phases' step configurations: (tag, goldens, F0 method,
# codec_dims, with_synthesis).
MESH_STEPS = (("harvest_22k", "goldens", "harvest", None, True),
              ("harvest_48k", "goldens_fs48", "harvest", None, True),
              ("dio_22k", "goldens", "dio", CODEC_DIMS, True),
              ("dio_48k", "goldens_fs48", "dio", CODEC_DIMS, True))


def golden_batch(torch, gold, seconds=None):
    """(fs, batch): main_path's and dio_path's first batch of 16 from the
    golden utterance of tests/<gold>/, tiled to ``seconds`` if given."""
    get, sc = load_goldens(gold)
    x = get("x").astype(np.float32)
    if seconds is not None:
        n = int(seconds * sc["fs"])
        x = np.tile(x, -(-n // len(x)))[:n]
    return sc["fs"], batch_maker(torch, x)()


def timed(torch, fn, reps=3):
    """(last result, wall ms of each of ``reps`` synchronized calls)."""
    out, times = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def mesh_nccl(torch, W, ola, tmp):
    """The mesh on nccl in this process: a world of one rank,
    make_mesh(1, 1), the Harvest and Dio (codec 64) steps on the golden
    batches at full width, analyze_long on longform_check's signal and
    allreduce_metrics, each bit-equal to the unsharded call."""
    import torch.distributed as dist

    from world_tpu_torch.parallel import analyze_long, pipeline
    from world_tpu_torch.utils import distributed

    t_phase = time.perf_counter()
    distributed.initialize(f"file://{tmp / 'nccl_store'}", 1, 0,
                           device="cuda")
    res, launches = {}, {k.__name__: 0 for k in all_kernels(ola)}
    try:
        backend = dist.get_backend()
        mesh = pipeline.make_mesh(1, 1)
        for tag, gold, method, codec_dims, synth in MESH_STEPS:
            fs, xb = golden_batch(torch, gold)
            kw = dict(rng_mode="fast", f0_method=method,
                      codec_dims=codec_dims, with_synthesis=synth)
            want = W.make_batch_step(fs, xb.shape[1], device="cuda",
                                     **kw)(xb)
            step = W.make_batch_step(fs, xb.shape[1], mesh=mesh, **kw)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(ola)
            shard, times = timed(torch, lambda: step(xb))
            counts = read_counts(ola)
            peak = torch.cuda.max_memory_allocated() - base
            got = pipeline.gather_outputs(shard, mesh)
            for k, v in counts.items():
                launches[k] += v
            res[tag] = {
                "step_ms": times, "peak_bytes_over_base": peak,
                "launches": counts,
                "equal": [bool(torch.equal(a, b)) for a, b in zip(got,
                                                                  want)]}
        x = long_vowelish(16000, 12.0)
        kw = dict(chunk_seconds=4.0, halo_seconds=0.2, f0_method="dio")
        long_m = analyze_long(x, 16000, mesh=mesh, **kw)
        long_u = analyze_long(x, 16000, device="cuda", **kw)
        res["analyze_long_equal"] = [bool(np.array_equal(a, b))
                                     for a, b in zip(long_m, long_u)]
        voiced = float((long_m[1] > 0).sum())
        res["allreduce_metrics"] = distributed.allreduce_metrics(
            {"voiced_frames": voiced, "note": "dropped"}, mesh=mesh)
    finally:
        dist.destroy_process_group()
    emit("mesh_nccl", seconds=time.perf_counter() - t_phase,
         backend=backend, mesh=[1, 1], **res)
    check(backend == "nccl", f"mesh_nccl: backend {backend}")
    for tag, _, method, *_ in MESH_STEPS:
        check(all(res[tag]["equal"]),
              f"mesh_nccl {tag}: sharded != unsharded {res[tag]['equal']}")
        for k in path_kernels(ola, method):
            check(res[tag]["launches"][k.__name__] > 0,
                  f"mesh_nccl {tag}: {k.__name__} never launched")
    check(all(res["analyze_long_equal"]),
          f"mesh_nccl analyze_long: {res['analyze_long_equal']}")
    check(res["allreduce_metrics"] == {"voiced_frames": voiced},
          f"mesh_nccl allreduce_metrics: {res['allreduce_metrics']}")
    return launches


def mesh_cases(n):
    """The cases of a mesh phase of ``n`` ranks (n divides 16): (tag,
    goldens, seconds or None, F0 method, codec_dims, with_synthesis,
    mesh shape).  The analysis case is the corpus runner's step
    configuration on 4 s rows."""
    return (("harvest_22k", "goldens", None, "harvest", None, True,
             (n // 2, 2)),
            ("dio_48k", "goldens_fs48", None, "dio", CODEC_DIMS, True,
             (n, 1)),
            ("dio_analysis_48k_4s", "goldens_fs48", 4.0, "dio", CODEC_DIMS,
             False, (1, n)))


def _mesh_rank(rank, world, store, out_dir, backend):
    """One rank of a mesh phase, on card rank % cards over ``backend``.
    Per case of mesh_cases(world): the unsharded step, then the sharded
    one (its all_gather calls counted, its kernels' inputs recorded),
    their peak memory over the baseline and step ms, and the gathered
    outputs against the unsharded ones.  Writes rank<rank>.json to
    ``out_dir``."""
    import torch
    import torch.distributed as dist

    import world_tpu_torch as W
    from world_tpu_torch.models import codec
    from world_tpu_torch.ops import ola, scan
    from world_tpu_torch.parallel import pipeline
    from world_tpu_torch.utils import distributed

    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"file://{store}", world, rank, device="cuda",
                           backend=backend)
    gathers = [0]
    real_all_gather = dist.all_gather

    def counting(*a, **k):
        gathers[0] += 1
        return real_all_gather(*a, **k)

    res = {"rank": rank, "backend": dist.get_backend(), "cases": {}}
    dist.all_gather = counting
    try:
        meshes = {}
        for tag, gold, seconds, method, codec_dims, synth, shape in \
                mesh_cases(world):
            if shape not in meshes:
                meshes[shape] = pipeline.make_mesh(*shape)
            mesh = meshes[shape]
            fs, xb = golden_batch(torch, gold, seconds)
            n = xb.shape[1]
            kw = dict(rng_mode="fast", f0_method=method,
                      codec_dims=codec_dims, with_synthesis=synth)
            plain = W.make_batch_step(fs, n, device="cuda", **kw)
            sharded = W.make_batch_step(fs, n, mesh=mesh, **kw)
            plain(xb)                                    # warm-up
            sharded(xb)

            def peak_over_base(step):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step(xb)
                torch.cuda.synchronize()
                return torch.cuda.max_memory_allocated() - base

            plain_peak = peak_over_base(plain)
            gathers[0] = 0
            peak = peak_over_base(sharded)
            n_gathers = gathers[0]
            want, plain_ms = timed(torch, lambda: plain(xb))
            zero_counts(ola)
            recorded = {}
            with recording_ola(recorded), recording_scan(recorded):
                shard, ms = timed(torch, lambda: sharded(xb))
            launches = read_counts(ola)
            fft = W.get_fft_size_for_cheaptrick(fs)

            def coded(outs):   # held to BATCH_ATOL through the codec
                f0, sp, ap, y = outs
                if codec_dims is None:
                    sp = codec.code_spectral_envelope_batch(
                        sp, fs, fft, CODEC_DIMS)
                    ap = codec.code_aperiodicity_batch(ap, fs, fft)
                return [f0, sp, ap, y]

            def max_abs(a, b):
                return {k: float((u - v).abs().max())
                        for k, u, v in zip(("f0", "coded_sp", "coded_ap",
                                            "y"), a, b) if u is not None}

            got = coded(pipeline.gather_outputs(shard, mesh))
            want = coded(want)
            # The unsharded step on this rank's rows alone, cut to its
            # frames: what the shard computes, less the rounding of the
            # 16-row batch's shapes.
            rows = BATCH // shape[0]
            d_rank = mesh.get_local_rank("data")
            lo, _, real = pipeline.frame_split(
                W.get_samples_for_dio(fs, n, 5.0), shape[1],
                mesh.get_local_rank("frame"))
            f0_m, sp_m, ap_m, y_m = plain(
                xb[d_rank * rows:(d_rank + 1) * rows])
            mine = coded([f0_m[:, lo:lo + real], sp_m[:, lo:lo + real],
                          ap_m[:, lo:lo + real], y_m])
            case = {
                "mesh": list(shape), "step_ms": ms, "plain_step_ms": plain_ms,
                "gathers_per_step": n_gathers, "launches": launches,
                "shard_shapes": [None if t is None else list(t.shape)
                                 for t in shard],
                "peak_bytes": peak, "plain_peak_bytes": plain_peak,
                "max_abs_diff": max_abs(got[:3], want[:3]),
                "same_rows_max_abs_diff": max_abs(coded(shard), mine)}
            if synth:
                y, y_ref = got[3].double(), want[3].double()
                case["y_snr_db"] = min(
                    snr_db(r.cpu().numpy(), v.cpu().numpy())
                    for r, v in zip(y_ref, y))
                resp, offs, row_ptr = recorded["inputs"]
                yp = recorded["y_padded"]
                case["replay_max_abs_err"] = {
                    "ola_accumulate_ragged": float((
                        ola.ola_accumulate_ragged(resp, offs, row_ptr,
                                                  y_padded=yp)
                        - ola.ola_ragged_plain(resp, offs, row_ptr, yp)
                    ).abs().max()),
                    "cumsum_rows": float((
                        scan.cumsum_rows(recorded["scan"])
                        - scan.cumsum_rows_plain(recorded["scan"])
                    ).abs().max())}
            if shape[1] > 1 and synth:
                # The step's gather alone: its packed (rows, frames per
                # rank, 2K+1) float32 buffer over the mesh's backend.
                per = pipeline.frame_split(
                    W.get_samples_for_dio(fs, n, 5.0), shape[1], 0)[1]
                buf = torch.zeros(BATCH // shape[0], per, fft + 3,
                                  device="cuda")
                parts = [torch.empty_like(buf) for _ in range(shape[1])]
                _, g_ms = timed(torch, lambda: real_all_gather(
                    parts, buf, group=mesh.get_group("frame")), reps=5)
                case["gather_buffer"] = list(buf.shape)
                case["gather_ms"] = g_ms
            res["cases"][tag] = case
    finally:
        dist.all_gather = real_all_gather
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def mesh_ranks(ola, tmp, phase, world, backend):
    """``world`` ranks spawned after the kernels are built, over
    ``backend``, one per card while there are cards, else sharing them.
    mesh_cases(world): the Harvest step with synthesis at mesh
    (world/2, 2) (22.05 kHz, F = 159, odd: the pad is used), the Dio step
    with codec 64 (48 kHz) at (world, 1), the Dio analysis step (codec
    64) on 4 s rows at 48 kHz at (1, world).  Sharded against unsharded
    within BATCH_ATOL (cuFFT's rounding at another batch shape) and y
    above 60 dB SNR; each rank's shard shape; one all_gather per
    synthesis step with frames sharded and none otherwise; the analysis
    step's per-rank peak below the unsharded one's; the ragged and scan
    kernels launched and equal to their plain versions on the recorded
    inputs."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    d = tmp / phase
    d.mkdir()
    mp.spawn(_mesh_rank, args=(world, str(d / "store"), str(d), backend),
             nprocs=world, join=True)
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(world)]
    launches = {k.__name__: sum(c["launches"][k.__name__]
                                for r in ranks for c in r["cases"].values())
                for k in all_kernels(ola)}
    summary = {}
    for tag, *_ in mesh_cases(world):
        cases = [r["cases"][tag] for r in ranks]
        summary[tag] = {
            "max_abs_diff": {k: max(c["max_abs_diff"][k] for c in cases)
                             for k in BATCH_ATOL},
            "atol": BATCH_ATOL,
            "peak_ratio": [c["peak_bytes"] / c["plain_peak_bytes"]
                           for c in cases]}
    emit(phase, seconds=time.perf_counter() - t_phase,
         backend=[r["backend"] for r in ranks], summary=summary,
         ranks=ranks, launches=launches)
    for r in ranks:
        check(r["backend"] == backend, f"{phase}: {r['backend']}")
        for tag, _, _, method, _, synth, shape in mesh_cases(world):
            c = r["cases"][tag]
            what = f"{phase} rank {r['rank']} {tag}"
            for k, lim in BATCH_ATOL.items():
                check(c["max_abs_diff"][k] <= lim,
                      f"{what}: {k} {c['max_abs_diff'][k]} > {lim}")
            rows = BATCH // shape[0]
            check(c["gathers_per_step"] == (1 if synth and shape[1] > 1
                                            else 0),
                  f"{what}: {c['gathers_per_step']} all_gather per step")
            sizes = c["shard_shapes"]
            check(sizes[0][0] == rows and sizes[1][:2] == sizes[0]
                  and sizes[2][:2] == sizes[0],
                  f"{what}: shard shapes {sizes}")
            for k in path_kernels(ola, method, synth):
                check(c["launches"][k.__name__] > 0,
                      f"{what}: {k.__name__} never launched")
            if synth:
                check(c["y_snr_db"] > 60.0, f"{what}: y {c['y_snr_db']} dB")
                check(all(v == 0.0 for v in
                          c["replay_max_abs_err"].values()),
                      f"{what}: kernel != plain {c['replay_max_abs_err']}")
            else:
                check(sizes[3] is None, f"{what}: y returned")
                check(c["peak_bytes"] < c["plain_peak_bytes"],
                      f"{what}: peak {c['peak_bytes']} not below the "
                      f"unsharded {c['plain_peak_bytes']}")
    return launches


def scaling_phase(torch, sizes=(1, 2)):
    """`python -m world_tpu_torch.tools scaling --devices 1,2 --seconds 1
    --iters 3` on the card: one row per mesh size (on one card the second
    is two ranks sharing it over gloo: contention, not scaling; not
    gated on efficiency)."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "world_tpu_torch.tools", "scaling",
         "--devices", ",".join(map(str, sizes)), "--seconds", "1",
         "--iters", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"scaling: rc {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    emit("scaling", seconds=time.perf_counter() - t0, result=rec)
    check(rec["metric"] == "scaling_efficiency" and rec["platform"] == "gpu",
          f"scaling: {rec}")
    check([r["devices"] for r in rec["rows"]] == list(sizes),
          f"scaling: rows {rec['rows']}")
    check(rec["rows"][0]["efficiency"] == 1.0
          and all(r["throughput_xrt"] > 0 for r in rec["rows"]),
          f"scaling: {rec['rows']}")


def all_kernels(ola):
    """Every kernel wrapper of the port (each counts its launches)."""
    from world_tpu_torch.ops import (contour, iir, refine, rng, scan,
                                     stonemask)

    return [ola.ola_accumulate, ola.ola_accumulate_ragged, scan.cumsum_rows,
            contour.dio_fix_walks, contour.harvest_fix_step3,
            iir.iir_zero_phase, iir.lti_state_scan, rng.randn_span,
            refine.harvest_refine, refine.remove_unreliable,
            stonemask.stonemask_refine]


def path_kernels(ola, f0_method, synthesis=True, exact=False):
    """The wrappers a step with ``f0_method`` must launch: the F0 stage's
    contour kernel; Harvest's decimation and smoothing (the state scan
    in float32, the zero-phase recurrence with ``exact``, float64 and the
    reference RNG; Dio at its default speed 1 does not decimate), its
    reliability pass and in float32 its refinement; Dio's StoneMask in
    float32; with ``exact`` the RNG span; and with
    synthesis the scan kernel and the OLA kernel's ragged mode
    (streaming, checked in its phases, the general mode)."""
    from world_tpu_torch.ops import contour, iir, refine, rng, scan, stonemask

    kernels = [{"dio": contour.dio_fix_walks,
                "harvest": contour.harvest_fix_step3}[f0_method]]
    if f0_method == "dio" and not exact:
        kernels.append(stonemask.stonemask_refine)
    if f0_method == "harvest":
        kernels.append(iir.iir_zero_phase if exact else iir.lti_state_scan)
        kernels.append(refine.remove_unreliable)
        if not exact:
            kernels.append(refine.harvest_refine)
    if exact:
        kernels.append(rng.randn_span)
    return kernels + ([ola.ola_accumulate_ragged, scan.cumsum_rows]
                      if synthesis else [])


CONTOUR_CASES = ("main_22k/harvest_fix_step3", "main_48k/harvest_fix_step3",
                 "dio_22k/dio_fix_walks", "dio_48k/dio_fix_walks",
                 "dio_exact/dio_fix_walks", "longform_48k/harvest_fix_step3",
                 "cli_manip/harvest_fix_step3")
# (F0 method, float64 exact): [(stage, most torch ops it runs, a
# kernel, its launches in the whole step)].  A float32 Harvest step runs
# the state scan twice in decimation and twice in the smoothing, and the
# refinement and the reliability pass once (harvest.refine: their four
# output allocations); a float64 one the zero-phase recurrence once in
# each and the reliability pass once after its bucketed FFTs.  A float32
# Dio step runs StoneMask's refinement once (its output allocation and
# the positions' expand).
STAGE_OPS_LIMITS = {
    ("dio", False): [("dio.fix", 50, "dio_fix_walks", 1),
                     ("stonemask", 6, "stonemask_refine", 1)],
    ("harvest", False): [("harvest.contour", 350, "harvest_fix_step3", 1),
                         ("harvest.decimate", 50, "lti_state_scan", 4),
                         ("harvest.refine", 6, "harvest_refine", 1),
                         ("harvest.refine", 6, "remove_unreliable", 1)],
    ("harvest", True): [("harvest.contour", 400, "harvest_fix_step3", 1),
                        ("harvest.decimate", 50, "iir_zero_phase", 2),
                        ("harvest.refine", 960, "remove_unreliable", 1)]}


def stage_ops_phase(torch, W, ola):
    """The top-level torch ops each stage of one batch step issues
    (main_*'s Harvest step, dio_*'s Dio step with codec 64, batch 16,
    float32 fast mode; and the Harvest step in float64 exact mode at
    22.05 kHz), with the kernel counts set to 0 just before the traced
    step and read just after: each stage of STAGE_OPS_LIMITS at most its
    ops, and its kernel launched as often as the step runs it."""
    from world_tpu_torch.tools.profile_step import stage_ops

    res = {}
    for tag, gold, method, codec_dims, exact in (
            ("main_22k", "goldens", "harvest", None, False),
            ("main_48k", "goldens_fs48", "harvest", None, False),
            ("dio_22k", "goldens", "dio", CODEC_DIMS, False),
            ("dio_48k", "goldens_fs48", "dio", CODEC_DIMS, False),
            ("harvest_f64_exact_22k", "goldens", "harvest", None, True)):
        fs, xb = golden_batch(torch, gold)
        if exact:
            xb = xb.double()
        step = W.make_batch_step(fs, xb.shape[1],
                                 rng_mode="exact" if exact else "fast",
                                 f0_method=method, codec_dims=codec_dims,
                                 device="cuda")
        step(xb)                                     # warm-up
        torch.cuda.synchronize()
        zero_counts(ola)
        ops = stage_ops(step, xb)
        res[tag] = {"f0_method": method, "exact": exact,
                    "dtype": str(xb.dtype), "stage_ops": ops,
                    "launches": read_counts(ola)}
    emit("stage_ops", **res)
    for tag, r in res.items():
        for stage, most, kernel, times in STAGE_OPS_LIMITS[
                r["f0_method"], r["exact"]]:
            n = r["stage_ops"].get(stage)
            k = r["launches"][kernel]
            check(n is not None and n <= most and k == times,
                  f"stage_ops {tag}: {stage} issued {n} ops (at most "
                  f"{most}) and {k} {kernel} launches ({times})")


# (phase, wrapper): the recorded calls iir_kernels measures, in order.
IIR_CASES = (("main_22k", "lti_state_scan"), ("main_48k", "lti_state_scan"),
             ("longform_48k", "lti_state_scan"),
             ("exact_22k", "iir_zero_phase"), ("exact_22k", "randn_span"),
             ("exact_48k", "iir_zero_phase"), ("exact_48k", "randn_span"),
             ("stream_exact_22k", "randn_span"),
             ("cli_manip", "iir_zero_phase"), ("cli_manip", "randn_span"))
RANDN_CALLS = {"exact_22k": 4, "exact_48k": 4}   # else the first call


def iir_picks(recorded_by_phase):
    """{case: (wrapper, args, kwargs)} of IIR_CASES: per phase the first
    call of each state size (lti_state_scan) or recurrence
    (iir_zero_phase), and the first RANDN_CALLS calls of randn_span."""
    picks = {}
    for tag, name in IIR_CASES:
        calls = recorded_by_phase.get(tag, {}).get(name, [])
        if name == "randn_span":
            keys = [str(i) for i in range(len(calls))][
                :RANDN_CALLS.get(tag, 1)]
            chosen = list(zip(keys, calls))
        else:
            chosen = {}
            for args, kwargs in calls:
                key = (f"S{args[1].shape[0]}" if name == "lti_state_scan"
                       else args[1])
                chosen.setdefault(key, (args, kwargs))
            chosen = list(chosen.items())
        for key, (args, kwargs) in chosen:
            picks[f"{tag}/{name}/{key}"] = (name, args, kwargs)
    return picks


def same_call(torch, a, b):
    """Two recorded argument lists of one wrapper, equal."""
    def same(u, v):
        if torch.is_tensor(u) and torch.is_tensor(v):
            return (u.shape == v.shape and u.dtype == v.dtype
                    and bool(torch.equal(u, v)))
        return not torch.is_tensor(u) and not torch.is_tensor(v) and u == v
    return len(a) == len(b) and all(same(u, v) for u, v in zip(a, b))


def iir_kernels_phase(torch, card, replays, launches):
    """The IIR kernels and the RNG span kernel on the calls iir_picks
    takes from the batch runs' recordings and IIR_INPUTS, each against
    its plain version on the same tensors (iir_bench.measure), beside
    ``launches``, each kernel's launches on the paths (at least one).  A
    call on the same arguments as one measured before (cli_manip's
    decimation is exact_22k's) is reported as that one, so the plain
    float64 decimation, a loop of tens of thousands of launches, runs
    once for each input."""
    from world_tpu_torch.tools import iir_bench

    recorded = dict(IIR_INPUTS)
    for tag in ("main_22k", "main_48k"):
        recorded[tag] = {"lti_state_scan": replays[tag]["lti_state_scan"]}
    picks = iir_picks(recorded)
    cases, done = {}, []
    for case, (name, args, kwargs) in picks.items():
        twin = next((c for c, n, a in done if n == name
                     and same_call(torch, a, args)), None)
        if twin is not None:
            cases[case] = dict(cases[twin], same_input_as=twin)
            continue
        cases[case] = iir_bench.measure(torch, name, args, kwargs)
        done.append((case, name, args))
    emit("iir_kernels", card=card, launches=launches, cases=cases)
    for name, n in launches.items():
        check(n > 0, f"iir_kernels: {name} never launched on the paths")
    found = {tuple(c.split("/")[:2]) for c in cases}
    check(found == set(IIR_CASES),
          f"iir_kernels: recorded {sorted(found)}, not {sorted(IIR_CASES)}")
    check_cases(cases.values(), "iir_kernels")
    return cases


REFINE_CASES = ("main_22k", "main_48k", "longform_48k")
# The reliability pass's recorded calls: the float32 ones beside the
# refinement's, and the float64 exact path's.
REMOVE_CASES = REFINE_CASES + ("exact_22k", "exact_48k")


def refine_kernel_phase(torch, card, replays, launches, flush):
    """Harvest's refinement kernel on the arguments its wrapper received
    in main_22k, main_48k and longform_48k's first batch, against its
    plain version at refine_bench.GATES, and the reliability pass's
    kernel on its wrapper's arguments there and in exact_path (float64),
    against its plain version (torch.equal), beside ``launches``, each
    kernel's launches on the paths (at least one)."""
    from world_tpu_torch.tools import refine_bench

    recorded = dict(REFINE_INPUTS)
    for tag in ("main_22k", "main_48k"):
        recorded[tag] = replays[tag]
    cases = {tag: refine_bench.measure(torch, *recorded[tag][
        "harvest_refine"], flush) for tag in REFINE_CASES}
    removes = {tag: refine_bench.measure_remove(
        torch, recorded[tag]["remove_unreliable"][0], flush)
        for tag in REMOVE_CASES}
    emit("refine_kernel", card=card, launches=launches, cases=cases,
         remove=removes)
    for name, n in launches.items():
        check(n > 0, f"refine_kernel: {name} never launched on the paths")
    for tag, c in cases.items():
        check(c["within_gates"], f"refine_kernel {tag}: kernel != plain "
              f"beyond refine_bench.GATES: {c}")
    for tag, c in removes.items():
        check(c["what"] == "kernel" and c["equal"],
              f"refine_kernel {tag}: remove kernel != plain: {c}")
    return cases, removes


STONEMASK_CASES = ("dio_22k", "dio_48k", "corpus_batched")


def stonemask_kernel_phase(torch, card, replays, launches, flush):
    """StoneMask's refinement kernel on the arguments its wrapper
    received in dio_22k, dio_48k and corpus_batched's first batch,
    against its plain version at stonemask_bench.GATES, beside
    ``launches``, its launches on the paths (at least one)."""
    from world_tpu_torch.tools import stonemask_bench

    recorded = dict(STONEMASK_INPUTS)
    for tag in ("dio_22k", "dio_48k"):
        recorded[tag] = replays[tag]
    cases = {tag: stonemask_bench.measure(torch, *recorded[tag][
        "stonemask_refine"], flush) for tag in STONEMASK_CASES}
    emit("stonemask_kernel", card=card, launches=launches, cases=cases)
    check(launches > 0, "stonemask_kernel: never launched on the paths")
    for tag, c in cases.items():
        check(c["within_gates"], f"stonemask_kernel {tag}: kernel != plain "
              f"beyond stonemask_bench.GATES: {c}")
    return cases


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
    from world_tpu_torch.ops import _cuda, ola, scan
    from world_tpu_torch.tools import contour_bench, iir_bench
    from world_tpu_torch.tools import ola_bench as bench
    from world_tpu_torch.tools import scan_bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_name()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card)

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _cuda.CSRC.glob("*.cu"))
    # The kernels and the dependent-add, -divide and IIR-chain
    # microbenchmarks, built together.
    builds = {s: functools.partial(_cuda.build, s) for s in sources}
    builds["dadd_chain"] = scan_bench.build_dadd
    builds["div_chain"] = contour_bench.build_div
    builds["iir_chain"] = iir_bench.build_chain
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = {k: pool.submit(f) for k, f in builds.items()}
        logs = {k: f.result() for k, f in futures.items()}
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(builds),
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
    # The default entry points, float64 with the reference RNG, counts
    # set to 0 before the timed call and read after it.
    exact_runs = {tag: exact_path(torch, W, ola, tag, gold, vuv, sp_gate)
                  for tag, gold, vuv, sp_gate in EXACT_RATES}

    # Streaming and long-form, each with the kernel counts set to 0 just
    # before it and read just after (general-mode launches per phase).
    with iir_bench.recording(IIR_INPUTS.setdefault("stream_exact_22k", {})):
        general = {"stream_exact_22k": stream_exact(W, ola, "cuda")}
    general.update({
        "stream_span_vs_rows": stream_span_vs_rows(W, ola, "cuda"),
        "stream_vs_cpu_48k": stream_vs_cpu(W, ola, "cuda")})
    general["stream_f32"], stream_rec = stream_f32(W, ola, "cuda")
    general["stream_frame_feed"] = stream_frame_feed(W, ola, "cuda")
    longform_check(W, "cuda")
    longform_48k(torch, W, "cuda")
    general["longform_synth"] = longform_synth(W, ola, "cuda")

    # The CLI (float64 on the card, counts set to 0 before each phase and
    # read after) and the corpus runners, all files in a temporary
    # directory.
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        for sub in ("manip", "examples", "corpus"):
            (tmp / sub).mkdir()
        cli_runs = {"cli_manip": cli_manip(W, ola, tmp / "manip"),
                    "cli_verify": cli_verify(ola),
                    "cli_examples": cli_examples(ola, tmp / "examples")}
        paths, audio_s = make_corpus(tmp / "corpus")
        corpus_ref(W, tmp, paths)
        corpus_batched(torch, W, tmp, paths, audio_s)

        # The mesh: nccl in this process (a world of one), two ranks on
        # this card over gloo, and the CLI's scaling.  Counts set to 0
        # before each step and read after it (in the ranks for the
        # two-rank phase).
        mesh_runs = {"mesh_nccl": mesh_nccl(torch, W, ola, tmp),
                     "mesh_2rank_card": mesh_ranks(
                         ola, tmp, "mesh_2rank_card", 2, "gloo")}
        scaling_phase(torch)

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


    # Both modes on the inputs each batch path's ragged call received (the
    # general mode on their padded layout), and the general mode on one
    # stream_f32 span render's inputs at each rate.  The kernels line
    # reports the 22.05 kHz Harvest path's ragged case and the 22.05 kHz
    # stream's general case.
    at_paths = {}
    for tag, rec in replays.items():
        inputs, yp = rec["inputs"], rec["y_padded"]
        at_paths[tag] = {
            "ragged": bench.measure(torch, ola, "ragged", inputs, yp, flush),
            "general": bench.measure(torch, ola, "general",
                                     bench.to_padded(torch, *inputs), yp,
                                     flush)}
    for tag, rec in stream_rec.items():
        at_paths[f"stream_{tag}"] = {"general": bench.measure(
            torch, ola, "general", rec["inputs"], rec["y_padded"], flush)}
    emit("kernels_at_path", card=card, ola=at_paths)
    check_cases([c for v in at_paths.values() for c in v.values()],
                "kernels_at_path")

    # The scan kernel on the phase increments each batch path (float32)
    # and cli_manip's last synthesis (float64) gave it, against its plain
    # version (torch.cumsum of the float64 rows on the CPU): bit-equal.
    scans = {tag: scan_bench.measure_scan(torch, scan, rec["scan"], flush)
             for tag, rec in replays.items()}
    scans["cli_manip"] = scan_bench.measure_scan(
        torch, scan, SCAN_INPUTS["scan"], flush)
    emit("scan_kernel", card=card, scan=scans)
    check_cases(scans.values(), "scan_kernel")

    # The contour kernels on the arguments their wrappers received in the
    # batch runs, dio_exact, longform_48k's first batch and cli_manip,
    # against their plain versions: bit-equal.
    walks = {}
    for tag, rec in list(replays.items()) + list(CONTOUR_INPUTS.items()):
        for name in ("dio_fix_walks", "harvest_fix_step3"):
            if name in rec:
                walks[f"{tag}/{name}"] = contour_bench.measure(
                    torch, name, *rec[name], flush)
    emit("contour_kernels", card=card, walks=walks)
    check(sorted(walks) == sorted(CONTOUR_CASES),
          f"contour_kernels: recorded {sorted(walks)}")
    check_cases(walks.values(), "contour_kernels")
    def path_launches(name):
        return (sum(r["launches"][name] for r in runs.values())
                + sum(c[name] for c in cli_runs.values())
                + sum(m[name] for m in mesh_runs.values())
                + sum(e[name] for e in exact_runs.values()))

    # The IIR kernels and the RNG span kernel on the arguments their
    # wrappers received in the Harvest batch runs, exact_path,
    # stream_exact_22k, longform_48k's first batch and cli_manip.
    iirs = iir_kernels_phase(torch, card, replays, {
        name: path_launches(name)
        for name in ("iir_zero_phase", "lti_state_scan", "randn_span")})
    # Harvest's float32 refinement on the arguments its wrapper received
    # in the Harvest batch runs and longform_48k's first batch.
    refines, removes = refine_kernel_phase(
        torch, card, replays, {name: path_launches(name) for name in (
            "harvest_refine", "remove_unreliable")}, flush)
    # StoneMask's float32 refinement on the arguments its wrapper received
    # in the Dio batch runs and corpus_batched's first batch.
    stonemasks = stonemask_kernel_phase(
        torch, card, replays, path_launches("stonemask_refine"), flush)
    stage_ops_phase(torch, W, ola)

    def line(name, c, launches, source="world_tpu_torch/csrc/ola.cu",
             replaces="world_tpu/ops/pallas_ola.py:33"):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "device_ms": c["device_ms"],
            # How device_ms was read: "profiler", "cuda events" (the
            # refinement kernels' fallback where a trace lost a launch),
            # or "not measured".
            "device_ms_read": c.get("device_ms_read", "profiler" if c[
                "device_ms"] is not None else "not measured"),
            "host_us": c["host_us"],
            "library_device_ms": c["library_device_ms"],
            "shape": c["shape"], "on_main_path": True}

    general_total = sum(general.values()) + sum(
        c["ola_accumulate"] for c in cli_runs.values())
    print(json.dumps({"kernels": [
        line("ola_accumulate_ragged", at_paths["main_22k"]["ragged"],
             path_launches("ola_accumulate_ragged")),
        line("ola_accumulate", at_paths["stream_22k"]["general"],
             general_total),
        # No Pallas kernel: the JAX time base's jnp.cumsum.
        dict(line("cumsum_rows", scans["main_22k"],
                  path_launches("cumsum_rows"),
                  source="world_tpu_torch/csrc/scan.cu",
                  replaces="world_tpu/models/synthesis.py:53"),
             chain_bound_ms=scans["main_22k"]["chain_bound_ms"]),
        # No Pallas kernels: the JAX package's device loops (lax.scan,
        # lax.while_loop) of the contour walks.
        dict(line("dio_fix_walks", walks["dio_22k/dio_fix_walks"],
                  path_launches("dio_fix_walks"),
                  source="world_tpu_torch/csrc/dio_fix.cu",
                  replaces="world_tpu/models/dio.py:155-203"),
             chain_bound_ms=walks["dio_22k/dio_fix_walks"][
                 "chain_bound_ms"]),
        dict(line("harvest_fix_step3",
                  walks["main_22k/harvest_fix_step3"],
                  path_launches("harvest_fix_step3"),
                  source="world_tpu_torch/csrc/harvest_contour.cu",
                  replaces="world_tpu/models/harvest_contour.py:114-306"),
             chain_bound_ms=walks["main_22k/harvest_fix_step3"][
                 "chain_bound_ms"]),
        # No Pallas kernels: the JAX package's device loops (lax.scan,
        # lax.fori_loop) of the float64 recurrences, the block-LTI state
        # and the reference RNG.
        dict(line("iir_zero_phase", iirs["exact_22k/iir_zero_phase/decimate"],
                  path_launches("iir_zero_phase"),
                  source="world_tpu_torch/csrc/iir.cu",
                  replaces="world_tpu/ops/matlab.py:204-227"),
             also_replaces="world_tpu/models/harvest_contour.py:353-366",
             chain_bound_ms=iirs["exact_22k/iir_zero_phase/decimate"][
                 "chain_bound_ms"]),
        dict(line("lti_state_scan", iirs["main_22k/lti_state_scan/S3"],
                  path_launches("lti_state_scan"),
                  source="world_tpu_torch/csrc/iir.cu",
                  replaces="world_tpu/ops/matlab.py:167-187"),
             chain_bound_ms=iirs["main_22k/lti_state_scan/S3"][
                 "chain_bound_ms"],
             longform_48k={k: iirs["longform_48k/lti_state_scan/S3"][k]
                           for k in ("shape", "device_ms", "ms",
                                     "bound_ms", "chain_bound_ms")}),
        dict(line("randn_span", iirs["exact_22k/randn_span/0"],
                  path_launches("randn_span"),
                  source="world_tpu_torch/csrc/xorshift.cu",
                  replaces="world_tpu/ops/rng.py:82-102"),
             chain_bound_ms=iirs["exact_22k/randn_span/0"][
                 "chain_bound_ms"]),
        # No Pallas kernel: the JAX package's float32 refinement stage
        # (_refine_frame_direct under _refine_all's while-loops).
        dict(line("harvest_refine", refines["main_22k"],
                  path_launches("harvest_refine"),
                  source="world_tpu_torch/csrc/refine.cu",
                  replaces="world_tpu/models/harvest.py:265-435"),
             also_replaces="world_tpu/models/harvest.py:487-594",
             **{f"{tag}_device_ms": refines[tag]["device_ms"]
                for tag in ("main_48k", "longform_48k")}),
        # No Pallas kernel: the JAX package's _remove_unreliable, an XLA
        # fusion over (F, M, M) distances.
        dict(line("harvest_remove_unreliable", removes["main_22k"],
                  path_launches("remove_unreliable"),
                  source="world_tpu_torch/csrc/refine.cu",
                  replaces="world_tpu/models/harvest.py:602-621"),
             **{f"{tag}_device_ms": removes[tag]["device_ms"]
                for tag in ("main_48k", "longform_48k", "exact_22k")},
             **{f"{tag}_bound_share": removes[tag]["bound_share"]
                for tag in ("main_22k", "main_48k", "longform_48k",
                            "exact_22k")}),
        # No Pallas kernel: the JAX package's float32 StoneMask
        # (_refine_direct under vmap over the frames).
        dict(line("stonemask_refine", stonemasks["dio_22k"],
                  path_launches("stonemask_refine"),
                  source="world_tpu_torch/csrc/stonemask.cu",
                  replaces="world_tpu/models/stonemask.py:110-168"),
             also_replaces="world_tpu/models/stonemask.py:193-211",
             **{f"{tag}_device_ms": stonemasks[tag]["device_ms"]
                for tag in ("dio_48k", "corpus_batched")})]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
