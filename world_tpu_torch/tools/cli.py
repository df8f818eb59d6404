"""Command-line tools mirroring the reference examples (port of
world_tpu/tools/cli.py).

Subcommands (the reference examples, examples/ of the C++ WORLD):
  f0analysis        -- Harvest F0 -> .f0 file   (parameter_io/f0analysis.cpp)
  spanalysis        -- CheapTrick -> .sp file, optional codec -d dims
                       (parameter_io & codec_test spanalysis.cpp)
  apanalysis        -- D4C -> .ap file, optional codec -c
                       (parameter_io & codec_test apanalysis.cpp)
  readandsynthesis  -- three files -> wav, auto-decoding coded params
                       (readandsynthesis.cpp; NOD header selects decoding)
  analysis          -- raw-binary dump pipeline (analysis_synthesis/analysis.cpp)
  synthesis         -- raw-binary synthesis (analysis_synthesis/synthesis.cpp)
  test              -- full pipeline with manipulation + 3 synthesis
                       variants (test/test.cpp)
  verify            -- float64 exact pipeline against a golden directory

Every subcommand runs in float64 (the reference file formats are
float64) on the CUDA card; WORLD_TPU_PLATFORM=cpu runs it on the CPU.

Usage: python -m world_tpu_torch.tools <subcommand> ...
"""

import argparse
import json
import os
import struct
import sys
import time

import numpy as np
import torch

PLATFORM_VAR = "WORLD_TPU_PLATFORM"


def _device():
    """The device every subcommand runs on: WORLD_TPU_PLATFORM ("cpu" or
    "cuda"), else the card (raising when there is none).  TF32 stays off:
    the float64 outputs are held to the reference within 1 LSB."""
    from ..device import resolve_device

    name = os.environ.get(PLATFORM_VAR) or None
    if name not in (None, "cpu", "cuda"):
        raise ValueError(f"{PLATFORM_VAR}={name!r}: expected cpu or cuda")
    dev = resolve_device(name)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _np(t):
    return t.cpu().numpy()


def _read_wav(path):
    from ..io.audio import wavread
    return wavread(path)


def cmd_f0analysis(argv):
    p = argparse.ArgumentParser(prog="f0analysis",
                                description="F0 estimation by Harvest")
    p.add_argument("input")
    p.add_argument("-f", dest="f0_floor", type=float, default=71.0,
                   help="floor of frequency range (Hz)")
    p.add_argument("-c", dest="f0_ceil", type=float, default=800.0,
                   help="ceil of frequency range (Hz)")
    p.add_argument("-s", dest="shift", type=float, default=5.0,
                   help="shift length (ms)")
    p.add_argument("-o", dest="output", default="output.f0")
    p.add_argument("-t", dest="text", action="store_true",
                   help="write text format")
    a = p.parse_args(argv)
    dev = _device()
    from .. import HarvestOption, harvest
    from ..io.parameterio import write_f0
    x, fs, _ = _read_wav(a.input)
    tp, f0 = harvest(x, fs, HarvestOption(f0_floor=a.f0_floor,
                                          f0_ceil=a.f0_ceil,
                                          frame_period=a.shift), device=dev)
    write_f0(a.output, _np(f0), a.shift, temporal_positions=_np(tp),
             text=a.text)


def cmd_spanalysis(argv):
    p = argparse.ArgumentParser(prog="spanalysis",
                                description="CheapTrick spectral envelope")
    p.add_argument("input")
    p.add_argument("f0file")
    p.add_argument("-f", dest="fft_size", type=int, default=0)
    p.add_argument("-q", dest="q1", type=float, default=-0.15)
    p.add_argument("-d", dest="dims", type=int, default=0,
                   help="number of coding coefficients (0 = no coding)")
    p.add_argument("-o", dest="output", default="output.sp")
    a = p.parse_args(argv)
    dev = _device()
    from .. import CheapTrickOption, cheap_trick
    from ..io.parameterio import (get_header_information, read_f0,
                                  write_spectral_envelope)
    from ..models.codec import code_spectral_envelope
    x, fs, _ = _read_wav(a.input)
    tp, f0 = read_f0(a.f0file)
    frame_period = get_header_information(a.f0file, "FP  ")
    option = CheapTrickOption(q1=a.q1, fft_size=a.fft_size).resolve(fs)
    sp = cheap_trick(x, fs, tp, f0, option, device=dev)
    if a.dims:
        coded = code_spectral_envelope(sp, fs, a.dims, option.fft_size,
                                       device=dev)
        write_spectral_envelope(a.output, _np(coded), fs, frame_period,
                                option.fft_size, a.dims)
    else:
        write_spectral_envelope(a.output, _np(sp), fs, frame_period,
                                option.fft_size, 0)


def cmd_apanalysis(argv):
    p = argparse.ArgumentParser(prog="apanalysis",
                                description="D4C band aperiodicity")
    p.add_argument("input")
    p.add_argument("f0file")
    p.add_argument("-f", dest="fft_size", type=int, default=0)
    p.add_argument("-t", dest="threshold", type=float, default=0.85)
    p.add_argument("-c", dest="coded", action="store_true",
                   help="store coded (coarse) aperiodicity")
    p.add_argument("-o", dest="output", default="output.ap")
    a = p.parse_args(argv)
    dev = _device()
    from .. import D4COption, d4c, get_fft_size_for_cheaptrick
    from ..io.parameterio import (get_header_information, read_f0,
                                  write_aperiodicity)
    from ..models.codec import code_aperiodicity
    x, fs, _ = _read_wav(a.input)
    tp, f0 = read_f0(a.f0file)
    frame_period = get_header_information(a.f0file, "FP  ")
    fft_size = a.fft_size or get_fft_size_for_cheaptrick(fs)
    ap = d4c(x, fs, tp, f0, fft_size, D4COption(threshold=a.threshold),
             device=dev)
    if a.coded:
        coded = _np(code_aperiodicity(ap, fs, fft_size, device=dev))
        write_aperiodicity(a.output, coded, fs, frame_period, fft_size,
                           coded.shape[1])
    else:
        write_aperiodicity(a.output, _np(ap), fs, frame_period, fft_size, 0)


def cmd_readandsynthesis(argv):
    p = argparse.ArgumentParser(prog="readandsynthesis",
                                description="synthesize from parameters")
    p.add_argument("f0file")
    p.add_argument("spfile")
    p.add_argument("apfile")
    p.add_argument("-o", dest="output", default="output.wav")
    a = p.parse_args(argv)
    dev = _device()
    from .. import get_number_of_aperiodicities, synthesis
    from ..io.audio import wavwrite
    from ..io.parameterio import (read_aperiodicity, read_f0,
                                  read_spectral_envelope)
    from ..models.codec import decode_aperiodicity, decode_spectral_envelope
    tp, f0 = read_f0(a.f0file)
    sp, meta = read_spectral_envelope(a.spfile)
    ap, ap_meta = read_aperiodicity(a.apfile)
    fs, fft_size = meta["fs"], meta["fft_size"]
    frame_period = meta["frame_period"]
    if meta["number_of_dimensions"]:
        sp = decode_spectral_envelope(sp, fs, fft_size, device=dev)
    if ap_meta["number_of_dimensions"]:
        if ap.shape[1] != get_number_of_aperiodicities(fs):
            raise ValueError(f"{a.apfile}: {ap.shape[1]} coded bands, "
                             f"{get_number_of_aperiodicities(fs)} expected")
        ap = decode_aperiodicity(ap, fs, fft_size, device=dev)
    y_length = int(len(f0) * frame_period / 1000.0 * fs)
    y = synthesis(f0, sp, ap, fs, frame_period, y_length=y_length,
                  fft_size=fft_size, device=dev)
    wavwrite(_np(y), fs, a.output)


def cmd_analysis(argv):
    """Raw-binary pipeline (examples/analysis_synthesis/analysis.cpp):
    Dio+StoneMask -> CheapTrick -> D4C, dumped as headerless doubles
    (spectrogram file carries int32 fs + float64 frame_period)."""
    p = argparse.ArgumentParser(prog="analysis")
    p.add_argument("input")
    p.add_argument("f0file")
    p.add_argument("spfile")
    p.add_argument("apfile")
    a = p.parse_args(argv)
    dev = _device()
    from .. import analyze
    x, fs, _ = _read_wav(a.input)
    params = analyze(x, fs, f0_method="dio", device=dev)
    _np(params.f0).astype(np.float64).tofile(a.f0file)
    with open(a.spfile, "wb") as f:
        f.write(struct.pack("<i", fs))
        f.write(struct.pack("<d", params.frame_period))
        f.write(_np(params.spectrogram).astype(np.float64).tobytes())
    _np(params.aperiodicity).astype(np.float64).tofile(a.apfile)


def cmd_synthesis(argv):
    """Raw-binary synthesis (examples/analysis_synthesis/synthesis.cpp)."""
    p = argparse.ArgumentParser(prog="synthesis")
    p.add_argument("f0file")
    p.add_argument("spfile")
    p.add_argument("apfile")
    p.add_argument("output")
    a = p.parse_args(argv)
    dev = _device()
    from .. import synthesis as synth
    from ..io.audio import wavwrite
    f0 = np.fromfile(a.f0file)
    with open(a.spfile, "rb") as f:
        fs = struct.unpack("<i", f.read(4))[0]
        frame_period = struct.unpack("<d", f.read(8))[0]
        sp = np.frombuffer(f.read(), np.float64).reshape(len(f0), -1)
    ap = np.fromfile(a.apfile).reshape(len(f0), -1)
    fft_size = 2 * (sp.shape[1] - 1)
    y = synth(f0, sp, ap, fs, frame_period, fft_size=fft_size, device=dev)
    wavwrite(_np(y), fs, a.output)


def parameter_modification_stretch(sp, fs, ratio, device=None):
    """Spectral stretching exactly as test/test.cpp:230-253: linear
    interp1 of the LOG envelope from the stretched frequency axis
    ``ratio*i/fft_size*fs`` back onto the linear axis, then (for
    ratio < 1) a flat fill above ``fft_size/2*ratio`` with the value
    just below the fill start.  ``sp`` (frames, fft_size/2+1), numpy or
    a tensor; returns a tensor on ``device`` (the GPU unless given)."""
    from ..device import as_tensor, resolve_device
    from ..ops.matlab import interp1

    sp = as_tensor(sp, resolve_device(device))
    half = sp.shape[1] - 1
    fft_size = 2 * half
    # The axes in host float64, as test.cpp computes them.
    i = np.arange(half + 1, dtype=np.float64)
    freq1 = as_tensor(ratio * i / fft_size * fs, sp.device, sp.dtype)
    freq2 = as_tensor(i / fft_size * fs, sp.device, sp.dtype)
    out = torch.exp(interp1(freq1, torch.log(sp), freq2))
    if ratio < 1.0:
        j0 = int(fft_size / 2.0 * ratio)
        out[:, j0:] = out[:, j0 - 1:j0]
    return out


def _stream(synth, f0, sp, ap, n_out, chunked):
    """Drive test.cpp's streaming loop: all frames at once, or one frame
    per add_parameters; 64-sample buffers copied into ``n_out`` samples."""
    out = np.zeros(n_out)
    index = 0

    def drain():
        nonlocal index
        while synth.synthesis2():
            take = min(64, n_out - index)
            if take > 0:
                out[index: index + take] = synth.buffer[:take]
            index += 64

    if chunked:
        for i in range(len(f0)):
            synth.add_parameters(f0[i: i + 1], sp[i: i + 1], ap[i: i + 1])
            drain()
    else:
        i = 0
        while i < len(f0):
            if synth.add_parameters(f0[i:], sp[i:], ap[i:]):
                i = len(f0)
            drain()
    return out


def cmd_test(argv):
    """Full pipeline like test/test.cpp: analysis -> optional F0 scaling /
    spectral stretching -> batch synthesis + both streaming variants."""
    p = argparse.ArgumentParser(prog="test")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("f0_scale", type=float, nargs="?", default=1.0)
    p.add_argument("spec_stretch", type=float, nargs="?", default=1.0)
    a = p.parse_args(argv)
    dev = _device()
    from .. import HarvestOption, analyze, synthesis
    from ..io.audio import wavwrite
    from ..models.realtime import StreamingSynthesizer
    x, fs, nbit = _read_wav(a.input)
    print(f"File information\nSampling : {fs} Hz {nbit} Bit\n"
          f"Length {len(x)} [sample]\nLength {len(x) / fs} [sec]")

    t0 = time.time()
    # test.cpp:145 lowers the Harvest floor to 40 Hz (below kFloorF0).
    params = analyze(x, fs, f0_option=HarvestOption(f0_floor=40.0),
                     device=dev)
    print(f"Analysis: {(time.time() - t0) * 1000:.0f} [msec]")

    # ParameterModification (test/test.cpp:221-258)
    f0 = params.f0 * a.f0_scale
    sp = params.spectrogram
    if a.spec_stretch != 1.0:
        sp = parameter_modification_stretch(sp, fs, a.spec_stretch,
                                            device=dev)
    ap = params.aperiodicity

    t0 = time.time()
    y = _np(synthesis(f0, sp, ap, fs, params.frame_period,
                      fft_size=params.fft_size, device=dev))
    print(f"Synthesis 1: {(time.time() - t0) * 1000:.0f} [msec]")
    wavwrite(y, fs, "01" + a.output)

    f0, sp, ap = _np(f0), _np(sp), _np(ap)
    for variant, (slots, chunked) in (("02", (1, False)),
                                      ("03", (100, True))):
        t0 = time.time()
        with StreamingSynthesizer(fs, params.frame_period, params.fft_size,
                                  64, slots, device=dev) as synth:
            out = _stream(synth, f0, sp, ap, len(y), chunked)
        print(f"Synthesis {variant}: {(time.time() - t0) * 1000:.0f} [msec]")
        wavwrite(out, fs, variant + a.output)
    print("complete.")


def cmd_verify(argv):
    """Verification mode: run the float64 exact-RNG pipeline, where the
    CLI runs, against a golden directory dumped from the C++ reference
    and print accuracy metrics (F0 cents RMSE, envelope error,
    resynthesis SNR).  Returns 0 on PASS."""
    p = argparse.ArgumentParser(prog="verify")
    p.add_argument("goldens", nargs="?", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tests", "goldens"))
    a = p.parse_args(argv)
    dev = _device()
    import world_tpu_torch as W

    scalars = {}
    shapes = {}
    with open(os.path.join(a.goldens, "manifest.txt")) as f:
        for line in f:
            parts = line.split()
            if parts[0] == "scalar":
                scalars[parts[1]] = int(parts[2])
            else:
                shapes[parts[0]] = tuple(int(v) for v in parts[1:])

    def g(name):
        return np.fromfile(os.path.join(a.goldens, name + ".f64")) \
            .reshape(shapes[name])

    def cents_rmse(f0, ref):
        v = (f0 > 0) & (ref > 0)
        cents = 1200.0 * np.log2(f0[v] / ref[v])
        return float(np.sqrt(np.mean(cents**2)))

    fs = scalars["fs"]
    fft_size = scalars["fft_size"]
    x = g("x")
    tp, f0 = W.harvest(x, fs, device=dev)
    ref = g("harvest_f0")
    sp = W.cheap_trick(x, fs, tp, f0, device=dev)
    ap = W.d4c(x, fs, tp, f0, device=dev)
    y = _np(W.synthesis(f0, sp, ap, fs, frame_period=5.0, device=dev))
    f0, sp, ap = _np(f0), _np(sp), _np(ap)
    ry = g("synthesis_y")
    n = min(len(y), len(ry))

    # dio + stonemask speed path (reference test.cpp:83-137).  StoneMask
    # refines the *golden* dio track so its gate measures the refiner,
    # not compounded dio deltas (same policy as tests/test_f0.py).
    _, df0 = W.dio(x, fs, device=dev)
    df0 = _np(df0)
    dio_ref = g("dio_f0")
    smf0 = _np(W.stone_mask(x, fs, g("dio_tp"), dio_ref, device=dev))
    sm_ref = g("stonemask_f0")

    # codec round trip from the golden parameters (test/codec_test)
    csp = W.code_spectral_envelope(g("cheaptrick_sp"), fs, scalars["sp_dim"],
                                   fft_size=fft_size, device=dev)
    dsp = _np(W.decode_spectral_envelope(csp, fs, fft_size, device=dev))
    cap = W.code_aperiodicity(g("d4c_ap"), fs, fft_size=fft_size, device=dev)
    dap = _np(W.decode_aperiodicity(cap, fs, fft_size, device=dev))

    # streaming (Synthesis2 ring buffer) vs the reference's own
    # streaming output golden (test.cpp variant 2: queue all, 1 slot)
    gf0, gsp, gap = g("harvest_f0"), g("cheaptrick_sp"), g("d4c_ap")
    ry2 = g("synthesis2_y")
    with W.StreamingSynthesizer(fs, 5.0, fft_size, 64, 1,
                                device=dev) as synth:
        ys = _stream(synth, gf0, gsp, gap, len(ry2), chunked=False)
    live = np.abs(ry2) > 0

    out = {
        "device": str(dev),
        "vuv_agreement": float(((f0 > 0) == (ref > 0)).mean()),
        "f0_rmse_cents": cents_rmse(f0, ref),
        "dio_vuv_agreement": float(((df0 > 0) == (dio_ref > 0)).mean()),
        "dio_rmse_cents": cents_rmse(df0, dio_ref),
        "stonemask_rmse_cents": cents_rmse(smf0, sm_ref),
        "envelope_max_rel_err": float(
            np.max(np.abs(sp - g("cheaptrick_sp")) / g("cheaptrick_sp"))),
        "aperiodicity_max_abs_err": float(
            np.max(np.abs(ap - g("d4c_ap")))),
        "codec_sp_max_rel_err": float(
            np.max(np.abs(dsp - g("decoded_sp")) / g("decoded_sp"))),
        "codec_ap_max_abs_err": float(
            np.max(np.abs(dap - g("decoded_ap")))),
        "resynthesis_snr_db": float(10 * np.log10(
            np.sum(ry[:n]**2) / np.sum((ry[:n] - y[:n])**2))),
        "streaming_snr_db": float(10 * np.log10(
            np.sum(ry2[live]**2) / np.sum((ry2[live] - ys[live])**2))),
    }
    print(json.dumps(out, indent=2))
    # The JAX CLI's gates (world_tpu/tools/cli.py:413-423), set just
    # below the exact-mode values: a real regression cannot print PASS.
    ok = (out["f0_rmse_cents"] < 1e-6
          and out["resynthesis_snr_db"] > 150.0
          and out["envelope_max_rel_err"] < 1e-3
          and out["aperiodicity_max_abs_err"] < 1e-6
          and out["vuv_agreement"] == 1.0
          and out["dio_vuv_agreement"] == 1.0
          and out["dio_rmse_cents"] < 1e-6
          and out["stonemask_rmse_cents"] < 1e-6
          and out["codec_sp_max_rel_err"] < 1e-9
          and out["codec_ap_max_abs_err"] < 1e-9
          and out["streaming_snr_db"] > 150.0)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


# The JAX CLI's "scaling" subcommand runs the device mesh, which is not
# ported yet (ROADMAP queue-1 item 13).
COMMANDS = {
    "f0analysis": cmd_f0analysis,
    "spanalysis": cmd_spanalysis,
    "apanalysis": cmd_apanalysis,
    "readandsynthesis": cmd_readandsynthesis,
    "analysis": cmd_analysis,
    "synthesis": cmd_synthesis,
    "test": cmd_test,
    "verify": cmd_verify,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 1
    return COMMANDS[argv[0]](argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
