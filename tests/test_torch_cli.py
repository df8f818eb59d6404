"""The port's command-line tools (world_tpu_torch.tools.cli) on the CPU
(WORLD_TPU_PLATFORM=cpu), float64: test.cpp's manipulation pipeline
against the reference binary's wavs (tests/goldens_manip/), verify, and
the example subcommands against world_tpu's CLI on the same input.

Tolerances: wavs within 1 LSB with < 1% of samples differing
(tests/test_manipulation.py's gate); tagged F0 within rtol 1e-9 of
world_tpu's (tests/test_crossrate_golden.py's voiced-F0 gate), coded sp
and coded ap within atol 1e-6 (the verify gate on aperiodicity;
mel-cepstra are of the same order), raw-binary sp within rtol 1e-3 (the
verify gate on the envelope; the two packages' CheapTrick on the Dio
track differ by up to 8.7e-5) and ap within atol 1e-6.
"""

import os
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import world_tpu_torch as W  # noqa: E402
from world_tpu.models import synthesis as jax_synthesis  # noqa: E402
from world_tpu.tools import cli as jax_cli  # noqa: E402
from world_tpu_torch.io import parameterio  # noqa: E402
from world_tpu_torch.io.audio import wavwrite  # noqa: E402
from world_tpu_torch.models import synthesis as synthesis_ops  # noqa: E402
from world_tpu_torch.tools import cli  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WAV = os.path.join(HERE, "vaiueo2d.wav")
GOLD = os.path.join(HERE, "goldens_manip")


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv(cli.PLATFORM_VAR, "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def read_wav_int16(path):
    with wave.open(path) as w:
        assert w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def assert_wavs_within_lsb(path, ref_path):
    ref = read_wav_int16(ref_path).astype(np.int64)
    got = read_wav_int16(path).astype(np.int64)
    assert got.shape == ref.shape
    d = got - ref
    assert np.abs(d).max() <= 1, np.abs(d).max()
    assert (d != 0).mean() < 0.01, (d != 0).mean()


def test_cli_test_manipulation(on_cpu):
    """harvest(floor 40) -> cheaptrick -> d4c -> f0 x2.0, stretch 1.5 ->
    batch synthesis and both streaming variants."""
    assert cli.main(["test", WAV, "out.wav", "2.0", "1.5"]) == 0
    for variant in ("01", "02", "03"):
        assert_wavs_within_lsb(str(on_cpu / f"{variant}out.wav"),
                               os.path.join(GOLD, f"{variant}out.wav"))


def test_stretch_down_flat_fill(on_cpu):
    """ratio < 1 takes the flat-fill branch (test/test.cpp:248-252);
    the stretch equals world_tpu's on the same envelope."""
    x, fs, _ = cli._read_wav(WAV)
    params = W.analyze(x, fs, f0_option=W.HarvestOption(f0_floor=40.0),
                       device="cpu")
    sp = cli.parameter_modification_stretch(params.spectrogram, fs, 0.7,
                                            device="cpu")
    want = jax_cli.parameter_modification_stretch(
        params.spectrogram.numpy(), fs, 0.7)
    np.testing.assert_allclose(sp.numpy(), want, rtol=1e-12, atol=0)
    y = W.synthesis(params.f0, sp, params.aperiodicity, fs,
                    params.frame_period, fft_size=params.fft_size,
                    device="cpu").numpy()
    wavwrite(y, fs, "ours.wav")
    assert_wavs_within_lsb("ours.wav",
                           os.path.join(GOLD, "01out_stretch07.wav"))


def test_verify_passes(on_cpu, capsys):
    assert cli.main(["verify"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("PASS") and '"device": "cpu"' in out


def test_usage_and_device_selection(on_cpu, monkeypatch, capsys):
    """No subcommand prints the usage; "scaling" waits for the mesh; the
    CLI runs on the card unless WORLD_TPU_PLATFORM says cpu."""
    assert cli.main([]) == 1 and "f0analysis" in capsys.readouterr().out
    assert "scaling" not in cli.COMMANDS
    assert set(cli.COMMANDS) == set(jax_cli.COMMANDS) - {"scaling"}
    monkeypatch.setenv(cli.PLATFORM_VAR, "tpu")
    with pytest.raises(ValueError):
        cli.main(["f0analysis", WAV])
    monkeypatch.delenv(cli.PLATFORM_VAR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["f0analysis", WAV])


def _examples(run, tag):
    """parameter_io + codec examples, then the raw-binary pair."""
    run(["f0analysis", WAV, "-o", f"{tag}.f0"])
    run(["spanalysis", WAV, f"{tag}.f0", "-d", "40", "-o", f"{tag}.sp"])
    run(["apanalysis", WAV, f"{tag}.f0", "-c", "-o", f"{tag}.ap"])
    run(["readandsynthesis", f"{tag}.f0", f"{tag}.sp", f"{tag}.ap",
         "-o", f"{tag}_rs.wav"])
    run(["analysis", WAV, f"{tag}_raw.f0", f"{tag}_raw.sp",
         f"{tag}_raw.ap"])
    run(["synthesis", f"{tag}_raw.f0", f"{tag}_raw.sp", f"{tag}_raw.ap",
         f"{tag}_raw.wav"])


def test_examples_match_jax_cli(on_cpu, monkeypatch):
    def port(argv):
        assert cli.main(argv) == 0

    def jax(argv):
        with monkeypatch.context() as m:
            m.delenv(cli.PLATFORM_VAR)
            assert jax_cli.main(argv) == 0

    _examples(port, "port")
    _examples(jax, "jax")
    _, f0 = parameterio.read_f0("port.f0")
    _, want = parameterio.read_f0("jax.f0")
    np.testing.assert_allclose(f0, want, rtol=1e-9, atol=0)
    for read, ext in ((parameterio.read_spectral_envelope, "sp"),
                      (parameterio.read_aperiodicity, "ap")):
        got, meta = read(f"port.{ext}")
        ref, ref_meta = read(f"jax.{ext}")
        assert meta == ref_meta and meta["number_of_dimensions"] > 0
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert_wavs_within_lsb("port_rs.wav", "jax_rs.wav")
    f0 = np.fromfile("port_raw.f0")
    np.testing.assert_allclose(f0, np.fromfile("jax_raw.f0"), rtol=1e-9,
                               atol=0)
    sp, ref = (open(f"{t}_raw.sp", "rb").read() for t in ("port", "jax"))
    assert sp[:12] == ref[:12]                    # int32 fs, float64 period
    np.testing.assert_allclose(np.frombuffer(sp[12:]),
                               np.frombuffer(ref[12:]), rtol=1e-3, atol=0)
    np.testing.assert_allclose(np.fromfile("port_raw.ap"),
                               np.fromfile("jax_raw.ap"), rtol=0, atol=1e-6)
    # The raw pair's track opens unvoiced, where pulses fall every 44.1
    # samples (500 Hz at 22.05 kHz) and every tenth lands on a rounding
    # tie of the phase sum.  The reference sums sequentially, as numpy,
    # torch's CPU cumsum and so the port do (pulse at 439); XLA's cumsum
    # rounds the tie the other way (440), which shifts the exact noise
    # stream of every later pulse by a draw (ROADMAP queue 3).  The wavs
    # are held within 1 LSB up to the previous pulse, whose noise the
    # shift lengthens.
    fs = 22050
    y_len = len(read_wav_int16("port_raw.wav"))
    fs_t = torch.tensor(float(fs), dtype=torch.float64)
    is_pulse = synthesis_ops._time_base(torch.as_tensor(f0)[None], fs_t,
                                        0.005, y_len,
                                        fs / 1024 + 1.0)[0][0].numpy()
    port_pulses = np.nonzero(is_pulse)[0]
    phase = np.mod(np.cumsum(np.full(1300, 2.0 * np.pi * 500.0 / fs)),
                   2.0 * np.pi)
    sequential = np.nonzero(np.abs(np.diff(phase)) > np.pi)[0]
    assert (f0[:12] == 0).all()                   # unvoiced to sample 1300
    np.testing.assert_array_equal(port_pulses[:len(sequential)], sequential)
    order, _, _, n, _ = jax_synthesis._time_base(
        jnp.asarray(f0), jnp.asarray(float(fs)), 0.005, y_len,
        fs / 1024 + 1.0, jnp.float64)
    jax_pulses = np.sort(np.asarray(order)[:int(n)])
    k = np.nonzero(jax_pulses[:len(sequential)] != sequential)[0][0]
    assert (sequential[k], jax_pulses[k]) == (439, 440)
    ours, theirs = (read_wav_int16(f"{t}_raw.wav").astype(np.int64)
                    for t in ("port", "jax"))
    assert np.abs(ours - theirs)[:sequential[k - 1] + 1].max() <= 1
