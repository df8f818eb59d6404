"""Port wav and parameter I/O (world_tpu_torch.io) against the reference
files in tests/goldens and the JAX package's writers: the same bytes,
headers and values (tests/test_io.py's checks), and npz files decoded
through the port's codec as the JAX package decodes them (rtol 1e-12)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import GOLDEN_DIR  # noqa: E402

from world_tpu.io import audio as jax_audio  # noqa: E402
from world_tpu.io import parameterio as jax_parameterio  # noqa: E402
from world_tpu.models import codec as jax_codec  # noqa: E402
from world_tpu_torch.io import audio, parameterio  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "vaiueo2d.wav")


def ref_bytes(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


def test_wavread_matches_reference(gold):
    x, fs, nbit = audio.wavread(FIXTURE)
    assert (fs, nbit) == (gold.scalar("fs"), 16)
    np.testing.assert_array_equal(x, gold["x"])
    assert audio.peek_header(FIXTURE) == (len(x), fs)
    assert audio.get_audio_length(FIXTURE) == len(x)


def test_wavwrite_matches_reference(tmp_path):
    x = (np.arange(1000) - 500) / 600.0
    audio.wavwrite(x, 22050, str(tmp_path / "ramp.wav"))
    assert (tmp_path / "ramp.wav").read_bytes() == ref_bytes("ref_ramp.wav")


def test_wav_roundtrip_and_jax_bytes(tmp_path):
    x = np.sin(np.arange(500) * 0.01) * 0.9
    audio.wavwrite(x, 16000, str(tmp_path / "t.wav"))
    jax_audio.wavwrite(x, 16000, str(tmp_path / "j.wav"))
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    y, fs, nbit = audio.wavread(str(tmp_path / "t.wav"))
    assert fs == 16000 and nbit == 16
    np.testing.assert_allclose(x, y, atol=2.5 / 32768)
    with pytest.raises(ValueError, match="RIFF/WAVE"):
        audio._parse_header(b"RIFF" + b"\0" * 60)


def _ref_params():
    n = 159
    tp = np.arange(n) * 0.005
    f0 = np.where(np.arange(n) % 7 == 0, 0.0, 100.0 + np.arange(n) * 0.25)
    sp = (np.arange(n)[:, None] * 0.001
          + np.arange(33)[None, :] * 1e-6)
    return tp, f0, sp


def test_f0_file_bytes(tmp_path):
    tp, f0, _ = _ref_params()
    parameterio.write_f0(str(tmp_path / "f0.bin"), f0, 5.0)
    assert (tmp_path / "f0.bin").read_bytes() == ref_bytes("ref_f0.bin")
    tp2, f02 = parameterio.read_f0(os.path.join(GOLDEN_DIR, "ref_f0.bin"))
    np.testing.assert_array_equal(f02, f0)
    np.testing.assert_allclose(tp2, tp, atol=1e-12)


def test_f0_text_bytes(tmp_path):
    tp, f0, _ = _ref_params()
    parameterio.write_f0(str(tmp_path / "f0.txt"), f0, 5.0,
                         temporal_positions=tp, text=True)
    assert (tmp_path / "f0.txt").read_bytes() == ref_bytes("ref_f0.txt")


@pytest.mark.parametrize("kind", ["spec", "ap"])
def test_matrix_file_bytes(tmp_path, kind):
    _, _, sp = _ref_params()
    p = str(tmp_path / f"{kind}.bin")
    ref = os.path.join(GOLDEN_DIR, f"ref_{kind}.bin")
    if kind == "spec":
        parameterio.write_spectral_envelope(p, sp, 22050, 5.0, 64)
        data, meta = parameterio.read_spectral_envelope(ref)
    else:
        parameterio.write_aperiodicity(p, sp, 22050, 5.0, 64)
        data, meta = parameterio.read_aperiodicity(ref)
    assert open(p, "rb").read() == ref_bytes(f"ref_{kind}.bin")
    np.testing.assert_array_equal(data, sp)
    assert meta == {"fs": 22050, "frame_period": 5.0, "fft_size": 64,
                    "number_of_dimensions": 0}


def test_header_information():
    path = os.path.join(GOLDEN_DIR, "ref_spec.bin")
    for tag, want in (("FS  ", 22050), ("FP  ", 5.0), ("NOF ", 159),
                      ("FFT ", 64), ("XYZ ", 0.0)):
        assert parameterio.get_header_information(path, tag) == want
        assert jax_parameterio.get_header_information(path, tag) == want


def test_npz_full_matches_jax_bytes(tmp_path):
    """Full-resolution npz: the JAX writer's arrays, float32 storage,
    exact scalar metadata; loading returns numpy."""
    rng = np.random.RandomState(11)
    F, K = 12, 33
    f0 = np.abs(rng.randn(F)) * 100
    sp = np.abs(rng.randn(F, K)) + 0.5
    ap = np.clip(np.abs(rng.randn(F, K)) * 0.3, 1e-3, 1 - 1e-12)
    p, q = str(tmp_path / "u.npz"), str(tmp_path / "j.npz")
    parameterio.write_npz(p, f0, 16000, 5.0, 64, spectrogram=sp,
                          aperiodicity=ap)
    jax_parameterio.write_npz(q, f0, 16000, 5.0, 64, spectrogram=sp,
                              aperiodicity=ap)
    got, want = parameterio.read_npz(p), jax_parameterio.read_npz(q)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    f0r, spr, apr, info = parameterio.load_npz_parameters(p, device="cpu")
    assert f0r.dtype == np.float64 and isinstance(spr, np.ndarray)
    assert info == {"fs": 16000, "frame_period": 5.0, "fft_size": 64}
    np.testing.assert_allclose(spr, sp, rtol=1e-6)
    np.testing.assert_allclose(apr, ap, rtol=1e-6)


def test_npz_coded_decodes_like_jax(tmp_path):
    """Coded npz: full-resolution sp/ap come back through the port's
    codec, equal to the JAX package's load of the same file."""
    fs, fft_size, dims = 16000, 512, 24
    rng = np.random.RandomState(12)
    F, K = 9, fft_size // 2 + 1
    f0 = np.abs(rng.randn(F)) * 100
    sp = np.exp(rng.randn(F, K) * 0.5)
    ap = np.clip(np.abs(rng.randn(F, K)) * 0.3, 1e-3, 1 - 1e-12)
    csp = np.asarray(jax_codec.code_spectral_envelope(sp, fs, dims,
                                                      fft_size), np.float32)
    cap = np.asarray(jax_codec.code_aperiodicity(ap, fs, fft_size),
                     np.float32)
    p = str(tmp_path / "c.npz")
    parameterio.write_npz(p, f0, fs, 5.0, fft_size, coded_sp=csp,
                          coded_ap=cap)
    f0r, spr, apr, info = parameterio.load_npz_parameters(p, device="cpu")
    _, want_sp, want_ap, want_info = jax_parameterio.load_npz_parameters(p)
    assert info == want_info
    assert isinstance(spr, np.ndarray) and spr.shape == (F, K)
    assert apr.shape == (F, K)
    np.testing.assert_allclose(spr, want_sp, rtol=1e-12)
    np.testing.assert_allclose(apr, want_ap, rtol=1e-12)
