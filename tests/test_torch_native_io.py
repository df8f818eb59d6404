"""The port's native wav library (world_tpu_torch/io/native.py over
world_tpu_torch/native/worldio.cpp, built with g++ at first use): the
cases of tests/test_native_io.py, plus the loader it reports, the
Python fallback, and a file at another rate counted as failed.
Tolerance: samples equal to the Python reader's (atol 0 in float64, 1e-7
after the float32 cast), written bytes identical."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from world_tpu_torch.io import audio, native  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "vaiueo2d.wav")


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_native_wavread_matches_python(lib, gold):
    x, fs, nbit = native.wavread(FIXTURE)
    assert fs == gold.scalar("fs") and nbit == 16
    np.testing.assert_allclose(x, gold["x"], atol=0)


def test_native_wavwrite_matches_python(lib, tmp_path):
    x = np.sin(np.arange(777) * 0.03) * 0.8
    p1, p2 = tmp_path / "n.wav", tmp_path / "p.wav"
    native.wavwrite(x, 16000, str(p1))
    audio.wavwrite(x, 16000, str(p2))
    assert p1.read_bytes() == p2.read_bytes()


def _corpus(tmp_path, rates=(22050,) * 5):
    paths = []
    for i, fs in enumerate(rates):
        x = np.sin(np.arange(1000 + 100 * i) * 0.01) * 0.5
        p = tmp_path / f"u{i}.wav"
        audio.wavwrite(x, fs, str(p))
        paths.append(str(p))
    return paths + [str(tmp_path / "missing.wav")]


def test_native_batch_loader(lib, tmp_path):
    paths = _corpus(tmp_path)
    batch, lengths, fs, failed, loader = native.load_batch(paths, 2048)
    assert loader == "native"
    assert fs == 22050
    assert batch.shape == (6, 2048)
    assert failed == [5]
    assert list(lengths[:5]) == [1000, 1100, 1200, 1300, 1400]
    ref, _, _ = audio.wavread(paths[0])
    np.testing.assert_allclose(batch[0, :1000], ref.astype(np.float32),
                               atol=1e-7)
    assert batch[0, 1000:].max() == 0.0


def test_python_fallback_matches_native(lib, tmp_path, monkeypatch):
    """Without the library the Python loader runs, says so, and packs the
    same batch; the first file sets fs and a file at another rate fails
    in both."""
    paths = _corpus(tmp_path, rates=(22050, 22050, 16000, 22050, 22050))
    want = native.load_batch(paths, 1200)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    got = native.load_batch(paths, 1200)
    assert want[4] == "native" and got[4] == "python"
    assert want[3] == got[3] == [2, 5] and want[2] == got[2] == 22050
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    x, fs, nbit = native.wavread(FIXTURE)
    assert (fs, nbit) == (22050, 16) and len(x) == 17500


def test_library_is_built_into_build_dir(lib):
    """Built from the package's source into _build/, under a name that
    carries a hash of source and flags."""
    from world_tpu_torch.ops import _cuda

    path = _cuda.hashed_path(native.SRC, native.CXX_FLAGS)
    assert path.parent == _cuda.BUILD_DIR and path.exists()
    assert path.name.startswith("libworldio-")
    assert native.SRC.parent.name == "native" and native.SRC.exists()
