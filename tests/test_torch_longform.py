"""The port's long-form analysis and synthesis
(world_tpu_torch.parallel.longform) on the CPU at small sizes.

Gates: chunked against whole-signal analysis on frames more than two
frames from a chunk edge, tests/test_longform.py's (VUV agreement
> 0.99, 95th percentile of cents < 1, median sp error < 0.1 dB); the
port's float32 analyze_long against world_tpu's on the same input,
tests/test_torch_pipeline.py's gates (test_torch_dio.f32_jax_gate on F0,
with the port's float64 analyze_long as the golden track, and median sp
error < 0.01 dB); the int16 + codec + batched run against the float
one-shot run coded afterwards within rtol/atol 2e-3
(tests/test_longform.py); streamed resynthesis longer than 0.9 of the
input with no 2048-sample segment below 0.05 of the median RMS.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import world_tpu_torch as W  # noqa: E402
from test_longform import _long_vowelish  # noqa: E402
from test_torch_dio import f32_jax_gate  # noqa: E402
from world_tpu.parallel import longform as jax_longform  # noqa: E402
from world_tpu_torch import parallel  # noqa: E402
from world_tpu_torch.models import codec  # noqa: E402
from world_tpu_torch.parallel import longform  # noqa: E402
from world_tpu_torch.parallel.longform import (analyze_long,  # noqa: E402
                                               synthesize_long)

FS = 16000


def chunk_gates(f0_c, sp_c, f0, sp, chunk_seconds):
    n = len(f0)
    core = int(round(chunk_seconds / 0.005))
    interior = np.ones(n, bool)
    for b in range(0, n, core):
        interior[max(0, b - 2): b + 3] = False
    both = (f0 > 0) & (f0_c > 0) & interior
    assert both.sum() > n // 2
    vuv = ((f0 > 0) == (f0_c > 0))[interior].mean()
    assert vuv > 0.99, vuv
    cents = 1200 * np.abs(np.log2(f0_c[both] / f0[both]))
    assert np.percentile(cents, 95) < 1.0, np.percentile(cents, 95)
    db = np.abs(10 * np.log10(sp_c[both] / sp[both]))
    assert np.median(db) < 0.1, np.median(db)


@pytest.fixture(scope="module")
def dio_6s():
    x, _ = _long_vowelish(FS, 6.0)
    return x, analyze_long(x, FS, chunk_seconds=2.0, halo_seconds=0.2,
                           f0_method="dio", device="cpu")


def test_chunked_dio_matches_direct(dio_6s):
    x, (tp_c, f0_c, sp_c, _) = dio_6s
    p = W.analyze(x, FS, f0_method="dio", device="cpu")
    f0 = p.f0.numpy()
    assert f0_c.shape == f0.shape and f0_c.dtype == np.float64
    np.testing.assert_allclose(tp_c, p.temporal_positions.numpy(),
                               atol=1e-12)
    chunk_gates(f0_c, sp_c, f0, p.spectrogram.numpy(), 2.0)


def test_chunked_harvest_matches_direct():
    """float32, the default 0.45 s halo around 1.5 s chunks."""
    x, _ = _long_vowelish(FS, 4.0)
    x = x.astype(np.float32)
    _, f0_c, sp_c, _ = analyze_long(x, FS, chunk_seconds=1.5,
                                    f0_method="harvest", device="cpu")
    assert f0_c.dtype == np.float32
    tp, f0 = W.harvest(x, FS, device="cpu")
    sp = W.cheap_trick(x, FS, tp, f0, device="cpu")
    chunk_gates(f0_c.astype(np.float64), sp_c.astype(np.float64),
                f0.double().numpy(), sp.double().numpy(), 1.5)


def test_analyze_long_matches_jax():
    """The same float32 signal through both packages' analyze_long (Dio,
    rng_mode "none")."""
    x, _ = _long_vowelish(FS, 6.0)
    kw = dict(chunk_seconds=2.0, halo_seconds=0.2, f0_method="dio",
              rng_mode="none")
    want = jax_longform.analyze_long(x.astype(np.float32), FS, **kw)
    got = analyze_long(x.astype(np.float32), FS, device="cpu", **kw)
    golden = analyze_long(x, FS, device="cpu", **kw)[1]
    assert [a.shape for a in got] == [a.shape for a in want]
    assert [a.dtype for a in got] == [a.dtype for a in want]
    np.testing.assert_array_equal(got[0], want[0])
    f0, jf0 = got[1].astype(np.float64), want[1].astype(np.float64)
    f32_jax_gate(f0, jf0, golden)
    v = (f0 > 0) & (jf0 > 0)
    err_db = np.abs(10 * np.log10(got[2][v].astype(np.float64)
                                  / want[2][v].astype(np.float64)))
    assert np.median(err_db) < 0.01, np.median(err_db)


def test_int16_codec_batches_match_float_one_shot():
    """int16 converted on the device, two-row batches and the codec on the
    device against the float one-shot path coded afterwards, in fast
    mode (a chunk's dither does not depend on its batch)."""
    x, _ = _long_vowelish(FS, 10.0)
    xi = (np.clip(x, -1, 1) * 32768).astype(np.int16)
    xf = xi.astype(np.float64) / 32768.0  # what wavread yields
    kw = dict(chunk_seconds=3.0, halo_seconds=0.2, f0_method="dio",
              rng_mode="fast", device="cpu")
    _, f0_a, sp_a, ap_a = analyze_long(xf.astype(np.float32), FS, **kw)
    _, f0_b, csp_b, cap_b = analyze_long(xi, FS, codec_dims=32,
                                         batch_lanes=2, **kw)
    assert f0_b.shape == f0_a.shape and f0_b.dtype == np.float32
    assert csp_b.shape == (len(f0_a), 32)
    assert cap_b.shape == (len(f0_a), W.get_number_of_aperiodicities(FS))
    np.testing.assert_allclose(f0_b, f0_a, rtol=2e-5, atol=1e-3)
    fft = W.get_fft_size_for_cheaptrick(FS)
    csp_a = codec.code_spectral_envelope(sp_a.astype(np.float64), FS, 32,
                                         fft, device="cpu").numpy()
    cap_a = codec.code_aperiodicity(ap_a.astype(np.float64), FS, fft,
                                    device="cpu").numpy()
    np.testing.assert_allclose(csp_b, csp_a, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(cap_b, cap_a, rtol=2e-3, atol=2e-3)


def test_synthesize_long_continuous(dio_6s):
    x, (_, f0, sp, ap) = dio_6s
    y = synthesize_long(f0, sp, ap, FS, buffer_size=2048, device="cpu")
    assert len(y) > 0.9 * len(x)
    assert np.isfinite(y).all()
    seg = y[: (len(y) // 2048) * 2048].reshape(-1, 2048)
    rms = seg.std(axis=1)
    assert rms.min() > 0.05 * np.median(rms), (rms.min(), np.median(rms))


def test_at_most_two_batches_in_flight(monkeypatch):
    """Batches are dispatched at most two ahead of the host copy of their
    results, and the batched result equals the one-batch result."""
    events = []
    real_init, real_result = longform._Batch.__init__, longform._Batch.result

    def init(self, outs, dev):
        events.append("dispatch")
        real_init(self, outs, dev)

    def result(self):
        events.append("read")
        return real_result(self)

    x, _ = _long_vowelish(FS, 2.5)
    kw = dict(chunk_seconds=0.5, halo_seconds=0.1, f0_method="dio",
              rng_mode="none", device="cpu")
    one = analyze_long(x, FS, **kw)
    monkeypatch.setattr(longform._Batch, "__init__", init)
    monkeypatch.setattr(longform._Batch, "result", result)
    got = analyze_long(x, FS, batch_lanes=1, **kw)
    assert events.count("dispatch") == 6
    assert events.index("read") <= longform.IN_FLIGHT
    outstanding = np.cumsum([1 if e == "dispatch" else -1 for e in events])
    assert outstanding.max() <= longform.IN_FLIGHT and outstanding[-1] == 0
    for a, b in zip(got, one):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_unported_mesh_and_device_selection(monkeypatch):
    """A mesh must come from make_mesh (tests/test_torch_mesh.py runs the
    real one); with no device given and no GPU, the entry points raise."""
    with pytest.raises(TypeError):
        analyze_long(np.zeros(16000), FS, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        analyze_long(np.zeros(16000), FS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthesize_long(np.full(40, 120.0), np.ones((40, 513)),
                        np.full((40, 513), 0.5), FS)


def test_exports():
    """world_tpu.parallel's names, make_mesh included."""
    from world_tpu import parallel as jax_parallel

    assert parallel.__all__ == jax_parallel.__all__
    for name in parallel.__all__:
        assert callable(getattr(parallel, name))
    assert W.StreamingSynthesizer.__name__ in W.__all__
