"""The port's main path as a whole: analyze -> synthesize, carrying the
JAX package's analysis across (world_tpu_torch.convert), and the batched
step (world_tpu_torch.parallel.pipeline), Harvest and Dio, against the
goldens and the JAX batched step.

Tolerances: float64 resynthesis of JAX's analysis matches JAX's own
synthesis at SNR > 200 dB (tests/test_synthesis.py's gate); the float32
Harvest step is held to the goldens and to JAX's float32 step at the
test_fast_mode.py gates (< 0.1 cent RMS and VUV > 99%, median sp error
< 0.01 dB, median resynthesis envelope < 0.5 dB); the float32 Dio step
meets test_torch_dio.f32_jax_gate against JAX's Dio step and the golden
StoneMask track, and the sp and envelope gates against JAX's Dio step.
Coded outputs equal the codec of the full outputs at rtol/atol 2e-4
(tests/test_corpus.py's gate)."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import world_tpu  # noqa: E402
import world_tpu_torch as W  # noqa: E402
from world_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
from world_tpu_torch.convert import world_parameters_from_numpy  # noqa: E402
from world_tpu_torch.models import codec  # noqa: E402
from world_tpu_torch.parallel import pipeline  # noqa: E402
from test_torch_dio import f32_jax_gate  # noqa: E402


def snr_db(ref, y):
    return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - y) ** 2))


def envelope_db(y, ref):
    n = (min(len(y), len(ref)) // 256) * 256
    re = ref[:n].reshape(-1, 256).std(axis=1)
    ye = y[:n].reshape(-1, 256).std(axis=1)
    act = re > re.max() * 0.03
    with np.errstate(divide="ignore"):
        return 20 * np.abs(np.log10(ye[act] / re[act]))


def f0_gate(f0, ref, max_cents):
    assert ((f0 > 0) == (ref > 0)).mean() > 0.99
    v = (f0 > 0) & (ref > 0)
    cents = 1200 * np.abs(np.log2(f0[v] / ref[v]))
    assert np.sqrt((cents ** 2).mean()) < max_cents


@pytest.fixture(scope="module")
def x_fs(gold):
    return gold["x"], gold.scalar("fs")


@pytest.fixture(scope="module")
def jax_params(x_fs):
    p = world_tpu.analyze(*x_fs)
    return {k: np.asarray(getattr(p, k)) for k in
            ("temporal_positions", "f0", "spectrogram", "aperiodicity")}, p


@pytest.fixture(scope="module")
def port_step_f32(x_fs):
    x, fs = x_fs
    x32 = x.astype(np.float32)
    step = pipeline.make_batch_step(fs, len(x), rng_mode="none",
                                    f0_method="harvest", device="cpu")
    return step(np.stack([x32, 0.7 * x32]))


@pytest.fixture(scope="module")
def dio_rows(x_fs):
    x32 = x_fs[0].astype(np.float32)
    return np.stack([x32, 0.7 * x32])


@pytest.fixture(scope="module")
def port_dio_step_f32(x_fs, dio_rows):
    step = pipeline.get_batch_step(x_fs[1], dio_rows.shape[1],
                                   rng_mode="none", device="cpu")
    return step(dio_rows)


def test_resynthesis_of_jax_analysis(x_fs, jax_params):
    """JAX analysis -> convert -> port synthesis == JAX synthesis."""
    arrays, p = jax_params
    params = world_parameters_from_numpy(
        arrays["temporal_positions"], arrays["f0"], arrays["spectrogram"],
        arrays["aperiodicity"], p.fs, p.frame_period, p.fft_size,
        device="cpu")
    assert params.spectrogram.dtype == torch.float64
    y = W.synthesize(params, rng_mode="exact", device="cpu").numpy()
    want = np.asarray(world_tpu.synthesize(p, rng_mode="exact"))
    assert snr_db(want, y) > 200.0, snr_db(want, y)


def test_analyze_synthesize_golden(gold, x_fs, jax_params):
    """The port's own float64 analysis meets the goldens and JAX's."""
    p = W.analyze(*x_fs, device="cpu")
    arrays, _ = jax_params
    f0 = p.f0.numpy()
    f0_gate(f0, gold["harvest_f0"], 1.0)
    f0_gate(f0, arrays["f0"], 1.0)
    db = 10 * np.abs(np.log10(p.spectrogram.numpy())
                     - np.log10(gold["cheaptrick_sp"]))
    assert np.median(db) < 1e-9 and db.max() < 1e-3, (np.median(db), db.max())
    y = W.synthesize(p, device="cpu").numpy()
    assert snr_db(gold["synthesis_y"], y) > 100.0, snr_db(
        gold["synthesis_y"], y)


def test_batch_step_f32_golden_gates(gold, port_step_f32):
    """test_full_fast_pipeline_f32's gates, on both rows (the second is
    the same utterance at 0.7 gain, whose f0 and envelope shape hold)."""
    f0, sp, _, y = port_step_f32
    assert f0.dtype == sp.dtype == y.dtype == torch.float32
    for row in range(2):
        f0_gate(f0[row].double().numpy(), gold["harvest_f0"], 0.1)
    db = envelope_db(y[0].double().numpy(), gold["synthesis_y"])
    assert np.median(db) < 0.5, np.median(db)
    err_db = np.abs(10 * np.log10(sp[0].double().numpy()
                                  / gold["cheaptrick_sp"]))
    assert np.median(err_db) < 0.01, np.median(err_db)


def test_batch_step_f32_matches_jax_f32(x_fs, port_step_f32):
    x, fs = x_fs
    x32 = x.astype(np.float32)
    step = jax.jit(jax_pipeline.make_batch_step(
        fs, len(x), rng_mode="none", f0_method="harvest"))
    jf0, jsp, _, jy = (np.asarray(a) for a in step(jnp.asarray(x32[None])))
    f0, sp, _, y = port_step_f32
    f0_gate(f0[0].double().numpy(), jf0[0].astype(np.float64), 0.1)
    err_db = np.abs(10 * np.log10(sp[0].double().numpy()
                                  / jsp[0].astype(np.float64)))
    assert np.median(err_db) < 0.01, np.median(err_db)
    db = envelope_db(y[0].double().numpy(), jy[0].astype(np.float64))
    assert np.median(db) < 0.5, np.median(db)


def test_batch_step_fast_mode(gold, x_fs):
    x, fs = x_fs
    step = pipeline.get_batch_step(fs, len(x), rng_mode="fast",
                                   f0_method="harvest", device="cpu")
    assert pipeline.get_batch_step(fs, len(x), rng_mode="fast",
                                   f0_method="harvest", device="cpu") is step
    timings = {}
    f0, sp, ap, y = step(x.astype(np.float32)[None], timings=timings)
    assert set(timings) == {"harvest", "harvest.decimate",
                            "harvest.filterbank", "harvest.refine",
                            "harvest.contour", "cheaptrick", "d4c",
                            "synthesis"}
    assert all(torch.isfinite(t).all() for t in (f0, sp, ap, y))
    db = envelope_db(y[0].double().numpy(), gold["synthesis_y"])
    assert np.median(db) < 0.5, np.median(db)


def test_unported_options_raise(x_fs):
    """Only the device mesh is still unported; a bad F0 method or batch
    shape raises ValueError."""
    _, fs = x_fs
    with pytest.raises(NotImplementedError):
        pipeline.make_batch_step(fs, 4000, device="cpu", mesh=object())
    with pytest.raises(ValueError):
        pipeline.make_batch_step(fs, 4000, device="cpu", f0_method="yin")
    with pytest.raises(ValueError):
        W.analyze(np.zeros(4000), fs, f0_method="yin", device="cpu")
    step = pipeline.make_batch_step(fs, 4000, device="cpu", codec_dims=40)
    with pytest.raises(ValueError):
        step(np.zeros((2, 3999), np.float32))


def test_batch_step_defaults_match_jax():
    for name in ("make_batch_step", "get_batch_step"):
        mine = inspect.signature(getattr(pipeline, name)).parameters
        theirs = inspect.signature(getattr(jax_pipeline, name)).parameters
        for p in theirs.values():
            assert mine[p.name].default == p.default, (name, p.name)
    assert inspect.signature(pipeline.make_batch_step).parameters[
        "f0_method"].default == "dio"


def test_dio_step_f32_matches_jax_f32(gold, x_fs, dio_rows,
                                      port_dio_step_f32):
    """The default (Dio -> StoneMask) step against JAX's on the same two
    rows, rng_mode="none"."""
    step = jax.jit(jax_pipeline.make_batch_step(x_fs[1], dio_rows.shape[1],
                                                rng_mode="none"))
    want = [np.asarray(a).astype(np.float64)
            for a in step(jnp.asarray(dio_rows))]
    got = [t.double().numpy() for t in port_dio_step_f32]
    assert all(t.dtype == torch.float32 for t in port_dio_step_f32)
    for row in range(2):
        f32_jax_gate(got[0][row], want[0][row], gold["stonemask_f0"])
        err_db = np.abs(10 * np.log10(got[1][row] / want[1][row]))
        assert np.median(err_db) < 0.01, np.median(err_db)
        db = envelope_db(got[3][row], want[3][row])
        assert np.median(db) < 0.5, np.median(db)


def test_dio_step_codec_dims(x_fs, dio_rows, port_dio_step_f32):
    """codec_dims: coded sp/ap leave the step, equal to the codec of the
    full step's sp/ap; synthesis is unchanged; with_synthesis=False
    returns y=None."""
    fs = x_fs[1]
    f0, sp, ap, y = port_dio_step_f32
    n_aper = W.get_number_of_aperiodicities(fs)
    fft = W.get_fft_size_for_cheaptrick(fs)
    want_sp = codec.code_spectral_envelope_batch(sp, fs, fft, 32)
    want_ap = codec.code_aperiodicity_batch(ap, fs, fft)
    for with_synthesis in (True, False):
        timings = {}
        out = pipeline.make_batch_step(
            fs, dio_rows.shape[1], rng_mode="none", codec_dims=32,
            with_synthesis=with_synthesis, device="cpu")(dio_rows,
                                                         timings=timings)
        assert out[1].shape == (2, f0.shape[1], 32)
        assert out[2].shape == (2, f0.shape[1], n_aper)
        np.testing.assert_array_equal(out[0].numpy(), f0.numpy())
        np.testing.assert_allclose(out[1].numpy(), want_sp.numpy(),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out[2].numpy(), want_ap.numpy(),
                                   rtol=2e-4, atol=2e-4)
        if with_synthesis:
            np.testing.assert_array_equal(out[3].numpy(), y.numpy())
            assert set(timings) == {"dio", "dio.fix", "stonemask",
                                    "cheaptrick", "d4c", "codec",
                                    "synthesis"}
        else:
            assert out[3] is None and "synthesis" not in timings


def test_corpus_metrics_match_jax(port_dio_step_f32):
    f0 = port_dio_step_f32[0]
    lengths = np.array([17500, 12000], np.int32)
    got = pipeline.corpus_metrics(f0, lengths, 22050, 5.0)
    want = jax_pipeline.corpus_metrics(jnp.asarray(f0.numpy()),
                                       jnp.asarray(lengths), 22050, 5.0)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6)
    assert int(got["voiced_frames"]) == int((f0 > 0).sum())


def test_analyze_dio_golden(gold, x_fs):
    """analyze(f0_method="dio") runs Dio -> StoneMask (float64)."""
    p = W.analyze(*x_fs, f0_method="dio", device="cpu")
    f0, ref = p.f0.numpy(), gold["stonemask_f0"]
    assert ((f0 > 0) == (ref > 0)).mean() == 1.0
    v = (f0 > 0) & (ref > 0)
    assert np.abs(1200 * np.log2(f0[v] / ref[v])).max() < 0.1
    assert p.spectrogram.shape == (len(f0), p.fft_size // 2 + 1)


def test_pad_and_bucket_matches_jax():
    rs = np.random.default_rng(2)
    waves = [rs.standard_normal(n).astype(np.float32)
             for n in (900, 1500, 400, 2000, 1000)]
    got = pipeline.pad_and_bucket(waves, (1000, 2000))
    want = jax_pipeline.pad_and_bucket(waves, (1000, 2000))
    assert got.keys() == want.keys()
    for b in got:
        for g, w in zip(got[b], want[b]):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        pipeline.pad_and_bucket([np.zeros(3000)], (1000, 2000))


def test_batch_rows_equal_single_utterance_runs(x_fs):
    """Batching two different utterances changes neither: per-utterance
    section counts, pulse counts, passing frames and RNG streams stay
    per row (float64, exact mode)."""
    x, fs = x_fs
    x2 = np.roll(x, 3000) * 0.8
    step = pipeline.make_batch_step(fs, len(x), rng_mode="exact",
                                    f0_method="harvest", device="cpu")
    both = step(np.stack([x, x2]))
    for row, xr in enumerate((x, x2)):
        single = step(xr[None])
        for got, want in zip(both, single):
            np.testing.assert_allclose(got[row].numpy(), want[0].numpy(),
                                       rtol=1e-12, atol=1e-15)
