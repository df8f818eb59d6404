"""The port at the other golden rates (8, 16, 44.1, 48 kHz) and the
multirate pipeline: the parts of tests/test_crossrate_golden.py and
tests/test_multirate.py that tests/test_torch_dio.py and
tests/test_torch_harvest.py do not cover (Dio and StoneMask at every
rate, Harvest at 44.1/48 kHz are there).

Gates, float64, the JAX tests': Harvest VUV > 0.98 and < 1 cent RMS;
CheapTrick from the golden F0 median relative error < 1e-6 and max
< 1e-2; D4C max abs error < 1e-5 at fs >= 15.8 kHz (2e-5 at 44.1 kHz,
D4C_GOLDEN_ATOL) and within 1e-5 of world_tpu's, and below it (where
the reference reads uninitialized memory) ap in (0, 1], real periodicity
in voiced frames, and equal to world_tpu's within 1e-9; synthesis > 100
dB against the golden; the codec equal to world_tpu's codec within 1e-9
(its golden tolerance).  The multirate pipeline: median < 40 cents from
the true F0, ap in (0, 1], resynthesis energy within 3 dB, decoded
envelope median < 3 dB.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import world_tpu  # noqa: E402
import world_tpu_torch as W  # noqa: E402
from conftest import Goldens  # noqa: E402
from test_multirate import synth_vowel  # noqa: E402
from world_tpu_torch import config  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# At 44.1 kHz D4C's smoothed group delay amplifies float64 rounding: one
# element is 1.06e-5 from the golden in the port and 7.0e-6 in
# world_tpu, and the two packages differ by up to 5.6e-6 over 53 frames.
D4C_GOLDEN_ATOL = {44100: 2e-5}


def golden_set(dirname):
    g = Goldens(os.path.join(HERE, dirname))
    return g, g.scalar("fs")


def snr_db(ref, y):
    n = min(len(y), len(ref))
    return 10 * np.log10(np.sum(ref[:n] ** 2)
                         / np.sum((ref[:n] - y[:n]) ** 2))


@pytest.mark.parametrize("dirname", ["goldens_fs8", "goldens_fs16"])
def test_harvest_low_rates_golden(dirname):
    g, fs = golden_set(dirname)
    tp, f0 = W.harvest(g["x"], fs, device="cpu")
    np.testing.assert_allclose(tp.numpy().reshape(-1), g["harvest_tp"],
                               atol=1e-12)
    f0, ref = f0.numpy(), g["harvest_f0"]
    assert ((f0 > 0) == (ref > 0)).mean() > 0.98
    v = (f0 > 0) & (ref > 0)
    cents = 1200 * np.abs(np.log2(f0[v] / ref[v]))
    assert np.sqrt((cents ** 2).mean()) < 1.0, np.sqrt((cents ** 2).mean())


@pytest.mark.parametrize("dirname", ["goldens_fs8", "goldens_fs16",
                                     "goldens_fs44", "goldens_fs48"])
def test_stage_parity_from_golden_f0(dirname):
    """CheapTrick, D4C, synthesis and the codec at this rate, from the
    golden Harvest track."""
    g, fs = golden_set(dirname)
    x, tp, ref = g["x"], g["harvest_tp"], g["harvest_f0"]
    sp = W.cheap_trick(x, fs, tp, ref, device="cpu").numpy()
    rel = np.abs(sp - g["cheaptrick_sp"]) / g["cheaptrick_sp"]
    assert np.median(rel) < 1e-6, np.median(rel)
    assert rel.max() < 1e-2, rel.max()

    ap = W.d4c(x, fs, tp, ref, device="cpu").numpy()
    want = np.asarray(world_tpu.d4c(x, fs, tp, ref))
    if fs >= 15800:
        err = np.abs(ap - g["d4c_ap"]).max()
        assert err < D4C_GOLDEN_ATOL.get(fs, 1e-5), err
        np.testing.assert_allclose(ap, want, rtol=0, atol=1e-5)
        y = W.synthesis(ref, sp, ap, fs, frame_period=5.0,
                        device="cpu").numpy()
    else:
        assert np.all((ap > 0) & (ap <= 1.0))
        assert ap[ref > 0].min() < 0.5
        np.testing.assert_allclose(ap, want, rtol=0, atol=1e-9)
        y = W.synthesis(ref, g["cheaptrick_sp"], g["d4c_ap"], fs,
                        frame_period=5.0, device="cpu").numpy()
    assert snr_db(g["synthesis_y"], y) > 100.0, snr_db(g["synthesis_y"], y)

    fft = config.get_fft_size_for_cheaptrick(fs)
    n_ap = config.get_number_of_aperiodicities(fs)
    coded = W.code_aperiodicity(ap, fs, fft, device="cpu").numpy()
    assert coded.shape == (len(ref), n_ap)
    np.testing.assert_allclose(
        coded, np.asarray(world_tpu.code_aperiodicity(ap, fs, fft)),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        W.decode_aperiodicity(coded, fs, fft, device="cpu").numpy(),
        np.asarray(world_tpu.decode_aperiodicity(coded, fs, fft)),
        rtol=0, atol=1e-9)
    csp = W.code_spectral_envelope(sp, fs, 50, fft, device="cpu").numpy()
    np.testing.assert_allclose(
        csp, np.asarray(world_tpu.code_spectral_envelope(sp, fs, 50, fft)),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        W.decode_spectral_envelope(csp, fs, fft, device="cpu").numpy(),
        np.asarray(world_tpu.decode_spectral_envelope(csp, fs, fft)),
        rtol=1e-9, atol=0)


@pytest.mark.parametrize("fs", [16000, 44100, 48000])
def test_pipeline_at_fs(fs):
    """tests/test_multirate.py's pipeline on the port."""
    f0_true = 140.0
    x = synth_vowel(fs, f0_true)
    tp, f0 = W.harvest(x, fs, device="cpu")
    f0 = f0.numpy()
    n_frames = config.get_samples_for_harvest(fs, len(x), 5.0)
    assert f0.shape == (n_frames,)
    voiced = f0 > 0
    assert voiced.mean() > 0.5, voiced.mean()
    mid = voiced.copy()
    mid[: n_frames // 5] = mid[-n_frames // 5:] = False
    cents = 1200 * np.abs(np.log2(f0[mid] / f0_true))
    assert np.median(cents) < 40.0, np.median(cents)

    sp = W.cheap_trick(x, fs, tp, f0, device="cpu").numpy()
    ap = W.d4c(x, fs, tp, f0, device="cpu").numpy()
    half = config.get_fft_size_for_cheaptrick(fs) // 2
    assert sp.shape == (n_frames, half + 1)
    assert ap.shape == (n_frames, half + 1)
    assert np.all(sp > 0) and np.isfinite(sp).all()
    assert np.all((ap > 0) & (ap <= 1.0))
    assert ap[mid].min() < 0.5

    y = W.synthesis(f0, sp, ap, fs, frame_period=5.0, device="cpu").numpy()
    assert np.isfinite(y).all()
    n = min(len(y), len(x))
    ratio = 10 * np.log10(np.sum(y[:n] ** 2) / np.sum(x[:n] ** 2))
    assert abs(ratio) < 3.0, ratio

    n_ap = config.get_number_of_aperiodicities(fs)
    coded = W.code_aperiodicity(ap, fs, 2 * half, device="cpu").numpy()
    assert coded.shape == (n_frames, n_ap)
    dec = W.decode_aperiodicity(coded, fs, 2 * half, device="cpu").numpy()
    assert dec.shape == ap.shape
    sp_c = W.code_spectral_envelope(sp, fs, 50, 2 * half, device="cpu")
    sp_d = W.decode_spectral_envelope(sp_c, fs, 2 * half,
                                      device="cpu").numpy()
    err_db = np.abs(10 * np.log10(sp_d[mid] / sp[mid]))
    assert np.median(err_db) < 3.0, np.median(err_db)
