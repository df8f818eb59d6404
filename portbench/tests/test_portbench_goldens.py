"""The plain reference (``portbench/reference``) against WORLD's own
outputs: the C++ golden vectors of the repo's tests (``tests/goldens``,
22.05 kHz, and ``tests/goldens_fs48``, 48 kHz: the "vaiueo" recording
through Harvest, Dio, StoneMask, CheapTrick, D4C, the codec and
Synthesis), in float64 with the C++ random sequence (``rng_mode
"exact"``).  So the yardstick is held to a source outside the program
it judges, not only to the program.

Gates: those the port's own tests hold the port to against the same
goldens: Harvest VUV > 99% and < 1 cent RMS; Dio's VUV equal and < 0.1
cent (22.05 kHz), VUV > 98% and voiced F0 rtol 1e-9 (48 kHz); StoneMask
on the golden Dio track < 0.1 cent (22.05 kHz), < 0.01 cent RMS (48
kHz); CheapTrick on the golden Harvest track median |dB| < 1e-9 and max
< 1e-3 (22.05 kHz), median relative error < 1e-6 and max < 1e-2 (48
kHz); D4C's default rows equal and the others within 0.01 dB (22.05
kHz), max |error| < 1e-5 (48 kHz); Synthesis of the golden F0, sp and
ap > 100 dB SNR; the codec within 1e-9.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference.world import config
from portbench.reference.world.models.cheaptrick import cheap_trick
from portbench.reference.world.models.codec import (code_aperiodicity,
                                                    code_spectral_envelope)
from portbench.reference.world.models.d4c import d4c
from portbench.reference.world.models.dio import dio
from portbench.reference.world.models.harvest import harvest
from portbench.reference.world.models.stonemask import stone_mask
from portbench.reference.world.models.synthesis import synthesis

TESTS = Path(__file__).resolve().parents[2] / "tests"
RATES = {22050: "goldens", 48000: "goldens_fs48"}
DEFAULT = 1.0 - 1e-12


class Goldens:
    def __init__(self, name):
        self.path = TESTS / name
        self.shapes, self.scalars = {}, {}
        for line in (self.path / "manifest.txt").read_text().splitlines():
            parts = line.split()
            if parts[0] == "scalar":
                self.scalars[parts[1]] = int(parts[2])
            else:
                self.shapes[parts[0]] = tuple(int(p) for p in parts[1:])

    def __getitem__(self, name):
        return np.fromfile(os.path.join(self.path, name + ".f64")).reshape(
            self.shapes[name])


@pytest.fixture(scope="module", params=sorted(RATES))
def gold(request):
    return request.param, Goldens(RATES[request.param])


def cents(a, b):
    return 1200.0 * np.abs(np.log2(a / b))


def snr_db(ref, y):
    n = min(len(y), len(ref))
    return 10 * np.log10(np.sum(ref[:n] ** 2)
                         / np.sum((ref[:n] - y[:n]) ** 2))


def test_harvest_meets_the_goldens(gold):
    fs, g = gold
    tp, f0 = harvest(g["x"], fs, device="cpu")
    np.testing.assert_allclose(tp.numpy(), g["harvest_tp"], atol=1e-12)
    f0, ref = f0.numpy(), g["harvest_f0"]
    assert ((f0 > 0) == (ref > 0)).mean() > 0.99
    v = (f0 > 0) & (ref > 0)
    assert v.sum() > 100
    assert np.sqrt((cents(f0[v], ref[v]) ** 2).mean()) < 1.0


def test_dio_and_stonemask_meet_the_goldens(gold):
    fs, g = gold
    tp, f0 = dio(g["x"], fs, device="cpu")
    np.testing.assert_allclose(tp.numpy(), g["dio_tp"], atol=1e-12)
    f0, ref = f0.numpy(), g["dio_f0"]
    same = (f0 > 0) == (ref > 0)
    v = (f0 > 0) & (ref > 0) & same
    assert v.sum() > 40
    if fs == 22050:
        assert same.all(), np.flatnonzero(~same)
        assert cents(f0[v], ref[v]).max() < 0.1
    else:
        assert same.mean() > 0.98, same.mean()
        np.testing.assert_allclose(f0[v], ref[v], rtol=1e-9)
    # StoneMask on the golden Dio track, so errors do not compound.
    f0s = stone_mask(g["x"], fs, g["dio_tp"], g["dio_f0"],
                     device="cpu").numpy()
    ref = g["stonemask_f0"]
    vs = (f0s > 0) & (ref > 0)
    if fs == 22050:
        assert ((f0s > 0) == (ref > 0)).all()
        assert cents(f0s[vs], ref[vs]).max() < 0.1
    else:
        assert np.sqrt((cents(f0s[vs], ref[vs]) ** 2).mean()) < 0.01


@pytest.fixture(scope="module")
def envelopes(gold):
    """CheapTrick and D4C of the golden Harvest track, float64, exact
    mode."""
    fs, g = gold
    x, tp, f0 = g["x"], g["harvest_tp"], g["harvest_f0"]
    sp = cheap_trick(x, fs, tp, f0, rng_mode="exact", device="cpu").numpy()
    ap = d4c(x, fs, tp, f0, rng_mode="exact", device="cpu").numpy()
    return sp, ap


def test_cheaptrick_meets_the_goldens(gold, envelopes):
    fs, g = gold
    sp, ref = envelopes[0], g["cheaptrick_sp"]
    assert sp.shape == ref.shape
    if fs == 22050:
        db = 10 * np.abs(np.log10(sp) - np.log10(ref))
        assert np.median(db) < 1e-9 and db.max() < 1e-3, (np.median(db),
                                                           db.max())
    else:
        rel = np.abs(sp - ref) / ref
        assert np.median(rel) < 1e-6 and rel.max() < 1e-2, (
            np.median(rel), rel.max())


def test_d4c_meets_the_goldens(gold, envelopes):
    fs, g = gold
    ap, ref = envelopes[1], g["d4c_ap"]
    assert ap.shape == ref.shape
    if fs == 22050:
        default = np.all(ref == DEFAULT, axis=1)
        np.testing.assert_array_equal(np.all(ap == DEFAULT, axis=1), default)
        db = 20 * np.abs(np.log10(ap[~default]) - np.log10(ref[~default]))
        assert db.max() < 0.01, db.max()
    else:
        assert np.abs(ap - ref).max() < 1e-5, np.abs(ap - ref).max()


def test_synthesis_meets_the_goldens(gold):
    fs, g = gold
    y = synthesis(g["harvest_f0"], g["cheaptrick_sp"], g["d4c_ap"], fs,
                  frame_period=5.0, rng_mode="exact", device="cpu").numpy()
    assert snr_db(g["synthesis_y"], y) > 100.0, snr_db(g["synthesis_y"], y)


def test_the_codec_meets_the_goldens():
    g = Goldens(RATES[22050])
    fs = 22050
    fft = config.get_fft_size_for_cheaptrick(fs)
    coded = code_aperiodicity(g["d4c_ap"], fs, fft, device="cpu").numpy()
    np.testing.assert_allclose(coded, g["coded_ap"], rtol=0, atol=1e-9)
    coded = code_spectral_envelope(g["cheaptrick_sp"], fs,
                                   g.shapes["coded_sp"][1], fft,
                                   device="cpu").numpy()
    np.testing.assert_allclose(coded, g["coded_sp"], rtol=0, atol=1e-9)


def test_float32_fast_mode_stays_near_the_goldens():
    """The configuration's own precision and draws (float32, fast mode)
    through the reference's batch entry, as the check runs it, on the
    22.05 kHz recording: F0 within the port's float32 gate (< 0.1 cent
    RMS, VUV > 99%) and sp within 0.01 dB median of the goldens."""
    from portbench.reference import analysis as ra
    g = Goldens(RATES[22050])
    x = torch.as_tensor(g["x"].astype(np.float32)[None])
    _, f0 = ra.f0_track(x, 22050, "harvest")
    f0 = f0[0].double().numpy()
    ref = g["harvest_f0"]
    assert ((f0 > 0) == (ref > 0)).mean() > 0.99
    v = (f0 > 0) & (ref > 0)
    assert np.sqrt((cents(f0[v], ref[v]) ** 2).mean()) < 0.1
    sp, _, _ = ra.envelopes(x, torch.as_tensor(ref[None], dtype=torch.float32),
                            22050)
    db = 10 * np.abs(np.log10(sp[0].double().numpy()) - np.log10(
        g["cheaptrick_sp"]))
    assert np.median(db) < 0.01, np.median(db)
