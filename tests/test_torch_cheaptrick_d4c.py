"""Port CheapTrick and D4C against the C++ goldens and the JAX package on
the same inputs.

Tolerances: float64 exact mode meets the golden gates of
tests/test_cheaptrick.py (median dB error < 1e-9, max < 1e-3) and
tests/test_d4c.py (same default rows; active rows within 0.01 dB), and
matches JAX's float64 output at the same gates.  float32 with
rng_mode="none" is held to JAX's float32 path at the test_fast_mode.py
envelope gate (median |dB| < 0.01); fast mode at the JAX fast-mode
gates."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from world_tpu.models import cheaptrick as jax_ct  # noqa: E402
from world_tpu.models.d4c import d4c as jax_d4c  # noqa: E402
from world_tpu_torch import config  # noqa: E402
from world_tpu_torch.models.cheaptrick import cheap_trick  # noqa: E402
from world_tpu_torch.models.d4c import d4c  # noqa: E402

DEFAULT = 1.0 - 1e-12


def db_err(a, b):
    return 10 * np.abs(np.log10(a) - np.log10(b))


def assert_envelope_gate(sp, ref):
    assert sp.shape == ref.shape
    db = db_err(sp, ref)
    assert np.median(db) < 1e-9, np.median(db)
    assert db.max() < 1e-3, db.max()


def assert_ap_gate(ap, ref):
    assert ap.shape == ref.shape
    default_ref = np.all(ref == DEFAULT, axis=1)
    np.testing.assert_array_equal(np.all(ap == DEFAULT, axis=1), default_ref)
    act = ~default_ref
    db = 20 * np.abs(np.log10(ap[act]) - np.log10(ref[act]))
    assert db.max() < 0.01, db.max()


@pytest.fixture(scope="module")
def inputs(gold):
    return (gold["x"], gold.scalar("fs"), gold["harvest_tp"],
            gold["harvest_f0"])


@pytest.fixture(scope="module")
def jax_ref(inputs):
    x, fs, tp, f0 = inputs
    x32 = x.astype(np.float32)
    return {
        "sp64": np.asarray(jax_ct.cheap_trick(x, fs, tp, f0,
                                              rng_mode="exact")),
        "sp32": np.asarray(jax_ct.cheap_trick(x32, fs, tp, f0,
                                              rng_mode="none")),
        "ap64": np.asarray(jax_d4c(x, fs, tp, f0, 1024, rng_mode="exact")),
        "ap32": np.asarray(jax_d4c(x32, fs, tp, f0, 1024, rng_mode="none")),
    }


@pytest.fixture(scope="module")
def port_sp64(inputs):
    x, fs, tp, f0 = inputs
    return cheap_trick(x, fs, tp, f0, rng_mode="exact", device="cpu").numpy()


@pytest.fixture(scope="module")
def port_ap64(inputs):
    x, fs, tp, f0 = inputs
    return d4c(x, fs, tp, f0, 1024, rng_mode="exact", device="cpu").numpy()


def test_cheaptrick_golden(gold, port_sp64):
    assert_envelope_gate(port_sp64, gold["cheaptrick_sp"])


def test_cheaptrick_matches_jax_f64(jax_ref, port_sp64):
    assert_envelope_gate(port_sp64, jax_ref["sp64"])


def test_cheaptrick_custom_fft_size(gold, inputs):
    x, fs, tp, f0 = inputs
    sp = cheap_trick(x, fs, tp, f0, option=config.CheapTrickOption(
        fft_size=2048), rng_mode="exact", device="cpu").numpy()
    assert_envelope_gate(sp, gold["cheaptrick_sp_fft2048"])


def test_cheaptrick_high_f0_cap(gold, inputs):
    x, fs, tp, _ = inputs
    sp = cheap_trick(x, fs, tp, gold["hif0"], rng_mode="exact",
                     f0_ceil=1500.0, device="cpu").numpy()
    assert_envelope_gate(sp, gold["cheaptrick_sp_hif0"])


def test_cheaptrick_f32_matches_jax_f32(inputs, jax_ref):
    x, fs, tp, f0 = inputs
    sp = cheap_trick(x.astype(np.float32), fs, tp, f0, rng_mode="none",
                     device="cpu").numpy()
    assert sp.dtype == np.float32
    assert np.median(db_err(sp, jax_ref["sp32"])) < 0.01


def test_cheaptrick_fast_mode_close(gold, inputs):
    x, fs, tp, f0 = inputs
    sp = cheap_trick(x.astype(np.float32), fs, tp, f0, rng_mode="fast",
                     device="cpu").numpy()
    voiced = f0 > 0
    db = db_err(sp[voiced], gold["cheaptrick_sp"][voiced])
    assert db.max() < 0.2, db.max()


def test_d4c_golden(gold, port_ap64):
    assert_ap_gate(port_ap64, gold["d4c_ap"])


def test_d4c_matches_jax_f64(jax_ref, port_ap64):
    assert_ap_gate(port_ap64, jax_ref["ap64"])


def test_d4c_custom_threshold(gold, inputs):
    x, fs, tp, f0 = inputs
    ap = d4c(x, fs, tp, f0, 1024, option=config.D4COption(threshold=0.0),
             rng_mode="exact", device="cpu").numpy()
    assert_ap_gate(ap, gold["d4c_ap_thr0"])


def test_d4c_f32_matches_jax_f32(inputs, jax_ref):
    """Same gated rows; active rows within a median 0.01 dB."""
    x, fs, tp, f0 = inputs
    ap = d4c(x.astype(np.float32), fs, tp, f0, 1024, rng_mode="none",
             device="cpu").numpy()
    assert ap.dtype == np.float32
    ref = jax_ref["ap32"]
    default_ref = np.all(ref == np.float32(DEFAULT), axis=1)
    default_mine = np.all(ap == np.float32(DEFAULT), axis=1)
    np.testing.assert_array_equal(default_mine, default_ref)
    act = ~default_ref
    db = 20 * np.abs(np.log10(ap[act]) - np.log10(ref[act]))
    assert np.median(db) < 0.01, np.median(db)


def test_d4c_fast_mode(gold, inputs):
    x, fs, tp, f0 = inputs
    ap = d4c(x.astype(np.float32), fs, tp, f0, 1024, rng_mode="fast",
             device="cpu").numpy()
    ref = gold["d4c_ap"]
    assert np.isfinite(ap).all()
    assert (ap > 0).all() and (ap <= 1.0).all()
    default_ref = np.all(ref == DEFAULT, axis=1)
    default_mine = np.all(ap == np.float32(DEFAULT), axis=1)
    assert (default_mine == default_ref).mean() > 0.95
