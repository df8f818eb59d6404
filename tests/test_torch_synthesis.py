"""Port synthesis (world_tpu_torch.models.synthesis) against the C++
golden and the JAX package's synthesis on the same inputs.

Tolerances: float64 exact mode meets the golden gate of
tests/test_synthesis.py (SNR > 200 dB) and matches JAX's float64 output
at the same gate.  float32 with rng_mode="none" is held to JAX's float32
path at the test_fast_mode.py envelope gate (median < 0.5 dB); fast-mode
noise comes from a torch generator and is held to the envelope gate."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from world_tpu.models.synthesis import synthesis as jax_synthesis  # noqa: E402
from world_tpu_torch.models.synthesis import synthesis  # noqa: E402


def snr_db(ref, y):
    return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - y) ** 2))


def envelope_db(y, ref):
    n = (min(len(y), len(ref)) // 256) * 256
    re = ref[:n].reshape(-1, 256).std(axis=1)
    ye = y[:n].reshape(-1, 256).std(axis=1)
    act = re > re.max() * 0.03
    with np.errstate(divide="ignore"):
        return 20 * np.abs(np.log10(ye[act] / re[act]))


@pytest.fixture(scope="module")
def params(gold):
    return (gold["harvest_f0"], gold["cheaptrick_sp"], gold["d4c_ap"],
            gold.scalar("fs"))


@pytest.fixture(scope="module")
def jax_ref(params):
    f0, sp, ap, fs = params
    return {
        "f64": np.asarray(jax_synthesis(f0, sp, ap, fs, rng_mode="exact")),
        "f32": np.asarray(jax_synthesis(
            f0.astype(np.float32), sp.astype(np.float32),
            ap.astype(np.float32), fs, rng_mode="none")),
    }


def test_synthesis_golden(gold, params):
    f0, sp, ap, fs = params
    y = synthesis(f0, sp, ap, fs, rng_mode="exact", device="cpu").numpy()
    ref = gold["synthesis_y"]
    assert y.shape == ref.shape
    assert snr_db(ref, y) > 200.0, snr_db(ref, y)


def test_synthesis_matches_jax_f64(params, jax_ref):
    f0, sp, ap, fs = params
    y = synthesis(f0, sp, ap, fs, rng_mode="exact", device="cpu").numpy()
    assert snr_db(jax_ref["f64"], y) > 200.0, snr_db(jax_ref["f64"], y)


def test_synthesis_f32_matches_jax_f32(params, jax_ref):
    f0, sp, ap, fs = params
    y = synthesis(f0.astype(np.float32), sp.astype(np.float32),
                  ap.astype(np.float32), fs, rng_mode="none",
                  device="cpu").numpy()
    assert y.dtype == np.float32
    db = envelope_db(y.astype(np.float64), jax_ref["f32"].astype(np.float64))
    assert np.median(db) < 0.5, np.median(db)


def test_synthesis_fast_quality(gold, params):
    f0, sp, ap, fs = params
    y = synthesis(f0, sp.astype(np.float32), ap, fs, rng_mode="fast",
                  device="cpu").numpy()
    assert np.isfinite(y).all()
    db = envelope_db(y.astype(np.float64), gold["synthesis_y"])
    assert np.median(db) < 0.5, np.median(db)


def test_early_pulses_drop_negative_offsets(params):
    """Pulses within fft_size/2 of the start have negative OLA offsets;
    their left tails must be dropped, not wrapped onto the end (the
    JAX float64 scatter remaps them, the port pads and slices)."""
    f0, sp, ap, fs = params
    f0 = np.full(40, 173.3)
    sp40, ap40 = sp[60:100], ap[60:100]
    y = synthesis(f0, sp40, ap40, fs, rng_mode="exact", device="cpu").numpy()
    want = np.asarray(jax_synthesis(f0, sp40, ap40, fs, rng_mode="exact"))
    assert snr_db(want, y) > 200.0
    np.testing.assert_allclose(y[-300:], want[-300:], atol=1e-12)


def test_high_f0_renders_every_pulse(params):
    """F0 above the JAX default capacity heuristic: the port renders the
    real pulses (no capacity), matching JAX with its capacity sized from
    the track."""
    f0, sp, ap, fs = params
    y = synthesis(f0 * 8.0, sp, ap, fs, rng_mode="exact",
                  device="cpu").numpy()
    want = np.asarray(jax_synthesis(f0 * 8.0, sp, ap, fs, rng_mode="exact"))
    assert snr_db(want, y) > 200.0, snr_db(want, y)


def test_max_pulses_capacity_matches_jax(params):
    """``max_pulses`` is the JAX capacity: with k = 50 of the track's
    ~170 pulses, the pulses past it are dropped, and the port equals
    JAX's synthesis(..., max_pulses=50) at the golden gate (rng_mode
    "none", float64).  JAX leaves the window of its last kept pulse
    non-finite (its noise length wraps past the cut to the first pulse
    and comes out negative), so the gate reads JAX's finite samples and
    the port's window is held to its own untruncated render; a capacity
    above the pulse count changes nothing."""
    f0, sp, ap, fs = params
    k, fft = 50, 2 * (sp.shape[1] - 1)
    y = synthesis(f0, sp, ap, fs, max_pulses=k, rng_mode="none",
                  device="cpu").numpy()
    want = np.asarray(jax_synthesis(f0, sp, ap, fs, max_pulses=k,
                                    rng_mode="none"))
    full = synthesis(f0, sp, ap, fs, rng_mode="none", device="cpu").numpy()
    assert np.isfinite(y).all()
    bad = np.flatnonzero(~np.isfinite(want))
    assert 0 < len(bad) <= fft and bad[-1] - bad[0] == len(bad) - 1
    ok = np.isfinite(want)
    assert snr_db(want[ok], y[ok]) > 200.0, snr_db(want[ok], y[ok])
    # Dropped: nothing after the last kept pulse's window, where the
    # untruncated render goes on.
    assert not y[bad[-1] + 1:].any() and full[bad[-1] + 1:].any()
    # The first dropped pulse comes after the last kept one, so its
    # window starts past the kept one's: up to there both renders agree.
    np.testing.assert_array_equal(y[:bad[0] + 1], full[:bad[0] + 1])
    roomy = synthesis(f0, sp, ap, fs, max_pulses=len(y), rng_mode="none",
                      device="cpu").numpy()
    np.testing.assert_array_equal(roomy, full)
