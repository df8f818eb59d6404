"""Port Harvest (world_tpu_torch.models.harvest, harvest_contour) against
the C++ goldens, the JAX package, and the host-numpy contour oracle.

Tolerances: float64 meets the golden gate of tests/test_harvest.py (VUV
agreement > 99%, < 1 cent RMS) and matches JAX's float64 output at the
same gate; float32 is held to JAX's float32 path at the test_fast_mode.py
gate (< 0.1 cent RMS, VUV > 99%).  Contour fixing equals the oracle at
the JAX property tests' 1e-9."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import harvest_contour_oracle as H  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from world_tpu.models.harvest import harvest as jax_harvest  # noqa: E402
from world_tpu_torch.models.harvest import harvest  # noqa: E402
from world_tpu_torch.models.harvest_contour import fix_and_smooth  # noqa: E402


def f0_gate(f0, ref, max_cents):
    assert f0.shape == ref.shape
    same_vuv = (f0 > 0) == (ref > 0)
    assert same_vuv.mean() > 0.99, np.where(~same_vuv)
    voiced = (f0 > 0) & (ref > 0)
    assert voiced.sum() > 100
    c = 1200.0 * np.abs(np.log2(f0[voiced] / ref[voiced]))
    rmse = np.sqrt((c ** 2).mean())
    assert rmse < max_cents, (rmse, c.max())


@pytest.fixture(scope="module")
def x_fs(gold):
    return gold["x"], gold.scalar("fs")


@pytest.fixture(scope="module")
def port64(x_fs):
    tp, f0 = harvest(x_fs[0], x_fs[1], device="cpu")
    return tp.numpy(), f0.numpy()


def test_harvest_golden(gold, port64):
    tp, f0 = port64
    np.testing.assert_allclose(tp, gold["harvest_tp"], atol=1e-12)
    f0_gate(f0, gold["harvest_f0"], 1.0)


def test_harvest_matches_jax_f64(x_fs, port64):
    _, want = jax_harvest(*x_fs)
    f0_gate(port64[1], np.asarray(want), 1.0)


def test_harvest_f32_matches_jax_f32(gold, x_fs):
    x, fs = x_fs
    x32 = x.astype(np.float32)
    _, f0 = harvest(x32, fs, device="cpu")
    _, want = jax_harvest(jnp.asarray(x32), fs)
    assert f0.dtype == torch.float32
    f0 = f0.numpy().astype(np.float64)
    f0_gate(f0, np.asarray(want).astype(np.float64), 0.1)
    f0_gate(f0, gold["harvest_f0"], 0.1)


@pytest.mark.parametrize("rate", ["goldens_fs44", "goldens_fs48"])
def test_harvest_other_rates_golden(rate):
    """44.1 kHz checks the host-f64 frame positions (a 1-ulp drift flips
    .5-rounding there); 48 kHz the 6-fold decimation."""
    import os

    from conftest import Goldens
    g = Goldens(os.path.join(os.path.dirname(__file__), rate))
    tp, f0 = harvest(g["x"], g.scalar("fs"), device="cpu")
    np.testing.assert_array_equal(tp.numpy(), g["harvest_tp"])
    f0_gate(f0.numpy(), g["harvest_f0"], 1.0)


def _random_grid(rng, F, S, run_max, gap_max, jitter, spread):
    cands = np.zeros((F, S))
    scores = np.zeros((F, S))
    t = 0
    pitch = 90.0 + 300.0 * rng.rand()
    while t < F:
        run = rng.randint(1, run_max)
        gap = rng.randint(1, gap_max)
        for i in range(t, min(F, t + run)):
            pitch *= 1.0 + jitter * rng.randn()
            pitch = float(np.clip(pitch, 70.0, 750.0))
            k = rng.randint(1, S)
            cands[i, :k] = pitch * (1.0 + spread * rng.randn(k))
            scores[i, :k] = np.abs(rng.randn(k)) * 3.0
        t += run + gap
    return cands, scores


def _oracle(cands, scores):
    return H._smooth_contour_np(H._fix_contour_np(cands, scores))


def test_contour_fix_matches_oracle_batched():
    """Eight random candidate grids as ONE batch: every row equals the
    oracle on its own grid (the batching over utterances is exact)."""
    rng = np.random.RandomState(7)
    grids = [_random_grid(rng, 400, 21, 40, 12, 0.01, 0.05)
             for _ in range(8)]
    got = fix_and_smooth(torch.as_tensor(np.stack([g[0] for g in grids])),
                         torch.as_tensor(np.stack([g[1] for g in grids])))
    for k, (c, s) in enumerate(grids):
        np.testing.assert_allclose(got[k].numpy(), _oracle(c, s), atol=1e-9,
                                   rtol=1e-9, err_msg=f"row {k}")


@pytest.mark.parametrize("trial", range(4))
def test_contour_fix_matches_oracle_harsh(trial):
    rng = np.random.RandomState(23 + trial)
    F = int(rng.choice([150, 401, 797]))
    S = int(rng.choice([7, 21, 49]))
    c, s = _random_grid(rng, F, S, 80, 20, 0.03, 0.1)
    got = fix_and_smooth(torch.as_tensor(c[None]), torch.as_tensor(s[None]))
    np.testing.assert_allclose(got[0].numpy(), _oracle(c, s), atol=1e-9,
                               rtol=1e-9)


def test_contour_fix_edge_cases():
    """All-unvoiced, one long section, threshold run lengths and gaps,
    extensions that overlap — in one batch."""
    F, S = 300, 15
    cases = [(np.zeros((F, S)), np.zeros((F, S)))]
    c = np.zeros((F, S)); s = np.zeros((F, S))
    c[50:250, 0] = 150.0; s[50:250, 0] = 5.0
    cases.append((c, s))
    c = np.zeros((F, S)); s = np.zeros((F, S))
    for st, ln in ((10, 6), (30, 7), (60, 12), (80, 12)):
        c[st:st + ln, 0] = 140.0; s[st:st + ln, 0] = 4.0
    c[150:190, 0] = 160.0; s[150:190, 0] = 6.0
    cases.append((c, s))
    rng = np.random.RandomState(11)
    cg = 120.0 + 10.0 * rng.randn(F, S); sg = np.abs(rng.randn(F, S))
    cc = np.zeros((F, S)); ss = np.zeros((F, S))
    cc[:, :3] = np.abs(cg[:, :3]); ss[:, :3] = sg[:, :3]
    cc[100:140] = 0.0; ss[100:140] = 0.0
    cases.append((cc, ss))
    got = fix_and_smooth(torch.as_tensor(np.stack([c for c, _ in cases])),
                         torch.as_tensor(np.stack([s for _, s in cases])))
    for k, (c, s) in enumerate(cases):
        np.testing.assert_allclose(got[k].numpy(), _oracle(c, s), atol=1e-9,
                                   rtol=1e-9, err_msg=f"case {k}")


def test_contour_fix_many_sections():
    """More than 8 surviving sections, stable pitch per run."""
    rng = np.random.RandomState(3)
    F, S = 797, 21
    cands = np.zeros((F, S))
    scores = np.zeros((F, S))
    t = 5
    while t + 12 < F:
        pitch = 100.0 + 400.0 * rng.rand()
        ln = rng.randint(7, 14)
        for i in range(t, t + ln):
            k = rng.randint(1, S)
            cands[i, :k] = pitch * (1.0 + 0.002 * rng.randn(k))
            scores[i, :k] = np.abs(rng.randn(k)) * 3.0
        t += ln + rng.randint(10, 25)
    got = fix_and_smooth(torch.as_tensor(cands[None]),
                         torch.as_tensor(scores[None]))
    np.testing.assert_allclose(got[0].numpy(), _oracle(cands, scores),
                               atol=1e-9, rtol=1e-9)


def test_contour_f32_block_smoothing():
    """float32 runs the smoothing biquad in block-LTI form: within float32
    rounding of the oracle."""
    rng = np.random.RandomState(5)
    c, s = _random_grid(rng, 400, 21, 40, 12, 0.01, 0.05)
    got = fix_and_smooth(torch.as_tensor(c[None], dtype=torch.float32),
                         torch.as_tensor(s[None], dtype=torch.float32))
    want = _oracle(c.astype(np.float32).astype(np.float64),
                   s.astype(np.float32).astype(np.float64))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-4, atol=1e-3)
