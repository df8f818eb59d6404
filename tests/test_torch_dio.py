"""Port Dio and StoneMask (world_tpu_torch.models.dio, .stonemask)
against the C++ goldens and the JAX package.

Tolerances: float64 meets the golden gates of tests/test_crossrate_golden.py
(tp atol 1e-12, VUV > 98%, voiced F0 rtol 1e-9, StoneMask < 0.01 cent
RMS) at all five rates and tests/test_f0.py's (VUV 1.0, max < 0.1 cent)
at 22.05 kHz; float32 is held to the golden StoneMask track at
tests/test_fast_mode.py's < 1 cent RMS and to the JAX float32 path by
f32_jax_gate (and frame by frame by tests/test_torch_stonemask.py).
The contour walks equal the JAX scans exactly in float64."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from conftest import Goldens  # noqa: E402

from world_tpu.models import dio as jax_dio  # noqa: E402
from world_tpu.models import stonemask as jax_stonemask  # noqa: E402
from world_tpu_torch import DioOption, dio, stone_mask  # noqa: E402
from world_tpu_torch.models import dio as port_dio  # noqa: E402
from world_tpu_torch.models.stonemask import stone_mask_batch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def cents(a, b):
    return 1200.0 * np.abs(np.log2(a / b))


def rms_cents(f0, ref, where=True):
    v = (f0 > 0) & (ref > 0) & where
    assert v.sum() > 40
    return np.sqrt((cents(f0[v], ref[v]) ** 2).mean())


def f32_jax_gate(f0, jax_f0, golden):
    """The port's float32 StoneMask track against JAX's float32 one and
    the golden, each from its own float32 Dio track: VUV equal to JAX's
    on every frame and >= 99% with the golden; < 1 cent RMS from the
    golden and within 0.01 cent RMS of JAX's distance from it; < 0.05
    cent RMS from JAX's track over every frame voiced in both.  (The port
    computes JAX's float32 StoneMask, ops/stonemask.py.  The two Dio
    tracks differ by up to 3.2e-6 relative, which leaves the refined
    tracks 0.00015 cent RMS apart here at 22.05 kHz, 0.0007 on
    test_torch_pipeline's rows and 0.0124 on a test_torch_corpus file
    (one frame 0.083 cent off), and the port 5.4e-6 cent RMS further from
    the 22.05 kHz golden than JAX.)"""
    assert ((f0 > 0) == (jax_f0 > 0)).all()
    assert ((f0 > 0) == (golden > 0)).mean() >= 0.99
    assert rms_cents(f0, golden) < 1.0
    assert rms_cents(f0, golden) <= rms_cents(jax_f0, golden) + 0.01
    assert rms_cents(f0, jax_f0) < 0.05


@pytest.mark.parametrize("dirname", ["goldens", "goldens_fs8",
                                     "goldens_fs16", "goldens_fs44",
                                     "goldens_fs48"])
def test_dio_stonemask_golden_all_rates(dirname):
    g = Goldens(os.path.join(HERE, dirname))
    fs, x = g.scalar("fs"), g["x"]
    tp, f0d = dio(x, fs, device="cpu")
    tp, f0d = tp.numpy(), f0d.numpy()
    np.testing.assert_allclose(tp, g["dio_tp"], atol=1e-12)
    same = (f0d > 0) == (g["dio_f0"] > 0)
    assert same.mean() > 0.98, same.mean()
    v = (f0d > 0) & (g["dio_f0"] > 0) & same
    np.testing.assert_allclose(f0d[v], g["dio_f0"][v], rtol=1e-9)

    f0s = stone_mask(x, fs, tp, f0d, device="cpu").numpy()
    vs = (f0s > 0) & (g["stonemask_f0"] > 0)
    c = cents(f0s[vs], g["stonemask_f0"][vs])
    assert np.sqrt((c ** 2).mean()) < 0.01, c.max()


def test_dio_golden(gold):
    """tests/test_f0.py::test_dio_golden on the port."""
    tp, f0 = dio(gold["x"], gold.scalar("fs"), device="cpu")
    np.testing.assert_allclose(tp.numpy(), gold["dio_tp"], atol=1e-12)
    f0, ref = f0.numpy(), gold["dio_f0"]
    same = (f0 > 0) == (ref > 0)
    assert same.mean() == 1.0, np.where(~same)
    v = (f0 > 0) & (ref > 0)
    assert v.sum() > 50
    assert cents(f0[v], ref[v]).max() < 0.1


def test_stonemask_golden(gold):
    """tests/test_f0.py::test_stonemask_golden: refine the reference Dio
    track so errors do not compound."""
    f0 = stone_mask(gold["x"], gold.scalar("fs"), gold["dio_tp"],
                    gold["dio_f0"], device="cpu").numpy()
    ref = gold["stonemask_f0"]
    same = (f0 > 0) == (ref > 0)
    assert same.mean() == 1.0, np.where(~same)
    v = (f0 > 0) & (ref > 0)
    assert cents(f0[v], ref[v]).max() < 0.1


def test_dio_speed_knob(gold):
    """Speed 5 (decimation by 5) stays within 10 cents median."""
    _, f0 = dio(gold["x"], gold.scalar("fs"), DioOption(speed=5),
                device="cpu")
    f0, ref = f0.numpy(), gold["dio_f0"]
    v = (f0 > 0) & (ref > 0)
    assert v.sum() > 40
    assert np.median(cents(f0[v], ref[v])) < 10.0


def test_dio_speed11_fs44():
    """Speed 11 at 44.1 kHz: actual_fs 4009.09 Hz, a non-integer ratio."""
    g = Goldens(os.path.join(HERE, "goldens_fs44"))
    _, f0 = dio(g["x"], 44100, DioOption(speed=11), device="cpu")
    f0, ref = f0.numpy(), g["dio_f0_s11"]
    same = (f0 > 0) == (ref > 0)
    assert same.mean() > 0.98, same.mean()
    v = (f0 > 0) & (ref > 0) & same
    assert v.sum() > 50
    assert np.sqrt((cents(f0[v], ref[v]) ** 2).mean()) < 0.01


def test_dio_stonemask_f32_matches_jax_f32(gold):
    x32 = gold["x"].astype(np.float32)
    fs = gold.scalar("fs")
    tp, f0 = dio(x32, fs, device="cpu")
    f0 = stone_mask(x32, fs, tp, f0, device="cpu")
    assert f0.dtype == torch.float32
    jtp, jf0 = jax_dio.dio(jnp.asarray(x32), fs)
    want = np.asarray(jax_stonemask.stone_mask(jnp.asarray(x32), fs, jtp,
                                               jf0))
    f32_jax_gate(f0.numpy().astype(np.float64), want.astype(np.float64),
                 gold["stonemask_f0"])


def _random_fix_inputs(seed, F=160, C=7):
    """A voiced/unvoiced pattern with short runs, and candidate grids
    around a drifting pitch (some zero)."""
    rs = np.random.RandomState(seed)
    pitch = 150.0 * np.exp(np.cumsum(rs.randn(F) * 0.02))
    step2 = np.where(rs.rand(F) < 0.35, 0.0, pitch * (1 + 0.01 * rs.randn(F)))
    step2[rs.rand(F) < 0.1] = 0.0
    cands = pitch[:, None] * (1.0 + 0.08 * rs.randn(F, C))
    cands[rs.rand(F, C) < 0.3] = 0.0
    return step2, cands


@pytest.mark.parametrize("seed", range(3))
def test_fix_steps_3_4_match_jax_exactly(seed):
    """The frame loops (vectorised over rows) == the JAX scans, float64,
    on three rows at once."""
    rows = [_random_fix_inputs(seed * 10 + r) for r in range(3)]
    s2 = torch.as_tensor(np.stack([r[0] for r in rows]))
    cands = torch.as_tensor(np.stack([r[1] for r in rows]))
    got3 = port_dio._fix_step3(s2, cands, 0.1)
    got4 = port_dio._fix_step4(got3, s2, cands, 0.1)
    for k, (step2, c) in enumerate(rows):
        want3 = np.asarray(jax_dio._fix_step3(jnp.asarray(step2),
                                              jnp.asarray(c), 0.1))
        want4 = np.asarray(jax_dio._fix_step4(jnp.asarray(want3),
                                              jnp.asarray(step2),
                                              jnp.asarray(c), 0.1))
        np.testing.assert_array_equal(got3[k].numpy(), want3)
        np.testing.assert_array_equal(got4[k].numpy(), want4)
        assert (want4 != step2).any()   # the walks did rewrite frames


def test_fix_steps_1_2_match_jax(gold):
    best = np.abs(gold["dio_f0"] * (1 + 0.05 * np.sin(np.arange(
        len(gold["dio_f0"])) * 0.7)))
    got1 = port_dio._fix_step1(torch.as_tensor(best[None]), 7, 0.1)
    got2 = port_dio._fix_step2(got1, 7)
    want1 = jax_dio._fix_step1(jnp.asarray(best), 7, 0.1)
    want2 = jax_dio._fix_step2(want1, 7)
    np.testing.assert_array_equal(got1[0].numpy(), np.asarray(want1))
    np.testing.assert_array_equal(got2[0].numpy(), np.asarray(want2))


def test_dio_batch_rows_equal_single_runs(gold):
    """Batching two different utterances changes neither (float64)."""
    x, fs = gold["x"], gold.scalar("fs")
    x2 = np.roll(x, 3000) * 0.8
    tp, both = port_dio.dio_batch(torch.as_tensor(np.stack([x, x2])), fs)
    refined = stone_mask_batch(torch.as_tensor(np.stack([x, x2])), fs, tp,
                               both)
    for row, xr in enumerate((x, x2)):
        _, single = dio(xr, fs, device="cpu")
        np.testing.assert_array_equal(both[row].numpy(), single.numpy())
        np.testing.assert_array_equal(
            refined[row].numpy(),
            stone_mask(xr, fs, tp, single, device="cpu").numpy())
