"""Fast mode draws per utterance, not per batch: each row of a batch step
equals that row run alone, as JAX's vmap gives every row the same draws.

The rows are the 22.05 kHz golden utterance, a rolled and scaled copy,
and the utterance cut to 6000 samples and zero-padded, whose silent
frames are dither-dominated (CheapTrick's and D4C's dither is all they
see).  Tolerance: rtol 1e-12 in float64 and 1e-6 in float32 (atol 0);
on the CPU the rows come out bit-equal.  analyze_long in fast mode is
held to the same tolerance between 1 and 2 chunks per batch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from world_tpu_torch.models import synthesis  # noqa: E402
from world_tpu_torch.parallel import analyze_long, pipeline  # noqa: E402

RTOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(scope="module")
def rows(gold):
    x = gold["x"]
    cut = np.zeros_like(x)
    cut[:6000] = x[:6000]
    return np.stack([x, 0.7 * np.roll(x, 3000), cut]), gold.scalar("fs")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("f0_method,codec_dims", [("dio", 32),
                                                  ("harvest", None)])
def test_batch_rows_equal_row_alone(rows, dtype, f0_method, codec_dims):
    """The Dio step with codec and synthesis, and the Harvest step with
    synthesis: f0, sp, ap and y of every row against the row alone."""
    x, fs = rows
    step = pipeline.make_batch_step(fs, x.shape[1], rng_mode="fast",
                                    f0_method=f0_method,
                                    codec_dims=codec_dims, device="cpu")
    batch = step(x.astype(dtype))
    for r in range(len(x)):
        alone = step(x[r:r + 1].astype(dtype))
        for got, want in zip(batch, alone):
            np.testing.assert_allclose(got[r].numpy(), want[0].numpy(),
                                       rtol=RTOL[dtype], atol=0)


def test_analyze_long_independent_of_batch_lanes(gold):
    """A chunk's parameters do not depend on which chunks share its
    batch: fast mode at 1 and 2 chunks per batch."""
    x = np.concatenate([gold["x"], np.zeros(4000), 0.5 * gold["x"]])
    kw = dict(chunk_seconds=0.4, halo_seconds=0.1, f0_method="dio",
              rng_mode="fast", codec_dims=24, device="cpu")
    one = analyze_long(x, gold.scalar("fs"), batch_lanes=1, **kw)
    two = analyze_long(x, gold.scalar("fs"), batch_lanes=2, **kw)
    for a, b in zip(one, two):
        np.testing.assert_allclose(a, b, rtol=RTOL[np.float64], atol=0)


def test_fast_synthesis_above_pulse_capacity():
    """An f0 track above 1500 Hz gives a row more pulses than the JAX
    step's static capacity, min(y_length, int(y_length/fs*1500)+64).  The
    JAX step drops the extra pulses; the port renders them all, as the
    reference does, and in fast mode their noise reuses the capacity's
    draws cyclically (the slot modulo the capacity).  The row still
    equals itself alone, and the output is finite."""
    fs, fft, F = 16000, 1024, 101
    y_length = (F - 1) * 80 + 1
    rng = np.random.default_rng(3)
    f0 = np.stack([np.full(F, 2000.0), np.full(F, 180.0)])
    sp = rng.uniform(1e-6, 1e-3, (2, F, fft // 2 + 1))
    ap = rng.uniform(0.01, 0.99, (2, F, fft // 2 + 1))
    t = [torch.from_numpy(a) for a in (f0, sp, ap)]
    both = synthesis.synthesis_batch(*t, fs, 5.0, y_length, fft,
                                     rng_mode="fast")
    alone = synthesis.synthesis_batch(*(a[:1] for a in t), fs, 5.0,
                                      y_length, fft, rng_mode="fast")
    capacity = min(y_length, int(y_length / fs * 1500) + 64)
    pulses, _, _ = synthesis._time_base(
        t[0][:1], torch.full((), float(fs), dtype=torch.float64), 0.005,
        y_length, fs / fft + 1.0)
    assert int(pulses.sum()) > capacity
    assert torch.isfinite(both).all()
    np.testing.assert_allclose(both[0].numpy(), alone[0].numpy(),
                               rtol=RTOL[np.float64], atol=0)
