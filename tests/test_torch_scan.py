"""The sequential row scan (world_tpu_torch/ops/scan.py) on the CPU, where
its wrapper runs the plain version: the reference's order of additions,
bit for bit, and the phase sum of synthesis's time base against the JAX
package's.  The kernel itself (csrc/scan.cu) is held to the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from world_tpu_torch import config  # noqa: E402
from world_tpu_torch.models import synthesis  # noqa: E402
from world_tpu_torch.ops import scan  # noqa: E402


def sequential(x):
    """Row by row, one element after another, summed in float64 from 0 and
    rounded to x's dtype on each write (plain numpy)."""
    out = np.empty_like(x)
    acc = np.zeros(x.shape[0], np.float64)
    for i in range(x.shape[1]):
        acc = acc + x[:, i].astype(np.float64)
        out[:, i] = acc
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cumsum_rows_is_sequential(dtype):
    """Random rows, and the unvoiced 500 Hz increments at 22.05 kHz whose
    sum ties a period boundary every 441 samples: bit-equal to the
    sequential sum, and float64 to numpy's cumsum."""
    rng = np.random.default_rng(5)
    inc = 2.0 * config.K_PI * config.K_DEFAULT_F0 / 22050.0
    x = np.stack([rng.random(3000) * 0.3, np.full(3000, inc),
                  rng.standard_normal(3000)]).astype(dtype)
    got = scan.cumsum_rows(torch.from_numpy(x)).numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, sequential(x))
    if dtype == np.float64:
        np.testing.assert_array_equal(got, np.cumsum(x, axis=1))
    else:
        np.testing.assert_array_equal(
            got, torch.cumsum(torch.from_numpy(x), 1).numpy())


def test_cumsum_rows_cpu_runs_plain_without_launch():
    before = scan.cumsum_rows.launches
    x = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    assert torch.equal(scan.cumsum_rows(x), scan.cumsum_rows_plain(x))
    assert scan.cumsum_rows(x[:, :0]).shape == (3, 0)
    assert scan.cumsum_rows.launches == before


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((2, 3), dtype=torch.int32), TypeError),
    (torch.zeros(5, dtype=torch.float64), ValueError),
    (torch.zeros((2, 3, 4), dtype=torch.float32), ValueError)])
def test_cumsum_rows_rejects(bad, exc):
    with pytest.raises(exc):
        scan.cumsum_rows(bad)


def test_time_base_pulses_follow_sequential_sum(gold, monkeypatch):
    """The time base of the golden Dio track in float64 (it opens
    unvoiced: pulses on rounding ties of the phase sum every 441
    samples): the port's pulses are where numpy's sequential cumsum of
    the same increments puts them, the reference's order.  The JAX
    package's jnp.cumsum adds in another order on the CPU: its pulses
    are as many and within one sample of the port's, off by one at a
    few ties."""
    import jax.numpy as jnp
    from world_tpu.models import synthesis as jsyn

    f0 = gold["dio_f0"]
    fs, y_length, fft = 22050, len(gold["synthesis_y"]), 1024
    lowest = fs / fft + 1.0
    seen = {}
    real = synthesis.cumsum_rows

    def record(x):
        seen["inc"] = x.numpy().copy()
        return real(x)

    monkeypatch.setattr(synthesis, "cumsum_rows", record)
    pulse, _, _ = synthesis._time_base(
        torch.from_numpy(f0)[None], torch.full((), float(fs),
                                               dtype=torch.float64),
        0.005, y_length, lowest)
    idx = pulse[0].nonzero()[:, 0].numpy()
    wrap = np.mod(np.cumsum(seen["inc"][0]), 2.0 * config.K_PI)
    want = np.nonzero(np.abs(np.diff(wrap)) > config.K_PI)[0]
    np.testing.assert_array_equal(idx, want)

    order, _, _, n, _ = jsyn._time_base(
        jnp.asarray(f0), jnp.asarray(float(fs)), 0.005, y_length, lowest,
        jnp.float64)
    j_idx = np.asarray(order)[:int(n)]
    assert len(j_idx) == len(idx) > 100
    assert np.abs(j_idx - idx).max() <= 1
    assert (j_idx != idx).mean() < 0.05
