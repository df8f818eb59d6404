"""The overlap-add port (world_tpu_torch.ops.ola) against the JAX
package's Pallas kernel (run in interpret mode on the CPU).

Tolerance: atol = 0.  Both sum each output sample's overlapping pulses
in pulse order from zero, so float32 results are bit-identical.  The
CUDA kernel is held to the plain version on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from world_tpu.ops.pallas_ola import ola_accumulate as jax_ola  # noqa: E402
from world_tpu_torch.ops.ola import ola_accumulate  # noqa: E402


def _case(seed, batch, pulses, fft, y_padded, dtype=np.float32,
          sort=False):
    rs = np.random.default_rng(seed)
    resp = rs.standard_normal((batch, pulses, fft)).astype(dtype)
    offs = rs.integers(0, y_padded - fft + 1, (batch, pulses)).astype(
        np.int32)
    if sort:
        offs = np.sort(offs, axis=1)
    return resp, offs


@pytest.mark.parametrize("fft", [512, 1024, 2048])
def test_plain_matches_jax_ola(fft):
    """Random unsorted offsets, pulses overlapping each other."""
    y_padded = 3 * fft + 777
    resp, offs = _case(fft, 2, 9, fft, y_padded)
    got = ola_accumulate(torch.as_tensor(resp), torch.as_tensor(offs),
                         y_padded=y_padded).numpy()
    want = np.asarray(jax_ola(jnp.asarray(resp), jnp.asarray(offs),
                              y_padded=y_padded))
    np.testing.assert_array_equal(got, want)


def test_small_fft_case_matches_jax_and_loop():
    """The fft_size=512 case of tests/test_synthesis.py:42-60."""
    rng = np.random.default_rng(0)
    batch, pulses, fft = 2, 5, 512
    resp = rng.standard_normal((batch, pulses, fft)).astype(np.float32)
    y_padded = 4000
    offs = rng.integers(0, y_padded - fft, (batch, pulses)).astype(np.int32)
    got = ola_accumulate(torch.as_tensor(resp), torch.as_tensor(offs),
                         y_padded=y_padded).numpy()
    want = np.asarray(jax_ola(jnp.asarray(resp), jnp.asarray(offs),
                              y_padded=y_padded))
    np.testing.assert_array_equal(got, want)
    ref = np.zeros((batch, y_padded), np.float32)
    for b in range(batch):
        for p in range(pulses):
            ref[b, offs[b, p]: offs[b, p] + fft] += resp[b, p]
    np.testing.assert_array_equal(got, ref)


def test_plain_is_sequential_scatter_float64():
    """float64, offsets at both ends of the range: equal to the pulse-
    ordered loop bit for bit."""
    resp, offs = _case(4, 3, 40, 256, 3000, np.float64)
    offs[:, 0] = 0
    offs[:, 1] = 3000 - 256
    got = ola_accumulate(torch.as_tensor(resp), torch.as_tensor(offs),
                         y_padded=3000).numpy()
    ref = np.zeros((3, 3000))
    for b in range(3):
        for p in range(40):
            ref[b, offs[b, p]: offs[b, p] + 256] += resp[b, p]
    np.testing.assert_array_equal(got, ref)


def test_wrapper_checks_and_cpu_counts_no_launch():
    resp, offs = _case(1, 2, 3, 64, 300)
    r, o = torch.as_tensor(resp), torch.as_tensor(offs)
    before = ola_accumulate.launches
    ola_accumulate(r, o, y_padded=300)
    assert ola_accumulate.launches == before
    assert ola_accumulate.last_shape == (2, 3, 64, 300)
    with pytest.raises(TypeError):
        ola_accumulate(r, o.long(), y_padded=300)
    with pytest.raises(TypeError):
        ola_accumulate(r.half(), o, y_padded=300)
    with pytest.raises(ValueError):
        ola_accumulate(r, o[:, :2], y_padded=300)
    strided = r.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ola_accumulate(strided, o, y_padded=300)
    with pytest.raises(ValueError):
        ola_accumulate(r, o, y_padded=32)
