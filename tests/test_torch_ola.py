"""The overlap-add port (world_tpu_torch.ops.ola) against the JAX
package's Pallas kernel (run in interpret mode on the CPU).

Tolerance: atol = 0.  All sum each output sample's overlapping pulses
in pulse order from zero, so results are bit-identical; the ragged
plain version equals the padded one on the padded equivalent of its
inputs.  The CUDA kernel is held to the plain versions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from world_tpu.ops.pallas_ola import ola_accumulate as jax_ola  # noqa: E402
from world_tpu.models.synthesis import synthesis as jax_synthesis  # noqa: E402,E501
from world_tpu_torch.models.synthesis import synthesis_batch  # noqa: E402
from world_tpu_torch.ops.ola import (  # noqa: E402
    ola_accumulate, ola_accumulate_ragged, ola_plain, ola_ragged_plain)


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


def _ragged_case(seed, fft, dtype):
    """Rows with 0, 1 and many pulses; pulses at offset 0 and at
    y_padded - fft; adjacent pulses on the same sample.  Returns the
    ragged inputs, their padded equivalent and y_padded."""
    rs = np.random.default_rng(seed)
    y_padded = 3 * fft + 555
    hi = y_padded - fft
    rows = [np.array([], np.int64), np.array([hi // 2]),
            np.sort(rs.integers(0, hi + 1, 9)),
            np.array([0, 0, 1, hi // 3, hi // 3, hi - 1, hi, hi]),
            np.array([], np.int64)]
    counts = np.array([len(r) for r in rows])
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    offs = np.concatenate(rows).astype(np.int32)
    resp = rs.standard_normal((len(offs), fft)).astype(dtype)
    P = counts.max()
    presp = np.zeros((len(rows), P, fft), dtype)
    poffs = np.zeros((len(rows), P), np.int32)
    for b, r in enumerate(rows):
        presp[b, :len(r)] = resp[row_ptr[b]:row_ptr[b + 1]]
        poffs[b, :len(r)] = r
    return (resp, offs, row_ptr), (presp, poffs), y_padded


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fft", [512, 1024, 2048])
def test_ragged_plain_matches_padded_and_jax(fft, dtype):
    (resp, offs, row_ptr), (presp, poffs), yp = _ragged_case(fft, fft, dtype)
    t = torch.as_tensor
    got = ola_accumulate_ragged(t(resp), t(offs), t(row_ptr),
                                y_padded=yp).numpy()
    np.testing.assert_array_equal(
        got, ola_ragged_plain(t(resp), t(offs), t(row_ptr), yp).numpy())
    np.testing.assert_array_equal(got, ola_plain(t(presp), t(poffs),
                                                 yp).numpy())
    want = np.asarray(jax_ola(jnp.asarray(presp), jnp.asarray(poffs),
                              y_padded=yp))
    assert want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and not got[4].any()   # rows without pulses


def test_ragged_wrapper_checks_and_cpu_counts_no_launch():
    (resp, offs, row_ptr), _, yp = _ragged_case(5, 256, np.float32)
    r, o, rp = (torch.as_tensor(a) for a in (resp, offs, row_ptr))
    before = ola_accumulate_ragged.launches
    ola_accumulate_ragged(r, o, rp, y_padded=yp)
    assert ola_accumulate_ragged.launches == before
    assert ola_accumulate_ragged.last_shape == (5, len(offs), 256, yp)
    with pytest.raises(ValueError):          # row_ptr shape
        ola_accumulate_ragged(r, o, rp[None], y_padded=yp)
    with pytest.raises(ValueError):
        ola_accumulate_ragged(r, o, rp[:0], y_padded=yp)
    with pytest.raises(TypeError):           # row_ptr dtype
        ola_accumulate_ragged(r, o, rp.long(), y_padded=yp)
    with pytest.raises(TypeError):           # offsets dtype
        ola_accumulate_ragged(r, o.long(), rp, y_padded=yp)
    with pytest.raises(TypeError):           # responses dtype
        ola_accumulate_ragged(r.half(), o, rp, y_padded=yp)
    with pytest.raises(ValueError):          # offsets shape
        ola_accumulate_ragged(r, o[:-1], rp, y_padded=yp)
    with pytest.raises(ValueError):          # padded responses
        ola_accumulate_ragged(r[None], o, rp, y_padded=yp)
    with pytest.raises(ValueError):
        ola_accumulate_ragged(r, o, rp, y_padded=128)


def test_ragged_plain_raises_on_broken_contract():
    (resp, offs, row_ptr), _, yp = _ragged_case(6, 256, np.float64)
    r, o, rp = (torch.as_tensor(a) for a in (resp, offs, row_ptr))
    swapped = o.clone()
    swapped[[3, 4]] = swapped[[4, 3]]        # row 2 no longer ascends
    assert swapped[3] > swapped[4]
    with pytest.raises(ValueError, match="ascend"):
        ola_accumulate_ragged(r, swapped, rp, y_padded=yp)
    # Descending across a row boundary is allowed.
    assert o[row_ptr[3]] < o[row_ptr[3] - 1]
    ola_accumulate_ragged(r, o, rp, y_padded=yp)
    bad = rp.clone()
    bad[-1] -= 1
    with pytest.raises(ValueError, match="row_ptr"):
        ola_accumulate_ragged(r, o, bad, y_padded=yp)
    falling = rp.clone()
    falling[2] = falling[3] + 1
    with pytest.raises(ValueError, match="row_ptr"):
        ola_accumulate_ragged(r, o, falling, y_padded=yp)
    late = o.clone()
    late[-1] = yp - 255
    with pytest.raises(ValueError, match="outside"):
        ola_accumulate_ragged(r, late, rp, y_padded=yp)


def test_synthesis_batch_rows_match_single_rows(gold):
    """The ragged caller: each row of a float64 exact-mode batch (each
    row's noise stream starting at 0) equals that row synthesized alone,
    and the batch's first row equals the JAX package's synthesis."""
    f0, sp, ap = gold["harvest_f0"], gold["cheaptrick_sp"], gold["d4c_ap"]
    fs = gold.scalar("fs")
    fft = 2 * (sp.shape[1] - 1)
    y_length = int((len(f0) - 1) * 5.0 / 1000.0 * fs) + 1
    f0s = np.stack([f0, 1.3 * f0, np.zeros_like(f0)])
    t = torch.as_tensor
    args = (fs, 5.0, y_length, fft)
    batch = synthesis_batch(t(f0s), t(np.stack([sp] * 3)),
                            t(np.stack([ap] * 3)), *args,
                            rng_mode="exact").numpy()
    for b in range(3):
        one = synthesis_batch(t(f0s[b:b + 1]), t(sp[None]), t(ap[None]),
                              *args, rng_mode="exact").numpy()
        np.testing.assert_allclose(batch[b], one[0], rtol=0, atol=1e-12)
    want = np.asarray(jax_synthesis(f0, sp, ap, fs, rng_mode="exact"))
    np.testing.assert_allclose(batch[0], want, rtol=0, atol=1e-9)
