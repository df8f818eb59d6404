"""The port's primitives (world_tpu_torch.ops) against the C++ goldens
and against the JAX package on the same inputs, plus the port-specific
traps: IEEE division by fs, half-away-from-zero rounding, clamped
indexing, import isolation and the default device.

Tolerances: the goldens' own (tests/test_primitives.py); exact equality
where both packages run the same float64 arithmetic."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from world_tpu.ops import common as jcommon  # noqa: E402
from world_tpu.ops import matlab as jmatlab  # noqa: E402
from world_tpu.ops import rng as jrng  # noqa: E402
from world_tpu_torch.device import div  # noqa: E402
from world_tpu_torch.ops import common, fftpack, matlab, rng  # noqa: E402


def T(a):
    return torch.as_tensor(np.asarray(a))


def test_rfft_irfft_conventions(gold):
    x = np.sin(np.arange(64) * 0.3) + 0.02 * np.arange(64)
    sp = fftpack.rfft(T(x)).numpy()
    np.testing.assert_allclose(sp.real, gold["rfft64_re"], atol=1e-12)
    np.testing.assert_allclose(sp.imag, gold["rfft64_im"], atol=1e-12)
    i = np.arange(33)
    spec = np.cos(i * 0.2) + 1j * (np.sin(i * 0.41) * 0.5)
    out = fftpack.irfft_unnormalized(T(spec), 64).numpy()
    np.testing.assert_allclose(out, gold["irfft64_out"], atol=1e-12)


def test_fast_fftfilt(gold):
    i = np.arange(19)
    x = np.sin(0.37 * i) + 0.25 * np.cos(1.1 * i * i)
    h = 1.0 / (1.0 + np.arange(7.0) ** 2)
    out = matlab.fast_fftfilt(T(x), T(h), 32).numpy()
    np.testing.assert_allclose(out, gold["fast_fftfilt"], atol=1e-15)


def test_nuttall(gold):
    np.testing.assert_allclose(common.nuttall_window(64).numpy(),
                               gold["nuttall_64"], atol=1e-13)
    np.testing.assert_allclose(common.nuttall_window(257).numpy(),
                               gold["nuttall_257"], atol=1e-13)


def test_interp1_golden_and_jax(gold):
    xs = np.arange(10, dtype=float)
    ys = np.sin(np.arange(10) * 0.7) + 0.1 * np.arange(10)
    xi = -1.0 + np.arange(200) * (11.5 / 199)
    out = matlab.interp1(T(xs), T(ys), T(xi)).numpy()
    np.testing.assert_allclose(out, gold["interp1_out"], atol=1e-12)
    # same float64 arithmetic as the JAX merge-rank version: bit-equal
    want = np.asarray(jmatlab.interp1(jnp.asarray(xs), jnp.asarray(ys),
                                      jnp.asarray(xi)))
    np.testing.assert_array_equal(out, want)


def test_interp1_padded_rows_match_jax():
    """Batched rows with +inf padding and per-row n_valid (the
    zero-crossing layout) equal the JAX function row by row."""
    rs = np.random.default_rng(5)
    rows = []
    for n in (2, 5, 9):
        x = np.sort(rs.random(n)) * 10
        rows.append((np.concatenate([x, np.full(12 - n, np.inf)]),
                     np.concatenate([rs.random(n), np.zeros(12 - n)]), n))
    xi = np.linspace(-1, 11, 37)
    got = matlab.interp1(T(np.stack([r[0] for r in rows])),
                         T(np.stack([r[1] for r in rows])), T(xi),
                         n_valid=torch.tensor([r[2] for r in rows])).numpy()
    for k, (x, y, n) in enumerate(rows):
        want = np.asarray(jmatlab.interp1(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(xi), n_valid=n))
        np.testing.assert_array_equal(got[k], want)


def test_interp1_short_rows_do_not_raise():
    """Rows with fewer than two valid points have no segment; JAX gathers
    clamp silently, torch raises unless the indices are clamped."""
    x = T(np.array([[0.5, np.inf, np.inf], [np.inf, np.inf, np.inf]]))
    y = T(np.zeros((2, 3)))
    out = matlab.interp1(x, y, T(np.linspace(0, 1, 4)),
                         n_valid=torch.tensor([1, 0]))
    assert out.shape == (2, 4)


def test_interp1q(gold):
    ys = np.sin(np.arange(10) * 0.7) + 0.1 * np.arange(10)
    xi = np.arange(200) * (4.99 / 199)
    out = matlab.interp1q(0.0, 0.5, T(ys), T(xi)).numpy()
    np.testing.assert_allclose(out, gold["interp1Q_out"], atol=1e-12)


@pytest.mark.parametrize("r", list(range(2, 13)))
def test_decimate(gold, r):
    x = gold["x"][:2000]
    out = matlab.decimate(T(x), r).numpy()
    np.testing.assert_allclose(out, gold[f"decimate_r{r}"], atol=1e-12)
    # float32 runs the block-LTI form: rounding-level agreement with the
    # JAX float32 path (same form, other summation order).
    got32 = matlab.decimate(T(x.astype(np.float32)), r).numpy()
    want32 = np.asarray(jmatlab.decimate(jnp.asarray(x, jnp.float32), r))
    np.testing.assert_allclose(got32, want32, rtol=1e-4, atol=1e-6)


def test_dc_correction(gold):
    out = common.dc_correction(T(gold["spec_in"]),
                               torch.tensor(160.0, dtype=torch.float64),
                               gold.scalar("fs"), 1024).numpy()
    np.testing.assert_allclose(out, gold["dccorr_out"], rtol=1e-12)


def test_linear_smoothing(gold):
    fs = gold.scalar("fs")
    width = 160.0 * 2.0 / 3.0
    b_max = int(width * 1024 / fs) + 1 + 7
    out = common.linear_smoothing(T(gold["spec_in"]),
                                  torch.tensor(width, dtype=torch.float64),
                                  fs, 1024, b_max).numpy()
    np.testing.assert_allclose(out, gold["linsmooth_out"], rtol=1e-10)
    # float32 input: the port integrates in float64, JAX float32 takes a
    # local box sum; both stay within float32 rounding of the golden.
    out32 = common.linear_smoothing(
        T(gold["spec_in"].astype(np.float32)),
        torch.tensor(width, dtype=torch.float32), fs, 1024, b_max).numpy()
    want32 = np.asarray(jcommon.linear_smoothing(
        jnp.asarray(gold["spec_in"], jnp.float32), jnp.float32(width), fs,
        1024, b_max))
    np.testing.assert_allclose(out32, gold["linsmooth_out"], rtol=1e-5)
    np.testing.assert_allclose(out32, want32, rtol=1e-4)


def test_minimum_phase(gold):
    mp = common.minimum_phase_spectrum(T(gold["minphase_logspec_in"]),
                                       512).numpy()
    np.testing.assert_allclose(mp.real, gold["minphase_re"], atol=1e-12)
    np.testing.assert_allclose(mp.imag, gold["minphase_im"], atol=1e-12)


def test_randn_sequence_and_jump(gold):
    np.testing.assert_array_equal(rng.randn_sequence(1024).numpy(),
                                  gold["randn_1024"])
    draws = rng.randn_blocks_at(torch.tensor([0, 1000]), 24).numpy()
    np.testing.assert_array_equal(draws[0], gold["randn_1024"][:24])
    np.testing.assert_array_equal(draws[1], gold["randn_1024"][1000:1024])


def test_states_at_draws_match_jax():
    offsets = np.array([0, 1, 7, 12345, 2 ** 20 + 3, 987654321])
    got = rng.states_at_draws(torch.as_tensor(offsets)).numpy()
    want = np.asarray(jrng.states_at_draws(jnp.asarray(offsets)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_randn_blocks_at_match_jax():
    """Overlapping, unsorted blocks (the per-pulse / per-frame dither
    layout) are windows of one stream: equal to the JAX draws."""
    offsets = np.array([[5, 0, 300], [299, 1000, 17]])
    got = rng.randn_blocks_at(torch.as_tensor(offsets), 40).numpy()
    want = np.asarray(jrng.randn_blocks_at(jnp.asarray(offsets.reshape(-1)),
                                           40)).reshape(2, 3, 40)
    np.testing.assert_array_equal(got, want)


def test_lti_block_filter_matches_scan():
    """Block-LTI form == the per-sample recurrence (decimate's stage and
    the contour biquad), at lengths spanning block edges, any lanes."""
    from world_tpu_torch.models.harvest_contour import _A, _B, _biquad

    rs = np.random.default_rng(7)
    for n in (1, 127, 128, 129, 1000):
        x = rs.standard_normal((3, n))
        want = _biquad(T(x)).numpy()          # float64: per-sample loop
        got = matlab.lti_block_filter(
            T(x), matlab.lti_block_tables(
                np.array([[_A[0], _A[1], _B[1], _B[0]], [1, 0, 0, 0],
                          [0, 0, 0, 0], [0, 0, 1, 0]], float),
                np.array([_B[0], 0.0, 1.0, 0.0]),
                np.array([_A[0], _A[1], _B[1], _B[0]]), _B[0], 128)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_window_slice_is_clamped_gather():
    """The plain clamped gather equals the JAX edge-padded slice bit for
    bit, for starts before 0 and past the end."""
    rs = np.random.default_rng(11)
    x = rs.standard_normal(1000)
    for max_len in (1, 64, 389):
        starts = np.concatenate([np.arange(-max_len - 4, 20),
                                 rs.integers(0, 1000, 40),
                                 np.arange(1000 - max_len - 4, 1004)])
        got = common.window_slice(T(x[None]), T(starts[None]),
                                  max_len).numpy()[0]
        want = np.asarray(jax.vmap(lambda s: jcommon.window_slice(
            jnp.asarray(x), s, max_len))(jnp.asarray(starts)))
        np.testing.assert_array_equal(got, want)


def test_matlab_round_half_away_from_zero():
    """matlab_round is half-away-from-zero (torch.round is half-to-even)
    and equals the JAX version on values sitting on .5."""
    v = np.array([-2.5, -1.5, -0.5, -0.0, 0.5, 1.5, 2.5, 2.4999, 7.5000001])
    got = matlab.matlab_round(T(v)).numpy()
    np.testing.assert_array_equal(got, [-3, -2, -1, 0, 1, 2, 3, 2, 8])
    rs = np.random.default_rng(3)
    w = np.round(rs.standard_normal(500) * 400) / 2 + rs.choice(
        [0, 1e-9], 500)
    np.testing.assert_array_equal(
        matlab.matlab_round(T(w)).numpy(),
        np.asarray(jmatlab.matlab_round(jnp.asarray(w))))


def test_div_is_ieee_division():
    """device.div divides (float32 and float64) like numpy, bit for bit."""
    rs = np.random.default_rng(1)
    a = rs.standard_normal(4096) * 1e4
    for dt, c in ((np.float32, 22050.0), (np.float32, 3.0),
                  (np.float64, 1000.0), (np.float32, 1000.0)):
        got = div(T(a.astype(dt)), c).numpy()
        np.testing.assert_array_equal(got, a.astype(dt) / dt(c))


def test_sort_stability_and_mod_match_jax():
    """Stable argsort and floored modulo behave like jnp's."""
    keys = np.array([3, 1, 3, 0, 1, 3, 0])
    np.testing.assert_array_equal(
        torch.argsort(T(keys), stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(keys), stable=True)))
    v = np.array([-7.5, -0.1, 0.0, 0.1, 6.2831853, 13.0, -13.0])
    np.testing.assert_array_equal(
        torch.remainder(T(v), 2.0 * np.pi).numpy(),
        np.asarray(jnp.mod(jnp.asarray(v), 2.0 * np.pi)))


def test_import_leaves_out_jax():
    """The port imports neither jax nor the JAX package."""
    code = ("import sys, world_tpu_torch, world_tpu_torch.convert; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'world_tpu' or "
            "m.startswith('world_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(__import__("pathlib").Path(
                              __file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_without_gpu_raise(monkeypatch, gold):
    """With no device given and no GPU, entry points raise rather than
    run on the CPU."""
    import world_tpu_torch as W

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = gold["x"][:4000]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W.harvest(x, 22050)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W.make_batch_step(22050, 4000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W.synthesis(gold["harvest_f0"], gold["cheaptrick_sp"],
                    gold["d4c_ap"], 22050)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W.analyze(x, 22050)
