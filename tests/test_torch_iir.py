"""The recurrences of ops/iir.py and the RNG span of ops/rng.py on the
CPU, where each wrapper runs its plain version: iir_zero_phase (float64
decimation and the float64 F0 smoothing), lti_state_scan (the block-LTI
form's carried state, float32 decimation and smoothing) and randn_span
(exact-mode draws).  The kernels (csrc/iir.cu, csrc/xorshift.cu) are held
to the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py; here their designs are: the recurrences' chain/off-chain
split, the jumps as ballots and the draws split among a warp's threads,
each held to the plain version bit for bit.

Tolerances: the float64 plain paths equal the per-sample loops they
replace bit for bit (torch.equal), and decimation the goldens at
test_primitives.py's 1e-12; JAX's float64 decimate at 1e-14 absolute
(XLA may fuse a multiply and an add; the port rounds each); the float64
smoothing the host-numpy oracle at the JAX property tests' 1e-9; the
float32 state scan JAX's float32 decimate and smoothing at
test_primitives.py's rtol 1e-4 / atol 1e-6; the span of draws JAX's
randn_blocks_at exactly (integer arithmetic and a power-of-two scale)."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import harvest_contour_oracle as H  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from world_tpu.models import harvest_contour as jax_hc  # noqa: E402
from world_tpu.ops import matlab as jax_matlab  # noqa: E402
from world_tpu.ops import rng as jax_rng  # noqa: E402
from world_tpu_torch.models import harvest_contour as hc  # noqa: E402
from world_tpu_torch.ops import iir, matlab, rng  # noqa: E402

LENGTHS = (1, 19, 127, 128, 129, 2000)
LANES = (1, 3, 16)


def T(a):
    return torch.as_tensor(a)


# The per-sample loops as they stood before ops/iir.py, kept here
# verbatim as the reference of the plain paths.

def decimate_stage_loop(x, r):
    a0, a1, a2, b0, b1 = (float(v) for v in matlab._DECIMATE_COEFFS[r])
    w0 = w1 = w2 = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    ys = []
    for xi in x.unbind(-1):
        wt = xi + a0 * w0 + a1 * w1 + a2 * w2
        ys.append(b0 * wt + b1 * w0 + b1 * w1 + b0 * w2)
        w0, w1, w2 = wt, w0, w1
    return torch.stack(ys, -1)


def biquad_loop(seq):
    b0, b1 = hc._B
    a0, a1 = hc._A
    x1 = x2 = y1 = y2 = torch.zeros(seq.shape[:-1], dtype=seq.dtype,
                                    device=seq.device)
    ys = []
    for xt in seq.unbind(-1):
        yt = b0 * xt + b1 * x1 + b0 * x2 + a0 * y1 + a1 * y2
        ys.append(yt)
        x1, x2, y1, y2 = xt, x1, yt, y1
    return torch.stack(ys, -1)


def zero_phase(f, x):
    return f(f(x).flip(-1)).flip(-1)


def decimate_before(x, r):
    """ops/matlab.py's decimate before the wrapper."""
    n = x.shape[-1]
    k = 9
    head = 2.0 * x[..., :1] - x[..., 1:k + 1].flip(-1)
    tail = 2.0 * x[..., n - 1:n] - x[..., n - 1 - k:n - 1].flip(-1)
    t = torch.cat([head, x, tail], dim=-1)
    t = zero_phase(lambda u: decimate_stage_loop(u, r), t)
    nout = (n - 1) // r + 1
    start = r - r * nout + n + k - 1
    return t[..., start:start + (nout - 1) * r + 1:r]


def state_loop_matmul(p, AL):
    """lti_block_filter's state loop before the wrapper (s @ AL.T)."""
    s = torch.zeros(p.shape[:-2] + (AL.shape[0],), dtype=p.dtype)
    states = []
    for j in range(p.shape[-2]):
        states.append(s)
        s = s @ AL.T + p[..., j, :]
    return torch.stack(states, -2)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n", LENGTHS)
def test_zero_phase_plain_equals_loops(n, lanes):
    """iir_zero_phase's plain path == the per-sample loops forward,
    flipped and back, bit for bit: decimate's stage (a ratio per case)
    and the smoothing biquad, with leading lane dims."""
    rs = np.random.default_rng(n * 31 + lanes)
    x = T(rs.standard_normal((lanes, n)) * 100.0)
    r = 2 + (n + lanes) % 11
    got = iir.iir_zero_phase(x, "decimate", r)
    assert got.shape == x.shape
    assert torch.equal(got, zero_phase(
        lambda u: decimate_stage_loop(u, r), x))
    x3 = x.reshape(lanes, 1, n)
    assert torch.equal(iir.iir_zero_phase(x3, "smooth"),
                       zero_phase(biquad_loop, x3))


@pytest.mark.parametrize("r", range(2, 13))
def test_decimate_f64_golden_and_jax(gold, r):
    """float64 decimate through the wrapper: == the loops bit for bit,
    the goldens at 1e-12, JAX's float64 decimate at 1e-14, on two rows."""
    x = gold["x"][:2000]
    xb = T(np.stack([x, 0.5 * x]))
    got = matlab.decimate(xb, r)
    assert torch.equal(got, decimate_before(xb, r))
    np.testing.assert_allclose(got[0].numpy(), gold[f"decimate_r{r}"],
                               rtol=0, atol=1e-12)
    want = np.asarray(jax_matlab.decimate(jnp.asarray(0.5 * x), r))
    np.testing.assert_allclose(got[1].numpy(), want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("r", [4, 11])
def test_decimate_f32_state_scan_vs_jax(gold, r):
    """float32 decimate (the block-LTI form, its state through
    lti_state_scan) against JAX's float32 decimate on the whole golden
    utterance, two rows."""
    x = gold["x"].astype(np.float32)
    got = matlab.decimate(T(np.stack([x, 0.7 * x])), r).numpy()
    for row, gain in enumerate((1.0, 0.7)):
        want = np.asarray(jax_matlab.decimate(
            jnp.asarray(gain * x, jnp.float32), r))
        np.testing.assert_allclose(got[row], want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("S", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_state_scan_plain_vs_matmul_loop(dtype, S):
    """The rewritten plain state loop (products and sums in index order)
    against the loop it replaced (s @ AL.T): float64 at 1e-12 relative,
    float32 within its rounding; the first state is 0."""
    dt = getattr(torch, dtype)
    tables = (matlab._decimate_block_tables(5, 128) if S == 3
              else hc._biquad_tables())
    AL = T(tables[3]).to(dt)
    rs = np.random.default_rng(S)
    p = T(rs.standard_normal((3, 140, S))).to(dt)
    got = iir.lti_state_scan(p, AL)
    want = state_loop_matmul(p.double(), AL.double())
    assert got.dtype == dt and got.shape == p.shape
    assert not got[..., 0, :].any()
    tol = 1e-12 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=tol, atol=tol * float(want.abs().max()))


def test_lti_block_filter_f64_edges():
    """lti_block_filter through lti_state_scan == the per-sample biquad at
    block edges (1, 127, 128, 129, 257 samples) and 16 lanes."""
    rs = np.random.default_rng(3)
    for n in (1, 127, 128, 129, 257):
        x = T(rs.standard_normal((16, n)))
        got = matlab.lti_block_filter(x, hc._biquad_tables())
        np.testing.assert_allclose(got.numpy(), biquad_loop(x).numpy(),
                                   rtol=1e-12, atol=1e-13)


def harsh_track(seed, F=400):
    """An F0 track of voiced sections of 3-60 frames, some touching the
    ends, around a drifting pitch."""
    rs = np.random.default_rng(seed)
    pitch = 180.0 * np.exp(np.cumsum(rs.standard_normal(F) * 0.02))
    f0 = np.zeros(F)
    t = int(rs.integers(0, 2))
    while t < F:
        run = int(rs.integers(3, 61))
        f0[t:t + run] = pitch[t:t + run]
        t += run + int(rs.integers(1, 20))
    return f0


def test_smoothing_f64_vs_oracle(gold):
    """The float64 smoothing through iir_zero_phase == the numpy oracle
    (scipy lfilter) at 1e-9, on the golden Harvest track and two harsh
    tracks in one batch (B * sections lanes)."""
    tracks = [gold["harvest_f0"]] + [harsh_track(s, len(gold["harvest_f0"]))
                                     for s in (1, 2)]
    got = hc._smooth_contour(T(np.stack(tracks)))
    for row, f0 in zip(got.numpy(), tracks):
        np.testing.assert_allclose(row, H._smooth_contour_np(f0),
                                   rtol=1e-9, atol=1e-9)


def test_smoothing_f32_state_scan_vs_jax(gold):
    """The float32 smoothing (block-LTI, its state through lti_state_scan)
    against JAX's float32 _smooth_contour."""
    for f0 in (gold["harvest_f0"], harsh_track(5)):
        F = len(f0)
        got = hc._smooth_contour(T(f0[None]).float())[0].numpy()
        want = np.asarray(jax_hc._smooth_contour(
            jnp.asarray(f0, jnp.float32), F // 8 + 2))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 63, 64, 2 ** 20 + 5, 2 ** 33 - 70])
def test_randn_span_plain_vs_jax(offset):
    """randn_blocks_at through randn_span (plain on the CPU) == JAX's
    randn_blocks_at exactly: blocks at and around ``offset``, spanning
    several lanes."""
    offsets = np.array([offset, offset + 1, offset + 64, offset + 200])
    got = rng.randn_blocks_at(T(offsets), 150).numpy()
    want = np.asarray(jax_rng.randn_blocks_at(jnp.asarray(offsets), 150))
    assert np.array_equal(got, want)


def test_randn_span_lanes():
    """randn_span's lanes are windows of one stream: lane k starts where
    lane k-1's 64 draws end."""
    starts = torch.arange(5, dtype=torch.int64) * rng._LANE + 7
    span = rng.randn_span(starts, int(starts[-1]))
    assert span.shape == (5, rng._LANE) and span.dtype == torch.float64
    whole = rng.randn_span(torch.tensor([7]), 7)
    assert torch.equal(span[0], whole[0])
    assert torch.equal(span.reshape(-1)[:rng._LANE], whole[0])
    seq = rng.randn_sequence(7 + 5 * rng._LANE)
    assert torch.equal(span.reshape(-1), seq[7:])


def test_jump_rows_layout():
    """The packed rows csrc/xorshift.cu reads: word k of row i holds
    M[i, 32k:32k+32], bit j of the word being M[i, 32k+j]."""
    mats = rng._jump_matrices()
    rows = rng._jump_rows(torch.device("cpu")).numpy().view(np.uint32)
    assert rows.shape == (rng._MAX_LOG2, 128, 4)
    bits = (rows[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    assert np.array_equal(bits.reshape(mats.shape), mats)


def test_wrapper_errors():
    """Wrong dtype, recurrence, ratio, state size and stream position
    raise."""
    x = torch.zeros(3, 40)
    with pytest.raises(TypeError):
        iir.iir_zero_phase(x, "smooth")
    with pytest.raises(ValueError):
        iir.iir_zero_phase(x.double(), "lowpass")
    with pytest.raises(ValueError):
        iir.iir_zero_phase(x.double(), "decimate", 13)
    with pytest.raises(ValueError):
        iir.lti_state_scan(torch.zeros(2, 5, 5), torch.eye(5))
    with pytest.raises(ValueError):
        iir.lti_state_scan(torch.zeros(2, 5, 3), torch.eye(3).double())
    with pytest.raises(TypeError):
        iir.lti_state_scan(torch.zeros(2, 5, 3, dtype=torch.int32),
                           torch.eye(3))
    with pytest.raises(ValueError):
        rng.randn_span(torch.tensor([2 ** 34]), 2 ** 34)


# The kernels' designs (csrc/iir.cu, csrc/xorshift.cu), held to the plain
# versions here before any card runs them: the same operations in the
# same order, written the way the kernels place them.  Python floats and
# numpy float64 round every operation on its own, as the kernels'
# _rn intrinsics do, so each comparison is bit for bit.

def _coeffs(recurrence, r):
    return [float(v) for v in iir._recurrence(recurrence, r)[2]]


def _shift(rows, k):
    """rows delayed by k samples along the last axis, zeros in front."""
    out = np.zeros_like(rows)
    out[:, k:] = rows[:, :rows.shape[1] - k]
    return out


def split_pass(rows, recurrence, r):
    """One pass split as the kernel's chain thread and helpers split it:
    a loop over only the chain's operations (and the products of the
    next step, which wait on nothing), the off-chain terms as whole-row
    operations."""
    out = np.empty_like(rows)
    if recurrence == "decimate":
        a0, a1, a2, b0, b1 = _coeffs(recurrence, r)
        for lane, xs in enumerate(rows.tolist()):
            w0 = w1 = w2 = 0.0
            q1, q2 = a1 * w1, a2 * w2
            for k, xi in enumerate(xs):
                wt = ((xi + a0 * w0) + q1) + q2
                q2, q1 = a2 * w1, a1 * w0
                w0, w1, w2 = wt, w0, w1
                out[lane, k] = wt
        wt = out
        return (((b0 * wt + b1 * _shift(wt, 1)) + b1 * _shift(wt, 2))
                + b0 * _shift(wt, 3))
    b0, b1, a0, a1, _ = _coeffs(recurrence, r)
    u = (b0 * rows + b1 * _shift(rows, 1)) + b0 * _shift(rows, 2)
    for lane, us in enumerate(u.tolist()):
        y1 = y2 = 0.0
        q = a1 * y2
        for k, uk in enumerate(us):
            y = (uk + a0 * y1) + q
            q = a1 * y1
            y1, y2 = y, y1
            out[lane, k] = y
    return out


def same_bits(got, want):
    """NaN at the same places, equal elsewhere (signed zeros too)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    return (np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan], want[~nan])
            and np.array_equal(np.signbit(got[~nan]),
                               np.signbit(want[~nan])))


ZERO_PHASE_CASES = ([("decimate", r) for r in range(2, 13)]
                    + [("smooth", None)])


@pytest.mark.parametrize("recurrence,r", ZERO_PHASE_CASES)
def test_zero_phase_chain_split_equals_plain(gold, recurrence, r):
    """The chain/off-chain split of each recurrence, forward, flipped and
    again, == iir_zero_phase_plain bit for bit: on random rows (one with
    a NaN, an inf and a -inf) and on a golden row (decimate's padded
    utterance, the golden Harvest track for the smoothing)."""
    rs = np.random.default_rng(40 + (r or 0))
    rows = rs.standard_normal((3, 600)) * 100.0
    rows[1, 100], rows[1, 300], rows[1, 599] = np.nan, np.inf, -np.inf
    if recurrence == "decimate":
        x = gold["x"][:2000]
        golden_row = np.concatenate([2 * x[0] - x[9:0:-1], x,
                                     2 * x[-1] - x[-2:-11:-1]])
    else:
        golden_row = np.repeat(gold["harvest_f0"], 2)[:1394]
    for x in (rows, golden_row[None]):
        with np.errstate(invalid="ignore", over="ignore"):
            got = split_pass(split_pass(x, recurrence, r)[:, ::-1].copy(),
                             recurrence, r)[:, ::-1]
        want = iir.iir_zero_phase_plain(T(x), recurrence, r).numpy()
        assert same_bits(got, want)


def _rows_u32(rows):
    return rows.numpy().view(np.uint32)


def ballot_jump(rows, state):
    """M state in the kernel's form: for word w, thread j's bit is the
    parity of popc(row[w*32 + j] & state) over the four words, and the
    ballot puts it at bit j.  rows (128, 4) uint32, state 4 words."""
    anded = rows & np.asarray(state, np.uint32)
    parity = np.unpackbits(anded.view(np.uint8), axis=-1).sum(-1) & 1
    weights = 1 << np.arange(32, dtype=np.uint64)
    return [int((parity[w * 32:(w + 1) * 32].astype(np.uint64)
                 * weights).sum()) for w in range(4)]


def lane_state(start):
    """The state at draw ``start`` as a lane's warp makes it: one
    ballot_jump a set bit, from the seed."""
    rows = _rows_u32(rng._jump_rows(torch.device("cpu")))
    s = list(rng.SEED)
    for b in range(int(start).bit_length()):
        if (start >> b) & 1:
            s = ballot_jump(rows[b], s)
    return s


@pytest.mark.parametrize("bit", range(rng._MAX_LOG2))
def test_ballot_jump_equals_states_at_draws(bit):
    """The ballot form of the jumps over _jump_rows' packing ==
    states_at_draws, for a start with ``bit`` set alone and one with
    bit and lower bits set."""
    starts = [1 << bit, (1 << bit) | ((bit * 0x9E3779B1) % (1 << bit))]
    want = rng.states_at_draws(torch.tensor(starts)).numpy()
    for start, w in zip(starts, want):
        assert lane_state(start) == [int(v) for v in w], start


def test_split_table_layout_is_the_kernels():
    """rng._DRAWERS, which shapes _split_rows, is csrc/xorshift.cu's
    kDrawers (the kernel reads kDrawers - 1 matrices of 128 packed rows),
    and _LANE and _MAX_LOG2 are its kLane and kMaxBits."""
    src = (Path(iir.__file__).resolve().parents[1] / "csrc"
           / "xorshift.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kDrawers") == rng._DRAWERS
    assert const("kLane") == rng._LANE
    assert const("kMaxBits") == rng._MAX_LOG2
    assert tuple(rng._split_rows(torch.device("cpu")).shape) == (
        const("kDrawers") - 1, const("kRows"), 4)


def test_split_rows_are_powers_of_the_draw_matrix():
    """The draw split's table: entry t - 1 is M_draw^(t * 64 / _DRAWERS)
    packed, M_draw^k made here by k products of _jump_matrices()[0]."""
    mats = rng._jump_matrices()
    per = rng._LANE // rng._DRAWERS
    rows = _rows_u32(rng._split_rows(torch.device("cpu")))
    assert rows.shape == (rng._DRAWERS - 1, 128, 4)
    bits = ((rows[..., None] >> np.arange(32, dtype=np.uint32)) & 1)
    power = np.eye(128, dtype=np.uint8)
    for k in range(1, rng._LANE):
        power = rng._gf2_matmul(mats[0], power)
        if k % per == 0:
            assert np.array_equal(bits[k // per - 1].reshape(128, 128), power)


def _draws(state, count):
    """``count`` normals from a state, xorshift128 in Python ints."""
    x, y, z, w = state
    out = []
    for _ in range(count):
        acc = 0
        for _ in range(12):
            t = (x ^ (x << 11)) & 0xFFFFFFFF
            x, y, z = y, z, w
            w = (w ^ (w >> 19)) ^ (t ^ (t >> 8))
            acc += w >> 4
        out.append(float(acc) * 2.0 ** -28 - 6.0)
    return out


@pytest.mark.parametrize("start", [0, 1, 63, 64, 2 ** 20 + 5,
                                   2 ** 34 - 1 - 64])
def test_draw_split_model_equals_plain(start):
    """A lane as the kernel's warp draws it: the lane's state by ballot
    jumps, thread t's by a ballot jump of the split table (thread 0 the
    lane's own), each thread's 64 / _DRAWERS draws in order == the
    plain version's lane bit for bit."""
    split = _rows_u32(rng._split_rows(torch.device("cpu")))
    s = lane_state(start)
    per = rng._LANE // rng._DRAWERS
    got = []
    for t in range(rng._DRAWERS):
        got += _draws(s if t == 0 else ballot_jump(split[t - 1], s), per)
    want = rng.randn_span_plain(torch.tensor([start]), start)[0].numpy()
    assert np.array_equal(np.array(got), want)
