"""StoneMask's float32 refinement (world_tpu_torch/ops/stonemask.py) on
the CPU, where the wrapper runs its plain version, against the JAX
package's float32 StoneMask (world_tpu/models/stonemask.py:
_stone_mask_impl's float32 branch and the _refine_direct it runs) on the
same inputs.  The kernel (csrc/stonemask.cu) is held to the plain
version on the card by tests/test_torch_cuda.py (-k stonemask) and
chip_smoke.py.

Tolerance against JAX: VUV equal on every frame, and voiced F0 within
1e-6 relative of JAX's on every frame.  The two take the same float32
arguments; they part in the cos / sin of them (the port's float64
rounded once, XLA's float32 within an ulp of it) and in the order of the
dots' sums.  Measured here: the five golden rates from JAX's own float32
Dio track 3.2e-7 at worst (8 kHz; 2.3e-7 at the others); the seeded
frames 8.5e-7 at worst.  One kind of frame is held to 1e-4 instead: a
second pass that reads the Nyquist bin (index clamped at fft / 2, t0
above fs / 12), whose sine at a multiple of pi is float32 noise in XLA's
evaluation and not in the port's (4.0e-5 measured, 22.05 kHz); those
frames are counted and few.  Where the two part there by more than 1e-6,
_refine_direct in float64 on the same inputs is the second witness: it
lies over 100x their gap from both (3.3e-2 / 9.9e-2 relative against
2.0e-5 / 3.7e-6 measured at 22.05 / 44.1 kHz), so float32 cannot fix
those frames and the gap is its noise."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import Goldens  # noqa: E402

from world_tpu.models import dio as jax_dio  # noqa: E402
from world_tpu.models import stonemask as jax_sm  # noqa: E402
from world_tpu_torch.models import stonemask as port_sm  # noqa: E402
from world_tpu_torch.ops import stonemask  # noqa: E402
from world_tpu_torch.tools.stonemask_bench import (  # noqa: E402
    glide, seeded_frames)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = ["goldens", "goldens_fs8", "goldens_fs16", "goldens_fs44",
           "goldens_fs48"]
RATES = [8000, 16000, 22050, 44100, 48000]
REL = 1e-6           # voiced F0 against JAX's, every frame
NYQUIST_REL = 1e-4   # frames whose second pass reads the Nyquist bin


def max_len_of(fs):
    return max(jax_sm._possible_fft_sizes(fs)) // 2


def port(x, pos, f0, fs):
    """The wrapper (the plain version here) on (B, L), (B, F), (B, F)."""
    return stonemask.stonemask_refine(
        *(torch.as_tensor(np.array(a, np.float32)) for a in (x, pos, f0)),
        float(fs), max_len_of(fs)).numpy()


def jax_stone_mask(x, pos, f0, fs):
    return np.asarray(jax_sm._stone_mask_impl(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(f0),
        jnp.asarray(np.float32(fs)), fs=fs))


def gate(got, want, excused=None):
    """VUV equal everywhere; voiced F0 within REL of JAX's but where
    ``excused`` (within NYQUIST_REL there).  Returns the worst relative
    error outside ``excused``."""
    assert ((got > 0) == (want > 0)).all()
    v = want > 0
    rel = np.zeros(got.shape)
    rel[v] = np.abs(got[v].astype(np.float64) / want[v] - 1.0)
    excused = np.zeros(got.shape, bool) if excused is None else excused
    assert rel[~excused].max() <= REL, rel[~excused].max()
    assert (rel[excused] <= NYQUIST_REL).all(), rel[excused].max()
    return rel[~excused].max()


@pytest.mark.parametrize("dirname", GOLDENS)
def test_golden_rates_match_jax(dirname):
    """JAX's own float32 Dio track of each golden utterance through both
    StoneMasks."""
    g = Goldens(os.path.join(HERE, dirname))
    fs = g.scalar("fs")
    x = g["x"].astype(np.float32)
    tp, f0 = (np.asarray(a) for a in jax_dio.dio(jnp.asarray(x), fs))
    want = np.asarray(jax_sm.stone_mask(jnp.asarray(x), fs, tp, f0))
    got = port(x[None], tp[None].astype(np.float32), f0[None], fs)[0]
    assert (want > 0).sum() > 100
    assert gate(got, want) <= 4e-7


@jax.jit
def _jax_direct(x, fs_t, pos, f0, max_len_marker):
    max_len = max_len_marker.shape[0]
    return jax.vmap(lambda p, f: jax_sm._refine_direct(
        x, fs_t, max_len, p, f))(pos, f0)


def jax_direct(x, pos, f0, fs):
    """JAX's _refine_direct frame by frame (fs traced, as
    _stone_mask_impl passes it), then StoneMask's 20% rule."""
    r = np.asarray(_jax_direct(jnp.asarray(x), jnp.asarray(np.float32(fs)),
                               jnp.asarray(pos), jnp.asarray(f0),
                               jnp.zeros((max_len_of(fs), 0))))
    over = np.abs(r - f0) > f0 * np.float32(0.2)
    return np.where(over, f0, r), r


def f64_direct(x, pos, f0, fs):
    """_refine_direct in float64 on the same float32 inputs, then the 20%
    rule."""
    r = np.asarray(_jax_direct(
        *(jnp.asarray(a, jnp.float64) for a in (x, np.float32(fs), pos, f0)),
        jnp.zeros((max_len_of(fs), 0))))
    return np.where(np.abs(r - f0) > f0 * 0.2, f0, r)


def nyquist_frames(x, pos, f0, fs):
    """The frames whose second pass reads the Nyquist bin (its index
    clamped at fft / 2), and whose first pass fails."""
    fs_t = torch.full((), float(fs))
    xt = torch.as_tensor(x)[None]
    rows = torch.zeros(len(f0), dtype=torch.int64)
    f0_t = torch.as_tensor(f0)
    xm, xd, fft_f = stonemask.windowed(xt, rows, torch.as_tensor(pos), f0_t,
                                       fs_t)
    t0 = stonemask._fix_f0(xm, xd, f0_t, fft_f, fs_t, 2)
    bad = (t0 <= 0.0) | (t0 > f0_t * 2.0)
    index = port_sm.matlab_round(t0[:, None] * fft_f[:, None] / fs_t
                                 * torch.arange(1, 7).float())
    half = (fft_f / 2.0).to(torch.int64)[:, None]
    return ((index >= half).any(1) & ~bad).numpy(), bad.numpy()


@pytest.mark.parametrize("fs", RATES)
def test_frames_match_refine_direct(fs):
    """Seeded frames frame by frame against _refine_direct: F0 across
    (40, fs / 12] along a glide, on the fft-size boundaries, windows
    clamped at both edges, first passes that fail."""
    x, pos, f0 = seeded_frames(fs, seed=fs)
    got = port(x[None], pos[None], f0[None], fs)[0]
    want, raw = jax_direct(x, pos, f0, fs)
    nyq, bad = nyquist_frames(x, pos, f0, fs)
    assert nyq.sum() <= 3
    gate(got, want, excused=nyq)
    far = nyq & (np.abs(got / want - 1.0) > REL)
    ref = f64_direct(x, pos, f0, fs)[far]
    assert (100 * np.abs(got[far] - want[far]) <= np.minimum(
        np.abs(got[far] - ref), np.abs(want[far] - ref))).all()
    # The silent frames fail their first pass (t0 = 0) in both and keep
    # their F0; so does every frame whose pass fails.
    assert bad[-3:].all() and (got[bad] == f0[bad]).all()
    assert (raw[bad] == 0.0).all()
    # And the whole StoneMask agrees on the same frames.
    np.testing.assert_array_equal(
        got, port_sm.stone_mask_batch(torch.as_tensor(x)[None], fs,
                                      torch.as_tensor(pos),
                                      torch.as_tensor(f0)[None])[0].numpy())
    gate(got, jax_stone_mask(x, pos, f0, fs), excused=nyq)


def test_first_pass_above_twice_f0():
    """A pure tone at 4.1 f0: the first pass's t0 is above 2 f0, so both
    keep the input F0 (JAX's _refine_direct gives 0 there)."""
    fs, f0_hz = 22050, 110.0
    t = np.arange(int(0.3 * fs)) / fs
    x = np.sin(2 * np.pi * 4.1 * f0_hz * t).astype(np.float32)
    pos = np.linspace(0.05, 0.25, 9).astype(np.float32)
    f0 = np.full(9, f0_hz, np.float32)
    got = port(x[None], pos[None], f0[None], fs)[0]
    _, raw = jax_direct(x, pos, f0, fs)
    _, bad = nyquist_frames(x, pos, f0, fs)
    assert bad.all() and (raw == 0.0).all()
    np.testing.assert_array_equal(got, f0)


def test_unusable_frames_and_20_percent_rule():
    """Frames outside 40 < f0 <= fs / 12 (at and beside both limits, 0,
    negative, NaN, inf) give 0; F0s 30% off the signal's pitch keep
    their input by the 20% rule; as JAX's StoneMask, frame by frame."""
    fs = 16000
    x, pitch = glide(fs, 7)
    top = np.float32(np.float32(fs) / np.float32(12.0))
    odd = [0.0, -100.0, 40.0, np.nextafter(np.float32(40.0), np.float32(50)),
           top, np.nextafter(top, np.float32(1e9)), np.nan, np.inf, 1e9]
    rs = np.random.RandomState(3)
    idx = rs.randint(0, len(x), 40)
    f0 = np.concatenate([odd, pitch[idx[:20]] * 1.3,
                         pitch[idx[20:]]]).astype(np.float32)
    pos = np.concatenate([np.full(len(odd), 0.3),
                          idx / fs]).astype(np.float32)
    got = port(x[None], pos[None], f0[None], fs)[0]
    want = jax_stone_mask(x, pos, f0, fs)
    gate(got, want)
    usable = (f0 > 40.0) & (f0 <= top)
    assert usable.tolist()[:len(odd)] == [False, False, False, True, True,
                                          False, False, False, False]
    assert (got[~usable] == 0.0).all()
    kept = got[len(odd):len(odd) + 20] == f0[len(odd):len(odd) + 20]
    assert kept.sum() >= 5


def test_batch_rows_equal_single_runs():
    """Rows of one call equal each row alone (bit for bit), and JAX's."""
    fs = 22050
    rows = [seeded_frames(fs, seed=s, n=60) for s in (1, 2, 3)]
    n = min(len(r[1]) for r in rows)
    x = np.stack([r[0] for r in rows])
    pos = np.stack([r[1][:n] for r in rows])
    f0 = np.stack([r[2][:n] for r in rows])
    both = port(x, pos, f0, fs)
    for b in range(3):
        alone = port(x[b:b + 1], pos[b:b + 1], f0[b:b + 1], fs)[0]
        np.testing.assert_array_equal(both[b], alone)
        nyq, _ = nyquist_frames(x[b], pos[b], f0[b], fs)
        gate(both[b], jax_stone_mask(x[b], pos[b], f0[b], fs), excused=nyq)


def test_fft_size_is_jax_exp2():
    """fft_size reproduces JAX's float32 exp2 of 2 + floor(log2(win_len))
    for every odd window length to 2^15 (not the power of two at 2^13
    and 2^15)."""
    w = np.arange(3, 1 << 15, 2)
    e = (2.0 + np.floor(np.log(w.astype(np.float32))
                        / np.float32(0.69314718055994529)))
    want = np.asarray(jax.jit(jnp.exp2)(jnp.asarray(e.astype(np.float32))))
    got = stonemask.fft_size(torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[w == 2049][0] != 8192.0


def test_float32_stone_mask_is_one_wrapper_call(monkeypatch):
    """stone_mask_batch's float32 branch calls the wrapper once on all
    (B, F) frames, with JAX's max_len, and issues at most 6 top-level
    torch ops around it (the kernel's stand-in allocates its output)."""
    from torch.profiler import ProfilerActivity, profile

    calls = []

    def stand_in(x, positions, f0, fs_t, max_len):
        calls.append((tuple(x.shape), tuple(positions.shape),
                      tuple(f0.shape), fs_t, max_len))
        return torch.empty_like(f0)

    monkeypatch.setattr(port_sm, "stonemask_refine", stand_in)
    fs = 48000
    x, pos, f0 = seeded_frames(fs, n=40)
    xb = torch.as_tensor(np.stack([x, x]))
    f0b = torch.as_tensor(np.stack([f0, f0]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_sm.stone_mask_batch(xb, fs, torch.as_tensor(pos), f0b)
    top = [e for e in prof.events() if e.name.startswith("aten::")
           and e.cpu_parent is None]
    assert calls == [((2, len(x)), f0b.shape, f0b.shape, 48000.0,
                      max_len_of(fs))]
    assert len(top) <= 6, [e.name for e in top]


def test_wrapper_checks():
    fs = 22050
    x = torch.zeros(2, 1000)
    f0 = torch.full((2, 5), 100.0)
    ok = dict(x=x, positions=torch.zeros(2, 5), f0=f0, fs_t=float(fs),
              max_len=max_len_of(fs))
    assert stonemask.stonemask_refine(**ok).shape == (2, 5)
    for bad, err in ((dict(f0=f0.double()), TypeError),
                     (dict(positions=torch.zeros(5)), ValueError),
                     (dict(x=torch.zeros(3, 1000)), ValueError),
                     (dict(max_len=stonemask.window_bound(fs) - 1),
                      ValueError),
                     (dict(max_len=stonemask.MAX_LEN + 1), ValueError),
                     (dict(fs_t=-1.0), ValueError)):
        with pytest.raises(err):
            stonemask.stonemask_refine(**{**ok, **bad})
    assert stonemask.window_bound(fs) <= max_len_of(fs)
    assert stonemask.window_bound(48000) == 3603


def test_kernel_builds_without_fma():
    """csrc/stonemask.cu rounds each product on its own, as the plain
    version's ops do: nvcc may not fuse a multiply and an add there."""
    from world_tpu_torch.ops import _cuda

    assert "-fmad=false" in _cuda.SOURCE_FLAGS["stonemask"]


@pytest.mark.parametrize("n", [1, 31, 33, 595])
def test_32_lane_sum_is_the_kernel_order(n):
    """refine.warp_sum(t, LANES) is, bit for bit, lane l of a warp's 32
    adding i = l, l + 32, ... to 0.0 in turn, then the xor butterfly
    over 16, 8, ..., 1, as csrc/stonemask.cu sums each dot."""
    from world_tpu_torch.ops.refine import warp_sum

    lanes = stonemask.LANES
    t = np.random.default_rng(n).standard_normal((40, n)).astype(np.float32)
    acc = np.zeros((40, lanes), np.float32)
    for i in range(n):
        acc[:, i % lanes] = acc[:, i % lanes] + t[:, i]
    off = lanes // 2
    while off:
        acc = acc + acc[:, np.arange(lanes) ^ off]
        off //= 2
    np.testing.assert_array_equal(
        warp_sum(torch.as_tensor(t), lanes).numpy(), acc[:, 0])


def lookahead_walk(w, lanes=32):
    """The kernel's walk of one pass over a window ``w`` (win_len,)
    (csrc/stonemask.cu: fix_f0), in numpy: lane l takes i = 32 k + l, w
    computed one chunk ahead (zero past the window), w[i - 1] by
    __shfl_up_sync with lane 0 taking the previous chunk's lane 31 from
    a register, w[i + 1] by __shfl_down_sync with lane 31 taking the
    next chunk's lane 0.  Returns (prv, cur, nxt) as the lanes hold them
    at each i < win_len."""
    n = len(w)

    def window(i):
        return np.where(i < n, w[np.minimum(i, n - 1)], np.float32(0))

    lane = np.arange(lanes)
    cur, ahead = window(lane), window(lane + lanes)
    carry = np.float32(0)
    chunks = -(-n // lanes)
    out = np.zeros((3, chunks * lanes), np.float32)
    for k in range(chunks):
        prv = cur[np.maximum(lane - 1, 0)]      # __shfl_up_sync(w, 1)
        nxt = cur[np.minimum(lane + 1, lanes - 1)]  # __shfl_down_sync
        prv[0] = carry
        nxt[-1] = ahead[0]
        carry = cur[-1]
        i = k * lanes + lane
        out[:, i] = prv, cur, nxt
        cur, ahead = ahead, window(i + 2 * lanes)
    return out[:, :n]


@pytest.mark.parametrize("win_len", [3, 31, 33, 63, 65, 95, 97, 127, 129,
                                     595, 1655, 3603])
def test_lookahead_neighbours_are_the_window_shifted(win_len):
    """The kernel's look-ahead walk gives every i < win_len (lanes 0 and
    31, the first and the last chunk among them) w[i - 1], w[i], w[i + 1]
    with zeros outside the window, and its difference -(nxt - prv) / 2 is
    the plain version's, bit for bit, on a frame of that window (x = 1,
    so that ``windowed`` returns the window and its difference)."""
    fs = 48000.0
    hw = (win_len - 1) // 2
    f0 = torch.tensor([1.5 * fs / (hw - 0.5)], dtype=torch.float32)
    x = torch.ones((1, 4 * win_len + 64))
    pos = torch.tensor([2 * win_len / fs], dtype=torch.float32)
    fs_t = torch.full((), fs)
    assert int((1.5 * fs_t / f0 + 1.0).to(torch.int64)) == hw
    w, d, _ = stonemask.windowed(x, torch.zeros(1, dtype=torch.int64), pos,
                                 f0, fs_t)
    assert (w[0, win_len:] == 0).all() and (d[0, win_len:] == 0).all()
    w, d = w[0, :win_len].numpy(), d[0, :win_len].numpy()
    prv, cur, nxt = lookahead_walk(w)
    z = np.zeros(1, np.float32)
    np.testing.assert_array_equal(cur, w)
    np.testing.assert_array_equal(prv, np.concatenate([z, w[:-1]]))
    np.testing.assert_array_equal(nxt, np.concatenate([w[1:], z]))
    np.testing.assert_array_equal(-(nxt - prv) * np.float32(0.5), d)


def kernel_constants():
    """The float64 constants of csrc/stonemask.cu's sincos_once."""
    import re
    src = open(os.path.join(HERE, "..", "world_tpu_torch", "csrc",
                            "stonemask.cu")).read()
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"constexpr double (k\w+) = ([-+0-9.e]+);", src)}


def test_kernel_sincos_reduction_is_exact():
    """kPio2Hi has 45 significant bits, kPio2Hi + kPio2Lo is pi / 2 to
    1e-30, and up to 400 radians the quadrant stays below 256, so that q
    kPio2Hi is exact (45 + 8 bits) and so is a - q kPio2Hi."""
    from fractions import Fraction

    k = kernel_constants()
    hi = Fraction(k["kPio2Hi"])
    assert (hi * 2 ** 44).denominator == 1
    pio2 = Fraction(314159265358979323846264338327950288419716939937510,
                    2 * 10 ** 50)
    assert abs(hi + Fraction(k["kPio2Lo"]) - pio2) < Fraction(1, 10 ** 30)
    assert round(400.0 * k["kTwoOverPi"]) < 256
    assert k["kRoundInt"] == 1.5 * 2.0 ** 52
