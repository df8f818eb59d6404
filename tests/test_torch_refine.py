"""Harvest's float32 refinement (world_tpu_torch/ops/refine.py) on the
CPU, where the wrapper runs its plain version, against the JAX package's
float32 branch of _refine_all (world_tpu/models/harvest.py:450, the
direct 6-bin DFT of _refine_frame_direct) on the same inputs: the golden
utterances at 22.05 and 48 kHz in float32, and the 22.05 kHz one at a
seeded gain with seeded noise, each through the port's candidate stage.
The kernel (csrc/refine.cu) is held to the plain version on the card by
tests/test_torch_cuda.py (-k refine) and chip_smoke.py.

Gates against JAX, from the plain version's own figures with headroom:
the surviving-pair masks equal or at most 0.1% of usable pairs apart; F0
relative error p99 <= 2e-4 and max <= 1e-3; score relative error max <=
1e-2.  Measured here: masks equal, F0 p99 3.5e-6-4.8e-6 and max 2.0e-5-
3.4e-5, score max 2.6e-3-7.4e-3 (48 kHz).  The two differ in the
trigonometry: JAX grows cos / sin by radix-16 angle addition (~1e-5 chain
error), which weak harmonic bins amplify in the score; the port reduces
every angle exactly.  At heavier noise (std 1e-2) one pair's score
differs from JAX's by 13%: the port's is within 3.5e-3 of the same
formulation in float64, JAX's 12% off it.  That case is held to the
float64 evaluation (test_refine_heavy_noise_tracks_float64), and to JAX
on masks and F0."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from world_tpu.models import harvest as jax_harvest  # noqa: E402
from world_tpu_torch import config  # noqa: E402
from world_tpu_torch.device import StageClock  # noqa: E402
from world_tpu_torch.models import harvest as port_harvest  # noqa: E402
from world_tpu_torch.ops import refine  # noqa: E402

from test_torch_cuda import remove_inputs  # noqa: E402

FLOOR, CEIL = config.K_FLOOR_F0, config.K_CEIL_F0
GOLDENS = {"22k": ("goldens", 22050), "48k": ("goldens_fs48", 48000)}
# (golden, gain, noise std, seed) of each input.
SIGNALS = {"22k": ("22k", 1.0, 0.0, None), "48k": ("48k", 1.0, 0.0, None),
           "22k_noise": ("22k", 0.7, 1e-3, 20261017),
           "22k_heavy_noise": ("22k", 0.8, 1e-2, 2)}


def signal(name):
    gold, gain, noise, seed = SIGNALS[name]
    import os
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     GOLDENS[gold][0])
    x = gain * np.fromfile(os.path.join(d, "x.f64"))
    if seed is not None:
        x = x + noise * np.random.default_rng(seed).standard_normal(len(x))
    return x.astype(np.float32), GOLDENS[gold][1]


def hw_max_of(fs_dec, f0_floor=FLOOR):
    """JAX's window bound (world_tpu/models/harvest.py:499)."""
    return int(1.5 * fs_dec / (f0_floor * 0.9 * 0.9) + 1.0) + 1


@functools.lru_cache(maxsize=None)
def stage(name):
    """The port's candidate stage on the CPU: (y (B, Ly), fs_dec,
    positions, cands (B, F, M))."""
    x, fs = signal(name)
    y, fs_dec, _, pos, cands = port_harvest._candidate_stage(
        torch.as_tensor(x)[None], fs, FLOOR, CEIL, 40.0,
        int(round(fs / 8000.0)), StageClock(None, "cpu"))
    return y, fs_dec, pos, cands


@functools.partial(jax.jit, static_argnames=("fs_dec",))
def _jax_refine(y, positions, cands, fs_dec):
    return jax_harvest._refine_all(
        y, jnp.asarray(fs_dec, jnp.float32), positions, cands, FLOOR, CEIL,
        jax_harvest._refine_buckets(fs_dec, FLOOR, CEIL), fs_dec)


def jax_refine(y, pos, cands, fs_dec):
    """JAX's float32 _refine_all on row 0; numpy (F, M) twice."""
    r, s = _jax_refine(jnp.asarray(y[0].numpy()), jnp.asarray(pos.numpy()),
                       jnp.asarray(cands[0].numpy()), fs_dec=fs_dec)
    return np.asarray(r), np.asarray(s)


def port_refine(y, pos, cands, fs_dec):
    r, s = refine.harvest_refine(y, pos, cands, fs_dec, FLOOR, CEIL,
                                 hw_max_of(fs_dec))
    return r[0].numpy(), s[0].numpy()


def gate(got, want, usable, score=True):
    """The JAX gates on the pairs of ``usable``: surviving masks, F0 and
    score relative errors where both survive."""
    (r, s), (jr, js) = got, want
    r, s, jr, js = r[usable], s[usable], jr[usable], js[usable]
    differ = int(((r > 0) != (jr > 0)).sum())
    assert differ <= 0.001 * usable.sum(), (differ, usable.sum())
    both = (r > 0) & (jr > 0)
    if not both.any():
        return
    f0_err = np.abs(r[both] / jr[both] - 1.0)
    assert np.percentile(f0_err, 99) <= 2e-4, np.percentile(f0_err, 99)
    assert f0_err.max() <= 1e-3, f0_err.max()
    if score:
        score_err = np.abs(s[both] / js[both] - 1.0)
        assert score_err.max() <= 1e-2, score_err.max()


@pytest.mark.parametrize("name", ["22k", "48k", "22k_noise"])
def test_refine_matches_jax(name):
    y, fs_dec, pos, cands = stage(name)
    usable = cands[0].numpy() > 0
    assert usable.sum() > 5000
    got = port_refine(y, pos, cands, fs_dec)
    gate(got, jax_refine(y, pos, cands, fs_dec), usable)
    assert ((got[0] > 0) <= usable).all() and ((got[1] > 0) <= usable).all()


def test_refine_heavy_noise_tracks_float64():
    """At noise std 1e-2 the port's float32 scores stay within 1e-2 of
    the same formulation in float64 (JAX's are 12% off on one pair); the
    masks and F0 meet the JAX gates."""
    y, fs_dec, pos, cands = stage("22k_heavy_noise")
    usable = cands[0].numpy() > 0
    r, s = port_refine(y, pos, cands, fs_dec)
    gate((r, s), jax_refine(y, pos, cands, fs_dec), usable, score=False)
    r64, s64 = refine.harvest_refine_plain(
        y.double(), pos.double(), cands.double(), fs_dec, FLOOR, CEIL,
        hw_max_of(fs_dec))
    r64, s64 = r64[0].numpy(), s64[0].numpy()
    both = (s > 0) & (s64 > 0)
    assert ((s > 0) != (s64 > 0)).sum() <= 0.001 * usable.sum()
    assert np.abs(s[both] / s64[both] - 1.0).max() <= 1e-2
    assert np.abs(r[both] / r64[both] - 1.0).max() <= 1e-4


def _edge_inputs():
    """The 22.05 kHz candidates with edge cases written into frames of
    their own: {case: frames}, and the edited cands."""
    y, fs_dec, pos, cands = stage("22k")
    c = cands.clone()
    n_frames, n_slots = c.shape[1:]
    counts = (c[0] > 0).sum(1)
    voiced = torch.nonzero(counts >= 10).flatten().tolist()
    src = c[0, voiced[len(voiced) // 2]].clone()
    floor_f0 = float(np.float32(FLOOR * 0.9 * 0.9))
    frames = {"first_last": [0, n_frames - 1],
              "floor": voiced[10:14], "high_f0": voiced[20:24],
              "below_floor": voiced[30:32], "empty_frame": voiced[40:42],
              "full_frame": voiced[50:52]}
    for f in frames["first_last"]:
        c[0, f] = src
    for case in ("floor", "high_f0", "below_floor", "empty_frame"):
        c[0, frames[case]] = 0.0
    for f in frames["floor"]:
        c[0, f, 1:4] = floor_f0
    for f in frames["high_f0"]:
        c[0, f, :2] = torch.tensor([650.0, 780.0])     # 5 and 4 harmonics
    for f in frames["below_floor"]:
        c[0, f, 2:4] = torch.tensor([50.0, 40.0])      # hw past hw_max
    for f in frames["full_frame"]:
        base = float(c[0, f, 0])
        c[0, f] = base * (1.0 + 0.002 * (torch.arange(n_slots) - 52.0))
    return y, fs_dec, pos, c, frames


@functools.lru_cache(maxsize=None)
def edge_results():
    y, fs_dec, pos, c, frames = _edge_inputs()
    return (port_refine(y, pos, c, fs_dec), jax_refine(y, pos, c, fs_dec),
            c[0].numpy(), frames, fs_dec)


@functools.partial(jax.jit, static_argnames=("fs_dec", "hw_max"))
def _jax_direct(seg_p, seg_m, c0, pos, f0, fs_dec, hw_max):
    """JAX's per-pair _refine_frame_direct over (frames, slots), the range
    test lifted (f0_floor 0, f0_ceil 1e9)."""
    def pair(sp, sm, c, p, f):
        return jax_harvest._refine_frame_direct(
            sp, sm, c, p, jnp.asarray(fs_dec, jnp.float32), hw_max, f, 0.0,
            1e9)
    one = jax.vmap(pair, in_axes=(None, None, None, None, 0))
    return jax.vmap(one)(seg_p, seg_m, c0, pos, f0)


def lifted_values(y, pos, c, fs_dec, rows):
    """(port, JAX) refined and scores of the frames ``rows`` with the
    range test lifted, each numpy (len(rows), M)."""
    hw_max = hw_max_of(fs_dec)
    r, s = refine.harvest_refine(y, pos, c, fs_dec, 0.0, 1e9, hw_max)
    fs = torch.full((), fs_dec)
    c0 = refine.matlab_round(pos * fs + 0.001)[rows]
    j = torch.arange(hw_max + 1)
    last = y.shape[1] - 1
    seg_p = y[0][(c0[:, None] - 1 + j).clamp(0, last)]
    seg_m = y[0][(c0[:, None] - 1 - j).clamp(0, last)]
    f0 = c[0, rows]
    jr, js = _jax_direct(jnp.asarray(seg_p.numpy()), jnp.asarray(
        seg_m.numpy()), jnp.asarray(c0.numpy().astype(np.int32)),
        jnp.asarray(pos[rows].numpy()), jnp.asarray(f0.numpy()),
        fs_dec=fs_dec, hw_max=hw_max)
    usable = f0.numpy() > 0
    return ((r[0, rows].numpy(), s[0, rows].numpy()),
            tuple(np.where(usable, np.asarray(a), 0.0) for a in (jr, js)))


@pytest.mark.parametrize("case", ["first_last", "floor", "high_f0",
                                  "below_floor", "empty_frame",
                                  "full_frame"])
def test_refine_edges_match_jax(case):
    got, want, c, frames, fs_dec = edge_results()
    rows = frames[case]
    usable = np.zeros_like(c, dtype=bool)
    usable[rows] = c[rows] > 0
    hw = (1.5 * np.float32(fs_dec) / c[rows][c[rows] > 0] + 1.0).astype(int)
    if case == "empty_frame":
        assert not usable.any()
        for a in got + want:
            assert (a[rows] == 0).all()
        return
    if case in ("floor", "below_floor"):
        # No pair of these survives the range test; with it lifted, each
        # does, and its values meet the gates against JAX's per-pair
        # function at the window bound (hw_max - 1) and past it.
        y, _, pos, c_t, _ = _edge_inputs()
        lifted, lifted_jax = lifted_values(y, pos, c_t, fs_dec, rows)
        assert (lifted[0][c[rows] > 0] > 0).all()
        gate(lifted, lifted_jax, c[rows] > 0)
    if case == "floor":
        assert (hw == hw_max_of(fs_dec) - 1).all()
    if case == "high_f0":
        assert set((np.float32(fs_dec) / 2.0 / c[rows][c[rows] > 0])
                   .astype(int)) == {4, 5}
    if case == "below_floor":
        assert (hw > hw_max_of(fs_dec)).all()
        # the 40 Hz pair's fft (2^11) is past the table's (2^10)
        assert refine.fft_log2(torch.as_tensor(2 * hw + 1)).max() > \
            refine.table_log2(hw_max_of(fs_dec))
    if case == "full_frame":
        assert (c[rows] > 0).all()
    assert usable.sum() >= 2
    gate(got, want, usable)
    got_all, want_all = got[0] > 0, want[0] > 0
    assert (got_all[rows] == want_all[rows]).all()


def test_refine_row_alone_equals_batch():
    """A row refined alone equals the same row in a batch of 4 (the plain
    version's chunks cut the pairs differently)."""
    x, fs = signal("22k")
    rng = np.random.default_rng(20261017)
    xb = np.stack([x * g + 1e-3 * rng.standard_normal(len(x))
                   for g in (1.0, 0.6, 1.4, 0.9)]).astype(np.float32)
    y, fs_dec, _, pos, cands = port_harvest._candidate_stage(
        torch.as_tensor(xb), fs, FLOOR, CEIL, 40.0, 3,
        StageClock(None, "cpu"))
    args = (fs_dec, FLOOR, CEIL, hw_max_of(fs_dec))
    r, s = refine.harvest_refine(y, pos, cands, *args)
    for i in range(4):
        ri, si = refine.harvest_refine(y[i:i + 1], pos, cands[i:i + 1],
                                       *args)
        assert torch.equal(ri[0], r[i]) and torch.equal(si[0], s[i]), i


def test_refine_on_cpu_launches_nothing():
    y, fs_dec, pos, cands = stage("22k")
    before = refine.harvest_refine.launches
    r, s = refine.harvest_refine(y, pos, cands[..., :40], fs_dec, FLOOR,
                                 CEIL, hw_max_of(fs_dec))
    assert refine.harvest_refine.launches == before
    assert r.shape == s.shape == cands[..., :40].shape
    assert r.dtype == torch.float32


@pytest.mark.parametrize("bad", ["float64", "hw_max_0", "hw_max_big",
                                 "hw_max_float", "rows", "frames"])
def test_refine_rejects(bad):
    y, fs_dec, pos, cands = stage("22k")
    hw_max = hw_max_of(fs_dec)
    if bad == "float64":
        y, pos, cands = y.double(), pos.double(), cands.double()
    elif bad.startswith("hw_max"):
        hw_max = {"hw_max_0": 0, "hw_max_big": refine.MAX_HW + 1,
                  "hw_max_float": float(hw_max)}[bad]
    elif bad == "rows":
        cands = torch.cat([cands, cands])
    else:
        pos = pos[:-1]
    with pytest.raises((TypeError, ValueError)):
        refine.harvest_refine(y, pos, cands, fs_dec, FLOOR, CEIL, hw_max)


def test_phase_table_is_exact_at_every_scale():
    """The table is cos / sin(2 pi k / 2^L) in float64 rounded once, so a
    smaller fft's entries are the larger table's every 2^d-th: a pair
    whose fft is below the table's reads its phase exactly, and one past
    it (hw > hw_max) needs only a larger table."""
    big = refine.phase_table(12, "cpu").double().numpy()
    k = np.arange(1 << 12)
    want = np.stack([np.cos(k / 4096.0 * (2.0 * config.K_PI)),
                     np.sin(k / 4096.0 * (2.0 * config.K_PI))])
    np.testing.assert_array_equal(big, want.astype(np.float32))
    for log2 in (4, 10, 11):
        small = refine.phase_table(log2, "cpu").numpy()
        np.testing.assert_array_equal(small, big[:, ::1 << (12 - log2)])


@pytest.mark.parametrize("hw_max", [1, 2, 193, 210])
def test_window_table_rows_are_the_window_angles(hw_max):
    """Row hw of the window table (from window_row(hw)) holds cos / sin(2
    pi j / (2 hw + 1)), j = 0..hw, in float64 rounded once, as the plain
    version computes a window past the table; the kernel's buffer is the
    phase table and then the window table."""
    w = refine.window_table(hw_max, "cpu")
    assert w.shape == (refine.window_row(hw_max + 1), 2)
    assert refine.window_row(hw_max + 1) == hw_max * (hw_max + 3) // 2
    for hw in sorted({1, min(2, hw_max), hw_max // 2 + 1, hw_max}):
        j = torch.arange(hw + 1)
        c, s = refine._window_trig(j, torch.tensor(2 * hw + 1))
        row = w[refine.window_row(hw):refine.window_row(hw) + hw + 1]
        assert torch.equal(row[:, 0], c) and torch.equal(row[:, 1], s)
    k = refine.kernel_table(hw_max, "cpu")
    log2 = refine.table_log2(hw_max)
    assert torch.equal(k[:2 << log2].view(2, -1),
                       refine.phase_table(log2, "cpu"))


def test_fft_log2_matches_jax_formula():
    """2 + floor(log2(win_len)) from the exponent equals JAX's float32
    exp2(2 + floor(log(win_len) / log 2)) for every odd window."""
    w = np.arange(3, 8193, 2)
    jax_fft = np.exp2(np.float32(2.0) + np.floor(
        np.log(w.astype(np.float32)) / np.float32(config.K_LOG2)))
    got = 1 << refine.fft_log2(torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(got, jax_fft.astype(np.int64))


# ----------------------------------------------- the kernels' orders

@pytest.mark.parametrize("n", [1, 7, 61, 194, 211])
def test_warp_sum_order_within_float64(n):
    """warp_sum is the float64 sum within its rounding bound: each of
    LANES lanes adds ceil(n / LANES) terms in turn and log2(LANES)
    butterfly levels follow, so the error is at most (ceil(n / LANES) +
    log2(LANES)) float32 half-ulps (2^-24) of the sum of magnitudes."""
    lanes = refine.LANES
    rng = np.random.default_rng(n)
    t = rng.standard_normal((200, n)).astype(np.float32)
    got = refine.warp_sum(torch.as_tensor(t)).double().numpy()
    exact = t.astype(np.float64).sum(-1)
    steps = -(-n // lanes) + int(np.log2(lanes))
    bound = steps * 2.0 ** -24 * np.abs(t).astype(np.float64).sum(-1)
    assert (np.abs(got - exact) <= bound).all()


@pytest.mark.parametrize("n", [1, 5, 61])
def test_warp_sum_is_the_lane_loops(n):
    """warp_sum is, bit for bit, lane l of LANES adding j = l, l + LANES,
    ... to 0.0 in turn, then the butterfly l + (l ^ LANES / 2), ..."""
    lanes = refine.LANES
    rng = np.random.default_rng(5)
    t = rng.standard_normal((50, n)).astype(np.float32)
    acc = np.zeros((50, lanes), np.float32)
    for j in range(t.shape[1]):
        acc[:, j % lanes] = acc[:, j % lanes] + t[:, j]
    off = lanes // 2
    while off:
        acc = acc + acc[:, np.arange(lanes) ^ off]
        off //= 2
    np.testing.assert_array_equal(
        refine.warp_sum(torch.as_tensor(t)).numpy(), acc[:, 0])


REMOVE_SHAPES = [(1, 1, 105), (1, 2, 105), (1, 3, 105), (2, 3, 7),
                 (3, 40, 31), (2, 40, 33), (1, 60, 105), (2, 20, 200)]


_jax_remove = jax.jit(jax_harvest._remove_unreliable)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B,F,M", REMOVE_SHAPES)
def test_remove_plain_matches_jax(dtype, B, F, M, nan):
    """remove_unreliable (the plain version on the CPU) equals JAX's
    _remove_unreliable row by row, bit for bit: zeros, values exactly 5%
    apart (kept: 0.05 in the tensors' type is not above itself) and one
    float32 step past it, F = 1, 2, 3; with ``nan``, NaN candidates too
    (a NaN in a slot's minimum keeps it in both; NaN where JAX has NaN,
    torch.equal elsewhere)."""
    c, s = remove_inputs(B, F, M, dtype, seed=B * 100 + F + M, nan=nan)
    got = refine.remove_unreliable(c, s)
    for b in range(B):
        want = _jax_remove(jnp.asarray(c[b].numpy()),
                           jnp.asarray(s[b].numpy()))
        for g, w in zip(got, want):
            w = torch.as_tensor(np.array(w))
            assert torch.equal(g[b].isnan(), w.isnan())
            assert torch.equal(g[b].nan_to_num(), w.nan_to_num())
    if F >= 3 and M >= 2:
        # 100 against 105: |a - b| / a == 0.05 exactly, so 100 stays
        # (where no NaN took its place).
        kept = got[0][:, 1::3, 0]
        assert ((kept == 100.0) | kept.isnan()).all()
    if F <= 2:
        assert torch.equal(got[0].nan_to_num(), c.nan_to_num())


@pytest.mark.parametrize("name", ["22k", "48k"])
def test_remove_plain_matches_jax_on_golden_refine(name):
    """On the golden utterances' refinement outputs (float32, and their
    float64 copies), the port's pass equals JAX's, and zeroes some."""
    y, fs_dec, pos, cands = stage(name)
    r, s = refine.harvest_refine(y, pos, cands, fs_dec, FLOOR, CEIL,
                                 hw_max_of(fs_dec))
    for dt in (torch.float32, torch.float64):
        rr, ss = r.to(dt), s.to(dt)
        got = refine.remove_unreliable(rr, ss)
        want = _jax_remove(jnp.asarray(rr[0].numpy()),
                                    jnp.asarray(ss[0].numpy()))
        assert torch.equal(got[0][0], torch.as_tensor(np.array(want[0])))
        assert torch.equal(got[1][0], torch.as_tensor(np.array(want[1])))
        assert ((rr != 0) & (got[0] == 0)).sum() > 0


def test_remove_on_cpu_launches_nothing_and_rejects():
    c, s = remove_inputs(1, 5, 9, "float32", seed=1)
    before = refine.remove_unreliable.launches
    refine.remove_unreliable(c, s)
    assert refine.remove_unreliable.launches == before
    with pytest.raises(TypeError):
        refine.remove_unreliable(c.double(), s)
    with pytest.raises(TypeError):
        refine.remove_unreliable(c.half(), s.half())
    with pytest.raises(ValueError):
        refine.remove_unreliable(c[0], s[0])
    with pytest.raises(ValueError):
        refine.remove_unreliable(c, s[:, :-1])


# ------------------------------------------- the remove kernel's threshold

def _ulp(x, k):
    """x moved by k units in the last place (x >= 0 finite)."""
    it = torch.int32 if x.dtype == torch.float32 else torch.int64
    return (x.view(it) + k).view(x.dtype)


def _threshold_cases(case, dtype):
    """(a, d) float tensors of ``dtype``, one pair an element."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(16)
    if case == "seeded":
        # a over every positive finite value (uniform in the bits, so
        # subnormals, the smallest and the largest finite value too); d
        # at t(a), one unit in the last place to either side, and seeded.
        if dtype == "float32":
            bits = rng.integers(1, 0x7F800000, 200_000, dtype=np.int64)
            a = torch.as_tensor(bits.astype(np.int32)).view(tdt)
        else:
            bits = rng.integers(1, 0x7FF0000000000000, 200_000,
                                dtype=np.int64)
            a = torch.as_tensor(bits).view(tdt)
        fin = torch.finfo(tdt)
        a = torch.cat([a, torch.tensor([fin.tiny, fin.smallest_normal / 2,
                                        fin.max, 1.0, 100.0, 105.0],
                                       dtype=tdt),
                       _ulp(torch.zeros(1, dtype=tdt), 1)])
        t = refine.remove_threshold_plain(a)
        scaled = a * torch.as_tensor(rng.uniform(0.0, 0.1, a.numel()),
                                     dtype=tdt)
        d = torch.cat([t, _ulp(t, 1), _ulp(t.clamp(min=fin.tiny), -1),
                       scaled])
        return a.repeat(4), d
    if case == "ratios":
        # 100 / 105 and 20 / 21 (exactly 5% of a apart), and one step of
        # the type past 105: as remove_inputs plants them, both ways.
        past = np.nextafter(np.array(105.0, dtype), np.array(200.0, dtype))
        pairs = [(100.0, 105.0), (105.0, 100.0), (20.0, 21.0),
                 (21.0, 20.0), (100.0, float(past)), (float(past), 100.0)]
        a = torch.tensor([p[0] for p in pairs], dtype=tdt)
        b = torch.tensor([p[1] for p in pairs], dtype=tdt)
        return a, (a - b).abs()
    if case == "neighbours":
        # b at a -+ t(a) and one unit in the last place to either side of
        # those, d = fl(|a - b|) as the pass takes it.
        a = torch.as_tensor(rng.uniform(1e-3, 2e3, 20_000), dtype=tdt)
        t = refine.remove_threshold_plain(a)
        bs = []
        for b in (a - t, a + t):
            bs += [b, _ulp(b, 1), _ulp(b, -1)]
        return a.repeat(len(bs)), torch.cat([(a - b).abs() for b in bs])
    # "specials": a negative, +-inf and NaN, against d of every kind.
    a = torch.tensor([-1.0, -1e-30, -float("inf"), float("inf"),
                      float("nan"), -100.0], dtype=tdt)
    d = torch.tensor([0.0, 1.0, 5.0, 1e30, float("inf"), float("nan")],
                     dtype=tdt)
    return a.repeat_interleave(d.numel()), d.repeat(a.numel())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["seeded", "ratios", "neighbours",
                                  "specials"])
def test_remove_threshold_matches_division(case, dtype):
    """!(d > t(a)) equals !(d / a > 0.05), the quotient and 0.05 in the
    type, on every pair of the case; and the CPU wrapper runs the plain
    version."""
    a, d = _threshold_cases(case, dtype)
    limit = torch.tensor(0.05, dtype=a.dtype)
    t = refine.remove_threshold(a)
    assert torch.equal(t, refine.remove_threshold_plain(a))
    assert torch.equal(~(d > t), ~(d / a > limit))
    if case == "seeded":
        # t(a) is the largest d that passes: the next one up fails.
        fin = (a > 0) & torch.isfinite(a)
        assert not (_ulp(t[fin], 1) / a[fin] > limit).logical_not().any()


def test_remove_threshold_on_cpu_launches_nothing_and_rejects():
    before = refine.remove_threshold.launches
    refine.remove_threshold(torch.ones(4))
    assert refine.remove_threshold.launches == before
    with pytest.raises(TypeError):
        refine.remove_threshold(torch.ones(4, dtype=torch.float16))
    with pytest.raises(ValueError):
        refine.remove_threshold(torch.ones(2, 2))


def remove_by_thresholds(cands, scores):
    """The reliability pass as the kernel tests it: a candidate a is kept
    where some slot b of frame f - 1 or f + 1 (zeros too) has !(|a - b| >
    t(a)); over (B, F, M, M) tensors."""
    t = refine.remove_threshold_plain(cands.flatten()).view_as(cands)
    nxt = torch.cat([cands[:, 1:], cands[:, -1:]], 1)
    prv = torch.cat([cands[:, :1], cands[:, :-1]], 1)

    def close(b):
        d = (cands[..., :, None] - b[..., None, :]).abs()
        return (~(d > t[..., None])).any(-1)

    j = torch.arange(cands.shape[1])
    interior = ((j > 0) & (j < cands.shape[1] - 1))[None, :, None]
    kill = ~(close(prv) | close(nxt)) & interior & (cands != 0.0)
    return (torch.where(kill, torch.zeros_like(cands), cands),
            torch.where(kill, torch.zeros_like(scores), scores))


def _equal_nan(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B,F,M", REMOVE_SHAPES)
def test_remove_by_thresholds_matches_plain(dtype, B, F, M, nan):
    """The pass by thresholds equals remove_unreliable_plain (torch.equal,
    NaN where it has NaN) on the seeded inputs."""
    c, s = remove_inputs(B, F, M, dtype, seed=B * 100 + F + M + 16, nan=nan)
    _equal_nan(remove_by_thresholds(c, s),
               refine.remove_unreliable_plain(c, s))


@pytest.mark.parametrize("name", ["22k", "48k"])
def test_remove_by_thresholds_on_golden_refine(name):
    """... and on the golden utterances' refinement outputs, float32 and
    float64."""
    y, fs_dec, pos, cands = stage(name)
    r, s = refine.harvest_refine(y, pos, cands, fs_dec, FLOOR, CEIL,
                                 hw_max_of(fs_dec))
    for dt in (torch.float32, torch.float64):
        rr, ss = r.to(dt), s.to(dt)
        want = refine.remove_unreliable_plain(rr, ss)
        _equal_nan(remove_by_thresholds(rr, ss), want)
        assert ((rr != 0) & (want[0] == 0)).sum() > 0
