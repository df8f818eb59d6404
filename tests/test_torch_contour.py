"""The F0 contour walks of ops/contour.py on the CPU, where each wrapper
runs its plain version: Dio's FixStep3 + FixStep4 (dio_fix_walks) against
the JAX package's scans, Harvest's FixStep3 (harvest_fix_step3) against
the host-numpy oracle and the JAX package, and fix_and_smooth's ``cap``
against JAX's.  The kernels (csrc/dio_fix.cu, csrc/harvest_contour.cu)
are held to the plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.

Tolerances: float64 Dio walks equal JAX's exactly; float64 Harvest
contours equal the oracle at the JAX property tests' 1e-9; float32 is
held to JAX's float32 path at tests/test_torch_harvest.py's gate (VUV
agreement > 99%, < 0.1 cent RMS)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import harvest_contour_oracle as H  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from world_tpu.models import dio as jax_dio  # noqa: E402
from world_tpu.models import harvest_contour as jax_hc  # noqa: E402
from world_tpu_torch.models import harvest_contour as hc  # noqa: E402
from world_tpu_torch.ops import contour  # noqa: E402


def f32_gate(got, want):
    """tests/test_torch_harvest.py's float32 gate on two contours."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert ((got > 0) == (want > 0)).mean() > 0.99
    v = (got > 0) & (want > 0)
    assert v.sum() > 20
    c = 1200.0 * np.abs(np.log2(got[v] / want[v]))
    assert np.sqrt((c ** 2).mean()) < 0.1, c.max()


# ---------------------------------------------------------------- Dio


def dio_inputs(seed, F=160, C=7):
    """tests/test_torch_dio.py's recipe: a voiced/unvoiced pattern with
    short runs and candidate grids around a drifting pitch (some zero),
    the candidates in the band stage's (C, F) layout."""
    rs = np.random.RandomState(seed)
    pitch = 150.0 * np.exp(np.cumsum(rs.randn(F) * 0.02))
    step2 = np.where(rs.rand(F) < 0.35, 0.0, pitch * (1 + 0.01 * rs.randn(F)))
    step2[rs.rand(F) < 0.1] = 0.0
    cands = pitch[:, None] * (1.0 + 0.08 * rs.randn(F, C))
    cands[rs.rand(F, C) < 0.3] = 0.0
    return step2, cands.T.copy()


def dio_edge_rows(F=160, C=7):
    """No voiced frame; a section touching frame 0 and one touching
    F-1; every frame voiced; sections of 6 frames."""
    step2, cands = dio_inputs(99, F, C)
    rows = [np.zeros(F)]
    edge = np.zeros(F)
    edge[:20] = step2[:20] + 150.0
    edge[F - 15:] = 160.0
    rows.append(edge)
    rows.append(np.abs(step2) + 100.0)
    six = np.zeros(F)
    for s in range(5, F - 6, 12):
        six[s:s + 6] = 140.0 + s * 0.1
    rows.append(six)
    return [(r, cands) for r in rows]


def jax_dio_walks(step2, cands_cf, dtype):
    c = jnp.asarray(cands_cf.T.astype(dtype))
    s2 = jnp.asarray(step2.astype(dtype))
    step3 = jax_dio._fix_step3(s2, c, 0.1)
    return np.asarray(jax_dio._fix_step4(step3, s2, c, 0.1))


def batch(rows, dtype, *cols):
    return [torch.as_tensor(np.stack([r[i] for r in rows]).astype(dtype))
            for i in cols]


@pytest.mark.parametrize("seed", range(3))
def test_dio_walks_match_jax_exactly(seed):
    """The plain version through the wrapper == the JAX scans, float64,
    three random rows and the edge rows in one batch."""
    rows = [dio_inputs(seed * 10 + r) for r in range(3)] + dio_edge_rows()
    s2, cands = batch(rows, np.float64, 0, 1)
    before = contour.dio_fix_walks.launches
    got = contour.dio_fix_walks(s2, cands, 0.1)
    assert contour.dio_fix_walks.launches == before
    assert torch.equal(got, contour.dio_fix_walks_plain(s2, cands, 0.1))
    for k, (step2, c) in enumerate(rows):
        np.testing.assert_array_equal(
            got[k].numpy(), jax_dio_walks(step2, c, np.float64),
            err_msg=f"row {k}")
    assert (got[:3].numpy() != s2[:3].numpy()).any()


def test_dio_walks_f32_match_jax_f32():
    rows = [dio_inputs(40 + r, F=400) for r in range(4)]
    s2, cands = batch(rows, np.float32, 0, 1)
    got = contour.dio_fix_walks(s2, cands, 0.1)
    assert got.dtype == torch.float32
    for k, (step2, c) in enumerate(rows):
        f32_gate(got[k].numpy(), jax_dio_walks(step2, c, np.float32))


# ------------------------------------------------------------ Harvest


def harvest_grid(rng, F, S, run_max, gap_max, jitter, spread):
    """tests/test_torch_harvest.py's random candidate grid: voiced runs
    around a drifting pitch with a random number of filled slots."""
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


def step2_of(cands, scores):
    """FixStep1 + FixStep2 of a grid, the port's (equal to the oracle's)."""
    c, s = torch.as_tensor(cands[None]), torch.as_tensor(scores[None])
    best = torch.argmax(s, -1, keepdim=True)
    base = torch.where(s.amax(-1) > 0.0, torch.gather(c, -1, best)[..., 0],
                       torch.zeros(()))
    return hc._fix_step2(hc._fix_step1(base, 0.008))[0].numpy()


def tracked_grid(rng, F, S):
    """Voiced runs whose best-scored slot follows a slowly drifting pitch
    (so FixStep1 and FixStep2 leave sections), the other slots scattered
    around it with lower scores, some of them empty."""
    c, s = harvest_grid(rng, F, S, 60, 15, 0.01, 0.1)
    voiced = c[:, 0] > 0
    pitch = 140.0 * np.exp(np.cumsum(rng.randn(F) * 0.001))
    c[voiced, 0] = pitch[voiced]
    s[voiced, 0] = 10.0 + rng.rand(int(voiced.sum()))
    return c, s


def harvest_rows(seed, n=3, F=400, S=21):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        c, s = tracked_grid(rng, F, S)
        rows.append((step2_of(c, s), c, s))
    return rows


def harvest_edge_rows(F=300, S=15):
    """No voiced frame; one section touching frame 0 and one touching
    F-1; every frame voiced; sections of 6 frames (as FixStep2 leaves
    them, which the walks then extend into each other)."""
    rng = np.random.RandomState(11)
    c, s = harvest_grid(rng, F, S, 80, 10, 0.01, 0.05)
    pitch = 130.0 + np.cumsum(rng.randn(F) * 0.3)
    c[:, 0], s[:, 0] = pitch, 5.0
    rows = [(np.zeros(F), c, s)]
    edge = np.zeros(F)
    edge[:40] = pitch[:40]
    edge[F - 30:] = pitch[F - 30:]
    rows.append((edge, c, s))
    rows.append((pitch.copy(), c, s))
    six = np.zeros(F)
    for st in range(3, F - 8, 14):
        six[st:st + 7] = pitch[st:st + 7]      # ed - st = 6
    rows.append((six, c, s))
    return rows


def test_harvest_step3_matches_oracle():
    """The plain version through the wrapper == the oracle's FixStep3 at
    1e-9, float64, on random rows and the edge rows in one batch."""
    rows = harvest_rows(3) + harvest_edge_rows(F=400, S=21)
    s2, c, s = batch(rows, np.float64, 0, 1, 2)
    before = contour.harvest_fix_step3.launches
    got = contour.harvest_fix_step3(s2, c, s)
    assert contour.harvest_fix_step3.launches == before
    assert torch.equal(got, contour.harvest_fix_step3_plain(s2, c, s))
    for k, (step2, cands, scores) in enumerate(rows):
        np.testing.assert_allclose(
            got[k].numpy(), H._fix_step3_np(step2, cands, scores),
            atol=1e-9, rtol=1e-9, err_msg=f"row {k}")
    assert (got.numpy() != s2.numpy()).any()


@pytest.mark.parametrize("trial", range(3))
def test_harvest_step3_matches_oracle_harsh(trial):
    rng = np.random.RandomState(31 + trial)
    F = int(rng.choice([150, 401, 797]))
    S = int(rng.choice([7, 21, 49]))
    c, s = tracked_grid(rng, F, S)
    step2 = step2_of(c, s)
    assert (step2 > 0).any()
    got = contour.harvest_fix_step3(*(torch.as_tensor(a[None])
                                      for a in (step2, c, s)))
    np.testing.assert_allclose(got[0].numpy(),
                               H._fix_step3_np(step2, c, s), atol=1e-9,
                               rtol=1e-9)


def test_harvest_step3_f32_matches_jax_f32():
    rows = harvest_rows(5, n=4)
    s2, c, s = batch(rows, np.float32, 0, 1, 2)
    got = contour.harvest_fix_step3(s2, c, s)
    assert got.dtype == torch.float32
    for k, (step2, cands, scores) in enumerate(rows):
        want = jax_hc._fix_step3(
            *(jnp.asarray(a.astype(np.float32))
              for a in (step2, cands, scores)), len(step2) // 8 + 2)
        f32_gate(got[k].numpy(), np.asarray(want))


def many_sections(F=400, S=9, n_sec=12):
    """A float64 grid whose FixStep2 leaves ``n_sec`` well separated
    voiced sections, each long enough for ExtendSub to keep it."""
    rng = np.random.RandomState(3)
    c = np.zeros((F, S))
    s = np.zeros((F, S))
    width = F // n_sec
    for k in range(n_sec):
        lo = k * width + 3
        pitch = 110.0 + 15.0 * k + np.cumsum(rng.randn(width - 8) * 0.2)
        c[lo:lo + width - 8, 0] = pitch
        c[lo:lo + width - 8, 1:] = pitch[:, None] * (
            1.3 + 0.2 * rng.rand(width - 8, S - 1))
        s[lo:lo + width - 8] = np.abs(rng.randn(width - 8, S)) + 0.1
        s[lo:lo + width - 8, 0] += 5.0
    return c, s


@pytest.mark.parametrize("cap", [3, 7])
def test_fix_and_smooth_cap_matches_jax(cap):
    """fix_and_smooth(cap=k) == JAX's on a grid with more than k sections
    (float64, 1e-9), and differs from the uncapped contour."""
    c, s = many_sections()
    n_sec = int(hc._section_bounds(torch.as_tensor(step2_of(c, s)[None]))
                [2][0])
    assert n_sec > cap
    got = hc.fix_and_smooth(torch.as_tensor(c[None]), torch.as_tensor(s[None]),
                            cap=cap)[0].numpy()
    want = np.asarray(jax_hc.fix_and_smooth(jnp.asarray(c), jnp.asarray(s),
                                            cap=cap))
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-9)
    full = hc.fix_and_smooth(torch.as_tensor(c[None]),
                             torch.as_tensor(s[None]))[0].numpy()
    assert (got != full).any()
    np.testing.assert_allclose(
        full, np.asarray(jax_hc.fix_and_smooth(jnp.asarray(c),
                                               jnp.asarray(s))),
        atol=1e-9, rtol=1e-9)


def test_harvest_step3_cap_keeps_first_sections():
    """cap through the wrapper: the first ``cap`` sections, as JAX's
    _fix_step3 with that capacity (float64, 1e-9); the rows past the cap
    keep only step2's values."""
    c, s = many_sections()
    step2 = step2_of(c, s)
    got = contour.harvest_fix_step3(
        *(torch.as_tensor(a[None]) for a in (step2, c, s)), cap=4)[0]
    want = jax_hc._fix_step3(jnp.asarray(step2), jnp.asarray(c),
                             jnp.asarray(s), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9,
                               rtol=1e-9)


def test_section_capacity():
    assert contour.section_capacity(794) == 397
    assert contour.section_capacity(794, cap=5) == 5
    assert contour.section_capacity(1) == 1
    assert contour.section_capacity(9, cap=100) == 5
    n_int, n_float = contour.harvest_scratch(794, 397)
    assert (n_int, n_float) == (3 + 7 * 397, 405 * 397 + 4 * 794)


@pytest.mark.parametrize("n_frames,cap", [(1, None), (794, None),
                                           (794, 5), (7146, None)])
def test_harvest_scratch_matches_kernel_layout(n_frames, cap):
    """The wrapper's scratch is the row the kernel addresses: a header of
    kHeader ints and kLists lists of kmax; 2 x 2 walks of kSteps values
    and scores per section, kmax span sums and four frame rows (the
    constants read from csrc/harvest_contour.cu)."""
    import re
    from pathlib import Path

    src = (Path(contour.__file__).parent.parent / "csrc"
           / "harvest_contour.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    kmax = contour.section_capacity(n_frames, cap)
    steps = const("kSteps")
    assert steps == contour.WALK_STEPS
    assert contour.harvest_scratch(n_frames, kmax) == (
        const("kHeader") + const("kLists") * kmax,
        (2 * 2 * steps + 1) * kmax + 4 * n_frames)


@pytest.mark.parametrize("call,exc", [
    (lambda: contour.dio_fix_walks(torch.zeros(2, 5, dtype=torch.int32),
                                   torch.zeros(2, 3, 5), 0.1), TypeError),
    (lambda: contour.dio_fix_walks(torch.zeros(2, 5), torch.zeros(2, 5, 3),
                                   0.1), ValueError),
    (lambda: contour.dio_fix_walks(torch.zeros(2, 5),
                                   torch.zeros(2, 3, 5, dtype=torch.float64),
                                   0.1), TypeError),
    (lambda: contour.harvest_fix_step3(torch.zeros(2, 5), torch.zeros(2, 5, 3),
                                       torch.zeros(2, 5, 4)), ValueError),
    (lambda: contour.harvest_fix_step3(torch.zeros(2, 5), torch.zeros(2, 5, 3),
                                       torch.zeros(2, 5, 3), cap=0),
     ValueError)])
def test_wrappers_reject(call, exc):
    with pytest.raises(exc):
        call()
