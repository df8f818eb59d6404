"""Tests of the port that need a CUDA card: the OLA kernel in both
modes, at every tile, the scan kernel, the contour-walk kernels, the
IIR kernels (iir_zero_phase, lti_state_scan; each at its chunk
edges) and the RNG span kernel (randn_span, at
lane counts about a warp and the card's warps) against their plain versions
(torch.equal), Harvest's float32 refinement kernel (harvest_refine)
against its plain version at refine_bench.GATES, the reliability pass
after it (harvest_remove_unreliable, float32 and float64, torch.equal),
IEEE
division by fs on the card, float64 Dio, StoneMask and the codec on the
card against the goldens, the batched steps (Harvest and Dio) through
the kernel, float64 streaming against the reference's streaming output
and span against rows, and chunked Dio analyze_long against
whole-signal analysis and its results landed in page-locked outputs
(equal to the plain stitch, no new host block a call), the host syncs
of a warmed Harvest and Dio step against what
set_sync_debug_mode("warn") reports, site by site, and a traced step's
launches inside its ``span:step``.  Each skips without a
card.

This file imports neither jax nor the JAX package and reads the goldens
itself, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import world_tpu_torch as W  # noqa: E402
from world_tpu_torch.device import div  # noqa: E402
from world_tpu_torch.models import dio as port_dio  # noqa: E402
from world_tpu_torch.models import harvest_contour as port_hc  # noqa: E402
from world_tpu_torch.ops import (  # noqa: E402
    _cuda, contour, iir, matlab, ola, refine, rng, scan)
from world_tpu_torch.ops.ola import ola_accumulate, ola_plain  # noqa: E402
from world_tpu_torch.parallel import pipeline  # noqa: E402
from world_tpu_torch.tools import refine_bench  # noqa: E402
from world_tpu_torch.tools.ola_bench import TABLE  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def golden(name):
    shapes = {}
    with open(os.path.join(GOLDENS, "manifest.txt")) as f:
        for line in f:
            parts = line.split()
            if parts[0] != "scalar":
                shapes[parts[0]] = tuple(int(p) for p in parts[1:])
    return np.fromfile(os.path.join(GOLDENS, name + ".f64")).reshape(
        shapes[name])


def cents(a, b):
    return 1200.0 * np.abs(np.log2(a / b))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ola_kernel_matches_plain(cuda, dtype):
    """The kernel == its plain version (atol 0) at the main path's
    nominal shapes and with unsorted offsets; the counter counts."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for B, P, fft, yp in ((16, 1249, 1024, 19468), (16, 1114, 2048, 37697),
                          (3, 77, 512, 5000)):
        r = torch.randn((B, P, fft), generator=gen, dtype=dt, device=cuda)
        o = torch.randint(0, yp - fft + 1, (B, P), generator=gen,
                          dtype=torch.int32, device=cuda)
        before = ola_accumulate.launches
        got = ola_accumulate(r, o, y_padded=yp)
        assert ola_accumulate.launches == before + 1
        assert got.dtype == dt
        assert torch.equal(got, ola_plain(r, o, yp))


def _ragged(gen, counts, fft, yp, dt, cuda):
    """Random ragged inputs with the given pulse count per row and
    ascending offsets within each row."""
    counts = torch.as_tensor(counts)
    row_ptr = torch.zeros(len(counts) + 1, dtype=torch.int32)
    row_ptr[1:] = torch.cumsum(counts, 0)
    n = int(row_ptr[-1])
    r = torch.randn((n, fft), generator=gen, dtype=dt, device=cuda)
    o = torch.randint(0, yp - fft + 1, (n,), generator=gen,
                      dtype=torch.int32, device=cuda)
    rows = torch.repeat_interleave(torch.arange(len(counts)), counts)
    key = rows.to(cuda) * yp + o.long()
    return r, o[torch.argsort(key)].contiguous(), row_ptr.to(cuda)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ola_ragged_kernel_matches_plain(cuda, dtype):
    """The ragged mode == its plain version at the table's shapes, rows
    holding 0 to P pulses; the counter counts."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    for B, P, fft, yp, _ in TABLE:
        counts = torch.linspace(0, P, B).round().long()
        r, o, rp = _ragged(gen, counts, fft, yp, dt, cuda)
        before = ola.ola_accumulate_ragged.launches
        got = ola.ola_accumulate_ragged(r, o, rp, y_padded=yp)
        assert ola.ola_accumulate_ragged.launches == before + 1
        assert torch.equal(got, ola.ola_ragged_plain(r, o, rp, yp))


def _edge_offsets(fft, yp, tile):
    """Offsets that straddle tile edges, leave whole tiles empty, sit at
    0 and at yp - fft, and repeat the same sample."""
    edges = [k * tile + d for k in (1, 2) for d in (-fft, -fft + 1, -1, 0,
                                                    1, -fft // 2)]
    return sorted([0, 0, yp - fft, yp - fft] + [e for e in edges
                                                 if 0 <= e <= yp - fft])


@pytest.mark.parametrize("tile", ola.TILES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ola_every_tile_at_edges(cuda, dtype, tile):
    """Both modes at every tile the kernel has: pulses straddling tile
    edges, tiles with an empty pulse range (the middle of a long row),
    rows with no pulse, unsorted offsets in the general mode."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(tile)
    for fft in (512, 1024, 2048):
        yp = 12 * 2048 + 333
        edge = torch.tensor(_edge_offsets(fft, yp, tile), dtype=torch.int32)
        rows = [edge, edge[:1], edge[:0], torch.tensor(
            [yp // 2 - 7] * 3, dtype=torch.int32)]
        counts = [len(x) for x in rows]
        row_ptr = torch.tensor([0] + list(np.cumsum(counts)),
                               dtype=torch.int32, device=cuda)
        o = torch.cat(rows).to(cuda)
        r = torch.randn((len(o), fft), generator=gen, dtype=dt, device=cuda)
        B, N = len(rows), len(o)
        out = torch.empty((B, yp), dtype=dt, device=cuda)
        ola.launch(r, o, row_ptr, out, B, N, fft, yp, tile=tile)
        assert torch.equal(out, ola.ola_ragged_plain(r, o, row_ptr, yp))
        # General mode: the same pulses padded, shuffled within each row.
        P = max(counts)
        pr = torch.zeros((B, P, fft), dtype=dt, device=cuda)
        po = torch.zeros((B, P), dtype=torch.int32, device=cuda)
        for b in range(B):
            a, z = int(row_ptr[b]), int(row_ptr[b + 1])
            perm = torch.randperm(z - a, generator=gen, device=cuda)
            pr[b, :z - a] = r[a:z][perm]
            po[b, :z - a] = o[a:z][perm]
        out = torch.empty((B, yp), dtype=dt, device=cuda)
        ola.launch(pr, po, None, out, B, P, fft, yp, tile=tile)
        assert torch.equal(out, ola_plain(pr, po, yp))


def test_ola_unknown_tile_raises(cuda):
    r = torch.zeros((4, 512), device=cuda)
    o = torch.zeros(4, dtype=torch.int32, device=cuda)
    rp = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    out = torch.empty((1, 1000), device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        ola.launch(r, o, rp, out, 1, 4, 512, 1000, tile=333)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scan_kernel_matches_plain(cuda, dtype):
    """The scan kernel == its plain version (torch.equal) on rows of 1,
    1023, 1024, 1025 and 17420 samples, the unvoiced 500 Hz increments
    at 22.05 kHz among them, and on 16 rows of 33601; the counter
    counts."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    inc = 2.0 * np.pi * 500.0 / 22050.0
    for B, L in ((3, 1), (3, 1023), (3, 1024), (3, 1025), (3, 17420),
                 (16, 33601)):
        x = torch.rand((B, L), generator=gen, dtype=dt, device=cuda) * 0.3
        x[0] = inc
        before = scan.cumsum_rows.launches
        got = scan.cumsum_rows(x)
        assert scan.cumsum_rows.launches == before + 1
        assert torch.equal(got.cpu(), scan.cumsum_rows_plain(x.cpu())), \
            (B, L)


def dio_walk_rows(rs, F=160, C=7, nan=0.0, ends=False):
    """(step2 (F,), cands (C, F)): random rows with short runs around a
    drifting pitch (some candidates zero, a share ``nan`` of them NaN),
    then the edge rows: no voiced frame, sections touching frames 0 and
    F-1, every frame voiced, sections of 6 frames; with ``ends`` also two
    rows whose active runs reach the last frame (FixStep3) and frame 1
    (FixStep4): one unvoiced boundary each, every candidate near the
    pitch."""
    rows = []
    for _ in range(4):
        pitch = 150.0 * np.exp(np.cumsum(rs.randn(F) * 0.02))
        step2 = np.where(rs.rand(F) < 0.35, 0.0,
                         pitch * (1 + 0.01 * rs.randn(F)))
        cands = pitch[:, None] * (1.0 + 0.08 * rs.randn(F, C))
        cands[rs.rand(F, C) < 0.3] = 0.0
        if nan:
            cands[rs.rand(F, C) < nan] = np.nan
        rows.append((step2, cands.T.copy()))
    if ends:
        pitch = 150.0 * np.exp(np.cumsum(rs.randn(F) * 0.002))
        near = (pitch[:, None] * (1.0 + 0.005 * rs.randn(F, C))).T.copy()
        cut = min(30, F // 3)
        rows += [(np.where(np.arange(F) < cut, pitch, 0.0), near),
                 (np.where(np.arange(F) >= F - cut, pitch, 0.0), near)]
    cands = rows[0][1]
    edge = np.zeros(F)
    edge[:20], edge[F - 15:] = 150.0, 160.0
    six = np.zeros(F)
    for st in range(5, F - 6, 12):
        six[st:st + 6] = 140.0
    rows += [(np.zeros(F), cands), (edge, cands),
             (np.abs(rows[0][0]) + 100.0, cands), (six, cands)]
    return rows


def harvest_walk_rows(rs, F=400, S=21, nan=0.0):
    """(step2, cands, scores): random grids whose best-scored slot follows
    a drifting pitch through voiced runs, step2 from the port's FixStep1
    and FixStep2; then the edge rows (as dio_walk_rows, sections of 7
    frames, which FixStep2 keeps).  A share ``nan`` of the candidates and
    of the scores is then NaN (step2 is taken before)."""
    rows = []
    for _ in range(4):
        c = np.zeros((F, S))
        s = np.zeros((F, S))
        pitch = 140.0 * np.exp(np.cumsum(rs.randn(F) * 0.001))
        t = 0
        while t < F:
            run, gap = rs.randint(1, 60), rs.randint(1, 15)
            for i in range(t, min(F, t + run)):
                k = rs.randint(1, S) if S > 1 else 1
                c[i, :k] = pitch[i] * (1.0 + 0.1 * rs.randn(k))
                s[i, :k] = np.abs(rs.randn(k)) * 3.0
                c[i, 0], s[i, 0] = pitch[i], 10.0 + rs.rand()
            t += run + gap
        best = np.argmax(s, 1)
        base = np.where(s.max(1) > 0, c[np.arange(F), best], 0.0)
        step2 = port_hc._fix_step2(port_hc._fix_step1(
            torch.as_tensor(base[None]), 0.008))[0].numpy()
        rows.append((step2, c, s))
    pitch, c, s = rows[0][1][:, 0], rows[0][1], rows[0][2]
    edge = np.zeros(F)
    edge[:40], edge[F - 30:] = pitch[:40], pitch[F - 30:]
    seven = np.zeros(F)
    for st in range(3, F - 8, 14):
        seven[st:st + 7] = pitch[st:st + 7]
    rows += [(np.zeros(F), c, s), (edge, c, s),
             (np.where(pitch > 0, pitch, 150.0), c, s), (seven, c, s)]
    if nan:
        rows = [(step2, np.where(rs.rand(F, S) < nan, np.nan, c),
                 np.where(rs.rand(F, S) < nan, np.nan, s))
                for step2, c, s in rows]
    return rows


def on_card(rows, dt, cuda):
    return [torch.as_tensor(np.stack([r[i] for r in rows]), dtype=dt,
                            device=cuda) for i in range(len(rows[0]))]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dio_fix_kernel_matches_plain(cuda, dtype):
    """Dio's walks kernel == its plain version (torch.equal) on random
    and edge rows; the counter counts."""
    s2, c = on_card(dio_walk_rows(np.random.RandomState(1)),
                    getattr(torch, dtype), cuda)
    before = contour.dio_fix_walks.launches
    got = contour.dio_fix_walks(s2, c, 0.1)
    assert contour.dio_fix_walks.launches == before + 1
    want = contour.dio_fix_walks_plain(s2, c, 0.1)
    assert torch.equal(got, want), (got != want).any(1)
    assert (got != s2).any()


@pytest.mark.parametrize("cap", [None, 2, 5])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_harvest_contour_kernel_matches_plain(cuda, dtype, cap):
    """Harvest's FixStep3 kernel == its plain version (torch.equal) on
    random and edge rows, all sections and the first ``cap``; the
    counter counts."""
    s2, c, s = on_card(harvest_walk_rows(np.random.RandomState(2)),
                       getattr(torch, dtype), cuda)
    before = contour.harvest_fix_step3.launches
    got = contour.harvest_fix_step3(s2, c, s, cap=cap)
    assert contour.harvest_fix_step3.launches == before + 1
    want = contour.harvest_fix_step3_plain(s2, c, s, cap=cap)
    assert torch.equal(got, want), (got != want).any(1)
    assert (got != s2).any()


def check_walk(name, args, *rest, **kwargs):
    """The contour wrapper ``name`` launches its kernel once on ``args``
    and equals its plain version: NaN at the same frames (a NaN candidate
    that SelectBestF0 picks passes on), torch.equal at the others."""
    kernel = getattr(contour, name)
    before = kernel.launches
    got = kernel(*args, *rest, **kwargs)
    assert kernel.launches == before + 1
    want = getattr(contour, name + "_plain")(*args, *rest, **kwargs)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan]), \
        (got != want).any(1).nonzero().flatten()
    return got


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dio_fix_kernel_runs_to_the_ends_and_nan(cuda, dtype):
    """Dio's walks kernel == its plain version on rows whose active runs
    reach the last frame and frame 1, and on rows with NaN candidates."""
    dt = getattr(torch, dtype)
    rows = dio_walk_rows(np.random.RandomState(3), ends=True)
    got = check_walk("dio_fix_walks", on_card(rows, dt, cuda), 0.1)
    assert bool((got[4, 30:] != 0).all())         # rows 4, 5: ``ends``
    assert bool((got[5, 1:] != 0).all()) and float(got[5, 0]) == 0.0
    check_walk("dio_fix_walks", on_card(dio_walk_rows(
        np.random.RandomState(4), nan=0.05), dt, cuda), 0.1)


@pytest.mark.parametrize("F", [9000, 16000])
def test_dio_fix_kernel_rows_past_shared_memory(cuda, F):
    """Float64 rows whose band rows (C = 7) do not fit in a block's shared
    memory (F = 9000: step2 and the output row do; F = 16000: only the
    boundary masks do): the kernel == its plain version."""
    rs = np.random.RandomState(F)
    rows = dio_walk_rows(rs, F=F, ends=True)
    check_walk("dio_fix_walks", on_card(rows, torch.float64, cuda), 0.1)


@pytest.mark.parametrize("S", [1, 31, 33, 105, 126, 160])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_harvest_contour_kernel_slot_counts(cuda, dtype, S):
    """Harvest's FixStep3 kernel == its plain version at slot counts on
    both sides of each unrolled count (1-4 slots a lane) and past them
    (the general loop)."""
    rows = harvest_walk_rows(np.random.RandomState(S), F=300, S=S)
    got = check_walk("harvest_fix_step3",
                     on_card(rows, getattr(torch, dtype), cuda))
    assert (got != on_card(rows, getattr(torch, dtype), cuda)[0]).any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_harvest_contour_kernel_nan(cuda, dtype):
    """NaN candidates and NaN scores in the walks' frames (and in the
    frame-score pass): the kernel == its plain version."""
    rows = harvest_walk_rows(np.random.RandomState(5), nan=0.03)
    check_walk("harvest_fix_step3",
               on_card(rows, getattr(torch, dtype), cuda))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_harvest_contour_kernel_ties(cuda, dtype):
    """Walk frames whose candidates lie at equal distances from the pitch
    (P - 20 and P + 20: equal errors, the later slot wins), one step of
    the type's resolution beyond (a near tie, whose quotient the kernel
    takes slot by slot), at P itself and at 0, shuffled over the slots:
    the kernel == its plain version."""
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(9)
    F, S, P = 300, 8, 140.0
    up = np.nextafter(np.array(P + 20.0, dtype=dtype), np.inf)
    base = np.array([P - 20.0, P + 20.0, float(up), P, 0.0, 0.0, 2 * P,
                     P + 20.0])
    rows = []
    for _ in range(4):
        c = np.stack([rs.permutation(np.where(
            (base == P) & (rs.rand() < 0.5), 0.0, base)) for _ in range(F)])
        s = rs.rand(F, S) * 5.0
        step2 = np.zeros(F)
        for st in range(rs.randint(5, 20), F - 30, rs.randint(40, 70)):
            step2[st:st + rs.randint(7, 25)] = P
        rows.append((step2, c, s))
    got = check_walk("harvest_fix_step3", on_card(rows, dt, cuda))
    assert (got != on_card(rows, dt, cuda)[0]).any()


def test_harvest_contour_kernel_more_walks_than_warps(cuda):
    """A row of 7,146 frames with a 7-frame section every 14 (where the
    grid is voiced: K = 486, so 972 walks, more than the 128 warps of a
    row's cluster), beside a random row: the kernel == its plain
    version."""
    rows = harvest_walk_rows(np.random.RandomState(6), F=7146)
    seven = rows[-1][0]
    assert int(((seven[1:] != 0) & (seven[:-1] == 0)).sum()) > 450
    check_walk("harvest_fix_step3",
               on_card([rows[0], rows[-1]], torch.float32, cuda))


@pytest.mark.parametrize("B", [1, 40])
def test_harvest_contour_kernel_batch_sizes(cuda, B):
    """One row, and 40 rows (320 blocks: more clusters than the card holds
    at once): the kernel == its plain version."""
    rs = np.random.RandomState(B)
    rows = []
    while len(rows) < B:
        rows += harvest_walk_rows(rs, F=300)
    check_walk("harvest_fix_step3", on_card(rows[:B], torch.float32, cuda))


def recorded_walks(fs, gold, method, dtype, cuda):
    """The arguments the contour kernel's wrapper gets in a 16-row batch
    step of the golden utterance of tests/<gold>/ (rows at gains
    0.5-1.5) on the card."""
    x = np.fromfile(os.path.join(os.path.dirname(GOLDENS), gold, "x.f64"))
    xb = (x[None] * np.linspace(0.5, 1.5, 16)[:, None]).astype(dtype)
    module, name = ((port_dio, "dio_fix_walks") if method == "dio"
                    else (port_hc, "harvest_fix_step3"))
    real, seen = getattr(module, name), []

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)
    setattr(module, name, record)
    try:
        pipeline.make_batch_step(fs, xb.shape[1], f0_method=method,
                                 with_synthesis=False, device=cuda)(xb)
    finally:
        setattr(module, name, real)
    return seen[0]


@pytest.mark.parametrize("method", ["dio", "harvest"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fs,gold", [(22050, "goldens"),
                                     (48000, "goldens_fs48")])
def test_contour_kernels_match_plain_at_golden_sizes(cuda, method, dtype,
                                                     fs, gold):
    """Each contour kernel == its plain version (torch.equal) on the
    arguments a 16-row batch step gives it at 22.05 and 48 kHz."""
    args, kwargs = recorded_walks(fs, gold, method, dtype, cuda)
    name = "dio_fix_walks" if method == "dio" else "harvest_fix_step3"
    got = getattr(contour, name)(*args, **kwargs)
    want = getattr(contour, name + "_plain")(*args, **kwargs)
    assert torch.equal(got, want), (got != want).any(1)


def test_contour_plain_versions_never_run_on_card(cuda, monkeypatch):
    """A CUDA tensor goes to the kernels: with every plain version made to
    raise, the Dio and Harvest steps still run on the card."""
    def boom(*args, **kwargs):
        raise AssertionError("plain version reached on the card")
    for module, name in ((contour, "dio_fix_walks_plain"),
                         (contour, "harvest_fix_step3_plain"),
                         (port_dio, "_fix_step3"), (port_dio, "_fix_step4"),
                         (port_hc, "_fix_step3"), (port_hc, "_extend")):
        monkeypatch.setattr(module, name, boom)
    x = golden("x").astype(np.float32)
    for method in ("dio", "harvest"):
        step = pipeline.make_batch_step(22050, len(x), f0_method=method,
                                        with_synthesis=False, device=cuda)
        f0 = step(np.stack([x, 0.7 * x]))[0]
        assert torch.isfinite(f0).all() and (f0 > 0).any()


def same_with_nan(got, want):
    """NaN at the same places, torch.equal at the others."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def check_iir(name, *args):
    """The wrapper ``name`` (ops/iir.py) launches its kernel once and
    equals its plain version on the CPU copy of its card arguments (the
    plain version's IEEE ops give the same bits on either device)."""
    kernel = getattr(iir, name)
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1
    want = getattr(iir, name + "_plain")(
        *[a.cpu() if torch.is_tensor(a) else a for a in args])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert same_with_nan(got.cpu(), want), (
        name, (got.cpu() != want).reshape(-1, want.shape[-1]).any(1))


@pytest.mark.parametrize("recurrence", ["decimate", "smooth"])
def test_iir_zero_phase_kernel_matches_plain(cuda, recurrence):
    """iir_zero_phase == its plain version at 1, 19, 127, 128, 129 and
    2,000 samples in 1, 3 and 16 lanes (decimate at every ratio in
    turn), and on rows holding a NaN, an inf and a -inf."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    for i, n in enumerate((1, 19, 127, 128, 129, 2000)):
        for lanes in (1, 3, 16):
            x = torch.randn((lanes, n), generator=gen, dtype=torch.float64,
                            device=cuda) * 100.0
            if lanes == 16:
                x[3, n // 2] = float("nan")
                x[5, n // 3] = float("inf")
                x[7, n - 1] = -float("inf")
            r = 2 + (i + lanes) % 11 if recurrence == "decimate" else None
            check_iir("iir_zero_phase", x, recurrence, r)


@pytest.mark.parametrize("r", range(2, 13))
def test_iir_decimate_kernel_at_golden_sizes(cuda, r):
    """iir_zero_phase(decimate) == its plain version on the padded golden
    utterance at 22.05 kHz (17,518 samples, one row, as analyze() has
    it) and, at Harvest's and Dio's 48 kHz ratios (6 and 12), on 16
    rows of the 48 kHz one (33,618 samples, as the batch step has
    it)."""
    def padded(gold, rows):
        x = np.fromfile(os.path.join(os.path.dirname(GOLDENS), gold,
                                     "x.f64"))
        t = np.concatenate([2 * x[0] - x[9:0:-1], x,
                            2 * x[-1] - x[-2:-11:-1]])
        gains = np.linspace(0.5, 1.5, rows) if rows > 1 else np.ones(1)
        return torch.as_tensor(t[None] * gains[:, None], device=cuda)
    check_iir("iir_zero_phase", padded("goldens", 1), "decimate", r)
    if r in (6, 12):
        check_iir("iir_zero_phase", padded("goldens_fs48", 16), "decimate",
                  r)


def test_iir_smooth_kernel_at_golden_size(cuda):
    """iir_zero_phase(smooth) == its plain version on the lanes the
    float64 smoothing gives it for the golden Harvest track at Harvest's
    1 ms contour rate (794 frames, each golden frame held 5 times) at the
    JAX package's capacity (101 sections x 1,394 frames), and for 16
    such rows."""
    seen = []
    real = port_hc.iir_zero_phase

    def record(x, recurrence, r=None):
        seen.append(x)
        return real(x, recurrence, r)
    port_hc.iir_zero_phase = record
    try:
        f0 = torch.as_tensor(np.repeat(golden("harvest_f0"), 5)[:794],
                             device=cuda)
        port_hc._smooth_contour(f0[None], len(f0) // 8 + 2)
        port_hc._smooth_contour(
            f0[None] * torch.linspace(0.5, 1.5, 16, dtype=torch.float64,
                                      device=cuda)[:, None],
            len(f0) // 8 + 2)
    finally:
        port_hc.iir_zero_phase = real
    assert [tuple(x.shape) for x in seen] == [(1, 101, 1394),
                                              (16, 101, 1394)]
    for x in seen:
        check_iir("iir_zero_phase", x, "smooth")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lti_state_scan_kernel_matches_plain(cuda, dtype):
    """lti_state_scan == its plain version for decimate's 3-state and
    the smoothing's 4-state tables at the blocks a pass has at 22.05 kHz
    (137), 48 kHz (263) and in a long-form chunk (2,344), in 1 and 16
    lanes (1,616 for the smoothing's sections), with 1 and 129 blocks
    too; and across the kernel's edges: 16 lanes (one a block) at 255-257
    and 511-513 blocks (a ring chunk holds 256 float64 or 512 float32
    blocks of one lane), 1,616 lanes (several a block, fewer blocks a
    chunk) at every count from 1 to 40 blocks, SMs + 1 and 2 x SMs + 1
    lanes (a last block of one lane) and 200 lanes of 300 blocks (more
    lanes than SMs, long rows)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    edges = ([(16, n) for n in (255, 256, 257, 511, 512, 513)]
             + [(1616, n) for n in range(1, 41)]
             + [(sms + 1, 40), (2 * sms + 1, 40), (200, 300)])
    for S, AL in ((3, matlab._decimate_block_tables(2, 128)[3]),
                  (4, port_hc._biquad_tables()[3])):
        al = torch.as_tensor(AL, dtype=dt, device=cuda)
        for lanes, nblk in [(1, 1), (16, 129), (1, 137), (16, 137),
                            (16, 263), (16, 2344), (1616, 14)] + edges:
            p = torch.randn((lanes, nblk, S), generator=gen, dtype=dt,
                            device=cuda)
            check_iir("lti_state_scan", p, al)


def test_randn_span_kernel_matches_plain(cuda):
    """randn_span == its plain version on 1 and 1,616 lanes from 0, 63,
    64, 2^20 + 5, and up to 2^33 - 70 (every jump bit up to 33), and
    randn_blocks_at on ~1,500-draw blocks of 794 frames, as CheapTrick
    draws at 22.05 kHz."""
    for base in (0, 63, 64, 2 ** 20 + 5, 2 ** 33 - 70 - 1615 * 64):
        for lanes in (1, 1616):
            starts = base + torch.arange(lanes, device=cuda) * rng._LANE
            top = base + (lanes - 1) * rng._LANE
            before = rng.randn_span.launches
            got = rng.randn_span(starts, top)
            assert rng.randn_span.launches == before + 1
            want = rng.randn_span_plain(starts.cpu(), top)
            assert torch.equal(got.cpu(), want), (base, lanes)
    f0 = golden("harvest_f0")
    offsets = np.cumsum(np.full(len(f0), 1500)) - 1500
    got = rng.randn_blocks_at(torch.as_tensor(offsets, device=cuda), 1537)
    want = rng.randn_blocks_at(torch.as_tensor(offsets), 1537)
    assert torch.equal(got.cpu(), want)


# csrc/iir.cu's zero-phase kernel: 512-sample chunks, the chain reading
# its inputs 32 at a time in two register groups (64 a round).
ZP_CHUNKS = (512, 64, 32)


def _zp_rows(gen, lanes, n, cuda):
    x = torch.randn((lanes, n), generator=gen, dtype=torch.float64,
                    device=cuda) * 100.0
    if n >= 3:
        x[lanes // 2, n // 2] = float("nan")
        x[lanes - 1, n - 1] = float("inf")
        x[0, 1] = -float("inf")
    return x


@pytest.mark.parametrize("lanes", [1, 16, 131, 132, 133, 1616])
@pytest.mark.parametrize("recurrence", ["decimate", "smooth"])
def test_iir_zero_phase_kernel_at_chunk_edges(cuda, recurrence, lanes):
    """iir_zero_phase == its plain version (torch.equal, NaN at the same
    places) at 1, 2 and 3 samples and at the chunk's and the chain's
    register groups' sizes - 1, the sizes, + 1 and 2 x + 1, on lane
    counts around the card's 132 SMs (blocks queueing past one an SM)
    and 1,616 (16 rows of 101 smoothing sections), with a NaN, an inf
    and a -inf."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(lanes)
    lengths = {1, 2, 3}
    for c in ZP_CHUNKS:
        lengths |= {c - 1, c, c + 1, 2 * c + 1}
    for i, n in enumerate(sorted(lengths)):
        r = 2 + (i + lanes) % 11 if recurrence == "decimate" else None
        check_iir("iir_zero_phase", _zp_rows(gen, lanes, n, cuda),
                  recurrence, r)


@pytest.mark.parametrize("recurrence,lanes", [("decimate", 1),
                                              ("smooth", 133)])
def test_iir_zero_phase_kernel_rows_past_shared_memory(cuda, recurrence,
                                                       lanes):
    """Rows of 40,000 samples (longer than 48 kHz decimation's 33,906 and
    far past a block's shared memory), on one lane and on more lanes
    than the card has SMs, == the plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    check_iir("iir_zero_phase", _zp_rows(gen, lanes, 40000, cuda),
              recurrence, 12 if recurrence == "decimate" else None)


@pytest.mark.parametrize("lanes", [1, 31, 32, 33, 2559, 9116])
def test_randn_span_kernel_lane_counts(cuda, lanes):
    """randn_span == its plain version at lane counts about a warp and at
    CheapTrick's and D4C's spans (2,559 and 9,116 lanes), on starts in
    no order with gaps, the largest using all 34 bits."""
    rs = np.random.RandomState(lanes)
    starts = rs.randint(0, 2 ** 34 - 64, size=lanes).astype(np.int64)
    starts[-1] = 2 ** 34 - 1
    top = int(starts.max())
    got = rng.randn_span(torch.as_tensor(starts, device=cuda), top)
    want = rng.randn_span_plain(torch.as_tensor(starts), top)
    assert torch.equal(got.cpu(), want)


def test_iir_kernel_launch_failure_raises(cuda):
    """A launch the kernel refuses (an unknown recurrence kind) raises."""
    import ctypes
    entry = _cuda.entry("iir", "iir_zero_phase_launch",
                       (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_longlong)
                       + (ctypes.c_double,) * 5 + (ctypes.c_void_p,))
    x = torch.zeros((1, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError):
        _cuda.launch("iir_zero_phase", entry, x.device, 7, x.data_ptr(),
                    x.data_ptr(), 1, 8, *[0.0] * 5)


def test_iir_and_rng_plain_versions_never_run_on_card(cuda, monkeypatch):
    """A CUDA tensor goes to the kernels: with the plain recurrences, the
    plain state loop and the plain RNG made to raise, the default float64
    exact analyze() + synthesize() and the float32 Harvest and Dio steps
    still run on the card."""
    def boom(*args, **kwargs):
        raise AssertionError("plain version reached on the card")
    for module, name in ((iir, "iir_zero_phase_plain"),
                         (iir, "lti_state_scan_plain"),
                         (rng, "randn_span_plain"), (rng, "randn_block"),
                         (rng, "states_at_draws")):
        monkeypatch.setattr(module, name, boom)
    x = golden("x")
    p = W.analyze(x, 22050, device=cuda)
    y = W.synthesize(p, device=cuda)
    assert torch.isfinite(y).all() and (p.f0 > 0).any()
    for method in ("dio", "harvest"):
        step = pipeline.make_batch_step(22050, len(x), f0_method=method,
                                        with_synthesis=False, device=cuda)
        f0 = step(np.stack([x, 0.7 * x]).astype(np.float32))[0]
        assert torch.isfinite(f0).all() and (f0 > 0).any()


def test_div_on_card_matches_cpu(cuda):
    """On the card, division by a Python scalar is a reciprocal multiply;
    device.div must still give the CPU's IEEE quotients."""
    a = torch.arange(40000, dtype=torch.float32)
    np.testing.assert_array_equal(div(a.to(cuda), 1000.0).cpu().numpy(),
                                  (a / 1000.0).numpy())


def test_batch_step_on_card(cuda):
    """The float32 fast step on the card at batch 2 meets the golden F0
    and envelope gates and goes through the ragged OLA kernel once."""
    x = golden("x").astype(np.float32)
    ref = golden("harvest_f0")
    step = pipeline.make_batch_step(22050, len(x), rng_mode="fast",
                                    f0_method="harvest", device=cuda)
    before = ola.ola_accumulate_ragged.launches
    f0, sp, _, _ = step(np.stack([x, 0.7 * x]))
    assert ola.ola_accumulate_ragged.launches == before + 1
    f0 = f0[0].double().cpu().numpy()
    assert ((f0 > 0) == (ref > 0)).mean() > 0.99
    v = (f0 > 0) & (ref > 0)
    assert np.sqrt(np.mean((1200 * np.log2(f0[v] / ref[v])) ** 2)) < 0.1
    err_db = np.abs(10 * np.log10(sp[0].double().cpu().numpy()
                                  / golden("cheaptrick_sp")))
    assert np.median(err_db) < 0.01


def test_dio_stonemask_f64_on_card_golden(cuda):
    """tests/test_f0.py's gates on the card: the IEEE-division and
    host-position traps hold there too."""
    x = golden("x")
    tp, f0 = W.dio(x, 22050, device=cuda)
    np.testing.assert_allclose(tp.cpu().numpy(), golden("dio_tp"),
                               atol=1e-12)
    f0, ref = f0.cpu().numpy(), golden("dio_f0")
    assert ((f0 > 0) == (ref > 0)).mean() == 1.0
    v = (f0 > 0) & (ref > 0)
    assert cents(f0[v], ref[v]).max() < 0.1
    sm = W.stone_mask(x, 22050, golden("dio_tp"), golden("dio_f0"),
                      device=cuda).cpu().numpy()
    ref = golden("stonemask_f0")
    assert ((sm > 0) == (ref > 0)).mean() == 1.0
    v = (sm > 0) & (ref > 0)
    assert cents(sm[v], ref[v]).max() < 0.1


def test_codec_f64_on_card_golden(cuda):
    """tests/test_codec.py's golden gates on the card."""
    fs, fft = 22050, 1024
    out = W.code_aperiodicity(golden("d4c_ap"), fs, fft, device=cuda)
    np.testing.assert_allclose(out.cpu().numpy(), golden("coded_ap"),
                               atol=1e-9)
    out = W.decode_aperiodicity(golden("coded_ap"), fs, fft, device=cuda)
    np.testing.assert_allclose(out.cpu().numpy(), golden("decoded_ap"),
                               atol=1e-10)
    coded = golden("coded_sp")
    out = W.code_spectral_envelope(golden("cheaptrick_sp"), fs,
                                   coded.shape[1], fft, device=cuda)
    np.testing.assert_allclose(out.cpu().numpy(), coded, atol=1e-9)
    out = W.decode_spectral_envelope(coded, fs, fft, device=cuda)
    np.testing.assert_allclose(out.cpu().numpy(), golden("decoded_sp"),
                               rtol=1e-9)


def test_dio_step_on_card(cuda):
    """The default (Dio) float32 fast step with codec_dims on the card at
    batch 2: the golden StoneMask gate (< 1 cent RMS), coded shapes, and
    one launch of the ragged OLA kernel."""
    x = golden("x").astype(np.float32)
    ref = golden("stonemask_f0")
    step = pipeline.make_batch_step(22050, len(x), rng_mode="fast",
                                    codec_dims=64, device=cuda)
    before = ola.ola_accumulate_ragged.launches
    f0, sp, ap, y = step(np.stack([x, 0.7 * x]))
    assert ola.ola_accumulate_ragged.launches == before + 1
    assert sp.shape == (2, len(ref), 64)
    n_aper = W.get_number_of_aperiodicities(22050)
    assert ap.shape == (2, len(ref), n_aper)
    assert torch.isfinite(y).all()
    f0 = f0[0].double().cpu().numpy()
    assert ((f0 > 0) == (ref > 0)).mean() > 0.99
    v = (f0 > 0) & (ref > 0)
    assert np.sqrt(np.mean(cents(f0[v], ref[v]) ** 2)) < 1.0


def _stream(feed, n_pointers, **kw):
    """The golden parameters streamed on the card (buffer 64)."""
    s = W.StreamingSynthesizer(22050, 5.0, 1024, 64, n_pointers,
                               device="cuda", **kw)
    out = []
    for f0, sp, ap in feed:
        assert s.add_parameters(f0, sp, ap)
        while s.synthesis2():
            out.append(s.buffer[:64].copy())
    s.close()
    return np.concatenate(out)


def _snr_nonzero(ref, y):
    """SNR over the samples where ``ref`` is nonzero, both cut to the
    shorter length."""
    n = min(len(ref), len(y))
    ref, y = ref[:n], y[:n]
    v = ref != 0
    err = np.sum((ref[v] - y[v]) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref[v] ** 2) / err)


def _golden_feed(step):
    f0, sp, ap = golden("harvest_f0"), golden("cheaptrick_sp"), \
        golden("d4c_ap")
    return [(f0[i: i + step], sp[i: i + step], ap[i: i + step])
            for i in range(0, len(f0), step)]


def test_streaming_f64_on_card(cuda):
    """float64 exact streaming on the card: all at once against
    synthesis2_y and frame by frame against synthesis3_y, > 80 dB, the
    span render going through the general-mode kernel."""
    before = ola_accumulate.launches
    y = _stream(_golden_feed(10 ** 6), 1)
    assert ola_accumulate.launches > before
    assert _snr_nonzero(golden("synthesis2_y"), y) > 80.0
    y = _stream(_golden_feed(1), 100)
    assert _snr_nonzero(golden("synthesis3_y"), y) > 80.0


def test_streaming_span_matches_rows_on_card(cuda):
    """The span render (kernel) against rows added on the host, float64,
    > 200 dB."""
    feed = _golden_feed(10 ** 6)
    rows = _stream(feed, 1, span_render=False)
    assert _snr_nonzero(rows, _stream(feed, 1)) > 200.0


def _eager(monkeypatch):
    """Turn the streaming synthesizer's graphs off: every render eager."""
    from world_tpu_torch.models import realtime
    monkeypatch.setattr(realtime, "_graph", lambda key: None)


def _lookahead_pulses(dtype, rng_mode, **kw):
    """A synthesizer on the card, warmed up to 32 pulses, holding the
    golden frames, and the render parameters of its lookahead's pulses."""
    from world_tpu_torch.models.realtime import StreamingSynthesizer
    dt = np.dtype(dtype)
    s = StreamingSynthesizer(22050, 5.0, 1024, 64, 100, rng_mode=rng_mode,
                             dtype=dt, device="cuda", **kw).warmup(32)
    assert s.add_parameters(*(golden(k).astype(dt) for k in (
        "harvest_f0", "cheaptrick_sp", "d4c_ap")))
    s._resp_cache.clear()
    params, _ = s._collect_lookahead()
    assert len(params) > 40
    return s, params


def _graphed_and_eager(s, pulses, monkeypatch):
    """Render ``pulses`` replayed from a graph, then eagerly: both
    landed."""
    from world_tpu_torch.models import realtime
    before = dict(realtime.counts)
    graphed = s._render_dispatch(pulses)
    graphed.wait()
    with monkeypatch.context() as m:
        _eager(m)
        eager = s._render_dispatch(pulses)
        eager.wait()
    assert realtime.counts["graphed"] == before["graphed"] + 1
    assert realtime.counts["captures"] == before["captures"]
    assert (graphed.kind, graphed.base) == (eager.kind, eager.base)
    return graphed, eager


@pytest.mark.parametrize("rng_mode", ["fast", "none"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streaming_graph_rows_match_eager(cuda, dtype, rng_mode,
                                          monkeypatch):
    """A render of 1 to 7 pulses (response rows) replayed from its graph
    equals the eager render bit for bit."""
    s, params = _lookahead_pulses(dtype, rng_mode)
    for lanes in range(1, 8):
        graphed, eager = _graphed_and_eager(s, params[lanes:2 * lanes],
                                            monkeypatch)
        assert graphed.kind == "rows" and graphed.host.shape[0] == lanes
        assert torch.equal(graphed.host, eager.host), lanes
    s.close()


@pytest.mark.parametrize("rng_mode", ["fast", "none"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streaming_spans_eager_wide_rows_graphed(cuda, dtype, rng_mode,
                                                 monkeypatch):
    """Spans (8 pulses and more, span_render on) render eagerly: no graph,
    one OLA launch each, counted.  With span_render off, renders of 8 and
    32 pulses come back as rows replayed from the graphs warm-up
    captured, bit for bit the eager ones."""
    from world_tpu_torch.models import realtime
    from world_tpu_torch.ops.ola import ola_accumulate
    s, params = _lookahead_pulses(dtype, rng_mode)
    for pulses in (params[:8], params[8:40]):
        before = (realtime.counts["graphed"], ola_accumulate.launches)
        render = s._render_dispatch(pulses)
        render.wait()
        assert render.kind == "span"
        assert (realtime.counts["graphed"], ola_accumulate.launches) \
            == (before[0], before[1] + 1)
    s.close()
    s, params = _lookahead_pulses(dtype, rng_mode, span_render=False)
    for pulses in (params[:8], params[8:40]):
        graphed, eager = _graphed_and_eager(s, pulses, monkeypatch)
        assert graphed.kind == "rows"
        assert torch.equal(graphed.host, eager.host), len(pulses)
    s.close()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_synthesize_long_graphed_matches_eager(cuda, dtype, monkeypatch):
    """synthesize_long on the golden frames, at its defaults and with one
    frame a push and small buffers (some of whose renders are rows that
    replay the graphs a warm-up captured), equals the same calls with
    graphs off, sample for sample."""
    from world_tpu_torch.models import realtime
    from world_tpu_torch.models.realtime import StreamingSynthesizer
    from world_tpu_torch.parallel import synthesize_long

    dt = np.dtype(dtype)
    f0, sp, ap = (golden(k).astype(dt) for k in (
        "harvest_f0", "cheaptrick_sp", "d4c_ap"))
    StreamingSynthesizer(22050, 5.0, 1024, 64, 16, rng_mode="fast",
                         dtype=dt, device="cuda").warmup(7)
    small = dict(frames_per_push=1, buffer_size=64)
    graphed = []
    for kw in ({}, small):
        before = realtime.counts["graphed"]
        graphed.append(synthesize_long(f0, sp, ap, 22050, device="cuda",
                                       **kw))
        if kw:
            assert realtime.counts["graphed"] > before
    _eager(monkeypatch)
    for kw, y in zip(({}, small), graphed):
        assert np.array_equal(
            synthesize_long(f0, sp, ap, 22050, device="cuda", **kw), y)


def test_exact_and_cpu_streams_never_graphed(cuda):
    """rng_mode "exact" on the card and a CPU synthesizer, warmed up and
    streamed, neither capture nor replay a graph."""
    from world_tpu_torch.models import realtime
    before = dict(realtime.counts)
    for device, feed in (("cuda", _golden_feed(1)), ("cpu", _golden_feed(7))):
        s = W.StreamingSynthesizer(22050, 5.0, 1024, 64, 100,
                                   device=device).warmup(8)
        for f0, sp, ap in feed:
            assert s.add_parameters(f0, sp, ap)
            while s.synthesis2():
                pass
        s.close()
        assert s.renders > 0
    for k in ("graphed", "captures"):
        assert realtime.counts[k] == before[k], k


def test_stream_buffers_graphed_match_eager(cuda, monkeypatch):
    """One synthesizer at the streaming cell's settings, warmed up as the
    streaming benchmark warms it and fed the golden frames one a push,
    delivers the same buffers with every render replayed from a graph as
    with graphs off.  Two settings are pinned so that batching cannot
    follow the clock: a render counts as landed once waited for, and a
    missed window renders at once (hold_force_ms 0)."""
    from world_tpu_torch.models import realtime
    from world_tpu_torch.models.realtime import StreamingSynthesizer

    monkeypatch.setattr(realtime._Render, "done",
                        lambda self: self.wait() or True)
    f0, sp, ap = (golden(k).astype(np.float32)
                  for k in ("harvest_f0", "cheaptrick_sp", "d4c_ap"))

    def play():
        s = StreamingSynthesizer(
            22050, 5.0, 1024, 64, 100, rng_mode="fast", dtype=np.float32,
            hold_on_miss=True, dispatch_min_pulses=2, hold_force_ms=0.0,
            device="cuda").warmup()
        before = dict(realtime.counts)
        out = []
        for i in range(len(f0)):
            while not s.add_parameters(f0[i:i + 1], sp[i:i + 1],
                                       ap[i:i + 1]):
                s.synthesis2()
            while s.synthesis2():
                out.append(s.buffer[:64].copy())
        s.close()
        return out, {k: realtime.counts[k] - before[k]
                     for k in ("renders", "graphed", "captures")}

    graphed, rise = play()
    assert rise["graphed"] == rise["renders"] > 10
    assert rise["captures"] == 0
    _eager(monkeypatch)
    eager, rise = play()
    assert rise["graphed"] == 0 and rise["renders"] > 10
    assert len(graphed) == len(eager) > 150
    assert all(np.array_equal(a, b) for a, b in zip(graphed, eager))


def _long_vowelish(fs, seconds, seed=1):
    """tests/test_longform.py::_long_vowelish (that module imports JAX)."""
    rng = np.random.RandomState(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    f0 = 130.0 + 25.0 * np.sin(2 * np.pi * 0.4 * t)
    phase = np.cumsum(2 * np.pi * f0 / fs)
    x = np.sin(phase) + 0.4 * np.sin(2 * phase + 0.3) \
        + 0.15 * np.sin(3 * phase + 1.1) + 0.003 * rng.randn(n)
    return 0.3 * x / np.abs(x).max()


def test_chunked_dio_on_card(cuda):
    """analyze_long (Dio, 2 s chunks, 0.2 s halo) of 6 s at 16 kHz against
    whole-signal analysis on the card, at tests/test_longform.py's gates
    on interior frames."""
    from world_tpu_torch.parallel import analyze_long

    fs = 16000
    x = _long_vowelish(fs, 6.0)
    _, f0_c, sp_c, _ = analyze_long(x, fs, chunk_seconds=2.0,
                                    halo_seconds=0.2, f0_method="dio",
                                    batch_lanes=2)
    p = W.analyze(x, fs, f0_method="dio", device=cuda)
    f0, sp = p.f0.cpu().numpy(), p.spectrogram.cpu().numpy()
    interior = np.ones(len(f0), bool)
    for b in range(0, len(f0), 400):
        interior[max(0, b - 2): b + 3] = False
    both = (f0 > 0) & (f0_c > 0) & interior
    assert both.sum() > len(f0) // 2
    assert ((f0 > 0) == (f0_c > 0))[interior].mean() > 0.99
    assert np.percentile(cents(f0_c[both], f0[both]), 95) < 1.0
    assert np.median(np.abs(10 * np.log10(sp_c[both] / sp[both]))) < 0.1


def test_analyze_long_lands_in_page_locked_outputs(cuda, monkeypatch):
    """analyze_long on the card (Dio, 1 s cores in batches of 3, 7 chunks,
    the last cut): f0, sp and ap are page-locked, every chunk is landed
    by the copy engine and none on the host, the outputs equal the plain
    concatenate-and-slice stitch of the same step outputs, and a second
    call after the first's arrays are dropped allocates no new host
    block."""
    from longform_stitch import plain_stitch, record_steps

    from world_tpu_torch.parallel import analyze_long, longform

    fs = 16000
    x = _long_vowelish(fs, 6.6).astype(np.float32)
    kw = dict(chunk_seconds=1.0, halo_seconds=0.2)
    call = dict(f0_method="dio", batch_lanes=3, device=cuda, **kw)
    seen = record_steps(monkeypatch)
    before = dict(longform.landed)
    tp, *got = analyze_long(x, fs, **call)
    assert len(tp) == 1321
    assert longform.landed["card"] - before.get("card", 0) == 7
    assert longform.landed["host"] == before.get("host", 0)
    assert all(torch.from_numpy(a).is_pinned() for a in got)
    want = plain_stitch(seen, len(tp), **kw)
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want))
    del tp, got
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:
        allocs = stats().get("num_host_alloc")
        again = analyze_long(x, fs, **call)
        assert stats().get("num_host_alloc") == allocs
        assert all(torch.from_numpy(a).is_pinned() for a in again[1:])


def test_synthesis_f64_on_card_matches_cpu(cuda):
    """float64 synthesis of the golden Dio track, which opens unvoiced
    (pulses on rounding ties of the phase sum every 441 samples), on the
    card against the CPU: the same pulses, so the same exact noise."""
    f0, sp, ap = golden("dio_f0"), golden("cheaptrick_sp"), golden("d4c_ap")
    y = [W.synthesis(f0, sp, ap, 22050, device=d).cpu().numpy()
         for d in (cuda, "cpu")]
    assert np.abs(y[0] - y[1]).max() < 1e-9


def _read_int16(path):
    import wave

    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()),
                             np.int16).astype(np.int64)


def test_cli_test_on_card(cuda, tmp_path, monkeypatch):
    """`test vaiueo2d.wav out.wav 2.0 1.5` on the card in float64: the
    three wavs within 1 LSB of the reference binary's, < 1% of samples
    differing, through both modes of the OLA kernel."""
    from world_tpu_torch.tools import cli

    monkeypatch.delenv(cli.PLATFORM_VAR, raising=False)
    monkeypatch.chdir(tmp_path)
    here = os.path.dirname(os.path.abspath(__file__))
    before = (ola_accumulate.launches, ola.ola_accumulate_ragged.launches)
    assert cli.main(["test", os.path.join(here, "vaiueo2d.wav"), "out.wav",
                     "2.0", "1.5"]) == 0
    assert ola_accumulate.launches > before[0]
    assert ola.ola_accumulate_ragged.launches > before[1]
    for v in ("01", "02", "03"):
        d = _read_int16(tmp_path / f"{v}out.wav") - _read_int16(
            os.path.join(here, "goldens_manip", f"{v}out.wav"))
        assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.01


def test_batched_corpus_on_card(cuda, tmp_path):
    """A small two-rate batched corpus run on the card (Dio, codec 32,
    npz, batches of 2): every file done, the native loader; each batch
    run again with its rows swapped, and each file alone in a batch of 1,
    give every file what the runner wrote within CARD_BATCH_ATOL."""
    from world_tpu_torch import config
    from world_tpu_torch.io.audio import wavread, wavwrite
    from world_tpu_torch.io.parameterio import read_npz
    from world_tpu_torch.utils.corpus import BatchedCorpusRunner

    x22, x48 = golden("x"), np.fromfile(os.path.join(
        os.path.dirname(GOLDENS), "goldens_fs48", "x.f64"))
    files = [(22050, x22[:9000]), (48000, x48), (22050, 0.5 * x22),
             (48000, 1.2 * x48[:20000]), (22050, np.roll(x22, 5000))]
    paths = []
    for i, (fs, x) in enumerate(files):
        p = tmp_path / f"k{i}.wav"
        wavwrite(x, fs, str(p))
        paths.append(str(p))
    m = BatchedCorpusRunner(str(tmp_path / "out"), fs=None,
                            bucket_seconds=[1.0], batch_size=2,
                            f0_method="dio", output_format="npz",
                            codec_dims=32, log=lambda *a: None,
                            device=cuda).run(paths)
    assert m["utterances_done"] == 5 and m["loader"] == "native"
    for fs in (22050, 48000):
        mine = [p for p, (f, _) in zip(paths, files) if f == fs]
        step = pipeline.get_batch_step(fs, fs, f0_method="dio",
                                       with_synthesis=False, codec_dims=32,
                                       device=cuda)
        for b0 in range(0, len(mine), 2):
            rows = np.zeros((2, fs), np.float32)
            lengths = []
            for j, p in enumerate(mine[b0:b0 + 2]):
                x, _, _ = wavread(p)
                rows[j, :len(x)] = x
                lengths.append(len(x))
            swapped = [t.cpu().numpy() for t in step(rows[::-1].copy())[:3]]
            for j, (p, n) in enumerate(zip(mine[b0:b0 + 2], lengths)):
                alone = [t[0].cpu().numpy() for t in step(rows[j:j + 1])[:3]]
                nf = config.get_samples_for_dio(fs, n, 5.0)
                got = read_npz(str(tmp_path / "out"
                                   / f"{os.path.basename(p)[:-4]}.npz"))
                for k, key in enumerate(("f0", "coded_sp", "coded_ap")):
                    for other in (swapped[k][1 - j], alone[k]):
                        assert np.abs(got[key] - other[:nf]).max() \
                            <= CARD_BATCH_ATOL[key], (p, key)


# A file in another row or alone against the runner's batch on the card,
# float32 (max abs difference; f0 in Hz, coded ap in dB): chip_smoke.py's
# BATCH_ATOL, where their origin is given.
CARD_BATCH_ATOL = {"f0": 1e-4, "coded_sp": 5e-4, "coded_ap": 0.04}


# ------------------------------------------------- Harvest's refinement

def refine_stage(gold, fs, rows, cuda, f0_floor=71.0):
    """The port's float32 candidate stage on the card for ``rows`` rows of
    the golden utterance (gains 0.5-1.5 past one row): (y, fs_dec,
    positions, cands)."""
    from world_tpu_torch.device import StageClock
    from world_tpu_torch.models import harvest as port_harvest

    x = np.fromfile(os.path.join(os.path.dirname(GOLDENS), gold, "x.f64"))
    gains = np.linspace(0.5, 1.5, rows) if rows > 1 else np.ones(1)
    xb = torch.as_tensor((x[None] * gains[:, None]).astype(np.float32),
                         device=cuda)
    y, fs_dec, _, pos, cands = port_harvest._candidate_stage(
        xb, fs, f0_floor, 800.0, 40.0, int(round(fs / 8000.0)),
        StageClock(None, cuda))
    return y, fs_dec, pos, cands


def hw_max_of(fs_dec, f0_floor=71.0):
    return int(1.5 * fs_dec / (f0_floor * 0.9 * 0.9) + 1.0) + 1


def check_refine(y, pos, cands, fs_dec, f0_floor=71.0, f0_ceil=800.0,
                 hw_max=None):
    """One launch of the kernel, held to the plain version on the same
    card tensors at refine_bench.GATES."""
    hw_max = hw_max or hw_max_of(fs_dec, f0_floor)
    args = (y, pos, cands, fs_dec, f0_floor, f0_ceil, hw_max)
    before = refine.harvest_refine.launches
    got = refine.harvest_refine(*args)
    assert refine.harvest_refine.launches == before + 1
    want = refine.harvest_refine_plain(*args)
    stats = refine_bench.compare(got, want, f0_floor, f0_ceil)
    assert refine_bench.within_gates(stats), stats
    assert stats["survivors"] > 0
    return got, want


@pytest.mark.parametrize("rows", [1, 16])
@pytest.mark.parametrize("fs,gold", [(22050, "goldens"),
                                     (48000, "goldens_fs48")])
def test_refine_kernel_matches_plain(cuda, fs, gold, rows):
    """At both rates, 1 and 16 rows: the (row, frame) items (794 / 701 a
    row) exceed the card's SMs, so blocks walk several each."""
    y, fs_dec, pos, cands = refine_stage(gold, fs, rows, cuda)
    assert rows * cands.shape[1] > torch.cuda.get_device_properties(
        cuda).multi_processor_count
    check_refine(y, pos, cands, fs_dec)


def refine_edges(cands, fs_dec):
    """tests/test_torch_refine.py's edge cases written into the frames of
    ``cands`` (row 0): the first and last frames, candidates at f0_floor
    0.81 and below it (hw past hw_max), above fs / 12, an empty frame and
    one with every slot filled."""
    c = cands.clone()
    n_frames, n_slots = c.shape[1:]
    voiced = torch.nonzero((c[0] > 0).sum(1) >= 10).flatten().tolist()
    src = c[0, voiced[len(voiced) // 2]].clone()
    c[0, [0, n_frames - 1]] = src
    c[0, voiced[10:42]] = 0.0
    c[0, voiced[10:14], 1:4] = float(np.float32(71.0 * 0.9 * 0.9))
    c[0, voiced[20:24], :2] = torch.tensor([650.0, 780.0], device=c.device)
    c[0, voiced[30:32], 2:4] = torch.tensor([50.0, 40.0], device=c.device)
    for f in voiced[50:52]:
        c[0, f] = c[0, f, 0] * (1.0 + 0.002 * (torch.arange(
            n_slots, device=c.device) - 52.0))
    return c


@pytest.mark.parametrize("lifted", [False, True])
def test_refine_kernel_edges(cuda, lifted):
    """The edge cases; ``lifted`` drops the range test (f0_floor 0,
    f0_ceil 1e9, hw_max still the 71 Hz one), so that the pairs at and
    past the window bound survive and their values are compared."""
    y, fs_dec, pos, cands = refine_stage("goldens", 22050, 2, cuda)
    c = refine_edges(cands, fs_dec)
    if lifted:
        got, _ = check_refine(y, pos, c, fs_dec, 0.0, 1e9,
                              hw_max_of(fs_dec))
    else:
        got, _ = check_refine(y, pos, c, fs_dec)
    voiced = torch.nonzero((cands[0] > 0).sum(1) >= 10).flatten().tolist()
    assert (got[0][0, voiced[40:42]] == 0).all()


def test_refine_kernel_low_floor(cuda):
    """f0_floor 40 at 48 kHz: hw_max 372, a 2^11 phase table and ~64 KB
    of shared memory a block (past 48 KB: opted in at launch)."""
    y, fs_dec, pos, cands = refine_stage("goldens_fs48", 48000, 4, cuda,
                                         f0_floor=40.0)
    assert hw_max_of(fs_dec, 40.0) == 372
    check_refine(y, pos, cands, fs_dec, f0_floor=40.0)


@pytest.mark.parametrize("hw_max", [600, refine.MAX_HW])
def test_refine_past_48k_shared_memory(cuda, hw_max):
    """hw_max whose block needs more than 48 KB of shared memory (opted
    in at launch; ~109 KB at 600, ~219 KB at the wrapper's limit) still
    launches and meets the gates."""
    y, fs_dec, pos, cands = refine_stage("goldens", 22050, 2, cuda)
    check_refine(y, pos, cands, fs_dec, hw_max=hw_max)


def test_refine_never_syncs(cuda):
    """The wrapper and the float32 _refine_all run under
    set_sync_debug_mode("error") (the phase table is built inside)."""
    from world_tpu_torch.models import harvest as port_harvest

    y, fs_dec, pos, cands = refine_stage("goldens", 22050, 16, cuda)
    refine._device_table.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r, s = refine.harvest_refine(y, pos, cands, fs_dec, 71.0, 800.0,
                                     hw_max_of(fs_dec))
        r2, s2 = port_harvest._refine_all(
            y, torch.full((), fs_dec, device=cuda), pos, cands, 71.0, 800.0,
            None, fs_dec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(r, r2) and torch.equal(s, s2)


def test_refine_plain_never_runs_on_card(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel: with the plain version made to
    raise, the float32 Harvest step still runs on the card and launches
    the kernel once."""
    def boom(*args, **kwargs):
        raise AssertionError("plain version reached on the card")
    monkeypatch.setattr(refine, "harvest_refine_plain", boom)
    monkeypatch.setattr(refine, "_refine_pairs", boom)
    x = golden("x").astype(np.float32)
    step = pipeline.make_batch_step(22050, len(x), f0_method="harvest",
                                    with_synthesis=False, device=cuda)
    before = refine.harvest_refine.launches
    f0 = step(np.stack([x, 0.7 * x]))[0]
    assert refine.harvest_refine.launches == before + 1
    assert torch.isfinite(f0).all() and (f0 > 0).any()


def test_refine_launch_failure_raises(cuda):
    """A launch the kernel refuses (shared memory past the card's) raises."""
    import ctypes
    entry = _cuda.entry("refine", "harvest_refine",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
                        + (ctypes.c_float,) * 3 + (ctypes.c_void_p,))
    t = torch.ones((1, 8), device=cuda)
    with pytest.raises(RuntimeError):
        _cuda.launch("harvest_refine", entry, t.device, *[t.data_ptr()] * 6,
                     1, 8, 1, 8, 100000, 19, 8000.0, 71.0, 800.0)


# ------------------------------------------- Harvest's reliability pass

def remove_inputs(B, F, M, dtype, seed, nan=False):
    """Seeded (cands, scores) (B, F, M) of ``dtype`` on the CPU: ~60%
    zeros, F0s in 70-800 Hz, and in every third frame pairs whose
    neighbour sits exactly 5% away (100 / 105, 20 / 21) or one float32
    step past it; with ``nan`` a few NaN candidates.  (Also
    tests/test_torch_refine.py's.)"""
    rng = np.random.default_rng(seed)
    c = rng.uniform(70.0, 800.0, (B, F, M))
    c[rng.random((B, F, M)) < 0.6] = 0.0
    if F >= 3 and M >= 2:
        c[:, 1::3, 0] = 100.0
        c[:, 2::3, 0] = 105.0
        c[:, 1::3, 1] = 20.0
        c[:, 0::3, M - 1] = 21.0
        c[:, 2::3, 1] = np.nextafter(np.float32(105.0), np.float32(200.0))
    if nan:
        c[rng.random((B, F, M)) < 0.01] = np.nan
    s = np.where(c > 0, rng.uniform(2.5, 50.0, (B, F, M)), 0.0)
    return (torch.as_tensor(c.astype(dtype)), torch.as_tensor(s.astype(dtype)))


def check_remove(cands, scores, cuda):
    """One launch of the remove kernel on the card against the plain
    version on the same card tensors: torch.equal (NaN where the plain
    version has NaN)."""
    c, s = cands.to(cuda), scores.to(cuda)
    before = refine.remove_unreliable.launches
    got = refine.remove_unreliable(c, s)
    assert refine.remove_unreliable.launches == before + (c.numel() > 0)
    want = refine.remove_unreliable_plain(c, s)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B,F,M", [(1, 1, 105), (1, 2, 105), (1, 3, 105),
                                   (2, 50, 1), (3, 40, 31), (2, 40, 33),
                                   (16, 794, 105), (1, 1394, 105),
                                   (2, 30, 200)])
def test_remove_kernel_matches_plain(cuda, dtype, B, F, M):
    """Edge shapes (F = 1, 2, 3; M not a multiple of 32; B = 1), the
    main_22k shape and the float64 exact path's (1, F, 105)."""
    cands, scores = remove_inputs(B, F, M, dtype, seed=B * 1000 + F + M)
    got, _ = check_remove(cands, scores, cuda)
    if F <= 2:
        assert torch.equal(got[0].cpu(), cands)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_remove_kernel_nan(cuda, dtype):
    cands, scores = remove_inputs(4, 60, 105, dtype, seed=7, nan=True)
    check_remove(cands, scores, cuda)


@pytest.mark.parametrize("fs,gold", [(22050, "goldens"),
                                     (48000, "goldens_fs48")])
def test_remove_kernel_on_refine_outputs(cuda, fs, gold):
    """On the refinement's outputs of 16 rows, as the float32 step runs
    it, and on their float64 copies."""
    y, fs_dec, pos, cands = refine_stage(gold, fs, 16, cuda)
    r, s = refine.harvest_refine(y, pos, cands, fs_dec, 71.0, 800.0,
                                 hw_max_of(fs_dec))
    got, want = check_remove(r, s, cuda)
    assert (got[0] == 0).sum() > (r == 0).sum()
    check_remove(r.double(), s.double(), cuda)


def test_refine_and_remove_never_sync(cuda):
    """Both kernels, and the float32 refine stage as harvest.refine runs
    it (_refine_all, then remove_unreliable), under
    set_sync_debug_mode("error"); float64 too for the remove kernel."""
    from world_tpu_torch.models import harvest as port_harvest

    y, fs_dec, pos, cands = refine_stage("goldens", 22050, 16, cuda)
    c64, s64 = (t.to(cuda) for t in remove_inputs(1, 300, 105, "float64",
                                                  seed=3))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r, s = refine.harvest_refine(y, pos, cands, fs_dec, 71.0, 800.0,
                                     hw_max_of(fs_dec))
        out = refine.remove_unreliable(r, s)
        out64 = refine.remove_unreliable(c64, s64)
        staged = refine.remove_unreliable(*port_harvest._refine_all(
            y, torch.full((), fs_dec, device=cuda), pos, cands, 71.0, 800.0,
            None, fs_dec))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = refine.remove_unreliable_plain(r, s)
    for got in (out, staged):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want64 = refine.remove_unreliable_plain(c64, s64)
    assert torch.equal(out64[0], want64[0])
    assert torch.equal(out64[1], want64[1])


def test_remove_plain_never_runs_on_card(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel: with the plain version made to
    raise, the float32 Harvest step runs and launches it once."""
    def boom(*args, **kwargs):
        raise AssertionError("plain version reached on the card")
    monkeypatch.setattr(refine, "remove_unreliable_plain", boom)
    x = golden("x").astype(np.float32)
    step = pipeline.make_batch_step(22050, len(x), f0_method="harvest",
                                    with_synthesis=False, device=cuda)
    before = refine.remove_unreliable.launches
    f0 = step(np.stack([x, 0.7 * x]))[0]
    assert refine.remove_unreliable.launches == before + 1
    assert torch.isfinite(f0).all() and (f0 > 0).any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_remove_kernel_slots_past_48k_shared_memory(cuda, dtype):
    """M = 1000: a tile of one frame and its two halo frames (values,
    lists and scores) passes 48 KB of shared memory in float64 (opted in
    at launch); M = 20000 in float64: three frames pass what a block may
    hold, and the launch raises."""
    cands, scores = remove_inputs(2, 12, 1000, dtype, seed=9)
    check_remove(cands, scores, cuda)
    if dtype == "float64":
        big = torch.zeros((1, 3, 20000), dtype=torch.float64, device=cuda)
        with pytest.raises(RuntimeError):
            refine.remove_unreliable(big, big)


def test_remove_launch_failure_raises(cuda):
    """A launch the kernel refuses (an element size it has no build for)
    raises."""
    import ctypes
    entry = _cuda.entry("refine", "harvest_remove_unreliable",
                        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
                        + (ctypes.c_void_p,))
    t = torch.ones((1, 3, 8), device=cuda)
    with pytest.raises(RuntimeError):
        _cuda.launch("harvest_remove_unreliable", entry, t.device,
                     *[t.data_ptr()] * 4, 1, 3, 8, 2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("M", [105, 200])
def test_remove_kernel_full_frames(cuda, dtype, M):
    """Frames with every slot nonzero (M candidates: several rounds of a
    lane a candidate at M = 200), beside frames of candidates close to
    theirs and frames of none."""
    cands, scores = remove_inputs(2, 40, M, dtype, seed=M + 16)
    rng = np.random.default_rng(M)
    full = torch.as_tensor(rng.uniform(70.0, 800.0, (2, 12, M)).astype(dtype))
    cands[:, 5:17] = full
    cands[:, 20:23] = full[:, :3] * (1.0 + 0.04 * torch.as_tensor(
        rng.uniform(-1.0, 1.0, (2, 3, M)).astype(dtype)))
    cands[:, 10, 0] = 5000.0   # far from every neighbour: zeroed
    cands[:, 11, M - 1] = 10.0
    scores[:, 5:23] = 3.0
    got, _ = check_remove(cands, scores, cuda)
    assert (got[0][:, 10, 0] == 0).all() and (got[0][:, 11, M - 1] == 0).all()
    assert (got[0][:, 6:16] != 0).sum() > 0.9 * 2 * 10 * M


def remove_tile(M, elem):
    """Frames a tile of the remove kernel at M slots of ``elem`` bytes in
    a call with a tile an SM: csrc/refine.cu's remove_tile and
    remove_layout, its constants read from the source."""
    import re
    src = open(os.path.join(os.path.dirname(refine.__file__), "..", "csrc",
                            "refine.cu")).read()

    def const(name):
        return eval(re.search(rf"constexpr \w+(?: \w+)? {name} = ([^;]+);",
                              src).group(1))

    walk, tile = const("kWalk"), const("kTileMost")

    def layout_bytes(t):
        g = t + 2
        b = (g * M * elem + 31) // 16 * 16
        b = (b + t * M * elem + 31) // 16 * 16
        b += g * (-(-M // walk) * walk) * elem + 4 * g + 4 * (t * M // 32 + 2)
        return (b + 2 * g * M + 15) // 16 * 16

    while tile > 1 and layout_bytes(tile) > const("kTileBytes"):
        tile //= 2
    return tile


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("edge", ["T-1", "T", "T+1", "2T+1"])
def test_remove_kernel_tile_edges(cuda, dtype, edge):
    """Rows of F = T - 1, T, T + 1 and 2 T + 1 frames for the kernel's T at
    M = 105 (16 in both types), as many rows as the card has SMs and 8
    more, so that the kernel keeps that T: tile edges fall inside rows and
    rows end inside tiles.  (Fewer rows take smaller tiles.)"""
    T = remove_tile(105, 4 if dtype == "float32" else 8)
    assert T == 16
    F = {"T-1": T - 1, "T": T, "T+1": T + 1, "2T+1": 2 * T + 1}[edge]
    B = torch.cuda.get_device_properties(cuda).multi_processor_count + 8
    cands, scores = remove_inputs(B, F, 105, dtype, seed=F + 1600)
    check_remove(cands, scores, cuda)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("F", [5, 8, 9, 17, 33])
def test_remove_kernel_small_calls(cuda, dtype, F):
    """Three rows: fewer tiles than SMs, so the kernel halves its tiles
    (down to a frame and its two halo frames)."""
    cands, scores = remove_inputs(3, F, 105, dtype, seed=F + 1700)
    check_remove(cands, scores, cuda)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_remove_kernel_more_tiles_than_grid(cuda, dtype):
    """(4, 5000, 105): more tiles than the grid's blocks, so each block
    walks several."""
    cands, scores = remove_inputs(4, 5000, 105, dtype, seed=5000)
    check_remove(cands, scores, cuda)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_remove_kernel_unaligned_views(cuda, dtype):
    """Contiguous views that start off a 16-byte boundary (rows 1 and 2
    of a batch whose rows are not a multiple of 16 bytes), for both
    inputs and for one of them: the kernel copies element by element
    there, and equals the plain version."""
    cands, scores = remove_inputs(3, 7, 105, dtype, seed=77)
    c, s = cands.to(cuda), scores.to(cuda)
    cv, sv = c[1:], s[1:]
    assert cv.is_contiguous() and cv.data_ptr() % 16 != 0
    check_remove(cv, sv, cuda)
    check_remove(cv.clone(), sv, cuda)


def test_remove_threshold_every_float32(cuda):
    """The kernel's threshold over every positive finite float32, on the
    card: fl(t / a) is not above 0.05f and fl(nextup(t) / a) is (so
    !(d > t) == !(d / a > 0.05f) for every d), and t equals the plain
    version's on the card."""
    limit = torch.tensor(0.05, dtype=torch.float32, device=cuda)
    chunk = 1 << 27
    before = refine.remove_threshold.launches
    n_chunks = 0
    for start in range(1, 0x7F800000, chunk):
        bits = torch.arange(start, min(start + chunk, 0x7F800000),
                            dtype=torch.int32, device=cuda)
        a = bits.view(torch.float32)
        t = refine.remove_threshold(a)
        up = (t.view(torch.int32) + 1).view(torch.float32)
        assert not (t / a > limit).any()
        assert (up / a > limit).all()
        assert torch.equal(t, refine.remove_threshold_plain(a))
        n_chunks += 1
    assert refine.remove_threshold.launches == before + n_chunks


def test_remove_threshold_float64_and_specials(cuda):
    """Seeded float64 over the whole positive range and the special
    values (negative, +-inf, NaN) of both types: the kernel's threshold
    equals the plain version's on the card."""
    rng = np.random.default_rng(64)
    bits = rng.integers(1, 0x7FF0000000000000, 1 << 22, dtype=np.int64)
    a64 = torch.as_tensor(bits).view(torch.float64).to(cuda)
    assert torch.equal(refine.remove_threshold(a64),
                       refine.remove_threshold_plain(a64))
    for dt in (torch.float32, torch.float64):
        sp = torch.tensor([-1.0, -float("inf"), float("inf"), float("nan"),
                           torch.finfo(dt).max, torch.finfo(dt).tiny],
                          dtype=dt, device=cuda)
        assert torch.equal(refine.remove_threshold(sp),
                           refine.remove_threshold_plain(sp))


# ------------------------------------------- StoneMask's float32 refinement

STONEMASK_GOLDENS = {8000: "goldens_fs8", 16000: "goldens_fs16",
                     22050: "goldens", 44100: "goldens_fs44",
                     48000: "goldens_fs48"}


def stonemask_dio(fs, rows, cuda):
    """The port's float32 Dio track on the card of ``rows`` rows of the
    golden utterance at ``fs`` (gains 0.5-1.5 past one row): (x, tp (B,
    F) contiguous, f0)."""
    x = np.fromfile(os.path.join(os.path.dirname(GOLDENS),
                                 STONEMASK_GOLDENS[fs], "x.f64"))
    gains = np.linspace(0.5, 1.5, rows) if rows > 1 else np.ones(1)
    xb = torch.as_tensor((x[None] * gains[:, None]).astype(np.float32),
                         device=cuda)
    tp, f0 = port_dio.dio_batch(xb, fs)
    return xb, tp.expand_as(f0).contiguous(), f0


def check_stonemask(x, pos, f0, fs, max_len=None):
    """One launch of the kernel, held to the plain version on the same
    card tensors at stonemask_bench.GATES."""
    from world_tpu_torch.models.stonemask import max_len as max_len_of
    from world_tpu_torch.ops import stonemask
    from world_tpu_torch.tools import stonemask_bench

    args = (x, pos, f0, float(fs), max_len or max_len_of(fs))
    before = stonemask.stonemask_refine.launches
    got = stonemask.stonemask_refine(*args)
    assert stonemask.stonemask_refine.launches == before + 1
    want = stonemask.stonemask_refine_plain(*args)
    stats = stonemask_bench.compare(got, want)
    assert stonemask_bench.within_gates(stats), stats
    return got, want


@pytest.mark.parametrize("fs", sorted(STONEMASK_GOLDENS))
def test_stonemask_kernel_matches_plain(cuda, fs):
    """The golden utterance's float32 Dio track at each golden rate, 16
    rows at 22.05 and 48 kHz (the batch step's), 2 at the others."""
    rows = 16 if fs in (22050, 48000) else 2
    x, pos, f0 = stonemask_dio(fs, rows, cuda)
    got, _ = check_stonemask(x, pos, f0, fs)
    assert (got > 0).sum() > 50 * rows


@pytest.mark.parametrize("fs", sorted(STONEMASK_GOLDENS))
def test_stonemask_kernel_edges(cuda, fs):
    """tests/test_torch_stonemask.py's seeded frames (F0 along a glide
    over (40, fs / 12], on the fft-size boundaries, windows clamped at
    both edges, silent frames whose first pass fails) in two rows, and
    unusable F0s (0, 40, past fs / 12, NaN, inf, negative) in a third."""
    from world_tpu_torch.tools.stonemask_bench import seeded_frames

    rows = [seeded_frames(fs, seed=s) for s in (fs, fs + 1)]
    n = min(len(r[1]) for r in rows)
    x = np.stack([r[0] for r in rows] + [rows[0][0]])
    pos = np.stack([r[1][:n] for r in rows] + [rows[0][1][:n]])
    f0 = np.stack([r[2][:n] for r in rows] + [rows[0][2][:n]])
    odd = [0.0, 40.0, fs / 11.0, np.nan, np.inf, -5.0]
    f0[2, :len(odd)] = odd
    got, _ = check_stonemask(*(torch.as_tensor(a, device=cuda)
                               for a in (x, pos, f0)), fs)
    got = got.cpu().numpy()
    assert (got[2, :len(odd)] == 0.0).all()
    assert (got[:2, -3:] == f0[:2, -3:]).all()     # failed first passes


def test_stonemask_kernel_largest_buffer(cuda):
    """max_len at the wrapper's limit (which sizes nothing in the kernel)
    gives what JAX's max_len gives."""
    from world_tpu_torch.ops import stonemask

    x, pos, f0 = stonemask_dio(22050, 4, cuda)
    got, _ = check_stonemask(x, pos, f0, 22050, stonemask.MAX_LEN)
    want, _ = check_stonemask(x, pos, f0, 22050)
    assert torch.equal(got, want)


def frames_of_windows(fs, win_lens, seed=0, seconds=1.0):
    """(x (1, L), pos (1, N), f0 (1, N)) numpy float32: each window
    length of ``win_lens`` at 3 seeded positions of a seeded glide (one
    clamped at the signal's start), f0 = 1.5 fs / (hw - 1/2) for hw =
    (win_len - 1) / 2, which the kernel's float32 half-width takes to hw
    (checked)."""
    from world_tpu_torch.tools.stonemask_bench import glide

    x, _ = glide(fs, seed, seconds)
    hw = (np.repeat(np.asarray(win_lens), 3) - 1) // 2
    f0 = (1.5 * fs / (hw - 0.5)).astype(np.float32)
    pos = np.random.RandomState(seed).uniform(0, seconds, len(hw))
    pos[::3] = 0.001
    got = (1.5 * torch.full((), float(fs)) / torch.as_tensor(f0)
           + 1.0).to(torch.int64).numpy()
    assert (got == hw).all()
    return x[None], pos.astype(np.float32)[None], f0[None]


@pytest.mark.parametrize("fs", [22050, 48000])
def test_stonemask_kernel_chunk_edges(cuda, fs):
    """Every usable window length beside a multiple of the 32-sample
    chunk (win_len = 32 k - 1 or 32 k + 1: a window is odd, so these end
    one sample short of a chunk or one past it, where the look-ahead
    and the carried neighbour meet the window's edge): 0 frames differ
    from the plain version."""
    from world_tpu_torch.ops.stonemask import usable_frames, window_bound

    lens = [n for k in range(2, window_bound(fs) // 32 + 2)
            for n in (32 * k - 1, 32 * k + 1) if n <= window_bound(fs)]
    x, pos, f0 = (torch.as_tensor(a, device=cuda)
                  for a in frames_of_windows(fs, lens))
    usable = usable_frames(f0, torch.full((), float(fs), device=cuda))
    assert int(usable.sum()) >= 3 * len(lens)
    got, want = check_stonemask(x, pos, f0, fs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fs", [8000, 22050, 44100, 48000])
def test_stonemask_kernel_longest_window(cuda, fs):
    """The longest window a usable frame takes (F0 at the least float32
    above 40 Hz; window_bound(fs), or 2 below it where 1.5 fs / 40 is a
    whole number), at 20 seeded positions and both signal edges: 0
    frames differ from the plain version."""
    from world_tpu_torch.ops.stonemask import window_bound
    from world_tpu_torch.tools.stonemask_bench import glide

    x, _ = glide(fs, 5)
    f0 = np.full(22, np.nextafter(np.float32(40), np.float32(50)))
    pos = np.random.RandomState(5).uniform(0, 1, 22).astype(np.float32)
    pos[:2] = 0.0, (len(x) - 1) / fs
    hw = int((1.5 * torch.full((), float(fs)) / torch.as_tensor(f0[:1])
              + 1.0).to(torch.int64))
    assert window_bound(fs) - 2 <= 2 * hw + 1 <= window_bound(fs)
    got, want = check_stonemask(*(torch.as_tensor(a[None], device=cuda)
                                  for a in (x, pos, f0)), fs)
    assert torch.equal(got, want) and (got > 0).all()


def test_stonemask_kernel_more_frames_than_resident_warps(cuda):
    """64 rows x 401 frames of seeded glides at 22.05 kHz (F0s 2% about
    their pitch), more frames than the card holds warps at once: 0
    frames differ from the plain version."""
    from world_tpu_torch.tools.stonemask_bench import glide, launch_shape

    fs, n_frames = 22050, 401
    rs = np.random.RandomState(64)
    x, f0 = [], []
    for seed in range(64):
        xs, pitch = glide(fs, seed, seconds=2.0)
        x.append(xs)
        at = np.minimum((np.arange(n_frames) * 0.005 * fs).astype(int),
                        len(xs) - 1)
        f0.append(pitch[at] * (1.0 + 0.02 * rs.randn(n_frames)))
    pos = np.tile(np.arange(n_frames) * 0.005, (64, 1))
    x, pos, f0 = (torch.as_tensor(np.asarray(a, np.float32), device=cuda)
                  for a in (x, pos, f0))
    shape = launch_shape(torch, f0.shape, cuda)
    assert f0.numel() > shape["warps_per_sm"] * shape["sms"]
    got, want = check_stonemask(x, pos, f0, fs)
    assert torch.equal(got, want) and (got > 0).sum() > 60 * n_frames


def test_stonemask_kernel_grid_stride(cuda):
    """More frames than the grid has warps (one row, the grid's warps +
    500 frames, usable ones at the start and past the first stride, the
    rest unusable): the warps walk on; 0 frames differ from the plain
    version, and the unusable frames are 0."""
    from world_tpu_torch.tools.stonemask_bench import glide, launch_shape

    fs = 22050
    x, pitch = glide(fs, 9)
    shape = launch_shape(torch, (1, 1 << 30), cuda)
    stride = shape["blocks"] * shape["warps_per_block"]
    F = stride + 500
    assert launch_shape(torch, (1, F), cuda)["blocks"] == shape["blocks"]
    f0 = np.zeros((1, F), np.float32)
    pos = np.zeros((1, F), np.float32)
    live = np.r_[0:50, stride:F]
    at = np.random.RandomState(9).randint(0, len(x), len(live))
    f0[0, live] = pitch[at]
    pos[0, live] = at / fs
    got, want = check_stonemask(*(torch.as_tensor(a, device=cuda)
                                  for a in (x[None], pos, f0)), fs)
    assert torch.equal(got, want)
    assert (got[0, live] > 0).all() and int((got != 0).sum()) == len(live)


def test_stonemask_never_syncs(cuda):
    """The wrapper and the model's float32 StoneMask (stone_mask_batch)
    run under set_sync_debug_mode("error"), one launch each."""
    from world_tpu_torch.models import stonemask as port_sm
    from world_tpu_torch.ops import stonemask

    x, pos, f0 = stonemask_dio(22050, 16, cuda)
    tp = pos[0]
    torch.cuda.synchronize()
    before = stonemask.stonemask_refine.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = stonemask.stonemask_refine(x, pos, f0, 22050.0, 2048)
        b = port_sm.stone_mask_batch(x, 22050, tp, f0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert stonemask.stonemask_refine.launches == before + 2
    assert torch.equal(a, b)


def test_stonemask_plain_never_runs_on_card(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel: with the plain version made to
    raise, the float32 Dio step runs on the card and launches it once."""
    from world_tpu_torch.ops import stonemask

    def boom(*args, **kwargs):
        raise AssertionError("plain version reached on the card")
    monkeypatch.setattr(stonemask, "stonemask_refine_plain", boom)
    monkeypatch.setattr(stonemask, "refine_frames", boom)
    x = golden("x").astype(np.float32)
    step = pipeline.make_batch_step(22050, len(x), f0_method="dio",
                                    with_synthesis=False, device=cuda)
    before = stonemask.stonemask_refine.launches
    f0 = step(np.stack([x, 0.7 * x]))[0]
    assert stonemask.stonemask_refine.launches == before + 1
    assert torch.isfinite(f0).all() and (f0 > 0).any()


def test_stonemask_rejects_bad_inputs(cuda):
    """float64, a CPU tensor beside card tensors, and non-contiguous
    inputs raise; so does a launch the kernel refuses (a max_len past its
    float32 sample indices, kMaxLen = 2^24)."""
    import ctypes

    from world_tpu_torch.ops import stonemask

    x, pos, f0 = stonemask_dio(22050, 2, cuda)
    ok = (x, pos, f0, 22050.0, 2048)
    for i, bad, err in ((2, f0.double(), TypeError), (0, x.double(), TypeError),
                        (1, pos.cpu(), ValueError),
                        (0, x.t().contiguous().t(), ValueError),
                        (2, f0.t().contiguous().t(), ValueError)):
        args = list(ok)
        args[i] = bad
        with pytest.raises(err):
            stonemask.stonemask_refine(*args)
    entry = _cuda.entry("stonemask", "stonemask_refine",
                        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
                        + (ctypes.c_float, ctypes.c_void_p))
    with pytest.raises(RuntimeError):
        _cuda.launch("stonemask_refine", entry, x.device, x.data_ptr(),
                     pos.data_ptr(), f0.data_ptr(), f0.data_ptr(), 2,
                     x.shape[1], f0.shape[1], (1 << 24) + 1, 22050.0)


def _sync_blocks():
    """{source path: [(first line, last line, site)]} of every
    ``with sync("<site>"...):`` block of the package."""
    import ast
    from pathlib import Path

    out = {}
    for path in Path(W.__file__).resolve().parent.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                call = item.context_expr
                if isinstance(call, ast.Call) and getattr(
                        call.func, "id", None) == "sync":
                    out.setdefault(str(path), []).append(
                        (node.lineno, node.end_lineno, call.args[0].value))
    return out


def _syncs_by_site(fn, events=False):
    """Run ``fn`` under set_sync_debug_mode("warn"): ({site: syncs the
    mode reports inside that site's block}, {site: device.sync.counts'
    rise}).  A sync outside every block is put under None.  With
    ``events`` every torch.cuda.Event.synchronize is reported too: a
    cudaEventSynchronize makes the host wait, but the mode does not see
    it (c10/cuda/CUDAEvent.h)."""
    import traceback
    import warnings

    from world_tpu_torch import device

    blocks = _sync_blocks()
    seen = []

    def record(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            seen.append(traceback.extract_stack()[:-1])

    real_wait = torch.cuda.Event.synchronize

    def recorded_wait(event):
        seen.append(traceback.extract_stack()[:-1])
        return real_wait(event)

    before = dict(device.sync.counts)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        if events:
            torch.cuda.Event.synchronize = recorded_wait
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.Event.synchronize = real_wait
    reported = {}
    for stack in seen:
        site = next((s for f in reversed(stack)
                     for first, last, s in blocks.get(
                         os.path.realpath(f.filename), ())
                     if first <= f.lineno <= last), None)
        reported[site] = reported.get(site, 0) + 1
    counted = {k: v - before.get(k, 0) for k, v in device.sync.counts.items()
               if v != before.get(k, 0)}
    return reported, counted


@pytest.mark.parametrize("path", ["harvest", "dio"])
def test_step_syncs_are_the_counted_sites(cuda, path):
    """One warmed float32 step, Harvest + Synthesis or Dio + StoneMask +
    codec: every sync that set_sync_debug_mode("warn") reports lies in a
    ``device.sync`` block, and each site's count rises by the syncs
    reported in it."""
    x = golden("x").astype(np.float32)
    kw = (dict(f0_method="harvest") if path == "harvest" else
          dict(f0_method="dio", codec_dims=60, with_synthesis=False))
    step = pipeline.make_batch_step(22050, len(x), rng_mode="fast",
                                    device=cuda, **kw)
    xb = torch.as_tensor(np.stack([x, 0.7 * x]), device=cuda)
    step(xb)
    reported, counted = _syncs_by_site(lambda: step(xb))
    assert None not in reported
    assert reported == counted and sum(counted.values()) >= 10


def test_step_launches_inside_its_span(cuda):
    """With tracing on, every kernel a profiled step launches has its
    launch time inside the step's ``span:step`` range: the program's
    spans and the card's kernels are on one clock."""
    from torch.profiler import ProfilerActivity, profile

    from world_tpu_torch import device

    x = golden("x").astype(np.float32)
    step = pipeline.make_batch_step(22050, len(x), rng_mode="fast",
                                    f0_method="harvest", device=cuda)
    xb = torch.as_tensor(np.stack([x, 0.7 * x]), device=cuda)
    step(xb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        device.set_tracing(True)
        try:
            step(xb)
        finally:
            device.set_tracing(False)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launch_at, kernels, spans = {}, [], []
    for ev in events:
        start = ev.start_ns()
        if "CUDA" in str(ev.device_type()):
            if not ev.is_user_annotation() and not ev.name().startswith(
                    ("Memcpy", "Memset")):
                kernels.append(ev.correlation_id())
        elif ev.name() == "span:step":
            spans.append((start, start + ev.duration_ns()))
        elif ev.name().startswith("cu"):
            launch_at[ev.correlation_id()] = start
    assert len(spans) == 1 and len(kernels) > 100
    lo, hi = spans[0]
    assert all(lo <= launch_at[c] <= hi for c in kernels)


def test_stream_syncs_are_the_counted_sites(cuda):
    """Warmed streams at the streaming cell's settings (hold on miss) and
    at the reference's semantics (a window that misses waits), each
    closed and refreshed on the way, their renders replayed from the
    graphs that warm-up captured where they fit: every sync that
    set_sync_debug_mode("warn") reports, and every wait on a render's
    event, lies in a ``device.sync`` block, and each site's count rises
    by the syncs in it: ``stream.wait`` the waits, and ``stream.dc``
    never (the DC remover is the process's since warm-up, and a close
    keeps it).  Replays add no sync, and no graph is captured after
    warm-up."""
    from world_tpu_torch.models import realtime
    from world_tpu_torch.models.realtime import StreamingSynthesizer

    f0, sp, ap = (golden(k).astype(np.float32)
                  for k in ("harvest_f0", "cheaptrick_sp", "d4c_ap"))

    def feed(s, lo, hi):
        for i in range(lo, hi):
            while not s.add_parameters(f0[i:i + 1], sp[i:i + 1],
                                       ap[i:i + 1]):
                s.synthesis2()
            while s.synthesis2():
                pass

    synths = [StreamingSynthesizer(
        22050, 5.0, 1024, 64, 100, rng_mode="fast", dtype=np.float32,
        hold_on_miss=hold, dispatch_min_pulses=2 if hold else None,
        hold_force_ms=8.0, device=cuda) for hold in (True, False)]
    for s in synths:
        s.warmup(32)
        feed(s, 0, 60)

    def run():
        for s in synths:
            feed(s, 60, 110)
            s.close()
            feed(s, 110, 150)
            s.refresh()
            feed(s, 0, 40)
            s.close()

    before = dict(realtime.counts)
    reported, counted = _syncs_by_site(run, events=True)
    assert None not in reported
    assert reported == counted
    assert "stream.dc" not in counted and counted["stream.wait"] > 0
    assert realtime.counts["graphed"] > before["graphed"]
    assert realtime.counts["captures"] == before["captures"]

