"""Harvest contour fixing + smoothing (FixF0Contour / SmoothF0Contour,
reference src/harvest.cpp:693-1113), batched over utterances.

The C++ walks data-dependent section lists with in-place swaps.  Here
sections live in (B, K) tensors (K = the largest section count in the
batch, or ``cap``) and every walk is a Python loop over its scan axis,
vectorized over utterances and sections:

- FixStep1 is frame-parallel (the jump test reads the *unfixed* base).
- FixStep2 uses run-length cummax/cummin of boundary indices.
- FixStep3's ExtendF0 is a 101-step loop over all sections and both
  directions; ExtendSub's mean-residue carry is a loop over sections,
  MergeF0 a loop over the kept sections in start order (the C++
  MakeSortedOrder swap-insertion is a stable sort for its keys).  These
  loops are the plain version of csrc/harvest_contour.cu, which runs
  FixStep3 in one launch on the card (ops/contour.py).
- FixStep4 fills short gaps frame-parallel from prev/next-section scans.
- SmoothF0Contour runs the zero-phase biquad per section with 300-frame
  edge-hold padding: the per-sample recurrence in float64 (the plain
  version of ops/iir.py's iir_zero_phase, one launch on the card), the
  block-LTI form in float32.
"""

import functools

import numpy as np
import torch

from ..ops.contour import harvest_fix_step3
from ..ops.iir import iir_zero_phase
from ..ops.matlab import lti_block_filter, lti_block_tables, take_last

BIG = 2 ** 30
LAG = 300  # smoothing pad (src/harvest.cpp:1090)

# SmoothF0Contour biquad (src/harvest.cpp:1058-1059).
_B = (0.0078202080334971724, 0.015640416066994345)
_A = (1.7347257688092754, -0.76600660094326412)


@functools.lru_cache(maxsize=None)
def _biquad_tables(block=128):
    """Block-LTI tables for the smoothing biquad.  State
    s_t = (y_t, y_{t-1}, x_t, x_{t-1}): y_t = b0 x_t + (a0, a1, b1, b0) . s."""
    M = np.array([[_A[0], _A[1], _B[1], _B[0]],
                  [1.0, 0.0, 0.0, 0.0],
                  [0.0, 0.0, 0.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    e = np.array([_B[0], 0.0, 1.0, 0.0])
    c = np.array([_A[0], _A[1], _B[1], _B[0]])
    return lti_block_tables(M, e, c, _B[0], block)


def _shift_right(x, k):
    return torch.cat([torch.zeros_like(x[:, :k]), x[:, :-k]], 1)


def _rev_cummin(x):
    return torch.cummin(x.flip(-1), -1).values.flip(-1)


def _section_masks(values):
    """Voiced-run masks with the reference's forced-unvoiced endpoints
    (GetBoundaryList, src/harvest.cpp:767-786): (voiced, starts, ends)."""
    n = values.shape[-1]
    j = torch.arange(n, device=values.device)
    v = (values != 0.0) & (j > 0) & (j < n - 1)
    prev = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], 1)
    nxt = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], 1)
    return v, v & ~prev, v & ~nxt


def _section_bounds(values, cap=None):
    """(starts, ends, count): (B, K) ascending frame indices padded with
    BIG, K the largest section count of the batch (at least 1), or the
    first ``cap`` (JAX's fixed capacity).  ``count`` is not capped."""
    _, s_mask, e_mask = _section_masks(values)
    count = s_mask.sum(1)
    if cap is not None:
        k = cap
    else:
        k = max(int(count.max()), 1) if count.numel() else 1
    idx = torch.arange(values.shape[1], device=values.device)
    big = torch.full((), BIG, device=values.device)
    st = torch.sort(torch.where(s_mask, idx, big), 1).values[:, :k]
    ed = torch.sort(torch.where(e_mask, idx, big), 1).values[:, :k]
    return st, ed, count


def _select_best(reference, rows, allowed):
    """SelectBestF0 (src/harvest.cpp:636-650): nearest candidate within
    ``allowed`` relative error; ties keep the *later* candidate.
    reference (...), rows (..., S)."""
    err = torch.abs(reference[..., None] - rows) / reference[..., None]
    j = rows.shape[-1] - 1 - torch.argmin(err.flip(-1), -1, keepdim=True)
    best = torch.gather(rows, -1, j)[..., 0]
    return torch.where(torch.gather(err, -1, j)[..., 0] <= allowed, best,
                       torch.zeros_like(best))


def _fix_step1(base, allowed_range):
    """Jump removal (src/harvest.cpp:710-722); reads the unfixed base."""
    b1 = _shift_right(base, 1)
    b2 = _shift_right(base, 2)
    ref = b1 * 2.0 - b2
    c1 = torch.abs((base - ref) / ref) > allowed_range
    c2 = torch.abs(base - b1) / b1 > allowed_range
    j = torch.arange(base.shape[1], device=base.device)
    keep = (j >= 2) & (base != 0.0) & ~(c1 & c2)
    return torch.where(keep, base, torch.zeros_like(base))


def _fix_step2(step1, voice_range_minimum=6):
    """Drop voiced runs with ed - st < 6 (src/harvest.cpp:748-762)."""
    v, s_mask, e_mask = _section_masks(step1)
    idx = torch.arange(step1.shape[1], device=step1.device)
    st_f = torch.cummax(torch.where(s_mask, idx, -1), 1).values
    ed_f = _rev_cummin(torch.where(e_mask, idx, BIG))
    remove = v & (ed_f - st_f < voice_range_minimum)
    return torch.where(remove, torch.zeros_like(step1), step1)


def _extend(ref0, origin, last_point, shift, cands, allowed):
    """ExtendF0 (src/harvest.cpp:791-820) for every (utterance, section):
    walk from ``origin`` toward ``last_point`` selecting candidates, stop
    after 4 straight misses.  ref0/origin/last_point (B, K); cands
    (B, F, S).  Frames outside [0, F) read as empty candidate rows.
    Returns (emitted values (B, K, 101), shifted origin (B, K))."""
    B, n_frames, _ = cands.shape
    rows = torch.arange(B, device=cands.device)[:, None]
    n_steps = torch.abs(last_point - origin) + 1
    tmp = ref0
    cnt = torch.zeros_like(origin)
    done = torch.zeros_like(origin, dtype=torch.bool)
    shifted = origin
    vals = []
    for s in range(101):
        t = origin + shift * (s + 1)
        inside = ((t >= 0) & (t < n_frames))[..., None]
        row = cands[rows, t.clamp(0, n_frames - 1)]
        row = torch.where(inside, row, torch.zeros_like(row))
        active = (s < n_steps) & ~done
        val = torch.where(active, _select_best(tmp, row, allowed),
                          torch.zeros_like(tmp))
        hit = val != 0.0
        cnt = torch.where(active, torch.where(hit, 0, cnt + 1), cnt)
        tmp = torch.where(active & hit, val, tmp)
        shifted = torch.where(active & hit, t, shifted)
        done = done | (cnt >= 4)
        vals.append(val)
    return torch.stack(vals, -1), shifted


def _place(vals, base, direction, n_frames):
    """The 101 emitted walk values at base + direction*(1..101), as a
    (B, K, F) row (zeros elsewhere)."""
    j = torch.arange(n_frames, device=vals.device)
    rel = (j - base[..., None]) * direction - 1
    ok = (rel >= 0) & (rel < 101)
    placed = take_last(vals, rel.clamp(0, 100))
    return torch.where(ok, placed, torch.zeros_like(placed))


def _fix_step3(step2, cands, scores, allowed_range=0.18, cap=None):
    """Extend + Merge (src/harvest.cpp:791-995) of the first ``cap``
    sections (all when None)."""
    B, n_frames, _ = cands.shape
    dev = step2.device
    rows = torch.arange(B, device=dev)[:, None]
    st, ed, n_sec = _section_bounds(step2, cap)
    K = st.shape[1]
    sec_valid = torch.arange(K, device=dev) < n_sec[:, None]
    j = torch.arange(n_frames, device=dev)
    big = torch.full((), BIG, device=dev)

    # Extend every section both ways (threshold 100 frames).
    st_c = st.clamp(0, n_frames - 1)
    ed_c = ed.clamp(0, n_frames - 1)
    in_sec = (j >= st_c[..., None]) & (j <= ed_c[..., None])
    row = step2[:, None, :]
    multi = torch.where(in_sec, row, torch.zeros_like(row))
    last_r = torch.clamp(ed_c + 100, max=n_frames - 2)
    vals_r, new_ed = _extend(step2[rows, ed_c], ed_c, last_r, 1, cands,
                             allowed_range)
    multi = multi + _place(vals_r, ed_c, 1, n_frames)
    last_l = torch.clamp(st_c - 100, min=1)
    ref_l = torch.gather(multi, -1, st_c[..., None])[..., 0]
    vals_l, new_st = _extend(ref_l, st_c, last_l, -1, cands, allowed_range)
    multi = multi + _place(vals_l, st_c, -1, n_frames)
    new_st = torch.where(sec_valid, new_st, big)
    new_ed = torch.where(sec_valid, new_ed, big)
    multi = torch.where(sec_valid[..., None], multi, torch.zeros_like(multi))

    # ExtendSub: keep sections with 2200/mean < length; the mean carries
    # residue across sections exactly like the C++ (src/harvest.cpp:840-856).
    span = (j >= new_st[..., None]) & (j < new_ed[..., None])
    sums = torch.where(span, multi, torch.zeros_like(multi)).sum(-1)
    lens = (new_ed - new_st).to(multi.dtype)
    mean = torch.zeros(B, dtype=multi.dtype, device=dev)
    keep = []
    for k in range(K):
        valid = sec_valid[:, k]
        mean = torch.where(valid, (mean + sums[:, k]) / lens[:, k], mean)
        keep.append(valid & (2200.0 / mean < lens[:, k]))
    keep = torch.stack(keep, 1)
    n_kept = keep.sum(1)

    # Compaction keeps the original order among kept sections; MergeF0's
    # MakeSortedOrder then sorts them by start (stable).
    kk = torch.arange(K, device=dev)
    compact = torch.argsort(torch.where(keep, kk, big), dim=1, stable=True)
    st_k = torch.gather(new_st, 1, compact)
    ed_k = torch.gather(new_ed, 1, compact)
    multi_k = multi[rows, compact]
    order = torch.argsort(torch.where(kk < n_kept[:, None], st_k, big), dim=1,
                          stable=True)

    # Per-section frame scores (src/harvest.cpp:858-868): best score
    # among the frame's slots holding the section's value.
    hit = cands[:, None] == multi_k[..., None]
    frame_score = torch.where(hit, scores[:, None],
                              torch.zeros_like(scores[:, None])).amax(-1)

    # Sequential merge (src/harvest.cpp:881-963).
    b_all = torch.arange(B, device=dev)
    merged = multi_k[:, 0]
    mscore = frame_score[:, 0]
    b0 = st_k[:, 0]
    b1 = ed_k[:, 0]
    for i in range(1, int(n_kept.max()) if B else 0):
        act = i < n_kept
        oi = order[:, i]
        st2, ed2 = st_k[b_all, oi], ed_k[b_all, oi]
        f0_2 = multi_k[b_all, oi]
        s2 = frame_score[b_all, oi]
        disjoint = st2 - b1 > 0
        contained = (b0 <= st2) & (b1 >= ed2)
        overlap = ~disjoint & ~contained
        in_score = (j >= st2[:, None]) & (j <= b1[:, None])
        zero = torch.zeros_like(mscore)
        score1 = torch.where(in_score, mscore, zero).sum(-1)
        score2 = torch.where(in_score, s2, zero).sum(-1)
        lo = torch.where(score1 > score2, b1, st2)     # overwrite [lo, ed2]
        write = ((disjoint[:, None] & (j >= st2[:, None])
                  & (j <= ed2[:, None]))
                 | (overlap[:, None] & (j >= lo[:, None])
                    & (j <= ed2[:, None]))) & act[:, None]
        merged = torch.where(write, f0_2, merged)
        mscore = torch.where(write, s2, mscore)
        b0 = torch.where(act & disjoint, st2, b0)
        b1 = torch.where(act & ~contained, ed2, b1)

    keep_merge = ((n_kept > 0) & (n_sec > 0))[:, None]
    return torch.where(keep_merge, merged, step2)


def _fix_step4(step3, threshold=9):
    """Linear fill of short unvoiced gaps (src/harvest.cpp:1000-1022)."""
    n = step3.shape[1]
    j = torch.arange(n, device=step3.device)
    _, s_mask, e_mask = _section_masks(step3)
    prev_ed = torch.cummax(torch.where(e_mask, j, -1), 1).values
    next_st = _rev_cummin(torch.where(s_mask, j, BIG))
    has = (prev_ed >= 0) & (next_st < BIG)
    dist = next_st - prev_ed - 1
    gap = (has & (step3 == 0.0) & (j > prev_ed) & (j < next_st)
           & (dist < threshold))
    t0 = torch.gather(step3, 1, prev_ed.clamp(0, n - 1)) + 1.0
    t1 = torch.gather(step3, 1, next_st.clamp(0, n - 1)) - 1.0
    coef = (t1 - t0) / (dist + 1.0).to(step3.dtype)
    fill = t0 + coef * (j - prev_ed).to(step3.dtype)
    return torch.where(gap, fill, step3)


def _biquad(seq):
    """y[t] = b0 x[t] + b1 x[t-1] + b0 x[t-2] + a0 y[t-1] + a1 y[t-2]
    along the last axis, zero initial state.  float64: the per-sample
    recurrence in the reference's order; float32: the block-LTI form
    (differs only in rounding, ~1e-6 relative)."""
    if seq.dtype != torch.float64:
        return lti_block_filter(seq, _biquad_tables())
    # The same recurrence as scipy's direct-form filter on the host.
    from scipy.signal import lfilter
    b0, b1 = _B
    a0, a1 = _A
    y = lfilter([b0, b1, b0], [1.0, -a0, -a1], seq.detach().cpu().numpy(),
                axis=-1)
    return torch.as_tensor(y, dtype=seq.dtype, device=seq.device)


def _smooth_contour(f0, cap=None):
    """Zero-phase 2nd-order smoothing per voiced section with 300-frame
    edge-hold padding (src/harvest.cpp:1049-1113), of the first ``cap``
    sections (all when None).  f0 (B, F)."""
    n_frames = f0.shape[1]
    contour = torch.nn.functional.pad(f0, (LAG, LAG))
    n = contour.shape[1]
    st, ed, n_sec = _section_bounds(contour, cap)
    valid = (torch.arange(st.shape[1], device=f0.device)
             < n_sec[:, None])[..., None]
    st_c = st.clamp(0, n - 1)[..., None]
    ed_c = ed.clamp(0, n - 1)[..., None]
    t = torch.arange(n, device=f0.device)
    v_st = torch.gather(contour, 1, st_c[..., 0])[..., None]
    v_ed = torch.gather(contour, 1, ed_c[..., 0])[..., None]
    x = torch.where(t < st_c, v_st,
                    torch.where(t > ed_c, v_ed, contour[:, None, :]))
    x = torch.where(valid, x, torch.zeros_like(x))
    if x.dtype == torch.float64:
        y2 = iir_zero_phase(x, "smooth")        # one launch on the card
    else:
        y2 = _biquad(_biquad(x).flip(-1)).flip(-1)
    in_sec = (t >= st_c) & (t <= ed_c) & valid
    out = torch.where(in_sec, y2, torch.zeros_like(y2)).sum(1)
    return out[:, LAG:LAG + n_frames]


def fix_and_smooth(cands, scores, *, cap=None):
    """FixF0Contour + SmoothF0Contour (src/harvest.cpp:1027-1113).
    cands/scores: (B, f0_length, n_slots).  Returns (B, f0_length).

    ``cap`` None keeps every section.  An int keeps the first ``cap``
    sections of FixStep3 and the first ``cap + 2`` of the smoothing, as
    the JAX package's fixed capacity does (its default, f0_length // 8 +
    2, holds every section FixStep2 can leave)."""
    best = torch.argmax(scores, -1, keepdim=True)
    has = scores.amax(-1) > 0.0
    base = torch.where(has, torch.gather(cands, -1, best)[..., 0],
                       torch.zeros_like(has, dtype=cands.dtype))
    step1 = _fix_step1(base, 0.008)
    step2 = _fix_step2(step1)
    step3 = harvest_fix_step3(step2, cands, scores, cap=cap)
    step4 = _fix_step4(step3)
    return _smooth_contour(step4, None if cap is None else cap + 2)
