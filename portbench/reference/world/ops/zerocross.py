"""Zero-crossing interval extraction, shared by Dio and Harvest
(reference src/dio.cpp:349-435, src/harvest.cpp:154-293).

Per filtered band, four event streams — negative-going zero crossings of
the signal, of its negation, and of the +/- forward difference (peaks and
dips) — give crossing intervals that interp1 turns into per-frame F0
candidates.  The port keeps the plain formulation: crossing lists
compacted per row and fed to interp1 (the JAX package's float64 path),
not the frame-block summaries its TPU path uses.
"""

import torch


def _crossing_pairs(signal, n_valid, fs):
    """Intervals between successive +to- zero crossings along the last
    axis (ZeroCrossingEngine, src/dio.cpp:357-393).

    signal (..., L); n_valid (...) int, the real samples of each row.
    Returns (locations, intervals, n_pairs): locations ascending and
    padded with +inf (ready for interp1), intervals padded with 0."""
    dtype, dev = signal.dtype, signal.device
    L = signal.shape[-1]
    idx = torch.arange(L, device=dev)
    s_next = torch.roll(signal, -1, -1)
    is_edge = ((signal > 0.0) & (s_next <= 0.0)
               & (idx < n_valid.unsqueeze(-1) - 1))
    n_edges = is_edge.sum(-1)
    # Sub-sample crossing position, strictly increasing over a row's
    # edges; a +to- crossing needs a sign change, so a row has at most
    # L/2 of them.
    fine_all = (idx + 1).to(dtype) - signal / (s_next - signal)
    cap = L // 2 + 2
    slot = torch.where(is_edge, torch.cumsum(is_edge, -1) - 1,
                       torch.full((), cap, device=dev))
    fine = torch.full(signal.shape[:-1] + (cap + 1,), float("inf"),
                      dtype=dtype, device=dev)
    fine.scatter_(-1, slot, fine_all)     # slot cap collects non-edges
    fine = fine[..., :cap]

    nxt = torch.roll(fine, -1, -1)
    intervals = fs / (nxt - fine)
    locations = (fine + nxt) / 2.0 / fs
    n_pairs = (n_edges - 1).clamp(min=0)
    valid = torch.arange(cap, device=dev) < n_pairs.unsqueeze(-1)
    locations = torch.where(valid, locations,
                            torch.full((), float("inf"), dtype=dtype,
                                       device=dev))
    intervals = torch.where(valid, intervals, torch.zeros_like(intervals))
    return locations, intervals, n_pairs


def four_zero_crossing_streams(filtered, n_valid, fs):
    """The four event streams of GetFourZeroCrossingIntervals
    (src/dio.cpp:402-435) for filtered (..., L): signal, negated signal,
    and the +/- forward difference.  Returns (..., 4, cap) locations and
    intervals and (..., 4) pair counts."""
    d = torch.roll(filtered, -1, -1) - filtered  # last entry junk
    streams = torch.stack([filtered, -filtered, d, -d], -2)
    valids = torch.tensor([n_valid, n_valid, n_valid - 1, n_valid - 1],
                          device=filtered.device)
    return _crossing_pairs(streams, valids.expand(streams.shape[:-1]), fs)
