"""The one traffic generator.  Every cell's mix is data in its workload
file (``portbench/workloads/<cell>.json``, key ``traffic``); this module
turns it and ``--seed`` into signals.

A signal is the golden utterance of the cell's rate (``data/
golden_<fs>.f64``, the 0.79 / 0.70 s "vaiueo" recordings of WORLD's test
data) tiled from a seeded start, with a seeded pause after each tile,
cut to its length, over a seeded noise floor (``noise``, the standard
deviation of white noise added throughout, as a recording's room and
preamp leave it) and scaled by a seeded gain: a frozen copy of
world_tpu_torch/tools/batch_invariance.py::corpus_signals and
contour_bench.py::longform_int16, with the pauses added so that voicing
comes and goes as in read speech.

The lengths of a corpus are one fixed multiset, drawn from the mix's own
``lengths_seed``; ``--seed`` draws their order, starts, pauses and gains.
So every seed asks for the same work, in another order.
"""

import math
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"


def golden(fs):
    return np.fromfile(DATA / f"golden_{fs}.f64")


def lengths_s(mix):
    """The corpus's utterance lengths in seconds (fixed by the mix)."""
    rng = np.random.default_rng(mix["lengths_seed"])
    lo, hi = mix["length_s"]
    n = mix["utterances"]
    if mix.get("length_dist", "uniform") == "beta":
        a, b = mix["beta"]
        return lo + (hi - lo) * rng.beta(a, b, n)
    return rng.uniform(lo, hi, n)


def speech(src, n, rng, mix, fs):
    """``n`` samples of ``src`` tiled from a seeded start, each tile
    followed by a seeded pause of ``mix["pause_s"]`` = [lo, hi] seconds,
    over a noise floor of ``mix["noise"]``."""
    parts, have = [], 0
    start = int(rng.integers(len(src)))
    while have < n:
        tile = src[start:]
        start = 0
        gap = np.zeros(int(rng.uniform(*mix["pause_s"]) * fs))
        parts += [tile, gap]
        have += len(tile) + len(gap)
    return np.concatenate(parts)[:n] + rng.normal(0.0, mix["noise"], n)


def corpus(mix, fs, seed):
    """[float32 signal] of the mix, in the seed's order."""
    rng = np.random.default_rng(seed)
    src = golden(fs)
    lengths = lengths_s(mix)[rng.permutation(mix["utterances"])]
    out = []
    for s in lengths:
        x = speech(src, int(s * fs), rng, mix, fs)
        out.append((x * rng.uniform(*mix["gain"])).astype(np.float32))
    return out


def bucket_len(seconds, fs):
    return int(math.ceil(seconds * fs))


def batches(signals, mix, fs):
    """The corpus as the batched runner forms it: each signal into the
    first bucket that holds it, in order; a bucket is dispatched when it
    holds ``batch`` rows, and the partly filled ones after the last
    signal, padded with zero rows.  Returns [(padded float32 (batch, L),
    real lengths (batch,), indices)]."""
    lens = [bucket_len(b, fs) for b in mix["buckets_s"]]
    size = mix["batch"]
    open_, out = {}, []

    def emit(b, members):
        rows = np.zeros((size, b), np.float32)
        lengths = np.zeros(size, np.int64)
        for r, i in enumerate(members):
            rows[r, :len(signals[i])] = signals[i]
            lengths[r] = len(signals[i])
        out.append((rows, lengths, list(members)))

    for i, x in enumerate(signals):
        b = next((b for b in lens if len(x) <= b), None)
        if b is None:
            raise ValueError(f"a signal of {len(x)} samples is longer "
                             f"than every bucket")
        open_.setdefault(b, []).append(i)
        if len(open_[b]) == size:
            emit(b, open_.pop(b))
    for b in sorted(open_):
        emit(b, open_[b])
    return out


def recording(mix, fs, seed):
    """One long int16 recording of ``mix["seconds"]`` (the long-form
    cell's request): speech at a seeded level, as 16-bit PCM stores it."""
    rng = np.random.default_rng(seed)
    x = speech(golden(fs), int(mix["seconds"] * fs), rng, mix, fs)
    level = rng.uniform(*mix["gain"])
    return (np.clip(x * level, -0.999, 0.999) * 32767).astype(np.int16)
