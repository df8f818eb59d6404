"""The one generator: the same seed gives the same inputs, other seeds
other inputs of the same work."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

CELLS = Path(__file__).resolve().parents[1] / "workloads"


def mix(cell, **small):
    m = json.loads((CELLS / f"{cell}.json").read_text())["traffic"]
    m.update(small)
    return m


@pytest.mark.parametrize("cell,fs", [("harvest_22k.copysynth", 22050),
                                     ("dio_48k.features", 48000)])
def test_same_seed_same_inputs_other_seed_same_work(cell, fs):
    m = mix(cell, utterances=24)
    seed = 2 ** 31 + 12345
    a, b = traffic.corpus(m, fs, seed), traffic.corpus(m, fs, seed)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = traffic.corpus(m, fs, seed + 1)
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a, c))
    assert sorted(map(len, a)) == sorted(map(len, c))
    lo, hi = m["length_s"]
    assert all(lo * fs - 1 <= len(x) <= hi * fs for x in a)
    ba, bc = traffic.batches(a, m, fs), traffic.batches(c, m, fs)
    assert sorted(r.shape for r, _, _ in ba) == \
        sorted(r.shape for r, _, _ in bc)


def test_batches_pad_and_fill():
    m = mix("dio_48k.features", utterances=40)
    sig = traffic.corpus(m, 48000, 7)
    out = traffic.batches(sig, m, 48000)
    seen = sorted(i for _, _, idx in out for i in idx)
    assert seen == list(range(40))
    for rows, lengths, idx in out:
        assert rows.shape[0] == m["batch"]
        for r, i in enumerate(idx):
            assert lengths[r] == len(sig[i])
            np.testing.assert_array_equal(rows[r, :len(sig[i])], sig[i])
            assert not rows[r, len(sig[i]):].any()
        assert not lengths[len(idx):].any()


def test_recording_is_int16_and_seeded():
    m = {"seconds": 2.0, "pause_s": [0.05, 0.35], "noise": 3e-4,
         "gain": [0.4, 0.8]}
    a = traffic.recording(m, 22050, 5)
    assert a.dtype == np.int16 and len(a) == 44100
    assert np.array_equal(a, traffic.recording(m, 22050, 5))
    assert not np.array_equal(a, traffic.recording(m, 22050, 6))
