"""The plain reference of WORLD's real-time synthesis
(portbench/reference/realtime.py) and the port's StreamingSynthesizer
against it, on the CPU at the 0.8 s golden utterance.

- The reference in exact mode, float64, against the C++ frame-by-frame
  output (synthesis3_y) at > 80 dB, as tests/test_torch_realtime.py holds
  the port.
- The port in float32 fast mode at the settings of the benchmark's
  streaming cell (portbench/configs/rtsynth_22k.json: hold on miss,
  dispatch threshold 2, forced after 8 ms, ring of 100, one frame a
  push) against the reference, by the cell's own check: no buffer off,
  and the cell's limit on y_err_db_median.
- Streams interleaved round-robin deliver, each, the buffers it delivers
  alone, bit for bit (with hold_force_ms 0 the renders a stream makes
  follow its own calls alone; with a time limit they follow the wall
  clock, and another grouping sums the same pulses in another order).
- ``realtime.counts`` adds up: calls, buffers and holds as the calls
  returned, renders and pulses as the renders launched.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from portbench import check_stream  # noqa: E402
from portbench.reference import realtime as ref  # noqa: E402
from world_tpu_torch.models import realtime  # noqa: E402
from world_tpu_torch.models.realtime import StreamingSynthesizer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                     "rtsynth_22k.json")))
CELL = json.load(open(os.path.join(ROOT, "portbench", "workloads",
                                   "rtsynth_22k.stream.json")))
FS, FFT, BS = CONFIG["fs"], CONFIG["fft_size"], CONFIG["buffer_size"]


def params(gold, dtype=np.float64):
    return (gold["harvest_f0"].astype(dtype),
            gold["cheaptrick_sp"].astype(dtype), gold["d4c_ap"].astype(dtype))


def lane(gold, seed):
    """A seeded variant of the golden frames: from a seeded frame on, F0
    scaled and the envelope at a seeded level, float32."""
    rng = np.random.default_rng([seed, 21])
    f0, sp, ap = params(gold)
    start = int(rng.integers(0, 20))
    return ((f0[start:] * rng.uniform(0.8, 1.25)).astype(np.float32),
            (sp[start:] * rng.uniform(0.1, 4.0)).astype(np.float32),
            ap[start:].astype(np.float32))


def synth(**kw):
    c = dict(rng_mode=CONFIG["rng_mode"], dtype=np.dtype(CONFIG["dtype"]),
             hold_on_miss=CONFIG["hold_on_miss"],
             dispatch_min_pulses=CONFIG["dispatch_min_pulses"],
             hold_force_ms=CONFIG["hold_force_ms"], device="cpu")
    c.update(kw)
    return StreamingSynthesizer(FS, CONFIG["frame_period_ms"], FFT, BS,
                                CONFIG["number_of_pointers"], **c)


class Feed:
    """One listener as the streaming cell's driver feeds it: a visit
    pushes the next frame if the ring takes it, then drains."""

    def __init__(self, s, frames):
        self.s, self.frames, self.fed, self.out = s, frames, 0, []

    def done(self):
        return (self.fed == len(self.frames[0])
                and self.s.synthesized_sample + BS >= self.s.last_location)

    def visit(self):
        k = self.fed
        if k < len(self.frames[0]) and self.s.add_parameters(
                *(a[k:k + 1] for a in self.frames)):
            self.fed += 1
        while self.s.synthesis2():
            self.out.append(self.s.buffer[:BS].copy())


def play(feeds):
    while not all(f.done() for f in feeds):
        for f in feeds:
            if not f.done():
                f.visit()
    for f in feeds:
        f.s.close()
    return [np.asarray(f.out) for f in feeds]


def snr_nonzero(want, got):
    v = np.abs(want) > 0
    return 10 * np.log10(np.sum(want[v] ** 2)
                         / np.sum((want[v] - got[v]) ** 2))


def test_reference_exact_meets_synthesis3(gold):
    f0, sp, ap = params(gold)
    y, n = ref.stream(f0, sp, ap, FS, 5.0, gold.scalar("fft_size"), 64,
                      rng_mode="exact")
    want = gold["synthesis3_y"]
    assert len(y) == 64 * n and n * 64 <= len(want) < (n + 3) * 64
    assert snr_nonzero(want[:len(y)], y) > 80.0
    assert not np.any(want[len(y):])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_against_reference_at_the_cells_settings(gold, seed):
    frames = lane(gold, seed)
    (got,) = play([Feed(synth(), frames)])
    y_ref, n_ref = ref.stream(*frames, FS, CONFIG["frame_period_ms"], FFT,
                              BS, rng_mode=CONFIG["rng_mode"])
    nums = check_stream.judge_lane([(got, 0, True, y_ref, n_ref)], FS)
    assert len(got) == n_ref and nums["buffers_off"] == 0
    assert nums["y_err_db_median"] \
        < CELL["check"]["limits"]["y_err_db_median"]


def test_interleaved_streams_are_each_alone(gold):
    lanes = [lane(gold, seed) for seed in range(3)]
    together = play([Feed(synth(hold_force_ms=0.0), f) for f in lanes])
    for frames, got in zip(lanes, together):
        (alone,) = play([Feed(synth(hold_force_ms=0.0), frames)])
        assert np.array_equal(alone, got)


def test_counts_add_up(gold, monkeypatch):
    sizes = []
    real = StreamingSynthesizer._render_dispatch

    def counted(self, pulses):
        sizes.append(len(pulses))
        return real(self, pulses)

    monkeypatch.setattr(StreamingSynthesizer, "_render_dispatch", counted)
    before = dict(realtime.counts)
    s = synth()
    f = Feed(s, lane(gold, 0))
    calls = trues = 0
    real_s2 = s.synthesis2

    def tallied():
        nonlocal calls, trues
        calls += 1
        ok = real_s2()
        trues += ok
        return ok

    s.synthesis2 = tallied
    (got,) = play([f])
    rise = {k: realtime.counts[k] - before.get(k, 0)
            for k in ("calls", "buffers", "holds", "renders", "pulses")}
    assert rise["calls"] == calls and rise["buffers"] == trues == len(got)
    assert rise["holds"] == s.holds
    assert rise["renders"] == len(sizes) == s.renders
    assert rise["pulses"] == sum(sizes) > rise["renders"]
