"""The port's streaming synthesizer (world_tpu_torch.models.realtime) on
the CPU, float64 unless noted: the semantic cases of
tests/test_realtime.py against the reference's goldens, the port
against world_tpu's StreamingSynthesizer on the same feed, and the
repairs of the JAX package's span-marker prune.

Tolerances: SNR > 80 dB against the reference's streaming outputs
(synthesis2_y, synthesis3_y), as tests/test_realtime.py; > 200 dB where
two float64 runs differ only in summation order (span against rows,
device against host parameters, the port against JAX, fast mode at two
lookaheads); the float32 fast-mode power within 0.5-2x of the reference.

tests/test_realtime.py's cases on _RenderWorker internals (the done-set
watermark, worker threads stopped by close()) have no counterpart: the
port renders without threads (CUDA events mark renders in flight).
"""

import inspect
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import Goldens  # noqa: E402
from world_tpu.models import realtime as jax_realtime  # noqa: E402
from world_tpu_torch.models import realtime  # noqa: E402
from world_tpu_torch.models.realtime import StreamingSynthesizer  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def snr_db(ref, y):
    with np.errstate(divide="ignore"):   # equal signals: +inf dB
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - y) ** 2))


def snr_nonzero(ref, y):
    v = np.abs(ref) > 0
    assert v.any()
    return snr_db(ref[v], y[v])


def synth(gold, n_pointers, buffer_size=64, **kw):
    kw.setdefault("device", "cpu")
    return StreamingSynthesizer(gold.scalar("fs"), 5.0,
                                gold.scalar("fft_size"), buffer_size,
                                n_pointers, **kw)


def params(gold, dtype=np.float64):
    return (gold["harvest_f0"].astype(dtype),
            gold["cheaptrick_sp"].astype(dtype), gold["d4c_ap"].astype(dtype))


def collect(s, out, index, buffer_size=64):
    """Drain every available buffer of ``s`` into ``out`` from ``index``."""
    while s.synthesis2():
        take = min(buffer_size, len(out) - index)
        if take > 0:
            out[index: index + take] = s.buffer[:take]
        index += buffer_size
    return index


def run_all_at_once(gold, dtype=np.float64, **kw):
    """test.cpp variant 2: queue everything, 1 ring slot."""
    f0, sp, ap = params(gold, dtype)
    s = synth(gold, 1, dtype=dtype, **kw)
    out = np.zeros(gold["synthesis2_y"].shape[0], dtype)
    assert s.add_parameters(f0, sp, ap)
    collect(s, out, 0)
    s.close()
    return out, s


def run_chunked(gold, step, n_pointers=100, **kw):
    """Feed ``step`` frames per add_parameters (an int, or a tuple of
    sizes used in turn), draining after each."""
    f0, sp, ap = params(gold)
    steps = step if isinstance(step, tuple) else (step,)
    s = synth(gold, n_pointers, **kw)
    out = np.zeros(gold["synthesis3_y"].shape[0])
    index = i = 0
    while i < len(f0):
        n = steps[s.head_pointer % len(steps)]
        assert s.add_parameters(f0[i: i + n], sp[i: i + n], ap[i: i + n])
        i += n
        index = collect(s, out, index)
        assert not s.is_locked()
    s.close()
    return out, s


def test_streaming_all_at_once(gold):
    out, _ = run_all_at_once(gold)
    assert snr_nonzero(gold["synthesis2_y"], out) > 80.0


def test_streaming_frame_by_frame(gold):
    out, _ = run_chunked(gold, 1)
    assert snr_nonzero(gold["synthesis3_y"], out) > 80.0


def test_ring_full_and_lock_detection(gold):
    f0, sp, ap = params(gold)
    s = synth(gold, 1)
    assert s.add_parameters(f0[:3], sp[:3], ap[:3])
    # A ring of size 1 is now full; consuming everything renderable
    # leaves it full and starved: locked, the documented deadlock the
    # caller must refresh out of (src/world/synthesisrealtime.h:125-139).
    assert not s.add_parameters(f0[3:6], sp[3:6], ap[3:6])
    while s.synthesis2():
        pass
    assert s.is_locked()
    s.refresh()
    assert s.add_parameters(f0[3:6], sp[3:6], ap[3:6])


def test_refresh_resets(gold):
    f0, sp, ap = params(gold)
    s = synth(gold, 100)
    for i in range(10):
        s.add_parameters(f0[i: i + 1], sp[i: i + 1], ap[i: i + 1])
    while s.synthesis2():
        pass
    s.refresh()
    assert s.synthesized_sample == 0
    assert not s.synthesis2()


def test_streaming_dispatch_batching(gold, monkeypatch):
    """All-queued feeding renders in O(pulses/lookahead) renders, chunked
    feeding about once per chunk (the chunk's first window miss takes
    the rest of the chunk along)."""
    calls = {"n": 0}
    orig = StreamingSynthesizer._render_dispatch

    def counted(self, pulses):
        calls["n"] += 1
        return orig(self, pulses)

    monkeypatch.setattr(StreamingSynthesizer, "_render_dispatch", counted)
    out, _ = run_all_at_once(gold)
    assert snr_nonzero(gold["synthesis2_y"], out) > 80.0
    assert calls["n"] <= 3, calls["n"]

    calls["n"] = 0
    step = 20
    out, s = run_chunked(gold, step)
    assert snr_nonzero(gold["synthesis3_y"], out) > 80.0
    n_chunks = -(-len(gold["harvest_f0"]) // step)
    assert calls["n"] <= n_chunks + 3, calls["n"]
    assert s.renders == calls["n"]


@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_random_feed_patterns(gold, seed):
    """Any interleaving of chunk sizes and partial drains gives the
    all-at-once waveform (the reference's 01/02/03 equivalence)."""
    f0, sp, ap = params(gold)
    ref = gold["synthesis2_y"]
    rng = np.random.default_rng(seed)
    s = synth(gold, 100)
    out = np.zeros(ref.shape[0])
    index = 0
    i = 0
    while i < len(f0):
        step = int(rng.integers(1, 24))
        assert s.add_parameters(f0[i: i + step], sp[i: i + step],
                                ap[i: i + step])
        i += step
        for _ in range(int(rng.integers(0, 4))):   # partial drain
            if not s.synthesis2():
                break
            take = min(64, ref.shape[0] - index)
            if take > 0:
                out[index: index + take] = s.buffer[:take]
            index += 64
    collect(s, out, index)
    assert snr_nonzero(ref, out) > 80.0


def test_streaming_recovers_from_render_error(gold, monkeypatch):
    """A failed render surfaces once and leaves its keys missing, so they
    are dispatched again and the stream completes with the right
    waveform (hold_on_miss, frame by frame)."""
    f0, sp, ap = params(gold)
    ref = gold["synthesis3_y"]
    orig = StreamingSynthesizer._render_dispatch
    state = {"calls": 0}

    def flaky(self, pulses):
        state["calls"] += 1
        if state["calls"] == 2:
            raise RuntimeError("injected render failure")
        return orig(self, pulses)

    monkeypatch.setattr(StreamingSynthesizer, "_render_dispatch", flaky)
    s = synth(gold, 100, hold_on_miss=True, dispatch_min_pulses=4)
    out = np.zeros(ref.shape[0])
    index = 0
    errors = 0

    def pump():
        nonlocal index, errors
        try:
            ok = s.synthesis2()
        except RuntimeError:
            errors += 1
            return True  # surfaced; state unconsumed: retry
        if ok:
            take = min(64, ref.shape[0] - index)
            if take > 0:
                out[index: index + take] = s.buffer[:take]
            index += 64
        return ok

    for i in range(len(f0)):
        while not s.add_parameters(f0[i: i + 1], sp[i: i + 1], ap[i: i + 1]):
            pump()
        while pump():
            pass
    deadline = time.perf_counter() + 60.0
    while s.synthesized_sample + 64 < s.last_location \
            and time.perf_counter() < deadline:
        if not pump():
            time.sleep(0.002)
    assert errors == 1
    assert snr_nonzero(ref, out) > 80.0


def test_hold_on_miss_requires_lookahead(gold):
    with pytest.raises(ValueError):
        synth(gold, 100, hold_on_miss=True, lookahead_pulses=0)


def test_streaming_hold_on_miss_frame_feed(gold):
    """hold_on_miss: the frame-by-frame waveform is the reference's, and
    consumption stops at most two buffers short of the end."""
    f0, sp, ap = params(gold)
    ref = gold["synthesis3_y"]
    s = synth(gold, 100, hold_on_miss=True, dispatch_min_pulses=4)
    out = np.zeros(ref.shape[0])
    index = 0
    for i in range(len(f0)):
        while not s.add_parameters(f0[i: i + 1], sp[i: i + 1], ap[i: i + 1]):
            index = collect(s, out, index)
        index = collect(s, out, index)
    deadline = time.perf_counter() + 30.0
    while s.synthesized_sample + 64 < s.last_location \
            and time.perf_counter() < deadline:
        index = collect(s, out, index)
    assert snr_nonzero(ref, out) > 80.0
    assert index >= ref.shape[0] - 2 * 64


def test_streaming_span_render_matches_rows(gold, monkeypatch):
    """The span path (responses overlap-added by ola_accumulate, the OLA
    kernel's general mode) against per-pulse rows added on the host:
    the same pulses summed in another order."""
    calls = []
    real = realtime.ola_accumulate

    def counted(responses, offsets, *, y_padded):
        calls.append(tuple(responses.shape))
        return real(responses, offsets, y_padded=y_padded)

    monkeypatch.setattr(realtime, "ola_accumulate", counted)
    out_span, _ = run_all_at_once(gold)
    assert calls and all(c[0] == 1 for c in calls)
    n_span = len(calls)
    out_rows, _ = run_all_at_once(gold, span_render=False)
    assert len(calls) == n_span
    assert snr_nonzero(out_rows, out_span) > 200.0


def test_streaming_span_render_float32(gold):
    """float32 fast mode against the float64 reference waveform: the
    output power stays within 0.5-2x (fast noise differs sample for
    sample from the exact stream)."""
    out, s = run_all_at_once(gold, np.float32, rng_mode="fast")
    assert out.dtype == np.float32 and s.device_params
    ref = gold["synthesis2_y"]
    v = np.abs(ref) > 0
    ratio = float(np.sum(out[v].astype(np.float64) ** 2)
                  / np.sum(ref[v] ** 2))
    assert 0.5 < ratio < 2.0, ratio


def test_streaming_device_params_matches_host(gold):
    """Parameter rows kept per chunk and interpolated where the render
    runs, against envelopes interpolated on the host.  Chunks of 10, 1, 7
    and 2 frames in turn: every chunk's rows are used whatever its size
    (the JAX package's ring stops being used for good after one chunk
    under 8 frames), and renders gather rows across chunks."""
    steps = (10, 1, 7, 2)
    out_dev, s = run_chunked(gold, steps, device_params=True)
    assert s.device_params
    out_host, s = run_chunked(gold, steps, device_params=False)
    assert not s.device_params
    assert snr_nonzero(out_host, out_dev) > 200.0
    assert snr_nonzero(gold["synthesis3_y"], out_dev) > 80.0


@pytest.mark.parametrize("rate", ["goldens", "goldens_fs48"])
def test_streaming_matches_jax(rate):
    """The same float64 exact feed (7 frames per push, 64-sample buffers)
    through world_tpu's StreamingSynthesizer and the port's."""
    g = Goldens(os.path.join(HERE, rate))
    f0, sp, ap = params(g)

    def run(s):
        out = []
        for i in range(0, len(f0), 7):
            assert s.add_parameters(f0[i: i + 7], sp[i: i + 7],
                                    ap[i: i + 7])
            while s.synthesis2():
                out.append(s.buffer[:64].copy())
        s.close()
        return np.concatenate(out)

    want = run(jax_realtime.StreamingSynthesizer(
        g.scalar("fs"), 5.0, g.scalar("fft_size"), 64, 100))
    got = run(synth(g, 100))
    assert got.shape == want.shape
    assert snr_nonzero(want, got) > 200.0


def test_fast_mode_independent_of_render_grouping(gold):
    """Fast-mode noise is a function of each pulse's reference alone, so
    lookahead 8 (many small renders, some as rows) and 256 (few spans)
    give the same audio."""
    outs = []
    for lookahead in (8, 256):
        out, s = run_chunked(gold, 5, rng_mode="fast",
                             lookahead_pulses=lookahead)
        outs.append((out, s.renders))
    assert outs[0][1] > outs[1][1]
    assert snr_nonzero(outs[1][0], outs[0][0]) > 200.0
    refs = torch.arange(1, 5, dtype=torch.int64)
    a = realtime.fast_noise(3, refs, 1024, torch.float64)
    b = realtime.fast_noise(3, refs[2:], 1024, torch.float64)
    assert torch.equal(a[2:], b)
    assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1.0) < 0.1


def test_response_cache_stays_bounded(gold):
    """A long stream of repeated frames keeps the response cache bounded,
    and landed span markers of pulses the stream has passed are dropped
    when the cache is pruned (the JAX package keeps them forever)."""
    f0, sp, ap = params(gold)
    lo, hi = 40, 60          # a voiced stretch, fed over and over
    s = synth(gold, 100, rng_mode="fast", lookahead_pulses=16)
    limit = 4 * max(s.lookahead_pulses, 64)
    sizes = []
    for rep in range(60):
        assert s.add_parameters(f0[lo:hi], sp[lo:hi], ap[lo:hi])
        while s.synthesis2():
            sizes.append(len(s._resp_cache))
        if rep == 30:
            # Stale landed markers, as a rewound stream would leave them.
            for k in range(2 * limit):
                s._resp_cache[("stale", k)] = ("span", k)
    assert s.synthesized_sample > 60 * 20 * 110 * 0.9
    assert max(sizes) <= limit + s.lookahead_pulses
    assert not any(k[0] == "stale" for k in s._resp_cache)
    s.close()


def test_close_and_context_manager(gold):
    """close() releases each chunk's device rows; a closed synthesizer
    streams on, uploading rows again when a render needs them."""
    f0, sp, ap = params(gold, np.float32)
    with synth(gold, 100, dtype=np.float32, rng_mode="none") as s:
        assert s.add_parameters(f0[:8], sp[:8], ap[:8])
        assert s.chunks[0].params is not None
        assert s.synthesis2()
    assert all(c.params is None for c in s.chunks.values())
    assert s.add_parameters(f0[8:40], sp[8:40], ap[8:40])
    assert s.synthesis2()
    s.close()


def test_device_selection(gold, monkeypatch):
    """The GPU unless device is given; with no GPU and no device given it
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingSynthesizer(22050, 5.0, 1024, 64, 10)
    assert synth(gold, 10).device == torch.device("cpu")


def test_constructor_matches_jax():
    """The JAX package's arguments and defaults, less param_ring_rows,
    plus device."""
    mine = inspect.signature(StreamingSynthesizer).parameters
    theirs = inspect.signature(
        jax_realtime.StreamingSynthesizer).parameters
    assert set(mine) == (set(theirs) - {"param_ring_rows"}) | {"device"}
    for name, p in theirs.items():
        if name in mine:
            assert mine[name].default == p.default, name
