"""The port's tracing (world_tpu_torch/device.py) on the CPU.

With tracing off (the default) a torch.profiler run over a golden-row
step and a short analyze_long holds no range of the program and no
record_function is made; with it on the same run holds the spans
``step``, ``upload``, ``download`` and ``longform.*`` and the stages, each
sync range inside its step.  The host syncs of one Harvest+Synthesis
step and one Dio+StoneMask+codec step, counted by site, equal a fixed
table whether tracing is on or off, and the outputs are the same either
way.  A stream at the streaming cell's settings makes no range and no
record_function with tracing off, and with it on holds ``stream.add`` and
``stream.synthesis2`` around each call, ``stream.render`` and
``stream.absorb`` inside them and the DC remover's sync inside a render.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from world_tpu_torch import device  # noqa: E402
from world_tpu_torch.models.realtime import StreamingSynthesizer  # noqa: E402
from world_tpu_torch.parallel.longform import analyze_long  # noqa: E402
from world_tpu_torch.parallel.pipeline import make_batch_step  # noqa: E402

X = np.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "goldens", "x.f64")).astype(np.float32)
CPU = torch.device("cpu")

# Host syncs of one step by site.  On the card harvest.sections is 1: the
# card runs FixStep3 as a kernel (ops/contour.harvest_fix_step3), and its
# plain version, which the CPU runs, finds the sections again.
EXPECTED = {
    "harvest": {"harvest.boundaries": 1, "zerocross.valids": 1,
                "harvest.sections": 2, "harvest.positions": 1,
                "d4c.n_pass": 1, "d4c.passing": 5, "synthesis.pulses": 1,
                "synthesis.dc_remover": 1},
    "dio": {"dio.lowcut": 1, "dio.positions": 1, "dio.boundaries": 1,
            "zerocross.valids": 1, "d4c.n_pass": 1, "d4c.passing": 5,
            "codec.perm": 1, "codec.weights": 2},
}
STEPS = {
    "harvest": dict(f0_method="harvest"),
    "dio": dict(f0_method="dio", codec_dims=40, with_synthesis=False),
}


def host_ranges(prof, prefixes):
    """[(name, start, end)] of a profile's host ranges whose names start
    with one of ``prefixes``, in ns of the profiler's clock."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefixes)]


def within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def run_paths(on):
    """Both steps on the golden row (upload, step, download) and a short
    chunked analysis, profiled with the program's tracing ``on``.
    Returns (the program's ranges, the test's own, sync counts by path,
    outputs by path)."""
    steps = {k: make_batch_step(22050, len(X), device=CPU, **kw)
             for k, kw in STEPS.items()}
    counts, outs = {}, {}
    was = device.set_tracing(on)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for k, step in steps.items():
                before = dict(device.sync.counts)
                x = device.upload(X[None], torch.float32, CPU)
                out = [t for t in step(x) if t is not None]
                outs[k], _ = device.download(out, CPU)
                counts[k] = {s: n - before.get(s, 0)
                             for s, n in device.sync.counts.items()
                             if n != before.get(s, 0)}
            with torch.profiler.record_function("test:analyze_long"):
                outs["long"] = analyze_long(
                    np.tile(X, 2), 22050, chunk_seconds=0.5,
                    halo_seconds=0.1, f0_method="dio", batch_lanes=2,
                    device=CPU)
    finally:
        device.set_tracing(was)
    return (host_ranges(prof, ("span:", "stage:")),
            host_ranges(prof, "test:"), counts, outs)


@pytest.fixture(scope="module")
def runs():
    return {on: run_paths(on) for on in (False, True)}


def test_the_switch():
    assert device.tracing() is False
    assert device.set_tracing(True) is False
    try:
        assert device.tracing() is True
        assert device.span("x") is not device.span("x")
    finally:
        assert device.set_tracing(False) is True
    assert device.span("x") is device.span("y")      # the shared no-op


def test_off_leaves_no_range_of_the_program(runs):
    ranges, call, _, _ = runs[False]
    assert call and ranges == []


def test_off_makes_no_record_function(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    x = 0.4 * np.sin(2 * np.pi * 150.0 * np.arange(4000) / 8000.0)
    step = make_batch_step(8000, 4000, f0_method="dio", codec_dims=20,
                           device=CPU)
    xb = device.upload(x[None], torch.float32, CPU)
    device.download([step(xb)[0]], CPU)
    with device.StageClock(None, CPU)("stage"):
        pass
    assert analyze_long(np.tile(x, 2), 8000, chunk_seconds=0.5,
                        halo_seconds=0.1, f0_method="dio",
                        device=CPU)[1].shape == (201,)


def test_on_holds_the_spans_nested(runs):
    ranges, call, _, _ = runs[True]
    names = {r[0] for r in ranges}
    assert {"span:step", "span:upload", "span:download", "stage:harvest",
            "stage:dio", "stage:d4c", "stage:codec",
            "stage:synthesis"} <= names
    steps = [r for r in ranges if r[0] == "span:step"]
    assert len(steps) == 2 + 2        # the two steps, long-form's two batches
    for r in ranges:
        if r[0].startswith(("span:sync.", "stage:")):
            assert any(within(r, s) for s in steps), r
    for part in ("chunk", "collect", "stitch"):
        mine = [r for r in ranges if r[0] == "span:longform." + part]
        assert mine and all(within(r, call[0]) for r in mine), part
    assert sum(within(s, call[0]) for s in steps) == 2


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("path", sorted(EXPECTED))
def test_sync_counts_by_site(runs, path, on):
    assert runs[on][2][path] == EXPECTED[path]


def test_outputs_equal_on_and_off(runs):
    off, on = runs[False][3], runs[True][3]
    for k in STEPS:
        assert all(torch.equal(a, b) for a, b in zip(off[k], on[k]))
    assert all(np.array_equal(a, b) for a, b in zip(off["long"], on["long"]))


def stream(gold):
    """40 golden frames pushed one at a time into a streaming synthesizer
    at the streaming cell's settings, every buffer drained, then closed:
    the buffers."""
    f0, sp, ap = (gold[k].astype(np.float32)
                  for k in ("harvest_f0", "cheaptrick_sp", "d4c_ap"))
    s = StreamingSynthesizer(22050, 5.0, 1024, 64, 100, rng_mode="fast",
                             dtype=np.float32, hold_on_miss=True,
                             dispatch_min_pulses=2, hold_force_ms=8.0,
                             device=CPU)
    out = []
    for i in range(40):
        assert s.add_parameters(f0[i:i + 1], sp[i:i + 1], ap[i:i + 1])
        while s.synthesis2():
            out.append(s.buffer[:64].copy())
    s.close()
    return np.asarray(out)


def profiled_stream(gold, on):
    was = device.set_tracing(on)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = stream(gold)
    finally:
        device.set_tracing(was)
    return host_ranges(prof, ("span:", "stage:")), out


def test_stream_off_leaves_no_range_and_no_record_function(gold,
                                                           monkeypatch):
    ranges, out = profiled_stream(gold, False)
    assert ranges == [] and len(out) > 20

    def refused(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert np.array_equal(stream(gold), out)


def test_stream_on_holds_its_spans_nested(gold):
    ranges, out = profiled_stream(gold, True)
    names = [r[0] for r in ranges]
    calls = [r for r in ranges
             if r[0] in ("span:stream.add", "span:stream.synthesis2")]
    for part in ("render", "absorb"):
        mine = [r for r in ranges if r[0] == "span:stream." + part]
        assert mine and all(any(within(r, c) for c in calls)
                            for r in mine), part
    (dc,) = [r for r in ranges if r[0] == "span:sync.stream.dc"]
    assert any(within(dc, r) for r in ranges
               if r[0] == "span:stream.render")
    assert names.count("span:stream.add") == 40
    assert names.count("span:stream.synthesis2") > len(out)
    assert np.array_equal(profiled_stream(gold, False)[1], out)


def test_stage_clock_times_with_a_dict():
    timings = {}
    clock = device.StageClock(timings, CPU)
    with clock("outer"):
        with clock("inner"):
            pass
    assert set(timings) == {"outer", "inner"}
    assert timings["outer"] >= timings["inner"] >= 0.0
