"""The readers of the program's own spans and sync counters
(metrics/_program.py and its five readers) on synthetic traces and
counter snapshots: nesting, the cutoff, no range to read, and the hook
that turns the program's tracing on and off with the profiler."""

import pytest

from portbench import run, trace

READ = {n: run.reader(n) for n in (
    "host_syncs_per_step", "step_sync_ms", "launches_per_step",
    "host_state_ms", "host_state_idle_ms")}


class Ctx:
    def __init__(self, trace_=None, captured=None, tracer=None):
        self.trace, self.captured, self.tracer = trace_, captured or {}, \
            tracer


def batch_trace():
    """Two traced steps (0-100, 200-300 us) and a third opened after the
    cutoff (250 us: the second one opened before it); sync ranges in
    each, a long-form wait outside them."""
    ranges = [("span:dispatch", 0.0, 110.0), ("span:step", 0.0, 100.0),
              ("span:sync.d4c.n_pass", 10.0, 40.0),
              ("stage:d4c", 5.0, 60.0),
              ("span:sync.d4c.passing", 50.0, 55.0),
              ("span:step", 200.0, 300.0),
              ("span:sync.d4c.n_pass", 210.0, 230.0),
              ("span:sync.longform.wait", 120.0, 190.0),
              ("span:step", 400.0, 500.0),
              ("span:sync.d4c.n_pass", 410.0, 490.0)]
    device = [("k1", 20.0, 30.0, 1.0), ("k2", 30.0, 40.0, 99.0),
              ("Memcpy HtoD", 41.0, 42.0, 50.0),
              ("Memset (Device)", 42.0, 43.0, 60.0),
              ("k3", 220.0, 240.0, 205.0), ("k4", 250.0, 260.0, 150.0),
              ("k5", 420.0, 430.0, 410.0), ("k6", 500.0, 510.0, None)]
    return trace.Trace(device, sorted(ranges, key=lambda r: r[1]),
                       (0.0, 320.0), 250.0, 2)


def test_step_sync_ms_is_the_median_over_owned_steps():
    # step 1: 30 + 5 us of syncs; step 2: 20; the third is past the cutoff
    # and the wait lies outside every step.
    got = READ["step_sync_ms"].read(Ctx(batch_trace()))
    assert got == pytest.approx((35.0 + 20.0) / 2 / 1e3)


def test_launches_per_step_counts_kernels_inside_owned_steps():
    # k1, k2 and k3 were launched inside the two owned steps; the copy and
    # the set are not kernels, k4 was launched between steps, k5 in the
    # step past the cutoff.
    assert READ["launches_per_step"].read(Ctx(batch_trace())) == 1.5


def test_host_syncs_per_step_counts_step_sites_between_on_and_off():
    snaps = [{"d4c.n_pass": 10, "longform.wait": 3},
             {"d4c.n_pass": 12, "d4c.passing": 10, "longform.wait": 9,
              "harvest.boundaries": 2},
             {"d4c.n_pass": 40}]
    got = READ["host_syncs_per_step"].read(
        Ctx(batch_trace(), {"sync_counts": snaps}))
    assert got == (2 + 10 + 2) / 2


def long_trace():
    """One long-form request: chunking, three steps with a collect after
    each result, the concatenation and the stitching; the card busy only
    while the steps run."""
    ranges = [("span:analyze_long", 0.0, 1000.0),
              ("span:longform.chunk", 0.0, 50.0),
              ("span:step", 50.0, 200.0), ("span:step", 200.0, 350.0),
              ("span:sync.longform.wait", 350.0, 500.0),
              ("span:longform.collect", 500.0, 510.0),
              ("span:step", 510.0, 600.0),
              ("span:longform.collect", 700.0, 800.0),
              ("span:longform.stitch", 800.0, 1000.0)]
    device = [("k", 60.0, 520.0, 55.0), ("k", 530.0, 650.0, 515.0)]
    return trace.Trace(device, ranges, (0.0, 1000.0), None, 1)


def test_host_state_ms_and_its_idle_share():
    t = long_trace()
    assert READ["host_state_ms"].read(Ctx(t)) == pytest.approx(
        (50 + 10 + 100 + 200) / 1e3)
    # idle: 0-60, 520-530, 650-1000; inside the host state: 50 (chunk),
    # 0 (the first collect), 100 + 200 (the second and the stitch).
    assert READ["host_state_idle_ms"].read(Ctx(t)) == pytest.approx(
        (50 + 100 + 200) / 1e3)


@pytest.mark.parametrize("name", sorted(READ))
def test_nothing_to_read_is_none(name):
    assert READ[name].read(Ctx()) is None
    empty = trace.Trace([("k", 0.0, 1.0, 0.5)], [("span:dispatch", 0.0,
                                                   2.0)], (0.0, 2.0), None, 1)
    assert READ[name].read(Ctx(empty, {"sync_counts": [{}, {}]})) is None
    # A batch trace has no host state; a long-form one has its steps.
    assert (READ[name].read(Ctx(batch_trace())) is None) == (
        name.startswith("host_state") or name == "host_syncs_per_step")


class Profile:
    def __init__(self):
        self.stopped = False

    def stop(self):
        self.stopped = True


class Tracer:
    def __init__(self):
        self.hooks, self.prof = [], Profile()


def test_install_turns_the_program_tracing_on_and_off_with_the_profiler():
    from world_tpu_torch import device

    tracer = Tracer()
    ctx = Ctx(tracer=tracer)
    for name in sorted(READ):
        READ[name].install(ctx)
    assert tracer.hooks and not device.tracing()
    try:
        before = dict(device.sync.counts)
        for hook in tracer.hooks:
            hook(True)
        assert device.tracing()
        with device.sync("test.site"):
            pass
        for hook in tracer.hooks:       # the cutoff: still on
            hook(False)
        assert device.tracing()
        for hook in tracer.hooks:       # the last traced request's end
            hook(False)
        tracer.prof.stop()
        assert tracer.prof.stopped and not device.tracing()
    finally:
        device.set_tracing(False)
        device.sync.counts["test.site"] -= 1
    snaps = ctx.captured["sync_counts"]
    assert snaps[0] == before and snaps[1]["test.site"] == \
        before.get("test.site", 0) + 1


def test_install_on_a_program_without_tracing_hooks_nothing(monkeypatch):
    from world_tpu_torch import device

    monkeypatch.delattr(device, "set_tracing")
    tracer = Tracer()
    for name in sorted(READ):
        READ[name].install(Ctx(tracer=tracer))
    assert tracer.hooks == []
