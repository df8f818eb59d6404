"""The metric arithmetic on synthetic inputs."""

import math

import numpy as np
import pytest
import torch

from portbench import run, trace, work

READ = {n: run.reader(n) for n in (
    "rtf", "latency_ms_p95", "peak_device_gib", "setup_s",
    "step_host_ms_p50", "device_idle_share", "stage_device_ms.d4c",
    "harvest_refine_roofline")}


class Ctx:
    def __init__(self, window=None, trace_=None, captured=None):
        self.window, self.trace = window, trace_
        self.captured = captured or {}
        self.setup_s = 12.5


def window():
    # (t_dispatch, t_done, audio_s, step_ms): every request dispatched in
    # the window, the last finished after its end
    reqs = [(0.0, 0.5, 100.0, 40.0), (0.2, 1.0, 50.0, 60.0),
            (0.9, 2.5, 80.0, 50.0), (9.8, 10.4, 70.0, 10.0)]
    return {"requests": reqs, "t0": 0.0, "t1": 10.0,
            "peak_bytes": 3 * 2 ** 30}


def test_rtf_is_all_the_work_over_all_the_window():
    assert READ["rtf"].read(Ctx(window())) == pytest.approx(300.0 / 10.4)
    # A stall at the window's end still counts: the time runs to t1 at
    # least.
    w = window()
    w["requests"] = w["requests"][:3]
    assert READ["rtf"].read(Ctx(w)) == pytest.approx(230.0 / 10.0)
    w["requests"] = []
    assert READ["rtf"].read(Ctx(w)) is None


def test_p95_over_all_requests_of_the_window():
    lat = [500.0, 800.0, 1600.0, 600.0]
    assert READ["latency_ms_p95"].read(Ctx(window())) == \
        pytest.approx(np.percentile(lat, 95))


def test_host_and_memory_readers():
    c = Ctx(window())
    assert READ["peak_device_gib"].read(c) == 3.0
    assert READ["setup_s"].read(c) == 12.5
    assert READ["step_host_ms_p50"].read(c) == 45.0  # of 40, 60, 50, 10


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (6.5, 6.8), (9.0, 12.0)]
    assert trace.union_us(iv, 0.0, 10.0) == pytest.approx(2 + 1 + 1 + 1)
    assert trace.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                        (7.0, 9.0)]


def fake_trace():
    # Two traced requests, each with a d4c range; a third request's range
    # opens after the cutoff and does not count.
    device = [("k1", 10.0, 14.0, 1.0), ("k2", 13.0, 20.0, 2.0),
              ("k3", 30.0, 31.0, 21.0), ("k4", 40.0, 45.0, 31.0),
              ("Memcpy HtoD", 50.0, 52.0, None)]
    ranges = [("stage:d4c", 0.5, 2.5), ("span:dispatch", 0.0, 3.0),
              ("stage:d4c", 20.0, 22.0), ("stage:d4c", 30.0, 32.0)]
    return trace.Trace(device, ranges, (0.0, 60.0), 25.0, 2)


def test_idle_share_is_one_minus_the_union():
    t = fake_trace()
    busy = 10 + 1 + 5 + 2
    assert READ["device_idle_share"].read(Ctx(trace_=t)) == \
        pytest.approx(100 * (1 - busy / 60.0))


def test_stage_ms_per_request_of_what_its_ranges_launched():
    t = fake_trace()
    assert READ["stage_device_ms.d4c"].read(Ctx(trace_=t)) == \
        pytest.approx((4 + 7 + 1) / 2 / 1e3)
    assert READ["stage_device_ms.d4c"].read(Ctx()) is None


def test_refine_roofline_on_a_hand_counted_case():
    fs, hw_max = 4000.0, 80
    cands = torch.zeros((1, 2, 3))
    cands[0, 0, 0], cands[0, 1, 2], cands[0, 1, 1] = 100.0, 200.0, 60.0
    y, pos = torch.zeros((1, 500)), torch.zeros(2)
    # hw = int(1.5 fs / f0 + 1), at most hw_max: 61, 31 and 80 (101 cut)
    terms = (61 + 1) + (31 + 1) + (80 + 1)
    table = 2 << (2 + int(math.floor(math.log2(2 * hw_max + 1))))
    nbytes = 4 * (500 + 2 + 3 * 6 + table) + 16 * 6
    assert work.harvest_refine(y, pos, cands, fs, 71.0, 800.0, hw_max) == \
        (nbytes, 80 * terms)
    least = max(nbytes / 3.35e12, 80 * terms / 67e12)
    ranges = [("stage:harvest.refine", 0.0, 5.0)]
    device = [("refine_kernel", 10.0, 10.0 + 2.0, 1.0)]
    t = trace.Trace(device, ranges, (0.0, 20.0), None, 1)
    args = (y, pos, cands, fs, 71.0, 800.0, hw_max)
    got = READ["harvest_refine_roofline"].read(
        Ctx(trace_=t, captured={"harvest_refine": [args]}))
    assert got == pytest.approx(100 * least / 2e-6)
    assert READ["harvest_refine_roofline"].read(Ctx(trace_=t)) is None


class Event:
    def __init__(self, name, dev, start, dur, corr, annotation=False):
        self._v = (name, dev, start, dur, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_from_kineto_links_kernels_to_their_launch():
    ev = [Event("span:traced", "DeviceType.CPU", 0, 100_000, 0),
          Event("stage:d4c", "DeviceType.CPU", 1_000, 5_000, 0),
          Event("cudaLaunchKernel", "DeviceType.CPU", 2_000, 100, 7),
          Event("d4c_kernel", "DeviceType.CUDA", 9_000, 4_000, 7),
          Event("stage:d4c", "DeviceType.CUDA", 9_000, 4_000, 0, True),
          Event("span:cutoff", "DeviceType.CPU", 50_000, 1, 0),
          Event("orphan", "DeviceType.CUDA", 60_000, 1_000, 99)]
    t = trace.from_kineto(ev, 1)
    assert t.span == (0.0, 100.0) and t.cutoff == 50.0
    assert t.device == [("d4c_kernel", 9.0, 13.0, 2.0),
                        ("orphan", 60.0, 61.0, None)]
    assert t.device_us("stage:d4c") == pytest.approx(4.0)


def test_launch_check_and_breakdown():
    t = trace.Trace([("void refine_kernel<float>", 1.0, 3.0, 0.5),
                     ("void refine_kernel<float>", 4.0, 5.0, None)],
                    [("span:wait_outputs", 3.0, 10.0),
                     ("stage:d4c", 0.0, 2.0)], (0.0, 10.0), None, 1)
    got = trace.launch_check({"refine.harvest_refine": 3},
                             {"refine.harvest_refine": 5}, t)
    assert got == {"refine_kernel": [2, 1]}
    b = run.breakdown(t)
    assert b["device_ops"][0] == ["void refine_kernel<float>", 3e-6]
    assert b["idle_gaps"] == [["wait_outputs", 5e-6], ["host/d4c", 1e-6],
                              ["wait_outputs", 1e-6]]
