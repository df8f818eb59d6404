"""The streaming cell (rtsynth_22k.stream) on the CPU: its files in the
contract's form, a tiny run of its driver (correct; a listener that
loses or swaps a buffer not), ``buffers_off`` on a reference stream, the
control not correct, and the cell's three readers on a synthetic trace
and counter snapshots."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import check, check_stream, control, run, trace
from portbench.reference import realtime as ref

PB = Path(__file__).resolve().parents[1]
BENCH = json.loads((PB.parent / "BENCHMARK.json").read_text())
CELL = "rtsynth_22k.stream"


def tiny():
    """The cell at a size a test run holds: 4 lanes, a pool of 4
    utterances of 0.4-0.7 s in one bucket, 10 warm-up buffers a lane."""
    cell = json.loads((PB / "workloads" / f"{CELL}.json").read_text())
    cell["traffic"].update(lanes=4, utterances=4, length_s=[0.4, 0.7],
                           buckets_s=[0.75], batch=4, warm_buffers=10)
    cell["trace"].update(skip=5, requests=20)
    return cell


def test_the_cells_files():
    entry = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    config = json.loads((PB / "configs" / "rtsynth_22k.json").read_text())
    cell = json.loads((PB / "workloads" / f"{CELL}.json").read_text())
    assert entry["config"] == cell["config"] == "rtsynth_22k"
    assert entry["chips"] == 1 and config["reduced"] == []
    assert (config["buffer_size"], config["number_of_pointers"],
            config["frames_per_push"]) == (64, 100, 1)
    assert {"streams", "hold", "loop", "frames", "utterances"} \
        <= set(config["assumed"])
    assert cell["traffic"]["lanes"] == 32 \
        and cell["trace"]["requests"] >= cell["traffic"]["lanes"]
    assert cell["check"]["limits"]["buffers_off"] == 0
    mine = {m["name"] for m in BENCH["per_layer"]
            if CELL in m.get("workloads", [CELL])}
    assert mine == {"device_idle_share", "stream_launches_per_render",
                    "stream_pulses_per_render", "stream_host_ms_per_buffer"}


@pytest.mark.parametrize("fault", [None, "drop", "swap"])
def test_a_sound_run_is_correct_and_the_faults_are_not(fault):
    res, lines, _ = run.run_cell(CELL, 2 ** 31 + 99, 0.7, False,
                                 device="cpu", fault=fault, cell=tiny())
    nums = {k: v for k, v, _ in lines}
    assert res["correct"] == (fault is None)
    assert (nums["buffers_off"] > 0) == (fault is not None)
    assert res["attempted"] > 100 and res["metrics"]["rtf"]["value"] > 0
    assert list(res)[-1] == "check"


def test_the_control_is_not_correct():
    cell = tiny()
    out = control.readings(CELL, 2 ** 33 + 1, 0.5, True, device="cpu",
                           cell=cell)
    limits = cell["check"]["limits"]
    assert check.verdict(out["program"], limits)[0]
    assert not check.verdict(out["control"], limits)[0]
    # In order, only imprecise.
    assert out["control"]["buffers_off"] == 0


def reference_buffers():
    n = 80
    t = np.arange(n)
    f0 = 120.0 + 30.0 * np.sin(t / 9.0)
    f0[30:42] = 0.0
    k = np.arange(513)
    sp = np.tile(1e-2 / (1.0 + k / 40.0) ** 2, (n, 1)) \
        * (1.0 + 0.5 * np.sin(t / 5.0))[:, None]
    ap = np.tile(np.clip(k / 513.0, 0.01, 0.99), (n, 1))
    y, m = ref.stream(f0, sp, ap, 22050, 5.0, 1024, 64)
    return y, m


def test_buffers_off_counts_order_not_precision():
    y, n = reference_buffers()
    bufs = y.reshape(n, 64)

    def off(b, finished=True, j0=0):
        return check_stream.buffers_off(b, j0, finished, y, n)

    assert n > 60 and off(bufs) == 0 and off(bufs[20:], j0=20) == 0
    assert off(bufs[:40], finished=False) == 0
    assert off(np.delete(bufs, 10, 0)) > 0
    assert off(np.delete(bufs, 10, 0)[:30], finished=False) > 0
    swapped = bufs.copy()
    swapped[[10, 11]] = swapped[[11, 10]]
    assert off(swapped) == 2
    assert off(np.insert(bufs, 10, bufs[10], 0)) > 0
    rng = np.random.default_rng(0)
    assert off(bufs * (1.0 + 1e-2 * rng.standard_normal(bufs.shape))) == 0
    nums = check_stream.judge_lane([(bufs, 0, True, y, n)], 22050)
    assert nums["buffers_off"] == 0 and nums["y_err_db_median"] < -200


class Ctx:
    def __init__(self, trace_=None, captured=None):
        self.trace, self.captured = trace_, captured or {}


def stream_trace():
    """Two synthesis2 calls and an add: renders at 12-20 and 41-45 us."""
    ranges = [("span:stream.add", 0.0, 10.0),
              ("span:stream.synthesis2", 10.0, 30.0),
              ("span:stream.render", 12.0, 20.0),
              ("span:stream.absorb", 22.0, 25.0),
              ("span:stream.synthesis2", 40.0, 50.0),
              ("span:stream.render", 41.0, 45.0)]
    device = [("k1", 21.0, 22.0, 13.0), ("k2", 22.0, 23.0, 14.0),
              ("Memcpy HtoD", 23.0, 24.0, 15.0), ("k3", 50.0, 51.0, 42.0),
              ("k4", 52.0, 53.0, 35.0), ("k5", 54.0, 55.0, None)]
    return trace.Trace(device, ranges, (0.0, 60.0), None, 2)


def test_the_readers():
    read = {n: run.reader(n).read for n in (
        "stream_launches_per_render", "stream_pulses_per_render",
        "stream_host_ms_per_buffer")}
    t = stream_trace()
    assert read["stream_launches_per_render"](Ctx(t)) == 1.5
    assert read["stream_host_ms_per_buffer"](Ctx(t)) \
        == pytest.approx(40.0 / 2 / 1e3)
    snaps = [{"renders": 5, "pulses": 10}, {"renders": 9, "pulses": 20},
             {"renders": 12, "pulses": 40}]
    assert read["stream_pulses_per_render"](
        Ctx(captured={"stream_counts": snaps})) == 2.5
    # A program without the spans or the counter (an older checkout).
    bare = trace.Trace(t.device, [], t.span, None, 2)
    for name, r in read.items():
        assert r(Ctx()) is None and r(Ctx(bare)) is None, name
