"""The reader ``stream_graphed_share`` (rtsynth_22k.stream) on made-up
counter snapshots: the share of the traced renders replayed from a
graph, and None on a program whose counter has no "graphed" key."""

import pytest

from portbench import run


class Ctx:
    def __init__(self, captured=None):
        self.trace, self.captured = None, captured or {}


def share(snaps):
    return run.reader("stream_graphed_share").read(
        Ctx({"stream_counts.graphed": snaps}))


def test_the_share_of_the_traced_renders():
    snaps = [{"renders": 5, "graphed": 3, "pulses": 10},
             {"renders": 45, "graphed": 41, "pulses": 90},
             {"renders": 60, "graphed": 41, "pulses": 120}]
    assert share(snaps) == pytest.approx(95.0)
    assert share([{"renders": 0, "graphed": 0},
                  {"renders": 8, "graphed": 8}]) == 100.0


def test_none_without_the_counter_or_the_renders():
    assert share([{"renders": 5, "pulses": 10},
                  {"renders": 9, "pulses": 20}]) is None
    assert share([{"renders": 5, "graphed": 5},
                  {"renders": 5, "graphed": 5}]) is None
    assert share([{"renders": 5, "graphed": 5}]) is None
    assert run.reader("stream_graphed_share").read(Ctx()) is None

