"""The trace's reduction over one card and over several, on made-up events."""

from types import SimpleNamespace

import pytest

from benchmark import trace


class Event:
    def __init__(self, start, end, name, kind, card=0, annotation=False):
        self._e = (start, end, name, kind, card, annotation)

    def start_ns(self):
        return self._e[0]

    def end_ns(self):
        return self._e[1]

    def name(self):
        return self._e[2]

    def device_type(self):
        return SimpleNamespace(name=self._e[3])

    def device_index(self):
        return self._e[4]

    def is_user_annotation(self):
        return self._e[5]


def profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


# a 100 ns window; card 0 busy 10-40 and 30-50 (union 40 ns), card 1 busy 60-80
EVENTS = [
    Event(0, 100, trace.WINDOW_SPAN, "CPU"),
    Event(0, 55, "bench.submit", "CPU"),
    Event(55, 100, "bench.finish", "CPU"),
    Event(60, 90, "aten::mul", "CPU"),
    Event(10, 40, "scan_kernel", "CUDA", 0),
    Event(30, 50, "copy", "CUDA", 0),
    Event(60, 80, "scan_kernel", "CUDA", 1),
    Event(20, 90, "bench.submit", "CUDA", 0, annotation=True),
]


def test_one_card_is_one_timeline():
    got = trace.reduce(profile(EVENTS), [0])
    assert got.window_s == pytest.approx(100e-9)
    assert got.busy_s == pytest.approx(60e-9)  # 10-50 and 60-80, every event on one line
    assert got.op_s == pytest.approx({"scan_kernel": 50e-9, "copy": 20e-9})
    assert got.card_busy_s == {} and not any(k.startswith("cuda:") for k in got.gaps_s)
    # each gap goes to what ran at its middle: 0-10, 50-60 and 80-100
    assert got.gaps_s == pytest.approx({"bench.submit": 10e-9, "bench.finish": 10e-9,
                                        "bench.finish/aten::mul": 20e-9})
    assert trace.reduce(profile(EVENTS)).busy_s == got.busy_s


def test_several_cards_keep_their_busy_time_and_name_their_gaps():
    got = trace.reduce(profile(EVENTS), [0, 1])
    assert got.card_busy_s == pytest.approx({"cuda:0": 40e-9, "cuda:1": 20e-9})
    assert got.busy_s == pytest.approx(30e-9)  # the mean: idle is each card's share, averaged
    assert got.op_s == pytest.approx({"scan_kernel": 50e-9, "copy": 20e-9})  # summed over cards
    assert got.gaps_s == pytest.approx({  # card 0: 0-10, 50-100; card 1: 0-60, 80-100
        "cuda:0 bench.submit": 10e-9, "cuda:0 bench.finish/aten::mul": 50e-9,
        "cuda:1 bench.submit": 60e-9, "cuda:1 bench.finish/aten::mul": 20e-9})
    idle = 100.0 * (1.0 - got.busy_s / got.window_s)
    assert idle == pytest.approx(100.0 * ((1 - 0.4) + (1 - 0.2)) / 2)


def test_a_card_with_no_operation_counts_as_idle():
    got = trace.reduce(profile(EVENTS), [0, 1, 2])
    assert got.card_busy_s["cuda:2"] == 0.0
    assert got.busy_s == pytest.approx(20e-9)
