"""The traced run: device operations and host spans from ``torch.profiler``,
reduced to what the per-layer readers and the ``breakdown`` need.

A card's busy time is the union of its device operations' intervals
(kernels, copies and sets), so overlapping operations are not counted
twice; ``busy_s`` is the mean over the cell's cards, so that
``1 - busy_s / window_s`` is the mean of each card's idle share. An idle gap
is a stretch of the window in which no device operation ran on a card; it
is named by the harness span and the innermost host operation running at
its middle, and by its card where the cell has more than one. ``op_s`` sums
each operation's device seconds over every card. With one card (or none:
the CPU) every device operation lies on one timeline.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

WINDOW_SPAN = "bench.window"
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # of a kernel's name in the breakdown


def _short(name: str) -> str:
    return name.removeprefix("void ")[:NAME_CHARS]


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float  # the mean over the cards of the union of each one's device operations
    op_s: Dict[str, float]  # device seconds by operation name (summed durations, all cards)
    gaps_s: Dict[str, float] = field(default_factory=dict)  # idle seconds by host activity
    card_busy_s: Dict[str, float] = field(default_factory=dict)  # by card, several only

    def sum_s(self, pattern: str = "") -> float:
        return sum(s for name, s in self.op_s.items() if pattern in name)

    def kernel_s(self, pattern: str):
        """Device seconds of the operations whose names hold ``pattern``, or
        None where no device operation was traced (a run on the CPU). On a
        device trace, none that matches is a fault and raises: a renamed
        kernel would otherwise leave its work unseen."""
        if self.busy_s <= 0:
            return None
        found = self.sum_s(pattern)
        if found <= 0:
            raise RuntimeError(f"no device operation in the trace is named like {pattern!r}; "
                               f"the busiest: {self.breakdown()['device_ops'][:3]}")
        return found

    def breakdown(self) -> Dict[str, List[list]]:
        def top(d):
            return [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(self.op_s), "idle_gaps": top(self.gaps_s)}


def _events(prof) -> Tuple[list, list]:
    """-> (device [(start_ns, end_ns, name, card index)], host [(start_ns,
    end_ns, name)]), from the profiler's raw events (a harness span's
    annotation on the device timeline is no device operation)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns(), e.end_ns(), e.name())
        kind = e.device_type().name
        if kind == "CUDA":
            if not (e.is_user_annotation() or item[2].startswith("bench.")):
                dev.append(item + (e.device_index(),))
        elif kind == "CPU":
            host.append(item)
    return dev, host


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _labels(bench, ops, points: List[float]) -> List[str]:
    """For each of the sorted ``points``: the harness span around it and the
    innermost host operation running then (one sweep over the operations,
    sorted by start, with a stack of the open ones)."""
    bench_starts = [b[0] for b in bench]
    out, stack, j = [], [], 0
    for t in points:
        while j < len(ops) and ops[j][0] <= t:
            s, e, name = ops[j]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            j += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        i = bisect.bisect_right(bench_starts, t) - 1
        span = bench[i][2] if i >= 0 and bench[i][1] >= t else "outside"
        out.append(f"{span}/{stack[-1][1]}" if stack else span)
    return out


def _gaps(busy, w0: float, w1: float) -> List[Tuple[float, float]]:
    edges = [(w0, w0)] + busy + [(w1, w1)]
    return [(prev_end, nxt_start) for (_, prev_end), (nxt_start, _) in zip(edges, edges[1:])
            if nxt_start > prev_end]


def reduce(prof, cards: Sequence[int] = ()) -> DeviceTrace:
    """``cards``: the CUDA indices of the cell's cards (at most one: every
    device operation on one timeline)."""
    dev, host = _events(prof)
    window = [(s, e) for s, e, name in host if name == WINDOW_SPAN]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = window[0]
    several = len(cards) > 1
    op_s: Dict[str, float] = defaultdict(float)
    spans: Dict[int, list] = {c: [] for c in cards} if several else {None: []}
    for s, e, name, card in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            op_s[name] += (e - s) / 1e9
            if several and card in spans:
                spans[card].append((s, e))
            elif not several:
                spans[None].append((s, e))
    busy = {c: _union(iv) for c, iv in spans.items()}
    bench = sorted(h for h in host if h[2].startswith("bench.") and h[2] != WINDOW_SPAN)
    ops = sorted((h for h in host if not h[2].startswith("bench.")), key=lambda h: (h[0], -h[1]))
    gaps = sorted((s, e, c) for c, b in busy.items() for s, e in _gaps(b, w0, w1))
    gaps_s: Dict[str, float] = defaultdict(float)
    for (s, e, c), label in zip(gaps, _labels(bench, ops, [(s + e) / 2 for s, e, _ in gaps])):
        gaps_s[f"cuda:{c} {label}" if several else label] += (e - s) / 1e9
    card_busy = {c: sum(e - s for s, e in b) / 1e9 for c, b in busy.items()}
    return DeviceTrace(window_s=(w1 - w0) / 1e9,
                       busy_s=sum(card_busy.values()) / len(card_busy),
                       op_s=dict(op_s), gaps_s=dict(gaps_s),
                       card_busy_s={f"cuda:{c}": v for c, v in card_busy.items()} if several
                       else {})
