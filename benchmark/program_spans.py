"""Per-request numbers from the program's own spans and counters
(``otters_tpu_torch.utils.profiling``), which it records while a profiler
runs: the records that lie inside the traced window (``rec.window``, on the
same ``time.perf_counter`` clock), over the window's requests.

An untraced run, or a program that records no spans, gives no value.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


def _window_records(rec) -> Optional[List]:
    if rec.trace is None:
        return None
    from otters_tpu_torch.utils import profiling

    read = getattr(profiling, "records", None)
    if read is None:
        return None
    t0 = rec.window.started
    t1 = t0 + rec.window.seconds
    return [r for r in read() if t0 <= r.start and r.end <= t1]


def ms_per_request(rec, names: Iterable[str], root: Optional[str] = None) -> Optional[float]:
    """Milliseconds a request in the spans named ``names``: each span counted
    once (none inside another of ``names``), and with ``root`` only the
    spans whose outermost span is named ``root``."""
    recs = _window_records(rec)
    if recs is None:
        return None
    names = set(names)
    by_id = {r.id: r for r in recs}
    total = 0.0
    for r in recs:
        if r.value is not None or r.name not in names:
            continue
        outer, nested = r, False
        while outer.parent in by_id:
            outer = by_id[outer.parent]
            nested = nested or outer.name in names
        if not nested and (root is None or outer.name == root):
            total += r.end - r.start
    return 1e3 * total / len(rec.window.requests)


def count_per_request(rec, name: str) -> Optional[float]:
    """The values counted under ``name``, summed, a request."""
    recs = _window_records(rec)
    if recs is None:
        return None
    return sum(r.value for r in recs if r.value is not None and r.name == name) / len(
        rec.window.requests)
