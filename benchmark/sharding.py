"""The sharding layer's spans and counter (``parallel/meta_sharded.py``), a
request, from the program's records in a traced run. A run whose program
records none of the name asked for (a single store, or a program without
them) gives no value."""

from __future__ import annotations

from typing import Optional

from benchmark import program_spans


def _recorded(rec, name: str) -> bool:
    recs = program_spans._window_records(rec)
    return bool(recs) and any(r.name == name for r in recs)


def ms_per_request(rec, name: str) -> Optional[float]:
    """Host ms a request in the spans ``name`` under ``otters.submit``."""
    if not _recorded(rec, name):
        return None
    return program_spans.ms_per_request(rec, [name], root="otters.submit")


def count_per_request(rec, name: str) -> Optional[float]:
    """The values counted under ``name``, summed, a request."""
    if not _recorded(rec, name):
        return None
    return program_spans.count_per_request(rec, name)
