"""Profiling integration.

The reference's observability contract is host wall-clock phase timers
surfaced in stats tables; the port keeps those (``MetaBuildStats`` /
``MetaQueryStats``) and adds optional tracing through ``torch.profiler``:
host operators and, on a CUDA device, kernel times, in a Chrome trace.

While a profiler records, the query path also names its own parts:
``span(name)`` is an event of the profiler's trace (on the timeline of the
device's kernels, as a ``record_function`` is) and a record in an
in-memory ring, and ``count(name, n)`` a counted value there;
``records()`` and ``summary()`` read them. With no profiler running a span
is one read of the flag the profiler sets and nothing more.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# the profiler's event of a span: ``record_function``'s, made in C++ (about
# 2 us a span where ``record_function`` takes 10-15 us, and no Python handle
# for the garbage collector to walk)
_RecordFunction = torch._C._profiler._RecordFunctionFast

RING_SIZE = 1 << 20  # records kept; older ones are dropped and counted

_NOTHING = contextlib.nullcontext()  # the span of an unprofiled run, shared


class Record(NamedTuple):
    """One span (``value`` None) or one count, on ``time.perf_counter()``'s
    clock. ``parent`` is the ``id`` of the span open around it, ``request``
    the id of the query it belongs to (a tuple of ids for a group), inherited
    from the parent span where the span names none."""

    name: str
    id: int
    parent: Optional[int]
    request: object
    start: float
    end: float
    value: Optional[float] = None


class SpanLog:
    """The ring of records and the spans open on each thread. The ring holds
    plain tuples, which the garbage collector stops tracking, so a long
    traced run does not make its collections walk every record."""

    def __init__(self, size: int = RING_SIZE):
        self.ring: deque = deque(maxlen=size)
        self.dropped = 0
        self.ids = itertools.count()
        self.local = threading.local()

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, rec: tuple) -> None:
        if len(self.ring) == self.ring.maxlen:
            self.dropped += 1
        self.ring.append(rec)

    def clear(self) -> None:
        self.ring.clear()
        self.dropped = 0


_LOG = SpanLog()


def enabled() -> bool:
    """True while a ``torch.profiler`` profile records (the flag it sets)."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "request", "id", "parent", "start", "event")

    def __init__(self, name: str, request):
        self.name = name
        self.request = request

    def __enter__(self):
        # the interval holds the span's own cost, so its parent's self time
        # holds none of it
        self.start = time.perf_counter()
        log = _LOG
        stack = log.open_spans()
        if stack:
            self.parent = stack[-1].id
            if self.request is None:
                self.request = stack[-1].request
        else:
            self.parent = None
        self.id = next(log.ids)
        self.event = (_RecordFunction(self.name) if self.request is None
                      else _RecordFunction(self.name, (str(self.request),)))
        self.event.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.event.__exit__(*exc)
        log = _LOG
        log.open_spans().pop()
        log.add((self.name, self.id, self.parent, self.request, self.start,
                 time.perf_counter(), None))
        return False


def span(name: str, request=None):
    """A context manager naming a part of the work. While a profiler
    records: a profiler event (the request id in its inputs) and a record
    of its name, parent span, request and interval. Otherwise one shared
    no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOTHING
    return _Span(name, request)


def count(name: str, n: float = 1) -> None:
    """While a profiler records, a record of ``n`` under ``name`` at this
    time, in the span open around it."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    log = _LOG
    stack = log.open_spans()
    top = stack[-1] if stack else None
    t = time.perf_counter()
    log.add((name, next(log.ids), None if top is None else top.id,
             None if top is None else top.request, t, t, n))


def records() -> List[Record]:
    """The records kept, oldest first (a span is kept when it ends)."""
    return [Record._make(r) for r in _LOG.ring]


def dropped() -> int:
    """Records dropped from the ring since it was last cleared."""
    return _LOG.dropped


def summary() -> Dict[str, Dict[str, float]]:
    """By name: a span's ``count``, ``total_ms`` and ``self_ms`` (its
    duration less its child spans'), a counter's ``count`` and ``value``
    (the sum of its values)."""
    recs = records()
    children: Dict[int, float] = {}
    for r in recs:
        if r.value is None and r.parent is not None:
            children[r.parent] = children.get(r.parent, 0.0) + (r.end - r.start)
    out: Dict[str, Dict[str, float]] = {}
    for r in recs:
        if r.value is None:
            e = out.setdefault(r.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            ms = 1e3 * (r.end - r.start)
            e["total_ms"] += ms
            e["self_ms"] += ms - 1e3 * children.get(r.id, 0.0)
        else:
            e = out.setdefault(r.name, {"count": 0, "value": 0.0})
            e["value"] += r.value
        e["count"] += 1
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed queries into ``log_dir``.

    >>> with otters_tpu_torch.utils.trace("otters-trace"):
    ...     store.query(q, Metric.Cosine).take(10).collect()

    Records CPU activity, and CUDA activity where a device is present, and
    writes ``trace_<pid>_<ms>.json`` (Chrome trace format: chrome://tracing
    or Perfetto) when the block ends. Yields the profiler, whose
    ``key_averages()`` sums time by operator and kernel. The span records
    are cleared on entry, so ``summary()`` afterwards covers this block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _LOG.clear()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))
