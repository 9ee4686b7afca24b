"""What a traffic kind hands back: the requests of the measured window,
each with its answer and its timings, read by the metric readers and the
comparison whatever kind made them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .gc_clock import GcClock


@dataclass
class Request:
    pool: int  # the pool entry of its queries
    sent_at: float  # perf_counter() when it was sent
    submit_s: float  # host seconds inside query_batch ... collect_async
    latency_s: float
    indices: List[int]
    scores: List[float]
    total_chunks: int
    evaluated_chunks: int
    merge_s: float
    certified: Optional[bool]


@dataclass
class Window:
    requests: List[Request]
    queries: int
    seconds: float
    started: float = 0.0  # perf_counter() at its start
    gc: GcClock = field(default_factory=GcClock)

    def qps_by_second(self, batch: int) -> List[float]:
        """Queries sent in each whole second of the window, for the log."""
        counts = [0] * max(1, int(self.seconds))
        for r in self.requests:
            i = int(r.sent_at - self.started)
            if i < len(counts):
                counts[i] += batch
        return [float(c) for c in counts]
