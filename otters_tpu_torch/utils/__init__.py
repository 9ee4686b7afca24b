"""Utility helpers (profiling: the trace and the query path's spans)."""

from .profiling import count, dropped, enabled, records, span, summary, trace

__all__ = ["count", "dropped", "enabled", "records", "span", "summary", "trace"]
