"""Utility helpers (profiling)."""

from .profiling import trace

__all__ = ["trace"]
