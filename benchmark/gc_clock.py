"""Host time in Python's cyclic garbage collector (a copy of
``chip_smoke.py``'s ``GcClock``)."""

from __future__ import annotations

import gc
import time


class GcClock:
    """The collections of each generation and their milliseconds while the
    clock is entered, read from ``gc.callbacks``."""

    def __init__(self):
        self.ms = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t0 = None

    def _hook(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms[info["generation"]] += (time.perf_counter() - self._t0) * 1e3
            self.count[info["generation"]] += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._hook)

    def __str__(self):
        return (f"gc {sum(self.count)} collections ({self.count[2]} full), "
                f"{sum(self.ms):.1f} ms ({self.ms[2]:.1f} full)")
