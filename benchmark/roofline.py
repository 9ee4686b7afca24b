"""The least time of a scan's work on one H100, counted from shapes.

A frozen copy of ``chip_smoke.py``'s ``scan_bound`` count (K1 / K1-bf16:
each live row read once with its 12 bytes of side data, each query once with
its 8, and the bin maxima written once; ``2 b d`` operations a live row),
with NVIDIA's published peaks of the H100 SXM part (dense, no sparsity).
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES_S = 3.35e12  # HBM3
PEAKS = {"bf16": 989e12}  # operations a second, dense: bf16 queries against int8 or bf16 rows
BIN = 512  # rows a bin maximum covers


def scan_bound(live_rows: int, b: int, d: int, row_bytes: int, row_side_bytes: int,
               query_bytes: int, query_side_bytes: int, peak: str
               ) -> Tuple[float, str, float, float]:
    """-> (least seconds, "bytes" or "operations", bytes, operations) of one
    scan of ``b`` queries over ``live_rows`` rows of depth ``d``."""
    bins = live_rows / BIN
    bytes_moved = (live_rows * (d * row_bytes + row_side_bytes)
                   + b * (d * query_bytes + query_side_bytes) + bins * b * 4)
    ops = 2.0 * b * d * live_rows
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, ops / PEAKS[peak]
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), bytes_moved, ops


def for_config(config: dict, live_rows: int, b: int) -> Tuple[float, str, float, float]:
    """``scan_bound`` with the row, side-data and peak sizes that the
    configuration's ``roofline`` entry states."""
    r = config["roofline"]
    return scan_bound(live_rows, b, int(config["dim"]), int(r["row_bytes"]),
                      int(r["row_side_bytes"]), int(r["query_bytes"]),
                      int(r["query_side_bytes"]), r["peak"])
