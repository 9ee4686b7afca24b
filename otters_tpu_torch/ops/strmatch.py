"""Fuzzy string matching: bounded Levenshtein over UTF-8 bytes.

The reference roadmap lists "fuzzy matching" among the string-filter
extensions. `col("name").fuzzy(pattern, max_dist)` keeps rows whose edit
distance to the pattern is <= max_dist. Distances are computed over UTF-8
BYTES (a multi-byte character counts per byte), identically in the native
C++ kernel (otters_native.cpp) and this pure-Python path.

Like contains/starts_with/ends_with, evaluation is host-side (strings never
live on the device) through the hostmask leaf: one pass per distinct
(column, pattern, max_dist), cached on the store, with an exact per-chunk
any() so zonemap-style pruning still applies.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

MAX_DIST_CAP = 16  # native kernel band cap


def bounded_levenshtein(a: bytes, b: bytes, k: int) -> bool:
    """True iff editdistance(a, b) <= k (banded DP, O(len * (2k+1)))."""
    la, lb = len(a), len(b)
    if abs(la - lb) > k:
        return False
    if k == 0:
        return a == b
    big = 1 << 30
    w = 2 * k + 1
    prev = [(c - k) if 0 <= (c - k) <= lb else big for c in range(w)]
    for r in range(1, la + 1):
        cur = [big] * w
        alive = False
        for c in range(w):
            j = r + c - k
            if j < 0 or j > lb:
                continue
            if j == 0:
                best = r
            else:
                best = big
                d = prev[c]
                if d < big:
                    best = d + (0 if a[r - 1] == b[j - 1] else 1)
                if c > 0 and cur[c - 1] + 1 < best:
                    best = cur[c - 1] + 1
            if c + 1 < w and prev[c + 1] + 1 < best:
                best = prev[c + 1] + 1
            cur[c] = best
            if best <= k:
                alive = True
        prev = cur
        if not alive:
            return False
    fc = lb - la + k
    return 0 <= fc < w and prev[fc] <= k


def fuzzy_mask(
    strings: Sequence[str], nulls: np.ndarray, pattern: str, max_dist: int
) -> np.ndarray:
    """bool[n]: edit distance(strings[i], pattern) <= max_dist, nulls False.

    Uses the native C++ kernel when available; byte-identical fallback here.
    """
    k = min(int(max_dist), MAX_DIST_CAP)
    n = len(strings)
    from .. import native

    out = native.fuzzy_mask(strings, pattern, k)
    if out is None:
        pat = pattern.encode("utf-8")
        out = np.fromiter(
            (bounded_levenshtein(s.encode("utf-8"), pat, k) for s in strings),
            bool,
            count=n,
        )
    out = np.asarray(out, dtype=bool)
    out[np.asarray(nulls, dtype=bool)[:n]] = False
    return out
