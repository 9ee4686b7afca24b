"""Stable 64-bit string hashing for device-side string predicates.

Devices cannot hold strings, so every string is hashed at ingest:
- a 64-bit identity hash (stored on device as one int64) lets
  row-level Eq/Neq predicates run on the device as one 64-bit compare
  (replacing the reference's exact host compares, meta_compute.rs:291-318;
  Eq hits among the returned top-k are re-verified host-side, keeping the
  exactness contract);
- a second independent 64-bit hash drives the Bloom filters' double hashing
  (replacing fastbloom, reference meta_compute.rs:100-115).

Hashes are FNV-1a 64 with a splitmix64 finalizer — stable across processes
and platforms (unlike Python's ``hash``). A C++ native path (the package's
native module) accelerates bulk hashing; this file is the portable fallback.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_MASK64 = (1 << 64) - 1
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def hash_string(s: str) -> Tuple[int, int]:
    """(g1, g2): two independent stable 64-bit hashes of the string."""
    x = fnv1a64(s.encode("utf-8"))
    g1 = _splitmix64(x)
    g2 = _splitmix64(x ^ 0xA5A5A5A5A5A5A5A5)
    # g2 must be odd so double-hashing probes cycle through all positions
    return g1, g2 | 1


def hash_strings(strings: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized hashing -> (g1 uint64 [n], g2 uint64 [n])."""
    from .. import native

    result = native.hash_strings(strings) if len(strings) > 64 else None
    if result is not None:
        return result
    n = len(strings)
    g1 = np.empty(n, dtype=np.uint64)
    g2 = np.empty(n, dtype=np.uint64)
    for i, s in enumerate(strings):
        a, b = hash_string(s)
        g1[i] = a
        g2[i] = b
    return g1, g2
