"""Extended string predicates: contains / starts_with / ends_with.

The reference compares string rows in tight Rust loops
(meta_compute.rs:291-318). Strings never live on the device, so these
predicates evaluate on the host through the hostmask leaf (the store
caches a row mask and a per-chunk any() per literal, and the device program
reads them as tensors). This module makes that evaluation fast: the native
C++ kernel (otters_native.cpp, OpenMP over rows, memchr/memcmp inner loops)
over a packed UTF-8 arena, with a vectorized numpy path when the library
is missing (no per-row Python). Results equal the per-row Python semantics
(``pattern in s`` / ``s.startswith`` / ``s.endswith``) bit for bit.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

MODES = ("contains", "starts_with", "ends_with")


def substr_mask(
    data: np.ndarray, offsets: np.ndarray, pattern: str, mode: str
) -> np.ndarray:
    """bool[n] over a packed UTF-8 arena (native.pack_utf8_arena layout).

    Byte-level matching is exact for whole-pattern UTF-8 substring/prefix/
    suffix tests. Null handling is the caller's job (mask after).
    """
    if mode not in MODES:
        raise ValueError(f"unknown substring mode {mode!r}")
    from .. import native

    out = native.substr_mask_arena(data, offsets, pattern, mode)
    if out is not None:
        return out.astype(bool, copy=False)
    return _substr_mask_numpy(data, offsets, pattern, mode)


_BYTES_CACHE: "OrderedDict[int, tuple]" = (
    OrderedDict()
)  # id(arena) -> (arena ref, bytes copy), LRU order
_BYTES_CACHE_CAP = 4  # each entry pins a full arena copy — keep few


def _arena_bytes(data: np.ndarray) -> bytes:
    """bytes view of the arena, cached per arena object: the fallback's
    C-speed ``bytes.find`` needs a bytes object, but re-copying a
    multi-hundred-MB arena per distinct literal would dwarf the search.
    LRU with single-entry eviction: evicting everything on overflow would
    drop the hot arena too, and a large cap would pin one arena copy (plus
    its strong arena ref) per rebuilt store for the process lifetime."""
    key = id(data)
    ent = _BYTES_CACHE.get(key)
    if ent is not None and ent[0] is data:
        _BYTES_CACHE.move_to_end(key)
        return ent[1]
    buf = data.tobytes()
    while len(_BYTES_CACHE) >= _BYTES_CACHE_CAP:
        _BYTES_CACHE.popitem(last=False)  # least-recently-used only
    _BYTES_CACHE[key] = (data, buf)
    return buf


def _substr_mask_numpy(
    data: np.ndarray, offsets: np.ndarray, pattern: str, mode: str
) -> np.ndarray:
    """Vectorized fallback: prefix/suffix via one [n, plen] gather+compare;
    contains via C-speed ``bytes.find`` over the whole arena (cost
    O(arena + matches)), mapping hit positions back to rows and rejecting
    matches that straddle a row boundary."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    pat = np.frombuffer(pattern.encode("utf-8"), dtype=np.uint8)
    plen = len(pat)
    if plen == 0:
        return np.ones(n, dtype=bool)
    lens = np.diff(offsets)
    ok = lens >= plen
    out = np.zeros(n, dtype=bool)
    if not ok.any():
        return out
    data = np.asarray(data, dtype=np.uint8)
    if mode in ("starts_with", "ends_with"):
        starts = offsets[:-1][ok] if mode == "starts_with" else (
            offsets[1:][ok] - plen
        )
        block = data[starts[:, None] + np.arange(plen, dtype=np.int64)]
        out[ok] = (block == pat[None, :]).all(axis=1)
        return out
    buf = _arena_bytes(data)
    pb = bytes(pat)
    pos = buf.find(pb)
    hits = []
    while pos != -1:
        hits.append(pos)
        pos = buf.find(pb, pos + 1)
    if hits:
        hp = np.asarray(hits, dtype=np.int64)
        rows = np.searchsorted(offsets, hp, side="right") - 1
        inside = hp + plen <= offsets[rows + 1]
        out[np.unique(rows[inside])] = True
    return out
