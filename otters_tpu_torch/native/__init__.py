"""Native (C++) host kernels, loaded via ctypes: string hashing, the Bloom
build and the extended string scans (substring / prefix / suffix over a
packed UTF-8 arena, bounded Levenshtein).

Compiles ``otters_native.cpp`` on first use with g++ (-O3 -fopenmp) into
``aot.cache_dir()`` (by default ``build/otters_tpu_torch/`` beside the
package), where a later process finds it (``aot.stats``: a build counts as
one of ``compiles``, a library found there as one of ``disk_hits``).
Every entry point returns None without the library (or without its symbol),
and its caller's pure-Python path takes over (ops/hashing.py, ops/bloom.py,
ops/strscan.py, ops/strmatch.py), so a missing compiler only costs host
speed, never correctness. Hash
outputs are bit-for-bit identical to the Python implementation. This is host
code only: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import aot

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "otters_native.cpp")
_LIB_NAME = f"otters_native_{sys.implementation.cache_tag}.so"

_lib = None
_tried = False


def _compile(out_path: str) -> bool:
    # build under a private name and rename into place: concurrent test
    # workers never load a half-written library
    tmp = f"{out_path}.{os.getpid()}.tmp"
    cmds = [
        ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
         _SRC, "-o", tmp],
        ["g++", "-O3", "-fPIC", "-shared", _SRC, "-o", tmp],
        ["cc", "-O3", "-fPIC", "-shared", "-x", "c++", _SRC, "-o", tmp,
         "-lstdc++"],
    ]
    for cmd in cmds:
        try:
            r = subprocess.run(
                cmd, capture_output=True, timeout=120, check=False
            )
            if r.returncode == 0 and os.path.exists(tmp):
                os.replace(tmp, out_path)
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    candidates = [os.path.join(aot.cache_dir(), _LIB_NAME)]

    def _fresh(p: str) -> bool:  # stale .so (older than the source) is rebuilt
        try:
            return os.path.getmtime(p) >= os.path.getmtime(_SRC)
        except OSError:
            return False

    path = next((p for p in candidates if os.path.exists(p) and _fresh(p)), None)
    if path is not None:
        aot.stats["disk_hits"] += 1
    else:
        for p in candidates:
            if _compile(p):
                aot.stats["compiles"] += 1
                path = p
                break
    if path is None:  # no compiler: fall back to any existing (stale) build
        path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.otters_hash_strings.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.otters_hash_strings.restype = None
    lib.otters_bloom_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.otters_bloom_build.restype = None
    try:
        lib.otters_fuzzy_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.otters_fuzzy_mask.restype = None
    except AttributeError:
        pass  # a stale library from before the fuzzy kernel existed
    try:
        lib.otters_substr_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.otters_substr_mask.restype = None
    except AttributeError:
        pass  # a stale library from before the substring kernel existed
    _lib = lib
    return _lib


def pack_utf8_arena(strings: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """[data uint8, offsets int64]: the contiguous UTF-8 arena layout shared
    by the native kernels and the .npz string persistence format."""
    encoded = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    data = (
        np.frombuffer(b"".join(encoded), dtype=np.uint8)
        if encoded
        else np.zeros(0, np.uint8)
    )
    return np.ascontiguousarray(data), offsets


def available() -> bool:
    return _load() is not None


def hash_strings(strings: Sequence[str]) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Bulk stable 64-bit hashing; None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(strings)
    data, offsets = pack_utf8_arena(strings)
    g1 = np.empty(n, dtype=np.uint64)
    g2 = np.empty(n, dtype=np.uint64)
    lib.otters_hash_strings(
        data.ctypes.data, offsets.ctypes.data, n, g1.ctypes.data, g2.ctypes.data
    )
    return g1, g2


def bloom_build(
    g1: np.ndarray,
    g2: np.ndarray,
    nulls: np.ndarray,
    chunk_size: int,
    n_rows: int,
    n_chunks: int,
    words: int,
    bits: int,
    k: int,
) -> Optional[np.ndarray]:
    """Bloom bit matrix for chunk-contiguous rows; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    starts = np.minimum(
        np.arange(n_chunks + 1, dtype=np.int64) * chunk_size, n_rows
    )
    g1 = np.ascontiguousarray(g1, dtype=np.uint64)
    g2 = np.ascontiguousarray(g2, dtype=np.uint64)
    nulls8 = np.ascontiguousarray(nulls, dtype=np.uint8)
    matrix = np.zeros(n_chunks * words, dtype=np.uint32)
    lib.otters_bloom_build(
        g1.ctypes.data, g2.ctypes.data, nulls8.ctypes.data, starts.ctypes.data,
        n_chunks, words, bits, k, matrix.ctypes.data,
    )
    return matrix.reshape(n_chunks, words)


_SUBSTR_MODES = {"contains": 0, "starts_with": 1, "ends_with": 2}


def substr_mask_arena(data: np.ndarray, offsets: np.ndarray, pattern: str, mode: str):
    """uint8[n] substring / prefix / suffix mask over a packed UTF-8 arena
    (``pack_utf8_arena`` layout); None if the library lacks the kernel.

    The semantics are Python's ``pattern in s`` / ``s.startswith`` /
    ``s.endswith`` on the same strings (a byte compare is exact for
    whole-pattern UTF-8 matching). Nulls are the caller's to mask."""
    lib = _load()
    if lib is None or not hasattr(lib, "otters_substr_mask"):
        return None
    n = len(offsets) - 1
    pat = np.frombuffer(pattern.encode("utf-8"), dtype=np.uint8)
    plen = len(pat)
    pat = np.ascontiguousarray(pat) if plen else np.zeros(1, np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if not len(data):
        data = np.zeros(1, np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.zeros(n, dtype=np.uint8)
    lib.otters_substr_mask(
        data.ctypes.data, offsets.ctypes.data, n,
        pat.ctypes.data, plen, _SUBSTR_MODES[mode], out.ctypes.data,
    )
    return out


def fuzzy_mask(strings: Sequence[str], pattern: str, max_dist: int):
    """uint8[n] bounded-Levenshtein mask over UTF-8 bytes; None if the
    library lacks the kernel. ``max_dist`` is clamped to the kernel's band
    (16)."""
    max_dist = min(int(max_dist), 16)
    lib = _load()
    if lib is None or not hasattr(lib, "otters_fuzzy_mask"):
        return None
    n = len(strings)
    data, offsets = pack_utf8_arena(strings)
    pat_b = pattern.encode("utf-8")
    pat = np.frombuffer(pat_b, dtype=np.uint8)
    pat = np.ascontiguousarray(pat) if len(pat) else np.zeros(1, np.uint8)
    out = np.zeros(n, dtype=np.uint8)
    lib.otters_fuzzy_mask(
        data.ctypes.data, offsets.ctypes.data, n,
        pat.ctypes.data, len(pat_b), int(max_dist), out.ctypes.data,
    )
    return out
