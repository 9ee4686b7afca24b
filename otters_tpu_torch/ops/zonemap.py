"""On-device zonemap construction (segmented min/max/non-null per chunk).

Replaces the reference's host-side zonemap fold (``src/meta_compute.rs:
32-132``): column values land on the device once (they are needed there for
row-mask predicates anyway) and the per-chunk statistics are reductions over
a ``[n_chunks, chunk]`` view, one pass per column.

Semantics match the JAX package's zonemaps exactly:
- null rows never contribute (min fold fill = +max, max fold fill = -min);
- float folds also skip NaN *values*; an all-null/NaN chunk reports
  (min=+inf, max=-inf) and ``non_null`` counts only non-null rows;
- 64-bit columns stay 64-bit: the device has int64 and float64, so they fold
  and compare natively instead of as the JAX package's (hi, lo) 32-bit
  pairs. Float64 values are canonicalised (-0.0 -> +0.0) as the JAX
  package's ordered-integer mapping does.
- Float32 values flush subnormals to zero of the same sign, as the JAX
  package's f32 compares do (XLA flushes them on the CPU and the TPU);
  literals compared against a Float32 column flush the same way
  (:func:`flush_subnormal_f32`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_I32 = np.iinfo(np.int32)
_I64 = np.iinfo(np.int64)
_F32_TINY = float(np.finfo(np.float32).tiny)


def flush_subnormal_f32(x):
    """+-subnormal Float32 values -> +-0 (a tensor, or one Python float);
    every other value, NaN included, is kept."""
    if isinstance(x, torch.Tensor):
        return torch.where(x.abs() < _F32_TINY, x * 0.0, x)
    return math.copysign(0.0, x) if abs(x) < _F32_TINY else x


def _chunk_view(x, excl_fill, *, c: int, n_chunks: int):
    """Pad [n] -> [n_chunks * c] with excl_fill and reshape to [n_chunks, c]."""
    length = n_chunks * c
    n = x.shape[0]
    if length != n:
        x = torch.cat([x, x.new_full((length - n,), excl_fill)])
    return x.reshape(n_chunks, c)


def _pad_rows(x, n_pad: int, fill):
    n = x.shape[0]
    if n_pad == n:
        return x
    return torch.cat([x, x.new_full((n_pad - n,), fill)])


def _non_null(nulls, *, c: int, n_chunks: int):
    nn = _chunk_view(~nulls, False, c=c, n_chunks=n_chunks)
    return nn.sum(dim=1, dtype=torch.int32)


def _fold(vals, excl, lo_fill, hi_fill, *, c: int, n_chunks: int):
    lo = torch.where(excl, vals.new_full((), lo_fill), vals)
    hi = torch.where(excl, vals.new_full((), hi_fill), vals)
    zmin = _chunk_view(lo, lo_fill, c=c, n_chunks=n_chunks).amin(dim=1)
    zmax = _chunk_view(hi, hi_fill, c=c, n_chunks=n_chunks).amax(dim=1)
    return zmin, zmax


def _build_int(vals, nulls, info, *, c: int, n_chunks: int, n_pad: int):
    zmin, zmax = _fold(
        vals, nulls, int(info.max), int(info.min), c=c, n_chunks=n_chunks
    )
    return {
        "vals": _pad_rows(vals, n_pad, int(info.min)),
        "null": _pad_rows(nulls, n_pad, True),
        "zmin": zmin,
        "zmax": zmax,
        "non_null": _non_null(nulls, c=c, n_chunks=n_chunks),
    }


def _build_float(vals, nulls, *, c: int, n_chunks: int, n_pad: int):
    # the null sentinel is NaN; real NaN values are skipped by the fold too,
    # exactly like np.fmin/np.fmax (reference meta_compute.rs:84-98)
    excl = nulls | torch.isnan(vals)
    zmin, zmax = _fold(
        vals, excl, float("inf"), float("-inf"), c=c, n_chunks=n_chunks
    )
    return {
        "vals": _pad_rows(vals, n_pad, float("nan")),
        "null": _pad_rows(nulls, n_pad, True),
        "zmin": zmin,
        "zmax": zmax,
        "non_null": _non_null(nulls, c=c, n_chunks=n_chunks),
    }


def build_i32(vals, nulls, *, c: int, n_chunks: int, n_pad: int):
    """Int32 / Bool (as 0/1) zonemaps; ``vals`` int32, ``nulls`` bool."""
    return _build_int(vals, nulls, _I32, c=c, n_chunks=n_chunks, n_pad=n_pad)


def build_i64(vals, nulls, *, c: int, n_chunks: int, n_pad: int):
    """Int64 / DateTime zonemaps over native int64 values."""
    return _build_int(vals, nulls, _I64, c=c, n_chunks=n_chunks, n_pad=n_pad)


def build_f32(vals, nulls, *, c: int, n_chunks: int, n_pad: int):
    """Float32 zonemaps over values with subnormals flushed to +-0."""
    return _build_float(flush_subnormal_f32(vals), nulls, c=c, n_chunks=n_chunks,
                        n_pad=n_pad)


def build_f64(vals, nulls, *, c: int, n_chunks: int, n_pad: int):
    """Float64 zonemaps over native float64 values (-0.0 canonicalised)."""
    return _build_float(vals + 0.0, nulls, c=c, n_chunks=n_chunks, n_pad=n_pad)


def build_str_rows(rh, nulls, *, c: int, n_chunks: int, n_pad: int):
    """String row state: padded int64 identity hashes + per-chunk non-null.

    (The Bloom bit matrix itself is built from host-side string hashes —
    strings never live on the device; see ops/bloom.py.)"""
    return {
        "rh": _pad_rows(torch.where(nulls, torch.zeros_like(rh), rh), n_pad, 0),
        "null": _pad_rows(nulls, n_pad, True),
        "non_null": _non_null(nulls, c=c, n_chunks=n_chunks),
    }
