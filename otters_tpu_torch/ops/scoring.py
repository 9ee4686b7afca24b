"""Batched scoring + exact global top-k in torch (the slice's subset).

Counterpart of the JAX package's ``ops/scoring.py``: device storage (f32,
bfloat16 with its rounding residuals, int8 with its quantization), the
certificate's per-query / per-row terms for Cosine, Dot and Euclid, the
bf16x3 error bound, the plain scoring programs the query paths can fall
into (``direct`` for small stores, ``scan`` for wide k), the windowed
take-all collection (``collect_all``) and the VPU metrics (Manhattan,
Hamming, Jaccard: :func:`_vpu_scores`, the ``panel`` program and the
pruned scan :func:`scan_pruned_topk_core`). The ``panel`` mode of the
matmul metrics is served by the hand-written fused kernels
(``ops/fused_topk.py``).

Store precisions of f32 and bfloat16 storage (``prec``): "highest" and
"high" score in full f32 here (the fused path runs "high" as bf16x3);
"default" and "bf16" are one bf16 pass (:func:`one_pass_dots`), what a TPU
computes at ``Precision.DEFAULT``. int8 storage and the certified scans do
not read it.

Exactness: f32 matrix products run in full f32. On CUDA that needs TF32
off, which :func:`require_full_f32` checks (it never changes the global
setting behind the caller's back). Top-k selection breaks ties like
``lax.top_k`` (``torch.topk`` gives no tie order), and the hierarchical
form keeps the JAX package's candidate order.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..errors import OttersError
from ..types import VPU_METRICS, Cmp, Metric

# Rows are padded to a multiple of SCAN_TILE for large stores so the scan can
# walk [N, D] in whole tiles.
SCAN_TILE = 8192
# Largest flattened candidate count (B * N_pad) handled by the direct path.
# A module constant so tests can patch it (as for the JAX package).
DIRECT_LIMIT = 1 << 22
SMALL_PAD = 128
MID_PAD = 512
PANEL_BIN = 512
PANEL_SCORE_BYTES = 1 << 30  # the largest staged panel score block
PANEL_K_MAX = 1024
SCAN_K_MAX = DIRECT_LIMIT // 4
HIER_BIN = 512
# certificate bin width; must equal ops.fused_topk.BIN (asserted there)
CERT_BIN = 512

_NEG_INF = float("-inf")


# the store precisions; the one-pass ones score one bf16 pass
PRECISIONS = ("highest", "high", "default", "bf16")
ONE_PASS = ("default", "bf16")


def check_precision(prec: str) -> None:
    """Raise ``ValueError`` unless ``prec`` is a store precision."""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown store precision {prec!r}; expected one of {PRECISIONS}")


def require_full_f32(t: torch.Tensor) -> None:
    """Raise unless f32 matmuls on ``t``'s device run in full f32.

    The exact rerank and the certificate's rescore assume IEEE f32 products
    (JAX's Precision.HIGHEST); TF32 keeps ~10 mantissa bits and would void
    the certificate's arithmetic headroom."""
    if t.device.type != "cuda":
        return
    if torch.backends.cuda.matmul.allow_tf32 or (
        torch.get_float32_matmul_precision() != "highest"
    ):
        raise OttersError(
            "exact f32 scoring needs torch.backends.cuda.matmul.allow_tf32 "
            "= False and torch.get_float32_matmul_precision() == 'highest'"
        )


# the rows' depth in memory is padded to a multiple of this (the Hopper
# kernels' TMA strides and 16-element steps)
DEPTH_ALIGN = 16


def pad_depth(d: int) -> int:
    """The stored depth of rows of logical depth ``d``."""
    return -(-d // DEPTH_ALIGN) * DEPTH_ALIGN


def _depth_padded(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` [n, d] as the store keeps them: a [n, d] view of a
    contiguous [n, pad_depth(d)] buffer whose extra columns are zero. The
    shape stays the logical one; the row stride is the stored depth. A
    contiguous ``rows`` with d already aligned is returned as it is."""
    n, d = rows.shape
    dp = pad_depth(d)
    if dp == d and rows.is_contiguous():
        return rows
    buf = rows.new_zeros((n, dp))
    buf[:, :d] = rows
    return buf[:, :d]


def _padded_empty(n: int, d: int, dtype, device) -> torch.Tensor:
    """An all-zero [n, d] store buffer with its depth padded (see
    :func:`_depth_padded`), for ingest that writes rows in place."""
    return torch.zeros((n, pad_depth(d)), dtype=dtype, device=device)[:, :d]


class DeviceVecs(NamedTuple):
    """Device-resident vector store.

    vectors  : [N_pad, D] float32, bfloat16 or int8; a view whose row
               stride is D padded to a multiple of DEPTH_ALIGN (the padding
               columns are zero, so they change no dot, norm, int8 scale or
               residual; the kernels read the padded rows)
    norms_sq : [N_pad]    float32, squared L2 norms of the stored rows (0
               for padding)
    inv_norms: [N_pad]    float32, 1/||v|| with 0 for zero-norm rows
    valid    : [N_pad]    bool, False for padding rows

    int8 and bfloat16 stores additionally carry sound per-row residual
    bounds (the certified-exact machinery):

    resid    : [N_pad] f32 (0 on padding rows); int8: the UNIT residual
               >= ||v/||v|| - v8/||v8||||; bfloat16: the ABSOLUTE residual
               >= ||v - bf16(v)|| (see cert_row_lanes)
    resid_bin: [N_pad/512] f32, per-512-row-bin max of resid (None when
               N_pad is not 512-aligned)
    resid_max: [] f32 scalar, max over valid rows
    """

    vectors: torch.Tensor
    norms_sq: torch.Tensor
    inv_norms: torch.Tensor
    valid: torch.Tensor
    resid: Optional[torch.Tensor] = None
    resid_bin: Optional[torch.Tensor] = None
    resid_max: Optional[torch.Tensor] = None


def pad_rows(n: int) -> int:
    """Padded row count for a store of n vectors."""
    if n > DIRECT_LIMIT // 8:  # large store: align to the scan tile
        tile = SCAN_TILE
    elif n > 4096:
        tile = MID_PAD
    else:
        tile = SMALL_PAD
    return max(tile, -(-n // tile) * tile)


def _valid_mask(n_pad: int, n: int, device) -> torch.Tensor:
    return torch.arange(n_pad, device=device) < n


def materialize(vectors_np: np.ndarray, dtype=torch.float32, *, device) -> DeviceVecs:
    """Ship an [n, d] host array to the device with norms computed there."""
    n, d = vectors_np.shape
    n_pad = pad_rows(n)
    host = np.zeros((n_pad, d), dtype=np.float32)
    host[:n] = vectors_np
    vecs = torch.from_numpy(host).to(device)
    if dtype == torch.int8:
        return _int8_slabs(lambda s, r: vecs[s : s + r], n_pad, n_pad, n, d,
                           INGEST_SLAB_ROWS, vecs.device)
    if dtype == torch.bfloat16:
        return _materialize_bf16(vecs, n)
    if dtype != torch.float32:
        raise OttersError(f"unsupported storage dtype {dtype}")
    valid = _valid_mask(n_pad, n, device)
    norms_sq, inv_norms = _device_norms(vecs)
    return DeviceVecs(_depth_padded(vecs), norms_sq, inv_norms, valid)


# rows per slab of the bfloat16 and int8 ingest: its f32 temporaries stay
# near 1 GB at d = 768, where a whole-store one would double a 10M-row f32
# source
INGEST_SLAB_ROWS = 1 << 18


def _materialize_bf16(vecs_f32: torch.Tensor, n_valid: int,
                      slab_rows: int = INGEST_SLAB_ROWS, n_pad: Optional[int] = None,
                      order: Optional[torch.Tensor] = None) -> DeviceVecs:
    """bfloat16 storage with per-row ABSOLUTE rounding residuals attached:
    half the device memory of f32, and the certificate covers Cosine, Dot
    and Euclid on it. The codes, norms and residuals are computed slab by
    slab and written in place (rows are independent). ``n_pad`` (default:
    the rows' count) pads the store past the given rows with zero rows,
    which are never read. ``order`` (see :func:`materialize_from_device`)
    gathers each slab's rows."""
    n, d = vecs_f32.shape
    n_pad = n if n_pad is None else n_pad
    dev = vecs_f32.device
    vecs = _padded_empty(n_pad, d, torch.bfloat16, dev)
    norms_sq = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    inv = torch.zeros_like(norms_sq)
    resid = torch.zeros_like(norms_sq)
    for s in range(0, n, max(1, slab_rows)):
        e = min(n, s + slab_rows)
        x = (vecs_f32[s:e] if order is None else vecs_f32[order[s:e]]).float()
        vecs[s:e] = x.to(torch.bfloat16)
        norms_sq[s:e], inv[s:e] = _device_norms(vecs[s:e])
        resid[s:e] = bf16_abs_resid(x)
        del x
    valid = _valid_mask(n_pad, n_valid, dev)
    resid = torch.where(valid, resid, 0.0)
    rbin, rmax = finalize_resid(resid)
    return DeviceVecs(vecs, norms_sq, inv, valid, resid, rbin, rmax)


def _inv_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x != 0.0, 1.0 / x, 0.0)


def _device_norms(vecs: torch.Tensor):
    v32 = vecs.float()
    norms_sq = (v32 * v32).sum(dim=1)
    return norms_sq, _inv_or_zero(torch.sqrt(norms_sq))


def _quantize_rows_int8(vecs: torch.Tensor):
    amax = vecs.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    v8 = torch.clamp(torch.round(vecs / scale), -127, 127).to(torch.int8)
    v8f = v8.float()
    norms_sq = (v8f * v8f).sum(dim=1)
    return v8, norms_sq, _inv_or_zero(torch.sqrt(norms_sq))


def unit_resid(a32, b32, inv_a, inv_b):
    """Sound per-row bound on ||a/||a|| - b/||b|||| in f32 (see the JAX
    package's scoring.unit_resid for the error analysis). Zero-norm rows
    (either side) get 0: both score paths define their cosine as 0."""
    u = a32 * inv_a[:, None] - b32 * inv_b[:, None]
    r = torch.sqrt((u * u).sum(dim=1))
    zero = (inv_a == 0.0) | (inv_b == 0.0)
    return torch.where(zero, 0.0, r * (1.0 + 1e-4) + 1e-6)


def _quantize_rows_int8_resid(vecs: torch.Tensor):
    """Quantize + sound per-row residual bound (certified-exact int8)."""
    v8, norms_sq, inv8 = _quantize_rows_int8(vecs)
    v32 = vecs.float()
    nv = torch.sqrt((v32 * v32).sum(dim=1))
    resid = unit_resid(v32, v8.float(), _inv_or_zero(nv), inv8)
    return v8, norms_sq, inv8, resid


def bf16_query_unit_resid(queries: torch.Tensor) -> torch.Tensor:
    """[B] sound bounds on ||q/||q|| - qh/||qh|||| for qh = bf16(q).

    Queries that are nonzero in f32 but round to bf16 zero get the
    trivially sound bound 2.0."""
    q32 = queries.float()
    qh32 = q32.to(torch.bfloat16).float()
    inv_q = _inv_or_zero(torch.sqrt((q32 * q32).sum(dim=1)))
    inv_h = _inv_or_zero(torch.sqrt((qh32 * qh32).sum(dim=1)))
    r = unit_resid(q32, qh32, inv_q, inv_h)
    return torch.where((inv_q != 0.0) & (inv_h == 0.0), 2.0, r)


def finalize_resid(resid: torch.Tensor):
    """-> (resid_bin | None, resid_max) from a [N_pad] residual array."""
    n_pad = resid.shape[0]
    rmax = resid.max() if n_pad else resid.new_zeros(())
    rbin = None
    if n_pad and n_pad % CERT_BIN == 0:
        rbin = resid.reshape(-1, CERT_BIN).amax(dim=1)
    return rbin, rmax


def mixed_cert_eps(d: int) -> float:
    """Arithmetic headroom for the MIXED certified scan (bf16 queries x int8
    rows, f32 accumulation): gamma_d-class accumulation error of the scan
    and of the f32 rerank, plus a few ulps of the inverse-norm multiplies.
    The kernel's accumulation error is measured against it on the card."""
    return 4.0 * d * 2.0**-24 + 4.0e-6


def _resid_inflation(d: int) -> float:
    """1 + max(1e-4, 4 d 2^-24): covers the f32 sum of squares of a
    residual norm (gamma_d relative) with room to spare."""
    return 1.0 + max(1e-4, 4.0 * d * 2.0**-24)


def bf16_abs_resid(vecs_f32: torch.Tensor) -> torch.Tensor:
    """[N] sound per-row bounds on ||v - bf16(v)|| (ABSOLUTE residual).

    v - bf16(v) is exact in f32 per element (Sterbenz); the sum of squares
    accumulates gamma_d relative error, covered by the inflation. Rows that
    are exact in bf16 get a true 0."""
    v32 = vecs_f32.float()
    u = v32 - v32.to(torch.bfloat16).float()
    return torch.sqrt((u * u).sum(dim=1)) * _resid_inflation(v32.shape[1])


def bf16_query_abs(queries: torch.Tensor):
    """-> (qh32, e_qa[B], hq[B]): the bf16-rounded queries (as f32), a sound
    bound on ||q - qh|| per query and ||qh|| per query (inflated alike):
    the query side of the Dot / Euclid certificate coefficients."""
    q32 = queries.float()
    qh32 = q32.to(torch.bfloat16).float()
    u = q32 - qh32  # exact per element
    infl = _resid_inflation(q32.shape[1])
    e_qa = torch.sqrt((u * u).sum(dim=1)) * infl
    hq = torch.sqrt((qh32 * qh32).sum(dim=1)) * infl
    return qh32, e_qa, hq


def _cert_kd(d: int) -> float:
    """The f32 accumulation term 4 (d + 8) 2^-24 of the Dot / Euclid
    certificate (scan and rerank sides)."""
    return 4.0 * (d + 8) * 2.0**-24


def cert_query_coeffs(metric: Metric, queries: torch.Tensor, d: int):
    """Per-query coefficients of the certificate fold: every row's true
    score is within

        slack(q, row) = c0(q) + c1(q)*lane_a(row) + c2(q)*||v_row|| + lane_b(row)

    of its scan score (for Euclid a lower bound, folded in the negated key
    space). -> (qh32, c0[B], c1[B], c2[B]); see the JAX package for the
    derivations.

    Cosine  c0 = e_unit + eps_arith, c1 = 1, c2 = 0;
    Dot     c0 = 0, c1 = (hq + e_qa) m + kd hq, c2 = e_qa m + kd (hq + e_qa);
    Euclid  c0 = e_qa (2 hq + e_qa) m + kd hq^2, c1 and c2 doubled;
    with m = 1 + 1e-6 and kd = 4 (d + 8) 2^-24."""
    if metric is Metric.Cosine:
        e_q = bf16_query_unit_resid(queries)
        qh32 = queries.float().to(torch.bfloat16).float()
        c0 = e_q + mixed_cert_eps(d)
        return qh32, c0, torch.ones_like(c0), torch.zeros_like(c0)
    if metric not in (Metric.DotProduct, Metric.Euclidean):
        raise OttersError(f"certificate does not support metric {metric}")
    qh32, e_qa, hq = bf16_query_abs(queries)
    kd = _cert_kd(d)
    m = 1.0 + 1e-6
    c1 = (hq + e_qa) * m + kd * hq
    c2 = e_qa * m + kd * (hq + e_qa)
    if metric is Metric.DotProduct:
        return qh32, torch.zeros_like(hq), c1, c2
    c0 = (e_qa * (2.0 * hq + e_qa)) * m + kd * hq * hq
    return qh32, c0, 2.0 * c1, 2.0 * c2


def cert_row_lanes(metric: Metric, storage_dtype, resid, inv_norms, norms_sq, d: int):
    """-> (lane_a[N], lane_b[N]) per-row lanes of the certificate fold.

    ``resid`` is the stored per-row residual: the UNIT residual for int8
    storage (Cosine only), the ABSOLUTE residual ||v - bf16(v)|| for
    bfloat16 storage. Padding rows carry resid = 0 and norms_sq = 0, so
    both lanes vanish there."""
    if metric is Metric.Cosine:
        if storage_dtype == torch.int8:
            lane_a = resid  # already a unit residual
        else:
            # ||a/||a|| - b/||b|||| <= 2 ||a - b|| / max(||a||, ||b||)
            lane_a = 2.0 * resid * inv_norms * (1.0 + 1e-5)
        return lane_a, torch.zeros_like(lane_a)
    if metric is Metric.DotProduct:
        return resid, torch.zeros_like(resid)
    if metric is Metric.Euclidean:
        vn = torch.sqrt(norms_sq)
        lane_b = (2.0 * vn * resid + resid * resid) * (1.0 + 1e-6) + _cert_kd(d) * norms_sq
        return resid, lane_b
    raise OttersError(f"certificate does not support metric {metric}")


def cert_global_slack(c0, c1, c2, lane_a, lane_b, norms_sq, q_valid=None):
    """Scalar >= slack(q, row) over every valid (q, row) pair — loosens the
    score filter so no truly passing row is dropped on its scan score, and
    is the global term of the direct/scan certificates."""
    if q_valid is not None:
        c0 = torch.where(q_valid, c0, 0.0)
        c1 = torch.where(q_valid, c1, 0.0)
        c2 = torch.where(q_valid, c2, 0.0)
    vn_max = torch.sqrt(norms_sq.max())
    return (
        c0.max()
        + c1.max() * lane_a.max()
        + c2.max() * vn_max
        + lane_b.max()
    )


def materialize_from_device(vecs: torch.Tensor, n_valid: Optional[int] = None,
                            dtype=None, order: Optional[torch.Tensor] = None) -> DeviceVecs:
    """Build a DeviceVecs from rows already on their device (no host round
    trip). ``dtype`` (default: the rows' own) is the storage: int8
    quantizes and bfloat16 rounds with residuals, both slab by slab
    (:data:`INGEST_SLAB_ROWS` rows of f32 temporaries at a time, the same
    bits as a whole-store pass); float32 keeps. Rows past ``n_valid`` are
    masked out of every query.

    A caller short of memory passes f32 rows already padded to
    ``pad_rows(n)`` with a depth that is a multiple of 16 (DEPTH_ALIGN):
    float32 storage then adopts the caller's tensor as it is, with no copy.
    Rows that need padding (more rows, or a deeper stride) are copied once
    into the padded store; int8 and bfloat16 storage always write a new
    tensor of their own type.

    ``order`` (a device int64 tensor of ``len(vecs)`` row ids: a sort's
    permutation followed by the padding rows) stores the rows as
    ``vecs[order]``. int8 and bfloat16 gather slab by slab, so a sorted
    store never holds a second full-precision copy; float32 gathers once
    (the store owns its rows)."""
    n, d = vecs.shape
    n_pad = pad_rows(n)
    n_valid = n if n_valid is None else n_valid
    dtype = vecs.dtype if dtype is None else dtype
    if dtype == torch.int8:
        if order is None:
            slab = lambda s, r: vecs[s : s + r]  # noqa: E731
        else:
            slab = lambda s, r: vecs[order[s : s + r]]  # noqa: E731
        return _int8_slabs(slab, n, n_pad, n_valid, d, INGEST_SLAB_ROWS, vecs.device)
    if dtype == torch.bfloat16 and vecs.dtype != torch.bfloat16:
        return _materialize_bf16(vecs, n_valid, n_pad=n_pad, order=order)
    if dtype not in (torch.float32, torch.bfloat16):
        raise OttersError(f"unsupported storage dtype {dtype}")
    if order is not None:
        vecs = vecs[order]
    vecs = vecs.to(dtype)
    if n_pad != n:
        vecs = torch.cat([vecs, vecs.new_zeros((n_pad - n, d))])
    norms_sq, inv_norms = _device_norms(vecs)
    return DeviceVecs(_depth_padded(vecs), norms_sq, inv_norms,
                      _valid_mask(n_pad, n_valid, vecs.device))


def _int8_slabs(slab_fn, n: int, n_pad: int, n_valid: int, d: int, slab_rows: int,
                device) -> DeviceVecs:
    """The int8 slab walk over rows ``0 .. n`` of ``slab_fn`` into an
    ``n_pad``-row store (rows past ``n`` stay zero: quantized zero rows),
    valid below ``n_valid``. Each slab is quantized and written in place
    into the preallocated int8 buffers, so the peak memory is the int8
    store plus one slab and its temporaries."""
    buf8 = _padded_empty(n_pad, d, torch.int8, device)
    norms_sq = torch.zeros((n_pad,), dtype=torch.float32, device=device)
    inv = torch.zeros((n_pad,), dtype=torch.float32, device=device)
    resid = torch.zeros((n_pad,), dtype=torch.float32, device=device)
    slab_rows = max(1, min(slab_rows, n_pad))
    for start in range(0, n, slab_rows):
        rows = min(slab_rows, n - start)
        slab = torch.as_tensor(slab_fn(start, rows), dtype=torch.float32, device=device)
        v8, nsq, iv, rs = _quantize_rows_int8_resid(slab)
        end = start + rows
        buf8[start:end] = v8
        norms_sq[start:end] = nsq
        inv[start:end] = iv
        resid[start:end] = rs
        del slab, v8, nsq, iv, rs
    valid = _valid_mask(n_pad, n_valid, device)
    resid = torch.where(valid, resid, 0.0)
    rbin, rmax = finalize_resid(resid)
    return DeviceVecs(buf8, norms_sq, inv, valid, resid, rbin, rmax)


def materialize_int8_slabs(slab_fn, n: int, d: int, slab_rows: int, *, device) -> DeviceVecs:
    """Build an int8 DeviceVecs slab by slab, quantizing on the device.

    ``slab_fn(start, rows)`` returns an f32 ``[rows, d]`` tensor (device or
    host) or numpy array of rows ``start .. start+rows`` (rows past ``n`` may
    hold anything; validity masks them out). Each slab is quantized and
    written in place into the preallocated int8 buffers, so the peak memory
    is the int8 store plus one slab and its temporaries."""
    n_pad = pad_rows(n)
    return _int8_slabs(slab_fn, n_pad, n_pad, n, d, slab_rows, torch.device(device))


def materialize_f32_slabs(slab_fn, n: int, d: int, slab_rows: int, *, device) -> DeviceVecs:
    """Build an f32 DeviceVecs slab by slab with in-place writes.

    Same ``slab_fn`` contract as :func:`materialize_int8_slabs`; the peak
    memory is the store plus one slab (a concatenation would double it)."""
    device = torch.device(device)
    n_pad = pad_rows(n)
    buf = _padded_empty(n_pad, d, torch.float32, device)
    slab_rows = max(1, min(slab_rows, n_pad))
    for start in range(0, n_pad, slab_rows):
        rows = min(slab_rows, n_pad - start)
        buf[start : start + rows] = torch.as_tensor(
            slab_fn(start, rows), dtype=torch.float32, device=device
        )
    norms_sq, inv = _device_norms(buf)
    return DeviceVecs(buf, norms_sq, inv, _valid_mask(n_pad, n, device))


def high_precision_bound(d: int) -> float:
    """Sound bound on |dot_bf16x3 - dot_f32| / (||q|| * ||v||): the dropped
    ql.vl term and the split residuals cost <= 2^-14.4 ||q|| ||v||, and the
    f32 accumulation of the three partial products gamma_d ~ d * 2^-24 per
    partial sum (see the JAX package's derivation). 2^-14 + 4 d 2^-24."""
    return 2.0**-14 + 4.0 * d * 2.0**-24


def one_pass_dots(q32: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The dots of the one-pass store precisions "default" / "bf16", what a
    TPU computes at ``Precision.DEFAULT`` for f32 operands: queries and
    rows each rounded to bfloat16 (round-to-nearest-even), every product
    exact in f32, the products summed in f32 (bfloat16 rows are their own
    rounding). [..., B, D] x [..., T, D] -> [..., B, T]. The metric
    epilogue keeps the unrounded f32 norms."""
    qh = q32.float().to(torch.bfloat16).float()
    require_full_f32(qh)
    return qh @ v.to(torch.bfloat16).float().transpose(-1, -2)


def _score_block(queries, q_inv, q_sq, vecs, v_inv, v_sq, metric: Metric,
                 prec: str = "highest"):
    """[B, D] x [T, D] -> [B, T] scores.

    cosine   = (q . v) * inv||q|| * inv||v||
    euclid   = ||q||^2 + ||v||^2 - 2 q . v     (squared)
    dot      = q . v

    f32 queries over f32 / bfloat16 rows take the store precision ``prec``
    (one bf16 pass for "default" / "bf16", full f32 otherwise); the VPU
    metrics have no matmul form (:func:`_vpu_scores`) and read none."""
    if queries.dtype == torch.bfloat16 and metric not in VPU_METRICS:
        # MIXED certified scan: bf16-rounded queries x stored rows, f32
        # accumulation (int8 codes and bf16 x int8 products are exact in
        # f32). Callers signal the mode by handing the queries in bf16.
        qh32 = queries.float()
        require_full_f32(qh32)
        dots = qh32 @ vecs.float().T
        if metric is Metric.DotProduct:
            return dots
        if metric is Metric.Cosine:
            qih = _inv_or_zero(torch.sqrt((qh32 * qh32).sum(dim=1)))
            return dots * qih[:, None] * v_inv[None, :]
        qn2 = (qh32 * qh32).sum(dim=1)
        return qn2[:, None] + v_sq[None, :] - 2.0 * dots
    if vecs.dtype == torch.int8:
        if metric is not Metric.Cosine:
            raise OttersError(
                "int8 quantized storage supports the Cosine metric only"
            )
        # quantized cosine: symmetric int8 queries; the int8 x int8 dots are
        # integers below 2^53, so a float64 product is exact (the JAX
        # package's int32 accumulation)
        q8, _, q_inv8 = _quantize_rows_int8(queries)
        dots = (q8.double() @ vecs.double().T).float()
        return dots * q_inv8[:, None] * v_inv[None, :]
    if metric in VPU_METRICS:
        return _vpu_scores(queries, vecs, metric)
    check_precision(prec)
    if prec in ONE_PASS:
        dots = one_pass_dots(queries, vecs)
    else:
        # f32 (and bfloat16 rows, upcast exactly, as JAX's f32 x bf16
        # matmul promotes them) in full f32
        require_full_f32(queries)
        dots = queries.float() @ vecs.float().T
    if metric is Metric.DotProduct:
        return dots
    if metric is Metric.Cosine:
        return dots * q_inv[:, None] * v_inv[None, :]
    return q_sq[:, None] + v_sq[None, :] - 2.0 * dots


def _vpu_block(q, vb, metric: Metric):
    """One [B, blk] score block for the metrics with no matmul form.

    manhattan : sum |q - v|               (L1 distance)
    hamming   : count of unequal components
    jaccard   : sum min(q, v) / sum max(q, v)  (weighted Jaccard over
                non-negative vectors; 0 when both rows are all zero)

    For Hamming / Jaccard over bfloat16 rows, q and vb arrive in bfloat16
    and the compare / min / max run in that type; the sums are f32."""
    ql = q[:, None, :]
    vl = vb[None, :, :]
    if metric is Metric.Manhattan:
        return (ql - vl).abs_().sum(dim=-1)
    if metric is Metric.Hamming:
        return (ql != vl).sum(dim=-1).to(torch.float32)
    num = torch.minimum(ql, vl).float().sum(dim=-1)
    den = torch.maximum(ql, vl).float().sum(dim=-1)
    return torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), 0.0)


def _vpu_scores(queries, vecs, metric: Metric):
    """VPU metric scores [B, T] (Manhattan / Hamming / Jaccard).

    The [B, blk, D] elementwise broadcast is bounded near 256 MB per block
    (the JAX package's ``blk``); blocks run in order, the last one short
    (the JAX package pads it with NaN rows and slices them off: the same
    scores). These metrics are elementwise work by construction (~3 ops
    per element). Hamming and Jaccard over bfloat16 rows compare in
    bfloat16, the queries cast down once; every other case computes in f32."""
    b, d = queries.shape
    n = vecs.shape[0]
    blk = max(8, min(n, (1 << 26) // max(1, b * d)))
    in_bf16 = vecs.dtype == torch.bfloat16 and metric in (Metric.Hamming, Metric.Jaccard)
    q = queries.to(torch.bfloat16) if in_bf16 else queries.float()
    if n <= blk:
        return _vpu_block(q, vecs if in_bf16 else vecs.float(), metric)
    out = torch.empty((b, n), dtype=torch.float32, device=queries.device)
    for s in range(0, n, blk):
        vb = vecs[s : s + blk]
        out[:, s : s + blk] = _vpu_block(q, vb if in_bf16 else vb.float(), metric)
    return out


def _filter_ok(scores, thr, cmp: Optional[Cmp]):
    if cmp is None:
        return torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    if cmp is Cmp.Lt:
        return scores < thr
    if cmp is Cmp.Gt:
        return scores > thr
    if cmp is Cmp.Lte:
        return scores <= thr
    if cmp is Cmp.Gte:
        return scores >= thr
    return scores == thr


def _query_norms(queries: torch.Tensor):
    q = queries.float()
    q_sq = (q * q).sum(dim=1)
    return q_sq, _inv_or_zero(torch.sqrt(q_sq))


def _stable_topk(key: torch.Tensor, k: int):
    vals, idx = torch.sort(key, descending=True, stable=True)
    return vals[:k], idx[:k]


def exact_topk_flat(key: torch.Tensor, k: int):
    """Exact top-k over a 1D key, in ``lax.top_k``'s tie order, fast at
    scale: the JAX package's structure, kept step for step so ties resolve
    the same way.

    Large inputs whose length is a multiple of 512 prefilter by per-512-entry
    maxima: every true top-k entry's bin max is >= the k-th value, so the
    top bins (recursively selected) are a superset of the answer. The bins
    stay in the order that selection returns them, and the final stable
    top-k over their entries breaks ties by that bin rank, then by index."""
    n = key.shape[0]
    k = min(k, n)
    if n <= (1 << 15) or n % HIER_BIN != 0 or k * HIER_BIN * 4 >= n:
        return _stable_topk(key, k)
    bins = key.reshape(-1, HIER_BIN)
    km = min(k, bins.shape[0])
    _, top_bins = exact_topk_flat(bins.amax(dim=1), km)  # recurse while large
    cand = bins[top_bins].reshape(-1)
    cand_idx = (
        top_bins[:, None] * HIER_BIN
        + torch.arange(HIER_BIN, device=key.device)[None, :]
    ).reshape(-1)
    vals, sel = _stable_topk(cand, k)
    return vals, cand_idx[sel]


def _masked_key(scores, ok, take_min: bool):
    key = torch.where(ok, scores, float("inf") if take_min else _NEG_INF)
    return -key if take_min else key


def direct_topk_core(
    vectors, norms_sq, inv_norms, valid, queries, row_mask, thr, *,
    metric: Metric, k: int, take_min: bool, cmp: Optional[Cmp], q_valid=None,
    prec: str = "highest",
):
    """[B, N] scores -> merged global (rows, scores, valid)."""
    n_pad = vectors.shape[0]
    q_sq, q_inv = _query_norms(queries)
    scores = _score_block(
        queries, q_inv, q_sq, vectors, inv_norms, norms_sq, metric, prec
    )
    ok = valid[None, :]
    if row_mask is not None:
        ok = ok & row_mask[None, :]
    if q_valid is not None:
        ok = ok & q_valid[:, None]
    ok = ok & _filter_ok(scores, thr, cmp) & ~torch.isnan(scores)
    _, top_flat = exact_topk_flat(_masked_key(scores, ok, take_min).reshape(-1), k)
    rows = (top_flat % n_pad).to(torch.int32)
    return rows, scores.reshape(-1)[top_flat], ok.reshape(-1)[top_flat]


def _scan_tiles(vectors, norms_sq, inv_norms, valid, queries, row_mask, thr, starts, *,
                metric: Metric, k: int, take_min: bool, cmp: Optional[Cmp], tile: int,
                q_valid=None, prec: str = "highest"):
    """Merge the row tiles that begin at ``starts`` (ascending) into a
    carried k-sized buffer -> (rows, scores, valid).

    The JAX package skips a tile's merge when it cannot beat the k-th best
    (``lax.cond``); a skipped merge and a performed one give the same buffer
    (the carried entries come first, so they win every tie), so this loop
    always merges and never waits on the device to decide."""
    b = queries.shape[0]
    dev = vectors.device
    q_sq, q_inv = _query_norms(queries)
    kk = min(k, b * tile)
    best_key = torch.full((k,), _NEG_INF, device=dev)
    best_row = torch.zeros((k,), dtype=torch.int32, device=dev)
    best_score = torch.zeros((k,), device=dev)
    best_valid = torch.zeros((k,), dtype=torch.bool, device=dev)
    for start in starts:
        sl = slice(start, start + tile)
        scores = _score_block(
            queries, q_inv, q_sq, vectors[sl], inv_norms[sl], norms_sq[sl], metric, prec
        )
        ok = valid[sl][None, :]
        if row_mask is not None:
            ok = ok & row_mask[sl][None, :]
        if q_valid is not None:
            ok = ok & q_valid[:, None]
        ok = ok & _filter_ok(scores, thr, cmp) & ~torch.isnan(scores)
        t_key, t_flat = exact_topk_flat(
            _masked_key(scores, ok, take_min).reshape(-1), kk
        )
        w = scores.shape[1]  # the last tile may be shorter
        m_key = torch.cat([best_key, t_key])
        m_row = torch.cat([best_row, (start + t_flat % w).to(torch.int32)])
        m_score = torch.cat([best_score, scores.reshape(-1)[t_flat]])
        m_valid = torch.cat([best_valid, ok.reshape(-1)[t_flat]])
        best_key, sel = _stable_topk(m_key, k)
        best_row, best_score, best_valid = m_row[sel], m_score[sel], m_valid[sel]
    return best_row, best_score, best_valid


def scan_topk_core(
    vectors, norms_sq, inv_norms, valid, queries, row_mask, thr, *,
    metric: Metric, k: int, take_min: bool, cmp: Optional[Cmp], tile: int,
    q_valid=None, prec: str = "highest",
):
    """Streaming top-k over every row tile with a carried k-sized buffer."""
    return _scan_tiles(
        vectors, norms_sq, inv_norms, valid, queries, row_mask, thr,
        range(0, vectors.shape[0], tile), metric=metric, k=k, take_min=take_min,
        cmp=cmp, tile=tile, q_valid=q_valid, prec=prec,
    )


def tiles_alive_from_chunk_mask(chunk_mask: torch.Tensor, chunk_size: int, n_pad: int,
                                tile: int) -> torch.Tensor:
    """[n_chunks] chunk mask -> [n_pad / tile] tile-alive flags (the OR of
    the chunks each tile overlaps). A tile [i*tile, (i+1)*tile) overlaps
    chunks first..last; it is alive when the alive-count prefix sum differs
    across that range. O(n_tiles + n_chunks) on the device, no host round
    trip."""
    n_chunks = chunk_mask.shape[0]
    dev = chunk_mask.device
    cs = torch.zeros(n_chunks + 1, dtype=torch.int64, device=dev)
    cs[1:] = torch.cumsum(chunk_mask.to(torch.int64), dim=0)
    start = torch.arange(n_pad // tile, device=dev) * tile
    first = torch.clamp(start // chunk_size, max=n_chunks)
    last = torch.clamp((start + tile - 1) // chunk_size + 1, max=n_chunks)
    return cs[last] > cs[first]


def scan_pruned_topk_core(
    vectors, norms_sq, inv_norms, valid, queries, row_mask, thr, tile_alive, *,
    metric: Metric, k: int, take_min: bool, cmp: Optional[Cmp], tile: int,
    q_valid=None, prec: str = "highest",
):
    """Streaming top-k that skips dead tiles entirely: the pruning path of
    the VPU metrics (Manhattan / Hamming / Jaccard), which no fused kernel
    takes (the reference prunes independent of the metric, meta.rs:647-691).

    The JAX package decides each tile inside ``lax.cond`` on the device; a
    torch program cannot branch there, so the list of live tiles is read to
    the host once per query (``collect_async`` waits for that one read) and
    only those tiles are scored: a dead tile's rows are never read.
    Soundness is the fused kernels' bin-skipping contract: every row of a
    dead tile fails ``row_mask``."""
    live = torch.nonzero(tile_alive).flatten().tolist()
    return _scan_tiles(
        vectors, norms_sq, inv_norms, valid, queries, row_mask, thr,
        [t * tile for t in live], metric=metric, k=k, take_min=take_min, cmp=cmp,
        tile=tile, q_valid=q_valid, prec=prec,
    )


def _panel_sizes(n_pad: int, b: int):
    """Split n_pad rows into panels of about PANEL_SCORE_BYTES score bytes."""
    target = max(PANEL_BIN * 2, PANEL_SCORE_BYTES // (4 * max(b, 1)))
    panel = min(n_pad, (target // PANEL_BIN) * PANEL_BIN)
    return [min(panel, n_pad - off) for off in range(0, n_pad, panel)]


def panel_topk_core(
    vectors, norms_sq, inv_norms, valid, queries, row_mask, thr, *,
    metric: Metric, k: int, take_min: bool, cmp: Optional[Cmp], q_valid=None,
    prec: str = "highest",
):
    """Two-level exact top-k for a large store and a small k: the ``panel``
    program of the VPU metrics (the matmul metrics take the fused kernels).

    Per panel of rows (its [B, size] score block near 1 GB), each 512-row
    bin of every query reduces to its max key; the top-k bins hold every
    top-k entry, so only their rows are gathered and merged into a carried
    buffer, carried entries first, in the JAX package's order (its ties
    resolve the same way)."""
    b = queries.shape[0]
    dev = vectors.device
    q_sq, q_inv = _query_norms(queries)
    best_key = torch.full((k,), _NEG_INF, device=dev)
    best_row = torch.zeros((k,), dtype=torch.int32, device=dev)
    best_score = torch.zeros((k,), device=dev)
    best_valid = torch.zeros((k,), dtype=torch.bool, device=dev)
    off = 0
    for size in _panel_sizes(vectors.shape[0], b):
        sl = slice(off, off + size)
        scores = _score_block(
            queries, q_inv, q_sq, vectors[sl], inv_norms[sl], norms_sq[sl], metric, prec
        )
        ok = valid[sl][None, :]
        if row_mask is not None:
            ok = ok & row_mask[sl][None, :]
        if q_valid is not None:
            ok = ok & q_valid[:, None]
        ok = ok & _filter_ok(scores, thr, cmp) & ~torch.isnan(scores)
        n_bins = size // PANEL_BIN
        key3 = _masked_key(scores, ok, take_min).reshape(b, n_bins, PANEL_BIN)
        bin_max = key3.amax(dim=2).reshape(-1)
        _, top_bins = exact_topk_flat(bin_max, min(k, bin_max.shape[0]))
        qi, bi = top_bins // n_bins, top_bins % n_bins
        cand_row = (off + bi[:, None] * PANEL_BIN
                    + torch.arange(PANEL_BIN, device=dev)[None, :]).reshape(-1)
        m_key = torch.cat([best_key, key3[qi, bi].reshape(-1)])
        m_row = torch.cat([best_row, cand_row.to(torch.int32)])
        m_score = torch.cat([best_score, scores.reshape(b, n_bins, PANEL_BIN)[qi, bi].reshape(-1)])
        m_valid = torch.cat([best_valid, ok.reshape(b, n_bins, PANEL_BIN)[qi, bi].reshape(-1)])
        best_key, sel = _stable_topk(m_key, k)
        best_row, best_score, best_valid = m_row[sel], m_score[sel], m_valid[sel]
        off += size
    return best_row, best_score, best_valid


# Host ceiling of the windowed take-all path: b * n_pad candidate scores
# (f32) and their validity (bool) are staged on the host, and the merge
# holds about 17 bytes per candidate, so the default (2^29, about 9 GB)
# suits a 32-64 GB host. OTTERS_TAKE_ALL_LIMIT raises it on larger hosts;
# beyond it take(k) with a smaller k is required.
TAKE_ALL_LIMIT = int(os.environ.get("OTTERS_TAKE_ALL_LIMIT", 1 << 29))


def needs_windowed(n_pad: int, b: int, k_eff: int) -> bool:
    """True when no on-device top-k strategy fits this (b, n_pad, k): the
    take-all regime (the reference returns EVERY row), where a k-sized
    device buffer would rival the store itself, so the windowed host
    collection (:func:`collect_all`) takes over."""
    if b * n_pad <= DIRECT_LIMIT:
        # direct handles most k at this size, but take-most/all of a big
        # store would be a near-full-length device sort
        return (
            k_eff > PANEL_K_MAX
            and 4 * k_eff > b * n_pad
            and b * n_pad > (1 << 20)
        )
    if k_eff <= PANEL_K_MAX and n_pad % PANEL_BIN == 0:
        return False
    if n_pad % SCAN_TILE == 0 and k_eff <= SCAN_K_MAX:
        return False
    return True


def _window_block(dv: DeviceVecs, queries, q_sq, q_inv, row_mask, thr, start: int,
                  w: int, *, metric: Metric, cmp: Optional[Cmp], prec: str):
    """Score one w-row window -> ([B, w] scores, [B, w] candidate-ok)."""
    sl = slice(start, start + w)
    scores = _score_block(queries, q_inv, q_sq, dv.vectors[sl], dv.inv_norms[sl],
                          dv.norms_sq[sl], metric, prec)
    ok = dv.valid[sl][None, :]
    if row_mask is not None:
        ok = ok & row_mask[sl][None, :]
    ok = ok & _filter_ok(scores, thr, cmp) & ~torch.isnan(scores)
    return scores, ok


def _window_size(n_pad: int, b: int) -> int:
    """Largest 512-multiple window dividing n_pad with b*w <= DIRECT_LIMIT."""
    w = max(512, min(n_pad, (DIRECT_LIMIT // max(b, 1)) // 512 * 512))
    while w > 512 and n_pad % w != 0:
        w -= 512
    if n_pad % w != 0:  # tiny / unaligned stores: one window covers everything
        w = n_pad
    return w


class HostCopy:
    """Device tensors copied to pinned host memory behind a CUDA event:
    the copies start at once, ``wait()`` returns them as numpy."""

    def __init__(self, tensors):
        self._host = [t.to("cpu", non_blocking=True) for t in tensors]
        self._event = None
        if any(t.is_cuda for t in tensors):
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> tuple:
        if self._event is not None:
            self._event.synchronize()
        return tuple(h.numpy() for h in self._host)

    @staticmethod
    def of(outputs):
        """A program's outputs on their way to the host: its device tensors
        copied (a new HostCopy), or outputs already bound there (a mesh
        across processes returns its exchange, ``parallel.exchange.Pending``)
        as they are."""
        return outputs if hasattr(outputs, "wait") else HostCopy(outputs)


def collect_all(
    dv: DeviceVecs,
    queries,
    metric: Metric,
    k: int,
    take_min: bool,
    cmp: Optional[Cmp],
    thr: Optional[float],
    row_mask=None,
    prec: str = "highest",
    return_qidx: bool = False,
):
    """Windowed full-score collection for the take-all regime.

    Scores [B, w] windows on the device and streams them to the host,
    double-buffered (window i+1 is enqueued before window i is waited
    for), then runs the global top-k on the host: every (query, row) pair
    sorted by the take direction and truncated to k, ties lower flat index
    first, as ``lax.top_k``. Returns host (rows, scores, valid) like
    :func:`run_vec_topk`. Windows are scored at the store precision."""
    n_pad = dv.vectors.shape[0]
    b = queries.shape[0]
    total = b * n_pad
    if total > TAKE_ALL_LIMIT:
        raise OttersError(
            f"take({k}) over {b} queries x {n_pad} rows stages "
            f"{total} candidate scores (> {TAKE_ALL_LIMIT}); use a smaller "
            "take(k) or fewer queries per batch"
        )
    check_precision(prec)
    k_eff = min(k, total)
    dev = dv.vectors.device
    q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    q_sq, q_inv = _query_norms(q)
    thr_t = torch.tensor(0.0 if thr is None else thr, dtype=torch.float32, device=dev)
    cmp_eff = None if thr is None else cmp
    w = _window_size(n_pad, b)

    scores_h = np.empty((b, n_pad), dtype=np.float32)
    ok_h = np.empty((b, n_pad), dtype=bool)
    pending = []  # (start, host copy): the double buffer
    for start in list(range(0, n_pad, w)) + [None]:
        if start is not None:
            out = _window_block(dv, q, q_sq, q_inv, row_mask, thr_t, start, w,
                                metric=metric, cmp=cmp_eff, prec=prec)
            pending.append((start, HostCopy(out)))
        if len(pending) > 1 or (start is None and pending):
            s0, copy = pending.pop(0)
            scores_h[:, s0 : s0 + w], ok_h[:, s0 : s0 + w] = copy.wait()

    key = np.where(ok_h, scores_h, np.inf if take_min else -np.inf).reshape(-1)
    if not take_min:
        key = -key  # an ascending sort of negated keys is the take-max order
    if k_eff * 4 < total:
        part = np.argpartition(key, k_eff - 1)[:k_eff]
        # argpartition breaks the flat-index tie order; sort the survivors
        # by (key, flat index) so ties resolve lower index first
        order = part[np.lexsort((part, key[part]))]
    else:
        order = np.argsort(key, kind="stable")[:k_eff]
    rows = (order % n_pad).astype(np.int32)
    out = rows, scores_h.reshape(-1)[order], ok_h.reshape(-1)[order]
    if return_qidx:
        return out + ((order // n_pad).astype(np.int32),)
    return out


def choose_mode(n_pad: int, b: int, k_eff: int) -> str:
    """Pick the scoring strategy: 'direct' | 'panel' | 'scan'.

    direct: small candidate count -> one stable top-k is fine.
    panel : large N, small k      -> the fused bin-max kernel.
    scan  : large N, large k      -> streaming tiles.
    """
    if b * n_pad <= DIRECT_LIMIT:
        return "direct"
    if k_eff <= PANEL_K_MAX and n_pad % PANEL_BIN == 0:
        return "panel"
    if n_pad % SCAN_TILE == 0 and k_eff <= SCAN_K_MAX:
        return "scan"
    if b * n_pad * 4 <= 2 << 30:
        return "direct"
    raise OttersError(
        f"take({k_eff}) over {b} queries x {n_pad} rows is too large for "
        "device memory; use an explicit smaller take(k)"
    )


def run_vec_topk(
    dv: DeviceVecs,
    queries: torch.Tensor,
    metric: Metric,
    k: int,
    take_min: bool,
    cmp: Optional[Cmp],
    thr: Optional[float],
    row_mask=None,
    prec: str = "highest",
):
    """Execute an uncertified scoring program; returns host numpy
    (rows, scores, valid). Used by VecStore and the hash-collision redo.

    The VPU metrics take the plain programs (``panel`` included). For the
    other metrics the ``panel`` shape goes to the fused kernels: K2 over
    int8 rows; over
    f32 and bfloat16 rows the verified fast-exact K4 where
    :func:`fused_topk.fast_ok` allows it, re-run strictly (K3) when its
    check fails, else K3 (K4 for the store precision "high", K6 for the
    one-pass "default" / "bf16"); a shape the kernel does not take
    (:func:`fused_topk.kernel_takes`: any under ``OTTERS_DISABLE_PALLAS``)
    goes to the scan program. The
    take-all regime streams windows to the host (:func:`collect_all`)."""
    check_precision(prec)
    n_pad = dv.vectors.shape[0]
    b = queries.shape[0]
    k_eff = min(k, b * n_pad)
    if k_eff <= 0:
        return np.array([], np.int32), np.array([], np.float32), np.array([], bool)
    if dv.vectors.dtype == torch.int8 and metric is not Metric.Cosine:
        raise OttersError("int8 quantized storage supports the Cosine metric only")
    if needs_windowed(n_pad, b, k_eff):
        return collect_all(dv, queries, metric, k_eff, take_min, cmp, thr,
                           row_mask=row_mask, prec=prec)
    mode = choose_mode(n_pad, b, k_eff)
    q = queries.float()
    thr_t = torch.tensor(0.0 if thr is None else thr, dtype=torch.float32, device=q.device)
    cmp_eff = None if thr is None else cmp
    kwargs = dict(metric=metric, k=k_eff, take_min=take_min, cmp=cmp_eff, prec=prec)
    args = (dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, q, row_mask, thr_t)
    if mode == "panel" and metric not in VPU_METRICS:
        from . import fused_topk as ft

        fast = dv.vectors.dtype != torch.int8 and ft.fast_ok(
            metric, take_min, cmp_eff, k_eff, prec
        )
        kernel = ft.kernel_mode(dv.vectors.dtype, metric, take_min, False, prec, fast)
        if not ft.kernel_takes(kernel, dv.vectors.shape[1]):
            # the kernel does not take this shape (the JAX package's
            # pallas_ok): the scan program, chosen before any launch
            ft.kernel_takes.routed += b
            mode = "scan"
    if mode == "panel" and metric in VPU_METRICS:
        out = panel_topk_core(*args, **kwargs)
    elif mode == "panel":
        alive = torch.ones(n_pad // ft.BIN, dtype=torch.bool, device=q.device)
        rows, scores, valid, check, _ = ft.fused_topk(*args, alive, fast=fast, **kwargs)
        if fast and not bool(check):
            # the verified fast-exact check failed (ties near the boundary):
            # re-run strictly in exact f32
            rows, scores, valid, _, _ = ft.fused_topk(*args, alive, fast=False, **kwargs)
        out = (rows, scores, valid)
    elif mode == "direct":
        out = direct_topk_core(*args, **kwargs)
    else:
        out = scan_topk_core(*args, tile=SCAN_TILE, **kwargs)
    return tuple(t.cpu().numpy() for t in out)
