"""MetaStore: vector search with metadata pruning, on a CUDA device.

Counterpart of the JAX package's ``meta.py`` (the slice the main path
runs). The store is one device-resident state:

- vectors ``[N_pad, D]`` (float32, or bfloat16 / int8 with certificate
  residuals);
- per-column value tensors + null masks ``[N_pad]`` (64-bit columns in
  int64 / float64, strings as 64-bit identity hashes);
- zonemaps as ``[n_chunks]`` tensors; Bloom filters as one
  ``[n_chunks, words]`` word matrix per string column.

A query dispatches chunk-mask pruning, the row mask and the scoring program
without waiting on the device (``collect_async``); the small outputs are
copied to pinned host buffers behind a CUDA event that ``result()`` and
``resolve()`` wait on. Errors from the kernel or the device propagate:
there is no fallback to another path.

Scoring at scale runs the fused kernels (``ops/fused_topk.py``): f32 and
bfloat16 storage take the verified fast-exact K4 (bf16x3) by default, with a
check that ``result()`` / ``resolve()`` read when they fetch; a failed check
re-runs the scan strictly in exact f32 (K3), as do Eq score filters and
k > 128. The store precision "high" scans with K4, and the one-pass
precisions "default" / "bf16" score one bf16 pass on every path (K6 at
scale). With the certificate (``take(k, rerank_from=...)``) int8 storage
takes K1 (Cosine), bfloat16 storage K1 for Cosine and K5 for Dot and
Euclid; uncertified int8 takes K2. A take(k) too wide for any device top-k
(the take-all regime) streams score windows to the host
(``scoring.collect_all``).

Exactness: string equality evaluates by 64-bit hash on the device and the
returned rows are re-verified host-side against the actual strings; a hash
collision that falsely includes a row re-runs the query with an exact
host-computed row mask.

Not ported yet (each raises where a query would need it): with_sort_by /
with_z_order, delete / append, persistence, the VPU metrics and extended
string predicates.
"""

from __future__ import annotations

import functools
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .column import Column
from .display import format_build_stats, format_query_stats, metastore_head
from .errors import ExprError, OttersError
from .expr import ColumnFilter, CompiledFilter, Expr
from .ops import bloom as bloom_ops
from .ops import fused_topk, hashing, predicate, scoring
from .ops import zonemap as zm
from .ops.scoring import HostCopy
from .types import (
    STRING_EXTENDED_OPS,
    VPU_METRICS,
    Cmp,
    CmpOp,
    DataType,
    Metric,
    TakeType,
    default_take_type,
)

# ---------------------------------------------------------------------------
# Stats / results types (reference meta.rs:23-46, 832-852)
# ---------------------------------------------------------------------------


@dataclass
class MetaQueryStats:
    total_chunks: int
    pruned_chunks: int
    evaluated_chunks: int
    vectors_compared: int
    prune_duration: float  # seconds
    score_duration: float
    merge_duration: float
    total_duration: float
    # exactness certificate (take(k, rerank_from=...) on int8 / bf16 storage):
    # None = not applicable; True = recall 1.0 by construction; False =
    # widening hit its cap
    certified: Optional[bool] = None
    # scan width that produced the final candidates
    scan_k_wide: Optional[int] = None


@dataclass
class MetaBuildStats:
    n_rows: int
    dim: int
    n_chunks: int
    vectors_ingest_duration: float
    zonemap_build_duration: float
    build_total_duration: float


class MetaQueryResults:
    """Query results with materialized metadata columns (meta.rs:23-40)."""

    def __init__(self, columns: List[str], data: Dict[str, Column],
                 indices: List[int], scores: List[float]):
        self.columns = columns
        self.data = data
        self.indices = indices
        self.scores = scores

    def __len__(self) -> int:
        return len(self.indices)

    def is_empty(self) -> bool:
        return not self.indices

    def column(self, name: str) -> Optional[Column]:
        return self.data.get(name)

    def __str__(self) -> str:
        from .display import AsciiTable, format_cell

        headers = ["index", "score"] + list(self.columns)
        rows = []
        for i in range(len(self)):
            line = [str(self.indices[i]), f"{self.scores[i]:.6f}"]
            for c in self.columns:
                col = self.data.get(c)
                line.append(format_cell(col, i) if col is not None else "")
            rows.append(line)
        return AsciiTable(headers, rows).render()

    def __repr__(self) -> str:
        return str(self)


class _LruCache(dict):
    """Tiny LRU dict: ``get`` refreshes recency; inserting beyond capacity
    evicts the least-recently-used entry."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap

    def get(self, key, default=None):
        if key in self:
            val = super().pop(key)
            super().__setitem__(key, val)
            return val
        return default

    def __setitem__(self, key, val):
        if key in self:
            super().pop(key)
        elif len(self) >= self.cap:
            super().pop(next(iter(self)))
        super().__setitem__(key, val)


# ---------------------------------------------------------------------------
# Host <-> device helpers
# ---------------------------------------------------------------------------


def _to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """Host array / tensor -> tensor on ``device`` without waiting on the
    device queue: CUDA copies go through pinned memory, non-blocking (a
    pageable copy would synchronize the stream)."""
    t = torch.as_tensor(x)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d device tensor filled on the device (no host copy, no wait)."""
    return torch.full((), value, dtype=dtype, device=device)


class _Fetched:
    """Host outputs that are already fetched (the take-all path)."""

    def __init__(self, outputs):
        self._outputs = tuple(outputs)

    def wait(self) -> tuple:
        return self._outputs


# ---------------------------------------------------------------------------
# Device state construction
# ---------------------------------------------------------------------------


def _build_device_column(col: Column, n: int, n_pad: int, chunk_size: int,
                         n_chunks: int, bloom_cfg, device):
    """-> (repr, device dict of tensors, bloom params or None) for one
    column. Zonemap statistics are computed on the device (ops/zonemap.py),
    replacing the reference's host fold (meta_compute.rs:32-132)."""
    nulls_np = np.asarray(col.null_mask(), dtype=bool)[:n]
    nulls = torch.from_numpy(nulls_np.copy()).to(device)
    dt = col.dtype
    kw = dict(c=chunk_size, n_chunks=n_chunks, n_pad=n_pad)

    def vals(np_dtype):
        arr = np.ascontiguousarray(np.asarray(col.values(), dtype=np_dtype)[:n])
        return torch.from_numpy(arr).to(device)

    if dt is DataType.Int32:
        return "i32", zm.build_i32(vals(np.int32), nulls, **kw), None
    if dt is DataType.Bool:
        # 0/1 int32 on the device: zonemap min/max prune chunks for Eq
        # literals, matching the reference rule (type_utils.rs:446-584)
        b01 = np.asarray(col.values(), dtype=np.bool_)[:n].astype(np.int32)
        return "i32", zm.build_i32(torch.from_numpy(b01).to(device), nulls, **kw), None
    if dt is DataType.Float32:
        return "f32", zm.build_f32(vals(np.float32), nulls, **kw), None
    if dt in (DataType.Int64, DataType.DateTime):
        return "i64", zm.build_i64(vals(np.int64), nulls, **kw), None
    if dt is DataType.Float64:
        return "f64", zm.build_f64(vals(np.float64), nulls, **kw), None
    # String: hashes + Bloom bits come from the host (strings never live on
    # the device); padding + non-null counts run on the device
    strings = list(col.values())[:n]
    g1, g2 = hashing.hash_strings(strings)
    rh = torch.from_numpy(np.ascontiguousarray(g1).view(np.int64)).to(device)
    dev = zm.build_str_rows(rh, nulls, **kw)
    kind, val = bloom_cfg
    if kind == "fpr":
        params = bloom_ops.BloomParams.from_fpr(val, chunk_size)
    else:
        params = bloom_ops.BloomParams.from_bits(val, chunk_size)
    chunk_ids = np.arange(n, dtype=np.int64) // chunk_size
    matrix = bloom_ops.build_matrix(
        g1, g2, nulls_np, chunk_ids, n_chunks, params, chunk_size=chunk_size
    )
    dev["bloom"] = bloom_ops.to_device(matrix, device)
    return "str", dev, params


# ---------------------------------------------------------------------------
# The query program
# ---------------------------------------------------------------------------


def _meta_query_program(store: "MetaStore", cols, queries, plan_static,
                        plan_params, thr, *, metric, k, take_min, cmp, tile,
                        certify, fast=False):
    """The whole meta query, enqueued on the device without waiting:

    zonemap chunk-mask pruning + stats -> row-mask predicate tensors ->
    scoring with fused masking -> exact global top-k (the fusion of the
    reference's prune/score/merge phases, meta.rs:632-709).

    certify=True (int8 / bf16 + rerank): the 5th output is a sound bound,
    in the key space (negated for take-min), on the true score of every row
    NOT among the returned candidates; -inf otherwise. fast=True (f32 / bf16
    rows): the 4th output is the fast-exact check, False when the query
    must be re-run strictly. Returns device tensors (rows, scores, ok,
    check, bound, evaluated, rows_eval)."""
    dv = store._dv
    dev = dv.vectors.device
    n_pad = dv.vectors.shape[0]
    chunk_lens = store._chunk_lens
    n_chunks = chunk_lens.shape[0]
    if plan_static:
        cmask = predicate.chunk_mask(plan_static, plan_params, cols, n_chunks, dev)
        evaluated = cmask.sum(dtype=torch.int32)
        rows_eval = (chunk_lens * cmask).sum(dtype=torch.int32)
        rmask = predicate.row_mask(plan_static, plan_params, cols, n_pad, dev)
    else:
        evaluated = torch.full((), n_chunks, dtype=torch.int32, device=dev)
        rows_eval = chunk_lens.sum(dtype=torch.int32)
        rmask = None
    if tile == "fused":
        # the hand-written kernel: pruned bins cost no loads and no math
        if plan_static:
            alive = fused_topk.bins_alive_from_chunk_mask(
                cmask, store._chunk_size, n_pad
            )
        else:
            alive = torch.ones(n_pad // fused_topk.BIN, dtype=torch.bool, device=dev)
        rows, scores, ok, check, bound = fused_topk.fused_topk(
            dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, queries, rmask,
            thr, alive, metric=metric, k=k, take_min=take_min, cmp=cmp,
            certify=certify, prec=store.precision, fast=fast, resid=dv.resid,
        )
        return rows, scores, ok, check, bound, evaluated, rows_eval

    # direct / scan: one global certificate term; the certified scan runs
    # MIXED (bf16-rounded queries x stored rows), signaled to _score_block
    # by the bf16 query dtype
    cert_slack = None
    thr_core = thr
    q_core = queries
    if certify:
        d = dv.vectors.shape[1]
        qh32, c0, c1, c2 = scoring.cert_query_coeffs(metric, queries, d)
        lane_a, lane_b = scoring.cert_row_lanes(
            metric, dv.vectors.dtype, dv.resid, dv.inv_norms, dv.norms_sq, d
        )
        cert_slack = scoring.cert_global_slack(c0, c1, c2, lane_a, lane_b, dv.norms_sq)
        if cmp in (Cmp.Gt, Cmp.Gte):
            thr_core = thr - cert_slack
        elif cmp in (Cmp.Lt, Cmp.Lte):
            thr_core = thr + cert_slack
        q_core = qh32.to(torch.bfloat16)
    args = (dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, q_core, rmask, thr_core)
    kwargs = dict(metric=metric, k=k, take_min=take_min, cmp=cmp, prec=store.precision)
    if tile == "scan":
        rows, scores, ok = scoring.scan_topk_core(*args, tile=scoring.SCAN_TILE, **kwargs)
    else:
        rows, scores, ok = scoring.direct_topk_core(*args, **kwargs)
    if certify:
        # every unreturned candidate's scan key <= the k-th returned one
        # (exact global top-k); with fewer than k valid candidates every
        # passing row was returned and nothing is unexamined
        kth_key = -scores[-1] if take_min else scores[-1]
        bound = torch.where(ok[-1], kth_key + cert_slack, float("-inf"))
    else:
        bound = torch.full((), float("-inf"), device=dev)
    check = torch.ones((), dtype=torch.bool, device=dev)
    return rows, scores, ok, check, bound, evaluated, rows_eval


def _rerank_scores(q: torch.Tensor, v: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Exact f32 scores [..., B, M] of queries [..., B, D] vs rows [..., M, D]
    (the formulas of evaluate.exact_rerank; full f32, like HIGHEST)."""
    if metric in VPU_METRICS:
        raise NotImplementedError(f"the {metric.value} rerank is not ported yet")
    scoring.require_full_f32(q)
    dots = q @ v.transpose(-1, -2)
    if metric is Metric.Cosine:
        qn = torch.sqrt((q * q).sum(-1))
        vn = torch.sqrt((v * v).sum(-1))
        qi = torch.where(qn > 0, 1.0 / torch.where(qn > 0, qn, 1.0), 0.0)
        vi = torch.where(vn > 0, 1.0 / torch.where(vn > 0, vn, 1.0), 0.0)
        return dots * qi[..., :, None] * vi[..., None, :]
    if metric is Metric.Euclidean:
        return (q * q).sum(-1)[..., :, None] + (v * v).sum(-1)[..., None, :] - 2.0 * dots
    return dots


def _device_rerank_dispatch(store: "MetaStore", plist):
    """Enqueue ONE exact rerank for a group of compatible pendings (same
    store / batch shape / metric / filter / k) without waiting for it.
    Returns (plist, cands, host copy) for _device_rerank_finish, or None
    when a member has no candidates (each then reranks on its own)."""
    plan0 = plist[0]._plan
    metric = plan0._metric
    dev = store._device
    k_final = plan0._take_count
    take_min = plist[0]._take_type is TakeType.Min
    cands = []
    for p in plist:
        rows, _, valid = p._fetched[0], p._fetched[1], p._fetched[2]
        idx = np.asarray(rows)[np.asarray(valid, dtype=bool)].astype(np.int64)
        # dedup preserving first-seen (scan output) order: tie-breaking in
        # the rerank follows this slot order
        _, first = np.unique(idx, return_index=True)
        cand = idx[np.sort(first)]
        if cand.size == 0:
            return None
        cands.append(cand)
    m = max(len(c) for c in cands)
    ids_arr = np.unique(np.concatenate(cands))
    vecs = _to_device(store._rerank_fetch(ids_arr), dev, torch.float32)
    n_p = len(plist)
    pos = np.zeros((n_p, m), dtype=np.int64)
    valid_m = np.zeros((n_p, m), dtype=bool)
    for j, cand in enumerate(cands):
        pos[j, : len(cand)] = np.searchsorted(ids_arr, cand)
        valid_m[j, : len(cand)] = True
    pos_t = _to_device(pos, dev)
    valid_t = _to_device(valid_m, dev)
    q = torch.stack([p._queries for p in plist])  # [P, B, D]
    b = q.shape[1]
    s = _rerank_scores(q, vecs[pos_t], metric)  # [P, B, M]
    ok = valid_t[:, None, :] & ~torch.isnan(s)
    if plan0._vec_filter is not None:
        thr, cmp = plan0._vec_filter
        ok = ok & scoring._filter_ok(s, thr, cmp)
    key = torch.where(ok, s, float("inf") if take_min else float("-inf"))
    if take_min:
        key = -key
    flat = key.reshape(n_p, b * m)
    sel = torch.sort(flat, dim=1, descending=True, stable=True)[1][:, : min(k_final, b * m)]
    out_s = torch.gather(s.reshape(n_p, b * m), 1, sel)
    out_ok = torch.gather(ok.reshape(n_p, b * m), 1, sel)
    return plist, cands, HostCopy([sel % m, out_s, out_ok])


def _device_rerank_finish(plist, cands, fetched) -> None:
    """Assign the fetched rerank outputs back onto each pending."""
    m_idx, out_s, out_ok = fetched
    for p, cand, mi, so, oo in zip(plist, cands, m_idx, out_s, out_ok):
        oo = np.asarray(oo, dtype=bool)
        p._device_rerank = (
            frozenset(cand.tolist()),
            cand[np.asarray(mi)[oo]].tolist(),
            np.asarray(so)[oo].tolist(),
        )


# ---------------------------------------------------------------------------
# MetaStore + builder
# ---------------------------------------------------------------------------

# storage dtype name of a pre-built DeviceVecs's rows
_STORAGE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}


class MetaStoreBuilder:
    """Builder (reference meta.rs:62-110, 113-148)."""

    def __init__(self, schema: Dict[str, DataType], columns: Dict[str, Column]):
        self._schema = dict(schema)
        self._columns = dict(columns)
        self._vectors = None
        self._vectors_n = None
        self._chunk_size = 1024
        self._bloom: Tuple[str, float] = ("fpr", 0.01)
        self._storage_dtype = "float32"
        self._rerank = None
        self._device = None

    def with_device(self, device) -> "MetaStoreBuilder":
        """Run the store on ``device`` ("cuda", "cuda:1", "cpu", ...). With no
        device named, ``build()`` uses the current CUDA device and raises if
        there is none."""
        self._device = torch.device(device)
        return self

    def with_rerank_source(self, fetch_vectors=None, keep_host_f32: bool = False) -> "MetaStoreBuilder":
        """Attach a source of TRUE f32 vectors for exact re-ranking.

        ``.take(k, rerank_from=k_wide)`` then scans ``k_wide`` candidates
        from the (int8 / bfloat16) storage and re-scores them in exact f32.
        Exactly one of:
        - ``fetch_vectors(indices) -> [m, d] float32`` (numpy or a torch
          tensor, e.g. a gather from device-resident f32 rows), called with
          row ids;
        - ``keep_host_f32=True`` — keep the ingested f32 rows host-side
          (unavailable for pre-built DeviceVecs)."""
        if (fetch_vectors is None) == (not keep_host_f32):
            raise OttersError(
                "with_rerank_source takes exactly one of fetch_vectors / "
                "keep_host_f32=True"
            )
        self._rerank = (fetch_vectors, bool(keep_host_f32))
        return self

    def with_vectors(self, vectors, n_rows=None) -> "MetaStoreBuilder":
        """Supply vectors: a [n, d] numpy array / list of rows, or a
        pre-built ``scoring.DeviceVecs`` (e.g. from
        ``scoring.materialize_int8_slabs`` for stores too large to exist in
        f32), adopted as-is with its storage dtype; ``n_rows`` is required
        then."""
        self._vectors = vectors
        self._vectors_n = n_rows
        return self

    def with_chunk_size(self, chunk_size: int) -> "MetaStoreBuilder":
        self._chunk_size = max(1, int(chunk_size))
        return self

    def with_storage_dtype(self, dtype: str) -> "MetaStoreBuilder":
        """Device storage dtype for vectors: "float32" (default, exact),
        "bfloat16" (half the memory; ``take(k)`` is exact over the stored
        values, ``take(k, rerank_from=...)`` certified exact for Cosine, Dot
        and Euclid) or "int8" (per-row symmetric quantization, Cosine-only;
        exact results through ``take(k, rerank_from=...)`` and the
        certificate)."""
        if dtype not in ("float32", "bfloat16", "int8"):
            raise OttersError(f"unsupported storage dtype {dtype!r}")
        self._storage_dtype = dtype
        return self

    def with_bloom_fpr(self, fpr: float) -> "MetaStoreBuilder":
        f = float(fpr)
        f = min(max(f, 1e-2), 0.5) if np.isfinite(f) else 0.01
        self._bloom = ("fpr", f)
        return self

    def with_bloom_bits(self, bits: int) -> "MetaStoreBuilder":
        self._bloom = ("bits", max(64, int(bits)))
        return self

    def with_column(self, name: str, column: Column) -> "MetaStoreBuilder":
        if name not in self._schema:
            raise OttersError(f"unknown column '{name}' not present in schema")
        if self._schema[name] is not column.dtype:
            raise OttersError(
                f"dtype mismatch for column '{name}': schema "
                f"{self._schema[name]!r}, got {column.dtype!r}"
            )
        self._columns[name] = column
        return self

    def with_columns(self, columns: List[Tuple[str, Column]]) -> "MetaStoreBuilder":
        for name, c in columns:
            self.with_column(name, c)
        return self

    def build(self) -> "MetaStore":
        if self._vectors is None:
            raise OttersError("vectors must be provided to build MetaStore")
        device = resolve_device(self._device, "MetaStoreBuilder.with_device('cpu')")
        vectors = self._vectors
        pre_built = isinstance(vectors, scoring.DeviceVecs)
        if pre_built:
            if self._vectors_n is None:
                raise OttersError(
                    "with_vectors(DeviceVecs) requires n_rows (the logical "
                    "row count; the buffers are padded)"
                )
            if vectors.vectors.device != device:
                raise OttersError(
                    f"the pre-built DeviceVecs live on {vectors.vectors.device}, "
                    f"the store on {device}"
                )
            n_rows = int(self._vectors_n)
            dim = int(vectors.vectors.shape[1])
            self._storage_dtype = _STORAGE_NAMES[vectors.vectors.dtype]
        elif isinstance(vectors, torch.Tensor):
            raise NotImplementedError(
                "with_vectors(torch.Tensor) is not ported yet; pass numpy "
                "rows or a pre-built scoring.DeviceVecs"
            )
        elif not isinstance(vectors, np.ndarray):
            vecs_list = [np.asarray(v, dtype=np.float32) for v in vectors]
            n_rows = len(vecs_list)
            dim = vecs_list[0].shape[0] if n_rows else 0
            for i, v in enumerate(vecs_list):
                if v.shape[0] != dim:
                    raise OttersError(
                        f"vector at index {i} has dim {v.shape[0]}, expected {dim}"
                    )
            vectors = np.stack(vecs_list, axis=0) if n_rows else np.zeros((0, dim), np.float32)
        else:
            vectors = vectors.astype(np.float32, copy=False)
            n_rows, dim = vectors.shape if vectors.ndim == 2 else (len(vectors), 0)
        if dim == 0 and n_rows > 0:
            raise OttersError("vector dimension cannot be zero")

        for name in self._schema:
            colo = self._columns.get(name)
            if colo is None:
                raise OttersError(f"missing column '{name}' in builder columns")
            if len(colo) != n_rows:
                raise OttersError(
                    f"column '{name}' length {len(colo)} does not match vectors "
                    f"length {n_rows}"
                )

        rerank_fetch = None
        if self._rerank is not None:
            fetch, keep = self._rerank
            if keep:
                if pre_built:
                    raise OttersError(
                        "keep_host_f32 is unavailable for pre-built "
                        "DeviceVecs (their f32 form never existed); pass "
                        "fetch_vectors instead"
                    )
                host_f32 = np.asarray(vectors, dtype=np.float32)[:n_rows]

                def rerank_fetch(ids, _hf=host_f32):
                    return _hf[np.asarray(ids, dtype=np.int64)]

            else:
                rerank_fetch = fetch

        build_start = time.perf_counter()
        ingest_start = time.perf_counter()
        if pre_built:
            dv = vectors
        else:
            dtype = getattr(torch, self._storage_dtype)
            dv = scoring.materialize(vectors, dtype=dtype, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # honest ingest timing
        ingest_dur = time.perf_counter() - ingest_start

        n_pad = dv.vectors.shape[0]
        c = self._chunk_size
        n_chunks = -(-n_rows // c) if n_rows else 0

        zstart = time.perf_counter()
        device_cols: Dict[str, Dict] = {}
        col_reprs: Dict[str, str] = {}
        bloom_params: Dict[str, bloom_ops.BloomParams] = {}
        for name in self._schema:
            rep, devcol, aux = _build_device_column(
                self._columns[name], n_rows, n_pad, c, n_chunks, self._bloom, device
            )
            device_cols[name] = devcol
            col_reprs[name] = rep
            if aux is not None:
                bloom_params[name] = aux
        chunk_lens = np.minimum(
            np.full(n_chunks, c, dtype=np.int64),
            n_rows - np.arange(n_chunks, dtype=np.int64) * c,
        ).astype(np.int32)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        zonemap_dur = time.perf_counter() - zstart

        store = MetaStore(self._schema)
        store._device = device
        store._columns = self._columns
        store._chunk_size = c
        store._n_rows = n_rows
        store._dim = dim
        store._n_chunks = n_chunks
        store._dv = dv
        store._device_cols = device_cols
        store._col_reprs = col_reprs
        store._bloom_params = bloom_params
        store._chunk_lens = torch.from_numpy(chunk_lens).to(device)
        store._storage_dtype = self._storage_dtype
        store._rerank_fetch = rerank_fetch
        store._build_stats = MetaBuildStats(
            n_rows=n_rows,
            dim=dim,
            n_chunks=n_chunks,
            vectors_ingest_duration=ingest_dur,
            zonemap_build_duration=zonemap_dur,
            build_total_duration=time.perf_counter() - build_start,
        )
        return store


class MetaStore:
    """Device-resident vector+metadata store (reference meta.rs:49-577)."""

    def __init__(self, schema):
        if isinstance(schema, dict):
            self._schema = dict(schema)
        else:
            self._schema = {name: dt for name, dt in schema}
        self._columns = {name: Column(name, dt) for name, dt in self._schema.items()}
        self._device: Optional[torch.device] = None
        self._chunk_size = 1024
        self._n_rows = 0
        self._dim = 0
        self._n_chunks = 0
        self._dv: Optional[scoring.DeviceVecs] = None
        self._device_cols: Dict[str, Dict] = {}
        self._col_reprs: Dict[str, str] = {}
        self._bloom_params: Dict[str, bloom_ops.BloomParams] = {}
        self._chunk_lens = None
        self._storage_dtype = "float32"
        self._rerank_fetch = None
        # per-(filter, vec_filter, k) scan widths that recently certified
        self._cert_kwide_hint = _LruCache(64)
        self._plan_cache = _LruCache(256)
        self._build_stats: Optional[MetaBuildStats] = None
        self._last_stats: Optional[MetaQueryStats] = None
        # scan precision of f32 / bf16 storage: "highest" (exact; the
        # verified fast-exact K4 with a strict K3 rerun), "high" (bf16x3 at
        # scale) or "default" / "bf16" (one bf16 pass on every path)
        self.precision: str = "highest"

    # -- constructors ------------------------------------------------------
    @staticmethod
    def new(schema) -> "MetaStore":
        return MetaStore(schema)

    @staticmethod
    def from_columns(columns: List[Column]) -> MetaStoreBuilder:
        schema = {c.name: c.dtype for c in columns}
        return MetaStoreBuilder(schema, {c.name: c for c in columns})

    @staticmethod
    def from_schema(schema) -> MetaStoreBuilder:
        schema_map = {name: dt for name, dt in schema}
        cols = {name: Column(name, dt) for name, dt in schema_map.items()}
        return MetaStoreBuilder(schema_map, cols)

    # -- accessors ----------------------------------------------------------
    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    def schema(self) -> Dict[str, DataType]:
        return self._schema

    def columns(self) -> Dict[str, Column]:
        return self._columns

    def n_chunks(self) -> int:
        return self._n_chunks

    def chunk_size(self) -> int:
        return self._chunk_size

    @property
    def n_rows(self) -> int:
        return self._n_rows

    def __len__(self) -> int:
        return self._n_rows

    def last_query_stats(self) -> Optional[MetaQueryStats]:
        return self._last_stats

    def build_stats(self) -> Optional[MetaBuildStats]:
        return self._build_stats

    def cert_hints(self) -> Dict[str, int]:
        """Certificate scan-width hints that certified, keyed per plan shape
        (filter, vec_filter, k)."""
        return dict(self._cert_kwide_hint)

    # -- display -------------------------------------------------------------
    def head(self) -> None:
        self.head_n(5)

    def head_n(self, n: int) -> None:
        print(metastore_head(self, n))

    def print_build_stats(self) -> None:
        if self._build_stats is not None:
            print(format_build_stats(self._build_stats))
        else:
            print("(no build stats)")

    def print_last_query_stats(self) -> None:
        if self._last_stats is not None:
            print(format_query_stats(self._last_stats))
        else:
            print("(no query stats)")

    def print_last_stats(self) -> None:
        self.print_build_stats()
        self.print_last_query_stats()

    # -- the device program ----------------------------------------------------
    def _run_query_program(self, cols_sub, queries, plan_params, thr, plan_static,
                           metric, k, take_min, cmp, strict=False, certify=False):
        """Pick the mode as the JAX package's ``_prepare_program`` does and
        enqueue the program. ``strict`` turns the fast-exact mode off (the
        redo after a failed check). -> device tensors (see
        _meta_query_program)."""
        dv = self._dv
        n_pad = dv.vectors.shape[0]
        b = queries.shape[0]
        k_eff = min(k, b * n_pad)
        if dv.vectors.dtype == torch.int8 and metric is not Metric.Cosine:
            raise OttersError("int8 quantized storage supports the Cosine metric only")
        if metric in VPU_METRICS:
            raise NotImplementedError(f"the {metric.value} metric (VPU metrics) is not ported yet")
        scoring.check_precision(self.precision)
        tile = scoring.choose_mode(n_pad, b, k_eff)
        fast = False
        if tile == "panel":
            # panel's shape (k <= 1024, 512-aligned rows) is the fused path's
            tile = "fused"
            fast = (
                not strict
                and dv.vectors.dtype != torch.int8
                and fused_topk.fast_ok(metric, take_min, cmp, k_eff, self.precision)
            )
        certify = (
            certify
            and not strict
            and self._certify_supported(metric, take_min, cmp)
            and (tile != "fused" or dv.resid_bin is not None)
        )
        # certify and fast are disjoint kernel modes; certify wins
        fast = fast and not certify
        if tile == "fused":
            fused_topk.kernel_mode(
                dv.vectors.dtype, metric, take_min, certify, self.precision, fast
            )
        thr_t = _scalar(float(thr), torch.float32, self._device)
        return _meta_query_program(
            self, cols_sub, queries, plan_static, plan_params, thr_t,
            metric=metric, k=k_eff, take_min=take_min, cmp=cmp, tile=tile,
            certify=certify, fast=fast,
        )

    def _certify_supported(self, metric, take_min, cmp) -> bool:
        """Can the exactness certificate cover this plan shape? int8 storage:
        Cosine + take-max + no/Gt/Gte filter. bfloat16 storage: Cosine and
        DotProduct (take-max, no/Gt/Gte) and Euclidean (take-min, no/Lt/Lte),
        through the general residual fold. f32 storage is exact and needs
        none. Stores without residuals (pre-quantized codes) cannot."""
        dv = self._dv
        if dv.resid is None:
            return False
        if dv.vectors.dtype == torch.int8:
            return metric is Metric.Cosine and not take_min and cmp in (None, Cmp.Gt, Cmp.Gte)
        if dv.vectors.dtype == torch.bfloat16:
            if metric in (Metric.Cosine, Metric.DotProduct):
                return not take_min and cmp in (None, Cmp.Gt, Cmp.Gte)
            if metric is Metric.Euclidean:
                return take_min and cmp in (None, Cmp.Lt, Cmp.Lte)
        return False

    def _direct_k_ok(self, k: int, b: int) -> bool:
        """Can the device top-k program run take(k) for a b-query batch?
        (False = the take-all regime, which returns no certificate bound.)"""
        n_pad = self._dv.vectors.shape[0]
        return not scoring.needs_windowed(n_pad, b, min(k, b * n_pad))

    def _windowed_collect(self, cols_sub, queries, plan_params, plan_static, k_eff,
                          metric, take_min, thr, cmp):
        """The take-all regime: device pruning, then score windows streamed
        to the host (``scoring.collect_all``) at the store precision. ->
        host (rows, scores, valid, check, bound, evaluated, rows_eval), the
        query program's layout."""
        dv = self._dv
        dev = dv.vectors.device
        n_pad = dv.vectors.shape[0]
        if plan_static:
            cmask = predicate.chunk_mask(plan_static, plan_params, cols_sub,
                                         self._chunk_lens.shape[0], dev)
            rmask = predicate.row_mask(plan_static, plan_params, cols_sub, n_pad, dev)
            ev = int(cmask.sum())
            re_ = int((self._chunk_lens * cmask).sum())
        else:
            rmask, ev, re_ = None, self.n_chunks(), self.n_rows
        rows, scores, valid = scoring.collect_all(
            dv, queries, metric, k_eff, take_min=take_min, cmp=cmp, thr=thr,
            row_mask=rmask, prec=self.precision,
        )
        return rows, scores, valid, np.bool_(True), np.float32(-np.inf), ev, re_

    def _run_exact_mask_query(self, queries, exact_mask, metric, k, take_min, cmp, thr):
        """Hash-collision fallback: re-run with an exact host-computed row
        mask. Returns host (rows, scores, valid)."""
        return scoring.run_vec_topk(
            self._dv, queries, metric, k, take_min=take_min, cmp=cmp, thr=thr,
            row_mask=torch.from_numpy(exact_mask).to(self._device),
            prec=self.precision,
        )

    # -- query ---------------------------------------------------------------
    def query(self, query, metric: Metric) -> "MetaQueryPlan":
        return MetaQueryPlan(self, [np.asarray(query, dtype=np.float32)], metric)

    def query_batch(self, queries, metric: Metric) -> "MetaQueryPlan":
        if isinstance(queries, (np.ndarray, torch.Tensor)) and queries.ndim == 2:
            return MetaQueryPlan(self, queries, metric)
        return MetaQueryPlan(self, [np.asarray(q, dtype=np.float32) for q in queries], metric)


# ---------------------------------------------------------------------------
# Query plan
# ---------------------------------------------------------------------------


class MetaQueryPlan:
    """Lazy meta-query builder with deferred compile errors (meta.rs:579-630)."""

    def __init__(self, store: MetaStore, queries, metric: Metric):
        self._store = store
        self._queries = queries
        self._metric = metric
        self._meta_filter: Optional[CompiledFilter] = None
        self._meta_error: Optional[str] = None
        self._vec_filter: Optional[Tuple[float, Cmp]] = None
        self._take_type: Optional[TakeType] = None
        self._take_count: Optional[int] = None
        self._rerank_from: Optional[int] = None
        self._certify: Optional[bool] = None
        self._hint_key: Optional[str] = None

    def meta_filter(self, expr: Expr) -> "MetaQueryPlan":
        try:
            self._meta_filter = expr.compile(self._store.schema())
            self._meta_error = None
        except ExprError as e:
            self._meta_error = f"meta_filter compile error: {e}"
        return self

    def vec_filter(self, score: float, cmp: Cmp) -> "MetaQueryPlan":
        self._vec_filter = (float(score), cmp)
        return self

    def take(self, k: int, rerank_from: Optional[int] = None,
             certify: Optional[bool] = None) -> "MetaQueryPlan":
        """Keep the top ``k``. With ``rerank_from=k_wide`` (requires
        ``with_rerank_source``) the device scan collects ``k_wide``
        candidates and the final ``k`` are exact-f32 re-scored.

        ``certify`` controls the exactness certificate (recall 1.0 by
        construction): the scan also returns a sound bound on the true score
        of every row it did not hand to the rerank; ``result()`` compares it
        with the k-th exact score and re-runs 4x wider until it passes.
        ``None`` (default) enables it where it applies (int8 + Cosine, no /
        Gt / Gte vec_filter; bfloat16 + Cosine / DotProduct likewise, or
        Euclidean take-min with no / Lt / Lte vec_filter); False disables;
        True raises where it cannot apply."""
        self._take_count = int(k)
        self._take_type = default_take_type(self._metric)
        if rerank_from is not None:
            rf = int(rerank_from)
            if rf < int(k):
                raise OttersError(f"rerank_from ({rf}) must be >= take k ({int(k)})")
            self._rerank_from = rf
        if certify is True and rerank_from is None:
            raise OttersError(
                "take(certify=True) requires rerank_from: the certificate "
                "compares the k-th EXACT rerank score against the scan's "
                "bound — there is no exact score without a rerank"
            )
        self._certify = certify
        return self

    # -- leaf lowering --------------------------------------------------------
    def _lower_leaf(self, leaf: ColumnFilter):
        """-> (static descriptor, params tuple of device scalars)."""
        store = self._store
        dev = store._device
        dtype = store.schema()[leaf.column]
        if leaf.kind == "null":
            return ("null", leaf.column, leaf.cmp), (store._chunk_lens,)
        if leaf.kind == "string" and leaf.cmp in STRING_EXTENDED_OPS:
            raise NotImplementedError(
                f"string predicate {leaf.cmp.value} is not ported yet (only Eq / Neq are)"
            )
        if leaf.kind == "string":
            g1, _ = hashing.hash_string(leaf.rhs)
            rh = np.array([g1], dtype=np.uint64).view(np.int64)[0]
            words, masks = bloom_ops.probe_coords(leaf.rhs, store._bloom_params[leaf.column])
            return ("str", leaf.column, leaf.cmp), (
                _scalar(int(rh), torch.int64, dev),
                _to_device(words.astype(np.int64), dev),
                _to_device(masks.view(np.int32), dev),
            )
        if dtype is DataType.Bool:
            return ("i32", leaf.column, leaf.cmp), (
                _scalar(1 if leaf.rhs else 0, torch.int32, dev),
            )
        if dtype is DataType.Int32:
            wrapped = int(np.int64(leaf.rhs).astype(np.int32))  # like `as i32`
            return ("i32", leaf.column, leaf.cmp), (
                _scalar(wrapped, torch.int32, dev),
            )
        if dtype is DataType.Float32:
            rhs32 = zm.flush_subnormal_f32(float(np.float32(leaf.rhs)))
            return ("f32", leaf.column, leaf.cmp), (_scalar(rhs32, torch.float32, dev),)
        if dtype in (DataType.Int64, DataType.DateTime):
            return ("i64", leaf.column, leaf.cmp), (
                _scalar(int(leaf.rhs), torch.int64, dev),
            )
        rhs = float(leaf.rhs)
        if np.isnan(rhs):
            return ("nanthr", leaf.column, leaf.cmp), ()
        return ("f64", leaf.column, leaf.cmp), (
            _scalar(rhs, torch.float64, dev),
        )

    def _lower_plan(self):
        """Lowered plans (device scalars included) are cached per store and
        reused by every query with the same filter."""
        cache_key = self._meta_filter.clauses
        cached = self._store._plan_cache.get(cache_key)
        if cached is not None:
            return cached
        static_clauses, param_clauses, used_cols = [], [], set()
        for clause in self._meta_filter.clauses:
            st, pr = [], []
            for leaf in clause:
                s, p = self._lower_leaf(leaf)
                st.append(s)
                pr.append(p)
                used_cols.add(leaf.column)
            static_clauses.append(tuple(st))
            param_clauses.append(tuple(pr))
        result = (tuple(static_clauses), tuple(param_clauses), used_cols)
        self._store._plan_cache[cache_key] = result
        return result

    # -- host-exact verification ------------------------------------------------
    def _host_rhs(self, leaf: ColumnFilter):
        """Leaf literal as the device sees it: Int32 thresholds wrap."""
        if leaf.kind == "numeric" and self._store.schema()[leaf.column] is DataType.Int32:
            return int(np.int64(leaf.rhs).astype(np.int32))
        return leaf.rhs

    def _row_satisfies(self, i: int) -> bool:
        """Host CNF evaluation for one row (exact, used for verification)."""
        cols = self._store.columns()
        for clause in self._meta_filter.clauses:
            ok = False
            for leaf in clause:
                c = cols[leaf.column]
                isnull = bool(c.null_mask()[i])
                if leaf.kind == "null":
                    if isnull if leaf.cmp is CmpOp.IsNull else not isnull:
                        ok = True
                        break
                    continue
                if isnull:
                    continue
                v = c.values()[i]
                if leaf.kind == "string":
                    sat = _str_cmp(v, leaf.rhs, leaf.cmp)
                else:
                    sat = _num_cmp(np.asarray(v).item(), self._host_rhs(leaf), leaf.cmp)
                if sat:
                    ok = True
                    break
            if not ok:
                return False
        return True

    def _host_exact_row_mask(self, n_pad: int) -> np.ndarray:
        """Vectorized exact host row mask (collision fallback path)."""
        store = self._store
        n = store.n_rows
        acc = np.ones(n_pad, dtype=bool)
        acc[n:] = False
        for clause in self._meta_filter.clauses:
            cm = np.zeros(n, dtype=bool)
            for leaf in clause:
                c = store.columns()[leaf.column]
                nulls = np.asarray(c.null_mask(), dtype=bool)[:n]
                if leaf.kind == "null":
                    cm |= nulls if leaf.cmp is CmpOp.IsNull else ~nulls
                    continue
                if leaf.kind == "string":
                    vals = np.asarray(c.values()[:n], dtype=object)
                    m = np.fromiter(
                        (_str_cmp(v, leaf.rhs, leaf.cmp) for v in vals), bool, count=n
                    )
                else:
                    m = _np_cmp(np.asarray(c.values()[:n]), self._host_rhs(leaf), leaf.cmp)
                cm |= np.asarray(m, dtype=bool) & ~nulls
            acc[:n] &= cm
        return acc

    def _has_string_leaf(self) -> bool:
        return self._meta_filter is not None and any(
            lf.kind == "string" for cl in self._meta_filter.clauses for lf in cl
        )

    # -- execution ----------------------------------------------------------
    def collect(self) -> MetaQueryResults:
        """Execute and block for results (reference meta.rs:632-829)."""
        return self.collect_async().result()

    def _device_queries(self) -> torch.Tensor:
        store = self._store
        q = self._queries
        if isinstance(q, list):
            q = np.stack(q, axis=0) if q else np.zeros((0, store._dim), np.float32)
        return _to_device(q, store._device, torch.float32)

    def collect_async(self) -> "PendingMetaQuery":
        """Enqueue the device program without waiting on the device, so
        callers can pipeline batches; ``.result()`` (or ``resolve``)
        finalizes."""
        if self._meta_error is not None:
            raise OttersError(self._meta_error)
        store = self._store
        total_start = time.perf_counter()
        k = self._take_count if self._take_count is not None else store.n_rows
        if self._rerank_from is not None:
            if store._rerank_fetch is None:
                raise OttersError(
                    "take(k, rerank_from=...) requires "
                    "with_rerank_source(...) on the MetaStoreBuilder"
                )
            k = self._rerank_from  # widen the device scan; result() reranks
        take_type = self._take_type or default_take_type(self._metric)
        take_min = take_type is TakeType.Min
        queries = self._device_queries()
        b = queries.shape[0]
        has_filter = self._meta_filter is not None and len(self._meta_filter.clauses) > 0

        prune_start = time.perf_counter()
        if has_filter and store.n_chunks() > 0:
            plan_static, plan_params, used = self._lower_plan()
            cols_sub = {name: store._device_cols[name] for name in used}
        else:
            plan_static, plan_params, cols_sub = (), (), {}
        prune_dur = time.perf_counter() - prune_start

        score_start = time.perf_counter()
        copy = None
        rerun_widened = None
        strict_redo = None
        if store.n_rows > 0 and k > 0 and b > 0:
            if queries.shape[1] != store._dim:
                raise OttersError(
                    f"Query vector length {queries.shape[1]} does not match "
                    f"expected dimension {store._dim}"
                )
            thr, cmp = (None, None) if self._vec_filter is None else self._vec_filter
            n_pad = store._dv.vectors.shape[0]
            certify = False
            if self._rerank_from is not None and self._certify is not False:
                supported = store._certify_supported(
                    self._metric, take_min, None if thr is None else cmp
                )
                if self._certify is True and not supported:
                    if store._dv.vectors.dtype == torch.int8 and store._dv.resid is None:
                        # the one precondition invisible from the plan
                        raise OttersError(
                            "take(certify=True): this int8 store has no "
                            "quantization-residual bounds (it was built "
                            "from pre-quantized codes); certification "
                            "requires quantize-from-f32 ingest"
                        )
                    raise OttersError(
                        "take(certify=True): the exactness certificate "
                        "requires storage quantized from f32 at ingest "
                        "(int8: Cosine + take-max + no/Gt/Gte vec_filter; "
                        "bfloat16: also DotProduct, and Euclidean with "
                        "take-min + no/Lt/Lte vec_filter)"
                    )
                certify = supported
                if certify:
                    # start at the widest scan that recently certified for
                    # this plan shape (filter, vec_filter, k)
                    self._hint_key = repr((
                        self._meta_filter.clauses if self._meta_filter is not None else None,
                        self._vec_filter,
                        self._take_count,
                    ))
                    k = min(max(k, store._cert_kwide_hint.get(self._hint_key, 0)), n_pad)
            if not store._direct_k_ok(k, b):
                if self._certify is True:
                    raise OttersError(
                        "take(certify=True): this k falls into the windowed "
                        "take-all regime, whose streaming program returns "
                        "no certificate bound; drop certify or use a "
                        "device-top-k-sized take"
                    )
                # take-all regime (reference meta.rs:638-640): no device
                # top-k buffer fits, so score windows stream to the host
                copy = _Fetched(store._windowed_collect(
                    cols_sub, queries, plan_params, plan_static, min(k, b * n_pad),
                    self._metric, take_min, thr, cmp,
                ))
            else:

                def run(k_run=k, strict=False):
                    return store._run_query_program(
                        cols_sub, queries, plan_params, 0.0 if thr is None else thr,
                        plan_static, self._metric, k_run, take_min,
                        None if thr is None else cmp, strict=strict, certify=certify,
                    )

                copy = HostCopy(run())
                rerun_widened = run if certify else None
                strict_redo = functools.partial(run, strict=True)
        return PendingMetaQuery(
            plan=self, copy=copy, queries=queries, k=k, take_type=take_type,
            has_filter=has_filter, total_start=total_start, prune_dur=prune_dur,
            score_start=score_start, rerun_widened=rerun_widened,
            strict_redo=strict_redo,
        )


def _cert_kwide_cap() -> int:
    """Widest scan the certificate's auto-widen loop will try
    (OTTERS_CERT_KWIDE_MAX, default 4096)."""
    import os

    return int(os.environ.get("OTTERS_CERT_KWIDE_MAX", "4096"))


def _cert_ok(bound, scores, k_final, vec_filter, take_min=False) -> bool:
    """Host-side certificate decision (see the JAX package's _cert_ok).

    ``bound`` is in the key space: a sound upper bound on the true score of
    every unreturned row (-inf when everything passing was returned)."""
    bnd = float(bound)
    if len(scores) >= int(k_final):
        kth = float(scores[int(k_final) - 1])
        return (-kth if take_min else kth) >= bnd
    if bnd == float("-inf"):
        return True
    if vec_filter is None:
        return False
    thr, cmp = vec_filter
    if cmp is Cmp.Gte:
        return bnd < float(thr)
    if cmp is Cmp.Gt:
        return bnd <= float(thr)
    if cmp is Cmp.Lte:
        return -bnd > float(thr)
    if cmp is Cmp.Lt:
        return -bnd >= float(thr)
    return False


class PendingMetaQuery:
    """In-flight meta query: device program enqueued, results not fetched."""

    def __init__(self, plan: MetaQueryPlan, copy: Optional[HostCopy], queries, k,
                 take_type, has_filter, total_start, prune_dur, score_start,
                 rerun_widened=None, strict_redo=None):
        self._plan = plan
        self._copy = copy
        self._strict_redo = strict_redo
        self._queries = queries
        self._k = k
        self._take_type = take_type
        self._has_filter = has_filter
        self._total_start = total_start
        self._prune_dur = prune_dur
        self._score_start = score_start
        self._rerun_widened = rerun_widened
        self._result: Optional[MetaQueryResults] = None
        self._fetched = None
        self._device_rerank = None  # set by resolve(): (cand set, rows, scores)
        self._certified: Optional[bool] = None
        self._scan_k_wide: Optional[int] = None
        self._stats: Optional[MetaQueryStats] = None

    def stats(self) -> MetaQueryStats:
        """This query's stats (finalizes it first); ``store.last_query_stats``
        only holds the most recently finalized query's."""
        self.result()
        return self._stats

    def _fetch(self) -> tuple:
        """The scan's outputs on the host. A failed fast-exact check (the
        4th output) re-runs the scan strictly in exact f32 here, where the
        outputs are fetched anyway; collect_async never waits for it."""
        if self._fetched is None:
            fetched = self._copy.wait()
            if not bool(fetched[3]) and self._strict_redo is not None:
                fetched = HostCopy(self._strict_redo()).wait()
            self._fetched = fetched
        return self._fetched

    def _exact_rerank(self, indices):
        """Exact-f32 re-rank of a candidate set, re-applying the vec_filter
        on the exact scores before truncating to k."""
        from .evaluate import exact_rerank

        plan = self._plan
        store = plan._store
        rows, scrs = exact_rerank(
            self._queries, indices, store._rerank_fetch, plan._metric,
            len(indices), take_min=(self._take_type is TakeType.Min),
        )
        if plan._vec_filter is not None:
            thr, cmp = plan._vec_filter
            op = CmpOp[cmp.value]
            keep = [i for i, s in enumerate(scrs) if _num_cmp(s, thr, op)]
            rows = [rows[i] for i in keep]
            scrs = [scrs[i] for i in keep]
        return rows[: plan._take_count], scrs[: plan._take_count]

    def result(self) -> MetaQueryResults:
        if self._result is not None:
            return self._result
        plan = self._plan
        store = plan._store
        n_chunks = store.n_chunks()
        b = self._queries.shape[0]
        indices: List[int] = []
        scores: List[float] = []
        evaluated = n_chunks
        rows_eval = store.n_rows
        if self._copy is not None:
            rows, scrs, valid, _check, bound, ev, re_ = self._fetch()
            evaluated = int(ev)
            rows_eval = int(re_)
            ok_np = np.asarray(valid, dtype=bool)
            indices = np.asarray(rows)[ok_np].astype(np.int64).tolist()
            scores = np.asarray(scrs)[ok_np].tolist()

            # exactness guard: verify string-predicate hits host-side; on a
            # hash collision re-run with an exact host row mask (p ~ 2^-64)
            collision_redo = False
            if self._has_filter and plan._has_string_leaf():
                if not all(plan._row_satisfies(i) for i in indices):
                    thr, cmp = (None, None) if plan._vec_filter is None else plan._vec_filter
                    exact_mask = plan._host_exact_row_mask(store._dv.vectors.shape[0])
                    rows, scrs, valid = store._run_exact_mask_query(
                        self._queries, exact_mask, plan._metric, self._k,
                        self._take_type is TakeType.Min, cmp, thr,
                    )
                    ok_np = np.asarray(valid, dtype=bool)
                    indices = np.asarray(rows)[ok_np].astype(np.int64).tolist()
                    scores = np.asarray(scrs)[ok_np].tolist()
                    self._fetched = (rows, scrs, valid, _check, bound, ev, re_)
                    collision_redo = True

            if plan._rerank_from is not None and indices:
                if self._device_rerank is None:
                    # plain collect(): the batched rerank as a group of one
                    state = _device_rerank_dispatch(store, [self])
                    if state is not None:
                        _device_rerank_finish(state[0], state[1], state[2].wait())
                dr = self._device_rerank
                if dr is not None and frozenset(indices) == dr[0]:
                    indices, scores = list(dr[1]), list(dr[2])
                else:
                    # a collision redo changed the candidate set
                    indices, scores = self._exact_rerank(indices)

                if self._rerun_widened is not None:
                    indices, scores, evaluated, rows_eval = self._certify_or_widen(
                        indices, scores, bound, collision_redo, b,
                        evaluated, rows_eval,
                    )
            elif self._rerun_widened is not None:
                # the scan returned ZERO candidates: provably complete (the
                # loosened threshold drops no truly passing row)
                self._certified = not collision_redo
                self._scan_k_wide = self._k
        score_dur = time.perf_counter() - self._score_start

        # ---- merge phase: result-column materialization (host) ----
        merge_start = time.perf_counter()
        col_names = sorted(store.schema().keys())
        data: Dict[str, Column] = {}
        idx = np.asarray(indices, dtype=np.int64)
        for name in col_names:
            src = store.columns()[name]
            dst = Column(name, src.dtype)
            if idx.size:
                nulls = np.asarray(src.null_mask(), dtype=bool)[idx]
                if src.dtype is DataType.String:
                    vals = src.values()
                    sel = [vals[i] for i in idx]
                else:
                    sel = np.asarray(src.values())[idx]
                dst._set_raw(sel, nulls)
            data[name] = dst
        merge_dur = time.perf_counter() - merge_start

        self._stats = store._last_stats = MetaQueryStats(
            total_chunks=n_chunks,
            pruned_chunks=n_chunks - evaluated,
            evaluated_chunks=evaluated,
            vectors_compared=rows_eval * b,
            prune_duration=self._prune_dur,
            score_duration=score_dur,
            merge_duration=merge_dur,
            total_duration=time.perf_counter() - self._total_start,
            certified=self._certified,
            scan_k_wide=self._scan_k_wide,
        )
        self._result = MetaQueryResults(col_names, data, indices, scores)
        return self._result

    def _certify_or_widen(self, indices, scores, bound, collision_redo, b,
                          evaluated, rows_eval):
        """The certificate: the k-th exact rerank score must beat the sound
        bound on every row the scan did not hand to the rerank; otherwise
        re-scan 4x wider (clamped at the fused kernel's k limit and at
        OTTERS_CERT_KWIDE_MAX) until it passes."""
        plan = self._plan
        store = plan._store
        k_used = self._k
        take_min = self._take_type is TakeType.Min
        certified = (not collision_redo) and _cert_ok(
            bound, scores, plan._take_count, plan._vec_filter, take_min
        )
        n_pad = store._dv.vectors.shape[0]
        cap = 0 if collision_redo else min(n_pad, _cert_kwide_cap())
        while not certified and k_used < cap:
            nxt = min(max(k_used * 4, k_used + 1), cap)
            if k_used < fused_topk.FUSED_K_MAX < nxt:
                # try the fused-kernel boundary before leaving it
                nxt = fused_topk.FUSED_K_MAX
            if not store._direct_k_ok(nxt, b):
                lo, hi = k_used, nxt
                while lo < hi:  # largest eligible width by bisection
                    mid = (lo + hi + 1) // 2
                    if store._direct_k_ok(mid, b):
                        lo = mid
                    else:
                        hi = mid - 1
                if lo <= k_used:
                    break
                nxt = cap = lo
            k_used = nxt
            rows, _, valid, _, bound, ev, re_ = HostCopy(
                self._rerun_widened(k_run=k_used)
            ).wait()
            evaluated, rows_eval = int(ev), int(re_)
            ok_np = np.asarray(valid, dtype=bool)
            indices = np.asarray(rows)[ok_np].astype(np.int64).tolist()
            self._device_rerank = None
            if (
                self._has_filter
                and plan._has_string_leaf()
                and not all(plan._row_satisfies(i) for i in indices)
            ):
                # hash collision inside the widened set: redo with the exact
                # host mask; the scan bound no longer speaks for the result
                thr_c, cmp_c = (None, None) if plan._vec_filter is None else plan._vec_filter
                em = plan._host_exact_row_mask(n_pad)
                rows, _, valid = store._run_exact_mask_query(
                    self._queries, em, plan._metric, k_used, take_min, cmp_c, thr_c
                )
                ok_np = np.asarray(valid, dtype=bool)
                indices = np.asarray(rows)[ok_np].astype(np.int64).tolist()
                indices, scores = self._exact_rerank(indices)
                certified = False
                break
            indices, scores = self._exact_rerank(indices)
            certified = _cert_ok(bound, scores, plan._take_count, plan._vec_filter, take_min)
        self._certified = certified
        self._scan_k_wide = k_used
        hk = plan._hint_key
        if (
            certified
            and hk is not None
            and k_used > self._k
            and k_used > store._cert_kwide_hint.get(hk, 0)
        ):
            store._cert_kwide_hint[hk] = k_used
        if not certified:
            warnings.warn(
                f"{store._storage_dtype} exactness certificate did not pass at "
                f"scan width {k_used} (cap {cap}); results "
                "match the quantized-scan + exact-rerank "
                "contract but recall 1.0 is not certified for "
                "this query. Raise OTTERS_CERT_KWIDE_MAX or "
                "widen rerank_from.",
                stacklevel=3,
            )
        return indices, scores, evaluated, rows_eval


def resolve(pendings: List[PendingMetaQuery]) -> List[MetaQueryResults]:
    """Finalize many in-flight queries: wait for their scans, enqueue one
    exact rerank per compatible group (same store, batch shape, metric,
    filter and k), then drain the groups and build the results."""
    todo = [p for p in pendings if p._copy is not None and p._result is None]
    by_group: Dict[tuple, Tuple[MetaStore, list]] = {}
    for p in todo:
        plan = p._plan
        if plan._rerank_from is not None and plan._store._rerank_fetch is not None:
            gkey = (
                id(plan._store), tuple(p._queries.shape), plan._metric,
                p._take_type, plan._vec_filter, plan._take_count,
            )
            by_group.setdefault(gkey, (plan._store, []))[1].append(p)
    for p in todo:
        p._fetch()
    states = []
    for store, plist in by_group.values():
        state = _device_rerank_dispatch(store, plist)
        if state is not None:
            states.append(state)
    for plist, cands, copy in states:
        _device_rerank_finish(plist, cands, copy.wait())
    return [p.result() for p in pendings]


def _str_cmp(v: str, rhs, cmp: CmpOp) -> bool:
    if cmp is CmpOp.Eq:
        return v == rhs
    if cmp is CmpOp.Neq:
        return v != rhs
    raise NotImplementedError(f"string predicate {cmp.value} is not ported yet")


def _num_cmp(v: float, t: float, cmp: CmpOp) -> bool:
    if cmp is CmpOp.Eq:
        return v == t
    if cmp is CmpOp.Neq:
        return v != t
    if cmp is CmpOp.Lt:
        return v < t
    if cmp is CmpOp.Lte:
        return v <= t
    if cmp is CmpOp.Gt:
        return v > t
    return v >= t


def _np_cmp(vals: np.ndarray, t, cmp: CmpOp) -> np.ndarray:
    if cmp is CmpOp.Eq:
        return vals == t
    if cmp is CmpOp.Neq:
        return vals != t
    if cmp is CmpOp.Lt:
        return vals < t
    if cmp is CmpOp.Lte:
        return vals <= t
    if cmp is CmpOp.Gt:
        return vals > t
    return vals >= t
