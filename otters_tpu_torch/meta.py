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
``resolve()`` wait on. ``resolve`` reranks each group of compatible
pendings in one device program. Errors from the kernel or the device
propagate: there is no fallback to another path.

Scoring at scale runs the fused kernels (``ops/fused_topk.py``): f32 and
bfloat16 storage take the verified fast-exact K4 (bf16x3) by default, with a
check that ``result()`` / ``resolve()`` read when they fetch; a failed check
re-runs the scan strictly in exact f32 (K3), as do Eq score filters and
k > 128. The store precision "high" scans with K4, and the one-pass
precisions "default" / "bf16" score one bf16 pass on every path (K6 at
scale). With the certificate (``take(k, rerank_from=...)``) int8 storage
takes K1 (Cosine), bfloat16 storage K1 for Cosine and K5 for Dot and
Euclid; uncertified int8 takes K2. Any depth is taken: the store pads its
rows' depth to a multiple of 16 and the kernels' deep-row plans stream the
query block. The shape route (``fused_topk.kernel_takes``, JAX's
``pallas_ok``) sends a shape to the scan program only when the user asks
for it by name (``OTTERS_DISABLE_PALLAS``). A take(k) too wide for
any device top-k (the take-all regime) streams score windows to the host
(``scoring.collect_all``).

Exactness: string equality evaluates by 64-bit hash on the device and the
returned rows are re-verified host-side against the actual strings; a hash
collision that falsely includes a row re-runs the query with an exact
host-computed row mask.

The extended string predicates (contains / starts_with / ends_with /
fuzzy and their negations) evaluate on the host, where the strings live:
each (column, op, literal) becomes a row mask and an exact per-chunk any()
(``_hostmask_for``, cached), which the device program reads as a
``hostmask`` leaf, so pruning still works.

The VPU metrics (Manhattan, Hamming, Jaccard) score on the plain programs
(``scoring._vpu_scores``); a filtered one at scale skips dead tiles
(``scoring.scan_pruned_topk_core``), and its rerank runs
``evaluate.exact_rerank``. ``precompile`` readies what a deployment serves
and ``cache_stats`` reports the per-store caches.

After its build a store can be laid out for pruning (``with_sort_by`` /
``with_z_order``: the rows are permuted before chunking, and results still
name the original row ids), tombstoned (``delete_rows``: the validity mask,
which every scoring path reads), rebuilt with rows appended (``append``)
and saved to / loaded from one ``.npz`` file (``save`` / ``load``, the JAX
package's format, in ``io.py``).

``MetaStoreBuilder.build_sharded(mesh)`` builds the row-sharded store of
``parallel/meta_sharded.py`` over a device mesh, and ``load`` reads its
per-shard directory format (``sharded-v1``) with or without a mesh. Every
public method of the JAX package's classes exists here.
"""

from __future__ import annotations

import functools
import itertools
import os
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import aot
from ._device import resolve_device
from .column import Column
from .display import format_build_stats, format_query_stats, metastore_head
from .errors import ExprError, OttersError
from .expr import ColumnFilter, CompiledFilter, Expr
from .ops import bloom as bloom_ops
from .ops import fused_topk, hashing, predicate, scoring
from .ops import zonemap as zm
from .ops.scoring import HostCopy
from .utils.profiling import count, span
from .types import (
    NEGATED_CMP,
    NEGATED_STRING_OPS,
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
    """One query's counts and host timers, in seconds of
    ``time.perf_counter()`` (filled whether or not a profiler runs)."""

    total_chunks: int
    pruned_chunks: int
    evaluated_chunks: int
    vectors_compared: int
    # the host seconds of this query's filter lowering and its mask enqueue
    prune_duration: float
    # the sum of this query's own host intervals: its scan's set-up, launch
    # and phase-2 enqueue, its wait for its own outputs, its rerank and
    # certificate (a resolve group's shared intervals split evenly among its
    # members); under pipelining not the wall time from collect_async to the
    # result, which holds the wait behind other queries
    score_duration: float
    # the host materialisation of the results
    merge_duration: float
    # the query's wall latency, from collect_async to its finished result
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

    def to_pandas(self):
        """-> pandas DataFrame (index, score, metadata columns; nullable
        dtypes for nulls). See ``adapters.results_to_pandas``."""
        from .adapters import results_to_pandas

        return results_to_pandas(self)

    def to_arrow(self):
        """-> pyarrow.Table. See ``adapters.results_to_arrow``."""
        from .adapters import results_to_arrow

        return results_to_arrow(self)

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
    evicts the least-recently-used entry. Hit / miss / eviction counters
    make a thrashing workload visible (``MetaStore.cache_stats()``)."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        if key in self:
            self.hits += 1
            val = super().pop(key)
            super().__setitem__(key, val)
            return val
        self.misses += 1
        return default

    def __setitem__(self, key, val):
        if key in self:
            super().pop(key)
        elif len(self) >= self.cap:
            super().pop(next(iter(self)))
            self.evictions += 1
        super().__setitem__(key, val)


def _chunk_offsets(n: int, c: int) -> np.ndarray:
    return np.arange(0, n, c, dtype=np.int64)


def _sort_permutation(col: Column, n: int, descending: bool) -> np.ndarray:
    """Stable permutation ordering rows by a column, nulls always last."""
    nulls = np.asarray(col.null_mask(), dtype=bool)[:n]
    idx_nn = np.flatnonzero(~nulls)
    if col.dtype is DataType.String:
        vals = np.asarray(list(col.values())[:n], dtype=object)
    else:
        vals = np.asarray(col.values())[:n]
    sub = idx_nn[np.argsort(vals[idx_nn], kind="stable")]
    if descending:
        sub = sub[::-1]
    return np.concatenate([sub, np.flatnonzero(nulls)]).astype(np.int64)


def _zorder_permutation(columns, names, n: int) -> np.ndarray:
    """Stable permutation ordering rows along a Z-order (Morton) curve over
    several columns (the reference's roadmap item "Something like
    Z-ordering").

    Each column becomes a dense-rank code (equal values share a code; every
    dtype, String by lexicographic rank) scaled to ``b = min(16, 64 // k)``
    bits, and the codes are bit-interleaved into one uint64 key. Nulls take
    the top code, so they cluster in the high corner of the curve."""
    k = len(names)
    b = min(16, 64 // k)
    top = (1 << b) - 1
    codes = []
    for nm in names:
        colo = columns[nm]
        nulls = np.asarray(colo.null_mask(), dtype=bool)[:n]
        if colo.dtype is DataType.String:
            vals = np.asarray(list(colo.values())[:n], dtype=object)
        else:
            vals = np.asarray(colo.values())[:n]
        code = np.full(n, top, dtype=np.uint64)
        idx_nn = np.flatnonzero(~nulls)
        if idx_nn.size:
            _, ranks = np.unique(vals[idx_nn], return_inverse=True)
            u = int(ranks.max()) if ranks.size else 0
            scaled = (
                (ranks.astype(np.float64) * (top / u)).round().astype(np.uint64)
                if u > 0
                else np.zeros(idx_nn.size, dtype=np.uint64)
            )
            code[idx_nn] = scaled
        codes.append(code)
    key = np.zeros(n, dtype=np.uint64)
    for j in range(b):
        for i, code in enumerate(codes):
            key |= ((code >> np.uint64(j)) & np.uint64(1)) << np.uint64(j * k + i)
    return np.argsort(key, kind="stable").astype(np.int64)


def _permute_column(col: Column, perm: np.ndarray) -> Column:
    new = Column(col.name, col.dtype)
    nulls = np.asarray(col.null_mask(), dtype=bool)[perm]
    if col.dtype is DataType.String:
        vals = col.values()
        new._set_raw([vals[i] for i in perm], nulls)
    else:
        new._set_raw(np.asarray(col.values())[perm], nulls)
    return new


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


_REQUEST_IDS = itertools.count()  # each query's id in its spans (collect_async)


class _HostClock:
    """A query's own host seconds by part (``MetaQueryStats``' timers)."""

    __slots__ = ("prune", "score")

    def __init__(self):
        self.prune = 0.0
        self.score = 0.0


def _charge(clocks, since: float) -> None:
    """Add the seconds since ``since`` to the score time of the queries
    whose ``clocks`` shared them, split evenly."""
    dt = (time.perf_counter() - since) / len(clocks)
    for c in clocks:
        c.score += dt


class _Part:
    """A span of one part of the scoring whose host seconds count in the
    score time of the queries whose ``clocks`` share it (:func:`_charge`),
    whether or not a profiler runs."""

    __slots__ = ("clocks", "span", "t0")

    def __init__(self, name: str, clocks, request=None):
        self.clocks = clocks
        self.span = span(name, request)

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.span.__enter__()

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        _charge(self.clocks, self.t0)
        return False


def _wait(copy, clocks, request=None) -> tuple:
    """``copy.wait()``: the host blocked on the device for the queries
    whose ``clocks`` wait on it."""
    with _Part("otters.finish.wait", clocks, request):
        return copy.wait()


def _fetch_vectors(store, ids):
    """The user's rerank source for the original row ids ``ids``."""
    with span("otters.fetch_vectors"):
        count("otters.fetch_rows", len(ids))
        return store._rerank_fetch(ids)


# ---------------------------------------------------------------------------
# Device state construction
# ---------------------------------------------------------------------------


class _StagedColumn(NamedTuple):
    """One column's host arrays, ready to be placed on a device in row
    ranges: the repr, the values (None for strings), the null mask and, for
    strings, the 64-bit hash pair of every row."""

    rep: str
    vals: Optional[np.ndarray]
    nulls: np.ndarray
    hashes: Optional[Tuple[np.ndarray, np.ndarray]]


def _stage_column(col: Column, n: int) -> _StagedColumn:
    """The host side of a column's device state (its first ``n`` rows)."""
    nulls = np.asarray(col.null_mask(), dtype=bool)[:n]
    dt = col.dtype

    def vals(np_dtype):
        return np.ascontiguousarray(np.asarray(col.values(), dtype=np_dtype)[:n])

    if dt is DataType.Int32:
        return _StagedColumn("i32", vals(np.int32), nulls, None)
    if dt is DataType.Bool:
        # 0/1 int32 on the device: zonemap min/max prune chunks for Eq
        # literals, matching the reference rule (type_utils.rs:446-584)
        b01 = np.asarray(col.values(), dtype=np.bool_)[:n].astype(np.int32)
        return _StagedColumn("i32", b01, nulls, None)
    if dt is DataType.Float32:
        return _StagedColumn("f32", vals(np.float32), nulls, None)
    if dt in (DataType.Int64, DataType.DateTime):
        return _StagedColumn("i64", vals(np.int64), nulls, None)
    if dt is DataType.Float64:
        return _StagedColumn("f64", vals(np.float64), nulls, None)
    # String: hashes come from the host (strings never live on the device)
    strings = list(col.values())[:n]
    return _StagedColumn("str", None, nulls, hashing.hash_strings(strings))


_ZONEMAP_BUILDS = {"i32": zm.build_i32, "f32": zm.build_f32, "i64": zm.build_i64,
                   "f64": zm.build_f64}


def _column_state(st: _StagedColumn, lo: int, hi: int, n_pad: int, chunk_size: int,
                  n_chunks: int, device) -> Dict[str, torch.Tensor]:
    """Rows ``[lo, hi)`` of a staged column as an ``n_pad``-row device
    state over ``n_chunks`` chunks (padding rows null), without the Bloom
    words: the values or identity hashes, the null mask and the zonemaps,
    computed on the device (ops/zonemap.py), replacing the reference's
    host fold (meta_compute.rs:32-132)."""
    nulls = torch.from_numpy(st.nulls[lo:hi].copy()).to(device)
    kw = dict(c=chunk_size, n_chunks=n_chunks, n_pad=n_pad)
    if st.rep == "str":
        g1 = np.ascontiguousarray(st.hashes[0][lo:hi])
        rh = torch.from_numpy(g1.view(np.int64)).to(device)
        return zm.build_str_rows(rh, nulls, **kw)
    vals = torch.from_numpy(np.ascontiguousarray(st.vals[lo:hi])).to(device)
    return _ZONEMAP_BUILDS[st.rep](vals, nulls, **kw)


def _bloom_params(bloom_cfg, chunk_size: int) -> bloom_ops.BloomParams:
    kind, val = bloom_cfg
    if kind == "fpr":
        return bloom_ops.BloomParams.from_fpr(val, chunk_size)
    return bloom_ops.BloomParams.from_bits(val, chunk_size)


def _bloom_on_device() -> bool:
    """OTTERS_BLOOM_DEVICE (the JAX package's switch): unset / "0" /
    "false" / "" = the host build; any other value = the device build
    where its geometry allows. Both give the same bits."""
    env = os.environ.get("OTTERS_BLOOM_DEVICE")
    return env is not None and env.lower() not in ("0", "false", "")


def _build_device_column(col: Column, n: int, n_pad: int, chunk_size: int,
                         n_chunks: int, bloom_cfg, device):
    """-> (repr, device dict of tensors, bloom params or None) for one
    column. String hashes and Bloom bits come from the host (strings never
    live on the device); padding and non-null counts run on the device."""
    st = _stage_column(col, n)
    dev = _column_state(st, 0, n, n_pad, chunk_size, n_chunks, device)
    if st.rep != "str":
        return st.rep, dev, None
    params = _bloom_params(bloom_cfg, chunk_size)
    g1, g2 = st.hashes
    if _bloom_on_device() and bloom_ops.device_build_ok(params, n_chunks):
        dev["bloom"] = bloom_ops.build_matrix_device(
            g1, g2, st.nulls, chunk_size, n_chunks, params, device
        )
    else:
        chunk_ids = np.arange(n, dtype=np.int64) // chunk_size
        matrix = bloom_ops.build_matrix(
            g1, g2, st.nulls, chunk_ids, n_chunks, params, chunk_size=chunk_size
        )
        dev["bloom"] = bloom_ops.to_device(matrix, device)
    return "str", dev, params


# ---------------------------------------------------------------------------
# The query program
# ---------------------------------------------------------------------------


def _device_program(dv: scoring.DeviceVecs, chunk_lens, chunk_size: int, cols, plan_static,
                    plan_params, queries, thr, launch: "_Launch", *, metric, k, take_min, cmp,
                    prec, q_valid=None, mesh_cert=None, with_maxima=False, local_plan=None,
                    clock=None):
    """One device's whole meta query, enqueued without waiting: a single
    store's, or one shard's of a mesh (:mod:`.parallel.meta_sharded`):

    zonemap chunk-mask pruning + stats -> row-mask predicate tensors ->
    scoring with fused masking -> exact top-k over the device's rows (the
    fusion of the reference's prune/score/merge phases, meta.rs:632-709).

    ``launch`` gives the tile program and the modes. certify (int8 / bf16 +
    rerank): the 5th output is a sound bound, in the key space (negated for
    take-min), on the true score of every row NOT among the returned
    candidates; -inf otherwise. fast (f32 / bf16 rows): the 4th output is
    the fast-exact check, False when the query must be re-run strictly.
    ``q_valid`` marks a padded batch's real queries. ``mesh_cert`` (a
    mesh's certified direct / panel programs): this device's
    ``scoring.cert_terms`` and the mesh-wide slack, in place of the
    device's own. ``with_maxima`` (a mesh's certified fused programs): an
    8th output, the six maxima of the certificate terms the fused scan
    reduced for its own slack (``scoring.cert_maxima``'s scalars), which
    the mesh composes its slack from. ``local_plan`` and ``clock``: see
    :func:`_device_masks` and ``_HostClock`` (the host seconds of the masks
    go to pruning, the rest to scoring). Returns device tensors (rows,
    scores, ok, check, bound, evaluated, rows_eval), rows local to the
    device."""
    t0 = time.perf_counter()
    with span("otters.submit.masks"):
        evaluated, rows_eval, rmask, alive = _device_masks(
            dv, chunk_lens, chunk_size, cols, plan_static, plan_params, launch.tile,
            local_plan=local_plan)
    t1 = time.perf_counter()
    out = _device_scores(dv, queries, rmask, alive, thr, launch, metric=metric, k=k,
                         take_min=take_min, cmp=cmp, prec=prec, q_valid=q_valid,
                         mesh_cert=mesh_cert, with_maxima=with_maxima)
    if clock is not None:
        clock.prune += t1 - t0
        clock.score += time.perf_counter() - t1
    return (*out[:5], evaluated, rows_eval, *out[5:])


def _device_masks(dv: scoring.DeviceVecs, chunk_lens, chunk_size: int, cols, plan_static,
                  plan_params, tile=None, local_plan=None):
    """A device's pruning, enqueued -> (evaluated chunks, their rows, the
    row mask or None, the live 512-row bins of the fused scan or the live
    tiles of the pruned VPU scan, else None). ``local_plan`` (a shard's)
    maps the store's columns and plan parameters to the shard's; unfiltered,
    a shard then counts only its chunks with rows (its padding chunks have
    none), where a single store counts all of its chunks."""
    dev = dv.vectors.device
    n_pad = dv.vectors.shape[0]
    n_chunks = chunk_lens.shape[0]
    if plan_static:
        if local_plan is not None:
            cols, plan_params = local_plan(cols, plan_params)
        cmask = predicate.chunk_mask(plan_static, plan_params, cols, n_chunks, dev)
        evaluated = cmask.sum(dtype=torch.int32)
        rows_eval = (chunk_lens * cmask).sum(dtype=torch.int32)
        rmask = predicate.row_mask(plan_static, plan_params, cols, n_pad, dev)
    else:
        if local_plan is None:
            evaluated = torch.full((), n_chunks, dtype=torch.int32, device=dev)
        else:
            evaluated = (chunk_lens > 0).sum(dtype=torch.int32)
        rows_eval = chunk_lens.sum(dtype=torch.int32)
        rmask = None
    alive = None
    if tile == "fused":
        # the hand-written kernel: pruned bins cost no loads and no math
        if plan_static:
            alive = fused_topk.bins_alive_from_chunk_mask(cmask, chunk_size, n_pad)
        else:
            alive = torch.ones(n_pad // fused_topk.BIN, dtype=torch.bool, device=dev)
    elif tile == "scan_pruned":
        # the pruning path of the VPU metrics: dead tiles are never read
        if plan_static:
            alive = scoring.tiles_alive_from_chunk_mask(cmask, chunk_size, n_pad,
                                                        scoring.SCAN_TILE)
        else:
            alive = torch.ones(n_pad // scoring.SCAN_TILE, dtype=torch.bool, device=dev)
    return evaluated, rows_eval, rmask, alive


def _device_scores(dv: scoring.DeviceVecs, queries, rmask, alive, thr, launch: "_Launch", *,
                   metric, k, take_min, cmp, prec, q_valid, mesh_cert, with_maxima):
    """A device's scoring, enqueued -> (rows, scores, ok, check, bound), and
    the certificate's maxima with ``with_maxima`` (see :func:`_device_program`)."""
    tile, certify = launch.tile, launch.certify
    if tile == "fused":
        return fused_topk.fused_topk(
            dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, queries, rmask,
            thr, alive, metric=metric, k=k, take_min=take_min, cmp=cmp,
            certify=certify, prec=prec, fast=launch.fast, resid=dv.resid, q_valid=q_valid,
            with_maxima=with_maxima,
        )

    # direct / scan / panel / scan_pruned: one global certificate term; the certified scan runs
    # MIXED (bf16-rounded queries x stored rows), signaled to _score_block
    # by the bf16 query dtype
    with span("otters.submit.scan_setup"):
        thr_core = thr
        q_core = queries
        if certify:
            if mesh_cert is None:
                terms = scoring.cert_terms(metric, queries, dv.vectors.dtype, dv.resid,
                                           dv.inv_norms, dv.norms_sq, dv.vectors.shape[1])
                slack = scoring.cert_global_slack(*terms[1:], dv.norms_sq)
            else:
                terms, slack = mesh_cert
            thr_core = scoring.loosened(thr, slack, cmp)
            q_core = terms[0].to(torch.bfloat16)  # qh32
    args = (dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, q_core, rmask, thr_core)
    kwargs = dict(metric=metric, k=k, take_min=take_min, cmp=cmp, q_valid=q_valid, prec=prec)
    with span("otters.submit.launch"):
        if tile == "scan_pruned":
            rows, scores, ok = scoring.scan_pruned_topk_core(
                *args, alive, tile=scoring.SCAN_TILE, **kwargs
            )
        elif tile == "panel":
            rows, scores, ok = scoring.panel_topk_core(*args, **kwargs)
        elif tile == "scan":
            rows, scores, ok = scoring.scan_topk_core(*args, tile=scoring.SCAN_TILE, **kwargs)
        else:
            rows, scores, ok = scoring.direct_topk_core(*args, **kwargs)
    with span("otters.submit.phase2"):
        if certify:
            # every unreturned candidate's scan key <= the k-th returned one
            # (exact top-k over the device's rows); with fewer than k valid
            # candidates every passing row was returned and nothing is
            # unexamined
            kth_key = -scores[-1] if take_min else scores[-1]
            bound = torch.where(ok[-1], kth_key + slack, float("-inf"))
        else:
            bound = torch.full((), float("-inf"), device=dv.vectors.device)
        check = torch.ones((), dtype=torch.bool, device=dv.vectors.device)
    return rows, scores, ok, check, bound


def _rerank_scores(q: torch.Tensor, v: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Exact f32 scores [..., B, M] of queries [..., B, D] vs rows [..., M, D]
    (the formulas of evaluate.exact_rerank; full f32, like HIGHEST). The
    VPU metrics take 2-D operands only (:func:`scoring._vpu_scores` over f32
    rows)."""
    if metric in VPU_METRICS:
        return scoring._vpu_scores(q, v, metric)
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
    if metric in VPU_METRICS:
        # a [P, B, M, D] broadcast would blow memory: the host rerank
        # (evaluate.exact_rerank) over resolve's one union prefetch
        return None
    dev = store._device
    k_final = plan0._take_count
    take_min = plist[0]._take_type is TakeType.Min
    cands = []
    for p in plist:
        rows, _, valid = p._fetched[0], p._fetched[1], p._fetched[2]
        idx = np.asarray(rows)[np.asarray(valid, dtype=bool)].astype(np.int64)
        if store._index_map is not None:
            idx = store._index_map[idx]  # the rerank source takes original ids
        # dedup preserving first-seen (scan output) order: tie-breaking in
        # the rerank follows this slot order
        _, first = np.unique(idx, return_index=True)
        cand = idx[np.sort(first)]
        if cand.size == 0:
            return None
        cands.append(cand)
    m = max(len(c) for c in cands)
    ids_arr = np.unique(np.concatenate(cands))
    vecs = _to_device(_fetch_vectors(store, ids_arr), dev, torch.float32)
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


def _same_device(have: torch.device, want: torch.device) -> bool:
    """Is ``have`` (a tensor's device) the device ``want`` names? A CUDA
    device named without an index is the current one."""
    if have.type != want.type:
        return False
    if want.type == "cuda" and want.index is None:
        return have.index == torch.cuda.current_device()
    return want.index is None or have.index == want.index


class _Launch(NamedTuple):
    """A shape's launch decision (its program in ``aot._mem``): the tile
    program ("fused", "direct", "scan", "panel" or "scan_pruned"), the
    fast-exact and certified modes, and for the fused tile its kernel
    (``fused_topk.KERNELS`` key; its ring depends on the batch too and is
    chosen at the launch) and the ``csrc/`` sources it needs (a fast
    launch's strict rerun included)."""

    tile: str
    fast: bool
    certify: bool
    mode: Optional[str] = None
    sources: Tuple[str, ...] = ()


class MetaStoreBuilder:
    """Builder (reference meta.rs:62-110, 113-148)."""

    def __init__(self, schema: Dict[str, DataType], columns: Dict[str, Column]):
        self._schema = dict(schema)
        self._columns = dict(columns)
        self._vectors = None
        self._vectors_n = None
        self._chunk_size = 1024
        self._bloom: Tuple[str, float] = ("fpr", 0.01)
        self._sort_by = None
        self._z_order = None
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
          original ingestion-order row ids (a sorted store's too);
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
        """Supply vectors: a [n, d] numpy array / list of rows; a [n, d]
        ``torch.Tensor`` on the store's device (ingested there, no host
        round trip); or a pre-built ``scoring.DeviceVecs`` (e.g. from
        ``scoring.materialize_int8_slabs`` for stores too large to exist in
        f32), adopted as-is with its storage dtype (``n_rows`` is required
        then).

        For a large tensor, pad its rows to ``scoring.pad_rows(n)`` and pass
        the logical row count as ``n_rows``: float32 storage then adopts the
        tensor itself (zero-copy, the store's rows have its ``data_ptr()``)
        when its depth is a multiple of 16; another depth is copied once
        into rows padded to one. int8 and bfloat16 storage are written slab
        by slab (``scoring.materialize_from_device``)."""
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

    def with_sort_by(self, column: str, descending: bool = False) -> "MetaStoreBuilder":
        """Cluster rows by a column before chunking (the reference's roadmap
        "Z-ordering" item): zonemap pruning bites when rows are clustered by
        the filter's columns. Result indices still refer to the original
        ingestion order."""
        self._sort_by = (column, bool(descending))
        return self

    def with_z_order(self, columns) -> "MetaStoreBuilder":
        """Cluster rows along a Z-order (Morton) curve over several columns
        before chunking, so zonemaps prune filters on any of them. Result
        indices still refer to the original ingestion order. Mutually
        exclusive with ``with_sort_by``; 1-8 columns."""
        if isinstance(columns, str):
            columns = [columns]  # a lone name, not its characters
        names = [str(c) for c in columns]
        if not 1 <= len(names) <= 8:
            raise OttersError("with_z_order takes between 1 and 8 columns")
        if len(set(names)) != len(names):
            raise OttersError("with_z_order columns must be distinct")
        self._z_order = tuple(names)
        return self

    def build_sharded(self, mesh) -> "MetaStore":
        """Build a ``ShardedMetaStore`` over ``mesh`` (``parallel.make_mesh``)
        by direct sharded ingest: every row shard's vectors, columns,
        zonemaps and Bloom words are placed on its own mesh device, so the
        store never exists whole on one device. See
        ``parallel.meta_sharded.build_sharded``."""
        from .parallel.meta_sharded import build_sharded

        return build_sharded(self, mesh)

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
            if not _same_device(vectors.vectors.device, device):
                raise OttersError(
                    f"the pre-built DeviceVecs live on {vectors.vectors.device}, "
                    f"the store on {device}"
                )
            if self._sort_by is not None or self._z_order is not None:
                raise OttersError(
                    "with_sort_by / with_z_order are not supported for "
                    "pre-built DeviceVecs (generate the slabs in sorted "
                    "order instead)"
                )
            n_rows = int(self._vectors_n)
            dim = int(vectors.vectors.shape[1])
            self._storage_dtype = _STORAGE_NAMES[vectors.vectors.dtype]
        from_device = (not pre_built) and isinstance(vectors, torch.Tensor)
        if from_device:
            if not _same_device(vectors.device, device):
                raise OttersError(
                    f"the vectors tensor lives on {vectors.device}, "
                    f"the store on {device}"
                )
            n_rows, dim = int(vectors.shape[0]), int(vectors.shape[1])
            if self._vectors_n is not None:
                n_rows = int(self._vectors_n)  # pre-padded zero-copy ingest
        elif pre_built:
            pass
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
                # snapshot before any sort / Z-order permutation: rerank
                # ids are original ingestion-order row ids
                if from_device:
                    # one copy to the host, as the JAX package's np.asarray
                    host_f32 = vectors[:n_rows].float().cpu().numpy()
                else:
                    host_f32 = np.asarray(vectors, dtype=np.float32)[:n_rows]

                def rerank_fetch(ids, _hf=host_f32):
                    return _hf[np.asarray(ids, dtype=np.int64)]

            else:
                rerank_fetch = fetch

        build_start = time.perf_counter()

        index_map = None
        orig_columns = None
        perm = None
        if self._sort_by is not None and self._z_order is not None:
            raise OttersError("with_sort_by and with_z_order are mutually exclusive")
        if self._sort_by is not None:
            sort_col, desc = self._sort_by
            if sort_col not in self._schema:
                raise OttersError(f"unknown column '{sort_col}' not present in schema")
            perm = _sort_permutation(self._columns[sort_col], n_rows, desc)
        elif self._z_order is not None:
            for nm in self._z_order:
                if nm not in self._schema:
                    raise OttersError(f"unknown column '{nm}' not present in schema")
            perm = _zorder_permutation(self._columns, self._z_order, n_rows)
        order = None  # a device tensor's row order: perm, then its padding rows
        if perm is not None:
            orig_columns = self._columns
            self._columns = {name: _permute_column(c, perm) for name, c in self._columns.items()}
            if from_device:
                perm_full = np.concatenate([perm, np.arange(n_rows, int(vectors.shape[0]))])
                order = torch.from_numpy(perm_full).to(vectors.device)
            else:
                vectors = vectors[perm]
            index_map = perm  # new position -> original row id

        ingest_start = time.perf_counter()
        if pre_built:
            dv = vectors
        elif from_device:
            dv = scoring.materialize_from_device(
                vectors, n_valid=n_rows, dtype=getattr(torch, self._storage_dtype),
                order=order,
            )
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
        store._bloom_config = self._bloom
        store._index_map = index_map
        store._orig_columns = orig_columns
        store._sort_by = self._sort_by
        store._z_order = self._z_order
        store._storage_dtype = self._storage_dtype
        store._rerank_fetch = rerank_fetch
        store._rerank_config = self._rerank
        if self._rerank is not None and self._rerank[1]:
            store._rerank_host = host_f32  # save / append reuse it
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
        self._index_map = None  # set when built with with_sort_by / with_z_order
        self._inv_index_map = None  # its inverse, built once (see _positions)
        self._z_order = None
        self._orig_columns = None
        self._sort_by = None
        self._storage_dtype = "float32"
        self._n_deleted = 0
        self._rerank_fetch = None
        self._rerank_config = None  # the builder's (fetch, keep) tuple
        self._rerank_host = None  # the keep_host_f32 snapshot (original order)
        # per-(filter, vec_filter, k) scan widths that recently certified
        self._cert_kwide_hint = _LruCache(64)
        # the per-store LRU caches under the JAX package's names and caps
        # (cache_stats): lowered plans; the per-shape aot signature (the
        # JAX package's AOT signature memo, keyed alike); the host masks of
        # extended string predicates
        self._plan_cache = _LruCache(256)
        self._aot_key_cache = _LruCache(512)
        self._hostmask_cache = _LruCache(128)
        # one packed UTF-8 arena per string column, shared by every literal
        self._str_arena_cache: Dict = {}
        self._bloom_config = ("fpr", 0.01)
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
        return self._n_rows - self._n_deleted

    def last_query_stats(self) -> Optional[MetaQueryStats]:
        return self._last_stats

    def build_stats(self) -> Optional[MetaBuildStats]:
        return self._build_stats

    def cert_hints(self) -> Dict[str, int]:
        """Certificate scan-width hints that certified, keyed per plan shape
        (filter, vec_filter, k)."""
        return dict(self._cert_kwide_hint)

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Size / hit / miss / eviction counters of the per-store LRU caches
        (plan lowering, the per-shape signature memo ``aot_key``, the host masks
        of extended string predicates ``hostmask``). A growing
        ``evictions`` count on a steady workload means the working set
        exceeds the cap."""
        return {
            name: {
                "size": len(c),
                "capacity": c.cap,
                "hits": c.hits,
                "misses": c.misses,
                "evictions": c.evictions,
            }
            for name, c in (
                ("plan", self._plan_cache),
                ("aot_key", self._aot_key_cache),
                ("hostmask", self._hostmask_cache),
            )
        }

    def _positions(self) -> np.ndarray:
        """A sorted store's original row id -> its position: the inverse of
        the index map, built at first use and kept (a scatter over every
        row, too slow to repeat for each query at 10M rows)."""
        if self._inv_index_map is None:
            inv = np.empty(self._n_rows, dtype=np.int64)
            inv[self._index_map] = np.arange(self._n_rows)
            self._inv_index_map = inv
        return self._inv_index_map

    def _restore_cert_hints(self, hints) -> None:
        for key, width in (hints or {}).items():
            self._cert_kwide_hint[str(key)] = int(width)

    # -- mutability (reference roadmap: "add/remove rows after build") -------
    def delete_rows(self, indices) -> None:
        """Tombstone rows in place (original row ids): deleted rows are never
        returned.

        The validity mask, which every scoring path reads, is updated on the
        device; zonemaps stay conservative (a chunk whose only matching rows
        were deleted may still be evaluated). ``append`` compacts
        tombstones."""
        idx = np.unique(np.asarray(list(indices), dtype=np.int64))
        if idx.size == 0:
            return
        if idx.min() < 0 or idx.max() >= self._n_rows:
            raise OttersError(f"delete index out of range 0..{self._n_rows - 1}")
        if self._index_map is not None:
            idx = self._positions()[idx]  # original ids -> current positions
        valid = self._host_valid().copy()
        newly = int(valid[idx].sum())
        valid[idx] = False
        self._dv = self._dv._replace(valid=self._place_valid(valid))
        self._n_deleted += newly

    def _host_valid(self) -> np.ndarray:
        """[n_pad] validity mask on the host."""
        return self._host_gather(self._dv.valid)

    def _host_gather(self, arr: torch.Tensor) -> np.ndarray:
        """Device tensor -> host numpy (bfloat16 upcast exactly to f32)."""
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.cpu().numpy()

    def _place_resid(self, resid_host: np.ndarray) -> None:
        """Place an [n_pad] residual array on the device and re-derive its
        bins and maximum."""
        r = torch.where(self._dv.valid, _to_device(resid_host, self._device, torch.float32), 0.0)
        rbin, rmax = scoring.finalize_resid(r)
        self._dv = self._dv._replace(resid=r, resid_bin=rbin, resid_max=rmax)

    def _carry_resid_forward(self, new: "MetaStore") -> None:
        """Quantized append without keep_host_f32: the rebuild re-quantizes
        the codes (int8: idempotent; bf16: exact), so the new store's
        recomputed residuals collapse toward 0 -- sound against the codes,
        not against the original source. Surviving rows therefore keep their
        original residuals (always >= the recomputed ones); appended rows
        keep the rebuild's."""
        if (
            self._storage_dtype not in ("int8", "bfloat16")
            or self._rerank_config is not None
            or self._dv is None
            or self._dv.resid is None
            or new._dv is None
            or new._dv.resid is None
        ):
            return
        n = self._n_rows
        old_resid = self._host_gather(self._dv.resid)[:n]
        valid = self._host_valid()[:n]
        if self._index_map is not None:
            inv = self._positions()
            old_resid = old_resid[inv]  # device -> original order
            valid = valid[inv]
        carried = old_resid[np.flatnonzero(valid)]
        n_keep = len(carried)
        resid_new = new._host_gather(new._dv.resid).copy()
        if new._index_map is not None:
            orig = np.asarray(new._index_map, dtype=np.int64)
            dev_pos = np.flatnonzero(orig < n_keep)
            resid_new[dev_pos] = carried[orig[dev_pos]]
        else:
            resid_new[:n_keep] = carried
        new._place_resid(resid_new)

    def _place_valid(self, valid: np.ndarray) -> torch.Tensor:
        """The updated [n_pad] validity mask, on the device."""
        return _to_device(valid, self._device)

    def append(self, vectors, column_values: Dict[str, list]) -> "MetaStore":
        """Return a new store with rows appended (tombstones compacted), on
        this store's device.

        Rebuilds chunking / zonemaps / Bloom with the same configuration
        (chunk size, Bloom, sort or Z-order, storage dtype, precision); row
        ids in the new store are fresh (0..n-1 over surviving + new rows).
        A ``keep_host_f32`` rerank source carries over (the true f32
        snapshot is re-sourced, not the quantized storage); a
        ``fetch_vectors`` source cannot -- ids change under compaction -- so
        append raises then."""
        new = self._append_builder(vectors, column_values).build()
        new.precision = self.precision
        self._carry_resid_forward(new)
        return new

    def _append_prep(self, vectors, column_values):
        """Shared append validation + column assembly (host side) -> (keep,
        inv_order, new_vecs, cols, cfg); ``keep`` holds the surviving rows
        in original ingestion order."""
        n = self._n_rows
        valid = self._host_valid()[:n]
        src_cols = self._orig_columns if self._orig_columns is not None else self._columns
        inv_order = None
        if self._index_map is not None:
            # the device rows are in sorted order; restore original order
            inv_order = self._positions()
            valid = valid[inv_order]
        cfg = self._rerank_config
        if cfg is not None and not cfg[1]:
            raise OttersError(
                "append on a store with a fetch_vectors rerank source: row "
                "ids change under compaction and the fetch cannot describe "
                "the appended rows; rebuild via MetaStore.from_columns(...)"
                ".with_rerank_source(fetch) with an updated fetch"
            )
        keep = np.flatnonzero(valid)
        new_vecs = np.asarray(vectors, dtype=np.float32)
        if new_vecs.ndim != 2 or (n and new_vecs.shape[1] != self._dim):
            raise OttersError(f"appended vectors must be [m, {self._dim}]")
        m = new_vecs.shape[0]
        cols = []
        for name in self._schema:
            vals_new = column_values.get(name)
            if vals_new is None or len(vals_new) != m:
                raise OttersError(f"column '{name}' needs {m} appended values")
            kept = _permute_column(src_cols[name], keep)
            for v in vals_new:
                kept.push(v)
            cols.append(kept)
        return keep, inv_order, new_vecs, cols, cfg

    def _append_configured_builder(self, cols) -> "MetaStoreBuilder":
        """A builder carrying this store's configuration (no vectors yet)."""
        builder = MetaStore.from_columns(cols).with_chunk_size(self._chunk_size)
        kind, val = self._bloom_config
        builder = (
            builder.with_bloom_fpr(val) if kind == "fpr" else builder.with_bloom_bits(int(val))
        )
        if self._sort_by is not None:
            builder = builder.with_sort_by(self._sort_by[0], self._sort_by[1])
        if self._z_order is not None:
            builder = builder.with_z_order(self._z_order)
        return builder.with_storage_dtype(self._storage_dtype).with_device(self._device)

    def _append_builder(self, vectors, column_values) -> "MetaStoreBuilder":
        """A configured builder over surviving + new rows in original
        ingestion order (tombstones compacted).

        Quantized stores without ``keep_host_f32`` rebuild from their codes:
        re-quantizing int8 codes is idempotent (each row's max |code| is
        127, so the scale is 1 and every code rounds to itself), so the
        surviving rows' codes are bit-identical across append generations."""
        n = self._n_rows
        keep, inv_order, new_vecs, cols, cfg = self._append_prep(vectors, column_values)
        if cfg is not None:
            # keep_host_f32: re-source the true f32 rows (original order)
            old_vecs = (
                self._rerank_host[:n]
                if self._rerank_host is not None
                else np.asarray(self._rerank_fetch(np.arange(n, dtype=np.int64)),
                                dtype=np.float32)
            )
        else:
            old_vecs = self._host_gather(self._dv.vectors[:n])
            if inv_order is not None:
                old_vecs = old_vecs[inv_order]
        builder = self._append_configured_builder(cols).with_vectors(
            np.concatenate([old_vecs[keep].astype(np.float32), new_vecs], axis=0)
        )
        if cfg is not None:
            builder = builder.with_rerank_source(keep_host_f32=True)
        return builder

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """Serialize to one file (``io.save_meta``; an .npz, no pickling,
        the JAX package's format)."""
        from . import io

        io.save_meta(self, path)

    @staticmethod
    def load(path: str, mesh=None, *, device=None) -> "MetaStore":
        """Load a store saved by ``save`` (or by the JAX package) onto
        ``device`` (default: the current CUDA device), or with ``mesh`` as
        the row-sharded store over that mesh (``parallel.ShardedMetaStore``;
        a ``sharded-v1`` directory or a single file)."""
        from . import io

        return io.load_meta(path, mesh=mesh, device=device)

    # -- warm-up ---------------------------------------------------------------
    def precompile(self, filters=None, batch_sizes=(1, 256), k: int = 10,
                   metric: Metric = Metric.Cosine, with_vec_filter: bool = False,
                   rerank_from: Optional[int] = None, pipeline_depths=(1,),
                   cert_widths: bool = True) -> int:
        """Ready the programs a deployment serves, off the query path, and
        return how many were readied (the JAX package's count for the same
        store and arguments). ``filters`` is a list of expressions (None =
        unfiltered), each combined with every batch size.

        Readying a program: its launch decision enters ``aot``'s table, the
        kernel libraries it needs are loaded, or built by nvcc into
        ``aot.cache_dir()`` (on a CUDA store only), the plan and ``aot_key``
        memos are filled, and the program runs once. ``rerank_from`` also
        warms the exact-rerank flow once per (filter, batch size, pipeline depth in ``pipeline_depths``)
        with seeded random queries; ``cert_widths`` (where the certificate
        applies) readies the certificate's widen ladder, 4x steps from
        ``rerank_from`` clamped like the widen loop, without running it."""
        count = self._precompile_rerank(
            filters, batch_sizes, k, metric, rerank_from, pipeline_depths
        )
        for expr in filters if filters is not None else [None]:
            for b in batch_sizes:
                plan = MetaQueryPlan(self, np.zeros((int(b), self._dim), np.float32), metric)
                if expr is not None:
                    plan.meta_filter(expr)
                    if plan._meta_error is not None:
                        raise OttersError(plan._meta_error)
                has_filter = plan._meta_filter is not None and len(plan._meta_filter.clauses) > 0
                if has_filter and self.n_chunks() > 0:
                    plan_static, plan_params, used = plan._lower_plan()
                    cols_sub = {nm: self._device_cols[nm] for nm in used}
                else:
                    plan_static, plan_params, cols_sub = (), (), {}
                queries = plan._device_queries()
                take_min = default_take_type(metric) is TakeType.Min
                variants = [(0.0, None)]
                if with_vec_filter:
                    variants.append((0.0, Cmp.Lt if take_min else Cmp.Gt))
                for thr, cmp in variants:
                    launch, k_eff = self._prepare_program(
                        queries, plan_static, metric, k, take_min, cmp
                    )
                    # run once: validates the readied launch
                    HostCopy.of(self._run_prepared(
                        launch, k_eff, cols_sub, queries, plan_params, thr, plan_static,
                        metric, take_min, cmp,
                    )).wait()
                    count += 1
                if (
                    cert_widths
                    and rerank_from is not None
                    and self._certify_supported(metric, take_min, None)
                ):
                    # the widen ladder (readied, not run): the width sequence
                    # result() dispatches on a failed certificate, clamped
                    # like the widen loop
                    w = int(rerank_from)
                    cap = min(self._dv.vectors.shape[0], _cert_kwide_cap())
                    while w < cap:
                        nxt = min(max(w * 4, w + 1), cap)
                        if w < fused_topk.FUSED_K_MAX < nxt:
                            nxt = fused_topk.FUSED_K_MAX
                        if not self._direct_k_ok(nxt, int(b)):
                            break
                        self._prepare_program(
                            queries, plan_static, metric, nxt, take_min, None, certify=True
                        )
                        count += 1
                        w = nxt
        return count

    def _precompile_rerank(self, filters, batch_sizes, k, metric, rerank_from,
                           pipeline_depths) -> int:
        """Warm the rerank flow: one resolve() per (filter, batch size,
        depth), each pending with distinct seeded random queries (zero
        queries all tie and collapse every candidate set)."""
        if rerank_from is None:
            return 0
        if self._rerank_fetch is None:
            raise OttersError(
                "precompile(rerank_from=...) requires with_rerank_source on "
                "the builder"
            )
        count = 0
        qrng = np.random.default_rng(0)
        for expr in filters if filters is not None else [None]:
            for b in batch_sizes:
                for depth in pipeline_depths:
                    pend = []
                    for _ in range(int(depth)):
                        plan = self.query_batch(
                            qrng.normal(size=(int(b), self._dim)).astype(np.float32), metric
                        ).take(k, rerank_from=rerank_from)
                        if expr is not None:
                            plan.meta_filter(expr)
                            if plan._meta_error is not None:
                                raise OttersError(plan._meta_error)
                        pend.append(plan.collect_async())
                    with warnings.catch_warnings():
                        # a warm batch that fails its certificate is noise
                        # here, and the widening it triggers warms the ladder
                        warnings.filterwarnings(
                            "ignore", message=".*certificate did not pass.*"
                        )
                        resolve(pend)
                    count += int(depth)
        return count

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

    # -- extended string predicates (host side) --------------------------------
    def _column_arena(self, name: str):
        """Packed UTF-8 (data, offsets) arena of a string column, built once
        and cached: every extended-predicate literal on the column shares it
        (packing 10M strings costs more than scanning them)."""
        cached = self._str_arena_cache.get(name)
        if cached is None:
            from .native import pack_utf8_arena

            vals = self.columns()[name].values()
            cached = pack_utf8_arena(
                [v if isinstance(v, str) else "" for v in vals[: self._n_rows]]
            )
            self._str_arena_cache[name] = cached
        return cached

    def _hostmask_for(self, leaf):
        """Row and chunk masks of an extended string predicate (contains /
        starts_with / ends_with / fuzzy and their negations). Strings live
        on the host only, so each (column, op, literal) is evaluated once
        there, cached, and handed to the device program as mask tensors,
        with an exact per-chunk any() so pruning still works."""
        key = (leaf.column, leaf.cmp, leaf.rhs)
        cached = self._hostmask_cache.get(key)
        if cached is not None:
            return cached
        colo = self.columns()[leaf.column]
        n = self._n_rows
        nulls = np.asarray(colo.null_mask(), dtype=bool)[:n]
        rhs = leaf.rhs
        negated = leaf.cmp in NEGATED_STRING_OPS
        base_cmp = NEGATED_CMP[leaf.cmp] if negated else leaf.cmp
        modes = {
            CmpOp.Contains: "contains",
            CmpOp.StartsWith: "starts_with",
            CmpOp.EndsWith: "ends_with",
        }
        if base_cmp in modes:
            # the native arena scan (OpenMP; memchr / memcmp inner loops) or
            # the vectorized numpy path, over the column's shared arena
            from .ops import strscan

            data, offsets = self._column_arena(leaf.column)
            m = strscan.substr_mask(data, offsets, rhs, modes[base_cmp])
            m = np.asarray(m, dtype=bool) & ~nulls
        else:  # Fuzzy: one vectorized pass (native when available)
            from .ops import strmatch

            pattern, max_dist = rhs
            m = strmatch.fuzzy_mask(colo.values()[:n], nulls, pattern, max_dist)
        if negated:
            # De Morgan leaves keep the nulls-excluded convention
            m = ~np.asarray(m, dtype=bool) & ~nulls
        n_pad = self._dv.vectors.shape[0]
        row = np.zeros(n_pad, dtype=bool)
        row[:n] = m
        offs = _chunk_offsets(n, self._chunk_size)
        chunk_any = np.logical_or.reduceat(m, offs) if n else np.zeros(0, bool)
        # padded to the store's chunk-array length
        n_chunks_dev = int(self._chunk_lens.shape[0])
        if n_chunks_dev != len(chunk_any):
            pad = np.zeros(n_chunks_dev, dtype=bool)
            pad[: len(chunk_any)] = chunk_any
            chunk_any = pad
        cached = self._place_masks(row, chunk_any)
        self._hostmask_cache[key] = cached
        return cached

    def _place_masks(self, row: np.ndarray, chunk: np.ndarray):
        """A host row mask [n_pad] and chunk mask [n_chunks] as the params
        of a ``hostmask`` leaf, on the device."""
        return _to_device(row, self._device), _to_device(chunk, self._device)

    # -- the device program ----------------------------------------------------
    def _prepare_program(self, queries, plan_static, metric, k, take_min, cmp,
                         strict=False, certify=False):
        """Pick the mode as the JAX package's ``_prepare_program`` does ->
        (the launch decision, the effective k). ``strict`` turns the
        fast-exact mode off (the redo after a failed check). The shape's
        signature is memoized in the ``aot_key`` cache under the JAX
        package's key (plan, batch, dtype, k, metric, direction, filter,
        precision, tile, fast, certify), so a query sequence hits and misses
        it as the JAX package's AOT signature memo (:meth:`_program`)."""
        dv = self._dv
        n_pad = dv.vectors.shape[0]
        b = queries.shape[0]
        k_eff = min(k, b * n_pad)
        if dv.vectors.dtype == torch.int8 and metric is not Metric.Cosine:
            raise OttersError("int8 quantized storage supports the Cosine metric only")
        scoring.check_precision(self.precision)
        tile = scoring.choose_mode(n_pad, b, k_eff)
        fast = False
        if (
            metric in VPU_METRICS
            and plan_static
            and n_pad % scoring.SCAN_TILE == 0
            and n_pad >= 4 * scoring.SCAN_TILE
            and k_eff <= scoring.SCAN_K_MAX
        ):
            # a filtered VPU-metric query at scale: skip the dead tiles
            tile = "scan_pruned"
        if tile == "panel" and metric not in VPU_METRICS:
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
            and tile != "scan_pruned"  # its program returns no bound
            and (tile != "fused" or dv.resid_bin is not None)
        )
        # certify and fast are disjoint kernel modes; certify wins
        fast = fast and not certify
        dtype = dv.vectors.dtype
        if tile == "fused" and not fused_topk.kernel_takes(
            fused_topk.kernel_mode(dtype, metric, take_min, certify, self.precision, fast),
            self._dim,
        ):
            # the kernel does not take this shape (the JAX package's
            # pallas_ok): the scan program, chosen before any launch
            tile, fast = "scan", False
            fused_topk.kernel_takes.routed += b
        memo = (plan_static, b, str(queries.dtype), k_eff, metric, take_min, cmp,
                self.precision, tile, fast, certify)
        return self._program("meta_query", memo, (dv, queries), tile, fast, certify, metric,
                             take_min), k_eff

    def _program(self, name, memo, args, tile, fast, certify, metric, take_min) -> "_Launch":
        """A query shape's program through ``aot``: the ``aot_key`` memo
        maps the shape to its signature (the shape, the store's device, chunk
        size and mesh, every argument's shape and dtype), the signature to the
        program in ``aot._mem``, made and readied on a miss.
        ``OTTERS_DISABLE_AOT`` bypasses both, as in the JAX package."""
        make = functools.partial(self._ready_launch, tile, fast, certify, metric, take_min)
        if aot.disabled():
            return make()
        key = self._aot_key_cache.get(memo)
        if key is None:
            statics = repr((memo, str(self._device), self._chunk_size,
                            getattr(self, "mesh", None)))
            key = aot.signature(name, statics, args, {})
            self._aot_key_cache[memo] = key
        return aot.lookup(key) or aot.load_or_compile(key, make, (), {})

    def _ready_launch(self, tile, fast, certify, metric, take_min) -> "_Launch":
        """The launch decision with the kernel libraries it needs loaded
        (built by nvcc into ``aot.cache_dir()`` if absent; a CUDA store's)."""
        launch = self._launch_decision(tile, fast, certify, metric, take_min)
        if launch.sources and self._device.type == "cuda":
            from . import kernels

            for source in launch.sources:
                kernels.load(source)
        return launch

    def _launch_decision(self, tile, fast, certify, metric, take_min) -> "_Launch":
        """The fused kernel a shape launches and the sources it needs."""
        if tile != "fused":
            return _Launch(tile, fast, certify)
        dtype = self._dv.vectors.dtype
        mode = fused_topk.kernel_mode(dtype, metric, take_min, certify, self.precision, fast)
        sources = {fused_topk.kernel_source(mode)}
        if fast:  # a failed check reruns strictly
            sources.add(fused_topk.kernel_source(
                fused_topk.kernel_mode(dtype, metric, take_min, False, self.precision)
            ))
        return _Launch(tile, fast, certify, mode, sources=tuple(sorted(sources)))

    def _run_prepared(self, launch, k_eff, cols_sub, queries, plan_params, thr, plan_static,
                      metric, take_min, cmp, clock=None):
        """Enqueue a prepared launch -> device tensors (see
        _device_program)."""
        thr_t = _scalar(float(thr), torch.float32, self._device)
        return _device_program(
            self._dv, self._chunk_lens, self._chunk_size, cols_sub, plan_static, plan_params,
            queries, thr_t, launch, metric=metric, k=k_eff, take_min=take_min, cmp=cmp,
            prec=self.precision, clock=clock,
        )

    def _run_query_program(self, cols_sub, queries, plan_params, thr, plan_static,
                           metric, k, take_min, cmp, strict=False, certify=False,
                           clock=None):
        """Prepare (:meth:`_prepare_program`) and enqueue the program ->
        device tensors (see _device_program, which fills ``clock``)."""
        with span("otters.submit.plan"):
            launch, k_eff = self._prepare_program(
                queries, plan_static, metric, k, take_min, cmp, strict=strict, certify=certify
            )
        return self._run_prepared(launch, k_eff, cols_sub, queries, plan_params, thr,
                                  plan_static, metric, take_min, cmp, clock=clock)

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
        if plan_static:
            ev, re_, rmask, _ = _device_masks(self._dv, self._chunk_lens, self._chunk_size,
                                              cols_sub, plan_static, plan_params)
            ev, re_ = int(ev), int(re_)
        else:
            rmask, ev, re_ = None, self.n_chunks(), self.n_rows
        rows, scores, valid = scoring.collect_all(
            self._dv, queries, metric, k_eff, take_min=take_min, cmp=cmp, thr=thr,
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
            return ("hostmask", leaf.column, leaf.cmp), store._hostmask_for(leaf)
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
                    if leaf.cmp is CmpOp.Eq:
                        m = vals == leaf.rhs
                    elif leaf.cmp is CmpOp.Neq:
                        m = vals != leaf.rhs
                    elif leaf.cmp in (CmpOp.Fuzzy, CmpOp.NotFuzzy):
                        from .ops import strmatch

                        pattern, max_dist = leaf.rhs
                        m = strmatch.fuzzy_mask(list(vals), nulls, pattern, max_dist)
                        if leaf.cmp is CmpOp.NotFuzzy:
                            m = ~np.asarray(m, dtype=bool)
                    elif leaf.cmp in STRING_EXTENDED_OPS:
                        m = np.fromiter(
                            (_str_cmp(v, leaf.rhs, leaf.cmp) for v in vals), bool, count=n
                        )
                    else:
                        m = np.zeros(n, dtype=bool)
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
        finalizes. One case waits: a filtered VPU-metric query at scale
        (the pruned scan) reads its list of live tiles to the host once."""
        if self._meta_error is not None:
            raise OttersError(self._meta_error)
        seq = next(_REQUEST_IDS)
        with span("otters.submit", seq):
            return self._submit(seq)

    def _submit(self, seq: int) -> "PendingMetaQuery":
        store = self._store
        total_start = time.perf_counter()
        clock = _HostClock()
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
        with span("otters.submit.plan"):
            queries = self._device_queries()
            b = queries.shape[0]
            has_filter = self._meta_filter is not None and len(self._meta_filter.clauses) > 0
            prune_start = time.perf_counter()
            if has_filter and store.n_chunks() > 0:
                plan_static, plan_params, used = self._lower_plan()
                cols_sub = {name: store._device_cols[name] for name in used}
            else:
                plan_static, plan_params, cols_sub = (), (), {}
            clock.prune += time.perf_counter() - prune_start

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
                with _Part("otters.submit.launch", [clock]):
                    copy = _Fetched(store._windowed_collect(
                        cols_sub, queries, plan_params, plan_static, min(k, b * n_pad),
                        self._metric, take_min, thr, cmp,
                    ))
            else:

                def run(k_run=k, strict=False, clock=None):
                    return store._run_query_program(
                        cols_sub, queries, plan_params, 0.0 if thr is None else thr,
                        plan_static, self._metric, k_run, take_min,
                        None if thr is None else cmp, strict=strict, certify=certify,
                        clock=clock,
                    )

                # a rerun (strict or widened) counts in the interval that runs it
                outputs = run(clock=clock)
                with _Part("otters.submit.phase2", [clock]):
                    copy = HostCopy.of(outputs)
                rerun_widened = run if certify else None
                strict_redo = functools.partial(run, strict=True)
        return PendingMetaQuery(
            plan=self, copy=copy, queries=queries, k=k, take_type=take_type,
            has_filter=has_filter, total_start=total_start, seq=seq, clock=clock,
            rerun_widened=rerun_widened, strict_redo=strict_redo,
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
                 take_type, has_filter, total_start, seq, clock,
                 rerun_widened=None, strict_redo=None):
        self._plan = plan
        self._copy = copy
        self._strict_redo = strict_redo
        self._queries = queries
        self._k = k
        self._take_type = take_type
        self._has_filter = has_filter
        self._total_start = total_start
        self._seq = seq  # the query's id in its spans
        self._clock = clock
        self._rerun_widened = rerun_widened
        self._result: Optional[MetaQueryResults] = None
        self._fetched = None
        self._rerank_prefetch = None  # set by resolve(): (sorted ids, their rows)
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
        outputs are fetched anyway; collect_async never waits for it. The
        redo and its wait are the span ``otters.finish.strict``, counted on
        ``otters.strict_reruns``."""
        if self._fetched is None:
            clocks = [self._clock]
            fetched = _wait(self._copy, clocks, self._seq)
            if not bool(fetched[3]) and self._strict_redo is not None:
                with span("otters.finish.strict", self._seq):
                    count("otters.strict_reruns")
                    t0 = time.perf_counter()
                    copy = HostCopy.of(self._strict_redo())
                    _charge(clocks, t0)
                    fetched = _wait(copy, clocks, self._seq)
            self._fetched = fetched
        return self._fetched

    def _exact_rerank(self, indices):
        """Exact-f32 re-rank of a candidate set, re-applying the vec_filter
        on the exact scores before truncating to k. Candidates are fetched by
        original row id; the returned indices are back in current positions
        (the materialization and the final index-map remap expect them so)."""
        from .evaluate import exact_rerank

        plan = self._plan
        store = plan._store
        idx = np.asarray(indices, dtype=np.int64)
        orig = store._index_map[idx] if store._index_map is not None else idx
        fetch = functools.partial(_fetch_vectors, store)
        if self._rerank_prefetch is not None:
            pf_ids, mat = self._rerank_prefetch

            def fetch(ids, _ids=pf_ids, _m=mat, _f=fetch):
                ids = np.asarray(ids, dtype=np.int64)
                pos = np.minimum(np.searchsorted(_ids, ids), len(_ids) - 1)
                if (_ids[pos] == ids).all():
                    return _m[torch.as_tensor(pos, device=_m.device)]
                return _f(ids)  # e.g. a collision redo changed the set
        rows, scrs = exact_rerank(
            self._queries, orig.tolist(), fetch, plan._metric,
            len(orig), take_min=(self._take_type is TakeType.Min),
        )
        if plan._vec_filter is not None:
            thr, cmp = plan._vec_filter
            op = CmpOp[cmp.value]
            keep = [i for i, s in enumerate(scrs) if _num_cmp(s, thr, op)]
            rows = [rows[i] for i in keep]
            scrs = [scrs[i] for i in keep]
        rows, scrs = rows[: plan._take_count], scrs[: plan._take_count]
        if store._index_map is not None:
            rows = store._positions()[np.asarray(rows, dtype=np.int64)].tolist()
        return rows, scrs

    def result(self) -> MetaQueryResults:
        if self._result is None:
            with span("otters.finish", self._seq):
                self._finish()
        return self._result

    def _finish(self) -> MetaQueryResults:
        """Finalize (``result()``'s work; ``resolve`` calls it in its own
        span)."""
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
                n_res = len(indices)
                if n_res > 256 and n_res * 64 > store.n_rows:
                    # take-all-sized results: one vectorized host pass beats
                    # millions of per-row CNF evaluations
                    em = plan._host_exact_row_mask(store._dv.vectors.shape[0])
                    sat = bool(em[np.asarray(indices, dtype=np.int64)].all())
                else:
                    sat = all(plan._row_satisfies(i) for i in indices)
                if not sat:
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
                clocks = [self._clock]
                if self._device_rerank is None:
                    # plain collect(): the batched rerank as a group of one
                    with _Part("otters.finish.rerank", clocks, self._seq):
                        state = _device_rerank_dispatch(store, [self])
                    if state is not None:
                        fetched = _wait(state[2], clocks, self._seq)
                        with _Part("otters.finish.rerank", clocks, self._seq):
                            _device_rerank_finish(state[0], state[1], fetched)
                with _Part("otters.finish.rerank", clocks, self._seq):
                    dr = self._device_rerank
                    idx0 = np.asarray(indices, dtype=np.int64)
                    orig0 = store._index_map[idx0] if store._index_map is not None else idx0
                    if dr is not None and frozenset(orig0.tolist()) == dr[0]:
                        rows_orig = np.asarray(dr[1], dtype=np.int64)
                        scores = list(dr[2])
                        if store._index_map is not None:
                            indices = store._positions()[rows_orig].tolist()
                        else:
                            indices = rows_orig.tolist()
                    else:
                        # a collision redo changed the candidate set
                        indices, scores = self._exact_rerank(indices)

                if self._rerun_widened is not None:
                    with _Part("otters.finish.certify", clocks, self._seq):
                        indices, scores, evaluated, rows_eval = self._certify_or_widen(
                            indices, scores, bound, collision_redo, b,
                            evaluated, rows_eval,
                        )
            elif self._rerun_widened is not None:
                # the scan returned ZERO candidates: provably complete (the
                # loosened threshold drops no truly passing row)
                self._certified = not collision_redo
                self._scan_k_wide = self._k
        # ---- merge phase: result-column materialization (host) ----
        with span("otters.finish.merge", self._seq):
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
                prune_duration=self._clock.prune,
                score_duration=self._clock.score,
                merge_duration=merge_dur,
                total_duration=time.perf_counter() - self._total_start,
                certified=self._certified,
                scan_k_wide=self._scan_k_wide,
            )
            if store._index_map is not None and indices:
                # sorted store: report original ingestion-order row ids
                indices = store._index_map[np.asarray(indices, dtype=np.int64)].tolist()
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
            copy = HostCopy.of(self._rerun_widened(k_run=k_used))
            with span("otters.finish.wait"):
                rows, _, valid, _, bound, ev, re_ = copy.wait()
            evaluated, rows_eval = int(ev), int(re_)
            ok_np = np.asarray(valid, dtype=bool)
            indices = np.asarray(rows)[ok_np].astype(np.int64).tolist()
            self._rerank_prefetch = None
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
                with span("otters.finish.rerank"):
                    indices, scores = self._exact_rerank(indices)
                certified = False
                break
            with span("otters.finish.rerank"):
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
    filter and k), then drain the groups and build the results. A group the
    device rerank does not take (the VPU metrics) fetches its members'
    candidates in one sorted ``fetch_vectors`` call, which each member's
    host rerank reads."""
    with span("otters.finish", tuple(p._seq for p in pendings)):
        return _resolve(pendings)


def _resolve(pendings: List[PendingMetaQuery]) -> List[MetaQueryResults]:
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
    states, host_groups = [], []
    for store, plist in by_group.values():
        with _Part("otters.finish.rerank", [p._clock for p in plist],
                   tuple(p._seq for p in plist)):
            state = _device_rerank_dispatch(store, plist)
        if state is None:
            host_groups.append((store, plist))
        else:
            states.append(state)
    for plist, cands, copy in states:
        clocks, seqs = [p._clock for p in plist], tuple(p._seq for p in plist)
        fetched = _wait(copy, clocks, seqs)
        with _Part("otters.finish.rerank", clocks, seqs):
            _device_rerank_finish(plist, cands, fetched)
    for store, plist in host_groups:
        with _Part("otters.finish.rerank", [p._clock for p in plist],
                   tuple(p._seq for p in plist)):
            ids = []
            for p in plist:
                rows, valid = p._fetched[0], p._fetched[2]
                idx = np.asarray(rows)[np.asarray(valid, dtype=bool)].astype(np.int64)
                ids.append(store._index_map[idx] if store._index_map is not None else idx)
            # the sorted union: each member looks its rows up by searchsorted,
            # and ascending ids make the user's fetch a gather in order
            ids_arr = np.unique(np.concatenate(ids))
            if ids_arr.size == 0:
                continue
            mat = _to_device(_fetch_vectors(store, ids_arr), store._device, torch.float32)
            for p in plist:
                p._rerank_prefetch = (ids_arr, mat)
    return [p._finish() if p._result is None else p._result for p in pendings]


def _str_cmp(v: str, rhs, cmp: CmpOp) -> bool:
    if cmp in NEGATED_STRING_OPS:
        return not _str_cmp(v, rhs, NEGATED_CMP[cmp])
    if cmp is CmpOp.Eq:
        return v == rhs
    if cmp is CmpOp.Neq:
        return v != rhs
    if cmp is CmpOp.Contains:
        return rhs in v
    if cmp is CmpOp.StartsWith:
        return v.startswith(rhs)
    if cmp is CmpOp.EndsWith:
        return v.endswith(rhs)
    if cmp is CmpOp.Fuzzy:
        from .ops.strmatch import MAX_DIST_CAP, bounded_levenshtein

        pattern, max_dist = rhs
        return bounded_levenshtein(
            v.encode("utf-8"), pattern.encode("utf-8"), min(int(max_dist), MAX_DIST_CAP)
        )
    return False


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
