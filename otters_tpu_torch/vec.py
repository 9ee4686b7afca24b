"""VecStore and VecQueryPlan: brute-force exact vector search on a CUDA device.

Counterpart of the JAX package's ``vec.py`` (reference ``src/vec.rs``):

- ``VecStore`` stages vectors host-side (amortized appends) and lazily
  materializes one ``[N_pad, D]`` tensor on the device with device-computed
  norms (float32, bfloat16, or int8 for Cosine). Appending invalidates the device
  copy. The store runs on the current CUDA device unless the caller names
  another (``VecStore(dim, device="cpu")``), and raises without one.
- ``VecQueryPlan`` is the same lazy builder with **deferred errors**:
  builder methods never raise, every error surfaces at ``collect()``
  (vec.rs:84-90,170-203), with the reference's messages.
- ``collect()`` runs one scoring program: every query of the batch scored
  with fused masking, and one exact global top-k merged across the whole
  batch (single-collector semantics, vec.rs:217-219). At scale that is a
  fused kernel (``ops/fused_topk.py``): K4 with a strict K3 rerun over f32
  and bfloat16 rows (exact over the stored values), K2 over int8 rows; the
  store precision "default" / "bf16" scores one bf16 pass (K6 at scale). A
  take(k) too wide for any device top-k streams score windows to the host.

Not ported yet: ``save`` / ``load`` (they wait for ``io.py``); both raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .errors import OttersError
from .ops import scoring
from .types import Cmp, Metric, SearchResult, TakeType, default_take_type


def _as_query_batch(queries) -> np.ndarray:
    """Accept [D] or [B, D] inputs (reference QueryBatch, vec.rs:320-336)."""
    if isinstance(queries, np.ndarray):
        arr = queries.astype(np.float32, copy=False)
        return arr[None, :] if arr.ndim == 1 else arr
    queries = list(queries)
    if queries and np.isscalar(queries[0]):
        return np.asarray(queries, dtype=np.float32)[None, :]
    # list of vectors (possibly ragged -> keep as python until validation)
    return queries  # type: ignore[return-value]


class VecStore:
    """Append-only store of fixed-dimension f32 vectors (vec.rs:338-412)."""

    def __init__(self, dim: int, dtype: str = "float32", device=None):
        if dtype not in ("float32", "bfloat16", "int8"):
            raise OttersError(f"unsupported storage dtype {dtype!r}")
        self.dim = int(dim)
        self._rows: List[np.ndarray] = []  # staged host chunks
        self._n = 0
        self._device: Optional[scoring.DeviceVecs] = None
        # device storage: "float32" (exact) | "bfloat16" (half the memory,
        # exact over the stored values) | "int8" (cosine-only, approximate;
        # see ops/scoring._materialize_int8)
        self._dtype = dtype
        self._where = None if device is None else torch.device(device)
        # scan precision of f32 / bf16 storage: "highest", "high",
        # "default" or "bf16" (see MetaStore.precision)
        self.precision: str = "highest"

    # ---- ingest ----------------------------------------------------------
    def add_vector(self, vector) -> None:
        arr = np.asarray(vector, dtype=np.float32)
        if arr.ndim != 1 or arr.shape[0] != self.dim:
            raise OttersError(
                f"Input vector length {arr.shape[-1] if arr.ndim else 0} does "
                f"not match expected dimension {self.dim}"
            )
        self._rows.append(arr[None, :])
        self._n += 1
        self._device = None

    def add_vectors(self, vectors) -> None:
        if isinstance(vectors, np.ndarray):
            if vectors.ndim != 2 or vectors.shape[1] != self.dim:
                raise OttersError(
                    f"Input vector length {vectors.shape[-1]} does not match "
                    f"expected dimension {self.dim}"
                )
            self._rows.append(np.asarray(vectors, dtype=np.float32))
            self._n += vectors.shape[0]
            self._device = None
            return
        for v in vectors:
            v = np.asarray(v, dtype=np.float32)
            if v.shape[0] != self.dim:
                raise OttersError(
                    f"Input vector length {v.shape[0]} does not match "
                    f"expected dimension {self.dim}"
                )
        for v in vectors:
            self._rows.append(np.asarray(v, dtype=np.float32)[None, :])
            self._n += 1
        self._device = None

    def __len__(self) -> int:
        return self._n

    def is_empty(self) -> bool:
        return self._n == 0

    # ---- persistence -----------------------------------------------------
    def save(self, path: str) -> None:
        raise NotImplementedError("VecStore.save: io.py is not ported yet")

    @staticmethod
    def load(path: str) -> "VecStore":
        raise NotImplementedError("VecStore.load: io.py is not ported yet")

    # ---- device ----------------------------------------------------------
    def _host_matrix(self) -> np.ndarray:
        if not self._rows:
            return np.zeros((0, self.dim), dtype=np.float32)
        if len(self._rows) > 1:
            self._rows = [np.concatenate(self._rows, axis=0)]
        return self._rows[0]

    def device(self) -> scoring.DeviceVecs:
        """Materialize (and cache) the device-resident store."""
        if self._device is None:
            where = resolve_device(self._where, "VecStore(dim, device='cpu')")
            self._device = scoring.materialize(
                self._host_matrix(), dtype=getattr(torch, self._dtype), device=where
            )
        return self._device

    # ---- query -----------------------------------------------------------
    def query(self, queries, metric: Metric) -> "VecQueryPlan":
        plan = VecQueryPlan()
        plan._store = self
        plan._metric = metric
        plan._set_queries(queries)
        return plan


class VecQueryPlan:
    """Lazy query builder with deferred errors (reference vec.rs:55-318)."""

    def __init__(self):
        self._store: Optional[VecStore] = None
        self._queries: Optional[np.ndarray] = None
        self._queries_raw = None
        self._metric: Optional[Metric] = None
        self._filter: Optional[Tuple[float, Cmp]] = None
        self._take_type: Optional[TakeType] = None
        self._take_count: Optional[int] = None
        self._row_mask: Optional[np.ndarray] = None
        self._error: Optional[str] = None
        self._queries_set = False

    # ---- builder chain (all no-ops once an error is recorded) -------------
    def _set_queries(self, queries):
        self._queries_set = True
        batch = _as_query_batch(queries)
        if isinstance(batch, np.ndarray):
            self._queries = batch
        else:
            self._queries_raw = batch  # ragged / needs validation at collect
        return self

    def with_vector_store(self, store: VecStore) -> "VecQueryPlan":
        if self._error is None:
            self._store = store
        return self

    def with_query_vectors(self, queries) -> "VecQueryPlan":
        if self._error is None:
            self._set_queries(queries)
        return self

    def with_metric(self, metric: Metric) -> "VecQueryPlan":
        if self._error is None:
            self._metric = metric
        return self

    def with_row_mask(self, mask) -> "VecQueryPlan":
        if self._error is None:
            self._row_mask = np.asarray(mask, dtype=bool)
        return self

    def filter(self, score: float, cmp: Cmp) -> "VecQueryPlan":
        if self._error is None:
            self._filter = (float(score), cmp)
        return self

    def _take_with_options(self, count: int, take_type: Optional[TakeType]):
        if self._error is not None:
            return self
        self._take_count = int(count)
        if take_type is not None:
            self._take_type = take_type
        elif self._take_type is None and self._metric is not None:
            self._take_type = default_take_type(self._metric)
        return self

    def take(self, count: int) -> "VecQueryPlan":
        return self._take_with_options(count, None)

    def take_min(self, count: int) -> "VecQueryPlan":
        return self._take_with_options(count, TakeType.Min)

    def take_max(self, count: int) -> "VecQueryPlan":
        return self._take_with_options(count, TakeType.Max)

    # ---- execution ---------------------------------------------------------
    def _validate(self) -> None:
        """Surface deferred errors; messages mirror vec.rs:170-203."""
        if self._error is not None:
            raise OttersError(self._error)
        if not self._queries_set:
            raise OttersError("Query vectors or their norms are not set")
        if self._metric is None:
            raise OttersError("Search metric is not set")
        if self._store is None:
            raise OttersError("Vector store is not set")

        if self._queries_raw is not None:
            qs = self._queries_raw
            if len(qs) == 0:
                raise OttersError("No queries provided")
            for q in qs:
                q = np.asarray(q, dtype=np.float32)
                if q.shape[0] != self._store.dim:
                    raise OttersError(
                        f"Query vector length {q.shape[0]} does not match "
                        f"expected dimension {self._store.dim}"
                    )
            self._queries = np.stack(
                [np.asarray(q, dtype=np.float32) for q in qs], axis=0
            )
            self._queries_raw = None
            return

        assert self._queries is not None
        if self._queries.shape[0] == 0:
            raise OttersError("No queries provided")
        if self._queries.shape[1] != self._store.dim:
            raise OttersError(
                f"Query vector length {self._queries.shape[1]} does not match "
                f"expected dimension {self._store.dim}"
            )

    def collect(self) -> List[SearchResult]:
        self._validate()
        store = self._store
        assert store is not None and self._queries is not None
        metric = self._metric
        k = self._take_count if self._take_count is not None else len(store)
        # a plan whose take_type was never set defaults to Max even for
        # Euclidean, as the reference does (vec.rs:214); take() infers the
        # direction from the metric, bare collect() does not
        take_type = self._take_type or TakeType.Max

        if len(store) == 0 or k <= 0 or self._queries.shape[0] == 0:
            return []

        dv = store.device()
        dev = dv.vectors.device
        row_mask = None
        if self._row_mask is not None:
            n_pad = dv.vectors.shape[0]
            rm = np.ones(n_pad, dtype=bool)  # missing bits default True
            m = self._row_mask[:n_pad]
            rm[: len(m)] = m
            row_mask = torch.from_numpy(rm).to(dev)

        thr, cmp = (None, None) if self._filter is None else self._filter
        queries = torch.from_numpy(np.ascontiguousarray(self._queries, dtype=np.float32))
        rows, scores, valid = scoring.run_vec_topk(
            dv,
            queries.to(dev),
            metric,
            k,
            take_min=(take_type is TakeType.Min),
            cmp=cmp,
            thr=thr,
            row_mask=row_mask,
            prec=store.precision,
        )
        return [
            SearchResult(int(r), float(s))
            for r, s, ok in zip(rows, scores, valid)
            if ok
        ]
