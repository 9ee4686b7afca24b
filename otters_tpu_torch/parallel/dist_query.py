"""Sharded exact top-k search over a device mesh.

The port of the JAX package's ``parallel/dist_query.py``. The ``[N, D]``
vector matrix (and any row mask) is split along the mesh's "rows" axis and
the query batch along "batch". Each (row shard, batch column) computes its
**local exact top-k** over its rows with the single-device scoring cores
(``scoring.direct_topk_core`` or ``scan_topk_core``; no kernel, as in the
JAX package), re-bases its rows by the shard's offset (the reference's
per-chunk ``base_offset``, meta_compute.rs:184-188), and the k-sized
``(row, score, ok)`` partials are merged on the lead device in the order
JAX's ``all_gather`` over ``("rows", "batch")`` lays them out, ties to the
earlier position as ``lax.top_k``. Only O(devices * k) values cross
devices, never a score matrix. On a mesh across processes each process
runs its own entries, the partials meet in one gloo ``all_gather``
(``exchange.py``) and every process merges them alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import OttersError
from ..ops import scoring
from ..types import Cmp, Metric, SearchResult, TakeType, default_take_type
from . import exchange
from .mesh import Mesh
from .shards import ShardedTensor, on_device, put_rows


def merge_partials(parts, k: int, take_min: bool, lead: torch.device):
    """The global top-k of per-program ``(rows, scores, ok)`` partials,
    concatenated in mesh order (rows-major over (rows, batch)) on ``lead``
    -> (rows, scores, ok, sel), ``sel`` the winners' positions in the
    concatenation; ties go to the earlier position, as ``lax.top_k``."""
    rows_g = torch.cat([p[0].to(lead) for p in parts])
    scores_g = torch.cat([p[1].to(lead) for p in parts])
    ok_g = torch.cat([p[2].to(lead) for p in parts])
    key = torch.where(ok_g, scores_g, float("inf") if take_min else float("-inf"))
    if take_min:
        key = -key
    _, sel = scoring._stable_topk(key, min(k, key.shape[0]))
    return rows_g, scores_g, ok_g, sel


def sharded_topk(
    mesh: Mesh,
    vectors: ShardedTensor,
    norms_sq: ShardedTensor,
    inv_norms: ShardedTensor,
    valid: ShardedTensor,
    queries: np.ndarray,
    metric: Metric,
    k: int,
    take_min: bool = False,
    cmp: Optional[Cmp] = None,
    thr: Optional[float] = None,
    row_mask: Optional[ShardedTensor] = None,
    prec: str = "highest",
    tile: Optional[int] = None,
):
    """Run the sharded search; returns host (rows, scores, valid).
    Collective on a mesh across processes (one ``all_gather``)."""
    n_rows_shards = mesh.shape["rows"]
    n_pad = vectors.shape[0]
    if n_pad % n_rows_shards != 0:
        raise OttersError(
            f"padded rows {n_pad} not divisible by rows shards {n_rows_shards}"
        )
    queries = np.asarray(queries, dtype=np.float32)
    b = queries.shape[0]
    n_batch = mesh.shape["batch"]
    b_pad = max(n_batch, -(-b // n_batch) * n_batch)
    q_host = np.zeros((b_pad, queries.shape[1]), dtype=np.float32)
    q_host[:b] = queries
    q_valid = np.arange(b_pad) < b
    b_local = b_pad // n_batch
    k_eff = min(k, b * n_pad)
    if k_eff <= 0:
        return np.array([], np.int32), np.array([], np.float32), np.array([], bool)
    cmp_eff = None if thr is None else cmp
    n_local = n_pad // n_rows_shards
    k_local = min(k_eff, b_local * n_local)
    kwargs = dict(metric=metric, k=k_local, take_min=take_min, cmp=cmp_eff, prec=prec)
    parts = {}
    for r, c in mesh.programs():
        dev = mesh.devices[r, c]
        with on_device(dev):
            sl = slice(c * b_local, (c + 1) * b_local)
            q = torch.from_numpy(q_host[sl]).to(dev)
            qv = torch.from_numpy(q_valid[sl]).to(dev)
            t = torch.full((), 0.0 if thr is None else thr, dtype=torch.float32, device=dev)
            args = (vectors.local(r, c), norms_sq.local(r, c), inv_norms.local(r, c),
                    valid.local(r, c), q,
                    None if row_mask is None else row_mask.local(r, c), t)
            if tile is not None and n_local % tile == 0 and n_local > tile:
                rows, scores, ok = scoring.scan_topk_core(*args, tile=tile, q_valid=qv,
                                                          **kwargs)
            else:
                rows, scores, ok = scoring.direct_topk_core(*args, q_valid=qv, **kwargs)
            parts[(r, c)] = (rows + r * n_local, scores, ok)
    if mesh.spans_processes:
        parts = _exchange_partials(mesh, parts)
    order = sorted(parts)
    rows_g, scores_g, ok_g, sel = merge_partials([parts[rc] for rc in order], k_eff, take_min,
                                                 mesh.lead)
    return rows_g[sel].cpu().numpy(), scores_g[sel].cpu().numpy(), ok_g[sel].cpu().numpy()


def _exchange_partials(mesh: Mesh, parts):
    """Every program's ``(rows, scores, ok)`` on the lead device from this
    process's, through one ``all_gather`` of their records (collective)."""
    lead = mesh.lead
    rows, scores, ok = next(iter(parts.values()))
    spec = [(rows.dtype, rows.shape[0]), (scores.dtype, scores.shape[0]), (torch.bool, ok.shape[0])]
    recs = torch.cat([exchange.to_bytes(parts[rc], lead) for rc in mesh.programs()])

    def finish(records):
        return {rc: tuple(t.to(lead) for t in exchange.from_bytes(rec, spec))
                for rc, rec in records.items()}

    return exchange.Pending(mesh, recs, exchange.record_bytes(spec), finish).wait()


class ShardedVecStore:
    """A VecStore whose rows are sharded across a device mesh.

    ``search`` answers as ``VecStore.query(...).collect()`` does, computed
    per shard and merged on the lead device. ``vectors`` is an ``[n, d]``
    numpy array or tensor (a CUDA tensor is sliced shard by shard, never
    copied to the host). On a mesh across processes every process passes
    the same rows and calls ``search`` in the same order (collective)."""

    def __init__(self, mesh: Mesh, vectors, prec: str = "highest"):
        self.mesh = mesh
        self.dim = int(vectors.shape[1])
        self._n = int(vectors.shape[0])
        self.precision = prec
        n_shards = mesh.shape["rows"]
        unit = 128 * n_shards
        n_pad = max(unit, -(-self._n // unit) * unit)
        if isinstance(vectors, torch.Tensor):
            shards = []
            for r in range(n_shards):
                lo, hi = r * (n_pad // n_shards), (r + 1) * (n_pad // n_shards)
                if mesh.home(r) is None:  # a shard of another process
                    shards.append(None)
                    continue
                block = torch.zeros((hi - lo, self.dim), device=mesh.home(r))
                avail = min(max(self._n - lo, 0), hi - lo)
                if avail > 0:
                    block[:avail] = vectors[lo : lo + avail].float()
                shards.append(block)
            self.vectors = ShardedTensor(mesh, shards)
        else:
            self.vectors = put_rows(mesh, np.asarray(vectors, dtype=np.float32), n_pad, 0.0)
        self.valid = put_rows(mesh, np.arange(n_pad) < self._n, n_pad, False)
        norms = [(None, None) if v is None else scoring._device_norms(v)
                 for v in self.vectors.shards]
        self.norms_sq = ShardedTensor(mesh, [nsq for nsq, _ in norms])
        self.inv_norms = ShardedTensor(mesh, [inv for _, inv in norms])

    def __len__(self) -> int:
        return self._n

    def search(
        self,
        queries,
        metric: Metric,
        k: int,
        take_type: Optional[TakeType] = None,
        vec_filter: Optional[Tuple[float, Cmp]] = None,
    ):
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().float().cpu().numpy()
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != self.dim:
            raise OttersError(
                f"Query vector length {queries.shape[1]} does not match "
                f"expected dimension {self.dim}"
            )
        tt = take_type or default_take_type(metric)
        thr, cmp = (None, None) if vec_filter is None else vec_filter
        rows, scores, ok = sharded_topk(
            self.mesh,
            self.vectors,
            self.norms_sq,
            self.inv_norms,
            self.valid,
            queries,
            metric,
            k,
            take_min=(tt is TakeType.Min),
            cmp=cmp,
            thr=thr,
            prec=self.precision,
        )
        return [
            SearchResult(int(r), float(s))
            for r, s, good in zip(rows, scores, ok)
            if good
        ]
