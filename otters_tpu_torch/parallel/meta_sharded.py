"""ShardedMetaStore: the metadata-filtered search over a device mesh.

The port of the JAX package's ``parallel/meta_sharded.py``. The rows and
chunks of the store (vectors, column tensors, null masks, zonemaps and
Bloom words) are split along the mesh's "rows" axis, one tensor per row
shard on that shard's device (:class:`~.shards.ShardedTensor`); the query
batch is split along "batch". A query runs, for every (row shard, batch
column) in mesh order, the program the JAX package's ``local_fn`` runs:

    local zonemap chunk mask  ->  local row mask  ->  local exact top-k

on the shard's device (the fused Hopper kernel of ``ops/fused_topk.py``
over the shard's live bins when the shapes qualify, else
``scan_pruned_topk_core``, ``direct_topk_core`` or ``panel_topk_core``),
then composes on the lead device (``mesh.devices[0, 0]`` in one process):

- the k-sized partials, concatenated rows-major over (rows, batch) as
  JAX's ``all_gather`` lays them out, merged by a stable top-k (ties to
  the earlier position, as ``lax.top_k``);
- the certificate: a mesh-wide slack from the maxima of every shard's
  per-query coefficients and per-row lanes; the merged bound is the
  largest local bound or the k-th merged key plus that slack;
- one failed fast-exact check fails the whole merge (the caller redoes the
  query strictly);
- the pruning statistics, summed over the row shards.

Only O(shards * k) values and a few scalars cross devices. On a mesh that
spans processes each process runs only its own (row shard, batch column)
programs; their records meet in one gloo ``all_gather`` where a single
process would wait on its device (``exchange.py``), and every process
composes them as above on its local lead, so all hold the same answer.
Building, ``delete_rows``, ``append``, ``save`` and every query are then
collective: each process calls them in the same order.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..errors import OttersError
from ..meta import (
    MetaBuildStats,
    MetaStore,
    MetaStoreBuilder,
    _bloom_on_device,
    _bloom_params,
    _column_state,
    _Launch,
    _permute_column,
    _sort_permutation,
    _stage_column,
    _zorder_permutation,
)
from ..ops import bloom as bloom_ops
from ..ops import fused_topk, predicate, scoring
from ..ops.scoring import HostCopy
from ..types import VPU_METRICS, Cmp, CmpOp, Metric
from . import exchange
from .dist_query import merge_partials
from .mesh import Mesh
from .shards import ShardedTensor, on_device, put_rows, shard_bounds

_NEG_INF = float("-inf")
_STORAGE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def sharded_geometry(n_rows: int, chunk: int, n_shards: int):
    """-> (n_pad_s, n_chunks_s, n_chunks): row / chunk padding so both axes
    split evenly across shards AND every shard's chunk range exactly covers
    its row range (the alignment per-shard bin skipping needs)."""
    lcm = scoring.SCAN_TILE * chunk // math.gcd(scoring.SCAN_TILE, chunk)
    if lcm > 4 * scoring.SCAN_TILE:
        raise OttersError(
            f"build_sharded requires a chunk size aligning with the scan "
            f"tile ({scoring.SCAN_TILE}); chunk_size={chunk} does not. Use "
            "a power-of-two chunk size, or build single-device and "
            "ShardedMetaStore.shard(...) it."
        )
    unit = lcm * n_shards
    n_pad_s = max(unit, -(-max(n_rows, 1) // unit) * unit)
    n_chunks = -(-n_rows // chunk) if n_rows else 0
    return n_pad_s, n_pad_s // chunk, n_chunks


def scan_tile_aligned(chunk: int) -> bool:
    """True when direct sharded ingest supports this chunk size: its lcm
    with the scan tile keeps the per-shard padding unit small (see
    :func:`sharded_geometry`). Unaligned sizes (possible on stores made by
    ``shard()``) must stage single-device first."""
    lcm = scoring.SCAN_TILE * chunk // math.gcd(scoring.SCAN_TILE, chunk)
    return lcm <= 4 * scoring.SCAN_TILE


def build_sharded_or_shard(builder, mesh) -> "ShardedMetaStore":
    """:func:`build_sharded` when the chunk size aligns with the scan tile,
    else a single-device build on the lead device + ``shard()`` (which
    takes unaligned chunk geometries, at the cost of staging the whole
    store on one device first). Used by the sharded ``append`` and by
    ``load(mesh=...)``, so stores of any valid chunk size stay mutable and
    reloadable on a mesh."""
    if scan_tile_aligned(builder._chunk_size):
        return build_sharded(builder, mesh)
    return ShardedMetaStore.shard(builder.with_device(mesh.lead).build(), mesh)


# ---------------------------------------------------------------------------
# Placement helpers
# ---------------------------------------------------------------------------


def _sharded_resid_finalize(mesh: Mesh, resid: ShardedTensor, valid: ShardedTensor):
    """Mask padding rows out of the residuals, then derive the per-bin
    maxima per shard (shard sizes are SCAN_TILE multiples, so bins never
    straddle shards) and the global maximum on the lead device."""
    rs, bins, maxes = [], [], []
    for r_t, v_t in zip(resid.shards, valid.shards):
        if r_t is None:  # a shard of another process
            rs.append(None)
            bins.append(None)
            continue
        r_t = torch.where(v_t, r_t, 0.0)
        rbin, rmax = scoring.finalize_resid(r_t)
        rs.append(r_t)
        bins.append(rbin)
        maxes.append(rmax)
    return ShardedTensor(mesh, rs), ShardedTensor(mesh, bins), _mesh_max(mesh, maxes)


def _mesh_max(mesh: Mesh, maxes) -> torch.Tensor:
    """The largest of every shard's maximum (0-d tensors) on the lead
    device; across processes each brings its own shards' (one
    ``all_reduce``, so building is collective there)."""
    m = torch.stack([x.to(mesh.lead) for x in maxes]).max()
    if mesh.spans_processes:
        m = torch.from_numpy(exchange.all_reduce_max(m.reshape(1).cpu().numpy()))[0].to(mesh.lead)
    return m


def _valid_shards(mesh: Mesh, n_pad_s: int, n: int) -> ShardedTensor:
    return ShardedTensor(mesh, [
        None if mesh.home(r) is None else torch.arange(lo, hi, device=mesh.home(r)) < n
        for r, (lo, hi) in enumerate(shard_bounds(n_pad_s, mesh.shape["rows"]))
    ])


def _slab_walk(slab_fn, n_pad_s: int, slab_rows: int, mesh: Mesh, write) -> None:
    """Walk ``slab_fn(start, rows)`` over ``[0, n_pad_s)`` and hand each
    piece that falls in one row shard this process holds to ``write(r,
    local_start, f32 piece on the shard's device)``. Every process calls
    ``slab_fn`` for every slab, in order (as in the JAX package), so a
    ``slab_fn`` may itself be collective; one that reads from disk may skip
    the rows of other processes' shards."""
    bounds = shard_bounds(n_pad_s, mesh.shape["rows"])
    slab_rows = max(1, min(slab_rows, n_pad_s))
    for start in range(0, n_pad_s, slab_rows):
        rows = min(slab_rows, n_pad_s - start)
        slab = slab_fn(start, rows)
        for r, (lo, hi) in enumerate(bounds):
            a, b = max(start, lo), min(start + rows, hi)
            dev = mesh.home(r)
            if a >= b or dev is None:
                continue
            piece = torch.as_tensor(slab[a - start : b - start], dtype=torch.float32).to(dev)
            write(r, a - lo, piece)


def materialize_int8_slabs_sharded(
    slab_fn, n: int, d: int, slab_rows: int, mesh: Mesh, chunk_size: int = 1024
) -> scoring.DeviceVecs:
    """Slab-streamed int8 ingest straight into per-shard device memory.

    Same ``slab_fn(start, rows) -> f32 [rows, d]`` contract as
    ``scoring.materialize_int8_slabs`` (numpy or a tensor on any device);
    the peak per device is its shard plus one slab. ``chunk_size`` must
    match the builder's so the padded geometry agrees
    (:func:`sharded_geometry`). Collective on a mesh across processes
    (every process calls ``slab_fn`` for every slab; one ``all_reduce``)."""
    n_pad_s, _, _ = sharded_geometry(n, chunk_size, mesh.shape["rows"])
    n_loc = n_pad_s // mesh.shape["rows"]
    devs = [mesh.home(r) for r in range(mesh.shape["rows"])]
    buf8 = _per_shard(devs, lambda dv: scoring._padded_empty(n_loc, d, torch.int8, dv))
    nsq = _per_shard(devs, lambda dv: torch.zeros(n_loc, device=dv))
    inv = _per_shard(devs, lambda dv: torch.zeros(n_loc, device=dv))
    resid = _per_shard(devs, lambda dv: torch.zeros(n_loc, device=dv))

    def write(r, s, piece):
        v8, q_nsq, q_inv, q_resid = scoring._quantize_rows_int8_resid(piece)
        e = s + piece.shape[0]
        buf8[r][s:e], nsq[r][s:e], inv[r][s:e], resid[r][s:e] = v8, q_nsq, q_inv, q_resid

    _slab_walk(slab_fn, n_pad_s, slab_rows, mesh, write)
    valid = _valid_shards(mesh, n_pad_s, n)
    rs, rbin, rmax = _sharded_resid_finalize(mesh, ShardedTensor(mesh, resid), valid)
    return scoring.DeviceVecs(ShardedTensor(mesh, buf8), ShardedTensor(mesh, nsq),
                              ShardedTensor(mesh, inv), valid, rs, rbin, rmax)


def materialize_f32_slabs_sharded(
    slab_fn, n: int, d: int, slab_rows: int, mesh: Mesh, chunk_size: int = 1024,
    dtype=None,
) -> scoring.DeviceVecs:
    """Slab-streamed f32 / bfloat16 ingest straight into per-shard device
    memory (``dtype`` torch.float32, the default, or torch.bfloat16, whose
    per-row absolute rounding residuals are computed slab by slab: the f32
    source exists only inside this loop). Collective on a mesh across
    processes, as :func:`materialize_int8_slabs_sharded`."""
    dtype = torch.float32 if dtype is None else dtype
    bf16 = dtype == torch.bfloat16
    n_pad_s, _, _ = sharded_geometry(n, chunk_size, mesh.shape["rows"])
    n_loc = n_pad_s // mesh.shape["rows"]
    devs = [mesh.home(r) for r in range(mesh.shape["rows"])]
    buf = _per_shard(devs, lambda dv: scoring._padded_empty(n_loc, d, dtype, dv))
    resid = _per_shard(devs, lambda dv: torch.zeros(n_loc, device=dv)) if bf16 else None

    def write(r, s, piece):
        e = s + piece.shape[0]
        if bf16:
            resid[r][s:e] = scoring.bf16_abs_resid(piece)
        buf[r][s:e] = piece.to(dtype)

    _slab_walk(slab_fn, n_pad_s, slab_rows, mesh, write)
    norms = [(None, None) if b is None else scoring._device_norms(b) for b in buf]
    nsq = ShardedTensor(mesh, [x for x, _ in norms])
    inv = ShardedTensor(mesh, [y for _, y in norms])
    valid = _valid_shards(mesh, n_pad_s, n)
    if bf16:
        rs, rbin, rmax = _sharded_resid_finalize(mesh, ShardedTensor(mesh, resid), valid)
        return scoring.DeviceVecs(ShardedTensor(mesh, buf), nsq, inv, valid, rs, rbin, rmax)
    return scoring.DeviceVecs(ShardedTensor(mesh, buf), nsq, inv, valid)


def _per_shard(devs, make):
    """``make(device)`` for each shard this process holds, None for the
    others'."""
    return [None if dv is None else make(dv) for dv in devs]


def _gather_rows(st: ShardedTensor, ids: np.ndarray) -> np.ndarray:
    """Rows ``ids`` (ascending global ids) of a sharded row array as host
    f32, each shard reading only its own rows (on a mesh across processes
    a collective: each process reads the shards it writes, and the pieces
    meet in one gather)."""
    mesh = st.mesh
    got, lo = {}, 0
    for r, (shard, n_r) in enumerate(zip(st.shards, st.rows)):
        hi = lo + n_r
        sel = ids[(ids >= lo) & (ids < hi)] - lo
        if sel.size and shard is not None and mesh.writer(r) == mesh.rank:
            idx = torch.from_numpy(sel).to(shard.device)
            got[r] = shard[idx].float().cpu().numpy()
        lo = hi
    if mesh.spans_processes:
        for part in exchange.all_gather_object(got):
            got.update(part)
    if not got:
        return np.zeros((0,) + st.shape[1:], np.float32)
    return np.concatenate([got[r] for r in sorted(got)])


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


class ShardedMetaStore(MetaStore):
    """A MetaStore whose rows, zonemaps and Bloom words live across a mesh.

    Construct via ``MetaStoreBuilder.build_sharded(mesh)`` or
    ``ShardedMetaStore.shard(store, mesh)``. The query API is MetaStore's
    (query / query_batch -> meta_filter / vec_filter / take -> collect,
    ``collect_async`` / ``resolve``). Its device state: ``_dv`` a
    ``DeviceVecs`` of :class:`~.shards.ShardedTensor` fields (the global
    residual maximum a lead-device scalar), ``_device_cols`` and
    ``_chunk_lens`` likewise sharded; ``_device`` is the lead device.

    On a mesh across processes every query, ``delete_rows``, ``append``,
    ``save``, ``shard`` and ``precompile`` is collective: each process calls
    them in the same order (``len()`` and the statistics getters are not)."""

    def __init__(self, schema):
        super().__init__(schema)
        self.mesh: Optional[Mesh] = None
        # the chunk axis splits row-aligned per shard (the per-shard bin
        # skipping of the fused kernel and the pruned scan needs it)
        self._pallas_aligned = False

    # -- per-shard views --------------------------------------------------------
    def _local_dv(self, r: int, c: int) -> scoring.DeviceVecs:
        dev = self.mesh.devices[r, c]
        return scoring.DeviceVecs(*(
            None if f is None
            else f.local(r, c) if isinstance(f, ShardedTensor) else f.to(dev)
            for f in self._dv
        ))

    def _local_cols(self, cols, r: int, c: int) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: {key: t.local(r, c) for key, t in colarrs.items()}
                for name, colarrs in cols.items()}

    def _local_params(self, plan_static, plan_params, r: int, c: int):
        """A plan's parameters for one shard: sharded params (hostmask
        masks, the null leaf's chunk lengths) as that shard's block, every
        other one (thresholds, hashes, Bloom probe coordinates) replicated
        onto the shard's device."""
        dev = self.mesh.devices[r, c]
        return tuple(
            tuple(
                tuple(p.local(r, c) if isinstance(p, ShardedTensor) else p.to(dev)
                      for p in leaf_params)
                for leaf_params in clause_params
            )
            for clause_params in plan_params
        )

    # -- mutation and placement hooks (the base class's delete / append) -------
    def _place_valid(self, valid: np.ndarray) -> ShardedTensor:
        return put_rows(self.mesh, valid, valid.shape[0], False)

    def _host_gather(self, arr) -> np.ndarray:
        if isinstance(arr, ShardedTensor):
            return arr.numpy()
        return super()._host_gather(arr)

    def _place_resid(self, resid_host: np.ndarray) -> None:
        resid = put_rows(self.mesh, resid_host.astype(np.float32), resid_host.shape[0], 0.0)
        r, rbin, rmax = _sharded_resid_finalize(self.mesh, resid, self._dv.valid)
        self._dv = self._dv._replace(resid=r, resid_bin=rbin, resid_max=rmax)

    def _place_masks(self, row: np.ndarray, chunk: np.ndarray):
        return (put_rows(self.mesh, row, row.shape[0], False),
                put_rows(self.mesh, chunk, chunk.shape[0], False))

    def append(self, vectors, column_values) -> "ShardedMetaStore":
        """Append rows: surviving + new rows are re-chunked and rebuilt
        directly onto this store's mesh (MetaStore.append's semantics:
        tombstones compacted, fresh ids). Unsorted stores rebuild by
        streaming: old rows flow shard -> bounded host slab -> the new
        shards, so the host never holds the store. Sorted / Z-ordered
        stores (a rebuild re-sorts globally) and chunk sizes that do not
        align with the scan tile take the host-staged path."""
        if self._index_map is None and scan_tile_aligned(self._chunk_size):
            new = self._append_streaming(vectors, column_values)
        else:
            new = build_sharded_or_shard(
                self._append_builder(vectors, column_values), self.mesh
            )
        new.precision = self.precision
        self._carry_resid_forward(new)
        return new

    def _append_streaming(self, vectors, column_values) -> "ShardedMetaStore":
        """Mesh-scaled append for unsorted stores: old rows are re-ingested
        through bounded shard -> host slabs (never the whole store);
        quantized storage re-quantizes its own codes bit-identically."""
        n = self._n_rows
        keep, _, new_vecs, cols, cfg = self._append_prep(vectors, column_values)
        d = self._dim
        n_keep = len(keep)
        n_total = n_keep + new_vecs.shape[0]
        mesh = self.mesh
        old_host = None
        if cfg is not None:
            old_host = (
                self._rerank_host[:n]
                if self._rerank_host is not None
                else np.asarray(self._rerank_fetch(np.arange(n, dtype=np.int64)),
                                dtype=np.float32)
            )

        def slab_fn(start, rows):
            end = min(start + rows, n_total)
            out = np.zeros((rows, d), np.float32)
            if end <= start:
                return out
            o_end = min(end, n_keep)
            if o_end > start:
                ids = keep[start:o_end]
                out[: o_end - start] = (
                    old_host[ids] if old_host is not None
                    else _gather_rows(self._dv.vectors, ids)
                )
            if end > max(start, n_keep):
                a = max(start, n_keep)
                out[a - start : end - start] = new_vecs[a - n_keep : end - n_keep]
            return out

        slab_rows = min(max(self._chunk_size, 1 << 16), 1 << 20)
        if self._storage_dtype == "int8":
            dv = materialize_int8_slabs_sharded(
                slab_fn, n_total, d, slab_rows, mesh, chunk_size=self._chunk_size,
            )
        else:
            dv = materialize_f32_slabs_sharded(
                slab_fn, n_total, d, slab_rows, mesh, chunk_size=self._chunk_size,
                dtype=getattr(torch, self._storage_dtype),
            )
        builder = self._append_configured_builder(cols).with_vectors(dv, n_rows=n_total)
        new = build_sharded(builder, mesh)
        if cfg is not None:
            # keep_host_f32 cannot ride a pre-built DeviceVecs through the
            # builder; re-attach the (host-resident by contract) snapshot
            host = np.concatenate([old_host[keep], new_vecs], axis=0)
            new._rerank_host = host
            new._rerank_config = (None, True)

            def _fetch(ids, _hf=host):
                return _hf[np.asarray(ids, dtype=np.int64)]

            new._rerank_fetch = _fetch
        return new

    def save(self, path: str) -> None:
        """Serialize as one file per row shard (``io.save_meta_sharded``):
        the host stages one shard at a time. Reload with
        ``MetaStore.load(path, mesh=...)`` (the directory is detected;
        a load without a mesh works too). ``io.save_meta(store, file)``
        writes the single-file format."""
        from .. import io

        io.save_meta_sharded(self, path)

    @staticmethod
    def shard(store: MetaStore, mesh: Mesh) -> "ShardedMetaStore":
        """Re-place a single-device store over ``mesh``: rows and chunks are
        re-padded so both axes split evenly across the row shards (and,
        when the chunk size and the scan tile have a small lcm, so every
        shard's chunk range covers its row range exactly)."""
        n_shards = mesh.shape["rows"]
        out = ShardedMetaStore(store.schema())
        out.mesh = mesh
        out._device = mesh.lead
        for attr in ("_columns", "_chunk_size", "_n_rows", "_dim", "_bloom_params",
                     "_col_reprs", "_build_stats", "precision", "_index_map",
                     "_orig_columns", "_sort_by", "_z_order", "_n_deleted",
                     "_bloom_config", "_storage_dtype", "_rerank_fetch",
                     "_rerank_config", "_rerank_host"):
            setattr(out, attr, getattr(store, attr))

        dv = store._dv
        n_pad = dv.vectors.shape[0]
        cs = store._chunk_size
        lcm = scoring.SCAN_TILE * cs // math.gcd(scoring.SCAN_TILE, cs)
        aligned = lcm <= 4 * scoring.SCAN_TILE
        unit = (lcm if aligned else scoring.SCAN_TILE) * n_shards
        n_pad_s = max(unit, -(-n_pad // unit) * unit)
        n_chunks = store.n_chunks()
        if aligned:
            n_chunks_s = n_pad_s // cs
        else:
            n_chunks_s = max(n_shards, -(-n_chunks // n_shards) * n_shards)
        out._pallas_aligned = aligned
        out._n_chunks = n_chunks

        def put_row_t(t, fill):
            return put_rows(mesh, t, n_pad_s, fill)

        def put_chunk_t(t, fill):
            return put_rows(mesh, t, n_chunks_s, fill)

        valid_s = put_row_t(dv.valid, False)
        # the rows keep their depth padding (the kernels read the stride)
        vectors_s = ShardedTensor(mesh, [None if v is None else scoring._depth_padded(v)
                                         for v in put_row_t(dv.vectors, 0).shards])
        fields = [vectors_s, put_row_t(dv.norms_sq, 0.0), put_row_t(dv.inv_norms, 0.0), valid_s]
        if dv.resid is not None:
            # certificate residuals survive re-sharding: per-row values are
            # re-padded (0 on padding), bins and max re-derived per shard
            fields += _sharded_resid_finalize(mesh, put_row_t(dv.resid, 0.0), valid_s)
        out._dv = scoring.DeviceVecs(*fields)
        out._chunk_lens = put_chunk_t(store._chunk_lens, 0)
        row_keys = {"vals", "null", "rh"}
        out._device_cols = {
            name: {
                key: (put_row_t(arr, key == "null") if key in row_keys
                      # zonemap / non_null / bloom: padded chunks have
                      # non_null == 0 and never survive
                      else put_chunk_t(arr, 0))
                for key, arr in colarrs.items()
            }
            for name, colarrs in store._device_cols.items()
        }
        return out

    def precompile(
        self,
        filters=None,
        batch_sizes=(1, 256),
        k: int = 10,
        metric: Metric = Metric.Cosine,
        with_vec_filter: bool = False,
        rerank_from=None,
        pipeline_depths=(1,),
    ) -> int:
        """Ready the sharded program for each signature by running one query
        through the real sharded path (the kernels a launch needs build on
        its first call) -> the number of programs readied, the JAX
        package's count."""
        from ..types import TakeType, default_take_type

        count = self._precompile_rerank(
            filters, batch_sizes, k, metric, rerank_from, pipeline_depths
        )
        take_min = default_take_type(metric) is TakeType.Min
        for expr in filters if filters is not None else [None]:
            for b in batch_sizes:
                variants = [None]
                if with_vec_filter:
                    variants.append((0.0, Cmp.Lt if take_min else Cmp.Gt))
                for vf in variants:
                    plan = self.query_batch(np.zeros((int(b), self._dim), np.float32), metric)
                    if expr is not None:
                        plan = plan.meta_filter(expr)
                    if vf is not None:
                        plan = plan.vec_filter(*vf)
                    plan.take(k).collect()
                    count += 1
        return count

    def _direct_k_ok(self, k: int, b: int) -> bool:
        # the merge gathers O(k) partials from every shard, so a k past
        # SCAN_K_MAX routes through the per-shard windowed take-all
        k_eff = min(k, b * self._dv.vectors.shape[0])
        return k_eff <= scoring.SCAN_K_MAX and super()._direct_k_ok(k, b)

    # -- the sharded program ------------------------------------------------------
    def _sharded_launch(self, plan_static, b_pad, b_local, n_local, k_eff, metric,
                        take_min, cmp, strict, certify) -> _Launch:
        """The per-shard strategy, as the JAX package's
        ``_run_query_program`` picks it: the fused kernel when the shard's
        shapes qualify and the chunk axis is row-aligned per shard (the
        port's ``kernel_takes`` standing in for ``pallas_ok``), the pruned
        scan for a filtered VPU-metric query, else the direct / panel
        programs; then the fast-exact and certified modes."""
        dtype = self._dv.vectors.dtype
        tile, fast = "auto", False
        if (
            metric in VPU_METRICS
            and plan_static
            and self._pallas_aligned
            and n_local % scoring.SCAN_TILE == 0
            and n_local >= 4 * scoring.SCAN_TILE
            and k_eff <= scoring.SCAN_K_MAX
        ):
            tile = "scan_pruned"
        elif (
            self._pallas_aligned
            and metric not in VPU_METRICS
            and b_local * n_local > scoring.DIRECT_LIMIT
            and k_eff <= fused_topk.FUSED_K_MAX
            and n_local % fused_topk.BIN == 0
        ):
            tile = "fused"
            fast = (
                not strict
                and dtype != torch.int8
                and fused_topk.fast_ok(metric, take_min, cmp, k_eff, self.precision)
            )
        supported = certify and not strict and self._certify_supported(metric, take_min, cmp)
        certify = (
            supported
            and tile != "scan_pruned"
            and (tile != "fused" or self._dv.resid_bin is not None)
        )
        fast = fast and not certify  # disjoint kernel modes; certify wins
        if tile == "fused" and not fused_topk.kernel_takes(
            fused_topk.kernel_mode(dtype, metric, take_min, certify, self.precision, fast),
            self._dim,
        ):
            # the kernel does not take this shape: the direct / panel programs
            tile, fast, certify = "auto", False, supported
            fused_topk.kernel_takes.routed += b_pad
        memo = (plan_static, b_pad, k_eff, metric, take_min, cmp, self.precision, tile,
                fast, certify)
        return self._program("sharded_meta_query", memo, (self._dv,), tile, fast, certify,
                             metric, take_min)

    def _run_query_program(self, cols_sub, queries, plan_params, thr, plan_static,
                           metric, k, take_min, cmp, strict=False, certify=False):
        """Run this process's per-shard programs and compose them on the lead
        device -> lead-device tensors (rows, scores, ok, check, bound,
        evaluated, rows_eval), the single-device program's layout. On a mesh
        across processes the local programs are enqueued and an
        :class:`~.exchange.Pending` returned instead: its ``wait()`` (where
        a single process waits on its device, ``HostCopy.of``) gathers every
        process's records in one ``all_gather`` and composes them alike
        everywhere. Collective there: every process runs the same queries in
        the same order."""
        dv = self._dv
        if dv.vectors.dtype == torch.int8 and metric is not Metric.Cosine:
            raise OttersError("int8 quantized storage supports the Cosine metric only")
        scoring.check_precision(self.precision)
        b = queries.shape[0]
        n_pad = dv.vectors.shape[0]
        if min(k, b * n_pad) > scoring.SCAN_K_MAX:
            # k this large always routes through the per-shard windowed
            # take-all, never through the merge of k-sized partials
            raise OttersError(
                f"internal: take({k}) reached the SPMD program; this size "
                "belongs to the windowed take-all path"
            )
        mesh = self.mesh
        n_rows_s, n_batch = mesh.shape["rows"], mesh.shape["batch"]
        lead = mesh.lead
        b_pad = max(n_batch, -(-b // n_batch) * n_batch)
        n_local = n_pad // n_rows_s
        b_local = b_pad // n_batch
        nc_local = self._chunk_lens.shape[0] // n_rows_s
        k_eff = min(k, b * n_pad)
        k_local = min(k_eff, b_local * n_local)
        launch = self._sharded_launch(plan_static, b_pad, b_local, n_local, k_eff, metric,
                                      take_min, cmp, strict, certify)
        tile, fast, certify = launch.tile, launch.fast, launch.certify
        qs = torch.zeros((b_pad, queries.shape[1]), dtype=torch.float32, device=lead)
        qs[:b] = queries.to(lead, torch.float32)
        qv = torch.arange(b_pad, device=lead) < b
        d = dv.vectors.shape[1]
        programs = mesh.programs()

        def local_queries(r, c):
            dev = mesh.devices[r, c]
            sl = slice(c * b_local, (c + 1) * b_local)
            return qs[sl].to(dev), qv[sl].to(dev)

        maxima, slack_g = {}, None
        if certify:
            # the mesh-wide slack: the maxima of every shard's per-query
            # coefficients (valid queries only) and per-row lanes, composed
            # once, so it covers every (query, row) pair any shard scanned
            for r, c in programs:
                with on_device(mesh.devices[r, c]):
                    dv_l = self._local_dv(r, c)
                    q_l, qv_l = local_queries(r, c)
                    _, c0, c1, c2 = scoring.cert_query_coeffs(metric, q_l, d)
                    lane_a, lane_b = scoring.cert_row_lanes(
                        metric, dv_l.vectors.dtype, dv_l.resid, dv_l.inv_norms,
                        dv_l.norms_sq, d,
                    )
                    c0, c1, c2 = (torch.where(qv_l, x, 0.0) for x in (c0, c1, c2))
                    maxima[(r, c)] = torch.stack([
                        c0.max(), c1.max(), lane_a.max(), c2.max(), dv_l.norms_sq.max(),
                        lane_b.max(),
                    ]).to(lead)
            if tile != "fused" or not mesh.spans_processes:
                # the direct / panel scans loosen their filter by it before
                # they scan (across processes: one all_reduce first); the
                # fused path needs it only after the merge
                g = torch.stack(list(maxima.values())).amax(dim=0)
                if mesh.spans_processes:
                    g = torch.from_numpy(exchange.all_reduce_max(g.cpu().numpy())).to(lead)
                slack_g = _slack(g)

        outs = {}
        kwargs = dict(metric=metric, k=k_local, take_min=take_min, cmp=cmp,
                      prec=self.precision)
        for r, c in programs:
            dev = mesh.devices[r, c]
            with on_device(dev):
                dv_l = self._local_dv(r, c)
                q_l, qv_l = local_queries(r, c)
                clens = self._chunk_lens.local(r, c)
                if plan_static:
                    cols_l = self._local_cols(cols_sub, r, c)
                    params_l = self._local_params(plan_static, plan_params, r, c)
                    cmask = predicate.chunk_mask(plan_static, params_l, cols_l, nc_local, dev)
                    ev = cmask.sum(dtype=torch.int32)
                    re_ = (clens * cmask).sum(dtype=torch.int32)
                    rmask = predicate.row_mask(plan_static, params_l, cols_l, n_local, dev)
                else:
                    # padded chunks have length 0; count only real ones
                    ev = (clens > 0).sum(dtype=torch.int32)
                    re_ = clens.sum(dtype=torch.int32)
                    rmask = None
                thr_l = torch.full((), float(thr), dtype=torch.float32, device=dev)
                thr_core, q_core = thr_l, q_l
                if certify and tile != "fused":
                    # the mixed certified scan: bf16-rounded queries x stored
                    # rows, the filter loosened by the mesh-wide slack
                    qh32, _, _, _ = scoring.cert_query_coeffs(metric, q_l, d)
                    slack = slack_g.to(dev)
                    if cmp in (Cmp.Gt, Cmp.Gte):
                        thr_core = thr_l - slack
                    elif cmp in (Cmp.Lt, Cmp.Lte):
                        thr_core = thr_l + slack
                    q_core = qh32.to(torch.bfloat16)
                args = (dv_l.vectors, dv_l.norms_sq, dv_l.inv_norms, dv_l.valid, q_core,
                        rmask, thr_core)
                if tile == "fused":
                    # the kernel per shard, over the shard's live bins; it
                    # loosens its filter by its own local slack
                    if plan_static:
                        alive = fused_topk.bins_alive_from_chunk_mask(
                            cmask, self._chunk_size, n_local)
                    else:
                        alive = torch.ones(n_local // fused_topk.BIN, dtype=torch.bool,
                                           device=dev)
                    rows, scores, ok, check, bound_l = fused_topk.fused_topk(
                        dv_l.vectors, dv_l.norms_sq, dv_l.inv_norms, dv_l.valid, q_l, rmask,
                        thr_l, alive, certify=certify, fast=fast,
                        resid=dv_l.resid if certify else None, q_valid=qv_l, **kwargs,
                    )
                elif tile == "scan_pruned":
                    if plan_static:
                        alive = scoring.tiles_alive_from_chunk_mask(
                            cmask, self._chunk_size, n_local, scoring.SCAN_TILE)
                    else:
                        alive = torch.ones(n_local // scoring.SCAN_TILE, dtype=torch.bool,
                                           device=dev)
                    rows, scores, ok = scoring.scan_pruned_topk_core(
                        *args, alive, tile=scoring.SCAN_TILE, q_valid=qv_l, **kwargs)
                    check, bound_l = None, None
                else:
                    if b_local * n_local <= scoring.DIRECT_LIMIT or (
                        n_local % scoring.PANEL_BIN != 0
                    ):
                        core = scoring.direct_topk_core
                    else:
                        core = scoring.panel_topk_core
                    rows, scores, ok = core(*args, q_valid=qv_l, **kwargs)
                    check = None
                    bound_l = _core_bound(scores, ok, slack_g.to(dev), take_min) if certify \
                        else None
                outs[(r, c)] = (rows + r * n_local, scores, ok, check, bound_l, ev, re_)

        def compose(outs, slack_g):
            """Every program's outputs, composed on the lead device in mesh
            order (rows-major over (rows, batch)), JAX's all_gather layout."""
            order = sorted(outs)
            if certify and slack_g is None:
                slack_g = _slack(torch.stack([maxima[rc] for rc in order]).amax(dim=0))
            # one failed fast-exact check fails the merge (the caller redoes it)
            checks = [outs[rc][3].to(lead) for rc in order if outs[rc][3] is not None]
            check_g = (torch.stack(checks).all() if checks
                       else torch.ones((), dtype=torch.bool, device=lead))
            rows_g, scores_g, ok_g, sel = merge_partials(
                [outs[rc][:3] for rc in order], k_eff, take_min, lead)
            bound_g = torch.full((), _NEG_INF, device=lead)
            if certify:
                # rows a shard returned but the merge dropped are bounded by
                # the k-th merged key + the slack; the rest by each shard's
                bounds = [outs[rc][4].to(lead) for rc in order if outs[rc][4] is not None]
                kth_key = scores_g[sel][-1]
                if take_min:
                    kth_key = -kth_key  # the bound lives in the key space
                bound_g = torch.where(ok_g[sel][-1], kth_key + slack_g, bound_g)
                if bounds:
                    bound_g = torch.maximum(torch.stack(bounds).max(), bound_g)
            # the statistics sum over the row shards only
            stats = [rc for rc in order if rc[1] == 0]
            return (rows_g[sel], scores_g[sel], ok_g[sel], check_g, bound_g,
                    torch.stack([outs[rc][5].to(lead) for rc in stats]).sum(dtype=torch.int32),
                    torch.stack([outs[rc][6].to(lead) for rc in stats]).sum(dtype=torch.int32))

        if not mesh.spans_processes:
            return compose(outs, slack_g)
        return _exchange_programs(mesh, outs, maxima if certify else None, slack_g, compose)

    def _run_exact_mask_query(self, queries, exact_mask, metric, k, take_min, cmp, thr):
        """Hash-collision fallback, shard-aware: the exact host row mask
        rides the sharded program as a synthetic hostmask leaf (one block
        per shard), so the re-run never gathers the store onto one device.
        The chunk mask is all ones (conservative; this is a p ~ 2^-64
        path). Returns host (rows, scores, valid)."""
        m = np.asarray(exact_mask, dtype=bool)
        n_chunks_dev = int(self._chunk_lens.shape[0])
        plan_static = ((("hostmask", "", CmpOp.Contains),),)
        plan_params = ((self._place_masks(m, np.ones(n_chunks_dev, dtype=bool)),),)
        b = queries.shape[0]
        n_pad = self._dv.vectors.shape[0]
        k_eff = min(k, b * n_pad)
        if scoring.needs_windowed(n_pad, b, k_eff):
            # a take-all-sized redo goes through the same per-shard windows
            rows, scores, ok, *_ = self._windowed_collect(
                {}, queries, plan_params, plan_static, k_eff, metric, take_min, thr, cmp,
            )
            return rows, scores, ok
        rows, scores, ok, *_ = HostCopy.of(self._run_query_program(
            {}, queries, plan_params, 0.0 if thr is None else thr, plan_static, metric, k,
            take_min, None if thr is None else cmp, strict=True,
        )).wait()
        return rows, scores, ok

    def _windowed_collect(self, cols_sub, queries, plan_params, plan_static, k_eff,
                          metric, take_min, thr, cmp):
        """The sharded take-all: the single-device windowed collection run
        per row shard on the shard's own device (its pruning and mask
        programs there, ``scoring.collect_all`` streaming its score windows
        to the host). Rows never cross devices; the per-shard candidate
        lists (<= k_eff each) meet on the host, where the global top-k_eff
        keeps the single-device order through the flat (query, global row)
        tie key. -> host (rows, scores, valid, check, bound, evaluated,
        rows_eval).

        On a mesh across processes each process collects the row shards it
        writes; every process then holds every shard's list at the shard's
        global slot (padding slots sort last) after one ``all_gather``, and
        sorts them alike (JAX's ``process_allgather`` merge)."""
        n_pad = self._dv.vectors.shape[0]
        b = queries.shape[0]
        if b * n_pad > scoring.TAKE_ALL_LIMIT:
            raise OttersError(
                f"take-all over {b} queries x {n_pad} rows stages "
                f"{b * n_pad} candidate scores (> {scoring.TAKE_ALL_LIMIT});"
                " use a smaller take(k) or fewer queries per batch"
            )
        mesh = self.mesh
        n_rows_s = mesh.shape["rows"]
        n_loc = n_pad // n_rows_s
        nc_loc = self._chunk_lens.shape[0] // n_rows_s
        k_r_g = min(k_eff, b * n_loc)
        if mesh.spans_processes and n_rows_s * k_r_g > (1 << 27):
            # the cross-process merge replicates every shard's candidate
            # list onto every process; cap the replicated state
            raise OttersError(
                "take-all on a multi-process sharded store replicates "
                f"{n_rows_s} x {k_r_g} merged candidates per host "
                "(> 2^27); use a smaller take(k), fewer queries per "
                "batch, or a single-process mesh"
            )
        # the mask programs of every shard are enqueued before any window
        # streams
        blocks = []
        for r in range(n_rows_s):
            if mesh.writer(r) != mesh.rank:
                continue
            dev = mesh.devices[r, 0]
            with on_device(dev):
                dv_l = self._local_dv(r, 0)
                dv_loc = scoring.DeviceVecs(dv_l.vectors, dv_l.norms_sq, dv_l.inv_norms,
                                            dv_l.valid)
                rmask = ev = re_ = None
                if plan_static:
                    cols_l = self._local_cols(cols_sub, r, 0)
                    params_l = self._local_params(plan_static, plan_params, r, 0)
                    cmask = predicate.chunk_mask(plan_static, params_l, cols_l, nc_loc, dev)
                    rmask = predicate.row_mask(plan_static, params_l, cols_l, n_loc, dev)
                    ev = cmask.sum(dtype=torch.int32)
                    re_ = (self._chunk_lens.local(r, 0) * cmask).sum(dtype=torch.int32)
                blocks.append((r * n_loc, dev, dv_loc, rmask, ev, re_))
        k_per = [min(k_eff, b * n_loc) for _ in blocks]
        total = int(np.sum(k_per, dtype=np.int64))
        key = np.empty(total, np.float32)
        flat = np.empty(total, np.int32)
        rows_all = np.empty(total, np.int32)
        sc_all = np.empty(total, np.float32)
        ok_all = np.empty(total, bool)
        ev_total = np.int32(0)
        re_total = np.int32(0)
        off = 0
        for (row_start, dev, dv_loc, rmask, ev, re_), k_r in zip(blocks, k_per):
            if ev is not None:
                ev_total += np.int32(int(ev))
                re_total += np.int32(int(re_))
            with on_device(dev):
                rows_r, sc_r, ok_r, q_r = scoring.collect_all(
                    dv_loc, queries, metric, k_r, take_min=take_min, cmp=cmp, thr=thr,
                    row_mask=rmask, prec=self.precision, return_qidx=True,
                )
            sl = slice(off, off + k_r)
            off += k_r
            grow = rows_r.astype(np.int64) + row_start
            kf = np.where(ok_r, sc_r, np.float32(np.inf if take_min else -np.inf))
            key[sl] = -kf if not take_min else kf
            flat[sl] = q_r.astype(np.int64) * n_pad + grow
            rows_all[sl] = grow
            sc_all[sl] = sc_r
            ok_all[sl] = ok_r
        if mesh.spans_processes:
            key, flat, rows_all, sc_all, ok_all, ev_total, re_total = _merge_take_all(
                mesh, blocks, k_per, n_loc, k_r_g,
                (key, flat, rows_all, sc_all, ok_all), ev_total, re_total)
        if not plan_static:
            ev_total = np.int32(self.n_chunks())
            re_total = np.int32(self.n_rows)
        order = np.lexsort((flat, key))[:k_eff]
        return (rows_all[order], sc_all[order], ok_all[order], np.bool_(True),
                np.float32(-np.inf), ev_total, re_total)


def _core_bound(scores, ok, slack_g, take_min=False):
    """A shard's certificate bound on the direct / panel programs: the k-th
    local scan key (negated score for take_min) + the mesh-wide slack
    covers every local row not returned (an exact local top-k); an invalid
    k-th slot means every passing local row was returned."""
    kth = -scores[-1] if take_min else scores[-1]
    return torch.where(ok[-1], kth + slack_g, _NEG_INF)


def _merge_take_all(mesh: Mesh, blocks, k_per, n_loc, k_r_g, lists, ev_total, re_total):
    """The take-all's cross-process merge: this process's candidate lists
    (key, flat tie index, row, score, ok) placed at their shards' global
    slots, padding slots (key +inf, flat int32 max, ok False) sorting last,
    gathered in one ``all_gather`` -> every shard's lists in slot order on
    every process, and the statistics summed."""
    n_shards = mesh.shape["rows"]
    gtotal = n_shards * k_r_g
    fills = (np.float32(np.inf), np.iinfo(np.int32).max, 0, 0, False)
    glob = [np.full(gtotal, f, dtype=a.dtype) for f, a in zip(fills, lists)]
    off = 0
    for (row_start, *_), k_r in zip(blocks, k_per):
        slot = (row_start // n_loc) * k_r_g
        for g, a in zip(glob, lists):
            g[slot : slot + k_r] = a[off : off + k_r]
        off += k_r
    arrays = glob + [np.array([ev_total, re_total], np.int64)]
    merged = [[] for _ in arrays]
    for got in exchange.all_gather_bytes(np.concatenate([a.view(np.uint8) for a in arrays])):
        o = 0
        for m, a in zip(merged, arrays):
            m.append(got[o : o + a.nbytes].copy().view(a.dtype))
            o += a.nbytes
    tot = np.sum(merged[-1], axis=0, dtype=np.int64)
    return (*(np.concatenate(m) for m in merged[:-1]), np.int32(tot[0]), np.int32(tot[1]))


def _slack(g: torch.Tensor) -> torch.Tensor:
    """The certificate's mesh-wide slack from the six composed maxima."""
    return g[0] + g[1] * g[2] + g[3] * torch.sqrt(g[4]) + g[5]


def _exchange_programs(mesh: Mesh, outs, maxima, slack_g, compose):
    """Across processes: this process's program outputs ``{(r, c): (rows,
    scores, ok, check, bound, evaluated, rows_eval)}`` packed on the lead
    device as one fixed-length record a program (with the certificate's
    six maxima, which the fused path composes only after the merge) and
    copied to the host without a wait -> an :class:`~.exchange.Pending`
    whose ``wait()`` gathers every process's records and composes them all
    with ``compose`` (host numpy, ``HostCopy.wait``'s layout). A mode
    without a check or a bound (every program runs the same mode) leaves
    them out again after the exchange."""
    lead = mesh.lead
    first = next(iter(outs.values()))
    k_local = int(first[0].shape[0])
    has_check, has_bound = first[3] is not None, first[4] is not None
    spec = [(first[0].dtype, k_local), (first[1].dtype, k_local), (torch.bool, k_local),
            (torch.bool, 1), (torch.float32, 1), (torch.int32, 2), (torch.float32, 6)]
    recs = []
    for rc in mesh.programs():
        rows, scores, ok, check, bound, ev, re_ = outs[rc]
        dev = rows.device
        recs.append(exchange.to_bytes([
            rows, scores, ok,
            check if has_check else torch.ones((), dtype=torch.bool, device=dev),
            bound.float() if has_bound else torch.full((), _NEG_INF, device=dev),
            torch.stack([ev.to(dev), re_.to(dev)]),
            maxima[rc] if maxima is not None else torch.zeros(6, device=dev),
        ], lead))

    def finish(records):
        every = {}
        for rc, rec in records.items():
            rows, scores, ok, check, bound, ev_re, mx = (
                t.to(lead) for t in exchange.from_bytes(rec, spec))
            every[rc] = (rows, scores, ok, check[0] if has_check else None,
                         bound[0] if has_bound else None, ev_re[0], ev_re[1])
            if maxima is not None:
                maxima[rc] = mx
        return tuple(t.cpu().numpy() for t in compose(every, slack_g))

    return exchange.Pending(mesh, torch.cat(recs), exchange.record_bytes(spec), finish)


# ---------------------------------------------------------------------------
# Direct sharded ingest + build
# ---------------------------------------------------------------------------


def _vectors_sharded(mesh: Mesh, src, n_rows: int, n_pad_s: int, dim: int,
                     storage: str) -> scoring.DeviceVecs:
    """Rows of ``src`` (an f32 [n, d] host array or a tensor, rows past
    ``n_rows`` masked out) placed and stored per shard: each shard's slice
    is moved to its device and stored there in slabs (int8 codes or
    bfloat16 with their residuals, or f32)."""
    n_shards = mesh.shape["rows"]
    n_loc = n_pad_s // n_shards
    have = min(int(src.shape[0]), n_pad_s)
    fields = []
    for r, (lo, hi) in enumerate(shard_bounds(n_pad_s, n_shards)):
        dev = mesh.home(r)
        if dev is None:
            fields.append(None)
            continue
        avail = min(max(have - lo, 0), hi - lo)
        block = torch.zeros((hi - lo, dim), dtype=torch.float32, device=dev)
        if avail > 0:
            block[:avail] = torch.as_tensor(src[lo : lo + avail]).to(dev, torch.float32)
        n_valid = min(max(n_rows - lo, 0), hi - lo)
        if storage == "int8":
            part = scoring._int8_slabs(lambda s, k, _b=block: _b[s : s + k], n_loc, n_loc,
                                       n_valid, dim, scoring.INGEST_SLAB_ROWS, dev)
        elif storage == "bfloat16":
            part = scoring._materialize_bf16(block, n_valid)
        else:
            nsq, inv = scoring._device_norms(block)
            part = scoring.DeviceVecs(scoring._depth_padded(block), nsq, inv,
                                      torch.arange(n_loc, device=dev) < n_valid)
        fields.append(part)
        del block
    out = [ShardedTensor(mesh, [None if p is None else p[i] for p in fields])
           for i in range(6 if storage != "float32" else 4)]
    if storage == "float32":
        return scoring.DeviceVecs(*out)
    rmax = _mesh_max(mesh, [p.resid_max for p in fields if p is not None])
    return scoring.DeviceVecs(*out, rmax)


def _bloom_sharded(mesh: Mesh, st, n: int, c: int, n_chunks: int, n_chunks_s: int,
                   params: bloom_ops.BloomParams) -> ShardedTensor:
    """A string column's Bloom words per shard, each shard's chunk range:
    the device build from the host hashes of the shard's rows where the
    switch and the geometry allow it, else the host build's rows. The same
    bits either way."""
    n_shards = mesh.shape["rows"]
    nc_loc = n_chunks_s // n_shards
    g1, g2 = st.hashes
    if _bloom_on_device() and bloom_ops.device_build_ok(params, nc_loc):
        shards = []
        for r in range(n_shards):
            lo, hi = r * nc_loc * c, min((r + 1) * nc_loc * c, n)
            hi = max(hi, lo)
            shards.append(None if mesh.home(r) is None else bloom_ops.build_matrix_device(
                g1[lo:hi], g2[lo:hi], st.nulls[lo:hi], c, nc_loc, params, mesh.home(r),
            ))
        return ShardedTensor(mesh, shards)
    chunk_ids = np.arange(n, dtype=np.int64) // c
    matrix = bloom_ops.build_matrix(g1, g2, st.nulls, chunk_ids, n_chunks, params, chunk_size=c)
    return put_rows(mesh, np.ascontiguousarray(matrix).view(np.int32), n_chunks_s, 0)


def build_sharded(builder: MetaStoreBuilder, mesh: Mesh) -> ShardedMetaStore:
    """Build a ShardedMetaStore by direct sharded ingest: vectors, column
    tensors, null masks, zonemaps and Bloom words are placed straight into
    each shard's device memory; the whole store never exists on one device.

    Accepts ``build()``'s vector inputs, except that a pre-built DeviceVecs
    must already be sharded over THIS mesh with the matching geometry
    (:func:`materialize_int8_slabs_sharded` /
    :func:`materialize_f32_slabs_sharded`). On a mesh across processes each
    process places the shards it owns from the same host data, and the
    build is collective."""
    b = builder
    if b._vectors is None:
        raise OttersError("vectors must be provided to build MetaStore")
    n_shards = mesh.shape["rows"]
    c = b._chunk_size
    vectors = b._vectors
    pre_built = isinstance(vectors, scoring.DeviceVecs)
    from_device = (not pre_built) and isinstance(vectors, torch.Tensor)

    if pre_built:
        if b._vectors_n is None:
            raise OttersError(
                "with_vectors(DeviceVecs) requires n_rows (the logical row "
                "count; the buffers are padded)"
            )
        n_rows = int(b._vectors_n)
        dim = int(vectors.vectors.shape[1])
        if vectors.vectors.dtype in (torch.int8, torch.bfloat16):
            b._storage_dtype = _STORAGE_NAMES[vectors.vectors.dtype]
    elif from_device:
        n_rows = int(b._vectors_n if b._vectors_n is not None else vectors.shape[0])
        dim = int(vectors.shape[1])
    else:
        if not isinstance(vectors, np.ndarray):
            vectors = np.asarray(
                [np.asarray(v, dtype=np.float32) for v in vectors], dtype=np.float32,
            )
        vectors = vectors.astype(np.float32, copy=False)
        n_rows, dim = vectors.shape
    if dim == 0 and n_rows > 0:
        raise OttersError("vector dimension cannot be zero")
    for name in b._schema:
        colo = b._columns.get(name)
        if colo is None:
            raise OttersError(f"missing column '{name}' in builder columns")
        if len(colo) != n_rows:
            raise OttersError(
                f"column '{name}' length {len(colo)} does not match vectors "
                f"length {n_rows}"
            )

    n_pad_s, n_chunks_s, n_chunks = sharded_geometry(n_rows, c, n_shards)
    build_start = time.perf_counter()

    # ---- optional clustering (host-array vectors only) ----
    columns = b._columns
    index_map = None
    orig_columns = None
    if b._sort_by is not None or b._z_order is not None:
        if pre_built or from_device:
            raise OttersError(
                "with_sort_by / with_z_order under build_sharded require "
                "host-array vectors (generate device slabs in sorted order "
                "instead)"
            )
        if b._sort_by is not None:
            sort_col, desc = b._sort_by
            if sort_col not in b._schema:
                raise OttersError(f"unknown column '{sort_col}' not present in schema")
            perm = _sort_permutation(columns[sort_col], n_rows, desc)
        else:
            for nm in b._z_order:
                if nm not in b._schema:
                    raise OttersError(f"unknown column '{nm}' not present in schema")
            perm = _zorder_permutation(columns, b._z_order, n_rows)
        orig_columns = columns
        columns = {name: _permute_column(col_, perm) for name, col_ in columns.items()}
        vectors = vectors[perm]
        index_map = perm

    # ---- rerank source (host snapshot before placement) ----
    rerank_fetch = None
    host_f32 = None
    if b._rerank is not None:
        fetch, keep = b._rerank
        if keep:
            if pre_built or from_device:
                raise OttersError(
                    "keep_host_f32 under build_sharded requires host-array "
                    "vectors; pass fetch_vectors instead"
                )
            host_f32 = vectors if index_map is None else vectors[_inverse(index_map)]

            def rerank_fetch(ids, _hf=host_f32):
                return _hf[np.asarray(ids, dtype=np.int64)]

        else:
            rerank_fetch = fetch

    # ---- vector ingest: straight to each shard's device ----
    ingest_start = time.perf_counter()
    if pre_built:
        dv = vectors
        if int(dv.vectors.shape[0]) != n_pad_s:
            raise OttersError(
                f"pre-built DeviceVecs has {int(dv.vectors.shape[0])} padded "
                f"rows; this mesh/chunk geometry needs {n_pad_s} — build it "
                "with materialize_*_slabs_sharded(mesh=..., chunk_size=...)"
            )
        if not isinstance(dv.vectors, ShardedTensor) or dv.vectors.mesh is not mesh:
            raise OttersError(
                "a pre-built DeviceVecs under build_sharded must be sharded over "
                "this mesh (materialize_*_slabs_sharded(mesh=...))"
            )
    else:
        dv = _vectors_sharded(mesh, vectors, n_rows, n_pad_s, dim, b._storage_dtype)
    for dev in {mesh.home(r) for r in mesh.local_rows()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # honest ingest timing
    ingest_dur = time.perf_counter() - ingest_start

    # ---- columns: staged on the host once, zonemaps computed per shard ----
    zstart = time.perf_counter()
    device_cols: Dict[str, Dict] = {}
    col_reprs: Dict[str, str] = {}
    bloom_params: Dict[str, bloom_ops.BloomParams] = {}
    bounds = shard_bounds(n_pad_s, n_shards)
    n_loc, nc_loc = n_pad_s // n_shards, n_chunks_s // n_shards
    for name in b._schema:
        st = _stage_column(columns[name], n_rows)
        per_shard = [
            None if mesh.home(r) is None
            else _column_state(st, lo, min(max(lo, n_rows), hi), n_loc, c, nc_loc, mesh.home(r))
            for r, (lo, hi) in enumerate(bounds)
        ]
        keys = next(p for p in per_shard if p is not None)
        devcol = {key: ShardedTensor(mesh, [None if p is None else p[key] for p in per_shard])
                  for key in keys}
        if st.rep == "str":
            params = _bloom_params(b._bloom, c)
            devcol["bloom"] = _bloom_sharded(mesh, st, n_rows, c, n_chunks, n_chunks_s, params)
            bloom_params[name] = params
        device_cols[name] = devcol
        col_reprs[name] = st.rep
    chunk_lens = np.zeros(n_chunks_s, dtype=np.int32)
    if n_chunks:
        chunk_lens[:n_chunks] = np.minimum(
            np.full(n_chunks, c, dtype=np.int64),
            n_rows - np.arange(n_chunks, dtype=np.int64) * c,
        ).astype(np.int32)
    zonemap_dur = time.perf_counter() - zstart

    out = ShardedMetaStore(b._schema)
    out.mesh = mesh
    out._device = mesh.lead
    out._columns = columns
    out._chunk_size = c
    out._n_rows = n_rows
    out._dim = dim
    out._n_chunks = n_chunks
    out._dv = dv
    out._device_cols = device_cols
    out._col_reprs = col_reprs
    out._bloom_params = bloom_params
    out._chunk_lens = put_rows(mesh, chunk_lens, n_chunks_s, 0)
    out._bloom_config = b._bloom
    out._index_map = index_map
    out._orig_columns = orig_columns
    out._sort_by = b._sort_by
    out._z_order = b._z_order
    out._storage_dtype = b._storage_dtype
    out._rerank_fetch = rerank_fetch
    out._rerank_config = b._rerank
    out._rerank_host = host_f32  # the keep_host_f32 snapshot: save / append reuse it
    out._pallas_aligned = True
    out._build_stats = MetaBuildStats(
        n_rows=n_rows,
        dim=dim,
        n_chunks=n_chunks,
        vectors_ingest_duration=ingest_dur,
        zonemap_build_duration=zonemap_dur,
        build_total_duration=time.perf_counter() - build_start,
    )
    return out


def _inverse(perm: np.ndarray) -> np.ndarray:
    inv = np.empty(len(perm), dtype=np.int64)
    inv[perm] = np.arange(len(perm))
    return inv

