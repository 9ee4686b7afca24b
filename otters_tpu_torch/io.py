"""Persistence: save / load stores to one file, or a sharded store to a
directory of per-shard files.

The reference lists persistence as roadmap (README.md:207 "Persistence
(save/load MetaStore to/from disk)"). The format is the JAX package's
single-file one, so a file written by either package loads in the other: a
single ``.npz`` (no pickling; strings are stored as UTF-8 byte arenas +
offsets) plus an embedded JSON manifest. Loading rebuilds the device state
through the normal build path, so zonemaps and Bloom bits are reconstructed
deterministically from the same configuration.

- A sorted or Z-ordered store is saved in original ingestion order (the
  layout is re-applied on load); tombstones are kept (``deleted``).
- The vector payload is f32: bfloat16 rows as their exact f32 upcast, int8
  codes as f32 values (re-quantizing codes is idempotent), and a
  ``keep_host_f32`` store's true f32 snapshot, so the rebuilt codes are the
  same.
- Certificate width hints are kept (``cert_hints``).

The sharded store (``parallel.ShardedMetaStore``) saves to a directory in
the JAX package's ``sharded-v1`` layout (:func:`save_meta_sharded`): one
``.npz`` per row shard, a manifest and the columns. ``load_meta`` reads a
file or a directory of either package, onto one device or, with
``mesh``, straight into a sharded store.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .column import Column
from .errors import OttersError
from .meta import MetaStore
from .types import DataType
from .vec import VecStore

_FORMAT_VERSION = 1


def _pack_strings(strings):
    from .native import pack_utf8_arena

    return pack_utf8_arena(strings)


def _unpack_strings(data: np.ndarray, offsets: np.ndarray):
    buf = data.tobytes()
    return [buf[offsets[i] : offsets[i + 1]].decode("utf-8") for i in range(len(offsets) - 1)]


def _column_blocks(arrays: dict, columns, n: int) -> dict:
    """Serialize columns into ``arrays``; returns the schema dict."""
    schema = {}
    for name, col in columns.items():
        dt = col.dtype
        schema[name] = dt.value
        arrays[f"col_null::{name}"] = np.asarray(col.null_mask())[:n]
        if dt is DataType.String:
            data, offsets = _pack_strings(list(col.values())[:n])
            arrays[f"col_strdata::{name}"] = data
            arrays[f"col_stroff::{name}"] = offsets
        else:
            arrays[f"col_vals::{name}"] = np.asarray(col.values())[:n]
    return schema


def _read_column_blocks(z, manifest) -> list:
    """Rebuild Column objects from a ``_column_blocks`` payload."""
    n = manifest["n_rows"]
    cols = []
    for name, dt_name in manifest["schema"].items():
        dt = DataType(dt_name)
        col = Column(name, dt)
        nulls = z[f"col_null::{name}"]
        if dt is DataType.String:
            vals = _unpack_strings(z[f"col_strdata::{name}"], z[f"col_stroff::{name}"])
        else:
            vals = z[f"col_vals::{name}"]
        col._set_raw(vals, nulls)
        if len(col) != n:
            raise OttersError(f"column '{name}' holds {len(col)} rows, the manifest {n}")
        cols.append(col)
    return cols


def save_meta(store: MetaStore, path: str) -> None:
    """Serialize a MetaStore (vectors + columns + config) to ``path``.

    A ``fetch_vectors`` rerank source cannot be serialized: the manifest
    records it so that load can say so."""
    n = store.n_rows
    arrays = {}
    cfg = store._rerank_config
    keep_rerank = bool(cfg is not None and cfg[1])
    if keep_rerank and store._rerank_fetch is not None:
        # the true f32 snapshot, already in original ingestion order
        vectors = (
            store._rerank_host[:n]
            if store._rerank_host is not None
            else np.asarray(store._rerank_fetch(np.arange(n, dtype=np.int64)), dtype=np.float32)
        )
    else:
        vectors = (
            store._host_gather(store._dv.vectors[:n])
            if store._dv is not None
            else np.zeros((0, store._dim), np.float32)
        )
        if vectors.dtype != np.float32:
            vectors = vectors.astype(np.float32)  # int8 codes: exact in f32
    deleted = ~store._host_valid()[:n] if store._dv is not None else np.zeros(0, bool)
    columns = store.columns()
    if store._index_map is not None:
        inv = store._positions()
        if not keep_rerank:
            vectors = vectors[inv]  # device order -> original order
        deleted = deleted[inv]
        columns = store._orig_columns
    arrays["vectors"] = vectors
    arrays["deleted"] = deleted
    schema = _column_blocks(arrays, columns, n)
    bloom_kind, bloom_val = store._bloom_config
    manifest = {
        "format_version": _FORMAT_VERSION,
        "kind": "MetaStore",
        "n_rows": n,
        "dim": store._dim,
        "chunk_size": store.chunk_size(),
        "bloom_kind": bloom_kind,
        "bloom_val": bloom_val,
        "schema": schema,
        "sort_by": list(store._sort_by) if store._sort_by else None,
        "z_order": list(store._z_order) if store._z_order else None,
        "storage_dtype": store._storage_dtype,
        "rerank": "keep_host_f32" if keep_rerank else ("fetch" if cfg is not None else None),
        # widths that certified: a fresh process starts at them
        "cert_hints": store.cert_hints() or None,
    }
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode("utf-8"), dtype=np.uint8)
    # through a file object so the exact path is used (np.savez appends
    # '.npz' to a bare path)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_meta(path: str, mesh=None, *, device=None) -> MetaStore:
    """Load a MetaStore saved by :func:`save_meta` (or by the JAX package)
    onto ``device`` (default: the current CUDA device), rebuilding its device
    state. A saved ``keep_host_f32`` rerank source is restored; a
    ``fetch_vectors`` one must be re-attached by rebuilding from columns.

    With ``mesh`` the store is rebuilt by direct sharded ingest over it
    (``parallel.build_sharded``; ``device`` is then the mesh's). ``path``
    may also be a per-shard directory written by
    :func:`save_meta_sharded` (detected)."""
    if os.path.isdir(path):
        return load_meta_dir(path, mesh=mesh, device=device)
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode("utf-8"))
        if manifest.get("kind") != "MetaStore":
            raise OttersError(f"{path} does not contain a MetaStore")
        cols = _read_column_blocks(z, manifest)
        builder = (
            MetaStore.from_columns(cols)
            .with_vectors(np.asarray(z["vectors"]))
            .with_chunk_size(manifest["chunk_size"])
        )
        if manifest["bloom_kind"] == "fpr":
            builder = builder.with_bloom_fpr(manifest["bloom_val"])
        else:
            builder = builder.with_bloom_bits(int(manifest["bloom_val"]))
        if manifest.get("sort_by"):
            sc, desc = manifest["sort_by"]
            builder = builder.with_sort_by(sc, desc)
        if manifest.get("z_order"):
            builder = builder.with_z_order(manifest["z_order"])
        builder = builder.with_storage_dtype(manifest.get("storage_dtype", "float32"))
        if manifest.get("rerank") == "keep_host_f32":
            builder = builder.with_rerank_source(keep_host_f32=True)
        if mesh is not None:
            # unaligned chunk sizes fall back to a single-device build +
            # shard() inside the helper
            from .parallel.meta_sharded import build_sharded_or_shard

            store = build_sharded_or_shard(builder, mesh)
        else:
            if device is not None:
                builder = builder.with_device(device)
            store = builder.build()
        if "deleted" in z:
            deleted = np.flatnonzero(np.asarray(z["deleted"]))
            if deleted.size:
                store.delete_rows(deleted)
        store._restore_cert_hints(manifest.get("cert_hints"))
        return store


# ---- the per-shard directory format (sharded-v1) ----------------------------
#
# Persistence that scales with the mesh: neither save nor load stages the
# whole vector payload on the host. A DIRECTORY holding
#   manifest_{process:05d}.json  -- the configuration + that process's shard files
#   meta.npz                     -- the columns (+ deleted ids, index_map)
#   shard_{row_start:012d}.npz   -- one row shard's valid rows ("rows", and
#                                   "resid" for quantized payloads)
# The vector payload is stored in DEVICE row order: a sorted store records
# its index_map and is rebuilt without re-sorting. The JAX package writes
# and reads the same layout. On a mesh that spans processes every process
# calls save with the same path (a shared file system) and writes the
# shards it owns and its own manifest; process 0 writes meta.npz.


def _rows_payload(rows: torch.Tensor) -> np.ndarray:
    """A shard's stored rows as the file holds them: int8 codes, f32 rows,
    or bfloat16 as their exact 16-bit codes (uint16)."""
    if rows.dtype == torch.bfloat16:
        return rows.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
    return rows.contiguous().cpu().numpy()


def save_meta_sharded(store, path: str) -> None:
    """Serialize a ShardedMetaStore as one file per row shard (see above).

    The host stages one shard at a time; ``save_meta``'s whole-store gather
    never happens. ``keep_host_f32`` stores save the TRUE f32 rows (host
    resident already) so the rebuilt quantized codes are identical; other
    stores save the device payload as it is (int8 codes round-trip bit for
    bit: re-quantizing codes is idempotent, each row's max |code| being
    127).

    On a mesh across processes this is collective (the validity mask is
    gathered; every process returns once every file is written)."""
    from .parallel import exchange
    from .parallel.mesh import process_count, process_index
    from .parallel.meta_sharded import ShardedMetaStore

    if not isinstance(store, ShardedMetaStore):
        raise OttersError("save_meta_sharded requires a ShardedMetaStore")
    if os.path.exists(path) and not os.path.isdir(path):
        raise OttersError(f"{path} exists and is not a directory")
    os.makedirs(path, exist_ok=True)
    n = store.n_rows
    dv = store._dv
    cfg = store._rerank_config
    keep_rerank = bool(cfg is not None and cfg[1] and store._rerank_fetch is not None)
    with_resid = dv.resid is not None and not keep_rerank
    mesh = store.mesh
    ranges, files = [], []
    lo = 0
    for r, (shard, n_r) in enumerate(zip(dv.vectors.shards, dv.vectors.rows)):
        hi = min(lo + n_r, n)
        # each row shard is written by one process; an all-padding shard
        # writes nothing
        if hi > lo and mesh.writer(r) == mesh.rank:
            if keep_rerank:
                # the true f32 rows of this device range (original -> device
                # order through index_map; host slicing of the snapshot)
                ids = (store._index_map[lo:hi] if store._index_map is not None
                       else np.arange(lo, hi, dtype=np.int64))
                rows = (store._rerank_host[ids] if store._rerank_host is not None
                        else np.asarray(store._rerank_fetch(ids), dtype=np.float32))
                payload = {"rows": np.asarray(rows, dtype=np.float32)}
            else:
                payload = {"rows": _rows_payload(shard[: hi - lo])}
                if with_resid:
                    payload["resid"] = dv.resid.shards[r][: hi - lo].cpu().numpy()
            fname = f"shard_{lo:012d}.npz"
            with open(os.path.join(path, fname), "wb") as f:
                np.savez(f, **payload)
            ranges.append([int(lo), int(hi)])
            files.append(fname)
        lo += n_r
    spans = mesh.spans_processes
    pid = process_index() if spans else 0

    bloom_kind, bloom_val = store._bloom_config
    if keep_rerank:
        payload_dtype = "float32"
    else:
        payload_dtype = {torch.int8: "int8", torch.bfloat16: "bfloat16"}.get(
            dv.vectors.dtype, "float32")
    manifest = {
        "format_version": _FORMAT_VERSION,
        "kind": "MetaStore",
        "layout": "sharded-v1",
        "n_rows": n,
        "dim": store._dim,
        "chunk_size": store.chunk_size(),
        "bloom_kind": bloom_kind,
        "bloom_val": bloom_val,
        "schema": {k: c.dtype.value for k, c in store._columns.items()},
        "sort_by": list(store._sort_by) if store._sort_by else None,
        "z_order": list(store._z_order) if store._z_order else None,
        "storage_dtype": store._storage_dtype,
        "rerank": "keep_host_f32" if keep_rerank else ("fetch" if cfg is not None else None),
        "payload_dtype": payload_dtype,
        "order": "device",
        "row_ranges": ranges,
        "files": files,
        "has_resid": bool(with_resid and files),
        "cert_hints": store.cert_hints() or None,
        # a load merges exactly manifests 0 .. process_count - 1
        "process_count": process_count() if spans else 1,
    }
    with open(os.path.join(path, f"manifest_{pid:05d}.json"), "w") as f:
        json.dump(manifest, f)
    # the deleted set is the only device-derived piece; its gather is
    # collective across processes, the write process 0's alone (the
    # columns are on every process's host)
    valid = store._host_valid()
    if pid == 0:
        pos = np.flatnonzero(~valid[:n]).astype(np.int64)
        arrays = {"deleted": store._index_map[pos] if store._index_map is not None else pos}
        if store._index_map is not None:
            arrays["index_map"] = np.asarray(store._index_map, np.int64)
        _column_blocks(arrays, store._columns, n)  # DEVICE order
        with open(os.path.join(path, "meta.npz"), "wb") as f:
            np.savez(f, **arrays)
    if spans:
        exchange.barrier()


_FILE_DTYPES = {"int8": np.int8, "bfloat16": np.uint16, "float32": np.float32}


def _held_rows(mesh, n: int, chunk: int):
    """``mine(a, b)``: do rows [a, b) meet a row shard this process holds
    (always, but on a mesh across processes)."""
    if mesh is None or not mesh.spans_processes:
        return lambda a, b: True
    from .parallel import meta_sharded as msh
    from .parallel.shards import shard_bounds

    n_pad_s, _, _ = msh.sharded_geometry(n, chunk, mesh.shape["rows"])
    bounds = shard_bounds(n_pad_s, mesh.shape["rows"])
    held = [bounds[r] for r in mesh.local_rows()]
    return lambda a, b: any(lo < b and a < hi for lo, hi in held)


def load_meta_dir(path: str, mesh=None, *, device=None) -> MetaStore:
    """Load a ``sharded-v1`` directory (see :func:`save_meta_sharded`).

    With ``mesh`` the payload streams file by file straight into each
    shard's device memory (the host holds one shard file and one slab; on
    a mesh across processes each process reads only the files of the
    shards it holds, and the load is collective); without it the store is
    rebuilt on ``device`` through the same slab streaming."""
    import glob

    from ._device import resolve_device
    from .ops import scoring

    mfs = sorted(glob.glob(os.path.join(path, "manifest_*.json")))
    if not mfs:
        raise OttersError(f"{path} does not contain a sharded MetaStore")
    with open(mfs[0]) as f:
        m0 = json.load(f)
    if m0.get("kind") != "MetaStore" or m0.get("layout") != "sharded-v1":
        raise OttersError(f"{path} does not contain a sharded MetaStore")
    # merge exactly the manifests the last save wrote (stale higher-numbered
    # manifests from an earlier wider save are ignored)
    n_procs = int(m0.get("process_count", len(mfs)))
    manifests = [m0]
    for pid_i in range(1, n_procs):
        p = os.path.join(path, f"manifest_{pid_i:05d}.json")
        if not os.path.exists(p):
            raise OttersError(
                f"sharded store at {path} was saved by {n_procs} processes "
                f"but manifest_{pid_i:05d}.json is missing"
            )
        with open(p) as f:
            manifests.append(json.load(f))
    n, d = m0["n_rows"], m0["dim"]
    chunk = m0["chunk_size"]
    storage = m0.get("storage_dtype", "float32")
    payload_dtype = m0.get("payload_dtype", "float32")
    pieces = sorted(
        (int(r[0]), int(r[1]), os.path.join(path, f))
        for mf in manifests
        for r, f in zip(mf["row_ranges"], mf["files"])
    )
    covered = 0
    for lo, hi, _ in pieces:
        if lo != covered:
            raise OttersError(
                f"sharded store at {path} is missing rows "
                f"[{covered}, {lo}) — were all processes' shards saved?"
            )
        covered = hi
    if covered != n:
        raise OttersError(f"sharded store at {path} is missing rows [{covered}, {n})")

    with np.load(os.path.join(path, "meta.npz")) as z:
        cols = _read_column_blocks(z, m0)
        deleted = np.asarray(z["deleted"], np.int64) if "deleted" in z else np.zeros(0, np.int64)
        index_map = np.asarray(z["index_map"], np.int64) if "index_map" in z else None

    cache: dict = {}
    mine = _held_rows(mesh, n, chunk)

    def _read(a, b, key="rows"):
        """Rows [a, b) of the logical payload (those of other processes'
        shards as zeros); one file resident at a time (the slab walks visit
        the ranges in order)."""
        parts = []
        for lo, hi, f in pieces:
            if hi <= a or lo >= b:
                continue
            s, e = max(a, lo), min(b, hi)
            if not mine(s, e):
                tail = (d,) if key == "rows" else ()
                parts.append(np.zeros((e - s,) + tail, _FILE_DTYPES[payload_dtype]
                                      if key == "rows" else np.float32))
                continue
            if cache.get("f") != f:
                with np.load(f) as zz:
                    cache.clear()
                    cache["f"] = f
                    cache["rows"] = zz["rows"]
                    if "resid" in zz:
                        cache["resid"] = zz["resid"]
            parts.append(cache[key][s - lo : e - lo])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def slab_fn(start, rows):
        end = min(start + rows, n)
        if end <= start or not mine(start, end):
            return np.broadcast_to(np.zeros((1, d), np.float32), (rows, d))
        block = _read(start, end)
        if payload_dtype == "bfloat16":
            block = torch.from_numpy(block.view(np.int16).copy()).view(torch.bfloat16)
            block = block.float().numpy()
        block = np.asarray(block, dtype=np.float32)
        if block.shape[0] < rows:
            block = np.concatenate([block, np.zeros((rows - block.shape[0], d), np.float32)])
        return block

    slab_rows = min(max(chunk, 1 << 16), 1 << 20)
    if mesh is not None:
        from .parallel import meta_sharded as msh

        if not msh.scan_tile_aligned(chunk):
            # unaligned chunk sizes cannot take direct sharded ingest:
            # rebuild on the lead device and re-shard
            return msh.ShardedMetaStore.shard(load_meta_dir(path, device=mesh.lead), mesh)
        if storage == "int8":
            dv = msh.materialize_int8_slabs_sharded(slab_fn, n, d, slab_rows, mesh,
                                                    chunk_size=chunk)
        else:
            dv = msh.materialize_f32_slabs_sharded(slab_fn, n, d, slab_rows, mesh,
                                                   chunk_size=chunk,
                                                   dtype=getattr(torch, storage))
    else:
        device = resolve_device(device, "MetaStore.load(path, device='cpu')")
        if storage == "int8":
            dv = scoring.materialize_int8_slabs(slab_fn, n, d, slab_rows, device=device)
        elif storage == "bfloat16":
            # bf16 on one device: host assembly (the small-store path)
            dv = scoring.materialize(slab_fn(0, n)[:n], dtype=torch.bfloat16, device=device)
        else:
            dv = scoring.materialize_f32_slabs(slab_fn, n, d, slab_rows, device=device)

    builder = MetaStore.from_columns(cols).with_vectors(dv, n_rows=n).with_chunk_size(chunk)
    if m0["bloom_kind"] == "fpr":
        builder = builder.with_bloom_fpr(m0["bloom_val"])
    else:
        builder = builder.with_bloom_bits(int(m0["bloom_val"]))
    # no with_sort_by / with_z_order: the payload and columns are already in
    # device (sorted) order; the sort metadata is re-attached below
    store = builder.build_sharded(mesh) if mesh is not None else (
        builder.with_device(device).build())

    if index_map is not None:
        store._index_map = index_map
        store._sort_by = tuple(m0["sort_by"]) if m0.get("sort_by") else None
        store._z_order = tuple(m0["z_order"]) if m0.get("z_order") else None
        inv = np.empty(n, dtype=np.int64)
        inv[index_map] = np.arange(n)
        orig = {}
        for name, colo in store._columns.items():
            vals = colo.values()
            nulls = np.asarray(colo.null_mask(), dtype=bool)[:n]
            ovals = vals[:n][inv] if isinstance(vals, np.ndarray) else [vals[i] for i in inv]
            oc = Column(name, colo.dtype)
            oc._set_raw(ovals, nulls[inv])
            orig[name] = oc
        store._orig_columns = orig

    if m0.get("rerank") == "keep_host_f32":
        host = np.empty((n, d), dtype=np.float32)
        for lo, hi, f in pieces:
            with np.load(f) as zz:
                rows = np.asarray(zz["rows"], dtype=np.float32)
            if index_map is not None:
                host[index_map[lo:hi]] = rows
            else:
                host[lo:hi] = rows
        store._rerank_host = host
        store._rerank_config = (None, True)

        def _fetch(ids, _hf=host):
            return _hf[np.asarray(ids, dtype=np.int64)]

        store._rerank_fetch = _fetch
    elif m0.get("rerank") == "fetch":
        store._rerank_config = None  # a fetch function cannot be serialized

    if m0.get("has_resid") and storage in ("int8", "bfloat16"):
        # the ORIGINAL true-f32 residual bounds (sound against the source
        # data, not only against the codes), restored so that a re-attached
        # fetch_vectors source keeps the certificate valid
        resid_host = np.zeros(dv.vectors.shape[0], dtype=np.float32)
        resid_host[:n] = np.concatenate([_read(lo, hi, "resid") for lo, hi, _ in pieces])
        store._place_resid(resid_host)

    if deleted.size:
        store.delete_rows(deleted)
    store._restore_cert_hints(m0.get("cert_hints"))
    return store


def save_vec(store: VecStore, path: str) -> None:
    manifest = {
        "format_version": _FORMAT_VERSION,
        "kind": "VecStore",
        "dim": store.dim,
        "n": len(store),
        "dtype": store._dtype,
    }
    with open(path, "wb") as f:
        np.savez(
            f,
            vectors=store._host_matrix(),
            manifest=np.frombuffer(json.dumps(manifest).encode("utf-8"), np.uint8),
        )


def load_vec(path: str, *, device=None) -> VecStore:
    """Load a VecStore saved by :func:`save_vec` (or by the JAX package);
    it materializes on ``device`` (default: the current CUDA device)."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode("utf-8"))
        if manifest.get("kind") != "VecStore":
            raise OttersError(f"{path} does not contain a VecStore")
        store = VecStore(manifest["dim"], dtype=manifest.get("dtype", "float32"), device=device)
        vectors = np.asarray(z["vectors"])
        if len(vectors):
            store.add_vectors(vectors)
        return store
