"""Persistence: save / load stores to one file.

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

The per-shard directory format of the sharded store (``sharded-v1``) is not
ported yet: a directory path raises ``NotImplementedError``, as does a
``mesh``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .column import Column
from .errors import OttersError
from .meta import MetaStore
from .types import DataType
from .vec import VecStore

_FORMAT_VERSION = 1

_SHARDED = (
    "the per-shard directory format and mesh loading wait for the multi-GPU "
    "store (ROADMAP.md, Queue 1: parallel/)"
)


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
    ``fetch_vectors`` one must be re-attached by rebuilding from columns."""
    if os.path.isdir(path):
        raise NotImplementedError(f"MetaStore.load({path!r}): {_SHARDED}")
    if mesh is not None:
        raise NotImplementedError(f"MetaStore.load(mesh=...): {_SHARDED}")
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
        if device is not None:
            builder = builder.with_device(device)
        store = builder.build()
        if "deleted" in z:
            deleted = np.flatnonzero(np.asarray(z["deleted"]))
            if deleted.size:
                store.delete_rows(deleted)
        store._restore_cert_hints(manifest.get("cert_hints"))
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
