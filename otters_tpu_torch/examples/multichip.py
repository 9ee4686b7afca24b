"""Sharded search over a mesh of devices.

Twin of the JAX package's ``examples/multichip.py``. The mesh holds the
given devices (every visible CUDA device by default; a device may be
listed more than once, e.g. ``cpu`` eight times to try it without cards).
Across processes, call ``otters_tpu_torch.parallel.init_distributed()``
first.

Usage: python -m otters_tpu_torch.examples.multichip [n_rows] [dim] [device ...]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from .. import Column, DataType, MetaStore, Metric, col
from ..parallel import ShardedMetaStore, make_mesh


def _kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def main(n: int = 100_000, d: int = 128, devices=None):
    """Run the example; returns (the sharded store, its first results)."""
    n_dev = make_mesh(devices=devices).devices.size
    batch = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh(rows=n_dev // batch, batch=batch, devices=devices)
    print(f"mesh: {dict(mesh.shape)} over {n_dev} x {_kind(mesh.lead)}")

    rng = np.random.default_rng(0)
    # direct sharded build: every array is placed straight onto its shard's
    # device; the store never exists on one device
    store = (
        MetaStore.from_columns(
            [
                Column("price", DataType.Float64).from_values(
                    list(rng.uniform(1, 100, n))
                )
            ]
        )
        .with_vectors(rng.normal(size=(n, d)).astype(np.float32))
        .with_chunk_size(1024)
        .build_sharded(mesh)
    )
    assert isinstance(store, ShardedMetaStore)

    queries = rng.normal(size=(8, d)).astype(np.float32)
    results = (
        store.query_batch(queries, Metric.Cosine)
        .meta_filter(col("price").lt(25.0))
        .take(10)
        .collect()
    )
    print(results)
    store.print_last_query_stats()

    # mutate in place: tombstone deletes, then a compacting append; both
    # stay on the mesh
    store.delete_rows([int(results.indices[0])])
    store = store.append(
        rng.normal(size=(4, d)).astype(np.float32),
        {"price": [9.5, 10.5, 11.5, 12.5]},
    )
    print(f"after delete+append: {len(store)} rows")

    # persistence at mesh scale: save gathers to one .npz; load(mesh=...)
    # rebuilds by direct sharded ingest
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "store.npz")
        store.save(path)
        reloaded = MetaStore.load(path, mesh=mesh)
    assert isinstance(reloaded, ShardedMetaStore)
    r2 = (
        reloaded.query_batch(queries, Metric.Cosine)
        .meta_filter(col("price").lt(25.0))
        .take(10)
        .collect()
    )
    assert r2.indices == (
        store.query_batch(queries, Metric.Cosine)
        .meta_filter(col("price").lt(25.0))
        .take(10)
        .collect()
        .indices
    )
    print("sharded save -> load(mesh) roundtrip: identical results")
    return store, results


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 100_000,
        int(sys.argv[2]) if len(sys.argv) > 2 else 128,
        sys.argv[3:] or None,
    )
