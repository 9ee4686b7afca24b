"""MetaStore demo on the port: chunked zonemap pruning + vector search.

Twin of the JAX package's ``examples/demo.py`` (itself a port of the
reference ``examples/demo.rs``): builds an online-store catalog with
hand-tuned per-chunk distributions so pruning is visible, then runs a
filtered cosine top-5 query and prints build/query stats.

Usage: python -m otters_tpu_torch.demo [n_size] [dim] [device]
(device defaults to the current CUDA device).
"""

from __future__ import annotations

import sys

import numpy as np

from . import Cmp, Column, DataType, MetaStore, Metric, col


def main(n_size: int = 1000, dim: int = 100, device=None):
    """Run the demo; returns (store, results) for callers that check them."""
    rng = np.random.default_rng(0)
    prune_demo_chunk = 128  # ~n_size / 128 chunks

    idx = np.arange(n_size)
    group = idx // prune_demo_chunk
    even = group % 2 == 0

    name_vals = [f"item_{i}" for i in range(n_size)]
    # price: expensive in even-numbered chunks, cheap in odd-numbered chunks
    price_vals = np.where(even, 80.0 + (idx % 20), 10.0 + (idx % 20)).tolist()
    mfg_vals = ["2024-01-01" if e else "2024-07-01" for e in even]
    exp_vals = ["2024-12-31" if e else "2025-12-31" for e in even]
    version_vals = np.where(even, 1, 3).tolist()

    columns = [
        Column("name", DataType.String).from_values(name_vals),
        Column("price", DataType.Float64).from_values(price_vals),
        Column("mfg", DataType.DateTime).from_values(mfg_vals),
        Column("exp", DataType.DateTime).from_values(exp_vals),
        Column("version", DataType.Int32).from_values(version_vals),
    ]

    vectors = rng.uniform(-1.0, 1.0, size=(n_size, dim)).astype(np.float32)
    builder = (
        MetaStore.from_columns(columns)
        .with_vectors(vectors)
        .with_chunk_size(prune_demo_chunk)
    )
    if device is not None:
        builder = builder.with_device(device)
    meta = builder.build()
    print("=== MetaStore built ===")
    meta.print_build_stats()

    print("\n=== MetaStore Head (ASCII table) ===")
    meta.head()

    print(
        "Note: example data is hand-tuned per chunk to clearly show pruning; "
        "real datasets may prune less unless clustered by filter columns.\n"
    )

    query = rng.uniform(-1.0, 1.0, size=dim).astype(np.float32)
    meta_results = (
        meta.query(query, Metric.Cosine)
        .meta_filter(
            # Prunes all even-numbered chunks (price high, exp in 2024, version 1)
            col("price").lt(50.0)
            & col("version").gte(2)
            & col("exp").gte("2025-01-01")
        )
        .vec_filter(0.1, Cmp.Gt)
        .take(5)
        .collect()
    )

    print("\n=== Meta query top 5 (ASCII table) ===")
    print(meta_results)

    meta.print_last_query_stats()

    print("\n=== Access result columns (head) ===")
    for cname in ("name", "price", "version"):
        c = meta_results.column(cname)
        if c is not None:
            c.head()
    return meta, meta_results


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 1000,
        int(sys.argv[2]) if len(sys.argv) > 2 else 100,
        sys.argv[3] if len(sys.argv) > 3 else None,
    )
