"""E-commerce catalog walkthrough: the query surface end to end.

Twin of the JAX package's ``examples/catalog.py``. Shows, on a clustered
synthetic catalog (``otters_tpu_torch.datasets``):
- Z-order clustering over (category, price) so zonemaps prune both columns
- Bool columns, null predicates, isin / between, and ``~`` (NOT)
- fuzzy string matching
- build / query stats tables showing the pruning

Usage: python -m otters_tpu_torch.examples.catalog [n_rows] [dim] [device]
(device defaults to the current CUDA device).
"""

from __future__ import annotations

import sys

from .. import MetaStore, Metric, col
from ..datasets import synthetic_catalog


def main(n: int = 20_000, dim: int = 128, device=None):
    """Run the walkthrough; returns (store, the int8 store's results) for
    callers that check them."""
    print(f"=== Generating a {n} x {dim} catalog ===")
    vecs, cols = synthetic_catalog(n, dim, seed=7)

    def builder():
        b = MetaStore.from_columns(list(cols.values())).with_vectors(vecs).with_chunk_size(512)
        return b if device is None else b.with_device(device)

    store = builder().with_z_order(["category", "price"]).build()  # both columns get locality
    store.print_build_stats()
    print("\n=== First rows ===")
    store.head()

    q = vecs[0]

    print("\n=== Cheap in-stock electronics (category+price both prune) ===")
    r = (
        store.query(q.tolist(), Metric.Cosine)
        .meta_filter(
            col("category").eq("electronics")
            & col("price").between(5.0, 40.0)
            & col("in_stock").eq(True)
        )
        .take(5)
        .collect()
    )
    print(r)
    store.print_last_query_stats()

    print("\n=== Rows missing a price or brand (null predicates) ===")
    r = (
        store.query(q.tolist(), Metric.Cosine)
        .meta_filter(col("price").is_null() | col("brand").is_null())
        .take(5)
        .collect()
    )
    print(r)

    print("\n=== NOT + isin: anything except groceries, from three brands ===")
    r = (
        store.query(q.tolist(), Metric.Cosine)
        .meta_filter(
            ~col("category").eq("grocery")
            & col("brand").isin(["brand_00", "brand_01", "brand_02"])
        )
        .take(5)
        .collect()
    )
    print(r)

    print("\n=== Fuzzy brand match (<= 1 edit of 'brand_0x') ===")
    r = (
        store.query(q.tolist(), Metric.Cosine)
        .meta_filter(col("brand").fuzzy("brand_0x", 1))
        .take(5)
        .collect()
    )
    print(r)

    print("\n=== Recent, well-reviewed listings (datetime + int64) ===")
    r = (
        store.query(q.tolist(), Metric.Cosine)
        .meta_filter(col("listed").gte("2024-10-01") & col("reviews").gt(50))
        .take(5)
        .collect()
    )
    print(r)
    store.print_last_query_stats()

    print("\n=== int8 storage + exact re-rank (recall\u00a0recovery) ===")  # JAX's no-break space
    # quantized storage at a quarter of the memory; take(k, rerank_from=k')
    # re-scores the widened candidate set in exact f32 from the builder's
    # rerank source
    store8 = builder().with_storage_dtype("int8").with_rerank_source(keep_host_f32=True).build()
    r = (
        store8.query(q.tolist(), Metric.Cosine)
        .meta_filter(col("category").eq("electronics"))
        .take(5, rerank_from=100)
        .collect()
    )
    print(r)
    return store, r


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 20_000,
        int(sys.argv[2]) if len(sys.argv) > 2 else 128,
        sys.argv[3] if len(sys.argv) > 3 else None,
    )
