"""Throughput serving pattern: pipelined async queries.

Twin of the JAX package's ``examples/async_serving.py``. Dispatch many
query batches without waiting on the device, then resolve them all at
once: each batch's small outputs stream back to the host behind the later
batches' scans.

Usage: python -m otters_tpu_torch.examples.async_serving [n_rows] [dim] [batches] [device]
(device defaults to the current CUDA device).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import Column, DataType, MetaStore, Metric, col, resolve


def _on(builder, device):
    return builder if device is None else builder.with_device(device)


def main(n: int = 100_000, d: int = 128, n_batches: int = 8, device=None):
    """Run the example; returns (the pipelined results, the int8 store's
    pipelined results) for callers that check them."""
    b = 64

    rng = np.random.default_rng(0)
    store = _on(
        MetaStore.from_columns(
            [
                Column("category", DataType.String).from_values(
                    [f"cat_{i % 16}" for i in range(n)]
                ),
                Column("score", DataType.Float32).from_values(
                    list(rng.uniform(0, 1, n).astype(np.float32))
                ),
            ]
        )
        .with_vectors(rng.normal(size=(n, d)).astype(np.float32))
        .with_chunk_size(1024),
        device,
    ).build()

    def dispatch():
        q = rng.normal(size=(b, d)).astype(np.float32)
        return (
            store.query_batch(q, Metric.Cosine)
            .meta_filter(col("category").eq("cat_3") & col("score").gt(0.5))
            .take(10)
            .collect_async()
        )

    dispatch().result()  # warm-up

    t0 = time.perf_counter()
    for _ in range(n_batches):
        dispatch().result()  # one round trip per batch
    seq = time.perf_counter() - t0

    t0 = time.perf_counter()
    results = resolve([dispatch() for _ in range(n_batches)])
    pipe = time.perf_counter() - t0

    total_q = b * n_batches
    print(f"sequential: {total_q / seq:,.0f} q/s")
    print(f"pipelined : {total_q / pipe:,.0f} q/s")
    print(f"sample top hit: {results[0].indices[0]} "
          f"(category={results[0].column('category').string_values()[0]})")

    # --- quantized storage + exact re-rank, still pipelined -----------------
    # int8 storage (a quarter of the memory) with take(k, rerank_from=k'):
    # resolve() re-scores every in-flight batch's widened candidates in one
    # device program, so exactness costs one extra dispatch per pipeline,
    # not one per batch.
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    store8 = _on(
        MetaStore.from_columns(
            [
                Column("score", DataType.Float32).from_values(
                    list(rng.uniform(0, 1, n).astype(np.float32))
                ),
            ]
        )
        .with_vectors(vecs)
        .with_chunk_size(1024)
        .with_storage_dtype("int8")
        .with_rerank_source(keep_host_f32=True),
        device,
    ).build()

    def dispatch8():
        q = rng.normal(size=(b, d)).astype(np.float32)
        return (
            store8.query_batch(q, Metric.Cosine)
            .meta_filter(col("score").gt(0.25))
            .take(10, rerank_from=100)
            .collect_async()
        )

    # production serving warms everything off the query path, including the
    # batched rerank for this pipeline depth (its shape depends on the
    # resolve() group size, which single queries never exercise)
    store8.precompile(
        filters=[col("score").gt(0.25)], batch_sizes=(b,), k=10,
        rerank_from=100, pipeline_depths=(n_batches,),
    )
    t0 = time.perf_counter()
    results8 = resolve([dispatch8() for _ in range(n_batches)])
    pipe8 = time.perf_counter() - t0
    print(f"int8 + exact rerank, pipelined: {total_q / pipe8:,.0f} q/s "
          f"({len(results8[0])} exact-top-10 results per batch)")
    return results, results8


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 100_000,
        int(sys.argv[2]) if len(sys.argv) > 2 else 128,
        int(sys.argv[3]) if len(sys.argv) > 3 else 8,
        sys.argv[4] if len(sys.argv) > 4 else None,
    )
