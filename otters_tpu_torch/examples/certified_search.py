"""Certified-exact search over quantized storage.

Twin of the JAX package's ``examples/certified_search.py``. int8 storage
is 4x smaller but approximate; the certificate restores recall 1.0: the
scan returns a sound upper bound on the true cosine of every row it did not
hand to the exact re-rank, and if the k-th exact score beats that bound no
unexamined row could have entered the top-k. On failure the scan widens
(4x per round) and remembers the working width per plan shape.

Usage: python -m otters_tpu_torch.examples.certified_search [n] [d] [device]
(device defaults to the current CUDA device).
"""

from __future__ import annotations

import sys

import numpy as np

from .. import Column, DataType, MetaStore, Metric


def main(n: int = 100_000, d: int = 128, device=None):
    """Run the example; returns the certified query's results and stats."""
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(n, d)).astype(np.float32)

    # adversarial cluster: 200 rows within int8 quantization error of each
    # other, which a narrow quantized scan cannot rank correctly
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    w = rng.normal(size=(200, d))
    w -= (w @ u)[:, None] * u[None, :]
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    eps = 0.05 + 0.25 * rng.permutation(200) / 200
    vecs[:200] = (u[None, :] + eps[:, None] * w).astype(np.float32)

    ids = Column("id", DataType.Int64).from_values(list(range(n)))
    builder = (
        MetaStore.from_columns([ids])
        .with_vectors(vecs)
        .with_chunk_size(1024)
        .with_storage_dtype("int8")             # 4x less memory
        .with_rerank_source(keep_host_f32=True)  # the exactness source
    )
    store = (builder if device is None else builder.with_device(device)).build()

    q = u.astype(np.float32)
    res = store.query(q, Metric.Cosine).take(10, rerank_from=50).collect()
    stats = store.last_query_stats()
    print(f"certified          : {stats.certified}")
    print(f"scan width used    : {stats.scan_k_wide} (asked for 50)")
    print(f"top-10 row ids     : {res.indices}")

    # prove it against the f32 oracle
    s = (vecs @ q) / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(q))
    want = np.argsort(-s, kind="stable")[:10].tolist()
    assert res.indices == want, (res.indices, want)
    print("matches f32 oracle : True")

    # the width is remembered: the next query starts wide and certifies in
    # one dispatch
    store.query(q, Metric.Cosine).take(10, rerank_from=50).collect()
    print(f"second query width : {store.last_query_stats().scan_k_wide} "
          "(no re-widening)")

    # certify=False restores the fixed-width measured behavior
    store.query(q, Metric.Cosine).take(10, rerank_from=50, certify=False).collect()
    print(f"certify=False      : certified={store.last_query_stats().certified}")
    return res, stats


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 100_000,
        int(sys.argv[2]) if len(sys.argv) > 2 else 128,
        sys.argv[3] if len(sys.argv) > 3 else None,
    )
