"""The cases of ``test_torch_multihost.py``, written once for both packages.

Each case builds its stores through ``pkg``'s public API (``otters_tpu`` or
``otters_tpu_torch``) on the ``[rows, batch]`` meshes ``meshes`` names,
checks every answer against a numpy oracle (as ``tests/test_multihost.py``'s
workers do) and returns the answers as plain data: indices, scores as
Python floats (exact), and the query statistics. The two worker processes
of the port run a case on a mesh that spans them; the test runs it again
in its own process on the port's single-process mesh (the answers must be
equal bit for bit) and on the JAX package's (the same indices, flags and
statistics; scores within a tolerance).
"""

import importlib
import os

import numpy as np


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _stats(store):
    s = store.last_query_stats()
    return [s.certified, s.scan_k_wide, s.pruned_chunks, s.evaluated_chunks, s.total_chunks,
            s.vectors_compared]


def _answer(store, res):
    return {"i": [int(i) for i in res.indices], "s": [float(x) for x in res.scores],
            "st": _stats(store)}


class _direct_limit:
    """``scoring.DIRECT_LIMIT`` lowered in ``pkg`` (the fused path at this
    size: the port's kernel through its plain version, the JAX kernel in
    interpret mode)."""

    def __init__(self, pkg, limit):
        self.sc, self.limit = _mod(pkg, "ops.scoring"), limit

    def __enter__(self):
        self.old = self.sc.DIRECT_LIMIT
        if self.limit is not None:
            self.sc.DIRECT_LIMIT = self.limit

    def __exit__(self, *exc):
        self.sc.DIRECT_LIMIT = self.old


PATHS = {"direct": None, "fused": 1 << 10}


def _cosine(queries, vectors):
    qi = 1 / np.linalg.norm(queries, axis=1)
    vi = 1 / np.linalg.norm(vectors, axis=1)
    return (queries @ vectors.T) * qi[:, None] * vi[None, :]


def _oracle(s, k, n):
    flat = s.reshape(-1)
    order = np.argsort(-flat, kind="stable")[:k]
    return (order % n).tolist(), flat[order]


def vecstore(pkg, meshes, tmp):
    """``ShardedVecStore.search`` (``_WORKER``'s recipe) on each mesh."""
    rng = np.random.default_rng(0)  # same data on every process
    n, d, k = 512, 16, 7
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(2, d)).astype(np.float32)
    want_rows, want_scores = _oracle(_cosine(queries, vectors), k, n)
    out = {}
    for name, mesh in meshes.items():
        store = pkg.parallel.ShardedVecStore(mesh, vectors)
        for metric in ("Cosine", "DotProduct"):
            got = store.search(queries, getattr(pkg.Metric, metric), k=k)
            out[f"{name} {metric}"] = {"i": [r.index for r in got],
                                       "s": [float(r.score) for r in got]}
        got = out[f"{name} Cosine"]
        assert got["i"] == want_rows, (got["i"], want_rows)
        np.testing.assert_allclose(got["s"], want_scores, rtol=1e-5, atol=1e-6)
    return out


def meta(pkg, meshes, tmp):
    """``build_sharded`` with a zonemap / Bloom filter (``_META_WORKER``'s
    recipe), on the direct and fused paths, plus a certified int8 store
    queried in pipelined batches on both paths."""
    rng = np.random.default_rng(1)  # same data on every process
    n, d, chunk, k = 2048, 16, 256, 6
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    price = ((np.arange(n) // chunk) % 2 * 50.0 + np.arange(n) % 10).astype(np.float64)
    tag = ["blue" if (i // chunk) % 4 == 0 else "red" for i in range(n)]
    queries = rng.normal(size=(2, d)).astype(np.float32)
    batches = [rng.normal(size=(2, d)).astype(np.float32) for _ in range(3)]
    mask = (price < 10.0) & np.array([t == "blue" for t in tag])
    s = _cosine(queries, vectors)
    s[:, ~mask] = -np.inf
    want_rows, want_scores = _oracle(s, k, n)
    flt = pkg.col("price").lt(10.0) & pkg.col("tag").eq("blue")
    out = {}
    for name, mesh in meshes.items():
        cols = [pkg.Column("price", pkg.DataType.Float64).from_values(price),
                pkg.Column("tag", pkg.DataType.String).from_values(tag)]
        store = (pkg.MetaStore.from_columns(cols).with_vectors(vectors).with_chunk_size(chunk)
                 .build_sharded(mesh))
        int8 = (pkg.MetaStore.from_columns([]).with_vectors(vectors).with_chunk_size(chunk)
                .with_storage_dtype("int8").with_rerank_source(keep_host_f32=True)
                .build_sharded(mesh))
        for path, limit in PATHS.items():
            with _direct_limit(pkg, limit):
                r = store.query_batch(queries, pkg.Metric.Cosine).meta_filter(flt).take(k) \
                    .collect()
                assert r.indices == want_rows, (path, r.indices, want_rows)
                np.testing.assert_allclose(r.scores, want_scores, rtol=1e-5, atol=1e-6)
                assert store.last_query_stats().evaluated_chunks == (n // chunk) // 4
                out[f"{name} {path} filter"] = _answer(store, r)
                pend = [int8.query_batch(q, pkg.Metric.Cosine).take(5, rerank_from=40)
                        .collect_async() for q in batches]
                for i, (p, q) in enumerate(zip(pend, batches)):
                    res = p.result()
                    assert res.indices == _oracle(_cosine(q, vectors), 5, n)[0]
                    assert int8.last_query_stats().certified is True
                    out[f"{name} {path} certified {i}"] = _answer(int8, res)
    return out


def _colliding(pkg):
    """Every string hashes alike: the device Eq mask passes every row and
    the exact host-mask redo must run (``_EXOTIC_WORKER``'s patch)."""
    hashing = _mod(pkg, "ops.hashing")
    saved = hashing.hash_strings, hashing.hash_string

    def restore():
        hashing.hash_strings, hashing.hash_string = saved

    hashing.hash_strings = lambda strings: (np.full(len(strings), 12345, np.uint64),
                                            np.full(len(strings), 99991, np.uint64))
    hashing.hash_string = lambda s: (np.uint64(12345), np.uint64(99991))
    return restore


def exotic_store(pkg, mesh, tag, vectors, chunk=256):
    return (pkg.MetaStore.from_columns([pkg.Column("tag", pkg.DataType.String).from_values(tag)])
            .with_vectors(vectors).with_chunk_size(chunk).with_storage_dtype("int8")
            .with_rerank_source(keep_host_f32=True).build_sharded(mesh))


def exotic_data():
    rng = np.random.default_rng(7)  # same data on every process
    n, d = 26_000, 16  # rows in all four shards of a rows=4 mesh (8192 rows a shard)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    tag = [f"item-{i % 11}{'-x' if i % 3 == 0 else ''}" for i in range(n)]
    queries = rng.normal(size=(2, d)).astype(np.float32)
    return vectors, tag, queries


def exotic(pkg, meshes, tmp):
    """``_EXOTIC_WORKER``'s paths: the hostmask ``contains`` with the
    rerank, the certified int8 rerank (direct and fused), the forced
    hash-collision redo, ``delete_rows`` + ``save`` + ``load(mesh=)``, the
    take-all (as the store routes it, and through the per-shard score
    windows); then ``append`` onto the mesh (from the host copy of an int8
    store's rows, and streamed from an f32 store's shards)."""
    vectors, tag, queries = exotic_data()
    n = len(tag)
    s_all = _cosine(queries, vectors)
    mesh = meshes["4"]
    store = exotic_store(pkg, mesh, tag, vectors)
    out = {}

    def run(st, plan, key, want=None):
        r = plan.collect()
        if want is not None:
            assert r.indices == want, (key, r.indices, want)
        out[key] = _answer(st, r)
        return r

    mask = np.array(["-x" in t for t in tag])
    s = s_all.copy()
    s[:, ~mask] = -np.inf
    run(store, store.query_batch(queries, pkg.Metric.Cosine)
        .meta_filter(pkg.col("tag").contains("-x")).take(6, rerank_from=48), "hostmask",
        _oracle(s, 6, n)[0])
    for path, limit in PATHS.items():
        with _direct_limit(pkg, limit):
            run(store, store.query_batch(queries, pkg.Metric.Cosine).take(5, rerank_from=40),
                f"certified {path}", _oracle(s_all, 5, n)[0])
            assert out[f"certified {path}"]["st"][0] is True

    restore = _colliding(pkg)
    try:
        collided = (pkg.MetaStore.from_columns(
            [pkg.Column("tag", pkg.DataType.String).from_values(tag)])
            .with_vectors(vectors).with_chunk_size(256).build_sharded(mesh))
        s3 = s_all.copy()
        s3[:, ~np.array([t == "item-7" for t in tag])] = -np.inf
        run(collided, collided.query_batch(queries, pkg.Metric.Cosine)
            .meta_filter(pkg.col("tag").eq("item-7")).take(6), "collision redo",
            _oracle(s3, 6, n)[0])
    finally:
        restore()

    store.delete_rows([3, 700])
    assert len(store) == n - 2
    path = os.path.join(tmp, "mh_store")
    store.save(path)  # collective: the valid gather, each process's shards
    loaded = pkg.MetaStore.load(path, mesh=mesh)
    assert len(loaded) == n - 2
    a = run(store, store.query_batch(queries, pkg.Metric.Cosine).take(5, rerank_from=40),
            "after delete")
    b = run(loaded, loaded.query_batch(queries, pkg.Metric.Cosine).take(5, rerank_from=40),
            "loaded")
    assert a.indices == b.indices and out["loaded"]["st"][0] is True
    assert 3 not in a.indices and 700 not in a.indices
    # int8 codes and their residuals on disk (no host copy of the rows): a
    # process reads only its own shards' files
    codes = (pkg.MetaStore.from_columns([]).with_vectors(vectors).with_chunk_size(256)
             .with_storage_dtype("int8").build_sharded(mesh))
    codes.save(os.path.join(tmp, "codes"))
    again = pkg.MetaStore.load(os.path.join(tmp, "codes"), mesh=mesh)
    a = run(codes, codes.query_batch(queries, pkg.Metric.Cosine).take(5), "codes")
    b = run(again, again.query_batch(queries, pkg.Metric.Cosine).take(5), "codes loaded")
    assert (a.indices, a.scores) == (b.indices, b.scores)

    f32 = (pkg.MetaStore.from_columns([pkg.Column("tag", pkg.DataType.String).from_values(tag)])
           .with_vectors(vectors).with_chunk_size(256).build_sharded(mesh))
    s5 = s_all[:1].copy()
    s5[:, ~np.array([t == "item-3" for t in tag])] = -np.inf
    flat5 = s5.reshape(-1)
    order5 = [int(i) for i in np.argsort(-flat5, kind="stable") if flat5[i] > -np.inf]
    run(f32, f32.query_batch(queries[:1], pkg.Metric.Cosine)
        .meta_filter(pkg.col("tag").eq("item-3")), "take-all", order5)
    sc = _mod(pkg, "ops.scoring")
    real = sc.needs_windowed
    sc.needs_windowed = lambda n_pad, b, k: n_pad > 4096 or real(n_pad, b, k)
    try:  # the per-shard score windows, merged across processes
        run(f32, f32.query_batch(queries[:1], pkg.Metric.Cosine)
            .meta_filter(pkg.col("tag").eq("item-3")), "take-all windowed", order5)
    finally:
        sc.needs_windowed = real

    rng = np.random.default_rng(8)
    extra = rng.normal(size=(300, vectors.shape[1])).astype(np.float32)
    grown = store.append(extra, {"tag": [f"new-{i % 5}" for i in range(300)]})
    assert len(grown) == n - 2 + 300
    run(grown, grown.query_batch(queries, pkg.Metric.Cosine)
        .meta_filter(pkg.col("tag").eq("new-2")).take(5, rerank_from=40), "append filter")
    run(grown, grown.query_batch(queries, pkg.Metric.Cosine).take(5, rerank_from=40),
        "append certified")
    keep = np.ones(n, bool)
    keep[[3, 700]] = False
    both = np.concatenate([vectors[keep], extra])
    assert out["append certified"]["i"] == _oracle(_cosine(queries, both), 5, len(both))[0]
    # no host copy of the rows: the streaming rebuild gathers them from the
    # shards slab by slab
    f32.delete_rows([5])
    grown = f32.append(extra, {"tag": [f"new-{i % 5}" for i in range(300)]})
    keep[[3, 700]], keep[5] = True, False
    both = np.concatenate([vectors[keep], extra])
    run(grown, grown.query_batch(queries, pkg.Metric.Cosine).take(5), "append streamed",
        _oracle(_cosine(queries, both), 5, len(both))[0])
    return out


CASES = {"vecstore": vecstore, "meta": meta, "exotic": exotic}
