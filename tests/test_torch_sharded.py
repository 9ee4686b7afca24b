"""The port's row-sharded MetaStore against the JAX package's.

Mirrors ``tests/test_meta_sharded.py`` and ``tests/test_build_sharded.py``.
Each case builds the same store in both packages from the same seeded
numpy inputs: the JAX package over conftest's 8 virtual CPU devices, the
port over the CPU listed 8 times, on a ``rows=4, batch=2`` and a ``rows=8``
mesh. The fused path lowers ``scoring.DIRECT_LIMIT`` in both packages, so
each shard runs the JAX kernel in interpret mode and the port's kernel
through its plain version. Every query asserts the same indices in the
same order, the same ``certified`` flag and scan width, the same evaluated
/ pruned chunk counts and compared vectors, and scores within
``torch_parity``'s tolerances:

- filters (numeric, Bloom strings, extended strings, nulls / bools /
  64-bit columns, ``vec_filter``) on int8, bfloat16 and f32 storage, on the
  direct and fused paths, the certificate on and off;
- the fast-exact check failing on the shards and the strict redo, and the
  hash-collision redo (direct and take-all sized);
- sorted and Z-ordered stores (original ids), ``delete_rows`` and
  ``append`` (streamed and staged, int8 codes bit for bit), the windowed
  take-all, the pruned scan of a VPU metric, ``shard()`` of a
  single-device store, the sharded int8 slab ingest and the device Bloom
  build bit for bit, ``precompile``'s count, and the error paths with
  JAX's messages.
"""

import functools

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu.errors import OttersError as JOttersError
from otters_tpu_torch.errors import OttersError
from otters_tpu_torch.parallel import ShardedMetaStore, ShardedTensor
from torch_parity import (
    assert_same_metric,
    columns,
    stats_tuple,
    twin_meshes,
    use_fused_path,
)

N, D, CHUNK = 20_000, 32, 512
PKGS = (jx, tx)


def _spec(n, rng):
    """test_build_sharded.py's columns: every dtype, nulls in three."""
    price = [None if i % 53 == 0 else float(rng.uniform(0, 100)) for i in range(n)]
    flag = [None if i % 29 == 0 else (i % 2 == 0) for i in range(n)]
    return [
        ("price", "Float64", price),
        ("version", "Int32", (np.arange(n) % 7).astype(np.int32)),
        ("tag", "String", [f"t{i % 37}" for i in range(n)]),
        ("when", "DateTime", [f"202{i % 4}-0{i % 9 + 1}-15" for i in range(n)]),
        ("flag", "Bool", flag),
        ("count", "Int64", (np.arange(n, dtype=np.int64) * 3_000_000_000) % (1 << 40)),
        ("weight", "Float32", rng.normal(size=n).astype(np.float32)),
    ]


@functools.cache
def _data():
    rng = np.random.default_rng(31)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    spec = _spec(N, rng)
    return {"vecs": vecs, "spec": spec, "q": rng.normal(size=(3, D)).astype(np.float32)}


def _builder(pkg, vecs, spec, *, storage="int8", keep=True, layout=None, chunk=CHUNK):
    b = (pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs)
         .with_chunk_size(chunk).with_storage_dtype(storage))
    if keep:
        b = b.with_rerank_source(keep_host_f32=True)
    if layout == "sort":
        b = b.with_sort_by("price", descending=True)
    elif layout == "z":
        b = b.with_z_order(["tag", "price"])
    return b


@functools.cache
def _twins(storage="int8", mesh="4x2", layout=None):
    """(JAX store, port store) built sharded from the module's data, once
    per module (the stores are never mutated; both see the same queries in
    the same order, so their certificate width hints stay alike)."""
    d = _data()
    return tuple(
        _builder(pkg, d["vecs"], d["spec"], storage=storage, layout=layout).build_sharded(m)
        for pkg, m in zip(PKGS, twin_meshes(mesh))
    )


FILTERS = {
    "none": None,
    "numeric": lambda p: p.col("price").lt(30.0) & p.col("when").gte("2022-01-01"),
    "bloom": lambda p: p.col("tag").eq("t5") | p.col("tag").eq("t11"),
    "extended": lambda p: p.col("tag").contains("t1") & ~p.col("version").eq(3),
    "nulls": lambda p: ((p.col("flag").eq(True) | p.col("price").is_null())
                        & p.col("count").gt(1 << 33)),
}
# the metric each storage is queried with: int8 is Cosine-only; bf16 Dot
# takes the general certificate fold (K5 on the fused path); f32 Euclid is
# a take-min on the fast-exact path
METRIC = {"int8": "Cosine", "bfloat16": "DotProduct", "float32": "Euclidean"}


def _plan(store, pkg, q, metric, flt=None, vf=None):
    plan = store.query_batch(q, getattr(pkg.Metric, metric))
    if flt is not None:
        plan = plan.meta_filter(flt(pkg))
    if vf is not None:
        plan = plan.vec_filter(vf[0], getattr(pkg.Cmp, vf[1]))
    return plan


def _both(stores, q, metric, flt=None, vf=None, **take):
    """Run one query on both stores -> (JAX result, port result)."""
    k = take.pop("k", 10)
    return tuple(_plan(s, pkg, q, metric, flt, vf).take(k, **take).collect()
                 for pkg, s in zip(PKGS, stores))


def _check(stores, q, metric, flt=None, vf=None, **take):
    rj, rt = _both(stores, q, metric, flt, vf, **take)
    assert_same_metric(rj, rt, stores[0], stores[1], metric)
    return rj, rt


# the fused path runs the kernel in its own masks' place: the leaves that
# only change the masks (extended strings, nulls) run on the direct path
FUSED_FILTERS = ("none", "numeric", "bloom")


@pytest.mark.parametrize("path", ["direct", "fused"])
@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("mesh", ["4x2", "8"])
def test_filters_match_jax(mesh, storage, path, monkeypatch):
    from otters_tpu_torch.ops import fused_topk as ft

    if path == "fused":
        use_fused_path(monkeypatch)
    launches = []
    orig = ft.fused_topk
    monkeypatch.setattr(ft, "fused_topk", lambda *a, **kw: launches.append(1) or orig(*a, **kw))
    stores = _twins(storage, mesh)
    metric, q = METRIC[storage], _data()["q"]
    for name, flt in FILTERS.items():
        if path == "fused" and name not in FUSED_FILTERS:
            continue
        # the certificate (int8 / bf16) with the exact rerank, then the
        # uncertified scan of the same width
        rj, _ = _check(stores, q, metric, flt, k=10, rerank_from=40)
        if storage != "float32" and len(rj) == 10:
            assert stores[1].last_query_stats().certified is True, name
        _check(stores, q, metric, flt, k=40)
    _check(stores, q, metric, FILTERS["numeric"], k=10, rerank_from=40, certify=False)
    vf = (float(D) * 2.2, "Lt") if metric == "Euclidean" else (0.2, "Gt")
    _check(stores, q, metric, FILTERS["numeric"], vf, k=15, rerank_from=40)
    _check(stores, q, metric, None, vf, k=25)
    # the fused path launches the kernel on every shard; the direct one never
    assert (len(launches) > 0) == (path == "fused")


@pytest.mark.parametrize("mesh", ["4x2", "8"])
def test_bf16_certified_cosine_and_euclid_match_jax(mesh, monkeypatch):
    use_fused_path(monkeypatch)
    stores = _twins("bfloat16", mesh)
    q = _data()["q"]
    for metric, vf in (("Cosine", (0.1, "Gte")), ("Euclidean", (60.0, "Lte"))):
        for flt in (None, FILTERS["numeric"]):
            _check(stores, q, metric, flt, k=10, rerank_from=40)
            assert stores[1].last_query_stats().certified is True
        _check(stores, q, metric, FILTERS["bloom"], vf, k=10, rerank_from=40)


def test_stats_sum_over_the_row_shards():
    sj, st = _twins()
    q = _data()["q"][:2]
    for pkg, s in zip(PKGS, (sj, st)):
        s.query_batch(q, pkg.Metric.Cosine).meta_filter(pkg.col("version").eq(2)).take(5).collect()
    assert stats_tuple(st) == stats_tuple(sj)
    # unfiltered: the padding chunks of the shards count for nothing
    for pkg, s in zip(PKGS, (sj, st)):
        s.query_batch(q, pkg.Metric.Cosine).take(5).collect()
    assert stats_tuple(st) == stats_tuple(sj)
    ls = st.last_query_stats()
    assert ls.evaluated_chunks == st.n_chunks() == -(-N // CHUNK)
    assert ls.vectors_compared == N * 2


def test_every_array_lies_on_its_shard():
    """The capacity contract: every row and chunk array is one tensor per
    row shard, each holding its shard's rows only."""
    _, st = _twins()
    from otters_tpu_torch.parallel import sharded_geometry

    n_pad_s, n_chunks_s, _ = sharded_geometry(N, CHUNK, 4)
    dv = st._dv
    for arr in (dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, dv.resid):
        assert isinstance(arr, ShardedTensor) and arr.shape[0] == n_pad_s
        assert [s.shape[0] for s in arr.shards] == [n_pad_s // 4] * 4
    assert [s.shape[0] for s in st._chunk_lens.shards] == [n_chunks_s // 4] * 4
    for name, colarrs in st._device_cols.items():
        for key, arr in colarrs.items():
            assert len(arr.shards) == 4, (name, key)


@pytest.mark.parametrize("layout", ["sort", "z"])
def test_sorted_and_zordered_stores_match_jax(layout, monkeypatch):
    use_fused_path(monkeypatch)
    stores = _twins("int8", "4x2", layout)
    q = _data()["q"]
    for flt in (None, FILTERS["numeric"], FILTERS["bloom"]):
        rj, rt = _check(stores, q, "Cosine", flt, k=8, rerank_from=64)
        assert stores[1].last_query_stats().certified is True
        _check(stores, q, "Cosine", flt, k=8)
    # original ingestion-order ids, filtered as the filter says
    price = dict(enumerate(_data()["spec"][0][2]))
    rt = _plan(stores[1], tx, q, "Cosine", FILTERS["numeric"]).take(8, rerank_from=64).collect()
    assert all(price[i] is not None and price[i] < 30.0 for i in rt.indices)


def _pallas_twins(n, d, chunk, seed, storage="float32", mesh="8"):
    """test_meta_sharded.py's fused-path stores: a price column whose even
    chunks hold 0-9 and odd ones 50-59."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    price = (np.arange(n) // chunk % 2 * 50 + np.arange(n) % 10).astype(np.float32)
    spec = [("price", "Float32", price)]
    stores = tuple(
        pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs).with_chunk_size(chunk)
        .with_storage_dtype(storage).build_sharded(m)
        for pkg, m in zip(PKGS, twin_meshes(mesh))
    )
    return stores, vecs, price, rng


def test_fast_exact_failure_redoes_strictly(monkeypatch):
    """A failed fast-exact check on the shards fails the merge and re-runs
    the query strictly, in both packages."""
    import otters_tpu.ops.pallas_topk as pk
    from otters_tpu.parallel.meta_sharded import ShardedMetaStore as JSharded
    from otters_tpu_torch.ops import fused_topk as ft

    use_fused_path(monkeypatch)
    monkeypatch.setattr(pk, "high_precision_bound", lambda d: 1.0e9)
    monkeypatch.setattr(ft, "high_precision_bound", lambda d: 1.0e9)
    strict = {jx: [], tx: []}
    for pkg, cls in ((jx, JSharded), (tx, ShardedMetaStore)):
        orig = cls._run_query_program

        def spy(self, *a, _o=orig, _l=strict[pkg], **kw):
            _l.append(kw.get("strict", False))
            return _o(self, *a, **kw)

        monkeypatch.setattr(cls, "_run_query_program", spy)
    stores, vecs, price, rng = _pallas_twins(32768, 8, 512, 62)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    # unfiltered, the real shards leave bins unexamined: their checks fail
    _check(stores, q, "Cosine", None, k=5)
    assert strict[tx] == strict[jx] == [False, True]
    # filtered, every shard examines all its live bins: no redo
    flt = lambda p: p.col("price").lt(10.0)  # noqa: E731
    _check(stores, q, "Cosine", flt, k=5)
    assert strict[tx] == strict[jx] == [False, True, False]
    # the exact oracle
    s = (q @ vecs.T) / np.linalg.norm(q, axis=1)[:, None] / np.linalg.norm(vecs, axis=1)
    want = np.sort(s.reshape(-1))[::-1][:5]
    rt = _plan(stores[1], tx, q, "Cosine").take(5).collect()
    np.testing.assert_allclose(rt.scores, want, rtol=1e-5, atol=1e-5)


def test_fused_bin_skipping_prunes_per_shard(monkeypatch):
    """The kernel runs per shard over its live bins only: half the chunks
    pruned, the same answers and counts as JAX's."""
    use_fused_path(monkeypatch)
    stores, vecs, price, rng = _pallas_twins(65536, 16, 1024, 56, storage="int8")
    calls = []
    from otters_tpu_torch.ops import fused_topk as ft

    orig = ft.fused_topk
    monkeypatch.setattr(ft, "fused_topk", lambda *a, **kw: calls.append(a[0].shape[0])
                        or orig(*a, **kw))
    q = rng.normal(size=(2, 16)).astype(np.float32)
    flt = lambda p: p.col("price").lt(10.0)  # noqa: E731
    _check(stores, q, "Cosine", flt, k=9)
    assert calls == [65536 // 8] * 8  # one launch per shard, over its own rows
    assert stores[1].last_query_stats().evaluated_chunks == 32


@pytest.mark.parametrize("take_all", [False, True], ids=["direct", "take_all"])
def test_hash_collision_redo_matches_jax(take_all, monkeypatch):
    """A string-hash collision is caught by the host verification and
    corrected through the sharded exact-mask re-run (the windowed path for
    a take-all-sized query)."""
    from otters_tpu.ops import hashing as jh
    from otters_tpu.ops import scoring as jsc
    from otters_tpu_torch.ops import hashing as th
    from otters_tpu_torch.ops import scoring as tsc

    rng = np.random.default_rng(63)
    n, d = 2048, 8
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    names = ["a" if i % 2 == 0 else "b" for i in range(n)]
    spec = [("name", "String", names)]
    stores = tuple(
        pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs).with_chunk_size(128)
        .build_sharded(m) for pkg, m in zip(PKGS, twin_meshes("4x2"))
    )
    for mod in (jh, th):
        real = mod.hash_string
        monkeypatch.setattr(mod, "hash_string",
                            lambda s, _r=real: _r("a") if s == "b" else _r(s))
    if take_all:
        for mod in (jsc, tsc):
            real_nw = mod.needs_windowed
            monkeypatch.setattr(mod, "needs_windowed",
                                lambda n_pad, b, k, _r=real_nw: n_pad > 4096 or _r(n_pad, b, k))
    q = rng.normal(size=(1, d)).astype(np.float32)
    flt = lambda p: p.col("name").eq("b")  # noqa: E731
    rj, rt = _check(stores, q, "Cosine", flt, k=6)
    assert all(names[i] == "b" for i in rt.indices) and len(rt) == 6


def test_windowed_take_all_matches_jax(monkeypatch):
    """The per-shard windowed take-all (forced at this size) with a filter
    of numeric, hostmask and null leaves, a vec_filter and tombstones."""
    from otters_tpu.ops import scoring as jsc
    from otters_tpu_torch.ops import scoring as tsc

    rng = np.random.default_rng(13)
    n, d = 2048, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    spec = [("price", "Float64", [None if i % 41 == 0 else float(i % 90) for i in range(n)]),
            ("tag", "String", [f"t{i % 23}x" for i in range(n)])]
    stores = tuple(
        pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs).with_chunk_size(512)
        .build_sharded(m) for pkg, m in zip(PKGS, twin_meshes("4x2"))
    )
    for s in stores:
        s.delete_rows([0, 7, 500, 1999])
    for mod in (jsc, tsc):
        real = mod.needs_windowed
        monkeypatch.setattr(mod, "needs_windowed",
                            lambda n_pad, b, k, _r=real: n_pad > 4096 or _r(n_pad, b, k))
    q = rng.normal(size=(3, d)).astype(np.float32)
    flt = lambda p: (p.col("price").lt(70.0) | p.col("price").is_null()  # noqa: E731
                     | p.col("tag").contains("3x"))
    rj, rt = _check(stores, q, "Cosine", flt, (-0.5, "Gt"), k=60)
    assert len(rt) == 60
    # a take past SCAN_K_MAX goes to the windows without the patch too
    monkeypatch.undo()
    rj, rt = _both(stores, q[:1], "Cosine", None, None, k=tsc.SCAN_K_MAX + 1)
    assert rt.indices == rj.indices and len(rt) == n - 4
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=1e-6)


def test_vpu_metric_pruned_scan_matches_jax():
    """A filtered Manhattan query at a shard size that takes the pruned
    scan: each shard reads its live tiles only (half of them)."""
    rng = np.random.default_rng(71)
    n, d = 4 * 4 * 8192, 8
    vecs = rng.integers(0, 4, size=(n, d)).astype(np.float32)
    cat = [f"c{(i // 8192) % 2}" for i in range(n)]
    spec = [("cat", "String", cat)]
    stores = tuple(
        pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs).with_chunk_size(1024)
        .build_sharded(m) for pkg, m in zip(PKGS, twin_meshes("4x2"))
    )
    q = rng.integers(0, 4, size=(2, d)).astype(np.float32)
    flt = lambda p: p.col("cat").eq("c1")  # noqa: E731
    rj, rt = _check(stores, q, "Manhattan", flt, k=10)
    assert stores[1].last_query_stats().evaluated_chunks == n // 1024 // 2
    assert all(cat[i] == "c1" for i in rt.indices)


def test_delete_rows_and_append_match_jax(monkeypatch):
    """delete_rows re-places the validity mask per shard; append rebuilds
    onto the mesh (streamed for an unsorted store, host-staged for a sorted
    one), the int8 codes bit for bit with JAX's, over three generations."""
    use_fused_path(monkeypatch)
    d = _data()
    q = d["q"]
    for layout in (None, "sort"):
        sj, st = (_builder(pkg, d["vecs"][:6000], [(nm, dt, v[:6000]) for nm, dt, v in d["spec"]],
                           layout=layout).build_sharded(m)
                  for pkg, m in zip(PKGS, twin_meshes("4x2")))
        rng = np.random.default_rng(23)
        for gen in range(3):
            top = _plan(st, tx, q, "Cosine").take(6).collect()
            dead = list(top.indices[:4]) + rng.choice(st.n_rows, 200).tolist()
            for s in (sj, st):
                s.delete_rows(dead)
            assert len(st) == len(sj)
            for flt in (None, FILTERS["numeric"]):
                rj, rt = _check((sj, st), q, "Cosine", flt, k=8, rerank_from=40)
                assert not set(rt.indices) & set(dead)
                assert st.last_query_stats().certified is True
            m = 300
            new_vecs = rng.normal(size=(m, D)).astype(np.float32)
            new_cols = {nm: list(v[:m]) for nm, _, v in _spec(m, rng)}
            sj, st = sj.append(new_vecs, new_cols), st.append(new_vecs, new_cols)
            assert isinstance(st, ShardedMetaStore) and len(st) == len(sj)
            np.testing.assert_array_equal(st._dv.vectors.numpy(), np.asarray(sj._dv.vectors))
            np.testing.assert_array_equal(st._dv.valid.numpy(), np.asarray(sj._dv.valid))
            _check((sj, st), q, "Cosine", FILTERS["bloom"], k=8, rerank_from=40)
    # the checks of delete_rows keep JAX's messages
    for bad in ([st.n_rows], [-1]):
        with pytest.raises(JOttersError) as ej:
            sj.delete_rows(bad)
        with pytest.raises(OttersError) as et:
            st.delete_rows(bad)
        assert str(et.value) == str(ej.value)


def test_append_without_rerank_carries_residuals():
    """An int8 store without a rerank source re-quantizes its own codes on
    append; the survivors keep their original residuals (JAX's rule)."""
    d = _data()
    vecs, spec = d["vecs"][:4000], [(nm, dt, v[:4000]) for nm, dt, v in d["spec"]]
    sj, st = (_builder(pkg, vecs, spec, keep=False).build_sharded(m)
              for pkg, m in zip(PKGS, twin_meshes("4x2")))
    for s in (sj, st):
        s.delete_rows(range(0, 4000, 9))
    rng = np.random.default_rng(5)
    new_vecs = rng.normal(size=(100, D)).astype(np.float32)
    new_cols = {nm: list(v[:100]) for nm, _, v in _spec(100, rng)}
    sj2, st2 = sj.append(new_vecs, new_cols), st.append(new_vecs, new_cols)
    np.testing.assert_array_equal(st2._dv.vectors.numpy(), np.asarray(sj2._dv.vectors))
    np.testing.assert_allclose(st2._dv.resid.numpy(), np.asarray(sj2._dv.resid), rtol=2e-5,
                               atol=0)
    keep = np.flatnonzero(np.arange(4000) % 9 != 0)
    np.testing.assert_array_equal(st2._dv.resid.numpy()[: len(keep)],
                                  st._dv.resid.numpy()[keep])


@pytest.mark.parametrize("chunk", [256, 100], ids=["aligned", "unaligned"])
def test_shard_of_a_single_device_store_matches_jax(chunk, monkeypatch):
    rng = np.random.default_rng(21)
    n, d = 3000, 32
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    spec = [("price", "Float64", list(rng.uniform(0, 100, n))),
            ("tag", "String", [f"t{i % 37}" for i in range(n)])]
    locals_ = (_builder(jx, vecs, spec, chunk=chunk).build(),
               _builder(tx, vecs, spec, chunk=chunk).with_device("cpu").build())
    jcls = __import__("otters_tpu.parallel", fromlist=["ShardedMetaStore"]).ShardedMetaStore
    stores = tuple(cls.shard(s, m) for cls, s, m in
                   zip((jcls, ShardedMetaStore), locals_, twin_meshes("4x2")))
    assert stores[1]._pallas_aligned == stores[0]._pallas_aligned == (chunk == 256)
    q = rng.normal(size=(3, d)).astype(np.float32)
    for flt in (None, FILTERS["bloom"], lambda p: p.col("price").lt(30.0)):
        _check(stores, q, "Cosine", flt, k=12, rerank_from=40)
        _check(stores, q, "Cosine", flt, k=12)
    # append and load(mesh=...) of an unaligned store fall back to shard()
    new = rng.normal(size=(3, d)).astype(np.float32)
    cols = {"price": [1.0, 2.0, 3.0], "tag": ["x", "y", "z"]}
    a = stores[1].append(new, cols)
    assert isinstance(a, ShardedMetaStore) and len(a) == n + 3
    r = a.query(new[0], tx.Metric.Cosine).take(1).collect()
    assert r.indices == [n] and abs(r.scores[0] - 1.0) < 1e-5


def test_int8_slab_ingest_matches_jax():
    """materialize_int8_slabs_sharded writes JAX's codes and norms bit for
    bit (residuals within the few ulps of their cancellation), and a store
    built from it answers as JAX's."""
    from otters_tpu.parallel import materialize_int8_slabs_sharded as jmat
    from otters_tpu_torch.parallel import materialize_int8_slabs_sharded as tmat

    rng = np.random.default_rng(6)
    n, d, chunk = 40_000, 16, 1024
    full = rng.normal(size=(n + 8192, d)).astype(np.float32)
    jm, tm = twin_meshes("4x2")
    dvj = jmat(lambda s, r: full[s : s + r], n, d, 8192, jm, chunk)
    dvt = tmat(lambda s, r: full[s : s + r], n, d, 8192, tm, chunk)
    np.testing.assert_array_equal(dvt.vectors.numpy(), np.asarray(dvj.vectors))
    np.testing.assert_array_equal(dvt.norms_sq.numpy(), np.asarray(dvj.norms_sq))
    np.testing.assert_array_equal(dvt.valid.numpy(), np.asarray(dvj.valid))
    np.testing.assert_allclose(dvt.resid.numpy(), np.asarray(dvj.resid), rtol=2e-5, atol=0)
    spec = [("price", "Float64", (np.arange(n) % 100).astype(np.float64))]
    stores = tuple(
        pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(dv, n_rows=n)
        .with_chunk_size(chunk).build_sharded(m)
        for pkg, dv, m in zip(PKGS, (dvj, dvt), (jm, tm))
    )
    assert stores[1]._storage_dtype == "int8"
    q = rng.normal(size=(2, d)).astype(np.float32)
    _check(stores, q, "Cosine", lambda p: p.col("price").lt(50.0), k=10)


def test_device_bloom_build_matches_jax_bit_for_bit(monkeypatch):
    monkeypatch.setenv("OTTERS_BLOOM_DEVICE", "1")
    rng = np.random.default_rng(11)
    n, d = 20_000, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    spec = [("tag", "String", [None if i % 29 == 0 else f"tag-{i % 137}" for i in range(n)])]
    dev_stores = tuple(
        pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs).with_chunk_size(1024)
        .build_sharded(m) for pkg, m in zip(PKGS, twin_meshes("8"))
    )
    monkeypatch.delenv("OTTERS_BLOOM_DEVICE")
    host_t = (tx.MetaStore.from_columns(columns(tx, spec)).with_vectors(vecs)
              .with_chunk_size(1024).build_sharded(twin_meshes("8")[1]))
    want = np.asarray(dev_stores[0]._device_cols["tag"]["bloom"]).view(np.int32)
    np.testing.assert_array_equal(dev_stores[1]._device_cols["tag"]["bloom"].numpy(), want)
    np.testing.assert_array_equal(host_t._device_cols["tag"]["bloom"].numpy(), want)
    q = rng.normal(size=(1, d)).astype(np.float32)
    for rhs in ["tag-5", "tag-136", "absent"]:
        _check(dev_stores, q, "Cosine", lambda p, _r=rhs: p.col("tag").eq(_r), k=7)


def test_precompile_count_matches_jax():
    sj, st = _twins()
    counts = [s.precompile(filters=[None, FILTERS["numeric"](pkg)], batch_sizes=(2,), k=4)
              for pkg, s in zip(PKGS, (sj, st))]
    assert counts[1] == counts[0] == 2
    counts = [s.precompile(batch_sizes=(1,), with_vec_filter=True, rerank_from=20)
              for s in (sj, st)]
    assert counts[1] == counts[0]


def test_error_paths_match_jax():
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(100, 8)).astype(np.float32)
    jm, tm = twin_meshes("4x2")

    def both(fn):
        with pytest.raises(JOttersError) as ej:
            fn(jx, jm)
        with pytest.raises(OttersError) as et:
            fn(tx, tm)
        assert str(et.value) == str(ej.value)

    both(lambda p, m: p.MetaStore.from_columns([]).with_vectors(vecs).with_chunk_size(3000)
         .build_sharded(m))
    from otters_tpu.ops import scoring as jsc
    from otters_tpu_torch.ops import scoring as tsc

    single = {jx: jsc.materialize(vecs), tx: tsc.materialize(vecs, device="cpu")}
    both(lambda p, m: p.MetaStore.from_columns([]).with_vectors(single[p], n_rows=100)
         .build_sharded(m))
    both(lambda p, m: p.MetaStore.from_columns([]).with_vectors(single[p]).build_sharded(m))
    both(lambda p, m: p.MetaStore.from_columns([]).build_sharded(m))
    both(lambda p, m: p.MetaStore.from_columns(
        [p.Column("a", p.DataType.Int32).from_values([1, 2])]).with_vectors(vecs)
        .build_sharded(m))
    slabs = {jx: __import__("otters_tpu.parallel", fromlist=["x"]),
             tx: __import__("otters_tpu_torch.parallel", fromlist=["x"])}

    def prebuilt(p, m, **kw):
        dv = slabs[p].materialize_int8_slabs_sharded(lambda s, r: np.zeros((r, 8), np.float32),
                                                     100, 8, 4096, m, 1024)
        b = p.MetaStore.from_columns([p.Column("a", p.DataType.Int32).from_values(
            list(range(100)))]).with_vectors(dv, n_rows=100)
        if kw.get("sort"):
            b = b.with_sort_by("a")
        else:
            b = b.with_rerank_source(keep_host_f32=True)
        return b.build_sharded(m)

    both(lambda p, m: prebuilt(p, m, sort=True))
    both(lambda p, m: prebuilt(p, m))
    sj, st = _twins()
    both(lambda p, m: (sj if p is jx else st).query(vecs[0].tolist() * 4, p.Metric.DotProduct)
         .take(3).collect())
    both(lambda p, m: (sj if p is jx else st).query(vecs[0], p.Metric.Cosine).take(3).collect())
    store = tx.MetaStore.from_columns([]).with_vectors(vecs).build_sharded(tm)
    assert isinstance(store, ShardedMetaStore) and store.device == torch.device("cpu")


def test_sharded_tensor_slices_and_replicas_keep_the_row_stride():
    """A ShardedTensor's row slice stays per shard, and a shard's copy for a
    batch column on another device keeps the depth-padded row stride the
    kernels read (the copy is made here between two CPU tensors)."""
    from otters_tpu_torch.parallel import make_mesh, shards
    from otters_tpu_torch.ops import scoring as tsc

    mesh = make_mesh(rows=2, batch=2, devices=["cpu"] * 4)
    rows = tsc._depth_padded(torch.arange(8 * 20, dtype=torch.float32).reshape(8, 20))
    st = ShardedTensor(mesh, [rows[:4], rows[4:]])
    assert st.shape == (8, 20) and st[:5].shape == (5, 20)
    assert [s.shape[0] for s in st[3:6].shards] == [1, 2]
    np.testing.assert_array_equal(st[2:7].numpy(), rows[2:7].numpy())
    copy = shards._copy_to(rows[4:], torch.device("cpu"))
    assert copy.stride(0) == rows.stride(0) == 32 and torch.equal(copy, rows[4:])
    assert st.local(1, 1) is st.shards[1]  # the same device: no copy


# ---------------------------------------------------------------------------
# The per-shard program against the single store's (the port alone)
# ---------------------------------------------------------------------------

# (storage, metric, the shard's tile, certified, fast-exact); the fused
# tiles run the plain kernels, "panel" is where the fused kernel refuses
PROGRAM_CASES = {
    "fused-int8-cosine-cert": ("int8", "Cosine", "fused", True, False),
    "fused-bf16-euclid-cert": ("bfloat16", "Euclidean", "fused", True, False),
    "fused-f32-fast": ("float32", "Cosine", "fused", False, True),
    "direct-int8-cosine-cert": ("int8", "Cosine", "direct", True, False),
    "panel-bf16-dot-cert": ("bfloat16", "DotProduct", "panel", True, False),
    "scan_pruned-manhattan": ("float32", "Manhattan", "scan_pruned", False, False),
}


def _program_stores(storage, metric, rows):
    """(single-device store, store on a ``rows`` x 1 mesh) of the same rows
    and columns: whole 1024-row chunks on whole 8192-row scan tiles, so both
    pad alike; a price column whose odd chunks (or, for the pruned scan,
    odd scan tiles) hold 50-59 and the others 0-9."""
    from otters_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(41)
    vpu = metric == "Manhattan"
    n, d, run = (65536, 8, 8192) if vpu else (32768, 16, 1024)
    vecs = (rng.integers(0, 4, size=(n, d)) if vpu else rng.normal(size=(n, d)))
    vecs = vecs.astype(np.float32)
    price = (np.arange(n) // run % 2 * 50 + np.arange(n) % 10).astype(np.float32)
    b = (tx.MetaStore.from_columns(columns(tx, [("price", "Float32", price)]))
         .with_vectors(vecs).with_chunk_size(1024).with_storage_dtype(storage)
         .with_rerank_source(keep_host_f32=True))
    mesh = make_mesh(rows=rows, batch=1, devices=["cpu"] * rows)
    q = (rng.integers(0, 4, size=(3, d)) if vpu else rng.normal(size=(3, d)))
    return b.with_device("cpu").build(), b.build_sharded(mesh), q.astype(np.float32)


def _lowered(store, q, metric, flt):
    """A filtered query's device inputs -> (cols, plan_static, plan_params,
    queries)."""
    plan = _plan(store, tx, q, metric, flt)
    static, params, used = plan._lower_plan()
    return {nm: store._device_cols[nm] for nm in used}, static, params, plan._device_queries()


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("case", list(PROGRAM_CASES))
def test_shard_runs_the_single_stores_program(case, rows, monkeypatch):
    """Each shard runs the single store's program: on a one-shard mesh its
    outputs (rows, scores, ok, check, bound and the pruning counts) are the
    single store's bit for bit, with the mesh-wide slack in the direct /
    panel programs' place; on two shards the answers and statistics are
    the single store's."""
    from otters_tpu_torch import meta
    from otters_tpu_torch.parallel import meta_sharded

    storage, metric, tile, certify, fast = PROGRAM_CASES[case]
    if tile != "direct":
        use_fused_path(monkeypatch)
    if tile == "panel":
        monkeypatch.setenv("OTTERS_DISABLE_PALLAS", "1")
    single, sharded, q = _program_stores(storage, metric, rows)
    calls = []

    def spy(*a, **kw):
        out = meta._device_program(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(meta_sharded, "_device_program", spy)
    flt = lambda p: p.col("price").lt(10.0)  # noqa: E731
    take = dict(k=10, rerank_from=40) if certify else dict(k=10)
    for f in (flt, None) if tile != "scan_pruned" else (flt,):
        rs, rm = (_plan(s, tx, q, metric, f).take(**take).collect() for s in (single, sharded))
        assert_same_metric(rs, rm, single, sharded, metric)
        assert (sharded.last_query_stats().certified is True) == certify
    launch = calls[0][0][8]
    assert (launch.tile, launch.certify, launch.fast) == (tile, certify, fast)
    assert len(calls) % rows == 0 and all(c[0][8] == launch for c in calls)
    if rows > 1:
        return
    # one shard: its program's outputs are the single store's own
    take_min = metric == "Euclidean"
    thr, cmp = (0.5, tx.Cmp.Gt) if not take_min else (40.0, tx.Cmp.Lt)
    if metric == "Manhattan":
        thr, cmp = 30.0, tx.Cmp.Lt
        take_min = True
    cols_m, static_m, params_m, queries = _lowered(sharded, q, metric, flt)
    sharded._run_query_program(cols_m, queries, params_m, thr, static_m,
                               getattr(tx.Metric, metric), 10, take_min, cmp, certify=certify)
    a, kw, shard_out = calls[-1]
    # the direct / panel programs take the mesh-wide slack, the kernel its own
    # and hands out the certificate maxima it reduced for it
    assert a[8] == launch and (kw["mesh_cert"] is not None) == (certify and tile != "fused")
    assert kw["with_maxima"] == (certify and tile == "fused")
    cols_1, static_1, params_1, _ = _lowered(single, q, metric, flt)
    kw = {key: kw[key] for key in ("metric", "k", "take_min", "cmp", "prec", "with_maxima")}
    single_out = meta._device_program(single._dv, single._chunk_lens, single._chunk_size,
                                      cols_1, static_1, params_1, queries, a[7], launch, **kw)
    assert len(shard_out) == len(single_out) == 7 + kw["with_maxima"]
    for got, want in zip(shard_out[:7], single_out[:7]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for got, want in zip(shard_out[7:], single_out[7:]):
        assert len(got) == 6 and torch.equal(torch.stack(got), torch.stack(want))


@pytest.mark.parametrize("case", ["fused-bf16-euclid-cert", "fused-int8-cosine-cert"])
def test_fused_shards_hand_the_mesh_their_certificate_maxima(case, monkeypatch):
    """On the fused tile (K5 over bf16 rows, K1 over int8 rows) each of four
    shards computes its certificate terms once a request, in its own scan,
    and the mesh-wide slack is composed from the six maxima that scan
    reduced: the composed rows, scores, ok and bound are those an explicit
    pre-pass gives (``cert_slack`` of the amax of each shard's
    ``cert_maxima``), bit for bit."""
    from otters_tpu_torch import meta
    from otters_tpu_torch.ops import fused_topk as tft
    from otters_tpu_torch.ops import scoring as tsc
    from otters_tpu_torch.parallel import meta_sharded
    from otters_tpu_torch.parallel.dist_query import merge_partials

    storage, metric, tile, certify, _ = PROGRAM_CASES[case]
    assert (tile, certify) == ("fused", True)
    use_fused_path(monkeypatch)
    _, sharded, q = _program_stores(storage, metric, 4)
    take_min = metric == "Euclidean"
    thr, cmp = (40.0, tx.Cmp.Lt) if take_min else (0.5, tx.Cmp.Gt)
    m = getattr(tx.Metric, metric)
    flt = lambda p: p.col("price").lt(10.0)  # noqa: E731
    cols, static, params, queries = _lowered(sharded, q, metric, flt)
    cert_terms, terms_calls, programs = tsc.cert_terms, [], []

    def counted(*a, **kw):
        terms_calls.append(a[1].shape)
        return cert_terms(*a, **kw)

    def spy(*a, **kw):
        out = meta._device_program(*a, **kw)
        programs.append((a, kw, out))
        return out

    monkeypatch.setattr(tsc, "cert_terms", counted)
    monkeypatch.setattr(tft, "cert_terms", counted)
    monkeypatch.setattr(meta_sharded, "_device_program", spy)
    got = sharded._run_query_program(cols, queries, params, thr, static, m, 10, take_min,
                                     cmp, certify=True)
    assert len(programs) == 4 and len(terms_calls) == 4  # once a shard
    assert all(kw["with_maxima"] and kw["mesh_cert"] is None for _, kw, _ in programs)
    maxima = []
    for (a, kw, out) in programs:
        dv_l, q_l = a[0], a[6]
        t = cert_terms(m, q_l, dv_l.vectors.dtype, dv_l.resid, dv_l.inv_norms, dv_l.norms_sq,
                       dv_l.vectors.shape[1])
        maxima.append(torch.stack(tsc.cert_maxima(*t[1:], dv_l.norms_sq,
                                                  q_valid=kw["q_valid"])))
        assert torch.equal(torch.stack(out[7]), maxima[-1])
    slack = tsc.cert_slack(*torch.stack(maxima).amax(dim=0))
    n_local = sharded._dv.vectors.shape[0] // 4
    rows_g, scores_g, ok_g, sel = merge_partials(
        [(out[0] + r * n_local, out[1], out[2]) for r, (_, _, out) in enumerate(programs)],
        10, take_min, torch.device("cpu"))
    kth_key = -scores_g[sel][-1] if take_min else scores_g[sel][-1]
    bound = torch.maximum(torch.stack([out[4] for _, _, out in programs]).max(),
                          torch.where(ok_g[sel][-1], kth_key + slack, float("-inf")))
    rows, scores, ok, check, bound_got = got[:5]
    assert float(slack) > 0 and bool(ok.any()) and bool(check)
    for a, b in ((rows, rows_g[sel]), (scores, scores_g[sel]), (ok, ok_g[sel]),
                 (bound_got, bound)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("with_q_valid", [False, True], ids=["all", "q_valid"])
def test_global_slack_is_the_slack_of_the_six_maxima(with_q_valid):
    """``cert_global_slack`` (a single device's, the maxima as scalars) and
    the mesh's slack (each device's six maxima stacked, composed by amax)
    are one formula, bit for bit; the masked queries count for nothing."""
    from otters_tpu_torch.ops import scoring as tsc

    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(300, 24)).astype(np.float32) * 3
    dv = tsc.materialize(vecs, torch.bfloat16, device="cpu")
    q = torch.from_numpy(rng.normal(size=(6, dv.vectors.shape[1])).astype(np.float32))
    q_valid = torch.tensor([True, False, True, True, False, True]) if with_q_valid else None
    t = tsc.cert_terms(tx.Metric.Euclidean, q, dv.vectors.dtype, dv.resid, dv.inv_norms,
                       dv.norms_sq, dv.vectors.shape[1])
    assert all(float(x.max()) > 0 for x in t[1:])
    single = tsc.cert_global_slack(*t[1:], dv.norms_sq, q_valid=q_valid)
    maxima = torch.stack(tsc.cert_maxima(*t[1:], dv.norms_sq, q_valid=q_valid))
    mesh = tsc.cert_slack(*torch.stack([maxima, torch.zeros(6)]).amax(dim=0))
    assert torch.equal(single, mesh)
    keep = slice(None) if q_valid is None else q_valid
    c0, c1, c2 = (x[keep].max() for x in t[1:4])
    want = c0 + c1 * t[4].max() + c2 * torch.sqrt(dv.norms_sq.max()) + t[5].max()
    assert torch.equal(single, want)
