"""Sorted and Z-ordered stores in the port against the JAX package.

``with_sort_by`` / ``with_z_order`` permute the rows before chunking, so
zonemaps prune the clustered columns; results still name original
ingestion-order row ids. The same seeded inputs go through ``otters_tpu``
(JAX on the CPU, Pallas in interpret mode) and ``otters_tpu_torch`` (CPU
device):

- ``_sort_permutation`` (stable, nulls last, either direction) and
  ``_zorder_permutation`` (1-8 columns of dense-rank codes, nulls on the top
  code) equal JAX's over every dtype, with nulls and ties;
- the builders' checks raise JAX's messages (column counts, duplicates,
  both layouts, unknown columns, pre-built ``DeviceVecs``);
- queries over sorted and Z-ordered stores on the direct, scan, fused and
  take-all paths, with the certificate on and off, give the same original
  row ids in order, the same ``certified`` flags and the same pruned /
  evaluated counts, and the rerank source is called with original ids;
- a store built from a device tensor (the rows gathered by the permutation
  and its padding rows, slab by slab for int8 / bf16) equals one built from
  host rows.
"""

import inspect

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu.meta as jmeta
import otters_tpu_torch as tx
import otters_tpu_torch.meta as tmeta
from otters_tpu.errors import OttersError as JOttersError
from otters_tpu_torch.errors import OttersError
from torch_parity import PATHS, assert_same_on_path, columns, query_on_path, route

N, D, CHUNK = 3000, 32, 128


def _values(dt, n, rng):
    """Few distinct values (ties) of each dtype, a tenth of them null."""
    ints = rng.integers(-5, 6, n)
    vals = {
        "Int32": ints.astype(np.int32).tolist(),
        "Int64": (ints.astype(np.int64) * (1 << 40)).tolist(),
        "Float32": (ints * 0.5).astype(np.float32).tolist(),
        "Float64": (ints * 0.25).tolist(),
        "Bool": (ints > 0).tolist(),
        "DateTime": [f"2024-0{abs(int(i)) % 9 + 1}-1{abs(int(i)) % 9}" for i in ints],
        "String": [f"s{int(i) % 4}é" for i in ints],
    }[dt]
    return [None if m else v for v, m in zip(vals, rng.random(n) < 0.1)]


DTYPES = ["Int32", "Int64", "Float32", "Float64", "Bool", "DateTime", "String"]


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("dt", DTYPES)
def test_sort_permutation_matches_jax(dt, descending):
    rng = np.random.default_rng(DTYPES.index(dt))
    vals = _values(dt, 500, rng)
    (cj,) = columns(jx, [("c", dt, vals)])
    (ct,) = columns(tx, [("c", dt, vals)])
    pj = jmeta._sort_permutation(cj, 500, descending)
    pt = tmeta._sort_permutation(ct, 500, descending)
    assert pt.dtype == np.int64 and np.array_equal(pt, pj)
    assert sorted(pt.tolist()) == list(range(500))
    nulls = [v is None for v in vals]
    assert all(nulls[i] for i in pt[len(pt) - sum(nulls):])  # nulls last


@pytest.mark.parametrize("k", range(1, 9))
def test_zorder_permutation_matches_jax(k):
    rng = np.random.default_rng(100 + k)
    spec = [(f"c{i}", DTYPES[(i + k) % len(DTYPES)], _values(DTYPES[(i + k) % len(DTYPES)],
                                                             700, rng)) for i in range(k)]
    if k == 8:
        spec[0] = ("c0", "Int32", [None] * 700)  # an all-null column
    cj = {c.name: c for c in columns(jx, spec)}
    ct = {c.name: c for c in columns(tx, spec)}
    names = [s[0] for s in spec]
    pj = jmeta._zorder_permutation(cj, names, 700)
    pt = tmeta._zorder_permutation(ct, names, 700)
    assert pt.dtype == np.int64 and np.array_equal(pt, pj)
    assert sorted(pt.tolist()) == list(range(700))


def _cols(pkg, n=N):
    rng = np.random.default_rng(7)
    return columns(pkg, [
        ("price", "Float64", [None if i % 29 == 0 else float(x) for i, x in
                              enumerate(rng.integers(0, 100, n))]),
        ("version", "Int32", rng.integers(0, 8, n).astype(np.int32).tolist()),
        ("tag", "String", [f"t{x}" for x in rng.integers(0, 12, n)]),
    ])


def _builder(pkg, vecs, layout, storage="int8", fetch=None, n=None):
    n = len(vecs) if n is None else n
    b = (pkg.MetaStore.from_columns(_cols(pkg, n)).with_vectors(vecs, n_rows=n)
         .with_chunk_size(CHUNK).with_storage_dtype(storage))
    if fetch is not None:
        b = b.with_rerank_source(fetch_vectors=fetch)
    else:
        b = b.with_rerank_source(keep_host_f32=True)
    if layout == "sort":
        b = b.with_sort_by("price")
    elif layout == "sort_desc":
        b = b.with_sort_by("tag", descending=True)
    elif layout == "z":
        b = b.with_z_order(["price", "version", "tag"])
    return b.with_device("cpu") if pkg is tx else b


def _twins(layout, storage="int8", n=N, seed=11):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    return (_builder(jx, vecs, layout, storage).build(),
            _builder(tx, vecs, layout, storage).build(), vecs, q)


def _filter(pkg):
    return pkg.col("price").lt(30.0) & pkg.col("version").gte(2)


@pytest.mark.parametrize("certify", [True, False], ids=["cert", "uncert"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("layout", ["sort", "z"])
def test_sorted_store_queries_match_jax(layout, path, certify, monkeypatch):
    route(path, monkeypatch)
    sj, st, vecs, q = _twins(layout)
    assert np.array_equal(st._index_map, sj._index_map)
    for flt in (None, _filter):
        rj = query_on_path(sj, jx, q, path, certify, flt)
        rt = query_on_path(st, tx, q, path, certify, flt)
        assert_same_on_path(rj, rt, sj, st, path)
    # original ids: the filter holds on the original columns' values
    price = _cols(tx)[0]
    assert all(price.values()[i] < 30.0 and not price.null_mask()[i] for i in rt.indices)
    # the sorted layout prunes what the unsorted one cannot
    assert st.last_query_stats().pruned_chunks > 0


@pytest.mark.parametrize("layout", ["sort", "sort_desc", "z"])
def test_rerank_source_is_called_with_original_ids(layout):
    """A ``fetch_vectors`` rerank source sees original row ids (JAX's
    ``_exact_rerank`` and device-rerank contract), and the results equal
    JAX's, collected alone and pipelined through ``resolve``."""
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    seen = []

    def fetch(ids):
        seen.append(np.asarray(ids).copy())
        return vecs[np.asarray(ids)]

    sj = _builder(jx, vecs, layout, fetch=lambda i: vecs[np.asarray(i)]).build()
    st = _builder(tx, vecs, layout, fetch=fetch).build()
    rj = sj.query_batch(q, jx.Metric.Cosine).meta_filter(_filter(jx)).take(10, rerank_from=40)
    rt = st.query_batch(q, tx.Metric.Cosine).meta_filter(_filter(tx)).take(10, rerank_from=40)
    rj, rt = rj.collect(), rt.collect()
    assert rt.indices == rj.indices and st.last_query_stats().certified is True
    # every id fetched passes the filter on the original columns
    price = _cols(tx)[0]
    ids = np.concatenate(seen)
    assert all(price.values()[i] < 30.0 for i in ids)
    pj = [sj.query_batch(x[None], jx.Metric.Cosine).take(5, rerank_from=20).collect_async()
          for x in q]
    pt = [st.query_batch(x[None], tx.Metric.Cosine).take(5, rerank_from=20).collect_async()
          for x in q]
    for a, b in zip(jmeta.resolve(pj), tmeta.resolve(pt)):
        assert b.indices == a.indices
        np.testing.assert_allclose(b.scores, a.scores, rtol=0, atol=1e-6)


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
def test_sorted_build_from_a_tensor_equals_host_rows(storage):
    """A device tensor (here on the CPU device) is gathered by the
    permutation followed by its padding rows: the store equals one built
    from the same rows on the host."""
    from otters_tpu_torch.ops import scoring as ts

    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    n_pad = ts.pad_rows(N)
    padded = torch.zeros((n_pad, D))
    padded[:N] = torch.from_numpy(vecs)
    host = _builder(tx, vecs, "z", storage).build()
    dev = _builder(tx, padded, "z", storage, n=N).build()
    assert np.array_equal(dev._index_map, host._index_map)
    for name in ("vectors", "norms_sq", "inv_norms", "valid", "resid"):
        a, b = getattr(dev._dv, name), getattr(host._dv, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name


def _raises_both(fn_j, fn_t):
    with pytest.raises(JOttersError) as ej:
        fn_j()
    with pytest.raises(OttersError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


CHECKS = {
    "no_columns": lambda p, b: b.with_z_order([]),
    "nine_columns": lambda p, b: b.with_z_order([f"c{i}" for i in range(9)]),
    "duplicates": lambda p, b: b.with_z_order(["price", "price"]),
    "both_layouts": lambda p, b: b.with_sort_by("price").with_z_order("tag").build(),
    "unknown_sort": lambda p, b: b.with_sort_by("nope").build(),
    "unknown_z": lambda p, b: b.with_z_order(["price", "nope"]).build(),
}


@pytest.mark.parametrize("check", list(CHECKS))
def test_builder_checks_raise_jax_messages(check):
    vecs = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)

    def builder(pkg):
        b = pkg.MetaStore.from_columns(_cols(pkg, 300)).with_vectors(vecs)
        return b.with_device("cpu") if pkg is tx else b

    _raises_both(lambda: CHECKS[check](jx, builder(jx)), lambda: CHECKS[check](tx, builder(tx)))


def test_pre_built_device_vecs_refuse_a_layout():
    from otters_tpu.ops import scoring as js
    from otters_tpu_torch.ops import scoring as ts

    vecs = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    dj = js.materialize(vecs)
    dt = ts.materialize(vecs, device="cpu")
    _raises_both(
        lambda: jx.MetaStore.from_columns(_cols(jx, 300)).with_vectors(dj, n_rows=300)
        .with_sort_by("price").build(),
        lambda: tx.MetaStore.from_columns(_cols(tx, 300)).with_vectors(dt, n_rows=300)
        .with_z_order("tag").with_device("cpu").build(),
    )
    # a lone name is one column, not its characters
    b = tx.MetaStore.from_columns(_cols(tx, 300)).with_z_order("tag")
    assert b._z_order == ("tag",)


@pytest.mark.parametrize("method", ["with_sort_by", "with_z_order"])
def test_layout_methods_keep_jax_signatures(method):
    """Moved from the API-surface stubs: the ported methods keep JAX's
    parameters and return the builder."""
    jsig = inspect.signature(getattr(jmeta.MetaStoreBuilder, method))
    tsig = inspect.signature(getattr(tmeta.MetaStoreBuilder, method))
    assert list(tsig.parameters) == list(jsig.parameters)
    b = tx.MetaStore.from_columns(_cols(tx, 300))
    assert getattr(b, method)("price") is b
