"""Single-file persistence in the port against the JAX package.

``MetaStore.save`` / ``load`` and ``VecStore.save`` / ``load`` write and read
the JAX package's format: one ``.npz`` written through a file object, a
JSON ``manifest``, the payload in original order (a sorted store's too), the
tombstones (``deleted``), a bfloat16 store as its exact f32 upcast, a
``keep_host_f32`` store's true f32 rows, and the certificate hints. The
same seeded stores are built in ``otters_tpu`` (JAX on the CPU) and
``otters_tpu_torch`` (CPU device):

- both packages write the same arrays and the same manifest;
- a file written by either loads in the other and answers identically:
  the same rows in order, scores within 1e-6, the same ``certified`` flags
  and pruned / evaluated counts, the hints restored (f32, int8, bfloat16;
  plain, sorted and Z-ordered; tombstoned; ``keep_host_f32``), and a
  ``VecStore`` likewise;
- a directory path is read as the per-shard format (a directory holding
  no sharded store raises JAX's message); ``load`` takes the device as a
  keyword and defaults to CUDA.
"""

import inspect
import json

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu.meta as jmeta
import otters_tpu_torch as tx
import otters_tpu_torch.meta as tmeta
from otters_tpu.errors import OttersError as JOttersError
from otters_tpu_torch.errors import OttersError
from torch_parity import columns, stats_tuple

N, D, CHUNK = 2000, 24, 128
HINTS = {"('shape', None, 10)": 400}


def _spec(n):
    rng = np.random.default_rng(9)
    return [
        ("name", "String", [None if i % 7 == 0 else f"item_{i % 23}_é" for i in range(n)]),
        ("price", "Float64", [None if i % 5 == 0 else float(x)
                              for i, x in enumerate(rng.integers(0, 90, n))]),
        ("ver", "Int64", [2**40 + i for i in range(n)]),
        ("when", "DateTime", [f"2024-0{(i % 9) + 1}-11" for i in range(n)]),
        ("w", "Float32", rng.uniform(0, 1, n).astype(np.float32).tolist()),
        ("c", "Int32", [i % 13 for i in range(n)]),
        ("flag", "Bool", [bool(i % 3) for i in range(n)]),
    ]


def _store(pkg, vecs, storage, layout):
    b = (pkg.MetaStore.from_columns(columns(pkg, _spec(len(vecs)))).with_vectors(vecs)
         .with_chunk_size(CHUNK).with_storage_dtype(storage).with_bloom_bits(512))
    if storage != "float32":
        b = b.with_rerank_source(keep_host_f32=True)
    if layout == "sort":
        b = b.with_sort_by("price", descending=True)
    elif layout == "z":
        b = b.with_z_order(["c", "name"])
    store = b.with_device("cpu").build() if pkg is tx else b.build()
    store.delete_rows(list(range(0, N, 31)))
    store._restore_cert_hints(HINTS)
    return store


def _filter(pkg):
    return (pkg.col("price").lt(40.0) & pkg.col("name").neq("item_3_é")
            & pkg.col("when").gte("2024-02-01"))


def _query(store, pkg, q, storage):
    plan = store.query_batch(q, pkg.Metric.Cosine).meta_filter(_filter(pkg))
    if storage == "float32":
        return plan.take(12).collect()
    return plan.take(12, rerank_from=60).collect()


def _codes(store):
    v = store._dv.vectors[:N]
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _npz(path):
    with np.load(path) as z:
        arrays = {k: np.asarray(z[k]) for k in z.files}
    return arrays, json.loads(bytes(arrays.pop("manifest")).decode("utf-8"))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("layout", ["plain", "sort", "z"])
@pytest.mark.parametrize("storage", ["float32", "int8", "bfloat16"])
def test_meta_files_cross_between_the_packages(storage, layout, direction, tmp_path):
    rng = np.random.default_rng(31)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    sj, st = _store(jx, vecs, storage, layout), _store(tx, vecs, storage, layout)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    sj.save(pj)
    st.save(pt)
    # the same file contents: every array and the manifest
    (aj, mj), (at, mt) = _npz(pj), _npz(pt)
    assert mt == mj
    assert mt["cert_hints"] == HINTS and mt["rerank"] == (
        None if storage == "float32" else "keep_host_f32")
    assert sorted(at) == sorted(aj)
    for k in aj:
        assert at[k].dtype == aj[k].dtype and at[k].shape == aj[k].shape, k
        assert at[k].tobytes() == aj[k].tobytes(), k  # null sentinels (NaN) too
    assert at["vectors"].dtype == np.float32 and at["deleted"].sum() == len(range(0, N, 31))
    if direction == "jax_to_port":
        src, src_pkg = sj, jx
        loaded, dst_pkg = tx.MetaStore.load(pj, device="cpu"), tx
    else:
        src, src_pkg = st, tx
        loaded, dst_pkg = jx.MetaStore.load(pt), jx
    assert len(loaded) == len(src) and loaded.cert_hints() == HINTS
    assert loaded._sort_by == src._sort_by and loaded._z_order == src._z_order
    r_src = _query(src, src_pkg, q, storage)
    r_dst = _query(loaded, dst_pkg, q, storage)
    assert r_dst.indices == r_src.indices
    np.testing.assert_allclose(r_dst.scores, r_src.scores, rtol=0, atol=1e-6)
    assert stats_tuple(loaded) == stats_tuple(src)
    assert not set(r_dst.indices) & set(range(0, N, 31))
    if storage == "int8":
        # the rebuilt codes equal the saved store's (same true f32 rows)
        assert np.array_equal(_codes(src), _codes(loaded))
    # the materialized nulls survive
    assert (r_dst.column("price").null_mask().tolist()
            == r_src.column("price").null_mask().tolist())


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
def test_quantized_store_without_rerank_round_trips(storage, tmp_path):
    """A quantized store with no rerank source saves its codes (int8 as f32
    values; re-quantizing them is idempotent, bf16 exactly): the reload has
    the same codes and answers as JAX's reload of the same file."""
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    st = (tx.MetaStore.from_columns(columns(tx, _spec(N))).with_vectors(vecs)
          .with_chunk_size(CHUNK).with_storage_dtype(storage).with_device("cpu").build())
    path = str(tmp_path / "q.npz")
    st.save(path)
    lt, lj = tx.MetaStore.load(path, device="cpu"), jx.MetaStore.load(path)
    assert torch.equal(lt._dv.vectors, st._dv.vectors)
    q = rng.normal(size=(2, D)).astype(np.float32)
    rt = lt.query_batch(q, tx.Metric.Cosine).take(10).collect()
    rj = lj.query_batch(q, jx.Metric.Cosine).take(10).collect()
    assert rt.indices == rj.indices


def test_fetch_rerank_source_is_recorded_not_saved(tmp_path):
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    st = (tx.MetaStore.from_columns([tx.Column("p", tx.DataType.Float64).from_values([1.0] * 300)])
          .with_vectors(vecs).with_storage_dtype("int8")
          .with_rerank_source(fetch_vectors=lambda i: vecs[np.asarray(i)])
          .with_device("cpu").build())
    path = str(tmp_path / "f.npz")
    st.save(path)
    assert _npz(path)[1]["rerank"] == "fetch"
    for loaded, pkg in ((tx.MetaStore.load(path, device="cpu"), tx), (jx.MetaStore.load(path), jx)):
        with pytest.raises(Exception, match="with_rerank_source"):
            loaded.query(vecs[0], pkg.Metric.Cosine).take(5, rerank_from=50).collect()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_vec_files_cross_between_the_packages(dtype, direction, tmp_path):
    rng = np.random.default_rng(32)
    rows = rng.normal(size=(700, 16)).astype(np.float32)
    path = str(tmp_path / "vec.npz")
    src = jx.VecStore(16, dtype=dtype) if direction == "jax_to_port" else tx.VecStore(
        16, dtype=dtype, device="cpu")
    src.add_vectors(rows)
    src.save(path)
    if direction == "jax_to_port":
        loaded, twin = tx.VecStore.load(path, device="cpu"), jx.VecStore.load(path)
    else:
        loaded, twin = jx.VecStore.load(path), tx.VecStore.load(path, device="cpu")
    assert len(loaded) == 700 and loaded.dim == 16 and loaded._dtype == dtype
    assert np.array_equal(loaded._host_matrix(), rows)
    q = rng.normal(size=16).astype(np.float32)
    a = [(r.index, r.score) for r in loaded.query(q, jx.Metric.Cosine if isinstance(
        loaded, jx.VecStore) else tx.Metric.Cosine).take(7).collect()]
    b = [(r.index, r.score) for r in twin.query(q, jx.Metric.Cosine if isinstance(
        twin, jx.VecStore) else tx.Metric.Cosine).take(7).collect()]
    assert [i for i, _ in a] == [i for i, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=1e-6)


def test_sharded_format_and_mesh_raise(tmp_path):
    """A directory is read as the per-shard format (tests of the format in
    test_torch_io_sharded.py): one that holds no sharded store raises JAX's
    message, and so does a VecStore load of a MetaStore file."""
    st = _store(tx, np.random.default_rng(1).normal(size=(N, D)).astype(np.float32),
                "float32", "plain")
    path = str(tmp_path / "m.npz")
    st.save(path)
    with pytest.raises(JOttersError) as ej:
        jx.MetaStore.load(str(tmp_path))
    with pytest.raises(OttersError) as et:
        tx.MetaStore.load(str(tmp_path), device="cpu")
    assert str(et.value) == str(ej.value) == f"{tmp_path} does not contain a sharded MetaStore"
    with pytest.raises(OttersError, match="does not contain a VecStore"):
        tx.VecStore.load(path, device="cpu")


def test_load_defaults_to_cuda(tmp_path, monkeypatch):
    store = tx.VecStore(4, device="cpu")
    store.add_vectors(np.eye(4, dtype=np.float32))
    path = str(tmp_path / "v.npz")
    store.save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(OttersError, match="device"):
        tx.VecStore.load(path).query([1.0, 0, 0, 0], tx.Metric.Cosine).take(1).collect()
    st = _store(tx, np.random.default_rng(1).normal(size=(N, D)).astype(np.float32),
                "float32", "plain")
    st.save(path)
    with pytest.raises(OttersError, match="with_device"):
        tx.MetaStore.load(path)


@pytest.mark.parametrize("method", ["save", "load"])
def test_persistence_methods_keep_jax_signatures(method):
    """Moved from the API-surface stubs: ``save`` keeps JAX's parameters;
    ``load`` keeps JAX's leading ones and adds the device as a keyword."""
    jsig = inspect.signature(getattr(jmeta.MetaStore, method))
    tsig = inspect.signature(getattr(tmeta.MetaStore, method))
    jp, tp = list(jsig.parameters), list(tsig.parameters)
    assert tp[: len(jp)] == jp
    extra = [tsig.parameters[p] for p in tp[len(jp):]]
    assert [(p.name, p.kind, p.default) for p in extra] == (
        [("device", inspect.Parameter.KEYWORD_ONLY, None)] if method == "load" else [])
