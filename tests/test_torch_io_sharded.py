"""The per-shard directory format (``sharded-v1``) in the port against the
JAX package.

Mirrors ``tests/test_io_sharded.py``. ``ShardedMetaStore.save(path)``
writes one ``.npz`` per row shard, a manifest and the columns;
``MetaStore.load(path, mesh=...)`` streams each shard's file straight into
its shard. The same seeded stores are built sharded in both packages (JAX
on conftest's 8 virtual CPU devices, the port over the CPU listed 8 times):

- a directory written by either package loads in the other, with a mesh
  and without: the payload (int8 codes, bfloat16 codes, f32 rows) equal bit
  for bit, the manifests and column files byte for byte, and the loaded
  store answering with the reader's own store's indices, scores bit for
  bit, ``certified`` flags and chunk counts (int8, bfloat16 and f32; plain,
  and Z-ordered with ``keep_host_f32`` and tombstones);
- no file holds more than one shard's rows; a directory loads onto one
  device too; a missing shard file, a file where a directory should be and
  a single-device store raise JAX's messages.
"""

import glob
import json
import os

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu import io as jio
from otters_tpu.errors import OttersError as JOttersError
from otters_tpu_torch import io as tio
from otters_tpu_torch.errors import OttersError
from otters_tpu_torch.parallel import ShardedMetaStore
from torch_parity import assert_same_results, columns, twin_meshes

N, D, CHUNK = 12_288, 24, 1024


def _spec(n):
    return [("price", "Float64", [float(i % 97) for i in range(n)]),
            ("tag", "String", [f"t{i % 7}" for i in range(n)])]


def _build(pkg, mesh, vecs, storage="int8", layout=None):
    b = (pkg.MetaStore.from_columns(columns(pkg, _spec(len(vecs)))).with_vectors(vecs)
         .with_chunk_size(CHUNK).with_storage_dtype(storage))
    if layout == "z":
        b = b.with_rerank_source(keep_host_f32=True).with_z_order(["price", "tag"])
    store = b.build_sharded(mesh)
    if layout == "z":
        store.delete_rows([5, 77, 1023])
    return store


def _vecs(seed=0):
    return np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)


def _query(store, pkg, q, rerank):
    plan = store.query_batch(q, pkg.Metric.Cosine).meta_filter(
        pkg.col("price").lt(40.0) & pkg.col("tag").neq("t3"))
    return (plan.take(10, rerank_from=64) if rerank else plan.take(12)).collect()


def _payload(store):
    v = store._dv.vectors
    if hasattr(v, "numpy"):  # the port's ShardedTensor: bf16 codes as uint16
        import torch

        shards = [s.contiguous().view(torch.int16).numpy().view(np.uint16)
                  if s.dtype == torch.bfloat16 else s.contiguous().numpy() for s in v.shards]
        return np.concatenate(shards)
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("layout", ["plain", "z"])
@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
def test_directories_cross_between_the_packages(storage, layout, direction, tmp_path):
    vecs = _vecs()
    jm, tm = twin_meshes("8")
    sj = _build(jx, jm, vecs, storage, None if layout == "plain" else layout)
    st = _build(tx, tm, vecs, storage, None if layout == "plain" else layout)
    pj, pt = str(tmp_path / "jax_dir"), str(tmp_path / "port_dir")
    sj.save(pj)
    st.save(pt)
    # the same files: manifests and columns byte for byte, payload rows equal
    for name in ["manifest_00000.json", "meta.npz"]:
        with open(os.path.join(pj, name), "rb") as a, open(os.path.join(pt, name), "rb") as b:
            assert a.read() == b.read(), name
    files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(pj, "shard_*.npz")))
    assert files == sorted(os.path.basename(f) for f in glob.glob(os.path.join(pt, "shard_*.npz")))
    for f in files:
        with np.load(os.path.join(pj, f)) as a, np.load(os.path.join(pt, f)) as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(a["rows"], b["rows"])
            if "resid" in a.files:  # the residuals' cancellation: a few ulps
                np.testing.assert_allclose(a["resid"], b["resid"], rtol=2e-5, atol=0)
    src, (pkg, own, mesh) = (pj, (tx, st, tm)) if direction == "jax_to_port" else \
        (pt, (jx, sj, jm))
    q = np.random.default_rng(1).normal(size=(3, D)).astype(np.float32)
    loaded = [pkg.MetaStore.load(src, mesh=mesh)]
    loaded.append(pkg.MetaStore.load(src, device="cpu") if pkg is tx
                  else pkg.MetaStore.load(src))
    assert isinstance(loaded[0], ShardedMetaStore if pkg is tx else jx.parallel.ShardedMetaStore)
    np.testing.assert_array_equal(_payload(loaded[0]), _payload(own))
    for rerank in (True, False) if layout == "z" else (False,):
        want = _query(own, pkg, q, rerank)
        for store in loaded:
            got = _query(store, pkg, q, rerank)
            assert got.indices == want.indices
            assert got.scores == want.scores  # bit for bit
            s_got, s_want = store.last_query_stats(), own.last_query_stats()
            assert (s_got.certified, s_got.evaluated_chunks, s_got.pruned_chunks) == \
                (s_want.certified, s_want.evaluated_chunks, s_want.pruned_chunks)
            assert len(store) == len(own)


def test_shard_files_bounded_and_parity(tmp_path):
    vecs = _vecs(2)
    jm, tm = twin_meshes("8")
    st = _build(tx, tm, vecs, "int8")
    sj = _build(jx, jm, vecs, "int8")
    path = str(tmp_path / "store_dir")
    st.save(path)
    files = sorted(glob.glob(os.path.join(path, "shard_*.npz")))
    assert len(files) >= 2
    per_shard = st._dv.vectors.shape[0] // 8
    total = 0
    for f in files:
        with np.load(f) as z:
            assert z["rows"].dtype == np.int8  # codes saved as codes
            assert z["rows"].shape[0] <= per_shard
            total += z["rows"].shape[0]
    assert total == N
    re_sh = tx.MetaStore.load(path, mesh=tm)
    np.testing.assert_array_equal(re_sh._dv.vectors.numpy(), st._dv.vectors.numpy())
    # the original residual bounds restored, not recomputed from the codes
    np.testing.assert_array_equal(re_sh._dv.resid.numpy(), st._dv.resid.numpy())
    q = np.random.default_rng(3).normal(size=(3, D)).astype(np.float32)
    assert_same_results(_query(sj, jx, q, False), _query(re_sh, tx, q, False), sj, re_sh)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_payload_dtypes_roundtrip_exact(storage, tmp_path):
    _, tm = twin_meshes("4x2")
    st = _build(tx, tm, _vecs(4)[:8192], storage)
    path = str(tmp_path / "dtyped")
    st.save(path)
    re_sh = tx.MetaStore.load(path, mesh=tm)
    assert re_sh._storage_dtype == storage
    np.testing.assert_array_equal(_payload(re_sh), _payload(st))


def test_sorted_rerank_certified_roundtrip_and_single_file_resave(tmp_path):
    """Z-ordered + int8 + keep_host_f32 + tombstones: original ids, the
    rerank source and the certificate survive, and a single-file save of
    the loaded store (original-order columns rebuilt) round-trips too."""
    _, tm = twin_meshes("8")
    st = _build(tx, tm, _vecs(3), "int8", "z")
    path = str(tmp_path / "sorted_dir")
    st.save(path)
    re_sh = tx.MetaStore.load(path, mesh=tm)
    assert len(re_sh) == N - 3
    q = np.random.default_rng(3).normal(size=D).astype(np.float32)
    a = st.query(q, tx.Metric.Cosine).take(10, rerank_from=64).collect()
    b = re_sh.query(q, tx.Metric.Cosine).take(10, rerank_from=64).collect()
    assert a.indices == b.indices and a.scores == b.scores
    assert st.last_query_stats().certified is True and re_sh.last_query_stats().certified is True
    assert not {5, 77, 1023} & set(b.indices)
    single = str(tmp_path / "resaved.npz")
    tio.save_meta(re_sh, single)
    c = tx.MetaStore.load(single, device="cpu").query(q, tx.Metric.Cosine).take(
        10, rerank_from=64).collect()
    assert c.indices == a.indices
    np.testing.assert_allclose(c.scores, a.scores, rtol=0, atol=1e-6)


def test_dir_loads_single_device_too(tmp_path):
    _, tm = twin_meshes("8")
    st = _build(tx, tm, _vecs(4)[:8192], "int8")
    path = str(tmp_path / "dir_single")
    st.save(path)
    one = tx.MetaStore.load(path, device="cpu")
    assert not isinstance(one, ShardedMetaStore)
    q = np.random.default_rng(2).normal(size=(2, D)).astype(np.float32)
    a = st.query_batch(q, tx.Metric.Cosine).take(8).collect()
    b = one.query_batch(q, tx.Metric.Cosine).take(8).collect()
    assert a.indices == b.indices
    np.testing.assert_allclose(a.scores, b.scores, rtol=0, atol=1e-6)


def test_errors_match_jax(tmp_path):
    vecs = _vecs(5)[:8192]
    jm, tm = twin_meshes("8")
    dirs = {}
    for pkg, mesh in ((jx, jm), (tx, tm)):
        dirs[pkg] = str(tmp_path / pkg.__name__)
        _build(pkg, mesh, vecs, "float32").save(dirs[pkg])
        mf = glob.glob(os.path.join(dirs[pkg], "manifest_*.json"))[0]
        with open(mf) as f:
            m = json.load(f)
        m["row_ranges"], m["files"] = m["row_ranges"][1:], m["files"][1:]
        with open(mf, "w") as f:
            json.dump(m, f)

    def both(fn_j, fn_t):
        with pytest.raises(JOttersError) as ej:
            fn_j()
        with pytest.raises(OttersError) as et:
            fn_t()
        assert str(et.value).replace(dirs[tx], "D") == str(ej.value).replace(dirs[jx], "D")

    both(lambda: jx.MetaStore.load(dirs[jx], mesh=jm), lambda: tx.MetaStore.load(dirs[tx], mesh=tm))
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    both(lambda: jx.MetaStore.load(empty), lambda: tx.MetaStore.load(empty, device="cpu"))
    afile = str(tmp_path / "afile")
    open(afile, "w").close()
    sj, st = _build(jx, jm, vecs, "float32"), _build(tx, tm, vecs, "float32")
    both(lambda: jio.save_meta_sharded(sj, afile), lambda: tio.save_meta_sharded(st, afile))
    single = (tx.MetaStore.from_columns(columns(tx, _spec(100))).with_vectors(vecs[:100])
              .with_device("cpu").build())
    with pytest.raises(OttersError, match="requires a ShardedMetaStore"):
        tio.save_meta_sharded(single, str(tmp_path / "x"))
