"""The port's sharded exact top-k (``parallel.sharded_topk`` /
``ShardedVecStore``) against the JAX package's.

Mirrors ``tests/test_distributed.py``: the same seeded vectors and queries
go through the JAX package's ``ShardedVecStore`` on conftest's 8 virtual
CPU devices and the port's over the CPU listed 8 times, on ``rows=8`` and
``rows=4, batch=2`` meshes: the same rows in the same order, scores within
1e-6 (relative for Dot / Euclid), and each against a single-device VecStore
and numpy. Also the mesh's construction and its checks.
"""

import inspect

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu.parallel as jpar
import otters_tpu_torch as tx
import otters_tpu_torch.parallel as tpar
from torch_parity import MESHES, twin_meshes


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    vectors = rng.normal(size=(1000, 32)).astype(np.float32)
    queries = rng.normal(size=(4, 32)).astype(np.float32)
    return vectors, queries


def _twins(vectors, mesh):
    jm, tm = twin_meshes(mesh)
    return jpar.ShardedVecStore(jm, vectors), tpar.ShardedVecStore(tm, vectors)


def _pairs(results):
    return [r.index for r in results], [r.score for r in results]


def _same(got_t, got_j):
    it, st = _pairs(got_t)
    ij, sj = _pairs(got_j)
    assert it == ij
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-6)


def test_mesh_construction():
    mesh = tpar.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape["rows"] == 8 and mesh.shape["batch"] == 1
    mesh2 = tpar.make_mesh(rows=4, batch=2, devices=["cpu"] * 8)
    assert mesh2.shape["rows"] == 4 and mesh2.shape["batch"] == 2
    assert mesh2.devices.shape == (4, 2) and mesh2.lead == torch.device("cpu")
    with pytest.raises(ValueError) as et:
        tpar.make_mesh(rows=3, batch=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError) as ej:
        jpar.make_mesh(rows=3, batch=2)
    assert str(et.value) == str(ej.value)
    assert (inspect.signature(tpar.make_mesh).parameters.keys()
            == inspect.signature(jpar.make_mesh).parameters.keys())


def test_default_mesh_takes_the_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tpar.make_mesh()
    assert mesh.shape["rows"] == 2
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_matches_jax_and_single_device(data, mesh):
    vectors, queries = data
    sj, st = _twins(vectors, mesh)
    local = tx.VecStore(32, device="cpu")
    local.add_vectors(vectors)
    for metric, tt in [("DotProduct", None), ("Cosine", None), ("Euclidean", "Min")]:
        kw = {} if tt is None else {"take_type": getattr(tx.TakeType, tt)}
        got = st.search(queries, getattr(tx.Metric, metric), k=10, **kw)
        _same(got, sj.search(queries, getattr(jx.Metric, metric), k=10,
                             **({} if tt is None else {"take_type": jx.TakeType.Min})))
        plan = local.query(queries, getattr(tx.Metric, metric))
        want = (plan.take_min(10) if tt else plan.take(10)).collect()
        _same(got, want)


def test_sharded_batch_axis(data):
    vectors, queries = data
    sj, st = _twins(vectors, "4x2")
    got = st.search(queries, tx.Metric.DotProduct, k=10)
    _same(got, sj.search(queries, jx.Metric.DotProduct, k=10))
    best = np.sort((queries @ vectors.T).reshape(-1))[-10:][::-1]
    np.testing.assert_allclose(_pairs(got)[1], best, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_with_filter(data, mesh):
    vectors, queries = data
    sj, st = _twins(vectors, mesh)
    got = st.search(queries[:1], tx.Metric.DotProduct, k=1000, vec_filter=(5.0, tx.Cmp.Gt))
    _same(got, sj.search(queries[:1], jx.Metric.DotProduct, k=1000,
                         vec_filter=(5.0, jx.Cmp.Gt)))
    scores = (queries[:1] @ vectors.T).reshape(-1)
    want = np.sort(scores[scores > 5.0])[::-1]
    np.testing.assert_allclose(_pairs(got)[1], want, rtol=1e-6, atol=1e-5)


def test_sharded_odd_batch_padding(data):
    vectors, _ = data
    queries = np.random.default_rng(7).normal(size=(3, 32)).astype(np.float32)
    sj, st = _twins(vectors, "4x2")  # 3 queries, 2 batch shards
    got = st.search(queries, tx.Metric.DotProduct, k=5)
    _same(got, sj.search(queries, jx.Metric.DotProduct, k=5))
    best = np.sort((queries @ vectors.T).reshape(-1))[-5:][::-1]
    np.testing.assert_allclose(_pairs(got)[1], best, rtol=1e-6, atol=1e-5)


def test_global_indices_across_shards(data):
    vectors, _ = data
    _, st = _twins(vectors, "8")
    target = 987  # a row in the last shard's range
    got = st.search(vectors[target], tx.Metric.Cosine, k=1)
    assert got[0].index == target and abs(got[0].score - 1.0) < 1e-5
    # a tensor of rows is sliced shard by shard, the same store
    st2 = tpar.ShardedVecStore(tpar.make_mesh(devices=["cpu"] * 8), torch.from_numpy(vectors))
    _same(st2.search(vectors[:2], tx.Metric.Cosine, k=7), st.search(vectors[:2], tx.Metric.Cosine,
                                                                     k=7))
    assert len(st2) == len(vectors) == 1000


def test_sharded_topk_ties_follow_lax_top_k():
    """Tied scores across shards go to the earlier merge position (row
    shard, then batch column), as JAX's all_gather + lax.top_k."""
    vectors = np.tile(np.eye(4, 16, dtype=np.float32), (64, 1))  # many exact ties
    queries = np.eye(3, 16, dtype=np.float32)
    sj, st = _twins(vectors, "4x2")
    _same(st.search(queries, tx.Metric.DotProduct, k=40),
          sj.search(queries, jx.Metric.DotProduct, k=40))


def test_sharded_topk_checks_match_jax(data):
    vectors, queries = data
    sj, st = _twins(vectors, "8")
    with pytest.raises(jx.OttersError) as ej:
        sj.search(queries[:, :8], jx.Metric.Cosine, k=3)
    with pytest.raises(tx.OttersError) as et:
        st.search(queries[:, :8], tx.Metric.Cosine, k=3)
    assert str(et.value) == str(ej.value)
    assert st.search(queries, tx.Metric.Cosine, k=0) == []
