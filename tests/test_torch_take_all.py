"""Take-all windowing in the port against the JAX package.

Twins of ``tests/test_take_all.py``: the same numpy inputs go through
``otters_tpu`` (JAX on the CPU) and ``otters_tpu_torch`` (CPU device). A
take(k) that no device top-k fits streams [B, w] score windows to the host
and sorts there (``scoring.collect_all``); both packages route the same
shapes there, return the same rows in the same order, and break exact ties
lower flat index first. Thousands of results over f32 sums taken in other
orders can swap near-tied neighbours, so those comparisons hold the rows
as a multiset, the scores rank for rank within 2e-5 (the JAX tests' own
tolerance against their oracles) and sorted in the take direction: the
port's order is a sorted order of scores that agree with JAX's.
"""

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu.errors import OttersError as JOttersError
from otters_tpu.ops import scoring as js
from otters_tpu_torch.ops import scoring as ts
from otters_tpu_torch.state import vec_store_from_numpy
from torch_parity import stats_tuple, twin_stores


def _near_same(rows_t, sc_t, rows_j, sc_j, tol=2e-5, take_min=False):
    np.testing.assert_allclose(np.asarray(sc_t), np.asarray(sc_j), rtol=tol, atol=tol)
    assert sorted(rows_t) == sorted(rows_j)
    step = np.diff(np.asarray(sc_t))
    assert (step >= 0).all() if take_min else (step <= 0).all()


def test_needs_windowed_routing():
    D = ts.DIRECT_LIMIT
    assert not ts.needs_windowed(1 << 20, 1, 1 << 20)
    assert not ts.needs_windowed(1 << 23, 256, 10)
    assert not ts.needs_windowed(ts.SCAN_TILE * 1024, 8, 4096)
    assert ts.needs_windowed(ts.SCAN_TILE * 1024, 8, ts.SCAN_K_MAX + 1)
    assert ts.needs_windowed(300032, 16, 5000)
    assert D == js.DIRECT_LIMIT and ts.TAKE_ALL_LIMIT == js.TAKE_ALL_LIMIT
    # the same routing and windows as the JAX package over a grid of shapes
    for n_pad in (512, 4096, 300032, 2000896, ts.SCAN_TILE * 1024):
        for b in (1, 3, 16, 256):
            for k in (10, 1025, 5000, n_pad, b * n_pad):
                assert ts.needs_windowed(n_pad, b, k) == js.needs_windowed(n_pad, b, k)
            assert ts._window_size(n_pad, b) == js._window_size(n_pad, b)


def _price_twins(n, d, seed, chunk=4096, storage="float32"):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    price = (np.arange(n) % 100).astype(np.float64)
    sj, st = twin_stores(vecs, [("price", "Float64", price)], chunk=chunk, storage=storage,
                         rerank=False)
    return rng, vecs, price, sj, st


def test_windowed_take_all_matches_oracle():
    rng, vecs, price, sj, st = _price_twins(300_000, 8, 7)
    b, k = 16, 5_000
    qs = rng.normal(size=(b, 8)).astype(np.float32)
    assert ts.needs_windowed(st._dv.vectors.shape[0], b, k)

    def run(store, pkg):
        return (store.query_batch(qs, pkg.Metric.Cosine).meta_filter(pkg.col("price").lt(50.0))
                .take(k).collect())

    rj, rt = run(sj, jx), run(st, tx)
    assert len(rt) == k
    _near_same(rt.indices, rt.scores, rj.indices, rj.scores)
    assert stats_tuple(st) == stats_tuple(sj)
    # the JAX test's oracle: the global top-k over every filtered pair
    qi = 1.0 / np.linalg.norm(qs, axis=1)
    vi = 1.0 / np.linalg.norm(vecs, axis=1)
    s = (qs @ vecs.T) * qi[:, None] * vi[None, :]
    okm = np.broadcast_to((price < 50.0)[None, :], s.shape)
    np.testing.assert_allclose(rt.scores, np.sort(s[okm])[::-1][:k], rtol=2e-5, atol=2e-5)
    assert all(price[i] < 50.0 for i in rt.indices)
    assert (np.diff(rt.scores) <= 1e-12).all()


def test_take_all_rows_returns_everything():
    """No take(): every row, sorted, with every column materialized; at
    1.2M rows (the JAX test's 2M, cut to keep the twin quick), still past
    the 2^20-candidate line that makes the direct program hand over."""
    n, d = 1_200_000, 8
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(d,)).astype(np.float32)
    version = (np.arange(n) % 5).astype(np.int32)
    sj, st = twin_stores(vecs, [("version", "Int32", version)], chunk=8192, storage="float32",
                         rerank=False)
    assert ts.needs_windowed(st._dv.vectors.shape[0], 1, n)
    rj = sj.query(q, jx.Metric.DotProduct).collect()
    rt = st.query(q, tx.Metric.DotProduct).collect()
    assert len(rt) == n
    _near_same(rt.indices, rt.scores, rj.indices, rj.scores)
    s = vecs @ q
    assert rt.indices[0] == int(np.argmax(s))
    np.testing.assert_allclose([rt.scores[0], rt.scores[-1]], [s.max(), s.min()], rtol=1e-5)
    assert len(rt.column("version")) == n
    assert stats_tuple(st) == stats_tuple(sj)


def test_windowed_take_min_and_vec_filter():
    rng, vecs, _, sj, st = _price_twins(300_000, 8, 9)
    b, k = 16, 3_000
    qs = rng.normal(size=(b, 8)).astype(np.float32)

    def run(store, pkg):
        return (store.query_batch(qs, pkg.Metric.Euclidean)
                .vec_filter(float(8 * 1.5), pkg.Cmp.Lt).take(k).collect())

    rj, rt = run(sj, jx), run(st, tx)
    _near_same(rt.indices, rt.scores, rj.indices, rj.scores, tol=2e-4, take_min=True)
    s = (qs**2).sum(1)[:, None] + (vecs**2).sum(1)[None, :] - 2.0 * (qs @ vecs.T)
    vals = np.sort(s[s < 12.0])[:k]
    assert len(rt) == min(k, vals.size)
    np.testing.assert_allclose(rt.scores, vals[: len(rt)], rtol=2e-4, atol=2e-4)


class _FakeArr:
    def __init__(self, shape):
        self.shape = shape


def test_take_all_cap_raises_clear_error():
    """The same error, with the same text, in both packages."""
    args = (np.zeros((2, 4), np.float32), None, ts.TAKE_ALL_LIMIT)
    with pytest.raises(JOttersError, match="candidate scores") as ej:
        js.collect_all(js.DeviceVecs(_FakeArr((js.TAKE_ALL_LIMIT + 512, 4)), None, None, None),
                       args[0], jx.Metric.Cosine, args[2], take_min=False, cmp=None, thr=None)
    with pytest.raises(tx.OttersError, match="candidate scores") as et:
        ts.collect_all(ts.DeviceVecs(_FakeArr((ts.TAKE_ALL_LIMIT + 512, 4)), None, None, None),
                       args[0], tx.Metric.Cosine, args[2], take_min=False, cmp=None, thr=None)
    assert str(et.value) == str(ej.value)


def test_vecstore_take_all_windowed():
    rng = np.random.default_rng(10)
    n, d, b = 300_000, 8, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(b, d)).astype(np.float32)
    sj = jx.VecStore(d)
    sj.add_vectors(vecs)
    st = vec_store_from_numpy(sj._host_matrix(), d, device="cpu")
    rj = sj.query(qs, jx.Metric.DotProduct).take(2000).collect()
    rt = st.query(qs, tx.Metric.DotProduct).take(2000).collect()
    _near_same([r.index for r in rt], [r.score for r in rt], [r.index for r in rj],
               [r.score for r in rj])
    want = np.sort((qs @ vecs.T).reshape(-1))[::-1][:2000]
    np.testing.assert_allclose([r.score for r in rt], want, rtol=2e-5, atol=2e-5)


def test_take_all_exact_ties_lower_flat_index_first():
    """Integer rows and queries (every score exact in both packages) with
    many exact ties: the same rows in exactly the same order as JAX on both
    the argpartition (k < total / 4) and the full-sort routes. The full
    sort equals a stable sort of the flat [query, row] keys (ties lower flat
    index first); the argpartition route equals it above the k-th score,
    and both packages keep argpartition's pick of the rows tied at the
    k-th score, sorted by flat index."""
    rng = np.random.default_rng(12)
    n, d, b = 300_000, 8, 16
    vecs = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    qs = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    sj, st = twin_stores(vecs, [("id", "Int64", np.arange(n))], chunk=4096,
                         storage="float32", rerank=False)
    n_pad = st._dv.vectors.shape[0]
    key = np.full((b, n_pad), -np.inf)
    key[:, :n] = qs.astype(np.float64) @ vecs.T.astype(np.float64)
    order = np.argsort(-key.reshape(-1), kind="stable")
    for k in (5_000, 4 * n_pad):
        assert ts.needs_windowed(n_pad, b, k)
        rj = sj.query_batch(qs, jx.Metric.DotProduct).take(k).collect()
        rt = st.query_batch(qs, tx.Metric.DotProduct).take(k).collect()
        assert rt.indices == rj.indices and rt.scores == rj.scores
        want = (order[:k] % n_pad).tolist()
        above = int(np.sum(np.asarray(rt.scores) > rt.scores[-1]))
        assert rt.indices[:above] == want[:above]
        if 4 * k >= b * n_pad:  # the full stable sort
            assert rt.indices == want
        assert len(set(rt.scores[:1000])) < 50  # ties did occur


def test_take_all_at_precision_default_matches_jax():
    """The windowed path scores its windows at the store precision: on
    bf16-representable inputs (where JAX's CPU DEFAULT equals the one
    pass) the two packages agree at "default", and on a store where bf16
    rounding reorders rows the port's "default" differs from "highest"."""
    rng = np.random.default_rng(14)
    n, d, b = 300_000, 8, 16
    vecs = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).bfloat16().float().numpy()
    qs = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).bfloat16().float().numpy()
    sj, st = twin_stores(vecs, [("id", "Int64", np.arange(n))], chunk=4096,
                         storage="float32", rerank=False)
    sj.precision = st.precision = "default"
    rj = sj.query_batch(qs, jx.Metric.Cosine).take(4000).collect()
    rt = st.query_batch(qs, tx.Metric.Cosine).take(4000).collect()
    _near_same(rt.indices, rt.scores, rj.indices, rj.scores)
    raw = rng.normal(size=(b, d)).astype(np.float32)
    st.precision = "highest"
    hi = st.query_batch(raw, tx.Metric.Cosine).take(4000).collect()
    st.precision = "default"
    lo = st.query_batch(raw, tx.Metric.Cosine).take(4000).collect()
    assert hi.scores != lo.scores
