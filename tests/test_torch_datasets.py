"""``datasets.synthetic_catalog`` and ``evaluate.recall_at_k`` in the port
against the JAX package.

The port's generator is numpy alone: for the same arguments it returns the
JAX package's vectors bit for bit and the same columns (dtypes, values,
null masks). The catalog's filtered query mix (the one of
``tests/test_realistic_dataset.py``) over a Z-ordered store answers as the
JAX package's, with the same pruned chunks; recall@k is JAX's function.
"""

import inspect

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu.datasets as jds
import otters_tpu.evaluate as jev
import otters_tpu_torch as tx
import otters_tpu_torch.datasets as tds
import otters_tpu_torch.evaluate as tev
from torch_parity import assert_same_results, stats_tuple

N, DIM, CHUNK = 6000, 64, 256


def _same_columns(cj, ct):
    assert list(ct) == list(cj)
    for name in cj:
        assert ct[name].dtype.value == cj[name].dtype.value
        assert list(ct[name].null_mask()) == list(cj[name].null_mask())
        vj, vt = cj[name].values(), ct[name].values()
        if isinstance(vj, np.ndarray):
            assert np.asarray(vt).dtype == vj.dtype
            np.testing.assert_array_equal(np.asarray(vt), vj)
        else:
            assert list(vt) == list(vj)


@pytest.mark.parametrize("args", [(500, 32, 7, 64, 0.03), (2000, 48, 0, 16, 0.1),
                                  (64, 8, 3, 4, 0.0)])
def test_synthetic_catalog_equals_jax(args):
    n, dim, seed, clusters, nulls = args
    vj, cj = jds.synthetic_catalog(n, dim, seed=seed, n_clusters=clusters, null_rate=nulls)
    vt, ct = tds.synthetic_catalog(n, dim, seed=seed, n_clusters=clusters, null_rate=nulls)
    assert vt.dtype == vj.dtype == np.float32
    np.testing.assert_array_equal(vt, vj)
    _same_columns(cj, ct)
    assert tds.CATEGORIES == jds.CATEGORIES and tds.BRANDS == jds.BRANDS
    assert (inspect.signature(tds.synthetic_catalog).parameters.keys()
            == inspect.signature(jds.synthetic_catalog).parameters.keys())


@pytest.fixture(scope="module")
def catalogs():
    out = []
    for pkg, mod in ((jx, jds), (tx, tds)):
        vecs, cols = mod.synthetic_catalog(N, DIM, seed=42)
        b = (pkg.MetaStore.from_columns(list(cols.values())).with_vectors(vecs)
             .with_chunk_size(CHUNK).with_z_order(["category", "price"]))
        out.append(b.with_device("cpu").build() if pkg is tx else b.build())
    return vecs, out


WORKLOAD = [
    lambda p: p.col("category").eq("electronics") & p.col("price").lt(40.0),
    lambda p: p.col("in_stock").eq(True) & p.col("rating").gte(4.5),
    lambda p: p.col("brand").isin(["brand_00", "brand_01", "brand_02"]),
    lambda p: p.col("listed").gte("2024-07-01") & p.col("reviews").gt(100),
    lambda p: p.col("price").is_null() | p.col("brand").is_null(),
    lambda p: ~p.col("category").eq("grocery") & p.col("price").between(10.0, 20.0),
    lambda p: p.col("category").eq("electronics") & p.col("price").lt(30.0),
]


def test_catalog_query_mix_matches_jax(catalogs):
    vecs, (sj, st) = catalogs
    rng = np.random.default_rng(1)
    for flt in WORKLOAD:
        q = vecs[rng.integers(0, N)]
        rj = sj.query(q, jx.Metric.Cosine).meta_filter(flt(jx)).take(20).collect()
        rt = st.query(q, tx.Metric.Cosine).meta_filter(flt(tx)).take(20).collect()
        assert_same_results(rj, rt, sj, st)
    # Z-order pays: the category + price filter prunes most chunks
    assert st.last_query_stats().pruned_chunks > st.last_query_stats().total_chunks // 2
    qs = vecs[rng.integers(0, N, size=4)]
    rj = sj.query_batch(qs, jx.Metric.Cosine).vec_filter(0.9, jx.Cmp.Gt).take(25).collect()
    rt = st.query_batch(qs, tx.Metric.Cosine).vec_filter(0.9, tx.Cmp.Gt).take(25).collect()
    # each query is a stored row: its self-match scores 1 within a few ulps,
    # summed in another order by each package, so two self-matches may swap
    assert sorted(rt.indices) == sorted(rj.indices)
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=1e-6)
    assert stats_tuple(st) == stats_tuple(sj)


def test_recall_at_k_matches_jax(catalogs):
    vecs, (_, st) = catalogs
    assert tev.recall_at_k([1, 2, 3, 4], [4, 2, 9, 1]) == jev.recall_at_k([1, 2, 3, 4],
                                                                           [4, 2, 9, 1]) == 0.75
    assert tev.recall_at_k([], []) == 1.0 and tev.mean_recall_at_k([], []) == 1.0
    with pytest.raises(ValueError):
        tev.mean_recall_at_k([[1]], [])
    # recall of a take(10) against an exact numpy truth, per query
    qs = vecs[:5]
    unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    exact = [np.argsort(-(unit @ (q / np.linalg.norm(q))), kind="stable")[:10].tolist()
             for q in qs]
    got = [st.query(q, tx.Metric.Cosine).take(10).collect().indices for q in qs]
    assert tev.mean_recall_at_k(exact, got) == jev.mean_recall_at_k(exact, got) == 1.0
    half = [g[:5] + [-1] * 5 for g in got]
    assert tev.mean_recall_at_k(exact, half) == jev.mean_recall_at_k(exact, half) == 0.5


def test_evaluate_doctests_pass():
    import doctest

    results = doctest.testmod(tev, verbose=False)
    assert results.failed == 0 and results.attempted >= 5
