"""The VPU metrics (Manhattan, Hamming, Jaccard) of the port against the JAX
package, mirroring tests/test_manhattan.py, tests/test_hamming_jaccard.py
and tests/test_vpu_pruning.py.

The same seeded numpy inputs go through both packages (JAX on the CPU, the
port on CPU tensors) over f32 and bf16 rows, in each scoring mode the query
paths take for these metrics: ``direct`` (small stores), ``panel`` and
``scan`` (``DIRECT_LIMIT`` lowered alike in both packages), and
``scan_pruned`` (a filtered query at scale, which skips dead tiles). Each
case must return the same indices in the same order (the integer-valued rows
make many ties, so the tie order is held too), the same pruned and
evaluated counts, and scores within rtol 1e-6 (Hamming exactly).
"""

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu.ops.scoring as jscoring
import otters_tpu_torch as tx
import otters_tpu_torch.ops.scoring as tscoring
from torch_parity import columns, stats_tuple

METRICS = ["Manhattan", "Hamming", "Jaccard"]
STORAGES = ["float32", "bfloat16"]
BIG, SMALL, SCAN_N, D, CHUNK = 32_768, 2_000, 8_192, 8, 1024


def _rows(n, d, seed, ints=True):
    rng = np.random.default_rng(seed)
    if ints:  # small non-negative integers: exact in bf16, many ties
        return rng.integers(0, 4, size=(n, d)).astype(np.float32)
    return np.abs(rng.normal(size=(n, d))).astype(np.float32)


def _price(n):
    # even chunks 0-9, odd chunks 50-59: price < 10 prunes half the chunks
    return (np.arange(n) // CHUNK % 2 * 50 + np.arange(n) % 10).astype(np.float64)


def _category(n):
    # bench.py's category column: 16 values clustered per chunk; "cat_03"
    # keeps chunks 3, 19, ..., so every other 8192-row scan tile is dead
    return [f"cat_{c % 16:02d}" for c in np.arange(n) // CHUNK]


FILTERS = {
    "price": lambda pkg: pkg.col("price").lt(10.0),
    "cat": lambda pkg: pkg.col("category").eq("cat_03"),
}


def _twins(vecs, storage, rerank=False):
    spec = [("price", "Float64", _price(len(vecs))),
            ("category", "String", _category(len(vecs)))]
    out = []
    for pkg in (jx, tx):
        b = (pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs)
             .with_chunk_size(CHUNK).with_storage_dtype(storage))
        if rerank:
            b = b.with_rerank_source(keep_host_f32=True)
        if pkg is tx:
            b = b.with_device("cpu")
        out.append(b.build())
    return out


_STORES = {}


def _stores(kind, storage, rerank=False):
    """Module-cached twin stores: 'big' (scan_pruned geometry: 4 scan
    tiles), 'small' (direct / panel) and 'scan' (one scan tile)."""
    key = (kind, storage, rerank)
    if key not in _STORES:
        n, ints = {"big": (BIG, True), "small": (SMALL, False), "scan": (SCAN_N, True)}[kind]
        _STORES[key] = _twins(_rows(n, D, {"big": 41, "small": 42, "scan": 43}[kind], ints),
                              storage, rerank)
    return _STORES[key]


def _queries(b, seed, ints=True):
    return _rows(b, D, seed, ints)


def _run(stores, metric, q, k, *, filt=None, vec_filter=None, rerank_from=None):
    out = []
    for pkg, st in zip((jx, tx), stores):
        p = st.query_batch(q, getattr(pkg.Metric, metric))
        if filt is not None:
            p = p.meta_filter(FILTERS[filt](pkg))
        if vec_filter is not None:
            p = p.vec_filter(vec_filter[0], getattr(pkg.Cmp, vec_filter[1]))
        out.append((p.take(k, rerank_from=rerank_from).collect(), st))
    return out


def _assert_twins(out, metric):
    (rj, sj), (rt, st) = out
    assert rt.indices == rj.indices
    if metric == "Hamming":
        assert rt.scores == rj.scores
    else:
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-6, atol=0)
    assert stats_tuple(st) == stats_tuple(sj)


class _Spy:
    """Record which of the port's scoring programs ran."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("direct_topk_core", "panel_topk_core", "scan_topk_core",
                     "scan_pruned_topk_core"):
            orig = getattr(tscoring, name)

            def spy(*a, _orig=orig, _name=name, **kw):
                self.calls.append(_name)
                return _orig(*a, **kw)

            monkeypatch.setattr(tscoring, name, spy)


def _lower_direct_limit(monkeypatch, limit=1 << 10):
    """Send bigger batches to the panel / scan programs in both packages
    (the stores are built first: the padding reads the limit)."""
    monkeypatch.setattr(jscoring, "DIRECT_LIMIT", limit)
    monkeypatch.setattr(tscoring, "DIRECT_LIMIT", limit)


MODES = {
    # mode: (store, batch, k, filter, lower DIRECT_LIMIT)
    "direct": ("small", 2, 9, "price", False),
    "panel": ("small", 3, 9, None, True),
    "scan": ("scan", 2, 1100, None, True),
    "scan_pruned": ("big", 2, 9, "cat", False),
    "scan_pruned_price": ("big", 2, 9, "price", False),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_vpu_modes_match_jax(metric, storage, mode, monkeypatch):
    kind, b, k, filt, lower = MODES[mode]
    stores = _stores(kind, storage)
    if lower:
        _lower_direct_limit(monkeypatch)
    spy = _Spy(monkeypatch)
    out = _run(stores, metric, _queries(b, 7, ints=kind != "small"), k, filt=filt)
    assert spy.calls == [f"{mode.replace('_price', '')}_topk_core"]
    _assert_twins(out, metric)
    st = out[1][1].last_query_stats()
    if mode == "scan_pruned":
        assert st.evaluated_chunks == st.total_chunks // 16
    if mode == "scan_pruned_price":
        assert st.evaluated_chunks == st.total_chunks // 2
    if mode == "scan":
        assert len(out[1][0]) == k


VEC_FILTERS = {"Manhattan": (6.0, "Lt"), "Hamming": (5.0, "Lte"), "Jaccard": (0.3, "Gt")}


@pytest.mark.parametrize("mode", ["direct", "scan_pruned"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_vpu_score_filter_matches_jax(metric, storage, mode, monkeypatch):
    kind, b, k, filt, _ = MODES[mode]
    spy = _Spy(monkeypatch)
    out = _run(_stores(kind, storage), metric, _queries(b, 8, ints=kind != "small"), 12,
               filt=filt, vec_filter=VEC_FILTERS[metric])
    assert spy.calls == [f"{mode}_topk_core"]
    _assert_twins(out, metric)
    thr, cmp = VEC_FILTERS[metric]
    ok = {"Lt": lambda s: s < thr, "Lte": lambda s: s <= thr, "Gt": lambda s: s > thr}[cmp]
    assert all(ok(s) for s in out[1][0].scores)


@pytest.mark.parametrize("kind", ["small", "big"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_vpu_rerank_matches_jax(metric, storage, kind):
    """take(k, rerank_from=...) reranks on the host formulas in both
    packages (the device rerank is given up for these metrics)."""
    stores = _stores(kind, storage, rerank=True)
    out = _run(stores, metric, _queries(2, 9, ints=kind != "small"), 7,
               filt="price" if kind == "small" else "cat", rerank_from=40)
    _assert_twins(out, metric)
    assert out[1][1].last_query_stats().certified is None


def test_vpu_certify_true_raises_as_jax():
    stores = _stores("small", "bfloat16", rerank=True)
    q = _queries(2, 10, ints=False)
    for pkg, st in zip((jx, tx), stores):
        plan = st.query_batch(q, pkg.Metric.Manhattan).take(5, rerank_from=20, certify=True)
        with pytest.raises(pkg.OttersError, match="bfloat16: also DotProduct"):
            plan.collect()


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_vpu_scores_blocks_match_jax(metric, storage):
    """_vpu_scores over several blocks and a short last one (b * d large):
    the same score matrix as the JAX package's lax.scan over NaN-padded
    blocks."""
    rng = np.random.default_rng(11)
    n, d, b = 2500, 512, 128  # blk = 2^26 // (b d) = 1024: 3 blocks, the last short
    v = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    v[::3] = np.round(v[::3])
    q = np.round(np.abs(rng.normal(size=(b, d)))).astype(np.float32)
    jdt = getattr(jscoring.jnp, storage)
    want = np.asarray(jscoring._vpu_scores(jscoring.jnp.asarray(q),
                                           jscoring.jnp.asarray(v, jdt), getattr(jx.Metric, metric)))
    got = tscoring._vpu_scores(torch.from_numpy(q), torch.from_numpy(v).to(getattr(torch, storage)),
                               getattr(tx.Metric, metric)).numpy()
    assert (1 << 26) // (b * d) < n  # blocked
    if metric == "Hamming":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("metric", METRICS)
def test_vpu_exact_rerank_matches_jax(metric):
    from otters_tpu.evaluate import exact_rerank as jrerank
    from otters_tpu_torch.evaluate import exact_rerank as trerank

    vecs = _rows(50, 6, 12)
    vecs[3] = 0.0
    q = _rows(3, 6, 13)
    q[1] = 0.0  # Jaccard: 0 where both rows are all zero
    cand = [5, 3, 7, 3, 1, 20, 44, 9, 0]
    rj, sj = jrerank(q, cand, lambda i: vecs[np.asarray(i)], getattr(jx.Metric, metric), 6)
    rt, st = trerank(q, cand, lambda i: vecs[np.asarray(i)], getattr(tx.Metric, metric), 6)
    assert rt == rj
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=0)


@pytest.mark.parametrize("panel", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_vecstore_vpu_matches_jax(metric, panel, monkeypatch):
    rng = np.random.default_rng(14)
    n, d, b = 5000, 24, 4
    vecs = rng.integers(0, 3, size=(n, d)).astype(np.float32)
    q = rng.integers(0, 3, size=(b, d)).astype(np.float32)
    got = []
    for pkg in (jx, tx):
        store = pkg.VecStore(d) if pkg is jx else pkg.VecStore(d, device="cpu")
        store.add_vectors(vecs)
        got.append(store)
    if panel:
        _lower_direct_limit(monkeypatch)
    spy = _Spy(monkeypatch)
    res = [s.query(q, getattr(pkg.Metric, metric)).take(11).collect()
           for pkg, s in zip((jx, tx), got)]
    assert spy.calls == ["panel_topk_core" if panel else "direct_topk_core"]
    assert [r.index for r in res[1]] == [r.index for r in res[0]]
    np.testing.assert_allclose([r.score for r in res[1]], [r.score for r in res[0]],
                               rtol=1e-6, atol=0)


def test_pruned_scan_reads_no_dead_tile(monkeypatch):
    """The port's pruned scan scores only the live tiles' rows: under the
    category filter half the scan tiles are dead, and the score blocks it
    computes cover exactly the other half of the store."""
    stores = _stores("big", "float32")
    seen = []
    orig = tscoring._score_block

    def spy(queries, q_inv, q_sq, vecs, *a, **kw):
        seen.append(vecs.shape[0])
        return orig(queries, q_inv, q_sq, vecs, *a, **kw)

    monkeypatch.setattr(tscoring, "_score_block", spy)
    r = stores[1].query_batch(_queries(2, 15), tx.Metric.Manhattan).meta_filter(
        FILTERS["cat"](tx)).take(5).collect()
    assert len(r) == 5 and all((i // CHUNK) % 16 == 3 for i in r.indices)
    assert seen == [tscoring.SCAN_TILE] * 2
    assert stores[1]._dv.vectors.shape[0] == 4 * tscoring.SCAN_TILE
