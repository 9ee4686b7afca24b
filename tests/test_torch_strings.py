"""The extended string predicates in the port against the JAX package.

contains / starts_with / ends_with / fuzzy and their negations evaluate on
the host, where the strings live: the native arena scans
(``native.substr_mask_arena`` / ``native.fuzzy_mask``) or their numpy /
Python paths (``ops/strscan.py``, ``ops/strmatch.py``), then a row mask and
an exact per-chunk any() per (column, op, literal) that the device program
reads as a ``hostmask`` leaf. The same seeded inputs go through
``otters_tpu`` (JAX on the CPU, Pallas in interpret mode) and
``otters_tpu_torch`` (CPU device):

- both scan routes of both packages give the same masks bit for bit, and
  Python's ``in`` / ``startswith`` / ``endswith`` / a plain Levenshtein
  (UTF-8 multibyte strings, empty patterns and strings, matches that would
  straddle two rows, ``max_dist`` past the band cap of 16);
- the hostmask row and chunk masks equal JAX's bit for bit (nulls excluded,
  negations by De Morgan);
- filtered queries on the direct, scan, fused and take-all paths, with the
  certificate on and off, give the same rows in order, the same
  ``certified`` flags and the same pruned / evaluated counts;
- ``cache_stats`` after the same sequence (evictions included, caps
  lowered alike) and ``precompile``'s count;
- the host compare ``_str_cmp`` answers every op as JAX's, and a
  hash-collision redo over ``Eq`` mixed with ``contains`` gives JAX's rows.
"""

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu.meta as jmeta
import otters_tpu_torch as tx
import otters_tpu_torch.meta as tmeta
from otters_tpu import native as jnative
from otters_tpu.ops import strmatch as jstrmatch
from otters_tpu.ops import strscan as jstrscan
from otters_tpu_torch import native as tnative
from otters_tpu_torch.ops import strmatch as tstrmatch
from otters_tpu_torch.ops import strscan as tstrscan
from torch_parity import (
    PATHS,
    assert_same_on_path,
    columns,
    query_on_path,
    route,
)

N, D, CHUNK = 3000, 32, 128

# arena edge cases: multibyte UTF-8, empty strings, and neighbours whose
# concatenation holds the pattern across their boundary ("ab" | "cd")
EDGE = ["", "abc", "ab", "cd", "éa", "aé", "日本語", "本", "x" * 40, "abcab", "é", "bé", "cdab",
        "ab cd", "Ab", "aaa", "a", "b", "ébé", "日本"]
PATTERNS = ["", "a", "ab", "bc", "cd", "é", "bé", "本", "日本語", "abcabc", "x" * 41, "b c"]


def _levenshtein(a: bytes, b: bytes) -> int:
    """The plain full-table edit distance (the truth for the banded one)."""
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _python_mask(strings, pattern, mode):
    fn = {"contains": lambda s: pattern in s, "starts_with": lambda s: s.startswith(pattern),
          "ends_with": lambda s: s.endswith(pattern)}[mode]
    return np.array([fn(s) for s in strings], dtype=bool)


@pytest.mark.parametrize("route_", ["native", "numpy"])
@pytest.mark.parametrize("mode", tstrscan.MODES)
def test_substr_mask_matches_jax_and_python(mode, route_):
    assert tnative.available()  # g++ builds the library here too
    data, offsets = tnative.pack_utf8_arena(EDGE)
    jd, jo = jnative.pack_utf8_arena(EDGE)
    assert np.array_equal(data, jd) and np.array_equal(offsets, jo)
    for pat in PATTERNS:
        want = _python_mask(EDGE, pat, mode)
        if route_ == "native":
            got = tnative.substr_mask_arena(data, offsets, pat, mode)
            ref = jnative.substr_mask_arena(jd, jo, pat, mode)
            assert got.dtype == np.uint8
            assert np.array_equal(tstrscan.substr_mask(data, offsets, pat, mode), want)
        else:
            got = tstrscan._substr_mask_numpy(data, offsets, pat, mode)
            ref = jstrscan._substr_mask_numpy(jd, jo, pat, mode)
        assert np.array_equal(got.astype(bool), want), (mode, pat)
        assert np.array_equal(got, ref), (mode, pat)
    with pytest.raises(ValueError, match="unknown substring mode"):
        tstrscan.substr_mask(data, offsets, "a", "middle")


def test_arena_bytes_cache_is_an_lru_of_four():
    tstrscan._BYTES_CACHE.clear()
    arenas = [np.frombuffer(bytes([i]) * 8, dtype=np.uint8).copy() for i in range(6)]
    for a in arenas:
        assert tstrscan._arena_bytes(a) == a.tobytes()
    assert len(tstrscan._BYTES_CACHE) == tstrscan._BYTES_CACHE_CAP == 4
    assert tstrscan._arena_bytes(arenas[2]) is tstrscan._BYTES_CACHE[id(arenas[2])][1]
    tstrscan._BYTES_CACHE.clear()


@pytest.mark.parametrize("route_", ["native", "python"])
@pytest.mark.parametrize("max_dist", [0, 1, 3, 20])
def test_fuzzy_mask_matches_jax_and_levenshtein(max_dist, route_, monkeypatch):
    if route_ == "python":
        monkeypatch.setattr(tnative, "fuzzy_mask", lambda *a: None)
        monkeypatch.setattr(jnative, "fuzzy_mask", lambda *a: None)
    rng = np.random.default_rng(max_dist)
    strings = EDGE + ["".join(rng.choice(list("abé日 "), size=rng.integers(0, 24)))
                      for _ in range(60)]
    nulls = np.zeros(len(strings), dtype=bool)
    nulls[::7] = True
    k = min(max_dist, tstrmatch.MAX_DIST_CAP)  # clamped on both routes
    for pat in ["", "ab", "abé", "日本語", "x" * 30, "éaé"]:
        got = tstrmatch.fuzzy_mask(strings, nulls, pat, max_dist)
        ref = jstrmatch.fuzzy_mask(strings, nulls, pat, max_dist)
        want = np.array([_levenshtein(s.encode(), pat.encode()) <= k for s in strings]) & ~nulls
        assert np.array_equal(got, want), pat
        assert np.array_equal(got, ref), pat
        if route_ == "native":
            raw = tnative.fuzzy_mask(strings, pat, max_dist)
            assert np.array_equal(raw, jnative.fuzzy_mask(strings, pat, max_dist))


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------

def _names(n, seed=0):
    """Multibyte names with nulls, clustered by chunk so that prefixes prune."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 17 == 0:
            out.append(None)
            continue
        c = (i // CHUNK) % 6
        out.append(f"{'éab'[c % 3]}_{c}_{rng.integers(0, 40)}_日{'x' * (i % 3)}")
    return out


def _spec(n):
    return [("name", "String", _names(n)),
            ("price", "Float64", (np.arange(n) % 100).astype(np.float64)),
            ("version", "Int32", ((np.arange(n) // CHUNK) % 4).astype(np.int32))]


def _twins(n=N, storage="int8", seed=5):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    out = []
    for pkg in (jx, tx):
        b = (pkg.MetaStore.from_columns(columns(pkg, _spec(n))).with_vectors(vecs)
             .with_chunk_size(CHUNK).with_storage_dtype(storage)
             .with_rerank_source(keep_host_f32=True))
        out.append(b.with_device("cpu").build() if pkg is tx else b.build())
    q = rng.normal(size=(3, D)).astype(np.float32)
    return out[0], out[1], q


LEAVES = {
    "contains": lambda p: p.col("name").contains("_1"),
    "starts_with": lambda p: p.col("name").starts_with("é_"),
    "ends_with": lambda p: p.col("name").ends_with("日x"),
    "fuzzy": lambda p: p.col("name").fuzzy("a_1_7_日", 2),
    "not_contains": lambda p: ~p.col("name").contains("_1"),
    "not_starts_with": lambda p: ~p.col("name").starts_with("é_"),
    "not_ends_with": lambda p: ~p.col("name").ends_with("日x"),
    "not_fuzzy": lambda p: ~p.col("name").fuzzy("a_1_7_日", 2),
}


def _leaf(store, expr):
    (clause,) = expr.compile(store.schema()).clauses
    (leaf,) = clause
    return leaf


@pytest.mark.parametrize("op", list(LEAVES))
def test_hostmask_row_and_chunk_masks_match_jax(op):
    sj, st, _ = _twins()
    row_j, chunk_j = sj._hostmask_for(_leaf(sj, LEAVES[op](jx)))
    row_t, chunk_t = st._hostmask_for(_leaf(st, LEAVES[op](tx)))
    assert row_t.dtype == chunk_t.dtype == torch.bool
    assert np.array_equal(row_t.numpy(), np.asarray(row_j))
    assert np.array_equal(chunk_t.numpy(), np.asarray(chunk_j))
    assert len(chunk_t) == st.n_chunks() and len(row_t) == st._dv.vectors.shape[0]
    names = _names(N)
    assert not row_t.numpy()[[i for i, s in enumerate(names) if s is None]].any()
    # the second lowering of the same literal is a cache hit
    assert st._hostmask_for(_leaf(st, LEAVES[op](tx)))[0] is row_t


FILTERS = {
    "contains": lambda p: p.col("name").contains("_1"),
    "not_contains_and_price": lambda p: ~p.col("name").contains("_1") & p.col("price").lt(50.0),
    "prefix_or_fuzzy": lambda p: p.col("name").starts_with("a_3") | p.col("name").fuzzy(
        "é_0_1_日", 1),
}


@pytest.mark.parametrize("certify", [True, False], ids=["cert", "uncert"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("flt", list(FILTERS))
def test_string_filtered_queries_match_jax(flt, path, certify, monkeypatch):
    route(path, monkeypatch)
    sj, st, q = _twins()
    rj = query_on_path(sj, jx, q, path, certify, FILTERS[flt])
    rt = query_on_path(st, tx, q, path, certify, FILTERS[flt])
    assert_same_on_path(rj, rt, sj, st, path)
    stats = st.last_query_stats()
    assert stats.certified is (True if certify and path != "take_all" else None)
    if flt == "prefix_or_fuzzy":
        assert stats.pruned_chunks > 0  # the per-chunk any() prunes
    plan = tx_plan(st, FILTERS[flt](tx))
    assert all(plan._row_satisfies(i) for i in _positions(st, rt.indices))


def tx_plan(store, expr):
    return store.query(np.zeros(D, np.float32), tx.Metric.Cosine).meta_filter(expr)


def _positions(store, ids):
    if store._index_map is None:
        return list(ids)
    inv = np.empty(store.n_rows, np.int64)
    inv[store._index_map] = np.arange(store.n_rows)
    return inv[np.asarray(ids, dtype=np.int64)].tolist()


@pytest.fixture
def _aot_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("OTTERS_AOT_CACHE", str(tmp_path))
    monkeypatch.setenv("OTTERS_AOT_NO_WARM", "1")
    monkeypatch.delenv("OTTERS_DISABLE_AOT", raising=False)


def test_cache_stats_and_precompile_match_jax(_aot_in_tmp):
    """The same literals and plans touch the same caches: a literal shared
    by two plans is a hostmask hit on the second, and with the hostmask cap
    lowered to 3 on both stores a cycle of literals evicts alike."""
    sj, st, q = _twins(n=1500)
    for s in (sj, st):
        s._hostmask_cache.cap = 3
    flts = [lambda p, s=s: p.col("name").contains(s) for s in ("_1", "_2", "_3", "_4")]
    flts += [lambda p: p.col("name").contains("_1") & p.col("price").lt(50.0),
             lambda p: p.col("name").fuzzy("a_1_7_日", 30), lambda p: p.col("name").contains("_2")]
    for pkg, s in ((jx, sj), (tx, st)):
        for f in flts:
            s.query_batch(q, pkg.Metric.Cosine).meta_filter(f(pkg)).take(5).collect()
    assert st.cache_stats() == sj.cache_stats()
    assert st.cache_stats()["hostmask"]["evictions"] > 0
    nj = sj.precompile(filters=[f(jx) for f in flts[:3]], batch_sizes=(1, 3), k=5,
                       rerank_from=20)
    nt = st.precompile(filters=[f(tx) for f in flts[:3]], batch_sizes=(1, 3), k=5,
                       rerank_from=20)
    assert nt == nj
    assert st.cache_stats() == sj.cache_stats()


STR_OPS = ["Eq", "Neq", "Contains", "StartsWith", "EndsWith", "Fuzzy", "NotContains",
           "NotStartsWith", "NotEndsWith", "NotFuzzy"]


@pytest.mark.parametrize("op", STR_OPS)
def test_str_cmp_answers_every_op_as_jax(op):
    """The host compare (``_row_satisfies``' and the exact mask's) no longer
    raises for any op, and answers as JAX's."""
    cmp_t, cmp_j = getattr(tx.CmpOp, op), getattr(jx.CmpOp, op)
    for v in EDGE:
        for pat in PATTERNS[:8]:
            rhs = (pat, 2) if "Fuzzy" in op else pat
            assert tmeta._str_cmp(v, rhs, cmp_t) == jmeta._str_cmp(v, rhs, cmp_j), (v, pat)
    assert tmeta._str_cmp("abc", ("abd", 99), tx.CmpOp.Fuzzy)  # max_dist clamped to 16
    assert not tmeta._str_cmp("a" * 40, ("", 99), tx.CmpOp.Fuzzy)


def test_host_exact_row_mask_matches_jax():
    sj, st, _ = _twins()
    for name, f in list(LEAVES.items()) + list(FILTERS.items()):
        ej = f(jx) | jx.col("name").eq("a_0_3_日x")
        et = f(tx) | tx.col("name").eq("a_0_3_日x")
        pj = sj.query(np.zeros(D, np.float32), jx.Metric.Cosine).meta_filter(ej)
        pt = tx_plan(st, et)
        n_pad = st._dv.vectors.shape[0]
        mj, mt = pj._host_exact_row_mask(n_pad), pt._host_exact_row_mask(n_pad)
        assert np.array_equal(mt, mj), name
        rows = np.flatnonzero(mt)[:40].tolist() + np.flatnonzero(~mt[:N])[:40].tolist()
        assert [pt._row_satisfies(i) for i in rows] == [pj._row_satisfies(i) for i in rows]


def test_collision_redo_over_eq_and_contains_matches_jax(monkeypatch):
    """A (forced) failed host verification of a filter mixing ``Eq`` and
    ``contains`` re-runs the query with the exact host mask in both
    packages: the same rows, and the certificate declines."""
    sj, st, q = _twins()

    def flt(pkg):
        return pkg.col("name").eq("a_0_3_日x") | pkg.col("name").contains("_4_1")

    for plan_cls in (jmeta.MetaQueryPlan, tmeta.MetaQueryPlan):
        seen = []
        monkeypatch.setattr(plan_cls, "_row_satisfies",
                            lambda self, i, seen=seen: bool(seen) or seen.append(i) or False)
    res = []
    for pkg, s in ((jx, sj), (tx, st)):
        with pytest.warns(UserWarning, match="certificate did not pass"):
            res.append(s.query_batch(q, pkg.Metric.Cosine).meta_filter(flt(pkg))
                       .take(10, rerank_from=40).collect())
    assert res[1].indices == res[0].indices
    np.testing.assert_allclose(res[1].scores, res[0].scores, rtol=0, atol=1e-6)
    assert st.last_query_stats().certified is False is sj.last_query_stats().certified
    names = _names(N)
    assert all(names[i] == "a_0_3_日x" or "_4_1" in names[i] for i in res[1].indices)
