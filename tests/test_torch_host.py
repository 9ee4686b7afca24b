"""Host-side copies of the port against the JAX package.

The port keeps its own copies of the host-only modules (it may not import
``otters_tpu``): the ``col()`` DSL and its CNF compiler, the deferred
errors, string hashing, Bloom filters and columns must agree exactly.
"""

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu import native as jnative
from otters_tpu.ops import bloom as jbloom
from otters_tpu.ops import hashing as jhash
from otters_tpu_torch import native as tnative
from otters_tpu_torch.ops import bloom as tbloom
from otters_tpu_torch.ops import hashing as thash


def _schema(pkg):
    return {
        "age": pkg.DataType.Int64,
        "score": pkg.DataType.Float64,
        "name": pkg.DataType.String,
        "ts": pkg.DataType.DateTime,
        "n": pkg.DataType.Int32,
        "f": pkg.DataType.Float32,
        "ok": pkg.DataType.Bool,
    }


# the tests/test_expr.py fixtures plus De Morgan, null and isin shapes
EXPRS = {
    "gt": lambda c: c("age").gt(25),
    "string_eq": lambda c: c("name").eq("alice"),
    "string_or": lambda c: c("name").eq("a") | c("name").eq("b") | c("name").eq("c"),
    "widen_int": lambda c: c("score").gte(3),
    "float": lambda c: c("score").lt(2.5),
    "and": lambda c: c("age").gt(1) & c("score").lte(9.0),
    "or": lambda c: c("age").lt(18) | c("age").gt(65),
    "cnf": lambda c: (c("age").lt(18) | c("age").gt(65)) & (c("name").neq("x") | c("score").gt(1.0)),
    "datetime": lambda c: c("ts").gte("2024-01-01") & c("ts").lt("2024-06-01T12:00:00Z"),
    "tautology": lambda c: (c("age").eq(3) | c("age").neq(3)) & c("score").gt(0.0),
    "not": lambda c: ~(c("age").gt(5) & c("name").eq("z")),
    "null": lambda c: c("age").is_null() | c("score").is_not_null(),
    "isin": lambda c: c("name").isin(["a", "b"]),
    "between": lambda c: c("n").between(-3, 7),
    "bool": lambda c: c("ok").eq(True),
    "int32_wrap": lambda c: c("n").lt((1 << 32) + 1),
    "nan": lambda c: c("score").neq(float("nan")),
}

BAD = {
    "unknown": lambda c: c("nope").gt(1),
    "type": lambda c: c("age").gt("x"),
    "string_op": lambda c: c("name").gt("a"),
    "float_literal_on_int": lambda c: c("age").gt(2.5),
    "bad_datetime": lambda c: c("ts").gt("not a date"),
}


def _norm(cf):
    return tuple(
        tuple((lf.kind, lf.column, lf.cmp.value, lf.rhs, lf.rhs_kind) for lf in cl)
        for cl in cf.clauses
    )


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_compiled_filters_equal(name):
    cj = EXPRS[name](jx.col).compile(_schema(jx))
    ct = EXPRS[name](tx.col).compile(_schema(tx))
    assert repr(_norm(ct)) == repr(_norm(cj))


@pytest.mark.parametrize("name", sorted(BAD))
def test_compile_errors_equal(name):
    with pytest.raises(jx.ExprError) as ej:
        BAD[name](jx.col).compile(_schema(jx))
    with pytest.raises(tx.ExprError) as et:
        BAD[name](tx.col).compile(_schema(tx))
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def test_deferred_error_messages_equal():
    """Builder chains defer errors to collect(), with the same messages."""
    vecs = np.eye(4, dtype=np.float32)
    msgs = []
    for pkg in (jx, tx):
        b = (
            pkg.MetaStore.from_columns([pkg.Column("age", pkg.DataType.Int64).from_values([1, 2, 3, 4])])
            .with_vectors(vecs)
        )
        if pkg is tx:
            b = b.with_device("cpu")
        store = b.build()
        plan = store.query(vecs[0], pkg.Metric.Cosine).meta_filter(pkg.col("zzz").gt(1)).take(2)
        with pytest.raises(pkg.OttersError) as e1:
            plan.collect()
        with pytest.raises(pkg.OttersError) as e2:
            store.query(np.ones(3, np.float32), pkg.Metric.Cosine).take(2).collect()
        with pytest.raises(pkg.OttersError) as e3:
            store.query(vecs[0], pkg.Metric.Cosine).take(2, rerank_from=1)
        with pytest.raises(pkg.OttersError) as e4:
            store.query(vecs[0], pkg.Metric.Cosine).take(2, rerank_from=4).collect()
        msgs.append([str(e.value) for e in (e1, e2, e3, e4)])
    assert msgs[1] == msgs[0]


def _strings(n, seed):
    rng = np.random.default_rng(seed)
    words = ["", "a", "ü", "日本", "item_", "x" * 40]
    return [words[i % len(words)] + str(int(v)) for i, v in enumerate(rng.integers(0, 10**9, n))]


@pytest.mark.parametrize("n", [10, 5000])  # python path / native path
def test_hash_strings_bit_equal(n):
    s = _strings(n, n)
    gj = jhash.hash_strings(s)
    gt = thash.hash_strings(s)
    np.testing.assert_array_equal(gt[0], gj[0])
    np.testing.assert_array_equal(gt[1], gj[1])


def test_native_library_builds_like_the_reference():
    assert tnative.available() == jnative.available()


@pytest.mark.parametrize("n", [300, 9000])  # numpy scatter / native scatter
def test_bloom_matrices_bit_equal(n):
    chunk = 256
    n_chunks = -(-n // chunk)
    s = _strings(n, 7)
    g1, g2 = thash.hash_strings(s)
    nulls = np.arange(n) % 13 == 0
    ids = np.arange(n, dtype=np.int64) // chunk
    for fpr in (0.01, 0.3):
        pj = jbloom.BloomParams.from_fpr(fpr, chunk)
        pt = tbloom.BloomParams.from_fpr(fpr, chunk)
        assert (pt.bits, pt.k_hashes, pt.words) == (pj.bits, pj.k_hashes, pj.words)
        mj = jbloom.build_matrix(g1, g2, nulls, ids, n_chunks, pj, chunk_size=chunk)
        mt = tbloom.build_matrix(g1, g2, nulls, ids, n_chunks, pt, chunk_size=chunk)
        np.testing.assert_array_equal(mt, mj)
        dev = tbloom.to_device(mt, "cpu")
        for probe in (s[5], s[4000 % n], "absent-string"):
            wj, kj = jbloom.probe_coords(probe, pj)
            wt, kt = tbloom.probe_coords(probe, pt)
            np.testing.assert_array_equal(wt, wj)
            np.testing.assert_array_equal(kt, kj)
            got = tbloom.probe(dev, torch.from_numpy(wt.astype(np.int64)),
                               torch.from_numpy(kt.view(np.int32)))
            want = jbloom.probe(mj, wj, kj)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


COLUMN_VALUES = {
    "Int32": [1, None, -5, 2**31 - 1],
    "Int64": [2**40, None, -(2**62), 0],
    "Float32": [1.5, None, float("nan"), -0.0],
    "Float64": [1e300, None, 5e-324, -2.5],
    "String": ["a", None, "", "日本"],
    "DateTime": ["2024-01-01", None, "2024-06-01T12:30:00Z", "1999-12-31 23:59:59"],
    "Bool": [True, None, False, True],
}


@pytest.mark.parametrize("dt", sorted(COLUMN_VALUES))
def test_column_sentinels_and_null_masks_equal(dt):
    cj = jx.Column("c", getattr(jx.DataType, dt)).from_values(COLUMN_VALUES[dt])
    ct = tx.Column("c", getattr(tx.DataType, dt)).from_values(COLUMN_VALUES[dt])
    np.testing.assert_array_equal(np.asarray(ct.null_mask()), np.asarray(cj.null_mask()))
    vj, vt = cj.values(), ct.values()
    if dt == "String":
        assert list(vt) == list(vj)
    else:
        np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj))
    assert repr(ct.dtype.sentinel) == repr(cj.dtype.sentinel)
