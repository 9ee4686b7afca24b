"""Zonemap / Bloom pruning of the port against the JAX package.

Chunk masks, row masks and the evaluated / pruned chunk counts must be equal
on the ``tests/test_zonemap.py`` fixture and on the 64-bit edge cases of
``tests/test_wide64.py`` (NaN, -0.0, subnormals, infinities, nulls, int64
extremes), which the port compares natively in int64 / float64 where the
JAX package uses (hi, lo) 32-bit pairs.
"""

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu.ops import predicate as jpred
from otters_tpu_torch.ops import predicate as tpred
from torch_parity import columns

ZONEMAP_SPEC = [
    ("val", "Int32", [1, 2, None, 10, 11, 12, None, None, None]),
    ("ts", "DateTime", [
        "2024-01-01T00:00:00Z", None, "2024-06-01T00:00:00Z",
        "2026-01-01T00:00:00Z", "2026-06-01T00:00:00Z",
        "2024-12-31T23:59:59Z", None, None, None,
    ]),
    ("grade", "String", ["A", "B", None, "C", "A", "A", None, None, None]),
]

_I64 = np.iinfo(np.int64)
_SUB = 5e-324  # smallest subnormal double
F64_VALUES = [float("nan"), -0.0, 0.0, _SUB, -_SUB, float("inf"),
              float("-inf"), None, 1.0, 2.5e-310, -1e300, 1e300,
              None, None, None, float("nan"), float("nan"), 7.0]
I64_VALUES = [int(_I64.min) + 1, -1, 0, 1 << 32, (1 << 32) - 1, -(1 << 32),
              int(_I64.max), None, 5, None, None, None, (1 << 40), -(1 << 40),
              3, int(_I64.min), 2, 1]
F32_VALUES = [float("nan"), -0.0, 0.0, 1e-30, -1e-30, 3.0, None, 2.0, 1.0]
F32_SUBNORMALS = [float("nan"), -0.0, 0.0, 1e-45, -1e-45, 3.0, None, 2.0, 1.0]
EDGE_SPEC = [
    ("f", "Float64", F64_VALUES),
    ("i", "Int64", I64_VALUES),
]


def _twins(spec, chunk):
    n = len(spec[0][2])
    vecs = np.tile(np.array([[1.0, 0.0]], np.float32), (n, 1))
    stores = []
    for pkg in (jx, tx):
        b = (
            pkg.MetaStore.from_columns(columns(pkg, spec))
            .with_vectors(vecs)
            .with_chunk_size(chunk)
        )
        if pkg is tx:
            b = b.with_device("cpu")
        stores.append(b.build())
    return stores


def _masks(store, pkg, expr):
    plan = store.query([1.0, 0.0], pkg.Metric.DotProduct).meta_filter(expr)
    static, params, used = plan._lower_plan()
    cols = {c: store._device_cols[c] for c in used}
    n_pad = store._dv.vectors.shape[0]
    if pkg is jx:
        return (
            np.asarray(jpred.chunk_mask(static, params, cols, store.n_chunks())),
            np.asarray(jpred.row_mask(static, params, cols, n_pad)),
        )
    return (
        tpred.chunk_mask(static, params, cols, store.n_chunks(), "cpu").numpy(),
        tpred.row_mask(static, params, cols, n_pad, "cpu").numpy(),
    )


def _check(stores, make_expr):
    sj, st = stores
    mj = _masks(sj, jx, make_expr(jx))
    mt = _masks(st, tx, make_expr(tx))
    np.testing.assert_array_equal(mt[0], mj[0])
    np.testing.assert_array_equal(mt[1], mj[1])
    n = sj.n_rows
    rj = sj.query([1.0, 0.0], jx.Metric.DotProduct).meta_filter(make_expr(jx)).take(n).collect()
    rt = st.query([1.0, 0.0], tx.Metric.DotProduct).meta_filter(make_expr(tx)).take(n).collect()
    assert rt.indices == rj.indices
    a, b = sj.last_query_stats(), st.last_query_stats()
    assert (b.pruned_chunks, b.evaluated_chunks, b.vectors_compared) == (
        a.pruned_chunks, a.evaluated_chunks, a.vectors_compared
    )


ZONEMAP_FILTERS = {
    "gt": lambda p: p.col("val").gt(5),
    "eq": lambda p: p.col("val").eq(1),
    "lte_boundary": lambda p: p.col("val").lte(2),
    "gte_boundary": lambda p: p.col("val").gte(12),
    "neq": lambda p: p.col("val").neq(11),
    "and_datetime": lambda p: p.col("val").gt(1) & p.col("ts").lt("2025-01-01"),
    "datetime": lambda p: p.col("ts").gte("2026-01-01"),
    "string_eq": lambda p: p.col("grade").eq("A"),
    "string_absent": lambda p: p.col("grade").eq("Z"),
    "string_neq": lambda p: p.col("grade").neq("A"),
    "or": lambda p: p.col("val").lt(2) | p.col("grade").eq("C"),
    "is_null": lambda p: p.col("val").is_null(),
    "is_not_null": lambda p: p.col("ts").is_not_null(),
    "int32_wrap": lambda p: p.col("val").lt((1 << 32) + 5),
}


@pytest.fixture(scope="module")
def zonemap_stores():
    return _twins(ZONEMAP_SPEC, chunk=3)


@pytest.mark.parametrize("name", sorted(ZONEMAP_FILTERS))
def test_zonemap_fixture_masks_and_counts_match(zonemap_stores, name):
    _check(zonemap_stores, ZONEMAP_FILTERS[name])


@pytest.fixture(scope="module")
def edge_stores():
    return _twins(EDGE_SPEC, chunk=3)


F64_THRESHOLDS = [0.0, -0.0, _SUB, -_SUB, float("inf"), float("-inf"),
                  float("nan"), 1.0, 2.5e-310, 1e300]
CMPS = ["eq", "neq", "lt", "lte", "gt", "gte"]


@pytest.mark.parametrize("cmp", CMPS)
def test_float64_edge_cases_match(edge_stores, cmp):
    for thr in F64_THRESHOLDS:
        _check(edge_stores, lambda p, t=thr: getattr(p.col("f"), cmp)(t))


@pytest.mark.parametrize("cmp", CMPS)
def test_int64_edge_cases_match(edge_stores, cmp):
    for thr in [0, -1, 1 << 32, (1 << 32) - 1, -(1 << 32), int(_I64.max),
                int(_I64.min), 1 << 40, 3]:
        _check(edge_stores, lambda p, t=thr: getattr(p.col("i"), cmp)(t))


def test_float32_nan_negzero_match():
    stores = _twins([("x", "Float32", F32_VALUES)], chunk=3)
    for cmp in CMPS:
        for thr in [0.0, -0.0, 1e-30, 3.0, float("nan")]:
            _check(stores, lambda p, t=thr, c=cmp: getattr(p.col("x"), c)(t))


def test_float32_subnormals_keep_ieee_semantics():
    """Float32 subnormals compare as the JAX package's do: flushed to zero
    (XLA on the CPU and the TPU), in the column and in the literal, so
    +-1e-45 == 0.0. Masks, rows and counts equal JAX's for every compare."""
    stores = _twins([("x", "Float32", F32_SUBNORMALS)], chunk=3)
    sj, st = stores
    got = st.query([1.0, 0.0], tx.Metric.DotProduct).meta_filter(
        tx.col("x").eq(0.0)
    ).take(9).collect()
    ref = sj.query([1.0, 0.0], jx.Metric.DotProduct).meta_filter(
        jx.col("x").eq(0.0)
    ).take(9).collect()
    assert sorted(got.indices) == sorted(ref.indices) == [1, 2, 3, 4]
    for cmp in CMPS:
        for thr in [0.0, -0.0, 1e-45, -1e-45, 1e-30, 3.0, float("nan")]:
            _check(stores, lambda p, t=thr, c=cmp: getattr(p.col("x"), c)(t))


def test_zonemap_min_max_excludes_nan_and_nulls():
    """All-null / all-NaN chunks report (+inf, -inf), like the JAX build."""
    _, st = _twins(EDGE_SPEC, chunk=3)
    dev = st._device_cols["f"]
    zmin, zmax = dev["zmin"].numpy(), dev["zmax"].numpy()
    # chunk 4 holds [None, None, None]; chunk 5 holds [NaN, NaN, 7.0]
    assert zmin[4] == np.inf and zmax[4] == -np.inf
    assert zmin[5] == 7.0 and zmax[5] == 7.0
    # chunk 0 holds [NaN, -0.0, 0.0]: canonicalised zero, sign dropped
    assert zmin[0] == 0.0 and not np.signbit(zmin[0])
    assert dev["vals"].dtype == torch.float64
