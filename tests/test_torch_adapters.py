"""The port's pandas / Arrow / Parquet adapters against the JAX package's.

The same DataFrames as ``tests/test_adapters.py`` go through
``otters_tpu.adapters`` and ``otters_tpu_torch.adapters``: the columns made
from each Series (dtype, values, null masks) are equal; stores built from a
DataFrame, an Arrow table or a Parquet file answer the same filtered
queries; ``MetaQueryResults.to_pandas`` / ``to_arrow`` give equal frames
and tables (null-faithful dtypes); the length check raises JAX's message.
"""

import inspect

import numpy as np
import pandas as pd
import pytest

import otters_tpu as jx
import otters_tpu.adapters as jad
import otters_tpu_torch as tx
import otters_tpu_torch.adapters as tad
from otters_tpu.errors import OttersError as JOttersError
from otters_tpu_torch.errors import OttersError

FUNCS = ["column_from_series", "columns_from_pandas", "builder_from_pandas",
         "builder_from_arrow", "builder_from_parquet", "results_to_pandas", "results_to_arrow"]


@pytest.fixture()
def df():
    return pd.DataFrame(
        {
            "name": ["ada", "bob", None, "cleo"],
            "price": [1.5, None, 3.0, 4.25],
            "count": pd.array([1, 2, None, 4], dtype="Int64"),
            "small": np.array([1, 2, 3, 4], dtype=np.int16),
            "when": pd.to_datetime(["2024-01-01", "2024-06-01", None, "2025-01-01"]),
            "ok": pd.array([True, None, False, True], dtype="boolean"),
            "f32": np.array([0.5, -1.0, 2.0, 3.5], dtype=np.float32),
        }
    )


@pytest.mark.parametrize("name", FUNCS)
def test_functions_keep_jax_signatures(name):
    assert (list(inspect.signature(getattr(tad, name)).parameters)
            == list(inspect.signature(getattr(jad, name)).parameters))


def test_columns_from_series_match_jax(df):
    for name in df.columns:
        cj, ct = jad.column_from_series(df[name]), tad.column_from_series(df[name])
        assert ct.dtype.value == cj.dtype.value and ct.name == cj.name == name
        assert list(ct.null_mask()) == list(cj.null_mask())
        vj, vt = cj.values(), ct.values()
        if isinstance(vj, np.ndarray):
            np.testing.assert_array_equal(np.asarray(vt), vj)
            assert np.asarray(vt).dtype == vj.dtype
        else:
            assert list(vt) == list(vj)
    assert [c.name for c in tad.columns_from_pandas(df, exclude=("small",))] == \
        [c.name for c in jad.columns_from_pandas(df, exclude=("small",))]


def _query(store, pkg, q):
    return (store.query(q, pkg.Metric.Cosine)
            .meta_filter(pkg.col("price").lt(4.0) & pkg.col("when").gte("2024-01-01"))
            .take(4).collect())


@pytest.mark.parametrize("source", ["pandas", "arrow", "parquet"])
def test_builders_match_jax(df, source, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    vectors = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    if source == "parquet":
        path = str(tmp_path / "meta.parquet")
        pq.write_table(pa.Table.from_pandas(df), path)
        arg = path
    else:
        arg = df if source == "pandas" else pa.Table.from_pandas(df)
    fn = f"builder_from_{source}"
    sj = getattr(jad, fn)(arg, vectors).with_chunk_size(2).build()
    st = getattr(tad, fn)(arg, vectors).with_chunk_size(2).with_device("cpu").build()
    rj, rt = _query(sj, jx, vectors[0]), _query(st, tx, vectors[0])
    assert rt.indices == rj.indices == [0]  # row 1's price is null, row 2's date
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=1e-6)
    r = st.query(vectors[3], tx.Metric.Cosine).meta_filter(tx.col("name").eq("cleo")) \
        .take(4).collect()
    assert r.indices == [3]


def test_length_mismatch_matches_jax(df):
    with pytest.raises(JOttersError) as ej:
        jad.builder_from_pandas(df, np.zeros((3, 4), np.float32))
    with pytest.raises(OttersError) as et:
        tad.builder_from_pandas(df, np.zeros((3, 4), np.float32))
    assert str(et.value) == str(ej.value)


def _results(pkg):
    rng = np.random.default_rng(51)
    n = 64
    cols = [
        pkg.Column("price", pkg.DataType.Float64).from_values(
            [None if i % 7 == 0 else float(i) for i in range(n)]),
        pkg.Column("tag", pkg.DataType.String).from_values(
            [None if i % 5 == 0 else f"t{i % 3}" for i in range(n)]),
        pkg.Column("ok", pkg.DataType.Bool).from_values(
            [None if i % 11 == 0 else (i % 2 == 0) for i in range(n)]),
        pkg.Column("cnt", pkg.DataType.Int64).from_values(list(range(n))),
        pkg.Column("small", pkg.DataType.Int32).from_values(
            [None if i % 13 == 0 else i for i in range(n)]),
        pkg.Column("when", pkg.DataType.DateTime).from_values(
            [1704067200000 + i * 86_400_000 for i in range(n)]),
    ]
    b = (pkg.MetaStore.from_columns(cols)
         .with_vectors(rng.normal(size=(n, 8)).astype(np.float32)).with_chunk_size(16))
    if pkg is tx:
        b = b.with_device("cpu")
    return b.build().query(rng.normal(size=8).astype(np.float32), pkg.Metric.Cosine) \
        .take(20).collect()


def test_results_to_pandas_and_arrow_match_jax():
    rj, rt = _results(jx), _results(tx)
    assert rt.indices == rj.indices
    fj, ft = rj.to_pandas(), rt.to_pandas()
    assert list(ft.columns) == list(fj.columns) == \
        ["index", "score", "cnt", "ok", "price", "small", "tag", "when"]
    assert [str(t) for t in ft.dtypes] == [str(t) for t in fj.dtypes]
    pd.testing.assert_frame_equal(ft.drop(columns="score"), fj.drop(columns="score"))
    np.testing.assert_allclose(ft["score"], fj["score"], rtol=0, atol=1e-6)
    tj, tt = rj.to_arrow(), rt.to_arrow()
    assert tt.schema == tj.schema and tt.num_rows == tj.num_rows == 20
    assert tt.drop(["score"]).equals(tj.drop(["score"]))
    for i, gi in enumerate(rt.indices):
        assert pd.isna(ft["price"][i]) == (gi % 7 == 0)
        assert pd.isna(ft["tag"][i]) == (gi % 5 == 0)
        assert pd.isna(ft["ok"][i]) == (gi % 11 == 0)
