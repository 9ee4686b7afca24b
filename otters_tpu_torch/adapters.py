"""DataFrame interop: build columns/stores from pandas and Arrow.

The reference lists "Integration with Parquet/Arrow formats" as roadmap;
the port ships the JAX package's adapters: pandas/Arrow columns map onto
``Column`` bulk loads (sentinel + null-mask scheme), so a store can be built
straight from a DataFrame or a Parquet file read with pyarrow. pandas and
pyarrow are imported inside the functions: ``import otters_tpu_torch``
needs neither.

dtype mapping:
    int8/16/32, uint8/16  -> Int32          int64, uint32 -> Int64
    float32               -> Float32        float64       -> Float64
    object/str/categorical-> String         datetime64[*] -> DateTime (millis)
Nullable pandas dtypes (Int64, boolean, string) are supported via ``isna``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .column import Column
from .errors import OttersError
from .meta import MetaStore, MetaStoreBuilder
from .types import DataType


def _dtype_for(series) -> DataType:
    import pandas as pd

    dt = series.dtype
    if pd.api.types.is_datetime64_any_dtype(dt):
        return DataType.DateTime
    if pd.api.types.is_float_dtype(dt):
        return DataType.Float32 if str(dt).endswith("32") else DataType.Float64
    if pd.api.types.is_integer_dtype(dt):
        s = str(dt).lower()
        if s.endswith(("int8", "int16", "int32")) and not s.startswith("uint32"):
            return DataType.Int32
        return DataType.Int64
    if pd.api.types.is_bool_dtype(dt):
        return DataType.Bool
    return DataType.String


def column_from_series(series, name: str = None) -> Column:
    """Build a Column from a pandas Series (bulk, vectorized)."""
    import pandas as pd

    name = name or str(series.name)
    dt = _dtype_for(series)
    col = Column(name, dt)
    nulls = series.isna().to_numpy(dtype=bool)
    n = len(series)
    if dt is DataType.String:
        vals = ["" if nulls[i] else str(v) for i, v in enumerate(series.tolist())]
        col._set_raw(vals, nulls)
        return col
    if dt is DataType.DateTime:
        # epoch milliseconds; nulls get the i64 sentinel
        ns = series.astype("datetime64[ms]", errors="ignore")
        vals = ns.to_numpy(dtype="datetime64[ms]").astype(np.int64)
        vals = np.where(nulls, DataType.DateTime.sentinel, vals)
        col._set_raw(vals, nulls)
        return col
    if dt is DataType.Bool:
        vals = series.to_numpy(dtype=np.bool_, na_value=False)
        col._set_raw(vals, nulls)
        return col
    np_dtype = dt.numpy_dtype
    if nulls.any():
        if dt in (DataType.Int32, DataType.Int64):
            # exact: never route int64 through float64 (2^53 precision cliff)
            vals = series.to_numpy(dtype=np_dtype, na_value=dt.sentinel)
        else:
            filled = series.astype("float64").to_numpy(na_value=np.nan)
            vals = np.where(nulls, dt.sentinel, filled).astype(np_dtype)
    else:
        vals = series.to_numpy(dtype=np_dtype)
    col._set_raw(vals, nulls)
    return col


def columns_from_pandas(df, exclude=()) -> List[Column]:
    return [
        column_from_series(df[name], str(name))
        for name in df.columns
        if name not in exclude
    ]


def builder_from_pandas(df, vectors, exclude=()) -> MetaStoreBuilder:
    """MetaStore builder from a DataFrame + vector array."""
    if len(df) != len(vectors):
        raise OttersError(
            f"dataframe length {len(df)} does not match vectors length "
            f"{len(vectors)}"
        )
    return MetaStore.from_columns(columns_from_pandas(df, exclude)).with_vectors(
        vectors
    )


def builder_from_arrow(table, vectors, exclude=()) -> MetaStoreBuilder:
    """MetaStore builder from a pyarrow Table (e.g. read from Parquet)."""
    return builder_from_pandas(table.to_pandas(), vectors, exclude)


def builder_from_parquet(path: str, vectors, exclude=()) -> MetaStoreBuilder:
    import pyarrow.parquet as pq

    return builder_from_arrow(pq.read_table(path), vectors, exclude)


def results_to_pandas(results):
    """MetaQueryResults -> pandas DataFrame (index, score, metadata columns).

    Null handling mirrors the store: nullable pandas dtypes for ints/bools,
    NaN for floats, None for strings, NaT for datetimes.
    """
    import pandas as pd

    out = {"index": results.indices, "score": results.scores}
    for name in results.columns:
        c = results.data[name]
        nulls = np.asarray(c.null_mask(), dtype=bool)
        if c.dtype is DataType.String:
            vals = c.values()
            out[name] = [
                None if nulls[i] else vals[i] for i in range(len(results))
            ]
        elif c.dtype is DataType.DateTime:
            s = pd.to_datetime(
                pd.Series(np.asarray(c.values(), dtype=np.int64)), unit="ms"
            )
            out[name] = s.mask(nulls)
        elif c.dtype is DataType.Bool:
            arr = pd.array(
                np.asarray(c.values(), dtype=bool), dtype="boolean"
            )
            arr[nulls] = pd.NA
            out[name] = arr
        elif c.dtype in (DataType.Int32, DataType.Int64):
            pd_dtype = "Int32" if c.dtype is DataType.Int32 else "Int64"
            arr = pd.array(np.asarray(c.values()), dtype=pd_dtype)
            arr[nulls] = pd.NA
            out[name] = arr
        else:  # Float32 / Float64
            vals = np.asarray(c.values(), dtype=np.float64).copy()
            vals[nulls] = np.nan
            out[name] = vals
    return pd.DataFrame(out)


def results_to_arrow(results):
    """MetaQueryResults -> pyarrow.Table (via the pandas conversion)."""
    import pyarrow as pa

    return pa.Table.from_pandas(
        results_to_pandas(results), preserve_index=False
    )
