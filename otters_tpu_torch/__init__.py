"""otters-tpu on PyTorch and CUDA: exact vector search with metadata pruning.

The port of the JAX package ``otters_tpu`` to an NVIDIA H100 (Hopper). It
imports torch and never JAX. Stores run on the current CUDA device unless
the builder names another (``MetaStoreBuilder.with_device("cpu")``).

This slice runs the certified int8 filtered MetaStore path end to end: the
builder, zonemap / Bloom pruning, the hand-written Hopper kernel for the
certified-cosine bin maxima (``csrc/cert_cos_binmax.cu``), the exact f32
rerank with its certificate, and pipelined ``collect_async`` / ``resolve``.
"""

from .column import Column
from .errors import (
    ColumnError,
    ColumnParseError,
    ColumnTypeMismatch,
    ExprError,
    InvalidComparison,
    InvalidExpression,
    OttersError,
    TypeMismatch,
    UnknownColumn,
    UnsupportedStringOp,
)
from .expr import CompiledFilter, Expr, col, lit
from .meta import (
    MetaBuildStats,
    MetaQueryPlan,
    MetaQueryResults,
    MetaQueryStats,
    MetaStore,
    MetaStoreBuilder,
    resolve,
)
from .types import Cmp, CmpOp, DataType, Metric, TakeType

__version__ = "0.1.0"

__all__ = [
    "Column",
    "ColumnError",
    "ColumnParseError",
    "ColumnTypeMismatch",
    "ExprError",
    "InvalidComparison",
    "InvalidExpression",
    "OttersError",
    "TypeMismatch",
    "UnknownColumn",
    "UnsupportedStringOp",
    "CompiledFilter",
    "Expr",
    "col",
    "lit",
    "MetaBuildStats",
    "MetaQueryPlan",
    "MetaQueryResults",
    "MetaQueryStats",
    "MetaStore",
    "MetaStoreBuilder",
    "resolve",
    "Cmp",
    "CmpOp",
    "DataType",
    "Metric",
    "TakeType",
]
