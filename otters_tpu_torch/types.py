"""Core enums and small value types.

Core types of the reference, as the JAX package defines them:
- ``DataType``   <-> reference ``src/type_utils.rs:11-19``
- ``Metric``     <-> ``src/vec.rs:11-16``
- ``TakeType``   <-> ``src/vec.rs:18-22``
- ``Cmp``        <-> ``src/vec.rs:24-31`` (score filters)
- ``CmpOp``      <-> ``src/expr.rs:83-91`` (metadata predicates)
- ``SearchResult`` <-> ``src/vec.rs:33-53``

The CUDA device has native int64 and float64, so 64-bit columns live on the
device in their own type (see ``otters_tpu_torch.ops.zonemap``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class DataType(enum.Enum):
    Int32 = "Int32"
    Int64 = "Int64"
    Float32 = "Float32"
    Float64 = "Float64"
    String = "String"
    DateTime = "DateTime"
    # beyond the reference (its "More Metadata Types" roadmap item):
    # stored as a bool array + null mask; device repr int32 0/1, so zonemap
    # min/max pruning works (all-False chunk prunes eq(True) etc.)
    Bool = "Bool"

    def __repr__(self) -> str:  # match Rust Debug formatting used in messages
        return self.value

    @property
    def numpy_dtype(self):
        """Host-side storage dtype (sentinel + null-mask scheme, col.rs:238-326)."""
        return _NUMPY_DTYPES[self]

    @property
    def sentinel(self):
        """Value stored for nulls (reference col.rs:242,257,272,287,302,317)."""
        return _SENTINELS[self]

    @property
    def is_numeric(self) -> bool:
        return self not in (DataType.String,)


_NUMPY_DTYPES = {
    DataType.Int32: np.int32,
    DataType.Int64: np.int64,
    DataType.Float32: np.float32,
    DataType.Float64: np.float64,
    DataType.String: object,
    DataType.DateTime: np.int64,
    DataType.Bool: np.bool_,
}

_SENTINELS = {
    DataType.Int32: np.int32(np.iinfo(np.int32).min),
    DataType.Int64: np.int64(np.iinfo(np.int64).min),
    DataType.Float32: np.float32("nan"),
    DataType.Float64: np.float64("nan"),
    DataType.String: "",
    DataType.DateTime: np.int64(np.iinfo(np.int64).min),
    DataType.Bool: np.False_,
}


class Metric(enum.Enum):
    Cosine = "Cosine"
    Euclidean = "Euclidean"  # squared euclidean, like the reference
    DotProduct = "DotProduct"
    # Beyond the reference (its "More Metrics" roadmap item: Manhattan,
    # Hamming, Jaccard). None has a matmul form, so they run on the VPU:
    # supported and exact, but slower than the matmul metrics at scale.
    Manhattan = "Manhattan"
    # count of unequal components (a distance; for 0/1 vectors this is the
    # classic bit-level Hamming distance)
    Hamming = "Hamming"
    # weighted Jaccard similarity sum(min)/sum(max) over non-negative
    # vectors (0 when both are all-zero); for 0/1 vectors this is
    # |intersection| / |union|
    Jaccard = "Jaccard"


class TakeType(enum.Enum):
    Min = "Min"
    Max = "Max"


class Cmp(enum.Enum):
    """Score-filter comparator (vec_filter / filter)."""

    Lt = "Lt"
    Gt = "Gt"
    Lte = "Lte"
    Gte = "Gte"
    Eq = "Eq"


class CmpOp(enum.Enum):
    """Metadata predicate comparator (expression DSL).

    Contains / StartsWith / EndsWith extend the reference (its roadmap item
    "more string filters"); they apply to String columns only.
    """

    Eq = "Eq"
    Neq = "Neq"
    Lt = "Lt"
    Lte = "Lte"
    Gt = "Gt"
    Gte = "Gte"
    Contains = "Contains"
    StartsWith = "StartsWith"
    EndsWith = "EndsWith"
    Fuzzy = "Fuzzy"  # bounded edit distance (rhs = (pattern, max_dist))
    # negated string predicates, produced by `~expr` De Morgan push-down;
    # like the reference's Neq they never select null rows
    NotContains = "NotContains"
    NotStartsWith = "NotStartsWith"
    NotEndsWith = "NotEndsWith"
    NotFuzzy = "NotFuzzy"
    # null predicates (any column dtype; the only ops that can SELECT nulls)
    IsNull = "IsNull"
    IsNotNull = "IsNotNull"


STRING_EXTENDED_OPS = (
    CmpOp.Contains, CmpOp.StartsWith, CmpOp.EndsWith, CmpOp.Fuzzy,
    CmpOp.NotContains, CmpOp.NotStartsWith, CmpOp.NotEndsWith,
    CmpOp.NotFuzzy,
)

NULL_OPS = (CmpOp.IsNull, CmpOp.IsNotNull)

NEGATED_STRING_OPS = (
    CmpOp.NotContains,
    CmpOp.NotStartsWith,
    CmpOp.NotEndsWith,
    CmpOp.NotFuzzy,
)

# total involution: the comparator of `~leaf` under nulls-excluded semantics
# (matches the reference's convention that value predicates never select
# nulls, meta_compute.rs:194-232 — so ~eq(v) == neq(v), SQL-style)
NEGATED_CMP = {
    CmpOp.Eq: CmpOp.Neq,
    CmpOp.Neq: CmpOp.Eq,
    CmpOp.Lt: CmpOp.Gte,
    CmpOp.Lte: CmpOp.Gt,
    CmpOp.Gt: CmpOp.Lte,
    CmpOp.Gte: CmpOp.Lt,
    CmpOp.Contains: CmpOp.NotContains,
    CmpOp.NotContains: CmpOp.Contains,
    CmpOp.StartsWith: CmpOp.NotStartsWith,
    CmpOp.NotStartsWith: CmpOp.StartsWith,
    CmpOp.EndsWith: CmpOp.NotEndsWith,
    CmpOp.NotEndsWith: CmpOp.EndsWith,
    CmpOp.Fuzzy: CmpOp.NotFuzzy,
    CmpOp.NotFuzzy: CmpOp.Fuzzy,
    CmpOp.IsNull: CmpOp.IsNotNull,
    CmpOp.IsNotNull: CmpOp.IsNull,
}


# metrics with no matmul form: excluded from the fused kernel
VPU_METRICS = (Metric.Manhattan, Metric.Hamming, Metric.Jaccard)


def default_take_type(metric: Metric) -> TakeType:
    """Distances -> Min, similarities -> Max (vec.rs:93-98)."""
    if metric in (Metric.Euclidean, Metric.Manhattan, Metric.Hamming):
        return TakeType.Min
    return TakeType.Max


@dataclass(frozen=True)
class SearchResult:
    index: int
    score: float

    def __str__(self) -> str:
        return f"#{self.index} score={self.score:.6f}"

    @classmethod
    def from_tuple(cls, t) -> "SearchResult":
        return cls(index=int(t[0]), score=float(t[1]))
