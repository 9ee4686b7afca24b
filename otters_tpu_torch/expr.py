"""Expression DSL for metadata filtering and its CNF compiler.

Mirrors the reference DSL (src/expr.rs): build predicates with ``col("x")``
and combine with ``&`` (AND) / ``|`` (OR); ``compile(schema)`` type-checks and
lowers to a ``CompiledFilter`` whose ``clauses`` are an AND of OR-clauses
(``[[A, B], [C]]`` == ``(A OR B) AND C`` — expr.rs:213-220).

Examples (the reference's doc examples, expr.rs:11-22):

>>> from otters_tpu_torch import col
>>> e1 = col("price").lte(40.0) & col("version").gte(2)
>>> e2 = (col("age").lt(18) | col("age").gt(65)) & col("name").neq("alice")
>>> e3 = col("grade").eq("A") | col("grade").eq("B")
>>> from otters_tpu_torch import DataType
>>> schema = {"grade": DataType.String}
>>> [len(clause) for clause in e3.compile(schema).clauses]
[2]

Lowering rules (expr.rs:345-372):
- Cmp leaf  -> ``[[filter]]``
- And(a, b) -> clause-list concatenation (expr.rs:474-483)
- Or(a, b)  -> cross-product distribution (expr.rs:494-511)
- tautology clauses ``(col == v) OR (col != v)`` dropped (expr.rs:302-343)

Type rules (expr.rs:385-466): String only Eq/Neq; Int32/Int64 require integer
literals; Float32/Float64 widen integer literals to float; DateTime requires a
parseable datetime string stored as epoch-millis i64.

The compiled plan is host-side metadata: MetaStore lowers it further into
device predicate tensors (see otters_tpu_torch/ops/predicate.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Union

import numpy as np

from .column import parse_datetime
from .errors import (
    ColumnParseError,
    InvalidComparison,
    InvalidExpression,
    TypeMismatch,
    UnknownColumn,
    UnsupportedStringOp,
)
from .types import CmpOp, DataType, NEGATED_CMP

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Literal:
    """Tagged literal: kind in {'i64', 'f64', 'str'} (expr.rs:44-49)."""

    kind: str
    value: Union[int, float, str]


def _to_literal(v) -> Literal:
    if isinstance(v, Literal):
        return v
    if isinstance(v, (bool, np.bool_)):
        # Bool columns extend the reference; bool literals only match them
        # (an int column still rejects True with TypeMismatch, like the
        # reference rejects bools outright)
        return Literal("bool", bool(v))
    if isinstance(v, (int, np.integer)):
        return Literal("i64", int(v))
    if isinstance(v, (float, np.floating)):
        return Literal("f64", float(v))
    if isinstance(v, str):
        return Literal("str", v)
    raise InvalidExpression()


class Expr:
    """Expression node. Subclasses: ColumnRef, LiteralExpr, CmpExpr, And, Or."""

    # comparison builders (expr.rs:118-166)
    def eq(self, v) -> "Expr":
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.Eq)

    def neq(self, v) -> "Expr":
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.Neq)

    def lt(self, v) -> "Expr":
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.Lt)

    def lte(self, v) -> "Expr":
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.Lte)

    def gt(self, v) -> "Expr":
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.Gt)

    def gte(self, v) -> "Expr":
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.Gte)

    def contains(self, v) -> "Expr":
        """String column contains substring (extends the reference)."""
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.Contains)

    def starts_with(self, v) -> "Expr":
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.StartsWith)

    def ends_with(self, v) -> "Expr":
        return CmpExpr(self, LiteralExpr(_to_literal(v)), CmpOp.EndsWith)

    def fuzzy(self, v, max_dist: int = 1) -> "Expr":
        """String column within ``max_dist`` edits of ``v`` (bounded
        Levenshtein over UTF-8 bytes; the reference roadmap's "fuzzy
        matching"). ``max_dist`` is clamped to 16."""
        if not isinstance(v, str):
            raise InvalidExpression()
        try:
            dist = max(0, min(int(max_dist), 16))
        except (TypeError, ValueError):
            raise InvalidExpression() from None
        return CmpExpr(
            self,
            LiteralExpr(Literal("fuzzy", (v, dist))),
            CmpOp.Fuzzy,
        )

    def is_null(self) -> "Expr":
        """Row's value is null (extends the reference; works on any dtype).

        The only predicate (with ``is_not_null``) that can *select* null
        rows — every value comparison excludes them (meta_compute.rs:194-232).
        Chunk pruning uses the zonemap non-null counts: a chunk with no nulls
        is skipped entirely.
        """
        return CmpExpr(self, LiteralExpr(Literal("unit", None)), CmpOp.IsNull)

    def is_not_null(self) -> "Expr":
        """Row's value is not null (extends the reference)."""
        return CmpExpr(
            self, LiteralExpr(Literal("unit", None)), CmpOp.IsNotNull
        )

    def isin(self, values) -> "Expr":
        """Value equals any of ``values`` (extends the reference).

        Sugar for ``eq(v0) | eq(v1) | ...`` — compiles to one OR-clause, so
        zonemap / Bloom pruning applies per value.
        """
        values = list(values)
        if not values:
            raise InvalidExpression()
        expr = self.eq(values[0])
        for v in values[1:]:
            expr = expr | self.eq(v)
        return expr

    def between(self, lo, hi) -> "Expr":
        """Inclusive range ``lo <= value <= hi`` (extends the reference).

        Sugar for ``gte(lo) & lte(hi)``.
        """
        return self.gte(lo) & self.lte(hi)

    def and_(self, other: "Expr") -> "Expr":
        return And(self, other)

    def or_(self, other: "Expr") -> "Expr":
        return Or(self, other)

    def not_(self) -> "Expr":
        """Logical negation (extends the reference, which has no Not).

        Lowered by De Morgan push-down to negated leaves before CNF:
        ``~(a & b) == ~a | ~b``; ``~col.eq(v) == col.neq(v)`` (so, like every
        value predicate, negations never select null rows; negate
        ``is_null()`` to select non-nulls explicitly).
        """
        return Not(self)

    def __and__(self, other: "Expr") -> "Expr":
        return And(self, other)

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, other)

    def __invert__(self) -> "Expr":
        return Not(self)

    def compile(self, schema: Dict[str, DataType]) -> "CompiledFilter":
        """Type-check against `schema` and lower to CNF (expr.rs:290-297)."""
        plan = _lower_to_plan(self, schema)
        return CompiledFilter(clauses=_normalize_plan(plan))


@dataclass(frozen=True)
class ColumnRef(Expr):
    name: str


@dataclass(frozen=True)
class LiteralExpr(Expr):
    literal: Literal


@dataclass(frozen=True)
class CmpExpr(Expr):
    left: Expr
    right: Expr
    op: CmpOp


@dataclass(frozen=True)
class And(Expr):
    left: Expr
    right: Expr


@dataclass(frozen=True)
class Or(Expr):
    left: Expr
    right: Expr


@dataclass(frozen=True)
class Not(Expr):
    inner: Expr


def col(name: str) -> Expr:
    """Column reference builder (expr.rs:109-111)."""
    return ColumnRef(name)


def lit(v) -> Expr:
    """Literal builder (expr.rs:113-115)."""
    return LiteralExpr(_to_literal(v))


# ---------------------------------------------------------------------------
# Compiled plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ColumnFilter:
    """A compiled, typed leaf predicate (expr.rs:199-211).

    kind: 'numeric', 'string', or 'null' (is_null / is_not_null, any dtype).
    rhs_kind: for numeric leaves, 'i64' or 'f64' (NumericLiteral tag).
    """

    kind: str
    column: str
    cmp: CmpOp
    rhs: Union[int, float, str]
    rhs_kind: str = ""

    @property
    def is_numeric(self) -> bool:
        return self.kind == "numeric"


Plan = List[List[ColumnFilter]]


@dataclass(frozen=True)
class CompiledFilter:
    clauses: tuple  # tuple of tuples of ColumnFilter (AND of OR-clauses)

    def structure_key(self):
        """Hashable key identifying the plan *shape* (not thresholds).

        Used to cache lowered device plans: two filters with the same
        column/op structure but different literals share one compilation.
        """
        return tuple(
            tuple((lf.kind, lf.column, lf.cmp, lf.rhs_kind) for lf in clause)
            for clause in self.clauses
        )


def _normalize_plan(plan: Plan) -> tuple:
    """Drop tautology clauses like (col == v) OR (col != v) (expr.rs:302-343)."""
    out = []
    for clause in plan:
        tautology = False
        for lf in clause:
            if lf.cmp is CmpOp.Eq:
                for other in clause:
                    if (
                        other.cmp is CmpOp.Neq
                        and other.kind == lf.kind
                        and other.column == lf.column
                        and other.rhs == lf.rhs
                        and other.rhs_kind == lf.rhs_kind
                    ):
                        tautology = True
                        break
            if tautology:
                break
        if not tautology:
            out.append(tuple(clause))
    return tuple(out)


def _negate(expr: Expr) -> Expr:
    """Push a Not down to the leaves (De Morgan). NEGATED_CMP is a total
    involution over CmpOp, so every well-formed expression negates."""
    if isinstance(expr, Not):
        return expr.inner
    if isinstance(expr, And):
        return Or(_negate(expr.left), _negate(expr.right))
    if isinstance(expr, Or):
        return And(_negate(expr.left), _negate(expr.right))
    if isinstance(expr, CmpExpr):
        return CmpExpr(expr.left, expr.right, NEGATED_CMP[expr.op])
    raise InvalidExpression()


def _lower_to_plan(expr: Expr, schema: Dict[str, DataType]) -> Plan:
    if isinstance(expr, Not):
        return _lower_to_plan(_negate(expr.inner), schema)
    if isinstance(expr, And):
        left = _lower_to_plan(expr.left, schema)
        right = _lower_to_plan(expr.right, schema)
        return left + right  # and_concat_clauses (expr.rs:474-483)
    if isinstance(expr, Or):
        left = _lower_to_plan(expr.left, schema)
        right = _lower_to_plan(expr.right, schema)
        if not left:
            return right
        if not right:
            return left
        # or_distribute_clauses: cross product (expr.rs:494-511)
        return [ca + cb for ca in left for cb in right]
    if isinstance(expr, CmpExpr):
        return [[_compile_cmp_leaf(expr.left, expr.right, expr.op, schema)]]
    raise InvalidExpression()


def _compile_cmp_leaf(
    left: Expr, right: Expr, op: CmpOp, schema: Dict[str, DataType]
) -> ColumnFilter:
    if not (isinstance(left, ColumnRef) and isinstance(right, LiteralExpr)):
        raise InvalidComparison()
    name = left.name
    literal = right.literal
    if name not in schema:
        raise UnknownColumn(name)
    dtype = schema[name]

    from .types import NULL_OPS, STRING_EXTENDED_OPS

    if op in NULL_OPS:
        # null predicates apply to every column dtype
        if literal.kind != "unit":
            raise InvalidComparison()
        return ColumnFilter("null", name, op, None)

    if dtype is DataType.String:
        if op not in (CmpOp.Eq, CmpOp.Neq) + STRING_EXTENDED_OPS:
            raise UnsupportedStringOp(name)
        if op in (CmpOp.Fuzzy, CmpOp.NotFuzzy):
            if literal.kind != "fuzzy":
                raise TypeMismatch(name, dtype, "fuzzy pattern")
            return ColumnFilter("string", name, op, literal.value)
        if literal.kind != "str":
            raise TypeMismatch(name, dtype, "string")
        return ColumnFilter("string", name, op, literal.value)
    if op in STRING_EXTENDED_OPS:
        raise TypeMismatch(name, dtype, "string predicate")

    if dtype is DataType.Bool:
        if literal.kind != "bool":
            got = {"i64": "integer", "f64": "float", "str": "string"}.get(
                literal.kind, literal.kind
            )
            raise TypeMismatch(name, dtype, got)
        if op not in (CmpOp.Eq, CmpOp.Neq):
            raise InvalidComparison()
        return ColumnFilter("numeric", name, op, bool(literal.value), "bool")
    if literal.kind == "bool":
        raise TypeMismatch(name, dtype, "bool")

    if dtype in (DataType.Int32, DataType.Int64):
        if literal.kind == "f64":
            raise TypeMismatch(name, dtype, "float")
        if literal.kind == "str":
            raise TypeMismatch(name, dtype, "string")
        return ColumnFilter("numeric", name, op, int(literal.value), "i64")

    if dtype is DataType.DateTime:
        if literal.kind != "str":
            raise TypeMismatch(name, dtype, "datetime string")
        try:
            millis = parse_datetime(literal.value)
        except ColumnParseError:
            raise TypeMismatch(name, dtype, "datetime string") from None
        return ColumnFilter("numeric", name, op, millis, "i64")

    # Float32 / Float64: widen integer literals (expr.rs:452-464)
    if literal.kind == "str":
        raise TypeMismatch(name, dtype, "string")
    return ColumnFilter("numeric", name, op, float(literal.value), "f64")
