"""Error types for otters-tpu.

Mirrors the reference's error surface (otters-rs):
- ``OttersError``      <-> ``Result<_, String>`` failures (reference
  ``src/vec.rs:170-203``, ``src/meta.rs:151-189``).
- ``ColumnError``      <-> ``src/col.rs:30-34`` (``TypeMismatch`` / ``ParseError``).
- ``ExprError``        <-> ``src/expr.rs:229-263`` with the same five variants.

The reference uses deferred-error builder chains (errors stored and surfaced
only at ``collect()``, ``src/vec.rs:84-90``). In Python we keep that contract:
builder methods never raise; ``collect()`` raises one of these exceptions.
"""

from __future__ import annotations


class OttersError(ValueError):
    """Generic framework error, equivalent to the reference's `Err(String)`."""


class ColumnError(OttersError):
    """Column ingest error (type mismatch or parse failure)."""


class ColumnTypeMismatch(ColumnError):
    def __init__(self, expected, got: str):
        self.expected = expected
        self.got = got
        super().__init__(f"Type mismatch: expected {expected!r}, got {got}")


class ColumnParseError(ColumnError):
    def __init__(self, msg: str):
        super().__init__(f"Parse error: {msg}")


class ExprError(OttersError):
    """Base class for expression-compilation errors (``expr.rs:229-236``)."""


class UnknownColumn(ExprError):
    def __init__(self, column: str):
        self.column = column
        super().__init__(f"Unknown column '{column}'")


class TypeMismatch(ExprError):
    def __init__(self, column: str, dtype, got: str):
        self.column = column
        self.dtype = dtype
        self.got = got
        super().__init__(
            f"Type mismatch for column '{column}': expected {dtype!r}, got literal {got}"
        )


class UnsupportedStringOp(ExprError):
    def __init__(self, column: str):
        self.column = column
        super().__init__(f"Unsupported comparator for string column '{column}'")


class InvalidComparison(ExprError):
    def __init__(self):
        super().__init__(
            "Invalid expression shape for comparison (expect column vs literal)"
        )


class InvalidExpression(ExprError):
    def __init__(self):
        super().__init__(
            "Invalid expression (unexpected literal or column without comparator)"
        )
