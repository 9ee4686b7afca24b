"""ASCII table rendering for heads, results, and stats.

Host-side observability layer, mirroring the reference ``src/display.rs``:
``AsciiTable`` (display.rs:12-99), cell formatting (floats %.4f, datetimes
``%Y-%m-%d %H:%M:%S UTC``, NULL — display.rs:102-123), ``metastore_head``
(display.rs:126-162), results tables (display.rs:164-188), and the build /
query stats tables with milliseconds at %.3f (display.rs:197-249).
"""

from __future__ import annotations

import datetime as _dt
from typing import List, Optional

from .column import Column
from .types import DataType


class AsciiTable:
    def __init__(self, headers: List[str], rows: List[List[str]]):
        self.headers = headers
        self.rows = rows
        self.title: Optional[str] = None

    def with_title(self, title: str) -> "AsciiTable":
        self.title = title
        return self

    def render(self) -> str:
        if not self.headers:
            return ""
        cols = len(self.headers)
        widths = [len(h) for h in self.headers]
        for row in self.rows:
            for i, cell in enumerate(row[:cols]):
                widths[i] = max(widths[i], len(cell))

        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = []
        if self.title:
            out.append(self.title)
        out.append(sep)
        out.append(
            "|"
            + "|".join(
                f" {h}{' ' * (widths[i] - len(h) + 1)}"
                for i, h in enumerate(self.headers)
            )
            + "|"
        )
        out.append(sep)
        for row in self.rows:
            cells = []
            for i in range(cols):
                cell = row[i] if i < len(row) else ""
                cells.append(f" {cell}{' ' * (widths[i] - len(cell) + 1)}")
            out.append("|" + "|".join(cells) + "|")
        out.append(sep)
        return "\n".join(out)

    def __str__(self) -> str:
        return self.render()


def format_cell(col: Column, i: int) -> str:
    nulls = col.null_mask()
    if i < len(nulls) and bool(nulls[i]):
        return "NULL"
    dt = col.dtype
    if dt is DataType.Int32 or dt is DataType.Int64:
        return str(int(col.values()[i]))
    if dt is DataType.Float32 or dt is DataType.Float64:
        return f"{float(col.values()[i]):.4f}"
    if dt is DataType.String:
        return col.values()[i]
    if dt is DataType.Bool:
        return "true" if col.values()[i] else "false"
    # DateTime
    ms = int(col.values()[i])
    try:
        return _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc).strftime(
            "%Y-%m-%d %H:%M:%S UTC"
        )
    except (OverflowError, OSError, ValueError):
        return str(ms)


def metastore_head(meta, n: int) -> str:
    cols = sorted(meta.schema().keys())
    columns = meta.columns()
    total_rows = len(next(iter(columns.values()))) if columns else meta.n_rows
    limit = min(total_rows, n)
    headers = ["index"] + cols
    rows = []
    for i in range(limit):
        row = [str(i)]
        for name in cols:
            c = columns.get(name)
            row.append(format_cell(c, i) if c is not None else "")
        rows.append(row)
    return (
        AsciiTable(headers, rows)
        .with_title(
            f"MetaStore • rows={total_rows} • chunks={meta.n_chunks()} "
            f"• chunk_size={meta.chunk_size()}"
        )
        .render()
    )


def format_build_stats(b) -> str:
    rows = [
        ["rows", str(b.n_rows)],
        ["dimensions", str(b.dim)],
        ["chunks", str(b.n_chunks)],
        ["vector_ingest_ms", f"{b.vectors_ingest_duration * 1000.0:.3f}"],
        ["zonemap_build_ms", f"{b.zonemap_build_duration * 1000.0:.3f}"],
        ["build_total_ms", f"{b.build_total_duration * 1000.0:.3f}"],
    ]
    return str(
        AsciiTable(["metric", "value"], rows).with_title("MetaStore Build Stats")
    )


def format_query_stats(s) -> str:
    rows = [
        ["total_chunks", str(s.total_chunks)],
        ["pruned_chunks", str(s.pruned_chunks)],
        ["evaluated_chunks", str(s.evaluated_chunks)],
        ["vectors_compared", str(s.vectors_compared)],
        ["prune_ms", f"{s.prune_duration * 1000.0:.3f}"],
        ["score_ms", f"{s.score_duration * 1000.0:.3f}"],
        ["merge_ms", f"{s.merge_duration * 1000.0:.3f}"],
        ["total_ms", f"{s.total_duration * 1000.0:.3f}"],
    ]
    return str(
        AsciiTable(["metric", "value"], rows).with_title("Last Meta Query Stats")
    )
