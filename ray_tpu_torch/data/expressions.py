"""Column predicate expressions for filter pushdown.

`col("x") > 5` builds a `ColumnPredicate` that executes BOTH ways: as a
vectorized mask over columnar blocks in the executor, and as a
`(column, op, value)` tuple pushed into parquet readers where pyarrow
prunes row groups by statistics before decoding (reference
`python/ray/data/datasource/parquet_datasource.py:214` filter pushdown,
`pyarrow.parquet.read_table(filters=...)`)."""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["col", "ColumnPredicate"]

_OPS = {
    ">": np.greater, ">=": np.greater_equal,
    "<": np.less, "<=": np.less_equal,
    "==": np.equal, "!=": np.not_equal,
}


class ColumnPredicate:
    """One comparison against a column; AND by chaining .filter() calls."""

    def __init__(self, column: str, op: str, value: Any):
        if op not in _OPS:
            raise ValueError(f"unsupported predicate op {op!r}")
        self.column = column
        self.op = op
        self.value = value

    def as_tuple(self):
        """pyarrow read_table(filters=...) form."""
        return (self.column, "=" if self.op == "==" else self.op, self.value)

    def mask(self, block: dict) -> np.ndarray:
        return _OPS[self.op](np.asarray(block[self.column]), self.value)

    def __call__(self, row: dict) -> bool:
        return bool(_OPS[self.op](row[self.column], self.value))

    def __repr__(self):
        return f"col({self.column!r}) {self.op} {self.value!r}"


class _Col:
    def __init__(self, name: str):
        self._name = name

    def __gt__(self, v):
        return ColumnPredicate(self._name, ">", v)

    def __ge__(self, v):
        return ColumnPredicate(self._name, ">=", v)

    def __lt__(self, v):
        return ColumnPredicate(self._name, "<", v)

    def __le__(self, v):
        return ColumnPredicate(self._name, "<=", v)

    def __eq__(self, v):  # noqa: E501 — expression builder, not identity
        return ColumnPredicate(self._name, "==", v)

    def __ne__(self, v):
        return ColumnPredicate(self._name, "!=", v)

    __hash__ = None


def col(name: str) -> _Col:
    """Column reference for predicate expressions: `col("x") > 5`."""
    return _Col(name)
