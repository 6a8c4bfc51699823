"""Columnar dataset — the part of ``mmlspark_tpu/data/dataset.py`` the
batch feed needs: an immutable table of named, host-resident numpy
columns of one length. Column metadata, partitions and the relational
operations wait for the stage layer (ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from mmlspark_tpu_torch.core.exceptions import SchemaError


def _as_column(values: Any) -> np.ndarray:
    """Coerce python/numpy input into a column array: rectangular numeric
    content becomes a typed array, anything else an object column."""
    if isinstance(values, np.ndarray):
        return values
    if isinstance(values, (list, tuple)):
        try:
            arr = np.asarray(values)
            if arr.dtype != object and arr.dtype.kind in "biufcM?":
                return arr
        except (ValueError, TypeError):
            pass
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    raise SchemaError(f"cannot build a column from {type(values).__name__}")


class Dataset:
    """An immutable, named-column, host-resident table."""

    __slots__ = ("_columns",)

    def __init__(self, columns: Mapping[str, Any]):
        cols = {name: _as_column(vals) for name, vals in columns.items()}
        lengths = {name: len(arr) for name, arr in cols.items()}
        if len(set(lengths.values())) > 1:
            raise SchemaError(f"column lengths differ: {lengths}")
        self._columns: dict[str, np.ndarray] = cols

    @property
    def columns(self) -> list[str]:
        return list(self._columns)

    @property
    def num_rows(self) -> int:
        if not self._columns:
            return 0
        return len(next(iter(self._columns.values())))

    def column(self, name: str) -> np.ndarray:
        if name not in self._columns:
            raise SchemaError(f"no column '{name}'; have {self.columns}")
        return self._columns[name]

    def require(self, *names: str) -> None:
        missing = [n for n in names if n not in self._columns]
        if missing:
            raise SchemaError(
                f"missing column(s) {missing}; have {self.columns}")
