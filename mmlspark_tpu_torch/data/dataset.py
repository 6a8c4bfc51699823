"""Columnar dataset — the port of ``mmlspark_tpu/data/dataset.py``.

The replacement for the reference's Spark DataFrame: columns are
host-resident numpy arrays (numeric columns as typed arrays, vectors as 2-D
arrays, strings/bytes/images/ragged values as object arrays), each carrying a
:class:`~mmlspark_tpu_torch.core.schema.ColumnMeta`. Datasets are immutable
values — every operation returns a new Dataset sharing unchanged column
buffers. The columns stay numpy on the host: the feed
(:mod:`mmlspark_tpu_torch.data.feed`) moves fixed-shape batches to the
card.

``num_partitions`` is kept as a lightweight attribute because several
reference stages expose it in their API surface (Repartition,
PartitionSample's AssignToPartition). pandas is needed by
:meth:`Dataset.to_pandas` only, and imported there.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

from mmlspark_tpu_torch.core.exceptions import SchemaError
from mmlspark_tpu_torch.core.schema import ColumnMeta


def _as_column(values: Any) -> np.ndarray:
    """Coerce arbitrary python/numpy input into a column array."""
    if isinstance(values, np.ndarray):
        return values
    if isinstance(values, (list, tuple)):
        # Ragged or non-numeric content becomes an object column; rectangular
        # numeric content becomes a typed (possibly 2-D) array.
        try:
            arr = np.asarray(values)
            # Strings stay object columns (uniform null handling via None).
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

    __slots__ = ("_columns", "_meta", "num_partitions")

    def __init__(
        self,
        columns: Mapping[str, Any],
        meta: Mapping[str, ColumnMeta] | None = None,
        num_partitions: int = 1,
    ):
        cols = {name: _as_column(vals) for name, vals in columns.items()}
        lengths = {name: len(arr) for name, arr in cols.items()}
        if len(set(lengths.values())) > 1:
            raise SchemaError(f"column lengths differ: {lengths}")
        self._columns: dict[str, np.ndarray] = cols
        self._meta: dict[str, ColumnMeta] = {
            name: (meta or {}).get(name, ColumnMeta()) for name in cols
        }
        self.num_partitions = max(1, int(num_partitions))

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_pandas(df, meta: Mapping[str, ColumnMeta] | None = None) -> "Dataset":
        cols = {}
        for name in df.columns:
            s = df[name]
            if s.dtype == object or str(s.dtype).startswith(("string", "str")):
                cols[name] = _as_column(list(s))
            else:
                cols[name] = s.to_numpy()
        return Dataset(cols, meta)

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(
            {
                name: (list(arr) if arr.ndim > 1 else arr)
                for name, arr in self._columns.items()
            }
        )

    @staticmethod
    def concat(datasets: Sequence["Dataset"]) -> "Dataset":
        """Row-wise union (reference ImageSetAugmenter unions flipped copies,
        ImageSetAugmenter.scala:15-69). Schemas must match; meta comes from the
        first dataset."""
        if not datasets:
            raise SchemaError("concat of zero datasets")
        first = datasets[0]
        names = list(first.columns)
        for d in datasets[1:]:
            if list(d.columns) != names:
                raise SchemaError(
                    f"concat schema mismatch: {names} vs {list(d.columns)}"
                )
        cols = {
            name: np.concatenate([d._columns[name] for d in datasets], axis=0)
            for name in names
        }
        return Dataset(cols, first._meta, first.num_partitions)

    # -- basic accessors ----------------------------------------------------

    @property
    def columns(self) -> list[str]:
        return list(self._columns)

    @property
    def num_rows(self) -> int:
        if not self._columns:
            return 0
        return len(next(iter(self._columns.values())))

    def __len__(self) -> int:
        return self.num_rows

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self.column(name)

    def column(self, name: str) -> np.ndarray:
        if name not in self._columns:
            raise SchemaError(f"no column '{name}'; have {self.columns}")
        return self._columns[name]

    def meta_of(self, name: str) -> ColumnMeta:
        if name not in self._meta:
            raise SchemaError(f"no column '{name}'; have {self.columns}")
        return self._meta[name]

    def require(self, *names: str) -> None:
        missing = [n for n in names if n not in self._columns]
        if missing:
            raise SchemaError(f"missing column(s) {missing}; have {self.columns}")

    def schema(self) -> dict[str, str]:
        """Human-readable column -> type summary."""
        out = {}
        for name, arr in self._columns.items():
            if arr.dtype == object:
                kind = type(arr[0]).__name__ if len(arr) else "object"
                out[name] = f"object<{kind}>"
            elif arr.ndim > 1:
                out[name] = f"{arr.dtype.name}{list(arr.shape[1:])}"
            else:
                out[name] = arr.dtype.name
        return out

    # -- transformations (all return new Datasets) --------------------------

    def _replace(
        self,
        columns: dict[str, np.ndarray] | None = None,
        meta: dict[str, ColumnMeta] | None = None,
    ) -> "Dataset":
        ds = Dataset.__new__(Dataset)
        ds._columns = dict(self._columns if columns is None else columns)
        base_meta = dict(self._meta if meta is None else meta)
        ds._meta = {n: base_meta.get(n, ColumnMeta()) for n in ds._columns}
        ds.num_partitions = self.num_partitions
        return ds

    def select(self, *names: str) -> "Dataset":
        self.require(*names)
        return self._replace(
            {n: self._columns[n] for n in names},
            {n: self._meta[n] for n in names},
        )

    def drop(self, *names: str) -> "Dataset":
        return self._replace(
            {n: a for n, a in self._columns.items() if n not in names}
        )

    def rename(self, mapping: Mapping[str, str]) -> "Dataset":
        cols: dict[str, np.ndarray] = {}
        meta: dict[str, ColumnMeta] = {}
        for n, a in self._columns.items():
            new = mapping.get(n, n)
            if new in cols:
                raise SchemaError(f"rename collision: two columns map to '{new}'")
            cols[new] = a
            meta[new] = self._meta[n]
        return self._replace(cols, meta)

    def with_column(
        self, name: str, values: Any, meta: ColumnMeta | None = None
    ) -> "Dataset":
        arr = _as_column(values)
        if self._columns and len(arr) != self.num_rows:
            raise SchemaError(
                f"with_column('{name}'): length {len(arr)} != {self.num_rows}"
            )
        cols = dict(self._columns)
        replacing = name in cols
        cols[name] = arr
        metas = dict(self._meta)
        # Replacing a column's values invalidates its old metadata; callers
        # that want to keep tags must pass meta explicitly.
        if meta is not None:
            metas[name] = meta
        elif replacing or name not in metas:
            metas[name] = ColumnMeta()
        return self._replace(cols, metas)

    def with_meta(self, name: str, meta: ColumnMeta) -> "Dataset":
        self.require(name)
        metas = dict(self._meta)
        metas[name] = meta
        return self._replace(None, metas)

    def with_partitions(self, n: int) -> "Dataset":
        ds = self._replace()
        ds.num_partitions = max(1, int(n))
        return ds

    def gather(self, indices: np.ndarray) -> "Dataset":
        """Row selection by integer index array."""
        idx = np.asarray(indices)
        return self._replace({n: a[idx] for n, a in self._columns.items()})

    def filter(self, mask: np.ndarray) -> "Dataset":
        mask = np.asarray(mask, dtype=bool)
        if len(mask) != self.num_rows:
            raise SchemaError("filter mask length mismatch")
        return self.gather(np.nonzero(mask)[0])

    def take(self, n: int) -> "Dataset":
        return self.gather(np.arange(min(n, self.num_rows)))

    def sample(
        self,
        fraction: float | None = None,
        n: int | None = None,
        seed: int = 0,
        replace: bool = False,
    ) -> "Dataset":
        rng = np.random.default_rng(seed)
        total = self.num_rows
        if n is None:
            n = int(round((fraction or 0.0) * total))
        n = min(n, total) if not replace else n
        idx = rng.choice(total, size=n, replace=replace)
        return self.gather(np.sort(idx))

    def shuffle(self, seed: int = 0) -> "Dataset":
        rng = np.random.default_rng(seed)
        return self.gather(rng.permutation(self.num_rows))

    def random_split(
        self, fraction: float, seed: int = 0
    ) -> tuple["Dataset", "Dataset"]:
        """Disjoint (first, second) split with ``fraction`` of the rows
        in the first part — the train/test split idiom (Spark's
        ``randomSplit``)."""
        order = np.random.default_rng(seed).permutation(self.num_rows)
        cut = int(round(fraction * self.num_rows))
        return self.gather(order[:cut]), self.gather(order[cut:])

    def map_column(
        self,
        name: str,
        fn: Callable[[Any], Any],
        output: str | None = None,
        meta: ColumnMeta | None = None,
    ) -> "Dataset":
        """Row-wise column map on the host (the reference's per-row UDF
        pattern). Used only for genuinely host-side work (decode, string ops);
        numeric work should be vectorized or on-device instead."""
        arr = self.column(name)
        vals = [fn(v) for v in arr]
        return self.with_column(output or name, vals, meta)

    def iter_rows(self) -> Iterable[dict[str, Any]]:
        names = self.columns
        for i in range(self.num_rows):
            yield {n: self._columns[n][i] for n in names}

    def __repr__(self) -> str:
        return (
            f"Dataset({self.num_rows} rows x {len(self._columns)} cols: "
            f"{self.schema()})"
        )
