"""ValueIndexer / IndexToValue — typed categorical indexing, the port of
``mmlspark_tpu/stages/value_indexer.py`` (host numpy, unchanged).

Reference: value-indexer/src/main/scala/ValueIndexer.scala (typed
StringIndexer generalization: distinct + null-aware sort of levels ->
categorical metadata; :37-47,63-82,140-149) and IndexToValue.scala:26-48
(inverse transform back to the original type via the metadata).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.schema import CategoricalMeta, ColumnMeta
from mmlspark_tpu_torch.core.stage import Estimator, Model, Transformer
from mmlspark_tpu_torch.data.dataset import Dataset


def _is_missing(v) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    return False


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Learn distinct levels of a column (any dtype) and map to indices.

    Null-aware: missing values get the trailing level index (reference
    null-ordering, ValueIndexer.scala:37-47)."""

    def _fit(self, dataset: Dataset) -> "ValueIndexerModel":
        dataset.require(self.input_col)
        arr = dataset[self.input_col]
        present = [v for v in arr if not _is_missing(v)]
        has_null = len(present) < len(arr)
        try:
            levels = sorted(set(present))
        except TypeError:
            raise FriendlyError(
                f"column '{self.input_col}' mixes unorderable types", self.uid
            )
        return ValueIndexerModel(
            input_col=self.input_col,
            output_col=self.output_col,
            levels=list(levels),
            has_null=has_null,
        )


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = Param("ordered category levels", default=list)
    has_null = Param("whether a trailing null level exists", False, ptype=bool)

    def categorical_meta(self) -> CategoricalMeta:
        return CategoricalMeta(tuple(self.levels), has_null=self.has_null)

    def _transform(self, dataset: Dataset) -> Dataset:
        dataset.require(self.input_col)
        lookup = {lvl: i for i, lvl in enumerate(self.levels)}
        null_index = len(self.levels)
        out = np.empty(dataset.num_rows, dtype=np.int32)
        for i, v in enumerate(dataset[self.input_col]):
            if _is_missing(v):
                if not self.has_null:
                    raise FriendlyError(
                        f"unseen null in '{self.input_col}' (no null level)",
                        self.uid,
                    )
                out[i] = null_index
            elif v in lookup:
                out[i] = lookup[v]
            else:
                raise FriendlyError(
                    f"unseen level {v!r} in column '{self.input_col}'", self.uid
                )
        meta = ColumnMeta(categorical=self.categorical_meta())
        return dataset.with_column(self.output_col, out, meta)


class IndexToValue(Transformer, HasInputCol, HasOutputCol):
    """Inverse of ValueIndexerModel using the column's categorical metadata
    (zero-config — reference IndexToValue.scala:26-48)."""

    def _transform(self, dataset: Dataset) -> Dataset:
        dataset.require(self.input_col)
        cat = dataset.meta_of(self.input_col).categorical
        if cat is None:
            raise FriendlyError(
                f"column '{self.input_col}' has no categorical metadata",
                self.uid,
            )
        levels = list(cat.levels)
        null_index = len(levels)
        values = []
        for idx in dataset[self.input_col]:
            idx = int(idx)
            if idx == null_index and cat.has_null:
                values.append(None)
            elif 0 <= idx < len(levels):
                values.append(levels[idx])
            else:
                raise FriendlyError(
                    f"index {idx} out of range for {len(levels)} levels",
                    self.uid,
                )
        return dataset.with_column(self.output_col, values)
