"""EnsembleByKey — group-by-key aggregation of score/vector columns.

Reference: ensemble/src/main/scala/EnsembleByKey.scala:21-203 (group by key
columns, mean of scalar and vector columns — vector average via UDAF —
optional collapse to one row per key).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.data.dataset import Dataset


class EnsembleByKey(Transformer):
    keys = Param("grouping key columns", default=list)
    cols = Param("columns to average", default=list)
    col_names = Param("output names (default '<col>_avg')")
    strategy = Param("aggregation strategy", "mean", domain=("mean",))
    collapse_group = Param("one row per key (vs broadcast back)", True,
                           ptype=bool)

    def _transform(self, dataset: Dataset) -> Dataset:
        if not self.keys or not self.cols:
            raise FriendlyError("keys and cols are required", self.uid)
        dataset.require(*self.keys, *self.cols)
        out_names = self.col_names or [f"{c}_avg" for c in self.cols]
        if len(out_names) != len(self.cols):
            raise FriendlyError("col_names must pair with cols", self.uid)

        key_tuples = list(
            zip(*[dataset[k] for k in self.keys])
        )
        groups: dict[tuple, list[int]] = {}
        for i, kt in enumerate(key_tuples):
            groups.setdefault(kt, []).append(i)

        # mean per group for each column (vectors via row-stack mean)
        means: dict[str, dict[tuple, np.ndarray]] = {}
        for c in self.cols:
            col = dataset[c]
            per = {}
            for kt, idxs in groups.items():
                vals = [np.asarray(col[i], dtype=np.float64) for i in idxs]
                per[kt] = np.mean(np.stack(vals), axis=0)
            means[c] = per

        if self.collapse_group:
            uniq = list(groups)
            cols: dict[str, list] = {
                k: [kt[j] for kt in uniq] for j, k in enumerate(self.keys)
            }
            for c, name in zip(self.cols, out_names):
                vals = [means[c][kt] for kt in uniq]
                arr = np.stack(vals)
                cols[name] = arr if arr.ndim > 1 else arr.ravel()
            return Dataset(cols)

        out = dataset
        for c, name in zip(self.cols, out_names):
            vals = [means[c][kt] for kt in key_tuples]
            arr = np.stack(vals)
            out = out.with_column(name, arr if arr.ndim > 1 else arr.ravel())
        return out
