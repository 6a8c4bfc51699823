"""Featurize / AssembleFeatures — automatic feature assembly, the port of
``mmlspark_tpu/stages/featurize.py``: pure numpy, its feature matrices
bit-equal to the JAX package's.

Reference: featurize/src/main/scala/Featurize.scala:24-108 (one-param-map
façade, defaults 2^18 hashed features, 2^12 for tree/NN learners) and
AssembleFeatures.scala:76-459 — per-column dispatch by type:

- numeric -> cast double
- string  -> tokenize + hashing-TF, then **count-based slot selection**: the
  union of non-zero hash slots over the fit data (the BitSet trick,
  AssembleFeatures.scala:241-258) keeps the dense dim small — exactly the
  property an accelerator wants (SURVEY.md §7 "sparse features" hard part);
  here the selected slots become a dense float block.
- categorical (ValueIndexer metadata) -> one-hot (OHE skipped for tree
  learners, TrainClassifier.scala:107)
- date/timestamp -> engineered vector (AssembleFeatures.scala:371-400)
- image rows -> (height, width, pixel...) vector (:401-410)
- vectors pass through
- rows with missing values dropped (FastVectorAssembler NA-drop semantics)
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import Param, positive
from mmlspark_tpu_torch.core.schema import ImageRow
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.utils.text import hash_token as _hash_token
from mmlspark_tpu_torch.utils.text import tokenize as _shared_tokenize

#: distinct-value memoization bound shared by the fit-path dedup set and
#: the transform-path row cache — past it, mostly-distinct free text
#: degrades to the uncached per-row cost instead of growing memory
_TEXT_CACHE_CAP = 4096

DEFAULT_NUM_FEATURES = 1 << 18  # Featurize.scala:13
TREE_NN_NUM_FEATURES = 1 << 12  # Featurize.scala:19

_NUMERIC = "numeric"
_CATEGORICAL = "categorical"
_TEXT = "text"
_DATETIME = "datetime"
_IMAGE = "image"
_VECTOR = "vector"


def _tokenize(value: str) -> list[str]:
    return _shared_tokenize(value)


def _column_kind(dataset: Dataset, name: str) -> str:
    arr = dataset.column(name)
    meta = dataset.meta_of(name)
    if meta.categorical is not None:
        return _CATEGORICAL
    if meta.image is not None:
        return _IMAGE
    if arr.dtype == object:
        first = next((v for v in arr if v is not None), None)
        if isinstance(first, str):
            return _TEXT
        if isinstance(first, ImageRow):
            return _IMAGE
        if isinstance(first, np.ndarray):
            return _VECTOR
        raise FriendlyError(
            f"cannot featurize column '{name}' of {type(first).__name__}"
        )
    if arr.dtype.kind == "M":
        return _DATETIME
    if arr.ndim > 1:
        return _VECTOR
    if arr.dtype.kind in "biuf":
        return _NUMERIC
    raise FriendlyError(f"cannot featurize column '{name}' ({arr.dtype})")


def _datetime_features(arr: np.ndarray) -> np.ndarray:
    """Engineered calendar vector (reference AssembleFeatures.scala:371-400:
    year/day-of-week/month/day-of-month + time parts)."""
    import pandas as pd

    s = pd.to_datetime(pd.Series(arr))
    cols = [
        s.dt.year,
        s.dt.dayofweek,
        s.dt.month,
        s.dt.day,
        s.dt.hour,
        s.dt.minute,
        s.dt.second,
    ]
    return np.stack([c.to_numpy(dtype=np.float64) for c in cols], axis=1)


def _image_features(arr: np.ndarray) -> np.ndarray:
    rows = []
    for v in arr:
        if not isinstance(v, ImageRow):
            raise FriendlyError("image column holds non-image values")
        rows.append(
            np.concatenate(
                [[v.height, v.width], v.data.reshape(-1).astype(np.float64)]
            )
        )
    shapes = {r.shape for r in rows}
    if len(shapes) > 1:
        raise FriendlyError(
            "images differ in size; resize with ImageTransformer first"
        )
    return np.stack(rows)


class AssembleFeatures(Estimator):
    """Learn a per-column featurization plan + hashed-slot selection."""

    columns_to_featurize = Param("input columns (None = all columns)")
    output_col = Param("assembled features column", "features", ptype=str)
    number_of_features = Param(
        "hash space for text columns", DEFAULT_NUM_FEATURES, ptype=int,
        validator=positive,
    )
    one_hot_encode_categoricals = Param("one-hot categoricals", True, ptype=bool)
    allow_images = Param("featurize image columns", False, ptype=bool)
    standardize = Param(
        "learn mean/std for numeric+datetime blocks (keeps gradient-trained "
        "learners well-conditioned on unscaled columns; a delta "
        "over the reference, which feeds raw doubles)",
        True,
        ptype=bool,
    )

    def _fit(self, dataset: Dataset) -> "AssembleFeaturesModel":
        cols = self.columns_to_featurize or dataset.columns
        specs: list[dict[str, Any]] = []
        for name in cols:
            kind = _column_kind(dataset, name)
            spec: dict[str, Any] = {"name": name, "kind": kind}
            if kind == _TEXT:
                # count-based slot selection: union of non-zero hash slots,
                # tokenizing each DISTINCT value once (census-like string
                # columns have tiny vocabularies; the per-row loop was the
                # fit-path hot spot)
                used: set[int] = set()
                seen: set[Any] = set()
                for v in dataset[name]:
                    if v is None or v in seen:
                        continue
                    if len(seen) < _TEXT_CACHE_CAP:
                        seen.add(v)
                    for t in _tokenize(v):
                        used.add(_hash_token(t, self.number_of_features))
                spec["slots"] = sorted(used)
            elif kind == _CATEGORICAL:
                cat = dataset.meta_of(name).categorical
                spec["num_levels"] = cat.num_levels + (1 if cat.has_null else 0)
                spec["one_hot"] = self.one_hot_encode_categoricals
            elif kind == _IMAGE and not self.allow_images:
                raise FriendlyError(
                    f"image column '{name}' present but allow_images=False",
                    self.uid,
                )
            specs.append(spec)
        model = AssembleFeaturesModel(
            output_col=self.output_col,
            specs=specs,
            number_of_features=self.number_of_features,
        )
        for spec in specs:
            block = model._block(dataset, spec)
            spec["dim"] = int(block.shape[1])  # exact width for feature_dim
            if self.standardize and spec["kind"] in (_NUMERIC, _DATETIME):
                mean = np.nanmean(block, axis=0)
                std = np.nanstd(block, axis=0)
                spec["mean"] = mean
                spec["std"] = np.where(std > 0, std, 1.0)
        return model


class AssembleFeaturesModel(Model):
    output_col = Param("assembled features column", "features", ptype=str)
    specs = Param("per-column featurization plan", default=list)
    number_of_features = Param("hash space", DEFAULT_NUM_FEATURES, ptype=int)

    def _block(self, dataset: Dataset, spec: dict) -> np.ndarray:
        name, kind = spec["name"], spec["kind"]
        arr = dataset.column(name)
        if kind == _NUMERIC:
            out = np.asarray(arr, dtype=np.float64).reshape(len(arr), 1)
            return self._maybe_standardize(out, spec)
        if kind == _CATEGORICAL:
            idx = np.asarray(arr, dtype=np.int64)
            n = spec["num_levels"]
            if not spec.get("one_hot", True):
                return idx.astype(np.float64).reshape(-1, 1)
            out = np.zeros((len(idx), n), dtype=np.float64)
            valid = (idx >= 0) & (idx < n)
            out[np.arange(len(idx))[valid], idx[valid]] = 1.0
            return out
        if kind == _TEXT:
            slots = spec["slots"]
            pos = {s: j for j, s in enumerate(slots)}
            out = np.zeros((len(arr), len(slots)), dtype=np.float64)
            # tokenize+hash once per DISTINCT value; each cache entry is the
            # (column indices, counts) sparse row it expands to
            cache: dict[Any, tuple[np.ndarray, np.ndarray]] = {}
            for i, v in enumerate(arr):
                if v is None:
                    out[i] = np.nan
                    continue
                hit = cache.get(v)
                if hit is None:
                    cols = [
                        j
                        for t in _tokenize(v)
                        if (j := pos.get(
                            _hash_token(t, self.number_of_features)
                        )) is not None
                    ]
                    cj, cc = (
                        np.unique(cols, return_counts=True)
                        if cols
                        else (np.empty(0, np.int64), np.empty(0, np.int64))
                    )
                    hit = (cj, cc.astype(np.float64))
                    if len(cache) < _TEXT_CACHE_CAP:
                        cache[v] = hit
                out[i, hit[0]] = hit[1]
            return out
        if kind == _DATETIME:
            return self._maybe_standardize(_datetime_features(arr), spec)
        if kind == _IMAGE:
            return _image_features(arr)
        if kind == _VECTOR:
            from mmlspark_tpu_torch.data.feed import stack_column

            v = stack_column(dataset, name)
            return np.asarray(v, dtype=np.float64).reshape(len(arr), -1)
        raise FriendlyError(f"unknown featurize kind '{kind}'", self.uid)

    @staticmethod
    def _maybe_standardize(block: np.ndarray, spec: dict) -> np.ndarray:
        if "mean" in spec:
            return (block - np.asarray(spec["mean"])) / np.asarray(spec["std"])
        return block

    def _transform(self, dataset: Dataset) -> Dataset:
        blocks = [self._block(dataset, s) for s in self.specs]
        feats = np.concatenate(blocks, axis=1) if blocks else np.zeros(
            (dataset.num_rows, 0)
        )
        # NA-drop semantics (reference AssembleFeatures NA handling +
        # FastVectorAssembler): rows with any missing feature are dropped.
        keep = ~np.isnan(feats).any(axis=1)
        out = dataset.filter(keep) if not keep.all() else dataset
        return out.with_column(self.output_col, feats[keep])

    @property
    def feature_dim(self) -> int:
        """Exact assembled width (every kind's dim is recorded at fit)."""
        return sum(int(s["dim"]) for s in self.specs)


class Featurize(Estimator):
    """One-liner façade (reference Featurize.scala:82-98): map of
    output-column -> input columns, one AssembleFeatures per entry."""

    feature_columns = Param(
        "dict {output_col: [input cols]}; None = all -> 'features'"
    )
    number_of_features = Param(
        "hash space for text columns", DEFAULT_NUM_FEATURES, ptype=int
    )
    one_hot_encode_categoricals = Param("one-hot categoricals", True, ptype=bool)
    allow_images = Param("featurize image columns", False, ptype=bool)
    standardize = Param(
        "z-score numeric/datetime blocks (pass-through to AssembleFeatures)",
        True, ptype=bool,
    )

    def _fit(self, dataset: Dataset) -> "FeaturizeModel":
        mapping = self.feature_columns or {"features": list(dataset.columns)}
        models = []
        for out_col, in_cols in mapping.items():
            assembler = AssembleFeatures(
                columns_to_featurize=list(in_cols),
                output_col=out_col,
                number_of_features=self.number_of_features,
                one_hot_encode_categoricals=self.one_hot_encode_categoricals,
                allow_images=self.allow_images,
                standardize=self.standardize,
            )
            models.append(assembler.fit(dataset))
        return FeaturizeModel(models=models)


class FeaturizeModel(Model):
    models = Param("fitted AssembleFeaturesModels", default=list)

    def _transform(self, dataset: Dataset) -> Dataset:
        out = dataset
        for m in self.models:
            out = m.transform(out)
        return out
