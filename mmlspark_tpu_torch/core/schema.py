"""Column-metadata schema protocol — the port's copy of
``mmlspark_tpu/core/schema.py``.

Re-creates the reference's self-describing scored-dataset contract without
Spark's ``Metadata``: columns carry a :class:`ColumnMeta` record tagging them
as label / score / scored-labels / scored-probabilities for a given producing
model, carrying categorical levels, and marking image columns — so downstream
evaluators discover everything with zero configuration.

Reference: core/schema/src/main/scala/SparkSchema.scala:13-249,
SchemaConstants.scala:7-43, Categoricals.scala:16-342, ImageSchema.scala:9-37,
BinaryFileSchema.scala:9-32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch.core.exceptions import SchemaError

# -- SchemaConstants (reference SchemaConstants.scala:7-43) ------------------

MML_TAG = "mml"

#: ScoreColumnKind values
LABEL_KIND = "label"
SCORES_KIND = "scores"
SCORED_LABELS_KIND = "scored_labels"
SCORED_PROBABILITIES_KIND = "scored_probabilities"

#: ScoreValueKind values
CLASSIFICATION = "classification"
REGRESSION = "regression"

#: default score-model tag used when no uid is supplied
DEFAULT_MODEL = "model_0"

#: canonical output column names (reference SchemaConstants)
SCORES_COLUMN = "scores"
SCORED_LABELS_COLUMN = "scored_labels"
SCORED_PROBABILITIES_COLUMN = "scored_probabilities"


@dataclass(frozen=True)
class CategoricalMeta:
    """Categorical levels stored on a column (reference Categoricals.scala:
    ``CategoricalUtilities.setLevels/getLevels``); index <-> level lookup.

    ``levels[i]`` is the original value encoded as index ``i``; ``has_null``
    marks a trailing null level (null-aware ordering, ValueIndexer.scala:37-47).
    """

    levels: tuple
    has_null: bool = False

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def level_to_index(self) -> dict:
        return {lvl: i for i, lvl in enumerate(self.levels)}

    def index_to_level(self, idx: int):
        return self.levels[int(idx)]


@dataclass(frozen=True)
class ImageMeta:
    """Marks a column holding image rows (reference ImageSchema.scala:9-37:
    ``(path, height, width, type, bytes row-wise BGR)``). Here an image column
    is an object-array of :class:`ImageRow` or a dense
    NHWC uint8 array; this meta records the canonical layout."""

    channels: int = 3
    layout: str = "HWC"  # row-major, BGR byte order to mirror OpenCV


@dataclass(frozen=True)
class ColumnMeta:
    """Everything the framework knows about a column beyond its dtype.

    ``kind``/``model``/``value_kind`` implement the score-column protocol
    (reference SparkSchema.scala:13-249): evaluators look up, for a given
    producing model, which column is the label / raw scores / predicted labels
    / probabilities and whether the task was classification or regression.
    """

    kind: Optional[str] = None  # one of the *_KIND constants
    model: Optional[str] = None  # uid of the producing model
    value_kind: Optional[str] = None  # CLASSIFICATION | REGRESSION
    categorical: Optional[CategoricalMeta] = None
    image: Optional[ImageMeta] = None
    extra: dict = field(default_factory=dict)

    def evolve(self, **changes: Any) -> "ColumnMeta":
        return dataclasses.replace(self, **changes)

    def is_empty(self) -> bool:
        return self == ColumnMeta()


@dataclass
class ImageRow:
    """One decoded image (reference ImageSchema.scala:9-20). ``data`` is HWC
    uint8, BGR channel order — matching the reference's OpenCV CV_8UC3 rows so
    byte-level parity tests against the reference semantics are possible."""

    path: str
    data: np.ndarray  # (H, W, C) uint8

    @property
    def height(self) -> int:
        return int(self.data.shape[0])

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def channels(self) -> int:
        return int(self.data.shape[2]) if self.data.ndim == 3 else 1


@dataclass
class BinaryFileRow:
    """One whole binary file (reference BinaryFileSchema.scala:9-32)."""

    path: str
    data: bytes


# -- score-column tagging / discovery ----------------------------------------


def tag_column(meta: ColumnMeta | None, kind: str, model: str, value_kind: str | None):
    """Return a ColumnMeta tagging a column under the score protocol
    (reference SparkSchema.updateMetadata)."""
    base = meta or ColumnMeta()
    return base.evolve(kind=kind, model=model, value_kind=value_kind)


def _find_by_kind(dataset, kind: str, model: str | None) -> str | None:
    hits = []
    for name in dataset.columns:
        m = dataset.meta_of(name)
        if m.kind == kind and (model is None or m.model == model):
            hits.append(name)
    if not hits:
        return None
    if len(hits) > 1 and model is None:
        raise SchemaError(
            f"multiple columns tagged '{kind}' ({hits}); pass a model uid"
        )
    return hits[0]


def find_label_column(dataset, model: str | None = None) -> str | None:
    return _find_by_kind(dataset, LABEL_KIND, model)


def find_scores_column(dataset, model: str | None = None) -> str | None:
    return _find_by_kind(dataset, SCORES_KIND, model)


def find_scored_labels_column(dataset, model: str | None = None) -> str | None:
    return _find_by_kind(dataset, SCORED_LABELS_KIND, model)


def find_scored_probabilities_column(dataset, model: str | None = None) -> str | None:
    return _find_by_kind(dataset, SCORED_PROBABILITIES_KIND, model)


def get_score_value_kind(dataset, model: str | None = None) -> str | None:
    """The task type (classification/regression) recorded by the producing
    model (reference SparkSchema.getScoreValueKind)."""
    for name in dataset.columns:
        m = dataset.meta_of(name)
        if m.value_kind is not None and (model is None or m.model == model):
            return m.value_kind
    return None


def fresh_column_name(dataset, base: str) -> str:
    """A column name not already present (reference
    DatasetExtensions.findUnusedColumnName, DatasetExtensions.scala:11-60)."""
    if base not in dataset.columns:
        return base
    i = 1
    while f"{base}_{i}" in dataset.columns:
        i += 1
    return f"{base}_{i}"
