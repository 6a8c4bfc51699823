"""Stage base classes: Estimator / Transformer / Model / Pipeline — the
port of ``mmlspark_tpu/core/stage.py``.

The reference's deepest idea (SURVEY.md §7): ML pipeline stages over a
dataframe, where a compiled NN is just another stage, with schema metadata
making stages self-describing. Here a stage is a pytree-of-params Python
object with ``fit``/``transform`` over
:class:`~mmlspark_tpu_torch.data.dataset.Dataset`.

Every concrete subclass is auto-registered (``__init_subclass__``), giving the
framework the stage registry the reference builds by jar reflection
(core/utils/src/main/scala/JarLoadingUtils.scala:18-145) — it powers the
registry-wide fuzz tests and serialization-by-name. The port's registry is
its own: a class of the JAX package never enters it, and a saved stage
loads in the port when the port has a class of that name.

Reference for the base contracts: Spark ML Estimator/Transformer as used
throughout src/*/src/main/scala (e.g. TrainClassifier.scala:40,
ImageTransformer.scala:258).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, ClassVar, Sequence

from mmlspark_tpu_torch.core.params import HasParams, Param
from mmlspark_tpu_torch.data.dataset import Dataset

_uid_lock = threading.Lock()
_uid_counters: dict[str, itertools.count] = {}


def _next_uid(prefix: str) -> str:
    with _uid_lock:
        counter = _uid_counters.setdefault(prefix, itertools.count())
        return f"{prefix}_{next(counter):04x}"


class PipelineStage(HasParams):
    """Base for everything in a pipeline. Stages are cheap, picklable param
    holders; heavy state (weights, datasets) lives in explicitly-declared
    params so serialization can dispatch on type."""

    _registry: ClassVar[dict[str, type["PipelineStage"]]] = {}
    #: set True on abstract intermediates to keep them out of the registry
    _abstract: ClassVar[bool] = True

    def __init_subclass__(cls, **kwargs: Any):
        super().__init_subclass__(**kwargs)
        cls._abstract = cls.__dict__.get("_abstract", False)
        if not cls._abstract:
            prev = PipelineStage._registry.get(cls.__name__)
            if prev is not None and prev.__module__ != cls.__module__:
                from mmlspark_tpu_torch.core.logging_utils import get_logger

                get_logger("registry").warning(
                    "stage name collision: %s.%s replaces %s.%s in the registry",
                    cls.__module__,
                    cls.__name__,
                    prev.__module__,
                    prev.__name__,
                )
            PipelineStage._registry[cls.__name__] = cls

    def __init__(self, **kwargs: Any):
        self.uid = _next_uid(type(self).__name__)
        super().__init__(**kwargs)

    @classmethod
    def registry(cls) -> dict[str, type["PipelineStage"]]:
        return dict(cls._registry)

    def copy(self, **overrides: Any) -> "PipelineStage":
        """A new stage of the same class with the same explicit params."""
        dup = type(self)()
        dup.set(**self.param_values())
        dup.set(**overrides)
        return dup

    # -- persistence (implemented in core.serialize to keep this file small)
    def save(self, path: str) -> None:
        from mmlspark_tpu_torch.core.serialize import save_stage

        save_stage(self, path)

    @staticmethod
    def load(path: str) -> "PipelineStage":
        from mmlspark_tpu_torch.core.serialize import load_stage

        return load_stage(path)

    def __repr__(self) -> str:
        vals = ", ".join(f"{k}={v!r}" for k, v in sorted(self.param_values().items()))
        return f"{type(self).__name__}({vals})"


class Transformer(PipelineStage):
    """A stage mapping Dataset -> Dataset."""

    _abstract = True

    def transform(self, dataset: Dataset) -> Dataset:
        self.check_required()
        return self._transform(dataset)

    def _transform(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError

    def transform_stream(self, chunks):
        """Chunkwise streaming transform — the structured-streaming leg of
        the reference (streamImages -> per-row stages -> CNTKModel, all
        row-wise; BinaryFileFormat.scala:118 implements the streaming
        source). Applies this transformer to each Dataset chunk from an
        iterator and yields the
        results. Row-wise stages (image ops, feature hashing, DNN
        inference, prep) are exact under chunking; aggregating stages
        (e.g. SummarizeData) see one chunk at a time — the same
        restriction Spark places on streaming aggregations."""
        for chunk in chunks:
            yield self.transform(chunk)

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.transform(dataset)


class Model(Transformer):
    """A fitted transformer produced by an Estimator."""

    _abstract = True


class Estimator(PipelineStage):
    """A stage learning a Model from a Dataset."""

    _abstract = True

    def fit(self, dataset: Dataset) -> Model:
        self.check_required()
        return self._fit(dataset)

    def _fit(self, dataset: Dataset) -> Model:
        raise NotImplementedError


class Pipeline(Estimator):
    """Sequential composition of stages; fitting fits estimators in order,
    transforming the running dataset through each fitted/transformer stage
    (Spark ML Pipeline semantics, as used by e.g. TrainClassifier.scala:182)."""

    stages = Param("ordered list of stages", default=list, ptype=(list, tuple))

    def __init__(self, stages: Sequence[PipelineStage] | None = None, **kwargs: Any):
        super().__init__(**kwargs)
        if stages is not None:
            self.stages = list(stages)

    def _fit(self, dataset: Dataset) -> "PipelineModel":
        stages = list(self.stages)
        last_estimator = max(
            (i for i, s in enumerate(stages) if isinstance(s, Estimator)),
            default=-1,
        )
        fitted: list[Transformer] = []
        current = dataset
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(current)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"not a pipeline stage: {stage!r}")
            fitted.append(model)
            # No later estimator needs the transformed data — skip the pass
            # (matches Spark ML Pipeline.fit; avoids a wasted full-dataset
            # inference when the last stage is an expensive model).
            if i < last_estimator:
                current = model.transform(current)
        return PipelineModel(stages=fitted)


class PipelineModel(Model):
    stages = Param("ordered list of fitted transformer stages", default=list)

    def __init__(self, stages: Sequence[Transformer] | None = None, **kwargs: Any):
        super().__init__(**kwargs)
        if stages is not None:
            self.set(stages=list(stages))

    def _transform(self, dataset: Dataset) -> Dataset:
        current = dataset
        for stage in self.stages:
            current = stage.transform(current)
        return current
