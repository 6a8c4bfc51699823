"""The pipeline-stage surface: importing this package registers every
stage the port has in the port's stage registry
(:meth:`~mmlspark_tpu_torch.core.stage.PipelineStage.registry`), the
analog of the reference loading every Transformer/Estimator from built
jars: ``TPUModel`` and ``DNNLearner``, the image stages, and the
classical surface (the value indexer, the prep stages, ``Featurize``,
the histogram tree learners, naive Bayes and one-vs-rest,
``TrainClassifier``/``TrainRegressor``, the evaluation stages,
``FindBestModel``, ``EnsembleByKey``, ``TextFeaturizer`` and
``Word2Vec``).
``load_stage`` imports it when a saved stage names a class it has not
seen."""

import importlib

from mmlspark_tpu_torch.stages.dnn_learner import DNNLearner
from mmlspark_tpu_torch.stages.dnn_model import TPUModel
from mmlspark_tpu_torch.stages.image import (
    ImageFeaturizer,
    ImageSetAugmenter,
    ImageTransformer,
    UnrollImage,
)

_STAGE_MODULES = [
    "value_indexer",
    "featurize",
    "text",
    "word2vec",
    "trees",
    "classical",
    "train_classifier",
    "train_regressor",
    "eval_metrics",
    "find_best",
    "prep",
    "ensemble",
]

for _m in _STAGE_MODULES:
    importlib.import_module(f"mmlspark_tpu_torch.stages.{_m}")

__all__ = ["DNNLearner", "ImageFeaturizer", "ImageSetAugmenter",
           "ImageTransformer", "TPUModel", "UnrollImage"]
