"""The pipeline-stage surface: importing this package registers every
stage the port has — ``TPUModel``, ``DNNLearner`` and the image stages
(``ImageTransformer``, ``UnrollImage``, ``ImageFeaturizer``,
``ImageSetAugmenter``) — in the port's
stage registry (:meth:`~mmlspark_tpu_torch.core.stage.PipelineStage.
registry`), the analog of the reference loading every
Transformer/Estimator from built jars. ``load_stage`` imports it when a
saved stage names a class it has not seen."""

from mmlspark_tpu_torch.stages.dnn_learner import DNNLearner
from mmlspark_tpu_torch.stages.dnn_model import TPUModel
from mmlspark_tpu_torch.stages.image import (
    ImageFeaturizer,
    ImageSetAugmenter,
    ImageTransformer,
    UnrollImage,
)

__all__ = ["DNNLearner", "ImageFeaturizer", "ImageSetAugmenter",
           "ImageTransformer", "TPUModel", "UnrollImage"]
