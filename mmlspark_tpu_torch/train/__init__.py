"""Training: ``SPMDTrainer`` and ``TrainConfig`` on one device."""

from mmlspark_tpu_torch.train.trainer import (
    SPMDTrainer,
    TrainConfig,
    masked_loss,
)

__all__ = ["SPMDTrainer", "TrainConfig", "masked_loss"]
