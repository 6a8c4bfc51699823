"""Training on one device: ``SPMDTrainer`` and ``TrainConfig``, the atomic
checkpoint store and the accumulation ladder, and the synthetic
``run_train_demo``."""

from mmlspark_tpu_torch.train.demo import run_train_demo
from mmlspark_tpu_torch.train.resilience import (
    AtomicCheckpointStore,
    next_accum_rung,
)
from mmlspark_tpu_torch.train.trainer import (
    SPMDTrainer,
    TrainConfig,
    masked_loss,
)

__all__ = ["AtomicCheckpointStore", "SPMDTrainer", "TrainConfig",
           "masked_loss", "next_accum_rung", "run_train_demo"]
