"""DNNLearner — DNN training as an Estimator stage, the port of
``mmlspark_tpu/stages/dnn_learner.py`` (the reference's CNTKLearner,
cntk-train/src/main/scala/CNTKLearner.scala:16-162).

Where the reference exports the dataset to a CNTK text file and shells out
to ``mpiexec cntk``, this stage feeds host batches straight into the
port's :class:`~mmlspark_tpu_torch.train.trainer.SPMDTrainer` (one
captured step program on the card) and returns the trained net wrapped as
a :class:`~mmlspark_tpu_torch.stages.dnn_model.TPUModel` — the same
``fit(df) -> inference stage`` contract (CNTKLearner.scala:158-161). The
params and ``_fit`` are the JAX package's; ``device`` is the port's
explicit device (``None``: the card), and ``checkpoint_dir`` means the
port's ``.npy`` checkpoint store (``train/resilience.py``), which does not
cross to the JAX package's orbax one.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import (
    HasFeaturesCol,
    HasLabelCol,
    Param,
    positive,
)
from mmlspark_tpu_torch.core.stage import Estimator
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import stack_column
from mmlspark_tpu_torch.models.registry import build_model
from mmlspark_tpu_torch.stages.dnn_model import TPUModel
from mmlspark_tpu_torch.train.trainer import (
    SOFTMAX_XENT,
    SPMDTrainer,
    TrainConfig,
)


class DNNLearner(Estimator, HasFeaturesCol, HasLabelCol):
    """fit(dataset) -> TPUModel, trained on one device."""

    model_name = Param("registered architecture name", "mlp", ptype=str)
    model_config = Param("architecture config kwargs", default=dict, ptype=dict)
    epochs = Param("training epochs", 1, ptype=int, validator=positive)
    batch_size = Param("global batch size", 128, ptype=int, validator=positive)
    learning_rate = Param("peak learning rate", 1e-3, ptype=float)
    optimizer = Param(
        "optimizer", "adam", domain=("adam", "adamw", "sgd", "momentum")
    )
    loss = Param(
        "loss kind", SOFTMAX_XENT,
        domain=("softmax_xent", "sigmoid_xent", "mse"),
    )
    weight_decay = Param("adamw weight decay", 0.0, ptype=float)
    lr_schedule = Param("lr schedule", "constant", domain=("constant", "cosine"))
    warmup_steps = Param("lr warmup steps", 0, ptype=int)
    seed = Param("rng seed", 0, ptype=int)
    shuffle = Param("shuffle each epoch", True, ptype=bool)
    steps_per_dispatch = Param(
        "optimizer steps chained per dispatch (exact; replays of the "
        "captured step with no host sync between them)", 1, ptype=int,
        validator=positive,
    )
    remat = Param(
        "recompute forward in backward (activation-memory saver)", False,
        ptype=bool,
    )
    mesh_axes = Param("mesh axis name -> size over the ranks of an "
                      "initialised process group (the trainer's mesh "
                      "mode); None = one device")
    checkpoint_dir = Param("the port's .npy checkpoint directory "
                           "(None = off)")
    checkpoint_every = Param("checkpoint every N steps (0 = end only)", 0,
                             ptype=int)
    output_col = Param("scores column on the returned model", "scores",
                       ptype=str)
    device = Param(
        "the device to train on: None = the card (cuda; raises without a "
        "GPU), or 'cpu'/'cuda'/'cuda:N'", ptype=str,
    )

    def _train_config(self) -> TrainConfig:
        return TrainConfig(
            epochs=self.epochs,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            optimizer=self.optimizer,
            loss=self.loss,
            weight_decay=self.weight_decay,
            lr_schedule=self.lr_schedule,
            warmup_steps=self.warmup_steps,
            seed=self.seed,
            shuffle=self.shuffle,
            steps_per_dispatch=self.steps_per_dispatch,
            remat=self.remat,
            mesh_axes=self.mesh_axes,
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_every=self.checkpoint_every,
        )

    def _fit(self, dataset: Dataset) -> TPUModel:
        dataset.require(self.features_col, self.label_col)
        x = stack_column(dataset, self.features_col)
        if x.dtype == object:
            raise FriendlyError(
                f"features column '{self.features_col}' is ragged", self.uid
            )
        y = np.asarray(dataset[self.label_col])
        # drop rows with missing labels (reference na.drop on labels,
        # CNTKLearner.scala:58)
        if y.dtype == object:
            keep = np.array([v is not None for v in y])
            x, y = x[keep], y[keep].astype(np.float64)
        elif np.issubdtype(y.dtype, np.floating):
            keep = ~np.isnan(y)
            x, y = x[keep], y[keep]

        config = dict(self.model_config or {})
        if self.loss == SOFTMAX_XENT and "num_outputs" not in config:
            n_classes = int(np.max(y)) + 1 if len(y) else 2
            if self.model_name in ("mlp", "linear"):
                config["num_outputs"] = max(n_classes, 2)
        graph = build_model(self.model_name, **config)
        trainer = SPMDTrainer(graph, self._train_config(), device=self.device)
        y_float = np.issubdtype(np.asarray(y).dtype, np.floating)
        if y_float and self.loss == SOFTMAX_XENT:
            y = y.astype(np.int32)
        variables = trainer.train(
            x.astype(np.float32) if np.issubdtype(x.dtype, np.floating) else x,
            y,
        )
        model = TPUModel.from_graph(
            graph,
            variables,
            self.model_name,
            model_config=config,
            input_col=self.features_col,
            output_col=self.output_col,
            batch_size=self.batch_size,
        )
        if self.device is not None:
            model.set(device=self.device)
        model.train_history = list(trainer.history)
        return model
