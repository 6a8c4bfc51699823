"""TrainRegressor — one-liner regression, the port of
``mmlspark_tpu/stages/train_regressor.py``; ``device`` goes to every
learner (``None``: the card).

Reference: train-regressor/src/main/scala/TrainRegressor.scala:21-192 (label
cast to double, auto-Featurize, learner fit, score-column metadata with
regression value kind).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import HasLabelCol, Param, positive
from mmlspark_tpu_torch.core.schema import (
    LABEL_KIND,
    REGRESSION,
    SCORED_LABELS_KIND,
    SCORES_KIND,
    ColumnMeta,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.stages.dnn_learner import DNNLearner
from mmlspark_tpu_torch.stages.featurize import (
    DEFAULT_NUM_FEATURES,
    TREE_NN_NUM_FEATURES,
    Featurize,
)

LINEAR_REGRESSION = "linear_regression"
MLP_REGRESSOR = "mlp"
DECISION_TREE = "decision_tree"
RANDOM_FOREST = "random_forest"
GBT = "gbt"

#: learners featurized tree-style (small hash space, no OHE)
_TREE_LEARNERS = (DECISION_TREE, RANDOM_FOREST, GBT)


class TrainRegressor(Estimator, HasLabelCol):
    model = Param(
        "learner: built-in name or custom Estimator", LINEAR_REGRESSION
    )
    number_of_features = Param("hash space (None = learner-aware default)")
    epochs = Param("epochs", 30, ptype=int, validator=positive)
    batch_size = Param("global batch size", 256, ptype=int, validator=positive)
    learning_rate = Param("learning rate", 1e-2, ptype=float)
    optimizer = Param("optimizer", "momentum",
                      domain=("adam", "adamw", "sgd", "momentum"))
    hidden = Param("hidden sizes for the mlp learner", (128,))
    seed = Param("rng seed", 0, ptype=int)
    steps_per_dispatch = Param(
        "optimizer steps per compiled call (NN learners)", 1, ptype=int,
        validator=positive,
    )
    # tree knobs (pass-through to the histogram learners)
    max_depth = Param("tree depth", 5, ptype=int, validator=positive)
    num_trees = Param("random-forest tree count", 20, ptype=int,
                      validator=positive)
    max_iter = Param("gbt boosting rounds", 20, ptype=int, validator=positive)
    device = Param(
        "the device the learner runs on: None = the card (cuda; raises "
        "without a GPU), or 'cpu'/'cuda'/'cuda:N'", ptype=str,
    )

    def _make_learner(self) -> Estimator:
        from mmlspark_tpu_torch.stages.trees import (
            DecisionTreeRegressor,
            GBTRegressor,
            RandomForestRegressor,
        )

        tree_common = dict(
            features_col="features",
            label_col="__label_double__",
            max_depth=self.max_depth,
            seed=self.seed,
            device=self.device,
        )
        if self.model == DECISION_TREE:
            return DecisionTreeRegressor(**tree_common)
        if self.model == RANDOM_FOREST:
            return RandomForestRegressor(
                num_trees=self.num_trees, **tree_common
            )
        if self.model == GBT:
            return GBTRegressor(
                max_iter=self.max_iter,
                step_size=self.learning_rate
                if self.is_set("learning_rate")
                else 0.1,
                **tree_common,
            )
        if isinstance(self.model, Estimator):
            return self.model
        common = dict(
            loss="mse",
            epochs=self.epochs,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            optimizer=self.optimizer,
            seed=self.seed,
            steps_per_dispatch=self.steps_per_dispatch,
            features_col="features",
            label_col="__label_double__",
            device=self.device,
        )
        if self.model == LINEAR_REGRESSION:
            return DNNLearner(
                model_name="linear", model_config={"num_outputs": 1}, **common
            )
        if self.model == MLP_REGRESSOR:
            return DNNLearner(
                model_name="mlp",
                model_config={"num_outputs": 1, "hidden": tuple(self.hidden)},
                **common,
            )
        raise FriendlyError(
            f"unknown learner '{self.model}'; built-ins: "
            f"{LINEAR_REGRESSION!r}, {MLP_REGRESSOR!r}, {DECISION_TREE!r}, "
            f"{RANDOM_FOREST!r}, {GBT!r}",
            self.uid,
        )

    def _fit(self, dataset: Dataset) -> "TrainedRegressorModel":
        dataset.require(self.label_col)
        y = np.asarray(dataset[self.label_col], dtype=np.float64)
        ds = dataset.with_column("__label_double__", y)
        feature_inputs = [
            c
            for c in dataset.columns
            if c not in (self.label_col, "__label_double__")
        ]
        nf = self.number_of_features or (
            TREE_NN_NUM_FEATURES
            if self.model == MLP_REGRESSOR or self.model in _TREE_LEARNERS
            else DEFAULT_NUM_FEATURES
        )
        featurizer = Featurize(
            feature_columns={"features": feature_inputs},
            number_of_features=nf,
            one_hot_encode_categoricals=self.model not in _TREE_LEARNERS,
        ).fit(ds)
        featurized = featurizer.transform(ds)
        fitted = self._make_learner().fit(featurized)
        return TrainedRegressorModel(
            featurizer=featurizer,
            learner_model=fitted,
            label_col=self.label_col,
        )


class TrainedRegressorModel(Model):
    featurizer = Param("fitted FeaturizeModel")
    learner_model = Param("fitted scoring model")
    label_col = Param("original label column", "label", ptype=str)

    def _transform(self, dataset: Dataset) -> Dataset:
        ds = self.featurizer.transform(dataset)
        ds = self.learner_model.transform(ds)
        scores = np.asarray(ds["scores"], dtype=np.float64)
        pred = scores[:, 0] if scores.ndim > 1 else scores
        uid = self.uid
        ds = ds.with_column(
            "scores",
            pred,
            ColumnMeta(kind=SCORES_KIND, model=uid, value_kind=REGRESSION),
        )
        ds = ds.with_column(
            "scored_labels",
            pred,
            ColumnMeta(kind=SCORED_LABELS_KIND, model=uid, value_kind=REGRESSION),
        )
        if self.label_col in ds.columns:
            ds = ds.with_meta(
                self.label_col,
                ds.meta_of(self.label_col).evolve(
                    kind=LABEL_KIND, model=uid, value_kind=REGRESSION
                ),
            )
        return ds
