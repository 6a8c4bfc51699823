"""TrainClassifier — one-liner AutoML-style classification, the port of
``mmlspark_tpu/stages/train_classifier.py``. The ``device`` param goes to
every learner that runs on a device (the tree learners and the
``DNNLearner`` behind ``logistic_regression``/``mlp``; naive Bayes is
host numpy): ``None`` is the card, which raises without a GPU.

Reference: train-classifier/src/main/scala/TrainClassifier.scala:40-348.
Pipeline reproduced feature-for-feature:

- label reindex via ValueIndexer (+ explicit labels option) with levels kept
  for inverse mapping (convertLabel, :203-249)
- auto-Featurize of all non-label columns, learner-aware config (2^18
  features default, 2^12 for NN learners; no OHE for tree learners —
  :107,186-201)
- the learner is just another estimator; built-ins mirror the reference's
  full dispatch list (TrainClassifier.scala:45-52): logistic regression /
  MLP (trained by the port's trainer), decision tree / random forest /
  GBT (histogram trees built on the device, stages/trees.py), and
  naive Bayes;
  a custom Estimator plugs in the same way. Delta vs reference: our
  logistic regression and GBT are natively multiclass (softmax), so the
  OneVsRest wrap the reference needs at :110-122 is unnecessary — the
  OneVsRest combinator still exists (stages/classical.py) for wrapping
  binary-only custom learners.
- output model = featurizer + learner + score-column metadata tagging
  (TrainedClassifierModel.transform, :297-348)
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import HasLabelCol, Param, positive
from mmlspark_tpu_torch.core.schema import (
    CLASSIFICATION,
    LABEL_KIND,
    SCORED_LABELS_KIND,
    SCORED_PROBABILITIES_KIND,
    SCORES_KIND,
    CategoricalMeta,
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
from mmlspark_tpu_torch.stages.value_indexer import ValueIndexer

#: built-in learners; mirrors the supported-learner dispatch at
#: TrainClassifier.scala:45-52
LOGISTIC_REGRESSION = "logistic_regression"
MLP_CLASSIFIER = "mlp"
DECISION_TREE = "decision_tree"
RANDOM_FOREST = "random_forest"
GBT = "gbt"
NAIVE_BAYES = "naive_bayes"

#: learners featurized tree-style: small hash space, no one-hot
#: (TrainClassifier.scala:107, Featurize.scala:13-19)
_TREE_LEARNERS = (DECISION_TREE, RANDOM_FOREST, GBT)


class TrainClassifier(Estimator, HasLabelCol):
    model = Param(
        "learner: built-in name or a custom Estimator producing a scores "
        "column on 'features'",
        LOGISTIC_REGRESSION,
    )
    number_of_features = Param(
        "hash space for text features (None = learner-aware default)"
    )
    reindex_label = Param("reindex label to [0, n)", True, ptype=bool)
    labels = Param("explicit label levels (overrides discovered ordering)")
    # pass-through training knobs for built-in learners
    epochs = Param("epochs", 10, ptype=int, validator=positive)
    batch_size = Param("global batch size", 256, ptype=int, validator=positive)
    learning_rate = Param("learning rate", 1e-2, ptype=float)
    hidden = Param("hidden layer sizes for the mlp learner", (128,))
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

    def _make_learner(self, num_classes: int) -> Estimator:
        from mmlspark_tpu_torch.stages.classical import NaiveBayes
        from mmlspark_tpu_torch.stages.trees import (
            DecisionTreeClassifier,
            GBTClassifier,
            RandomForestClassifier,
        )

        tree_common = dict(
            features_col="features",
            label_col="__label_idx__",
            max_depth=self.max_depth,
            seed=self.seed,
            device=self.device,
        )
        if self.model == DECISION_TREE:
            return DecisionTreeClassifier(**tree_common)
        if self.model == RANDOM_FOREST:
            return RandomForestClassifier(
                num_trees=self.num_trees, **tree_common
            )
        if self.model == GBT:
            return GBTClassifier(
                max_iter=self.max_iter,
                step_size=self.learning_rate
                if self.is_set("learning_rate")
                else 0.1,
                **tree_common,
            )
        if self.model == NAIVE_BAYES:
            return NaiveBayes(
                features_col="features", label_col="__label_idx__"
            )
        if isinstance(self.model, Estimator):
            return self.model
        if self.model == LOGISTIC_REGRESSION:
            return DNNLearner(
                model_name="linear",
                model_config={"num_outputs": num_classes},
                loss="softmax_xent",
                epochs=self.epochs,
                batch_size=self.batch_size,
                learning_rate=self.learning_rate,
                seed=self.seed,
                steps_per_dispatch=self.steps_per_dispatch,
                features_col="features",
                label_col="__label_idx__",
                device=self.device,
            )
        if self.model == MLP_CLASSIFIER:
            return DNNLearner(
                model_name="mlp",
                model_config={
                    "num_outputs": num_classes,
                    "hidden": tuple(self.hidden),
                },
                loss="softmax_xent",
                epochs=self.epochs,
                batch_size=self.batch_size,
                learning_rate=self.learning_rate,
                seed=self.seed,
                steps_per_dispatch=self.steps_per_dispatch,
                features_col="features",
                label_col="__label_idx__",
                device=self.device,
            )
        raise FriendlyError(
            f"unknown learner '{self.model}'; built-ins: "
            f"{LOGISTIC_REGRESSION!r}, {MLP_CLASSIFIER!r}, "
            f"{DECISION_TREE!r}, {RANDOM_FOREST!r}, {GBT!r}, "
            f"{NAIVE_BAYES!r}",
            self.uid,
        )

    def _num_features(self) -> int:
        if self.number_of_features is not None:
            return int(self.number_of_features)
        # tree/NN learners get the smaller hash space (Featurize.scala:13-19)
        return (
            TREE_NN_NUM_FEATURES
            if self.model == MLP_CLASSIFIER or self.model in _TREE_LEARNERS
            else DEFAULT_NUM_FEATURES
        )

    def _fit(self, dataset: Dataset) -> "TrainedClassifierModel":
        dataset.require(self.label_col)
        # -- label conversion (convertLabel, :203-249)
        if self.labels is not None:
            levels = list(self.labels)
            lookup = {lvl: i for i, lvl in enumerate(levels)}
            try:
                idx = np.asarray(
                    [lookup[v] for v in dataset[self.label_col]], np.int32
                )
            except KeyError as e:
                raise FriendlyError(
                    f"label value {e.args[0]!r} not in explicit labels",
                    self.uid,
                )
            indexed = dataset.with_column("__label_idx__", idx)
        elif self.reindex_label:
            indexer = ValueIndexer(
                input_col=self.label_col, output_col="__label_idx__"
            ).fit(dataset)
            indexed = indexer.transform(dataset)
            levels = list(indexer.levels)
        else:
            idx = np.asarray(dataset[self.label_col], np.int64)
            levels = list(range(int(idx.max()) + 1)) if len(idx) else []
            indexed = dataset.with_column("__label_idx__", idx.astype(np.int32))
        num_classes = max(len(levels), 2)

        # -- featurize all non-label columns
        feature_inputs = [
            c
            for c in dataset.columns
            if c not in (self.label_col, "__label_idx__")
        ]
        featurizer = Featurize(
            feature_columns={"features": feature_inputs},
            number_of_features=self._num_features(),
            # trees split categoricals on the raw index — no OHE
            # (TrainClassifier.scala:107)
            one_hot_encode_categoricals=self.model not in _TREE_LEARNERS,
            # naive Bayes needs raw non-negative counts (Spark MLlib
            # requirement); z-scoring would sign-flip them
            standardize=self.model != NAIVE_BAYES,
        ).fit(indexed)
        featurized = featurizer.transform(indexed)

        learner = self._make_learner(num_classes)
        fitted = learner.fit(featurized)

        return TrainedClassifierModel(
            featurizer=featurizer,
            learner_model=fitted,
            levels=levels,
            label_col=self.label_col,
        )


class TrainedClassifierModel(Model):
    featurizer = Param("fitted FeaturizeModel")
    learner_model = Param("fitted scoring model (scores on 'features')")
    levels = Param("label levels for inverse mapping", default=list)
    label_col = Param("original label column", "label", ptype=str)

    def _transform(self, dataset: Dataset) -> Dataset:
        ds = self.featurizer.transform(dataset)
        ds = self.learner_model.transform(ds)
        scores = np.asarray(ds["scores"], dtype=np.float64)
        # softmax probabilities + argmax labels (the reference's
        # probability/prediction columns, tagged via metadata :297-348)
        z = scores - scores.max(axis=1, keepdims=True)
        ez = np.exp(z)
        probs = ez / ez.sum(axis=1, keepdims=True)
        pred_idx = scores.argmax(axis=1)
        levels = list(self.levels)
        if levels:
            inv = np.array(levels + [None], dtype=object)
            pred = inv[np.minimum(pred_idx, len(levels) - 1)]
            pred = np.array([p for p in pred], dtype=object)
        else:
            pred = pred_idx
        uid = self.uid
        cat = CategoricalMeta(tuple(levels)) if levels else None
        ds = ds.with_column(
            "scores",
            scores,
            ColumnMeta(kind=SCORES_KIND, model=uid, value_kind=CLASSIFICATION),
        )
        ds = ds.with_column(
            "scored_probabilities",
            probs,
            ColumnMeta(
                kind=SCORED_PROBABILITIES_KIND,
                model=uid,
                value_kind=CLASSIFICATION,
            ),
        )
        ds = ds.with_column(
            "scored_labels",
            pred,
            ColumnMeta(
                kind=SCORED_LABELS_KIND,
                model=uid,
                value_kind=CLASSIFICATION,
                categorical=cat,
            ),
        )
        if self.label_col in ds.columns:
            ds = ds.with_meta(
                self.label_col,
                ds.meta_of(self.label_col).evolve(
                    kind=LABEL_KIND, model=uid, value_kind=CLASSIFICATION,
                    categorical=cat,
                ),
            )
        return ds
