"""Classical learners: multinomial naive Bayes and one-vs-rest reduction —
the port of ``mmlspark_tpu/stages/classical.py`` (host numpy).

Reference learner dispatch: train-classifier/src/main/scala/
TrainClassifier.scala:45-52 (NaiveBayesClassifier) and the OneVsRest wrap
applied to multiclass logistic regression (:110-122). The reference
delegates to Spark MLlib; here naive Bayes is a closed-form log-count
computation (one matmul at inference), and OneVsRest is a
generic estimator combinator usable around ANY binary learner stage.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import (
    HasFeaturesCol,
    HasLabelCol,
    HasOutputCol,
    Param,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import stack_column
from mmlspark_tpu_torch.stages.trees import _prep_xy


class NaiveBayes(Estimator, HasFeaturesCol, HasLabelCol):
    """Multinomial naive Bayes over non-negative (count-like) features.

    The natural pairing with hashed text features (Featurize /
    TextFeaturizer output). Negative feature values are rejected, matching
    Spark MLlib's requirement.
    """

    smoothing = Param("Laplace/Lidstone smoothing", 1.0, ptype=float)

    def _fit(self, dataset: Dataset) -> "NaiveBayesModel":
        x, y, k = _prep_xy(self, dataset, classification=True)
        if np.any(x < 0):
            raise FriendlyError(
                "NaiveBayes requires non-negative feature values", self.uid
            )
        d = x.shape[1]
        counts = np.zeros((k, d))
        class_n = np.zeros(k)
        for c in range(k):
            rows = x[y == c]
            counts[c] = rows.sum(axis=0)
            class_n[c] = len(rows)
        a = self.smoothing
        log_prior = np.log(
            np.maximum(class_n, 1e-15) / max(len(y), 1)
        )
        log_like = np.log(counts + a) - np.log(
            counts.sum(axis=1, keepdims=True) + a * d
        )
        return NaiveBayesModel(
            log_prior=log_prior,
            log_likelihood=log_like,
            features_col=self.features_col,
        )


class NaiveBayesModel(Model, HasFeaturesCol, HasOutputCol):
    log_prior = Param("log class priors [K]")
    log_likelihood = Param("log feature likelihoods [K, d]")

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("output_col", "scores")
        super().__init__(**kwargs)

    def _transform(self, dataset: Dataset) -> Dataset:
        x = np.asarray(stack_column(dataset, self.features_col), np.float64)
        # log joint: one [n,d]x[d,K] matmul — softmax downstream recovers
        # the posterior
        scores = x @ np.asarray(self.log_likelihood).T + np.asarray(
            self.log_prior
        )
        return dataset.with_column(self.output_col, scores)


class OneVsRest(Estimator, HasFeaturesCol, HasLabelCol):
    """K binary copies of any learner stage, one per class.

    Reference: the OneVsRest wrap TrainClassifier applies to multiclass
    logistic regression (TrainClassifier.scala:110-122). The wrapped
    learner must produce a 'scores' column; class k's score is the binary
    model's positive-class score.
    """

    learner = Param("binary learner Estimator to replicate", required=True)
    num_classes = Param("class count (None = infer from labels)")

    def _fit(self, dataset: Dataset) -> "OneVsRestModel":
        dataset.require(self.label_col)
        y = np.asarray(dataset[self.label_col])
        # same label hygiene as every sibling learner: missing labels drop
        # (CNTKLearner.scala:58), string labels index to [0, k)
        levels: list | None = None
        if y.dtype == object:
            keep = np.array([v is not None for v in y])
            dataset, y = dataset.filter(keep), y[keep]
            levels = sorted(set(y))
            lookup = {v: i for i, v in enumerate(levels)}
            y = np.asarray([lookup[v] for v in y], np.int64)
        else:
            if np.issubdtype(y.dtype, np.floating):
                keep = ~np.isnan(y)
                dataset, y = dataset.filter(keep), y[keep]
            y = y.astype(np.int64)
        k = (
            int(self.num_classes)
            if self.num_classes is not None
            else max(int(y.max()) + 1 if y.size else 2, 2)
        )
        models = []
        for c in range(k):
            binary = (y == c).astype(np.int32)
            ds_c = dataset.with_column("__ovr_label__", binary)
            learner = self.learner.copy(label_col="__ovr_label__")
            models.append(learner.fit(ds_c))
        return OneVsRestModel(
            models=models, features_col=self.features_col, levels=levels
        )


class OneVsRestModel(Model, HasFeaturesCol, HasOutputCol):
    models = Param("per-class fitted binary models", default=list)
    levels = Param("original label levels when labels were strings")

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("output_col", "scores")
        super().__init__(**kwargs)

    def _transform(self, dataset: Dataset) -> Dataset:
        cols = []
        for m in self.models:
            scored = m.transform(dataset)
            s = np.asarray(scored["scores"], np.float64)
            if s.ndim == 2 and s.shape[1] >= 2:
                # binary softmax scores -> positive-class log-odds margin
                cols.append(s[:, 1] - s[:, 0])
            else:
                cols.append(s.reshape(len(s)))
        scores = np.stack(cols, axis=1)
        return dataset.with_column(self.output_col, scores)
