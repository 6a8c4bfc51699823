"""ComputeModelStatistics / ComputePerInstanceStatistics — zero-config
evaluation keyed off schema metadata.

Reference: compute-model-statistics/src/main/scala/
ComputeModelStatistics.scala:82-567 (discovers label/scored columns from
column metadata — ``getSchemaInfo`` :213-226 — so no column config is
needed; classification: confusion matrix, accuracy, Sokolova-Lapalme
micro/macro precision/recall (:383-437), AUC via 1000-bin ROC (:439-455);
regression: MSE/RMSE/R^2/MAE (:189-207)) and compute-per-instance-statistics/
.../ComputePerInstanceStatistics.scala:40-96 (per-row log_loss with
eps=1e-15, L1/L2 loss).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError, SchemaError
from mmlspark_tpu_torch.core.metrics_contracts import MetricData
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.schema import (
    CLASSIFICATION,
    REGRESSION,
    find_label_column,
    find_scored_labels_column,
    find_scored_probabilities_column,
    get_score_value_kind,
)
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.data.dataset import Dataset

ROC_BINS = 1000  # ComputeModelStatistics.scala:78
LOG_LOSS_EPS = 1e-15  # ComputePerInstanceStatistics log_loss epsilon


def _schema_info(dataset: Dataset, model: str | None):
    """Discover evaluation inputs from metadata (getSchemaInfo analog)."""
    label = find_label_column(dataset, model)
    scored = find_scored_labels_column(dataset, model)
    kind = get_score_value_kind(dataset, model)
    if label is None or scored is None:
        raise SchemaError(
            "dataset carries no score-column metadata; run a Train* model "
            "first or set evaluation_metric + columns explicitly"
        )
    return label, scored, kind


def _encode_labels(y_true, y_pred, order=None):
    """Map arbitrary label values to shared integer codes. ``order`` (the
    producing model's level ordering, from categorical metadata) keeps codes
    aligned with the columns of scored_probabilities; unseen values are
    appended after."""
    seen = set(list(y_true)) | set(list(y_pred))
    if order is not None:
        levels = list(order) + sorted(seen - set(order), key=repr)
    else:
        levels = sorted(seen, key=repr)
    lookup = {v: i for i, v in enumerate(levels)}
    t = np.asarray([lookup[v] for v in y_true])
    p = np.asarray([lookup[v] for v in y_pred])
    return t, p, levels


def classification_metrics(y_true, y_pred, order=None) -> dict:
    """Accuracy + Sokolova-Lapalme micro/macro precision/recall."""
    t, p, levels = _encode_labels(y_true, y_pred, order)
    n = len(levels)
    cm = np.zeros((n, n), dtype=np.int64)
    np.add.at(cm, (t, p), 1)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)
    predicted = cm.sum(axis=0).astype(np.float64)
    total = cm.sum()
    accuracy = tp.sum() / max(total, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_prec = np.where(predicted > 0, tp / predicted, 0.0)
        per_rec = np.where(support > 0, tp / support, 0.0)
    macro_prec = float(per_prec.mean()) if n else 0.0
    macro_rec = float(per_rec.mean()) if n else 0.0
    # micro-averaged precision == recall == accuracy in single-label tasks
    micro = float(accuracy)
    return {
        "accuracy": float(accuracy),
        "precision_macro": macro_prec,
        "recall_macro": macro_rec,
        "precision_micro": micro,
        "recall_micro": micro,
        "confusion_matrix": cm,
        "levels": levels,
    }


def binary_auc(y_true01: np.ndarray, prob1: np.ndarray, bins: int = ROC_BINS):
    """AUC via binned ROC (reference binning=1000,
    ComputeModelStatistics.scala:439-455). One histogram pass + cumsum —
    O(n + bins), not O(n * bins). Returns (auc, roc_points)."""
    y = np.asarray(y_true01)
    p = np.clip(np.asarray(prob1, dtype=np.float64), 0.0, 1.0)
    edges = np.linspace(0.0, 1.0, bins + 1)
    pos_hist, _ = np.histogram(p[y == 1], bins=edges)
    neg_hist, _ = np.histogram(p[y == 0], bins=edges)
    pos = max(int(pos_hist.sum()), 1)
    neg = max(int(neg_hist.sum()), 1)
    # threshold sweep from 1.0 down to 0.0: cumulative counts from the top
    tpr = np.concatenate([[0.0], np.cumsum(pos_hist[::-1])]) / pos
    fpr = np.concatenate([[0.0], np.cumsum(neg_hist[::-1])]) / neg
    auc = float(np.trapezoid(tpr, fpr))
    return auc, np.stack([fpr, tpr], axis=1)


def regression_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    err = y_pred - y_true
    mse = float(np.mean(err**2))
    mae = float(np.mean(np.abs(err)))
    var = float(np.var(y_true))
    r2 = 1.0 - mse / var if var > 0 else 0.0
    return {
        "mean_squared_error": mse,
        "root_mean_squared_error": float(np.sqrt(mse)),
        "mean_absolute_error": mae,
        "R^2": float(r2),
    }


class ComputeModelStatistics(Transformer):
    """transform(scored dataset) -> one-row metrics Dataset. The confusion
    matrix and ROC curve are exposed as attributes after transform (the
    reference surfaces them as DataFrames/MetricData,
    ComputeModelStatistics.scala:494-529)."""

    evaluation_metric = Param(
        "task kind", "auto", domain=("auto", "classification", "regression")
    )
    model = Param("producing model uid (None = discover)")
    label_col = Param("explicit label column (overrides metadata)")
    scores_col = Param("explicit scored-labels column (overrides metadata)")

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.confusion_matrix: np.ndarray | None = None
        self.roc_curve: np.ndarray | None = None
        self.metrics: list[MetricData] = []

    def _transform(self, dataset: Dataset) -> Dataset:
        if self.label_col and self.scores_col:
            label, scored = self.label_col, self.scores_col
            kind = (
                None if self.evaluation_metric == "auto"
                else self.evaluation_metric
            )
        else:
            label, scored, kind = _schema_info(dataset, self.model)
        if self.evaluation_metric != "auto":
            kind = self.evaluation_metric
        if kind is None:
            raise FriendlyError("cannot infer task kind; set evaluation_metric",
                                self.uid)

        if kind == CLASSIFICATION:
            # class order from the producing model's categorical metadata —
            # keeps codes aligned with scored_probabilities columns
            cat = dataset.meta_of(scored).categorical
            if cat is None:
                cat = dataset.meta_of(label).categorical
            order = list(cat.levels) if cat is not None else None
            stats = classification_metrics(
                dataset[label], dataset[scored], order
            )
            self.confusion_matrix = stats.pop("confusion_matrix")
            levels = stats.pop("levels")
            prob_col = find_scored_probabilities_column(dataset, self.model)
            if prob_col is not None and len(levels) == 2:
                probs = np.asarray(dataset[prob_col], dtype=np.float64)
                t, _, _ = _encode_labels(
                    dataset[label], dataset[scored], order
                )
                auc, roc = binary_auc(t, probs[:, 1])
                stats["AUC"] = auc
                self.roc_curve = roc
            self.metrics = [
                MetricData.create(k, v, self.model) for k, v in stats.items()
            ]
            return Dataset({k: [v] for k, v in stats.items()})

        if kind == REGRESSION:
            y = np.asarray(dataset[label], dtype=np.float64)
            p = np.asarray(dataset[scored], dtype=np.float64)
            stats = regression_metrics(y, p)
            self.metrics = [
                MetricData.create(k, v, self.model) for k, v in stats.items()
            ]
            return Dataset({k: [v] for k, v in stats.items()})

        raise FriendlyError(f"unknown evaluation kind '{kind}'", self.uid)


class ComputePerInstanceStatistics(Transformer):
    """Per-row metrics: log_loss (classification), L1/L2 loss (regression)
    (reference ComputePerInstanceStatistics.scala:40-96)."""

    model = Param("producing model uid (None = discover)")

    def _transform(self, dataset: Dataset) -> Dataset:
        label, scored, kind = _schema_info(dataset, self.model)
        if kind == CLASSIFICATION:
            prob_col = find_scored_probabilities_column(dataset, self.model)
            if prob_col is None:
                raise FriendlyError(
                    "per-instance log_loss needs scored probabilities",
                    self.uid,
                )
            probs = np.asarray(dataset[prob_col], dtype=np.float64)
            cat = dataset.meta_of(scored).categorical
            order = list(cat.levels) if cat is not None else None
            t, _, levels = _encode_labels(dataset[label], dataset[scored], order)
            if len(t) and t.max() >= probs.shape[1]:
                bad = levels[int(t.max())]
                raise FriendlyError(
                    f"label value {bad!r} was never seen by the model "
                    f"({probs.shape[1]} classes); cannot score it",
                    self.uid,
                )
            # clip like the reference (eps=1e-15)
            p_true = np.clip(
                probs[np.arange(len(t)), t], LOG_LOSS_EPS, 1 - LOG_LOSS_EPS
            )
            return dataset.with_column("log_loss", -np.log(p_true))
        y = np.asarray(dataset[label], dtype=np.float64)
        p = np.asarray(dataset[scored], dtype=np.float64)
        ds = dataset.with_column("L1_loss", np.abs(p - y))
        return ds.with_column("L2_loss", (p - y) ** 2)
