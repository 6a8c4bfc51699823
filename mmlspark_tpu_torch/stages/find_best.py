"""FindBestModel — model selection over an evaluation dataset.

Reference: find-best-model/src/main/scala/FindBestModel.scala:24-230
(evaluate each trained model with ComputeModelStatistics on one metric,
higher/lower-is-better dispatch, keep best + all-model metrics table + ROC
of the best model).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.stages.eval_metrics import ComputeModelStatistics

#: metric -> higher is better?
_METRIC_DIRECTION = {
    "accuracy": True,
    "precision_macro": True,
    "recall_macro": True,
    "precision_micro": True,
    "recall_micro": True,
    "AUC": True,
    "R^2": True,
    "mean_squared_error": False,
    "root_mean_squared_error": False,
    "mean_absolute_error": False,
    "log_loss": False,
}


class FindBestModel(Estimator):
    models = Param("candidate fitted models", default=list)
    evaluation_metric = Param("metric to rank by", "accuracy", ptype=str)

    def _fit(self, dataset: Dataset) -> "BestModel":
        if not self.models:
            raise FriendlyError("no candidate models given", self.uid)
        metric = self.evaluation_metric
        if metric not in _METRIC_DIRECTION:
            raise FriendlyError(
                f"unknown metric '{metric}'; known: "
                f"{sorted(_METRIC_DIRECTION)}",
                self.uid,
            )
        higher_better = _METRIC_DIRECTION[metric]
        rows: list[dict] = []
        best_idx, best_val, best_roc = -1, None, None
        for i, model in enumerate(self.models):
            scored = model.transform(dataset)
            evaluator = ComputeModelStatistics(model=model.uid)
            stats = evaluator.transform(scored)
            row = {"model": model.uid, **{c: stats[c][0] for c in stats.columns}}
            rows.append(row)
            if metric not in row:
                raise FriendlyError(
                    f"metric '{metric}' not produced for model {model.uid} "
                    f"(got {sorted(row)})",
                    self.uid,
                )
            val = float(row[metric])
            if (
                best_val is None
                or (higher_better and val > best_val)
                or (not higher_better and val < best_val)
            ):
                best_idx, best_val, best_roc = i, val, evaluator.roc_curve
        all_cols = sorted({k for r in rows for k in r})
        table = Dataset(
            {c: [r.get(c, np.nan) for r in rows] for c in all_cols}
        )
        return BestModel(
            best_model=self.models[best_idx],
            best_metric_value=best_val,
            evaluation_metric=metric,
            all_model_metrics=table,
            roc_curve=best_roc,
        )


class BestModel(Model):
    best_model = Param("the winning fitted model")
    best_metric_value = Param("winning metric value")
    evaluation_metric = Param("metric ranked by", "accuracy", ptype=str)
    all_model_metrics = Param("metrics table over all candidates")
    roc_curve = Param("ROC points of the best model (binary cls only)")

    def _transform(self, dataset: Dataset) -> Dataset:
        return self.best_model.transform(dataset)
