"""Learner-benchmark matrix — the port's copy of
``mmlspark_tpu/testing/benchmark_metrics.py``: the same datasets, learners
and seeds, run through the port's stages on ``device`` (``None``: the
card), so its rows can be held to the JAX package's recorded CSVs
(``tests/fixtures/benchmark_metrics*.csv``).

Mirrors the reference's benchmark-verification idea: a fixed set of
datasets x the full built-in learner list, each trained and scored with
deterministic seeds, producing one (accuracy, AUC) row per combination
(VerifyTrainClassifier.scala:41-42,148-240 with benchmarkMetrics.csv).
One definition here keeps the generator (tools/make_benchmark_metrics.py)
and the regression test (tests/test_benchmark_metrics.py) on exactly the
same matrix.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.testing.datagen import make_census, make_flights

#: the reference's supported-learner sweep (TrainClassifier.scala:45-52);
#: like the reference's CSV, the learner list varies per dataset —
#: naive Bayes (non-negative features only, the Spark MLlib restriction)
#: is benchmarked on the count-like census tables only
ALL_LEARNERS = (
    "logistic_regression",
    "decision_tree",
    "random_forest",
    "gbt",
    "naive_bayes",
    "mlp",
)
NO_NB = tuple(l for l in ALL_LEARNERS if l != "naive_bayes")


def _multiclass(n: int, seed: int) -> Dataset:
    """Three classes derivable from the features (a broken learner cannot
    hide at chance level) with 10% label noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    score = np.stack(
        [x[:, 0] + x[:, 1], x[:, 2] - x[:, 0], x[:, 3] - x[:, 1]], axis=1
    )
    y = score.argmax(axis=1)
    flip = rng.random(n) < 0.10
    y = np.where(flip, rng.integers(0, 3, n), y).astype(np.int64)
    cols = {f"num_{i}": x[:, i] for i in range(4)}
    cols["cat"] = list(rng.choice(["alpha", "beta", "gamma"], n))
    cols["label"] = y
    return Dataset(cols)


def _noisy_binary(n: int, seed: int) -> Dataset:
    """A hard binary task: informative numerics + label noise."""
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    noise = rng.normal(size=n)
    flip = rng.random(n) < 0.15
    y = ((x1 + 0.7 * x2 > 0) ^ flip).astype(np.int64)
    return Dataset({"a": x1, "b": x2, "noise": noise, "label": y})


def datasets() -> dict[str, tuple[Dataset, Dataset, str, tuple]]:
    """name -> (train, test, label_col, learners); all seeded."""
    return {
        "census_full": (
            make_census(1500, seed=7, full_schema=True),
            make_census(500, seed=8, full_schema=True),
            "income",
            ALL_LEARNERS,
        ),
        "census_compact": (
            make_census(1200, seed=9),
            make_census(400, seed=10),
            "income",
            ALL_LEARNERS,
        ),
        "noisy_binary": (
            _noisy_binary(1200, seed=11),
            _noisy_binary(400, seed=12),
            "label",
            NO_NB,
        ),
        "multiclass": (
            _multiclass(900, seed=13),
            _multiclass(300, seed=14),
            "label",
            NO_NB,
        ),
    }


@dataclass(frozen=True)
class BenchRow:
    dataset: str
    learner: str
    accuracy: float
    auc: str  # formatted to 4 decimals, or "" for multiclass


def run_matrix(device: str | None = None) -> list[BenchRow]:
    """Every (dataset, learner) row, trained on ``device``."""
    from mmlspark_tpu_torch.stages.eval_metrics import ComputeModelStatistics
    from mmlspark_tpu_torch.stages.train_classifier import TrainClassifier

    rows: list[BenchRow] = []
    for ds_name, (train, test, label, learners) in datasets().items():
        for learner in learners:
            kwargs = {"label_col": label, "model": learner, "seed": 0,
                      "device": device}
            if learner in ("logistic_regression", "mlp"):
                # NN knobs only — an explicit learning_rate would also
                # override GBT's Spark-default step_size 0.1
                kwargs.update(epochs=12, learning_rate=5e-2)
            model = TrainClassifier(**kwargs).fit(train)
            stats = ComputeModelStatistics().transform(model.transform(test))
            acc = float(stats["accuracy"][0])
            auc = (
                f"{float(stats['AUC'][0]):.4f}" if "AUC" in stats else ""
            )
            rows.append(BenchRow(ds_name, learner, acc, auc))
    return rows


#: TrainRegressor's supported-learner sweep (TrainRegressor.scala:21-130)
REGRESSORS = (
    "linear_regression",
    "decision_tree",
    "random_forest",
    "gbt",
    "mlp",
)


def _linear_noise(n: int, seed: int) -> Dataset:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5))
    y = x @ np.array([2.0, -1.0, 0.5, 0.0, 0.0]) + rng.normal(0, 0.5, n)
    cols = {f"x{i}": x[:, i] for i in range(5)}
    cols["target"] = y
    return Dataset(cols)


@dataclass(frozen=True)
class RegBenchRow:
    dataset: str
    learner: str
    r2: float
    rmse: float


def regression_datasets() -> dict[str, tuple[Dataset, Dataset, str]]:
    return {
        "flights": (
            make_flights(800, seed=3),
            make_flights(250, seed=4),
            "arr_delay",
        ),
        "linear_noise": (
            _linear_noise(800, seed=21),
            _linear_noise(250, seed=22),
            "target",
        ),
    }


def run_regressor_matrix(device: str | None = None) -> list[RegBenchRow]:
    """Every (dataset, regressor) row, trained on ``device``."""
    from mmlspark_tpu_torch.stages.eval_metrics import ComputeModelStatistics
    from mmlspark_tpu_torch.stages.train_regressor import TrainRegressor

    rows: list[RegBenchRow] = []
    for ds_name, (train, test, label) in regression_datasets().items():
        for learner in REGRESSORS:
            kwargs = {"label_col": label, "model": learner, "seed": 0,
                      "device": device}
            if learner in ("linear_regression", "mlp"):
                kwargs.update(epochs=80, learning_rate=5e-2)
            model = TrainRegressor(**kwargs).fit(train)
            stats = ComputeModelStatistics().transform(model.transform(test))
            rows.append(RegBenchRow(
                ds_name, learner,
                float(stats["R^2"][0]),
                float(stats["root_mean_squared_error"][0]),
            ))
    return rows


#: the JAX test's tolerance on every recorded metric
#: (tests/test_benchmark_metrics.py): the tree and naive-Bayes rows
TOL = 0.015
#: the logistic-regression, linear-regression and MLP rows train from the
#: port's initial weights (``torch.Generator`` draws from the seed), not
#: flax's, in bf16 on both sides: a learner of the same recipe from other
#: weights. Their gap to the recorded rows is held to this and reported
#: row by row (PERF.md)
NN_TOL = 0.05
NN_LEARNERS = ("logistic_regression", "linear_regression", "mlp")

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")


def _recorded(name: str) -> dict:
    with open(os.path.join(FIXTURES, name)) as f:
        return {(r["dataset"], r["learner"]): r for r in csv.DictReader(f)}


def compare_to_recorded(rows: list, regression: bool = False) -> dict:
    """Each row's gap to the recorded CSV row of its (dataset, learner),
    and the rows past their tolerance: ``{"gaps": {"dataset/learner":
    {metric: gap}}, "mismatches": [...], "missing": [...]}``. RMSE is
    target-scale, so its gap is relative to the recorded value, as in the
    JAX test."""
    recorded = _recorded("benchmark_metrics_regression.csv" if regression
                         else "benchmark_metrics.csv")
    out = {"gaps": {}, "mismatches": [], "missing": []}
    for r in rows:
        want = recorded.get((r.dataset, r.learner))
        key = f"{r.dataset}/{r.learner}"
        if want is None:
            out["missing"].append(key)
            continue
        tol = NN_TOL if r.learner in NN_LEARNERS else TOL
        if regression:
            gaps = {"r2": r.r2 - float(want["r2"]),
                    "rmse_rel": (r.rmse - float(want["rmse"]))
                    / max(1.0, float(want["rmse"]))}
        else:
            gaps = {"accuracy": r.accuracy - float(want["accuracy"])}
            if bool(want["auc"]) != bool(r.auc):
                out["mismatches"].append(f"{key}: AUC presence changed")
            elif want["auc"]:
                gaps["auc"] = float(r.auc) - float(want["auc"])
        out["gaps"][key] = gaps
        out["mismatches"] += [f"{key}: {m} off by {g:+.4f} (tol {tol})"
                              for m, g in gaps.items() if abs(g) > tol]
    return out
