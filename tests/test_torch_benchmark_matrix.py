"""The port's recorded-metrics matrix: every (dataset, learner) row of
``mmlspark_tpu_torch/testing/benchmark_metrics.py`` retrained through the
port's ``TrainClassifier``/``TrainRegressor`` on the CPU and held to the
JAX package's recorded CSVs (``tests/fixtures/benchmark_metrics*.csv``,
VerifyTrainClassifier.scala's benchmarkMetrics.csv). The tree and
naive-Bayes rows are held to the JAX test's ``TOL``; the logistic,
linear and MLP rows train from the port's own initial weights and are
held to ``NN_TOL``. No JAX runs here.
"""

from __future__ import annotations

import pytest
import torch

from mmlspark_tpu_torch.testing.benchmark_metrics import (
    ALL_LEARNERS,
    NN_LEARNERS,
    NN_TOL,
    REGRESSORS,
    TOL,
    _recorded,
    compare_to_recorded,
    run_matrix,
    run_regressor_matrix,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its tensors are small, so one
    thread is faster and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tolerances():
    assert TOL == 0.015  # tests/test_benchmark_metrics.py
    assert TOL < NN_TOL <= 0.05


@pytest.fixture(scope="module")
def classifier_rows():
    return run_matrix(device="cpu")


@pytest.fixture(scope="module")
def regressor_rows():
    return run_regressor_matrix(device="cpu")


@pytest.mark.parametrize("learner", ALL_LEARNERS)
def test_classifier_rows_match_recorded(learner, classifier_rows):
    rows = [r for r in classifier_rows if r.learner == learner]
    recorded = {k for k in _recorded("benchmark_metrics.csv")
                if k[1] == learner}
    assert {(r.dataset, r.learner) for r in rows} == recorded
    out = compare_to_recorded(rows)
    assert not out["missing"] and not out["mismatches"], out
    if learner not in NN_LEARNERS:
        assert all(abs(g) <= TOL for gaps in out["gaps"].values()
                   for g in gaps.values())


@pytest.mark.parametrize("learner", REGRESSORS)
def test_regressor_rows_match_recorded(learner, regressor_rows):
    rows = [r for r in regressor_rows if r.learner == learner]
    recorded = {k for k in _recorded("benchmark_metrics_regression.csv")
                if k[1] == learner}
    assert {(r.dataset, r.learner) for r in rows} == recorded
    out = compare_to_recorded(rows, regression=True)
    assert not out["missing"] and not out["mismatches"], out
