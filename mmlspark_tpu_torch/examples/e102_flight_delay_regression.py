"""Notebook-102 parity: TrainRegressor on a REAL table.

Reference flow (notebooks/samples/102 - Regression Example with Flight
Delay Dataset.ipynb): read flight table -> TrainRegressor -> score ->
ComputeModelStatistics + ComputePerInstanceStatistics. The reference
installs the real On-Time Performance CSV at build time
(tools/config.sh:62-117); with no egress here, the committed REAL table
is the UCI Relative CPU Performance set (tests/fixtures/machine_cpu.csv,
209 machines, extracted from the scikit-learn wheel by
tools/make_fixtures.py) — the same shape of problem: categorical column
(vendor ~ carrier) + numerics, continuous target. The flight-shaped
synthetic generator stays as the fallback when the fixture is absent.
"""

import os


from mmlspark_tpu_torch.stages.eval_metrics import (
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
)
from mmlspark_tpu_torch.stages.train_regressor import TrainRegressor

FIXTURE = os.path.join(
    os.path.dirname(__file__), "..", "..", "tests", "fixtures", "machine_cpu.csv"
)


def load_real_or_synthetic():
    """(train, test, label_col, r2_floor)."""
    if os.path.exists(FIXTURE):
        from mmlspark_tpu_torch.data.readers import read_csv

        ds = read_csv(FIXTURE)
        test, train = ds.random_split(0.25, seed=0)
        return train, test, "performance", 0.5
    from mmlspark_tpu_torch.testing.datagen import make_flights

    return make_flights(seed=3), make_flights(n=250, seed=4), "arr_delay", 0.5


def main():
    from mmlspark_tpu_torch.stages.find_best import FindBestModel

    train, test, label, floor = load_real_or_synthetic()
    # the notebook trains linear + tree-family regressors (each with its
    # own knobs) and compares; rank with FindBestModel like its
    # evaluation cells
    configs = [
        dict(model="linear_regression", epochs=120, learning_rate=5e-2),
        dict(model="gbt", max_iter=60),
        dict(model="random_forest", num_trees=30),
    ]
    candidates = [
        TrainRegressor(label_col=label, **cfg).fit(train)
        for cfg in configs
    ]
    best = FindBestModel(models=candidates, evaluation_metric="R^2").fit(
        test
    )
    scored = best.best_model.transform(test)
    stats = ComputeModelStatistics().transform(scored)
    r2 = float(stats["R^2"][0])
    rmse = float(stats["root_mean_squared_error"][0])
    per = ComputePerInstanceStatistics().transform(scored)
    assert r2 > floor, f"R^2 {r2} too low (floor {floor})"
    assert per["L2_loss"].min() >= 0
    print(f"OK {{'R^2': {r2:.3f}, 'RMSE': {rmse:.2f}, "
          f"'rows': {len(train) + len(test)}, "
          f"'candidates': {len(best.all_model_metrics)}}}")


if __name__ == "__main__":
    main()
