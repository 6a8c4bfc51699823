"""Data-prep stages — the port of ``mmlspark_tpu/stages/prep.py`` (host
numpy; ``Timer``'s profiler trace is a ``torch.profiler`` trace here).

Reference modules (SURVEY.md §2.7): pipeline-stages (Cacher, CheckpointData,
DropColumns, SelectColumns, Repartition, ClassBalancer, Timer),
clean-missing-data, data-conversion, partition-sample, summarize-data,
multi-column-adapter.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.params import (
    HasInputCols,
    HasOutputCols,
    Param,
    in_unit_interval,
    positive,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model, Transformer
from mmlspark_tpu_torch.data.dataset import Dataset

_log = get_logger("stages")


class Cacher(Transformer):
    """Materialization hint (reference Cacher persists the DataFrame;
    Datasets here are host-materialized already, so this is the identity
    with the same pipeline role)."""

    def _transform(self, dataset: Dataset) -> Dataset:
        return dataset


class CheckpointData(Transformer):
    """Persist the dataset to disk and reload (reference
    checkpoint-data/.../CheckpointData.scala:13-62; disk option maps to an
    on-disk column store, remove_checkpoint drops it after load)."""

    checkpoint_dir = Param("directory to persist into", required=True)
    remove_checkpoint = Param("delete files after reload", False, ptype=bool)

    def _transform(self, dataset: Dataset) -> Dataset:
        import shutil

        from mmlspark_tpu_torch.core.serialize import load_dataset, save_dataset

        save_dataset(dataset, self.checkpoint_dir)
        out = load_dataset(self.checkpoint_dir)
        if self.remove_checkpoint:
            shutil.rmtree(self.checkpoint_dir, ignore_errors=True)
        return out


class DropColumns(Transformer):
    cols = Param("columns to drop", default=list)

    def _transform(self, dataset: Dataset) -> Dataset:
        dataset.require(*self.cols)
        return dataset.drop(*self.cols)


class SelectColumns(Transformer):
    cols = Param("columns to keep", default=list)

    def _transform(self, dataset: Dataset) -> Dataset:
        return dataset.select(*self.cols)


class Repartition(Transformer):
    """Set the dataset's partition count (reference Repartition stage; here
    partitioning advises the host feed pipeline, not cluster shuffles)."""

    n = Param("partition count", 1, ptype=int, validator=positive)

    def _transform(self, dataset: Dataset) -> Dataset:
        return dataset.with_partitions(self.n)


class ClassBalancer(Estimator):
    """Inverse-frequency observation weights (reference ClassBalancer:
    weight = max_count/count per label level)."""

    input_col = Param("label column", "label", ptype=str)
    output_col = Param("weight column", "weight", ptype=str)

    def _fit(self, dataset: Dataset) -> "ClassBalancerModel":
        dataset.require(self.input_col)
        values, counts = np.unique(
            np.asarray(dataset[self.input_col], dtype=object), return_counts=True
        )
        weights = counts.max() / counts
        return ClassBalancerModel(
            input_col=self.input_col,
            output_col=self.output_col,
            table={v: float(w) for v, w in zip(values.tolist(), weights)},
        )


class ClassBalancerModel(Model):
    input_col = Param("label column", "label", ptype=str)
    output_col = Param("weight column", "weight", ptype=str)
    table = Param("level -> weight", default=dict)

    def _transform(self, dataset: Dataset) -> Dataset:
        w = np.array(
            [self.table.get(v, 1.0) for v in dataset[self.input_col]],
            dtype=np.float64,
        )
        return dataset.with_column(self.output_col, w)


class Timer(Transformer):
    """Wrap a stage and log wall time of fit/transform (reference
    pipeline-stages/.../Timer.scala:14-123). The wrapped stage's output is
    returned unchanged; timings accumulate on ``records``."""

    stage = Param("wrapped stage", required=True)
    log_to_scala = Param("log timings (name kept for parity)", True, ptype=bool)
    profile_dir = Param(
        "when set, also capture a torch.profiler trace of each timed op "
        "under this directory (Chrome/Perfetto viewable)"
    )

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self.records: list[dict] = []

    def _time(self, what: str, fn, dataset: Dataset):
        import contextlib

        if self.profile_dir:
            from mmlspark_tpu_torch.utils.profiling import trace_profile

            ctx: Any = trace_profile(self.profile_dir)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            result = fn(dataset)
        dt = time.perf_counter() - t0
        rec = {
            "stage": getattr(self.stage, "uid", str(self.stage)),
            "op": what,
            "seconds": dt,
            "rows": dataset.num_rows,
        }
        self.records.append(rec)
        if self.log_to_scala:
            _log.info("%(stage)s %(op)s took %(seconds).3fs on %(rows)d rows",
                      rec)
        return result

    def _transform(self, dataset: Dataset) -> Dataset:
        stage = self.stage
        if isinstance(stage, Estimator):
            model = self._time("fit", stage.fit, dataset)
            return self._time("transform", model.transform, dataset)
        return self._time("transform", stage.transform, dataset)


class CleanMissingData(Estimator):
    """Imputation: Mean / Median / Custom fill per column (reference
    clean-missing-data/src/main/scala/CleanMissingData.scala:14-45)."""

    MEAN, MEDIAN, CUSTOM = "Mean", "Median", "Custom"

    input_cols = Param("columns to clean", default=list)
    output_cols = Param("output columns (default: in place)")
    cleaning_mode = Param("imputation mode", "Mean",
                          domain=("Mean", "Median", "Custom"))
    custom_value = Param("fill value for Custom mode")

    def _fit(self, dataset: Dataset) -> "CleanMissingDataModel":
        explicit = bool(self.input_cols)
        cols = list(self.input_cols or dataset.columns)
        dataset.require(*cols)
        if not explicit:
            # zero-config mode imputes the numeric columns only
            cols = [
                c
                for c in cols
                if dataset[c].dtype != object and dataset[c].dtype.kind in "iuf"
            ]
        fills: dict[str, float] = {}
        for c in cols:
            try:
                arr = np.asarray(dataset[c], dtype=np.float64)
            except (ValueError, TypeError):
                raise FriendlyError(
                    f"column '{c}' is not numeric; CleanMissingData imputes "
                    "numeric columns",
                    self.uid,
                )
            if self.cleaning_mode == self.MEAN:
                fills[c] = float(np.nanmean(arr)) if not np.all(np.isnan(arr)) else 0.0
            elif self.cleaning_mode == self.MEDIAN:
                all_nan = np.all(np.isnan(arr))
                fills[c] = float(np.nanmedian(arr)) if not all_nan else 0.0
            else:
                if self.custom_value is None:
                    raise FriendlyError("Custom mode needs custom_value", self.uid)
                fills[c] = float(self.custom_value)
        out_cols = self.output_cols or cols
        return CleanMissingDataModel(
            input_cols=list(cols), output_cols=list(out_cols), fills=fills
        )


class CleanMissingDataModel(Model, HasInputCols, HasOutputCols):
    fills = Param("column -> fill value", default=dict)

    def _transform(self, dataset: Dataset) -> Dataset:
        out = dataset
        for c_in, c_out in zip(self.input_cols, self.output_cols):
            arr = np.asarray(out[c_in], dtype=np.float64).copy()
            arr[np.isnan(arr)] = self.fills[c_in]
            out = out.with_column(c_out, arr)
        return out


class DataConversion(Transformer):
    """Column type casting incl. date<->string (reference
    data-conversion/src/main/scala/DataConversion.scala:23-66)."""

    cols = Param("columns to convert", default=list)
    convert_to = Param(
        "target type",
        "double",
        domain=("boolean", "byte", "short", "integer", "long", "float",
                "double", "string", "toCategorical", "clearCategorical",
                "date"),
    )
    date_time_format = Param("strftime format for date<->string",
                             "%Y-%m-%d %H:%M:%S", ptype=str)

    _NUMPY = {
        "boolean": np.bool_, "byte": np.int8, "short": np.int16,
        "integer": np.int32, "long": np.int64, "float": np.float32,
        "double": np.float64,
    }

    def _transform(self, dataset: Dataset) -> Dataset:

        out = dataset
        for c in self.cols:
            out.require(c)
            arr = out[c]
            if self.convert_to in self._NUMPY:
                out = out.with_column(
                    c, np.asarray(arr).astype(self._NUMPY[self.convert_to])
                )
            elif self.convert_to == "string":
                if arr.dtype.kind == "M":
                    import pandas as pd

                    s = pd.Series(arr).dt.strftime(self.date_time_format)
                    out = out.with_column(c, list(s))
                else:
                    out = out.with_column(c, [str(v) for v in arr])
            elif self.convert_to == "date":
                import pandas as pd

                s = pd.to_datetime(
                    pd.Series(list(arr)), format=self.date_time_format
                )
                out = out.with_column(c, s.to_numpy())
            elif self.convert_to == "toCategorical":
                from mmlspark_tpu_torch.stages.value_indexer import ValueIndexer

                model = ValueIndexer(input_col=c, output_col=c).fit(out)
                out = model.transform(out)
            elif self.convert_to == "clearCategorical":
                meta = out.meta_of(c)
                cat = meta.categorical
                if cat is not None:
                    levels = list(cat.levels) + ([None] if cat.has_null else [])
                    vals = [levels[int(i)] for i in arr]
                    out = out.with_column(c, vals, meta.evolve(categorical=None))
        return out


class PartitionSample(Transformer):
    """Head / RandomSample (absolute or percent) / AssignToPartition
    (reference partition-sample/.../PartitionSample.scala:13-135)."""

    mode = Param("sampling mode", "RandomSample",
                 domain=("Head", "RandomSample", "AssignToPartition"))
    count = Param("rows for Head or absolute RandomSample", 1000, ptype=int)
    percent = Param("fraction for percent RandomSample", 0.1, ptype=float,
                    validator=in_unit_interval)
    random_sample_mode = Param("Absolute | Percentage", "Percentage",
                               domain=("Absolute", "Percentage"))
    seed = Param("rng seed", 0, ptype=int)
    num_parts = Param("partitions for AssignToPartition", 10, ptype=int,
                      validator=positive)
    partition_col = Param("partition-id column name", "Partition", ptype=str)

    def _transform(self, dataset: Dataset) -> Dataset:
        if self.mode == "Head":
            return dataset.take(self.count)
        if self.mode == "RandomSample":
            if self.random_sample_mode == "Absolute":
                return dataset.sample(n=self.count, seed=self.seed)
            return dataset.sample(fraction=self.percent, seed=self.seed)
        rng = np.random.default_rng(self.seed)
        ids = rng.integers(0, self.num_parts, size=dataset.num_rows)
        return dataset.with_column(
            self.partition_col, ids.astype(np.int32)
        ).with_partitions(self.num_parts)


class SummarizeData(Transformer):
    """Per-column statistics table (reference
    summarize-data/.../SummarizeData.scala:22-98: counts / basic / sample /
    percentiles blocks, error threshold ignored — exact quantiles here)."""

    counts = Param("include count/unique/missing", True, ptype=bool)
    basic = Param("include min/max/mean/stddev", True, ptype=bool)
    sample = Param("include variance/skew/kurtosis", True, ptype=bool)
    percentiles = Param("include P0.5..P99.5", True, ptype=bool)
    error_threshold = Param("approx-quantile error (parity param)", 0.0,
                            ptype=float)

    _PCTS = (0.005, 0.25, 0.5, 0.75, 0.995)

    def _transform(self, dataset: Dataset) -> Dataset:
        rows: dict[str, list] = {"Feature": []}

        def put(name, value):
            rows.setdefault(name, []).append(value)

        for c in dataset.columns:
            arr = dataset[c]
            rows["Feature"].append(c)
            is_num = arr.dtype != object and arr.dtype.kind in "biuf"
            f = np.asarray(arr, dtype=np.float64) if is_num else None
            valid = f[~np.isnan(f)] if f is not None else None
            if self.counts:
                put("Count", dataset.num_rows)
                if arr.dtype == object:
                    vals = [v for v in arr if v is not None]
                    put("Unique Value Count", len(set(vals)))
                    put("Missing Value Count", dataset.num_rows - len(vals))
                else:
                    put("Unique Value Count", len(np.unique(arr)))
                    put("Missing Value Count",
                        int(np.isnan(f).sum()) if f is not None else 0)
            if self.basic:
                have = valid is not None and len(valid) > 0
                put("Min", float(valid.min()) if have else np.nan)
                put("Max", float(valid.max()) if have else np.nan)
                put("Mean", float(valid.mean()) if have else np.nan)
                put("Standard Deviation",
                    float(valid.std(ddof=1))
                    if have and len(valid) > 1 else np.nan)
            if self.sample:
                if valid is not None and len(valid) > 2:
                    m = valid.mean()
                    s = valid.std(ddof=0)
                    z = (valid - m) / s if s > 0 else valid * 0
                    put("Sample Variance", float(valid.var(ddof=1)))
                    put("Sample Skewness", float(np.mean(z**3)))
                    put("Sample Kurtosis", float(np.mean(z**4) - 3))
                else:
                    put("Sample Variance", np.nan)
                    put("Sample Skewness", np.nan)
                    put("Sample Kurtosis", np.nan)
            if self.percentiles:
                for p in self._PCTS:
                    put(
                        f"P{p * 100:g}",
                        float(np.quantile(valid, p))
                        if valid is not None and len(valid)
                        else np.nan,
                    )
        return Dataset(rows)


class MultiColumnAdapter(Transformer):
    """Apply a unary stage across paired input/output column lists
    (reference multi-column-adapter/.../MultiColumnAdapter.scala:17-53)."""

    base_stage = Param("unary stage with input_col/output_col params",
                       required=True)
    input_cols = Param("input columns", default=list)
    output_cols = Param("output columns", default=list)

    def _transform(self, dataset: Dataset) -> Dataset:
        if len(self.input_cols) != len(self.output_cols):
            raise FriendlyError(
                "input_cols and output_cols must pair up", self.uid
            )
        out = dataset
        for c_in, c_out in zip(self.input_cols, self.output_cols):
            stage = self.base_stage.copy(input_col=c_in, output_col=c_out)
            if isinstance(stage, Estimator):
                out = stage.fit(out).transform(out)
            else:
                out = stage.transform(out)
        return out
