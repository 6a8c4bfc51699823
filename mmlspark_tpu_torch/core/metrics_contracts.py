"""Metric value records — the port's copy of
``mmlspark_tpu/core/metrics_contracts.py`` (``MetricData`` with
``create`` and ``create_table``), which the telemetry plane's
``snapshot()`` views return."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class MetricData:
    """One named scalar or table metric attached to a model/stage uid."""

    name: str
    value: Any
    model: str | None = None
    group: str | None = None
    extra: dict = field(default_factory=dict)

    @staticmethod
    def create(name: str, value: float,
               model: str | None = None) -> "MetricData":
        return MetricData(name=name, value=float(value), model=model)

    @staticmethod
    def create_table(name: str, rows: dict,
                     model: str | None = None) -> "MetricData":
        return MetricData(name=name, value=rows, model=model, group="table")
