"""Profiling hooks — the port of ``mmlspark_tpu/utils/profiling.py``:
``torch.profiler`` traces and named ranges, plus the telemetry plane's
public names re-exported from :mod:`mmlspark_tpu_torch.core.perf` and
:mod:`mmlspark_tpu_torch.core.telemetry`, so call sites have one
observability import. ``analyze_program_cost`` stands where the JAX
module re-exports ``analyze_jit_cost``: the port costs a program
family's eager body on ``meta`` tensors instead of a jitted one."""

from __future__ import annotations

import contextlib
import os

import torch

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.perf import (  # noqa: F401 — re-exports
    DevicePeak,
    PerfAnalytics,
    ProgramCost,
    SloMonitor,
    SloTargets,
    analyze_program_cost,
    device_peak,
    export_chrome_trace,
    parse_slo_spec,
)
from mmlspark_tpu_torch.core.telemetry import (  # noqa: F401 — re-exports
    Counter,
    FlightRecorder,
    Gauge,
    Histogram,
    MetricRegistry,
    RetraceWatchdog,
    Span,
    SpanTracer,
    default_registry,
    watch_retrace,
)

_log = get_logger("profiling")


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Context manager writing a ``torch.profiler`` trace of the block —
    host ranges, and the card's kernels and copies when one is present —
    as a Chrome-trace JSON file under ``log_dir`` (what
    ``jax.profiler.trace`` is in the JAX package; Perfetto opens it)::

        with trace_profile("traces"):
            model.transform(ds)
    """
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{id(prof):x}.json")
    prof.export_chrome_trace(path)
    _log.info("profiler trace written to %s", path)


def annotate(name: str):
    """A named range on the profiler's timeline (``torch.profiler``'s
    ``record_function``, as ``jax.profiler.TraceAnnotation`` is in the
    JAX package): the serving engine's admit, prefill, hand-off and
    decode phases run under one, so a trace of the card groups the
    device work of each phase under its name. Costs one host-side range
    push and pop when no profiler is running; syncs nothing."""
    return torch.profiler.record_function(name)
