"""Profiling hooks — the port of ``mmlspark_tpu/utils/profiling.py``:
``torch.profiler`` traces and named ranges, plus the telemetry plane's
public names re-exported from :mod:`mmlspark_tpu_torch.core.perf` and
:mod:`mmlspark_tpu_torch.core.telemetry`, so call sites have one
observability import. ``analyze_program_cost`` stands where the JAX
module re-exports ``analyze_jit_cost``: the port costs a program
family's eager body on ``meta`` tensors instead of a jitted one."""

from __future__ import annotations

import contextlib
import json
import os
import time

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


#: the range :func:`clock_anchor` leaves on the profiler's timeline
CLOCK_ANCHOR = "serve.clock_anchor"

#: what :func:`annotate` returns while no profiler runs: one shared
#: context that does nothing
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Context manager writing a ``torch.profiler`` trace of the block —
    host ranges, and the card's kernels and copies when one is present —
    as a Chrome-trace JSON file under ``log_dir`` (what
    ``jax.profiler.trace`` is in the JAX package; Perfetto opens it)::

        with trace_profile("traces"):
            model.transform(ds)

    The file's top-level ``clock_offset_ns`` maps the program's clock
    onto the trace: ``time.perf_counter_ns() + clock_offset_ns`` is the
    Unix-epoch nanosecond of the trace's events (their ``ts`` is in
    microseconds after the file's ``baseTimeNanoseconds``), so a
    ``TelemetryHub.export_trace``, a flight-recorder dump (whose
    ``time.monotonic`` is the same clock on Linux) or a request's
    ``submitted_at`` / ``admitted_at`` / ``first_token_at`` overlay it.
    """
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        stamp = clock_anchor()
        yield log_dir
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{id(prof):x}.json")
    prof.export_chrome_trace(path)
    offset = clock_offset_ns(prof, stamp)
    if offset is not None:
        with open(path) as f:
            trace = json.load(f)
        trace["clock_offset_ns"] = offset
        with open(path, "w") as f:
            json.dump(trace, f)
    _log.info("profiler trace written to %s", path)


def annotate(name: str):
    """A named range on the profiler's timeline (``torch.profiler``'s
    ``record_function``, as ``jax.profiler.TraceAnnotation`` is in the
    JAX package): the serving engine's phases run under these, so a
    trace of the card groups the device work of each phase under its
    name. While no profiler runs it returns one shared null context:
    0.5 us a use on an H100 machine's host CPU, where ``record_function``
    costs 8 us, and 10 us with a profiler running. Syncs nothing."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def clock_anchor() -> int | None:
    """While a profiler runs: leave empty :data:`CLOCK_ANCHOR` ranges on
    its timeline and return the ``time.perf_counter_ns()`` at which the
    last one started — the pair ties the program's clock to the trace's
    (:func:`clock_offset_ns`). None, and no range, while none runs.

    The first ranges after a profiler starts begin up to ~1 ms after
    the call that opens them (its range path warms up), so the stamp
    goes with the third, at the midpoint of the clock read either side
    of its start: a few microseconds from it on a CPU core."""
    if not torch._C._autograd._profiler_enabled():
        return None
    for _ in range(3):
        before = time.perf_counter_ns()
        with torch.profiler.record_function(CLOCK_ANCHOR):
            inside = time.perf_counter_ns()
    return (before + inside) // 2


def clock_offset_ns(prof, stamp: int | None) -> int | None:
    """What maps the program's clock onto a stopped profiler's events:
    ``trace_start_ns + start_us * 1e3 - stamp`` of the last
    :data:`CLOCK_ANCHOR` range, which :func:`clock_anchor` left and
    returned ``stamp`` for, so that ``perf_counter_ns + offset`` is an
    event time in Unix-epoch ns. None without the range."""
    starts = [e.time_range.start for e in prof.events()
              if e.name == CLOCK_ANCHOR]
    if stamp is None or not starts:
        return None
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    return int(round(start_ns + max(starts) * 1e3)) - stamp
