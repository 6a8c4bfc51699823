"""Profiling hooks — the port of ``annotate`` and ``trace_profile`` from
``mmlspark_tpu/utils/profiling.py``. The module's re-exports of the
telemetry plane wait with the rest of the surface (ROADMAP.md Queue 1
item 14)."""

from __future__ import annotations

import contextlib
import os

import torch

from mmlspark_tpu_torch.core.logging_utils import get_logger

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
