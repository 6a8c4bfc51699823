"""Profiling hooks — the port of ``annotate`` from
``mmlspark_tpu/utils/profiling.py``. The rest of that module waits with
the rest of the surface (ROADMAP.md Queue 1 item 14)."""

from __future__ import annotations

import torch


def annotate(name: str):
    """A named range on the profiler's timeline (``torch.profiler``'s
    ``record_function``, as ``jax.profiler.TraceAnnotation`` is in the
    JAX package): the serving engine's admit, prefill, hand-off and
    decode phases run under one, so a trace of the card groups the
    device work of each phase under its name. Costs one host-side range
    push and pop when no profiler is running; syncs nothing."""
    return torch.profiler.record_function(name)
