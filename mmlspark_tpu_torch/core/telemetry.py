"""Metric registry and flight recorder — a trimmed copy of
``mmlspark_tpu/core/telemetry.py``, the pieces the trainer and the
serving metrics use.

- :class:`MetricRegistry` with :class:`Counter` / :class:`Gauge` /
  :class:`Histogram`. Histograms use deterministic log-bucketed bins:
  the same samples give the same quantiles in any arrival order, within
  one bucket's growth factor (10%), with exact count, sum, min and max.
- :class:`FlightRecorder`: a bounded ring buffer of structured events,
  dumped as JSON-lines when a :class:`FriendlyError` escapes a guarded
  block — the post-mortem of what happened right before a failure.
- :class:`RetraceWatchdog` / :func:`watch_retrace`: log every NEW program
  a counting callable makes (``testing/compile_guard.py``'s
  ``ProgramCountingGraph``: one CUDA graph per static signature), with
  the signature that made it.

Spans, the Prometheus exposition and snapshots are not ported (ROADMAP.md
Queue 1 item 12).
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator

from mmlspark_tpu_torch.core.exceptions import FriendlyError

_log = logging.getLogger("mmlspark_tpu_torch.telemetry")


class Counter:
    """Monotonic counter. ``inc`` only; resets belong to a new registry."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    def __init__(self, name: str):
        self.name = name
        self._value: float | None = None

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float | None:
        return self._value


class Histogram:
    """Log-bucketed histogram with deterministic quantiles: bucket ``i``
    covers ``(lo * growth**(i-1), lo * growth**i]`` for lo = 1e-3 and
    growth = 1.1 up to 1e8, values ``<= lo`` land in bucket 0 and larger
    ones in the last; quantiles return the bucket's geometric midpoint
    clamped into the exact ``[min, max]``."""

    lo = 1e-3
    growth = 1.1
    _log_growth = math.log(growth)
    n_buckets = 2 + math.ceil(math.log(1e8 / lo) / _log_growth)

    def __init__(self, name: str = ""):
        self.name = name
        self._counts = [0] * self.n_buckets
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def _bucket(self, value: float) -> int:
        if value <= self.lo:
            return 0
        idx = 1 + int(math.ceil(math.log(value / self.lo) / self._log_growth
                                - 1e-12))
        return min(idx, self.n_buckets - 1)

    def record(self, value: float) -> None:
        value = float(value)
        self._counts[self._bucket(value)] += 1
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def percentile(self, p: float) -> float | None:
        """Deterministic quantile estimate; None while empty."""
        if not self.count:
            return None
        rank = max(1, math.ceil(p / 100.0 * self.count))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                est = self.lo if i == 0 else self.lo * self.growth ** (i - 0.5)
                return min(max(est, self.min), self.max)
        return self.max  # unreachable

    @property
    def mean(self) -> float | None:
        return (self.sum / self.count) if self.count else None


class MetricRegistry:
    """Name -> metric map; get-or-create with type checking."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise FriendlyError(
                    f"metric '{name}' is already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def to_dict(self) -> dict:
        """Flat view: counters and gauges as scalars, histograms expanded
        to ``<name>_{count,mean,p50,p95,p99}``."""
        out: dict[str, Any] = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[f"{name}_count"] = m.count
                out[f"{name}_mean"] = m.mean
                for p in (50, 95, 99):
                    out[f"{name}_p{p}"] = m.percentile(p)
            else:
                out[name] = m.value
        return out


class FlightRecorder:
    """Bounded ring buffer of structured events: each one a flat dict of
    ``t`` (monotonic seconds), ``name``, an optional ``tick`` and an
    ``attrs`` dict. The buffer keeps the LAST ``capacity`` events."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise FriendlyError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: deque[dict] = deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()

    def record(self, name: str, *, tick: int | None = None,
               **attrs) -> None:
        ev: dict[str, Any] = {"t": time.monotonic(), "name": name}
        if tick is not None:
            ev["tick"] = tick
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def dump(self) -> str:
        """The buffered events as JSON-lines, after a header line."""
        events = self.events()
        header = json.dumps({"header": "flight_recorder",
                             "events": len(events), "dropped": self.dropped,
                             "capacity": self.capacity})
        return "\n".join(
            [header] + [json.dumps(ev, default=str) for ev in events]) + "\n"

    @contextlib.contextmanager
    def dump_on_friendly_error(self) -> Iterator["FlightRecorder"]:
        """Log the buffered events, then re-raise, when a
        :class:`FriendlyError` escapes the block: the failure itself
        triggers the evidence dump."""
        try:
            yield self
        except FriendlyError as e:
            _log.error("flight recorder dump on %s (last %d events):\n%s",
                       type(e).__name__, len(self._events), self.dump())
            raise


# --------------------------------------------------------------------------
# retrace watchdog
# --------------------------------------------------------------------------


def _describe_abstract(args: tuple, kwargs: dict, limit: int = 12) -> str:
    """``bfloat16[4,64,2,16]``-style rendering of a call's tensor leaves
    (and the repr of its other leaves) — the static signature that decides
    whether a call reuses a program. A copy of the JAX package's
    formatter over PyTorch's containers."""
    leaves: list = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            leaves.append(x)

    walk((args, kwargs))
    parts = []
    for leaf in leaves[:limit]:
        shape = getattr(leaf, "shape", None)
        if shape is None:
            parts.append(repr(leaf)[:32])
            continue
        dtype = str(getattr(leaf, "dtype", "?")).replace("torch.", "")
        parts.append(f"{dtype}[{','.join(str(d) for d in shape)}]")
    if len(leaves) > limit:
        parts.append(f"... +{len(leaves) - limit} leaves")
    return ", ".join(parts)


class RetraceWatchdog:
    """Wrap a program-counting callable; log every NEW program.

    Counting reads the ``_cache_size()`` contract that
    ``testing/compile_guard.py`` pins invariants with
    (:func:`~mmlspark_tpu_torch.testing.compile_guard.program_count`): the
    count is sampled after each call, and growth means the call's static
    signature made a new program. Programs within the
    ``expected_programs`` budget log at INFO (the expected warm-up: 1 for
    a training step, the ladder or bucket count for the serve engine's
    program families), every later one at WARNING, both with the
    triggering signature. Optionally mirrors into a registry counter
    (``retrace.<label>``) and a flight-recorder ``retrace`` event.
    """

    def __init__(self, fn: Callable, label: str, *,
                 registry: MetricRegistry | None = None,
                 recorder: FlightRecorder | None = None,
                 expected_programs: int = 1):
        from mmlspark_tpu_torch.testing.compile_guard import program_count

        self._fn = fn
        self._size_of = program_count
        self.label = label
        self.compilations = 0  # programs seen by THIS wrapper
        self.expected_programs = max(1, expected_programs)
        self._counter = (
            registry.counter(f"retrace.{label}")
            if registry is not None else None
        )
        self._recorder = recorder
        self._seen = max(0, program_count(fn))

    @property
    def retraces(self) -> int:
        """Programs beyond the expected budget."""
        return max(0, self.compilations - self.expected_programs)

    @property
    def capture_seconds(self) -> float:
        """The wrapped callable's capture time, where it keeps one."""
        return getattr(self._fn, "capture_seconds", 0.0)

    def _cache_size(self) -> int:
        """compile_guard-compatible counting passthrough."""
        return self._size_of(self._fn)

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        n = self._size_of(self._fn)
        if n > self._seen:
            new = n - self._seen
            self.compilations += new
            self._seen = n
            sig = _describe_abstract(args, kwargs)
            level = (
                _log.info
                if self.compilations <= self.expected_programs
                else _log.warning
            )
            level(
                "retrace[%s]: %d new program(s) made (total %d) for "
                "signature (%s)",
                self.label, new, n, sig,
            )
            if self._counter is not None:
                self._counter.inc(new)
            if self._recorder is not None:
                self._recorder.record(
                    "retrace", label=self.label, new_programs=new,
                    total_programs=n, signature=sig,
                )
        return out


def watch_retrace(fn: Callable, label: str, *,
                  registry: MetricRegistry | None = None,
                  recorder: FlightRecorder | None = None) -> RetraceWatchdog:
    """Functional spelling of :class:`RetraceWatchdog`."""
    return RetraceWatchdog(fn, label, registry=registry, recorder=recorder)
