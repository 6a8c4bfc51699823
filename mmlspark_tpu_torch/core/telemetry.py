"""The telemetry plane — the port of ``mmlspark_tpu/core/telemetry.py``:
metric registry, trace spans, flight recorder and retrace watchdog.

- :class:`MetricRegistry` with :class:`Counter` / :class:`Gauge` /
  :class:`Histogram`. Histograms use deterministic log-bucketed bins:
  the same samples give the same quantiles in any arrival order, within
  one bucket's growth factor (10% by default), with exact count, sum,
  min and max. The registry exports a flat dict (:meth:`to_dict`), the
  Prometheus text exposition (:meth:`to_prometheus`, format 0.0.4:
  counters with ``_total``, histograms as cumulative ``_bucket{le=...}``
  series with ``_sum`` and ``_count``) and structured
  :class:`~mmlspark_tpu_torch.core.metrics_contracts.MetricData` records
  (:meth:`snapshot`). :class:`NamespacedRegistry` prefixes every name
  registered through it, so several subsystems share one exposition.
- :class:`Span` + :class:`SpanTracer`: structured events (name, attrs,
  tick, monotonic time) grouped by span id — the serving engine opens
  one span per request lifecycle.
- :class:`FlightRecorder`: a bounded ring buffer of those events, dumped
  as JSON-lines on demand (:meth:`FlightRecorder.dump`, atomically when
  given a path) and when a :class:`FriendlyError` escapes a guarded
  block (:meth:`FlightRecorder.dump_on_friendly_error`). Its
  ``t0_unix`` anchor turns an event's monotonic ``t`` into wall time.
- :class:`RetraceWatchdog` / :func:`watch_retrace`: log every NEW program
  a counting callable makes (``testing/compile_guard.py``'s
  ``ProgramCountingGraph``: one CUDA graph per static signature), with
  the signature that made it.

Stdlib only, apart from the watchdog's program counter. The same calls
give the same Prometheus text, histogram summaries and dumps as the JAX
package's module.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.metrics_contracts import MetricData

_log = logging.getLogger("mmlspark_tpu_torch.telemetry")


def atomic_write_text(path: str, text: str) -> None:
    """Torn-write-safe text dump: write a temporary file in the target
    directory, fsync, then ``os.replace`` it onto the final name, so a
    kill mid-dump leaves the previous file or the complete new one."""
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path),
        prefix=os.path.basename(path) + ".", suffix=".tmp",
    )
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # the commit point
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_json(path: str, doc, **dump_kwargs) -> None:
    """:func:`atomic_write_text` for a JSON document."""
    atomic_write_text(path, json.dumps(doc, **dump_kwargs))


# --------------------------------------------------------------------------
# metric primitives
# --------------------------------------------------------------------------


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
    """Last-write-wins scalar (queue depth, utilization, ...)."""

    def __init__(self, name: str):
        self.name = name
        self._value: float | None = None

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float | None:
        return self._value


class Histogram:
    """Log-bucketed histogram with deterministic quantiles.

    Bucket ``i`` covers ``(lo * growth**(i-1), lo * growth**i]``; values
    ``<= lo`` land in bucket 0 and values above the top edge in the last
    (overflow) bucket. Quantiles walk the cumulative counts and return
    the bucket's geometric midpoint, clamped into the exactly-tracked
    ``[min, max]``: two histograms fed the same samples in any order
    report the same p50/p95/p99, within one ``growth`` factor."""

    def __init__(self, name: str, *, lo: float = 1e-3, hi: float = 1e8,
                 growth: float = 1.1):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise FriendlyError(
                f"histogram '{name}' needs 0 < lo < hi and growth > 1, "
                f"got lo={lo} hi={hi} growth={growth}"
            )
        self.name = name
        self.lo = lo
        self.growth = growth
        self._log_growth = math.log(growth)
        self.n_buckets = 2 + math.ceil(math.log(hi / lo) / self._log_growth)
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

    def bucket_bounds(self) -> list[float | str]:
        """Upper edge of each bucket, aligned with :meth:`bucket_counts`:
        bucket 0's is ``lo``, the overflow bucket's the string
        ``"+Inf"`` (Prometheus' ``le`` spelling; JSON has no Infinity)."""
        edges: list[float | str] = [self.lo]
        for i in range(1, self.n_buckets - 1):
            edges.append(self.lo * self.growth ** i)
        edges.append("+Inf")
        return edges

    def bucket_counts(self) -> list[int]:
        """Per-bucket observation counts (not cumulative), aligned with
        :meth:`bucket_bounds`."""
        return list(self._counts)

    def summary(self) -> dict:
        """count/sum/mean/min/max, p50/p95/p99 and the buckets up to the
        last occupied one (leading empties kept so edges align by
        index)."""
        last = 0
        for i, c in enumerate(self._counts):
            if c:
                last = i + 1
        bounds = self.bucket_bounds()[:last]
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.mean, 6) if self.count else None,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": {
                "bounds": [
                    b if isinstance(b, str) else round(b, 9)
                    for b in bounds
                ],
                "counts": self._counts[:last],
            },
        }


class MetricRegistry:
    """Name -> metric map; get-or-create with type checking. One
    process-wide default lives behind :func:`default_registry`; engines
    and trainers build their own."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
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

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self._get_or_create(name, Histogram, **kwargs)

    def get(self, name: str):
        return self._metrics.get(name)

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
                s = m.summary()
                for k in ("count", "mean", "p50", "p95", "p99"):
                    out[f"{name}_{k}"] = s[k]
            else:
                out[name] = m.value
        return out

    def prom_series(
        self, labels: dict | None = None,
    ) -> Iterator[tuple[str, str, list[str]]]:
        """Per-metric exposition pieces ``(prom_name, type, sample
        lines)``, ``labels`` rendered (escaped) on every sample line."""
        for name in self.names():
            m = self._metrics[name]
            pname = _prom_name(name)
            lbl = _prom_labels(labels)
            if isinstance(m, Counter):
                # a dotted name that already ends in _total keeps one
                if not pname.endswith("_total"):
                    pname += "_total"
                yield pname, "counter", [f"{pname}{lbl} {m.value}"]
            elif isinstance(m, Gauge):
                if m.value is None:
                    continue
                yield pname, "gauge", [f"{pname}{lbl} {_prom_num(m.value)}"]
            elif isinstance(m, Histogram):
                lines: list[str] = []
                cum = 0
                bounds = m.bucket_bounds()
                for edge, c in zip(bounds, m.bucket_counts()):
                    cum += c
                    if c == 0 and edge != "+Inf":
                        continue  # occupied edges and +Inf only
                    le = edge if isinstance(edge, str) else _prom_num(edge)
                    blbl = _prom_labels(labels, {"le": le})
                    lines.append(f"{pname}_bucket{blbl} {cum}")
                lines.append(f"{pname}_sum{lbl} {_prom_num(m.sum)}")
                lines.append(f"{pname}_count{lbl} {m.count}")
                yield pname, "histogram", lines

    def to_prometheus(self, labels: dict | None = None) -> str:
        """Prometheus text exposition (format 0.0.4): dotted names become
        underscored, counters get ``_total``, histograms emit cumulative
        ``_bucket{le="..."}`` series (each occupied edge and ``+Inf``)
        with ``_sum`` and ``_count``; ``labels`` stamps every sample."""
        out: list[str] = []
        for pname, mtype, lines in self.prom_series(labels):
            out.append(f"# TYPE {pname} {mtype}")
            out.extend(lines)
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self, model: str | None = None,
                 group: str | None = None) -> list[MetricData]:
        """Structured records: one :class:`MetricData` per set scalar,
        a ``create_table`` summary per histogram."""
        out: list[MetricData] = []
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out.append(MetricData.create_table(name, m.summary(), model))
            elif m.value is not None:
                out.append(MetricData(name=name, value=float(m.value),
                                      model=model, group=group))
        return out


def _prom_name(name: str) -> str:
    """Registry names are dotted; Prometheus names are
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    cleaned = "".join(
        c if c.isalnum() or c in "_:" else "_" for c in name
    )
    if cleaned and cleaned[0].isdigit():
        cleaned = "_" + cleaned
    return cleaned or "_"


def _prom_num(value: float) -> str:
    """Integers without a trailing ``.0``, other floats by repr."""
    f = float(value)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _prom_escape_label_value(value) -> str:
    """Label-value escaping of the text format: backslash, double quote
    and newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_labels(labels: dict | None, extra: dict | None = None) -> str:
    """``{replica="0",le="+Inf"}``-style rendering (escaped, insertion
    order kept); empty without labels."""
    items = {**(labels or {}), **(extra or {})}
    if not items:
        return ""
    inner = ",".join(
        f'{_prom_name(str(k))}="{_prom_escape_label_value(v)}"'
        for k, v in items.items()
    )
    return "{" + inner + "}"


class NamespacedRegistry:
    """A prefixing view over a shared :class:`MetricRegistry`: every
    ``counter``/``gauge``/``histogram`` name gets ``namespace`` in front,
    so N subsystems share one registry (one exposition) without
    collisions — the metrics other code registers against the handed-in
    registry (``perf.*``, ``slo.*``, ``retrace.*``) included. The read
    side (``to_dict``, ``to_prometheus``, ``snapshot``) covers the whole
    inner registry."""

    def __init__(self, inner: MetricRegistry, namespace: str):
        self._inner = inner
        self.namespace = namespace

    def counter(self, name: str) -> Counter:
        return self._inner.counter(f"{self.namespace}{name}")

    def gauge(self, name: str) -> Gauge:
        return self._inner.gauge(f"{self.namespace}{name}")

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self._inner.histogram(f"{self.namespace}{name}", **kwargs)

    def get(self, name: str):
        return self._inner.get(f"{self.namespace}{name}")

    def names(self) -> list[str]:
        return self._inner.names()

    def to_dict(self) -> dict:
        return self._inner.to_dict()

    def to_prometheus(self, labels: dict | None = None) -> str:
        return self._inner.to_prometheus(labels)

    def prom_series(self, labels: dict | None = None):
        return self._inner.prom_series(labels)

    def snapshot(self, model: str | None = None,
                 group: str | None = None):
        return self._inner.snapshot(model=model, group=group)


_DEFAULT_REGISTRY = MetricRegistry()


def default_registry() -> MetricRegistry:
    """The process-wide registry, for ad-hoc call sites."""
    return _DEFAULT_REGISTRY


# --------------------------------------------------------------------------
# spans and the flight recorder
# --------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring buffer of structured events: each one a flat dict of
    ``t`` (monotonic seconds), ``name``, optional ``tick`` / ``span`` /
    ``span_name`` and an ``attrs`` dict. The buffer keeps the LAST
    ``capacity`` events (``dropped`` counts evictions). ``t0_unix`` is
    the epoch time at monotonic zero: ``t0_unix + ev["t"]`` is an
    event's wall time, which lines recorders of different processes up
    on one timeline."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise FriendlyError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: deque[dict] = deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()
        self.t0_unix = time.time() - time.monotonic()

    def record(self, name: str, *, tick: int | None = None,
               span: int | None = None, span_name: str | None = None,
               **attrs) -> None:
        ev: dict[str, Any] = {"t": time.monotonic(), "name": name}
        if tick is not None:
            ev["tick"] = tick
        if span is not None:
            ev["span"] = span
        if span_name is not None:
            ev["span_name"] = span_name
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def dump(self, path: str | None = None) -> str:
        """The buffered events as JSON-lines after a header line
        (``{"header": "flight_recorder", "t0_unix": ..., ...}``); written
        atomically to ``path`` when given, returned either way."""
        events = self.events()
        header = json.dumps({
            "header": "flight_recorder",
            "t0_unix": round(self.t0_unix, 6),
            "events": len(events),
            "dropped": self.dropped,
            "capacity": self.capacity,
        })
        lines = "\n".join(
            [header] + [json.dumps(ev, default=str) for ev in events]
        ) + "\n"
        if path is not None:
            atomic_write_text(path, lines)
            _log.info("flight recorder: %d events -> %s", len(events), path)
        return lines

    @contextlib.contextmanager
    def dump_on_friendly_error(
        self, path: str | None = None,
        exc_types: tuple = (FriendlyError,),
    ) -> Iterator["FlightRecorder"]:
        """Dump the buffered events (to ``path``, or the error log), then
        re-raise, when one of ``exc_types`` escapes the block: the
        failure itself triggers the evidence dump."""
        try:
            yield self
        except exc_types as e:
            dumped = self.dump(path)
            if path is None:
                _log.error(
                    "flight recorder dump on %s (last %d events):\n%s",
                    type(e).__name__, len(self._events), dumped,
                )
            raise


class Span:
    """One traced unit of work (a serve request). Serving spans live
    across many engine ticks, so the lifecycle is explicit: ``event()``
    per phase, ``end()`` once with the terminal status."""

    def __init__(self, recorder: FlightRecorder, name: str, span_id: int,
                 tick: int | None = None, **attrs):
        self._recorder = recorder
        self.name = name
        self.id = span_id
        self.t0 = time.monotonic()
        self.ended = False
        self._recorder.record("start", tick=tick, span=span_id,
                              span_name=name, **attrs)

    def event(self, name: str, *, tick: int | None = None, **attrs) -> None:
        self._recorder.record(name, tick=tick, span=self.id,
                              span_name=self.name, **attrs)

    def end(self, status: str = "ok", *, tick: int | None = None,
            **attrs) -> None:
        if self.ended:
            return
        self.ended = True
        self._recorder.record(
            status, tick=tick, span=self.id, span_name=self.name,
            duration_ms=round((time.monotonic() - self.t0) * 1e3, 3),
            **attrs,
        )


class SpanTracer:
    """Hands out :class:`Span` objects with unique ids over one
    :class:`FlightRecorder`."""

    def __init__(self, recorder: FlightRecorder):
        self.recorder = recorder
        self._next_id = 0
        self._lock = threading.Lock()

    def span(self, name: str, *, tick: int | None = None, **attrs) -> Span:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        return Span(self.recorder, name, sid, tick=tick, **attrs)


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
