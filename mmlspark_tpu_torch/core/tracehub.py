"""Fleet-wide telemetry hub: merged timelines, stitched traces, alerts —
the port of ``mmlspark_tpu/core/tracehub.py``.

Every serving component keeps its OWN flight recorder and metric
registry — a :class:`~mmlspark_tpu_torch.serve.engine.ServeEngine` per
replica, the :class:`~mmlspark_tpu_torch.serve.supervisor.ReplicaSet` /
:class:`~mmlspark_tpu_torch.serve.fleet.DisaggFleet` control planes, the
multi-model facade, the trainer. That isolation keeps replicas free of
each other's locks and names, but a request that prefills on replica 0,
hands off to replica 2 and replays after a failover leaves its evidence
in four recorders.

:class:`TelemetryHub` is the read-side merge point:

- **sources**: ``(name, recorder, registry, labels)`` registered directly
  (:meth:`TelemetryHub.add_source`) or found by provider callbacks on
  each refresh (:meth:`TelemetryHub.add_provider`) — how the hub keeps
  up with engines a control plane REPLACES on failover (the rebuilt one
  is a new generation, labeled ``gen="1"``) and replicas an autoscaler
  spawns mid-run.
- **merged timeline**: every recorder anchors its monotonic events on
  its ``t0_unix`` wall clock, so :meth:`TelemetryHub.merged_events`
  interleaves N recorders into one ordered list (and
  :meth:`TelemetryHub.dump_events` one ``events.jsonl``).
- **causal chains**: requests carry a set-wide ``trace_id`` stamped at
  submit and threaded through routing, hand-offs, hedge twins, failover
  replays and drain migrations; :meth:`TelemetryHub.request_chains`
  groups the merged timeline by it.
- **merged exports**: ONE Perfetto-loadable Chrome trace with a process
  per source and ``trace_id``-bound flow arrows crossing replica tracks
  (:meth:`TelemetryHub.export_trace`), ONE label-based Prometheus
  exposition (``{replica="0",model="lm"}`` labels instead of name
  prefixes, :meth:`TelemetryHub.to_prometheus`), ONE merged metrics dict
  (:meth:`TelemetryHub.metrics_dict`), and the bundle of all of them
  (:meth:`TelemetryHub.write_bundle`).
- **topology**: a mesh engine's source carries ``{mesh="data=2,model=2",
  rank="r"}`` labels beside its own (each rank of a mesh engine keeps its
  own recorder and registry; a hub reads the rank it runs on).
- **anomaly detectors**: :meth:`TelemetryHub.detect` sweeps every source
  for retrace storms, host-syncs-per-block drift, queue-depth watermarks,
  tick-time p99 blowups and uneven SLO burn, emitting ``alert`` events on
  the hub's own recorder and ``alerts.*`` counters.
- **live surface**: :class:`MetricsServer` serves ``/metrics`` /
  ``/traces`` / ``/healthz`` from a stdlib ``http.server`` thread on
  127.0.0.1.

The hub only READS host-side Python state — deques, dicts, counters. It
never touches a tensor, so attaching it adds no program and no host sync
per decode block (``tests/test_torch_tracehub.py``).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterable

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.telemetry import (
    Counter,
    FlightRecorder,
    Histogram,
    MetricRegistry,
    atomic_write_json,
    atomic_write_text,
)

_log = get_logger("tracehub")

#: terminal request-span statuses (mirrors core/perf.py's exporter)
_TERMINAL = ("completed", "expired", "failed", "stalled", "handed_off")

#: per-source track ids in the merged trace: engine-plane tracks first,
#: request tracks offset past them so they can never collide
_TID_TICKS = 0
_TID_DISPATCH = 1
_TID_EVENTS = 2
_TID_REQUEST_BASE = 10

#: every alert kind :meth:`TelemetryHub.detect` can raise; the
#: ``alerts.{kind}`` counters are pre-registered at 0 so the merged
#: exposition and metrics dict always carry the full catalog
ALERT_KINDS = (
    "retrace_storm",
    "host_sync_regression",
    "queue_watermark",
    "tick_p99_drift",
    "slo_burn_spread",
)

#: detector thresholds (override per-key via ``TelemetryHub(thresholds=
#: {...})``). ``retrace_storm`` counts COMPILATIONS under one watchdog
#: label — warm-up legitimately compiles the decode ladder + prefill
#: buckets, so the default sits well above any expected family size.
#: ``host_syncs_per_block`` is the design invariant itself: one fetch
#: (== one ``dispatch`` event) per fused decode block.
DEFAULT_THRESHOLDS: dict[str, float] = {
    "retrace_storm": 32,
    "host_syncs_per_block": 1.0,
    "queue_high": 8,
    "tick_p99_drift_factor": 50.0,
    "tick_p99_min_count": 20,
}


@dataclass
class TelemetrySource:
    """One registered telemetry producer.

    ``recorder`` may be None for metrics-only sources (the multi-model
    per-deployment views share ONE recorder — registering it once
    keeps the merged timeline duplicate-free). ``labels`` stamp every
    Prometheus sample line from this source; ``stats`` is an optional
    host-side callable feeding the live detectors (queue depth, decode
    block counts)."""

    name: str
    display: str
    pid: int
    recorder: FlightRecorder | None = None
    registry: Any = None
    labels: dict = field(default_factory=dict)
    stats: Callable[[], dict] | None = None


class _ViewMap:
    """Mapping facade that lets :class:`_RegistryView` reuse
    ``MetricRegistry``'s read-side methods verbatim (they index
    ``self._metrics[name]`` with names from ``self.names()``)."""

    def __init__(self, view: "_RegistryView"):
        self._view = view

    def __getitem__(self, name: str):
        m = self._view.get(name)
        if m is None:
            raise KeyError(name)
        return m


class _RegistryView(MetricRegistry):
    """Read-only projection of another registry.

    ``prefix`` restricts the view to names under it (stripped) — how
    the hub turns the multi-model engine's ``model{name}.serve.*``
    name-prefix namespacing into ``serve.*{model="name"}`` labeled
    series. ``strip_prefix`` keeps EVERY name but removes the prefix
    where present — how per-replica engines' ``replica{idx}.serve.*``
    names fold into one fleet-wide ``serve.*`` family told apart by
    ``{replica="idx"}`` labels (their ``perf.*``/``slo.*`` names are
    un-prefixed and pass through). ``exclude_prefixes`` filters on the
    ORIGINAL (inner) names."""

    def __init__(self, inner, prefix: str = "",
                 strip_prefix: str = "",
                 exclude_prefixes: tuple = ()):
        super().__init__()
        self._inner = inner
        self._prefix = prefix
        self._strip = strip_prefix
        self._exclude = tuple(exclude_prefixes)
        self._metrics = _ViewMap(self)  # type: ignore[assignment]

    def _get_or_create(self, name, cls, **kwargs):
        raise FriendlyError(
            "registry views are read-only: register metrics on the "
            "underlying registry, not on a TelemetryHub projection"
        )

    def names(self) -> list[str]:
        out = []
        for n in self._inner.names():
            if any(n.startswith(e) for e in self._exclude):
                continue
            if self._prefix:
                if not n.startswith(self._prefix):
                    continue
                n = n[len(self._prefix):]
            elif self._strip and n.startswith(self._strip):
                n = n[len(self._strip):]
            out.append(n)
        return sorted(out)

    def get(self, name: str):
        if self._prefix:
            return self._inner.get(self._prefix + name)
        if self._strip:
            m = self._inner.get(self._strip + name)
            if m is not None:
                return m
        return self._inner.get(name)


def _strip_replica_view(engine, idx: int) -> "_RegistryView":
    """Per-replica engines namespace their own serve.* names
    (``replica{idx}.serve.ttft_ms``); the merged exposition wants ONE
    ``serve_ttft_ms`` family with ``{replica="idx"}`` labels instead,
    so the hub reads them through a prefix-stripping view."""
    return _RegistryView(engine.metrics.registry,
                         strip_prefix=f"replica{idx}.")


def _topology(engine) -> dict:
    """The labels of a mesh engine's place: its mesh (``"data=2,
    model=2"``) and the rank the telemetry comes from (every rank of a
    mesh keeps its own recorder and registry); {} on one device."""
    place = getattr(engine, "_place", None)
    if place is None:
        return {}
    import torch.distributed as dist

    return {"mesh": ",".join(f"{a}={n}" for a, n in place.shape.items()),
            "rank": str(dist.get_rank())}


def _engine_stats(engine) -> Callable[[], dict]:
    """Host-side live figures for the detectors — plain attribute and
    dict reads, no device access."""

    def stats() -> dict:
        return {
            "queue_depth": engine.queue_depth,
            "decode_blocks": sum(engine.metrics.decode_blocks.values()),
        }

    return stats


def _meta(name: str, pid: int, tid: int, args: dict) -> dict:
    return {"name": name, "ph": "M", "pid": pid, "tid": tid,
            "args": args, "ts": 0.0}


def _instant_args(ev: dict) -> dict:
    args = dict(ev.get("attrs", {}))
    if "tick" in ev:
        args["tick"] = ev["tick"]
    return args


class TelemetryHub:
    """Merge N recorders + registries into one observability surface.

    The hub owns a recorder (alert events land there) and a registry
    (the ``alerts.*`` counters) of its own, registered as source
    ``hub`` — so its output is subject to the same merge, export and
    scrape paths as every other source.
    """

    def __init__(self, *, thresholds: dict | None = None):
        unknown = set(thresholds or {}) - set(DEFAULT_THRESHOLDS)
        if unknown:
            raise FriendlyError(
                f"unknown detector threshold(s) {sorted(unknown)}; "
                f"known: {sorted(DEFAULT_THRESHOLDS)}"
            )
        self.thresholds = {**DEFAULT_THRESHOLDS, **(thresholds or {})}
        self.registry = MetricRegistry()
        self.recorder = FlightRecorder()
        self._sources: list[TelemetrySource] = []
        #: (name, producer identity) -> source; the identity key is
        #: what makes re-registration idempotent while still catching a
        #: REPLACED engine (failover builds a fresh recorder under the
        #: same replica name -> new key -> new generation)
        self._keys: dict[tuple, TelemetrySource] = {}
        self._gen: dict[str, int] = {}
        self._providers: list[Callable[[], Iterable[dict]]] = []
        self._lock = threading.Lock()
        # the full alert catalog exists from tick zero: dashboards and
        # the schema gate can rely on every alerts.* key being present
        self._alerts = {
            kind: self.registry.counter(f"alerts.{kind}")
            for kind in ALERT_KINDS
        }
        self._alerted: set = set()
        self.add_source("hub", recorder=self.recorder,
                        registry=self.registry)

    # -- source registration ------------------------------------------------

    def add_source(self, name: str, *, recorder=None, registry=None,
                   labels: dict | None = None,
                   stats: Callable[[], dict] | None = None,
                   ) -> TelemetrySource:
        """Register one producer; idempotent for the same (name,
        recorder-or-registry) pair. A NEW producer under an existing
        name becomes the next generation: display name ``name#1`` and a
        ``gen="1"`` label, so a rebuilt post-failover engine never
        collides with its predecessor's Prometheus series."""
        if recorder is None and registry is None:
            raise FriendlyError(
                f"source '{name}' needs a recorder, a registry, or both"
            )
        key = (name,
               id(recorder) if recorder is not None else id(registry))
        with self._lock:
            src = self._keys.get(key)
            if src is not None:
                return src
            gen = self._gen.get(name, 0)
            self._gen[name] = gen + 1
            labels = dict(labels or {})
            display = name
            if gen:
                display = f"{name}#{gen}"
                labels["gen"] = str(gen)
            src = TelemetrySource(
                name=name, display=display, pid=len(self._sources) + 1,
                recorder=recorder, registry=registry, labels=labels,
                stats=stats,
            )
            self._sources.append(src)
            self._keys[key] = src
            return src

    def add_provider(self, fn: Callable[[], Iterable[dict]]) -> None:
        """Register a discovery callback: called on every
        :meth:`refresh`, yielding :meth:`add_source` kwargs dicts. The
        mechanism that tracks replica sets whose engines are replaced
        (failover) or spawned (autoscaling) after attach time."""
        self._providers.append(fn)
        self.refresh()

    def refresh(self) -> None:
        """Re-run every provider so newly spawned / rebuilt engines
        become sources before a merge, export, scrape or detect."""
        for fn in self._providers:
            for spec in fn():
                self.add_source(**spec)

    def sources(self) -> list[TelemetrySource]:
        self.refresh()
        return list(self._sources)

    # -- component attachments ----------------------------------------------

    def attach_engine(self, engine, name: str = "engine",
                      labels: dict | None = None) -> TelemetrySource:
        """One standalone :class:`ServeEngine` (trainer registries ride
        the generic :meth:`add_source` instead — they already share one
        recorder/registry pair across restarts)."""
        return self.add_source(
            name, recorder=engine.recorder,
            registry=engine.metrics.registry,
            labels={**_topology(engine), **(labels or {})} or None,
            stats=_engine_stats(engine),
        )

    def attach_replicaset(self, rs) -> None:
        """The supervisor's control-plane recorder/registry plus a
        provider over its live replica list."""
        self.add_source("supervisor", recorder=rs.recorder,
                        registry=rs.registry)

        def provider() -> Iterable[dict]:
            # the supervisor REPLACES rep.engine on failover; walking
            # the live list each refresh is what catches the rebuild
            for rep in rs._reps:
                labels = {"replica": str(rep.idx), **_topology(rep.engine)}
                if rep.model:
                    labels["model"] = rep.model
                yield dict(
                    name=f"replica{rep.idx}",
                    recorder=rep.engine.recorder,
                    registry=_strip_replica_view(rep.engine, rep.idx),
                    labels=labels, stats=_engine_stats(rep.engine),
                )

        self.add_provider(provider)

    def attach_fleet(self, fleet) -> None:
        """The disagg fleet's control plane plus a provider over its
        prefill/decode replicas (autoscaled spawns included)."""
        self.add_source("fleet", recorder=fleet.recorder,
                        registry=fleet.registry)

        def provider() -> Iterable[dict]:
            for rep in fleet._reps:
                yield dict(
                    name=f"{rep.role}{rep.idx}",
                    recorder=rep.engine.recorder,
                    registry=_strip_replica_view(rep.engine, rep.idx),
                    labels={"replica": str(rep.idx), "role": rep.role,
                            **_topology(rep.engine)},
                    stats=_engine_stats(rep.engine),
                )

        self.add_provider(provider)

    def attach_multimodel(self, mm) -> None:
        """The multi-model facade: ONE event source (deployments share
        the facade's recorder) plus a metrics-only projection per
        deployment that swaps the ``model{name}.`` name prefix for a
        ``{model="name"}`` label."""
        prefixes = tuple(f"model{n}." for n in mm.models)
        self.add_source(
            "multimodel", recorder=mm.recorder,
            registry=_RegistryView(mm.registry,
                                   exclude_prefixes=prefixes),
        )
        for n in mm.models:
            self.add_source(
                f"model:{n}",
                registry=_RegistryView(mm.registry, prefix=f"model{n}."),
                labels={"model": n},
            )

    # -- merged timeline ----------------------------------------------------

    def merged_events(self) -> list[dict]:
        """Every source's events on ONE globally-ordered timeline.

        Each row is the original event plus ``src`` (the source's
        display name) and ``wall`` (absolute unix seconds via the
        owning recorder's ``t0_unix`` anchor — the merge key; ``t``
        stays the source-local monotonic stamp)."""
        self.refresh()
        rows: list[tuple] = []
        for src in self._sources:
            if src.recorder is None:
                continue
            t0 = getattr(src.recorder, "t0_unix", 0.0)
            for i, ev in enumerate(src.recorder.events()):
                rows.append((t0 + ev["t"], src.pid, i, src, ev))
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        return [
            {"wall": round(wall, 6), "src": src.display, **ev}
            for wall, _pid, _i, src, ev in rows
        ]

    def dump_events(self, path: str | None = None) -> str:
        """The merged timeline as JSON-lines (torn-write-safe when
        ``path`` is given). The header row carries each source's
        ``t0_unix`` anchor and drop count, so the merge is auditable
        from the file alone."""
        events = self.merged_events()
        anchors = {
            s.display: round(s.recorder.t0_unix, 6)
            for s in self._sources if s.recorder is not None
        }
        header = json.dumps({
            "header": "telemetry_hub",
            "sources": [s.display for s in self._sources],
            "t0_unix": anchors,
            "events": len(events),
            "dropped": sum(
                s.recorder.dropped for s in self._sources
                if s.recorder is not None
            ),
        })
        lines = "\n".join(
            [header] + [json.dumps(ev, default=str) for ev in events]
        ) + "\n"
        if path is not None:
            atomic_write_text(path, lines)
            _log.info("telemetry hub: %d merged events -> %s",
                      len(events), path)
        return lines

    def request_chains(self) -> dict[str, list[dict]]:
        """Merged events grouped by ``trace_id`` — one causal chain per
        request across every component it touched. Span-scoped events
        inherit the trace id from their span's start event; control
        events (routed, hedge, handoff_routed, migrated) carry a
        ``trace`` attr directly."""
        events = self.merged_events()
        span_trace: dict[tuple, str] = {}
        for ev in events:
            if ev.get("name") == "start":
                tr = (ev.get("attrs") or {}).get("trace")
                if tr:
                    span_trace[(ev["src"], ev.get("span"))] = str(tr)
        chains: dict[str, list[dict]] = {}
        for ev in events:
            tr = (ev.get("attrs") or {}).get("trace")
            if not tr and "span" in ev:
                tr = span_trace.get((ev["src"], ev["span"]))
            if tr:
                chains.setdefault(str(tr), []).append(ev)
        return chains

    # -- merged Chrome trace ------------------------------------------------

    def export_trace(self, path: str | None = None,
                     extra_meta: dict | None = None) -> dict:
        """One Perfetto-loadable Chrome trace for the whole fleet.

        One trace PROCESS per source (pid = registration order), with
        the same track layout the single-engine exporter
        (core/perf.py) uses — ticks / dispatch / events threads plus
        one thread per request span — and flow arrows (``ph`` s/t/f,
        ``id`` = ``trace_id``) stitching every fragment of a request
        across processes: prefill slice on the prefill replica's
        track, adopted decode slice on the decode replica's, failover
        replays and hedge twins included. Output is deterministic:
        re-exporting an unchanged hub is byte-identical."""
        self.refresh()
        meta: list[dict] = []
        body: list[dict] = []
        #: trace_id -> [(slice ts, pid, tid)] request-slice anchors
        fragments: dict[str, list[tuple]] = {}
        for src in self._sources:
            if src.recorder is None:
                continue
            meta.append(_meta("process_name", src.pid, 0,
                              {"name": src.display}))
            self._source_trace(src, meta, body, fragments)
        for trace in sorted(fragments):
            frags = sorted(fragments[trace])
            if len(frags) < 2:
                continue  # single-fragment requests need no arrow
            last = len(frags) - 1
            for j, (fts, pid, tid) in enumerate(frags):
                ph = "s" if j == 0 else ("f" if j == last else "t")
                ev: dict[str, Any] = {
                    "name": trace, "cat": "request", "id": trace,
                    "ph": ph, "pid": pid, "tid": tid, "ts": fts,
                }
                if ph == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice
                body.append(ev)
        body.sort(key=lambda e: (e["ts"], e["pid"], e["tid"],
                                 e["name"], e["ph"]))
        doc = {
            "traceEvents": meta + body,
            "displayTimeUnit": "ms",
            "otherData": {
                "generator":
                    "mmlspark_tpu_torch.core.tracehub.TelemetryHub",
                "sources": [s.display for s in self._sources],
                **(extra_meta or {}),
            },
        }
        if path is not None:
            atomic_write_text(path, json.dumps(
                doc, sort_keys=True, separators=(",", ":"), default=str,
            ))
            _log.info("merged chrome trace: %d events -> %s",
                      len(doc["traceEvents"]), path)
        return doc

    def _source_trace(self, src: TelemetrySource, meta: list,
                      body: list, fragments: dict) -> None:
        events = src.recorder.events()
        t0 = getattr(src.recorder, "t0_unix", 0.0)

        def ts(mono_t: float) -> float:
            return round((t0 + mono_t) * 1e6, 3)

        spans: dict[int, list[dict]] = {}
        for ev in events:
            if ev.get("span_name") == "request" and "span" in ev:
                spans.setdefault(ev["span"], []).append(ev)
        for sid in sorted(spans):
            evs = spans[sid]
            start = next((e for e in evs if e["name"] == "start"), None)
            req_id = (
                start.get("attrs", {}).get("id", sid)
                if start is not None else sid
            )
            tid = _TID_REQUEST_BASE + int(req_id)
            meta.append(_meta("thread_name", src.pid, tid,
                              {"name": f"request {req_id}"}))
            end = next((e for e in evs if e["name"] in _TERMINAL), None)
            if start is not None:
                dur = (
                    round((end["t"] - start["t"]) * 1e6, 3)
                    if end is not None else 0.0
                )
                slice_ts = ts(start["t"])
                body.append({
                    "name": (
                        f"request {req_id}"
                        + (f" [{end['name']}]" if end is not None else "")
                    ),
                    "ph": "X", "pid": src.pid, "tid": tid,
                    "ts": slice_ts, "dur": dur,
                    "args": dict(start.get("attrs", {})),
                })
                trace = start.get("attrs", {}).get("trace")
                if trace:
                    fragments.setdefault(str(trace), []).append(
                        (slice_ts, src.pid, tid)
                    )
            for ev in evs:
                if ev is start:
                    continue
                body.append({
                    "name": ev["name"], "ph": "i", "s": "t",
                    "pid": src.pid, "tid": tid, "ts": ts(ev["t"]),
                    "args": _instant_args(ev),
                })
        used: set[int] = set()
        for ev in events:
            if ev.get("span_name") == "request":
                continue
            name = ev["name"]
            if name == "tick":
                dur_ms = ev.get("attrs", {}).get("ms", 0.0)
                used.add(_TID_TICKS)
                body.append({
                    "name": f"tick {ev.get('tick', '?')}",
                    "ph": "X", "pid": src.pid, "tid": _TID_TICKS,
                    "ts": ts(ev["t"] - dur_ms * 1e-3),
                    "dur": round(dur_ms * 1e3, 3),
                    "args": _instant_args(ev),
                })
            elif name == "dispatch":
                attrs = ev.get("attrs", {})
                dur_ms = attrs.get("ms", 0.0)
                used.add(_TID_DISPATCH)
                body.append({
                    "name": attrs.get("family", "dispatch"),
                    "ph": "X", "pid": src.pid, "tid": _TID_DISPATCH,
                    "ts": ts(ev["t"] - dur_ms * 1e-3),
                    "dur": round(dur_ms * 1e3, 3),
                    "args": _instant_args(ev),
                })
            else:
                used.add(_TID_EVENTS)
                body.append({
                    "name": name, "ph": "i", "s": "t",
                    "pid": src.pid, "tid": _TID_EVENTS,
                    "ts": ts(ev["t"]), "args": _instant_args(ev),
                })
        for tid, tname in ((_TID_TICKS, "ticks"),
                           (_TID_DISPATCH, "dispatch"),
                           (_TID_EVENTS, "events")):
            if tid in used:
                meta.append(_meta("thread_name", src.pid, tid,
                                  {"name": tname}))

    # -- merged metrics -----------------------------------------------------

    def to_prometheus(self) -> str:
        """ONE text exposition (format 0.0.4) across every source.

        Series from N registries are grouped by metric name with a
        single ``# TYPE`` header each; sources are told apart by their
        labels (``{replica="0",role="decode"}``), not by name prefixes
        — so ``serve_ttft_ms`` is one queryable metric family across
        the fleet."""
        self.refresh()
        order: list[str] = []
        groups: dict[str, tuple[str, list[str]]] = {}
        for src in self._sources:
            if src.registry is None:
                continue
            for pname, mtype, lines in src.registry.prom_series(
                    src.labels or None):
                if pname not in groups:
                    groups[pname] = (mtype, [])
                    order.append(pname)
                gtype, glines = groups[pname]
                if gtype != mtype:
                    # name registered with a different type elsewhere:
                    # emitting both would corrupt the exposition —
                    # first registration wins, the clash gets logged
                    _log.warning(
                        "prom type clash on %s: %s (source %s) vs %s",
                        pname, mtype, src.display, gtype,
                    )
                    continue
                glines.extend(lines)
        out: list[str] = []
        for pname in order:
            mtype, lines = groups[pname]
            out.append(f"# TYPE {pname} {mtype}")
            out.extend(lines)
        return "\n".join(out) + ("\n" if out else "")

    def metrics_dict(self) -> dict:
        """Merged JSON-able view: one flat registry dict per source
        plus the alert counters."""
        self.refresh()
        return {
            "sources": {
                s.display: (
                    s.registry.to_dict()
                    if s.registry is not None else {}
                )
                for s in self._sources
            },
            "alerts": {k: c.value for k, c in sorted(self._alerts.items())},
        }

    def summary(self) -> dict:
        """Compact hub block for an existing metrics document: source
        names, alert counters, merged event count."""
        return {
            "sources": [s.display for s in self.sources()],
            "alerts": {k: c.value for k, c in sorted(self._alerts.items())},
            "events_merged": sum(
                len(s.recorder.events()) for s in self._sources
                if s.recorder is not None
            ),
        }

    # -- anomaly detectors --------------------------------------------------

    def detect(self) -> list[dict]:
        """One detector sweep over every source; returns the NEW alerts
        (each distinct condition fires once per hub lifetime — scrape
        loops don't re-count a standing condition). Each alert is an
        ``alert`` event on the hub recorder plus an ``alerts.{kind}``
        counter increment."""
        self.refresh()
        alerts: list[dict] = []
        th = self.thresholds
        burning: dict[str, int] = {}
        for src in self._sources:
            reg = src.registry
            if reg is not None and src.name != "hub":
                for name in reg.names():
                    m = reg.get(name)
                    if m is None:
                        continue
                    if ("retrace." in name and isinstance(m, Counter)
                            and m.value >= th["retrace_storm"]):
                        self._alert(
                            alerts, "retrace_storm", src, metric=name,
                            compilations=m.value,
                        )
                    if (name.endswith("serve.tick_ms")
                            and isinstance(m, Histogram)
                            and m.count >= th["tick_p99_min_count"]):
                        p50, p99 = m.percentile(50), m.percentile(99)
                        if (p50 and p99
                                and p99 > th["tick_p99_drift_factor"] * p50):
                            self._alert(
                                alerts, "tick_p99_drift", src,
                                metric=name, p50_ms=round(p50, 3),
                                p99_ms=round(p99, 3),
                            )
                    if name.endswith("slo.burning") and m.value is not None:
                        burning[src.display] = int(m.value)
            if src.stats is not None:
                st = src.stats()
                depth = st.get("queue_depth")
                if depth is not None and depth >= th["queue_high"]:
                    self._alert(alerts, "queue_watermark", src,
                                queue_depth=depth)
                blocks = st.get("decode_blocks") or 0
                if blocks and src.recorder is not None:
                    # each fused decode block performs exactly ONE
                    # fetch, recorded as one decode dispatch event
                    # — the ratio drifting above 1 means a code path
                    # started syncing more than the design allows.
                    # (The ring buffer can only UNDERcount syncs on
                    # long runs, so eviction never causes a false
                    # alarm.)
                    syncs = sum(
                        1 for ev in src.recorder.events()
                        if ev.get("name") == "dispatch"
                        and str((ev.get("attrs") or {})
                                .get("family", "")).startswith("decode")
                    )
                    ratio = syncs / blocks
                    if ratio > th["host_syncs_per_block"] + 1e-9:
                        self._alert(
                            alerts, "host_sync_regression", src,
                            syncs=syncs, blocks=blocks,
                            ratio=round(ratio, 4),
                        )
        if len(burning) >= 2 and len(set(burning.values())) > 1:
            # uneven SLO burn: one replica degrading while its peers
            # hold the target — a routing or health problem, not load
            self._alert(
                alerts, "slo_burn_spread", None,
                burning={k: burning[k] for k in sorted(burning)},
            )
        return alerts

    def _alert(self, out: list, kind: str,
               src: TelemetrySource | None, **detail) -> None:
        key = (kind, src.display if src is not None else None,
               detail.get("metric"))
        if key in self._alerted:
            return
        self._alerted.add(key)
        self._alerts[kind].inc()
        ev = dict(detail)
        if src is not None:
            ev["source"] = src.display
        self.recorder.record("alert", kind=kind, **ev)
        out.append({"kind": kind, **ev})
        _log.warning("alert[%s]: %s", kind, ev)

    # -- bundle export ------------------------------------------------------

    def write_bundle(self, out_dir: str,
                     metrics: dict | None = None) -> dict:
        """The full merged telemetry bundle under ``out_dir`` — the
        hub-mode counterpart of the single-engine ``--telemetry-dir``
        file set, every file written atomically: ``events.jsonl``
        (merged timeline), ``trace.json`` (merged Perfetto trace),
        ``metrics.prom`` (merged labeled exposition), ``metrics.json``
        (``metrics`` plus a ``hub`` summary block). Runs one
        :meth:`detect` pass first so alert events and counters are in
        the bundle. Returns the written paths."""
        os.makedirs(out_dir, exist_ok=True)
        self.detect()
        paths = {
            name: os.path.join(out_dir, name)
            for name in ("events.jsonl", "trace.json", "metrics.prom",
                         "metrics.json")
        }
        self.dump_events(paths["events.jsonl"])
        self.export_trace(path=paths["trace.json"])
        atomic_write_text(paths["metrics.prom"], self.to_prometheus())
        doc = dict(metrics or {})
        doc["hub"] = self.summary()
        atomic_write_json(paths["metrics.json"], doc, indent=1,
                          default=str)
        return paths


# --------------------------------------------------------------------------
# live ops surface
# --------------------------------------------------------------------------


class MetricsServer:
    """Stdlib HTTP endpoint over a :class:`TelemetryHub`.

    Routes: ``/metrics`` (Prometheus text exposition; each scrape also
    runs a detector sweep so ``alerts.*`` stay live), ``/traces`` (the
    merged Chrome trace JSON), ``/healthz`` (source census). Binds
    127.0.0.1 by default — the exposition includes prompt-adjacent
    request attrs, so exposing it beyond the host is an explicit
    opt-in. ``port=0`` picks an ephemeral port; the bound one is
    ``self.port``. The serving thread is a daemon: it reads host-side
    state only and never blocks interpreter exit; :meth:`close` (or the
    ``with`` block) stops it."""

    def __init__(self, hub: TelemetryHub, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.hub = hub
        handler = _make_handler(hub)
        try:
            self._httpd = ThreadingHTTPServer((host, port), handler)
        except OSError as e:
            raise FriendlyError(
                f"metrics server could not bind {host}:{port}: {e} — "
                "pass port 0 for an ephemeral port"
            ) from e
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mmlspark-tpu-metrics", daemon=True,
        )
        self._thread.start()
        _log.info("metrics server on http://%s:%d (/metrics /traces "
                  "/healthz)", self.host, self.port)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _make_handler(hub: TelemetryHub):
    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003 — stdlib name
            # the default writes to stderr per request; a serving
            # process keeps its logs quiet, so scrapes log at debug
            _log.debug("metrics server: " + fmt, *args)

        def do_GET(self):  # noqa: N802 — stdlib contract
            try:
                if self.path == "/metrics":
                    hub.detect()
                    body = hub.to_prometheus().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/traces":
                    body = json.dumps(
                        hub.export_trace(), sort_keys=True,
                        separators=(",", ":"), default=str,
                    ).encode("utf-8")
                    ctype = "application/json"
                elif self.path == "/healthz":
                    body = json.dumps({
                        "status": "ok",
                        "sources": [s.display for s in hub.sources()],
                        "alerts": {
                            k: hub.registry.counter(f"alerts.{k}").value
                            for k in ALERT_KINDS
                        },
                    }, sort_keys=True).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404, "routes: /metrics /traces "
                                         "/healthz")
                    return
            except Exception as e:  # noqa: BLE001 — a scrape must
                # never take the serving process down with it
                self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return _Handler
