"""The port's telemetry hub (``mmlspark_tpu_torch/core/tracehub.py``)
against the JAX package's, mirroring ``tests/test_tracehub.py`` without
its 2x2 mesh case (``tests/test_torch_serve_mesh_planes.py``'s).

The merge plane is compared on synthetic inputs: the SAME events are
recorded on a JAX flight recorder and on a port one, and the same metrics
registered on a JAX registry and a port one; the recorders' wall-clock
anchors, event stamps and span durations are then set to equal values
(the recorders' clocks are their only free inputs), so both hubs must
produce EQUAL
merged events, request chains, ``events.jsonl`` dumps, alerts and
Prometheus text. The hub's live surface (``MetricsServer``) binds an
ephemeral loopback port, every request carries a timeout and the server
closes in a ``finally``. The fleet flows (hand-off flow arrows, a
failover replay joining its trace, a hedge twin sharing it) run on the
port's own planes over a small random-init LM, and attaching the hub is
shown to add no program and no fetch per decode block.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import telemetry as jax_telemetry
from mmlspark_tpu.core import tracehub as jax_tracehub
from mmlspark_tpu_torch.core import telemetry, tracehub
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
from mmlspark_tpu_torch.core.tracehub import (
    ALERT_KINDS,
    MetricsServer,
    TelemetryHub,
)
from mmlspark_tpu_torch.models import build_model, init_variables
from mmlspark_tpu_torch.serve import (
    BatchDeployment,
    DisaggFleet,
    MultiModelEngine,
    ReplicaSet,
    ServeEngine,
)
from mmlspark_tpu_torch.testing import serve_compile_guard


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: (framework telemetry module, framework hub module)
SIDES = {"jax": (jax_telemetry, jax_tracehub),
         "port": (telemetry, tracehub)}
TIMEOUT = 10  # seconds, on every request to a MetricsServer
KW = dict(slots=2, cache_len=32, max_queue=8, decode_block=4,
          retry_backoff_s=0.0, device="cpu")


def _pin_clocks(hubs_recorders) -> None:
    """Give every recorder the same anchor, each event (in recording
    order across all of them) the same stamp on both sides, and each
    span's measured duration the same value."""
    for recorders in hubs_recorders:
        for r in recorders:
            r.t0_unix = 1_700_000_000.0
        events = sorted(
            (ev for r in recorders for ev in r._events),
            key=lambda ev: ev["t"])
        for k, ev in enumerate(events):
            ev["t"] = 100.0 + 0.001 * k
            if "duration_ms" in ev.get("attrs", {}):
                ev["attrs"]["duration_ms"] = 1.0


def _twins(script):
    """Run ``script(hub, telemetry module)`` on a JAX hub and a port hub;
    return both hubs with their recorders' clocks pinned equal."""
    hubs = {}
    for side, (tel, hub_mod) in SIDES.items():
        hub = hub_mod.TelemetryHub()
        script(hub, tel)
        hubs[side] = hub
    _pin_clocks([[s.recorder for s in hubs[side].sources()
                  if s.recorder is not None] for side in hubs])
    return hubs["jax"], hubs["port"]


@pytest.fixture(scope="module")
def lm():
    g = build_model("transformer_lm", vocab_size=16, d_model=32, heads=2,
                    depth=2, max_len=32)
    v = init_variables(g, 0, device="cpu")
    row = np.random.default_rng(0).integers(0, 16, size=16)
    return g, v, row


# -- registry views ---------------------------------------------------------


def test_registry_view_prefix_strip_exclude_and_readonly():
    views = {}
    for side, (tel, hub_mod) in SIDES.items():
        inner = tel.MetricRegistry()
        inner.counter("modellm.serve.completed").inc(4)
        inner.counter("multimodel.faults_injected").inc(1)
        inner.counter("replica0.serve.completed").inc(2)
        inner.gauge("perf.mfu").set(0.5)
        views[side] = [
            hub_mod._RegistryView(inner, prefix="modellm."),
            hub_mod._RegistryView(inner, strip_prefix="replica0."),
            hub_mod._RegistryView(inner, exclude_prefixes=("modellm.",)),
        ]
    for jv, tv in zip(views["jax"], views["port"]):
        assert tv.names() == jv.names()
        assert tv.to_dict() == jv.to_dict()
        assert tv.to_prometheus() == jv.to_prometheus()
    v, s, e = views["port"]
    assert v.names() == ["serve.completed"] and v.get(
        "serve.completed").value == 4
    assert s.get("serve.completed").value == 2 and "perf.mfu" in s.names()
    assert "multimodel.faults_injected" in e.names()
    with pytest.raises(FriendlyError, match="read-only"):
        v.counter("new.metric")


def test_hub_rejects_unknown_thresholds():
    with pytest.raises(FriendlyError, match="unknown detector"):
        TelemetryHub(thresholds={"typo_threshold": 1})


def test_add_source_idempotent_and_generation_bump():
    hub = TelemetryHub()
    rec = telemetry.FlightRecorder()
    s1 = hub.add_source("replica0", recorder=rec)
    assert hub.add_source("replica0", recorder=rec) is s1
    assert s1.display == "replica0" and "gen" not in s1.labels
    s2 = hub.add_source("replica0", recorder=telemetry.FlightRecorder())
    assert s2.display == "replica0#1" and s2.labels["gen"] == "1"
    with pytest.raises(FriendlyError, match="recorder"):
        hub.add_source("empty")


# -- merged timeline ----------------------------------------------------------


def test_merged_events_and_dump_equal_the_jax_hub(tmp_path):
    def script(hub, tel):
        a, b = tel.FlightRecorder(), tel.FlightRecorder()
        hub.add_source("a", recorder=a)
        hub.add_source("b", recorder=b)
        for i in range(4):
            (a if i % 2 == 0 else b).record("ev", tick=i, n=i * i)

    jhub, hub = _twins(script)
    merged = hub.merged_events()
    assert merged == jhub.merged_events()
    ours = [ev for ev in merged if ev["src"] in ("a", "b")]
    assert [ev["tick"] for ev in ours] == [0, 1, 2, 3]
    assert [ev["src"] for ev in ours] == ["a", "b", "a", "b"]
    assert hub.dump_events() == jhub.dump_events()
    path = tmp_path / "events.jsonl"
    hub.dump_events(str(path))
    header = json.loads(path.read_text().splitlines()[0])
    assert header["header"] == "telemetry_hub"
    assert set(header["t0_unix"]) == {"hub", "a", "b"}
    assert header["dropped"] == 0


def test_request_chains_equal_the_jax_hub():
    def script(hub, tel):
        r0, r1 = tel.FlightRecorder(), tel.FlightRecorder()
        hub.add_source("sup", recorder=r0)
        hub.add_source("rep", recorder=r1)
        r0.record("routed", trace="g0", replica=1)
        span = tel.SpanTracer(r1).span("request", id=0, trace="g0")
        span.event("prefill")
        span.end("completed")
        r0.record("routed", trace="g1", replica=0)

    jhub, hub = _twins(script)
    chains = hub.request_chains()
    assert chains == jhub.request_chains()
    assert [ev["name"] for ev in chains["g0"]] == [
        "routed", "start", "prefill", "completed"]
    assert {ev["src"] for ev in chains["g0"]} == {"sup", "rep"}
    assert hub.export_trace()["traceEvents"] == \
        jhub.export_trace()["traceEvents"]


# -- merged prometheus -----------------------------------------------------------


def test_merged_prom_equals_the_jax_hub():
    def script(hub, tel):
        ra, rb = tel.MetricRegistry(), tel.MetricRegistry()
        ra.counter("serve.completed").inc(3)
        rb.counter("serve.completed").inc(5)
        for r, scale in ((ra, 1.0), (rb, 10.0)):
            h = r.histogram("serve.ttft_ms")
            for v in (1.0, 2.5, 40.0):
                h.record(v * scale)
            r.gauge("perf.mfu").set(0.25 * scale)
        hub.add_source("r0", registry=ra, labels={"replica": "0"})
        hub.add_source("r1", registry=rb, labels={"replica": "1"})

    jhub, hub = _twins(script)
    prom = hub.to_prometheus()
    assert prom == jhub.to_prometheus()
    assert prom.count("# TYPE serve_completed_total counter") == 1
    assert 'serve_completed_total{replica="0"} 3' in prom
    assert 'serve_completed_total{replica="1"} 5' in prom
    assert hub.metrics_dict() == jhub.metrics_dict()


def test_prom_label_value_escaping_round_trip():
    evil = 'mo"del\\v1\nline2'
    escaped = telemetry._prom_escape_label_value(evil)
    assert escaped == jax_telemetry._prom_escape_label_value(evil)
    assert "\n" not in escaped
    assert escaped.replace("\\n", "\n").replace('\\"', '"').replace(
        "\\\\", "\\") == evil
    reg = telemetry.MetricRegistry()
    reg.counter("serve.completed").inc(1)
    hub = TelemetryHub()
    hub.add_source("m", registry=reg, labels={"model": evil})
    sample = [ln for ln in hub.to_prometheus().splitlines()
              if ln.startswith("serve_completed_total{")]
    assert len(sample) == 1
    assert sample[0].split("{", 1)[1].rsplit("}", 1)[0] == \
        f'model="{escaped}"'


# -- detectors -------------------------------------------------------------------


def test_detectors_fire_once_per_condition_as_in_jax():
    def script(hub, tel):
        hub.thresholds["queue_high"] = 4
        reg = tel.MetricRegistry()
        reg.counter("retrace.serve.decode").inc(40)
        h = reg.histogram("serve.tick_ms")
        for _ in range(25):
            h.record(1.0)
        h.record(5000.0)
        rec = tel.FlightRecorder()
        for _ in range(3):
            rec.record("dispatch", family="decode[T=2]", ms=1.0)
        hub.add_source("r0", recorder=rec, registry=reg,
                       stats=lambda: {"queue_depth": 9, "decode_blocks": 2})
        ra, rb = tel.MetricRegistry(), tel.MetricRegistry()
        ra.gauge("slo.burning").set(1)
        rb.gauge("slo.burning").set(0)
        hub.add_source("r1", registry=ra)
        hub.add_source("r2", registry=rb)

    jhub, hub = _twins(script)
    alerts = hub.detect()
    assert alerts == jhub.detect()
    assert {a["kind"] for a in alerts} == set(ALERT_KINDS)
    for kind in ALERT_KINDS:
        assert hub.registry.counter(f"alerts.{kind}").value == 1
    assert len([ev for ev in hub.recorder.events()
                if ev["name"] == "alert"]) == len(ALERT_KINDS)
    assert hub.detect() == [] == jhub.detect()
    assert hub.to_prometheus() == jhub.to_prometheus()


def test_detectors_quiet_on_healthy_source():
    hub = TelemetryHub()
    reg = telemetry.MetricRegistry()
    reg.counter("retrace.serve.decode").inc(3)
    rec = telemetry.FlightRecorder()
    rec.record("dispatch", family="decode[T=2]", ms=1.0)
    hub.add_source("r0", recorder=rec, registry=reg,
                   stats=lambda: {"queue_depth": 1, "decode_blocks": 1})
    assert hub.detect() == []
    assert all(hub.registry.counter(f"alerts.{k}").value == 0
               for k in ALERT_KINDS)


# -- live surface -----------------------------------------------------------------


def _get(url: str):
    return urllib.request.urlopen(url, timeout=TIMEOUT).read()


def test_metrics_server_endpoints_on_ephemeral_port():
    hub = TelemetryHub()
    reg = telemetry.MetricRegistry()
    reg.counter("serve.completed").inc(2)
    hub.add_source("r0", registry=reg, labels={"replica": "0"})
    server = MetricsServer(hub, port=0)
    try:
        assert server.port > 0 and server.host == "127.0.0.1"
        base = f"http://{server.host}:{server.port}"
        body = _get(f"{base}/metrics").decode()
        assert 'serve_completed_total{replica="0"} 2' in body
        assert "# TYPE alerts_retrace_storm_total counter" in body
        health = json.loads(_get(f"{base}/healthz"))
        assert health["status"] == "ok" and "r0" in health["sources"]
        assert set(health["alerts"]) == set(ALERT_KINDS)
        doc = json.loads(_get(f"{base}/traces"))
        assert doc["otherData"]["generator"].endswith("TelemetryHub")
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{base}/nope")
        assert err.value.code == 404
    finally:
        server.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{base}/healthz", timeout=0.5)


# -- the hub costs nothing per block ------------------------------------------------


def _drive(g, v, row, hub: bool) -> dict:
    """Serve four prompts; with ``hub`` attached and scraped between
    ticks. Returns the program counts, the fetches and the decode
    blocks."""
    eng = ServeEngine(g, v, **KW)
    fetches = []
    inner = eng._fetch
    eng._fetch = lambda inflight: fetches.append(1) or inner(inflight)
    h = None
    if hub:
        h = TelemetryHub()
        h.attach_engine(eng)
    prompts = [row[:n] for n in (5, 9, 4, 7)]
    with serve_compile_guard(eng, min_decode=1, min_prefill=1):
        for p in prompts:
            eng.submit(p, 6)
        done = 0
        while done < len(prompts):
            done += len(eng.step())
            if h is not None:
                h.to_prometheus()
                h.merged_events()
        if h is not None:
            h.export_trace()
            assert h.detect() == []
            assert h.registry.counter(
                "alerts.host_sync_regression").value == 0
    syncs = sum(1 for ev in eng.recorder.events()
                if ev["name"] == "dispatch" and str(ev.get(
                    "attrs", {}).get("family", "")).startswith("decode"))
    blocks = sum(eng.metrics.decode_blocks.values())
    assert syncs == blocks
    return dict(decode=eng.decode_compile_count,
                prefill=eng.prefill_compile_count,
                fetches=len(fetches), blocks=blocks)


def test_hub_adds_no_program_and_no_fetch(lm):
    g, v, row = lm
    with_hub, without = _drive(g, v, row, True), _drive(g, v, row, False)
    assert with_hub == without
    assert with_hub["fetches"] == with_hub["blocks"]


def test_attach_multimodel_labels_deployments(lm):
    """The multi-model facade: one event source plus a labeled
    projection per deployment; ``model{name}.`` prefixes become
    ``{model="name"}`` labels on shared families."""
    g, v, row = lm
    clf = build_model("mlp", num_outputs=3, hidden=(8,))
    clf.size_input((4,))
    eng = MultiModelEngine(device="cpu")
    eng.add_lm("lm", g, v, slots=2, cache_len=32)
    dep = eng.add_batch("clf", clf, init_variables(clf, 1, device="cpu"),
                        max_batch=2)
    assert isinstance(dep, BatchDeployment)
    hub = TelemetryHub()
    hub.attach_multimodel(eng)
    gid = eng.submit(row[:5], model="lm", max_new_tokens=4)
    eng.submit(np.zeros(4, np.float32), model="clf")
    eng.run()
    prom = hub.to_prometheus()
    for name in ("lm", "clf"):
        assert f'serve_completed_total{{model="{name}"}} 1' in prom
    assert "modellm_serve" not in prom
    chain = hub.request_chains()[f"m{gid}"]
    assert {"routed", "start", "completed"} <= {ev["name"] for ev in chain}
    displays = [s.display for s in hub.sources()]
    assert displays == ["hub", "multimodel", "model:lm", "model:clf"]


# -- fleet flows: hand-off, failover, hedge -------------------------------------------


def _flow_events(doc):
    return [e for e in doc["traceEvents"] if e["ph"] in ("s", "t", "f")]


def test_fleet_handoff_flow_arrows_and_deterministic_export(lm, tmp_path):
    g, v, row = lm
    fleet = DisaggFleet(g, v, prefill_replicas=1, decode_replicas=1, **KW)
    hub = TelemetryHub()
    hub.attach_fleet(fleet)
    gids = [fleet.submit(row[:n], 6) for n in (5, 9, 4)]
    results = fleet.run()
    assert all(results[gid].status == "completed" for gid in gids)
    doc = hub.export_trace()
    pid_of = {s.display: s.pid for s in hub.sources()}
    by_trace = {}
    for ev in _flow_events(doc):
        by_trace.setdefault(ev["id"], []).append(ev)
    assert set(by_trace) == {f"f{gid}" for gid in gids}
    for evs in by_trace.values():
        phases = [e["ph"] for e in sorted(evs, key=lambda e: e["ts"])]
        assert phases[0] == "s" and phases[-1] == "f"
        assert {pid_of["prefill0"], pid_of["decode1"]} <= {
            e["pid"] for e in evs}
        assert all(e.get("bp") == "e" for e in evs if e["ph"] == "f")
        assert all(e["tid"] >= 10 for e in evs)
    chains = hub.request_chains()
    for gid in gids:
        assert {"fleet", "prefill0", "decode1"} <= {
            ev["src"] for ev in chains[f"f{gid}"]}
        assert {"handoff_routed", "handed_off"} <= {
            ev["name"] for ev in chains[f"f{gid}"]}
    p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
    hub.export_trace(path=str(p1))
    hub.export_trace(path=str(p2))
    assert p1.read_bytes() == p2.read_bytes()
    paths = hub.write_bundle(str(tmp_path / "bundle"), metrics={"x": 1})
    assert json.loads(open(paths["metrics.json"]).read())["hub"]["sources"]


def test_failover_replay_joins_the_original_trace(lm):
    g, v, row = lm
    inj = FaultInjector([Fault("serve.decode", "kill", tick=3, replica=0)])
    rs = ReplicaSet(g, v, replicas=2, snapshot_every_ticks=2, faults=inj,
                    **dict(KW, slots=4, decode_block=2))
    hub = TelemetryHub()
    hub.attach_replicaset(rs)
    gids = [rs.submit(row[:n], 8) for n in (5, 9, 4, 7)]
    results = rs.run()
    assert rs.replica_failovers_total == 1
    assert all(results[gid].status == "completed" for gid in gids)
    displays = [s.display for s in hub.sources()]
    assert "replica0#1" in displays
    chains = hub.request_chains()
    replayed = [t for t, evs in chains.items()
                if any(ev["src"].startswith("replica0#") for ev in evs)]
    assert replayed
    for t in replayed:
        assert {"supervisor", "replica0#1"} <= {
            ev["src"] for ev in chains[t]}
    flow_traces = {e["id"] for e in _flow_events(hub.export_trace())}
    assert set(replayed) <= flow_traces


def test_hedge_twin_shares_the_trace(lm):
    g, v, row = lm

    class _FakeClock:
        t = 0.0

        def __call__(self):
            return self.t

    clk = _FakeClock()
    rs = ReplicaSet(g, v, replicas=2, hedge_ms=50.0, clock=clk,
                    snapshot_every_ticks=None, **dict(KW, decode_block=2))
    hub = TelemetryHub()
    hub.attach_replicaset(rs)
    gid = rs.submit(row[:6], 12)
    rs.step()
    clk.t = 0.2
    results = rs.run()
    assert rs.hedges_total == 1
    assert results[gid].status == "completed"
    chain = hub.request_chains()[f"g{gid}"]
    assert {"replica0", "replica1"} <= {ev["src"] for ev in chain}
    assert "hedge" in {ev["name"] for ev in chain}
    assert len([ev for ev in chain if ev["name"] == "start"]) >= 2
    flow = [e for e in _flow_events(hub.export_trace())
            if e["id"] == f"g{gid}"]
    assert {e["pid"] for e in flow} == {
        s.pid for s in hub.sources()
        if s.display in ("replica0", "replica1")}


def test_run_demo_replicas_writes_the_merged_bundle(tmp_path):
    """``run_demo(replicas=2, telemetry_dir=...)`` writes the hub's
    merged bundle — one timeline over the supervisor and both replicas,
    one labeled exposition — beside the control plane's own timeline,
    and serves ``/metrics`` while it runs when asked."""
    from mmlspark_tpu_torch.serve.demo import run_demo

    d = tmp_path / "tel"
    out = run_demo(slots=2, n_requests=4, max_new_tokens=3, vocab=32,
                   d_model=16, heads=2, depth=1, cache_len=32, replicas=2,
                   telemetry_dir=str(d), metrics_port=0, device="cpu")
    assert out["completed"] == 4 and out["metrics_port"] > 0
    assert sorted(p.name for p in d.iterdir()) == [
        "events.jsonl", "metrics.json", "metrics.prom",
        "supervisor.events.jsonl", "trace.json"]
    header = json.loads((d / "events.jsonl").read_text().splitlines()[0])
    assert header["header"] == "telemetry_hub"
    assert {"supervisor", "replica0", "replica1"} <= set(header["sources"])
    prom = (d / "metrics.prom").read_text()
    assert 'serve_completed_total{replica="0"}' in prom
    assert 'serve_completed_total{replica="1"}' in prom
    assert json.loads((d / "metrics.json").read_text())["hub"]["sources"]
