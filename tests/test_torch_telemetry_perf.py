"""The port's telemetry plane, device analytics and SLO monitor against
the JAX package, mirroring the single-device cases of
``tests/test_telemetry.py`` and ``tests/test_perf.py``: identical calls
give identical results in both packages — histogram summaries,
Prometheus text, flight-recorder dumps, ``SloMonitor`` states tick for
tick under one injected clock, ``PerfAnalytics`` arithmetic, the
``parse_slo_spec``/``parse_autoscale_spec`` results and errors — and
the serving integration keeps its contracts: with analytics and an SLO
on, a request decoding 16 tokens through T=8 blocks still fetches once
a block, the program pins hold, and every program family is costed on
``meta`` tensors (no program made or counted for it).

The engine cases run a small random-init port model against the port's
own ``generate()``; the stream parity with the JAX engine is
``tests/test_torch_supervisor.py``'s and ``tests/test_torch_fleet.py``'s.
"""

from __future__ import annotations

import json
import random
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.perf import DevicePeak as JaxDevicePeak
from mmlspark_tpu.core.perf import PerfAnalytics as JaxPerfAnalytics
from mmlspark_tpu.core.perf import ProgramCost as JaxProgramCost
from mmlspark_tpu.core.perf import SloMonitor as JaxSloMonitor
from mmlspark_tpu.core.perf import SloTargets as JaxSloTargets
from mmlspark_tpu.core.perf import export_chrome_trace as jax_export
from mmlspark_tpu.core.perf import parse_slo_spec as jax_parse_slo
from mmlspark_tpu.core.telemetry import FlightRecorder as JaxRecorder
from mmlspark_tpu.core.telemetry import Histogram as JaxHistogram
from mmlspark_tpu.core.telemetry import MetricRegistry as JaxRegistry
from mmlspark_tpu.core.telemetry import NamespacedRegistry as JaxNamespaced
from mmlspark_tpu.core.telemetry import SpanTracer as JaxTracer
from mmlspark_tpu.serve.fleet import parse_autoscale_spec as jax_parse_auto
from mmlspark_tpu.serve.metrics import ServeMetrics as JaxServeMetrics
from mmlspark_tpu_torch.core import integrity
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.perf import (
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
from mmlspark_tpu_torch.core.telemetry import (
    FlightRecorder,
    Histogram,
    MetricRegistry,
    NamespacedRegistry,
    SpanTracer,
)
from mmlspark_tpu_torch.models import build_model, generate, init_variables
from mmlspark_tpu_torch.serve import ServeEngine, ServeMetrics
from mmlspark_tpu_torch.serve import engine as engine_mod
from mmlspark_tpu_torch.serve.fleet import parse_autoscale_spec
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


# -- histograms and the registry: identical calls, identical results -------


def _samples(seed: int, n: int = 500) -> list[float]:
    rng = random.Random(seed)
    return [rng.lognormvariate(2.0, 1.5) for _ in range(n)] + [0.0, 1e12]


@pytest.mark.parametrize("kw", [{}, dict(lo=1.0, hi=100.0, growth=2.0),
                                dict(growth=1.05)])
def test_histogram_summaries_equal_the_jax_package(kw):
    samples = _samples(7)
    port, ref = Histogram("t", **kw), JaxHistogram("t", **kw)
    for v in samples:
        port.record(v)
        ref.record(v)
    assert port.summary() == ref.summary()
    assert port.bucket_bounds() == ref.bucket_bounds()
    assert port.bucket_counts() == ref.bucket_counts()
    json.dumps(port.summary())
    # order independence, the point of log-bucketed bins (the sum of
    # same-scale samples rounds alike in any order)
    summaries = []
    for seed in range(3):
        body = samples[:-2]
        random.Random(seed).shuffle(body)
        h = Histogram("t", **kw)
        for v in body:
            h.record(v)
        summaries.append(h.summary())
    assert summaries[0] == summaries[1] == summaries[2]


def test_histogram_edges_empty_and_validation():
    h = Histogram("t")
    assert h.percentile(50) is None and h.mean is None
    h.record(0.0)
    assert h.percentile(50) == 0.0
    with pytest.raises(FriendlyError):
        Histogram("bad", lo=0.0)
    with pytest.raises(FriendlyError):
        Histogram("bad", growth=1.0)


def _fill(reg):
    reg.counter("serve.submitted").inc(3)
    reg.counter("train.retries_total").inc(2)
    reg.gauge("perf.mfu").set(0.25)
    reg.gauge("perf.decode[T=8].hbm_bw_util_pct").set(12.5)
    reg.gauge("empty.gauge")
    h = reg.histogram("serve.ttft_ms")
    for v in (1.0, 10.0, 100.0, 1e9):
        h.record(v)
    reg.histogram("serve.tick_ms", lo=1.0, hi=10.0, growth=2.0).record(3.0)


@pytest.mark.parametrize("labels", [None, {"replica": "0"},
                                    {"model": 'a"b\\c\nd', "role": "p"}])
def test_prometheus_text_equals_the_jax_package(labels):
    port, ref = MetricRegistry(), JaxRegistry()
    _fill(port)
    _fill(ref)
    assert port.to_prometheus(labels) == ref.to_prometheus(labels)
    assert port.to_dict() == ref.to_dict()
    text = port.to_prometheus()
    assert "serve_submitted_total 3" in text.splitlines()
    assert "train_retries_total 2" in text.splitlines()
    assert "empty_gauge" not in text


def test_registry_types_snapshot_and_namespaces():
    r = MetricRegistry()
    c = r.counter("a")
    c.inc(3)
    assert r.counter("a") is c and r.get("a") is c
    with pytest.raises(FriendlyError, match="already registered"):
        r.histogram("a")
    r.gauge("g").set(2.5)
    r.histogram("h").record(10.0)
    names = {m.name for m in r.snapshot(model="m", group="test")}
    assert names == {"a", "g", "h"}
    # a namespaced view prefixes what it creates; the read side is the
    # whole shared registry, as the JAX package's
    port, ref = MetricRegistry(), JaxRegistry()
    for inner, cls in ((port, NamespacedRegistry), (ref, JaxNamespaced)):
        for ns in ("replica0.", "replica1."):
            view = cls(inner, ns)
            view.counter("serve.completed").inc(2)
            view.histogram("serve.ttft_ms").record(4.0)
            view.gauge("slo.burning").set(1)
    assert port.names() == ref.names()
    assert NamespacedRegistry(port, "x.").to_prometheus() == \
        JaxNamespaced(ref, "x.").to_prometheus()


# -- flight recorder and spans ---------------------------------------------


def test_flight_recorder_ring_dump_and_dump_on_error(tmp_path):
    rec = FlightRecorder(capacity=8)
    for i in range(20):
        rec.record("ev", tick=i)
    assert [e["tick"] for e in rec.events()] == list(range(12, 20))
    lines = rec.dump(str(tmp_path / "ev.jsonl")).strip().splitlines()
    header = json.loads(lines[0])
    assert header["header"] == "flight_recorder"
    assert header["events"] == 8 and header["dropped"] == 12
    assert abs((rec.t0_unix + time.monotonic()) - time.time()) < 1.0
    assert (tmp_path / "ev.jsonl").read_text().splitlines() == lines
    # the same header keys and event layout as the JAX recorder's
    ref = JaxRecorder(capacity=8)
    ref.record("ev", tick=3, span=1, span_name="request", x=1)
    rec.record("ev", tick=3, span=1, span_name="request", x=1)
    strip = lambda e: {k: v for k, v in e.items() if k != "t"}  # noqa: E731
    assert strip(rec.events()[-1]) == strip(ref.events()[-1])
    assert set(json.loads(rec.dump().splitlines()[0])) == \
        set(json.loads(ref.dump().splitlines()[0]))
    path = tmp_path / "crash.jsonl"
    with pytest.raises(FriendlyError, match="boom"):
        with rec.dump_on_friendly_error(str(path)):
            raise FriendlyError("boom")
    assert json.loads(path.read_text().splitlines()[0])["events"] == 8
    with pytest.raises(ValueError):
        with rec.dump_on_friendly_error(str(tmp_path / "no.jsonl")):
            raise ValueError("not friendly")
    assert not (tmp_path / "no.jsonl").exists()


def test_span_lifecycle_equals_the_jax_tracer():
    runs = []
    for rec_cls, tracer_cls in ((FlightRecorder, SpanTracer),
                                (JaxRecorder, JaxTracer)):
        rec = rec_cls()
        tracer = tracer_cls(rec)
        s = tracer.span("request", tick=0, id=7)
        s.event("queued", tick=0, queue_depth=1)
        s.end("completed", tick=3, generated=4)
        s.end("completed", tick=9)  # a second end is a no-op
        assert tracer.span("request").id != s.id
        runs.append([
            (e["name"], e.get("tick"), e["span"], e["span_name"],
             sorted(e.get("attrs", {})))
            for e in rec.events()])
    assert runs[0] == runs[1]
    assert [r[0] for r in runs[0]] == ["start", "queued", "completed",
                                       "start"]


# -- SLOs ------------------------------------------------------------------

#: (tick clock, observations before the evaluation)
SLO_SCRIPT = [
    (0.0, [("ttft", 500.0), ("ttft", 600.0)]),
    (1.0, [("ttft", 700.0), ("finish", True)]),
    (2.0, [("per_token", 9.0), ("finish", False), ("finish", False)]),
    (3.0, [("per_token", 9.0)] * 4 + [("finish", True)] * 3),
    (11.0, []),
    (12.0, [("finish", False)] * 5),
    (30.0, []),
]


def test_slo_monitor_states_tick_for_tick():
    """One injected clock drives both monitors through burning, shedding
    and recovery: every evaluation's state, the shed signal, the burn
    streak and the recorder's alerts are the JAX monitor's."""
    targets = dict(ttft_p99_ms=50.0, per_token_p99_ms=5.0, error_rate=0.3,
                   window_s=10.0, min_samples=3)
    clock = {"t": 0.0}
    port_rec, ref_rec = FlightRecorder(), JaxRecorder()
    port_reg, ref_reg = MetricRegistry(), JaxRegistry()
    port = SloMonitor(SloTargets(**targets), recorder=port_rec,
                      registry=port_reg, clock=lambda: clock["t"])
    ref = JaxSloMonitor(JaxSloTargets(**targets), recorder=ref_rec,
                        registry=ref_reg, clock=lambda: clock["t"])
    assert port.state() == ref.state()
    burned = []
    for tick, (t, obs) in enumerate(SLO_SCRIPT):
        clock["t"] = t
        for kind, value in obs:
            for mon in (port, ref):
                getattr(mon, f"observe_{kind}")(value)
        assert port.evaluate(tick=tick) == ref.evaluate(tick=tick)
        assert (port.should_shed, port.burn_ticks) == \
            (ref.should_shed, ref.burn_ticks)
        burned.append(port.should_shed)
    assert True in burned and burned[-1] is False
    alerts = [(e["name"], e.get("tick")) for e in port_rec.events()]
    assert alerts == [(e["name"], e.get("tick")) for e in ref_rec.events()]
    assert {n for n, _ in alerts} == {"slo_violation", "slo_recovered"}
    assert port_reg.to_dict() == ref_reg.to_dict()
    with pytest.raises(FriendlyError, match="SloTargets"):
        SloMonitor({"ttft_p99_ms": 10.0})


@pytest.mark.parametrize("spec", [
    " ttft_p99_ms=50, per_token_p99_ms=5 ,error_rate=0.05,window_s=30,"
    "min_samples=2",
    "ttft_p99_ms=1e-6,min_samples=1",
    "latency=5", "ttft_p99_ms=fast", "ttft_p99_ms", "window_s=30",
])
def test_parse_slo_spec_equals_the_jax_package(spec):
    try:
        want = jax_parse_slo(spec).to_dict()
    except Exception as e:  # noqa: BLE001 — the JAX error is the oracle
        with pytest.raises(FriendlyError) as got:
            parse_slo_spec(spec)
        assert str(got.value) == str(e)
        return
    assert parse_slo_spec(spec).to_dict() == want


@pytest.mark.parametrize("spec", [
    "max_decode=4,queue_high=1.5,idle_ticks=3", "", "min_prefill=2,max_prefill=3",
    "bogus=3", "max_decode", "min_decode=3,max_decode=2", "queue_high=0",
    "cooldown_ticks=-1", "min_decode=0",
])
def test_parse_autoscale_spec_equals_the_jax_package(spec):
    try:
        want = jax_parse_auto(spec).to_dict()
    except Exception as e:  # noqa: BLE001 — the JAX error is the oracle
        with pytest.raises(FriendlyError) as got:
            parse_autoscale_spec(spec)
        assert str(got.value) == str(e)
        return
    assert parse_autoscale_spec(spec).to_dict() == want


# -- device analytics ------------------------------------------------------


def test_perf_analytics_arithmetic_equals_the_jax_package():
    """The same registrations, dispatches (queued time included) and
    ticks give the same summary and gauges."""
    peak = dict(flops_per_s=1e12, hbm_bytes_per_s=1e11, source="table",
                device_kind="test")
    port_reg, ref_reg = MetricRegistry(), JaxRegistry()
    port = PerfAnalytics(registry=port_reg, peak=DevicePeak(**peak))
    ref = JaxPerfAnalytics(registry=ref_reg, peak=JaxDevicePeak(**peak))
    for pa, cost in ((port, ProgramCost), (ref, JaxProgramCost)):
        pa.register_program("decode[T=8]", cost(1e9, 1e9, "m"))
        pa.register_program("decode[T=8]", cost(5e55, 5e55, "m"))
        pa.register_program("prefill[16]", cost.unavailable())
        pa.record_dispatch("decode[T=8]", 0.01, tokens=8)
        pa.record_dispatch("decode[T=8]", 0.004, tokens=8, queued_s=0.001)
        pa.record_dispatch("prefill[16]", 0.002, tokens=1)
        pa.record_dispatch("mystery", 0.02)
        pa.record_tick(0.05)
    assert port.summary() == ref.summary()
    assert port_reg.to_dict() == ref_reg.to_dict()
    assert port.summary()["families"]["decode[T=8]"]["flops"] == 1e9
    assert port.wants_program("chunk[8]") and not \
        port.wants_program("decode[T=8]")


def test_device_peak_table_nominal_and_env(monkeypatch):
    monkeypatch.delenv("MMLTPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("MMLTPU_PEAK_HBM_BYTES_PER_S", raising=False)

    class FakeCard:
        device_kind = "NVIDIA H100 80GB HBM3"

    p = device_peak(FakeCard())
    assert (p.source, p.flops_per_s, p.hbm_bytes_per_s) == \
        ("table", 989e12, 3.35e12)
    # this suite's CPU is no card in the table
    assert device_peak(torch.device("cpu")).source == "nominal"
    monkeypatch.setenv("MMLTPU_PEAK_FLOPS", "2e12")
    p2 = device_peak(FakeCard())
    assert p2.source == "env" and p2.flops_per_s == 2e12
    assert p2.hbm_bytes_per_s == 3.35e12  # the unset half keeps the table


def test_analyze_program_cost_counts_and_degrades():
    """A body's FLOPs and bytes on meta tensors (nothing computed, no
    storage); a body that needs tensor values degrades to
    ``unavailable``."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    cost = analyze_program_cost(lambda x, y: (x @ y).relu(), a, b)
    assert cost.source == "meta"
    assert cost.flops == 2 * 8 * 16 * 4
    # mm: both inputs and its output; relu: its input and output
    assert cost.bytes_accessed == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * 2 * 32
    bad = analyze_program_cost(lambda x: int(x.sum()), a)
    assert bad == ProgramCost.unavailable()
    # a scatter writes its source's size, not the whole destination
    dst, idx, src = torch.zeros(100, 8), torch.tensor([3]), torch.ones(1, 8)
    cost = analyze_program_cost(
        lambda d, i, s: d.index_put_((i,), s), dst, idx, src)
    assert cost.bytes_accessed == 8 + 2 * 32


# -- the Chrome trace --------------------------------------------------------


def _synthetic(rec_cls, tracer_cls):
    rec = rec_cls()
    tracer = tracer_cls(rec)
    s = tracer.span("request", tick=0, id=3)
    s.event("queued", tick=0)
    s.event("admitted", tick=0, slot=0)
    rec.record("dispatch", tick=0, family="prefill[8]", ms=2.0, tokens=1)
    rec.record("dispatch", tick=1, family="decode[T=4]", ms=1.5, tokens=4)
    rec.record("tick", tick=1, ms=4.0, tokens=4)
    rec.record("retrace", tick=1, signature="f32[4]")
    s.end("completed", tick=1, generated=4)
    s2 = tracer.span("request", tick=1, id=4)  # never ends: open slice
    s2.event("queued", tick=1)
    return rec


def test_chrome_trace_layout_equals_the_jax_exporter(tmp_path):
    rec = _synthetic(FlightRecorder, SpanTracer)
    doc = export_chrome_trace(rec, path=str(tmp_path / "trace.json"))
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        export_chrome_trace(rec), sort_keys=True)
    assert json.loads((tmp_path / "trace.json").read_text()) == \
        json.loads(json.dumps(doc))
    ref = jax_export(_synthetic(JaxRecorder, JaxTracer))

    def layout(d):
        return sorted((e["name"], e["ph"], e["pid"], e["tid"])
                      for e in d["traceEvents"])

    assert layout(doc) == layout(ref)
    evs = doc["traceEvents"]
    n_meta = sum(1 for e in evs if e["ph"] == "M")
    rest = evs[n_meta:]
    assert all(rest[i]["ts"] <= rest[i + 1]["ts"]
               for i in range(len(rest) - 1))


# -- serving wiring ----------------------------------------------------------

TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)


@pytest.fixture(scope="module")
def lm():
    graph = build_model("transformer_lm", **TINY)
    return graph, init_variables(graph, 0, device="cpu")


def _ref(lm, prompt, n):
    ids = torch.as_tensor(np.asarray(prompt, np.int32)[None])
    return generate(lm[0], lm[1], ids, n, device="cpu")[0].numpy()


def test_metrics_schema_equals_the_jax_package():
    """The port's ServeMetrics reports exactly the JAX package's keys,
    and its hand-off, SLO and analytics hooks count as they do."""
    port, ref = ServeMetrics("m", 2), JaxServeMetrics("m", 2)
    assert set(port.to_dict()) == set(ref.to_dict())
    port.record_reject()
    time.sleep(0.01)
    port.record_reject()
    port.record_handoff_adopt()
    port.record_handoff_fallback()
    port.record_integrity_handoff_failure()
    d = port.to_dict()
    assert d["rejected"] == 2 and d["wall_s"] > 0.0
    assert (d["handoffs_adopted_total"], d["handoff_fallbacks_total"],
            d["integrity_checksum_failures_total"]) == (1, 1, 1)
    assert port.ttft_p99_ms() == port.per_token_p99_ms() == \
        port.tick_p99_ms() == 0.0
    port.prefill_buckets = {"8": 3}
    tables = {r.name: r for r in port.snapshot() if r.group == "table"}
    assert tables["serve.prefill_buckets"].value == {"8": 3}


def test_analytics_keep_the_fetch_and_program_contracts(lm, monkeypatch):
    """THE bar: with analytics AND an SLO monitor on, one request
    decoding 16 tokens through T=8 blocks pays at most one fetch a block
    (counted through the engine's one fetch helper), the program pins
    hold, and every family is costed on meta tensors."""
    prompt = np.arange(4) % TINY["vocab_size"]
    engine = ServeEngine(
        lm[0], lm[1], slots=1, cache_len=32, decode_block=8, device="cpu",
        slo="ttft_p99_ms=60000,per_token_p99_ms=60000,error_rate=0.99")
    rid = engine.submit(prompt, max_new_tokens=17)  # 1 prefill + 16 decode
    fetches = {"n": 0}
    real = engine._fetch

    def counting(inflight):
        fetches["n"] += 1
        return real(inflight)

    engine._fetch = counting
    with serve_compile_guard(engine, min_decode=1, min_prefill=1):
        res = engine.run()[rid]
    np.testing.assert_array_equal(res.tokens, _ref(lm, prompt, 17))
    assert fetches["n"] <= 2, fetches
    d = engine.metrics.to_dict()
    fams = d["perf_families"]
    assert any(f.startswith("decode[T=") for f in fams)
    assert any(f.startswith("prefill[") for f in fams)
    for f in fams.values():
        assert f["dispatches"] >= 1 and f["cost_source"] == "meta"
    assert isinstance(d["mfu"], float) and isinstance(d["device_time_pct"],
                                                      float)
    assert d["slo"]["declared"] is True and d["slo_burning"] == 0
    # the block's cost, extended from 1 and 2 micro-steps, equals the
    # block analyzed whole
    pool = engine.pool
    args = (engine.variables, pool.buffers, pool.positions, pool.live,
            torch.zeros(1, dtype=torch.int32),
            torch.full((1,), 4, dtype=torch.int32),
            torch.full((1,), -1, dtype=torch.int32))
    whole = analyze_program_cost(engine._decode_body, *args, 8)
    assert fams["decode[T=8]"]["flops"] == whole.flops
    assert fams["decode[T=8]"]["bytes_accessed"] == whole.bytes_accessed
    # the costs are the engine's: metrics made afresh take them without
    # a second analysis
    engine.metrics = ServeMetrics("m", 1, decode_block=8)
    calls = []
    monkeypatch.setattr(engine_mod, "analyze_program_cost",
                        lambda *a: calls.append(a))
    engine.submit(prompt, max_new_tokens=17)
    engine.run()
    assert not calls
    assert engine.metrics.to_dict()["perf_families"].keys() == fams.keys()


def test_slo_shedding_suppresses_admissions_but_completes(lm):
    """An impossible TTFT target trips shedding while a request is in
    flight — but an idle engine always admits, so every request still
    completes, each equal to generate()."""
    prompt = np.arange(4) + 3
    engine = ServeEngine(
        lm[0], lm[1], slots=1, cache_len=32, max_queue=8, decode_block=2,
        device="cpu", slo="ttft_p99_ms=0.000001,min_samples=1,window_s=600")
    rids = [engine.submit(prompt, max_new_tokens=8) for _ in range(3)]
    res = engine.run()
    want = _ref(lm, prompt, 8)
    for r in rids:
        np.testing.assert_array_equal(res[r].tokens, want)
    d = engine.metrics.to_dict()
    assert d["slo_violations_total"] > 0 and d["slo_shed_ticks_total"] > 0
    assert d["slo"]["burning"] is True
    names = {e["name"] for e in engine.recorder.events()}
    assert {"slo_violation", "slo_shed"} <= names
    with pytest.raises(FriendlyError, match="unknown SLO key"):
        ServeEngine(lm[0], lm[1], slots=1, cache_len=32, slo="latency=5",
                    device="cpu")


def test_engine_spans_and_chrome_trace(lm):
    engine = ServeEngine(lm[0], lm[1], slots=2, cache_len=32,
                         decode_block=2, device="cpu")
    rids = [engine.submit(np.arange(4) + 1, max_new_tokens=5)
            for _ in range(2)]
    res = engine.run()
    assert all(res[r].status == "completed" for r in rids)
    spans = {}
    for e in engine.recorder.events():
        if e.get("span_name") == "request":
            spans.setdefault(e["span"], []).append(e["name"])
    assert len(spans) == 2
    for names in spans.values():
        assert names[0] == "start" and names[-1] == "completed"
        assert {"queued", "admitted", "prefill", "decode"} <= set(names)
    doc = export_chrome_trace(engine.recorder)
    evs = doc["traceEvents"]
    req = [e for e in evs if e["ph"] == "X"
           and e["name"].startswith("request ")]
    assert len(req) == 2 and all("[completed]" in e["name"] for e in req)
    assert any(e["ph"] == "X" and e["name"].startswith("decode[T=")
               for e in evs)
    assert any(e["ph"] == "X" and e["name"].startswith("prefill[")
               for e in evs)


def test_demo_and_train_demo_write_their_bundles(tmp_path):
    """``serve`` writes events.jsonl (one complete span a request),
    metrics.json, trace.json and metrics.prom; the trainer's bundle now
    carries metrics.prom too."""
    from mmlspark_tpu_torch.serve.demo import run_demo
    from mmlspark_tpu_torch.train.demo import run_train_demo

    out = run_demo(slots=2, n_requests=3, max_new_tokens=3,
                   arrivals_per_tick=2, vocab=32, d_model=16, heads=2,
                   depth=1, cache_len=32, seed=0, device="cpu",
                   telemetry_dir=str(tmp_path / "serve"))
    d = tmp_path / "serve"
    events = [json.loads(ln) for ln in
              (d / "events.jsonl").read_text().splitlines()[1:]]
    spans = {}
    for e in events:
        if e.get("span_name") == "request":
            spans.setdefault(e["span"], []).append(e["name"])
    assert len(spans) == 3
    for names in spans.values():
        assert {"queued", "admitted", "prefill"} <= set(names)
        assert names[-1] == "completed"
    assert any(e["name"] == "retrace" for e in events)
    assert json.loads((d / "metrics.json").read_text()) == \
        json.loads(json.dumps(out, default=str))
    json.loads((d / "trace.json").read_text())
    assert "serve_completed_total 3" in (d / "metrics.prom").read_text()
    run_train_demo(epochs=1, n_samples=64, batch_size=32, device="cpu",
                   telemetry_dir=str(tmp_path / "train"))
    prom = (tmp_path / "train" / "metrics.prom").read_text()
    assert "# TYPE" in prom and "train_" in prom


def test_corrupt_payload_flips_one_bit_and_fails_the_checksum():
    gen = torch.Generator().manual_seed(0)
    kv = {"b1": (torch.randn(1, 5, 2, 4, generator=gen).bfloat16(),
                 torch.randn(1, 5, 2, 4, generator=gen).bfloat16()),
          "b0": (torch.randn(1, 5, 2, 4, generator=gen),
                 torch.randn(1, 5, 2, 4, generator=gen))}
    pay = {"prompt": np.arange(3), "prefix": np.arange(2), "length": 5,
           "first_token": 1, "kv": kv}
    pay["checksum"] = integrity.payload_checksum(pay)
    keep = {k: tuple(t.clone() for t in v) for k, v in kv.items()}
    for seed in range(4):
        bad = integrity.corrupt_payload(pay, seed)
        assert integrity.verify_payload(pay)[0]
        assert not integrity.verify_payload(bad)[0]
        flipped = sum(
            int(np.unpackbits(np.bitwise_xor(
                integrity._host_array(a).view(np.uint8),
                integrity._host_array(b).view(np.uint8))).sum())
            for a, b in zip(integrity.tree_leaves(pay["kv"]),
                            integrity.tree_leaves(bad["kv"])))
        assert flipped == 1
    for k, v in keep.items():  # the producer's cache is untouched
        for a, b in zip(v, kv[k]):
            assert torch.equal(a, b)
