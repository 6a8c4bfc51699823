"""The serving engine's tracing on the CPU: the profiler ranges that split
``ServeEngine.step`` into its phases, the requests' admission and
first-token stamps, the anchor that puts the program's clock on the
profiler's timeline, ``annotate``'s shared null context while no
profiler runs, and ``ServeMetrics``' running per-tick aggregates against
the per-tick lists they replace.

A tiny ``transformer_lm`` engine with one slot and three requests, so the
second and third wait in the queue behind the first."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmlspark_tpu_torch.models import build_model, init_variables
from mmlspark_tpu_torch.serve import ServeEngine
from mmlspark_tpu_torch.utils.profiling import (
    CLOCK_ANCHOR,
    annotate,
    clock_anchor,
    clock_offset_ns,
    trace_profile,
)

TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)

#: the innermost ranges a tick's host time may lie in
LEAVES = {"serve.account", "serve.admit", "serve.prefill", "serve.handoff",
          "serve.decode.inputs", "serve.decode.launch", "serve.decode.stage",
          "serve.decode.fetch", "serve.decode.consume", "serve.capture"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    graph = build_model("transformer_lm", **TINY)
    return graph, init_variables(graph, seed=3, device="cpu")


def engine_with_queue(lm, slots: int = 1, n: int = 3) -> ServeEngine:
    engine = ServeEngine(*lm, slots=slots, cache_len=32, decode_block=4,
                         device="cpu")
    rng = np.random.default_rng(7)
    for i in range(n):
        engine.submit(rng.integers(0, 64, size=5 + 2 * i), 6)
    return engine


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def innermost_cover(spans, lo: float, hi: float) -> dict[str, float]:
    """Microseconds of ``[lo, hi)`` by the innermost (latest-starting)
    of ``spans`` open there; None where none is."""
    cuts = sorted({lo, hi, *(x for a, b, _ in spans for x in (a, b)
                             if lo < x < hi)})
    out: dict = {}
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        open_ = [(s, n) for s, e, n in spans if s <= mid < e]
        name = max(open_)[1] if open_ else None
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def test_leaf_spans_cover_a_step(lm):
    engine = engine_with_queue(lm)
    with cpu_profile() as prof:
        # the process's first range pays ~1 ms of the profiler's own
        # start-up: not the step's
        with torch.profiler.record_function("test.warm"):
            pass
        with torch.profiler.record_function("test.step"):
            engine.step()
    events = [e for e in prof.events()
              if e.name.startswith(("serve.", "test.step"))]
    (step,) = [e for e in events if e.name == "test.step"]
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in events if e.name.startswith("serve.")]
    names = {n for _, _, n in spans}
    assert names <= LEAVES | {"serve.decode"}
    assert {"serve.account", "serve.admit", "serve.prefill",
            "serve.decode.inputs", "serve.decode.launch",
            "serve.decode.stage", "serve.decode.fetch",
            "serve.decode.consume"} <= names
    cover = innermost_cover(spans, step.time_range.start,
                            step.time_range.end)
    wall = step.time_range.end - step.time_range.start
    leaf = sum(us for n, us in cover.items() if n in LEAVES)
    assert leaf >= 0.98 * wall, cover


def test_annotate_is_one_null_context_while_no_profiler_runs():
    assert annotate("serve.a") is annotate("serve.b")
    with annotate("serve.a"):
        pass
    assert clock_anchor() is None
    with cpu_profile():
        assert isinstance(annotate("serve.a"),
                          torch.profiler.record_function)
        assert clock_anchor() is not None


def test_stamps_order_and_queue(lm):
    engine = engine_with_queue(lm)
    results = engine.run()
    res = [results[i] for i in sorted(results)]
    assert [r.status for r in res] == ["completed"] * 3
    for r in res:
        assert r.submitted_at <= r.admitted_at <= r.first_token_at
    # one slot: the second and third wait for the first to finish
    for r in res[1:]:
        assert r.admitted_at >= res[0].first_token_at


def test_admission_stamp_lies_in_an_admit_range(lm):
    engine = engine_with_queue(lm)
    with cpu_profile() as prof:
        stamp = clock_anchor()
        results = engine.run()
    offset = clock_offset_ns(prof, stamp)
    assert offset is not None
    t0 = prof.profiler.kineto_results.trace_start_ns()
    admits = [(t0 + e.time_range.start * 1e3, t0 + e.time_range.end * 1e3)
              for e in prof.events() if e.name == "serve.admit"]
    slack = 0.2e6  # ns
    for r in results.values():
        at = r.admitted_at * 1e9 + offset
        assert any(a - slack <= at <= b + slack for a, b in admits), r.id


def test_trace_profile_writes_the_clock_offset(tmp_path):
    with trace_profile(str(tmp_path)):
        torch.ones(4).sum()
    (path,) = tmp_path.glob("trace_*.json")
    trace = json.loads(path.read_text())
    ts = max(e["ts"] for e in trace["traceEvents"]
             if e.get("name") == CLOCK_ANCHOR)
    offset = trace["clock_offset_ns"]
    # the last anchor's start, put back on the program's clock, is the
    # stamp: some moment of this process's life, before now
    epoch_ns = trace["baseTimeNanoseconds"] + ts * 1e3
    assert 0 < (time.perf_counter_ns() - (epoch_ns - offset)) < 60e9


def test_running_tick_aggregates_equal_the_lists(lm):
    """``to_dict``'s per-tick figures from the running count, sums and
    maxima against the same figures from per-tick lists, over one run."""
    engine = engine_with_queue(lm, slots=2, n=6)
    m = engine.metrics
    depth, util, secs = [], [], []
    sample = m.sample_tick

    def listed(queue_depth, leased, seconds, tokens_emitted=0):
        depth.append(queue_depth)
        util.append(leased / m.slots)
        secs.append(seconds)
        sample(queue_depth, leased, seconds, tokens_emitted=tokens_emitted)

    m.sample_tick = listed
    engine.run()
    d = m.to_dict()
    assert len(depth) > 3 and max(depth) > 0
    assert d["ticks"] == len(secs)
    assert d["queue_depth_mean"] == sum(depth) / len(depth)
    assert d["queue_depth_max"] == max(depth)
    assert d["slot_utilization_mean"] == round(sum(util) / len(util), 4)
    assert d["slot_utilization_peak"] == round(max(util), 4)
    assert d["host_idle_fraction"] == round(
        min(1.0, m.host_sync_wait_s / sum(secs)), 4)
