"""The serving driver: the port's ``ServeEngine`` under a closed or an
open loop.

Set-up builds the engine on the seed's weights and warms exactly the
programs the cell's traffic reaches: one prefill per bucket of its
prompt lengths, and every size of the decode-block ladder (one request
whose budget walks 32, 16, ..., 1), twice, so the window replays what
was captured.

The window starts when the first request is due. A closed loop's
clients each send their next request as soon as the last one finished;
an open loop sends each request at its due time, whatever the queue
holds, and times it from then. Every ``engine.step()`` runs under the
harness's ``step`` span. When the window has closed, an open loop keeps
stepping, with no new arrivals, until every request due in the window
has finished (at most ``DRAIN_S``), so that each has its first token
and its last.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.trace import Tracer, span

#: how long an open loop waits past the close for its due requests
DRAIN_S = 60.0


@dataclass
class Record:
    prompt: np.ndarray
    max_new: int
    due: float  # host clock
    first: float | None = None  # end of the step whose results carry it
    finish: float | None = None
    served: np.ndarray | None = None


@dataclass
class ServeOutcome:
    t0: float
    t_close: float
    records: dict = field(default_factory=dict)  # engine id -> Record
    counters: dict = field(default_factory=dict)  # over the window
    trace_counters: dict | None = None  # over the traced steps
    trace: dict | None = None
    tokens: int = 0  # output tokens emitted in the window
    submitted: int = 0
    open_loop: bool = False


def build_engine(graph, weights: dict, workload: dict, device):
    from mmlspark_tpu_torch.serve.engine import ServeEngine

    return ServeEngine(graph, weights, device=device, **workload["engine"])


def warm(engine, workload: dict, rng: np.random.Generator, vocab: int):
    """Capture the prefill buckets of the traffic's prompt lengths and the
    whole decode-block ladder, then replay them once."""
    lo = int(workload["prompt_len"].get("lo", workload["prompt_len"].get(
        "value", 1)))
    hi = int(workload["prompt_len"].get("hi", lo))
    buckets = sorted({engine.prefill_bucket(p) for p in range(lo, hi + 1)})
    ladder = 2 * engine.decode_block  # first token + 32 + 16 + ... + 1
    for _ in range(2):
        for i, b in enumerate(buckets):
            p = min(hi, b, engine.cache_len - ladder - 1) if i == 0 \
                else min(hi, b)
            engine.submit(rng.integers(0, vocab, size=p).astype(np.int32),
                          ladder if i == 0 else 1)
        while engine.busy:
            engine.step()
    return buckets


def snapshot(engine) -> dict:
    m = engine.metrics
    return {
        "decode_tokens": m.decode_tokens,
        "decode_live_kv": m.decode_live_kv,
        "decode_blocks": dict(m.decode_blocks),
        "first_tokens": len(m.ttft_req_ids),
        "ticks": len(m.tick_tokens),
    }


def window_counters(engine, records: dict, a: dict, b: dict) -> dict:
    """What the program counted between two snapshots: decode tokens,
    their live positions, blocks and micro-steps, and the prefills'
    prompt lengths and buckets."""
    m = engine.metrics
    blocks = {int(k): b["decode_blocks"].get(k, 0) - a["decode_blocks"].get(
        k, 0) for k in b["decode_blocks"]}
    ids = m.ttft_req_ids[a["first_tokens"]:b["first_tokens"]]
    lengths = [len(records[i].prompt) for i in ids if i in records]
    return {
        "decode_tokens": b["decode_tokens"] - a["decode_tokens"],
        "decode_live_kv": b["decode_live_kv"] - a["decode_live_kv"],
        "decode_blocks": sum(blocks.values()),
        "decode_microsteps": sum(t * n for t, n in blocks.items()),
        "prefill_lengths": lengths,
        "prefill_buckets": [engine.prefill_bucket(p) for p in lengths],
        "tokens": int(sum(m.tick_tokens[a["ticks"]:b["ticks"]])),
    }


def drive(engine, requests: list, workload: dict, seconds: float,
          tracer: Tracer | None, trace_seconds: float) -> ServeOutcome:
    open_loop = workload["driver"] == "open"
    records: dict[int, Record] = {}
    m = engine.metrics
    seen_first = len(m.ttft_req_ids)

    def submit(req, due):
        with span("submit"):
            rid = engine.submit(req.prompt, req.max_new)
        records[rid] = Record(req.prompt, req.max_new, due)

    def step():
        nonlocal seen_first
        with span("step"):
            finished = engine.step()
        now = time.perf_counter()
        for rid in m.ttft_req_ids[seen_first:]:
            if rid in records:
                records[rid].first = now
        seen_first = len(m.ttft_req_ids)
        for res in finished:
            rec = records.get(res.id)
            if rec is None:
                continue
            if res.status != "completed":
                raise RuntimeError(
                    f"request {res.id} ended {res.status!r}, not completed")
            rec.finish = now
            rec.served = np.asarray(res.tokens[res.prompt_len:], np.int32)
        return finished, now

    t0 = time.perf_counter()
    t_end = t0 + seconds
    trace_at = t_end - min(trace_seconds, seconds)
    out = ServeOutcome(t0=t0, t_close=t0, open_loop=open_loop)
    start = snapshot(engine)
    nxt = 0
    if not open_loop:
        for req in requests[:int(workload["clients"])]:
            submit(req, t0)
        nxt = int(workload["clients"])
    trace_snap = None
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if tracer is not None and trace_snap is None and now >= trace_at:
            trace_snap = snapshot(engine)
            tracer.start()
        if open_loop:
            while nxt < len(requests) and t0 + requests[nxt].due <= now:
                submit(requests[nxt], t0 + requests[nxt].due)
                nxt += 1
            if not engine.busy:
                wake = t0 + requests[nxt].due if nxt < len(requests) \
                    else t_end
                with span("wait"):
                    time.sleep(max(0.0, min(wake, t_end) - now))
                continue
        finished, now = step()
        if not open_loop:
            for _ in finished:
                if nxt < len(requests):
                    submit(requests[nxt], now)
                    nxt += 1
    out.t_close = time.perf_counter()
    if trace_snap is not None:
        # the trace covers the window's last steps; reading it happens
        # after the close
        tracer.stop()
        out.trace_counters = window_counters(engine, records, trace_snap,
                                             snapshot(engine))
    out.counters = window_counters(engine, records, start, snapshot(engine))
    out.tokens = out.counters["tokens"]
    if open_loop:
        # the arrivals due before the close that the last step outlasted
        while nxt < len(requests) and requests[nxt].due < seconds:
            submit(requests[nxt], t0 + requests[nxt].due)
            nxt += 1
    out.submitted = len(records)
    if open_loop:
        deadline = out.t_close + DRAIN_S
        while engine.busy and time.perf_counter() < deadline:
            step()
    out.trace = tracer.summary if tracer is not None else None
    out.records = records
    return out
