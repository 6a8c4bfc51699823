"""The program's spans and request stamps read against a traced window of
one cell: where the card's idle time falls on the host, and what a
request's time to first token is made of.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

from the checkout's root. It builds and warms the cell's program as
``benchmark.run`` does, drives it for ``--seconds`` with the window's
last ``trace_seconds`` under the profiler, and prints one JSON object as
the last line of standard output:

- ``idle_by_span``: the card's idle seconds in the traced window, each
  idle instant given to the innermost host span open over it (a harness
  ``bench.`` span where no program span is open, ``none`` outside every
  span), split by overlap and not by where a gap began, as
  ``benchmark.trace``'s ``idle_gaps`` names it;
- ``idle_admit_share`` and ``idle_decode_share``: the idle time under
  ``serve.admit`` and ``serve.decode`` with their nested spans, and
  ``idle_outside_serve_share`` under no ``serve.`` span, in percent of
  the window;
- in an open-loop cell, over the requests that ``ttft_p50_ms`` counts:
  ``queue_wait_p50_ms`` (due to the program's ``admitted_at``),
  ``prefill_p50_ms`` (``admitted_at`` to ``first_token_at``) and
  ``idle_queued_share``, the idle time during which a request due in the
  window waited for admission, in percent of the window.

None of these is in the benchmark's result line yet; this run is the
reading they come from. The program's ``clock_anchor`` ties its
``time.perf_counter`` to the trace's clock (``clock_offset_ns``), so the
stamps and the window's start land on the trace exactly. The card's
timestamps drift from the host's within a trace; the split puts the host
spans on the card's clock first (:func:`device_lead`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.trace import Tracer, _is_device_op, _merge, summarize

#: the range the program's ``utils.profiling.clock_anchor`` leaves: the
#: last one's start is the ``time.perf_counter_ns()`` the call returned
ANCHOR = "serve.clock_anchor"

#: the stretch of host time over which the least launch-to-start delay
#: is taken as the card clock's lead (:func:`device_lead`), and how far
#: above the lead's trend a stretch's least delay may stand
LEAD_BUCKET_US = 50_000.0
LEAD_SPIKE_US = 2_000.0

#: the program's stamps that a finished request carries
STAMPS = ("submitted_at", "admitted_at", "first_token_at")


class Idle:
    """Sorted, disjoint idle intervals (``intervals``, n by 2) and the
    idle length before any moment, by their running sum."""

    def __init__(self, intervals):
        self.intervals = np.asarray(intervals, float).reshape(-1, 2)
        self.cum = np.concatenate(
            [[0.0], np.cumsum(self.intervals[:, 1] - self.intervals[:, 0])])

    def before(self, t: float) -> float:
        k = int(np.searchsorted(self.intervals[:, 0], t, side="right")) - 1
        if k < 0:
            return 0.0
        a, b = self.intervals[k]
        return float(self.cum[k] + max(0.0, min(t, b) - a))

    def between(self, a: float, b: float) -> float:
        return self.before(b) - self.before(a)


def split_idle(idle: Idle, spans: list) -> tuple[dict, dict]:
    """Idle length by the innermost of the nested ``spans`` (start, end,
    name) open over it, ``none`` outside all of them, and by every span
    open over it (a name's idle with its nested spans')."""
    under = idle.between
    inner: dict[str, float] = {}
    nested: dict[str, float] = {}
    # parents before children: by start, the longer first
    stack: list = []  # [end, name, its idle, its children's idle]
    top = 0.0

    def close(entry):
        end, name, own, kids = entry
        inner[name] = inner.get(name, 0.0) + own - kids
        nested[name] = nested.get(name, 0.0) + own
        if stack:
            stack[-1][3] += own

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            close(stack.pop())
        if stack:
            b = min(b, stack[-1][0])
        else:
            top += under(a, b)
        stack.append([b, name, under(a, b), 0.0])
    while stack:
        close(stack.pop())
    inner["none"] = float(idle.cum[-1]) - top
    return inner, nested


def device_lead(launches: dict, first_start: dict) -> tuple:
    """Where the card's timestamps stand against the host's in one trace,
    as points to interpolate: (host times, the card clock's lead there,
    both in us). ``launches`` maps a runtime call's correlation id to its
    start on the host, ``first_start`` to the start of the first device
    operation it enqueued. In each :data:`LEAD_BUCKET_US` of launches the
    least delay is the lead there, since a copy or kernel launched onto
    an idle card starts within microseconds. A stretch whose launches
    all queued behind work stands above the trend (the median of the
    slopes between stretches, through the median intercept) by more than
    :data:`LEAD_SPIKE_US`, and is dropped. On an H100 under the serving
    loop kineto's card timestamps were seen to run from the host's by
    1-7 ms a second, either way."""
    best: dict[int, tuple] = {}
    for cid, host in launches.items():
        dev = first_start.get(cid)
        if dev is None:
            continue
        k = int(host // LEAD_BUCKET_US)
        if k not in best or dev - host < best[k][1]:
            best[k] = (host, dev - host)
    pts = [best[k] for k in sorted(best)]
    t = np.array([p[0] for p in pts], float)
    d = np.array([p[1] for p in pts], float)
    if len(d) >= 3:
        i, j = np.triu_indices(len(d), 1)
        slope = np.median((d[j] - d[i]) / (t[j] - t[i]))
        trend = np.median(d - slope * t) + slope * t
        keep = d <= trend + LEAD_SPIKE_US
        t, d = t[keep], d[keep]
    return t, d


def split(events, window_s: float, *, anchor_ns: int | None = None,
          start_s: float | None = None,
          trace_start_ns: int | None = None) -> dict:
    """The idle time of a traced window of ``window_s`` seconds, split by
    span, from the profiler's events. ``anchor_ns`` is what the program's
    ``clock_anchor`` returned, ``start_s`` the window's start on the same
    clock (``time.perf_counter``), ``trace_start_ns`` the trace's start
    in Unix-epoch ns (for ``clock_offset_ns``). Without the anchor the
    harness spans' extent is the window, and nothing maps to the host
    clock."""
    ops, spans, bench = [], [], []
    anchor_us = None
    launches, first_start = {}, {}
    for e in events:
        tr = e.time_range
        cid = getattr(e, "id", 0)
        if _is_device_op(e):
            ops.append((tr.start, tr.end))
            if cid:
                first_start[cid] = min(tr.start,
                                       first_start.get(cid, tr.start))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            if e.name.startswith("cuda") and cid:
                launches[cid] = tr.start
            elif e.name == ANCHOR:
                # the last of the anchor's ranges carries the stamp
                anchor_us = max(tr.start, anchor_us or tr.start)
            elif e.name.startswith(("bench.", "serve.", "train.")):
                spans.append((tr.start, tr.end, e.name))
                if e.name.startswith("bench."):
                    bench.append((tr.start, tr.end))
    merged = _merge(ops)
    busy = sum(b - a for a, b in merged) * 1e-6
    # the window on the trace's clock: from the anchor where the program
    # left one, else the harness spans' extent
    mapped = None not in (anchor_us, anchor_ns, start_s)
    offset_ns = None
    if mapped:
        w0 = anchor_us + (start_s * 1e9 - anchor_ns) * 1e-3
        w1 = w0 + window_s * 1e6
        if trace_start_ns is not None:
            offset_ns = int(round(trace_start_ns + anchor_us * 1e3)) \
                - anchor_ns
    elif bench:
        w0, w1 = min(s[0] for s in bench), max(s[1] for s in bench)
    else:
        w0 = w1 = 0.0
    # the window and the host spans on the card's clock, then the holes
    # between the device operations, cut to the window
    lead_t, lead = device_lead(launches, first_start)

    def lead_at(t):
        return np.interp(t, lead_t, lead) if len(lead) else 0.0 * t

    c0, c1 = w0 + float(lead_at(w0)), w1 + float(lead_at(w1))
    m = np.asarray(merged, float).reshape(-1, 2)
    lo = np.maximum(np.concatenate([[c0], m[:, 1]]), c0)
    hi = np.minimum(np.concatenate([m[:, 0], [c1]]), c1)
    idle = Idle(np.stack([lo, hi], 1)[hi > lo])
    inner, nested = split_idle(idle, [
        (a + float(lead_at(a)), b + float(lead_at(b)), name)
        for a, b, name in spans])
    return {
        "busy_s": busy,
        "window_s": window_s,
        # seconds by the innermost span over each idle instant
        "idle_by_span": {k: v * 1e-6 for k, v in sorted(
            inner.items(), key=lambda kv: -kv[1])},
        # seconds under each span, its nested spans' included
        "idle_under": {k: v * 1e-6 for k, v in nested.items()},
        # perf_counter_ns + clock_offset_ns = the trace's Unix-epoch ns
        "clock_offset_ns": offset_ns,
        # the idle intervals (n by 2) in time.perf_counter seconds
        "idle_intervals": (start_s + (idle.intervals - lead_at(
            idle.intervals) - w0) * 1e-6 if mapped else None),
        # the card clock's lead on the host's at the window's ends (us):
        # the idle split above sums to the idle time plus their change
        "device_lead_us": [c0 - w0, c1 - w1] if len(lead) else None,
    }


@dataclass
class Request:
    """One request of an open-loop window: the harness's due time and
    first-token time, and the program's stamps, all on
    ``time.perf_counter`` (a stamp None where the program keeps none)."""
    due: float
    first: float | None
    submitted_at: float | None = None
    admitted_at: float | None = None
    first_token_at: float | None = None


def _median(values: list[float]) -> float:
    s = sorted(values)
    return s[max(0, -(-len(s) // 2) - 1)]


def idle_under_share(sp: dict, name: str) -> float | None:
    """The idle time under the span ``name``, its nested spans' included,
    in percent of the window."""
    if sp["busy_s"] <= 0 or name not in sp["idle_under"]:
        return None
    return 100.0 * sp["idle_under"][name] / sp["window_s"]


def idle_outside_serve_share(sp: dict) -> float | None:
    """The idle time under no ``serve.`` span, in percent of the
    window."""
    if sp["busy_s"] <= 0:
        return None
    rest = sum(v for k, v in sp["idle_by_span"].items()
               if not k.startswith("serve."))
    return 100.0 * rest / sp["window_s"]


def queue_wait_p50_ms(requests: list) -> float | None:
    """The nearest-rank median of the wait from a request's due time to
    its admission, in ms. A request due while a step runs waits for that
    step, as it would in a server's queue; one the program never admitted
    counts as the longest wait."""
    waits = [(r.admitted_at - r.due) * 1e3 for r in requests
             if r.admitted_at is not None]
    if not waits:
        return None
    return _median(waits + [max(waits)] * (len(requests) - len(waits)))


def prefill_p50_ms(requests: list) -> float | None:
    """The nearest-rank median of the time from a request's admission to
    its first token in the program's hand (its own prefill and its sync),
    in ms; one without both stamps counts as the longest."""
    own = [(r.first_token_at - r.admitted_at) * 1e3 for r in requests
           if r.admitted_at is not None and r.first_token_at is not None]
    if not own:
        return None
    return _median(own + [max(own)] * (len(requests) - len(own)))


def idle_queued_share(sp: dict, requests: list) -> float | None:
    """The idle time during which at least one request due in the window
    was not yet admitted (the union of each ``[due, admitted_at)``,
    open-ended where it was never admitted), in percent of the window:
    idle time with work waiting is a host stall, the rest of the card's
    idle time had nothing queued."""
    if sp["busy_s"] <= 0 or sp["idle_intervals"] is None or \
            not any(r.admitted_at is not None for r in requests):
        return None
    waiting = []
    for a, b in sorted((r.due, float("inf") if r.admitted_at is None
                        else r.admitted_at) for r in requests):
        if b <= a:
            continue
        if waiting and a <= waiting[-1][1]:
            waiting[-1][1] = max(waiting[-1][1], b)
        else:
            waiting.append([a, b])
    idle = Idle(sp["idle_intervals"])
    queued = sum(idle.between(a, b) for a, b in waiting)
    return 100.0 * queued / sp["window_s"]


class StampedEngine:
    """The program's engine as ``serve.drive`` sees it, keeping the
    stamps of every finished request by its id."""

    def __init__(self, engine):
        self._engine = engine
        self.stamps: dict[int, dict] = {}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self):
        finished = self._engine.step()
        for res in finished:
            self.stamps[res.id] = {k: getattr(res, k, None) for k in STAMPS}
        return finished


class SpanTracer(Tracer):
    """The harness's tracer that also leaves the program's clock anchor
    at the window's start and, at its stop, splits the idle time by span
    (``split``) beside the harness's own reduction (``summary``)."""

    anchor_ns = None
    split = None

    def start(self) -> None:
        super().start()
        try:
            from mmlspark_tpu_torch.utils.profiling import clock_anchor
        except ImportError:
            return
        self.anchor_ns = clock_anchor()

    def stop(self) -> None:
        self._sync()
        window_s = time.perf_counter() - self.t_start
        self.prof.__exit__(None, None, None)
        events = self.prof.events()
        results = getattr(self.prof.profiler, "kineto_results", None)
        self.summary = summarize(events, window_s)
        self.split = split(
            events, window_s, anchor_ns=self.anchor_ns, start_s=self.t_start,
            trace_start_ns=(results.trace_start_ns()
                            if results is not None else None))
        self.prof = None


def traced_window(cell, seed: int, seconds: float, device):
    """The cell's program built, warmed and driven for ``seconds`` as
    ``benchmark.run`` drives it, its last ``trace_seconds`` traced.
    Returns ``serve.drive``'s outcome, the requests of an open loop with the
    program's stamps, and the idle split."""
    from benchmark import serve
    from benchmark.run import make_engine
    from benchmark.traffic import make_requests

    wl = cell.workload
    engine = StampedEngine(make_engine(cell, seed, device))
    tracer = SpanTracer(device)
    tracer.warm()
    requests = make_requests(wl, seed, seconds,
                             int(cell.config["port"]["vocab_size"]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    outcome = serve.drive(engine, requests, wl, seconds, tracer,
                          float(wl.get("trace_seconds", 2.0)))
    engine.release_programs()
    stamped = [Request(r.due, r.first, **engine.stamps.get(rid, {}))
               for rid, r in outcome.records.items()] \
        if outcome.open_loop else []
    return outcome, stamped, tracer.split


def reading(cell, seed: int, seconds: float, device) -> dict:
    """What :func:`traced_window` gives, reduced to the line's numbers."""
    outcome, requests, sp = traced_window(cell, seed, seconds, device)
    out = {
        "workload": cell.name,
        "seed": seed,
        "window_s": sp["window_s"],
        "busy_s": sp["busy_s"],
        "idle_s": sp["window_s"] - sp["busy_s"],
        "idle_by_span_s": sum(sp["idle_by_span"].values()),
        "idle_admit_share": idle_under_share(sp, "serve.admit"),
        "idle_decode_share": idle_under_share(sp, "serve.decode"),
        "idle_outside_serve_share": idle_outside_serve_share(sp),
        "trace_tokens_per_s": (outcome.trace_counters["tokens"]
                               / sp["window_s"]
                               if outcome.trace_counters else None),
    }
    if outcome.open_loop:
        out["queue_wait_p50_ms"] = queue_wait_p50_ms(requests)
        out["prefill_p50_ms"] = prefill_p50_ms(requests)
        out["idle_queued_share"] = idle_queued_share(sp, requests)
    out["clock_offset_ns"] = sp["clock_offset_ns"]
    out["device_lead_us"] = sp["device_lead_us"]
    out["idle_by_span"] = sp["idle_by_span"]
    return out


def main(argv=None, *, root=None, device: str | None = None) -> int:
    """``device`` None: the card, which must be there; the tests pass
    ``"cpu"``."""
    from benchmark.run import cache_dirs
    from benchmark.spec import ROOT, load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = ROOT if root is None else root
    cache_dirs(root)
    cell = load_cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            print("benchmark.spans: no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    print(json.dumps(reading(cell, args.seed, args.seconds,
                             torch.device(device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
