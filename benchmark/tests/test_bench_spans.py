"""The idle time split by span, the clock that maps the program's stamps
onto the trace, the readings of the program's spans and stamps on
hand-built inputs with known answers, and a seeded run of the tiny open
cell: each request's stamps split its TTFT, and the harness's own
reduction of the trace is what it was."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans
from benchmark.spans import ANCHOR, Request, split
from benchmark.spec import load_cell
from benchmark.trace import summarize

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU

def ev(name, a, b, dev=CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


#: perf_counter ns at the anchor's start, and the trace's start (epoch ns)
STAMP, TRACE0 = 5_000_000_000, 1_700_000_000_000_000_000


def timeline():
    """Two steps of 100 us under the harness, the second with nested
    decode leaves; the anchor at 0 us and the window from 0 to 200 us."""
    return [
        ev(ANCHOR, 0, 1, CPU),
        ev("bench.step", 0, 100, CPU),
        ev("serve.account", 0, 5, CPU),
        ev("serve.admit", 5, 50, CPU),
        ev("serve.prefill", 10, 40, CPU),
        ev("serve.decode", 50, 95, CPU),
        ev("serve.decode.launch", 50, 60, CPU),
        ev("serve.decode.fetch", 60, 90, CPU),
        ev("bench.submit", 100, 110, CPU),
        ev("bench.step", 110, 200, CPU),
        ev("serve.decode", 110, 200, CPU),
        ev("serve.decode.consume", 150, 200, CPU),
        ev("gemm", 0, 10),
        ev("gemm", 20, 30),
        ev("decode_partial_kernel", 55, 70),
        ev("gemm", 120, 160),
    ]


def test_idle_split_by_span_sums_to_the_idle_time():
    s = split(timeline(), 200e-6, anchor_ns=STAMP, start_s=STAMP * 1e-9,
              trace_start_ns=TRACE0)
    # busy: [0,10] + [20,30] + [55,70] + [120,160] = 75 us of 200
    assert s["busy_s"] == pytest.approx(75e-6)
    by = s["idle_by_span"]
    assert sum(by.values()) == pytest.approx(s["window_s"] - s["busy_s"],
                                             abs=1e-9)
    us = {k: round(v * 1e6, 6) for k, v in by.items()}
    # idle: [10,20] + [30,55] + [70,120] + [160,200] = 125 us
    assert us == {
        "serve.prefill": 20.0,  # [10,20] + [30,40]
        "serve.admit": 10.0,  # [40,50]
        "serve.decode.launch": 5.0,  # [50,55]
        "serve.decode.fetch": 20.0,  # [70,90]
        "serve.decode": 15.0,  # [90,95] + [110,120]
        "serve.decode.consume": 40.0,  # [160,200]
        "bench.step": 5.0,  # [95,100]
        "bench.submit": 10.0,  # [100,110]
        "serve.account": 0.0,  # [0,5] is busy
        "none": 0.0,
    }
    under = {k: round(v * 1e6, 6) for k, v in s["idle_under"].items()}
    assert under["serve.admit"] == 30.0
    assert under["serve.decode"] == 80.0
    assert under["bench.step"] == 115.0
    # the anchor's start is the stamp: the window starts there
    assert s["clock_offset_ns"] == TRACE0 - STAMP
    first = s["idle_intervals"][0]
    assert first == pytest.approx([STAMP * 1e-9 + 10e-6,
                                   STAMP * 1e-9 + 20e-6])


def test_without_the_anchor():
    events = [e for e in timeline() if e.name != ANCHOR]
    plain = split(events, 200e-6)
    # the harness's reduction neither sees nor counts the anchor
    assert summarize(events, 200e-6) == summarize(timeline(), 200e-6)
    assert plain["busy_s"] == pytest.approx(75e-6)
    # no anchor: the harness spans' extent is the window, no clock
    assert plain["clock_offset_ns"] is None
    assert plain["idle_intervals"] is None
    assert sum(plain["idle_by_span"].values()) == pytest.approx(125e-6)


def test_card_clock_lead_is_taken_off_before_the_split():
    """Card timestamps 5 ms ahead of the host's: each operation's launch
    call (host) and its first operation (card) give the lead, and the
    idle time is split on the host's clock."""
    def with_id(e, cid):
        e.id = cid
        return e

    lead = 5000.0
    events = [
        ev(ANCHOR, 0, 1, CPU),
        ev("bench.step", 0, 1000, CPU),
        ev("serve.decode.launch", 100, 200, CPU),
        with_id(ev("cudaGraphLaunch", 150, 160, CPU), 7),
        ev("serve.decode.consume", 400, 600, CPU),
        with_id(ev("cudaLaunchKernel", 600, 605, CPU), 8),
        with_id(ev("gemm", 150 + lead, 390 + lead), 7),
        with_id(ev("gemm", 600 + lead, 690 + lead), 8),
    ]
    s = split(events, 1000e-6, anchor_ns=STAMP, start_s=STAMP * 1e-9,
              trace_start_ns=TRACE0)
    assert s["device_lead_us"] == [lead, lead]
    us = {k: round(v * 1e6, 6) for k, v in s["idle_by_span"].items()}
    # idle on the host's clock: [0,150] + [390,600] + [690,1000]
    assert us == {"bench.step": 420.0, "serve.decode.consume": 200.0,
                  "serve.decode.launch": 50.0, "none": 0.0}
    # the busy time is the card's own, uncorrected
    assert s["busy_s"] == pytest.approx(330e-6)


def test_card_clock_lead_follows_a_drift_past_a_queued_stretch():
    """A lead that grows 4 us every ms of host time, read from one launch
    every 50 ms; one stretch's launch queued 20 ms behind other work
    does not move it."""
    events, cid = [], 0
    for k in range(9):
        host = 50_000.0 * k + 1000.0
        queued = 20_000.0 if k == 4 else 0.0
        dev = host + 0.004 * host + queued
        cid += 1
        events.append(ev("cudaLaunchKernel", host, host + 5, CPU))
        events[-1].id = cid
        events.append(ev("gemm", dev, dev + 10))
        events[-1].id = cid
    events += [ev(ANCHOR, 0, 1, CPU), ev("bench.step", 0, 410_000, CPU)]
    s = split(events, 0.41, anchor_ns=STAMP, start_s=STAMP * 1e-9)
    lead0, lead1 = s["device_lead_us"]
    assert lead0 == pytest.approx(0.004 * 1000.0, abs=1e-6)
    assert lead1 == pytest.approx(0.004 * 401_000.0, abs=1e-6)


def req(due, admitted, first_token, first):
    return Request(due, first, due, admitted, first_token)


def test_readings_known_answers():
    sp = {"busy_s": 0.6, "window_s": 1.0,
          "idle_under": {"serve.admit": 0.1, "serve.decode": 0.25},
          "idle_by_span": {"serve.prefill": 0.05, "serve.admit": 0.05,
                           "serve.decode.fetch": 0.25, "bench.submit": 0.03,
                           "bench.step": 0.02, "none": 0.0},
          "idle_intervals": [[0.0, 0.1], [0.5, 0.7], [0.9, 1.0]]}
    reqs = [req(0.0, 0.05, 0.30, 0.31),  # queued [0, 0.05)
            req(0.55, 0.65, 0.80, 0.82),  # [0.55, 0.65)
            req(0.60, 0.95, 0.97, 0.99)]  # [0.60, 0.95)
    assert spans.idle_under_share(sp, "serve.admit") == pytest.approx(10.0)
    assert spans.idle_under_share(sp, "serve.decode") == pytest.approx(25.0)
    assert spans.idle_outside_serve_share(sp) == pytest.approx(5.0)
    # waits 50, 100, 350 ms; own prefills 250, 150, 20 ms
    assert spans.queue_wait_p50_ms(reqs) == pytest.approx(100)
    assert spans.prefill_p50_ms(reqs) == pytest.approx(150)
    # queued [0, 0.05) + [0.55, 0.95) against the idle intervals:
    # 0.05 + [0.55, 0.7) 0.15 + [0.9, 0.95) 0.05 = 0.25 of 1 s
    assert spans.idle_queued_share(sp, reqs) == pytest.approx(25.0)
    # a request never admitted waits for the rest of the window, and
    # counts as the longest wait
    reqs.append(req(0.2, None, None, 0.99))
    assert spans.idle_queued_share(sp, reqs) == \
        pytest.approx(100.0 * (0.05 + 0.2 + 0.1))
    assert spans.queue_wait_p50_ms(reqs) == pytest.approx(100)
    assert spans.prefill_p50_ms(reqs) == pytest.approx(150)


def test_readings_find_nothing_without_spans_or_stamps():
    """A program without the stamps or the anchor (or a trace with no
    device operation) gives nothing to read."""
    bare = [req(0.0, None, None, 0.3)]
    empty = {"busy_s": 0.0, "window_s": 1.0, "idle_under": {},
             "idle_by_span": {"none": 1.0}, "idle_intervals": None}
    unmapped = dict(empty, busy_s=0.5, idle_by_span={"none": 0.5})
    for sp in (empty, unmapped):
        assert spans.idle_under_share(sp, "serve.admit") is None
        assert spans.idle_queued_share(sp, bare) is None
    assert spans.idle_outside_serve_share(empty) is None
    assert spans.queue_wait_p50_ms(bare) is None
    assert spans.prefill_p50_ms(bare) is None


def test_tiny_open_stamps_split_ttft(tiny_root, capsys):
    """A seeded CPU run of the tiny open cell: every request's wait for
    admission, its own prefill and the rest of its step add up to its
    TTFT, and the run's line holds the readings."""
    # the whole window traced: a trace of its end alone may start after
    # a busy CPU's last step
    path = tiny_root / "benchmark" / "workloads" / "tiny.open.json"
    wl = json.loads(path.read_text())
    wl["trace_seconds"] = 3.0
    path.write_text(json.dumps(wl))
    cell = load_cell("tiny.open", tiny_root)
    seed = 2 ** 31 + 91
    outcome, reqs, sp = spans.traced_window(cell, seed, 3.0,
                                            torch.device("cpu"))
    assert len(reqs) > 10
    for r in reqs:
        assert r.due <= r.submitted_at <= r.admitted_at <= \
            r.first_token_at <= r.first
        parts = ((r.admitted_at - r.due) + (r.first_token_at - r.admitted_at)
                 + (r.first - r.first_token_at))
        assert parts == pytest.approx(r.first - r.due, abs=1e-9)
    # the harness's own reduction keeps its keys
    assert set(outcome.trace) == {"busy_s", "window_s", "per_kernel_s",
                                  "device_ops", "idle_gaps"}
    by = sp["idle_by_span"]
    assert "serve.admit" in by and "serve.decode.fetch" in by
    assert sum(by.values()) == pytest.approx(sp["window_s"] - sp["busy_s"],
                                             rel=1e-6)
    assert sp["clock_offset_ns"] is not None
    rc = spans.main(["--workload", "tiny.open", "--seed", str(seed),
                     "--seconds", "2"], root=tiny_root, device="cpu")
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["queue_wait_p50_ms"] > 0 and line["prefill_p50_ms"] > 0
    assert "serve.decode.fetch" in line["idle_by_span"]
