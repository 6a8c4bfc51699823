"""Find an open-loop cell's knee: the highest offered rate at which 90% of
the requests meet both of the cell's limits with no growing backlog.

    python3 -m benchmark.sweep --workload <cell> --seed <n> \\
        --seconds <s> --rates 2,3,4,5

One process builds and warms the program once, then offers each rate in
turn for ``--seconds`` (the cell's own traffic with its rate replaced),
drains, and prints one JSON line a rate: the share of requests that met
both limits, the TTFT and time-per-output-token percentiles, the median
TTFT of the window's first and last thirds (a backlog that grows shows
as a last third far slower than the first), and the most requests that
held a slot at once (from the first token to the last), which the
cell's ``slots`` has to cover. The benchmark's runs
never call it; the rate it finds is written into the workload file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from benchmark.run import PROCESS_START, cache_dirs, make_engine, percentile
from benchmark.spec import ROOT, load_cell


def live_max(recs) -> int:
    """The most requests between their first token and their last at any
    one time."""
    edges = sorted([(r.first, 1) for r in recs if r.finish is not None]
                   + [(r.finish, -1) for r in recs if r.finish is not None],
                   key=lambda e: (e[0], e[1]))
    live = most = 0
    for _, d in edges:
        live += d
        most = max(most, live)
    return most


def summarize(outcome, limits: dict, seconds: float, bucket) -> dict:
    recs = list(outcome.records.values())
    t0 = outcome.t0
    ttft = [((r.first or float("inf")) - r.due) * 1e3 for r in recs]
    tpot = [(r.finish - r.first) / (len(r.served) - 1) * 1e3
            if r.finish is not None and len(r.served) > 1 else 0.0
            for r in recs]
    met = sum(a <= limits["ttft_ms"] and b <= limits["tpot_ms"]
              for a, b in zip(ttft, tpot))
    thirds = [[a for r, a in zip(recs, ttft)
               if k * seconds / 3 <= r.due - t0 < (k + 1) * seconds / 3]
              for k in range(3)]
    return {
        "requests": len(recs),
        "met_share": met / max(1, len(recs)),
        "ttft_p95_ms": percentile(ttft, 95) if ttft else None,
        "tpot_p95_ms": percentile(tpot, 95) if tpot else None,
        "ttft_p50_first_third_ms": statistics.median(thirds[0])
        if thirds[0] else None,
        "ttft_p50_last_third_ms": statistics.median(thirds[2])
        if thirds[2] else None,
        "unfinished": sum(r.finish is None for r in recs),
        "live_max": live_max(recs),
        # each prefill bucket's TTFTs: what a prompt of that size waits
        "ttft_ms_by_bucket": {
            b: sorted(round(a, 1) for r, a in zip(recs, ttft)
                      if bucket(len(r.prompt)) == b)
            for b in sorted({bucket(len(r.prompt)) for r in recs})},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    cell = load_cell(args.workload)
    import torch

    from benchmark import serve
    from benchmark.traffic import make_requests

    wl = cell.workload
    vocab = int(cell.config["port"]["vocab_size"])
    engine = make_engine(cell, args.seed, torch.device("cuda"))
    print(json.dumps({"setup_s": time.perf_counter() - PROCESS_START}),
          flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        at = dict(wl, arrivals=dict(wl["arrivals"], rate=rate))
        requests = make_requests(at, args.seed, args.seconds, vocab)
        outcome = serve.drive(engine, requests, at, args.seconds, None, 0.0)
        print(json.dumps(dict(rate=rate, **summarize(
            outcome, wl["limits"], args.seconds, engine.prefill_bucket))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
