"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the checkout's root. One process: load the cell's files, make the
weights and the traffic from the seed, build and warm the program, serve
for ``--seconds``, read the peak memory, free the program, check its
answers against the plain reference, and print one JSON object as the
last line of standard output. ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` its per-layer ones, from a profiler
trace of the window's last ``trace_seconds`` and the program's counters
over the window. The numbers compared, each with its limit, come last on
standard error and last in the line.

Exits 2 without a result when the card (or enough cards) is missing,
and 3 when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmark.spec import ROOT, load_cell, reader  # noqa: E402

#: top-level modules that must not be loaded: JAX, its libraries and the
#: JAX package (compared by the whole name before the first dot)
FORBIDDEN = ("jax", "jaxlib", "flax", "mmlspark_tpu")

#: ``transformer_lm`` arguments a configuration's ``port`` entry gives
MODEL_KEYS = ("vocab_size", "d_model", "heads", "depth", "d_ff", "max_len",
              "kv_heads")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = Path(root) / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def end_to_end(outcome, setup_s: float) -> dict:
    """The end-to-end numbers of a serving run, by metric name: an open
    loop's latencies beside the rate and the set-up. Only the cell's
    declared metrics go into the result line; the rest are readings on
    standard error."""
    window = outcome.t_close - outcome.t0
    out = {"setup_s": setup_s, "serve_tokens_per_s": outcome.tokens / window}
    if not outcome.open_loop:
        return out
    recs = list(outcome.records.values())
    ttft = [(r.first - r.due) * 1e3 for r in recs if r.first is not None]
    # a request with no first token counts as the longest wait
    ttft += [max(ttft, default=0.0)] * sum(r.first is None for r in recs)
    tpot = [(r.finish - r.first) / (len(r.served) - 1) * 1e3
            for r in recs if r.finish is not None and len(r.served) > 1]
    for q in (50, 95):
        if ttft:
            out[f"ttft_p{q}_ms"] = percentile(ttft, q)
        if tpot:
            out[f"tpot_p{q}_ms"] = percentile(tpot, q)
    return out


def check_layout(graph, weights: dict) -> None:
    """The weights made from the configuration fit the program's graph."""
    for name, mod in graph.blocks:
        want = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in weights[name].items()}
        if want != got:
            raise RuntimeError(f"weights of '{name}' do not fit the graph: "
                               f"{sorted(set(want.items()) ^ set(got.items()))}")


def note(what: str) -> None:
    print(f"benchmark: {what} at {time.perf_counter() - PROCESS_START:.3f} s",
          file=sys.stderr, flush=True)


def make_engine(cell, seed: int, device):
    """The program built on the seed's weights and warmed for the cell's
    traffic; the engine holds the only copy of the weights."""
    import numpy as np

    from benchmark import serve
    from benchmark.weights import make_weights
    from mmlspark_tpu_torch.models.transformer import transformer_lm

    wl, port = cell.workload, cell.config["port"]
    graph = transformer_lm(**{k: port.get(k) for k in MODEL_KEYS})
    weights = make_weights(port, seed, device)
    check_layout(graph, weights)
    note("weights made")
    engine = serve.build_engine(graph, weights, wl, device)
    del weights
    note("engine built")
    serve.warm(engine, wl, np.random.default_rng(int(seed) + 7),
               int(port["vocab_size"]))
    note("warmed")
    return engine


def serve_window(cell, seed: int, seconds: float, trace: bool, device):
    """Set-up and the measured window: the program built on the seed's
    weights, warmed, driven for ``seconds``, its peak memory read, and
    then freed. Returns the window's outcome, the peak and the set-up
    seconds."""
    import torch

    from benchmark import serve
    from benchmark.trace import Tracer
    from benchmark.traffic import make_requests

    wl = cell.workload
    vocab = int(cell.config["port"]["vocab_size"])
    engine = make_engine(cell, seed, device)
    tracer = Tracer(device) if trace else None
    if tracer is not None:
        tracer.warm()
    requests = make_requests(wl, seed, seconds, vocab)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - PROCESS_START
    outcome = serve.drive(engine, requests, wl, seconds, tracer,
                          float(wl.get("trace_seconds", 2.0)))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    engine.release_programs()
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    note("window closed and program freed")
    return SimpleNamespace(outcome=outcome, peak=peak, setup_s=setup_s)


def judge(cell, seed: int, outcome, device, control: bool = False) -> dict:
    """The comparison with the plain reference, on weights made again
    from the seed: the numbers compared, each with its limit, and the
    verdict; with ``control``, the float8 control's gaps and its verdict
    by the same limits beside them."""
    from benchmark.check import compared, pick_sample, served_gaps, verdict
    from benchmark.reference.gpt import Gpt
    from benchmark.weights import make_weights

    wl, port = cell.workload, cell.config["port"]
    check = wl["check"]
    finished = [(r.prompt, r.served) for r in outcome.records.values()
                if r.served is not None]
    unfinished = sum(r.finish is None for r in outcome.records.values()) \
        if wl["driver"] == "open" else 0
    sample = pick_sample(finished, seed, int(check["min_tokens"]))
    weights = make_weights(port, seed, device)
    gaps = served_gaps(Gpt(port, weights), sample, device,
                       control=Gpt(port, weights, quant="fp8")
                       if control else None)
    note(f"reference compared {gaps['tokens']} tokens of {len(sample)} "
         "requests")
    out = {"compared": compared(gaps, check, unfinished),
           "correct": verdict(gaps, check, unfinished),
           "unfinished": unfinished, "gaps": gaps}
    if control:
        out["control_correct"] = verdict(gaps["control"], check, unfinished)
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    import torch

    from benchmark.arith import GptShape

    w = serve_window(cell, seed, seconds, trace, device)
    outcome = w.outcome
    verdict = judge(cell, seed, outcome, device)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        ctx = SimpleNamespace(
            shape=GptShape(cell.config["port"]), workload=cell.workload,
            window_s=outcome.t_close - outcome.t0,
            counters=outcome.counters, trace_counters=outcome.trace_counters,
            trace=outcome.trace)
        values = {m["name"]: reader(m["name"], cell.root)(ctx)
                  for m in cell.per_layer}
        if outcome.trace is not None and not outcome.trace["per_kernel_s"]:
            note("the profiler recorded no device operation in the traced "
                 "window; its readers are left out")
    else:
        everything = end_to_end(outcome, w.setup_s)
        note(f"readings {json.dumps(everything)}")
        values = {m["name"]: everything.get(m["name"])
                  for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]}
               for k, v in values.items() if v is not None}
    result = {
        "correct": verdict["correct"],
        "attempted": outcome.submitted,
        "failed": verdict["unfinished"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": int(w.peak),
        },
    }
    if trace and outcome.trace is not None:
        result["device"]["busy_s"] = outcome.trace["busy_s"]
        result["device"]["window_s"] = outcome.trace["window_s"]
        result["breakdown"] = {"device_ops": outcome.trace["device_ops"],
                               "idle_gaps": outcome.trace["idle_gaps"]}
    result["compared"] = verdict["compared"]
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: Path = ROOT, device: str | None = None) -> int:
    """``device`` None: the card, which must be there; the tests pass
    ``"cpu"`` to drive the rest of a run on the CPU."""
    args = parse(argv)
    cache_dirs(root)
    cell = load_cell(args.workload, root)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device(device))
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
