"""Synthetic-traffic serving demo — the port of
``mmlspark_tpu/serve/demo.py``: a single engine, a ``ReplicaSet`` or a
``DisaggFleet`` over a random-init ``transformer_lm``, with the dense,
paged (+ prefix cache) and int8 KV pools, weight-only int8, chunked
prefill, the async host loop, seeded fault injection and SLOs.

A deterministic staggered arrival schedule (a few submits a tick, prompt
lengths from a seeded rng) drives the target; the demo returns the
engine's metrics dict (or, with ``replicas > 1`` or ``disagg``, the
supervisor's ``metrics_dict``) under the JAX demo's key names. With
``telemetry_dir`` a single engine's bundle lands there: its flight
recorder in ``events.jsonl``, the metrics in ``metrics.json``, the
Perfetto-loadable trace in ``trace.json`` and the Prometheus exposition
in ``metrics.prom``; a multi-engine run writes the control plane's
timeline (``supervisor.events.jsonl``), ``metrics.json`` and its
registry's ``metrics.prom`` — the merged multi-engine bundle of the JAX
demo waits for the telemetry hub (ROADMAP.md Queue 1 item 19), as do
``models``, ``device_budget`` and ``metrics_port``; ``mesh`` waits for
item 13.
"""

from __future__ import annotations

import os

import numpy as np

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError

#: demo flags of the JAX package that wait for a later slice
_NOT_PORTED = {
    "mesh": "meshes (ROADMAP.md Queue 1 item 13)",
    "models": "multi-model serving (ROADMAP.md Queue 1 item 19)",
    "device_budget": "multi-model serving (ROADMAP.md Queue 1 item 19)",
    "metrics_port": "the live metrics endpoint (ROADMAP.md Queue 1 item 19)",
}


def run_demo(*, slots: int = 4, n_requests: int = 8,
             max_new_tokens: int = 8, arrivals_per_tick: int = 2,
             vocab: int = 64, d_model: int = 32, heads: int = 2,
             depth: int = 2, cache_len: int = 64, seed: int = 0,
             deadline_ticks: int | None = None,
             decode_block: int | None = None, mesh: str | None = None,
             telemetry_dir: str | None = None, faults: str | None = None,
             slo: str | None = None, trace_out: str | None = None,
             paged: bool = False, page_size: int | None = None,
             prefix_cache: bool = False, replicas: int = 1,
             hedge_ms: float | None = None, kv_dtype: str = "bf16",
             quantize_weights: bool = False, disagg: bool = False,
             prefill_replicas: int = 1, decode_replicas: int = 1,
             autoscale: str | None = None, models: str | None = None,
             device_budget: int | None = None,
             prefill_chunk: int | None = None, async_host: bool = False,
             metrics_port: int | None = None, device=None) -> dict:
    """Run the synthetic-traffic loop on ``device`` (``cuda`` unless the
    caller asks for ``"cpu"``); returns the metrics dict. The flags are
    the JAX demo's: ``paged``/``page_size``/``prefix_cache`` the paged
    pool, ``kv_dtype="int8"`` the int8 KV mode, ``quantize_weights`` the
    weight-only int8 engine, ``prefill_chunk``/``async_host`` chunked
    prefill and the pipelined loop, ``faults`` a
    ``"seed=7,transient=0.05,oom=0.02"``-style spec (no retry backoff),
    ``slo`` a ``"ttft_p99_ms=50,error_rate=0.05"``-style spec,
    ``deadline_ticks`` each request's deadline; ``replicas > 1`` (with
    ``hedge_ms``) a :class:`~mmlspark_tpu_torch.serve.supervisor.ReplicaSet`,
    ``disagg`` a :class:`~mmlspark_tpu_torch.serve.fleet.DisaggFleet` of
    ``prefill_replicas`` + ``decode_replicas`` (``autoscale`` a
    ``"max_decode=4,queue_high=2"``-style policy); ``telemetry_dir`` and
    ``trace_out`` the telemetry files."""
    from mmlspark_tpu_torch.core.faults import parse_fault_spec
    from mmlspark_tpu_torch.core.perf import export_chrome_trace
    from mmlspark_tpu_torch.core.telemetry import (
        atomic_write_json,
        atomic_write_text,
    )
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.serve.engine import ServeEngine

    asked = {"mesh": mesh, "models": models, "device_budget": device_budget,
             "metrics_port": metrics_port}
    for name, value in asked.items():
        if value is not None:
            raise FriendlyError(f"{name}={value!r}: {_NOT_PORTED[name]} is "
                                "not ported yet")
    dev = default_device(device)
    graph = build_model(
        "transformer_lm", vocab_size=vocab, d_model=d_model, heads=heads,
        depth=depth, max_len=cache_len, attn_impl="dense",
    )
    variables = init_variables(graph, seed, device=dev)
    engine_kwargs = dict(
        slots=slots, cache_len=cache_len, max_queue=max(n_requests, 1),
        slo=slo or None, retry_backoff_s=0.0, paged=paged,
        page_size=page_size, prefix_cache=prefix_cache, kv_dtype=kv_dtype,
        quantize_weights=quantize_weights, prefill_chunk=prefill_chunk,
        async_host=async_host, device=dev,
        **({} if decode_block is None else {"decode_block": decode_block}),
    )
    injector = parse_fault_spec(faults) if faults else None
    if disagg:
        from mmlspark_tpu_torch.serve.fleet import DisaggFleet

        target = DisaggFleet(
            graph, variables, prefill_replicas=prefill_replicas,
            decode_replicas=decode_replicas, autoscale=autoscale or None,
            faults=injector, **engine_kwargs,
        )
    elif replicas > 1:
        from mmlspark_tpu_torch.serve.supervisor import ReplicaSet

        target = ReplicaSet(graph, variables, replicas=replicas,
                            hedge_ms=hedge_ms, faults=injector,
                            **engine_kwargs)
    else:
        target = ServeEngine(graph, variables, faults=injector,
                             **engine_kwargs)
    rng = np.random.default_rng(seed)
    lo, hi = 4, max(5, min(16, cache_len - max_new_tokens))
    lengths = rng.integers(lo, hi + 1, size=n_requests)
    prompts = [rng.integers(0, vocab, size=int(p)) for p in lengths]

    submitted = 0
    while submitted < n_requests or target.busy:
        for _ in range(arrivals_per_tick):
            if submitted < n_requests:
                target.submit(prompts[submitted], max_new_tokens,
                              deadline_ticks=deadline_ticks)
                submitted += 1
        target.step()

    multi = disagg or replicas > 1
    if multi:
        out = target.metrics_dict()
        registry = target.registry
    else:
        out = target.metrics.to_dict()
        out.update(
            decode_compiles=target.decode_compile_count,
            prefill_compiles=target.prefill_compile_count,
            prefill_bucket_count=target.num_prefill_buckets,
        )
        registry = target.metrics.registry
    out.update(
        n_requests=n_requests,
        arrivals_per_tick=arrivals_per_tick,
        max_new_tokens=max_new_tokens,
        cache_len=cache_len,
        model_config={"vocab": vocab, "d_model": d_model, "heads": heads,
                      "depth": depth},
        device=str(dev),
    )
    recorder = target.recorder
    if telemetry_dir:
        os.makedirs(telemetry_dir, exist_ok=True)
        recorder.dump(os.path.join(
            telemetry_dir,
            "supervisor.events.jsonl" if multi else "events.jsonl"))
        atomic_write_json(os.path.join(telemetry_dir, "metrics.json"), out,
                          indent=1, default=str)
        atomic_write_text(os.path.join(telemetry_dir, "metrics.prom"),
                          registry.to_prometheus())
        if not multi:
            export_chrome_trace(
                recorder, path=os.path.join(telemetry_dir, "trace.json"),
                extra_meta={"model": graph.name})
    if trace_out:
        export_chrome_trace(recorder, path=trace_out,
                            extra_meta={"model": graph.name})
    return out
