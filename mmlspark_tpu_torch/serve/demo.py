"""Synthetic-traffic serving demo — the port of
``mmlspark_tpu/serve/demo.py``: a single engine, a ``ReplicaSet``, a
``DisaggFleet`` or a ``MultiModelEngine`` over random-init models, with
the dense, paged (+ prefix cache) and int8 KV pools, weight-only int8,
chunked prefill, the async host loop, seeded fault injection and SLOs.

A deterministic staggered arrival schedule (a few submits a tick, prompt
lengths from a seeded rng) drives the target; the demo returns the
engine's metrics dict (or, with ``replicas > 1``, ``disagg`` or
``models``, the control plane's ``metrics_dict``) under the JAX demo's
key names. With ``telemetry_dir`` a single engine's bundle lands there:
its flight recorder in ``events.jsonl``, the metrics in
``metrics.json``, the Perfetto-loadable trace in ``trace.json`` and the
Prometheus exposition in ``metrics.prom``. A multi-engine run
(``--replicas``/``--disagg``/``--models``) writes the MERGED
:class:`~mmlspark_tpu_torch.core.tracehub.TelemetryHub` bundle instead:
one wall-clock-ordered ``events.jsonl`` across every replica's recorder,
one flow-arrow-stitched ``trace.json`` and one labeled exposition — plus
``supervisor.events.jsonl``, the control plane's own timeline, for the
replica planes. ``metrics_port`` serves the same hub live on 127.0.0.1
while the demo runs. ``mesh`` (``"data=2,model=2"``) serves through the
engine's mesh mode — every engine of the run (a replica set's and a
fleet's too) on that mesh; call it on every rank of an initialised
process group, with the same arguments: rank 0 writes the telemetry and
serves the endpoint. ``stream_digest`` (a port-only key) is the SHA-256
of every completed request's token stream in request order: the handle
that holds one run's streams to another's across devices and meshes.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError


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
    ``"max_decode=4,queue_high=2"``-style policy); ``models`` a
    ``--models`` spec (``serve/multimodel.py``) for a
    :class:`~mmlspark_tpu_torch.serve.multimodel.MultiModelEngine` under
    ``device_budget``; ``telemetry_dir`` and ``trace_out`` the telemetry
    files, ``metrics_port`` the live ``/metrics`` endpoint (0: an
    ephemeral port)."""
    from mmlspark_tpu_torch.core.faults import parse_fault_spec
    from mmlspark_tpu_torch.core.perf import export_chrome_trace
    from mmlspark_tpu_torch.core.telemetry import (
        atomic_write_json,
        atomic_write_text,
    )
    from mmlspark_tpu_torch.core.tracehub import MetricsServer, TelemetryHub
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.serve.engine import ServeEngine

    dev = default_device(device)
    lead = _is_lead(mesh)
    injector = parse_fault_spec(faults) if faults else None
    if models and mesh is not None:
        raise FriendlyError(
            f"mesh={mesh!r} with models: the multi-model engine serves on "
            "one device; the mesh serves a single engine, --replicas and "
            "--disagg"
        )
    if models:
        return _run_multimodel_demo(
            models, n_requests=n_requests, max_new_tokens=max_new_tokens,
            arrivals_per_tick=arrivals_per_tick, seed=seed,
            device_budget=device_budget, injector=injector,
            telemetry_dir=telemetry_dir, trace_out=trace_out,
            prefill_chunk=prefill_chunk, async_host=async_host,
            metrics_port=metrics_port, device=dev,
        )
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
        async_host=async_host, device=dev, mesh=mesh,
        **({} if decode_block is None else {"decode_block": decode_block}),
    )
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
    multi = disagg or replicas > 1
    # multi-engine modes get a TelemetryHub, the merge point that stitches
    # every replica's recorder and registry into ONE bundle and backs the
    # live endpoint; a single engine builds one only for the endpoint,
    # its on-disk bundle staying the single-recorder format
    hub = None
    if multi or metrics_port is not None:
        hub = TelemetryHub()
        if disagg:
            hub.attach_fleet(target)
        elif replicas > 1:
            hub.attach_replicaset(target)
        else:
            hub.attach_engine(target)
    server = MetricsServer(hub, port=metrics_port) \
        if metrics_port is not None and lead else None

    rng = np.random.default_rng(seed)
    lo, hi = 4, max(5, min(16, cache_len - max_new_tokens))
    lengths = rng.integers(lo, hi + 1, size=n_requests)
    prompts = [rng.integers(0, vocab, size=int(p)) for p in lengths]

    results = {}
    try:
        submitted = 0
        while submitted < n_requests or target.busy:
            for _ in range(arrivals_per_tick):
                if submitted < n_requests:
                    target.submit(prompts[submitted], max_new_tokens,
                                  deadline_ticks=deadline_ticks)
                    submitted += 1
            results.update((res.id, res) for res in target.step())
    finally:
        if server is not None:
            server.close()

    if multi:
        out = target.metrics_dict()
    else:
        out = target.metrics.to_dict()
        out.update(
            decode_compiles=target.decode_compile_count,
            prefill_compiles=target.prefill_compile_count,
            prefill_bucket_count=target.num_prefill_buckets,
        )
    out.update(
        n_requests=n_requests,
        arrivals_per_tick=arrivals_per_tick,
        max_new_tokens=max_new_tokens,
        cache_len=cache_len,
        model_config={"vocab": vocab, "d_model": d_model, "heads": heads,
                      "depth": depth},
        device=str(dev),
        stream_digest=stream_digest(results),
    )
    if server is not None:
        out["metrics_port"] = server.port
    recorder = target.recorder
    if telemetry_dir and lead:
        os.makedirs(telemetry_dir, exist_ok=True)
        if multi:
            # the MERGED bundle: every replica's events and metrics plus
            # the control plane's; the control plane's own timeline
            # stays beside it as supervisor.events.jsonl
            hub.write_bundle(telemetry_dir, metrics=out)
            recorder.dump(
                os.path.join(telemetry_dir, "supervisor.events.jsonl"))
        else:
            recorder.dump(os.path.join(telemetry_dir, "events.jsonl"))
            atomic_write_json(os.path.join(telemetry_dir, "metrics.json"),
                              out, indent=1, default=str)
            export_chrome_trace(
                recorder, path=os.path.join(telemetry_dir, "trace.json"),
                extra_meta={"model": graph.name})
            atomic_write_text(os.path.join(telemetry_dir, "metrics.prom"),
                              target.metrics.registry.to_prometheus())
    if trace_out and lead:
        if multi:
            hub.export_trace(path=trace_out,
                             extra_meta={"model": graph.name})
        else:
            export_chrome_trace(recorder, path=trace_out,
                                extra_meta={"model": graph.name})
    return out


def stream_digest(results: dict) -> str:
    """SHA-256 of every completed request's token stream (prompt and
    generated), in request-id order."""
    h = hashlib.sha256()
    for rid in sorted(results):
        res = results[rid]
        if res.status == "completed":
            h.update(np.asarray(res.tokens, np.int64).tobytes())
            h.update(b"|")
    return h.hexdigest()


def _is_lead(mesh) -> bool:
    """Whether this process writes a run's files: always without a mesh,
    else rank 0 of the process group."""
    if mesh is None:
        return True
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _run_multimodel_demo(spec: str, *, n_requests: int,
                         max_new_tokens: int, arrivals_per_tick: int,
                         seed: int, device_budget: int | None,
                         injector, telemetry_dir: str | None,
                         trace_out: str | None,
                         prefill_chunk: int | None, async_host: bool,
                         metrics_port: int | None, device) -> dict:
    """The ``--models`` body: spec -> MultiModelEngine, then a
    deterministic interleaved arrival schedule — ``n_requests`` per
    deployment, token prompts for LM deployments and float feature
    examples for batch deployments, round-robin across the models so
    every queue stays contended. Returns the engine's ``metrics_dict``;
    the telemetry files are the hub's merged bundle, per-deployment
    ``{model="name"}`` labels in place of ``model{name}.`` prefixes."""
    from mmlspark_tpu_torch.core.tracehub import MetricsServer, TelemetryHub
    from mmlspark_tpu_torch.serve.engine import ServeEngine
    from mmlspark_tpu_torch.serve.multimodel import engine_from_spec

    lm_kwargs = {}
    if prefill_chunk is not None:
        lm_kwargs["prefill_chunk"] = prefill_chunk
    if async_host:
        lm_kwargs["async_host"] = True
    engine = engine_from_spec(
        spec, device_budget=device_budget, faults=injector, seed=seed,
        lm_kwargs=lm_kwargs, device=device,
    )
    rng = np.random.default_rng(seed)
    streams: dict[str, list] = {}
    for name in engine.models:
        dep = engine.deployment(name)
        reqs = []
        for _ in range(n_requests):
            if isinstance(dep, ServeEngine):
                vocab = int(dep.graph.extra.get("vocab_size", 16))
                hi = max(5, min(16, dep.cache_len - max_new_tokens))
                plen = int(rng.integers(4, hi + 1))
                reqs.append((rng.integers(0, vocab, size=plen),
                             max_new_tokens))
            else:
                shape = tuple(dep.graph.input_shape)
                reqs.append(
                    (rng.normal(size=shape).astype(np.float32), None)
                )
        streams[name] = reqs
    arrivals = [
        (name, *streams[name][i])
        for i in range(n_requests) for name in engine.models
    ]
    hub = TelemetryHub()
    hub.attach_multimodel(engine)
    server = MetricsServer(hub, port=metrics_port) \
        if metrics_port is not None else None
    try:
        submitted = 0
        while submitted < len(arrivals) or engine.busy:
            for _ in range(arrivals_per_tick):
                if submitted < len(arrivals):
                    name, x, budget = arrivals[submitted]
                    if budget is None:
                        engine.submit(x, model=name)
                    else:
                        engine.submit(x, model=name,
                                      max_new_tokens=budget)
                    submitted += 1
            engine.step()
    finally:
        if server is not None:
            server.close()
    out = engine.metrics_dict()
    out.update(
        n_requests=n_requests,
        arrivals_per_tick=arrivals_per_tick,
        max_new_tokens=max_new_tokens,
        models_spec=spec,
        device=str(device),
    )
    if server is not None:
        out["metrics_port"] = server.port
    if telemetry_dir:
        hub.write_bundle(telemetry_dir, metrics=out)
    if trace_out:
        hub.export_trace(path=trace_out,
                         extra_meta={"model": "multimodel"})
    return out
