"""Multi-model serving: one engine, many graphs — the port of
``mmlspark_tpu/serve/multimodel.py``.

The reference's serving surface is batched inference over arbitrary
loaded models (``CNTKModel.transform``, ``ImageFeaturizer`` over
zoo-downloaded graphs). :class:`MultiModelEngine` hosts several NAMED
deployments behind one ``submit(model=...)/step()/run()`` facade:

- **LM deployments** — the port's :class:`~mmlspark_tpu_torch.serve.
  engine.ServeEngine`, unchanged: its program pins (``num_decode_blocks``
  / ``num_prefill_buckets``), one fetch a decode block, token streams
  bit-equal to a dedicated single-model engine on the same weights and
  schedule.
- **Stateless batch deployments** (:class:`BatchDeployment`) — any
  non-causal graph from ``build_model`` (ResNet, BiLSTM, MLP, an imported
  ONNX file) run as power-of-two-BUCKETED batch dispatches, one program
  per bucket: ``k`` queued examples pad to the next power of two (capped
  at ``max_batch``), so the program count is at most
  ``num_batch_buckets`` however traffic arrives, and the padding rows
  are sliced off before results surface (a bucket-size batch pads
  nothing, so its output is bit-equal to a direct ``graph.apply`` on the
  same batch). On the card a program is a CUDA graph captured after the
  bucket's first (eager) call and replayed
  (:class:`~mmlspark_tpu_torch.testing.compile_guard.
  ProgramCountingGraph`); a replay overwrites the program's outputs, so
  each dispatch copies its output to the host — the dispatch's one host
  sync — before any later replay.

Shared planes:

- **Per-model admission and SLOs** — each deployment keeps its own queue,
  :class:`~mmlspark_tpu_torch.core.perf.SloMonitor` and shed signal; one
  model burning its SLO sheds only its own admissions.
- **One device budget** — ``step()`` round-robins at most
  ``device_budget`` deployment dispatches a tick (None = every deployment
  with work), so any deployment with queued work dispatches within
  ``ceil(deployments / device_budget)`` ticks.
- **Telemetry namespaces** — the deployments share ONE
  :class:`~mmlspark_tpu_torch.core.telemetry.MetricRegistry`, each
  writing through a :class:`~mmlspark_tpu_torch.core.telemetry.
  NamespacedRegistry` view under ``model{name}.``.
- **Fault envelope** — the ``serve.batch`` site (``core/faults.py``)
  fires before every batch dispatch: transients retry behind the capped
  backoff, ``oom`` halves the deployment's admission cap down the
  EXISTING bucket ladder (no new program) and recovers after clean
  dispatches, and retry exhaustion quarantines the batch as ``"failed"``.

ONNX ingestion: :meth:`MultiModelEngine.add_onnx` (or ``ox=onnx:path=...``
in the ``--models`` spec) imports a graph with ``models/onnx_import.py``
and serves it as a batch deployment, the imported initializers its
variables. Everything runs on ``device`` (``cuda`` unless the caller asks
for ``"cpu"``); a batch output in bf16 comes back as float32 numpy
holding the same values.
"""

from __future__ import annotations

import dataclasses
import difflib
import time
from collections import deque

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import default_device, host_to_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import (
    EngineKilled,
    FaultInjector,
    is_resource_exhausted,
    is_transient,
)
from mmlspark_tpu_torch.core.perf import SloMonitor, SloTargets, parse_slo_spec
from mmlspark_tpu_torch.core.telemetry import (
    FlightRecorder,
    MetricRegistry,
    NamespacedRegistry,
    RetraceWatchdog,
)
from mmlspark_tpu_torch.models.bridge import variables_to
from mmlspark_tpu_torch.serve.engine import ServeEngine
from mmlspark_tpu_torch.serve.metrics import ServeMetrics
from mmlspark_tpu_torch.testing.compile_guard import (
    ProgramCountingGraph,
    program_count,
)


@dataclasses.dataclass
class BatchResult:
    """Terminal record for one stateless batch request: ``status`` is
    ``"completed"`` (``output`` carries the example's result row) or
    ``"failed"`` (quarantined by fault handling; ``output`` is None).
    ``generated`` is 1 for a completed example — one example in, one
    result out — so the shared metrics plane's tokens/sec reads as
    examples/sec for batch deployments."""

    id: int
    status: str
    output: np.ndarray | None
    submit_tick: int
    finish_tick: int
    wall_s: float
    generated: int = 1


@dataclasses.dataclass
class _BatchReq:
    """One queued example. ``submit_tick``/``submit_wall`` are the fields
    :meth:`ServeMetrics.record_first_token` reads, so batch TTFT rides the
    same histogram as LM TTFT."""

    id: int
    x: np.ndarray
    submit_tick: int
    submit_wall: float


class BatchDeployment:
    """Stateless batched inference over one non-causal graph.

    The batch-size analog of the LM engine's bucketed prefill: each tick
    drains up to ``min(queue, admission cap, max_batch)`` examples, pads
    the stacked batch to the next power of two on the ladder {1, 2, ...,
    max_batch} and runs ONE dispatch — at most :attr:`num_batch_buckets`
    programs ever, pinned by ``RetraceWatchdog`` over
    ``ProgramCountingGraph``. One host sync per dispatch fetches the whole
    output batch.
    """

    kind = "batch"

    def __init__(self, graph, variables, *, max_batch: int = 8,
                 max_queue: int = 64,
                 slo=None,
                 faults: FaultInjector | None = None,
                 retry_limit: int = 2,
                 retry_backoff_s: float = 0.0,
                 degrade_recover_ticks: int = 8,
                 recorder: FlightRecorder | None = None,
                 registry=None,
                 device=None):
        if graph.extra.get("causal", False):
            raise FriendlyError(
                f"'{graph.name}' is a causal LM; serve it as an LM "
                "deployment (MultiModelEngine.add_lm) — batch "
                "deployments run stateless non-causal graphs only"
            )
        if max_batch < 1:
            raise FriendlyError(
                f"max_batch must be >= 1, got {max_batch}"
            )
        if retry_limit < 0:
            raise FriendlyError(
                f"retry_limit must be >= 0, got {retry_limit}"
            )
        self.device = default_device(device)
        self.graph = graph
        self.variables = variables_to(variables, self.device)
        # floor to a power of two: batch buckets live on the ladder
        # {1, 2, 4, ..., max_batch}, so the program count is O(log)
        self.max_batch = 1 << (int(max_batch).bit_length() - 1)
        self.max_queue = max_queue
        self.recorder = (
            recorder if recorder is not None else FlightRecorder()
        )
        self.metrics = ServeMetrics(
            graph.name, self.max_batch, registry=registry,
        )
        self._faults = faults
        self._retry_limit = retry_limit
        self._retry_backoff_s = retry_backoff_s
        self._degrade_recover_ticks = max(1, degrade_recover_ticks)
        #: memory-pressure degradation: the current admission cap (walks
        #: DOWN the existing bucket ladder on OOM, re-escalates after
        #: ``degrade_recover_ticks`` clean dispatches — never a new
        #: program)
        self._admit_cap = self.max_batch
        self._ok_dispatches = 0
        if isinstance(slo, str):
            slo = parse_slo_spec(slo)
        if isinstance(slo, SloTargets):
            slo = SloMonitor(slo, recorder=self.recorder,
                             registry=self.metrics.registry)
        self._slo: SloMonitor | None = slo
        if slo is not None:
            self.metrics.attach_slo(slo)
        if faults is not None and faults.listener is None:
            def _on_fault(kind: str, site: str) -> None:
                self.metrics.record_fault(kind)
                self.recorder.record(
                    "fault_injected", tick=self.tick, kind=kind,
                    site=site,
                )
            faults.listener = _on_fault
        self._queue: deque[_BatchReq] = deque()
        self._next_id = 0
        self._tick = 0
        self._dead = False
        #: example shape/dtype, locked by the first submit — one program
        #: per bucket REQUIRES homogeneous examples
        self._example_shape: tuple | None = None
        self._example_dtype = None

        def _apply(variables, x):
            return graph.apply(variables, x)

        # the variables are the programs' state (read at their own
        # addresses); the batch is copied into each program's input
        self._programs = ProgramCountingGraph(
            _apply, state_argnums=(0,), label=f"serve.batch.{graph.name}")
        self._dispatch = RetraceWatchdog(
            self._programs,
            f"serve.batch.{graph.name}",
            registry=self.metrics.registry,
            recorder=self.recorder,
            expected_programs=self.num_batch_buckets,
        )

    # -- bucket ladder ------------------------------------------------------

    def batch_bucket(self, k: int) -> int:
        """Padded batch size the dispatch runs at for ``k`` queued
        examples: the next power of two >= max(k, 1), capped at
        ``max_batch``."""
        bucket = 1
        while bucket < k:
            bucket *= 2
        return min(bucket, self.max_batch)

    @property
    def num_batch_buckets(self) -> int:
        """How many distinct dispatch programs CAN exist — one per ladder
        bucket, the ceiling the compile-guard tests pin dispatch to."""
        return len({
            self.batch_bucket(k) for k in range(1, self.max_batch + 1)
        })

    @property
    def batch_compile_count(self) -> int:
        """How many distinct programs the batch dispatch has made —
        bounded by ``num_batch_buckets`` for the deployment's life."""
        return program_count(self._dispatch)

    @property
    def capture_seconds(self) -> float:
        """Wall seconds the batch programs took to capture (0 on the
        CPU)."""
        return self._dispatch.capture_seconds

    def graph_pool_bytes(self) -> int:
        """Device bytes the batch programs' shared graph pool holds."""
        return self._programs.pool.reserved_bytes()

    def release_programs(self) -> None:
        """Drop the captured programs and, with them, their graph pool
        (the program count stays for a post-mortem)."""
        self._programs.release()

    # -- introspection ------------------------------------------------------

    @property
    def tick(self) -> int:
        return self._tick

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def busy(self) -> bool:
        return bool(self._queue)

    @property
    def degraded(self) -> bool:
        return self._admit_cap < self.max_batch

    # -- fault handling -----------------------------------------------------

    def _backoff(self, attempts: int) -> None:
        self.metrics.record_retry()
        self.recorder.record("retry", tick=self._tick, attempt=attempts)
        if self._retry_backoff_s > 0:
            time.sleep(self._retry_backoff_s * attempts)

    def _note_oom(self, tick: int) -> None:
        """Graceful degradation on resource exhaustion: halve the
        admission cap — the smaller batch lands on an EXISTING ladder
        bucket, so degradation never makes a new program. The queued
        examples are requeued untouched and redispatch next tick."""
        self._admit_cap = max(1, self._admit_cap // 2)
        self._ok_dispatches = 0
        self.metrics.set_degraded(True)
        self.recorder.record(
            "degraded", tick=tick, site="serve.batch",
            admit_cap=self._admit_cap,
        )

    def _note_clean_dispatch(self, tick: int) -> None:
        if not self.degraded:
            return
        self._ok_dispatches += 1
        if self._ok_dispatches < self._degrade_recover_ticks:
            return
        self._ok_dispatches = 0
        self._admit_cap = min(self.max_batch, self._admit_cap * 2)
        self.metrics.set_degraded(self.degraded)
        self.recorder.record(
            "recovered" if not self.degraded else "re_escalated",
            tick=tick, admit_cap=self._admit_cap,
        )

    # -- public API ---------------------------------------------------------

    def submit(self, x) -> int:
        """Queue ONE example (no batch dim — batching is the deployment's
        job); returns its id. The first submit locks the deployment's
        example shape/dtype; mismatches and a full queue raise
        :class:`FriendlyError` (admission control)."""
        x = np.asarray(x)
        if self._example_shape is None:
            self._example_shape = tuple(x.shape)
            self._example_dtype = x.dtype
        elif (tuple(x.shape) != self._example_shape
                or x.dtype != self._example_dtype):
            raise FriendlyError(
                f"example shape/dtype {tuple(x.shape)}/{x.dtype} does "
                f"not match this deployment's locked "
                f"{self._example_shape}/{self._example_dtype} "
                f"(model '{self.graph.name}'); one bucket ladder "
                "serves ONE example geometry — submit matching "
                "examples or add a second deployment"
            )
        if len(self._queue) >= self.max_queue:
            self.metrics.record_reject()
            self.recorder.record(
                "rejected", tick=self._tick, reason="queue_full",
            )
            raise FriendlyError(
                f"deployment '{self.graph.name}' queue is full "
                f"({self.max_queue}); retry later or raise max_queue"
            )
        req = _BatchReq(
            id=self._next_id, x=x, submit_tick=self._tick,
            submit_wall=time.perf_counter(),
        )
        self._next_id += 1
        self._queue.append(req)
        self.metrics.record_submit()
        return req.id

    def _run_batch(self, x: np.ndarray) -> np.ndarray:
        """One dispatch: the padded batch in, its whole output on the
        host. The copy out is the dispatch's one host sync, and it lands
        before any later replay can overwrite the program's output."""
        out = self._dispatch(self.variables, host_to_device(x, self.device))
        out = out.to("cpu")
        if out.dtype == torch.bfloat16:
            out = out.float()  # numpy has no bfloat16; exact
        return out.numpy()

    def step(self) -> list[BatchResult]:
        """One deployment tick: drain up to ``min(queue, admission cap,
        max_batch)`` examples, pad to the ladder bucket, fire the
        ``serve.batch`` fault hook, run ONE dispatch, slice the padding
        rows off, retire every example in the batch."""
        if self._dead:
            raise FriendlyError(
                f"deployment '{self.graph.name}' was killed "
                "(EngineKilled); rebuild the engine instead of "
                "stepping it again"
            )
        t0 = time.perf_counter()
        tick = self._tick
        self._tick += 1
        if not self._queue:
            self.metrics.sample_tick(0, 0, time.perf_counter() - t0, 0)
            return []
        if self._slo is not None:
            self._slo.evaluate(tick=tick)
            if self._slo.should_shed:
                # shed = suppress NEW dispatches; queued examples wait
                self.metrics.record_slo_shed()
                self.metrics.sample_tick(
                    len(self._queue), 0, time.perf_counter() - t0, 0,
                )
                return []
        k = min(len(self._queue), self._admit_cap, self.max_batch)
        batch = [self._queue.popleft() for _ in range(k)]
        bucket = self.batch_bucket(k)
        x = np.stack([r.x for r in batch])
        if bucket > k:
            pad = np.zeros((bucket - k,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad])
        attempts = 0
        d0 = time.perf_counter()
        while True:
            try:
                if self._faults is not None:
                    # BEFORE the dispatch: a raised fault runs nothing
                    self._faults.fire(
                        "serve.batch", tick=tick, request=batch[0].id,
                    )
                out = self._run_batch(x)
                break
            except EngineKilled:
                self._dead = True
                self.release_programs()
                for r in reversed(batch):
                    self._queue.appendleft(r)
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                if is_resource_exhausted(e):
                    self._note_oom(tick)
                    for r in reversed(batch):
                        self._queue.appendleft(r)
                    self.metrics.sample_tick(
                        len(self._queue), 0,
                        time.perf_counter() - t0, 0,
                    )
                    return []
                if not is_transient(e):
                    raise
                if attempts < self._retry_limit:
                    attempts += 1
                    self._backoff(attempts)
                    continue
                # retry exhaustion: quarantine the WHOLE batch as
                # "failed" — the deployment keeps serving
                results = []
                for r in batch:
                    self.metrics.record_quarantine()
                    self.recorder.record(
                        "quarantine", tick=tick, id=r.id,
                        reason="retry_exhausted",
                    )
                    res = BatchResult(
                        id=r.id, status="failed", output=None,
                        submit_tick=r.submit_tick, finish_tick=tick,
                        wall_s=time.perf_counter() - r.submit_wall,
                        generated=0,
                    )
                    self.metrics.record_finish(res)
                    results.append(res)
                self.metrics.sample_tick(
                    len(self._queue), 0, time.perf_counter() - t0, 0,
                )
                return results
        dispatch_s = time.perf_counter() - d0
        self._note_clean_dispatch(tick)
        # per-"token" here means per-EXAMPLE: k results in dispatch_s
        self.metrics.record_decode(
            k, dispatch_s, tokens_emitted=k, block=bucket,
        )
        self.recorder.record(
            "batch_dispatch", tick=tick, model=self.graph.name,
            size=k, bucket=bucket,
        )
        results = []
        for i, r in enumerate(batch):
            self.metrics.record_first_token(r, tick, bucket=bucket)
            res = BatchResult(
                id=r.id, status="completed", output=out[i],
                submit_tick=r.submit_tick, finish_tick=tick,
                wall_s=time.perf_counter() - r.submit_wall,
            )
            self.metrics.record_finish(res)
            results.append(res)
        self.metrics.sample_tick(
            len(self._queue), k, time.perf_counter() - t0, k,
        )
        return results


class MultiModelEngine:
    """Several named model deployments behind one submit/step/run
    facade, interleaved under one device budget.

    ``device_budget`` caps deployment dispatches per engine tick (None =
    every deployment with work each tick); a round-robin cursor over the
    registration order guarantees no deployment starves: with D busy
    deployments and budget B, each dispatches at least once per
    ``ceil(D / B)`` ticks. ``faults`` / ``recorder`` / ``registry`` are
    SHARED across deployments — one fault timeline, one registry with
    per-model ``model{name}.`` namespaces. ``device`` is where every
    deployment runs unless its kwargs name another.
    """

    def __init__(self, *, device_budget: int | None = None,
                 recorder: FlightRecorder | None = None,
                 faults: FaultInjector | None = None,
                 registry: MetricRegistry | None = None,
                 device=None):
        if device_budget is not None and device_budget < 1:
            raise FriendlyError(
                f"device_budget must be >= 1, got {device_budget}"
            )
        self.device = default_device(device)
        self.device_budget = device_budget
        self.registry = (
            registry if registry is not None else MetricRegistry()
        )
        self.recorder = (
            recorder if recorder is not None else FlightRecorder()
        )
        self._faults = faults
        # claim the shared injector's listener BEFORE deployments can (a
        # deployment only claims it when unset): fault events from every
        # model land in ONE control-plane timeline
        if faults is not None and faults.listener is None:
            self._m_faults = self.registry.counter(
                "multimodel.faults_injected"
            )

            def _on_fault(kind: str, site: str) -> None:
                self._m_faults.inc()
                self.recorder.record(
                    "fault_injected", tick=self._tick, kind=kind,
                    site=site,
                )
            faults.listener = _on_fault
        self._deployments: dict[str, ServeEngine | BatchDeployment] = {}
        self._order: list[str] = []
        self._rr = 0
        self._tick = 0
        self._next_gid = 0
        #: (model, deployment-local id) -> global id, popped at finish
        self._gid: dict[tuple[str, int], int] = {}
        #: global id -> model name, kept after finish (model_of)
        self._model_of: dict[int, str] = {}

    # -- registration -------------------------------------------------------

    def _check_name(self, name: str) -> None:
        if not name or any(c in name for c in ".;:= "):
            raise FriendlyError(
                f"deployment name {name!r} is invalid: names feed the "
                "model{name}.serve.* metric namespace and the CLI spec "
                "grammar, so they must be non-empty and free of "
                "'.', ';', ':', '=' and spaces"
            )
        if name in self._deployments:
            raise FriendlyError(
                f"deployment '{name}' already exists; names are unique "
                "per engine"
            )

    @staticmethod
    def _check_managed(kwargs: dict, keys: tuple) -> None:
        for key in keys:
            if key in kwargs:
                raise FriendlyError(
                    f"'{key}' is managed by MultiModelEngine — pass it "
                    "to the MultiModelEngine constructor, not through "
                    "deployment kwargs"
                )

    def _view(self, name: str) -> NamespacedRegistry:
        return NamespacedRegistry(self.registry, f"model{name}.")

    def _register(self, name: str, dep, kind: str, arch: str) -> None:
        self._deployments[name] = dep
        self._order.append(name)
        self.recorder.record(
            "deployment_added", tick=self._tick, model=name, kind=kind,
            arch=arch,
        )

    def add_lm(self, name: str, graph, variables,
               **engine_kwargs) -> ServeEngine:
        """Register a stateful LM-decode deployment: a full
        :class:`ServeEngine` (slots, KV pool, fused decode blocks,
        bucketed prefill, its program pins unchanged) writing its metrics
        through the shared registry under ``model{name}.``."""
        self._check_name(name)
        self._check_managed(engine_kwargs,
                            ("faults", "recorder", "registry", "replica"))
        engine_kwargs.setdefault("device", self.device)
        eng = ServeEngine(
            graph, variables, faults=self._faults,
            recorder=self.recorder, registry=self._view(name),
            **engine_kwargs,
        )
        self._register(name, eng, "lm", graph.name)
        return eng

    def add_batch(self, name: str, graph, variables,
                  **deploy_kwargs) -> BatchDeployment:
        """Register a stateless batch deployment for a non-causal
        graph."""
        self._check_name(name)
        self._check_managed(deploy_kwargs, ("faults", "recorder", "registry"))
        deploy_kwargs.setdefault("device", self.device)
        dep = BatchDeployment(
            graph, variables, faults=self._faults,
            recorder=self.recorder, registry=self._view(name),
            **deploy_kwargs,
        )
        self._register(name, dep, "batch", graph.name)
        return dep

    def add_onnx(self, name: str, path: str,
                 **deploy_kwargs) -> BatchDeployment:
        """ONNX ingestion: import a graph file and serve it as a batch
        deployment — the imported initializers are the variables
        (imported graphs arrive trained)."""
        from mmlspark_tpu_torch.models.registry import build_model

        graph = build_model("onnx", path=path)
        dev = deploy_kwargs.get("device", self.device)
        return self.add_batch(name, graph, graph.init(device=dev),
                              **deploy_kwargs)

    def close(self) -> None:
        """Release every deployment's captured programs and their graph
        pools (an LM deployment's KV pool goes with the engine object).
        The engine keeps its bookkeeping for a post-mortem; stepping a
        deployment afterwards runs its programs eagerly."""
        for dep in self._deployments.values():
            dep.release_programs()
        self.recorder.record("closed", tick=self._tick)

    # -- lookup -------------------------------------------------------------

    @property
    def models(self) -> list[str]:
        """Deployment names in registration (= scheduling) order."""
        return list(self._order)

    def deployment(self, name: str):
        return self._deployments[self._resolve(name)]

    def _resolve(self, model: str | None) -> str:
        if model is None:
            if len(self._order) == 1:
                return self._order[0]
            raise FriendlyError(
                "this engine serves several models — pass model=<name>; "
                f"deployments: {sorted(self._deployments)}"
            )
        if model in self._deployments:
            return model
        hint = difflib.get_close_matches(
            model, list(self._deployments), n=1,
        )
        suggest = f"; did you mean '{hint[0]}'?" if hint else ""
        raise FriendlyError(
            f"unknown model '{model}'; deployments: "
            f"{sorted(self._deployments)}{suggest}"
        )

    def model_of(self, gid: int) -> str:
        """Which deployment a global request id was routed to."""
        try:
            return self._model_of[gid]
        except KeyError:
            raise FriendlyError(
                f"unknown request id {gid}; ids are the values "
                "submit() returned"
            )

    # -- public API ---------------------------------------------------------

    def submit(self, x, *, model: str | None = None,
               max_new_tokens: int | None = None,
               eos_id: int | None = None,
               deadline_ticks: int | None = None) -> int:
        """Queue one request on the named deployment; returns a GLOBAL id
        (results come back keyed by it). For an LM deployment ``x`` is
        the prompt token vector and ``max_new_tokens`` is required; for a
        batch deployment ``x`` is one example and the LM-only kwargs are
        rejected. ``model`` may be omitted only when the engine hosts one
        deployment."""
        name = self._resolve(model)
        dep = self._deployments[name]
        # minted BEFORE the deployment call (the gid is consumed only on
        # success): LM spans on the shared recorder carry the facade's
        # trace id, so the hub's chains join "routed" to the engine span
        trace = f"m{self._next_gid}"
        if isinstance(dep, ServeEngine):
            if max_new_tokens is None:
                raise FriendlyError(
                    f"deployment '{name}' is an LM — pass "
                    "max_new_tokens= (the decode budget)"
                )
            lid = dep.submit(
                x, max_new_tokens, eos_id=eos_id,
                deadline_ticks=deadline_ticks, trace_id=trace,
            )
        else:
            if (max_new_tokens is not None or eos_id is not None
                    or deadline_ticks is not None):
                raise FriendlyError(
                    "max_new_tokens/eos_id/deadline_ticks configure LM "
                    f"decode; deployment '{name}' is a stateless batch "
                    "deployment (one example in, one result out)"
                )
            lid = dep.submit(x)
        gid = self._next_gid
        self._next_gid += 1
        self._gid[(name, lid)] = gid
        self._model_of[gid] = name
        self.recorder.record(
            "routed", tick=self._tick, model=name, gid=gid, rid=lid,
            trace=trace,
        )
        return gid

    def _has_work(self, name: str) -> bool:
        return self._deployments[name].busy

    def step(self) -> list:
        """One engine tick: walk the round-robin cursor over the
        deployment order, stepping each deployment that has work, up to
        ``device_budget`` dispatches. Returns every request that reached
        a terminal state this tick (``RequestResult`` for LM streams,
        :class:`BatchResult` for batch examples), rekeyed to global
        ids."""
        self._tick += 1
        n = len(self._order)
        if n == 0:
            return []
        budget = self.device_budget if self.device_budget else n
        results: list = []
        ticked = 0
        scanned = 0
        i = self._rr
        while ticked < budget and scanned < n:
            name = self._order[i % n]
            i += 1
            scanned += 1
            if not self._has_work(name):
                continue
            ticked += 1
            for res in self._deployments[name].step():
                gid = self._gid.pop((name, res.id), None)
                if gid is None:
                    # a request submitted directly on the deployment
                    # (bypassing the facade) — surfaced as it is
                    results.append(res)
                    continue
                results.append(dataclasses.replace(res, id=gid))
        self._rr = i % n
        return results

    @property
    def tick(self) -> int:
        return self._tick

    @property
    def busy(self) -> bool:
        return any(self._has_work(name) for name in self._order)

    def run(self, max_ticks: int = 100_000) -> dict:
        """Step until no deployment has work; results keyed by global id.
        Raises the typed error at ``max_ticks`` with the partial results
        attached as ``err.results``."""
        out: dict = {}
        ticks = 0
        with self.recorder.dump_on_friendly_error():
            while self.busy:
                if ticks >= max_ticks:
                    err = FriendlyError(
                        f"MultiModelEngine run() exceeded max_ticks "
                        f"({max_ticks}) with work still queued; "
                        "partial results are attached as err.results"
                    )
                    err.results = dict(out)
                    raise err
                for res in self.step():
                    out[res.id] = res
                ticks += 1
        return out

    # -- metrics ------------------------------------------------------------

    def metrics_dict(self) -> dict:
        """Engine-level totals, one nested per-model dict (each
        deployment's flat ``to_dict`` plus its kind and program-count
        pins) and the SHARED registry's flat view — the JAX package's
        keys."""
        per_model: dict[str, dict] = {}
        totals = {"submitted": 0, "completed": 0, "failed": 0,
                  "rejected": 0}
        for name in self._order:
            dep = self._deployments[name]
            d = dep.metrics.to_dict()
            for key in totals:
                totals[key] += d[key]
            if isinstance(dep, ServeEngine):
                d["kind"] = "lm"
                d["decode_compile_count"] = dep.decode_compile_count
                d["prefill_compile_count"] = dep.prefill_compile_count
                d["num_decode_blocks"] = dep.num_decode_blocks
                d["num_prefill_buckets"] = dep.num_prefill_buckets
            else:
                d["kind"] = "batch"
                d["batch_compile_count"] = dep.batch_compile_count
                d["num_batch_buckets"] = dep.num_batch_buckets
                d["max_batch"] = dep.max_batch
            per_model[name] = d
        return {
            "multimodel": True,
            "deployments": len(self._order),
            "device_budget": self.device_budget,
            "ticks": self._tick,
            **totals,
            "per_model": per_model,
            # the shared registry's flat keys: model{name}.serve.*, ...
            "registry": self.registry.to_dict(),
        }

    def to_prometheus(self) -> str:
        """One collision-free Prometheus exposition for every deployment
        (``model{name}_serve_*`` metric families)."""
        return self.registry.to_prometheus()


# ---------------------------------------------------------------------------
# CLI spec grammar (serve --models)
# ---------------------------------------------------------------------------

#: per-entry keys that configure the DEPLOYMENT rather than the model
#: builder (everything else in an entry is build_model config)
_DEPLOY_KEYS = frozenset({
    "slots", "cache_len", "decode_block", "max_queue", "max_batch",
    "slo", "prefill_chunk", "async_host",
})
#: deployment keys valid per kind — crossing them is a spec error
_LM_ONLY = frozenset({
    "slots", "cache_len", "decode_block", "prefill_chunk", "async_host",
})
_BATCH_ONLY = frozenset({"max_batch"})


@dataclasses.dataclass
class ModelSpecEntry:
    """One parsed ``--models`` entry: ``name=arch:key=value:...``."""

    name: str
    arch: str
    build_config: dict
    deploy_kwargs: dict


def _coerce(value: str):
    """CLI value -> int / float / 'x'-separated int tuple / string."""
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    parts = value.split("x")
    if len(parts) > 1 and all(p.isdigit() for p in parts):
        return tuple(int(p) for p in parts)
    return value


def parse_models_spec(spec: str) -> list[ModelSpecEntry]:
    """The ``--models`` grammar: entries separated by ``;``, each
    ``name=arch`` followed by ``:key=value`` fields. Reserved deployment
    keys (slots / cache_len / decode_block / max_queue / max_batch / slo /
    prefill_chunk / async_host) configure the deployment; every other key
    is ``build_model`` config (``path=`` is how an ONNX file registers:
    ``ox=onnx:path=/path/model.onnx``). SLO values spell ``,`` as ``+``
    (``slo=ttft_p99_ms=200+error_rate=0.5``) because ``:`` and ``;`` are
    taken. Two more reserved keys, ``input_shape`` (``8`` or ``32x32x3``)
    and ``input_dtype`` (``int32``/``float32``), give the example
    geometry of architectures that record no ``input_shape`` of their own
    (``mlp``/``linear``/``bilstm_tagger``)::

        lm=transformer_lm:slots=4:cache_len=64;clf=mlp:max_batch=8
    """
    entries: list[ModelSpecEntry] = []
    seen: set[str] = set()
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        fields = raw.split(":")
        head = fields[0]
        if "=" not in head:
            raise FriendlyError(
                f"bad --models entry {head!r}: expected 'name=arch' "
                "(e.g. 'lm=transformer_lm' or 'ox=onnx:path=m.onnx')"
            )
        name, arch = (s.strip() for s in head.split("=", 1))
        if not name or not arch:
            raise FriendlyError(
                f"bad --models entry {raw!r}: empty name or arch"
            )
        if name in seen:
            raise FriendlyError(
                f"duplicate deployment name '{name}' in --models spec"
            )
        seen.add(name)
        build_config: dict = {}
        deploy_kwargs: dict = {}
        for f in fields[1:]:
            if "=" not in f:
                raise FriendlyError(
                    f"bad --models field {f!r} in entry '{name}': "
                    "expected key=value"
                )
            key, value = f.split("=", 1)
            key = key.strip()
            if key == "slo":
                # the SLO spec spells ',' as '+' inside the models grammar
                deploy_kwargs[key] = value.replace("+", ",")
            elif key == "path":
                build_config[key] = value
            elif key in _DEPLOY_KEYS:
                deploy_kwargs[key] = _coerce(value)
            else:
                build_config[key] = _coerce(value)
        entries.append(ModelSpecEntry(
            name=name, arch=arch, build_config=build_config,
            deploy_kwargs=deploy_kwargs,
        ))
    if not entries:
        raise FriendlyError(
            "--models spec is empty; expected "
            "'name=arch[:key=value]*[;name=arch...]'"
        )
    return entries


def engine_from_spec(spec: str, *, device_budget: int | None = None,
                     recorder: FlightRecorder | None = None,
                     faults: FaultInjector | None = None,
                     registry: MetricRegistry | None = None,
                     variables: dict | None = None,
                     lm_kwargs: dict | None = None,
                     seed: int = 0, device=None) -> MultiModelEngine:
    """Build a :class:`MultiModelEngine` from the CLI spec string.

    Each entry builds its graph with ``build_model(arch, **config)``; ONNX
    entries take their variables from the imported initializers, every
    other entry initializes fresh from ``seed`` (:func:`_init_variables`)
    unless ``variables`` maps the deployment name to trained variables.
    The kind comes from the graph: ``causal`` graphs become LM
    deployments, everything else a batch deployment — and deployment keys
    of the wrong kind are rejected with the offending entry named.
    """
    from mmlspark_tpu_torch.models.registry import build_model

    engine = MultiModelEngine(
        device_budget=device_budget, recorder=recorder, faults=faults,
        registry=registry, device=device,
    )
    variables = variables or {}
    for entry in parse_models_spec(spec):
        config = dict(entry.build_config)
        shape = config.pop("input_shape", None)
        config.pop("input_dtype", None)  # the port's init needs no sample
        graph = build_model(entry.arch, **config)
        if shape is not None:
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            graph = dataclasses.replace(graph, input_shape=shape)
        causal = bool(graph.extra.get("causal", False))
        wrong = (
            (_BATCH_ONLY if causal else _LM_ONLY)
            & set(entry.deploy_kwargs)
        )
        if wrong:
            kind = "an LM" if causal else "a stateless batch"
            raise FriendlyError(
                f"--models entry '{entry.name}' ({entry.arch}) is "
                f"{kind} deployment; {sorted(wrong)} do not apply"
            )
        if entry.name in variables:
            model_vars = variables[entry.name]
        elif entry.arch == "onnx":
            model_vars = graph.init(device=engine.device)
        else:
            model_vars = _init_variables(graph, seed, engine.device)
        if causal:
            # lm_kwargs: CLI-wide LM defaults (--prefill-chunk,
            # --async-host through --models); per-entry spec keys win
            engine.add_lm(entry.name, graph, model_vars,
                          **{**(lm_kwargs or {}), **entry.deploy_kwargs})
        else:
            engine.add_batch(entry.name, graph, model_vars,
                             **entry.deploy_kwargs)
    return engine


def _init_variables(graph, seed: int, device: torch.device) -> dict:
    """Fresh variables for a spec-built graph, drawn on the compute
    device from a ``torch.Generator`` seeded with ``seed``; a graph that
    learns its input width from the first input (``mlp``/``linear``) is
    sized from its ``input_shape``, which spec-built deployments need."""
    from mmlspark_tpu_torch.models.bridge import init_variables

    if not graph.input_shape:
        raise FriendlyError(
            f"'{graph.name}' records no input_shape; spec-built "
            "deployments need it to initialize variables — set the "
            "spec's input_shape= key (e.g. input_shape=8 or 32x32x3) "
            "or pass trained variables explicitly"
        )
    graph.size_input(tuple(graph.input_shape))
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_variables(graph, seed, device=device, generator=gen)
