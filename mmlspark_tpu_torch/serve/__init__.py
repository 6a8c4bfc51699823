"""Serving: the slot KV pool, the continuous-batching scheduler and
``ServeEngine``, its metrics, the synthetic-traffic demo, and the replica
planes over the engine — :class:`ReplicaSet` (health probes, snapshot
failover, hedging, zero-loss drain, model routing) and
:class:`DisaggFleet` (prefill and decode roles with KV hand-offs, a
fleet-wide prefix index and an :class:`AutoscalePolicy`) — and
:class:`MultiModelEngine`: several named deployments, LM engines and
stateless batch deployments (ONNX imports among them), under one device
budget. The fault harness and the SLO and analytics planes are
re-exported here, as the JAX package's ``serve`` does."""

from mmlspark_tpu_torch.core.faults import (
    Fault,
    FaultInjector,
    parse_fault_spec,
)
from mmlspark_tpu_torch.core.perf import (
    PerfAnalytics,
    SloMonitor,
    SloTargets,
    export_chrome_trace,
    parse_slo_spec,
)
from mmlspark_tpu_torch.serve.cache_pool import SlotCachePool
from mmlspark_tpu_torch.serve.demo import run_demo
from mmlspark_tpu_torch.serve.engine import ServeEngine
from mmlspark_tpu_torch.serve.fleet import (
    AutoscalePolicy,
    DisaggFleet,
    parse_autoscale_spec,
)
from mmlspark_tpu_torch.serve.metrics import ServeMetrics
from mmlspark_tpu_torch.serve.multimodel import (
    BatchDeployment,
    BatchResult,
    MultiModelEngine,
    engine_from_spec,
    parse_models_spec,
)
from mmlspark_tpu_torch.serve.scheduler import (
    ContinuousBatchScheduler,
    RequestResult,
    ServeRequest,
)
from mmlspark_tpu_torch.serve.supervisor import ReplicaSet

__all__ = [
    "AutoscalePolicy",
    "BatchDeployment",
    "BatchResult",
    "ContinuousBatchScheduler",
    "DisaggFleet",
    "Fault",
    "FaultInjector",
    "MultiModelEngine",
    "PerfAnalytics",
    "ReplicaSet",
    "RequestResult",
    "ServeEngine",
    "ServeMetrics",
    "ServeRequest",
    "SloMonitor",
    "SloTargets",
    "SlotCachePool",
    "engine_from_spec",
    "export_chrome_trace",
    "parse_autoscale_spec",
    "parse_fault_spec",
    "parse_models_spec",
    "parse_slo_spec",
    "run_demo",
]
