"""Serving: the slot KV pool, the continuous-batching scheduler and
``ServeEngine``, its metrics, and the synthetic-traffic demo."""

from mmlspark_tpu_torch.serve.cache_pool import SlotCachePool
from mmlspark_tpu_torch.serve.demo import run_demo
from mmlspark_tpu_torch.serve.engine import ServeEngine
from mmlspark_tpu_torch.serve.metrics import ServeMetrics
from mmlspark_tpu_torch.serve.scheduler import RequestResult

__all__ = [
    "RequestResult",
    "ServeEngine",
    "ServeMetrics",
    "SlotCachePool",
    "run_demo",
]
