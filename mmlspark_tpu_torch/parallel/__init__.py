"""Parallelism: for now the single-device half of expert routing
(:mod:`expert`). Meshes, sharding rules, context and pipeline
parallelism wait for ROADMAP.md Queue 1 item 13."""

from mmlspark_tpu_torch.parallel.expert import (
    moe_dispatch,
    moe_ffn,
    moe_ffn_dropless,
    router_probs,
    validate_experts,
)

__all__ = ["moe_dispatch", "moe_ffn", "moe_ffn_dropless", "router_probs",
           "validate_experts"]
