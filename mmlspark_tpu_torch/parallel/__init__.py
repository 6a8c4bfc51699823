"""Parallelism layer: device meshes over a ``torch.distributed`` process
group (:mod:`mesh`), tensor-parallel sharding rules (:mod:`sharding`),
sequence/context parallelism — ring attention and Ulysses
(:mod:`context_parallel`) — and the single-device half of expert routing
(:mod:`expert`). Pipeline parallelism, the sequence-parallel BiLSTM and
``EXPERT_RULES`` wait for the rest of ROADMAP.md Queue 1 item 13.
"""

from mmlspark_tpu_torch.parallel.context_parallel import (
    ring_attention,
    ulysses_attention,
)
from mmlspark_tpu_torch.parallel.expert import (
    moe_dispatch,
    moe_ffn,
    moe_ffn_dropless,
    router_probs,
    validate_experts,
)
from mmlspark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    axis_size,
    batch_spec,
    initialize_distributed,
    make_mesh,
    mesh_shape,
    parse_mesh_axes,
    replicated_spec,
)
from mmlspark_tpu_torch.parallel.sharding import (
    TRANSFORMER_TP_RULES,
    NamedSharding,
    build_param_shardings,
    shard_params,
    spec_for_path,
    unmatched_param_paths,
)

__all__ = [
    "DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPELINE_AXIS",
    "SEQUENCE_AXIS", "NamedSharding", "TRANSFORMER_TP_RULES", "axis_size",
    "batch_spec", "build_param_shardings", "initialize_distributed",
    "make_mesh", "mesh_shape", "moe_dispatch", "moe_ffn",
    "moe_ffn_dropless", "parse_mesh_axes", "replicated_spec",
    "ring_attention", "router_probs", "shard_params", "spec_for_path",
    "ulysses_attention", "unmatched_param_paths", "validate_experts",
]
