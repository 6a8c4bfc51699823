"""Parallelism layer: device meshes over a ``torch.distributed`` process
group (:mod:`mesh`), parameter sharding rules (:mod:`sharding`),
sequence/context parallelism — ring attention and Ulysses
(:mod:`context_parallel`) — pipeline parallelism (:mod:`pipeline`),
expert routing and its sharding rules (:mod:`expert`) and the
sequence-parallel BiLSTM (:mod:`sequence_rnn`). The trainer's mesh mode
(``train/trainer.py``) runs them. The serving engine's mesh mode
(``serve/engine.py``) takes a rank's place on a (data, model) mesh
(:class:`MeshPlace`, :func:`serve_mesh`: the sum over ``model``, the
gather over ``data``, the vocab-parallel greedy combine and the control
plane's agreement) and splits the model's compute over it
(:func:`model_split`, :func:`local_variables`). The trainer's mesh mode
runs the same split with its backward over any mesh that has a
``model`` axis (:class:`ModelPlace`: :class:`CopyToAxis` and
:class:`ReduceFromAxis`, Megatron's conjugate pair).
"""

from mmlspark_tpu_torch.parallel.context_parallel import (
    ring_attention,
    ulysses_attention,
)
from mmlspark_tpu_torch.parallel.expert import (
    EXPERT_RULES,
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
    CopyToAxis,
    MeshDesync,
    MeshPlace,
    ModelPlace,
    ReduceFromAxis,
    axis_size,
    batch_spec,
    initialize_distributed,
    local_batch,
    make_mesh,
    mesh_shape,
    parse_mesh_axes,
    replicated_spec,
    serve_mesh,
)
from mmlspark_tpu_torch.parallel.pipeline import (
    PIPELINE_STAGE_RULES,
    pipeline_apply,
)
from mmlspark_tpu_torch.parallel.sequence_rnn import (
    bilstm_seq_parallel_apply,
    bilstm_seq_parallel_train_step,
)
from mmlspark_tpu_torch.parallel.sharding import (
    TRANSFORMER_TP_RULES,
    ModelSplit,
    NamedSharding,
    build_param_shardings,
    local_variables,
    model_split,
    shard_params,
    spec_for_path,
    unmatched_param_paths,
)

__all__ = [
    "DATA_AXIS", "EXPERT_AXIS", "EXPERT_RULES", "MODEL_AXIS",
    "PIPELINE_AXIS", "PIPELINE_STAGE_RULES", "SEQUENCE_AXIS",
    "CopyToAxis", "MeshDesync", "MeshPlace", "ModelPlace", "ModelSplit",
    "NamedSharding", "ReduceFromAxis",
    "TRANSFORMER_TP_RULES", "axis_size", "batch_spec",
    "bilstm_seq_parallel_apply", "bilstm_seq_parallel_train_step",
    "build_param_shardings", "initialize_distributed", "local_batch",
    "local_variables", "make_mesh", "mesh_shape", "model_split",
    "moe_dispatch", "moe_ffn", "moe_ffn_dropless", "parse_mesh_axes",
    "pipeline_apply", "replicated_spec", "ring_attention",
    "router_probs", "serve_mesh", "shard_params", "spec_for_path",
    "ulysses_attention", "unmatched_param_paths", "validate_experts",
]
