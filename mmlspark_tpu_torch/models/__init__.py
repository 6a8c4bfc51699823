"""Models: named-block graphs, the registry, the transformer LM and its
switch-MoE and pipelined twins, the MLP and linear family, the ResNets, the BiLSTM
tagger, the weight bridge from flax, generation (greedy, sampled, beam
search), and ONNX import and export."""

from mmlspark_tpu_torch.models.bilstm import bilstm_tagger
from mmlspark_tpu_torch.models.bridge import (
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.models.generate import beam_search, generate
from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.mlp import linear, mlp
from mmlspark_tpu_torch.models.moe import transformer_lm_moe
from mmlspark_tpu_torch.models.onnx_export import export_onnx, save_onnx
from mmlspark_tpu_torch.models.onnx_import import OnnxGraph, load_onnx
from mmlspark_tpu_torch.models.pipelined import (
    PipelinedGraph,
    transformer_lm_pipelined,
)
from mmlspark_tpu_torch.models.registry import (
    build_model,
    register_model,
    registered_models,
)
from mmlspark_tpu_torch.models.resnet import resnet20_cifar10, resnet50
from mmlspark_tpu_torch.models.transformer import transformer_lm

__all__ = [
    "FINAL_NODE",
    "NamedGraph",
    "OnnxGraph",
    "PipelinedGraph",
    "beam_search",
    "bilstm_tagger",
    "build_model",
    "export_onnx",
    "generate",
    "init_variables",
    "linear",
    "load_flax_variables",
    "load_onnx",
    "mlp",
    "register_model",
    "registered_models",
    "resnet20_cifar10",
    "resnet50",
    "save_onnx",
    "transformer_lm",
    "transformer_lm_moe",
    "transformer_lm_pipelined",
]
