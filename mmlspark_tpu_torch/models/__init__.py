"""Models: named-block graphs, the registry, the transformer LM, the
weight bridge from flax, and greedy generation."""

from mmlspark_tpu_torch.models.bridge import (
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.models.generate import generate
from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.registry import build_model, register_model
from mmlspark_tpu_torch.models.transformer import transformer_lm

__all__ = [
    "FINAL_NODE",
    "NamedGraph",
    "build_model",
    "generate",
    "init_variables",
    "load_flax_variables",
    "register_model",
    "transformer_lm",
]
