"""MLP and linear model family — the port of ``mmlspark_tpu/models/mlp.py``.

``DenseRelu`` and ``DenseOut`` hold f32 parameters and compute in bf16,
as the flax modules do (``nn.Dense(dtype=bfloat16,
param_dtype=float32)``); ``DenseOut`` casts its output back to f32. Each
block keeps its layer under flax's name, ``Dense_0``, so the weight
bridge carries ``hidden{i}/params/Dense_0/{kernel,bias}`` and
``z/params/Dense_0/...`` across (the kernel transposed, as for every
Dense leaf).

A flax Dense learns its input width from the first input it sees. Here a
block is unsized until
:meth:`~mmlspark_tpu_torch.models.graph.NamedGraph.size_input` (the
trainer calls it with the batch's feature width) or the weight bridge
(from the flax kernel's rows) sizes it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.registry import register_model
from mmlspark_tpu_torch.models.transformer import Dense


class _DenseBlock(nn.Module):
    """One flax Dense in bf16 under the name ``Dense_0``."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features

    @property
    def sized(self) -> bool:
        return hasattr(self, "Dense_0")

    def size_input(self, in_features: int) -> int:
        """Build the layer for ``in_features`` inputs (once); returns the
        block's output width."""
        if self.sized:
            have = self.Dense_0.weight.shape[1]
            if have != in_features:
                raise FriendlyError(
                    f"the block was sized for {have} input features, got "
                    f"{in_features}")
            return self.features
        with torch.device("meta"):
            self.Dense_0 = Dense(int(in_features), self.features)
        self.Dense_0.requires_grad_(False)
        return self.features

    def size_from_flax(self, params) -> None:
        """Size the block from its flax parameters' kernel (in, out)."""
        if not self.sized:
            self.size_input(np.shape(params["Dense_0"]["kernel"])[0])

    def dense(self, x):
        if not self.sized:
            raise FriendlyError(
                "the MLP block has no input width yet: call "
                "graph.size_input(x.shape[1:]) or load flax weights first")
        return self.Dense_0(x, torch.bfloat16)


class DenseRelu(_DenseBlock):
    def forward(self, x):
        return F.relu(self.dense(x))


class DenseOut(_DenseBlock):
    def forward(self, x):
        return self.dense(x).float()


@register_model("mlp")
def mlp(num_outputs: int = 2,
        hidden: Sequence[int] = (128, 128)) -> NamedGraph:
    blocks: list[tuple[str, nn.Module]] = [
        (f"hidden{i + 1}", DenseRelu(h)) for i, h in enumerate(hidden)
    ]
    blocks.append((FINAL_NODE, DenseOut(num_outputs)))
    return NamedGraph(name="mlp", blocks=blocks)


@register_model("linear")
def linear(num_outputs: int = 1) -> NamedGraph:
    """Single dense layer: logistic regression (with softmax/sigmoid applied
    by the loss/eval layer) or linear regression."""
    return NamedGraph(name="linear",
                      blocks=[(FINAL_NODE, DenseOut(num_outputs))])
