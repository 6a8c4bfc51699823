"""BiLSTM sequence tagger — the port of ``mmlspark_tpu/models/bilstm.py``.

Capability target: reference notebook 304 (Medical Entity Extraction), a
per-token tagger: embedding -> bidirectional LSTM -> per-token logits.
The JAX package runs flax's ``OptimizedLSTMCell`` under ``nn.RNN``
(``lax.scan``, not a Pallas kernel); here both directions are one call of
PyTorch's LSTM (``torch.lstm``, the op ``nn.LSTM`` calls), whose CUDA path
is cuDNN's.

The gates are flax's: ``i, f, g, o`` from input kernels ``ii/if/ig/io``
(no bias) and hidden kernels ``hi/hf/hg/ho`` (with a bias), each
``(in, hidden)`` in flax. :class:`BiLSTM` keeps PyTorch's packed layout
per direction, gate order ``i, f, g, o``: ``weight_ih`` (4H, E),
``weight_hh`` (4H, H) and ``bias_hh`` (4H,) — flax's hidden bias; the
input-side bias PyTorch's op also takes is a zero it makes per call, so
no parameter exists that flax lacks and training moves the same leaves.
The forward direction is flax's ``OptimizedLSTMCell_0``, the backward
(``reverse=True, keep_order=True``) ``OptimizedLSTMCell_1``, suffixed
``_reverse`` here; the outputs are concatenated forward first. The LSTM
computes in f32, as flax's cell does by default.
"""

from __future__ import annotations

import torch
from torch import nn

from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.registry import register_model
from mmlspark_tpu_torch.models.transformer import Dense

#: flax's gate names, in PyTorch's packed order
GATES = ("i", "f", "g", "o")
#: the port's direction suffix -> flax's cell
DIRECTIONS = {"": "OptimizedLSTMCell_0", "_reverse": "OptimizedLSTMCell_1"}


class TokenEmbed(nn.Module):
    """flax ``nn.Embed`` under ``Embed_0``: (B, T) int ids -> f32
    (B, T, E)."""

    def __init__(self, vocab_size: int, features: int):
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, features)

    def forward(self, ids):
        return self.Embed_0(ids.long())


class BiLSTM(nn.Module):
    """(B, T, E) -> (B, T, 2 * hidden), both directions in one call."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        for sfx in DIRECTIONS:
            self.register_parameter(f"weight_ih{sfx}", nn.Parameter(
                torch.empty(4 * features, in_features)))
            self.register_parameter(f"weight_hh{sfx}", nn.Parameter(
                torch.empty(4 * features, features)))
            self.register_parameter(f"bias_hh{sfx}", nn.Parameter(
                torch.empty(4 * features)))

    def forward(self, x):
        x = x.float()
        zero = torch.zeros_like(self.bias_hh)
        weights = [t for sfx in DIRECTIONS for t in (
            getattr(self, f"weight_ih{sfx}"), getattr(self, f"weight_hh{sfx}"),
            zero, getattr(self, f"bias_hh{sfx}"))]
        h0 = x.new_zeros(2, x.shape[0], self.features)
        out, _, _ = torch.lstm(x, (h0, h0), weights, True, 1, 0.0,
                               torch.is_grad_enabled(), True, True)
        return out


class TokenLogits(nn.Module):
    """A Dense over each token computed in ``dtype`` (bf16), returned in
    f32."""

    def __init__(self, in_features: int, num_tags: int):
        super().__init__()
        self.dtype = torch.bfloat16
        self.Dense_0 = Dense(in_features, num_tags)

    def forward(self, x):
        return self.Dense_0(x, self.dtype).float()


@register_model("bilstm_tagger")
def bilstm_tagger(
    vocab_size: int = 10000,
    embed_dim: int = 128,
    hidden: int = 128,
    num_tags: int = 8,
) -> NamedGraph:
    with torch.device("meta"):
        blocks: list[tuple[str, nn.Module]] = [
            ("embed", TokenEmbed(vocab_size, embed_dim)),
            ("bilstm", BiLSTM(embed_dim, hidden)),
            (FINAL_NODE, TokenLogits(2 * hidden, num_tags)),
        ]
    return NamedGraph(name="bilstm_tagger", blocks=blocks)
