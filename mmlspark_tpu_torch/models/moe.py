"""Mixture-of-experts transformer LM — the port of
``mmlspark_tpu/models/moe.py`` for one device.

Every block's FFN is a top-1 switch-routed expert bank
(:mod:`mmlspark_tpu_torch.parallel.expert`); attention, the layer norms,
the embedding and the head are ``transformer_lm``'s. The names are
flax's (``ln1``, ``attn``, ``ln2``, ``moe/gate``,
``moe/experts/{w_in,b_in,w_out,b_out}``), and every MoE leaf keeps
flax's layout (``gate`` (D, E), ``w_in`` (E, D, F), ``w_out`` (E, F, D)),
so the weight bridge carries them untransposed and weight-int8 takes one
scale per index of their last axis, as the JAX package's does.

The routing mode: a decode step (the explicit ``decode`` flag that
``models/generate.py`` passes) routes droplessly; every other call —
training, scoring, and a prefill, even of a one-token prompt — takes the
capacity path, over the real rows of ``mask`` when one is given. In
train mode (``train=True``, passed by ``NamedGraph.apply``) the router's
load-balance loss is left in :attr:`MoEFFN.new_losses`, which the graph
collects into ``updated[block]["losses"]`` (flax's sown ``losses``
collection); the trainer adds ``moe_aux_weight`` times their sum to the
loss.

:func:`expert_local_graph` makes a rank's copy for the trainer's mesh
mode under ``EXPERT_RULES``: each MoE FFN holds the rank's experts only
and runs them on its slice of the dispatch (``parallel/expert.py``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from mmlspark_tpu_torch.core.exceptions import ParamError
from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.registry import register_model
from mmlspark_tpu_torch.models.transformer import (
    ATTN_IMPLS,
    AUTO,
    LN_EPS,
    LMHead,
    SelfAttention,
    TokenPosEmbed,
    resolve_attn_impl,
    validate_attention_features,
)
from mmlspark_tpu_torch.parallel.expert import (
    moe_ffn,
    moe_ffn_dropless,
    validate_experts,
)


class ExpertParams(nn.Module):
    """The stacked expert weights, under a module named ``experts`` as in
    flax."""

    #: the leaves the expert products cast to the compute dtype (the
    #: router's ``gate`` stays f32)
    COMPUTE_DTYPE_LEAVES = ("w_in", "b_in", "w_out", "b_out")

    def __init__(self, n_experts: int, d_model: int, d_ff: int):
        super().__init__()
        self.w_in = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.b_in = nn.Parameter(torch.empty(n_experts, d_ff))
        self.w_out = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        self.b_out = nn.Parameter(torch.empty(n_experts, d_model))


class MoEFFN(nn.Module):
    #: the expert-local FFN's ``expert`` axis (a ``parallel.mesh.
    #: MeshAxis``; :func:`expert_local_graph`), None: every expert here
    expert_axis = None

    def __init__(self, d_model: int, n_experts: int, d_ff: int,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16,
                 group_size: int = 1024):
        super().__init__()
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.group_size = group_size
        self.gate = nn.Parameter(torch.empty(d_model, n_experts))
        self.experts = ExpertParams(n_experts, d_model, d_ff)
        #: the load-balance loss of the last train-mode call, collected
        #: (and cleared) by ``NamedGraph.apply``
        self.new_losses: dict | None = None

    def forward(self, x, mask=None, decode: bool = False,
                train: bool = False):
        ex = self.experts
        weights = (self.gate, ex.w_in, ex.b_in, ex.w_out, ex.b_out)
        if decode:
            # one-token decode steps: dropless per-token expert gather —
            # capacity dispatch over B tokens would drop streams whenever
            # routing concentrates
            return moe_ffn_dropless(x.to(self.dtype), *weights).to(x.dtype)
        out, aux = moe_ffn(x.to(self.dtype), *weights,
                           capacity_factor=self.capacity_factor, mask=mask,
                           group_size=self.group_size,
                           expert=self.expert_axis)
        if train:
            self.new_losses = {"load_balance": aux}
        return out.to(x.dtype)


class MoEBlock(nn.Module):
    def __init__(self, d_model: int, heads: int, head_dim: int,
                 n_experts: int, d_ff: int, causal: bool,
                 capacity_factor: float, dtype=torch.bfloat16,
                 window: int | None = None, kv_heads: int | None = None,
                 rope: bool = False, attn_impl: str = AUTO):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = SelfAttention(
            d_model, heads, head_dim, causal, window=window,
            kv_heads=kv_heads, rope=rope, dtype=dtype, attn_impl=attn_impl,
        )
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.moe = MoEFFN(d_model, n_experts, d_ff, capacity_factor, dtype)

    def forward(self, x, mask=None, cache=None, pos=None, rolled=False,
                decode=False, live=None, train=False):
        attn = self.attn(self.ln1(x.float()), cache=cache, pos=pos,
                         rolled=rolled, decode=decode, live=live)
        new_cache = None
        if cache is not None:
            attn, new_cache = attn
        x = x + attn
        # ``decode`` is the explicit decode-step marker: a prefill, even
        # of a one-token prompt, keeps the capacity path, which over the
        # unpadded prompt is exactly the scoring forward
        y = self.moe(self.ln2(x.float()), mask, decode=decode, train=train)
        out = x + y
        return out if new_cache is None else (out, new_cache)


@register_model("transformer_lm_moe")
def transformer_lm_moe(
    vocab_size: int = 1024,
    d_model: int = 128,
    heads: int = 4,
    depth: int = 2,
    n_experts: int = 8,
    d_ff: int = 0,
    max_len: int = 512,
    causal: bool = True,
    capacity_factor: float = 1.25,
    attn_impl: str = AUTO,
    window: int | None = None,
    kv_heads: int | None = None,
    pos_embedding: str = "learned",
    mesh: Any = None,
) -> NamedGraph:
    """Decoder-only switch-MoE LM; every block's FFN is expert-routed.
    The attention feature set (window / kv_heads / pos_embedding /
    attn_impl) is ``transformer_lm``'s."""
    if d_model % heads:
        raise ParamError(f"d_model {d_model} not divisible by heads {heads}")
    rope = validate_attention_features(
        heads=heads, head_dim=d_model // heads, causal=causal,
        window=window, kv_heads=kv_heads, pos_embedding=pos_embedding,
    )
    if attn_impl not in ATTN_IMPLS:
        raise ParamError(
            f"unknown attn_impl '{attn_impl}'; one of {ATTN_IMPLS}"
        )
    validate_experts(n_experts, mesh)
    attn_impl = resolve_attn_impl(attn_impl)
    d_ff = d_ff or 4 * d_model
    with torch.device("meta"):
        blocks: list[tuple[str, nn.Module]] = [
            ("embed", TokenPosEmbed(vocab_size, d_model, max_len,
                                    learned_pos=not rope))
        ]
        for i in range(depth):
            blocks.append((
                f"block{i}",
                MoEBlock(d_model, heads, d_model // heads, n_experts, d_ff,
                         causal, capacity_factor, window=window,
                         kv_heads=kv_heads, rope=rope, attn_impl=attn_impl),
            ))
        blocks.append((FINAL_NODE, LMHead(d_model, vocab_size)))
    return NamedGraph(
        name="transformer_lm_moe",
        blocks=blocks,
        input_shape=(max_len,),
        extra={
            "vocab_size": vocab_size,
            "n_experts": n_experts,
            "attn_impl": attn_impl,
            "causal": causal,
            "heads": heads,
            "window": window,
            "kv_heads": kv_heads,
            "pos_embedding": pos_embedding,
        },
    )


def expert_local_graph(graph: NamedGraph, axis) -> NamedGraph:
    """This rank's copy of a switch-MoE ``graph`` whose FFNs run only
    the rank's experts: the blocks copied on ``meta``, each expert bank
    resized to ``n_experts / axis.size`` experts and its FFN given
    ``axis`` (the rank's ``parallel.mesh.MeshAxis`` on ``expert``; the
    router's gate stays whole). Bind it to the rank's contiguous chunk
    of every expert leaf (``EXPERT_RULES``' layout)."""
    from mmlspark_tpu_torch.models.graph import _meta_copy

    blocks = []
    with torch.device("meta"):
        for name, mod in graph.blocks:
            mod = _meta_copy(mod)
            for ffn in mod.modules():
                if isinstance(ffn, MoEFFN):
                    n, d, f = ffn.experts.w_in.shape
                    ffn.experts = ExpertParams(n // axis.size, d, f)
                    ffn.expert_axis = axis
            blocks.append((name, mod))
    return NamedGraph(name=graph.name, blocks=blocks,
                      input_shape=graph.input_shape,
                      compute_dtype=graph.compute_dtype,
                      extra=dict(graph.extra))
