"""Pipeline-parallel transformer LM — the port of
``mmlspark_tpu/models/pipelined.py``.

The trunk (a stack of identical transformer Blocks) is cut into
``pipe``-axis stages and run with
:func:`mmlspark_tpu_torch.parallel.pipeline.pipeline_apply`; the
embedding and the LM head run outside the pipeline on every rank (they
are not homogeneous with the trunk).

The graph is a :class:`~mmlspark_tpu_torch.models.graph.NamedGraph` of
three blocks, ``embed``, ``stages`` and ``z``, so the trainer, the
weight bridge and the sharding rules take it as they take any graph:
pass the trainer ``param_rules=PIPELINE_STAGE_RULES`` and a mesh with a
``pipe`` axis, and the stacked stage parameters shard one stage a rank.
The ``stages`` block (:class:`StackedStages`) holds every parameter of
one stage with a leading stacked dim of ``n_stages`` — the layout of the
JAX package's ``vmap``-ed stage init, ``stages/params/layer{i}/...`` —
and its blocks are the port's :class:`~mmlspark_tpu_torch.models.
transformer.Block` with ``"dense"`` attention, as the JAX stage builds
them. No Pallas kernel stands behind this path in either framework.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.func import functional_call

from mmlspark_tpu_torch.core.exceptions import FriendlyError, ParamError
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.registry import register_model
from mmlspark_tpu_torch.models.transformer import (
    DENSE,
    Block,
    LMHead,
    TokenPosEmbed,
)
from mmlspark_tpu_torch.parallel.mesh import PIPELINE_AXIS, mesh_shape

_log = get_logger("models.pipelined")


class _Stage(nn.Module):
    """One pipeline stage: ``layers`` consecutive transformer Blocks
    (flax's ``layer{i}``), dense attention."""

    def __init__(self, layers: int, heads: int, head_dim: int, d_ff: int,
                 causal: bool):
        super().__init__()
        for i in range(layers):
            self.add_module(f"layer{i}", Block(
                heads * head_dim, heads, head_dim, d_ff, causal,
                attn_impl=DENSE))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


def pick_microbatches(batch: int, n_stages: int,
                      n_microbatches: int) -> int | None:
    """Largest microbatch count <= ``n_microbatches`` that divides
    ``batch`` and is a stage-count multiple; None when the pipeline
    schedule cannot run (the stages then run one after another)."""
    for m in range(min(n_microbatches, batch), 0, -1):
        if batch % m == 0 and m % n_stages == 0:
            return m
    if batch >= n_stages:
        _log.warning(
            "batch %d not divisible into %d-stage microbatches; running "
            "stages sequentially (no pipelining) — pick a batch size "
            "divisible by n_microbatches (%d)",
            batch, n_stages, n_microbatches,
        )
    return None


class StackedStages(nn.Module):
    """The ``stages`` block: ``n_stages`` copies of one :class:`_Stage`,
    every parameter stacked on a leading dim. The forward runs the
    microbatched pipeline over ``mesh``, or the stages one after another
    when the batch cannot be microbatched (tiny probes, a batch smaller
    than the stage count)."""

    #: the weight bridge and the initialiser treat dim 0 as the stage dim
    stacked = True

    def __init__(self, stage: _Stage, n_stages: int, n_microbatches: int,
                 mesh: Any):
        super().__init__()
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.mesh = mesh
        # the module the stage function runs, kept out of the module tree
        # (its parameters are the per-stage slices, passed per call)
        self.__dict__["template"] = stage
        for name, child in stage.named_children():
            self.add_module(name, copy.deepcopy(child))
        for path, p in list(self.named_parameters()):
            owner_path, _, leaf = path.rpartition(".")
            self.get_submodule(owner_path).register_parameter(
                leaf, nn.Parameter(torch.empty((n_stages, *p.shape),
                                               device="meta"),
                                   requires_grad=False))

    def _stage_fn(self, params: dict, x):
        return functional_call(self.template, params, (x,), strict=True)

    def forward(self, x):
        stacked = dict(self.named_parameters())
        b = x.shape[0]
        m = pick_microbatches(b, self.n_stages, self.n_microbatches)
        from mmlspark_tpu_torch.parallel.pipeline import pipeline_apply

        if self.n_stages > 1 and next(iter(stacked.values())).shape[0] == 1:
            # the mesh trainer's layout under PIPELINE_STAGE_RULES: this
            # rank's stage alone, run in the schedule (one microbatch when
            # the batch cannot be microbatched: the stages in turn)
            m = m or 1
            mb = x.reshape(m, b // m, *x.shape[1:])
            out = pipeline_apply(self._stage_fn, stacked, mb, self.mesh,
                                 local_stage=True)
            return out.reshape(b, *out.shape[2:])
        if m is None:
            # no valid microbatching for this batch: the same math, no
            # pipeline
            for i in range(self.n_stages):
                x = self._stage_fn({k: v[i] for k, v in stacked.items()}, x)
            return x
        mb = x.reshape(m, b // m, *x.shape[1:])
        out = pipeline_apply(self._stage_fn, stacked, mb, self.mesh)
        return out.reshape(b, *out.shape[2:])


@dataclass(eq=False)
class PipelinedGraph(NamedGraph):
    """A :class:`NamedGraph` whose trunk runs as a device pipeline.

    Variables layout: ``{"embed": ..., "stages": ..., "z": ...}``, where
    every ``stages`` leaf carries a leading stacked dim of ``n_stages``."""

    n_stages: int = 1
    n_microbatches: int = 1
    mesh: Any = None

    def _pick_microbatches(self, batch: int) -> int | None:
        """Largest microbatch count <= ``n_microbatches`` that divides
        ``batch`` and is a stage-count multiple; None when the pipeline
        schedule cannot run (falls back to sequential stages)."""
        return pick_microbatches(batch, self.n_stages, self.n_microbatches)


@register_model("transformer_lm_pipelined")
def transformer_lm_pipelined(
    vocab_size: int = 1024,
    d_model: int = 128,
    heads: int = 4,
    depth: int = 4,
    d_ff: int = 0,
    max_len: int = 512,
    causal: bool = True,
    mesh: Any = None,
    n_stages: int | None = None,
    n_microbatches: int | None = None,
) -> PipelinedGraph:
    """Decoder-only LM whose blocks run pipeline-parallel over the
    ``pipe`` axis of ``mesh`` (a
    :func:`~mmlspark_tpu_torch.parallel.mesh.make_mesh` DeviceMesh).
    ``depth`` must divide evenly into ``n_stages`` (default: the mesh's
    pipe-axis size)."""
    shape = mesh_shape(mesh) if mesh is not None else {}
    if PIPELINE_AXIS not in shape:
        raise FriendlyError(
            "transformer_lm_pipelined needs a mesh with a "
            f"'{PIPELINE_AXIS}' axis"
        )
    if d_model % heads:
        raise ParamError(f"d_model {d_model} not divisible by heads {heads}")
    n_stages = n_stages or shape[PIPELINE_AXIS]
    if n_stages != shape[PIPELINE_AXIS]:
        raise FriendlyError(
            f"n_stages {n_stages} != mesh '{PIPELINE_AXIS}' size "
            f"{shape[PIPELINE_AXIS]}"
        )
    if depth % n_stages:
        raise ParamError(
            f"depth {depth} not divisible by {n_stages} pipeline stages"
        )
    if n_microbatches is not None and (
        n_microbatches <= 0 or n_microbatches % n_stages
    ):
        raise ParamError(
            f"n_microbatches {n_microbatches} must be a positive multiple "
            f"of the pipeline depth {n_stages}"
        )
    d_ff = d_ff or 4 * d_model
    n_micro = n_microbatches or n_stages
    with torch.device("meta"):
        stage = _Stage(depth // n_stages, heads, d_model // heads, d_ff,
                       causal)
        blocks: list[tuple[str, nn.Module]] = [
            ("embed", TokenPosEmbed(vocab_size, d_model, max_len)),
            ("stages", StackedStages(stage, n_stages, n_micro, mesh)),
            (FINAL_NODE, LMHead(d_model, vocab_size)),
        ]
    return PipelinedGraph(
        name="transformer_lm_pipelined",
        blocks=blocks,
        input_shape=(max_len,),
        extra={"vocab_size": vocab_size, "causal": causal},
        n_stages=n_stages,
        n_microbatches=n_micro,
        mesh=mesh,
    )
