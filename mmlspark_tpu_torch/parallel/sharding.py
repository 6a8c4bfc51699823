"""Parameter sharding rules: param-path regex -> spec — the port of
``mmlspark_tpu/parallel/sharding.py``.

A rule set is an ordered list of ``(regex, spec_tuple)``; the first regex
matching the '/'-joined param path wins. Spec axis names not present in
the target mesh (or of size 1) degrade to replicated, so one rule set
serves data-only meshes and dp×tp meshes unchanged.

Rules key on the JAX package's parameter paths (``block0/params/attn/
qkv/kernel``). The port's parameters reach them through the weight
bridge (:func:`~mmlspark_tpu_torch.models.bridge.flax_param_path`), which
also gives the axis permutation between a flax leaf and the port's
(a Dense kernel is (in, out) in flax and (out, in) here), so one rule
table serves both frameworks: the spec is resolved in the flax leaf's
axes, exactly as the JAX package does, then carried to the port's axes.

A resolved spec becomes DTensor placements (:class:`NamedSharding`'s
``placements``) and :func:`shard_params` places each leaf with
``distribute_tensor``. The serving engine's and the trainer's mesh modes
split the COMPUTE by them (:func:`model_split`, :func:`split_leaves`,
:func:`local_variables`): each ``model`` rank keeps only its shard of
every split leaf and the forward (and, training, its backward) runs on
it (``models/transformer.py``'s split forward), as Megatron and GSPMD
do. The trainer gathers for its step only the sharded leaves that no
split computes on (``train/distributed.py``).

One deliberate difference from a contiguous split: the fused ``qkv``
kernel and bias are laid out ``[q heads | k heads | v heads]``, so the
JAX rule ``qkv/kernel -> (None, model)`` read as a contiguous column
split would give rank 0 only q heads (GSPMD then moves data to repair
the reshape). The port splits ``qkv`` HEAD-ALIGNED: each rank takes its
q heads, and the k and v heads those q heads read — split over
``model`` when ``kv_heads % model == 0``, else (``model % kv_heads ==
0``) the one kv head a rank's q heads share, which is replicated on the
ranks that read it.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from dataclasses import dataclass, replace
from typing import Any, Sequence

import torch

from mmlspark_tpu_torch.parallel.mesh import MODEL_AXIS, mesh_shape

#: Megatron-style rules for the transformer family
#: (models/transformer.py): column-parallel into attention/MLP, row-parallel
#: out of them. The embedding/unembed/norm tails are explicit: the token
#: embedding shards its vocab rows and the lm_head its vocab columns over
#: the model axis (the vocab-parallel pair), while norms, row-parallel
#: output biases and the learned position table replicate by design.
#: :func:`unmatched_param_paths` audits that a model's whole tree is
#: covered.
TRANSFORMER_TP_RULES: list[tuple[str, tuple]] = [
    (r"qkv/kernel$", (None, MODEL_AXIS)),
    (r"attn_out/kernel$", (MODEL_AXIS, None)),
    (r"mlp_in/kernel$", (None, MODEL_AXIS)),
    (r"mlp_out/kernel$", (MODEL_AXIS, None)),
    (r"qkv/bias$", (MODEL_AXIS,)),
    (r"mlp_in/bias$", (MODEL_AXIS,)),
    # embedding / unembed (vocab-parallel pair)
    (r"token/embedding$", (MODEL_AXIS, None)),
    (r"head/kernel$", (None, MODEL_AXIS)),
    (r"head/bias$", (MODEL_AXIS,)),
    # explicitly replicated: norms, row-parallel biases, position table
    (r"(ln1|ln2|ln_f)/(scale|bias)$", ()),
    (r"attn_out/bias$", ()),
    (r"mlp_out/bias$", ()),
    (r"embed/params/pos$", ()),
]


def spec_for_path(path: str, rules: Sequence[tuple[str, tuple]],
                  mesh, keep_unit_axes: bool = False) -> tuple:
    """Resolve the spec (one mesh axis name or None per leading dim) for
    one param path; unmatched or mesh-incompatible rules fall back to
    replication per-axis — axes of one rank too, unless
    ``keep_unit_axes`` (the serving split, whose one-rank model axis
    runs the split forward with the whole)."""
    shape = mesh_shape(mesh)
    low = 0 if keep_unit_axes else 1
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(
                a if (a is None or (a in shape and shape[a] > low)) else None
                for a in spec
            )
    return ()


@dataclass(frozen=True)
class NamedSharding:
    """One parameter's layout on ``mesh``: ``spec[i]`` is the mesh axis
    the tensor's dim ``i`` splits over (None: whole; dims past the spec
    whole too). ``flax_path`` and ``flax_spec`` are the rule's view: the
    JAX package's path of the leaf and its spec in the flax leaf's axes,
    which equals the JAX package's ``NamedSharding.spec``."""

    mesh: Any
    spec: tuple
    flax_path: str
    flax_spec: tuple

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        return tuple(
            Shard(self.spec.index(name)) if name in self.spec
            else Replicate()
            for name in self.mesh.mesh_dim_names
        )


def _resolve(path: str, flax_shape: tuple, mesh, rules,
             keep_unit_axes: bool = False) -> tuple:
    """The JAX package's spec for a leaf of ``flax_shape``: dims that a
    rule would shard unevenly degrade to replicated."""
    shape = mesh_shape(mesh)
    axes = []
    for i, a in enumerate(spec_for_path(path, rules, mesh, keep_unit_axes)):
        if a is not None and (
            i >= len(flax_shape) or flax_shape[i] % shape[a]
        ):
            a = None
        axes.append(a)
    return tuple(axes)


def _one(path: str, leaf, perm, mesh, rules,
         keep_unit_axes: bool = False) -> NamedSharding:
    port_shape = tuple(leaf.shape)
    flax_shape = port_shape
    if perm is not None and len(perm) == len(port_shape):
        flax_shape = tuple(port_shape[perm.index(j)]
                           for j in range(len(perm)))
    else:
        perm = None
    flax_spec = _resolve(path, flax_shape, mesh, rules, keep_unit_axes)
    spec = flax_spec
    if perm is not None and flax_spec:
        padded = flax_spec + (None,) * (len(perm) - len(flax_spec))
        spec = tuple(padded[j] for j in perm)
    return NamedSharding(mesh, spec, path, flax_spec)


def _walk(params, graph):
    """Yield ``(keys, flax_path, permutation, leaf)`` for every tensor:
    through the bridge when ``graph`` is given (the port's ``{block:
    {key: tensor}}``), else with the nested keys as the path."""
    if graph is None:
        def rec(node, keys):
            if isinstance(node, Mapping):
                for k, v in node.items():
                    yield from rec(v, keys + (k,))
            else:
                yield keys, "/".join(map(str, keys)), None, node

        yield from rec(params, ())
        return
    from mmlspark_tpu_torch.models.bridge import flax_param_path

    for name, mod in graph.blocks:
        for key, leaf in params.get(name, {}).items():
            path, perm = flax_param_path(name, mod, key)
            if isinstance(leaf, Mapping):  # a weight-quantized leaf
                for sub, t in leaf.items():
                    yield (name, key, sub), f"{path}/{sub}", perm, t
            else:
                yield (name, key), path, perm, leaf


def _nest(items) -> dict:
    out: dict = {}
    for keys, value in items:
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return out


def build_param_shardings(params, mesh,
                          rules: Sequence[tuple[str, tuple]] | None,
                          graph=None, keep_unit_axes: bool = False) -> dict:
    """A dict of :class:`NamedSharding` shaped like ``params``; dims that
    a rule would shard unevenly degrade to replicated (the JAX package's
    even-tiling rule). ``params`` is the port's variables with ``graph``
    (paths and layouts through the bridge), or a nested mapping keyed by
    the flax names without it. ``keep_unit_axes`` keeps a one-rank axis
    in the specs (see :func:`spec_for_path`)."""
    rules = rules or []
    return _nest((keys, _one(path, leaf, perm, mesh, rules, keep_unit_axes))
                 for keys, path, perm, leaf in _walk(params, graph))


def shard_params(params, mesh, rules=None, graph=None) -> dict:
    """``distribute_tensor`` every leaf by the rules: each rank keeps its
    shard as a DTensor (rank 0's values are the ones placed)."""
    from torch.distributed.tensor import distribute_tensor

    shardings = build_param_shardings(params, mesh, rules, graph)

    def place(keys, leaf):
        sh = shardings
        for k in keys:
            sh = sh[k]
        return distribute_tensor(leaf, mesh, sh.placements)

    return _nest((keys, place(keys, leaf))
                 for keys, _, _, leaf in _walk(params, graph))


def unmatched_param_paths(params, rules: Sequence[tuple[str, tuple]],
                          graph=None) -> list[str]:
    """Param paths in ``params`` that NO rule matches — the whole-model
    rule-coverage audit in one call. An unmatched param silently
    replicates; an empty list means every param was explicitly
    considered (a rule may still replicate it on purpose)."""
    return sorted(
        path for _, path, _, _ in _walk(params, graph)
        if not any(re.search(pat, path) for pat, _ in rules)
    )


# -- the compute split over ``model`` ---------------------------------------


@dataclass(frozen=True)
class ModelSplit:
    """How a transformer's compute splits over a mesh's ``model`` axis
    on the calling rank (:func:`model_split`; the serving engine's and
    the trainer's mesh modes). ``attn``, ``mlp`` and
    ``vocab`` say which layers split (each degrades to replicated as a
    whole when its leaves do not tile); the head ranges are the rank's
    q heads and the kv heads they read."""

    size: int
    index: int
    heads: int
    kv_heads: int
    head_dim: int
    attn: bool
    mlp: bool
    vocab: bool

    @property
    def local_heads(self) -> int:
        return self.heads // self.size if self.attn else self.heads

    @property
    def q_start(self) -> int:
        return self.index * self.local_heads if self.attn else 0

    @property
    def kv_range(self) -> tuple[int, int]:
        """The kv heads this rank's q heads read: ``[lo, hi)``."""
        if not self.attn:
            return 0, self.kv_heads
        group = self.heads // self.kv_heads
        lo = self.q_start // group
        hi = (self.q_start + self.local_heads - 1) // group + 1
        return lo, hi

    @property
    def local_kv_heads(self) -> int:
        lo, hi = self.kv_range
        return hi - lo

    @property
    def kv_share(self) -> int:
        """How many ``model`` ranks hold each of this rank's kv heads: 1
        when the kv heads split over ``model``, ``model / kv_heads``
        when ``model`` exceeds them (each rank then holds the one kv
        head its q heads share)."""
        return max(self.size // self.kv_heads, 1) if self.attn else 1

    def qkv_rows(self, device) -> torch.Tensor:
        """The rows of the fused ``[q | k | v]`` projection this rank
        keeps: its q heads, then its k heads, then its v heads."""
        d, h, hk = self.head_dim, self.heads, self.kv_heads
        lo, hi = self.kv_range
        q0 = self.q_start
        rows = [torch.arange(q0 * d, (q0 + self.local_heads) * d),
                torch.arange((h + lo) * d, (h + hi) * d),
                torch.arange((h + hk + lo) * d, (h + hk + hi) * d)]
        return torch.cat(rows).to(device)


#: the leaves each layer's split cuts (the keys of a transformer block)
_SPLIT_LEAVES = {
    "attn": ("attn.qkv.weight", "attn.qkv.bias", "attn.attn_out.weight"),
    "mlp": ("mlp_in.weight", "mlp_in.bias", "mlp_out.weight"),
}


def model_split(graph, variables: dict, place,
                rules: Sequence[tuple[str, tuple]] | None = None
                ) -> ModelSplit:
    """The compute split of ``graph`` (a transformer LM: dense or MoE
    blocks) on ``place``'s ``model`` axis (a ``parallel.mesh.
    ModelPlace``), by ``rules`` (default ``TRANSFORMER_TP_RULES``)
    through :func:`build_param_shardings` (a one-rank axis kept, so it
    runs the split forward with the whole). A layer splits when the
    rules shard every leaf it cuts over ``model`` and those leaves tile
    evenly; attention also needs whole heads on each rank and
    ``kv_heads % model == 0`` or ``model % kv_heads == 0``."""
    heads = int(graph.extra["heads"])
    hk = int(graph.extra.get("kv_heads") or heads)
    m = place.model_size
    if place.model is None:
        flags = dict.fromkeys(("attn", "mlp", "vocab"), False)
    else:
        sh = build_param_shardings(
            variables, place.mesh,
            TRANSFORMER_TP_RULES if rules is None else rules, graph,
            keep_unit_axes=True)

        def split(block: str, key: str) -> bool:
            leaf = sh.get(block, {}).get(key)
            return leaf is not None and MODEL_AXIS in leaf.spec

        flags = {}
        for layer, keys in _SPLIT_LEAVES.items():
            owners = [name for name, _ in graph.blocks
                      if keys[0] in variables.get(name, {})]
            flags[layer] = bool(owners) and all(
                split(name, k) for name in owners for k in keys
                if k in variables[name])
        flags["attn"] = flags["attn"] and heads % m == 0 and (
            hk % m == 0 or m % hk == 0)
        embed, head = graph.blocks[0][0], graph.blocks[-1][0]
        flags["vocab"] = (split(embed, "token.weight")
                          and split(head, "head.weight")
                          and split(head, "head.bias"))
    d = None
    for name, _ in graph.blocks:
        w = variables.get(name, {}).get("attn.qkv.weight")
        if w is not None:
            d = int(w.shape[0]) // (heads + 2 * hk)
            break
    return ModelSplit(m, place.model_index, heads, hk, d, **flags)


def split_leaves(graph, variables: dict, split: ModelSplit) -> dict:
    """``(block, key) -> how`` for every leaf of ``variables`` that
    ``split`` cuts: ``"qkv"`` (the head-aligned rows of
    :meth:`ModelSplit.qkv_rows`) or the dim whose contiguous chunk the
    rank keeps. Leaves that stay whole are absent."""
    embed, head = graph.blocks[0][0], graph.blocks[-1][0]
    vocab_leaves = {(embed, "token.weight"), (head, "head.weight"),
                    (head, "head.bias")}
    out = {}
    for name, block in variables.items():
        for key in block:
            leaf = key.rsplit(".", 1)[-1]
            owner = key[: len(key) - len(leaf) - 1]
            if split.attn and owner.endswith("qkv"):
                out[(name, key)] = "qkv"
            elif split.attn and owner.endswith("attn_out") \
                    and leaf == "weight":
                out[(name, key)] = 1  # the rank's heads' columns
            elif split.mlp and owner == "mlp_in":
                out[(name, key)] = 0
            elif split.mlp and owner == "mlp_out" and leaf == "weight":
                out[(name, key)] = 1
            elif split.vocab and (name, key) in vocab_leaves:
                out[(name, key)] = 0
    return out


def cut_leaf(split: ModelSplit, how, t: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole leaf ``t`` (a new compact tensor),
    cut as :func:`split_leaves` says."""
    if how == "qkv":
        return t.index_select(0, split.qkv_rows(t.device))
    return t.chunk(split.size, dim=how)[split.index].contiguous()


def join_leaf(split: ModelSplit, how, parts: list) -> torch.Tensor:
    """The whole leaf from every ``model`` rank's part, in rank order:
    the inverse of :func:`cut_leaf` (a kv head's rows that several ranks
    hold are taken from the last of them; the ranks hold them equal)."""
    if how != "qkv":
        return torch.cat(parts, dim=how)
    rows = (split.heads + 2 * split.kv_heads) * split.head_dim
    whole = parts[0].new_empty((rows, *parts[0].shape[1:]))
    for r, part in enumerate(parts):
        whole.index_copy_(0, replace(split, index=r).qkv_rows(part.device),
                          part)
    return whole


def local_variables(graph, variables: dict, split: ModelSplit) -> dict:
    """This rank's shards of ``variables`` under ``split``: the split
    layers' leaves cut to the rank's part (``qkv`` head-aligned, the
    rest by the rules' dims), every other leaf whole. Cut leaves are new
    compact tensors; whole ones are the same tensors."""
    how = split_leaves(graph, variables, split)
    return {name: {key: cut_leaf(split, how[(name, key)], t)
                   if (name, key) in how else t
                   for key, t in block.items()}
            for name, block in variables.items()}
