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
``distribute_tensor``. The trainer's mesh mode stores each rank's part of
a sharded leaf by these layouts and gathers the whole for its step
(``train/distributed.py``); the engine's waits for ROADMAP.md Queue 1
item 13e.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Sequence

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
                  mesh) -> tuple:
    """Resolve the spec (one mesh axis name or None per leading dim) for
    one param path; unmatched or mesh-incompatible rules fall back to
    replication per-axis."""
    shape = mesh_shape(mesh)
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(
                a if (a is None or (a in shape and shape[a] > 1)) else None
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


def _resolve(path: str, flax_shape: tuple, mesh, rules) -> tuple:
    """The JAX package's spec for a leaf of ``flax_shape``: dims that a
    rule would shard unevenly degrade to replicated."""
    shape = mesh_shape(mesh)
    axes = []
    for i, a in enumerate(spec_for_path(path, rules, mesh)):
        if a is not None and (
            i >= len(flax_shape) or flax_shape[i] % shape[a]
        ):
            a = None
        axes.append(a)
    return tuple(axes)


def _one(path: str, leaf, perm, mesh, rules) -> NamedSharding:
    port_shape = tuple(leaf.shape)
    flax_shape = port_shape
    if perm is not None and len(perm) == len(port_shape):
        flax_shape = tuple(port_shape[perm.index(j)]
                           for j in range(len(perm)))
    else:
        perm = None
    flax_spec = _resolve(path, flax_shape, mesh, rules)
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
                          graph=None) -> dict:
    """A dict of :class:`NamedSharding` shaped like ``params``; dims that
    a rule would shard unevenly degrade to replicated (the JAX package's
    even-tiling rule). ``params`` is the port's variables with ``graph``
    (paths and layouts through the bridge), or a nested mapping keyed by
    the flax names without it."""
    rules = rules or []
    return _nest((keys, _one(path, leaf, perm, mesh, rules))
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
