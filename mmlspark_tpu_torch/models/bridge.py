"""Weights for the port's graphs: the JAX package's flax variables carried
across (:func:`load_flax_variables`), or the port's own seeded
initialisation (:func:`init_variables`).

Both return ``{block name: {parameter name: tensor}}`` in each block's
``state_dict`` layout, which :meth:`NamedGraph.bind` assigns into the
blocks. The flax side is keyed as flax keys it, e.g. for
``transformer_lm``::

    embed/params/token/embedding        -> embed["token.weight"]
    embed/params/pos                    -> embed["pos"]
    block{i}/params/ln1/{scale,bias}    -> block{i}["ln1.{weight,bias}"]
    block{i}/params/attn/qkv/kernel     -> block{i}["attn.qkv.weight"] (T)
    block{i}/params/mlp_in/bias         -> block{i}["mlp_in.bias"]
    z/params/head/kernel                -> z["head.weight"] (T)

and for ``mlp``, ``hidden{i}/params/Dense_0/kernel`` -> ``hidden{i}[
"Dense_0.weight"]`` (T); an MLP block that has no input width yet takes
it from that kernel's rows. The ResNets (``models/resnet.py``)::

    stage2/params/ResBlock_0/ConvBN_0/Conv_0/kernel
        -> stage2["ResBlock_0.ConvBN_0.Conv_0.weight"]  (HWIO -> OIHW)
    .../BatchNorm_0/{scale,bias}         -> "...BatchNorm_0.{weight,bias}"
    stage2/batch_stats/.../BatchNorm_0/{mean,var}
                                         -> "...BatchNorm_0.{mean,var}"

(the statistics come from flax's ``batch_stats`` collection, everything
else from ``params``), and the BiLSTM tagger (``models/bilstm.py``)::

    bilstm/params/OptimizedLSTMCell_0/i{i,f,g,o}/kernel
        -> bilstm["weight_ih"]   (the four (E, H) kernels side by side, T)
    bilstm/params/OptimizedLSTMCell_0/h{i,f,g,o}/kernel -> "weight_hh" (T)
    bilstm/params/OptimizedLSTMCell_0/h{i,f,g,o}/bias   -> "bias_hh"
    bilstm/params/OptimizedLSTMCell_1/...  -> the same names + "_reverse"

and the switch-MoE LM (``models/moe.py``), whose MoE leaves keep flax's
layout (untransposed; ``ln1``, ``ln2`` and ``attn`` as in
``transformer_lm``)::

    block{i}/params/moe/gate                -> block{i}["moe.gate"] (D, E)
    block{i}/params/moe/experts/w_in        -> "moe.experts.w_in"  (E, D, F)
    block{i}/params/moe/experts/{b_in,w_out,b_out}
                                            -> "moe.experts.{...}"

The pipelined LM (``models/pipelined.py``) keeps flax's vmapped stage
layout: every ``stages/params/layer{i}/...`` leaf carries a leading
``n_stages`` dim, and each stage's slice changes layout as above
(``stages["layer{i}.attn.qkv.weight"]`` is (n_stages, out, in)).

A flax Dense ``kernel`` is (in, out); the port's weight is (out, in), so
it is transposed on the way in, and a flax Conv ``kernel`` (kh, kw, in,
out) becomes the port's (out, in, kh, kw). Weight-quantized flax
variables (``mmlspark_tpu/ops/quantize.py``: ``{__w8__: int8,
__w8_scale__: f32}`` in place of a float leaf) cross too: the int8
payload takes the float leaf's layout change, and the scale keeps its
values (one per flax output channel, the last axis), shaped to broadcast
against the port's payload (``ops/quantize.py``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.bilstm import DIRECTIONS, GATES, BiLSTM
from mmlspark_tpu_torch.models.moe import ExpertParams, MoEFFN
from mmlspark_tpu_torch.models.resnet import BatchNorm, Conv
from mmlspark_tpu_torch.models.transformer import Dense
from mmlspark_tpu_torch.ops.quantize import _Q8, _SCALE

#: port leaf name -> flax leaf name, by the kind of module that owns it
_LEAVES = {
    Dense: {"weight": "kernel", "bias": "bias"},
    nn.LayerNorm: {"weight": "scale", "bias": "bias"},
    nn.Embedding: {"weight": "embedding"},
    Conv: {"weight": "kernel"},
    BatchNorm: {"weight": "scale", "bias": "bias"},
}
#: the leaves flax keeps in its ``batch_stats`` collection
_STATS = {BatchNorm: ("mean", "var")}


def _owner_and_leaf(mod: nn.Module, key: str):
    path, _, leaf = key.rpartition(".")
    owner = mod.get_submodule(path) if path else mod
    return path, owner, leaf


def _layout(owner: nn.Module, leaf: str) -> str:
    """How a port leaf's layout relates to its flax leaf's: ``dense`` (a
    2-D transpose), ``conv`` (HWIO -> OIHW) or ``same``."""
    if isinstance(owner, Dense) and leaf == "weight" or \
            isinstance(owner, BiLSTM) and leaf.startswith("weight"):
        return "dense"
    if isinstance(owner, Conv) and leaf == "weight":
        return "conv"
    return "same"


def flax_channel_axis(mod: nn.Module, key: str, ndim: int) -> int:
    """The axis of block ``mod``'s parameter ``key`` (``ndim`` dims) that
    is its flax leaf's LAST axis — the axis flax's int8 quantization keeps
    one scale per index of: axis 0 of a Dense, LSTM or Conv weight, the
    last axis of a leaf held in flax's layout."""
    _, owner, leaf = _owner_and_leaf(mod, key)
    return ndim - 1 if _layout(owner, leaf) == "same" else 0


def _to_port_layout(arr: np.ndarray, layout: str) -> np.ndarray:
    if layout == "dense":
        return arr.T
    if layout == "conv":
        return arr.transpose(3, 2, 0, 1)
    return arr


def _port_leaf(node, layout: str, dev, stacked: bool = False):
    """A flax leaf (float, or ``{__w8__, __w8_scale__}``) as the port's
    tensor (or quantized dict) on ``dev``; a ``stacked`` leaf (a leading
    stage dim) changes layout stage by stage."""
    if stacked:
        arr = np.array(node, dtype=np.float32)
        arr = np.stack([_to_port_layout(a, layout) for a in arr])
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    if not (isinstance(node, Mapping) and _Q8 in node and _SCALE in node):
        arr = _to_port_layout(np.array(node, dtype=np.float32), layout)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    q = np.array(node[_Q8], dtype=np.int8)
    scale = np.array(node[_SCALE], dtype=np.float32).reshape(-1)
    if q.ndim < 2 or scale.size != q.shape[-1]:
        raise FriendlyError(
            f"a quantized flax leaf of payload {q.shape} and scale "
            f"{scale.shape} is not a per-output-channel leaf"
        )
    q = _to_port_layout(q, layout)
    shape = [1] * q.ndim
    shape[0 if layout != "same" else -1] = scale.size
    return {
        _Q8: torch.from_numpy(np.ascontiguousarray(q)).to(dev),
        _SCALE: torch.from_numpy(scale.reshape(shape)).to(dev),
    }


def _lookup(tree, parts: list, what: str):
    node = tree
    for part in parts:
        if not isinstance(node, Mapping) or part not in node:
            raise FriendlyError(
                f"flax variables lack '{'/'.join(parts)}' ({what})")
        node = node[part]
    return node


def _lstm_node(cell, leaf: str):
    """One packed LSTM leaf from flax's per-gate cell leaves: the four
    gates' kernels side by side ((in, 4H), transposed later), or their
    hidden biases end to end."""
    kind, side = ("bias", "h") if leaf == "bias_hh" else (
        "kernel", "i" if leaf == "weight_ih" else "h")
    parts = [_lookup(cell, [side + g, kind], f"LSTM gate {side}{g}")
             for g in GATES]
    if all(isinstance(p, Mapping) and _Q8 in p for p in parts):
        return {_Q8: np.concatenate([np.asarray(p[_Q8]) for p in parts],
                                    axis=-1),
                _SCALE: np.concatenate([np.asarray(p[_SCALE]).reshape(-1)
                                        for p in parts])}
    return np.concatenate([np.asarray(p, dtype=np.float32) for p in parts],
                          axis=-1)


def _flax_node(block_vars, name: str, mod: nn.Module, key: str):
    """The flax leaf (or quantized dict) behind port parameter
    ``name.key``, and its layout."""
    path, owner, leaf = _owner_and_leaf(mod, key)
    parts = path.split(".") if path else []
    what = f"port parameter '{name}.{key}'"
    if isinstance(owner, BiLSTM):
        base, sfx = leaf, ""
        if leaf.endswith("_reverse"):
            base, sfx = leaf[: -len("_reverse")], "_reverse"
        cell = _lookup(block_vars, ["params", *parts, DIRECTIONS[sfx]],
                       what)
        return _lstm_node(cell, base), _layout(owner, leaf)
    coll = "batch_stats" if leaf in _STATS.get(type(owner), ()) \
        else "params"
    flax_leaf = _LEAVES.get(type(owner), {}).get(leaf, leaf)
    node = _lookup(block_vars, [coll, *parts, flax_leaf], what)
    return node, _layout(owner, leaf)


#: port axis i of a leaf holds its flax leaf's axis ``perm[i]``, by layout
_PERMUTATIONS = {"dense": (1, 0), "conv": (3, 2, 0, 1)}


def flax_param_path(name: str, mod: nn.Module, key: str):
    """The '/'-joined path of the flax leaf behind port parameter
    ``name.key`` of block ``mod`` — the path the JAX package's sharding
    rules match, e.g. ``block0/params/attn/qkv/kernel`` — and the axis
    permutation between the two layouts (port axis ``i`` is flax axis
    ``perm[i]``; ``None`` when they agree). A packed LSTM leaf, which
    stands for four flax kernels, is named after its cell."""
    path, owner, leaf = _owner_and_leaf(mod, key)
    parts = path.split(".") if path else []
    layout = _layout(owner, leaf)
    if isinstance(owner, BiLSTM):
        sfx = "_reverse" if leaf.endswith("_reverse") else ""
        flax_leaf = [DIRECTIONS[sfx], leaf[: len(leaf) - len(sfx)]]
        coll = "params"
    else:
        coll = "batch_stats" if leaf in _STATS.get(type(owner), ()) \
            else "params"
        flax_leaf = [_LEAVES.get(type(owner), {}).get(leaf, leaf)]
    perm = _PERMUTATIONS.get(layout)
    if perm is not None and getattr(mod, "stacked", False):
        perm = (0, *(p + 1 for p in perm))
    return "/".join([name, coll, *parts, *flax_leaf]), perm


def load_flax_variables(graph, variables, *, device=None,
                        mesh=None) -> dict:
    """The port's variables from the JAX package's ``variables`` (a
    nested dict of numpy or numpy-convertible arrays, float or
    weight-quantized, with flax's ``batch_stats`` where a block keeps
    statistics), on ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``). A graph that is not made of blocks (an imported ONNX
    graph) converts its own through ``from_flax_variables``. With a
    serving ``mesh`` (see :func:`variables_to`) the result is the calling
    rank's shards."""
    own = getattr(graph, "from_flax_variables", None)
    if own is not None:
        return own(variables, device=device)
    if mesh is not None:
        return variables_to(load_flax_variables(graph, variables,
                                                device=device),
                            default_device(device), graph=graph, mesh=mesh)
    dev = default_device(device)
    out = {}
    for name, mod in graph.blocks:
        block_vars = variables.get(name) if isinstance(variables, Mapping) \
            else None
        has_params = isinstance(block_vars, Mapping) and "params" in block_vars
        if has_params and hasattr(mod, "size_from_flax"):
            mod.size_from_flax(block_vars["params"])
        refs = mod.state_dict()
        if not refs and getattr(mod, "sized", True):
            out[name] = {}  # a block without variables (the global pool)
            continue
        if not has_params:
            raise FriendlyError(
                f"flax variables lack '{name}/params' for graph "
                f"'{graph.name}'"
            )
        block = {}
        for key, ref in refs.items():
            node, layout = _flax_node(block_vars, name, mod, key)
            block[key] = _port_leaf(node, layout, dev,
                                    getattr(mod, "stacked", False))
            got = block[key][_Q8] if isinstance(block[key], dict) \
                else block[key]
            _check_shape(name, key, got.shape, ref)
        out[name] = block
    return out


def _check_shape(name: str, key: str, shape, ref) -> None:
    if tuple(shape) != tuple(ref.shape):
        raise FriendlyError(
            f"'{name}.{key}': flax shape {tuple(shape)} does not match the "
            f"port's {tuple(ref.shape)}"
        )


def init_variables(graph, seed: int = 0, *, device=None,
                   generator: torch.Generator | None = None) -> dict:
    """The port's own seeded initialisation, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (so a seed gives the same
    weights on every device) and moved to ``device`` — or, with
    ``generator``, drawn from that generator on its own device (one seed
    then gives other weights on the card than on the CPU, made without a
    host copy): Dense, Conv and LSTM weights and
    embeddings ``N(0, 1/fan_in)``, the MoE router and expert weights
    ``N(0, 1/fan_in)`` over their second-last axis (biases 0), learned
    positions ``N(0, 0.02^2)``,
    LayerNorm and BatchNorm scales 1, biases 0, BatchNorm running means 0
    and variances 1 (flax's starting statistics)."""
    dev = default_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(seed)
    draw = {"generator": gen, "device": gen.device}
    out = {}
    for name, mod in graph.blocks:
        if not getattr(mod, "sized", True):
            raise FriendlyError(
                f"block '{name}' of graph '{graph.name}' has no input width "
                "yet: call graph.size_input(x.shape[1:]) first")
        block = {}
        stacked = getattr(mod, "stacked", False)
        for key, ref in mod.state_dict().items():
            _, owner, leaf = _owner_and_leaf(mod, key)
            shape = tuple(ref.shape)
            if stacked:  # one draw a stage, of the stage's shape
                t = torch.stack([_init_leaf(owner, leaf, shape[1:], draw)
                                 for _ in range(shape[0])])
            else:
                t = _init_leaf(owner, leaf, shape, draw)
            block[key] = t.to(dev)
        out[name] = block
    return out


def _init_leaf(owner: nn.Module, leaf: str, shape: tuple, draw: dict):
    if isinstance(owner, (nn.LayerNorm, BatchNorm)) and \
            leaf in ("weight", "var"):
        return torch.ones(shape)
    if leaf.startswith("bias") or leaf in ("mean", "b_in", "b_out"):
        return torch.zeros(shape)
    if isinstance(owner, (MoEFFN, ExpertParams)):
        return torch.randn(shape, **draw) * shape[-2] ** -0.5
    if isinstance(owner, (Dense, nn.Embedding, Conv, BiLSTM)):
        fan_in = int(np.prod(shape[1:]))
        return torch.randn(shape, **draw) * fan_in ** -0.5
    return torch.randn(shape, **draw) * 0.02  # the learned position table


def variables_to(variables: dict, device, *, graph=None, mesh=None) -> dict:
    """``variables`` on ``device``: the same dict when every tensor is
    already there (so a bound graph stays bound), else a moved copy. A
    weight-quantized leaf (a dict of tensors) moves as a whole.

    With a serving ``mesh`` (a ``parallel.mesh.MeshPlace``, or what
    :func:`~mmlspark_tpu_torch.parallel.mesh.serve_mesh` takes: a spec
    string, an axes mapping or a DeviceMesh) and the ``graph``, the
    result is the calling rank's shards of the float variables
    (``parallel.sharding.local_variables`` under ``model_split``): what
    the rank's copy of the graph for the split forward binds."""
    if mesh is not None:
        from mmlspark_tpu_torch.parallel.mesh import MeshPlace, serve_mesh
        from mmlspark_tpu_torch.parallel.sharding import (
            local_variables,
            model_split,
        )

        place = mesh if isinstance(mesh, MeshPlace) else serve_mesh(mesh)
        whole = variables_to(variables, device)
        return local_variables(graph, whole,
                               model_split(graph, whole, place))
    dev = torch.device(device)
    if all(_on(t, dev) for v in variables.values() for leaf in v.values()
           for t in _tensors(leaf)):
        return variables
    return {n: {k: _leaf_to(leaf, dev) for k, leaf in v.items()}
            for n, v in variables.items()}


def _tensors(leaf):
    return leaf.values() if isinstance(leaf, dict) else (leaf,)


def _leaf_to(leaf, dev):
    if isinstance(leaf, dict):
        return {k: t.to(dev) for k, t in leaf.items()}
    return leaf.to(dev)


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (
        dev.index is None or t.device.index == dev.index
    )
