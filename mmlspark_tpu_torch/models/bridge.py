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

A flax Dense ``kernel`` is (in, out); the port's weight is (out, in), so
it is transposed on the way in. Weight-quantized flax variables
(``mmlspark_tpu/ops/quantize.py``: ``{__w8__: int8, __w8_scale__: f32}``
in place of a float leaf) cross too: the int8 payload is transposed where
the float leaf would be, and the scale keeps its values, shaped to
broadcast against the port's payload (``ops/quantize.py``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.transformer import Dense
from mmlspark_tpu_torch.ops.quantize import _Q8, _SCALE

#: port leaf name -> flax leaf name, by the kind of module that owns it
_LEAVES = {
    Dense: {"weight": "kernel", "bias": "bias"},
    nn.LayerNorm: {"weight": "scale", "bias": "bias"},
    nn.Embedding: {"weight": "embedding"},
}


def _owner_and_leaf(mod: nn.Module, key: str):
    path, _, leaf = key.rpartition(".")
    owner = mod.get_submodule(path) if path else mod
    return path, owner, leaf


def flax_transposed(mod: nn.Module, key: str) -> bool:
    """Whether block ``mod``'s parameter ``key`` is the transpose of its
    flax leaf: a ``Dense`` weight, (out, in) here and (in, out) in flax."""
    _, owner, leaf = _owner_and_leaf(mod, key)
    return isinstance(owner, Dense) and leaf == "weight"


def _quantized_leaf(node, transposed: bool, dev) -> dict:
    """A flax ``{__w8__, __w8_scale__}`` leaf in the port's layout."""
    q = np.array(node[_Q8], dtype=np.int8)
    scale = np.array(node[_SCALE], dtype=np.float32).reshape(-1)
    if q.ndim != 2 or scale.size != q.shape[-1]:
        raise FriendlyError(
            f"a quantized flax leaf of payload {q.shape} and scale "
            f"{scale.shape} is not a 2-D per-output-channel leaf"
        )
    if transposed:
        q, scale = q.T, scale[:, None]
    else:
        scale = scale[None, :]
    return {
        _Q8: torch.from_numpy(np.ascontiguousarray(q)).to(dev),
        _SCALE: torch.from_numpy(np.ascontiguousarray(scale)).to(dev),
    }


def load_flax_variables(graph, variables, *, device=None) -> dict:
    """The port's parameters from the JAX package's ``variables`` (a
    nested dict of numpy or numpy-convertible arrays, float or
    weight-quantized), on ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``)."""
    dev = default_device(device)
    out = {}
    for name, mod in graph.blocks:
        try:
            params = variables[name]["params"]
        except (KeyError, TypeError) as e:
            raise FriendlyError(
                f"flax variables lack '{name}/params' for graph "
                f"'{graph.name}'"
            ) from e
        block = {}
        for key, ref in mod.state_dict().items():
            path, owner, leaf = _owner_and_leaf(mod, key)
            flax_leaf = _LEAVES.get(type(owner), {}).get(leaf, leaf)
            node = params
            for part in (path.split(".") if path else []) + [flax_leaf]:
                if not isinstance(node, Mapping) or part not in node:
                    raise FriendlyError(
                        f"flax variables lack '{name}/params/"
                        f"{'/'.join(path.split('.') if path else [])}"
                        f"/{flax_leaf}' (port parameter '{name}.{key}')"
                    )
                node = node[part]
            transposed = flax_transposed(mod, key)
            if isinstance(node, Mapping) and _Q8 in node and _SCALE in node:
                block[key] = _quantized_leaf(node, transposed, dev)
                _check_shape(name, key, block[key][_Q8].shape, ref)
                continue
            arr = np.array(node, dtype=np.float32)  # an owned copy
            if transposed:
                arr = arr.T
            _check_shape(name, key, arr.shape, ref)
            block[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        out[name] = block
    return out


def _check_shape(name: str, key: str, shape, ref) -> None:
    if tuple(shape) != tuple(ref.shape):
        raise FriendlyError(
            f"'{name}.{key}': flax shape {tuple(shape)} does not match the "
            f"port's {tuple(ref.shape)}"
        )


def init_variables(graph, seed: int = 0, *, device=None) -> dict:
    """The port's own seeded initialisation, drawn on the CPU from a
    ``torch.Generator`` (so a seed gives the same weights on every
    device) and moved to ``device``: Dense weights and embeddings
    ``N(0, 1/fan_in)``, learned positions ``N(0, 0.02^2)``, LayerNorm
    scales 1, biases 0."""
    dev = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, mod in graph.blocks:
        block = {}
        for key, ref in mod.state_dict().items():
            _, owner, leaf = _owner_and_leaf(mod, key)
            shape = tuple(ref.shape)
            if isinstance(owner, nn.LayerNorm):
                t = torch.ones(shape) if leaf == "weight" else torch.zeros(
                    shape)
            elif leaf == "bias":
                t = torch.zeros(shape)
            elif isinstance(owner, (Dense, nn.Embedding)):
                t = torch.randn(shape, generator=gen) * shape[1] ** -0.5
            else:  # the learned position table
                t = torch.randn(shape, generator=gen) * 0.02
            block[key] = t.to(dev)
        out[name] = block
    return out


def variables_to(variables: dict, device) -> dict:
    """``variables`` on ``device``: the same dict when every tensor is
    already there (so a bound graph stays bound), else a moved copy. A
    weight-quantized leaf (a dict of tensors) moves as a whole."""
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
