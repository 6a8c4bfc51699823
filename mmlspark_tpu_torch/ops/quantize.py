"""Weight-only int8 and KV-cache byte accounting — the port of
``mmlspark_tpu/ops/quantize.py``.

Weight-only int8 (W8): the large leaves of a variables dict (ndim >= 2,
at least ``min_size`` elements, float) become per-output-channel
symmetric int8 with a float32 scale, and small leaves (biases, norm
parameters) stay as they are. Dequantization runs once per program call
(``serve/engine.py``), so the device holds the int8 copy between calls.
Activations stay bf16: this is a bandwidth lever, not an int8-GEMM one.

A quantized leaf is a dict ``{_Q8: int8 payload, _SCALE: f32 scale}`` in
place of the float tensor. The payload has the port leaf's layout; the
scale holds the JAX package's values, shaped to broadcast against the
payload: flax quantizes per output channel, the LAST axis of the flax
leaf, so a ``Dense`` weight — (out, in) in the port, transposed from
flax's (in, out) — takes an (out, 1) scale, and an embedding table or
the learned position table (not transposed) a (1, d) one. The arithmetic
is JAX's, bit for bit: ``scale = absmax / 127`` in f32 (a zero scale
becomes 1), ``q = clip(rint(x / scale), -127, 127)``, and dequantization
``q.to(dtype) * scale.to(dtype)``, the product in ``dtype``.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = [
    "quantize_weights", "dequantize_weights", "quantized_bytes",
    "kv_cache_bytes",
]

#: marker keys: a dict {_Q8: int8 tensor, _SCALE: f32 per-channel scale}
#: stands in for the original float leaf
_Q8 = "__w8__"
_SCALE = "__w8_scale__"

_MIN_QUANT_SIZE = 4096  # leave tiny tensors exact; no bandwidth to win


def _is_quantized_leaf(x: Any) -> bool:
    return isinstance(x, dict) and _Q8 in x and _SCALE in x


def quantize_leaf(t: torch.Tensor, channel_axis: int) -> dict:
    """One 2-D float tensor as ``{_Q8, _SCALE}``, one scale per index of
    ``channel_axis`` (the flax leaf's last axis, wherever the port's
    layout puts it)."""
    x = t.float()
    scale = x.abs().amax(dim=1 - channel_axis, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return {_Q8: q, _SCALE: scale}


def quantize_weights(graph, variables: dict, *,
                     min_size: int = _MIN_QUANT_SIZE) -> dict:
    """Per-output-channel symmetric int8 for every float leaf of
    ``variables`` (``{block: {name: tensor}}``) with ndim >= 2 and at
    least ``min_size`` elements; every other leaf is passed through, the
    same tensor. ``graph`` names each leaf's owning module, which decides
    the channel axis (see the module docstring); the port's weights are
    2-D. The serving engine passes ``min_size=0``, so every projection
    goes int8."""
    from mmlspark_tpu_torch.models.bridge import flax_transposed

    out = {}
    for name, mod in graph.blocks:
        block = {}
        for key, t in variables[name].items():
            if (
                t.ndim < 2
                or t.numel() < min_size
                or not t.is_floating_point()
            ):
                block[key] = t
                continue
            block[key] = quantize_leaf(
                t, 0 if flax_transposed(mod, key) else 1)
        out[name] = block
    return out


def dequantize_weights(variables: dict,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """Compute-dtype weights from a quantized variables dict: each
    quantized leaf becomes ``q.to(dtype) * scale.to(dtype)`` (two
    roundings, as JAX's), every other leaf the same tensor. A new dict,
    made once per program call; nothing keeps it afterwards."""
    return {
        name: {
            key: (t[_Q8].to(dtype) * t[_SCALE].to(dtype)
                  if _is_quantized_leaf(t) else t)
            for key, t in block.items()
        }
        for name, block in variables.items()
    }


def _leaves(tree: Any):
    if _is_quantized_leaf(tree) or isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def quantized_bytes(variables: Any) -> tuple[int, int]:
    """(bytes as stored, bytes if f32) over any nest of dicts, tuples and
    lists of tensors — the bandwidth win, for logging. A quantized leaf
    counts its int8 payload and its f32 scales against 4 bytes per
    payload element."""
    stored = f32 = 0
    for leaf in _leaves(variables):
        if _is_quantized_leaf(leaf):
            n = leaf[_Q8].numel()
            stored += n + leaf[_SCALE].numel() * 4
            f32 += n * 4
        else:
            stored += leaf.numel() * leaf.element_size()
            f32 += leaf.numel() * 4
    return stored, f32


def kv_cache_bytes(buffers: dict) -> tuple[int, int]:
    """(bytes as stored, bytes if bf16) for a cache pool's ``buffers``
    (``{block: tuple of tensors}``), with the baseline at bf16 because
    that is what the dense accuracy-oracle pool stores. int8 K/V tensors
    count 1 byte against a 2-byte baseline; f32 scale tensors and int32
    page tables are quantization/paging overhead, so they count toward
    stored AND baseline at their own width (an int8 pool is never
    reported as beating a bf16 pool it does not beat). A tensor shared by
    several blocks (the paged pool's one device page table) counts
    once."""
    stored = bf16 = 0
    seen: set[int] = set()
    for entry in buffers.values():
        for t in entry:
            if id(t) in seen:
                continue
            seen.add(id(t))
            nbytes = t.numel() * t.element_size()
            stored += nbytes
            bf16 += t.numel() * 2 if t.dtype == torch.int8 else nbytes
    return stored, bf16
