"""Seeded weights, made on the device in a few large draws.

The leaves are named and shaped as the port's ``transformer_lm`` takes
them (``{block: {leaf: tensor}}``), worked out here from the
configuration file alone. One ``torch.Generator`` seeded with the run's
seed, on the run's device, fills chunks of up to ``CHUNK`` normal
numbers; each leaf is a slice of a chunk, scaled and stored in the type
it is served in: the matrices and biases of the dense projections in
bfloat16, the LayerNorms and the two tables in float32. The same seed
on the same device gives the same values, so the reference makes its
own copy again after the program's run instead of keeping one beside it.

Scales: projections and the token table ``N(0, 1 / fan_in)``, biases
and the position table ``N(0, 0.02^2)``, LayerNorm scales
``1 + N(0, 0.1^2)`` and shifts ``N(0, 0.02^2)``. The biases and the
LayerNorm parameters are not left at 0 and 1, so a path that drops one
shows in the comparison.
"""

from __future__ import annotations

import math

import torch

#: normal numbers drawn in one call (1 GiB of float32)
CHUNK = 1 << 28


def leaf_specs(port: dict) -> list[tuple[str, str, tuple, str]]:
    """``(block, leaf, shape, kind)`` in draw order; ``kind`` is ``dense``
    (a projection's weight), ``bias``, ``ln_scale``, ``ln_shift``,
    ``token`` or ``pos``."""
    v, d = int(port["vocab_size"]), int(port["d_model"])
    h = int(port["heads"])
    hk = int(port.get("kv_heads") or h)
    hd = d // h
    ff = int(port.get("d_ff") or 4 * d)
    specs = [("embed", "token.weight", (v, d), "token"),
             ("embed", "pos", (int(port["max_len"]), d), "pos")]
    for i in range(int(port["depth"])):
        blk = f"block{i}"
        specs += [(blk, "ln1.weight", (d,), "ln_scale"),
                  (blk, "ln1.bias", (d,), "ln_shift")]
        for name, n_out, n_in in (("attn.qkv", (h + 2 * hk) * hd, d),
                                  ("attn.attn_out", d, h * hd)):
            specs += [(blk, f"{name}.weight", (n_out, n_in), "dense"),
                      (blk, f"{name}.bias", (n_out,), "bias")]
        specs += [(blk, "ln2.weight", (d,), "ln_scale"),
                  (blk, "ln2.bias", (d,), "ln_shift")]
        for name, n_out, n_in in (("mlp_in", ff, d), ("mlp_out", d, ff)):
            specs += [(blk, f"{name}.weight", (n_out, n_in), "dense"),
                      (blk, f"{name}.bias", (n_out,), "bias")]
    specs += [("z", "ln_f.weight", (d,), "ln_scale"),
              ("z", "ln_f.bias", (d,), "ln_shift"),
              ("z", "head.weight", (v, d), "dense"),
              ("z", "head.bias", (v,), "bias")]
    return specs


def _finish(z: torch.Tensor, shape: tuple, kind: str) -> torch.Tensor:
    z = z.view(shape)
    if kind in ("dense", "token"):
        return (z * shape[-1] ** -0.5).to(
            torch.bfloat16 if kind == "dense" else torch.float32)
    if kind == "bias":
        return (z * 0.02).to(torch.bfloat16)
    if kind == "ln_scale":
        return 1.0 + 0.1 * z
    return z * 0.02  # ln_shift, pos


def make_weights(port: dict, seed: int, device) -> dict:
    """The run's weights on ``device`` (see the module docstring)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    specs = leaf_specs(port)
    out: dict = {}
    i = 0
    while i < len(specs):
        # one draw for the leaves that fit a chunk (at least one leaf)
        j, n = i, 0
        while j < len(specs):
            size = math.prod(specs[j][2])
            if n and n + size > CHUNK:
                break
            n += size
            j += 1
        buf = torch.randn(n, generator=gen, device=device)
        at = 0
        for block, leaf, shape, kind in specs[i:j]:
            size = math.prod(shape)
            out.setdefault(block, {})[leaf] = _finish(buf[at:at + size],
                                                      shape, kind)
            at += size
        del buf
        i = j
    return out
