"""Greedy autoregressive decode for the causal transformer family — the
port of ``mmlspark_tpu/models/generate.py``.

KV-cache decode: one prefill forward writes the prompt's K/V into
preallocated ``(B, P+N, Hkv, D)`` bf16 buffers per block, then one-token
steps read the buffer back through the length-aware ``flash_decode``
kernel (``ops/flash_attention.py``). Sliding-window models roll the
cache after prefill into ``(B, window, Hkv, D)`` circular buffers.

``jax.lax.scan`` becomes a Python loop, and the buffers the JAX package
threads functionally (and donates) are updated in place. This slice
ports greedy decode only: sampling (temperature, top-k/top-p), the
full-recompute oracle and ``beam_search`` wait for a later slice
(ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.bridge import variables_to
from mmlspark_tpu_torch.models.graph import _accepts_kwarg


def cache_geometry(graph, variables) -> dict:
    """``{block name: (kv_heads, head_dim)}`` for every block that takes
    a ``cache`` kwarg, read off the fused qkv weight. Raises
    :class:`FriendlyError` when ``graph.extra`` lacks ``heads`` or a
    cache-accepting block's variables lack ``attn.qkv.weight``."""
    heads = graph.extra.get("heads")
    if not heads:
        raise FriendlyError(
            f"KV-cache decode needs graph.extra['heads'] to size the "
            f"cache buffers; '{graph.name}' does not record it — register "
            "the model builder with heads metadata in extra"
        )
    hk = graph.extra.get("kv_heads") or heads
    geometry = {}
    for name, mod in graph.blocks:
        if not _accepts_kwarg(mod, "cache"):
            continue
        try:
            weight = variables[name]["attn.qkv.weight"]
        except (KeyError, TypeError) as e:
            raise FriendlyError(
                f"block '{name}' of '{graph.name}' accepts a cache kwarg "
                "but its variables lack the fused qkv weight the cache "
                "geometry is read from (attn.qkv.weight); cached decode "
                "requires the transformer attention layout"
            ) from e
        geometry[name] = (hk, weight.shape[0] // (heads + 2 * hk))
    return geometry


def _variables_device(variables) -> torch.device:
    for v in variables.values():
        for t in v.values():
            return t.device
    raise FriendlyError("variables hold no tensors")


def init_cache(graph, variables, batch: int, total: int) -> dict:
    """Per-block K/V decode buffers, ``(B, total, Hkv, D)`` bf16 zeros on
    the variables' device. K and V are DISTINCT tensors: the decode step
    writes both in place."""
    device = _variables_device(variables)
    cache = {}
    for name, (hk, d) in cache_geometry(graph, variables).items():
        cache[name] = tuple(
            torch.zeros((batch, total, hk, d), dtype=torch.bfloat16,
                        device=device)
            for _ in range(2)
        )
    return cache


def _cached_apply(graph, variables, ids, cache, pos, rolled=False,
                  step=False, live=None):
    """One forward over ``ids`` (B, T) starting at absolute position
    ``pos`` (an int, or a (B,) tensor of per-row positions), reading and
    writing the K/V cache in place. Returns (logits (B, T, V), cache).
    ``step`` marks a DECODE step (vs the prefill call), which routes a
    one-token step to ``flash_decode``; ``live`` ((B,) bool, the fused
    decode block's carry) zeroes dead rows' live lengths."""
    graph.bind(variables)
    x = ids
    new_cache = dict(cache)
    with torch.no_grad():
        for name, mod in graph.blocks:
            if name in cache:
                kwargs = {"cache": cache[name], "pos": pos, "rolled": rolled}
                if _accepts_kwarg(mod, "decode"):
                    kwargs["decode"] = step
                if live is not None and _accepts_kwarg(mod, "live"):
                    kwargs["live"] = live
                x, new_cache[name] = mod(x, **kwargs)
            elif _accepts_kwarg(mod, "pos"):
                x = mod(x, pos=pos)
            else:
                x = mod(x)
    return x, new_cache


def greedy_next(logits):
    """The repo-wide greedy pick: argmax over f32-cast logits (the first
    maximum on ties), returned int32 — ONE definition shared by
    ``generate()``, the engine's prefill and the fused decode block."""
    return logits.float().argmax(dim=-1).to(torch.int32)


def make_decode_block(graph, pad_id: int = 0):
    """Build the fused multi-token decode block for ``graph``: ``t``
    greedy micro-steps in one call, with sampling, position advance and
    the live/EOS/budget mask kept on the device, so the host syncs once
    per block (when it reads the tokens). Signature::

        decode_block(variables, buffers, pos, live, tok, rem, eos, t)

    - ``buffers``: the slot pool's ``{block: (K, V)}``, written in place
    - ``pos``: (S,) int32 next-write positions (frozen for dead rows)
    - ``live``: (S,) bool — True while the row has an unfinished tenant
    - ``tok``: (S,) int32 last emitted token per row
    - ``rem``: (S,) int32 remaining new-token budget per row
    - ``eos``: (S,) int32 per-row EOS id, -1 meaning "no EOS"

    Returns ``(tokens (S, t), live (S,), buffers, pos)``. A row's stream
    equals single-request greedy ``generate()`` up to and including its
    EOS or last budgeted token; later columns are ``pad_id``.
    """

    def decode_block(variables, buffers, pos, live, tok, rem, eos, t):
        pad = torch.full_like(tok, pad_id)
        toks = []
        for _ in range(t):
            # write tok's K/V at pos, attend over [0, pos], next logits.
            # Dead rows run too, at a frozen pos with zeroed flash-decode
            # lengths: their only cost is a repeated K/V write at that
            # pos, which the slot's next prefill overwrites (the writes
            # stay ordered on the one stream)
            logits, buffers = _cached_apply(
                graph, variables, tok[:, None], buffers, pos,
                step=True, live=live,
            )
            emit = torch.where(live, greedy_next(logits[:, 0]), pad)
            pos = torch.where(live, pos + 1, pos)
            rem = torch.where(live, rem - 1, rem)
            # generate()'s semantics: the EOS token IS emitted, THEN the
            # row goes dead; budget death means the row just emitted its
            # last allowed token
            live = live & (emit != eos) & (rem > 0)
            tok = torch.where(live, emit, tok)
            toks.append(emit)
        return torch.stack(toks, dim=1), live, buffers, pos

    return decode_block


def _roll_prefill_cache(cache, p: int, window: int) -> dict:
    """Fold a linear prefill cache (buffers of length ``p``) into
    circular window buffers of length ``window``: the last min(p, window)
    K/V land at their ``pos % window`` slots; older positions are outside
    every future query's window and are dropped."""
    wm = min(p, window)
    out = {}
    for name, (ck, cv) in cache.items():
        slots = torch.arange(p - wm, p, device=ck.device) % window
        rolled = []
        for buf in (ck, cv):
            b, _, hk, d = buf.shape
            r = torch.zeros((b, window, hk, d), dtype=buf.dtype,
                            device=buf.device)
            r[:, slots] = buf[:, p - wm:]
            rolled.append(r)
        out[name] = tuple(rolled)
    return out


def _validate_causal_decode(graph, prompt, max_new_tokens: int, device):
    """Decode-entry validation: causal contract, token budget, and the
    learned-position-table cap. Returns (prompt int32, B, P, total)."""
    if not graph.extra.get("causal", False):
        raise FriendlyError(
            f"decoding needs a causal LM; '{graph.name}' has "
            "causal=False (bidirectional logits leak future positions)"
        )
    if max_new_tokens < 1:
        raise FriendlyError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}"
        )
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.array(prompt, dtype=np.int32))
    prompt = prompt.to(device=device, dtype=torch.int32)
    if prompt.ndim != 2:
        raise FriendlyError(
            f"prompt must be (B, P) token ids, got shape "
            f"{tuple(prompt.shape)}"
        )
    b, p = prompt.shape
    total = p + max_new_tokens
    max_len = graph.input_shape[0] if graph.input_shape else None
    if (
        max_len
        and total > max_len
        and graph.extra.get("pos_embedding", "learned") == "learned"
    ):
        raise FriendlyError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"the learned position table ({max_len}); build the model "
            "with a larger max_len or pos_embedding='rope'"
        )
    return prompt, b, p, total


def generate(graph, variables, prompt, max_new_tokens: int, *,
             pad_id: int = 0, eos_id: int | None = None, device=None):
    """Greedily generate ``max_new_tokens`` continuations of ``prompt``
    ((B, P) int token ids) with the KV cache, on ``device`` (``cuda``
    unless the caller asks for ``"cpu"``). Returns the
    (B, P + max_new_tokens) int32 tensor including the prompt.

    ``eos_id`` stops a sequence once it emits that token: its remaining
    positions fill with ``pad_id``."""
    dev = default_device(device)
    variables = variables_to(variables, dev)
    prompt, b, p, total = _validate_causal_decode(
        graph, prompt, max_new_tokens, dev
    )
    pad = torch.full((b,), pad_id, dtype=torch.int32, device=dev)

    def advance(nxt, done):
        # a finished row emits pads from then on
        if eos_id is None:
            return nxt, done
        emit = torch.where(done, pad, nxt)
        return emit, done | (emit == eos_id)

    window = graph.extra.get("window")
    rolled = bool(window) and window < total
    cache = init_cache(graph, variables, b, p if rolled else total)
    # prefill: one call over the whole prompt at pos 0
    logits, cache = _cached_apply(graph, variables, prompt, cache, 0)
    tok, done = advance(greedy_next(logits[:, -1]),
                        torch.zeros((b,), dtype=torch.bool, device=dev))
    out = [prompt, tok[:, None]]
    if rolled:
        cache = _roll_prefill_cache(cache, p, window)
    for pos in range(p, total - 1):
        logits, cache = _cached_apply(
            graph, variables, tok[:, None], cache, pos,
            rolled=rolled, step=True,
        )
        tok, done = advance(greedy_next(logits[:, 0]), done)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
