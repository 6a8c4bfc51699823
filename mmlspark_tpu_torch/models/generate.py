"""Autoregressive decode for the causal transformer family — the port of
``mmlspark_tpu/models/generate.py``.

Two decode strategies:

- **KV-cache decode** (default, ``kv_cache=True``): one prefill forward
  writes the prompt's K/V into preallocated ``(B, P+N, Hkv, D)`` bf16
  buffers per block, then one-token steps read the buffer back through
  the length-aware ``flash_decode`` kernel (``ops/flash_attention.py``).
  Sliding-window models roll the cache after prefill into
  ``(B, window, Hkv, D)`` circular buffers.
- **full recompute** (``kv_cache=False``): each step runs the whole
  pad-filled ``(B, P+N)`` buffer through the model's eval forward (the
  ``flash`` forward kernel on an ``attn_impl="flash"`` model), the
  numerics oracle the cache path is tested against.

Greedy decode (``temperature=0``) or sampling at a temperature, with
optional top-k and nucleus filters (:func:`filter_logits`), drawn from
the caller's ``torch.Generator``; and :func:`beam_search` over the cache.

``jax.lax.scan`` becomes a Python loop, and the buffers the JAX package
threads functionally (and donates) are updated in place. JAX's threefry
draws cannot be reproduced: a sampled token is drawn by the Gumbel-max
rule (JAX's ``categorical``) from one ``torch.rand`` of (B, V) uniforms
per generated token, so the same generator seed gives the same tokens on
both decode strategies, and the port matches JAX in distribution.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.bridge import variables_to
from mmlspark_tpu_torch.models.graph import _accepts_kwarg
from mmlspark_tpu_torch.ops.quantize import _Q8, _is_quantized_leaf


def cache_geometry(graph, variables) -> dict:
    """``{block name: (kv_heads, head_dim)}`` for every block that takes
    a ``cache`` kwarg, read off the fused qkv weight (its int8 payload in
    weight-quantized variables, ``ops/quantize.py``). Raises
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
        if _is_quantized_leaf(weight):
            weight = weight[_Q8]
        geometry[name] = (hk, graph.extra.get("head_dim")
                          or weight.shape[0] // (heads + 2 * hk))
    return geometry


def _variables_device(variables) -> torch.device:
    for v in variables.values():
        for t in v.values():
            return (t[_Q8] if _is_quantized_leaf(t) else t).device
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
    ``pos`` (an int, a 0-d tensor — a captured program's position, which
    the host never reads — or a (B,) tensor of per-row positions), reading
    and writing the K/V cache in place. Returns (logits (B, T, V), cache).
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


def greedy_next(logits, vocab_split=None):
    """The repo-wide greedy pick: argmax over f32-cast logits (the first
    maximum on ties), returned int32 — ONE definition shared by
    ``generate()``, the engine's prefill and the fused decode block.
    ``vocab_split`` (a ``parallel.mesh.MeshPlace``; the split forward's
    ``graph.extra["vocab_split"]``) says ``logits`` are this rank's vocab
    slice: the pick is then :meth:`~mmlspark_tpu_torch.parallel.mesh.
    MeshPlace.greedy`'s combine over ``model``, the same token with the
    same tie rule."""
    if vocab_split is not None:
        return vocab_split.greedy(logits)
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

    On a rank's copy of the graph under a serving mesh (``graph.extra
    ["mesh_place"]``, ``models/transformer.split_graph``) the rows are
    the rank's slots and the greedy picks combine over the vocab shards;
    ``tokens`` is then every ``data`` rank's rows gathered in slot order
    — ONE (S_all, t + 1) int32 tensor, its last column the rows' live
    flags, gathered inside the block (one collective, so the host still
    fetches once a block) — while ``live`` and ``pos`` stay the rank's.
    """
    place = graph.extra.get("mesh_place")
    vocab_split = graph.extra.get("vocab_split")

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
            emit = torch.where(live, greedy_next(logits[:, 0], vocab_split),
                               pad)
            pos = torch.where(live, pos + 1, pos)
            rem = torch.where(live, rem - 1, rem)
            # generate()'s semantics: the EOS token IS emitted, THEN the
            # row goes dead; budget death means the row just emitted its
            # last allowed token
            live = live & (emit != eos) & (rem > 0)
            tok = torch.where(live, emit, tok)
            toks.append(emit)
        toks = torch.stack(toks, dim=1)
        if place is not None:
            toks = place.data_gather(
                torch.cat([toks, live[:, None].to(toks.dtype)], dim=1))
        return toks, live, buffers, pos

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


def filter_logits(logits, temperature: float, top_k: int | None = None,
                  top_p: float | None = None):
    """The sampling distribution's logits, as JAX's ``generate`` shapes
    them: f32 ``logits`` (B, V) over ``temperature``, then the top-k
    filter (everything below the k-th highest value goes to -inf, so ties
    AT the k-th value stay), then the nucleus: over the logits sorted
    descending, keep each token whose preceding probability mass is below
    ``top_p`` (the top token always), and drop everything below the
    smallest kept logit."""
    logits = logits.float() / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        mass_before = torch.cumsum(probs, dim=-1) - probs
        kept = mass_before < top_p
        thresh = torch.where(kept, sorted_desc, -neg_inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, neg_inf, logits)
    return logits


def sample_next(logits, rng: torch.Generator):
    """One draw per row from softmax(``logits``) by the Gumbel-max rule
    (JAX's ``categorical``): ``argmax(logits + g)`` with ``g = -log(-log
    u)`` for ``u`` uniform in (0, 1). One ``torch.rand`` of ``logits``'
    shape from ``rng``; -inf logits are never drawn. Returns int32."""
    u = torch.rand(logits.shape, generator=rng, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1).to(
        torch.int32)


def _check_generator(rng, dev: torch.device) -> None:
    if not isinstance(rng, torch.Generator):
        raise FriendlyError(
            f"rng must be a torch.Generator, got {type(rng).__name__}"
        )
    gdev = torch.device(rng.device)
    if gdev.type != dev.type or (
        dev.index is not None and gdev.index not in (None, dev.index)
    ):
        raise FriendlyError(
            f"rng lives on {gdev} but generate() computes on {dev}; make "
            f"it with torch.Generator(device='{dev}')"
        )


def generate(graph, variables, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, rng: torch.Generator | None = None,
             pad_id: int = 0, eos_id: int | None = None,
             kv_cache: bool = True, device=None):
    """Generate ``max_new_tokens`` continuations of ``prompt`` ((B, P) int
    token ids) on ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``). Returns the (B, P + max_new_tokens) int32 tensor
    including the prompt.

    ``temperature=0`` is greedy argmax; otherwise softmax sampling at the
    given temperature from ``rng`` (a ``torch.Generator`` on ``device``,
    required then), optionally truncated to the ``top_k`` most probable
    tokens and/or the nucleus holding ``top_p`` cumulative mass
    (:func:`filter_logits`). One draw per generated token.

    ``eos_id`` stops a sequence once it emits that token: its remaining
    positions fill with ``pad_id``. ``kv_cache=True`` decodes with the
    preallocated K/V cache; ``False`` re-runs the whole buffer each step
    (the O(T²) oracle). Both produce the same tokens, sampled ones
    included for the same generator state."""
    dev = default_device(device)
    variables = variables_to(variables, dev)
    prompt, b, p, total = _validate_causal_decode(
        graph, prompt, max_new_tokens, dev
    )
    if graph.extra.get("n_experts") and not kv_cache:
        # expert-capacity routing over the pad-filled recompute buffer is
        # not causal: future pads would consume capacity ahead of later
        # rows' real tokens
        raise FriendlyError(
            f"generate(kv_cache=False) does not support MoE routing "
            f"('{graph.name}'): capacity dispatch over the pad-filled "
            "recompute buffer is not causal; use the default kv_cache "
            "decode"
        )
    if temperature < 0.0:
        raise FriendlyError(
            f"temperature must be >= 0, got {temperature} (0 = greedy)"
        )
    if temperature > 0.0 and rng is None:
        raise FriendlyError("sampling (temperature > 0) needs rng")
    if (top_k is not None or top_p is not None) and temperature <= 0.0:
        raise FriendlyError(
            "top_k/top_p shape the SAMPLING distribution; they need "
            "temperature > 0 (greedy decode ignores them by definition)"
        )
    vocab = graph.extra.get("vocab_size")
    if top_k is not None and (
        top_k < 1 or (vocab and top_k > vocab)
    ):
        raise FriendlyError(
            f"top_k must be in [1, vocab_size={vocab}], got {top_k}"
        )
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise FriendlyError(f"top_p must be in (0, 1], got {top_p}")
    if temperature > 0.0:
        _check_generator(rng, dev)
    pad = torch.full((b,), pad_id, dtype=torch.int32, device=dev)

    def pick(cur):
        # cur: (B, V) logits for the next token
        if temperature <= 0.0:
            return greedy_next(cur)
        return sample_next(filter_logits(cur, temperature, top_k, top_p),
                           rng)

    def advance(nxt, done):
        # a finished row emits pads from then on
        if eos_id is None:
            return nxt, done
        emit = torch.where(done, pad, nxt)
        return emit, done | (emit == eos_id)

    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    if not kv_cache:
        buf = torch.full((b, total), pad_id, dtype=torch.int32, device=dev)
        buf[:, :p] = prompt
        for pos in range(p, total):
            # the logits for the token AT pos come from position pos - 1
            logits = graph.apply(variables, buf)
            tok, done = advance(pick(logits[:, pos - 1].float()), done)
            buf[:, pos] = tok
        return buf

    window = graph.extra.get("window")
    rolled = bool(window) and window < total
    cache = init_cache(graph, variables, b, p if rolled else total)
    # prefill: one call over the whole prompt at pos 0
    logits, cache = _cached_apply(graph, variables, prompt, cache, 0)
    tok, done = advance(pick(logits[:, -1].float()), done)
    out = [prompt, tok[:, None]]
    if rolled:
        cache = _roll_prefill_cache(cache, p, window)
    for pos in range(p, total - 1):
        logits, cache = _cached_apply(
            graph, variables, tok[:, None], cache, pos,
            rolled=rolled, step=True,
        )
        tok, done = advance(pick(logits[:, 0].float()), done)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def top_k_stable(x, k: int):
    """(values, indices) of the ``k`` largest entries of ``x``'s last
    axis, ties broken toward the LOWER index, as ``lax.top_k`` does
    (``torch.topk`` promises no tie order): a stable descending sort."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def reorder_cache(cache: dict, flat) -> dict:
    """Every per-block cache tensor's batch rows gathered by ``flat`` into
    NEW tensors (``index_select``): row j of the result is row
    ``flat[j]`` of the input, with no in-place write through an alias of
    the buffer being read."""
    return {name: tuple(t.index_select(0, flat) for t in entry)
            for name, entry in cache.items()}


def beam_search(graph, variables, prompt, max_new_tokens: int, *,
                beams: int = 4, eos_id: int | None = None,
                pad_id: int = 0, length_penalty: float = 0.0,
                return_all: bool = False, device=None):
    """Beam-search decode over the KV cache, on ``device`` (``cuda``
    unless the caller asks for ``"cpu"``).

    B·K sequences decode as one batch: each step scores (B, K, V)
    candidates, keeps the top K of the flattened K·V axis (ties to the
    lower index, :func:`top_k_stable`), and reorders every per-block K/V
    buffer by the surviving beams' parents (:func:`reorder_cache`).
    Finished beams (``eos_id``) extend only with ``pad_id`` at zero added
    score.

    ``length_penalty`` alpha divides final scores by ``gen_len**alpha``
    (0 = plain sum of log-probs). As in the reference, a finished beam's
    score and ``gen_len`` FREEZE at the step its eos was emitted and the
    beam keeps competing in the per-step top-k (no separate pool of
    finished hypotheses), so with ``alpha > 0`` short finished beams are
    mildly favoured over the conventional compare-at-finish rule. Returns
    the best (B, P+N) int32 sequences, or with ``return_all`` a tuple of
    ((B, K, P+N) sequences sorted best first, (B, K) adjusted scores).
    Works with GQA, RoPE and sliding windows (rolled buffers reorder the
    same way)."""
    dev = default_device(device)
    variables = variables_to(variables, dev)
    prompt, b, p, total = _validate_causal_decode(
        graph, prompt, max_new_tokens, dev
    )
    if beams < 1:
        raise FriendlyError(f"beams must be >= 1, got {beams}")
    vocab = graph.extra.get("vocab_size")
    if vocab and beams > vocab:
        raise FriendlyError(
            f"beams ({beams}) cannot exceed vocab_size ({vocab})"
        )
    if length_penalty < 0.0:
        raise FriendlyError(
            f"length_penalty must be >= 0, got {length_penalty}"
        )
    n, k = max_new_tokens, beams
    window = graph.extra.get("window")
    rolled = bool(window) and window < total

    # prefill once at batch B, then tile the cache to B*K beams
    cache = init_cache(graph, variables, b, p if rolled else total)
    logits, cache = _cached_apply(graph, variables, prompt, cache, 0)
    if rolled:
        cache = _roll_prefill_cache(cache, p, window)
    logprobs = torch.log_softmax(logits[:, -1].float(), dim=-1)
    vocab = logprobs.shape[-1]
    if k > vocab:  # builders without vocab metadata reach here instead
        raise FriendlyError(
            f"beams ({k}) cannot exceed vocab_size ({vocab})"
        )
    scores, tok = top_k_stable(logprobs, k)  # (B, K) each
    tok = tok.to(torch.int32)
    cache = reorder_cache(
        cache, torch.arange(b, device=dev).repeat_interleave(k))
    buf = torch.full((b, k, n), pad_id, dtype=torch.int32, device=dev)
    buf[:, :, 0] = tok
    done = (tok == eos_id if eos_id is not None
            else torch.zeros((b, k), dtype=torch.bool, device=dev))
    gen_len = torch.ones((b, k), dtype=torch.int32, device=dev)
    # finished beams may only extend with pad at zero added score
    pad_only = torch.full((vocab,), float("-inf"), device=dev)
    pad_only[pad_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * k
    for i in range(1, n):
        logits, cache = _cached_apply(
            graph, variables, tok.reshape(b * k, 1), cache, p + i - 1,
            rolled=rolled, step=True,
        )
        lp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(
            b, k, vocab)
        lp = torch.where(done[..., None], pad_only, lp)
        cand = (scores[..., None] + lp).reshape(b, k * vocab)
        scores, idx = top_k_stable(cand, k)  # (B, K)
        parent = idx // vocab
        tok = (idx % vocab).to(torch.int32)
        # reorder every per-beam quantity by the surviving parents
        buf = torch.take_along_dim(buf, parent[..., None], dim=1)
        done = torch.take_along_dim(done, parent, dim=1)
        gen_len = torch.take_along_dim(gen_len, parent, dim=1)
        cache = reorder_cache(cache, (rows + parent).reshape(-1))
        buf[:, :, i] = tok
        gen_len = gen_len + (~done).to(torch.int32)
        if eos_id is not None:
            done = done | (tok == eos_id)

    adjusted = scores
    if length_penalty > 0.0:
        adjusted = scores / gen_len.float().clamp_min(1.0) ** length_penalty
    seqs = torch.cat([prompt[:, None].expand(b, k, p), buf], dim=2)
    if return_all:
        order = torch.sort(adjusted, dim=1, descending=True,
                           stable=True).indices
        return (torch.take_along_dim(seqs, order[..., None], dim=1),
                torch.take_along_dim(adjusted, order, dim=1))
    best = adjusted.argmax(dim=1)  # the first maximum, as jnp.argmax
    return seqs[torch.arange(b, device=dev), best]
