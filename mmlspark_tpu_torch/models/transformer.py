"""Transformer LM — the port of ``mmlspark_tpu/models/transformer.py``.

Compute is bfloat16 (each block's ``dtype``), parameters float32, logits
float32, with bf16 rounding at the same places as the flax modules:

- the token and position rows are f32;
- every Dense (``qkv``, ``attn_out``, ``mlp_in``, ``mlp_out``, ``head``)
  casts its input and weight to ``dtype`` and adds the bias in ``dtype``
  after the product, as flax's ``nn.Dense(dtype=...)`` does;
- LayerNorms run in f32 with flax's epsilon (1e-6), residual sums
  promote to f32, and the gelu is the tanh approximation (flax's
  ``nn.gelu`` default).

Layer names (``qkv``/``attn_out``/``mlp_in``/``mlp_out``, ``ln1``/``ln2``/
``ln_f``/``head``, ``token``/``pos``) are the flax names, which is what
:mod:`mmlspark_tpu_torch.models.bridge` maps weights by.

Cache paths: the 2-tuple linear cache (prefill through
``dense_attention(q_offset=pos)``), the per-row single-token decode
through the CUDA ``flash_decode`` kernel, and the rolled sliding-window
cache; the serve pools' decode formats — the int8 slot cache
``(K, V, k_scale, v_scale)`` through ``flash_decode``'s int8 mode, and
the paged cache ``(K, V, PT)`` / int8 ``(K, V, PT, k_scale, v_scale)``
through ``paged_flash_decode``.

Without a cache, ``attn_impl`` picks the attention: ``flash`` is the
blockwise kernel with its gradient (:func:`~mmlspark_tpu_torch.ops.
flash_attention.flash_attention`, the CUDA kernels on the card), ``dense``
the plain oracle; ``auto`` is ``flash`` when PyTorch sees a GPU, as the
JAX package picks its Pallas kernel on a TPU. ``ring``/``ulysses`` raise
``ParamError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core.env import has_cuda
from mmlspark_tpu_torch.core.exceptions import ParamError
from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.registry import register_model
from mmlspark_tpu_torch.ops.attention import (
    _is_per_row,
    decode_live_lengths,
    dense_attention,
    rolled_window_attention,
)
from mmlspark_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_decode,
    paged_flash_decode,
)
from mmlspark_tpu_torch.ops.rope import apply_rope

DENSE = "dense"
RING = "ring"
ULYSSES = "ulysses"
FLASH = "flash"
AUTO = "auto"
ATTN_IMPLS = (DENSE, RING, ULYSSES, FLASH, AUTO)
#: flax nn.LayerNorm's default epsilon (torch's is 1e-5)
LN_EPS = 1e-6

_NOT_PORTED = {
    RING: "context parallelism (ROADMAP.md Queue 1 item 13)",
    ULYSSES: "context parallelism (ROADMAP.md Queue 1 item 13)",
}


def resolve_attn_impl(attn_impl: str) -> str:
    """``auto`` -> ``flash`` when PyTorch sees a GPU, else ``dense`` (the
    JAX package's ``is_tpu()`` choice at build time); ``flash`` and
    ``dense`` stay; ``ring``/``ulysses`` raise until their slice lands."""
    if attn_impl not in ATTN_IMPLS:
        raise ParamError(
            f"unknown attn_impl '{attn_impl}'; one of {ATTN_IMPLS}"
        )
    if attn_impl in _NOT_PORTED:
        raise ParamError(
            f"attn_impl '{attn_impl}' is not ported yet: it needs "
            f"{_NOT_PORTED[attn_impl]}; use 'flash', 'dense' or 'auto'"
        )
    if attn_impl == AUTO:
        return FLASH if has_cuda() else DENSE
    return attn_impl


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: f32 weight
    (out, in) and bias; ``forward(x, dtype)`` casts the input and the
    parameters to the caller's compute dtype and adds the bias after the
    product — two roundings, as in flax."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x, dtype):
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return y + self.bias.to(dtype)


class TokenPosEmbed(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, max_len: int,
                 learned_pos: bool = True):
        super().__init__()
        self.token = nn.Embedding(vocab_size, d_model)
        self.learned_pos = learned_pos  # False: tokens only (RoPE)
        if learned_pos:
            self.pos = nn.Parameter(torch.empty(max_len, d_model))

    def forward(self, ids, pos=None):
        # ``pos`` offsets the position table for cached decode: an int
        # (or 0-d tensor), or a (B,) vector of PER-ROW offsets for the
        # serving engine's multi-tenant decode
        tok = self.token(ids)
        if not self.learned_pos:
            return tok
        t = ids.shape[1]
        if pos is None:
            return tok + self.pos[None, :t]
        steps = torch.arange(t, device=ids.device)
        if _is_per_row(pos):
            return tok + self.pos[pos.long()[:, None] + steps]
        return tok + self.pos[pos + steps][None]


def compute_dtype_variables(graph, variables: dict) -> dict:
    """``variables`` with every ``Dense`` leaf (weight and bias) cast once
    to the compute dtype its caller passes (the ``dtype`` of the module
    that owns the Dense): a new dict, the other leaves the same tensors.
    ``Dense.forward`` casts its parameters to that dtype on every call, and
    a cast to the dtype a tensor already has returns it unchanged, so the
    model's outputs are bit-equal on either dict. The serving engine keeps
    the cast copy in place of the f32 leaves, which it then never reads."""
    out = {}
    for name, mod in graph.blocks:
        block = dict(variables[name])
        for path, owner in mod.named_modules():
            dtype = getattr(owner, "dtype", None)
            if not isinstance(dtype, torch.dtype):
                continue
            for child, sub in owner.named_children():
                if not isinstance(sub, Dense):
                    continue
                for leaf in ("weight", "bias"):
                    key = ".".join(filter(None, (path, child, leaf)))
                    t = block.get(key)
                    if isinstance(t, torch.Tensor) and t.is_floating_point():
                        block[key] = t.to(dtype)
        out[name] = block
    return out


class SelfAttention(nn.Module):
    """Multi-head (or grouped-query) self-attention. Without a cache it
    runs ``attn_impl`` (``flash`` or ``dense``, resolved by
    ``transformer_lm``)."""

    def __init__(self, d_model: int, heads: int, head_dim: int,
                 causal: bool, window: int | None = None,
                 kv_heads: int | None = None, rope: bool = False,
                 dtype=torch.bfloat16, attn_impl: str = DENSE):
        super().__init__()
        self.attn_impl = attn_impl
        self.heads = heads
        self.head_dim = head_dim
        self.kv_heads = kv_heads
        self.causal = causal
        self.window = window
        self.rope = rope
        self.dtype = dtype
        hk = kv_heads or heads
        # one fused projection; under GQA the K/V slices are narrower
        self.qkv = Dense(d_model, (heads + 2 * hk) * head_dim)
        self.attn_out = Dense(heads * head_dim, d_model)

    def forward(self, x, cache=None, pos=None, rolled=False,
                decode=False, live=None):
        b, t, _ = x.shape
        h, d = self.heads, self.head_dim
        hk = self.kv_heads or h
        qkv = self.qkv(x, self.dtype).reshape(b, t, h + 2 * hk, d)
        q = qkv[:, :, :h]
        k = qkv[:, :, h:h + hk]
        v = qkv[:, :, h + hk:]
        if self.rope:
            if cache is None:
                positions = None
            elif _is_per_row(pos):  # per-row serve decode: (B, T) positions
                positions = (pos.long()[:, None]
                             + torch.arange(t, device=x.device))
            else:
                positions = pos + torch.arange(t, device=x.device)
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        new_cache = None
        if cache is not None:
            # every cache is written in place: the caller's tuple comes
            # back as the new cache
            self._check_cache(cache, pos, t, rolled, decode)
            new_cache = cache
            if len(cache) in (3, 5):
                o = self._paged_decode(q, k, v, cache, pos, live)
            else:
                o = self._slot_decode(q, k, v, cache, pos, rolled, decode,
                                      live)
        elif self.attn_impl == FLASH:
            o = flash_attention(q, k, v, causal=self.causal,
                                window=self.window)
        else:
            o = dense_attention(q, k, v, causal=self.causal,
                                window=self.window)
        out = self.attn_out(o.reshape(b, t, h * d), self.dtype)
        return out if new_cache is None else (out, new_cache)

    def _slot_decode(self, q, k, v, cache, pos, rolled, decode, live):
        """Write the step's K/V into a linear, rolled or int8 slot cache
        and attend over it."""
        ck, cv, *cscales = cache
        b, t = q.shape[:2]
        if _is_per_row(pos):
            # multi-tenant decode: every row writes its own absolute
            # position in its own slot row. In place — the JAX package
            # scatters into a donated buffer instead
            rows = torch.arange(b, device=q.device)
            if cscales:
                # int8 slot pool: quantize the step's K/V against the
                # slots' prefill-fixed scales (out-of-range values
                # saturate)
                from mmlspark_tpu_torch.serve.cache_pool import quantize_kv

                wk = quantize_kv(k[:, 0], cscales[0])
                wv = quantize_kv(v[:, 0], cscales[1])
            else:
                wk, wv = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
            ck.index_put_((rows, pos.long()), wk)
            cv.index_put_((rows, pos.long()), wv)
        else:
            # linear: the write index IS the absolute position; rolled:
            # slot pos % W (every written slot lies inside the window,
            # ops/attention.rolled_window_attention). In place, where the
            # JAX package's dynamic_update_slice returns a new buffer.
            # ``pos`` is an int or a 0-d device tensor (the engine's
            # resume program, where the host never reads it)
            idx = pos + torch.arange(t, device=q.device)
            if rolled:
                idx = idx % ck.shape[1]
            ck.index_copy_(1, idx, k.to(ck.dtype))
            cv.index_copy_(1, idx, v.to(cv.dtype))
        if rolled:
            return rolled_window_attention(q, ck, cv, pos)
        if decode and t == 1 and (
            self.window is None or self.window >= ck.shape[1]
        ):
            # single-token DECODE step over a linear cache: the
            # length-aware kernel reads only each row's live positions
            # [0, pos + 1); ``live`` (the fused decode block's carry)
            # zeroes dead rows' lengths so they read nothing
            return flash_decode(
                q, ck, cv,
                decode_live_lengths(pos, b, live=live, device=q.device),
                k_scale=cscales[0] if cscales else None,
                v_scale=cscales[1] if cscales else None,
            )
        return dense_attention(q, ck, cv, causal=True, window=self.window,
                               q_offset=pos)

    def _paged_decode(self, q, k, v, cache, pos, live):
        """One decode step over a PAGED slot cache (``serve/paging.py``):
        scatter the step's K/V through the page table — row b's position
        pos[b] lands in physical page ``ptab[b, pos // ps]`` at offset
        ``pos % ps`` — then read through ``paged_flash_decode``. Dead
        rows hold a frozen pos whose page the pool keeps pointed at the
        trash page (or at the row's own private page), so their writes
        never touch live data."""
        ck, cv, ptab, *cscales = cache
        b = q.shape[0]
        ps = ck.shape[2]
        rows = torch.arange(b, device=q.device)
        pl = pos.long()
        pages = ptab[rows, pl // ps].long()
        offs = pl % ps
        idx = (pages[:, None],
               torch.arange(ck.shape[1], device=q.device)[None, :],
               offs[:, None])
        if cscales:
            # int8 page store: a page's scale is FIXED at its first write
            # — offs == 0 means this token opens a fresh page (the pool
            # pre-mapped it), so its amax (+ headroom) becomes the page's
            # scale; later tokens into the page quantize against it.
            # Dead rows re-stamp their trash page's scale, which nothing
            # reads (live length 0)
            from mmlspark_tpu_torch.serve.cache_pool import (
                kv_head_scales,
                quantize_kv,
            )

            ks, vs = cscales
            tk, tv = k[:, 0].float(), v[:, 0].float()
            first = (offs == 0)[:, None]
            row_ks = torch.where(first, kv_head_scales(tk, axes=(2,)),
                                 ks[pages])
            row_vs = torch.where(first, kv_head_scales(tv, axes=(2,)),
                                 vs[pages])
            ks.index_put_((pages,), row_ks)
            vs.index_put_((pages,), row_vs)
            wk, wv = quantize_kv(tk, row_ks), quantize_kv(tv, row_vs)
        else:
            wk, wv = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
        ck.index_put_(idx, wk)
        cv.index_put_(idx, wv)
        return paged_flash_decode(
            q, ck, cv, decode_live_lengths(pos, b, live=live), ptab,
            k_scale=cscales[0] if cscales else None,
            v_scale=cscales[1] if cscales else None,
        )

    def _check_cache(self, cache, pos, t: int, rolled: bool,
                     decode: bool) -> None:
        if not self.causal:
            raise ParamError("cache decode requires causal=True")
        if rolled and t != 1:
            raise ParamError(
                "rolled cache decode is single-token (t=1); prefill uses "
                "the linear cache path"
            )
        per_row = _is_per_row(pos)
        if per_row and (rolled or t != 1):
            raise ParamError(
                "per-row cache positions (the serve engine's fused decode "
                "step) are single-token and linear-cache only"
            )
        if len(cache) not in (2, 3, 4, 5):
            raise ParamError(
                f"a cache is a (K, V) pair, a paged (K, V, PT[, k_scale, "
                f"v_scale]) or an int8 (K, V, k_scale, v_scale) tuple, got "
                f"a {len(cache)}-tuple"
            )
        if len(cache) in (3, 5):
            # the serve engine's fused decode-block format: prefill runs
            # on a linear batch-1 cache and the pool scatters it into
            # pages host-side
            if not (per_row and decode and t == 1):
                raise ParamError(
                    "paged caches serve per-row single-token decode "
                    "only (the serve engine's fused decode step); "
                    "prefill uses the linear cache path"
                )
            virt = cache[2].shape[1] * cache[0].shape[2]
            if self.window is not None and self.window < virt:
                raise ParamError(
                    f"paged decode has no windowed read: window "
                    f"({self.window}) must cover the virtual cache "
                    f"({virt})"
                )
        elif len(cache) == 4 and not (
            per_row and decode and t == 1
            and (self.window is None or self.window >= cache[0].shape[1])
        ):
            # the slot pool's int8 mode; only the flash-decode read can
            # dequantize it
            raise ParamError(
                "int8 dense caches serve the engine's per-row "
                "single-token full-window decode only; prefill and "
                "single-request generate use bf16 linear caches"
            )


class Block(nn.Module):
    def __init__(self, d_model: int, heads: int, head_dim: int, d_ff: int,
                 causal: bool, dtype=torch.bfloat16,
                 window: int | None = None, kv_heads: int | None = None,
                 rope: bool = False, attn_impl: str = DENSE):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = SelfAttention(
            d_model, heads, head_dim, causal, window=window,
            kv_heads=kv_heads, rope=rope, dtype=dtype, attn_impl=attn_impl,
        )
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp_in = Dense(d_model, d_ff)
        self.mlp_out = Dense(d_ff, d_model)

    def forward(self, x, cache=None, pos=None, rolled=False,
                decode=False, live=None):
        attn = self.attn(self.ln1(x.float()), cache=cache, pos=pos,
                         rolled=rolled, decode=decode, live=live)
        new_cache = None
        if cache is not None:
            attn, new_cache = attn
        x = x + attn
        y = self.mlp_in(self.ln2(x.float()), self.dtype)
        y = self.mlp_out(F.gelu(y, approximate="tanh"), self.dtype)
        out = x + y
        return out if new_cache is None else (out, new_cache)


class LMHead(nn.Module):
    def __init__(self, d_model: int, vocab_size: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.head = Dense(d_model, vocab_size)

    def forward(self, x):
        return self.head(self.ln_f(x.float()), self.dtype).float()


def validate_attention_features(*, heads: int, head_dim: int,
                                causal: bool, window: int | None,
                                kv_heads: int | None,
                                pos_embedding: str) -> bool:
    """Build-time validation of the attention feature set; returns
    whether RoPE is enabled."""
    if window is not None:
        if not causal:
            raise ParamError(
                "window (causal sliding-window attention) requires "
                "causal=True"
            )
        if int(window) < 1:
            raise ParamError(f"window must be >= 1, got {window}")
    if kv_heads is not None and (kv_heads < 1 or heads % kv_heads):
        raise ParamError(
            f"kv_heads ({kv_heads}) must be >= 1 and divide heads "
            f"({heads})"
        )
    if pos_embedding not in ("learned", "rope"):
        raise ParamError(
            f"pos_embedding must be 'learned' or 'rope', got "
            f"'{pos_embedding}'"
        )
    if pos_embedding == "rope" and head_dim % 2:
        raise ParamError(
            f"RoPE needs an even head_dim, got {head_dim}"
        )
    return pos_embedding == "rope"


@register_model("transformer_lm")
def transformer_lm(
    vocab_size: int = 1024,
    d_model: int = 128,
    heads: int = 4,
    depth: int = 2,
    d_ff: int = 0,
    max_len: int = 512,
    causal: bool = True,
    attn_impl: str = AUTO,
    window: int | None = None,
    kv_heads: int | None = None,
    pos_embedding: str = "learned",
    mesh: Any = None,
) -> NamedGraph:
    """Decoder-only LM (or bidirectional encoder with ``causal=False``)
    with per-token logits. The graph's blocks live on the ``meta``
    device; weights come from
    :func:`~mmlspark_tpu_torch.models.bridge.init_variables` or
    :func:`~mmlspark_tpu_torch.models.bridge.load_flax_variables`."""
    if d_model % heads:
        raise ParamError(f"d_model {d_model} not divisible by heads {heads}")
    if mesh is not None:
        raise ParamError(
            "meshes are not ported yet (ROADMAP.md Queue 1 item 13); "
            "build without mesh"
        )
    rope = validate_attention_features(
        heads=heads, head_dim=d_model // heads, causal=causal,
        window=window, kv_heads=kv_heads, pos_embedding=pos_embedding,
    )
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
                Block(d_model, heads, d_model // heads, d_ff, causal,
                      window=window, kv_heads=kv_heads, rope=rope,
                      attn_impl=attn_impl),
            ))
        blocks.append((FINAL_NODE, LMHead(d_model, vocab_size)))
    return NamedGraph(
        name="transformer_lm",
        blocks=blocks,
        input_shape=(max_len,),
        extra={
            "vocab_size": vocab_size,
            "attn_impl": attn_impl,
            "causal": causal,
            "heads": heads,
            "window": window,
            "kv_heads": kv_heads,
            "pos_embedding": pos_embedding,
        },
    )
