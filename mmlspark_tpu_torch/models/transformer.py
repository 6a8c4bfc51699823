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
JAX package picks its Pallas kernel on a TPU. ``ring``/``ulysses`` are
the sequence-parallel paths of :mod:`mmlspark_tpu_torch.parallel.
context_parallel` over the graph's ``mesh`` (every rank runs the model;
the attention shards the sequence), and degrade to ``dense`` when no mesh
is given, as in the JAX package.

**The split forward** (the serving engine's and the trainer's mesh
modes): :func:`split_graph` makes a rank's copy of the graph over its
shard of the weights (``parallel/sharding.py``'s :func:`~mmlspark_tpu_torch.
parallel.sharding.local_variables`), Megatron-style over the mesh's
``model`` axis — attention over the rank's heads, ``attn_out`` and
``mlp_out`` row-parallel (the partial products summed over ``model``,
then the replicated bias added), ``qkv`` and ``mlp_in`` column-parallel,
the token embedding vocab-parallel (a masked lookup of the rank's rows,
then a sum) and the ``head`` column-parallel, giving the rank's vocab
slice of the logits (the greedy combine is ``models/generate.
greedy_next``'s, the training loss ``train/distributed.
vocab_parallel_loss_terms``). Under autograd each sum's backward is the
identity and each column-parallel input's backward sums the ranks'
partial gradients over ``model`` (``parallel/mesh.ModelPlace``), so
every replicated leaf — the layer norms, the row-parallel biases, the
position table — ends the backward with its whole gradient on every
rank; under ``no_grad`` both moves are the serving engine's, unchanged.
Without a mesh the code path and the arithmetic are the ones above.
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

def resolve_attn_impl(attn_impl: str) -> str:
    """``auto`` -> ``flash`` when PyTorch sees a GPU, else ``dense`` (the
    JAX package's ``is_tpu()`` choice at build time); the others stay."""
    if attn_impl not in ATTN_IMPLS:
        raise ParamError(
            f"unknown attn_impl '{attn_impl}'; one of {ATTN_IMPLS}"
        )
    if attn_impl == AUTO:
        return FLASH if has_cuda() else DENSE
    return attn_impl


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: f32 weight
    (out, in) and bias; ``forward(x, dtype)`` casts the input and the
    parameters to the caller's compute dtype and adds the bias after the
    product — two roundings, as in flax. ``bias=False`` is flax's
    ``use_bias=False``. A row-parallel Dense of the split forward holds
    its rows of the weight and a ``reduce`` (a ``parallel.mesh.
    ModelPlace``): the partial product is summed over ``model`` before
    the replicated bias is added. A column-parallel one holds its
    columns and a ``copy``: its whole input enters through
    ``model_copy``, whose backward sums the ranks' partial input
    gradients."""

    #: the split forward's row-parallel sum and column-parallel copy
    #: (None: a whole Dense)
    reduce = None
    copy = None

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x, dtype):
        if self.copy is not None:
            x = self.copy.model_copy(x)
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        if self.reduce is not None:
            y = self.reduce.model_sum(y)
        return y if self.bias is None else y + self.bias.to(dtype)


class TokenPosEmbed(nn.Module):
    #: the split forward's vocab-parallel sum (None: the whole table) and
    #: the first vocab id of this rank's rows
    reduce = None
    vocab_start = 0

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
        if self.reduce is None:
            tok = self.token(ids)
        else:
            # vocab-parallel: this rank's rows of the table, zero for ids
            # outside them; the sum over model has one non-zero term
            local = ids - self.vocab_start
            inside = (local >= 0) & (local < self.token.num_embeddings)
            tok = self.token(torch.where(inside, local, 0))
            tok = self.reduce.model_sum(
                torch.where(inside[..., None], tok, 0.0))
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
    """``variables`` with every ``Dense`` leaf (weight and bias) — and
    every leaf a child module lists in ``COMPUTE_DTYPE_LEAVES`` (the MoE
    expert weights, ``models/moe.py``) — cast once to the compute dtype
    its caller passes (the ``dtype`` of the module that owns it): a new
    dict, the other leaves the same tensors. The forward casts those
    parameters to that dtype on every call, and a cast to the dtype a
    tensor already has returns it unchanged, so the model's outputs are
    bit-equal on either dict. The serving engine keeps the cast copy in
    place of the f32 leaves, which it then never reads."""
    out = {}
    for name, mod in graph.blocks:
        block = dict(variables[name])
        for path, owner in mod.named_modules():
            dtype = getattr(owner, "dtype", None)
            if not isinstance(dtype, torch.dtype):
                continue
            for child, sub in owner.named_children():
                leaves = (("weight", "bias") if isinstance(sub, Dense)
                          else getattr(sub, "COMPUTE_DTYPE_LEAVES", ()))
                for leaf in leaves:
                    key = ".".join(filter(None, (path, child, leaf)))
                    t = block.get(key)
                    if isinstance(t, torch.Tensor) and t.is_floating_point():
                        block[key] = t.to(dtype)
        out[name] = block
    return out


class SelfAttention(nn.Module):
    """Multi-head (or grouped-query) self-attention. Without a cache it
    runs ``attn_impl`` (resolved by ``transformer_lm``): ``flash``,
    ``dense``, or ``ring``/``ulysses`` over ``mesh`` (a
    :func:`~mmlspark_tpu_torch.parallel.mesh.make_mesh` DeviceMesh; dense
    without one)."""

    def __init__(self, d_model: int, heads: int, head_dim: int,
                 causal: bool, window: int | None = None,
                 kv_heads: int | None = None, rope: bool = False,
                 dtype=torch.bfloat16, attn_impl: str = DENSE,
                 mesh: Any = None):
        super().__init__()
        self.attn_impl = attn_impl
        self.mesh = mesh
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
        elif self.attn_impl == DENSE or self.mesh is None:
            # ring/ulysses degrade to dense when no mesh is provided
            o = dense_attention(q, k, v, causal=self.causal,
                                window=self.window)
        elif self.attn_impl == RING:
            from mmlspark_tpu_torch.parallel.context_parallel import (
                ring_attention,
            )

            o = ring_attention(q, k, v, self.mesh, causal=self.causal,
                               window=self.window)
        else:
            from mmlspark_tpu_torch.parallel.context_parallel import (
                ulysses_attention,
            )

            o = ulysses_attention(q, k, v, self.mesh, causal=self.causal,
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
                 rope: bool = False, attn_impl: str = DENSE,
                 mesh: Any = None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = SelfAttention(
            d_model, heads, head_dim, causal, window=window,
            kv_heads=kv_heads, rope=rope, dtype=dtype, attn_impl=attn_impl,
            mesh=mesh,
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
    :func:`~mmlspark_tpu_torch.models.bridge.load_flax_variables`.
    ``mesh`` carries the sequence axis ``ring``/``ulysses`` shard over;
    the trainer's mesh mode trains the graph on it (``param_rules``:
    ``TRANSFORMER_TP_RULES``: each rank runs :func:`split_graph`'s copy).
    The serving engine's mesh mode takes its own ``mesh`` and runs each
    rank on the same copy."""
    if d_model % heads:
        raise ParamError(f"d_model {d_model} not divisible by heads {heads}")
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
                      attn_impl=attn_impl, mesh=mesh),
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


def split_graph(graph: NamedGraph, split, place) -> NamedGraph:
    """This rank's copy of a transformer LM ``graph`` for the split
    forward: the blocks copied on ``meta`` and resized to the rank's
    shard under ``split`` (a ``parallel.sharding.ModelSplit``) — local
    heads and kv heads, ``d_ff / model`` hidden columns, ``vocab /
    model`` embedding rows and head columns — with the row-parallel and
    vocab-parallel modules summing over ``place``'s ``model`` axis.
    The column-parallel ``qkv``, ``mlp_in`` and ``head`` take their
    input through ``place``'s ``model_copy`` (the backward's sum).
    ``extra`` records the local ``heads``/``kv_heads``, the ``head_dim``,
    ``mesh_place`` (the data gather of the decode block) and
    ``vocab_split`` (``place`` when the head is vocab-parallel: the
    greedy combine), ``vocab_size`` staying the whole vocabulary. Bind it
    to :func:`~mmlspark_tpu_torch.parallel.sharding.local_variables`.
    Ulysses attention over ``seq`` needs the rank's q and kv heads to
    divide by ``seq``: a ``ParamError`` otherwise."""
    from mmlspark_tpu_torch.models.graph import _meta_copy
    from mmlspark_tpu_torch.parallel.mesh import SEQUENCE_AXIS, mesh_shape

    blocks = []
    with torch.device("meta"):
        for name, mod in graph.blocks:
            mod = _meta_copy(mod)
            if split.vocab and isinstance(mod, TokenPosEmbed):
                n = mod.token.num_embeddings // split.size
                mod.token = nn.Embedding(n, mod.token.embedding_dim)
                mod.reduce = place
                mod.vocab_start = split.index * n
            if split.vocab and isinstance(mod, LMHead):
                w = mod.head.weight
                mod.head = Dense(w.shape[1], w.shape[0] // split.size)
                mod.head.copy = place
            attn = getattr(mod, "attn", None)
            if split.attn and isinstance(attn, SelfAttention):
                d, d_model = split.head_dim, attn.qkv.weight.shape[1]
                attn.heads = split.local_heads
                attn.kv_heads = split.local_kv_heads
                attn.qkv = Dense(d_model, (split.local_heads
                                           + 2 * split.local_kv_heads) * d)
                attn.qkv.copy = place
                attn.attn_out = Dense(split.local_heads * d, d_model)
                attn.attn_out.reduce = place
                seq = mesh_shape(attn.mesh).get(SEQUENCE_AXIS, 1) \
                    if attn.mesh is not None else 1
                if attn.attn_impl == ULYSSES and (
                        split.local_heads % seq
                        or split.local_kv_heads % seq):
                    raise ParamError(
                        f"ulysses over '{SEQUENCE_AXIS}' ({seq}) needs "
                        f"each model rank's heads divisible by it: "
                        f"{split.heads} heads ({split.kv_heads} kv) over "
                        f"model ({split.size}) leave "
                        f"{split.local_heads} ({split.local_kv_heads} kv) "
                        "a rank")
            if split.mlp and isinstance(mod, Block):
                d_model, d_ff = mod.mlp_in.weight.shape[1], \
                    mod.mlp_in.weight.shape[0]
                mod.mlp_in = Dense(d_model, d_ff // split.size)
                mod.mlp_in.copy = place
                mod.mlp_out = Dense(d_ff // split.size, d_model)
                mod.mlp_out.reduce = place
            blocks.append((name, mod))
    extra = dict(graph.extra, head_dim=split.head_dim, mesh_place=place,
                 vocab_split=place if split.vocab else None)
    if split.attn:
        extra.update(heads=split.local_heads,
                     kv_heads=split.local_kv_heads)
    return NamedGraph(name=graph.name, blocks=blocks,
                      input_shape=graph.input_shape,
                      compute_dtype=graph.compute_dtype, extra=extra)
