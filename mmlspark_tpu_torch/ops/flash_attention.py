"""Attention kernels — the port of ``mmlspark_tpu/ops/flash_attention.py``:
the cache-free ``flash_attention`` with its gradient, and the length-aware
single-token reads ``flash_decode`` and ``paged_flash_decode``, each with
its int8 mode.

``flash_attention`` is blockwise causal / windowed grouped-query attention
for the forward of training and scoring. It is a
``torch.autograd.Function``: the forward keeps the row log-sum-exp (a
compact (B·H, S) f32 tensor) when an input requires grad, and the
backward recomputes P from it. On a CUDA tensor the forward launches a
kernel replacing the Pallas ``_fwd_kernel``: bf16 at head dims 64 and
128 with 16-byte-aligned rows takes the tensor-core kernel
``csrc/flash_attention_fwd_mma.cu``, any other input
``csrc/flash_attention_fwd.cu`` (:func:`_fwd_route` picks before the
launch). The backward launches two kernels, dK/dV and dQ (replacing
``_bwd_kv_kernel`` and ``_bwd_q_kernel``), on the same rule
(:func:`_bwd_route`): the tensor-core pair
``csrc/flash_attention_bwd_mma.cu`` for bf16 at head dims 64 and 128
with 16-byte-aligned rows, ``csrc/flash_attention_bwd.cu`` for any other
input. On a CPU tensor both run their plain versions,
:func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`.

The serving hot path decodes ONE query token per slot per step. Both
functions read only each row's live prefix ``[0, lengths[b])``, so per-row
work and bytes scale with what the request has generated, not with the
pool's capacity. ``flash_decode`` reads ``(B, cache_len, Hkv, D)`` slot
caches; ``paged_flash_decode`` reads ``(num_pages, Hkv, page_size, D)``
page stores through a ``(B, max_pages)`` page table. int8 K/V come with
f32 dequantization scales: per (row, kv head) for the dense pool, per
(page, kv head) for the paged pool.

On a CUDA tensor each launches a hand-written Hopper kernel built on
first use by :mod:`kernel_build`: ``csrc/flash_decode.cu`` (replacing the
Pallas ``_decode_kernel`` and ``_decode_kernel_q8``) and
``csrc/paged_flash_decode.cu`` (replacing ``_paged_decode_kernel`` and
``_paged_decode_kernel_q8``): split-KV, one block per chunk of
:data:`DECODE_CHUNK` positions of one (row, kv head), then a small
kernel that combines a row's chunks in order (:func:`decode_plan`); a
refused launch raises. On a CPU tensor
each runs its plain PyTorch version (:func:`flash_decode_reference`,
:func:`paged_flash_decode_reference`), which the tests hold to the JAX
kernels and ``chip_smoke.py`` holds the CUDA kernels to. There is no
other route and no fallback between the two.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd.function import once_differentiable

from mmlspark_tpu_torch.ops.attention import (
    KERNEL_NEG_INF,
    _validate_and_expand_gqa,
)
from mmlspark_tpu_torch.ops.kernel_build import bind as _bind

# the C signature table of every kernel library lives beside the builder
# (ops/kernel_build.py); its names stay importable here, where the
# kernel-plan tests read the attention entry points' signatures
from mmlspark_tpu_torch.ops.kernel_build import (  # noqa: unused
    I32 as _I32,
    I64 as _I64,
    PTR as _PTR,
    SIGNATURES as _SIGNATURES,
)

#: launches of each CUDA kernel in this process — added to where its
#: wrapper launches it and nowhere else; ``chip_smoke.py`` resets and
#: reads them to show a main path went through the kernels.
#: ``launches``: float dense decode; ``q8_launches``: int8 dense;
#: ``paged_launches``: float paged; ``paged_q8_launches``: int8 paged;
#: ``fwd_launches``: the attention forward (either route), of which
#: ``fwd_mma_launches`` took the tensor-core kernel; ``bwd_kv_launches``
#: and ``bwd_q_launches``: its two backward kernels (either route), of
#: which ``bwd_kv_mma_launches`` and ``bwd_q_mma_launches`` took the
#: tensor-core pair
launches = 0
q8_launches = 0
paged_launches = 0
paged_q8_launches = 0
fwd_launches = 0
fwd_mma_launches = 0
bwd_kv_launches = 0
bwd_q_launches = 0
bwd_kv_mma_launches = 0
bwd_q_mma_launches = 0
#: every counter above, for whoever resets or adds to them (a captured
#: program adds its launches on each replay, ``testing/compile_guard.py``)
COUNTERS = ("launches", "q8_launches", "paged_launches",
            "paged_q8_launches", "fwd_launches", "fwd_mma_launches",
            "bwd_kv_launches", "bwd_q_launches", "bwd_kv_mma_launches",
            "bwd_q_mma_launches")

#: the decode kernels' own FLOPs and bytes while a cost analysis runs
#: (:func:`meta_cost`); None otherwise
_meta_acc: dict | None = None


@contextlib.contextmanager
def meta_cost():
    """Collect the decode kernels' FLOPs and bytes over a run on ``meta``
    tensors (``core/perf.analyze_program_cost``): a ``ctypes`` launch is
    invisible to a dispatch mode, so each decode wrapper, given ``meta``
    tensors, launches nothing and adds its kernel's figures here
    instead. Yields the ``{"flops", "bytes"}`` accumulator."""
    global _meta_acc
    prev, _meta_acc = _meta_acc, {"flops": 0, "bytes": 0}
    try:
        yield _meta_acc
    finally:
        _meta_acc = prev


def _meta_decode(q, L: int, hk: int, kv_elem: int, extra_bytes: int):
    """A decode call on ``meta`` tensors: no launch and no raise; the
    output's shape, and the kernel's figures added to :func:`meta_cost`
    by the formula of ``PERF.md``'s bounds — q.k and p.v at 2 FLOPs a
    multiply-add, each K and V row read once, q in and out, the lengths —
    over every one of the ``L`` positions (a meta tensor holds no live
    lengths)."""
    b, _, h, d = q.shape
    if _meta_acc is not None:
        _meta_acc["flops"] += 4 * b * L * h * d
        _meta_acc["bytes"] += (2 * b * L * hk * d * kv_elem
                               + 2 * b * h * d * q.element_size()
                               + b * 4 + extra_bytes)
    return torch.empty_like(q)


#: smallest page and the page unit: the paged pool's API contract
#: (``serve/paging.py``), kept from the JAX package, where a page's
#: (page_size, D) face is the Pallas kernel's KV block and must tile in
#: whole 8-row sublanes
MIN_PAGE_SIZE = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_HEAD_DIM = 128
#: the widest head the attention kernels take (their shared-memory tiles)
MAX_ATTENTION_HEAD_DIM = 256
#: the head dims the tensor-core forward and backward are built for
MMA_HEAD_DIMS = (64, 128)
#: positions one split-KV decode block reads: a multiple of every page
#: size the engine uses (a page size that does not divide it gets chunks
#: of whole pages); chunk boundaries depend on the position alone, so a
#: row's result does not depend on its batch or cache length
DECODE_CHUNK = 64


# -- cache-free attention and its gradient -------------------------------------


def flash_attention(q, k, v, *, causal: bool = False, window=None,
                    scale=None, block: int = 128):
    """Blockwise fused attention, (B, S, H, D) layout, with exact
    gradients through :func:`flash_attention_backward_reference`'s math.

    Grouped-query attention: ``k``/``v`` may carry fewer heads (Hkv
    dividing H); query head i attends kv head ``i // (H // Hkv)``, and
    dK/dV come back per kv head. ``window=W`` (with ``causal=True``)
    restricts each query to its W most recent keys. q, k and v share one
    dtype; the output has it.

    ``block`` is accepted for the JAX signature: the CUDA kernels use
    their own tiles (64 positions, 32 for head dims over 128) and the
    plain versions none, so results equal the JAX kernels' up to the
    order of the sums (and, in bf16, where P is rounded against a
    running max). When no input requires grad the forward skips the
    log-sum-exp, as the JAX primal path does. There is no second
    derivative (the JAX VJP has none either).
    """
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            "flash_attention requires q, k, v to share one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.shape[2] != v.shape[2] or q.shape[2] % k.shape[2]:
        raise ValueError(
            "flash_attention needs k/v heads equal and dividing q heads, "
            f"got q={q.shape[2]} k={k.shape[2]} v={v.shape[2]}"
        )
    if window is not None:
        if not causal:
            raise ValueError(
                "flash_attention window=W is the causal sliding window; "
                "pass causal=True with it"
            )
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        window = int(window)
    # the JAX package's rule: a falsy scale means 1/sqrt(D)
    scale = float(scale) if scale else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), window, scale)
    out, _ = flash_attention_forward(q, k, v, causal=bool(causal),
                                     window=window, scale=scale,
                                     with_lse=False)
    return out


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX package's ``_build``: the forward saves
    (q, k, v, out, lse), the backward returns (dq, dk, dv) in the input
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dq, dk, dv = flash_attention_backward(*ctx.saved_tensors, g,
                                              **ctx.attn)
        return dq, dk, dv, None, None, None


def flash_attention_forward(q, k, v, *, causal: bool, window, scale: float,
                            with_lse: bool = True):
    """The forward of :func:`flash_attention` on validated arguments (the
    JAX package's ``_flash_forward``): ``(out, lse)``, the LSE compact
    (B·H, S) f32, or None without ``with_lse``. A CUDA tensor launches
    the forward kernel; a CPU tensor runs
    :func:`flash_attention_reference`."""
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, causal=causal,
                                             window=window, scale=scale)
        return out, (lse if with_lse else None)
    _require_cuda(q, "flash_attention")
    return _launch_attention_fwd(q, k, v, causal, window, scale, with_lse)


def flash_attention_backward(q, k, v, out, lse, g, *, causal: bool, window,
                             scale: float):
    """(dq, dk, dv) from the forward's residuals and the cotangent ``g``
    (the JAX package's ``_flash_backward``). A CUDA tensor launches the
    dK/dV and dQ kernels of the route :func:`_bwd_route` picks; a CPU
    tensor runs :func:`flash_attention_backward_reference`."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, g, causal=causal, window=window, scale=scale)
    _require_cuda(q, "flash_attention")
    ops = _backward_operands(q, k, v, out, lse, g)
    mma = _bwd_route(*ops[:4]) == "mma"
    dk, dv = _launch_bwd_kv(ops, causal, window, scale, mma)
    return _launch_bwd_q(ops, causal, window, scale, mma), dk, dv


def _attention_live(s: int, causal: bool, window, device):
    """(S, S) bool: which (query, key) pairs attend."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    live = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        live = live & (kpos <= qpos)
    if window is not None:
        live = live & (kpos > qpos - window)
    return live


def _row_delta(out, g):
    """D = rowsum(dO ⊙ O) in f32, as the compact (B·H, S) rows the
    kernels read."""
    b, s, h, _ = out.shape
    dd = (g.float() * out.float()).sum(dim=-1)  # (B, S, H)
    return dd.transpose(1, 2).reshape(b * h, s).contiguous()


def flash_attention_reference(q, k, v, *, causal: bool = False, window=None,
                              scale=None):
    """Plain PyTorch attention forward with the Pallas kernel's math:
    f32 scores times ``scale``, dead pairs dropped (P exactly 0), P
    rounded to V's dtype before P·V, f32 sums, out in q's dtype. Returns
    ``(out, lse)`` with the row log-sum-exp as compact (B·H, S) f32; a
    row with no live key (``l == 0``) gives zeros and LSE
    ``KERNEL_NEG_INF``."""
    b, s, h, d = q.shape
    if not scale:
        scale = d ** -0.5
    kx, vx = _validate_and_expand_gqa(q, k, v)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) * scale
    live = _attention_live(s, causal, window, q.device)
    m = torch.where(live, sc, torch.full_like(sc, float("-inf")))
    m = m.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(live, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1)  # (B, H, S)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vx.float())
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (pv / denom.transpose(1, 2)[..., None]).to(q.dtype)
    lse = torch.where(l == 0.0, torch.full_like(l, KERNEL_NEG_INF),
                      m[..., 0] + torch.log(denom))
    return out, lse.reshape(b * h, s)


def flash_attention_backward_reference(q, k, v, out, lse, g, *,
                                       causal: bool = False, window=None,
                                       scale=None):
    """Plain PyTorch gradient of :func:`flash_attention`, with the Pallas
    backward's math: P recomputed from q, k and the compact (B·H, S)
    ``lse`` (dead pairs exactly 0), ``dS = P ⊙ (dO·Vᵀ − D)`` with
    ``D = rowsum(dO ⊙ O)``, P rounded to dO's dtype before dV and dS to
    q's (k's) dtype before dK (dQ), f32 sums. Under GQA dK/dV are
    computed per query head, rounded to the input dtype, and summed over
    the group in f32, as the JAX wrapper does. Returns (dq, dk, dv) in the
    input dtypes."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    if not scale:
        scale = d ** -0.5
    kx, vx = _validate_and_expand_gqa(q, k, v)
    dd = _row_delta(out, g).reshape(b, h, s, 1)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) * scale
    live = _attention_live(s, causal, window, q.device)
    p = torch.where(live, torch.exp(sc - lse.reshape(b, h, s, 1)),
                    torch.zeros_like(sc))
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), vx.float())
    ds = p * (dp - dd)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      kx.float()) * scale
    dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    if h != hk:
        grp = h // hk
        dk = dk.reshape(b, s, hk, grp, d).float().sum(dim=3).to(k.dtype)
        dv = dv.reshape(b, s, hk, grp, d).float().sum(dim=3).to(v.dtype)
    return dq.to(q.dtype), dk, dv


def _validate_kv_scales(q, kv_dtype, hk: int, b: int, k_scale, v_scale,
                        d: int, name: str) -> bool:
    """Shared int8-mode argument contract for both decode functions:
    int8 K/V requires BOTH f32 scale tensors and a float query; float
    K/V must not pass scales (a silent no-op scale would mask a pool
    wiring bug). Returns True when the int8 path is active."""
    quantized = kv_dtype == torch.int8
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError(
                f"{name}: int8 K/V requires k_scale and v_scale"
            )
        if not q.dtype.is_floating_point:
            raise ValueError(
                f"{name}: int8 K/V needs a float query, got {q.dtype}"
            )
        if d % 2:
            raise ValueError(
                f"{name}: int8 K/V requires an even head_dim (the pools' "
                f"int8 contract, kept from the JAX package), got {d}"
            )
    elif k_scale is not None or v_scale is not None:
        raise ValueError(
            f"{name}: k_scale/v_scale are int8-mode arguments; K/V "
            f"here are {kv_dtype}"
        )
    return quantized


def _as_scales(k_scale, v_scale, want, device, name: str, per: str):
    k_scale = torch.as_tensor(k_scale, dtype=torch.float32, device=device)
    v_scale = torch.as_tensor(v_scale, dtype=torch.float32, device=device)
    if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        raise ValueError(
            f"{name} int8 scales must be {want} — one f32 per ({per}, kv "
            f"head) — got {tuple(k_scale.shape)}/{tuple(v_scale.shape)}"
        )
    return k_scale, v_scale


def flash_decode(q, k, v, lengths, *, scale=None, k_scale=None,
                 v_scale=None):
    """Attention for ONE query token per row over live cache prefixes.

    ``q`` is (B, 1, H, D); ``k``/``v`` are the (B, L, Hkv, D) slot
    caches, Hkv dividing H (query head ``h`` reads kv head
    ``h // (H // Hkv)``); ``lengths`` is (B,) int32 — row b attends cache
    positions ``[0, lengths[b])`` (the ``pos + 1`` contract of
    :func:`~mmlspark_tpu_torch.ops.attention.decode_live_lengths`),
    clipped to [0, L]. A row with length 0 yields zeros. Inference only.

    int8 mode: when ``k``/``v`` are int8, ``k_scale``/``v_scale`` —
    (B, Hkv) f32, the dense pool's per-(slot, kv-head) quantization
    scales — must be passed: ``k_scale`` folds into the softmax scale,
    ``v_scale`` multiplies the P·V sum. ``q`` stays float and sets the
    output dtype.
    """
    if k.dtype != v.dtype:
        raise ValueError(
            f"flash_decode requires k and v to share one dtype, got "
            f"{k.dtype}/{v.dtype}"
        )
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(
            "flash_decode takes a SINGLE query token per row: q must be "
            f"(B, 1, H, D), got {tuple(q.shape)}"
        )
    if k.shape[2] != v.shape[2] or q.shape[2] % k.shape[2]:
        raise ValueError(
            "flash_decode needs k/v heads equal and dividing q heads, "
            f"got q={q.shape[2]} k={k.shape[2]} v={v.shape[2]}"
        )
    b, _, h, d = q.shape
    quantized = _validate_kv_scales(
        q, k.dtype, k.shape[2], b, k_scale, v_scale, d, "flash_decode"
    )
    if not quantized and q.dtype != k.dtype:
        raise ValueError(
            "flash_decode requires q, k, v to share one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if quantized:
        k_scale, v_scale = _as_scales(
            k_scale, v_scale, (b, k.shape[2]), q.device, "flash_decode",
            "row",
        )
    if k.shape[0] != b or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(
            f"k/v must be (B={b}, L, Hkv, D={d}) alike, got "
            f"{tuple(k.shape)}/{tuple(v.shape)}"
        )
    lengths = torch.as_tensor(lengths, device=q.device)
    if tuple(lengths.shape) != (b,):
        raise ValueError(
            f"lengths must be ({b},) — one live length per batch row — "
            f"got {tuple(lengths.shape)}"
        )
    if scale is None:
        scale = d ** -0.5
    # the kernels and the plain version clamp each length to [0, L]
    lengths = lengths.to(torch.int32)
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, lengths, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "meta":
        return _meta_decode(q, k.shape[1], k.shape[2], k.element_size(),
                            2 * 4 * b * k.shape[2] if quantized else 0)
    _require_cuda(q, "flash_decode")
    return _launch_dense(q, k, v, lengths, float(scale), k_scale, v_scale)


def paged_flash_decode(q, k_pages, v_pages, lengths, page_table, *,
                       scale=None, k_scale=None, v_scale=None):
    """:func:`flash_decode` over PAGED caches.

    ``q`` is (B, 1, H, D); ``k_pages``/``v_pages`` are the physical page
    stores ``(num_pages, Hkv, page_size, D)`` shared by all rows;
    ``page_table`` is (B, max_pages) int32 mapping row b's logical page
    j to physical page ``page_table[b, j]`` (every entry a live position
    reaches must be a valid page id — the pool points unmapped entries at
    a trash page); ``lengths`` is the (B,) live-length vector of
    :func:`flash_decode`, in LOGICAL positions. The virtual cache length
    is ``max_pages * page_size``.

    int8 mode: when the page stores are int8, ``k_scale``/``v_scale`` —
    (num_pages, Hkv) f32, the paged pool's PER-PAGE quantization scales
    — must be passed; each page's scales apply to that page's positions.
    """
    if k_pages.dtype != v_pages.dtype:
        raise ValueError(
            f"paged_flash_decode requires k and v pages to share one "
            f"dtype, got {k_pages.dtype}/{v_pages.dtype}"
        )
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(
            "paged_flash_decode takes a SINGLE query token per row: q "
            f"must be (B, 1, H, D), got {tuple(q.shape)}"
        )
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            "k_pages/v_pages must share one (num_pages, Hkv, page_size, "
            f"D) shape, got {tuple(k_pages.shape)} vs "
            f"{tuple(v_pages.shape)}"
        )
    if q.shape[2] % k_pages.shape[1]:
        raise ValueError(
            "paged_flash_decode needs k/v heads equal and dividing q "
            f"heads, got q={q.shape[2]} kv={k_pages.shape[1]}"
        )
    b, _, h, d = q.shape
    if k_pages.shape[3] != d:
        raise ValueError(
            f"page faces must have head_dim D={d}, got "
            f"{tuple(k_pages.shape)}"
        )
    quantized = _validate_kv_scales(
        q, k_pages.dtype, k_pages.shape[1], b, k_scale, v_scale, d,
        "paged_flash_decode",
    )
    if not quantized and q.dtype != k_pages.dtype:
        raise ValueError(
            "paged_flash_decode requires q, k, v to share one dtype, got "
            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if quantized:
        k_scale, v_scale = _as_scales(
            k_scale, v_scale, (k_pages.shape[0], k_pages.shape[1]),
            q.device, "paged_flash_decode", "page",
        )
    ps = k_pages.shape[2]
    if ps % MIN_PAGE_SIZE:
        raise ValueError(
            f"page_size must be a multiple of {MIN_PAGE_SIZE} (the paged "
            f"pool's page unit), got {ps}"
        )
    page_table = torch.as_tensor(page_table, device=q.device)
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(
            f"page_table must be ({b}, max_pages) int32 — one row per "
            f"batch row — got {tuple(page_table.shape)}"
        )
    lengths = torch.as_tensor(lengths, device=q.device)
    if tuple(lengths.shape) != (b,):
        raise ValueError(
            f"lengths must be ({b},) — one live length per batch row — "
            f"got {tuple(lengths.shape)}"
        )
    if scale is None:
        scale = d ** -0.5
    # the kernels and the plain version clamp each length to [0, L]
    lengths = lengths.to(torch.int32)
    page_table = page_table.to(torch.int32)
    if q.device.type == "cpu":
        return paged_flash_decode_reference(
            q, k_pages, v_pages, lengths, page_table, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type == "meta":
        n_pages = page_table.shape[1]
        return _meta_decode(
            q, n_pages * ps, k_pages.shape[1], k_pages.element_size(),
            b * n_pages * 4
            + (2 * 4 * b * n_pages * k_pages.shape[1] if quantized else 0))
    _require_cuda(q, "paged_flash_decode")
    return _launch_paged(q, k_pages, v_pages, lengths, page_table,
                         float(scale), k_scale, v_scale)


# -- plain versions -----------------------------------------------------------


def _attend(q, k, v, lengths, scale, k_scale=None, v_scale=None):
    """The plain decode read over a linear (B, L, Hkv, D) cache: f32
    scores, an f32 softmax and f32 P·V over upcast V, cast to q's dtype.
    ``k_scale``/``v_scale`` are per-POSITION (B, L, Hkv) dequantization
    scales (int8 K/V) or None: the k scale multiplies each score as
    ``scale * k_scale``, the v scale each position's p."""
    k, v = _validate_and_expand_gqa(q, k, v)
    lengths = torch.as_tensor(lengths, device=q.device).clamp(0, k.shape[1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if k_scale is None:
        s = s * scale
    else:
        rep = q.shape[2] // k_scale.shape[2]
        ks = k_scale.repeat_interleave(rep, dim=2)  # (B, L, H)
        s = s * (scale * ks.permute(0, 2, 1)[:, :, None, :])
    live = (torch.arange(k.shape[1], device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]  # (B, 1, 1, L)
    # dead positions are dropped, not exponentiated: an all-dead row
    # keeps l == 0 exactly, like the kernel that never reads them
    m = torch.where(live, s, torch.full_like(s, float("-inf")))
    m = m.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)  # (B, H, 1)
    if v_scale is not None:
        rep = q.shape[2] // v_scale.shape[2]
        vs = v_scale.repeat_interleave(rep, dim=2)
        p = p * vs.permute(0, 2, 1)[:, :, None, :]
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def flash_decode_reference(q, k, v, lengths, *, scale=None, k_scale=None,
                           v_scale=None):
    """Plain PyTorch ``flash_decode``: the same masking (positions
    ``>= lengths[b]`` never enter the softmax), the same empty-row rule
    (``l == 0`` -> zeros) and, for int8 K/V, the same scale placement as
    the kernel: ``k_scale[b, hk]`` folded into the softmax scale,
    ``v_scale[b, hk]`` onto P·V."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k_scale is not None:
        L = k.shape[1]
        k_scale = k_scale.float()[:, None, :].expand(-1, L, -1)
        v_scale = v_scale.float()[:, None, :].expand(-1, L, -1)
    return _attend(q, k, v, lengths, scale, k_scale, v_scale)


def paged_flash_decode_reference(q, k_pages, v_pages, lengths, page_table,
                                 *, scale=None, k_scale=None,
                                 v_scale=None):
    """Plain PyTorch ``paged_flash_decode``: gathers each row's pages
    (and, for int8, each page's scales) into a linear cache in logical
    order, then the read of :func:`flash_decode_reference`. A page id
    outside the stores raises (an index error), as the kernel's launch
    fails."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, n_pages = page_table.shape
    _, hk, ps, d = k_pages.shape
    idx = page_table.long()

    def linear(store):
        g = store[idx]  # (B, max_pages, Hkv, ps, D)
        return g.permute(0, 1, 3, 2, 4).reshape(b, n_pages * ps, hk, d)

    if k_scale is not None:
        k_scale = k_scale.float()[idx].repeat_interleave(ps, dim=1)
        v_scale = v_scale.float()[idx].repeat_interleave(ps, dim=1)
    return _attend(q, linear(k_pages), linear(v_pages), lengths, scale,
                   k_scale, v_scale)


# -- the CUDA launches ---------------------------------------------------------


def _require_cuda(q, name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(
            f"{name} runs on cuda (the kernel) or cpu (its plain "
            f"version), got {q.device}"
        )


def _load_width(d: int, tensors, strides) -> int:
    """int8: a lane's load, the widest of 8, 4 or 2 bytes that divides
    the row (D bytes), every row stride and every base address (8, so
    that a lane holds at most 8 elements of a row)."""
    for vec in (8, 4, 2):
        if d % vec == 0 and all(t.data_ptr() % vec == 0 for t in tensors) \
                and all(s % vec == 0 for s in strides):
            return vec
    raise ValueError(
        f"int8 K/V rows must start on 2-byte boundaries (D={d}, strides "
        f"{strides})"
    )


def _check_operands(q, kv, lengths, extra=()) -> int:
    """What the kernels take; returns a lane's K/V load width in bytes.
    q float32 or bfloat16, contiguous in its last dim; float K/V with a
    head_dim that is a multiple of 8 up to 128 and every row start
    16-byte aligned (16-byte loads); int8 K/V with an even head_dim up to
    128 (the load width follows D and the alignment)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"the decode kernels take a float32 or bfloat16 query, got "
            f"{q.dtype}"
        )
    d = q.shape[3]
    quantized = kv[0].dtype == torch.int8
    if quantized:
        if d % 2 or d > _MAX_HEAD_DIM:
            raise ValueError(
                f"the int8 decode kernels take an even head_dim up to "
                f"{_MAX_HEAD_DIM}, got {d}"
            )
    elif d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(
            f"the flash_decode kernel takes a head_dim that is a multiple "
            f"of 8 up to {_MAX_HEAD_DIM}, got {d}"
        )
    if q.shape[0] > 65535:
        raise ValueError(f"batch {q.shape[0]} exceeds the kernel grid")
    if q.stride(3) != 1:
        raise ValueError(
            f"q must be contiguous in its last dim, got strides "
            f"{q.stride()}"
        )
    for t in (*kv, lengths, *extra):
        if t.device != q.device:
            raise ValueError(f"an operand is on {t.device}, q on {q.device}")
    strides = []
    for t in kv:
        if t.stride(3) != 1:
            raise ValueError(
                f"K/V must be contiguous in their last dim, got strides "
                f"{t.stride()}"
            )
        strides += [s * t.element_size() for s in t.stride()[:3]]
    if quantized:
        return _load_width(d, kv, strides)
    if any(t.data_ptr() % 16 for t in kv) or any(s % 16 for s in strides):
        raise ValueError(
            f"k/v rows must start on 16-byte boundaries (strides "
            f"{kv[0].stride()} of {kv[0].element_size()}-byte elements)"
        )
    return 16


def decode_plan(cache_len: int, page_size=None) -> tuple[int, int]:
    """``(chunk, splits)`` of the split-KV decode kernels: ``chunk``
    positions a block — :data:`DECODE_CHUNK`, or for a paged cache the
    whole pages that cover it — and ``splits = ceil(cache_len / chunk)``
    blocks a (row, kv head), from the static cache length alone (the host
    never reads the live lengths)."""
    chunk = DECODE_CHUNK
    if page_size is not None:
        chunk = page_size * -(-DECODE_CHUNK // page_size)
    return chunk, -(-cache_len // chunk)


def decode_workspace_shape(b: int, h: int, splits: int, d: int) -> tuple:
    """The f32 workspace of one decode call: every (row, query head,
    split)'s partial — acc[D], then (m, l) — in one flat tensor."""
    return (b * h * splits * (d + 2),)


def _launch_dense(q, k, v, lengths, scale: float, k_scale, v_scale):
    global launches, q8_launches
    from mmlspark_tpu_torch.ops.kernel_build import load

    quantized = k_scale is not None
    scales = (k_scale.contiguous(), v_scale.contiguous()) if quantized \
        else ()
    vec = _check_operands(q, (k, v), lengths, scales)
    lib = _bind(load("flash_decode"))
    b, _, h, d = q.shape
    L, hk = k.shape[1], k.shape[2]
    lengths = lengths.contiguous()
    chunk, splits = decode_plan(L)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    ws = torch.empty(decode_workspace_shape(b, h, splits, d),
                     dtype=torch.float32, device=q.device)
    strides = (q.stride(0), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quantized:
            rc = lib.mml_flash_decode_q8(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lengths.data_ptr(), scales[0].data_ptr(),
                scales[1].data_ptr(), out.data_ptr(), ws.data_ptr(), b, h,
                hk, L, d, vec, chunk, splits, *strides, scale, stream,
            )
        else:
            rc = lib.mml_flash_decode(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                ws.data_ptr(), b, h, hk, L, d, chunk, splits, *strides,
                scale, stream,
            )
    _raise_on(rc, lib, "flash_decode")
    if quantized:
        q8_launches += 1
    else:
        launches += 1
    return out


def _launch_paged(q, k_pages, v_pages, lengths, page_table, scale: float,
                  k_scale, v_scale):
    global paged_launches, paged_q8_launches
    from mmlspark_tpu_torch.ops.kernel_build import load

    quantized = k_scale is not None
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{t.stride()}")
    scales = (k_scale.contiguous(), v_scale.contiguous()) if quantized \
        else ()
    vec = _check_operands(q, (k_pages, v_pages), lengths,
                          (page_table, *scales))
    lib = _bind(load("paged_flash_decode"))
    b, _, h, d = q.shape
    num_pages, hk, ps, _ = k_pages.shape
    lengths = lengths.contiguous()
    chunk, splits = decode_plan(page_table.shape[1] * ps, ps)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    ws = torch.empty(decode_workspace_shape(b, h, splits, d),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mml_paged_flash_decode(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr(),
            scales[0].data_ptr() if quantized else None,
            scales[1].data_ptr() if quantized else None,
            out.data_ptr(), ws.data_ptr(), b, h, hk, num_pages, ps,
            page_table.shape[1], d, vec, chunk, splits, q.stride(0),
            q.stride(2), scale, stream,
        )
    _raise_on(rc, lib, "paged_flash_decode")
    if quantized:
        paged_q8_launches += 1
    else:
        paged_launches += 1
    return out


def _attention_operands(tensors, d: int):
    """What the attention kernels take: float32 or bfloat16, a head dim
    up to 256, one device, 64-bit-safe grids. A tensor whose last dim is
    not contiguous is copied once (the kernels read the other dims
    through their strides)."""
    q = tensors[0]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"the attention kernels take float32 or bfloat16, got {q.dtype}"
        )
    if d > MAX_ATTENTION_HEAD_DIM:
        raise ValueError(
            f"the attention kernels take a head_dim up to "
            f"{MAX_ATTENTION_HEAD_DIM} (their shared-memory tiles), got {d}"
        )
    b, s, h, _ = q.shape
    if s < 1 or b * h > 65535:
        raise ValueError(
            f"the attention kernels take 1 <= S and B·H <= 65535, got "
            f"{tuple(q.shape)}"
        )
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"an operand is on {t.device}, q on {q.device}")
    return [t if t.stride(-1) == 1 else t.contiguous() for t in tensors]


def _strides(*tensors):
    """The (batch, position, head) strides of each (B, S, heads, D)
    tensor, in elements."""
    return [st for t in tensors for st in t.stride()[:3]]


def _rows_16b(t) -> bool:
    """Does every row of this (B, S, heads, D) tensor start on a 16-byte
    boundary (its base and its batch, position and head strides)?"""
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in t.stride()[:3])


def _fwd_route(q, k, v) -> str:
    """Which forward kernel takes these operands (last dims contiguous):
    ``"mma"``, the tensor-core kernel, for bf16 at a head dim it is built
    for with every row on a 16-byte boundary (its 16-byte ``cp.async``
    loads); ``"simt"``, the f32-FMA kernel, for anything else — float32
    (whose card-vs-CPU training check needs f32 products) and other head
    dims. A choice by shape, made before the launch; nothing falls back."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in MMA_HEAD_DIMS:
        return "simt"
    return "mma" if all(_rows_16b(t) for t in (q, k, v)) else "simt"


def _bwd_route(q, k, v, g) -> str:
    """Which backward pair takes these operands (``g`` is dO, in q's
    dtype; last dims contiguous): the rule of :func:`_fwd_route`, with
    dO's rows on 16-byte boundaries too (the pair stages its tiles as Q's
    are staged)."""
    return _fwd_route(q, k, v) if _rows_16b(g) else "simt"


def _launch_attention_fwd(q, k, v, causal, window, scale, with_lse):
    global fwd_launches, fwd_mma_launches
    from mmlspark_tpu_torch.ops.kernel_build import load

    b, s, h, d = q.shape
    q, k, v = _attention_operands((q, k, v), d)
    mma = _fwd_route(q, k, v) == "mma"
    lib = _bind(load("flash_attention_fwd_mma" if mma
                     else "flash_attention_fwd"))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, s, h, k.shape[2], d,
            *_strides(q, k, v), scale, int(causal), window or 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mma:
            rc = lib.mml_flash_attention_fwd_mma(*args, stream)
        else:
            rc = lib.mml_flash_attention_fwd(_DTYPE_CODES[q.dtype], *args,
                                             stream)
    _raise_on(rc, lib, "flash_attention forward")
    fwd_launches += 1
    if mma:
        fwd_mma_launches += 1
    return out, lse


def _backward_operands(q, k, v, out, lse, g):
    """What both backward kernels read: q, k, v and dO with contiguous
    last dims, the LSE and D = rowsum(dO ⊙ O) as compact (B·H, S) f32."""
    q, k, v, g = _attention_operands((q, k, v, g.to(q.dtype)), q.shape[3])
    return q, k, v, g, lse.contiguous(), _row_delta(out, g)


def _bwd_call(entry, label, mma, ops, outs, causal, window, scale):
    """Launch the backward entry point ``entry`` (its ``_mma`` twin, which
    takes no dtype code, on the tensor-core route); raises if refused."""
    from mmlspark_tpu_torch.ops.kernel_build import load

    q, k, v, g, lse, delta = ops
    b, s, h, d = q.shape
    lib = _bind(load("flash_attention_bwd_mma" if mma
                     else "flash_attention_bwd"))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            b, s, h, k.shape[2], d, *_strides(q, k, v, g), scale,
            int(causal), window or 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mma:
            rc = getattr(lib, entry + "_mma")(*args, stream)
        else:
            rc = getattr(lib, entry)(_DTYPE_CODES[q.dtype], *args, stream)
    _raise_on(rc, lib, label)


def _launch_bwd_kv(ops, causal, window, scale, mma: bool):
    """dK and dV, (B, S, Hkv, D) in k's and v's dtype."""
    global bwd_kv_launches, bwd_kv_mma_launches
    k = ops[1]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=ops[2].dtype, device=k.device)
    _bwd_call("mml_flash_attention_bwd_kv", "flash_attention dK/dV", mma,
              ops, (dk, dv), causal, window, scale)
    bwd_kv_launches += 1
    if mma:
        bwd_kv_mma_launches += 1
    return dk, dv


def _launch_bwd_q(ops, causal, window, scale, mma: bool):
    """dQ, (B, S, H, D) in q's dtype."""
    global bwd_q_launches, bwd_q_mma_launches
    q = ops[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_call("mml_flash_attention_bwd_q", "flash_attention dQ", mma, ops,
              (dq,), causal, window, scale)
    bwd_q_launches += 1
    if mma:
        bwd_q_mma_launches += 1
    return dq


def _raise_on(rc: int, lib, name: str) -> None:
    if rc:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({lib.mml_cuda_error_string(rc).decode()})"
        )
