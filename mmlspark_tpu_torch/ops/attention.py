"""Attention math: the dense reference and the online-softmax block
update — the port of ``mmlspark_tpu/ops/attention.py``.

Scores accumulate in float32 whatever the input dtype, exactly as the
JAX reference does. Layout convention: ``(batch, seq, heads, head_dim)``
for q/k/v, running stats ``(batch, heads, q_len)``, accumulator
``(batch, q_len, heads, dim)``.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# masking values — ONE home for both conventions, so masks composed across
# the dense path and the kernels can never mix semantics:
#
# - ``NEG_INF`` (true -inf) is the DENSE additive-mask value. The dense
#   paths detect fully-masked rows exactly (``isneginf`` on the running max,
#   ``denom == 0``) and emit zeros for them; exp(-inf - finite) is exactly 0.
# - ``KERNEL_NEG_INF`` (finite -1e30) is the in-kernel stand-in. A kernel's
#   running max starts at it, and true -inf would poison the update the
#   first time it computes ``exp(m_prev - m_new)`` with both at -inf
#   (inf - inf -> nan). Kernels detect fully-masked rows via ``l == 0``
#   (dead blocks are skipped, never accumulated), not via isneginf.
#
# Pick with :func:`mask_value`; never hard-code a third convention.

NEG_INF = float("-inf")
KERNEL_NEG_INF = -1e30


def mask_value(*, kernel: bool) -> float:
    """The additive value for dead attention scores: the finite in-kernel
    stand-in when ``kernel=True``, true ``-inf`` for the dense paths."""
    return KERNEL_NEG_INF if kernel else NEG_INF


def _is_per_row(x) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim > 0


def decode_live_lengths(pos, batch: int, live=None, *, device=None):
    """Per-row LIVE KV lengths for a single-token decode step writing at
    absolute position ``pos``: the step's own K/V lands at ``pos``, so
    positions ``[0, pos]`` are live — length ``pos + 1``.

    The one definition of the decode off-by-one shared by the dense cache
    read (``dense_attention(..., q_offset=pos)`` keeps exactly ``pos + 1``
    keys) and ``flash_decode`` (which masks ``kpos >= length``). ``pos``
    is a Python int, a 0-d tensor or a per-row ``(B,)`` tensor; returns
    ``(batch,)`` int32 on ``pos``'s device (``device`` for an int).

    ``live`` ((B,) bool, optional — the fused decode block's carry) zeroes
    dead rows' lengths, so the kernel reads none of their cache.
    """
    if isinstance(pos, torch.Tensor):
        pos = pos.to(torch.int32)
        if not pos.ndim:
            pos = pos.expand(batch)
    else:
        pos = torch.full((batch,), int(pos), dtype=torch.int32,
                         device=device)
    lengths = pos + 1
    if live is not None:
        lengths = torch.where(live, lengths, torch.zeros_like(lengths))
    return lengths


def causal_block_mask(q_len: int, kv_len: int, q_offset, kv_offset,
                      window: int | None = None, *, device=None):
    """Additive mask (q_len, kv_len) for a block of a causal attention
    matrix whose global coordinates start at (q_offset, kv_offset);
    ``window=W`` additionally masks keys older than ``qpos - W + 1``.

    ``q_offset`` may be a PER-ROW ``(B,)`` tensor — the serving engine's
    fused decode step — producing a (B, 1, q_len, kv_len) mask that
    broadcasts over heads; ``kv_offset`` must be scalar then.
    """
    if isinstance(q_offset, torch.Tensor):
        device = q_offset.device
    q_idx = torch.arange(q_len, device=device)
    k_idx = torch.arange(kv_len, device=device)
    if _is_per_row(q_offset):
        if _is_per_row(kv_offset):
            raise ValueError("per-row q_offset requires a scalar kv_offset")
        qi = (q_offset.long()[:, None, None, None]
              + q_idx[None, None, :, None])  # (B, 1, Q, 1)
        kj = kv_offset + k_idx[None, None, None, :]
    else:
        qi = q_offset + q_idx[:, None]
        kj = kv_offset + k_idx[None, :]
    dead = kj > qi
    if window is not None:
        dead = dead | (kj <= qi - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(dead, torch.full_like(zero, NEG_INF), zero)


def softmax_block_update(carry, q, k, v, scale, mask=None):
    """One streaming-softmax step: fold the (k, v) block into the running
    (max, normalizer, accumulator) for queries ``q``.

    ``carry = (m, l, acc)`` with m, l: (B, H, Q) float32 and
    acc: (B, Q, H, D) float32. Blocks where every entry is masked
    contribute exactly zero.
    """
    m, l, acc = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows still at -inf (nothing unmasked yet): exponentiate against 0
    # so exp(-inf - 0) == 0 instead of exp(-inf + inf) == nan
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(m - m_safe)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float()
    )
    return m_new, l_new, acc_new


def finalize_softmax(l, acc, dtype):
    """Normalize the accumulator; fully-masked rows come out as zeros."""
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / denom.transpose(1, 2)[..., None]).to(dtype)


def _validate_and_expand_gqa(q, k, v):
    """Shared grouped-query contract: k/v heads equal and dividing q
    heads, expanded to q heads by repeat (query head i reads kv head
    i // group)."""
    if k.shape[2] != v.shape[2] or q.shape[2] % k.shape[2]:
        raise ValueError(
            "k/v heads must be equal and divide q heads, got "
            f"q={q.shape[2]} k={k.shape[2]} v={v.shape[2]}"
        )
    rep = q.shape[2] // k.shape[2]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def rolled_window_attention(q, k, v, pos, *, scale=None):
    """One decode step against a ROLLED sliding-window cache.

    ``k``/``v`` are (B, W, Hkv, D) circular buffers where slot ``j`` holds
    the key/value at the latest absolute position congruent to ``j`` mod W
    that is <= ``pos``; every written slot is inside the causal window of
    the query at ``pos``, so the only masking is validity for slots not
    yet written while ``pos < W``. ``q`` is (B, 1, H, D).
    """
    k, v = _validate_and_expand_gqa(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = k.shape[1]
    valid = torch.arange(w, device=q.device)[None, None, None, :] <= pos
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    # the slot at pos % W is always valid, so no fully-masked rows exist
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return (out / p.sum(dim=-1).transpose(1, 2)[..., None]).to(q.dtype)


def dense_attention(q, k, v, *, causal: bool = False,
                    window: int | None = None, scale=None,
                    q_offset=0, kv_offset: int = 0):
    """Reference multi-head attention, (B, S, H, D) layout.

    ``window`` is the causal sliding window (each query sees its W most
    recent keys; requires causal). ``q_offset`` may be a (B,) tensor of
    per-row positions (see :func:`causal_block_mask`). A fully masked row
    gives zeros.
    """
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    k, v = _validate_and_expand_gqa(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s + causal_block_mask(q.shape[1], k.shape[1], q_offset,
                                  kv_offset, window=window, device=q.device)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    denom = p.sum(dim=-1)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return (out / denom.transpose(1, 2)[..., None]).to(q.dtype)
