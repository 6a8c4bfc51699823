"""Rotary position embeddings (RoPE) — the port of
``mmlspark_tpu/ops/rope.py``.

The rotate-half formulation (GPT-NeoX convention): the head dimension
splits into two halves that form the (real, imaginary) parts of d/2
complex pairs, each rotated by an angle proportional to the position.
"""

from __future__ import annotations

import torch


def rope_tables(positions, head_dim: int, base: float = 10000.0):
    """cos/sin tables, each ``positions.shape + (head_dim // 2,)``
    float32. ``positions`` is a vector, or a (B, S) matrix of PER-ROW
    positions (the serving engine's fused decode step)."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    inv_freq = base ** (
        -torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions=None, *, base: float = 10000.0):
    """Rotate ``x`` of shape (B, S, H, D) by position; D must be even.

    ``positions`` defaults to 0..S-1; a (B, S) matrix applies per-row
    positions. The rotation runs in f32 and casts back to ``x.dtype``.
    """
    b, s, h, d = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    positions = torch.as_tensor(positions, device=x.device)
    cos, sin = rope_tables(positions, d, base)
    if positions.ndim == 2:  # (B, S, D/2): broadcast over H only
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    else:  # (S, D/2): broadcast over (B, H)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat(
        (x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1
    ).to(x.dtype)
