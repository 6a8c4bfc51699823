"""Length-aware single-token attention over slot caches: ``flash_decode``
— the port of ``mmlspark_tpu/ops/flash_attention.py:flash_decode``.

The serving hot path decodes ONE query token per slot per step against a
preallocated ``(B, cache_len, Hkv, D)`` cache. ``flash_decode`` reads
only each row's live prefix ``[0, lengths[b])``, so per-row work and
bytes scale with what the request has generated, not with the pool's
capacity.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/flash_decode.cu`` (built on first use by :mod:`kernel_build`),
which replaces the Pallas ``_decode_kernel``; a refused launch raises.
On a CPU tensor it runs :func:`flash_decode_reference`, the plain
PyTorch version of the same function, which the tests hold to the JAX
kernel and ``chip_smoke.py`` holds the CUDA kernel to. There is no other
route and no fallback between the two.

Only ``_decode_kernel`` is ported here; the int8 twin and the paged
kernels wait for their slices (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from mmlspark_tpu_torch.ops.attention import _validate_and_expand_gqa

#: launches of the CUDA kernel in this process — added to where the
#: wrapper launches it and nowhere else; ``chip_smoke.py`` resets and
#: reads it to show the decode path went through the kernel
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def flash_decode(q, k, v, lengths, *, scale=None):
    """Attention for ONE query token per row over live cache prefixes.

    ``q`` is (B, 1, H, D); ``k``/``v`` are the (B, L, Hkv, D) slot
    caches, Hkv dividing H (query head ``h`` reads kv head
    ``h // (H // Hkv)``); ``lengths`` is (B,) int32 — row b attends cache
    positions ``[0, lengths[b])`` (the ``pos + 1`` contract of
    :func:`~mmlspark_tpu_torch.ops.attention.decode_live_lengths`),
    clipped to [0, L]. A row with length 0 yields zeros. Inference only.
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
    if q.dtype != k.dtype:
        raise ValueError(
            "flash_decode requires q, k, v to share one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    b = q.shape[0]
    if k.shape[0] != b or v.shape != k.shape or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"k/v must be (B={b}, L, Hkv, D={q.shape[3]}) alike, got "
            f"{tuple(k.shape)}/{tuple(v.shape)}"
        )
    lengths = torch.as_tensor(lengths, device=q.device)
    if tuple(lengths.shape) != (b,):
        raise ValueError(
            f"lengths must be ({b},) — one live length per batch row — "
            f"got {tuple(lengths.shape)}"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lengths = lengths.to(torch.int32).clamp(0, k.shape[1])
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_decode runs on cuda (the kernel) or cpu (its plain "
            f"version), got {q.device}"
        )
    return _launch(q, k, v, lengths, float(scale))


def flash_decode_reference(q, k, v, lengths, *, scale=None):
    """Plain PyTorch ``flash_decode``: the same masking (positions
    ``>= lengths[b]`` never enter the softmax) and the same empty-row
    rule (``l == 0`` -> zeros) as the kernel, with f32 scores, an f32
    softmax and f32 P·V over upcast V, cast to q's dtype at the end."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = _validate_and_expand_gqa(q, k, v)
    lengths = torch.as_tensor(lengths, device=q.device).clamp(0, k.shape[1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    live = (torch.arange(k.shape[1], device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]  # (B, 1, 1, L)
    # dead positions are dropped, not exponentiated: an all-dead row
    # keeps l == 0 exactly, like the kernel that never reads them
    m = torch.where(live, s, torch.full_like(s, float("-inf")))
    m = m.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    l = p.sum(dim=-1)  # (B, H, 1)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def _check_cuda_operands(q, k, v, lengths):
    """What the kernel takes: f32/bf16, D a multiple of 8 up to 128, the
    last dim contiguous, and every row start 16-byte aligned (the tiles
    are staged with 16-byte loads)."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the flash_decode kernel takes float32 or bfloat16, got "
            f"{q.dtype}"
        )
    d = q.shape[3]
    if d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(
            f"the flash_decode kernel takes a head_dim that is a multiple "
            f"of 8 up to {_MAX_HEAD_DIM}, got {d}"
        )
    if q.shape[0] > 65535:
        raise ValueError(f"batch {q.shape[0]} exceeds the kernel grid")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(
                f"{name} must be contiguous in its last dim, got strides "
                f"{t.stride()}"
            )
        strides = (t.stride(0), t.stride(2)) + (
            (t.stride(1),) if name != "q" else ()
        )
        if t.data_ptr() % 16 or any(s % vec for s in strides):
            raise ValueError(
                f"{name} rows must start on 16-byte boundaries (strides "
                f"{t.stride()} of {t.element_size()}-byte elements)"
            )
    if lengths.device != q.device:
        raise ValueError(f"lengths on {lengths.device}, q on {q.device}")


def _launch(q, k, v, lengths, scale: float):
    global launches
    from mmlspark_tpu_torch.ops.kernel_build import load

    _check_cuda_operands(q, k, v, lengths)
    lib = _bind(load("flash_decode"))
    b, _, h, d = q.shape
    L, hk = k.shape[1], k.shape[2]
    lengths = lengths.contiguous()
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mml_flash_decode(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, hk, L, d,
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            scale, stream,
        )
    if rc:
        raise RuntimeError(
            f"flash_decode kernel launch failed: CUDA error {rc} "
            f"({lib.mml_cuda_error_string(rc).decode()})"
        )
    launches += 1
    return out


def _bind(lib):
    """Declare the C signatures once per library: every pointer and the
    stream as ``c_void_p`` — an undeclared argument would pass as a
    32-bit int and cut the pointer."""
    fn = lib.mml_flash_decode
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [i32] + [ptr] * 5 + [i32] * 5 + [i64] * 8
            + [ctypes.c_float, ptr]
        )
        fn.restype = ctypes.c_int
        err = lib.mml_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib
