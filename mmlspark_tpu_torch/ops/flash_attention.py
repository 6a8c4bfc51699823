"""Length-aware single-token attention over slot caches and paged caches:
``flash_decode`` and ``paged_flash_decode`` — the ports of
``mmlspark_tpu/ops/flash_attention.py:flash_decode`` and
``:paged_flash_decode``, each with its int8 mode.

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
``_paged_decode_kernel_q8``); a refused launch raises. On a CPU tensor
each runs its plain PyTorch version (:func:`flash_decode_reference`,
:func:`paged_flash_decode_reference`), which the tests hold to the JAX
kernels and ``chip_smoke.py`` holds the CUDA kernels to. There is no
other route and no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from mmlspark_tpu_torch.ops.attention import _validate_and_expand_gqa

#: launches of each CUDA kernel in this process — added to where its
#: wrapper launches it and nowhere else; ``chip_smoke.py`` resets and
#: reads them to show the decode path went through the kernels.
#: ``launches``: float dense; ``q8_launches``: int8 dense;
#: ``paged_launches``: float paged; ``paged_q8_launches``: int8 paged
launches = 0
q8_launches = 0
paged_launches = 0
paged_q8_launches = 0

#: smallest page and the page unit: the paged pool's API contract
#: (``serve/paging.py``), kept from the JAX package, where a page's
#: (page_size, D) face is the Pallas kernel's KV block and must tile in
#: whole 8-row sublanes
MIN_PAGE_SIZE = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_HEAD_DIM = 128


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
    lengths = lengths.to(torch.int32).clamp(0, k.shape[1])
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, lengths, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)
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
    L = page_table.shape[1] * ps
    lengths = torch.as_tensor(lengths, device=q.device)
    if tuple(lengths.shape) != (b,):
        raise ValueError(
            f"lengths must be ({b},) — one live length per batch row — "
            f"got {tuple(lengths.shape)}"
        )
    if scale is None:
        scale = d ** -0.5
    lengths = lengths.to(torch.int32).clamp(0, L)
    page_table = page_table.to(torch.int32)
    if q.device.type == "cpu":
        return paged_flash_decode_reference(
            q, k_pages, v_pages, lengths, page_table, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
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
    """int8 staging: the widest load of 16, 8, 4 or 2 bytes that divides
    the row (D bytes), every row stride and every base address."""
    for vec in (16, 8, 4, 2):
        if d % vec == 0 and all(t.data_ptr() % vec == 0 for t in tensors) \
                and all(s % vec == 0 for s in strides):
            return vec
    raise ValueError(
        f"int8 K/V rows must start on 2-byte boundaries (D={d}, strides "
        f"{strides})"
    )


def _check_operands(q, kv, lengths, extra=()) -> int:
    """What the kernels take; returns the K/V staging load width in
    bytes. q float32 or bfloat16, contiguous in its last dim; float K/V
    with a head_dim that is a multiple of 8 up to 128 and every row start
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
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    strides = (q.stride(0), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quantized:
            rc = lib.mml_flash_decode_q8(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lengths.data_ptr(), scales[0].data_ptr(),
                scales[1].data_ptr(), out.data_ptr(), b, h, hk, L, d, vec,
                *strides, scale, stream,
            )
        else:
            rc = lib.mml_flash_decode(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                b, h, hk, L, d, *strides, scale, stream,
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
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mml_paged_flash_decode(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr(),
            scales[0].data_ptr() if quantized else None,
            scales[1].data_ptr() if quantized else None,
            out.data_ptr(), b, h, hk, num_pages, ps, page_table.shape[1],
            d, vec, q.stride(0), q.stride(2), scale, stream,
        )
    _raise_on(rc, lib, "paged_flash_decode")
    if quantized:
        paged_q8_launches += 1
    else:
        paged_launches += 1
    return out


def _raise_on(rc: int, lib, name: str) -> None:
    if rc:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({lib.mml_cuda_error_string(rc).decode()})"
        )


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C signatures: every pointer and the stream as ``c_void_p`` (an
#: undeclared argument would pass as a 32-bit int and cut the pointer),
#: strides as 64-bit
_SIGNATURES = {
    "mml_flash_decode": (
        [_I32] + [_PTR] * 5 + [_I32] * 5 + [_I64] * 8
        + [ctypes.c_float, _PTR]
    ),
    "mml_flash_decode_q8": (
        [_I32] + [_PTR] * 7 + [_I32] * 6 + [_I64] * 8
        + [ctypes.c_float, _PTR]
    ),
    "mml_paged_flash_decode": (
        [_I32] * 2 + [_PTR] * 8 + [_I32] * 8 + [_I64] * 2
        + [ctypes.c_float, _PTR]
    ),
}


def _bind(lib):
    """Declare the C signatures of the entry points ``lib`` exports, once
    per library."""
    err = lib.mml_cuda_error_string
    if err.argtypes is None:
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return lib
