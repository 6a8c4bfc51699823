"""KV-cache byte accounting for the int8 pools — ``kv_cache_bytes`` of
``mmlspark_tpu/ops/quantize.py``. Weight-only int8 (``quantize_weights``
and its kin) waits for a later slice (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import torch


def kv_cache_bytes(buffers: dict) -> tuple[int, int]:
    """(bytes as stored, bytes if bf16) for a cache pool's ``buffers``
    (``{block: tuple of tensors}``), with the baseline at bf16 because
    that is what the dense accuracy-oracle pool stores. int8 K/V tensors
    count 1 byte against a 2-byte baseline; f32 scale tensors and int32
    page tables are quantization/paging overhead, so they count toward
    stored AND baseline at their own width (an int8 pool is never
    reported as beating a bf16 pool it does not beat). A tensor shared by
    several blocks (the paged pool's one device page table) counts
    once."""
    stored = bf16 = 0
    seen: set[int] = set()
    for entry in buffers.values():
        for t in entry:
            if id(t) in seen:
                continue
            seen.add(id(t))
            nbytes = t.numel() * t.element_size()
            stored += nbytes
            bf16 += t.numel() * 2 if t.dtype == torch.int8 else nbytes
    return stored, bf16
