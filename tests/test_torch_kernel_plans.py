"""The host-side plans of the port's redesigned attention kernels
(``mmlspark_tpu_torch/ops/flash_attention.py``), checked on the CPU:

- which forward kernel a call takes (``_fwd_route``): the tensor-core
  kernel for bf16 at head dims 64 and 128 with 16-byte-aligned rows, the
  f32-FMA kernel for everything else;
- the split-KV decode plan (``decode_plan``, ``decode_workspace_shape``):
  the chunk and split count follow the static cache length and the page
  size alone, and a paged chunk is a whole number of pages.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
what surrounds them is plain Python and is held here.
"""

from __future__ import annotations

import pytest
import torch

from mmlspark_tpu_torch.ops import flash_attention as fa


def _qkv(d, dtype, b=2, s=8, h=4, hk=2):
    """q, k, v as the model slices them out of one fused projection."""
    qkv = torch.zeros(b, s, h + 2 * hk, d, dtype=dtype)
    return qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:]


@pytest.mark.parametrize("d,want", [(40, "simt"), (64, "mma"),
                                    (128, "mma"), (256, "simt"),
                                    (32, "simt"), (96, "simt")])
def test_forward_route_by_head_dim(d, want):
    assert fa._fwd_route(*_qkv(d, torch.bfloat16)) == want


@pytest.mark.parametrize("d", [40, 64, 128, 256])
def test_float32_forward_takes_the_simt_kernel(d):
    assert fa._fwd_route(*_qkv(d, torch.float32)) == "simt"


def test_forward_route_needs_16_byte_rows():
    # a head of 64 inside rows of 68: every position stride is 136 bytes
    wide = torch.zeros(2, 8, 4, 68, dtype=torch.bfloat16)
    q = wide[..., :64]
    assert q.stride(-1) == 1
    k = v = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    assert fa._fwd_route(q, k, v) == "simt"
    assert fa._fwd_route(k, q, v) == "simt"
    assert fa._fwd_route(k, k, v) == "mma"
    # a base address off a 16-byte boundary (one bf16 element in)
    flat = torch.zeros(2 * 8 * 4 * 64 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 8 * 4 * 64].view(2, 8, 4, 64)
    assert shifted.data_ptr() % 16
    assert fa._fwd_route(k, k, shifted) == "simt"
    assert fa._fwd_route(k, k, flat[8:].view(2, 8, 4, 64)) == "mma"


def test_mma_head_dims_fit_the_route():
    assert all(d % 16 == 0 and d <= 128 for d in fa.MMA_HEAD_DIMS)
    assert fa.MMA_HEAD_DIMS[-1] <= fa.MAX_ATTENTION_HEAD_DIM


@pytest.mark.parametrize("cache_len,splits", [(1, 1), (63, 1), (64, 1),
                                              (65, 2), (256, 4),
                                              (512, 8), (500, 8)])
def test_dense_decode_plan(cache_len, splits):
    assert fa.decode_plan(cache_len) == (fa.DECODE_CHUNK, splits)


@pytest.mark.parametrize("page_size", [8, 16, 24, 32, 48, 64, 128])
def test_paged_decode_chunk_is_whole_pages(page_size):
    max_pages = 20
    chunk, splits = fa.decode_plan(max_pages * page_size, page_size)
    assert chunk % page_size == 0
    # the fewest whole pages that cover DECODE_CHUNK positions
    assert chunk >= fa.DECODE_CHUNK > chunk - page_size
    assert splits == -(-max_pages * page_size // chunk)
    # the engine's page sizes divide the chunk: it stays DECODE_CHUNK
    if fa.DECODE_CHUNK % page_size == 0:
        assert chunk == fa.DECODE_CHUNK


def test_decode_plan_ignores_batch_and_tracks_positions():
    """A chunk's positions depend on the position alone: the same
    boundaries under every cache length, so a row decodes alike in any
    batch or pool."""
    chunk, _ = fa.decode_plan(256)
    for cache_len in (64, 300, 512, 4096):
        assert fa.decode_plan(cache_len)[0] == chunk


@pytest.mark.parametrize("b,h,cache_len,d", [(8, 8, 512, 64),
                                             (1, 4, 256, 128),
                                             (3, 2, 100, 6)])
def test_decode_workspace_shape(b, h, cache_len, d):
    _, splits = fa.decode_plan(cache_len)
    (n,) = fa.decode_workspace_shape(b, h, splits, d)
    # acc[D] and (m, l) for every (row, query head, split)
    assert n == b * h * splits * d + b * h * splits * 2


def test_int8_load_width_is_at_most_8_bytes():
    k = torch.zeros(2, 16, 2, 64, dtype=torch.int8)
    strides = [st for st in k.stride()[:3]]
    assert fa._load_width(64, (k, k), strides) == 8
    k = torch.zeros(2, 16, 2, 6, dtype=torch.int8)
    assert fa._load_width(6, (k, k), list(k.stride()[:3])) == 2
    k = torch.zeros(2, 16, 2, 12, dtype=torch.int8)
    assert fa._load_width(12, (k, k), list(k.stride()[:3])) == 4


def test_decode_signatures_carry_the_workspace():
    """The C entry points take the workspace pointer and the split plan:
    one more pointer and two more ints than before the split."""
    sig = fa._SIGNATURES
    assert sig["mml_flash_decode"].count(fa._PTR) == 7  # + the stream
    assert sig["mml_flash_decode_q8"].count(fa._PTR) == 9
    assert sig["mml_paged_flash_decode"].count(fa._PTR) == 10
    assert "mml_flash_attention_fwd_mma" in sig
