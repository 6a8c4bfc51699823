"""The host-side plans of the port's redesigned attention kernels
(``mmlspark_tpu_torch/ops/flash_attention.py``), checked on the CPU:

- which forward kernel a call takes (``_fwd_route``): the tensor-core
  kernel for bf16 at head dims 64 and 128 with 16-byte-aligned rows, the
  f32-FMA kernel for everything else; and which backward pair
  (``_bwd_route``), on the same rule with dO's rows aligned too;
- the split-KV decode plan (``decode_plan``, ``decode_workspace_shape``):
  the chunk and split count follow the static cache length and the page
  size alone, and a paged chunk is a whole number of pages;
- the ``ctypes`` signatures, against the C prototypes in ``csrc/``.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
what surrounds them is plain Python and is held here.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.ops import kernel_build


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


def _misaligned(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` whose base sits one element past a 16-byte
    boundary (its strides stay those of a contiguous tensor)."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8, dtype=dtype)
    t = flat[1:1 + n].view(*shape)
    assert t.data_ptr() % 16
    return t


@pytest.mark.parametrize("d,want", [(24, "simt"), (40, "simt"),
                                    (64, "mma"), (128, "mma"),
                                    (256, "simt")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_route_by_dtype_and_head_dim(d, want, dtype):
    q, k, v = _qkv(d, dtype)
    g = torch.zeros(q.shape, dtype=dtype)
    assert fa._bwd_route(q, k, v, g) == (
        want if dtype == torch.bfloat16 else "simt")


@pytest.mark.parametrize("which", ["q", "k", "v", "dO"])
def test_backward_route_needs_every_row_aligned(which):
    """One operand off a 16-byte boundary sends the pair to the simt
    kernels, whichever it is; the same operands aligned take the mma."""
    ops = dict(zip(("q", "k", "v"), _qkv(64, torch.bfloat16)))
    ops["dO"] = torch.zeros(ops["q"].shape, dtype=torch.bfloat16)
    assert fa._bwd_route(*ops.values()) == "mma"
    ops[which] = _misaligned(tuple(ops[which].shape))
    assert fa._bwd_route(*ops.values()) == "simt"


def test_backward_route_misaligned_dO_view():
    """dO as a view whose positions are 136 bytes apart (a head of 64
    inside rows of 68), as a caller's slice may hand it: not a 16-byte
    stride, so the simt pair, though q, k and v would take the mma."""
    q, k, v = _qkv(64, torch.bfloat16)
    g = torch.zeros(2, 8, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert g.stride(-1) == 1 and g.stride(2) * 2 % 16
    assert fa._fwd_route(q, k, v) == "mma"
    assert fa._bwd_route(q, k, v, g) == "simt"
    # every other head of a wider tensor (the smoke run's dO) is aligned
    wide = torch.zeros(2, 8, 8, 64, dtype=torch.bfloat16)
    assert fa._bwd_route(q, k, v, wide[:, :, ::2]) == "mma"


def test_bf16_cpu_backward_launches_no_kernel():
    """A bf16 backward at head dim 64 (the mma route's shape) on CPU
    tensors runs the plain version and launches nothing."""
    q, k, v = (t.normal_() for t in _qkv(64, torch.bfloat16))
    g = torch.randn(q.shape).bfloat16()
    before = {name: getattr(fa, name) for name in (
        "bwd_kv_launches", "bwd_q_launches", "bwd_kv_mma_launches",
        "bwd_q_mma_launches")}
    out, lse = fa.flash_attention_forward(q, k, v, causal=True, window=None,
                                          scale=0.125)
    grads = fa.flash_attention_backward(q, k, v, out, lse, g, causal=True,
                                        window=None, scale=0.125)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                 causal=True, scale=0.125)
    for got, ref in zip(grads, want):
        assert torch.equal(got, ref)
    assert {name: getattr(fa, name) for name in before} == before


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


_C_TYPES = {"const void*": fa._PTR, "void*": fa._PTR, "int": fa._I32,
            "long long": fa._I64, "float": ctypes.c_float}


def _c_prototypes() -> dict:
    """``{name: [ctypes type of each parameter]}`` of every
    ``extern "C" int mml_*(...)`` entry point in ``csrc/*.cu``."""
    protos = {}
    for src in kernel_build.sources().values():
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (mml_\w+)\(([^)]*)\)', text):
            types = []
            for param in params.split(","):
                ctype = " ".join(param.split()[:-1])
                ctype += "*" * param.split()[-1].count("*")
                types.append(_C_TYPES[ctype.replace(" *", "*")])
            assert name not in protos, f"{name} defined twice"
            protos[name] = types
    return protos


def test_signatures_match_the_c_prototypes():
    """Every entry point a source exports has its ``ctypes`` signature,
    parameter by parameter (a pointer declared as an int would be cut to
    32 bits)."""
    protos = _c_prototypes()
    assert set(protos) == set(fa._SIGNATURES)
    for name, types in protos.items():
        assert fa._SIGNATURES[name] == types, name


@pytest.mark.parametrize("name,pointers", [
    ("mml_flash_attention_bwd_kv_mma", 9),  # q k v dO lse D dk dv stream
    ("mml_flash_attention_bwd_q_mma", 8),   # q k v dO lse D dq stream
])
def test_backward_mma_signatures(name, pointers):
    """The tensor-core pair takes the simt pair's arguments without the
    leading dtype code (bf16 only)."""
    sig = fa._SIGNATURES[name]
    assert sig.count(fa._PTR) == pointers
    assert sig == fa._SIGNATURES[name[:-len("_mma")]][1:]


def test_decode_signatures_carry_the_workspace():
    """The C entry points take the workspace pointer and the split plan:
    one more pointer and two more ints than before the split."""
    sig = fa._SIGNATURES
    assert sig["mml_flash_decode"].count(fa._PTR) == 7  # + the stream
    assert sig["mml_flash_decode_q8"].count(fa._PTR) == 9
    assert sig["mml_paged_flash_decode"].count(fa._PTR) == 10
    assert "mml_flash_attention_fwd_mma" in sig


# -- the fused optimizer's route --------------------------------------------------


def test_fused_optimizer_route_by_device():
    """A CPU tensor takes the plain update, a CUDA tensor the kernel;
    any other device raises."""
    from types import SimpleNamespace

    from mmlspark_tpu_torch.ops import fused_optim as fo

    assert fo.fused_update_route(torch.zeros(2)) == "plain"
    assert fo.fused_update_route(
        SimpleNamespace(device=torch.device("cuda", 0))) == "cuda"
    with pytest.raises(ValueError, match="cuda .the kernel. or cpu"):
        fo.fused_update_route(torch.zeros(2, device="meta"))


@pytest.mark.parametrize("route", ["plain", "cuda"])
def test_fused_optimizer_dispatch_follows_the_route(route, monkeypatch):
    """``optimizer_update`` calls the plain version on the plain route
    and launches the kernel on the cuda route, never both; the count
    advances either way."""
    from mmlspark_tpu_torch.ops import fused_optim as fo

    called = []
    monkeypatch.setattr(fo, "fused_update_route", lambda t: route)
    monkeypatch.setattr(fo, "_launch",
                        lambda *a, **k: called.append("cuda"))
    reference = fo.optimizer_update_reference
    monkeypatch.setattr(fo, "optimizer_update_reference",
                        lambda *a, **k: (called.append("plain"),
                                         reference(*a, **k)))
    params = [torch.ones(3)]
    state = {"count": torch.zeros((), dtype=torch.int32),
             "mu": [torch.zeros(3)], "nu": [torch.zeros(3)]}
    fo.optimizer_update("adam", params, [torch.ones(3)], state,
                        torch.full((), 0.1), torch.tensor(False))
    assert called == [route] and int(state["count"]) == 1
