"""The port's CUDA kernels on the card (``mmlspark_tpu_torch/csrc``).

Every test here needs a CUDA GPU and ``nvcc``: it is marked ``gpu`` and
skips without a card. The tests' ``conftest.py`` imports JAX, which the
GPU machine does not have, so run this file there on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu -q

Each kernel is held to its plain PyTorch version
(``flash_decode_reference``, ``paged_flash_decode_reference``,
``flash_attention_reference``, ``flash_attention_backward_reference``)
on the same CUDA tensors. Tolerances: 1e-5 for a float32 query (both
accumulate in f32; only the order of the sums differs) and 1e-2 for a
bfloat16 one (both round the output to bf16: one ulp at |out| < 2 is
2^-7), int8 K/V included — both sides read the same int8 values and
scales. The attention gradients' own tolerances are at their test.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the flash_decode kernel has no "
                    "CPU mode (its plain version is tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, L, h, hk, d, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=gen).to(dtype).cuda()
        for shape in ((b, 1, h, d), (b, L, hk, d), (b, L, hk, d))
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hk,d", [(4, 64), (2, 64), (1, 32), (4, 128),
                                  (4, 8)])
def test_kernel_matches_reference(cuda, dtype, hk, d):
    L = 200
    q, k, v = _qkv(6, L, 4, hk, d, dtype, seed=d + hk)
    lengths = torch.tensor([0, 1, 63, 64, 150, 10_000], dtype=torch.int32,
                           device=cuda)
    got = fa.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    want = fa.flash_decode_reference(q, k, v, lengths.clamp(0, L))
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert not got[0].any()  # length 0: exact zeros


def test_kernel_reads_strided_views(cuda):
    # q sliced out of a fused projection, K/V every other pool slot
    qkv = torch.randn(3, 1, 12, 64, device=cuda, dtype=torch.bfloat16)
    pool = torch.randn(2, 6, 40, 4, 64, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], pool[0, ::2], pool[1, ::2]
    lengths = torch.tensor([40, 7, 0], dtype=torch.int32, device=cuda)
    got = fa.flash_decode(q, k, v, lengths)
    want = fa.flash_decode_reference(q, k, v, lengths)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2


def test_launch_counter_counts_launches(cuda):
    q, k, v = _qkv(2, 16, 2, 2, 16, torch.float32, seed=0)
    lengths = torch.tensor([3, 16], dtype=torch.int32, device=cuda)
    before = fa.launches
    fa.flash_decode(q, k, v, lengths)
    fa.flash_decode(q, k, v, lengths)
    assert fa.launches == before + 2
    # the plain version is not a launch
    fa.flash_decode_reference(q, k, v, lengths)
    assert fa.launches == before + 2


def test_kernel_rejects_what_it_does_not_take(cuda):
    lengths = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    q, k, v = _qkv(2, 16, 2, 2, 16, torch.float16, seed=1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_decode(q, k, v, lengths)
    q, k, v = _qkv(2, 16, 2, 2, 12, torch.float32, seed=1)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_decode(q, k, v, lengths)
    q, k, v = _qkv(2, 16, 2, 2, 256, torch.float32, seed=1)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_decode(q, k, v, lengths)
    # rows that start on a 16-byte boundary are fine, others are refused
    q, k, v = _qkv(2, 16, 2, 2, 24, torch.bfloat16, seed=1)
    got = fa.flash_decode(q[..., 8:], k[..., 8:], v[..., 8:], lengths)
    want = fa.flash_decode_reference(q[..., 8:], k[..., 8:], v[..., 8:],
                                     lengths)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_decode(q[..., 2:18], k[..., 2:18], v[..., 2:18], lengths)


def test_small_model_decode_on_card_matches_cpu(cuda):
    """One cached decode step of a small f32 model through the kernel,
    against the same step on the CPU (the plain path); 1e-4 on logits of
    magnitude ~3 (f32, sums in other orders on the two devices)."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.models.generate import _cached_apply

    graph = build_model("transformer_lm", vocab_size=64, d_model=32,
                        heads=2, depth=2, max_len=32, kv_heads=1)
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    ids = torch.randint(0, 64, (3, 9), generator=torch.Generator()
                        .manual_seed(0), dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        variables = init_variables(graph, 3, device=dev)
        cache = {f"block{i}": (torch.zeros(3, 16, 1, 16, device=dev),
                               torch.zeros(3, 16, 1, 16, device=dev))
                 for i in range(2)}
        x = ids.to(dev)
        _, cache = _cached_apply(graph, variables, x[:, :8], cache, 0)
        pos = torch.tensor([8, 8, 8], dtype=torch.int32, device=dev)
        live = torch.tensor([True, False, True], device=dev)
        out[dev], _ = _cached_apply(graph, variables, x[:, 8:], cache, pos,
                                    step=True, live=live)
    err = (out["cuda"].cpu() - out["cpu"]).abs().max().item()
    assert err <= 1e-4


def _int8_kv(shape, n_scales, gen):
    """int8 K/V values over the whole range and positive f32 scales that
    dequantize them to about [-4, 4] (an amax of about 3 with the pools'
    1.5x headroom)."""
    vals = torch.randint(-127, 128, shape, generator=gen,
                         dtype=torch.int8).cuda()
    scales = (torch.rand(n_scales, generator=gen) * 0.01 + 0.02).cuda()
    return vals, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hk,d", [(4, 64), (2, 64), (1, 32), (4, 128),
                                  (2, 6), (1, 34)])
def test_q8_kernel_matches_reference(cuda, dtype, hk, d):
    b, L, h = 6, 200, 4
    gen = torch.Generator().manual_seed(d + hk)
    q = torch.randn(b, 1, h, d, generator=gen).to(dtype).cuda()
    k, ks = _int8_kv((b, L, hk, d), (b, hk), gen)
    v, vs = _int8_kv((b, L, hk, d), (b, hk), gen)
    lengths = torch.tensor([0, 1, 63, 64, 150, 10_000], dtype=torch.int32,
                           device=cuda)
    before = fa.q8_launches
    got = fa.flash_decode(q, k, v, lengths, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert fa.q8_launches == before + 1
    want = fa.flash_decode_reference(q, k, v, lengths.clamp(0, L),
                                     k_scale=ks, v_scale=vs)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert not got[0].any()


def _page_table(b, max_pages, num_pages, lengths, ps, gen):
    """A shuffled page table: distinct pages for every live logical page,
    two rows sharing their first page, and the trash page 0 past each
    row's live length."""
    perm = (torch.randperm(num_pages - 1, generator=gen) + 1).tolist()
    pt = torch.zeros(b, max_pages, dtype=torch.int32)
    for row, n in enumerate(lengths):
        for j in range(-(-min(n, max_pages * ps) // ps)):
            pt[row, j] = perm.pop()
    pt[1, 0] = pt[2, 0]  # a shared page
    return pt.cuda()


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hk,d,ps", [(4, 64, 16), (2, 64, 8), (4, 128, 32),
                                     (2, 6, 16)])
def test_paged_kernel_matches_reference(cuda, kv, qdtype, hk, d, ps):
    if kv != "int8" and (kv != str(qdtype).split(".")[1] or d % 8):
        pytest.skip("float pages take their query's dtype and D % 8 == 0")
    b, h, max_pages = 6, 4, 8
    num_pages = b * max_pages + 1
    lengths = [0, 1, ps - 1, ps + 1, 5 * ps, 10_000]
    gen = torch.Generator().manual_seed(d + hk + ps)
    q = torch.randn(b, 1, h, d, generator=gen).to(qdtype).cuda()
    shape = (num_pages, hk, ps, d)
    if kv == "int8":
        kp, ks = _int8_kv(shape, (num_pages, hk), gen)
        vp, vs = _int8_kv(shape, (num_pages, hk), gen)
        counter = "paged_q8_launches"
    else:
        kp, vp = (torch.randn(shape, generator=gen).to(qdtype).cuda()
                  for _ in range(2))
        ks = vs = None
        counter = "paged_launches"
    pt = _page_table(b, max_pages, num_pages, lengths, ps, gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = getattr(fa, counter)
    got = fa.paged_flash_decode(q, kp, vp, lens, pt, k_scale=ks,
                                v_scale=vs)
    torch.cuda.synchronize()
    assert getattr(fa, counter) == before + 1
    want = fa.paged_flash_decode_reference(
        q, kp, vp, lens.clamp(0, max_pages * ps), pt, k_scale=ks,
        v_scale=vs)
    assert got.dtype == qdtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[qdtype]
    assert not got[0].any()


def test_paged_kernel_fails_on_a_page_id_out_of_range(cuda):
    """A page id past the stores traps in the kernel: the launch fails
    (run in a child process, since a trap ends the CUDA context)."""
    code = (
        "import torch\n"
        "from mmlspark_tpu_torch.ops import flash_attention as fa\n"
        "q = torch.randn(1, 1, 2, 16, device='cuda')\n"
        "kp = torch.randn(3, 2, 8, 16, device='cuda')\n"
        "pt = torch.tensor([[1, 7]], dtype=torch.int32, device='cuda')\n"
        "lens = torch.tensor([12], dtype=torch.int32, device='cuda')\n"
        "try:\n"
        "    fa.paged_flash_decode(q, kp, kp, lens, pt)\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('FAILED', type(e).__name__)\n"
        "else:\n"
        "    print('RAN')\n"
    )
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert "FAILED" in out.stdout, (out.stdout, out.stderr[-2000:])


# -- the attention forward and its two backward kernels -------------------------


def _attention_inputs(b, s, h, hk, d, dtype, seed):
    """q/k/v strided slices of one fused projection, dO every other head
    of a wider tensor (the layouts the model hands the kernels)."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, h + 2 * hk, d, generator=gen).to(dtype).cuda()
    wide = torch.randn(b, s, 2 * h, d, generator=gen).to(dtype).cuda()
    return (qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:],
            wide[:, :, ::2])


def _scaled_err(got, want):
    """Max abs error over the plain value's max abs, or over 1 where that
    is smaller (a gradient that is 0 in exact arithmetic, as dq and dk of
    a single token, holds only rounding noise)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,d,causal,window", [
    (2, 200, 4, 4, 64, True, None),
    (2, 130, 4, 2, 32, True, 48),
    (1, 96, 4, 1, 128, False, None),
    (1, 1, 2, 2, 64, True, None),
    (1, 40, 2, 2, 256, True, None),
    (2, 70, 4, 2, 24, True, 7),
    # e307's models: head dim 16, windows smaller than a tile
    (1, 16, 2, 2, 16, True, 8),
    (1, 48, 2, 2, 16, True, None),
    (2, 130, 2, 2, 16, True, 8),
])
def test_attention_kernels_match_reference(cuda, dtype, b, s, h, hk, d,
                                           causal, window):
    """Forward (out, LSE) and both backward kernels against the plain
    versions on the same tensors; the backward kernels read the plain
    forward's (out, lse). Gradients as max abs error over the plain
    value's max abs: 1e-4 in f32, 1e-2 in bf16 (the kernel sums a GQA
    group in f32, the plain version rounds each head first)."""
    q, k, v, g = _attention_inputs(b, s, h, hk, d, dtype, seed=s + d)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    before = (fa.fwd_launches, fa.bwd_kv_launches, fa.bwd_q_launches)
    out, lse = fa.flash_attention_forward(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, **kw)
    grads = fa.flash_attention_backward(q, k, v, want_out, want_lse, g, **kw)
    want = fa.flash_attention_backward_reference(q, k, v, want_out,
                                                 want_lse, g, **kw)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_kv_launches, fa.bwd_q_launches) == tuple(
        n + 1 for n in before)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - want_out.float()).abs().max().item() <= TOL[dtype]
    assert lse.shape == (b * h, s)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    for got, ref in zip(grads, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _scaled_err(got, ref) <= (1e-4 if dtype == torch.float32
                                         else 1e-2)


def test_attention_autograd_on_card_matches_cpu(cuda):
    """flash_attention through autograd: the kernels on the card, the
    plain versions on the CPU, float32."""
    q, k, v, g = _attention_inputs(2, 90, 4, 2, 32, torch.float32, seed=9)
    results = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev, copy=True).requires_grad_(True)
                  for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True, window=40)
        out.backward(g.to(dev))
        results[dev] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, want in zip(results["cuda"], results["cpu"]):
        assert _scaled_err(got, want) <= 1e-4


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, _ = _attention_inputs(1, 8, 2, 2, 320, torch.float32, seed=1)
    with pytest.raises(ValueError, match="up to 256"):
        fa.flash_attention(q, k, v, causal=True)
    q, k, v, _ = _attention_inputs(1, 8, 2, 2, 16, torch.float16, seed=1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, k, v, causal=True)


def test_small_model_trains_on_card_like_cpu(cuda):
    """Three SGD steps of a small float32 flash model through
    SPMDTrainer, on the card and on the CPU: the same losses (1e-4)."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    graph = build_model("transformer_lm", vocab_size=64, d_model=64,
                        heads=4, kv_heads=2, depth=2, max_len=48,
                        attn_impl="flash", window=20)
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    x = torch.randint(0, 64, (12, 48), generator=torch.Generator()
                      .manual_seed(0)).numpy()
    losses = {}
    mma_before = (fa.fwd_mma_launches, fa.bwd_kv_mma_launches,
                  fa.bwd_q_mma_launches)
    for dev in ("cpu", "cuda"):
        trainer = SPMDTrainer(graph, TrainConfig(
            batch_size=4, optimizer="sgd", learning_rate=0.1, log_every=1),
            device=dev)
        trainer.train(x, x, init_variables=init_variables(graph, 1,
                                                          device=dev))
        losses[dev] = [h["loss"] for h in trainer.history]
    assert len(losses["cuda"]) == 3
    # float32 keeps the f32-FMA kernels, forward and backward
    assert (fa.fwd_mma_launches, fa.bwd_kv_mma_launches,
            fa.bwd_q_mma_launches) == mma_before
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4


# -- the redesigned kernels: routes, chunk edges, batch invariance -------------


@pytest.mark.parametrize("b,s,h,hk,d,causal,window", [
    (8, 512, 8, 8, 64, True, None),
    (2, 500, 8, 2, 64, True, 128),
    (2, 384, 8, 1, 128, False, None),
    (1, 1, 4, 4, 64, True, None),
    (2, 64, 4, 4, 256, True, None),
    (2, 96, 4, 2, 40, True, None),
])
def test_forward_routes_match_reference(cuda, b, s, h, hk, d, causal,
                                        window):
    """The bf16 forward at the smoke run's five shapes and a D = 40 one:
    head dims 64 and 128 take the tensor-core kernel, 256 and 40 the
    f32-FMA one, each within the bf16 tolerance of the plain version
    (out) and 1e-5 (LSE, f32 on both sides)."""
    q, k, v, _ = _attention_inputs(b, s, h, hk, d, torch.bfloat16,
                                   seed=s + d + 1)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    want_route = "mma" if d in fa.MMA_HEAD_DIMS else "simt"
    assert fa._fwd_route(q, k, v) == want_route
    before = (fa.fwd_launches, fa.fwd_mma_launches)
    out, lse = fa.flash_attention_forward(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.fwd_launches == before[0] + 1
    assert fa.fwd_mma_launches == before[1] + (want_route == "mma")
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - want_out.float()).abs().max().item() <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-5
    # the inference-only forward writes the same output without an LSE
    out2, none = fa.flash_attention_forward(q, k, v, with_lse=False, **kw)
    assert none is None and torch.equal(out2, out)


_BWD_COUNTERS = ("bwd_kv_launches", "bwd_q_launches", "bwd_kv_mma_launches",
                 "bwd_q_mma_launches")


def _backward_against_reference(q, k, v, g, kw, route):
    """Both backward kernels on the plain forward's residuals against the
    plain backward: the counters show the route, and each gradient is
    within 1e-2 of the plain value's max (bf16: P and dS round at the
    same places; the kernels sum a GQA group's dK/dV in f32, the plain
    version rounds each head first)."""
    out, lse = fa.flash_attention_reference(q, k, v, **kw)
    before = [getattr(fa, name) for name in _BWD_COUNTERS]
    grads = fa.flash_attention_backward(q, k, v, out, lse, g, **kw)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    mma = int(route == "mma")
    assert [getattr(fa, name) for name in _BWD_COUNTERS] == [
        before[0] + 1, before[1] + 1, before[2] + mma, before[3] + mma]
    for got, ref in zip(grads, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _scaled_err(got, ref) <= 1e-2


@pytest.mark.parametrize("b,s,h,hk,d,causal,window", [
    (8, 512, 8, 8, 64, True, None),
    (2, 500, 8, 2, 64, True, 128),
    (2, 384, 8, 1, 128, False, None),
    (1, 1, 4, 4, 64, True, None),
    (2, 64, 4, 4, 256, True, None),
    (2, 96, 4, 2, 40, True, None),
    (1, 70, 4, 2, 128, True, 9),
])
def test_backward_routes_match_reference(cuda, b, s, h, hk, d, causal,
                                         window):
    """The bf16 backward at the smoke run's five shapes, a D = 40 one and
    a D = 128 window narrower than a tile: head dims 64 and 128 take the
    tensor-core pair, 256 and 40 the f32-FMA pair."""
    q, k, v, g = _attention_inputs(b, s, h, hk, d, torch.bfloat16,
                                   seed=s + d + 2)
    route = "mma" if d in fa.MMA_HEAD_DIMS else "simt"
    assert fa._bwd_route(q, k, v, g) == route
    _backward_against_reference(
        q, k, v, g, dict(causal=causal, window=window, scale=d ** -0.5),
        route)


def test_backward_misaligned_dO_takes_simt(cuda):
    """dO whose positions are 136 bytes apart (a head of 64 inside rows of
    68): the simt pair, as right as the mma pair would be."""
    q, k, v, _ = _attention_inputs(2, 96, 4, 2, 64, torch.bfloat16, seed=4)
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(2, 96, 4, 68, generator=gen).bfloat16().cuda()[..., :64]
    assert fa._bwd_route(q, k, v, g) == "simt"
    _backward_against_reference(q, k, v, g, dict(causal=True, window=None,
                                                 scale=0.125), "simt")


@pytest.mark.parametrize("b,s,h,hk,d,causal,window", [
    (8, 512, 8, 8, 64, True, None),
    (2, 500, 8, 2, 64, True, 128),
    (2, 384, 8, 1, 128, False, None),
])
def test_backward_is_deterministic(cuda, b, s, h, hk, d, causal, window):
    """Two backward calls on the same inputs give bit-equal dq, dk and dv:
    no atomics, every sum in a fixed order."""
    q, k, v, g = _attention_inputs(b, s, h, hk, d, torch.bfloat16, seed=6)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    assert fa._bwd_route(q, k, v, g) == "mma"
    out, lse = fa.flash_attention_forward(q, k, v, **kw)
    first = fa.flash_attention_backward(q, k, v, out, lse, g, **kw)
    second = fa.flash_attention_backward(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def _decode_case(mode, b, L, lengths, seed, ps=16, h=8, hk=2, d=64):
    """(call, reference call, counter name) for one decode mode over
    lengths, bf16 query."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, h, d, generator=gen).bfloat16().cuda()
    lens = torch.tensor(lengths, dtype=torch.int32).cuda()
    if mode in ("dense", "dense_q8"):
        if mode == "dense":
            k, v = (torch.randn(b, L, hk, d, generator=gen).bfloat16().cuda()
                    for _ in range(2))
            kw = {}
        else:
            k, ks = _int8_kv((b, L, hk, d), (b, hk), gen)
            v, vs = _int8_kv((b, L, hk, d), (b, hk), gen)
            kw = dict(k_scale=ks, v_scale=vs)
        return (lambda: fa.flash_decode(q, k, v, lens, **kw),
                lambda: fa.flash_decode_reference(q, k, v, lens, **kw),
                "launches" if mode == "dense" else "q8_launches")
    max_pages = L // ps
    num_pages = b * max_pages + 1
    shape = (num_pages, hk, ps, d)
    if mode == "paged":
        kp, vp = (torch.randn(shape, generator=gen).bfloat16().cuda()
                  for _ in range(2))
        kw = {}
    else:
        kp, ks = _int8_kv(shape, (num_pages, hk), gen)
        vp, vs = _int8_kv(shape, (num_pages, hk), gen)
        kw = dict(k_scale=ks, v_scale=vs)
    pt = _page_table(b, max_pages, num_pages, lengths, ps, gen)
    return (lambda: fa.paged_flash_decode(q, kp, vp, lens, pt, **kw),
            lambda: fa.paged_flash_decode_reference(q, kp, vp, lens, pt,
                                                    **kw),
            "paged_launches" if mode == "paged" else "paged_q8_launches")


@pytest.mark.parametrize("mode", ["dense", "dense_q8", "paged", "paged_q8"])
def test_decode_lengths_at_chunk_edges(cuda, mode):
    """Live lengths on either side of a split-KV chunk boundary, 0 and
    the whole cache, in all four decode modes (GQA, group 4)."""
    c, L = fa.DECODE_CHUNK, 4 * fa.DECODE_CHUNK
    lengths = [c - 1, c, c + 1, 0, L, 2 * c + 1]
    call, ref, counter = _decode_case(mode, len(lengths), L, lengths,
                                      seed=11)
    before = getattr(fa, counter)
    got = call()
    torch.cuda.synchronize()
    assert getattr(fa, counter) == before + 1
    want = ref()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 1e-2
    assert not got[3].any()  # length 0: exact zeros


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_decode_is_batch_invariant(cuda, mode):
    """One row decoded alone over a 256-position cache is bit-equal to
    the same row inside a batch of 8 over a 512-position cache: chunk
    boundaries follow the position, and every sum runs in a fixed
    order."""
    gen = torch.Generator().manual_seed(5)
    b, h, hk, d, n = 8, 8, 2, 64, 200
    q = torch.randn(b, 1, h, d, generator=gen).bfloat16().cuda()
    lens = torch.tensor([n, 17, 512, 0, 64, 65, 300, 1], dtype=torch.int32,
                        device="cuda")
    if mode == "dense":
        k, v = (torch.randn(b, 512, hk, d, generator=gen).bfloat16().cuda()
                for _ in range(2))
        batch = fa.flash_decode(q, k, v, lens)
        alone = fa.flash_decode(q[:1], k[:1, :256].contiguous(),
                                v[:1, :256].contiguous(), lens[:1])
    else:
        ps, max_pages = 16, 32
        num_pages = b * max_pages + 1
        kp, vp = (torch.randn(num_pages, hk, ps, d, generator=gen)
                  .bfloat16().cuda() for _ in range(2))
        pt = _page_table(b, max_pages, num_pages, lens.tolist(), ps, gen)
        batch = fa.paged_flash_decode(q, kp, vp, lens, pt)
        alone = fa.paged_flash_decode(q[:1], kp, vp, lens[:1],
                                      pt[:1, :16].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(alone[0], batch[0])


def test_sampling_and_beam_search_on_card(cuda, monkeypatch):
    """Sampling and beam search on the card, through the decode kernel:
    a seeded CUDA generator gives the same stream twice, every drawn
    token lies in the filtered support of its step's logits, a CPU
    generator is refused; beams=1 is greedy decode, ``return_all`` is
    sorted and led by the default output; the weight-int8 engine serves
    the same model."""
    import importlib

    from mmlspark_tpu_torch.core.exceptions import FriendlyError
    from mmlspark_tpu_torch.models import (
        beam_search,
        build_model,
        generate,
        init_variables,
    )
    from mmlspark_tpu_torch.serve import ServeEngine

    gen_mod = importlib.import_module("mmlspark_tpu_torch.models.generate")
    filter_logits = gen_mod.filter_logits
    steps = []

    def recorded(logits, *args):  # each step's logits, as sampled
        steps.append(logits.clone())
        return filter_logits(logits, *args)

    monkeypatch.setattr(gen_mod, "filter_logits", recorded)

    graph = build_model("transformer_lm", vocab_size=64, d_model=64,
                        heads=2, depth=2, max_len=64)
    variables = init_variables(graph, 7, device="cuda")
    prompt = torch.randint(0, 64, (4, 12), generator=torch.Generator()
                           .manual_seed(7), dtype=torch.int32).cuda()
    kw = dict(temperature=0.8, top_k=10, top_p=0.9)
    before = fa.launches
    streams = [generate(graph, variables, prompt, 16,
                        rng=torch.Generator(device="cuda").manual_seed(3),
                        **kw) for _ in range(2)]
    assert torch.equal(streams[0], streams[1])
    assert fa.launches - before == 2 * 2 * 15  # 2 layers, 15 cached steps
    for t, logits in enumerate(steps[:16]):  # the first stream's steps
        kept = torch.isfinite(filter_logits(logits, 0.8, 10, 0.9))
        drawn = streams[0][:, 12 + t].long()
        assert kept[torch.arange(4), drawn].all()
    with pytest.raises(FriendlyError, match="lives on cpu"):
        generate(graph, variables, prompt, 4, rng=torch.Generator(), **kw)

    greedy = generate(graph, variables, prompt, 10)
    assert torch.equal(beam_search(graph, variables, prompt, 10, beams=1),
                       greedy)
    seqs, scores = beam_search(graph, variables, prompt, 10, beams=3,
                               return_all=True)
    assert (scores[:, :-1] >= scores[:, 1:]).all()
    assert torch.equal(beam_search(graph, variables, prompt, 10, beams=3),
                       seqs[:, 0])

    engine = ServeEngine(graph, variables, slots=2, cache_len=64,
                         decode_block=4, quantize_weights=True)
    rid = engine.submit(prompt[0].cpu().numpy(), max_new_tokens=8)
    assert engine.run()[rid].generated == 8


# -- the program ladder: CUDA graphs -------------------------------------------


def _small_lm():
    from mmlspark_tpu_torch.models import build_model, init_variables

    graph = build_model("transformer_lm", vocab_size=64, d_model=64,
                        heads=2, depth=2, max_len=64)
    return graph, init_variables(graph, 11, device="cuda")


def _clone_state(pool):
    bufs = {n: tuple(t.clone() for t in e) for n, e in pool.buffers.items()}
    return bufs, pool.positions.clone(), pool.live.clone()


def _counts():
    return {n: getattr(fa, n) for n in fa.COUNTERS}


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_dtype="int8"),
    dict(paged=True, page_size=16, prefix_cache=True),
    dict(paged=True, page_size=16, kv_dtype="int8"),
    dict(quantize_weights=True),
], ids=["dense", "dense_int8", "paged", "paged_int8", "weight_int8"])
def test_captured_decode_block_matches_eager(cuda, kw):
    """A captured decode block replayed on a pool's state emits the same
    tokens and leaves the same KV bytes, positions and live mask as the
    eager ``make_decode_block`` on a copy of that state, and its replay
    adds the eager call's kernel launches to the counters."""
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _small_lm()
    engine = ServeEngine(graph, variables, slots=4, cache_len=64,
                         decode_block=4, **kw)
    rng = np.random.default_rng(3)
    for n in (5, 12, 9):
        engine.submit(rng.integers(0, 64, size=n), 30)
    engine.step()  # prefills, and the T=4 program's eager call and capture
    assert engine.decode_compile_count == 1
    tok, rem, eos, _ = engine._sched.decode_block_inputs(engine.pad_id)
    if engine._paged:
        engine.pool.ensure_decode_pages(
            {s: st.pos for s, st in engine._sched.active.items()}, 4)
    args = [torch.from_numpy(a).cuda() for a in (tok, rem, eos)]
    bufs, pos, live = _clone_state(engine.pool)
    before = _counts()
    with engine._weights(engine.variables) as weights:
        want_toks, want_live, _, want_pos = engine._block(
            weights, bufs, pos, live, *args, 4)
    torch.cuda.synchronize()
    eager = {n: v - before[n] for n, v in _counts().items()}
    before = _counts()
    got = engine._decode(engine.variables, engine.pool.buffers,
                         engine.pool.positions, engine.pool.live, *args, 4)
    torch.cuda.synchronize()
    replay = {n: v - before[n] for n, v in _counts().items()}
    assert engine.decode_compile_count == 1  # a replay, no new program
    assert torch.equal(got, want_toks)
    assert torch.equal(engine.pool.positions, want_pos)
    assert torch.equal(engine.pool.live, want_live)
    for name, entry in engine.pool.buffers.items():
        for a, b in zip(entry, bufs[name]):
            assert torch.equal(a, b), name
    assert replay == eager and sum(eager.values()) == 2 * 4  # 2 layers


def test_program_counts_hold_on_a_short_schedule(cuda):
    """Mixed-length joiners through the dense and the paged prefix-cache
    engines: streams equal ``generate()`` on the card, the programs stay
    within their pins and were captured (capture time and pool bytes)."""
    from mmlspark_tpu_torch.models import generate
    from mmlspark_tpu_torch.serve import ServeEngine
    from mmlspark_tpu_torch.testing import serve_compile_guard

    graph, variables = _small_lm()
    rng = np.random.default_rng(4)
    head = rng.integers(0, 64, size=20)
    prompts = [np.concatenate([head, rng.integers(0, 64, size=n)])
               for n in (3, 7, 1, 12)] + [rng.integers(0, 64, size=n)
                                         for n in (4, 17)]
    for kw in (dict(), dict(paged=True, page_size=16, prefix_cache=True)):
        engine = ServeEngine(graph, variables, slots=2, cache_len=64,
                             decode_block=8, **kw)
        with serve_compile_guard(engine, min_decode=1, min_prefill=1):
            rids = [engine.submit(p, 9) for p in prompts]
            results = engine.run()
        for rid, p in zip(rids, prompts):
            want = generate(graph, variables, p[None], 9)[0].cpu().numpy()
            np.testing.assert_array_equal(results[rid].tokens, want)
        assert engine.resume_compile_count <= engine.num_prefill_buckets
        if kw:
            assert engine.pool.prefix_hits >= 1
            assert engine.resume_compile_count >= 1
        assert engine.capture_seconds > 0
        assert engine.graph_pool_bytes() > 0


def _optimizer_tensors(kind, n_tensors, seed):
    from mmlspark_tpu_torch.ops.fused_optim import moment_names

    gen = torch.Generator().manual_seed(seed)
    shapes = [(4096 * 3 + 17,), (64, 65), (1,), (5000,)]
    shapes = [shapes[i % len(shapes)] for i in range(n_tensors)]

    def make(scale=1.0, positive=False):
        out = [torch.randn(s, generator=gen) * scale for s in shapes]
        return [(t.abs() if positive else t).cuda() for t in out]

    params, grads = make(), make()
    moments = [make(0.1, positive=(name == "nu"))
               for name in moment_names(kind)]
    return params, grads, moments


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd", "momentum"])
def test_fused_optimizer_is_bit_equal_to_plain(cuda, kind, bad):
    """The fused kernel against the plain update on the same CUDA
    tensors: bit-equal parameters and moments in f32, nothing written
    where ``bad``; 130 tensors take two launches (128 a table)."""
    from mmlspark_tpu_torch.ops import fused_optim as fo

    for n_tensors in (4, 130):
        params, grads, moments = _optimizer_tensors(kind, n_tensors, 5)
        plain = ([p.clone() for p in params],
                 [[t.clone() for t in m] for m in moments])
        step_size = torch.full((), -3e-3, device=cuda)
        count = torch.full((), 7, dtype=torch.int32, device=cuda)
        c1 = 1 - torch.pow(fo.ADAM_B1, count)
        c2 = 1 - torch.pow(fo.ADAM_B2, count)
        flag = torch.tensor(bad, device=cuda)
        args = (step_size, c1, c2, flag)
        kw = dict(weight_decay=0.1, momentum=0.8)
        before = fo.launches
        fo._launch(kind, params, grads, moments, *args, **kw)
        assert fo.launches - before == -(-n_tensors // fo.MAX_TENSORS)
        fo.optimizer_update_reference(kind, plain[0], grads, plain[1],
                                      *args, **kw)
        torch.cuda.synchronize()
        for got, want in zip(params + sum(moments, []),
                             plain[0] + sum(plain[1], [])):
            assert torch.equal(got, want)
        if bad:
            assert torch.equal(params[0], _optimizer_tensors(
                kind, n_tensors, 5)[0][0])


@pytest.mark.parametrize("kw", [dict(), dict(remat=True),
                                dict(grad_accum=2)],
                         ids=["plain", "remat", "grad_accum2"])
def test_captured_training_step_matches_eager(cuda, kw, monkeypatch):
    """Four adam steps through the trainer, whose step is captured after
    step 0 and replayed, against the same four steps run eagerly on the
    card (the program wrapper swapped for a plain call): the same losses
    and parameters within 1e-6 (f32), one program, one fused-optimizer
    launch a step."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.ops import fused_optim as fo
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig
    from mmlspark_tpu_torch.train import trainer as trainer_mod

    graph = build_model("transformer_lm", vocab_size=64, d_model=64,
                        heads=4, kv_heads=2, depth=2, max_len=48,
                        attn_impl="flash")
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    x = torch.randint(0, 64, (16, 48), generator=torch.Generator()
                      .manual_seed(0)).numpy()
    weights = init_variables(graph, 2, device="cuda")

    def run():
        trainer = SPMDTrainer(graph, TrainConfig(
            batch_size=4, learning_rate=1e-3, log_every=1, **kw))
        before = fo.launches
        out = trainer.train(x, x, init_variables=weights)
        torch.cuda.synchronize()
        return trainer, out, fo.launches - before

    graphed, got, launches = run()
    assert launches == 4
    assert graphed.telemetry.counter("retrace.train.step").value == 1

    class Eager:
        def __init__(self, fn, **_):
            self.fn = fn

        def __call__(self, *args):
            return self.fn(*args)

    monkeypatch.setattr(trainer_mod, "ProgramCountingGraph", Eager)
    eager, want, _ = run()
    for a, b in zip(graphed.history, eager.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-6
    for block, leaves in want.items():
        for name, w in leaves.items():
            assert (got[block][name] - w).abs().max().item() <= 1e-6


def test_capture_that_syncs_the_host_raises(cuda):
    """A program that reads a device value on the host cannot be
    captured: the wrapper raises, after the first (eager) call ran."""
    from mmlspark_tpu_torch.testing import ProgramCountingGraph

    prog = ProgramCountingGraph(lambda x: x * x.sum().item(),
                                label="syncing")
    with pytest.raises(RuntimeError, match="syncing: the program failed"):
        prog(torch.ones(4, device=cuda))
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=cuda).sum()) == 2.0


def test_collection_inside_a_capture_cannot_invalidate_it(cuda):
    """A cyclic garbage collection that ran inside a capture used to free
    earlier programs' graphs, pinned buffers and events there — CUDA
    calls that are illegal while a stream captures — and the capture
    failed for a reason outside it (``test_async_streams_bit_equal_sync
    [paged_int8]`` after the file's earlier tests). Here such a cycle
    becomes garbage inside the capture and the collector comes due
    there; the capture holds it off, so the program captures, replays
    right, and the cycle is collected after."""
    import gc
    import weakref

    from mmlspark_tpu_torch.testing import ProgramCountingGraph

    x = torch.arange(4.0, device=cuda)
    holder = {}

    def leave_garbage():
        old = ProgramCountingGraph(lambda t: t * 2, label="old")
        old(x)  # eager, then captured: the cycle holds a CUDA graph
        host = torch.empty(4, pin_memory=True)
        host.copy_(x, non_blocking=True)  # a pinned buffer with an event
        event = torch.cuda.Event()
        event.record()
        cycle = [old, host, event]
        cycle.append(cycle)
        holder["cycle"] = cycle
        return weakref.ref(old)

    def churn(t):
        if torch.cuda.is_current_stream_capturing():
            holder.pop("cycle")  # garbage now, kept only by its cycle
            threshold = gc.get_threshold()
            gc.set_threshold(1, 1, 1)  # the collector comes due
            try:
                junk = [[object()] for _ in range(8)]
            finally:
                gc.set_threshold(*threshold)
            del junk
        return t + 1

    for _ in range(2):
        alive = leave_garbage()
        torch.cuda.synchronize()
        prog = ProgramCountingGraph(churn, label="victim")
        y = prog(x)  # eager; then captured
        y = prog(x + 1)  # replayed
        torch.cuda.synchronize()
        assert torch.equal(y, x + 2)
        assert gc.isenabled()
        gc.collect()
        assert alive() is None  # collected after the capture


# -- chunked prefill, the async host loop, the resilience layer ----------------


def _wide_lm():
    """A model wide enough that a T=32 block outlasts the host's dispatch
    of the next one."""
    from mmlspark_tpu_torch.models import build_model, init_variables

    graph = build_model("transformer_lm", vocab_size=512, d_model=256,
                        heads=4, depth=4, max_len=256)
    return graph, init_variables(graph, 12, device="cuda")


def _joins(engine, prompts, budget):
    """Half the prompts up front, two ticks, then the rest join."""
    results, rids = {}, []
    half = len(prompts) // 2
    for p in prompts[:half]:
        rids.append(engine.submit(p, budget))
    for _ in range(2):
        results.update({r.id: r for r in engine.step()})
    for p in prompts[half:]:
        rids.append(engine.submit(p, budget))
    results.update(engine.run())
    return [results[r].tokens for r in rids]


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_dtype="int8"),
    dict(paged=True, page_size=16, prefix_cache=True),
    dict(paged=True, page_size=16, kv_dtype="int8"),
    dict(quantize_weights=True),
], ids=["dense", "dense_int8", "paged", "paged_int8", "weight_int8"])
def test_async_streams_bit_equal_sync(cuda, kw):
    """The async loop runs the same programs on the same inputs as the
    synchronous one, only reordered on the host: the streams are
    bit-equal on the card, for every pool and weight-int8."""
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _small_lm()
    rng = np.random.default_rng(5)
    head = rng.integers(0, 64, size=20)
    prompts = [np.concatenate([head, rng.integers(0, 64, size=n)])
               for n in (3, 9)] + [rng.integers(0, 64, size=n)
                                   for n in (4, 17, 30, 2)]
    streams = {}
    for mode in (False, True):
        engine = ServeEngine(graph, variables, slots=3, cache_len=64,
                             decode_block=8, async_host=mode, **kw)
        streams[mode] = _joins(engine, prompts, 12)
        if mode:
            assert engine.metrics.overlapped_dispatches_total > 0
            assert engine.pool.leased_count == 0
    for a, b in zip(streams[False], streams[True]):
        np.testing.assert_array_equal(a, b)


def test_async_fetch_overlaps_the_next_block(cuda):
    """A pipelined fetch waits on its own block's event only: at least
    one fetch returns while the block dispatched after it is still
    running (its event pending)."""
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _wide_lm()
    engine = ServeEngine(graph, variables, slots=8, cache_len=256,
                         decode_block=32, async_host=True)
    rng = np.random.default_rng(6)
    for _ in range(8):
        engine.submit(rng.integers(0, 512, size=16), 1 + 4 * 32)
    seen = {"fetches": 0, "pending": 0}
    inner = engine._fetch

    def fetch(inflight):
        out = inner(inflight)
        seen["fetches"] += 1
        nxt = engine._inflight
        if nxt is not None and not nxt["event"].query():
            seen["pending"] += 1
        return out

    engine._fetch = fetch
    engine.run()
    assert seen["pending"] >= 1, seen
    assert engine.metrics.overlapped_dispatches_total > 0


def test_oom_inside_a_capture_degrades_and_recaptures(cuda):
    """An allocation failure raised inside a decode program's capture:
    classified as resource exhaustion through the wrapping error, the
    positions and live mask its eager run advanced restored, the block
    cap halved down the ladder, the capture stream closed, the key
    captured again on its next call, every count within its pin and the
    streams equal ``generate()``."""
    from mmlspark_tpu_torch.models import generate
    from mmlspark_tpu_torch.serve import ServeEngine
    from mmlspark_tpu_torch.testing import serve_compile_guard

    graph, variables = _small_lm()
    engine = ServeEngine(graph, variables, slots=2, cache_len=64,
                         decode_block=4, retry_backoff_s=0.0,
                         degrade_recover_ticks=2)
    program = engine._decode._fn
    body = program._fn
    armed = {"n": 1}

    def flaky(*args):
        if armed["n"] and torch.cuda.is_current_stream_capturing() \
                and args[-1] == 4:
            armed["n"] -= 1
            raise torch.cuda.OutOfMemoryError("forced inside the capture")
        return body(*args)

    program._fn = flaky
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 64, size=n) for n in (5, 11, 8)]
    with serve_compile_guard(engine, min_decode=1, min_prefill=1):
        rids = [engine.submit(p, 20) for p in prompts]
        results = engine.run()
    assert armed["n"] == 0
    assert not torch.cuda.is_current_stream_capturing()
    events = [e["name"] for e in engine.recorder.events()]
    assert "degraded" in events and "recovered" in events
    assert "2" in engine.metrics.decode_blocks
    assert "4" in engine.metrics.decode_blocks  # recaptured and replayed
    assert engine.decode_compile_count <= engine.num_decode_blocks
    assert engine.metrics.retries_total == 1
    for rid, p in zip(rids, prompts):
        want = generate(graph, variables, p[None], 20)[0].cpu().numpy()
        np.testing.assert_array_equal(results[rid].tokens, want)


def test_chunked_streams_match_monolithic_or_near_tie(cuda):
    """Chunked fills run GEMMs of other shapes than the monolithic
    prefill, so in bf16 at random weights a stream may first differ only
    at a near tie: the top-2 margin of the full forward there below the
    bf16 logit tolerance; every chunk family within its pin."""
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _small_lm()
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 64, size=n) for n in (40, 7, 33, 17, 50)]
    streams = {}
    for chunk in (None, 16):
        engine = ServeEngine(graph, variables, slots=2, cache_len=64,
                             decode_block=8, prefill_chunk=chunk,
                             async_host=chunk is not None)
        streams[chunk] = _joins(engine, prompts, 12)
        assert engine.prefill_compile_count <= engine.num_prefill_buckets
    for p, want, got in zip(prompts, streams[None], streams[16]):
        diff = np.nonzero(want != got)[0]
        if not diff.size:
            continue
        i = int(diff[0])
        assert i >= len(p)
        ids = torch.from_numpy(want[None, :i].astype(np.int32)).cuda()
        top2 = graph.apply(variables, ids)[0, -1].float().sort().values[-2:]
        assert float(top2[1] - top2[0]) < 6.25e-2


def test_slot_freed_in_flight_is_not_released_before_its_fetch(cuda):
    """A request cancelled while the block that saw it live is in flight
    frees its slot into the deferred window: no new lease takes the slot
    until that block is fetched; then the next request gets it and
    decodes like ``generate()``."""
    from mmlspark_tpu_torch.models import generate
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _small_lm()
    engine = ServeEngine(graph, variables, slots=1, cache_len=64,
                         decode_block=4, async_host=True)
    rng = np.random.default_rng(9)
    a = engine.submit(rng.integers(0, 64, size=6), 30)
    engine.step()  # a admitted, its first block dispatched, in flight
    assert engine._inflight is not None
    slot = next(iter(engine._sched.active))
    assert engine.cancel(a) is not None
    assert slot in engine.pool._deferred_slots
    assert engine.pool.free_count == 0
    prompt = rng.integers(0, 64, size=9)
    b = engine.submit(prompt, 10)
    engine.step()  # no lease yet; the in-flight block is fetched
    assert engine.queue_depth == 1 and engine.pool.free_count == 1
    results = engine.run()
    want = generate(graph, variables, prompt[None], 10)[0].cpu().numpy()
    np.testing.assert_array_equal(results[b].tokens, want)
    assert a not in results


# -- the trainer's resilience: the fold kernel, bit-exact resume, the ladder ---


def _fold_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return [
        torch.randn(7, 5, generator=g),
        torch.randn(8193 * 3 + 5, generator=g).bfloat16(),
        torch.randn(3, generator=g).half(),
        torch.randint(-128, 128, (16385 + 7,), generator=g,
                      dtype=torch.int8),
        torch.randint(-2 ** 31, 2 ** 31 - 1, (33,), generator=g,
                      dtype=torch.int32),
        torch.randint(-2 ** 62, 2 ** 62, (17,), generator=g,
                      dtype=torch.int64),
        torch.randn(9, generator=g, dtype=torch.float64),
        torch.rand(77, generator=g) > 0.5,
        torch.zeros(0),
        torch.randn(40_000, generator=g),
        torch.zeros((), dtype=torch.int32),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_kernel_bit_equal_to_plain_and_host(cuda, seed):
    """Every word size, odd lengths, empty leaves and a 4-byte-aligned
    leaf that is not 16-byte aligned (the scalar path): the kernel's fold
    equals the plain version's and numpy's, on every repeat (the
    workspace is left at zero)."""
    from mmlspark_tpu_torch.core.integrity import tree_checksum_host
    from mmlspark_tpu_torch.ops import tree_checksum as tc

    leaves = _fold_tree(seed)
    base = torch.randn(50_001, device=cuda)
    on_card = [t.to(cuda) for t in leaves] + [base[1:]]
    want = tree_checksum_host(leaves + [base[1:].cpu()])
    plan = tc.FoldPlan(on_card)
    out = torch.zeros((), dtype=torch.int32, device=cuda)
    before = tc.launches
    for _ in range(3):
        tc.tree_fold(on_card, out=out, plan=plan)
        assert tc.as_uint32(out) == want
    assert tc.launches - before == 3
    assert tc.as_uint32(tc.tree_fold_reference(on_card)) == want
    assert not plan.workspace.any()


def test_fold_flag_exits_early_and_keeps_the_carry(cuda):
    from mmlspark_tpu_torch.ops import tree_checksum as tc

    leaves = [t.to(cuda) for t in _fold_tree(2)]
    plan = tc.FoldPlan(leaves)
    out = torch.full((), 1234, dtype=torch.int32, device=cuda)
    off = torch.zeros((), dtype=torch.bool, device=cuda)
    on = torch.ones((), dtype=torch.bool, device=cuda)
    tc.tree_fold(leaves, out=out, flag=off, plan=plan)
    assert int(out) == 1234 and not plan.workspace.any()
    tc.tree_fold(leaves, out=out, flag=on, plan=plan)
    assert tc.as_uint32(out) == tc.as_uint32(tc.tree_fold_reference(leaves))
    with pytest.raises(ValueError, match="other tensors"):
        tc.tree_fold(leaves[:-1], out=out, plan=plan)


def _blobs(n=96, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(-1.5, 1.0, (n // 2, d)),
                        rng.normal(1.5, 1.0, (n // 2, d))]).astype(np.float32)
    y = np.concatenate([np.zeros(n // 2), np.ones(n // 2)]).astype(np.int32)
    perm = rng.permutation(n)
    return x[perm], y[perm]


def _lm_rows(n, seed, vocab=256, seq=64):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n, 1))
    stride = rng.integers(1, 16, size=(n, 1))
    x = ((start + stride * np.arange(seq)) % vocab).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


_RESILIENCE_MODELS = {
    "mlp": (dict(name="mlp", num_outputs=2, hidden=(64,)), _blobs,
            dict(batch_size=32, learning_rate=1e-2)),
    "lm_depth2": (dict(name="transformer_lm", vocab_size=256, d_model=128,
                       heads=2, depth=2, max_len=64, attn_impl="flash"),
                  lambda: _lm_rows(24, 3),
                  dict(batch_size=8, learning_rate=1e-3)),
}


def _model(key):
    from mmlspark_tpu_torch.models import build_model

    kw, data, cfg = _RESILIENCE_MODELS[key]
    kw = dict(kw)
    return build_model(kw.pop("name"), **kw), data(), cfg


@pytest.mark.parametrize("key", sorted(_RESILIENCE_MODELS))
def test_eager_step_bit_equal_to_replayed(cuda, key, monkeypatch):
    """Every step of a run whose steps 1.. replay one captured program
    against the same steps all run eagerly: bit-equal losses and
    parameters — what a resume (whose first step is eager) relies on."""
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig
    from mmlspark_tpu_torch.train import trainer as trainer_mod

    graph, (x, y), cfg = _model(key)

    def run():
        tr = SPMDTrainer(graph, TrainConfig(epochs=2, log_every=1,
                                            shuffle=False, **cfg))
        return tr, tr.train(x, y)

    graphed, got = run()
    assert graphed.telemetry.counter("retrace.train.step").value == 1

    class Eager:
        def __init__(self, fn, **_):
            self.fn = fn

        def __call__(self, *args):
            return self.fn(*args)

    monkeypatch.setattr(trainer_mod, "ProgramCountingGraph", Eager)
    eager, want = run()
    assert [h["loss"] for h in graphed.history] == \
        [h["loss"] for h in eager.history]
    for block, leaves in want.items():
        for name, w in leaves.items():
            assert torch.equal(got[block][name], w), (block, name)


@pytest.mark.parametrize("key", sorted(_RESILIENCE_MODELS))
def test_kill_and_resume_bit_exact_on_card(cuda, key, tmp_path):
    from mmlspark_tpu_torch.core.faults import (
        EngineKilled,
        Fault,
        FaultInjector,
    )
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    graph, (x, y), cfg = _model(key)
    base = dict(epochs=2, log_every=1, shuffle=False, **cfg)
    full = SPMDTrainer(graph, TrainConfig(**base))
    want = full.train(x, y)
    ck = dict(base, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    with pytest.raises(EngineKilled):
        SPMDTrainer(graph, TrainConfig(**ck), faults=FaultInjector(
            [Fault("train.step", "kill", tick=4)])).train(x, y)
    resumed = SPMDTrainer(graph, TrainConfig(**ck))
    got = resumed.train(x, y)
    assert resumed.history[0]["step"] == 3  # from the step-2 checkpoint
    assert [h["loss"] for h in resumed.restored_history + resumed.history] \
        == [h["loss"] for h in full.history]
    for block, leaves in want.items():
        for name, w in leaves.items():
            assert torch.equal(got[block][name], w), (block, name)


def test_ladder_captures_a_second_program(cuda, monkeypatch):
    """Resource exhaustion walks grad_accum 1 -> 2 and captures the step
    again; an allocation failure in the capture itself does the same (the
    eager step before it stands, and the failed capture leaves no
    program), and both runs end alike."""
    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig
    from mmlspark_tpu_torch.train import trainer as trainer_mod

    graph, (x, y), cfg = _model("mlp")
    base = dict(epochs=2, log_every=1, shuffle=False, **cfg)
    hooked = SPMDTrainer(graph, TrainConfig(**base), faults=FaultInjector(
        [Fault("train.step", "oom", tick=1)]))
    want = hooked.train(x, y)
    tel = hooked.telemetry
    assert tel.counter("retrace.train.step").value == 2
    assert tel.gauge("train.grad_accum").value == 2
    assert tel.gauge("train.step_capture_s").value > 0

    masked_loss = trainer_mod.masked_loss
    failed = []

    def failing(*args):
        if torch.cuda.is_current_stream_capturing() and not failed:
            failed.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return masked_loss(*args)

    monkeypatch.setattr(trainer_mod, "masked_loss", failing)
    real = SPMDTrainer(graph, TrainConfig(**base))
    got = real.train(x, y)
    assert failed and real.telemetry.counter(
        "retrace.train.step").value == 1
    assert real.telemetry.gauge("train.grad_accum").value == 2
    assert [h["loss"] for h in real.history] == \
        [h["loss"] for h in hooked.history]
    for block, leaves in want.items():
        for name, w in leaves.items():
            assert torch.equal(got[block][name], w), (block, name)


def test_audited_step_is_one_program_and_adjudicates(cuda):
    """audit_every=2 on the card: one step program, one fold launch a step
    (an empty one on non-audit steps), clean audits without faults, and a
    flip after an audit step's fold replayed and adopted bit-exact."""
    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.ops import tree_checksum as tc
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    graph, (x, y), cfg = _model("lm_depth2")
    base = dict(epochs=2, log_every=1, shuffle=False, **cfg)
    want = SPMDTrainer(graph, TrainConfig(**base)).train(x, y)
    before = tc.launches
    clean = SPMDTrainer(graph, TrainConfig(audit_every=2, **base))
    clean.train(x, y)
    torch.cuda.synchronize()
    assert tc.launches - before == 6
    tel = clean.telemetry.to_dict()
    assert tel["retrace.train.step"] == 1
    assert tel["train.integrity.audits"] == 3
    assert tel["train.integrity.sdc_suspected"] == 0
    drill = SPMDTrainer(graph, TrainConfig(audit_every=2, **base),
                        faults=FaultInjector([Fault("train.step", "corrupt",
                                                    tick=3)]))
    got = drill.train(x, y)
    assert [v["verdict"] for v in drill.replay_verdicts] == ["transient_sdc"]
    for block, leaves in want.items():
        for name, w in leaves.items():
            assert torch.equal(got[block][name], w), (block, name)


# -- the stage layer and the CNNs -----------------------------------------------


def _f32_port(graph):
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


@pytest.mark.parametrize("name,cfg,shape", [
    ("resnet20_cifar10", {}, (8, 32, 32, 3)),
    ("resnet50", {"input_size": 64}, (4, 64, 64, 3)),
])
def test_resnet_forward_on_card_matches_cpu(cuda, name, cfg, shape):
    """cuDNN's channels_last convolutions against the port's f32 CPU
    forward on the same weights (f32 compute, TF32 off): within 1e-3 of
    the largest logit; bf16 on the card within 3e-2 of it."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.models.bridge import variables_to

    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(
        np.float32))
    graph = build_model(name, **cfg)
    cpu_vars = init_variables(graph, 0, device="cpu")
    card_vars = variables_to(cpu_vars, cuda)
    want_bf16 = graph.apply(cpu_vars, x)
    got_bf16 = graph.apply(card_vars, x.to(cuda)).cpu()
    _f32_port(graph)
    want = graph.apply(cpu_vars, x)
    got = graph.apply(card_vars, x.to(cuda)).cpu()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-3 * scale
    assert (got_bf16 - want_bf16).abs().max().item() <= 3e-2 * scale


def test_tpu_model_programs_and_eager_twin(cuda, monkeypatch):
    """TPUModel on the card: one captured program per key, replayed for
    every batch, and the same scores and launch counts (the flash forward)
    as an eager twin whose programs are never captured."""
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.stages import TPUModel
    from mmlspark_tpu_torch.stages import dnn_model
    from mmlspark_tpu_torch.testing.compile_guard import ProgramCountingGraph

    cfg = dict(vocab_size=64, d_model=128, heads=2, depth=2, max_len=64,
               attn_impl="flash")
    graph = build_model("transformer_lm", **cfg)
    weights = init_variables(graph, 0, device="cpu")
    rows = np.random.default_rng(0).integers(0, 64, size=(10, 64))
    ds = Dataset({"tokens": rows})

    def run(stage):
        fa.fwd_launches = 0
        out = stage.transform(ds)["scores"]
        torch.cuda.synchronize()
        return out, fa.fwd_launches

    captured = TPUModel(model_name="transformer_lm", model_config=cfg,
                        input_col="tokens", batch_size=4).set(weights=weights)
    scores, launches = run(captured)

    class EagerPrograms(ProgramCountingGraph):
        def _capture(self, args):
            return None

    monkeypatch.setattr(dnn_model, "ProgramCountingGraph", EagerPrograms)
    eager = captured.copy().set(weights=weights)
    eager_scores, eager_launches = run(eager)
    assert captured.program_count == eager.program_count == 1
    assert captured.capture_seconds > 0 and eager.capture_seconds == 0
    assert launches == eager_launches == 3 * cfg["depth"]
    np.testing.assert_array_equal(scores, eager_scores)


def test_captured_train_step_updates_batch_statistics(cuda):
    """The ResNet trainer's captured step writes the running statistics
    in place, step after step, as its eager twin on the CPU does (f32,
    TF32 off: within 1e-4 relative after three steps)."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=24)
    out = {}
    for dev in ("cuda", "cpu"):
        graph = _f32_port(build_model("resnet20_cifar10", width=8))
        init = init_variables(graph, 0, device="cpu")
        trainer = SPMDTrainer(graph, TrainConfig(batch_size=8, log_every=1,
                                                 optimizer="sgd",
                                                 learning_rate=1e-2),
                              device=dev)
        out[dev] = (trainer.train(x, y, init_variables=init), init, trainer)
    (card, init, trainer), (cpu, _, _) = out["cuda"], out["cpu"]
    assert trainer.telemetry.counter("retrace.train.step").value == 1
    key = "ResBlock_0.ConvBN_2.BatchNorm_0.var"
    got, want = card["stage2"][key].cpu(), cpu["stage2"][key]
    assert not torch.equal(want, init["stage2"][key])
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# -- the switch-MoE LM and the image path ------------------------------------------


def _overfit_moe():
    """A small MoE LM overfit on the card to a periodic stream (1..4
    cycling; the JAX package's ``overfit_periodic_lm`` recipe: adam at
    5e-2, 40 steps on one row) by the port's trainer, so greedy picks
    have wide margins."""
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    graph = build_model("transformer_lm_moe", vocab_size=8, d_model=64,
                        heads=1, depth=2, max_len=64, n_experts=2,
                        capacity_factor=2.0, attn_impl="flash")
    x = ((np.arange(32)[None] % 4) + 1).astype(np.int32)
    trainer = SPMDTrainer(graph, TrainConfig(
        epochs=40, batch_size=1, learning_rate=5e-2, log_every=40,
        shuffle=False))
    return graph, trainer.train(x, np.roll(x, -1, axis=1)), x[0]


def test_moe_engines_match_generate_and_each_other(cuda):
    """The MoE LM's dense and paged prefix-cache engines on the card (a
    ragged, joining schedule): every stream equal to the port's
    ``generate()`` on the card and dense equal to paged; the decode
    kernels launched ``depth`` times a micro-step; the dense engine made
    one prefill program a distinct prompt length, the paged one resumed
    its prefix hits."""
    from mmlspark_tpu_torch.models import generate
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables, row = _overfit_moe()
    prompts = [row[:n] for n in (5, 1, 17, 9, 23, 17)]
    budgets = [12, 7, 20, 16, 9, 11]
    want = [generate(graph, variables, p[None], n)[0].cpu().numpy()
            for p, n in zip(prompts, budgets)]
    streams = {}
    for label, kw, counter in (
            ("dense", {}, "launches"),
            ("paged", dict(paged=True, page_size=8, prefix_cache=True),
             "paged_launches")):
        engine = ServeEngine(graph, variables, slots=3, cache_len=64,
                             decode_block=8, **kw)
        setattr(fa, counter, 0)
        results, rids = {}, []
        for p, n in zip(prompts[:3], budgets[:3]):
            rids.append(engine.submit(p, n))
        for _ in range(2):
            results.update({r.id: r for r in engine.step()})
        for p, n in zip(prompts[3:], budgets[3:]):
            rids.append(engine.submit(p, n))
        results.update(engine.run())
        torch.cuda.synchronize()
        if label == "dense":
            dense_programs = engine.prefill_compile_count
        steps = sum(int(t) * c
                    for t, c in engine.metrics.decode_blocks.items())
        assert getattr(fa, counter) == 2 * steps
        streams[label] = [results[r].tokens for r in rids]
        for got, w in zip(streams[label], want):
            np.testing.assert_array_equal(got, w)
    # dense: every prompt prefilled at its exact length; paged: the
    # prefix hits resumed their remainders instead
    lengths = len({len(p) for p in prompts})
    assert dense_programs == lengths
    assert engine.pool.prefix_hits >= 1 and engine.resume_compile_count >= 1
    assert engine.prefill_compile_count < lengths


def test_captured_moe_training_step_bit_equal_to_eager(cuda, monkeypatch):
    """Four adam steps of a float32 MoE LM (the aux loss in the loss)
    through the trainer, its step captured after step 0 and replayed,
    against the same steps run eagerly on the card: bit-equal losses
    and parameters, one program, one fused-optimizer launch a step."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.ops import fused_optim as fo
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig
    from mmlspark_tpu_torch.train import trainer as trainer_mod

    graph = _f32_port(build_model(
        "transformer_lm_moe", vocab_size=64, d_model=64, heads=1, depth=2,
        max_len=48, n_experts=4, attn_impl="flash"))
    x = torch.randint(0, 64, (16, 48), generator=torch.Generator()
                      .manual_seed(0)).numpy()
    weights = init_variables(graph, 2, device="cuda")

    def run():
        trainer = SPMDTrainer(graph, TrainConfig(
            batch_size=4, learning_rate=1e-3, log_every=1,
            moe_aux_weight=1e-2))
        before = fo.launches
        out = trainer.train(x, x, init_variables=weights)
        torch.cuda.synchronize()
        return trainer, out, fo.launches - before

    graphed, got, launches = run()
    assert launches == 4
    assert graphed.telemetry.counter("retrace.train.step").value == 1

    class Eager:
        def __init__(self, fn, **_):
            self.fn = fn

        def __call__(self, *args):
            return self.fn(*args)

    monkeypatch.setattr(trainer_mod, "ProgramCountingGraph", Eager)
    eager, want, _ = run()
    assert [h["loss"] for h in graphed.history] == \
        [h["loss"] for h in eager.history]
    for block, leaves in want.items():
        assert "losses" not in got[block]
        for name, w in leaves.items():
            assert torch.equal(got[block][name], w), (block, name)


def test_card_resize_matches_the_cpu(cuda):
    """The featurizer's batched resize + round + scale on the card against
    the CPU's on the same uint8 images: within one uint8 level on at most
    0.5% of the values (the same filter summed in another order);
    upsampling by an integer factor and equal sizes the same."""
    from mmlspark_tpu_torch.stages.image import resize_scale

    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, 256, 256, 3), dtype=np.uint8))
    for size in (224, 97, 512, 256):
        got = resize_scale(imgs.cuda(), size, size, 1.0).cpu()
        want = resize_scale(imgs, size, size, 1.0)
        diff = (got - want).abs()
        assert diff.max().item() <= 1.0
        assert (diff > 0).float().mean().item() <= 5e-3
        if size in (512, 256):
            assert torch.equal(got, want)


def test_resnet50_featurizer_on_card_matches_cpu_f32(cuda):
    """ImageFeaturizer over ResNet-50 (input 64) on the card, uint8 images
    resized there, against the CPU's float32 forward on the card's
    resized input: the ``pool`` features within 1e-2 of their largest
    (bf16 convolutions on the card); one captured program."""
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.models.bridge import variables_to
    from mmlspark_tpu_torch.stages import ImageFeaturizer, TPUModel
    from mmlspark_tpu_torch.stages.image import resize_scale

    cfg = {"input_size": 64}
    weights = init_variables(build_model("resnet50", **cfg), 0,
                             device="cuda")
    imgs = np.random.default_rng(1).integers(0, 256, (10, 80, 80, 3),
                                             dtype=np.uint8)
    model = TPUModel(model_name="resnet50", model_config=cfg,
                     input_col="image", batch_size=4).set(weights=weights)
    feat = ImageFeaturizer(model=model, cut_output_layers=1, batch_size=4,
                           scale=1 / 255)
    got = feat.transform(Dataset({"image": imgs}))["features"]
    assert got.shape == (10, 2048) and feat._scorer.program_count == 1
    x = resize_scale(torch.from_numpy(imgs).cuda(), 64, 64, 1 / 255).cpu()
    cpu = _f32_port(build_model("resnet50", **cfg))
    want = cpu.apply(variables_to(weights, "cpu"), x,
                     output_node="pool").numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-2, err


# -- the replica planes on the card -------------------------------------------


def _decode_counts():
    return {name: getattr(fa, name) for name in
            ("launches", "q8_launches", "paged_launches",
             "paged_q8_launches")}


def _count_per_engine(engines):
    """Wrap each engine's ``step`` to add the decode launch counters'
    delta over the step to that engine's tally (the replicas step one at
    a time, so each delta is that engine's alone)."""
    tallies = []
    for engine in engines:
        tally = dict.fromkeys(_decode_counts(), 0)
        inner = engine.step

        def step(inner=inner, tally=tally):
            before = _decode_counts()
            try:
                return inner()
            finally:
                for k, v in _decode_counts().items():
                    tally[k] += v - before[k]

        engine.step = step
        tallies.append(tally)
    return tallies


def _fleet_prompts(seed: int):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 64, size=24)
    return ([np.concatenate([head, rng.integers(0, 64, size=n)])
             for n in (3, 9, 14)]
            + [rng.integers(0, 64, size=n) for n in (4, 17, 30, 2, 11)])


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_dtype="int8"),
    dict(paged=True, page_size=16, prefix_cache=True),
], ids=["dense", "dense_int8", "paged_prefix"])
def test_replica_and_fleet_streams_equal_the_single_engine(cuda, kw):
    """A ReplicaSet of 2 and a DisaggFleet of 1 prefill + 2 decode
    replicas over the same pool and KV dtype give every stream of a
    single engine, bit for bit, on the card; the prefill replica
    launches no decode kernel and the decode replicas make no prefill
    program."""
    from mmlspark_tpu_torch.serve import DisaggFleet, ReplicaSet, ServeEngine

    graph, variables = _small_lm()
    prompts = _fleet_prompts(7)
    common = dict(slots=3, cache_len=64, decode_block=8, max_queue=16,
                  retry_backoff_s=0.0, **kw)
    single = ServeEngine(graph, variables, **common)
    rids = [single.submit(p, 12) for p in prompts]
    want = single.run()
    counter = "q8_launches" if kw.get("kv_dtype") else (
        "paged_launches" if kw.get("paged") else "launches")
    rs = ReplicaSet(graph, variables, replicas=2, **common)
    fleet = DisaggFleet(graph, variables, prefill_replicas=1,
                        decode_replicas=2, **common)
    tallies = _count_per_engine([fleet.engine(i) for i in range(3)])
    for target in (rs, fleet):
        gids = [target.submit(p, 12) for p in prompts]
        got = target.run()
        for gid, rid in zip(gids, rids):
            np.testing.assert_array_equal(got[gid].tokens,
                                          want[rid].tokens)
    assert fleet.handoffs_total == len(prompts)
    assert fleet.metrics_dict()["handoff_fallbacks_total"] == 0
    assert sum(tallies[0].values()) == 0, tallies
    assert all(t[counter] > 0 for t in tallies[1:]), tallies
    assert fleet.engine(0).decode_compile_count == 0
    assert all(fleet.engine(i).prefill_compile_count == 0 for i in (1, 2))


def test_payload_held_across_a_second_prefill_adopts_correctly(cuda):
    """The prefill program's outputs are static: the next replay of the
    same bucket overwrites them. A payload taken only AFTER a second
    prefill of that bucket still adopts by direct write (no fallback)
    and continues to the single engine's stream — it holds a copy."""
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _small_lm()
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 64, size=12), rng.integers(0, 64, size=13)
    common = dict(slots=2, cache_len=64, decode_block=8,
                  retry_backoff_s=0.0)
    single = ServeEngine(graph, variables, **common)
    ra = single.submit(a, 10)
    want = single.run()[ra].tokens
    prefill = ServeEngine(graph, variables, role="prefill", **common)
    for p in (a, b, a):  # three replays of the 16-token bucket's program
        prefill.submit(p, 10)
        prefill.step()
    payloads = prefill.take_handoffs()
    assert prefill.prefill_compile_count == 1 and len(payloads) == 3
    decode = ServeEngine(graph, variables, role="decode", **common)
    rid = decode.adopt_handoff(payloads[0])
    got = decode.run()[rid].tokens
    assert decode.metrics.handoffs_adopted_total == 1
    assert decode.metrics.handoff_fallbacks_total == 0
    assert decode.prefill_compile_count == 0
    np.testing.assert_array_equal(got, want)


def test_failovers_leave_no_graph_pool_behind(cuda):
    """Three kills and rebuilds: the dead engines' captured programs,
    graph pools and KV pools are released, so the device memory a
    replica set holds after its run is within 25% of a set that never
    failed over (one leaked engine of this model would add ~50%)."""
    import gc

    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.serve import ReplicaSet

    graph, variables = _wide_lm()
    prompts = [np.random.default_rng(s).integers(0, 512, size=40)
               for s in range(6)]

    def held(faults):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        rs = ReplicaSet(graph, variables, replicas=2, slots=4,
                        cache_len=256, decode_block=8, max_queue=8,
                        snapshot_every_ticks=2, faults=faults,
                        retry_backoff_s=0.0)
        for p in prompts:
            rs.submit(p, 40)
        rs.run()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out = torch.cuda.memory_allocated() - base, \
            rs.replica_failovers_total
        del rs
        return out

    clean, n0 = held(None)
    kills = FaultInjector([Fault("serve.decode", "kill", tick=t, replica=0)
                           for t in (1, 3, 5)])
    failed, n3 = held(kills)
    assert (n0, n3) == (0, 3)
    assert failed <= 1.25 * clean, (failed, clean)


# -- multi-model serving and imported graphs -------------------------------------


def _mlp_on(cuda, outputs=3, width=8, seed=4):
    from mmlspark_tpu_torch.models import build_model, init_variables

    graph = build_model("mlp", num_outputs=outputs, hidden=(32,))
    graph.size_input((width,))
    return graph, init_variables(graph, seed, device=cuda)


def test_batch_result_survives_two_later_replays(cuda):
    """A batch dispatch copies its output to the host before the next
    replay of the same bucket's program overwrites the program's output
    buffer: a result held across two later dispatches keeps its values
    (bit-equal to the direct apply of its batch), and the three batches'
    results all differ."""
    from mmlspark_tpu_torch.serve import BatchDeployment

    graph, variables = _mlp_on(cuda)
    dep = BatchDeployment(graph, variables, max_batch=4, device=cuda)
    rng = np.random.default_rng(5)
    batches = [rng.normal(size=(4, 8)).astype(np.float32) for _ in range(3)]
    held = []
    for xs in batches:
        for x in xs:
            dep.submit(x)
        held.append(np.stack([r.output for r in dep.step()]))
    assert dep.batch_compile_count == 1  # one program, replayed twice
    for xs, got in zip(batches, held):
        want = graph.apply(variables, torch.from_numpy(xs).to(cuda))
        np.testing.assert_array_equal(got, want.cpu().numpy())
    assert not np.array_equal(held[0], held[1])


def _conv_proto(rng):
    """An NCHW ONNX graph written with the port's exporter helpers:
    Conv (asymmetric pads, stride 2) -> BatchNormalization -> Relu ->
    grouped Conv -> MaxPool (asymmetric pads) -> GlobalAveragePool ->
    Flatten -> Gemm."""
    from mmlspark_tpu_torch.models import onnx_export as ox

    def f32(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    inits = {"w1": f32(8, 3, 3, 3), "b1": f32(8), "scale": 1 + f32(8),
             "bias": f32(8), "mean": f32(8, scale=0.1),
             "var": 1 + np.abs(f32(8)), "w2": f32(8, 2, 3, 3),
             "fc": f32(8, 10), "fcb": f32(10)}
    nodes = [
        ox.node("Conv", ["x", "w1", "b1"], ["c1"], name="conv1",
                attrs=[ox.attr_ints("pads", [0, 1, 2, 1]),
                       ox.attr_ints("strides", [2, 2])]),
        ox.node("BatchNormalization", ["c1", "scale", "bias", "mean",
                                       "var"], ["bn"], name="bn"),
        ox.node("Relu", ["bn"], ["r"], name="relu"),
        ox.node("Conv", ["r", "w2"], ["c2"], name="conv2",
                attrs=[ox.attr_ints("pads", [1, 1, 1, 1]),
                       ox.attr_i("group", 4)]),
        ox.node("MaxPool", ["c2"], ["p"], name="pool",
                attrs=[ox.attr_ints("kernel_shape", [3, 3]),
                       ox.attr_ints("strides", [2, 2]),
                       ox.attr_ints("pads", [1, 0, 0, 1])]),
        ox.node("GlobalAveragePool", ["p"], ["g"], name="gap"),
        ox.node("Flatten", ["g"], ["f"], name="flat"),
        ox.node("Gemm", ["f", "fc", "fcb"], ["z"], name="z"),
    ]
    return ox.model_proto(
        nodes, [ox.tensor_proto(k, v) for k, v in inits.items()],
        [ox.value_info("x", (4, 3, 32, 32))], [ox.value_info("z", (4, 10))])


def test_imported_conv_graph_on_card_matches_cpu(cuda):
    """An imported NCHW conv graph on the card (TF32 off) against the
    CPU: within 1e-4; as a batch deployment, its captured replay equals
    its first (eager) call's bucket-size output bit for bit."""
    from mmlspark_tpu_torch.models.onnx_import import load_onnx
    from mmlspark_tpu_torch.serve import BatchDeployment

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    graph = load_onnx(_conv_proto(rng))
    x = torch.from_numpy(rng.normal(size=(4, 3, 32, 32)).astype(np.float32))
    want = graph.apply(graph.init(device="cpu"), x)
    variables = graph.init(device=cuda)
    got = graph.apply(variables, x.to(cuda)).cpu()
    assert got.shape == (4, 10)
    assert (got - want).abs().max().item() <= 1e-4
    dep = BatchDeployment(graph, variables, max_batch=4, device=cuda)
    outs = []
    for _ in range(2):
        for row in x.numpy():
            dep.submit(row)
        outs.append(np.stack([r.output for r in dep.step()]))
    assert dep.batch_compile_count == 1 and dep.capture_seconds > 0
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], got.numpy())


def test_lm_deployment_streams_equal_the_dedicated_engine(cuda):
    """The facade's LM deployment (with a batch deployment beside it and
    every deployment stepped each tick) emits the dedicated engine's
    streams bit for bit, through its captured programs."""
    from mmlspark_tpu_torch.serve import MultiModelEngine, ServeEngine

    graph, variables = _wide_lm()
    clf, clf_vars = _mlp_on(cuda)
    prompts = [np.random.default_rng(s).integers(0, 512, size=20 + 7 * s)
               for s in range(6)]
    kw = dict(slots=4, cache_len=256, decode_block=8, max_queue=8)
    solo = ServeEngine(graph, variables, **kw)
    ids = [solo.submit(p, 24) for p in prompts]
    want = solo.run()
    eng = MultiModelEngine(device=cuda)
    lm = eng.add_lm("lm", graph, variables, **kw)
    eng.add_batch("clf", clf, clf_vars, max_batch=4)
    for x in np.random.default_rng(1).normal(size=(8, 8)).astype(np.float32):
        eng.submit(x, model="clf")
    gids = [eng.submit(p, model="lm", max_new_tokens=24) for p in prompts]
    got = eng.run()
    assert lm.capture_seconds > 0 and lm.graph_pool_bytes() > 0
    for g, rid in zip(gids, ids):
        np.testing.assert_array_equal(got[g].tokens, want[rid].tokens)


def test_multimodel_close_returns_the_graph_pools(cuda):
    """``MultiModelEngine.close`` releases every deployment's captured
    programs: each graph pool holds bytes before and none after (its
    segments returned to the card), and the engine holds no more device
    memory than before."""
    import gc

    from mmlspark_tpu_torch.serve import MultiModelEngine

    graph, variables = _wide_lm()
    clf, clf_vars = _mlp_on(cuda)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    eng = MultiModelEngine(device=cuda)
    eng.add_lm("lm", graph, variables, slots=4, cache_len=256,
               decode_block=8, max_queue=8)
    eng.add_batch("clf", clf, clf_vars, max_batch=4)
    for s in range(4):
        eng.submit(np.random.default_rng(s).integers(0, 512, size=30),
                   model="lm", max_new_tokens=16)
        eng.submit(np.zeros(8, np.float32), model="clf")
    eng.run()
    pools = {n: eng.deployment(n).graph_pool_bytes() for n in eng.models}
    assert all(pools.values()), pools
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng.close()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = {n: eng.deployment(n).graph_pool_bytes() for n in eng.models}
    assert not any(after.values()), after
    assert torch.cuda.memory_allocated() <= before


def _tree_data(n=3000, d=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = ((x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * rng.normal(size=n))
         > 0).astype(np.int64)
    return x, y


@pytest.mark.parametrize("name,kw", [
    ("RandomForestClassifier", {"num_trees": 8}),
    ("GBTClassifier", {"max_iter": 6}),
    ("GBTRegressor", {"max_iter": 6}),
])
def test_tree_fit_on_card_is_deterministic_and_equals_the_cpu(cuda, name,
                                                              kw):
    """A fit on the card repeats bit for bit under its seed (the level
    histogram's deterministic segment sums), one host fetch a fit, and
    equals the CPU fit: gini forests exactly, boosted trees' structures
    equal or parting only at a near tie, scores within 1e-4."""
    from mmlspark_tpu_torch.data.dataset import Dataset
    from mmlspark_tpu_torch.stages import trees
    from mmlspark_tpu_torch.testing.tree_parity import gbt_divergence

    x, y = _tree_data()
    if name == "GBTRegressor":
        y = x[:, 0] * 2 + np.sin(x[:, 3])
    ds = Dataset({"features": x, "label": y})
    est = getattr(trees, name)
    before = trees.fetches
    a = est(seed=1, **kw).fit(ds)
    b = est(seed=1, **kw).fit(ds)
    assert trees.fetches == before + 2
    for p in ("feats", "threshs", "values", "feature_importances"):
        np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    cpu = est(seed=1, device="cpu", **kw).fit(ds)
    card_scores = np.asarray(a.transform(ds)["scores"])
    a.set(device="cpu")
    np.testing.assert_allclose(np.asarray(a.transform(ds)["scores"]),
                               card_scores, atol=1e-6, rtol=0)
    if name == "RandomForestClassifier":
        np.testing.assert_array_equal(a.feats, cpu.feats)
        np.testing.assert_array_equal(a.threshs, cpu.threshs)
        np.testing.assert_allclose(a.values, cpu.values, atol=1e-6, rtol=0)
        return
    div = gbt_divergence(cpu, a, x, y)
    assert all(s["near_tie"] for s in div["splits"]), div
    if div["first_diverged_tree"] is None:
        np.testing.assert_allclose(card_scores,
                                   np.asarray(cpu.transform(ds)["scores"]),
                                   atol=1e-4, rtol=0)


# -- sequence parallelism, the launcher and the entry point -------------------


CP_LM = dict(vocab_size=512, d_model=256, heads=4, depth=2, max_len=256)


@pytest.fixture(scope="module")
def seq_mesh(cuda):
    """A one-rank NCCL group on the card and its ``seq`` mesh: the card
    machine has one GPU, and NCCL puts one rank on a GPU."""
    import socket

    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import initialize_distributed, make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        yield make_mesh({"seq": 1})
    finally:
        dist.destroy_process_group()


def _lm_grads(impl, mesh, variables, ids):
    import torch.nn.functional as F

    from mmlspark_tpu_torch.models import build_model

    graph = build_model("transformer_lm", attn_impl=impl, mesh=mesh, **CP_LM)
    leaves = {n: {k: t.detach().clone().requires_grad_()
                  for k, t in b.items()} for n, b in variables.items()}
    logits, _ = graph.apply(leaves, ids, train=True)
    F.cross_entropy(logits[:, :-1].float().reshape(-1, logits.shape[-1]),
                    ids[:, 1:].reshape(-1)).backward()
    return logits.detach(), {f"{n}.{k}": t.grad for n, b in leaves.items()
                             for k, t in b.items()}


def _cp_inputs(cuda):
    from mmlspark_tpu_torch.models import build_model, init_variables

    variables = init_variables(build_model("transformer_lm", **CP_LM), 0,
                               device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    ids = torch.randint(0, CP_LM["vocab_size"], (2, 256), generator=gen,
                        device=cuda)
    return variables, ids


def test_ulysses_at_one_rank_is_bit_equal_to_flash(cuda, seq_mesh):
    """Ulysses over a one-rank NCCL mesh: the all-to-alls are identities,
    so logits and every gradient equal the flash path's bit for bit, and
    the local attention is the hand-written forward and backward pair
    (head dim 64, bf16: the tensor-core kernels), once a layer each."""
    variables, ids = _cp_inputs(cuda)
    want_logits, want = _lm_grads("flash", None, variables, ids)
    counters = ("fwd_mma_launches", "bwd_kv_mma_launches",
                "bwd_q_mma_launches")
    torch.cuda.synchronize()
    for name in counters:
        setattr(fa, name, 0)
    logits, grads = _lm_grads("ulysses", seq_mesh, variables, ids)
    torch.cuda.synchronize()
    assert [getattr(fa, name) for name in counters] == [CP_LM["depth"]] * 3
    assert torch.equal(logits, want_logits)
    for key in want:
        assert torch.equal(grads[key], want[key]), key


def test_ring_at_one_rank_is_within_bf16_of_flash(cuda, seq_mesh):
    variables, ids = _cp_inputs(cuda)
    want_logits, want = _lm_grads("flash", None, variables, ids)
    logits, grads = _lm_grads("ring", seq_mesh, variables, ids)
    assert (logits - want_logits).abs().max().item() <= 6.25e-2
    for key in want:
        scale = want[key].abs().max().item() + 1e-12
        assert (grads[key] - want[key]).abs().max().item() <= 2e-2 * scale, \
            key


def _mesh_lm_run(cuda, graph, weights, x, y, **cfg):
    """Four adam steps through SPMDTrainer: the curve, the variables, the
    step programs and the attention kernels' mma launches."""
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    trainer = SPMDTrainer(graph, TrainConfig(
        epochs=1, batch_size=2, learning_rate=1e-3, log_every=1,
        shuffle=False, **cfg), device=cuda)
    counters = ("fwd_mma_launches", "bwd_kv_mma_launches",
                "bwd_q_mma_launches")
    torch.cuda.synchronize()
    for name in counters:
        setattr(fa, name, 0)
    out = trainer.train(x, y, init_variables=weights)
    torch.cuda.synchronize()
    return ([h["loss"] for h in trainer.history], out,
            trainer.telemetry.counter("retrace.train.step").value,
            [getattr(fa, name) for name in counters])


def test_mesh_step_at_one_rank_is_bit_equal_to_plain(cuda, seq_mesh):
    """The trainer's mesh mode over a one-rank NCCL group under
    TRANSFORMER_TP_RULES runs the split step (the rank's Megatron-split
    copy on its shards, the vocab-parallel loss): every collective is an
    identity, the split leaves are the whole ones and the loss's part
    beyond ``log_softmax`` is exactly 0, so the curve and the final
    parameters equal the plain trainer's bit for bit; the step is one
    captured program with its collectives inside, and the flash kernels
    run on the tensor cores once a layer a step."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import TRANSFORMER_TP_RULES

    graph = build_model("transformer_lm", attn_impl="flash", **CP_LM)
    weights = init_variables(graph, 3, device=cuda)
    x = np.random.default_rng(3).integers(
        0, CP_LM["vocab_size"], size=(8, 256)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    plain = _mesh_lm_run(cuda, graph, weights, x, y)
    meshed = _mesh_lm_run(cuda, graph, weights, x, y,
                          mesh_axes={"data": 1, "model": 1},
                          param_rules=TRANSFORMER_TP_RULES)
    assert meshed[0] == plain[0]
    for b in plain[1]:
        for k in plain[1][b]:
            assert torch.equal(meshed[1][b][k], plain[1][b][k]), (b, k)
    assert meshed[2] == 1
    assert meshed[3] == [CP_LM["depth"] * 4] * 3


def test_expert_local_step_at_one_rank_is_bit_equal_to_plain(cuda,
                                                            seq_mesh):
    """The MoE LM under EXPERT_RULES on a one-rank ``expert`` axis runs
    the expert-local FFN (the rank's experts on its slice of the
    dispatch, the combine summed over ``expert``): at one rank the slice
    is the whole buffer and the sum an identity, so the curve and the
    final parameters equal the plain trainer's bit for bit, in one
    captured step."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import EXPERT_RULES

    graph = build_model("transformer_lm_moe", attn_impl="flash",
                        n_experts=4, **CP_LM)
    weights = init_variables(graph, 4, device=cuda)
    x = np.random.default_rng(4).integers(
        0, CP_LM["vocab_size"], size=(8, 256)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    plain = _mesh_lm_run(cuda, graph, weights, x, y)
    meshed = _mesh_lm_run(cuda, graph, weights, x, y,
                          mesh_axes={"data": 1, "expert": 1},
                          param_rules=EXPERT_RULES)
    assert meshed[0] == plain[0]
    for b in plain[1]:
        for k in plain[1][b]:
            assert torch.equal(meshed[1][b][k], plain[1][b][k]), (b, k)
    assert meshed[2] == 1
    assert meshed[3] == [CP_LM["depth"] * 4] * 3


def test_pipelined_lm_on_the_card(cuda, seq_mesh):
    """The pipelined LM over a one-rank pipe axis: its forward within
    bf16 of its own stage loop (a plain transformer_lm on the stages'
    layers), and four steps under PIPELINE_STAGE_RULES on one repeated
    batch lower its loss (random tokens of a new batch a step need not
    fall in four steps)."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import PIPELINE_STAGE_RULES, make_mesh

    config = dict(CP_LM, max_len=64)
    mesh = make_mesh({"data": 1, "pipe": 1})
    graph = build_model("transformer_lm_pipelined", mesh=mesh,
                        n_microbatches=2, **config)
    weights = init_variables(graph, 4, device=cuda)
    x = np.tile(np.random.default_rng(4).integers(
        0, config["vocab_size"], size=(2, 64)), (4, 1)).astype(np.int32)
    got = graph.apply(weights, torch.from_numpy(x[:4]).to(cuda))
    loop_vars = {"embed": weights["embed"], "z": weights["z"]}
    for i in range(config["depth"]):
        loop_vars[f"block{i}"] = {
            k[len(f"layer{i}."):]: t[0] for k, t in weights["stages"].items()
            if k.startswith(f"layer{i}.")}
    loop = build_model("transformer_lm", attn_impl="dense", **config)
    want = loop.apply(loop_vars, torch.from_numpy(x[:4]).to(cuda))
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-2 * scale
    losses, _, programs, _ = _mesh_lm_run(
        cuda, graph, weights, x, np.roll(x, -1, axis=1),
        mesh_axes={"data": 1, "pipe": 1}, param_rules=PIPELINE_STAGE_RULES)
    assert programs == 1 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_seq_parallel_tagger_on_the_card(cuda, seq_mesh):
    """The sequence-parallel BiLSTM over a one-rank seq axis (cuDNN's
    LSTM, one direction a call) against the dense tagger (one
    bidirectional call), and three mixed-axis SGD steps lowering the
    loss."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import (
        bilstm_seq_parallel_apply,
        bilstm_seq_parallel_train_step,
        make_mesh,
    )

    mesh = make_mesh({"data": 1, "seq": 1})
    graph = build_model("bilstm_tagger", vocab_size=500, embed_dim=32,
                        hidden=32, num_tags=5)
    v = init_variables(graph, 5, device=cuda)
    ids = np.random.default_rng(5).integers(0, 500, size=(16, 24)).astype(
        np.int32)
    par = bilstm_seq_parallel_apply(graph, v, ids, mesh)
    dense = graph.apply(v, torch.from_numpy(ids).to(cuda))
    assert (par - dense).abs().max().item() <= \
        2 * 2.0 ** -7 * dense.abs().max().item()
    losses = []
    for _ in range(3):
        loss, v = bilstm_seq_parallel_train_step(
            graph, v, ids, (ids % 5).astype(np.int32), mesh,
            learning_rate=0.5)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_dtype="int8"),
    dict(paged=True, page_size=16, prefix_cache=True),
    dict(paged=True, page_size=16, prefix_cache=True, kv_dtype="int8"),
    dict(prefill_chunk=16, async_host=True),
], ids=["dense", "dense_int8", "paged_prefix", "paged_prefix_int8",
        "chunked_async"])
def test_mesh_engine_at_one_rank_is_bit_equal_to_plain(cuda, seq_mesh, kw):
    """The engine's mesh mode over a one-rank (data, model) mesh of the
    NCCL group: every stream bit-equal to the plain engine's (at one rank
    every collective is an identity and the split is the whole), the
    decode kernel of its pool launched through it, and its programs
    captured with their collectives inside."""
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _small_lm()
    prompts = _fleet_prompts(9)
    common = dict(slots=4, cache_len=64, decode_block=8, max_queue=16, **kw)
    counter = ("paged_" if kw.get("paged") else "") + (
        "q8_launches" if kw.get("kv_dtype") else "launches")
    out = []
    for mesh in (None, {"data": 1, "model": 1}):
        engine = ServeEngine(graph, variables, mesh=mesh, **common)
        rids = [engine.submit(p, 12) for p in prompts]
        before = getattr(fa, counter)
        res = engine.run()
        out.append([res[r].tokens for r in rids])
        assert getattr(fa, counter) > before
    for want, got in zip(*out):
        np.testing.assert_array_equal(got, want)
    assert engine.mesh is not None and engine.capture_seconds > 0
    assert engine.decode_compile_count <= engine.num_decode_blocks


def test_cli_env_names_the_card(cuda):
    import json

    out = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch", "env"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout)
    assert info["platform"] == "gpu"
    assert info["device_kind"] == torch.cuda.get_device_name(0)
    assert info["num_local_devices"] == torch.cuda.device_count()


def test_entry_forward_on_the_card(cuda):
    from mmlspark_tpu_torch.entry import entry
    from mmlspark_tpu_torch.models.bridge import variables_to

    forward, (variables, x) = entry()
    assert x.is_cuda and tuple(x.shape) == (128, 32, 32, 3)
    x = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    got = forward(variables, x.cuda()).float().cpu()
    want = forward(variables_to(variables, "cpu"), x)
    assert got.shape == (128, 10) and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()
