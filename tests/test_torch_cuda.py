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
