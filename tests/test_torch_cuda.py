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
    for dev in ("cpu", "cuda"):
        trainer = SPMDTrainer(graph, TrainConfig(
            batch_size=4, optimizer="sgd", learning_rate=0.1, log_every=1),
            device=dev)
        trainer.train(x, x, init_variables=init_variables(graph, 1,
                                                          device=dev))
        losses[dev] = [h["loss"] for h in trainer.history]
    assert len(losses["cuda"]) == 3
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4
