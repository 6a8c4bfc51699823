"""The port's CUDA kernels on the card (``mmlspark_tpu_torch/csrc``).

Every test here needs a CUDA GPU and ``nvcc``: it is marked ``gpu`` and
skips without a card. The tests' ``conftest.py`` imports JAX, which the
GPU machine does not have, so run this file there on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu -q

The kernel is held to ``flash_decode_reference``, its plain PyTorch
version, on the same CUDA tensors. Tolerances: 1e-5 in float32 (both
accumulate in f32; only the order of the sums differs) and 1e-2 in
bfloat16 (both round the output to bf16: one ulp at |out| < 2 is
2^-7).
"""

from __future__ import annotations

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
