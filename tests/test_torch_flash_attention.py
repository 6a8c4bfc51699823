"""The port's cache-free attention (``mmlspark_tpu_torch.ops.
flash_attention.flash_attention``) against the JAX package's Pallas
kernels, run in interpret mode on the CPU, on the same numpy inputs.

On the CPU the port's autograd Function runs the plain versions
(``flash_attention_reference``, ``flash_attention_backward_reference``),
so these tests hold its wiring — the saved LSE, the D = rowsum(dO ⊙ O)
precompute, the GQA group sum — and its numerics to the JAX kernels.

Tolerances: float32 1e-5 (the same f32 arithmetic summed in other
orders); bfloat16 1e-2 on outputs and gradients (both sides round P and
dS to bf16 at the same places; the JAX forward rounds P against a
running max, block by block, the plain version against the row's max,
so a value may land one bf16 ulp apart); the LSE, f32 on both sides,
1e-5 in both dtypes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.ops.flash_attention import _flash_backward as jax_backward
from mmlspark_tpu.ops.flash_attention import _flash_forward as jax_forward
from mmlspark_tpu_torch.models import build_model, init_variables
from mmlspark_tpu_torch.models.transformer import resolve_attn_impl
from mmlspark_tpu_torch.ops import flash_attention as fa

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LSE_TOL = 1e-5
#: (b, s, h, hk, d, causal, window, block) — the JAX tests' sizes; S=20
#: is not a multiple of the block, so the last tile is padded
CASES = {
    "causal_gqa_hkv2": (2, 32, 4, 2, 16, True, None, 8),
    "noncausal_padded_s20": (2, 20, 2, 2, 8, False, None, 8),
    "window5_mqa_hkv1_padded": (2, 20, 4, 1, 8, True, 5, 8),
    "causal_s1": (2, 1, 2, 1, 8, True, None, 8),
}


def _inputs(case: str, dtype: str):
    b, s, h, hk, d = CASES[case][:5]
    rng = np.random.default_rng(sorted(CASES).index(case))
    shapes = ((b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d))
    return [rng.normal(size=shape).astype(np.float32) for shape in shapes]


def _to_jax(arrays, dtype):
    return [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrays]


def _to_port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_kernels(case, dtype):
    """Forward (out, LSE) and gradients (dq, dk, dv) of the port against
    the Pallas forward and backward; and the plain backward alone on the
    JAX forward's own (out, lse) and the same cotangent."""
    b, s, h, hk, d, causal, window, block = CASES[case]
    q, k, v, g = _inputs(case, dtype)
    scale = d ** -0.5
    jq, jk, jv, jg = _to_jax((q, k, v, g), dtype)
    j_out, j_lse = jax_forward(jq, jk, jv, causal=causal, window=window,
                               scale=scale, block=block, interpret=True)
    j_grads = jax_backward(jq, jk, jv, j_out, j_lse, jg, causal=causal,
                           window=window, scale=scale, block=block,
                           interpret=True)
    # JAX keeps the LSE lanes-replicated and padded: (b*h, s_pad, 128)
    j_lse = np.asarray(j_lse)[:, :s, 0]

    tq, tk, tv, tg = (t.requires_grad_(True) if i < 3 else t
                      for i, t in enumerate(_to_port((q, k, v, g), dtype)))
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window,
                             block=block)
    assert out.dtype == tq.dtype
    _close(out.detach(), j_out, TOL[dtype])
    _, lse = fa.flash_attention_reference(tq.detach(), tk.detach(),
                                          tv.detach(), causal=causal,
                                          window=window)
    assert lse.shape == (b * h, s) and lse.dtype == torch.float32
    _close(lse, j_lse, LSE_TOL)
    out.backward(tg)
    for got, want, t in zip((tq.grad, tk.grad, tv.grad), j_grads,
                            (tq, tk, tv)):
        assert got.dtype == t.dtype and got.shape == t.shape
        _close(got, want, TOL[dtype])

    # the plain backward on the JAX forward's residuals, bit for bit the
    # same inputs
    ref = fa.flash_attention_backward_reference(
        *_to_port((q, k, v), dtype),
        torch.from_numpy(np.array(jnp.asarray(j_out, jnp.float32))).to(
            getattr(torch, dtype)),
        torch.from_numpy(j_lse.copy()), tg, causal=causal, window=window,
        scale=scale)
    for got, want in zip(ref, j_grads):
        _close(got, want, TOL[dtype])


def test_no_grad_forward_skips_the_lse(monkeypatch):
    """Without an input that requires grad the forward asks for no LSE
    and no autograd node; with one it saves it for the backward."""
    q, k, v, _ = _to_port(_inputs("causal_gqa_hkv2", "float32"), "float32")
    asked = []
    inner = fa.flash_attention_forward

    def spy(*args, with_lse=True, **kw):
        asked.append(with_lse)
        return inner(*args, with_lse=with_lse, **kw)

    monkeypatch.setattr(fa, "flash_attention_forward", spy)
    out = fa.flash_attention(q, k, v, causal=True)
    assert asked == [False] and out.grad_fn is None
    out2 = fa.flash_attention(q, k.requires_grad_(True), v, causal=True)
    assert asked == [False, True] and out2.grad_fn is not None
    torch.testing.assert_close(out, out2.detach(), rtol=0, atol=0)
    with torch.no_grad():
        fa.flash_attention(q, k, v, causal=True)
    assert asked[-1] is False


def test_gradients_equal_the_dense_oracle():
    """Through autograd, flash's gradients are the dense attention's, in
    f32 (the plain versions and the dense oracle differ only in where
    they round, which f32 makes moot)."""
    from mmlspark_tpu_torch.ops.attention import dense_attention

    q, k, v, g = _to_port(_inputs("window5_mqa_hkv1_padded", "float32"),
                          "float32")
    grads = []
    for fn in (fa.flash_attention, dense_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, causal=True, window=5).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_validation_errors():
    q = torch.zeros(1, 8, 4, 8)
    k = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="dividing q heads"):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 3, 8))
    with pytest.raises(ValueError, match="dividing q heads"):
        fa.flash_attention(q, k, torch.zeros(1, 8, 1, 8))
    with pytest.raises(ValueError, match="pass causal=True"):
        fa.flash_attention(q, k, k, window=4)
    with pytest.raises(ValueError, match="window must be >= 1"):
        fa.flash_attention(q, k, k, causal=True, window=0)
    # a tensor on neither the card nor the CPU reaches no plain version
    with pytest.raises(ValueError, match="runs on cuda"):
        fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def test_cpu_launches_no_kernel():
    q, k, v, g = _to_port(_inputs("causal_gqa_hkv2", "float32"), "float32")
    names = ("fwd_launches", "fwd_mma_launches", "bwd_kv_launches",
             "bwd_q_launches", "bwd_kv_mma_launches", "bwd_q_mma_launches")
    counts = [getattr(fa, name) for name in names]
    q.requires_grad_(True)
    fa.flash_attention(q, k, v, causal=True).backward(g)
    assert [getattr(fa, name) for name in names] == counts


def test_auto_resolves_to_dense_without_a_gpu():
    assert not torch.cuda.is_available()
    assert resolve_attn_impl("auto") == "dense"
    assert resolve_attn_impl("flash") == "flash"
    assert resolve_attn_impl("dense") == "dense"


@pytest.mark.parametrize("variant", [
    dict(),
    dict(kv_heads=2, window=5, pos_embedding="rope"),
], ids=["mha_learned", "gqa_window_rope"])
def test_transformer_flash_equals_dense(variant):
    """The tiny LM with attn_impl="flash" against the same model with
    "dense", on the same weights, in float32: logits and every
    parameter's gradient."""
    tiny = dict(vocab_size=32, d_model=16, heads=4, depth=2, max_len=16,
                **variant)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, 32, size=(2, 12)).astype(np.int32))
    results = []
    for impl in ("flash", "dense"):
        graph = build_model("transformer_lm", attn_impl=impl, **tiny)
        for _, mod in graph.blocks:
            for m in mod.modules():
                if hasattr(m, "dtype"):
                    m.dtype = torch.float32
        variables = {b: {n: t.requires_grad_(True) for n, t in leaves.items()}
                     for b, leaves in init_variables(graph, 0,
                                                     device="cpu").items()}
        logits, _ = graph.apply(variables, ids, train=True)
        logits.square().mean().backward()
        results.append((logits.detach(), variables, graph))
    (lf, vf, flash_graph), (ld, vd, _) = results
    assert flash_graph.extra["attn_impl"] == "flash"
    torch.testing.assert_close(lf, ld, rtol=0, atol=1e-5)
    for b, leaves in vf.items():
        for n, t in leaves.items():
            torch.testing.assert_close(t.grad, vd[b][n].grad, rtol=0,
                                       atol=1e-5)
    # eval mode (no grad, no LSE) gives the train-mode logits
    torch.testing.assert_close(flash_graph.apply(vf, ids), lf, rtol=0,
                               atol=0)
