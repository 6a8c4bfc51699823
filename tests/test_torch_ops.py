"""The port's attention ops against the JAX package's (ops/attention.py,
ops/rope.py, ops/flash_attention.py:flash_decode), on identical numpy
inputs, plus the CPU-side contract of the CUDA kernel's wrapper and
builder.

The JAX ``flash_decode`` runs its Pallas kernel in interpret mode here,
as ``tests/test_flash_decode.py`` runs it. Tolerances: float32 within
1e-5 (the same f32 arithmetic, summed in other orders); bfloat16 within
2e-2 (the outputs round to bf16 at the end: one ulp is 2^-7 at |x| in
[1, 2) and the two sides' f32 sums may straddle a rounding boundary).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.ops import attention as jattn
from mmlspark_tpu.ops.flash_attention import flash_decode as jax_flash_decode
from mmlspark_tpu.ops.rope import apply_rope as jax_apply_rope
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.ops import attention as tattn
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.ops import kernel_build
from mmlspark_tpu_torch.ops.rope import apply_rope


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32_TOL = 1e-5
BF16_TOL = 2e-2

DTYPES = {
    "float32": (jnp.float32, torch.float32, F32_TOL),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL),
}


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(x, dtype):
    """One numpy array as (jax, torch) arrays of ``dtype`` ('float32' or
    'bfloat16'); the bf16 rounding happens once, on the torch side, and
    jax gets the identical values."""
    jd, td, _ = DTYPES[dtype]
    t = torch.from_numpy(x).to(td)
    return jnp.asarray(t.float().numpy()).astype(jd), t


def _close(j, t, tol):
    np.testing.assert_allclose(
        np.asarray(j, np.float32), t.float().numpy(), atol=tol, rtol=tol,
    )


# -- (a) flash_decode_reference vs the JAX kernel ---------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # (B, L, H, Hkv, D, lengths, JAX block): ragged incl. 0 and > L
    (6, 32, 4, 4, 16, [0, 1, 5, 17, 31, 99], 128),
    # multi-block with a ragged tail: block 8 over L=30 (no divisor)
    (5, 30, 2, 2, 8, [0, 3, 11, 29, 30], 8),
    # grouped and multi-query attention
    (4, 16, 4, 2, 8, [1, 7, 12, 16], 8),
    (4, 16, 4, 1, 8, [0, 9, 16, 40], 8),
], ids=["ragged", "multi_block_tail", "gqa_hkv2", "mqa_hkv1"])
def test_flash_decode_reference_matches_jax_kernel(dtype, case):
    b, L, h, hk, d, lengths, block = case
    rng = np.random.default_rng(L + hk)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, *s), dtype)
        for s in ((b, 1, h, d), (b, L, hk, d), (b, L, hk, d))
    )
    want = jax_flash_decode(jq, jk, jv, jnp.asarray(lengths, jnp.int32),
                            block=block)
    got = fa.flash_decode(tq, tk, tv, torch.tensor(lengths,
                                                   dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(want, got, DTYPES[dtype][2])
    for row, n in enumerate(lengths):
        if n == 0:  # no live positions: exact zeros, like the kernel
            assert not got[row].any()


def test_flash_decode_reference_equals_dense_oracle():
    # a live length n is a query at position n - 1 under the causal mask
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_normal(rng, *s))
               for s in ((3, 1, 4, 8), (3, 12, 2, 8), (3, 12, 2, 8)))
    lengths = torch.tensor([0, 4, 12], dtype=torch.int32)
    got = fa.flash_decode_reference(q, k, v, lengths)
    want = tattn.dense_attention(q, k, v, causal=True, q_offset=lengths - 1)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_flash_decode_validation_matches_jax():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_normal(rng, 2, 1, 4, 8)).bfloat16()
    k = torch.from_numpy(_normal(rng, 2, 8, 2, 8)).bfloat16()
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_decode(q.float(), k, k, lengths)
    with pytest.raises(ValueError, match="SINGLE query"):
        fa.flash_decode(torch.cat([q, q], 1), k, k, lengths)
    with pytest.raises(ValueError, match="heads"):
        k3 = k[:, :, :1].repeat(1, 1, 3, 1)
        fa.flash_decode(q, k3, k3, lengths)
    with pytest.raises(ValueError, match="lengths"):
        fa.flash_decode(q, k, k, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="k and v"):
        fa.flash_decode(q, k, k.float(), lengths)


def test_flash_decode_routes_by_device():
    """A CPU tensor takes the plain version (no launch); a ``meta`` tensor
    (a cost analysis) launches nothing and counts the kernel's FLOPs and
    bytes; a tensor on any other non-CUDA device is refused rather than
    computed somewhere else."""
    q = torch.zeros(1, 1, 2, 8)
    k = torch.zeros(1, 4, 2, 8)
    before = fa.launches
    out = fa.flash_decode(q, k, k, torch.tensor([2], dtype=torch.int32))
    assert out.shape == q.shape and fa.launches == before
    meta = [t.to("meta") for t in (q, k)]
    with fa.meta_cost() as cost:
        out = fa.flash_decode(
            meta[0], meta[1], meta[1],
            torch.tensor([2], dtype=torch.int32, device="meta"))
    assert out.shape == q.shape and out.device.type == "meta"
    assert fa.launches == before
    # q.k and p.v over every one of the 4 positions, 2 heads of 8
    assert cost["flops"] == 4 * 1 * 4 * 2 * 8
    assert cost["bytes"] == 2 * 4 * 2 * 8 * 4 + 2 * 2 * 8 * 4 + 4
    with pytest.raises(ValueError, match="cuda"):
        fa._require_cuda(meta[0], "flash_decode")


# -- (b) the dense oracle, the masks and RoPE vs JAX ------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [
    dict(causal=False),
    dict(causal=True),
    dict(causal=True, window=3),
    dict(causal=True, q_offset=np.asarray([0, 4, 9])),
], ids=["full", "causal", "window", "per_row_offset"])
def test_dense_attention_matches_jax(dtype, kw):
    rng = np.random.default_rng(1)
    b, s = 3, (1 if "q_offset" in kw else 6)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, *shape), dtype)
        for shape in ((b, s, 4, 8), (b, 10, 2, 8), (b, 10, 2, 8))
    )
    jkw, tkw = dict(kw), dict(kw)
    if "q_offset" in kw:
        jkw["q_offset"] = jnp.asarray(kw["q_offset"])
        tkw["q_offset"] = torch.from_numpy(kw["q_offset"])
    _close(jattn.dense_attention(jq, jk, jv, **jkw),
           tattn.dense_attention(tq, tk, tv, **tkw), DTYPES[dtype][2])


def test_dense_attention_fully_masked_row_is_zero():
    # q_offset -1 masks every key: true -inf, and the row comes out 0
    rng = np.random.default_rng(2)
    q, k = (torch.from_numpy(_normal(rng, *s))
            for s in ((2, 1, 2, 4), (2, 5, 2, 4)))
    out = tattn.dense_attention(q, k, k, causal=True,
                                q_offset=torch.tensor([-1, 3]))
    assert not out[0].any() and out[1].abs().sum() > 0
    assert torch.isfinite(out).all()


def test_decode_live_lengths_matches_jax():
    for pos, live in ((4, None), (np.asarray([0, 2, 9]), None),
                      (np.asarray([3, 5, 7]), np.asarray([True, False,
                                                          True]))):
        want = jattn.decode_live_lengths(
            jnp.asarray(pos), 3,
            live=None if live is None else jnp.asarray(live),
        )
        got = tattn.decode_live_lengths(
            pos if isinstance(pos, int) else torch.from_numpy(pos), 3,
            live=None if live is None else torch.from_numpy(live),
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_causal_block_mask_matches_jax():
    for args, kw in (
        ((4, 6, 2, 0), {}),
        ((2, 12, np.asarray([0, 3, 7, 10]), 0), {"window": 5}),
    ):
        jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                      for a in args)
        targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray)
                      else a for a in args)
        np.testing.assert_array_equal(
            np.asarray(jattn.causal_block_mask(*jargs, **kw)),
            tattn.causal_block_mask(*targs, **kw).numpy(),
        )
    with pytest.raises(ValueError, match="scalar kv_offset"):
        tattn.causal_block_mask(1, 4, torch.tensor([0, 1]),
                                torch.tensor([0, 1]))


def test_mask_values_are_the_two_conventions():
    assert tattn.mask_value(kernel=False) == tattn.NEG_INF == float("-inf")
    assert tattn.mask_value(kernel=True) == tattn.KERNEL_NEG_INF == -1e30
    assert tattn.KERNEL_NEG_INF == jattn.KERNEL_NEG_INF


def test_streaming_softmax_matches_jax():
    """Two blocks through softmax_block_update + finalize_softmax, the
    second fully masked for one row, against the JAX pair."""
    rng = np.random.default_rng(4)
    b, q_len, h, d = 2, 3, 2, 8
    q = _normal(rng, b, q_len, h, d)
    blocks = [(_normal(rng, b, 4, h, d), _normal(rng, b, 4, h, d))
              for _ in range(2)]
    mask = np.zeros((q_len, 4), np.float32)
    mask[0] = -np.inf
    jc = (jnp.full((b, h, q_len), -jnp.inf), jnp.zeros((b, h, q_len)),
          jnp.zeros((b, q_len, h, d)))
    tc = (torch.full((b, h, q_len), float("-inf")),
          torch.zeros((b, h, q_len)), torch.zeros((b, q_len, h, d)))
    for i, (k, v) in enumerate(blocks):
        m = mask if i == 1 else None
        jc = jattn.softmax_block_update(
            jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
            None if m is None else jnp.asarray(m))
        tc = tattn.softmax_block_update(
            tc, torch.from_numpy(q), torch.from_numpy(k),
            torch.from_numpy(v), 0.3, None if m is None
            else torch.from_numpy(m))
    for j, t in zip(jc, tc):
        _close(j, t, F32_TOL)
    _close(jattn.finalize_softmax(jc[1], jc[2], jnp.float32),
           tattn.finalize_softmax(tc[1], tc[2], torch.float32), F32_TOL)


def test_rolled_window_attention_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, *s) for s in ((2, 1, 4, 8), (2, 6, 2, 8),
                                          (2, 6, 2, 8)))
    for pos in (3, 11):
        _close(
            jattn.rolled_window_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), pos),
            tattn.rolled_window_attention(torch.from_numpy(q),
                                          torch.from_numpy(k),
                                          torch.from_numpy(v), pos),
            F32_TOL,
        )


@pytest.mark.parametrize("positions", [
    None, np.asarray([5, 6, 7]), np.asarray([[0, 1, 2], [9, 10, 11]]),
], ids=["iota", "offset", "per_row"])
def test_apply_rope_matches_jax(positions):
    rng = np.random.default_rng(6)
    x = _normal(rng, 2, 3, 2, 8)
    want = jax_apply_rope(jnp.asarray(x), None if positions is None
                          else jnp.asarray(positions))
    got = apply_rope(torch.from_numpy(x), None if positions is None
                     else torch.from_numpy(positions))
    _close(want, got, F32_TOL)
    with pytest.raises(ValueError, match="even head_dim"):
        apply_rope(torch.zeros(1, 2, 1, 5))


# -- the kernel builder, as far as the CPU can see it -----------------------


def test_every_kernel_source_builds_for_sm90a():
    srcs = kernel_build.sources()
    assert {"flash_decode", "paged_flash_decode"} <= set(srcs)
    cmd = kernel_build.nvcc_command("nvcc", srcs["flash_decode"],
                                    kernel_build.BUILD_DIR / "x.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    # builds land in the checkout's build/ (listed in .gitignore), under
    # a name that changes with the source
    assert kernel_build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    lib = kernel_build.library_path(srcs["flash_decode"])
    assert lib.parent == kernel_build.BUILD_DIR
    assert lib.name.startswith("libflash_decode-") and lib.suffix == ".so"


def test_library_name_follows_the_source(tmp_path):
    a, b = tmp_path / "k.cu", tmp_path / "k2.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    assert (kernel_build.library_path(a).name.split("-")[1]
            != kernel_build.library_path(b).name.split("-")[1])
    # an edited header beside the source rebuilds it too
    before = kernel_build.library_path(a)
    (tmp_path / "shared.cuh").write_text("// header\n")
    assert kernel_build.library_path(a) != before


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernel_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(kernel_build, "Path", _NoDefaultNvcc)
    with pytest.raises(FriendlyError, match="nvcc not found"):
        kernel_build.find_nvcc()


class _NoDefaultNvcc(type(kernel_build.CSRC)):
    """A Path whose files never exist (no toolkit under any prefix)."""

    def is_file(self):
        return False


def test_kernel_source_declares_the_c_interface():
    srcs = kernel_build.sources()
    header = (kernel_build.CSRC / "decode_attention.cuh").read_text()
    # the launchers the wrappers bind with ctypes, the error text, and
    # the TPU kernels each source replaces
    for name, symbols, replaces in (
        ("flash_decode", ("mml_flash_decode", "mml_flash_decode_q8"),
         ("_decode_kernel", "_decode_kernel_q8")),
        ("paged_flash_decode", ("mml_paged_flash_decode",),
         ("_paged_decode_kernel", "_paged_decode_kernel_q8")),
    ):
        src = srcs[name].read_text()
        assert '#include "decode_attention.cuh"' in src
        for sym in symbols:
            assert f'extern "C" int {sym}(' in src
            assert sym in fa._SIGNATURES
        assert 'extern "C" const char* mml_cuda_error_string(' in src
        for kernel in replaces:
            assert f"mmlspark_tpu/ops/flash_attention.py:{kernel}" in src
    # every launch path returns the launch's own error
    assert "return (int)cudaGetLastError();" in header
    assert "__trap()" in header  # an out-of-range page id fails the launch
