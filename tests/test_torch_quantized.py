"""The port's int8 KV mode against the JAX package's (mirroring
``tests/test_quantized_serve.py``): ``quantize_kv``/``kv_head_scales``
bit-equal to JAX, the int8 plain versions of both decode reads against
the JAX int8 ``flash_decode``/``paged_flash_decode`` run in interpret
mode, the pools' scale lifecycle (a freed dense slot resets its scales,
copy-on-extend copies a page's scales, ``gather_prefix`` dequantizes),
the byte accounting, and the int8 engines' token streams against the JAX
int8 engines'.

Tolerances: the plain versions against the JAX kernels, on the same
int8 values and scales, 1e-5 for a float32 query and 1e-2 for a
bfloat16 one (both accumulate in f32; bf16 rounds the output). Streams
equal the JAX int8 engine's, or first differ at a near tie of the JAX
model (``tests/test_torch_serve.py``), and stay within ``FLIP_BUDGET``
of the port's bf16 streams — the JAX suite's budget: one int8 rounding
flip near an argmax tie cascades for the rest of a greedy stream.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.ops.flash_attention import flash_decode as jax_flash_decode
from mmlspark_tpu.ops.flash_attention import (
    paged_flash_decode as jax_paged_flash_decode,
)
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.serve.cache_pool import kv_head_scales as jax_kv_scales
from mmlspark_tpu.serve.cache_pool import quantize_kv as jax_quantize_kv
from mmlspark_tpu.serve.paging import PagedCachePool as JaxPagedCachePool
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.ops.quantize import kv_cache_bytes
from mmlspark_tpu_torch.serve import ServeEngine, run_demo
from mmlspark_tpu_torch.serve.cache_pool import (
    SlotCachePool,
    kv_head_scales,
    quantize_kv,
    validate_kv_dtype,
)
from mmlspark_tpu_torch.serve.paging import PagedCachePool


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF16_LOGIT_TOL = 6.25e-2
FLIP_BUDGET = 0.25
TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)
CACHE_LEN = 32


@pytest.fixture(scope="module")
def lm():
    """The JAX package's overfit periodic LM, bridged into the port:
    confident logits make the flip budget meaningful."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    tg = build_model("transformer_lm", **TINY)
    tv = load_flax_variables(tg, jv, device="cpu")
    return jg, jv, tg, tv, np.array(ids)


def _assert_streams_agree(jg, jv, want, got, prompt_len):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want, got)
    diff = np.nonzero(want != got)[0]
    if not diff.size:
        return
    i = int(diff[0])
    assert i >= prompt_len
    logits = np.asarray(jg.apply(jv, jnp.asarray(want[None, :i])))[0, -1]
    top2 = np.sort(logits.astype(np.float32))[-2:]
    assert float(top2[1] - top2[0]) < BF16_LOGIT_TOL, (i, want, got)


def _flip_rate(a_streams, b_streams) -> float:
    flips = total = 0
    for a, b in zip(a_streams, b_streams):
        n = min(len(a), len(b))
        flips += int(np.sum(np.asarray(a[:n]) != np.asarray(b[:n])))
        flips += abs(len(a) - len(b))
        total += max(len(a), len(b))
    return flips / max(total, 1)


def _fake_prefill(length, seed, hk=2, d=16):
    """A batch-1 linear cache for both packages: the same bf16 values."""
    rng = np.random.default_rng(seed)
    port, jax_cache = {}, {}
    for name in ("block0", "block1"):
        pair = [torch.from_numpy(
            rng.normal(size=(1, length, hk, d)).astype(np.float32)
        ).to(torch.bfloat16) for _ in range(2)]
        port[name] = tuple(pair)
        jax_cache[name] = tuple(
            jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
            for t in pair)
    return port, jax_cache


# -- the quantizer ---------------------------------------------------------------


def test_quantize_kv_and_scales_bit_equal_to_jax():
    """Random values, an all-zero head (scale 1.0), exact .5 ties (round
    half to even) and values past the scale's range (saturation): the
    same int8 bytes and f32 scales as JAX, from f32 and from bf16."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 3, 4, 8)) * 3).astype(np.float32)
    x[:, :, 1] = 0.0  # an all-zero kv head
    ties = np.arange(-6, 6, dtype=np.float32) + 0.5  # x.5 at scale 1
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        t = torch.from_numpy(x).to(dtype)
        j = jnp.asarray(t.float().numpy()).astype(jdtype)
        for axes in ((0, 1, 3), (0, 3)):
            s, js = kv_head_scales(t, axes=axes), jax_kv_scales(j, axes=axes)
            assert s.dtype == torch.float32
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        s, js = kv_head_scales(t, axes=(3,)), jax_kv_scales(j, axes=(3,))
        assert (s[:, :, 1] == 1.0).all()
        np.testing.assert_array_equal(
            quantize_kv(t, s).numpy(), np.asarray(jax_quantize_kv(j, js)))
        # a too-small scale saturates at ±127
        small = s * 0.1
        q = quantize_kv(t, small)
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(jax_quantize_kv(j, jnp.asarray(
                small.numpy()))))
        assert q.max() == 127 and q.min() == -127
    got = quantize_kv(torch.from_numpy(ties)[:, None, None],
                      torch.ones(12, 1))
    want = jax_quantize_kv(jnp.asarray(ties)[:, None, None], jnp.ones((12, 1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0, 0].tolist() == [-6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6]


def test_kv_dtype_validation(lm):
    with pytest.raises(FriendlyError, match="kv_dtype"):
        validate_kv_dtype("fp8", {"b0": (2, 16)})
    with pytest.raises(FriendlyError, match="even"):
        validate_kv_dtype("int8", {"b0": (2, 15)})
    validate_kv_dtype("int8", {"b0": (2, 16)})
    validate_kv_dtype("bf16", {"b0": (2, 15)})  # bf16 never restricted
    _, _, tg, tv, _ = lm
    with pytest.raises(FriendlyError, match="kv_dtype"):
        ServeEngine(tg, tv, slots=2, cache_len=CACHE_LEN, kv_dtype="int4",
                    device="cpu")


def test_run_demo_rejects_odd_head_dim():
    """An int8 engine over a model whose head_dim is odd dies with a
    FriendlyError at build time, not a kernel error mid-decode."""
    with pytest.raises(FriendlyError, match="even"):
        run_demo(slots=2, n_requests=1, max_new_tokens=2, d_model=30,
                 heads=2, cache_len=32, kv_dtype="int8", device="cpu")


# -- the int8 plain versions against the JAX int8 kernels -----------------------


def _q8_inputs(rng, kv_shape, scale_shape):
    """Same int8 values and f32 scales for both packages."""
    vals = [rng.integers(-127, 128, size=kv_shape).astype(np.int8)
            for _ in range(2)]
    scales = [(rng.random(scale_shape) * 0.01 + 0.02).astype(np.float32)
              for _ in range(2)]
    return vals, scales


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["float32", "bfloat16"])
def test_int8_flash_decode_reference_matches_jax(dtype, tol):
    b, L, h, hk, d = 4, 32, 4, 2, 16
    rng = np.random.default_rng(1)
    (k, v), (ks, vs) = _q8_inputs(rng, (b, L, hk, d), (b, hk))
    q = torch.from_numpy(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    q = q.to(dtype)
    jq = jnp.asarray(q.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    lengths = [32, 17, 0, 1]
    want = jax_flash_decode(jq, jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), block=8, interpret=True,
                            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = fa.flash_decode(q, torch.from_numpy(k), torch.from_numpy(v),
                          torch.tensor(lengths), k_scale=torch.from_numpy(ks),
                          v_scale=torch.from_numpy(vs))
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.float().numpy(), atol=tol, rtol=tol)
    assert not got[2].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["float32", "bfloat16"])
def test_int8_paged_reference_matches_jax(dtype, tol):
    b, h, hk, d, ps, max_pages = 3, 2, 1, 16, 8, 4
    num_pages = b * max_pages + 1
    rng = np.random.default_rng(2)
    (kp, vp), (ks, vs) = _q8_inputs(rng, (num_pages, hk, ps, d),
                                    (num_pages, hk))
    pt = np.zeros((b, max_pages), np.int32)
    pt[0] = [5, 2, 11, 7]
    pt[1, :3] = [3, 9, 2]   # shares page 2 with row 0
    pt[2, :1] = [12]        # the rest point at the trash page 0
    lengths = [32, 19, 6]
    q = torch.from_numpy(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    q = q.to(dtype)
    jq = jnp.asarray(q.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jax_paged_flash_decode(
        jq, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lengths),
        jnp.asarray(pt), interpret=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = fa.paged_flash_decode(
        q, torch.from_numpy(kp), torch.from_numpy(vp), torch.tensor(lengths),
        torch.from_numpy(pt), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    assert got.dtype == dtype
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.float().numpy(), atol=tol, rtol=tol)


def test_int8_argument_contract():
    b, L, h, d = 2, 16, 2, 16
    q = torch.zeros(b, 1, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, L, h, d, dtype=torch.int8)
    lens = torch.full((b,), L, dtype=torch.int32)
    ones = torch.ones(b, h)
    with pytest.raises(ValueError, match="scale"):
        fa.flash_decode(q, k, k, lens)
    with pytest.raises(ValueError, match="int8-mode"):
        fa.flash_decode(q, q.expand(b, L, h, d), q.expand(b, L, h, d), lens,
                        k_scale=ones, v_scale=ones)
    with pytest.raises(ValueError, match="float query"):
        fa.flash_decode(q.to(torch.int32), k, k, lens, k_scale=ones,
                        v_scale=ones)
    with pytest.raises(ValueError, match=r"\(2, 2\)"):
        fa.flash_decode(q, k, k, lens, k_scale=ones[:1], v_scale=ones)
    with pytest.raises(ValueError, match="even head_dim"):
        fa.flash_decode(q[..., :15], k[..., :15], k[..., :15], lens,
                        k_scale=ones, v_scale=ones)
    pages = torch.zeros(5, h, 8, d, dtype=torch.int8)
    pt = torch.zeros(b, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="per \\(page, kv head\\)"):
        fa.paged_flash_decode(q, pages, pages, lens, pt, k_scale=ones,
                              v_scale=ones)
    before = (fa.q8_launches, fa.paged_q8_launches)
    fa.paged_flash_decode(q, pages, pages, lens, pt,
                          k_scale=torch.ones(5, h), v_scale=torch.ones(5, h))
    fa.flash_decode(q, k, k, lens, k_scale=ones, v_scale=ones)
    assert (fa.q8_launches, fa.paged_q8_launches) == before  # plain, CPU


# -- the pools' scale lifecycle ----------------------------------------------------


def test_dense_pool_int8_writes_and_free_resets_scales(lm):
    _, _, tg, tv, _ = lm
    pool = SlotCachePool(tg, tv, 2, CACHE_LEN, device="cpu", kv_dtype="int8")
    cache, _ = _fake_prefill(8, seed=0)
    slot = pool.lease()
    with pytest.raises(FriendlyError, match="start=0"):
        pool.write_prefill(slot, cache, 8, start=2)
    pool.write_prefill(slot, cache, 8)
    for name, (k, _v, ks, vs) in pool.buffers.items():
        assert k.dtype == torch.int8 and ks.shape == (2, 2)
        want_ks = kv_head_scales(cache[name][0][0], axes=(0, 2))
        assert torch.equal(ks[slot], want_ks)
        assert torch.equal(k[slot, :8],
                           quantize_kv(cache[name][0][0], want_ks))
        assert not torch.allclose(vs[slot], torch.ones(2))
    pool.free(slot)
    for _k, _v, ks, vs in pool.buffers.values():
        assert (ks == 1.0).all() and (vs == 1.0).all()


def test_paged_int8_pool_bit_equal_to_jax(lm):
    """Per-page first-write scales, a prefix hit whose resume enters the
    shared partial page (copy-on-extend copies the page's scales, the
    shared page keeps its own), and the int8 gather round trip: the port
    pool's int8 stores and scales bit-equal to the JAX pool's."""
    jg, jv, tg, tv, _ = lm
    port = PagedCachePool(tg, tv, 2, CACHE_LEN, device="cpu",
                          kv_dtype="int8", prefix_cache=True)
    jpool = JaxPagedCachePool(jg, jv, 2, CACHE_LEN, kv_dtype="int8",
                              prefix_cache=True)
    ps = port.page_size
    length = ps + 4  # page 1 shared AND partial
    seq = np.arange(length, dtype=np.int32) % 8
    cache, jcache = _fake_prefill(length, seed=5)
    rest, jrest = _fake_prefill(2 * ps, seed=6)
    for pool, c, r in ((port, cache, rest), (jpool, jcache, jrest)):
        s0 = pool.lease()
        pool.write_prefill(s0, c, length)
        pool.prefix_insert(s0, seq)
        pool.free(s0)
        s1 = pool.lease()
        assert pool.map_prefix(s1, pool._prefix[seq.tobytes()], length)
        pool.write_prefill(s1, r, 2 * ps, start=length)
    assert port.cow_copies == jpool.cow_copies == 1
    np.testing.assert_array_equal(port._pt_host, jpool._pt_host)
    shared, new = port._prefix[seq.tobytes()].pages[1], port._pt_host[s1, 1]
    assert new != shared
    for name, entry in port.buffers.items():
        jentry = jpool.buffers[name]
        for i in (0, 1, 3, 4):
            np.testing.assert_array_equal(
                entry[i].numpy(), np.asarray(jentry[i]),
                err_msg=f"{name}[{i}]")
        ks = entry[3]
        assert torch.equal(ks[new], ks[shared])  # CoW carried the scales
    got = port.gather_prefix(port._prefix[seq.tobytes()], length)
    want = jpool.gather_prefix(jpool._prefix[seq.tobytes()], length)
    for name in got:
        for g, w, src in zip(got[name], want[name], cache[name]):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
            np.testing.assert_allclose(g[0, :length].float().numpy(),
                                       src[0, :length].float().numpy(),
                                       atol=0.06)
    port.free(s1)
    assert port.pages_free == port.pages_allocatable - 2  # the entry's


def test_kv_cache_bytes_and_metrics(lm):
    _, _, tg, tv, _ = lm
    kw = dict(slots=2, cache_len=CACHE_LEN, device="cpu")
    bf16 = ServeEngine(tg, tv, **kw)
    int8 = ServeEngine(tg, tv, kv_dtype="int8", **kw)
    stored, baseline = kv_cache_bytes(int8.pool.buffers)
    assert stored < baseline and baseline > 1.6 * stored
    assert kv_cache_bytes(bf16.pool.buffers) == (
        bf16.pool.device_bytes_per_device() - 2 * 4 - 2,) * 2
    d8, d16 = int8.metrics.to_dict(), bf16.metrics.to_dict()
    assert d8["kv_dtype"] == "int8" and d16["kv_dtype"] == "bf16"
    assert (d8["cache_pool_bytes_per_device"]
            < d16["cache_pool_bytes_per_device"])
    paged8 = ServeEngine(tg, tv, paged=True, kv_dtype="int8", **kw)
    stored, baseline = kv_cache_bytes(paged8.pool.buffers)
    assert stored < baseline
    # the one page table counts once
    assert stored == paged8.pool.device_bytes_per_device() - 2 * 4 - 2


# -- the int8 engines against the JAX int8 engines --------------------------------


#: prompts in one prefill bucket and budgets that keep the block ladder
#: at T=4: each JAX engine compiles few interpret-mode programs
PROMPTS = (4, 1, 8, 7, 3)
BUDGETS = [5] * 5


def _streams(engine, ids):
    """The ragged schedule with a mid-run join; generated tokens per
    request."""
    prompts = [ids[0, :n] for n in PROMPTS]
    results, rids = {}, []
    for p, n in zip(prompts[:3], BUDGETS[:3]):
        rids.append(engine.submit(p, max_new_tokens=n))
    results.update({r.id: r for r in engine.step()})
    for p, n in zip(prompts[3:], BUDGETS[3:]):
        rids.append(engine.submit(p, max_new_tokens=n))
    results.update(engine.run())
    return [results[r] for r in rids]


@pytest.fixture(scope="module")
def bf16_streams(lm):
    _, _, tg, tv, ids = lm
    engine = ServeEngine(tg, tv, slots=2, cache_len=CACHE_LEN, max_queue=8,
                         decode_block=4, device="cpu")
    return [r.tokens for r in _streams(engine, ids)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_engine_matches_jax_and_stays_within_flip_budget(
        lm, bf16_streams, paged):
    jg, jv, tg, tv, ids = lm
    kw = dict(slots=2, cache_len=CACHE_LEN, max_queue=8, decode_block=4,
              kv_dtype="int8", paged=paged)
    jax_res = _streams(JaxServeEngine(jg, jv, **kw), ids)
    engine = ServeEngine(tg, tv, device="cpu", **kw)
    res = _streams(engine, ids)
    for n, jr, r in zip(PROMPTS, jax_res, res):
        assert r.status == "completed"
        _assert_streams_agree(jg, jv, jr.tokens, r.tokens, n)
    rate = _flip_rate([s[n:] for s, n in zip(bf16_streams, PROMPTS)],
                      [r.tokens[n:] for r, n in zip(res, PROMPTS)])
    assert rate <= FLIP_BUDGET, f"int8 flip rate {rate}"
    if paged:
        assert engine.pool.pages_free == engine.pool.pages_allocatable
    else:  # every slot freed, its scales reset with it
        for _k, _v, ks, _vs in engine.pool.buffers.values():
            assert (ks == 1.0).all()
    assert engine.metrics.to_dict()["kv_dtype"] == "int8"
