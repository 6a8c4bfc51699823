"""The port's paged KV pool and paged decode against the JAX package's
(mirroring ``tests/test_paging.py``): page geometry and validation, the
host allocator (refcounts, double free, the trash page, exhaustion), the
page stores and page tables bit-equal to the JAX ``PagedCachePool``'s
after the same writes, ``paged_flash_decode_reference`` against the JAX
``paged_flash_decode`` run in interpret mode, and the paged engine's
token streams and paging figures against the JAX paged engine's and the
port's dense engine's.

Tolerances: the plain version against the JAX kernel 1e-5 in float32
(both accumulate in f32; only the order of the sums differs) and 1e-2 in
bfloat16 (both round the output to bf16). Streams must be equal, or
first differ at a near tie of the JAX model (``tests/test_torch_serve.py``
explains the rule).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.ops.flash_attention import (
    paged_flash_decode as jax_paged_flash_decode,
)
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.serve.paging import PagedCachePool as JaxPagedCachePool
from mmlspark_tpu.serve.paging import default_page_size as jax_page_size
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import (
    ResourceExhausted,
    is_resource_exhausted,
)
from mmlspark_tpu_torch.models import (
    build_model,
    generate,
    load_flax_variables,
)
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.serve import ServeEngine
from mmlspark_tpu_torch.serve.paging import (
    MIN_PAGE_SIZE,
    PagedCachePool,
    default_page_size,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the bf16 logit tolerance of tests/test_torch_model.py
BF16_LOGIT_TOL = 6.25e-2
TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)
CACHE_LEN = 32


@pytest.fixture(scope="module")
def lm():
    """(jax graph, jax variables, port graph, port variables, ids): the
    JAX package's overfit periodic LM, bridged into the port."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    tg = build_model("transformer_lm", **TINY)
    tv = load_flax_variables(tg, jv, device="cpu")
    return jg, jv, tg, tv, np.array(ids)


def _assert_streams_agree(jg, jv, want, got, prompt_len):
    """``got`` equals ``want`` (both prompt + generated), or first
    differs at a step where the JAX model's top-2 margin is a near-tie
    under the bf16 logit tolerance; equal lengths either way."""
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


def _fake_prefill(geometry, length, seed=0):
    """A synthetic batch-1 linear cache: ({block: (K, V)} for the port,
    the same bf16 values for JAX)."""
    rng = np.random.default_rng(seed)
    port, jax_cache = {}, {}
    for name, (hk, d) in geometry.items():
        pair = [torch.from_numpy(
            rng.normal(size=(1, length, hk, d)).astype(np.float32)
        ).to(torch.bfloat16) for _ in range(2)]
        port[name] = tuple(pair)
        jax_cache[name] = tuple(
            jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
            for t in pair)
    return port, jax_cache


def _pools(lm, **kw):
    jg, jv, tg, tv, _ = lm
    kw.setdefault("slots", 2)
    kw.setdefault("cache_len", CACHE_LEN)
    return (PagedCachePool(tg, tv, device="cpu", **kw),
            JaxPagedCachePool(jg, jv, **kw))


GEOMETRY = {"block0": (2, 16), "block1": (2, 16)}


def _assert_pools_equal(port, jax_pool):
    """Page stores (and int8 scales) bit-equal, page tables and paging
    figures equal; the device table equals the host mirror."""
    assert port.paging_stats() == jax_pool.paging_stats()
    assert port.refcount_audit() == jax_pool.refcount_audit()
    np.testing.assert_array_equal(port._pt_host, jax_pool._pt_host)
    np.testing.assert_array_equal(port.page_table.numpy(), port._pt_host)
    for name, entry in port.buffers.items():
        jentry = jax_pool.buffers[name]
        assert len(entry) == len(jentry)
        for i, (t, j) in enumerate(zip(entry, jentry)):
            if i == 2:
                continue  # the page table, compared above
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(j, np.float32),
                err_msg=f"{name}[{i}]")


# -- page geometry and validation ---------------------------------------------


def test_default_page_size_and_validation(lm):
    for cl in (8, 16, 24, 32, 40, 48, 64, 80, 96):
        assert default_page_size(cl) == jax_page_size(cl)
        assert default_page_size(cl) % MIN_PAGE_SIZE == 0
    for cl in (20, 36, 100):
        with pytest.raises(FriendlyError, match="multiple"):
            default_page_size(cl)
    _, _, tg, tv, _ = lm
    for kw, match in ((dict(page_size=4), "page_size"),
                      (dict(page_size=12), "multiple"),
                      (dict(page_size=24), "divide"),
                      (dict(cache_len=20), "multiple"),
                      (dict(num_pages=1), "trash page")):
        kw.setdefault("cache_len", CACHE_LEN)
        with pytest.raises(FriendlyError, match=match):
            PagedCachePool(tg, tv, 2, device="cpu", **kw)
    # paging knobs without paged=True refuse loudly, not serve dense
    for kw in (dict(page_size=8), dict(prefix_cache=True),
               dict(num_pages=9)):
        with pytest.raises(FriendlyError, match="paged=True"):
            ServeEngine(tg, tv, slots=2, cache_len=CACHE_LEN, device="cpu",
                        **kw)


# -- the host allocator --------------------------------------------------------


def test_alloc_refcount_free_and_double_free(lm):
    port, _ = _pools(lm)
    assert port.pages_free == port.pages_allocatable == 2 * 4
    slot = port.lease()
    port.write_prefill(slot, _fake_prefill(GEOMETRY, 12)[0], 12)
    assert port._npages[slot] == 2  # ceil(12 / 8)
    mapped = port._pt_host[slot, :2].tolist()
    assert all(port._refcount[p] == 1 for p in mapped)
    assert port.pages_free == port.pages_allocatable - 2
    assert port.refcount_audit() == (2, 2)
    port.free(slot)
    assert port.pages_free == port.pages_allocatable
    assert port.refcount_audit() == (0, 0)
    with pytest.raises(FriendlyError, match="not leased"):
        port.free(slot)  # double free
    with pytest.raises(FriendlyError, match="underflow"):
        port._decref(mapped[0])  # already back on the free list


def test_freed_rows_point_at_the_trash_page(lm):
    port, _ = _pools(lm)
    slot = port.lease()
    port.write_prefill(slot, _fake_prefill(GEOMETRY, 9)[0], 9)
    assert (port.page_table[slot, :2] != 0).all()
    assert bool(port.live[slot]) and int(port.positions[slot]) == 9
    port.free(slot)
    # host mirror and device table alike: every entry absorbs dead-row
    # writes in the trash page, and every block reads the one table
    assert (port.page_table[slot] == 0).all()
    assert (port._pt_host[slot] == 0).all()
    assert len({id(e[2]) for e in port.buffers.values()}) == 1
    assert not bool(port.live[slot]) and int(port.positions[slot]) == 0


def test_pool_exhaustion_raises_resource_exhausted(lm):
    port, _ = _pools(lm, num_pages=4)  # 1 trash + 3 allocatable
    slot = port.lease()
    with pytest.raises(ResourceExhausted, match="exhausted") as err:
        port.write_prefill(slot, _fake_prefill(GEOMETRY, 32)[0], 32)
    assert is_resource_exhausted(err.value)
    assert "RESOURCE_EXHAUSTED" in str(err.value)
    # pages mapped before the failure stay accounted to the slot
    assert port.pages_free == 0
    port.free(slot)
    assert port.pages_free == port.pages_allocatable


def test_pool_state_bit_equal_to_jax(lm):
    """The same writes, prefix-cache hit, copy-on-extend, decode-page
    mapping and frees through both pools: identical page tables,
    refcounts and paging figures, bit-equal page stores, and the same
    gathered prefix."""
    port, jax_pool = _pools(lm, prefix_cache=True)
    seq = np.arange(12, dtype=np.int32) % 8
    cache, jcache = _fake_prefill(GEOMETRY, 12, seed=3)
    for pool, c in ((port, cache), (jax_pool, jcache)):
        s0 = pool.lease()
        pool.write_prefill(s0, c, 12)
        pool.prefix_insert(s0, seq)
    _assert_pools_equal(port, jax_pool)

    # a prompt sharing 10 tokens resumes at keep=10: page 1 is shared
    # and partial, so the remainder write copies it on extend
    other = np.concatenate([seq[:10], [5, 6, 7]]).astype(np.int32)
    rest, jrest = _fake_prefill(GEOMETRY, 16, seed=4)
    for pool, c in ((port, rest), (jax_pool, jrest)):
        entry, keep = pool.prefix_lookup(other, lambda n: 8)
        assert keep == 10
        s1 = pool.lease()
        assert pool.map_prefix(s1, entry, keep)
        pool.write_prefill(s1, c, 13, start=keep)
        pool.ensure_decode_pages({s1: 13}, 8)
    assert port.cow_copies == 1
    _assert_pools_equal(port, jax_pool)

    entry, jentry = (p._prefix[seq.tobytes()] for p in (port, jax_pool))
    got, want = port.gather_prefix(entry, 11), jax_pool.gather_prefix(
        jentry, 11)
    for name in got:
        for g, w, src in zip(got[name], want[name], cache[name]):
            assert g.shape == (1, CACHE_LEN, 2, 16)
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
            assert torch.equal(g[0, :11], src[0, :11])
    for pool in (port, jax_pool):
        pool.free(0)
        pool.free(1)
    _assert_pools_equal(port, jax_pool)
    assert port.pages_free == port.pages_allocatable - 2  # the entry's


# -- the plain version against the JAX kernel ---------------------------------


def _paged_inputs(b, h, hk, d, ps, max_pages, lengths, seed):
    """Random stores and a shuffled page table: distinct pages for every
    live logical page, rows 1 and 2 sharing their first page, and the
    trash page 0 past each row's live length."""
    rng = np.random.default_rng(seed)
    num_pages = b * max_pages + 1
    perm = list(rng.permutation(np.arange(1, num_pages)))
    pt = np.zeros((b, max_pages), np.int32)
    for row, n in enumerate(lengths):
        for j in range(-(-min(n, max_pages * ps) // ps)):
            pt[row, j] = perm.pop()
    pt[1, 0] = pt[2, 0]
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kp, vp = (rng.normal(size=(num_pages, hk, ps, d)).astype(np.float32)
              for _ in range(2))
    return q, kp, vp, pt


def _both(x, dtype):
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(t.float().numpy())
    return (j.astype(jnp.bfloat16) if dtype == torch.bfloat16 else j), t


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hk", [2, 1], ids=["mha", "gqa_hkv1"])
def test_paged_reference_matches_jax_kernel(dtype, tol, hk):
    b, h, d, ps, max_pages = 4, 2, 16, 8, 4
    lengths = [0, 9, 7, 40]  # empty, shared-page rows, past the end
    arrays = _paged_inputs(b, h, hk, d, ps, max_pages, lengths, seed=hk)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in arrays[:3])
    pt = arrays[3]
    want = jax_paged_flash_decode(jq, jk, jv, jnp.asarray(lengths),
                                  jnp.asarray(pt), interpret=True)
    got = fa.paged_flash_decode(tq, tk, tv, torch.tensor(lengths),
                                torch.from_numpy(pt))
    assert got.dtype == dtype and got.shape == tq.shape
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.float().numpy(), atol=tol, rtol=tol)
    assert not got[0].any()  # length 0: exact zeros


def test_paged_flash_decode_validation_and_routing():
    q = torch.zeros(2, 1, 2, 16)
    pages = torch.zeros(5, 2, 8, 16)
    pt = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.tensor([3, 9], dtype=torch.int32)
    pages3 = pages[:, :1].repeat(1, 3, 1, 1)  # 3 kv heads for 2 q heads
    for args, match in (
        ((q, pages, pages.bfloat16(), lens, pt), "one dtype"),
        ((torch.cat([q, q], 1), pages, pages, lens, pt), "SINGLE query"),
        ((q, pages, pages[:, :1], lens, pt), "one .* shape"),
        ((q, pages3, pages3, lens, pt), "heads"),
        ((q.bfloat16(), pages, pages, lens, pt), "share one dtype"),
        ((q, pages[:, :, :4], pages[:, :, :4], lens, pt), "multiple of 8"),
        ((q, pages, pages, lens, pt[:1]), "page_table"),
        ((q, pages, pages, lens[:1], pt), "lengths"),
    ):
        with pytest.raises(ValueError, match=match):
            fa.paged_flash_decode(*args)
    # a CPU tensor takes the plain version (no launch); another device
    # is refused rather than computed somewhere else
    before = (fa.paged_launches, fa.paged_q8_launches)
    out = fa.paged_flash_decode(q, pages, pages, lens, pt)
    assert out.shape == q.shape
    assert (fa.paged_launches, fa.paged_q8_launches) == before
    # a meta tensor (a cost analysis) launches nothing and returns the
    # output's shape; any other non-CUDA device is refused
    meta = [t.to("meta") for t in (q, pages, lens, pt)]
    with fa.meta_cost() as cost:
        out = fa.paged_flash_decode(meta[0], meta[1], meta[1], meta[2],
                                    meta[3])
    assert out.shape == q.shape and out.device.type == "meta"
    assert (fa.paged_launches, fa.paged_q8_launches) == before
    assert cost["flops"] > 0 and cost["bytes"] > 0
    with pytest.raises(ValueError, match="cuda"):
        fa._require_cuda(meta[0], "paged_flash_decode")


# -- the paged engine against the JAX paged engine and the dense engine -------


def _run(engine, prompts, budgets, eos):
    """Three requests up front, two steps, then the rest join mid-run."""
    results, rids = {}, []
    for p, n, e in zip(prompts[:3], budgets[:3], eos[:3]):
        rids.append(engine.submit(p, max_new_tokens=n, eos_id=e))
    for _ in range(2):
        results.update({r.id: r for r in engine.step()})
    for p, n, e in zip(prompts[3:], budgets[3:], eos[3:]):
        rids.append(engine.submit(p, max_new_tokens=n, eos_id=e))
    while engine.busy:
        results.update({r.id: r for r in engine.step()})
    return [results[r] for r in rids]


def test_paged_engine_streams_match_jax_and_dense(lm):
    """Shared-prefix traffic with mid-run joins through the paged engine
    with the prefix cache: a 10-token shared prefix (a hit that copies
    the shared partial page on extend), an exact re-ask, and a request
    that hits EOS inside a T=4 block. The port's paged streams = the JAX
    paged engine's = the port's dense engine's = the port's generate(),
    the paging figures equal the JAX engine's, and the drained pool
    holds only the prefix entries' pages."""
    jg, jv, tg, tv, ids = lm
    a = ids[0, :12]
    b = np.concatenate([a[:10], (a[10:12] + 1) % 64]).astype(np.int32)
    c = ids[0, :3]
    free = generate(tg, tv, c[None], 12, device="cpu")[0].numpy()
    eos_c = int(free[len(c) + 2])
    prompts = [a, b, c, a, ids[0, :9]]
    budgets = [6, 8, 12, 5, 7]
    eos = [None, None, eos_c, None, None]
    kw = dict(slots=2, cache_len=CACHE_LEN, max_queue=8, decode_block=4)
    jax_engine = JaxServeEngine(jg, jv, paged=True, prefix_cache=True, **kw)
    jax_res = _run(jax_engine, prompts, budgets, eos)
    paged = ServeEngine(tg, tv, paged=True, prefix_cache=True,
                        device="cpu", **kw)
    paged_res = _run(paged, prompts, budgets, eos)
    dense_res = _run(ServeEngine(tg, tv, device="cpu", **kw), prompts,
                     budgets, eos)
    for p, n, e, jr, pr, dr in zip(prompts, budgets, eos, jax_res,
                                   paged_res, dense_res):
        assert pr.status == "completed"
        _assert_streams_agree(jg, jv, jr.tokens, pr.tokens, len(p))
        _assert_streams_agree(jg, jv, dr.tokens, pr.tokens, len(p))
        want = generate(tg, tv, p[None], n, eos_id=e, device="cpu")[0]
        _assert_streams_agree(jg, jv, want.numpy()[:len(pr.tokens)],
                              pr.tokens, len(p))
    assert int(paged_res[2].tokens[-1]) == eos_c  # the mid-block EOS
    assert paged_res[2].generated < 12
    stats = paged.pool.paging_stats()
    assert stats == jax_engine.pool.paging_stats()
    assert stats["prefix_cache_hits_total"] >= 2
    assert stats["cow_copies_total"] >= 1
    assert paged.pool.refcount_audit() == jax_engine.pool.refcount_audit()
    refs, mapped = paged.pool.refcount_audit()
    assert refs == mapped
    entry_pages = {p for e in paged.pool._prefix.values() for p in e.pages}
    assert paged.pool.pages_free == (paged.pool.pages_allocatable
                                     - len(entry_pages))
    d = paged.metrics.to_dict()
    assert {k: d[k] for k in stats} == stats
    assert d["kv_dtype"] == "bf16"
    assert (paged.pool.device_bytes_per_device()
            > 0 and d["cache_pool_bytes_per_device"]
            == paged.pool.device_bytes_per_device())
