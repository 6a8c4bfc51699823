"""The port's chunked prefill and pipelined async host loop against the
JAX engine, mirroring ``tests/test_chunked_async.py`` (its 2x2 mesh case
is in ``tests/test_torch_serve_mesh_planes.py``; its disaggregated
hand-off and ``core/perf`` cases are the replica plane's): with
``prefill_chunk`` a long prompt's fill runs as bounded chunk programs,
one program per chunk bucket; with ``async_host`` block N+1 is
dispatched before block N is fetched, still at most one fetch a block;
every stream equals the JAX engine's, and a JAX engine's snapshot,
killed mid-fill, restores on the port.

The model is the JAX package's overfit periodic LM bridged into the port,
so greedy picks have wide margins and the streams compare token for
token. The JAX reference streams come from ONE JAX engine over every
prompt the module uses, each at its longest budget (a shorter budget's
stream is a prefix). On the CPU the async mode checks the bookkeeping —
parity, the identity fence, the deferred frees, the fetch count through
the engine's one fetch helper; the overlap on the card is
``tests/test_torch_cuda.py``'s.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.faults import EngineKilled as JaxEngineKilled
from mmlspark_tpu.core.faults import Fault as JaxFault
from mmlspark_tpu.core.faults import FaultInjector as JaxFaultInjector
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.serve.metrics import ServeMetrics as JaxServeMetrics
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import EngineKilled, Fault, FaultInjector
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.serve import ServeEngine, ServeMetrics
from mmlspark_tpu_torch.serve.cache_pool import SlotCachePool
from mmlspark_tpu_torch.models.generate import init_cache
from mmlspark_tpu_torch.testing import serve_compile_guard


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)
#: prompt length -> the longest budget any test here asks of it
LONGEST = {1: 9, 2: 5, 4: 17, 5: 5, 6: 12, 9: 8, 11: 8, 12: 8}


@pytest.fixture(scope="module")
def lm():
    """(jax graph, jax variables, port graph, port variables, row, JAX
    streams {prompt length: prompt + LONGEST tokens})."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    tg = build_model("transformer_lm", **TINY)
    tv = load_flax_variables(tg, jv, device="cpu")
    row = np.array(ids[0])
    ref = JaxServeEngine(jg, jv, slots=4, cache_len=32, max_queue=8,
                         decode_block=8)
    rids = {n: ref.submit(row[:n], max_new_tokens=b)
            for n, b in LONGEST.items()}
    out = ref.run()
    streams = {n: np.asarray(out[r].tokens) for n, r in rids.items()}
    return jg, jv, tg, tv, row, streams


def _want(streams, n, budget):
    assert budget <= LONGEST[n]
    return streams[n][:n + budget]


def _engine(lm, **kw):
    return ServeEngine(lm[2], lm[3], device="cpu", **kw)


def _drive_joins(engine, prompts, budgets, head=3, warm=3):
    """``head`` requests up front, ``warm`` steps, then the rest join
    while earlier fills and decodes are open."""
    results, rids = {}, []
    for p, n in zip(prompts[:head], budgets[:head]):
        rids.append(engine.submit(p, max_new_tokens=n))
    for _ in range(warm):
        results.update({r.id: r for r in engine.step()})
    for p, n in zip(prompts[head:], budgets[head:]):
        rids.append(engine.submit(p, max_new_tokens=n))
    while engine.busy:
        results.update({r.id: r for r in engine.step()})
    return results, rids


# -- config validation -----------------------------------------------------


def test_chunk_validation(lm):
    _, jv, tg, tv, _, _ = lm
    for bad in (12, 6, 3, 9):
        with pytest.raises(FriendlyError, match="power of two"):
            _engine(lm, slots=1, cache_len=32, prefill_chunk=bad)
    with pytest.raises(FriendlyError, match="exceeds cache_len"):
        _engine(lm, slots=1, cache_len=32, prefill_chunk=64)
    moe = copy.copy(tg)
    moe.extra = dict(tg.extra, n_experts=2)
    with pytest.raises(FriendlyError, match="MoE"):
        ServeEngine(moe, tv, slots=1, cache_len=16, prefill_chunk=8,
                    device="cpu")


def test_chunk_bucket_ladder(lm):
    jg, jv = lm[:2]
    for chunk in (16, 8, None):
        port = _engine(lm, slots=1, cache_len=32, prefill_chunk=chunk)
        ref = JaxServeEngine(jg, jv, slots=1, cache_len=32,
                             prefill_chunk=chunk)
        assert port.num_chunk_buckets == ref.num_chunk_buckets
        assert port.num_prefill_buckets == ref.num_prefill_buckets
        if chunk is not None:
            assert [port.chunk_bucket(n) for n in range(1, 33)] == \
                [ref.chunk_bucket(n) for n in range(1, 33)]
    e = _engine(lm, slots=1, cache_len=32, prefill_chunk=16)
    assert e.num_chunk_buckets == e.num_prefill_buckets == 2
    assert (e.chunk_bucket(1), e.chunk_bucket(8), e.chunk_bucket(9),
            e.chunk_bucket(16)) == (8, 8, 16, 16)
    assert _engine(lm, slots=1, cache_len=32,
                   prefill_chunk=8).num_chunk_buckets == 1
    mono = _engine(lm, slots=1, cache_len=32)
    assert mono.num_prefill_buckets > 0 and mono.num_chunk_buckets == 0


# -- parity: chunked fills against the JAX engine --------------------------


def test_chunked_parity_ragged_prompts_and_mid_fill_joins(lm):
    """chunk=8 over prompts of 1 to 12 tokens (multi-chunk fills for the
    long ones), mixed budgets, joins landing while other slots are
    mid-fill AND mid-decode: every stream equals the JAX engine's, under
    the compile guard with the tightened pin."""
    row, streams = lm[4], lm[5]
    lengths = [12, 1, 9, 4, 11, 6]
    budgets = [6, 9, 4, 8, 5, 7]
    engine = _engine(lm, slots=2, cache_len=32, max_queue=8,
                     decode_block=4, prefill_chunk=8)
    with serve_compile_guard(engine, min_decode=1, min_prefill=1):
        results, rids = _drive_joins(
            engine, [row[:n] for n in lengths], budgets)
    for rid, n, b in zip(rids, lengths, budgets):
        np.testing.assert_array_equal(
            results[rid].tokens, _want(streams, n, b),
            err_msg=f"chunked fill diverged: request={rid}")
    assert engine.prefill_compile_count <= engine.num_chunk_buckets == 1
    assert engine.metrics.chunked_prefills_total >= len(lengths) + 1


def test_chunked_parity_mid_fill_eos_and_tiny_budget(lm):
    """A fill whose FIRST token is the EOS retires at fill completion
    without activating; budget 1 retires the same way."""
    row, streams = lm[4], lm[5]
    prompt = row[:9]  # 2 chunks at chunk=8
    free = _want(streams, 9, 4)
    eos = int(free[9])  # the first generated token
    engine = _engine(lm, slots=2, cache_len=32, prefill_chunk=8)
    r_eos = engine.submit(prompt, max_new_tokens=4, eos_id=eos)
    r_one = engine.submit(prompt, max_new_tokens=1)
    res = engine.run()
    np.testing.assert_array_equal(res[r_eos].tokens, free[:10])
    assert res[r_eos].generated == 1 and res[r_eos].status == "completed"
    np.testing.assert_array_equal(res[r_one].tokens, free[:10])


def test_chunked_parity_paged_prefix_and_int8(lm):
    """Chunked fills through the paged pool with the prefix cache on (a
    resubmitted prompt seeds its carry from the shared prefix) and int8
    KV, against the monolithic twin and the JAX streams; the dense int8
    pool's chunked fills (whole-range writes) too."""
    row, streams = lm[4], lm[5]
    lengths = [12, 12, 9, 5]  # the second reuses the first's prefix
    prompts = [row[:n] for n in lengths]
    kw = dict(slots=2, cache_len=32, max_queue=8, paged=True, page_size=8,
              prefix_cache=True, kv_dtype="int8")
    runs = {}
    for label, extra in (("chunked", dict(prefill_chunk=8)),
                         ("monolithic", {}),
                         ("dense int8", dict(prefill_chunk=8, paged=False,
                                             page_size=None,
                                             prefix_cache=False))):
        engine = _engine(lm, **dict(kw, **extra))
        rids = [engine.submit(p, max_new_tokens=5) for p in prompts]
        res = engine.run()
        runs[label] = [res[r].tokens for r in rids]
        if label == "chunked":
            assert engine.pool.prefix_hits >= 1
            refs, mapped = engine.pool.refcount_audit()
            assert refs == mapped
    for label, got in runs.items():
        for toks, n in zip(got, lengths):
            np.testing.assert_array_equal(
                toks, _want(streams, n, 5), err_msg=f"{label}: {n}")


# -- parity: the async host loop -------------------------------------------


def test_async_parity_and_at_most_one_fetch_per_block(lm, monkeypatch):
    """One request decoding 16 tokens through T=8 blocks pays at most 2
    fetches (one a block: the pipelined fetch lands a tick late but adds
    none), and the stream equals the JAX engine's."""
    row, streams = lm[4], lm[5]
    engine = _engine(lm, slots=1, cache_len=32, decode_block=8,
                     async_host=True)
    rid = engine.submit(row[:4], max_new_tokens=17)
    fetches = {"n": 0}
    real = engine._fetch

    def counting(inflight):
        fetches["n"] += 1
        return real(inflight)

    monkeypatch.setattr(engine, "_fetch", counting)
    res = engine.run()[rid]
    np.testing.assert_array_equal(res.tokens, _want(streams, 4, 17))
    assert fetches["n"] <= 2, f"fetches: {fetches['n']} (> 1 per block)"
    d = engine.metrics.to_dict()
    assert d["async_host"] == 1
    assert d["host_idle_fraction"] is not None


def test_async_parity_ragged_with_joins_and_overlap(lm, monkeypatch):
    """Multi-slot async run with mid-run joins (fills start while a block
    is in flight): streams equal the JAX engine's, the engine pipelined
    (overlapped dispatches), the identity fence dropped rows of slots that
    changed hands, and no deferred slot was leased before its fetch."""
    row, streams = lm[4], lm[5]
    lengths = [4, 1, 9, 6, 2]
    budgets = [10, 7, 3, 12, 5]
    engine = _engine(lm, slots=2, cache_len=32, max_queue=8,
                     decode_block=4, async_host=True, prefill_chunk=8)
    pool = engine.pool
    fenced = {"rows": 0}
    real_consume = engine._sched.consume

    def consume(block, tick, states=None):
        fenced["rows"] += sum(engine._sched.active.get(s) is not st
                              for s, st in (states or {}).items())
        return real_consume(block, tick, states=states)

    real_lease = pool.lease

    def lease():
        slot = real_lease()
        assert slot not in pool._deferred_slots
        return slot

    monkeypatch.setattr(engine._sched, "consume", consume)
    monkeypatch.setattr(pool, "lease", lease)
    with serve_compile_guard(engine, min_decode=1, min_prefill=1):
        results, rids = _drive_joins(
            engine, [row[:n] for n in lengths], budgets, warm=2)
    for rid, n, b in zip(rids, lengths, budgets):
        np.testing.assert_array_equal(
            results[rid].tokens, _want(streams, n, b),
            err_msg=f"async stream diverged: request={rid}")
    assert engine.metrics.overlapped_dispatches_total > 0
    assert fenced["rows"] > 0
    assert engine.decode_compile_count <= engine.num_decode_blocks
    assert engine.prefill_compile_count <= engine.num_chunk_buckets
    assert pool._defer_gen is None and not pool._deferred
    assert pool.leased_count == 0


# -- crash drill: kill mid-chunk, restore ----------------------------------


def _kill_drill(engine, prompts, killed):
    rids = [engine.submit(p, max_new_tokens=8) for p in prompts]
    results = {}
    snap = engine.snapshot()
    with pytest.raises(killed):
        while engine.busy:
            snap = engine.snapshot()
            for res in engine.step():
                results[res.id] = res
    json.dumps(snap)
    assert snap["active"] or snap["queued"]
    return rids, results, snap


def test_kill_mid_chunk_restore_is_bit_identical(lm):
    """A kill at the prefill site while a multi-chunk fill is open
    (chunked + async engine): the park closes the deferred-free window,
    the snapshot carries the mid-fill request as queued, and the restored
    engine finishes every stream equal to the JAX engine's."""
    row, streams = lm[4], lm[5]
    lengths = [12, 9, 4, 11]
    inj = FaultInjector([Fault("serve.prefill", "kill", tick=1)])
    engine = _engine(lm, slots=2, cache_len=32, decode_block=2,
                     prefill_chunk=8, async_host=True, faults=inj)
    rids, results, snap = _kill_drill(
        engine, [row[:n] for n in lengths], EngineKilled)
    assert engine.pool.leased_count == 0
    assert engine.pool._defer_gen is None
    with pytest.raises(FriendlyError, match="killed"):
        engine.step()
    rebuilt = ServeEngine.restore(snap, lm[2], lm[3], slots=2,
                                  decode_block=2, prefill_chunk=8,
                                  async_host=True, device="cpu")
    results.update(rebuilt.run())
    assert set(results) == set(rids)
    for rid, n in zip(rids, lengths):
        assert results[rid].status == "completed"
        np.testing.assert_array_equal(
            results[rid].tokens, _want(streams, n, 8),
            err_msg=f"request {rid} diverged across the mid-chunk kill")


def test_jax_snapshot_killed_mid_chunk_restores_on_the_port(lm):
    """The JAX engine's own crash drill: its snapshot, taken before the
    tick that killed it mid-fill, passes the port's checksum and restores
    on the port's chunked async engine, which finishes every stream equal
    to the JAX engine's uncrashed streams."""
    jg, jv, tg, tv, row, streams = lm
    lengths = [12, 9, 4, 11]
    inj = JaxFaultInjector([JaxFault("serve.prefill", "kill", tick=1)])
    jax_engine = JaxServeEngine(jg, jv, slots=2, cache_len=32,
                                decode_block=2, prefill_chunk=8,
                                async_host=True, faults=inj)
    rids, results, snap = _kill_drill(
        jax_engine, [row[:n] for n in lengths], JaxEngineKilled)
    snap = json.loads(json.dumps(snap))  # through the wire format
    rebuilt = ServeEngine.restore(snap, tg, tv, slots=2, decode_block=2,
                                  prefill_chunk=8, async_host=True,
                                  device="cpu")
    assert rebuilt.tick == snap["tick"]
    results.update(rebuilt.run())
    assert set(results) == set(rids)
    for rid, n in zip(rids, lengths):
        assert results[rid].status == "completed"
        np.testing.assert_array_equal(
            np.asarray(results[rid].tokens), _want(streams, n, 8),
            err_msg=f"request {rid}")


# -- pool plumbing: deferred frees, ranged dense writes --------------------


def test_deferred_free_window_and_dense_start_validation(lm):
    tg, tv = lm[2], lm[3]
    pool = SlotCachePool(tg, tv, slots=2, cache_len=32, device="cpu")
    s0 = pool.lease()
    s1 = pool.lease()
    pool.defer_frees(1)
    pool.free(s0)
    # inside the window: the lease is NOT reusable yet...
    with pytest.raises(FriendlyError):
        pool.lease()
    # ...and a second free of the same slot is still a double free
    with pytest.raises(FriendlyError, match="double free"):
        pool.free(s0)
    pool.defer_frees(2)
    pool.free(s1)
    pool.flush_frees(1)  # releases gen <= 1 only
    assert pool.lease() == s0
    with pytest.raises(FriendlyError):
        pool.lease()
    pool.flush_frees(None)  # closes the window: everything releases
    assert pool.lease() == s1

    pool8 = SlotCachePool(tg, tv, slots=1, cache_len=32, device="cpu",
                          kv_dtype="int8")
    slot = pool8.lease()
    cache = init_cache(tg, tv, 1, 32)
    with pytest.raises(FriendlyError, match="start=0"):
        pool8.write_prefill(slot, cache, 8, start=4)


def test_paged_deferred_free_holds_pages_until_flush(lm):
    """The paged split: a deferred free points the slot's table row at
    the trash page at once, but its pages return to the free list only
    at the flush."""
    from mmlspark_tpu_torch.serve.paging import TRASH_PAGE, PagedCachePool

    tg, tv = lm[2], lm[3]
    pool = PagedCachePool(tg, tv, 2, 32, device="cpu", page_size=8)
    slot = pool.lease()
    pool.write_prefill(slot, init_cache(tg, tv, 1, 32), 12)
    free_before = pool.pages_free
    pool.defer_frees(1)
    pool.free(slot)
    assert (pool.page_table[slot] == TRASH_PAGE).all()
    assert pool.pages_free == free_before and slot in pool._deferred_slots
    pool.flush_frees(1)
    assert pool.pages_free == free_before + 2
    assert pool.lease() == slot


def test_metrics_new_keys_and_host_idle():
    port = ServeMetrics("m", slots=2)
    d = port.to_dict()
    assert set(d) <= set(JaxServeMetrics("m", 2).to_dict())
    assert d["prefill_chunk"] == 0
    assert d["chunked_prefills_total"] == 0
    assert d["async_host"] == 0
    assert d["overlapped_dispatches_total"] == 0
    assert d["host_idle_fraction"] is None

    b = ServeMetrics("m", slots=2, prefill_chunk=16, async_host=True)
    b.record_prefill_chunk()
    b.record_prefill_chunk()
    b.record_overlapped_dispatch()
    b.record_host_sync(0.002)
    b.sample_tick(0, 1, 0.010, tokens_emitted=1)
    d = b.to_dict()
    assert d["prefill_chunk"] == 16
    assert d["chunked_prefills_total"] == 2
    assert d["async_host"] == 1
    assert d["overlapped_dispatches_total"] == 1
    assert d["host_idle_fraction"] == pytest.approx(0.2)
    assert d["host_sync_wait_s"] == pytest.approx(0.002)
