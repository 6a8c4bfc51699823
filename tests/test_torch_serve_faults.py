"""The port's serving resilience layer against the JAX engine, mirroring
``tests/test_serve_faults.py`` (all but its sharded chaos soak, which
waits for meshes) and the serve cases of ``tests/test_integrity.py``:
the seeded fault injector (``core/faults.py``), retries invisible to
results, quarantine of exactly the faulted request, graceful degradation
under resource exhaustion (down the existing block ladder, admission cap,
preemption with resume; no new program), snapshot/restore crash recovery
with the snapshot checksum, and a port snapshot that passes the JAX
engine's ``restore`` checksum and finishes there with equal streams.

The model is the JAX package's overfit periodic LM bridged into the port.
The reference streams are the JAX engine's: ONE JAX engine, restored
from a port snapshot taken mid-run over every prompt the module uses at
its longest budget (a shorter budget's stream is a prefix). The chaos
soak's oracle is the port's own ``generate()``, which
``tests/test_torch_generate.py`` holds to the JAX package's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import integrity as jax_integrity
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core import integrity
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import (
    EngineKilled,
    Fault,
    FaultInjector,
    ResourceExhausted,
    TransientFault,
    is_resource_exhausted,
    is_transient,
    parse_fault_spec,
)
from mmlspark_tpu_torch.core.integrity import (
    CheckpointCorruption,
    IntegrityError,
    SnapshotCorruption,
)
from mmlspark_tpu_torch.models import (
    build_model,
    generate,
    load_flax_variables,
)
from mmlspark_tpu_torch.serve import ServeEngine
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
VOCAB = TINY["vocab_size"]
TERMINAL = {"completed", "expired", "failed", "stalled"}
#: prompt length -> the longest budget any test here asks of it
LONGEST = {3: 8, 4: 20, 5: 20, 6: 8}


@pytest.fixture(scope="module")
def lm():
    """(jax graph, jax variables, port graph, port variables, row, JAX
    streams {prompt length: prompt + LONGEST tokens}, the port's streams
    of the same run)."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    tg = build_model("transformer_lm", **TINY)
    tv = load_flax_variables(tg, jv, device="cpu")
    row = np.array(ids[0])
    port = ServeEngine(tg, tv, slots=2, cache_len=32, decode_block=4,
                       device="cpu")
    rids = {n: port.submit(row[:n], max_new_tokens=b)
            for n, b in LONGEST.items()}
    port.step()
    port.step()
    snap = json.loads(json.dumps(port.snapshot()))
    jax_engine = JaxServeEngine.restore(snap, jg, jv, slots=2,
                                        decode_block=4)
    out = jax_engine.run()
    streams = {n: np.asarray(out[r].tokens) for n, r in rids.items()}
    port_out = port.run()
    return (jg, jv, tg, tv, row, streams, snap,
            {n: port_out[r].tokens for n, r in rids.items()})


def _want(streams, n, budget):
    assert budget <= LONGEST[n]
    return streams[n][:n + budget]


def _engine(lm, **kw):
    return ServeEngine(lm[2], lm[3], device="cpu", **kw)


def _assert_completed_like_jax(lm, results, rid, n, budget):
    assert results[rid].status == "completed", results[rid].status
    np.testing.assert_array_equal(results[rid].tokens,
                                  _want(lm[5], n, budget),
                                  err_msg=f"request {rid}")


# -- the port snapshot on the JAX engine -----------------------------------


def test_port_snapshot_passes_jax_restore_with_equal_streams(lm):
    """A mid-run port snapshot (active requests with emitted tokens, one
    still queued) passes the JAX engine's checksum; the restored JAX
    engine finished every stream equal to the port's uncrashed run."""
    snap, port_streams, streams = lm[6], lm[7], lm[5]
    assert snap["active"] and snap["queued"]
    assert snap["checksum"] == jax_integrity.json_checksum(snap)
    for n in LONGEST:
        np.testing.assert_array_equal(port_streams[n], streams[n])
    bad = integrity.flip_bit_json(snap, 3)
    with pytest.raises(jax_integrity.SnapshotCorruption):
        JaxServeEngine.restore(bad, lm[0], lm[1])


# -- injector unit tests (pure host, no engine) ----------------------------


def test_fault_schedule_deterministic():
    inj = FaultInjector([Fault("serve.decode", "transient", times=2)])
    with pytest.raises(TransientFault):
        inj.fire("serve.decode", tick=0)
    with pytest.raises(TransientFault):
        inj.fire("serve.decode", tick=1)
    inj.fire("serve.decode", tick=2)   # entry spent: silent
    inj.fire("serve.prefill", tick=0)  # wrong site: never fires
    assert inj.counts == {"transient": 2}
    assert inj.injected_total == 2


def test_fault_schedule_pinning():
    inj = FaultInjector([Fault("serve.prefill", "oom", tick=3, request=7)])
    inj.fire("serve.prefill", tick=3, request=5)  # wrong request
    inj.fire("serve.prefill", tick=2, request=7)  # wrong tick
    inj.fire("serve.prefill", tick=3)             # no request context
    with pytest.raises(ResourceExhausted, match="RESOURCE_EXHAUSTED"):
        inj.fire("serve.prefill", tick=3, request=7)
    assert inj.injected_total == 1


def test_seeded_rates_replay_the_jax_injectors_draws():
    from mmlspark_tpu.core.faults import FaultInjector as JaxInjector

    def run(cls, seed):
        inj = cls(seed=seed, rates={"transient": 0.3, "oom": 0.1})
        fired = []
        for t in range(60):
            try:
                inj.fire("serve.decode", tick=t)
                fired.append(0)
            except Exception as e:  # noqa: BLE001 — the kind is the record
                fired.append(type(e).__name__)
        return fired

    assert run(FaultInjector, 7) == run(FaultInjector, 7)
    assert run(FaultInjector, 7) != run(FaultInjector, 8)
    assert 0 < sum(x != 0 for x in run(FaultInjector, 7)) < 60
    # one spec replays the same faults on both frameworks
    assert run(FaultInjector, 7) == run(JaxInjector, 7)


def test_injector_and_fault_validation():
    with pytest.raises(FriendlyError, match="seed"):
        FaultInjector(rates={"transient": 0.5})
    with pytest.raises(FriendlyError, match="rate"):
        FaultInjector(seed=0, rates={"transient": 1.5})
    with pytest.raises(FriendlyError, match="kind"):
        FaultInjector(seed=0, rates={"nope": 0.1})
    with pytest.raises(FriendlyError, match="site"):
        Fault("bad.site", "transient")
    with pytest.raises(FriendlyError, match="kind"):
        Fault("serve.decode", "nope")


def test_parse_fault_spec():
    inj = parse_fault_spec("seed=7, transient=0.05,oom=0.02,stall_s=0.002")
    assert inj.rates == {"transient": 0.05, "oom": 0.02}
    assert inj.stall_s == 0.002
    with pytest.raises(FriendlyError, match="fault spec"):
        parse_fault_spec("transient")
    with pytest.raises(FriendlyError, match="key"):
        parse_fault_spec("bogus=1")
    with pytest.raises(FriendlyError, match="value"):
        parse_fault_spec("transient=lots")


def test_classifiers_cover_injected_and_real_spellings():
    assert is_transient(TransientFault("x"))
    assert not is_transient(ResourceExhausted("x"))
    assert not is_transient(EngineKilled("x"))
    assert is_resource_exhausted(ResourceExhausted("x"))
    assert is_resource_exhausted(RuntimeError("RESOURCE_EXHAUSTED: pool"))

    class XlaRuntimeError(RuntimeError):
        pass

    assert is_transient(XlaRuntimeError("UNAVAILABLE: link down"))
    assert is_transient(XlaRuntimeError("DEADLINE_EXCEEDED: slow"))
    assert not is_transient(XlaRuntimeError("INTERNAL: compiler bug"))
    assert not is_transient(RuntimeError("UNAVAILABLE"))
    # the card's own spellings: an OOM, also wrapped by a failed capture
    # (compile_guard chains it), is resource exhaustion; a sticky CUDA
    # error is neither
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert is_resource_exhausted(oom) and not is_transient(oom)
    try:
        try:
            raise oom
        except Exception as e:
            raise RuntimeError("serve.decode: the program failed to "
                               "capture as a CUDA graph") from e
    except RuntimeError as wrapped:
        assert is_resource_exhausted(wrapped)
    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    assert not is_transient(sticky) and not is_resource_exhausted(sticky)


# -- transient retry: invisible to results ---------------------------------


def test_transient_faults_retry_transparently(lm):
    row = lm[4]
    inj = FaultInjector([
        Fault("serve.decode", "transient", times=2),
        Fault("serve.prefill", "transient", times=1),
        Fault("serve.device_get", "transient", times=1),
    ])
    engine = _engine(lm, slots=2, cache_len=32, decode_block=4, faults=inj,
                     retry_backoff_s=0.0)
    rids = [engine.submit(row[:n], max_new_tokens=6) for n in (4, 5, 6)]
    results = engine.run()
    for rid, n in zip(rids, (4, 5, 6)):
        _assert_completed_like_jax(lm, results, rid, n, 6)
    assert engine.metrics.retries_total == 4
    assert engine.metrics.faults_injected_total == 4
    assert engine.metrics.failed == 0
    assert engine.metrics.quarantined_total == 0


def test_stall_fault_slows_but_never_fails(lm):
    row = lm[4]
    inj = FaultInjector([Fault("serve.decode", "stall", times=2)],
                        stall_s=0.001)
    engine = _engine(lm, slots=2, cache_len=32, decode_block=2, faults=inj)
    rid = engine.submit(row[:4], max_new_tokens=6)
    results = engine.run()
    _assert_completed_like_jax(lm, results, rid, 4, 6)
    assert inj.counts.get("stall") == 2
    assert engine.metrics.retries_total == 0


# -- quarantine: blast radius is one request -------------------------------


def test_prefill_fault_beyond_retries_quarantines_one_request(lm):
    row = lm[4]
    inj = FaultInjector([
        Fault("serve.prefill", "transient", request=1, times=10),
    ])
    engine = _engine(lm, slots=2, cache_len=32, decode_block=4, faults=inj,
                     retry_limit=2, retry_backoff_s=0.0)
    rids = [engine.submit(row[:n], max_new_tokens=5) for n in (4, 5, 6)]
    results = engine.run()
    assert results[rids[1]].status == "failed"
    assert results[rids[1]].generated == 0
    for rid, n in ((rids[0], 4), (rids[2], 6)):
        _assert_completed_like_jax(lm, results, rid, n, 5)
    assert engine.metrics.quarantined_total == 1
    assert engine.metrics.failed == 1
    assert engine.pool.leased_count == 0 and not engine.busy


def test_prefill_poison_quarantines_before_results(lm):
    row = lm[4]
    inj = FaultInjector([Fault("serve.prefill", "poison", request=0)])
    engine = _engine(lm, slots=2, cache_len=32, faults=inj)
    rid_bad = engine.submit(row[:4], max_new_tokens=5)
    rid_ok = engine.submit(row[:5], max_new_tokens=5)
    results = engine.run()
    assert results[rid_bad].status == "failed"
    assert results[rid_bad].generated == 0
    _assert_completed_like_jax(lm, results, rid_ok, 5, 5)
    assert engine.metrics.quarantined_total == 1


@pytest.mark.parametrize("async_host", [False, True], ids=["sync", "async"])
def test_decode_poison_quarantines_only_that_row(lm, async_host):
    """The same poisoned block on the port and the JAX engine (one fault
    schedule): the same request fails with the same pre-fault tokens,
    the others complete with the JAX streams, and the quarantined slot is
    re-leasable."""
    jg, jv, row = lm[0], lm[1], lm[4]
    lengths = (4, 5, 6)

    def run(engine_cls, fault_cls, injector_cls, **kw):
        inj = injector_cls([fault_cls("serve.device_get", "poison",
                                      tick=1, times=1)])
        engine = engine_cls(slots=2, cache_len=32, decode_block=2,
                            faults=inj, async_host=async_host, **kw)
        rids = [engine.submit(row[:n], max_new_tokens=8) for n in lengths]
        return engine, rids, engine.run()

    engine, rids, results = run(lambda **kw: _engine(lm, **kw), Fault,
                                FaultInjector)
    statuses = [results[r].status for r in rids]
    assert statuses.count("failed") == 1
    assert engine.metrics.quarantined_total == 1
    for rid, n in zip(rids, lengths):
        res = results[rid]
        if res.status == "failed":
            assert all(0 <= int(t) < VOCAB for t in res.tokens)
            assert res.generated < 8
            np.testing.assert_array_equal(
                res.tokens, _want(lm[5], n, res.generated))
        else:
            _assert_completed_like_jax(lm, results, rid, n, 8)
    if not async_host:
        from mmlspark_tpu.core.faults import Fault as JaxFault
        from mmlspark_tpu.core.faults import FaultInjector as JaxInjector

        _, jrids, jresults = run(
            lambda **kw: JaxServeEngine(jg, jv, **kw), JaxFault,
            JaxInjector)
        for rid, jrid in zip(rids, jrids):
            assert results[rid].status == jresults[jrid].status
            np.testing.assert_array_equal(
                results[rid].tokens, np.asarray(jresults[jrid].tokens))
    rid2 = engine.submit(row[:4], max_new_tokens=4)
    res2 = engine.run()
    _assert_completed_like_jax(lm, res2, rid2, 4, 4)


# -- graceful degradation under memory pressure ----------------------------


def test_oom_steps_down_ladder_and_recovers(lm):
    row = lm[4]
    inj = FaultInjector([Fault("serve.decode", "oom", times=2)])
    engine = _engine(lm, slots=2, cache_len=32, decode_block=8, faults=inj,
                     retry_limit=3, retry_backoff_s=0.0,
                     degrade_recover_ticks=2)
    rids = [engine.submit(row[:4], max_new_tokens=20),
            engine.submit(row[:5], max_new_tokens=20)]
    with serve_compile_guard(engine, min_decode=1):
        results = engine.run()
    for rid, n in zip(rids, (4, 5)):
        _assert_completed_like_jax(lm, results, rid, n, 20)
    # two OOMs walked the cap 8 -> 4 -> 2: the degraded block ran a
    # SMALLER ladder size, and the probe re-escalated by the end
    assert "2" in engine.metrics.decode_blocks
    assert inj.counts.get("oom") == 2
    assert not engine.degraded
    assert engine.metrics.to_dict()["degraded_mode"] == 0
    assert engine.metrics.faults_by_kind.get("oom") == 2


def test_oom_at_ladder_floor_preempts_and_resumes(lm):
    row = lm[4]
    inj = FaultInjector([Fault("serve.decode", "oom", times=2)])
    engine = _engine(lm, slots=2, cache_len=32, decode_block=1, faults=inj,
                     retry_limit=3, retry_backoff_s=0.0,
                     degrade_recover_ticks=2)
    rid_a = engine.submit(row[:4], max_new_tokens=6)
    rid_b = engine.submit(row[:5], max_new_tokens=6)
    results = engine.run()
    assert engine.metrics.preemptions_total >= 1
    for rid, n in ((rid_a, 4), (rid_b, 5)):
        _assert_completed_like_jax(lm, results, rid, n, 6)
    assert not engine.degraded


# -- crash drill: kill mid-run, restore ------------------------------------


def test_crash_drill_restore_is_bit_identical(lm):
    row = lm[4]
    lengths = (4, 5, 6, 3)
    inj = FaultInjector([Fault("serve.decode", "kill", tick=2)])
    engine = _engine(lm, slots=2, cache_len=32, decode_block=2, faults=inj)
    rids = [engine.submit(row[:n], max_new_tokens=8) for n in lengths]
    results = {}
    snap = engine.snapshot()
    with pytest.raises(EngineKilled):
        while engine.busy:
            snap = engine.snapshot()  # checkpoint BEFORE each tick
            for res in engine.step():
                results[res.id] = res
    json.dumps(snap)
    assert snap["active"] or snap["queued"]
    rebuilt = ServeEngine.restore(snap, lm[2], lm[3], slots=2,
                                  decode_block=2, device="cpu")
    assert rebuilt.tick == snap["tick"]
    results.update(rebuilt.run())
    assert set(results) == set(rids)
    for rid, n in zip(rids, lengths):
        _assert_completed_like_jax(lm, results, rid, n, 8)
    assert rebuilt.submit(row[:4], max_new_tokens=2) == max(rids) + 1


def test_restore_guards(lm):
    engine = _engine(lm, slots=2, cache_len=32)
    snap = engine.snapshot()
    with pytest.raises(SnapshotCorruption, match="checksum"):
        ServeEngine.restore({**snap, "version": 99}, lm[2], lm[3],
                            device="cpu")
    unstamped = {k: val for k, val in snap.items() if k != "checksum"}
    with pytest.raises(FriendlyError, match="version"):
        ServeEngine.restore({**unstamped, "version": 99}, lm[2], lm[3],
                            device="cpu")
    with pytest.raises(FriendlyError, match="model"):
        ServeEngine.restore({**unstamped, "model": "other_lm"}, lm[2],
                            lm[3], device="cpu")
    rebuilt = ServeEngine.restore(snap, lm[2], lm[3], slots=2,
                                  device="cpu")
    assert not rebuilt.busy and rebuilt.tick == engine.tick


def test_cancel_queued_active_and_filling(lm):
    """``cancel`` removes a queued, an active and a mid-fill request
    without a result, frees their slots, and the rest complete."""
    row = lm[4]
    engine = _engine(lm, slots=2, cache_len=32, decode_block=2,
                     prefill_chunk=8, async_host=True)
    a = engine.submit(row[:4], max_new_tokens=8)
    b = engine.submit(row[:6], max_new_tokens=8)
    c = engine.submit(row[:5], max_new_tokens=8)
    engine.step()
    engine.step()
    assert engine.cancel(c) == 0  # still queued
    assert engine.cancel(a) > 0   # active, tokens discarded
    assert engine.cancel(12345) is None
    results = engine.run()
    assert set(results) == {b}
    _assert_completed_like_jax(lm, results, b, 6, 8)
    assert engine.metrics.cancelled_total == 2
    f = engine.submit(row[:12], max_new_tokens=4)  # two chunks
    g = engine.submit(row[:4], max_new_tokens=4)
    engine.step()
    assert [fs.req.id for fs in engine._sched.filling.values()] == [f]
    assert engine.cancel(f) == 0
    results = engine.run()
    assert set(results) == {g} and engine.pool.leased_count == 0


# -- seeded chaos soak -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_soak_single_device(lm, seed):
    tg, tv, row = lm[2], lm[3], lm[4]
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, 9, size=8)
    budgets = rng.integers(3, 11, size=8)
    prompts = [row[:int(n)] for n in lengths]
    inj = FaultInjector(
        seed=seed,
        rates={"transient": 0.08, "oom": 0.04, "stall": 0.02,
               "poison": 0.04},
        stall_s=0.0005,
    )
    engine = _engine(lm, slots=2, cache_len=32, max_queue=16,
                     decode_block=4, faults=inj, retry_limit=2,
                     retry_backoff_s=0.0, degrade_recover_ticks=3)
    results, rids = {}, []
    with serve_compile_guard(engine, min_decode=1, min_prefill=1):
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            rids.append(engine.submit(p, max_new_tokens=int(n)))
            if i % 2:
                results.update({r.id: r for r in engine.step()})
        results.update(engine.run())
    assert set(results) == set(rids)
    n_completed = 0
    for rid, p, n in zip(rids, prompts, budgets):
        res = results[rid]
        assert res.status in TERMINAL, (rid, res.status)
        if res.status == "completed":
            n_completed += 1
            want = generate(tg, tv, p[None], int(n), device="cpu")[0]
            np.testing.assert_array_equal(
                res.tokens, want.numpy(),
                err_msg=f"seed={seed} request={rid}")
    assert n_completed >= 1
    assert engine.metrics.faults_injected_total == inj.injected_total
    assert engine.pool.leased_count == 0 and not engine.busy
    md = engine.metrics.to_dict()
    assert (md["completed"] + md["expired"] + md["failed"]
            + md["stalled"]) == len(rids)


# -- zero-overhead contract -------------------------------------------------


def test_disabled_injection_compiles_same_program_set(lm):
    """``faults=None`` makes the same program set as an engine with the
    injector on but nothing firing: one decode program per ladder size
    run, one prefill program per bucket hit."""
    row = lm[4]
    counts = []
    for faults in (None, FaultInjector()):
        engine = _engine(lm, slots=2, cache_len=32, decode_block=4,
                         faults=faults)
        with serve_compile_guard(engine, min_decode=1, min_prefill=1):
            rids = [engine.submit(row[:n], max_new_tokens=6)
                    for n in (4, 6)]
            results = engine.run()
        for rid, n in zip(rids, (4, 6)):
            _assert_completed_like_jax(lm, results, rid, n, 6)
        assert engine.metrics.retries_total == 0
        assert engine.metrics.faults_injected_total == 0
        assert engine.metrics.to_dict()["degraded_mode"] == 0
        counts.append((engine.decode_compile_count,
                       engine.prefill_compile_count))
    assert counts[0] == counts[1]


# -- integrity (the serve cases of tests/test_integrity.py) ----------------


def test_json_checksum_detects_snapshot_bit_flips():
    snap = {"version": 3, "tick": 41, "slots": [1, 0, 7],
            "nested": {"tokens": [5, 6, 7], "done": False}}
    snap["checksum"] = integrity.json_checksum(snap)
    assert integrity.json_checksum(snap) == snap["checksum"]
    assert snap["checksum"] == jax_integrity.json_checksum(snap)
    for seed in (0, 5, 23):
        bad = integrity.flip_bit_json(snap, seed)
        assert bad == jax_integrity.flip_bit_json(snap, seed)
        assert integrity.json_checksum(bad) != bad["checksum"], seed


def test_typed_errors_name_both_hashes():
    e = CheckpointCorruption(7, expected="aa" * 32, actual="bb" * 32)
    assert isinstance(e, IntegrityError)
    assert e.step == 7
    assert "aa" * 32 in str(e) and "bb" * 32 in str(e)
    s = SnapshotCorruption(expected="cafe", actual="beef")
    assert isinstance(s, IntegrityError)
    assert "cafe" in str(s) and "beef" in str(s)


def test_host_fold_payload_and_dir_hashes_equal_the_jax_package(tmp_path):
    """The host fold, the payload and directory sha256s and the seeded
    array flip agree with the JAX package's on the same values (bf16
    leaves included, hashed under their raw words)."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(7, 5)).astype(np.float32),
            "emb": {"ids": np.arange(6, dtype=np.int32)}}
    assert integrity.tree_checksum_host(tree) == \
        jax_integrity.tree_checksum_host(tree)
    flipped = integrity.flip_bit_array(tree["w"], 4)
    np.testing.assert_array_equal(
        flipped, jax_integrity.flip_bit_array(tree["w"], 4))
    kv = rng.normal(size=(2, 4, 8)).astype(np.float32)
    payload = {"prompt": np.arange(5, dtype=np.int32),
               "prefix": np.arange(5, 9, dtype=np.int32), "length": 9,
               "first_token": 3, "kv": {"k": kv}}
    stamp = jax_integrity.payload_checksum(payload)
    assert integrity.payload_checksum(
        dict(payload, kv={"k": torch.from_numpy(kv)})) == stamp
    ok, expected, actual = integrity.verify_payload(
        dict(payload, checksum=stamp))
    assert ok and expected == actual == stamp
    bf = torch.randn(3, 4).to(torch.bfloat16)
    assert integrity.tree_checksum_host({"x": bf}) == \
        integrity.tree_checksum_host({"x": bf.view(torch.int16)})
    (tmp_path / "a").write_bytes(b"xyz")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b").write_bytes(b"12")
    assert integrity.dir_sha256(str(tmp_path)) == \
        jax_integrity.dir_sha256(str(tmp_path))


def test_corrupt_spec_round_trips_and_is_seeded():
    inj = parse_fault_spec("seed=3,train.step:corrupt=0.2")
    fires = {t: inj.corrupt_spec("train.step", tick=t) for t in range(6)}
    seeds = {t: s for t, s in fires.items() if s is not None}
    assert seeds, "the seeded rate stream must fire within 6 ticks"
    assert all(isinstance(s, int) for s in seeds.values())
    inj2 = parse_fault_spec("seed=3,train.step:corrupt=0.2")
    assert fires == {t: inj2.corrupt_spec("train.step", tick=t)
                     for t in range(6)}


def test_scheduled_corrupt_carries_its_value_as_seed():
    inj = FaultInjector([Fault("train.step", "corrupt", tick=2, value=99)])
    assert inj.corrupt_spec("train.step", tick=0) is None
    assert inj.corrupt_spec("train.step", tick=2) == 99


def test_engine_restore_rejects_corrupted_snapshot(lm):
    row = lm[4]
    engine = _engine(lm, slots=2, cache_len=32, decode_block=4)
    engine.submit(row[:5], max_new_tokens=4)
    engine.run()
    snap = engine.snapshot()
    assert snap["checksum"] == integrity.json_checksum(snap)
    for seed in (0, 1, 2):
        bad = integrity.flip_bit_json(snap, seed)
        with pytest.raises(SnapshotCorruption) as exc:
            ServeEngine.restore(bad, lm[2], lm[3], device="cpu")
        assert bad["checksum"] in str(exc.value)
    ServeEngine.restore(snap, lm[2], lm[3], device="cpu")
    legacy = {k: s for k, s in snap.items() if k != "checksum"}
    ServeEngine.restore(legacy, lm[2], lm[3], device="cpu")


def test_clean_kill_soak_zero_integrity_false_positives(lm):
    """Kills with periodic snapshots on (one engine standing in for the
    JAX test's replica set): every recovery restores from a VERIFIED
    ``last_snapshot`` (its stamp re-hashes), a corrupted checkpoint is
    rejected, and the streams equal the JAX engine's."""
    row = lm[4]
    lengths = (5, 6, 4)
    inj = FaultInjector([Fault("serve.decode", "kill", tick=1),
                         Fault("serve.decode", "kill", tick=3)])
    kw = dict(slots=2, cache_len=32, max_queue=8, decode_block=2,
              snapshot_every_ticks=1, faults=inj, retry_backoff_s=0.0,
              device="cpu")
    engine = ServeEngine(lm[2], lm[3], **kw)
    rids = [engine.submit(row[:n], max_new_tokens=8) for n in lengths]
    results, recoveries = {}, 0
    while engine.busy:
        try:
            results.update({r.id: r for r in engine.step()})
        except EngineKilled:
            snap = engine.last_snapshot
            assert snap["checksum"] == integrity.json_checksum(snap)
            engine = ServeEngine.restore(snap, lm[2], lm[3], **kw)
            recoveries += 1
    assert recoveries == 2
    assert engine.metrics.snapshots_total >= 1
    for rid, n in zip(rids, lengths):
        _assert_completed_like_jax(lm, results, rid, n, 8)
    corrupting = FaultInjector([Fault("serve.snapshot", "corrupt", tick=1,
                                      value=5)])
    engine = ServeEngine(lm[2], lm[3], **dict(kw, faults=corrupting))
    engine.submit(row[:5], max_new_tokens=8)
    engine.step()
    with pytest.raises(SnapshotCorruption):
        ServeEngine.restore(engine.last_snapshot, lm[2], lm[3], **kw)


def test_decode_sync_contract_holds_after_verified_restore(lm,
                                                           monkeypatch):
    """After a checksum-verified restore, a request decoding 16 tokens
    through T=8 blocks pays at most one fetch a block, and its stream
    equals the JAX engine's."""
    row = lm[4]
    src = _engine(lm, slots=1, cache_len=32, decode_block=8)
    snap = src.snapshot()
    assert snap["checksum"] == integrity.json_checksum(
        {k: s for k, s in snap.items() if k != "checksum"})
    engine = ServeEngine.restore(snap, lm[2], lm[3], slots=1, cache_len=32,
                                 decode_block=8, device="cpu")
    rid = engine.submit(row[:4], max_new_tokens=17)
    fetches = {"n": 0}
    real = engine._fetch

    def counting(inflight):
        fetches["n"] += 1
        return real(inflight)

    monkeypatch.setattr(engine, "_fetch", counting)
    res = engine.run()
    _assert_completed_like_jax(lm, res, rid, 4, 17)
    assert fetches["n"] <= 2, f"fetches: {fetches['n']} (> 1 per block)"
