"""The port's replicated serving plane against the JAX package, mirroring
the single-device cases of ``tests/test_serve_supervisor.py`` and the
replica cases of ``tests/test_integrity.py``: a ``ReplicaSet`` of
health-checked port engines behind one ``submit()/run()`` facade
survives replica kills, failed health probes, hedged duplicates, drains
and corrupted snapshots, and every final stream equals the JAX single
engine's, exactly one result per request, with every replica's program
pins intact. The 2x2 mesh case is in
``tests/test_torch_serve_mesh_planes.py``; routing by model
(``models=``) is held to the JAX set in ``tests/test_torch_multimodel.py``.

The model is the JAX package's overfit periodic LM bridged into the port
(``tests/test_torch_chunked_async.py``'s fixture), so greedy picks have
wide margins. The reference streams come from ONE JAX engine over every
prompt at its longest budget (a shorter budget's stream is a prefix);
no JAX supervisor runs per test — one JAX ``ReplicaSet`` run gives the
``metrics_dict`` schema.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.serve import ReplicaSet as JaxReplicaSet
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import EngineKilled, Fault, FaultInjector
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.serve import ReplicaSet, ServeEngine
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
LONGEST = {4: 12, 5: 16, 6: 12, 7: 12, 8: 12, 9: 12, 11: 6}


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


def _set(lm, **kw):
    kw.setdefault("retry_backoff_s", 0.0)
    return ReplicaSet(lm[2], lm[3], device="cpu", **kw)


def _prompt(lm, n):
    return lm[4][:n]


def _assert_parity(lm, results, gids, lengths, budgets):
    assert len(results) == len(gids)
    streams = lm[5]
    for gid, n, b in zip(gids, lengths, budgets):
        assert b <= LONGEST[n]
        res = results[gid]
        assert res.status == "completed", f"gid={gid}: {res.status}"
        np.testing.assert_array_equal(res.tokens, streams[n][:n + b],
                                      err_msg=f"gid={gid}")


def _assert_engine_pins(engine):
    assert engine.decode_compile_count <= engine.num_decode_blocks
    assert engine.prefill_compile_count <= engine.num_prefill_buckets


class _FakeClock:
    """Injectable supervisor clock: hedge deadlines and stall probes move
    only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# -- routing ---------------------------------------------------------------


def test_routing_parity_and_load_split(lm):
    """Two replicas behind the facade serve a staggered arrival schedule,
    every stream equal to the JAX engine's; both replicas take work, and
    each engine's program pins hold under the guard."""
    rs = _set(lm, replicas=2, slots=2, cache_len=32, max_queue=8,
              decode_block=4)
    lengths = (5, 9, 4, 7, 6, 8)
    gids = []
    with serve_compile_guard(rs.engine(0), min_decode=1, min_prefill=1), \
            serve_compile_guard(rs.engine(1), min_decode=1,
                                min_prefill=1):
        it = iter(lengths)
        pending = True
        while pending or rs.busy:
            for _ in range(2):
                n = next(it, None)
                if n is None:
                    pending = False
                    break
                gids.append(rs.submit(_prompt(lm, n), 6))
            rs.step()
        results = rs.run()
    _assert_parity(lm, results, gids, lengths, [6] * 6)
    per = rs.metrics_dict()["per_replica"]
    assert per["replica0"]["submitted"] > 0
    assert per["replica1"]["submitted"] > 0
    assert rs.replica_failovers_total == 0


def test_submit_validation_and_global_ids(lm):
    rs = _set(lm, replicas=2, slots=2, cache_len=32, max_queue=2)
    with pytest.raises(FriendlyError, match="non-empty"):
        rs.submit(np.zeros(0, np.int32), 4)
    assert (rs.submit([1, 2, 3], 4), rs.submit([1, 2, 3], 4)) == (0, 1)
    with pytest.raises(FriendlyError, match="replicas must be"):
        _set(lm, replicas=0)
    with pytest.raises(FriendlyError, match="hedge_ms"):
        _set(lm, replicas=2, hedge_ms=-1.0)
    with pytest.raises(FriendlyError, match="managed by ReplicaSet"):
        _set(lm, replicas=2, replica=0)
    # models= routes by model now (tests/test_torch_multimodel.py); its
    # construction is validated like the JAX set's
    with pytest.raises(FriendlyError, match="at least one model"):
        _set(lm, replicas=2, models={})
    with pytest.raises(FriendlyError, match="model="):
        _set(lm, replicas=2, models={"a": (lm[2], lm[3])}).submit(
            [1, 2, 3], 4)
    with pytest.raises(FriendlyError, match="replica index must be"):
        ServeEngine(lm[2], lm[3], replica=-1, device="cpu")


# -- failover --------------------------------------------------------------


def test_kill_failover_equal_streams(lm):
    """Kill replica 0 mid-decode-block: run() still completes every
    request with the JAX engine's stream, the pins intact. Mixed budgets
    make some requests complete between the snapshot and the kill, so
    the reconciliation's exactly-once cancel runs too."""
    inj = FaultInjector([Fault("serve.decode", "kill", tick=3, replica=0)])
    rs = _set(lm, replicas=2, slots=4, cache_len=32, max_queue=8,
              decode_block=2, snapshot_every_ticks=2, faults=inj)
    lengths = (5, 9, 4, 7, 6, 8)
    budgets = (12, 3, 12, 3, 12, 12)
    gids = [rs.submit(_prompt(lm, n), b) for n, b in zip(lengths, budgets)]
    dead = rs.engine(0)
    results = rs.run()
    assert rs.replica_failovers_total == 1
    _assert_parity(lm, results, gids, lengths, budgets)
    for i in range(2):
        _assert_engine_pins(rs.engine(i))
    assert rs.engine(0) is not dead and dead._dead
    assert rs.replica_state(0) in ("healthy", "degraded")
    md = rs.metrics_dict()
    assert md["replica_failovers_total"] == 1
    assert md["per_replica"]["replica0"]["failovers"] == 1


def test_health_probe_fault_fails_over(lm):
    inj = FaultInjector([Fault("serve.health", "transient", replica=0)])
    rs = _set(lm, replicas=2, slots=2, cache_len=32, max_queue=8,
              decode_block=2, snapshot_every_ticks=1, faults=inj)
    lengths = (5, 9, 4)
    gids = [rs.submit(_prompt(lm, n), 8) for n in lengths]
    results = rs.run()
    assert rs.replica_failovers_total == 1
    _assert_parity(lm, results, gids, lengths, [8] * 3)


def test_max_failovers_caps_the_rebuild_loop(lm):
    inj = FaultInjector([Fault("serve.decode", "kill", times=10)])
    rs = _set(lm, replicas=1, slots=2, cache_len=32, max_queue=4,
              decode_block=2, max_failovers=2, snapshot_every_ticks=1,
              faults=inj)
    rs.submit(_prompt(lm, 5), 8)
    with pytest.raises(FriendlyError, match="max_failovers"):
        rs.run()
    assert rs.replica_failovers_total == 3  # 2 absorbed + the fatal one


def test_stalled_replica_fails_over_on_the_probe_clock(lm):
    """A busy replica whose token count stops moving for longer than
    ``probe_stall_s`` (on the injected clock) fails over; its request
    still completes with the JAX engine's stream. (The idle replica
    counts as progressing.)"""
    clk = _FakeClock()
    rs = _set(lm, replicas=2, slots=2, cache_len=32, max_queue=8,
              decode_block=2, probe_stall_s=5.0, clock=clk,
              snapshot_every_ticks=1)
    lengths = (5,)
    gids = [rs.submit(_prompt(lm, n), 12) for n in lengths]
    rs.step()
    stuck = rs.engine(0)
    real = stuck.health_counters

    def frozen():
        h = real()
        h["tokens_generated"] = 0
        return h

    stuck.health_counters = frozen
    rs.step()
    clk.t = 10.0
    results = rs.run()
    assert rs.replica_failovers_total == 1
    assert rs.engine(0) is not stuck
    assert any(e["name"] == "failover"
               and e["attrs"]["reason"] == "stalled"
               for e in rs.recorder.events())
    _assert_parity(lm, results, gids, lengths, [12])


# -- hedging ---------------------------------------------------------------


def test_hedging_first_committed_wins_exactly_once(lm):
    clk = _FakeClock()
    rs = _set(lm, replicas=2, slots=2, cache_len=32, max_queue=8,
              decode_block=2, hedge_ms=50.0, clock=clk,
              snapshot_every_ticks=None)
    gid = rs.submit(_prompt(lm, 6), 12)
    rs.step()  # below the deadline: no hedge yet
    assert rs.hedges_total == 0
    clk.t = 0.2  # 200 ms of queue age > the 50 ms deadline
    results = rs.run()
    assert rs.hedges_total == 1 and rs.hedge_wasted_tokens_total > 0
    assert list(results) == [gid]
    _assert_parity(lm, results, [gid], [6], [12])
    md = rs.metrics_dict()
    assert md["hedges_total"] == 1
    assert sum(md["per_replica"][f"replica{i}"]["cancelled_total"]
               for i in range(2)) == 1
    # both copies carry the one trace id
    traces = {e["attrs"]["trace"] for i in range(2)
              for e in rs.engine(i).recorder.events()
              if e["name"] == "start"}
    assert traces == {f"g{gid}"}


def test_hedge_needs_a_second_live_replica(lm):
    clk = _FakeClock()
    rs = _set(lm, replicas=1, slots=2, cache_len=32, max_queue=8,
              decode_block=2, hedge_ms=1.0, clock=clk)
    gid = rs.submit(_prompt(lm, 5), 6)
    clk.t = 10.0
    results = rs.run()
    assert rs.hedges_total == 0
    _assert_parity(lm, results, [gid], [5], [6])


# -- drain -----------------------------------------------------------------


def test_drain_under_load_migrates_with_equal_streams(lm):
    rs = _set(lm, replicas=2, slots=4, cache_len=32, max_queue=8,
              decode_block=2, snapshot_every_ticks=2)
    lengths = (5, 9, 4, 7)
    gids = [rs.submit(_prompt(lm, n), 12) for n in lengths]
    rs.step()
    rs.step()
    before = rs.engine(1).metrics.submitted
    rs.drain(0)
    assert rs.replica_state(0) in ("draining", "drained")
    assert rs.engine(1).metrics.submitted > before  # migration landed
    g_late = rs.submit(_prompt(lm, 5), 12)  # routes around the drain
    results = rs.run()
    assert rs.replica_state(0) == "drained" and rs.drains_total == 1
    _assert_parity(lm, results, gids + [g_late], lengths + (5,), [12] * 5)
    with pytest.raises(FriendlyError, match="already"):
        rs.drain(0)


def test_drain_last_replica_finishes_in_place(lm):
    rs = _set(lm, replicas=1, slots=2, cache_len=32, max_queue=8,
              decode_block=2)
    gid = rs.submit(_prompt(lm, 5), 8)
    rs.drain(0)
    results = rs.run()
    _assert_parity(lm, results, [gid], [5], [8])
    rs.step()  # the idle draining replica retires on the next tick
    assert rs.replica_state(0) == "drained" and rs.drains_total == 1
    with pytest.raises(FriendlyError, match="no live replica"):
        rs.submit(_prompt(lm, 5), 4)


def test_run_bound_stalls_open_requests(lm):
    rs = _set(lm, replicas=1, slots=2, cache_len=32, max_queue=8,
              decode_block=2)
    p = _prompt(lm, 5)
    gid = rs.submit(p, 16)
    with pytest.raises(FriendlyError, match="max_ticks") as ei:
        rs.run(max_ticks=1)
    res = ei.value.results[gid]
    assert res.status == "stalled" and res.generated > 0
    np.testing.assert_array_equal(res.tokens,
                                  lm[5][5][:5 + res.generated])
    assert not rs.busy


# -- the engine's kill parking and torn checkpoints ------------------------


def test_engine_killed_parks_resources_deterministically(lm):
    """An EngineKilled escaping run() leaves no leased slot behind, every
    paged mapping released (refcounts back to the prefix cache's own),
    the captured programs released (the counts kept); the dead engine
    refuses steps, and an in-process restore completes every stream."""
    inj = FaultInjector([Fault("serve.decode", "kill", tick=2)])
    engine = ServeEngine(lm[2], lm[3], slots=2, cache_len=32, max_queue=8,
                         decode_block=2, paged=True, prefix_cache=True,
                         snapshot_every_ticks=1, faults=inj,
                         retry_backoff_s=0.0, device="cpu")
    lengths = (9, 4, 11)
    rids = [engine.submit(_prompt(lm, n), 6) for n in lengths]
    with pytest.raises(EngineKilled):
        engine.run()
    assert engine.pool.leased_count == 0
    total, mapped = engine.pool.refcount_audit()
    assert total == mapped
    assert sum(engine.pool.snapshot()["npages"]) == 0
    programs = engine.prefill_compile_count
    assert programs > 0 and engine.decode_compile_count > 0
    assert all(p is None for p in engine._prefill_program._fn._programs
               .values())
    with pytest.raises(FriendlyError, match="killed"):
        engine.step()
    assert engine.cancel(rids[0]) is None
    assert engine.steal_all() == [] and engine.take_handoffs() == []
    rebuilt = ServeEngine.restore(engine.last_snapshot, lm[2], lm[3],
                                  slots=2, max_queue=8, decode_block=2,
                                  paged=True, prefix_cache=True,
                                  device="cpu")
    results = rebuilt.run()
    _assert_parity(lm, results, rids, lengths, [6] * 3)


def test_snapshot_fault_keeps_previous_checkpoint(lm):
    inj = FaultInjector([Fault("serve.snapshot", "transient", tick=3)])
    engine = ServeEngine(lm[2], lm[3], slots=2, cache_len=32, max_queue=8,
                         decode_block=2, faults=inj, retry_backoff_s=0.0,
                         device="cpu")
    lengths = (5, 9)
    rids = [engine.submit(_prompt(lm, n), 10) for n in lengths]
    engine.step()
    engine.step()
    good = engine.checkpoint()
    assert good is not None and engine.metrics.snapshots_total == 1
    engine.step()
    assert engine.checkpoint() is None  # the fault tears this one
    assert engine.last_snapshot is good
    assert engine.metrics.snapshot_failures_total == 1
    rebuilt = ServeEngine.restore(engine.last_snapshot, lm[2], lm[3],
                                  slots=2, max_queue=8, decode_block=2,
                                  device="cpu")
    _assert_parity(lm, rebuilt.run(), rids, lengths, [10] * 2)


# -- integrity: replica snapshots --------------------------------------------


def test_snapshot_corrupt_failover_falls_back_to_a_fresh_engine(lm):
    """A corrupted snapshot and a same-tick kill: the failover refuses the
    snapshot, rebuilds a FRESH engine, re-admits the in-flight prompts,
    and the streams stay equal to the JAX engine's."""
    inj = FaultInjector([
        Fault("serve.snapshot", "corrupt", tick=1, replica=1),
        Fault("serve.decode", "kill", tick=1, replica=1),
    ])
    rs = _set(lm, replicas=2, slots=2, cache_len=32, max_queue=8,
              decode_block=2, snapshot_every_ticks=1, faults=inj)
    lengths = (5, 9, 4)
    gids = [rs.submit(_prompt(lm, n), 10) for n in lengths]
    results = rs.run()
    md = rs.metrics_dict()
    assert md["integrity_snapshot_checksum_failures_total"] == 1
    assert rs.replica_failovers_total >= 1
    _assert_parity(lm, results, gids, lengths, [10] * 3)
    assert any(e["name"] == "integrity.snapshot_checksum"
               for e in rs.recorder.events())


def test_clean_chaos_zero_integrity_false_positives(lm):
    inj = FaultInjector([Fault("serve.decode", "kill", tick=1, replica=0)])
    rs = _set(lm, replicas=2, slots=2, cache_len=32, max_queue=8,
              decode_block=2, snapshot_every_ticks=1, faults=inj)
    lengths = (5, 9, 4)
    gids = [rs.submit(_prompt(lm, n), 8) for n in lengths]
    results = rs.run()
    assert rs.replica_failovers_total >= 1
    assert rs.metrics_dict()[
        "integrity_snapshot_checksum_failures_total"] == 0
    _assert_parity(lm, results, gids, lengths, [8] * 3)


# -- the metrics surface -----------------------------------------------------


def _keys(d):
    return {k: _keys(v) if k == "per_replica" else None
            for k, v in d.items()} if isinstance(d, dict) else None


def test_metrics_dict_schema_equals_the_jax_package(lm):
    """The same one-request run gives ``metrics_dict()`` key sets equal to
    the JAX ReplicaSet's, flat and per replica, and the replicas'
    registries namespace their serve counters."""
    jg, jv = lm[:2]
    jrs = JaxReplicaSet(jg, jv, replicas=2, slots=2, cache_len=32,
                        max_queue=8, decode_block=2, retry_backoff_s=0.0)
    jrs.submit(_prompt(lm, 5), 4)
    jrs.run()
    rs = _set(lm, replicas=2, slots=2, cache_len=32, max_queue=8,
              decode_block=2)
    gid = rs.submit(_prompt(lm, 5), 4)
    rs.run()
    md, ref = rs.metrics_dict(), jrs.metrics_dict()
    assert set(md) == set(ref)
    assert set(md["per_replica"]) == set(ref["per_replica"])
    for name, sub in md["per_replica"].items():
        assert set(sub) == set(ref["per_replica"][name])
    assert md["completed"] == 1 and gid == 0
    json.dumps(md, default=str)
    names = rs.engine(0).metrics.registry.names()
    assert any(n.startswith("replica0.serve.") for n in names)
    prom = rs.engine(1).metrics.registry.to_prometheus()
    assert "replica1_serve_submitted_total" in prom
