"""The port's disaggregated prefill/decode fleet against the JAX package,
mirroring the single-device cases of ``tests/test_serve_fleet.py``, the
hand-off cases of ``tests/test_integrity.py`` and the disaggregated case
of ``tests/test_chunked_async.py``: a ``DisaggFleet`` of port engines
serves every stream equal to the JAX single engine's — dense, int8 KV,
paged with the prefix cache, chunked — with the decode replicas adopting
every hand-off by direct KV write (no prefill program) and the prefill
replica running no decode block; it survives ``serve.handoff`` faults
(retry, then a full-prefill fallback), corrupted payloads, kills of
either role and drains; the fleet-wide prefix index turns a repeat
prompt into a decode-only request with every pool's refcounts conserved;
the autoscaler grows a role under load and drains back; and fleet
snapshots (JSON, no K/V) restore across the frameworks both ways. The
2x2 mesh cases are ``tests/test_torch_serve_mesh_planes.py``'s.

The model is the JAX package's overfit periodic LM bridged into the port;
the reference streams come from ONE JAX engine over every prompt at its
longest budget. One JAX fleet run gives the cross-framework snapshot and
the ``metrics_dict`` schema.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.faults import SITES as JAX_SITES
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.serve import DisaggFleet as JaxDisaggFleet
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import (
    SITES,
    Fault,
    FaultInjector,
    parse_fault_spec,
)
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.serve import (
    AutoscalePolicy,
    DisaggFleet,
    ReplicaSet,
    ServeEngine,
)
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
LONGEST = {4: 12, 5: 12, 6: 12, 7: 12, 8: 12, 9: 12, 12: 6}
#: the JAX fleet run: prompts, budget, steps before its snapshot
SNAP_LENGTHS, SNAP_BUDGET, SNAP_STEPS = (5, 9, 4), 12, 4
KW = dict(slots=2, cache_len=32, max_queue=8, decode_block=4,
          retry_backoff_s=0.0)


@pytest.fixture(scope="module")
def lm():
    """(jax graph, jax variables, port graph, port variables, row, JAX
    streams {prompt length: prompt + LONGEST tokens}, the JAX fleet's
    snapshot after SNAP_STEPS ticks, its final metrics_dict)."""
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
    jfleet = JaxDisaggFleet(jg, jv, prefill_replicas=1, decode_replicas=1,
                            **dict(KW, decode_block=2))
    for n in SNAP_LENGTHS:
        jfleet.submit(row[:n], SNAP_BUDGET)
    for _ in range(SNAP_STEPS):
        jfleet.step()
    snap = json.loads(json.dumps(jfleet.snapshot()))
    jfleet.run()
    return jg, jv, tg, tv, row, streams, snap, jfleet.metrics_dict()


def _fleet(lm, **kw):
    kw = {**KW, **kw}
    return DisaggFleet(lm[2], lm[3], device="cpu", **kw)


def _prompt(lm, n):
    return lm[4][:n]


def _assert_parity(lm, results, gids, lengths, budgets):
    assert len(results) == len(gids)
    for gid, n, b in zip(gids, lengths, budgets):
        assert b <= LONGEST[n]
        res = results[gid]
        assert res.status == "completed", f"gid={gid}: {res.status}"
        np.testing.assert_array_equal(res.tokens, lm[5][n][:n + b],
                                      err_msg=f"gid={gid}")


def _assert_engine_pins(engine):
    assert engine.decode_compile_count <= engine.num_decode_blocks
    assert engine.prefill_compile_count <= engine.num_prefill_buckets


def _assert_pool_audits(fleet):
    """The allocator's conservation law on every live paged pool, and the
    fleet index's refs == open indexed requests."""
    for rep in fleet._reps:
        pool = rep.engine.pool
        if hasattr(pool, "refcount_audit"):
            total, mapped = pool.refcount_audit()
            assert total == mapped, (rep.idx, rep.role, total, mapped)
    stats = fleet.prefix_index_stats()
    assert stats["refs_total"] == stats["open_indexed"], stats


# -- streams against the JAX engine ----------------------------------------


def test_disagg_streams_equal_the_jax_engine(lm):
    """1 prefill + 1 decode replica, ragged prompts with mid-run joins:
    every stream equals the JAX engine's; the decode replica made no
    prefill program (every request arrived as a hand-off) and the
    prefill replica no decode block."""
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=1)
    lengths = (5, 9, 4, 7, 6, 8)
    with serve_compile_guard(fleet.engine(0), min_prefill=1), \
            serve_compile_guard(fleet.engine(1), min_decode=1):
        gids = [fleet.submit(_prompt(lm, n), 6) for n in lengths[:4]]
        for _ in range(2):
            fleet.step()
        gids += [fleet.submit(_prompt(lm, n), 6) for n in lengths[4:]]
        results = fleet.run()
    _assert_parity(lm, results, gids, lengths, [6] * 6)
    assert fleet.engine(1).prefill_compile_count == 0
    assert fleet.engine(0).decode_compile_count == 0
    assert fleet.handoffs_total == len(lengths)
    md = fleet.metrics_dict()
    assert md["per_role"]["prefill"]["handoffs_out_total"] == len(lengths)
    assert md["per_role"]["decode"]["handoffs_adopted_total"] == \
        len(lengths)
    assert md["integrity_handoff_checksum_failures_total"] == 0
    assert md["handoff_fallbacks_total"] == 0
    for i in range(2):
        _assert_engine_pins(fleet.engine(i))
    _assert_pool_audits(fleet)
    # the hand-off carried the request's trace id onto the decode replica
    traces = {e["attrs"]["trace"] for e in fleet.engine(1).recorder.events()
              if e["name"] == "start"}
    assert traces == {f"f{g}" for g in gids}


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="int8"),
    dict(paged=True, prefix_cache=True),
    dict(paged=True, prefix_cache=True, kv_dtype="int8"),
], ids=["dense_int8", "paged_prefix_bf16", "paged_prefix_int8"])
def test_int8_and_paged_prefix_fleets_equal_the_jax_engine(lm, kw):
    """The pools' hand-off paths: int8 pools re-quantize the handed-off
    linear cache; the paged prefix-cache prefill replica resumes shared
    prefixes (every prompt is a prefix of one row) and ships the resume
    program's output. Every stream equals the JAX engine's, and the
    repeat of the first prompt is a fleet index hit."""
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=2, **kw)
    lengths = (9, 12, 5, 8)
    gids = [fleet.submit(_prompt(lm, n), 6) for n in lengths]
    results = fleet.run()
    again = fleet.submit(_prompt(lm, 9), 6)
    results.update(fleet.run())
    _assert_parity(lm, results, gids + [again], lengths + (9,), [6] * 5)
    assert fleet.fleet_prefix_hits_total == 1
    assert fleet.engine(0).decode_compile_count == 0
    for i in (1, 2):
        assert fleet.engine(i).prefill_compile_count == 0
    if kw.get("paged"):
        assert fleet.engine(0).pool.paging_stats()[
            "prefix_cache_hits_total"] > 0
    _assert_pool_audits(fleet)


def test_disagg_chunked_handoff(lm):
    """A chunked prefill replica hands off at FILL COMPLETION; the decode
    replica adopts without a prefill program."""
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=1,
                   prefill_chunk=8)
    lengths = (12, 4, 9, 6)
    gids = [fleet.submit(_prompt(lm, n), 6) for n in lengths]
    results = fleet.run()
    _assert_parity(lm, results, gids, lengths, [6] * 4)
    assert fleet.engine(1).prefill_compile_count == 0
    assert fleet.engine(0).metrics.chunked_prefills_total >= len(lengths)
    assert fleet.engine(0).metrics.handoffs_out_total == len(lengths)


# -- the fleet-wide prefix index ---------------------------------------------


def test_fleet_prefix_index_cross_replica_hit(lm):
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=2, paged=True,
                   prefix_cache=True)
    g0 = fleet.submit(_prompt(lm, 6), 8)
    r0 = fleet.run()
    assert fleet.fleet_prefix_hits_total == 0
    prefills_before = fleet.engine(0).metrics.submitted
    g1 = fleet.submit(_prompt(lm, 6), 8)
    g2 = fleet.submit(_prompt(lm, 6), 8)
    stats = fleet.prefix_index_stats()
    assert stats["refs_total"] == stats["open_indexed"] == 2
    res = fleet.run()
    assert fleet.fleet_prefix_hits_total == 2
    assert fleet.fleet_prefill_tokens_saved_total == 2 * 6
    assert fleet.engine(0).metrics.submitted == prefills_before
    res.update(r0)
    _assert_parity(lm, res, [g0, g1, g2], [6] * 3, [8] * 3)
    _assert_pool_audits(fleet)
    md = fleet.metrics_dict()
    assert md["fleet_prefix_hits_total"] == 2
    assert md["fleet_prefix_entries"] >= 1


def test_fleet_index_lru_eviction_pins_referenced_entries(lm):
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=1,
                   prefix_index_capacity=2)
    for n in (4, 5):
        fleet.submit(_prompt(lm, n), 4)
    fleet.run()
    assert fleet.prefix_index_stats()["entries"] == 2
    for n in (6, 7):
        fleet.submit(_prompt(lm, n), 4)
    fleet.run()
    stats = fleet.prefix_index_stats()
    assert stats["entries"] <= 2 and stats["evictions_total"] >= 2
    assert stats["refs_total"] == 0


# -- the hand-off fault site and its integrity --------------------------------


def test_handoff_transient_fault_retries(lm):
    inj = FaultInjector([Fault("serve.handoff", "transient", times=2)])
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=1, faults=inj)
    lengths = (5, 9, 4)
    gids = [fleet.submit(_prompt(lm, n), 6) for n in lengths]
    results = fleet.run()
    _assert_parity(lm, results, gids, lengths, [6] * 3)
    md = fleet.metrics_dict()
    assert md["handoff_fallbacks_total"] == 0
    assert fleet.engine(1).metrics.retries_total == 2


def test_handoff_lost_payload_falls_back_to_full_prefill(lm):
    inj = FaultInjector([Fault("serve.handoff", "transient", times=1000)])
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=1, faults=inj)
    lengths = (5, 9)
    gids = [fleet.submit(_prompt(lm, n), 6) for n in lengths]
    results = fleet.run()
    _assert_parity(lm, results, gids, lengths, [6] * 2)
    assert fleet.metrics_dict()["handoff_fallbacks_total"] == len(lengths)
    assert fleet.engine(1).prefill_compile_count > 0  # real prefills


def test_handoff_corrupt_falls_back_with_equal_streams(lm):
    """A corrupted payload is refused at adoption (checksum mismatch),
    the decode replica re-prefills, and every stream still equals the
    JAX engine's — under the program pins."""
    inj = FaultInjector([Fault("serve.handoff", "corrupt", tick=0)])
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=1, faults=inj)
    lengths = (5, 9, 4)
    with serve_compile_guard(fleet.engine(0), min_prefill=1), \
            serve_compile_guard(fleet.engine(1), min_decode=1):
        gids = [fleet.submit(_prompt(lm, n), 6) for n in lengths]
        results = fleet.run()
    _assert_parity(lm, results, gids, lengths, [6] * 3)
    md = fleet.metrics_dict()
    assert md["integrity_handoff_checksum_failures_total"] >= 1
    assert md["handoff_fallbacks_total"] >= 1
    assert md["integrity_snapshot_checksum_failures_total"] == 0
    names = {e["name"] for e in fleet.engine(1).recorder.events()}
    assert {"integrity.handoff_checksum", "handoff_fallback"} <= names


# -- failover and drain ------------------------------------------------------


def test_decode_replica_kill_failover(lm):
    inj = FaultInjector([Fault("serve.decode", "kill", tick=3, replica=1)])
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=2, slots=4,
                   decode_block=2, snapshot_every_ticks=2, faults=inj)
    lengths = (5, 9, 4, 7, 6, 8)
    budgets = (12, 3, 12, 3, 12, 12)
    gids = [fleet.submit(_prompt(lm, n), b)
            for n, b in zip(lengths, budgets)]
    results = fleet.run()
    assert fleet.replica_failovers_total == 1
    _assert_parity(lm, results, gids, lengths, budgets)
    assert fleet.replica_state(1) in ("healthy", "degraded")
    assert fleet.replica_role(1) == "decode"
    _assert_pool_audits(fleet)


def test_prefill_replica_kill_failover(lm):
    """Killing the prefill replica loses its undelivered payloads; the
    fleet re-routes every affected request from its ledger."""
    inj = FaultInjector([Fault("serve.prefill", "kill", tick=0, replica=0)])
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=1,
                   decode_block=2, snapshot_every_ticks=2, faults=inj)
    lengths = (5, 9, 4)
    gids = [fleet.submit(_prompt(lm, n), 8) for n in lengths]
    results = fleet.run()
    assert fleet.replica_failovers_total == 1
    _assert_parity(lm, results, gids, lengths, [8] * 3)
    assert fleet.replica_role(0) == "prefill"


def test_drain_decode_replica_migrates(lm):
    fleet = _fleet(lm, prefill_replicas=1, decode_replicas=2, slots=4,
                   decode_block=2, snapshot_every_ticks=2)
    lengths = (5, 9, 4, 7)
    gids = [fleet.submit(_prompt(lm, n), 12) for n in lengths]
    for _ in range(3):
        fleet.step()
    fleet.drain(1)
    assert fleet.replica_state(1) in ("draining", "drained")
    g_late = fleet.submit(_prompt(lm, 5), 12)
    results = fleet.run()
    assert fleet.replica_state(1) == "drained" and fleet.drains_total == 1
    _assert_parity(lm, results, gids + [g_late], lengths + (5,), [12] * 5)
    for entry in fleet._index.values():
        assert 1 not in entry.home
    with pytest.raises(FriendlyError, match="already"):
        fleet.drain(1)
    _assert_pool_audits(fleet)


# -- autoscaling and construction --------------------------------------------


def test_autoscaler_scales_up_under_burst_and_drains_back(lm):
    fleet = _fleet(
        lm, prefill_replicas=1, decode_replicas=1, slots=1, max_queue=16,
        autoscale=AutoscalePolicy(max_prefill=2, max_decode=3,
                                  queue_high=1.0, slo_burn_ticks=0,
                                  idle_ticks=2, cooldown_ticks=0))
    assert fleet._parked == {"prefill": 1, "decode": 2}
    lengths = [4 + (i % 3) for i in range(8)]
    gids = [fleet.submit(_prompt(lm, n), 8) for n in lengths]
    results = fleet.run()
    assert fleet.scale_ups_total >= 1
    assert len(results) == len(set(gids)) == len(gids)
    _assert_parity(lm, results, gids, lengths, [8] * 8)
    for _ in range(12):
        fleet.step()
    assert fleet.scale_downs_total >= 1
    assert (fleet.prefill_replicas, fleet.decode_replicas) == (1, 1)
    md = fleet.metrics_dict()
    assert (md["parked_prefill"], md["parked_decode"]) == (1, 2)
    _assert_pool_audits(fleet)


def test_fleet_and_policy_validation(lm):
    with pytest.raises(FriendlyError, match="at least one replica"):
        _fleet(lm, prefill_replicas=0)
    for key in ("role", "replica"):
        with pytest.raises(FriendlyError, match="managed by DisaggFleet"):
            _fleet(lm, **{key: "decode" if key == "role" else 0})
    with pytest.raises(FriendlyError, match="role must be"):
        ServeEngine(lm[2], lm[3], role="hybrid", device="cpu")
    with pytest.raises(FriendlyError, match="max_decode"):
        AutoscalePolicy(min_decode=3, max_decode=2)
    with pytest.raises(FriendlyError, match="autoscale floor"):
        _fleet(lm, decode_replicas=1,
               autoscale=AutoscalePolicy(min_decode=2))
    # percentile helpers are 0.0 on a cold engine and fleet, never None
    eng = ServeEngine(lm[2], lm[3], slots=2, cache_len=32, device="cpu")
    assert eng.metrics.ttft_p99_ms() == eng.metrics.tick_p99_ms() == 0.0
    fleet = _fleet(lm)
    assert fleet.ttft_p99_ms() == 0.0
    assert fleet.metrics_dict()["ttft_ms_p99"] == 0.0


def test_fault_sites_are_the_jax_packages():
    assert SITES == JAX_SITES and "serve.handoff" in SITES
    with pytest.raises(FriendlyError) as ei:
        parse_fault_spec("bogus.site:transient=0.5")
    for site in SITES:
        assert site in str(ei.value)


# -- hedged duplicates of a shared prefix ------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def test_hedged_shared_prefix_no_double_insert(lm):
    clk = _FakeClock()
    rs = ReplicaSet(lm[2], lm[3], replicas=2, slots=2, cache_len=32,
                    max_queue=8, decode_block=2, hedge_ms=50.0, clock=clk,
                    paged=True, prefix_cache=True,
                    snapshot_every_ticks=None, retry_backoff_s=0.0,
                    device="cpu")
    gid = rs.submit(_prompt(lm, 6), 12)
    rs.step()
    clk.t = 0.2
    results = rs.run()
    assert rs.hedges_total == 1
    g2 = rs.submit(_prompt(lm, 6), 12)
    results.update(rs.run())
    _assert_parity(lm, results, [gid, g2], [6, 6], [12, 12])
    for i in range(2):
        pool = rs.engine(i).pool
        total, mapped = pool.refcount_audit()
        assert total == mapped
        assert pool.paging_stats()["prefix_cache_entries"] <= 1


# -- fleet snapshots across the frameworks -----------------------------------


def test_fleet_snapshot_restores_both_ways(lm):
    """A JAX fleet's snapshot restores on the port, a port fleet's on the
    JAX package, and a port fleet's on the port: every stream finishes
    equal to the JAX engine's under its global id."""
    jg, jv, tg, tv = lm[:4]
    budgets = [SNAP_BUDGET] * len(SNAP_LENGTHS)
    snap = lm[6]
    assert snap["version"] == 1 and snap["open"]
    port = DisaggFleet.restore(snap, tg, tv, device="cpu",
                               **dict(KW, decode_block=2))
    _assert_parity(lm, port.run(), list(range(len(SNAP_LENGTHS))),
                   SNAP_LENGTHS, budgets)

    fleet = _fleet(lm, decode_block=2)
    gids = [fleet.submit(_prompt(lm, n), SNAP_BUDGET) for n in SNAP_LENGTHS]
    for _ in range(SNAP_STEPS):
        fleet.step()
    mine = json.loads(json.dumps(fleet.snapshot()))
    assert set(mine) == set(snap)
    assert any(e["emitted"] for e in mine["open"])
    again = DisaggFleet.restore(mine, tg, tv, device="cpu",
                                **dict(KW, decode_block=2))
    _assert_parity(lm, again.run(), gids, SNAP_LENGTHS, budgets)
    jax_side = JaxDisaggFleet.restore(mine, jg, jv,
                                      **dict(KW, decode_block=2))
    _assert_parity(lm, jax_side.run(), gids, SNAP_LENGTHS, budgets)
    with pytest.raises(FriendlyError, match="snapshot version"):
        DisaggFleet.restore({"version": 99}, tg, tv, device="cpu")


def test_metrics_dict_schema_equals_the_jax_package(lm):
    ref = lm[7]
    fleet = _fleet(lm, decode_block=2)
    for n in SNAP_LENGTHS:
        fleet.submit(_prompt(lm, n), SNAP_BUDGET)
    fleet.run()
    md = fleet.metrics_dict()
    assert set(md) == set(ref)
    for role in ("prefill", "decode"):
        assert set(md["per_role"][role]) == set(ref["per_role"][role])
    assert set(md["per_replica"]) == set(ref["per_replica"])
    for name, sub in md["per_replica"].items():
        assert set(sub) == set(ref["per_replica"][name])
    assert (md["submitted"], md["completed"]) == \
        (ref["submitted"], ref["completed"])
    assert md["handoffs_total"] == ref["handoffs_total"]
    json.dumps(md, default=str)
