"""The planes over the serving engine's mesh mode: a ``ReplicaSet`` and a
``DisaggFleet`` of mesh engines, the chaos soak, chunked prefill with the
async host loop, the device analytics and the telemetry hub on a
``{"data": 2, "model": 2}`` mesh — the ports of the JAX package's 2x2
cases (``tests/test_serve_supervisor.py::test_kill_failover_bit_identical
_2x2_mesh``, ``tests/test_serve_fleet.py::test_disagg_bit_identical_2x2_
mesh`` and ``::test_disagg_bit_identical_paged_prefix_mesh``,
``tests/test_serve_faults.py::test_chaos_soak_sharded``,
``tests/test_chunked_async.py::test_chunked_async_parity_2x2_mesh``,
``tests/test_perf.py::test_analytics_keep_contracts_sharded`` and
``tests/test_tracehub.py::test_hub_zero_new_programs_2x2_mesh``), with
their ``slow`` marks.

One gloo group of 4 CPU ranks (``testing/rank_pool.RankPool``) runs every
body on every rank; the non-slow bodies start together while this
process computes the reference: the JAX package's overfit periodic LM
bridged into the port and ONE JAX one-device engine over every prompt
length the file uses at its longest budget (a shorter budget's stream is
a prefix). Every completed stream on every rank must equal it exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.testing.rank_pool import RankPool


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WORLD = 4
MESH = {"data": 2, "model": 2}
TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)
CACHE_LEN = 32
TERMINAL = {"completed", "expired", "failed", "stalled"}
#: (prompt lengths, budgets) of the JAX kill drill and the fleet drill
KILL = ((5, 9, 4, 7, 6, 8), (12, 3, 12, 3, 12, 12))
FLEET = ((5, 9, 4, 7, 6, 8), (6,) * 6)
CHUNKED = ((12, 3, 9, 6), (6,) * 4)
HUB = ((5, 9, 4, 7), (6,) * 4)


def _soak_plan(seed: int):
    """The JAX chaos soak's seeded prompt lengths and budgets."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, 9, size=8)
    budgets = rng.integers(3, 11, size=8)
    return [int(n) for n in lengths], [int(b) for b in budgets]


def _longest() -> dict[int, int]:
    out: dict[int, int] = {4: 9}
    plans = [KILL, FLEET, CHUNKED, HUB, _soak_plan(3), _soak_plan(4)]
    for lengths, budgets in plans:
        for n, b in zip(lengths, budgets):
            out[n] = max(out.get(n, 0), b)
    return out


#: prompt length -> the longest budget any test here asks of it
LONGEST = _longest()


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD)
    try:
        yield pool
    finally:
        pool.close()


@pytest.fixture(scope="module")
def lm():
    """(flax variables as numpy, the periodic row)."""
    import jax

    from mmlspark_tpu.models import build_model as jax_build_model
    from mmlspark_tpu.testing.datagen import overfit_periodic_lm

    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    return jax.tree_util.tree_map(np.asarray, jv), np.array(ids[0])


@pytest.fixture(scope="module")
def planes(ranks, lm):
    """The non-slow bodies' per-rank results, and the JAX one-device
    engine's streams {prompt length: stream at its LONGEST budget},
    computed while the ranks work."""
    from mmlspark_tpu.models import build_model as jax_build_model
    from mmlspark_tpu.serve import ServeEngine as JaxServeEngine

    flax_np, row = lm
    pending = ranks.submit(_on_rank_planes, flax_np, row)
    jg = jax_build_model("transformer_lm", **TINY)
    ref = JaxServeEngine(jg, flax_np, slots=4, cache_len=CACHE_LEN,
                         max_queue=16, decode_block=1)
    rids = {n: ref.submit(row[:n], max_new_tokens=b)
            for n, b in LONGEST.items()}
    out = ref.run()
    streams = {n: [int(t) for t in out[r].tokens] for n, r in rids.items()}
    return pending.result(), streams


def _want(streams, n, b):
    return streams[n][:n + b]


# -- bodies run on every rank ---------------------------------------------


def _port(flax_np):
    from mmlspark_tpu_torch.models import build_model, load_flax_variables

    graph = build_model("transformer_lm", attn_impl="dense", **TINY)
    return graph, load_flax_variables(graph, flax_np, device="cpu")


def _pins(engine):
    return (engine.decode_compile_count <= engine.num_decode_blocks
            and engine.prefill_compile_count <= engine.num_prefill_buckets)


def _tokens(res):
    return [int(t) for t in res.tokens]


def _kill_drill(flax_np, row):
    """Kill replica 0 mid-decode-block: every request completes, one
    failover, every replica's program pins intact."""
    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.serve import ReplicaSet

    graph, variables = _port(flax_np)
    inj = FaultInjector([Fault("serve.decode", "kill", tick=3, replica=0)])
    rs = ReplicaSet(graph, variables, replicas=2, slots=4,
                    cache_len=CACHE_LEN, max_queue=8, decode_block=2,
                    mesh=MESH, snapshot_every_ticks=2, faults=inj,
                    retry_backoff_s=0.0, device="cpu")
    gids = [rs.submit(row[:n], b) for n, b in zip(*KILL)]
    results = rs.run()
    md = rs.metrics_dict()
    return ([(results[g].status, _tokens(results[g])) for g in gids],
            rs.replica_failovers_total,
            md["per_replica"]["replica0"]["failovers"],
            all(_pins(rs.engine(i)) for i in range(2)),
            rs.replica_state(0))


def _chaos_soak(flax_np, row, seed):
    """Seeded transient, OOM, stall and poison faults (the same injector
    on every rank): every request reaches a terminal state, the completed
    ones unchanged, under the program pins."""
    from mmlspark_tpu_torch.core.faults import FaultInjector

    graph, variables = _port(flax_np)
    lengths, budgets = _soak_plan(seed)
    inj = FaultInjector(seed=seed, rates={"transient": 0.08, "oom": 0.04,
                                          "stall": 0.02, "poison": 0.04},
                        stall_s=0.0005)
    from mmlspark_tpu_torch.serve import ServeEngine

    engine = ServeEngine(graph, variables, slots=2, cache_len=CACHE_LEN,
                         max_queue=16, decode_block=4, mesh=MESH,
                         faults=inj, retry_limit=2, retry_backoff_s=0.0,
                         degrade_recover_ticks=3, device="cpu")
    results, rids = {}, []
    for i, (n, b) in enumerate(zip(lengths, budgets)):
        rids.append(engine.submit(row[:n], max_new_tokens=b))
        if i % 2:
            results.update({r.id: r for r in engine.step()})
    results.update(engine.run())
    md = engine.metrics.to_dict()
    return ([(results[r].status, _tokens(results[r])) for r in rids],
            _pins(engine), engine.metrics.faults_injected_total,
            inj.injected_total, engine.pool.leased_count, engine.busy,
            md["completed"] + md["expired"] + md["failed"] + md["stalled"])


def _perf(flax_np, row):
    """The analytics ride the existing sync points: one fetch a block,
    every family costed on meta tensors over the mesh's devices."""
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _port(flax_np)
    engine = ServeEngine(graph, variables, slots=2, cache_len=CACHE_LEN,
                         decode_block=4, mesh=MESH,
                         slo="ttft_p99_ms=60000,error_rate=0.99",
                         device="cpu")
    rid = engine.submit(row[:4], max_new_tokens=9)  # 1 prefill + 8 decode
    fetches = {"n": 0}
    real = engine._fetch

    def counting(inflight):
        fetches["n"] += 1
        return real(inflight)

    engine._fetch = counting
    res = engine.run()[rid]
    d = engine.metrics.to_dict()
    single = ServeEngine(graph, variables, slots=2, cache_len=CACHE_LEN,
                         decode_block=4, device="cpu")
    single.submit(row[:4], max_new_tokens=9)
    single.run()
    fams = {k: (f["cost_source"], f["flops"])
            for k, f in d["perf_families"].items()}
    one = {k: f["flops"]
           for k, f in single.metrics.to_dict()["perf_families"].items()}
    return (_tokens(res), fetches["n"], fams, one, _pins(engine),
            d["perf_peak"]["devices"])


def _on_rank_planes(flax_np, row):
    return {"kill": _kill_drill(flax_np, row),
            "soak3": _chaos_soak(flax_np, row, 3),
            "perf": _perf(flax_np, row)}


def _on_rank_soak(flax_np, row, seed):
    return _chaos_soak(flax_np, row, seed)


def _on_rank_fleet(flax_np, row, extra):
    """A 1-prefill + 1-decode fleet against a 2-replica set at equal
    device count, ragged prompts with mid-run joins; the decode replica
    rides the hand-off path (no prefill program)."""
    from mmlspark_tpu_torch.serve import DisaggFleet, ReplicaSet

    graph, variables = _port(flax_np)
    kw = dict(slots=2, cache_len=CACHE_LEN, max_queue=8, decode_block=4,
              mesh=MESH, retry_backoff_s=0.0, device="cpu", **extra)
    prompts = [row[:n] for n in FLEET[0]]

    def drive(target):
        gids = [target.submit(p, 6) for p in prompts[:4]]
        for _ in range(2):
            target.step()
        gids += [target.submit(p, 6) for p in prompts[4:]]
        res = target.run()
        return [_tokens(res[g]) for g in gids]

    rs = drive(ReplicaSet(graph, variables, replicas=2, **kw))
    fleet = DisaggFleet(graph, variables, prefill_replicas=1,
                        decode_replicas=1, **kw)
    got = drive(fleet)
    return (rs, got, fleet.engine(1).prefill_compile_count,
            fleet.engine(0).decode_compile_count,
            all(_pins(fleet.engine(i)) for i in range(2)))


def _on_rank_chunked(flax_np, row):
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _port(flax_np)
    engine = ServeEngine(graph, variables, slots=2, cache_len=CACHE_LEN,
                         max_queue=8, decode_block=4, prefill_chunk=8,
                         async_host=True, mesh=MESH, device="cpu")
    rids = [engine.submit(row[:n], max_new_tokens=b)
            for n, b in zip(*CHUNKED)]
    results = engine.run()
    return ([_tokens(results[r]) for r in rids],
            engine.prefill_compile_count <= engine.num_chunk_buckets,
            engine.decode_compile_count <= engine.num_decode_blocks)


def _on_rank_hub(flax_np, row):
    """Serve with the hub attached and scraped mid-run: the pins hold,
    one fetch a decode block, no alert, and the source carries the mesh
    topology."""
    from mmlspark_tpu_torch.core.tracehub import TelemetryHub
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _port(flax_np)
    eng = ServeEngine(graph, variables, slots=2, cache_len=CACHE_LEN,
                      max_queue=8, decode_block=4, mesh=MESH, device="cpu")
    hub = TelemetryHub()
    src = hub.attach_engine(eng)
    for n, b in zip(*HUB):
        eng.submit(row[:n], b)
    done = 0
    while done < len(HUB[0]):
        done += len(eng.step())
        hub.to_prometheus()
        hub.merged_events()
    hub.export_trace()
    syncs = sum(
        1 for ev in eng.recorder.events()
        if ev["name"] == "dispatch"
        and str(ev.get("attrs", {}).get("family", "")).startswith("decode"))
    return (hub.detect(), _pins(eng), syncs,
            sum(eng.metrics.decode_blocks.values()),
            hub.registry.counter("alerts.host_sync_regression").value,
            dict(src.labels))


# -- the tests ---------------------------------------------------------------


def test_kill_failover_bit_identical_2x2_mesh(planes):
    out, streams = planes
    for got, failovers, rep0, pins, state in (o["kill"] for o in out):
        assert failovers == 1 and rep0 == 1 and pins
        assert state in ("healthy", "degraded")
        for (status, tokens), n, b in zip(got, *KILL):
            assert status == "completed"
            assert tokens == _want(streams, n, b), (n, b)


def _check_soak(outs, streams, seed):
    lengths, budgets = _soak_plan(seed)
    first = outs[0][0]
    for (got, pins, fired, injected, leased, busy, terminal) in outs:
        assert got == first  # every rank took the same path
        assert pins and fired == injected and leased == 0 and not busy
        assert terminal == len(lengths)
        completed = 0
        for (status, tokens), n, b in zip(got, lengths, budgets):
            assert status in TERMINAL
            if status == "completed":
                completed += 1
                assert tokens == _want(streams, n, b), (seed, n, b)
        assert completed >= 1


@pytest.mark.parametrize("seed", [3, pytest.param(4, marks=pytest.mark.slow)])
def test_chaos_soak_sharded(ranks, lm, planes, seed):
    out, streams = planes
    if seed == 3:
        outs = [o["soak3"] for o in out]
    else:
        outs = ranks.run(_on_rank_soak, *lm, seed)
    _check_soak(outs, streams, seed)


def test_analytics_keep_contracts_sharded(planes):
    out, streams = planes
    for tokens, fetches, fams, one, pins, devices in (o["perf"] for o in out):
        assert tokens == _want(streams, 4, 9)
        assert fetches <= 2 and pins
        assert any(f.startswith("decode[T=") for f in fams)
        assert all(src == "meta" for src, _ in fams.values())
        assert devices == 4
        # each family's cost is the rank's shard of the work over the
        # mesh's 4 devices: a decode block's is the one-device program's
        # (its rows and heads split 4 ways), a prefill's more (it runs on
        # every data rank), never more than 4 of it
        for family, (_src, flops) in fams.items():
            if family in one:
                assert one[family] <= flops <= 4 * one[family], family
                if family.startswith("prefill"):
                    assert flops > one[family], family


@pytest.mark.slow
def test_disagg_bit_identical_2x2_mesh(ranks, lm, planes):
    _check_fleet(ranks.run(_on_rank_fleet, *lm, {}), planes[1])


@pytest.mark.slow
def test_disagg_bit_identical_paged_prefix_mesh(ranks, lm, planes):
    _check_fleet(ranks.run(_on_rank_fleet, *lm,
                           {"paged": True, "prefix_cache": True}),
                 planes[1])


def _check_fleet(outs, streams):
    for rs, got, decode_prefills, prefill_decodes, pins in outs:
        assert got == rs
        assert got == [_want(streams, n, b) for n, b in zip(*FLEET)]
        assert decode_prefills == 0 and prefill_decodes == 0 and pins


@pytest.mark.slow
def test_chunked_async_parity_2x2_mesh(ranks, lm, planes):
    for got, chunk_pin, decode_pin in ranks.run(_on_rank_chunked, *lm):
        assert got == [_want(planes[1], n, b) for n, b in zip(*CHUNKED)]
        assert chunk_pin and decode_pin


@pytest.mark.slow
def test_hub_zero_new_programs_2x2_mesh(ranks, lm):
    for rank, (alerts, pins, syncs, blocks, regress, labels) in enumerate(
            ranks.run(_on_rank_hub, *lm)):
        assert alerts == [] and pins and regress == 0
        assert syncs == blocks
        assert labels == {"mesh": "data=2,model=2", "rank": str(rank)}
