"""The serving engine's mesh mode (``serve/engine.py`` with ``mesh=``):
slots over ``data``, the Megatron-split compute over ``model``, the
sharded slot and paged pools, the metrics and the demo — the port of
``tests/test_serve_sharded.py``, with its ``slow`` marks, held to the JAX
package's one-device engine.

The port's side runs on one gloo group of 4 CPU ranks
(``testing/rank_pool.RankPool``), started once for the file; every
``_on_rank_*`` body runs the same engine and schedule on every rank, and
each rank returns what it saw (streams, program counts, its shard's
shapes), so the tests hold every rank to the references. The JAX side
runs in this process while the ranks work: the JAX package's overfit
periodic LM (``testing/datagen.overfit_periodic_lm``; vocab 64, d_model
32, 2 heads, depth 2), bridged into the port, and ONE JAX engine run per
KV dtype over every prompt length the file uses at its longest budget
(prompts are prefixes of the periodic row, so a shorter budget's stream
is a prefix). The JAX package's own tests show that its mesh streams
equal its one-device ones; here every rank's streams must equal the JAX
one-device engine's and the port's one-device engine's exactly. The
split forward's logits are held to the one-device forward's within
``LOGIT_TOL`` = 1e-5, computing in float32 on both.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError
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
#: the split forward against the one-device forward, both in float32
LOGIT_TOL = 1e-5
#: prompt length -> the longest budget any schedule here asks of it
LONGEST = {1: 7, 2: 5, 3: 12, 4: 12, 5: 16, 6: 12, 8: 12, 9: 12, 11: 6}
#: the engine modes the mixed schedule runs through
MODES = {
    "dense": {},
    "paged_prefix": {"paged": True, "prefix_cache": True},
    "int8": {"kv_dtype": "int8"},
    "chunked_async": {"prefill_chunk": 8, "async_host": True},
}


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


def _jax_streams(flax_np, row, kv_dtype="bf16"):
    """{prompt length: the JAX one-device engine's stream at its LONGEST
    budget}."""
    from mmlspark_tpu.models import build_model as jax_build_model
    from mmlspark_tpu.serve import ServeEngine as JaxServeEngine

    jg = jax_build_model("transformer_lm", **TINY)
    ref = JaxServeEngine(jg, flax_np, slots=4, cache_len=CACHE_LEN,
                         max_queue=16, decode_block=1, kv_dtype=kv_dtype)
    rids = {n: ref.submit(row[:n], max_new_tokens=b)
            for n, b in LONGEST.items()}
    out = ref.run()
    return {n: np.asarray(out[r].tokens) for n, r in rids.items()}


@pytest.fixture(scope="module")
def parity(ranks, lm):
    """The mixed schedule through every mode on the 2x2 mesh (rank
    results) beside the JAX references, computed meanwhile."""
    flax_np, row = lm
    pending = ranks.submit(_on_rank_modes, flax_np, row)
    refs = {"bf16": _jax_streams(flax_np, row),
            "int8": _jax_streams(flax_np, row, "int8")}
    return pending.result(), refs


# -- bodies run on every rank ---------------------------------------------


def _port(flax_np, f32=False):
    from mmlspark_tpu_torch.models import build_model, load_flax_variables

    graph = build_model("transformer_lm", attn_impl="dense", **TINY)
    if f32:
        for _, mod in graph.blocks:
            for m in mod.modules():
                if hasattr(m, "dtype"):
                    m.dtype = torch.float32
    return graph, load_flax_variables(graph, flax_np, device="cpu")


def _engine(flax_np, mesh=None, **kw):
    from mmlspark_tpu_torch.serve import ServeEngine

    graph, variables = _port(flax_np)
    kw.setdefault("slots", 4)
    kw.setdefault("max_queue", 8)
    kw.setdefault("decode_block", 4)
    return ServeEngine(graph, variables, cache_len=CACHE_LEN, mesh=mesh,
                       retry_backoff_s=0.0, device="cpu", **kw)


#: the mixed schedule: (prompt length, budget, eos offset or None,
#: deadline ticks or None), the first three up front, two ticks, then the
#: rest join; 11 shares 9's prefix (a prefix-cache hit from the other
#: data shard), the 4-token request stops at an EOS mid-block and the
#: 5-token one expires while active, its slot re-leased by a joiner
SCHEDULE = [(9, 12, None, None), (4, 12, 2, None), (5, 16, None, 2),
            (11, 6, None, None), (6, 12, None, None), (8, 12, None, None)]


def _drive(engine, row, schedule=SCHEDULE):
    """The schedule's results: [(status, tokens)] in submit order."""
    rids, results = [], {}
    for i, (n, b, eos_at, dl) in enumerate(schedule):
        if i == 3:
            for _ in range(2):
                results.update({r.id: r for r in engine.step()})
        eos = None
        if eos_at is not None:
            # the EOS is a token the free-running (periodic) stream emits
            # mid-block
            eos = int(row[(n + eos_at) % 4])
        rids.append(engine.submit(row[:n], max_new_tokens=b, eos_id=eos,
                                  deadline_ticks=dl))
    while engine.busy:
        results.update({r.id: r for r in engine.step()})
    return [(results[r].status, [int(t) for t in results[r].tokens])
            for r in rids]


def _counting_fetch(engine):
    calls = {"n": 0}
    real = engine._fetch

    def fetch(inflight):
        calls["n"] += 1
        return real(inflight)

    engine._fetch = fetch
    return calls


def _on_rank_modes(flax_np, row):
    """Every mode's mixed schedule on one device and on the 2x2 mesh,
    with the mesh engine's program counts, fetches and a re-tick."""
    out = {}
    for mode, kw in MODES.items():
        single = _drive(_engine(flax_np, **kw), row)
        engine = _engine(flax_np, MESH, **kw)
        fetches = _counting_fetch(engine)
        meshed = _drive(engine, row)
        counts = (engine.decode_compile_count, engine.prefill_compile_count,
                  engine.resume_compile_count)
        blocks = sum(engine.metrics.decode_blocks.values())
        n_fetches = fetches["n"]
        again = _drive(engine, row)
        out[mode] = dict(
            single=single, mesh=meshed, again=again, counts=counts,
            retick=(engine.decode_compile_count,
                    engine.prefill_compile_count,
                    engine.resume_compile_count),
            pins=(engine.num_decode_blocks, engine.num_prefill_buckets),
            fetches=n_fetches, blocks=blocks,
            shard_copies=getattr(engine.pool, "prefix_shard_copies", 0),
            prefix_hits=getattr(engine.pool, "prefix_hits", 0))
    return out


def _on_rank_raises(flax_np):
    try:
        _engine(flax_np, MESH, slots=3)
    except FriendlyError as e:
        return str(e)
    return None


def _on_rank_ragged(flax_np, row, mesh):
    """The JAX test's ragged schedule: three up front, two ticks, two
    joins; None on a rank the mesh leaves out."""
    try:
        engine = _engine(flax_np, mesh)
    except FriendlyError as e:
        if "outside the serving mesh" in str(e):
            return None
        raise
    sched = [(4, 10, None, None), (1, 7, None, None), (9, 3, None, None),
             (6, 12, None, None), (2, 5, None, None)]
    got = _drive(engine, row, sched)
    return got, (engine.decode_compile_count, engine.num_decode_blocks,
                 engine.prefill_compile_count, engine.num_prefill_buckets)


def _on_rank_expire(flax_np, row):
    """The expire-active case: the owner's device row dead at pos 0, the
    survivor and the re-leased slot's tenant unharmed."""
    engine = _engine(flax_np, MESH, slots=2, max_queue=4, decode_block=1)
    rid_a = engine.submit(row[:4], max_new_tokens=12, deadline_ticks=2)
    rid_b = engine.submit(row[:5], max_new_tokens=10)
    results = {r.id: r for r in engine.step()}
    slot_a = next(s for s, st in engine._sched.active.items()
                  if st.req.id == rid_a)
    while rid_a not in results:
        results.update({r.id: r for r in engine.step()})
    row_a = engine.pool.local_row(slot_a)
    state = None
    if row_a is not None:
        state = (bool(engine.pool.live[row_a]),
                 int(engine.pool.positions[row_a]))
    rid_c = engine.submit(row[:6], max_new_tokens=4)
    results.update(engine.run())
    return (results[rid_a].status, state,
            [(results[r].status, [int(t) for t in results[r].tokens])
             for r in (rid_b, rid_c)])


def _on_rank_metrics(flax_np):
    engine = _engine(flax_np, MESH)
    d = engine.metrics.to_dict()
    local = sum(t.numel() * t.element_size()
                for pair in engine.pool.buffers.values() for t in pair)
    single = _engine(flax_np).metrics.to_dict()
    return (d["mesh_shape"], d["mesh_devices"],
            d["cache_pool_bytes_per_device"], local,
            single["mesh_shape"], single["mesh_devices"],
            single["cache_pool_bytes_per_device"])


def _on_rank_split(flax_np, row):
    """The split is real: the heads each decode step's attention reads,
    and the rank's leaves and KV buffers against the whole model's."""
    import mmlspark_tpu_torch.models.transformer as tr

    seen = set()
    real = tr.flash_decode

    def spy(q, k, v, *a, **kw):
        seen.add((q.shape[2], k.shape[2]))
        return real(q, k, v, *a, **kw)

    tr.flash_decode = spy
    try:
        engine = _engine(flax_np, MESH)
        engine.submit(row[:5], max_new_tokens=6)
        engine.run()
    finally:
        tr.flash_decode = real
    whole = _engine(flax_np)
    leaves = {}
    for block, key in [("block0", "attn.qkv.weight"),
                       ("block0", "attn.qkv.bias"),
                       ("block1", "attn.attn_out.weight"),
                       ("block0", "mlp_in.weight"),
                       ("block1", "mlp_out.weight"),
                       ("embed", "token.weight"), ("z", "head.weight")]:
        leaves[f"{block}.{key}"] = (engine.variables[block][key].numel(),
                                    whole.variables[block][key].numel())
    kv = (engine.pool.buffers["block0"][0].numel(),
          whole.pool.buffers["block0"][0].numel())
    return sorted(seen), leaves, kv, engine._split.local_heads


def _on_rank_logits(flax_np, row):
    """The split forward's logits (prefill, then one per-row decode
    step) against the one-device forward's, in float32: this rank's vocab
    slice of each, and the greedy combine against the whole argmax."""
    from mmlspark_tpu_torch.models.generate import (
        _cached_apply,
        greedy_next,
        init_cache,
    )
    from mmlspark_tpu_torch.models import load_flax_variables
    from mmlspark_tpu_torch.models.transformer import split_graph
    from mmlspark_tpu_torch.parallel import model_split, serve_mesh

    graph, whole = _port(flax_np, f32=True)
    place = serve_mesh(MESH)
    local_graph = split_graph(graph, model_split(graph, whole, place), place)
    # the bridge carries the flax variables straight to the rank's shards
    local = load_flax_variables(graph, flax_np, device="cpu", mesh=place)
    ids = torch.as_tensor(np.stack([row[:8], row[1:9]]).astype(np.int32))
    errs, agree = [], True
    outs = []
    for g, v in ((graph, whole), (local_graph, local)):
        cache = {name: tuple(t.float() for t in kv)
                 for name, kv in init_cache(g, v, 2, CACHE_LEN).items()}
        pre, cache = _cached_apply(g, v, ids, cache, 0)
        step, _ = _cached_apply(g, v, ids[:, -1:], cache,
                                torch.tensor([8, 8], dtype=torch.int32),
                                step=True)
        outs.append((pre, step, g.extra.get("vocab_split")))
    n = TINY["vocab_size"] // place.model_size
    sl = slice(place.model_index * n, (place.model_index + 1) * n)
    for full, part in zip(outs[0][:2], outs[1][:2]):
        errs.append(float((full[..., sl] - part).abs().max()))
        agree &= bool(torch.equal(greedy_next(full),
                                  greedy_next(part, outs[1][2])))
    return max(errs), agree


def _on_rank_demo():
    from mmlspark_tpu_torch.serve import run_demo

    kw = dict(n_requests=6, max_new_tokens=6, slots=4, decode_block=4,
              device="cpu")
    single = run_demo(**kw)
    meshed = run_demo(mesh="data=2,model=2", **kw)
    paged = run_demo(mesh="data=2,model=2", paged=True, prefix_cache=True,
                     **kw)
    return (single["stream_digest"], meshed["stream_digest"],
            paged["stream_digest"], meshed["mesh_devices"],
            meshed["completed"])


def _on_rank_snapshots(flax_np, row):
    """Snapshots cross: a mesh engine's restores on one device and a
    one-device engine's on the mesh, mid-run, the streams unchanged."""
    from mmlspark_tpu_torch.serve import ServeEngine

    out = []
    for src_mesh, dst_mesh in ((MESH, None), (None, MESH)):
        engine = _engine(flax_np, src_mesh)
        rids = [engine.submit(row[:n], max_new_tokens=8) for n in (5, 9)]
        results = {}
        for _ in range(3):
            results.update({r.id: r for r in engine.step()})
        graph, variables = _port(flax_np)
        restored = ServeEngine.restore(
            engine.snapshot(), graph, variables, slots=4, decode_block=4,
            mesh=dst_mesh, device="cpu")
        results.update(restored.run())
        out.append([[int(t) for t in results[r].tokens] for r in rids])
    return out


def _on_rank_agreed_fault(flax_np, row):
    """A transient fault injected on rank 0 alone is agreed: every rank
    retries the same dispatch, and the streams are unchanged."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector

    faults = None
    if dist.get_rank() == 0:
        faults = FaultInjector([Fault("serve.decode", "transient", tick=2),
                                Fault("serve.prefill", "oom", tick=0)])
    engine = _engine(flax_np, MESH, faults=faults)
    rids = [engine.submit(row[:n], max_new_tokens=8) for n in (4, 6)]
    results = engine.run()
    return ([[int(t) for t in results[r].tokens] for r in rids],
            engine.metrics.retries_total, engine.degraded or
            engine._block_cap < engine.decode_block)


def _on_rank_desync(flax_np, row):
    """A fetch that fails on rank 0 alone, after every rank's block ran:
    every rank stops with MeshDesync instead of retrying."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import MeshDesync

    engine = _engine(flax_np, MESH)
    if dist.get_rank() == 0:
        real = engine._fetch

        def fetch(inflight):
            engine._fetch = real
            raise RuntimeError("a fetch that failed on one rank")

        engine._fetch = fetch
    engine.submit(row[:4], max_new_tokens=8)
    try:
        engine.run()
    except MeshDesync as e:
        return str(e)
    return None


def _on_rank_feed():
    """``data_sharding`` over the mesh's data axis gives a rank its
    contiguous block of a batch's rows; ``to_device`` places only
    those."""
    from mmlspark_tpu_torch.data.feed import data_sharding, to_device
    from mmlspark_tpu_torch.parallel import serve_mesh

    place = serve_mesh(MESH)
    batch = {"x": np.arange(8 * 3).reshape(8, 3)}
    got = to_device(batch, torch.device("cpu"), data_sharding(place))
    return place.data_index, got["x"].numpy().tolist()


# -- spec parsing, topology, rule coverage (no ranks) -----------------------


def test_parse_mesh_axes():
    from mmlspark_tpu_torch.parallel import parse_mesh_axes

    assert parse_mesh_axes("data=4,model=2") == {"data": 4, "model": 2}
    assert parse_mesh_axes(" data=-1 , model=2 ") == {"data": -1,
                                                     "model": 2}
    with pytest.raises(FriendlyError, match="mesh spec"):
        parse_mesh_axes("data:4")
    with pytest.raises(FriendlyError, match="mesh spec"):
        parse_mesh_axes("")


def test_tp_rule_coverage_transformer_lm():
    """Every transformer_lm leaf matches SOME rule, through the bridge's
    paths; an unknown leaf is reported by its full path."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import (
        TRANSFORMER_TP_RULES,
        unmatched_param_paths,
    )

    graph = build_model("transformer_lm", attn_impl="dense", **TINY)
    v = init_variables(graph, 0, device="cpu")
    assert unmatched_param_paths(v, TRANSFORMER_TP_RULES, graph) == []
    extra = {"novel": {"params": {"adapter": {"kernel": torch.zeros(4, 4)}}}}
    assert unmatched_param_paths(extra, TRANSFORMER_TP_RULES) == \
        ["novel/params/adapter/kernel"]


def test_slots_not_divisible_by_data_axis_raises(ranks, lm):
    msgs = ranks.run(_on_rank_raises, lm[0])
    assert all(m is not None and "multiple of the mesh" in m for m in msgs)


# -- parity: every rank's streams == the JAX one-device engine's -----------


@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_streams_equal_jax_and_one_device(parity, mode):
    """The mixed schedule (ragged prompts, mid-run joins, a mid-block
    EOS, an expiry whose slot a joiner re-leases, a cross-shard prefix)
    on the 2x2 mesh: every rank's results equal the port's one-device
    engine's exactly, every completed stream the JAX one-device engine's,
    one fetch a block, programs within their pins and none new on a
    re-tick."""
    out, refs = parity
    ref = refs["int8" if mode == "int8" else "bf16"]
    first = out[0][mode]
    for rank, got in enumerate(out):
        got = got[mode]
        assert got["mesh"] == got["single"] == first["mesh"], (rank, mode)
        assert got["again"] == got["mesh"]
    for (n, b, eos_at, _dl), (status, tokens) in zip(SCHEDULE,
                                                      first["mesh"]):
        want = list(ref[n][:n + b])
        if eos_at is not None:
            eos = want[n + eos_at]
            stop = n + want[n:].index(eos)
            want = want[:stop + 1]
            assert len(want) < n + b  # it stopped early
        if status == "completed":
            assert tokens == want, (mode, n)
        else:
            assert status == "expired" and n == 5, (mode, n, status)
            assert tokens == want[:len(tokens)]
    assert [s for s, _ in first["mesh"]].count("completed") == 5
    dec, pre, res = first["counts"]
    assert 1 <= dec <= first["pins"][0]
    assert 1 <= pre <= first["pins"][1] and res <= first["pins"][1]
    if mode == "paged_prefix":
        # the warm prefix cache may resume at a new remainder bucket
        assert first["retick"][:2] == first["counts"][:2]
        assert first["retick"][2] <= first["pins"][1]
    else:
        assert first["retick"] == first["counts"]
    # one fetch a block
    assert first["fetches"] <= first["blocks"]
    if mode == "paged_prefix":
        assert first["prefix_hits"] >= 1 and first["shard_copies"] >= 1


@pytest.mark.parametrize("mesh_axes", [
    {"data": 2, "model": 2},
    pytest.param({"data": 4}, marks=pytest.mark.slow),
    pytest.param({"data": 1, "model": 2}, marks=pytest.mark.slow),
])
def test_sharded_parity_ragged_prompts_and_joins(ranks, lm, parity,
                                                mesh_axes):
    flax_np, row = lm
    ref = parity[1]["bf16"]
    outs = [o for o in ranks.run(_on_rank_ragged, flax_np, row, mesh_axes)
            if o is not None]
    assert len(outs) == int(np.prod(list(mesh_axes.values())))
    sched = [(4, 10), (1, 7), (9, 3), (6, 12), (2, 5)]
    for got, (dec, n_dec, pre, n_pre) in outs:
        for (n, b), (status, tokens) in zip(sched, got):
            assert status == "completed"
            assert tokens == list(ref[n][:n + b]), (mesh_axes, n)
        assert dec <= n_dec and pre <= n_pre


def test_sharded_expire_active_slot_device_state(ranks, lm, parity):
    flax_np, row = lm
    ref = parity[1]["bf16"]
    outs = ranks.run(_on_rank_expire, flax_np, row)
    owners = [o[1] for o in outs if o[1] is not None]
    assert owners == [(False, 0)] * 2  # the owner's two model ranks
    for status, _state, rest in outs:
        assert status == "expired"
        assert rest == outs[0][2]
        assert rest[0] == ("completed", list(ref[5][:15]))
        assert rest[1] == ("completed", list(ref[6][:10]))


def test_sharded_metrics_mesh_keys(ranks, lm):
    for (shape, devices, per_dev, local, s_shape, s_devices,
         s_bytes) in ranks.run(_on_rank_metrics, lm[0]):
        assert shape == MESH and devices == 4
        assert s_shape == {} and s_devices == 1
        # the rank's shard: a quarter of the pool's K/V bytes (slots over
        # data, heads over model), strictly below the one-device total
        assert 0 < per_dev < s_bytes
        assert local * 4 < s_bytes


def test_split_is_real(ranks, lm):
    """A model rank's attention runs on H/model q heads and Hkv/model kv
    heads, its Megatron leaves hold 1/model of theirs and its KV pool
    1/(data·model) of the whole pool, by shape."""
    for seen, leaves, (kv_local, kv_whole), heads in ranks.run(
            _on_rank_split, *lm):
        assert heads == TINY["heads"] // 2
        assert seen == [(1, 1)]
        for name, (local, whole) in leaves.items():
            assert local * 2 == whole, name
        assert kv_local * 4 == kv_whole


def test_split_forward_logits_f32(ranks, lm):
    for err, agree in ranks.run(_on_rank_logits, *lm):
        assert err < LOGIT_TOL
        assert agree


def test_demo_mesh_streams_equal_one_device(ranks):
    outs = ranks.run(_on_rank_demo)
    for single, meshed, paged, devices, completed in outs:
        assert meshed == single == paged == outs[0][0]
        assert devices == 4 and completed == 6


def test_snapshots_cross_mesh_and_one_device(ranks, lm, parity):
    flax_np, row = lm
    ref = parity[1]["bf16"]
    for streams in ranks.run(_on_rank_snapshots, flax_np, row):
        for got in streams:
            assert got == [list(ref[5][:13]), list(ref[9][:17])]


def test_fault_on_one_rank_is_agreed(ranks, lm, parity):
    flax_np, row = lm
    ref = parity[1]["bf16"]
    outs = ranks.run(_on_rank_agreed_fault, flax_np, row)
    for streams, retries, degraded in outs:
        assert streams == [list(ref[4][:12]), list(ref[6][:14])]
        assert retries == outs[0][1] >= 2
        assert degraded == outs[0][2]


# -- the JAX test's slow cases ---------------------------------------------


def _on_rank_eos(flax_np, row):
    engine = _engine(flax_np, MESH, slots=2)
    return _drive(engine, row, [(3, 12, 2, None)])


@pytest.mark.slow
def test_sharded_mid_block_eos(ranks, lm, parity):
    flax_np, row = lm
    ref = list(parity[1]["bf16"][3])
    eos = ref[3 + 2]
    want = ref[:3 + ref[3:].index(eos) + 1]
    for got in ranks.run(_on_rank_eos, flax_np, row):
        assert got == [("completed", want)]


def _on_rank_retick(flax_np, row):
    engine = _engine(flax_np, MESH, slots=2)
    engine.submit(row[:4], max_new_tokens=9)
    engine.run()
    before = (engine.decode_compile_count, engine.prefill_compile_count)
    rid = engine.submit(row[:4], max_new_tokens=9)
    res = engine.run()[rid]
    return before, (engine.decode_compile_count,
                    engine.prefill_compile_count), \
        [int(t) for t in res.tokens]


@pytest.mark.slow
def test_sharded_retick_compiles_zero_new_programs(ranks, lm, parity):
    flax_np, row = lm
    for before, after, tokens in ranks.run(_on_rank_retick, flax_np, row):
        assert before == after
        assert tokens == list(parity[1]["bf16"][4][:13])


def _on_rank_one_fetch(flax_np, row):
    engine = _engine(flax_np, MESH, slots=2)
    rid = engine.submit(row[:4], max_new_tokens=9)  # 1 prefill + 8 decode
    calls = _counting_fetch(engine)
    res = engine.run()[rid]
    return calls["n"], [int(t) for t in res.tokens]


@pytest.mark.slow
def test_sharded_one_host_sync_per_block(ranks, lm, parity):
    flax_np, row = lm
    for n, tokens in ranks.run(_on_rank_one_fetch, flax_np, row):
        assert n <= 2
        assert tokens == list(parity[1]["bf16"][4][:13])


def test_embedding_and_head_rules_shard(ranks):
    assert ranks.run(_on_rank_rule_specs) == [None] * WORLD


def _on_rank_rule_specs():
    """The rules place the vocab-parallel pair (embedding rows and head
    columns over model), norms and the position table replicated; None
    when they do."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import (
        TRANSFORMER_TP_RULES,
        build_param_shardings,
        make_mesh,
    )

    graph = build_model("transformer_lm", attn_impl="dense", **TINY)
    v = init_variables(graph, 0, device="cpu")
    sh = build_param_shardings(v, make_mesh(MESH), TRANSFORMER_TP_RULES,
                               graph)
    got = (sh["embed"]["token.weight"].flax_spec,
           sh["z"]["head.weight"].flax_spec,
           sh["z"]["ln_f.weight"].flax_spec,
           sh["embed"]["pos"].flax_spec)
    want = (("model", None), (None, "model"), (), ())
    return None if got == want else got


def test_call_failing_on_one_rank_stops_every_rank(ranks, lm):
    msgs = ranks.run(_on_rank_desync, *lm)
    assert all(m is not None and "serve.device_get" in m for m in msgs)


def test_feed_data_sharding_gives_a_rank_its_rows(ranks):
    rows = np.arange(8 * 3).reshape(8, 3)
    for index, got in ranks.run(_on_rank_feed):
        assert got == rows[index * 4:(index + 1) * 4].tolist()
