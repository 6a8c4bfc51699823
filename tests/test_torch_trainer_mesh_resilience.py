"""The trainer's mesh mode under faults (``mmlspark_tpu_torch/train/
distributed.py``): kill and resume on a 2x2 mesh, elastic resume at a
narrower data width, the geometry check, the train -> checkpoint ->
serve round trip over a mesh, the audit's cross-replica vote, and the
layers above the trainer that a mesh reaches (the demo, ``TPUModel
(data_parallel)``, ``entry.dryrun_multichip``). Twins of the mesh cases
of ``tests/test_train_resilience.py``, ``tests/test_integrity.py`` and
``__graft_entry__.dryrun_multichip``.

One gloo group of 4 CPU ranks (``testing/rank_pool.RankPool``) for the
file; every ``_on_rank_*`` body runs on every rank, and ranks a smaller
mesh leaves out return None. Bit-exact claims are the JAX tests' own;
the elastic resume's losses are held to an uninterrupted data=4 run
within ``LOSS_TOL`` (float32: only the reduction width differs).
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
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD)
    try:
        yield pool
    finally:
        pool.close()


def _two_blob_data(n=96, d=8, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([rng.normal(-1.5, 1.0, (half, d)),
                        rng.normal(1.5, 1.0, (half, d))]).astype(np.float32)
    y = np.concatenate([np.zeros(half), np.ones(half)]).astype(np.int32)
    perm = rng.permutation(n)
    return x[perm], y[perm]


def _cfg(**kw):
    from mmlspark_tpu_torch.train import TrainConfig

    base = dict(epochs=2, batch_size=32, learning_rate=1e-2, shuffle=False,
                log_every=1, retry_backoff_s=0.0)
    base.update(kw)
    return TrainConfig(**base)


def _mlp():
    from mmlspark_tpu_torch.models import build_model

    return build_model("mlp", num_outputs=2, hidden=(8,))


def _numpy(tree):
    return {b: {k: t.numpy() for k, t in blk.items()}
            for b, blk in tree.items()}


# -- bodies run on every rank ---------------------------------------------


def _on_rank_kill_resume(ckdir, mesh_axes):
    """The headline drill over ``mesh_axes``: an uninterrupted run, a run
    killed at step 3 of 6, and its resume."""
    from mmlspark_tpu_torch.core.faults import (
        EngineKilled,
        Fault,
        FaultInjector,
    )
    from mmlspark_tpu_torch.train import SPMDTrainer

    x, y = _two_blob_data()
    full = SPMDTrainer(_mlp(), _cfg(mesh_axes=mesh_axes), device="cpu")
    v_full = full.train(x, y)
    ck = dict(checkpoint_dir=ckdir, checkpoint_every=1, mesh_axes=mesh_axes)
    crashed = SPMDTrainer(_mlp(), _cfg(**ck), faults=FaultInjector(
        [Fault("train.step", "kill", tick=3)]), device="cpu")
    try:
        crashed.train(x, y)
        killed = False
    except EngineKilled:
        killed = True
    resumed = SPMDTrainer(_mlp(), _cfg(**ck), device="cpu")
    v_res = resumed.train(x, y)
    return {
        "killed": killed,
        "crashed_steps": [h["step"] for h in crashed.history],
        "restored_steps": [h["step"] for h in resumed.restored_history],
        "resumed_steps": [h["step"] for h in resumed.history],
        "full_curve": [h["loss"] for h in full.history],
        "stitched": [h["loss"] for h in
                     resumed.restored_history + resumed.history],
        "full": _numpy(v_full), "resumed": _numpy(v_res),
    }


def _lm_rows():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 32, size=(48, 8)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _f32_lm():
    from mmlspark_tpu_torch.models import build_model

    graph = build_model("transformer_lm", vocab_size=32, d_model=16,
                        heads=2, depth=1, max_len=8, attn_impl="dense")
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


def _on_rank_elastic(ckdir):
    """Killed at step 3 over data=4, resumed over data=2 (every rank
    calls make_mesh; the data=2 mesh leaves ranks 2 and 3 out), against
    an uninterrupted data=4 run."""
    from mmlspark_tpu_torch.core.faults import (
        EngineKilled,
        Fault,
        FaultInjector,
    )
    from mmlspark_tpu_torch.train import SPMDTrainer

    x, y = _lm_rows()
    kw = dict(batch_size=16, learning_rate=1e-2)
    full = SPMDTrainer(_f32_lm(), _cfg(mesh_axes={"data": 4}, **kw),
                       device="cpu")
    full.train(x, y)
    ck = dict(checkpoint_dir=ckdir, checkpoint_every=1, **kw)
    crashed = SPMDTrainer(_f32_lm(), _cfg(mesh_axes={"data": 4}, **ck),
                          faults=FaultInjector(
                              [Fault("train.step", "kill", tick=3)]),
                          device="cpu")
    try:
        crashed.train(x, y)
    except EngineKilled:
        pass
    resumed = SPMDTrainer(_f32_lm(), _cfg(mesh_axes={"data": 2}, **ck),
                          device="cpu")
    v = resumed.train(x, y)
    if v is None:
        return None
    return {"steps": [h["step"] for h in resumed.history],
            "losses": [h["loss"] for h in resumed.history],
            "full": [h["loss"] for h in full.history],
            "finite": all(bool(torch.isfinite(t).all())
                          for blk in v.values() for t in blk.values())}


def _on_rank_geometry(ckdir):
    from mmlspark_tpu_torch.core.exceptions import FriendlyError
    from mmlspark_tpu_torch.train import SPMDTrainer

    x, y = _two_blob_data(n=96)
    ck = dict(checkpoint_dir=ckdir, checkpoint_every=1,
              mesh_axes={"data": 2, "model": 2})
    SPMDTrainer(_mlp(), _cfg(epochs=1, batch_size=32, **ck),
                device="cpu").train(x, y)
    try:
        SPMDTrainer(_mlp(), _cfg(epochs=2, batch_size=48, **ck),
                    device="cpu").train(x, y)
    except FriendlyError as e:
        return str(e)
    return None


def _on_rank_roundtrip(ckdir):
    """A data=2 run with a checkpoint at its end (rank 0 writes whole
    tensors), the trained variables of the run."""
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer

    graph = build_model("transformer_lm", vocab_size=8, d_model=32,
                        heads=2, depth=2, max_len=32)
    ids = np.repeat(((np.arange(16)[None, :] % 4) + 1), 8, axis=0)
    ids = ids.astype(np.int32)
    cfg = _cfg(epochs=2, batch_size=4, learning_rate=5e-2, log_every=100,
               mesh_axes={"data": 2}, checkpoint_dir=ckdir,
               checkpoint_every=0)
    trained = SPMDTrainer(graph, cfg, device="cpu").train(
        ids, np.roll(ids, -1, axis=1))
    return None if trained is None else _numpy(trained)


def _on_rank_audit(mesh_axes, rules: bool, corrupt_tick: int):
    """An audited run (audit_every=2) with a seeded bit-flip after step
    ``corrupt_tick``, and a clean audited run: the integrity counters,
    the quarantine events, the verdicts, and both runs' variables."""
    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.parallel import TRANSFORMER_TP_RULES
    from mmlspark_tpu_torch.train import SPMDTrainer

    x, y = _lm_rows()
    kw = dict(batch_size=16, mesh_axes=mesh_axes, audit_every=2,
              param_rules=TRANSFORMER_TP_RULES if rules else None)
    inj = FaultInjector([Fault("train.step", "corrupt", tick=corrupt_tick,
                               value=5)])
    hit = SPMDTrainer(_f32_lm(), _cfg(**kw), faults=inj, device="cpu")
    v_hit = hit.train(x, y)
    clean = SPMDTrainer(_f32_lm(), _cfg(**kw), device="cpu")
    v_clean = clean.train(x, y)
    tel = hit.telemetry.to_dict()
    return {
        "audits": tel["train.integrity.audits"],
        "suspected": tel["train.integrity.sdc_suspected"],
        "quarantined": [e["attrs"] for e in hit.recorder.events()
                        if e["name"] == "integrity.replica_quarantined"],
        "verdicts": [v["verdict"] for v in hit.replay_verdicts],
        "hit": _numpy(v_hit), "clean": _numpy(v_clean),
        "curve": [h["loss"] for h in hit.history],
        "clean_curve": [h["loss"] for h in clean.history],
    }


def _on_rank_demo(ckdir):
    from mmlspark_tpu_torch.train.demo import run_train_demo

    return run_train_demo(device="cpu", mesh="data=2,model=2", epochs=1,
                          n_samples=64, checkpoint_dir=ckdir)


def _on_rank_tpu_model(weights, rows):
    """The MLP's scores with data_parallel on the group, and off."""
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.stages import TPUModel

    ds = Dataset({"x": rows})
    weights = {b: {k: torch.from_numpy(t) for k, t in blk.items()}
               for b, blk in weights.items()}
    out = []
    for dp in (True, False):
        stage = TPUModel(model_name="mlp", model_config={
            "num_outputs": 3, "hidden": [8]}, input_col="x", batch_size=4,
            data_parallel=dp, device="cpu").set(weights=weights)
        out.append(np.asarray(stage.transform(ds)["scores"]))
    return out


def _on_rank_batch_norm():
    """ResNet-20 (width 4, float32) trained two steps over data=4 and on
    one device: both loss curves."""
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer

    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=16).astype(np.int32)
    curves = []
    for axes in ({"data": WORLD}, None):
        graph = build_model("resnet20_cifar10", width=4)
        for _, mod in graph.blocks:
            for m in mod.modules():
                if hasattr(m, "dtype"):
                    m.dtype = torch.float32
        trainer = SPMDTrainer(graph, _cfg(epochs=1, batch_size=8,
                                          mesh_axes=axes), device="cpu")
        trainer.train(x, y)
        curves.append([h["loss"] for h in trainer.history])
    return curves


# -- the tests ----------------------------------------------------------------


def test_kill_and_resume_bit_exact_2x2(ranks, tmp_path):
    """The 2x2 data x model case of the headline drill: a crash at step 3
    of 6, a resume, and the final params and the stitched loss curve
    bit-identical to a run that never crashed."""
    for r in ranks.run(_on_rank_kill_resume, str(tmp_path / "ck"),
                       {"data": 2, "model": 2}):
        assert r["killed"] and r["crashed_steps"] == [0, 1, 2]
        assert r["restored_steps"] == [0, 1, 2]
        assert r["resumed_steps"] == [3, 4, 5]
        assert r["stitched"] == r["full_curve"]
        for b in r["full"]:
            for k in r["full"][b]:
                np.testing.assert_array_equal(r["full"][b][k],
                                              r["resumed"][b][k])


def test_elastic_resume_at_reduced_data_width(ranks, tmp_path):
    """Crash at data=4, resume at data=2: the deterministic data order
    lets the narrower mesh pick up at the step the checkpoint committed,
    and its losses are the uninterrupted data=4 run's (only the
    reduction width differs)."""
    res = [r for r in ranks.run(_on_rank_elastic, str(tmp_path / "ck"))
           if r is not None]
    assert len(res) == 2
    for r in res:
        assert r["steps"] == [3, 4, 5]
        assert r["finite"] and all(np.isfinite(r["losses"]))
        np.testing.assert_allclose(r["losses"], r["full"][3:],
                                   atol=LOSS_TOL, rtol=LOSS_TOL)


def test_elastic_resume_rejects_incompatible_geometry(ranks, tmp_path):
    """A resume whose batch changes steps_per_epoch would replay or skip
    data: it is refused, with the JAX package's text."""
    errs = ranks.run(_on_rank_geometry, str(tmp_path / "ck"))
    assert all(e is not None and "steps_per_epoch=3" in e
               and "computes 2 (batch 48 over 2 data shards)" in e
               and "elastic resume needs a batch_size divisible" in e
               for e in errs)


def test_train_checkpoint_serve_roundtrip(ranks, tmp_path):
    """A checkpoint of a data=2 run (whole tensors, rank 0 writes),
    restored in a fresh target, serves through the port's ServeEngine
    exactly as ``generate()`` over the trained variables, under the
    serving compile pins."""
    from mmlspark_tpu_torch.models import (
        build_model,
        generate,
        init_variables,
    )
    from mmlspark_tpu_torch.serve import ServeEngine
    from mmlspark_tpu_torch.testing import serve_compile_guard
    from mmlspark_tpu_torch.train.resilience import AtomicCheckpointStore

    ckdir = str(tmp_path / "ck")
    got = [r for r in ranks.run(_on_rank_roundtrip, ckdir) if r is not None]
    assert len(got) == 2
    trained = {b: {k: torch.from_numpy(t) for k, t in blk.items()}
               for b, blk in got[0].items()}
    graph = build_model("transformer_lm", vocab_size=8, d_model=32,
                        heads=2, depth=2, max_len=32)
    params = init_variables(graph, 1, device="cpu")
    flat = [t for block in params.values() for t in block.values()]
    target = {"params": params,
              "opt_state": {"count": torch.zeros((), dtype=torch.int32),
                            "mu": [torch.zeros_like(t) for t in flat],
                            "nu": [torch.zeros_like(t) for t in flat]},
              "anomaly": {"streak": torch.zeros((), dtype=torch.int32),
                          "total": torch.zeros((), dtype=torch.int32)}}
    state, meta, step = AtomicCheckpointStore(ckdir).restore(target)
    assert step == 3 and int(meta["steps_per_epoch"]) == 2
    for b in trained:
        for k in trained[b]:
            assert torch.equal(state["params"][b][k], trained[b][k])
    ids = np.repeat(((np.arange(16)[None, :] % 4) + 1), 8, axis=0)
    prompt = ids[0, :4].astype(np.int32)
    ref = generate(graph, trained, prompt[None], 8, device="cpu")[0]
    engine = ServeEngine(graph, state["params"], slots=2, cache_len=32,
                         decode_block=4, device="cpu")
    with serve_compile_guard(engine, min_decode=1, min_prefill=1):
        rid = engine.submit(prompt, max_new_tokens=8)
        res = engine.run()[rid]
    assert res.status == "completed"
    np.testing.assert_array_equal(np.asarray(res.tokens), np.asarray(ref))


def test_audit_vote_repairs_a_corrupted_replica(ranks):
    """A seeded bit-flip lands in ONE rank's replica after step 3's
    dispatch; the audit right after folds every replica, the majority
    outvotes the flipped one, which is re-replicated from a good rank
    (``integrity.replica_quarantined``) before any step reads it, the
    replay calls it a one-off, and the run ends bit-equal to a clean one
    on every rank. (A flip that a later step reads first reaches every
    replica through the gradient sum, as in the JAX package.)"""
    res = ranks.run(_on_rank_audit, {"data": 4}, False, 3)
    for r in res:
        assert r["audits"] == 3 and r["suspected"] == 1
        assert len(r["quarantined"]) == 1
        event = r["quarantined"][0]
        assert len(event["devices"]) == 1
        assert event["source"] not in event["devices"]
        assert r["verdicts"] == ["transient_sdc"]
        assert r["curve"] == r["clean_curve"]
        for b in r["clean"]:
            for k in r["clean"][b]:
                np.testing.assert_array_equal(r["hit"][b][k],
                                              r["clean"][b][k])


def test_no_vote_under_param_rules(ranks):
    """Under rules a rank's copy is a shard: no vote, no quarantine, and
    (as in the JAX package) the drill does not flip a shard."""
    for r in (x for x in ranks.run(_on_rank_audit, {"data": 2, "model": 2},
                                   True, 3) if x is not None):
        assert r["audits"] == 3 and r["suspected"] == 0
        assert r["quarantined"] == [] and r["verdicts"] == []
        assert r["curve"] == r["clean_curve"]


def test_run_train_demo_over_a_mesh(ranks, tmp_path):
    """The demo over a 2x2 mesh: the JAX demo's keys, every rank's
    metrics the same run's."""
    outs = ranks.run(_on_rank_demo, str(tmp_path / "ck"))
    assert all(o["steps_total"] == 2 and o["restarts"] == 0 for o in outs)
    assert len({o["final_loss"] for o in outs}) == 1
    assert np.isfinite(outs[0]["final_loss"])
    assert outs[0]["checkpoint_steps"] == [0, 1]


def test_tpu_model_data_parallel_on_a_group(ranks):
    """TPUModel(data_parallel) on a group: each rank scores its block of
    the rows, the scores come back in row order, equal to one device's."""
    from mmlspark_tpu_torch.models import build_model, init_variables

    graph = build_model("mlp", num_outputs=3, hidden=(8,))
    graph.size_input((5,))
    weights = init_variables(graph, 0, device="cpu")
    rows = np.random.default_rng(0).normal(size=(13, 5)).astype(np.float32)
    for dp, single in ranks.run(_on_rank_tpu_model, _numpy(weights), rows):
        assert dp.shape == (13, 3)
        np.testing.assert_array_equal(dp, single)


def test_batch_norm_statistics_span_the_data_ranks(ranks):
    """BatchNorm in a mesh step reduces its batch statistics over every
    data rank (the global batch's, as the JAX package's BatchNorm sees
    the sharded array): a float32 ResNet-20 over data=4 follows the
    one-device curve."""
    for meshed, single in ranks.run(_on_rank_batch_norm):
        np.testing.assert_allclose(meshed, single, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)


def test_dryrun_multichip():
    """The graft entry's data-parallel leg: one full ResNet-20 (width 8)
    step over data=4 on 4 gloo ranks of its own."""
    from mmlspark_tpu_torch.entry import dryrun_multichip

    losses = dryrun_multichip(4)
    assert len(losses) == 4 and np.isfinite(losses[0])
