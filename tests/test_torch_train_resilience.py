"""The port's training resilience (``mmlspark_tpu_torch.train``) against
the contract of ``tests/test_train_resilience.py``, on the CPU.

The single-device drills run on the port's MLP (``hidden=(8,)``) over the
JAX tests' two-blob float data: an inert injector changes nothing; a kill
at step 3 of 6 resumes bit-exact (parameters and the stitched loss
curve); a torn checkpoint and a bit-flipped one leave the previous
checkpoint restorable and the resume still bit-exact; the anomaly
quarantine skips, counts and aborts; transients are retried invisibly or
escape past the limit; resource exhaustion — injected at the hook, or a
real allocation failure inside the step — walks the accumulation ladder
and captures one program a rung; the train -> checkpoint -> serve round
trip serves the restored weights through the port's ``ServeEngine``
under the serving compile pins.

Cross-framework cases hold the port to the JAX package: the port's
``mlp`` on bridged flax weights gives the JAX ``mlp``'s logits (bit-equal
here: both compute in bf16 with one f32-accumulated product a layer,
tolerance 1e-6), and the port's and the JAX package's ``run_train_demo``
under the same seeded fault specs, on one device (``mesh="data=1"`` for
JAX), from the same initial weights, give equal counters, restart counts
and checkpoint steps, and loss curves within 1e-3 (bf16 products rounded
by two libraries; the measured gap is ~2e-4).

Left out, with meshes (ROADMAP.md Queue 1 item 13): the 2x2 data x model
mesh case of the kill drill and the elastic-resume pair (a checkpoint
taken at one data width resumed at another).
"""

from __future__ import annotations

import json
import logging

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.train.demo import run_train_demo as jax_run_train_demo
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import (
    EngineKilled,
    Fault,
    FaultInjector,
    TransientFault,
    parse_fault_spec,
)
from mmlspark_tpu_torch.core.integrity import (
    CheckpointCorruption,
    flip_bit_in_dir,
)
from mmlspark_tpu_torch.models import (
    build_model,
    generate,
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.serve import ServeEngine
from mmlspark_tpu_torch.testing import serve_compile_guard
from mmlspark_tpu_torch.train import (
    AtomicCheckpointStore,
    SPMDTrainer,
    TrainConfig,
    next_accum_rung,
    run_train_demo,
)
from mmlspark_tpu_torch.train import trainer as trainer_mod


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DEMO_LOSS_TOL = 1e-3
LOGIT_TOL = 1e-6


def _two_blob_data(n=96, d=8, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate(
        [rng.normal(-1.5, 1.0, (half, d)), rng.normal(1.5, 1.0, (half, d))]
    ).astype(np.float32)
    y = np.concatenate([np.zeros(half), np.ones(half)]).astype(np.int32)
    perm = rng.permutation(n)
    return x[perm], y[perm]


def _cfg(**kw):
    base = dict(epochs=2, batch_size=32, learning_rate=1e-2,
                shuffle=False, log_every=1, retry_backoff_s=0.0)
    base.update(kw)
    return TrainConfig(**base)


def _mlp():
    return build_model("mlp", num_outputs=2, hidden=(8,))


def _trainer(cfg, faults=None):
    return SPMDTrainer(_mlp(), cfg, faults=faults, device="cpu")


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for block in a:
        assert a[block].keys() == b[block].keys()
        for name in a[block]:
            assert torch.equal(a[block][name], b[block][name]), (block, name)


def _target(graph, x, opt="adam"):
    """A restore target rebuilt from scratch, as a new process holds it."""
    graph.size_input(x.shape[1:])
    params = init_variables(graph, 0, device="cpu")
    flat = [t for block in params.values() for t in block.values()]
    opt_state = {"count": torch.zeros((), dtype=torch.int32)}
    if opt == "adam":
        opt_state["mu"] = [torch.zeros_like(t) for t in flat]
        opt_state["nu"] = [torch.zeros_like(t) for t in flat]
    return {"params": params, "opt_state": opt_state,
            "anomaly": {"streak": torch.zeros((), dtype=torch.int32),
                        "total": torch.zeros((), dtype=torch.int32)}}


@pytest.fixture(scope="module")
def data():
    return _two_blob_data()


@pytest.fixture(scope="module")
def clean(data):
    """The uninterrupted 6-step run: (variables, loss curve)."""
    tr = _trainer(_cfg())
    v = tr.train(*data)
    return v, [h["loss"] for h in tr.history]


# -- hook sites and the ladder ------------------------------------------------


def test_unknown_site_error_lists_train_sites():
    with pytest.raises(FriendlyError, match=r"train\.step"):
        Fault("train.bogus", "kill")
    with pytest.raises(FriendlyError, match=r"train\.checkpoint"):
        FaultInjector(site_rates={"train.bogus": {"kill": 1.0}})


def test_parse_fault_spec_accepts_and_lists_train_sites():
    inj = parse_fault_spec(
        "seed=3,train.step:transient=0.5,train.data:poison=0.25,"
        "train.checkpoint:kill=0.1,train.restore:transient=0.1"
    )
    assert set(inj.site_rates) == {
        "train.step", "train.data", "train.checkpoint", "train.restore",
    }
    with pytest.raises(FriendlyError, match=r"train\.restore"):
        parse_fault_spec("train.bogus:kill=1.0")


def test_next_accum_rung_power_of_two_ladder():
    assert next_accum_rung(1, batch=32, n_data=8) == 2
    assert next_accum_rung(2, batch=32, n_data=8) == 4
    assert next_accum_rung(4, batch=32, n_data=8) is None  # 1 row/shard
    assert next_accum_rung(1, batch=8, n_data=8) is None
    assert next_accum_rung(1, batch=32, n_data=1) == 2
    assert next_accum_rung(16, batch=32, n_data=1) == 32
    assert next_accum_rung(32, batch=32, n_data=1) is None


def test_checkpoint_dir_and_audit_every_are_accepted(tmp_path, data):
    """The fields the trainer used to refuse: a checkpointed, audited run
    trains, commits its checkpoints and audits at its cadence."""
    tr = _trainer(_cfg(checkpoint_dir=str(tmp_path / "ck"),
                       checkpoint_every=2, max_checkpoints=2, audit_every=3))
    tr.train(*data)
    assert AtomicCheckpointStore(str(tmp_path / "ck")).steps() == [4, 5]
    tel = tr.telemetry.to_dict()
    assert tel["train.checkpoints"] == 4  # steps 0, 2, 4 and the end, 5
    assert tel["train.integrity.audits"] == 2
    assert tel["train.integrity.sdc_suspected"] == 0
    # a mesh wider than one device needs a process group (the mesh mode's
    # tests run over gloo ranks, tests/test_torch_trainer_mesh*.py)
    with pytest.raises(FriendlyError, match="initialised process group"):
        _trainer(_cfg(mesh_axes={"data": 2})).train(*data)


# -- disabled / inert hooks change nothing ---------------------------------------


def test_inert_injector_is_bit_identical_to_disabled(data, clean):
    tr = _trainer(_cfg(), faults=FaultInjector([]))
    _assert_trees_equal(clean[0], tr.train(*data))
    assert [h["loss"] for h in tr.history] == clean[1]


# -- kill -> bit-exact resume ---------------------------------------------------


def _crash(tmp_path, data, site="train.step", tick=3):
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    crashed = _trainer(_cfg(**ck),
                       FaultInjector([Fault(site, "kill", tick=tick)]))
    with pytest.raises(EngineKilled):
        crashed.train(*data)
    return ck, crashed


def test_kill_and_resume_bit_exact(tmp_path, data, clean):
    """Crash at step 3 of 6, resume: the final parameters and the stitched
    loss curve are bit-identical to the run that never crashed."""
    ck, crashed = _crash(tmp_path, data)
    assert [h["step"] for h in crashed.history] == [0, 1, 2]
    resumed = _trainer(_cfg(**ck))
    v = resumed.train(*data)
    assert [h["step"] for h in resumed.restored_history] == [0, 1, 2]
    assert [h["step"] for h in resumed.history] == [3, 4, 5]
    stitched = [h["loss"] for h in
                resumed.restored_history + resumed.history]
    assert stitched == clean[1]
    _assert_trees_equal(clean[0], v)
    assert any(e["name"] == "restore" for e in resumed.recorder.events())


def test_torn_checkpoint_keeps_previous_restorable(tmp_path, data, clean):
    ck, _ = _crash(tmp_path, data, site="train.checkpoint", tick=2)
    store = AtomicCheckpointStore(ck["checkpoint_dir"])
    assert store.steps() == [0, 1]  # step 2's write is torn debris
    assert not (tmp_path / "ck" / "step-2.json").exists()
    assert (tmp_path / "ck" / "payload-2.tmp").is_dir()
    resumed = _trainer(_cfg(**ck))
    v = resumed.train(*data)
    assert resumed.history[0]["step"] == 2  # replays exactly one step
    _assert_trees_equal(clean[0], v)


def test_bit_flipped_checkpoint_raises_typed_error_and_quarantines(
        tmp_path, data):
    ck, _ = _crash(tmp_path, data)
    ckdir = tmp_path / "ck"
    store = AtomicCheckpointStore(str(ckdir))
    assert store.latest_step() == 2
    manifest = json.loads((ckdir / "step-2.json").read_text())
    flip_bit_in_dir(str(ckdir / "payload-2"), 5)
    with pytest.raises(CheckpointCorruption) as exc:
        store.restore(_target(_mlp(), data[0]))
    assert exc.value.step == 2
    assert exc.value.expected == manifest["payload_sha256"]
    assert exc.value.actual != exc.value.expected
    assert exc.value.expected in str(exc.value)
    assert exc.value.actual in str(exc.value)
    assert (ckdir / "step-2.json.corrupt").exists()
    assert not (ckdir / "step-2.json").exists()
    assert AtomicCheckpointStore(str(ckdir)).latest_step() == 1


def test_bit_flipped_checkpoint_resume_falls_back_bit_exact(tmp_path, data,
                                                            clean):
    ck, _ = _crash(tmp_path, data)
    ckdir = tmp_path / "ck"
    manifest = json.loads((ckdir / "step-2.json").read_text())
    flip_bit_in_dir(str(ckdir / "payload-2"), 9)
    resumed = _trainer(_cfg(**ck))
    v = resumed.train(*data)
    fails = resumed.telemetry.counter("train.integrity.checksum_failures")
    assert fails.value == 1
    ev = [e for e in resumed.recorder.events()
          if e["name"] == "integrity.checksum_failure"]
    assert len(ev) == 1
    assert ev[0]["attrs"]["expected"] == manifest["payload_sha256"]
    assert ev[0]["attrs"]["actual"] != ev[0]["attrs"]["expected"]
    assert [h["step"] for h in resumed.restored_history] == [0, 1]
    assert resumed.history[0]["step"] == 2
    _assert_trees_equal(clean[0], v)


def test_corrupt_at_checkpoint_site_is_caught_on_resume(tmp_path, data,
                                                        clean):
    """The ``train.checkpoint`` corrupt drill flips a bit after the hash:
    the manifest commits, and the next resume refuses it and falls back
    to the checkpoint before."""
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    crashed = _trainer(_cfg(**ck), FaultInjector([
        Fault("train.checkpoint", "corrupt", tick=2),
        Fault("train.step", "kill", tick=3)]))
    with pytest.raises(EngineKilled):
        crashed.train(*data)
    assert AtomicCheckpointStore(ck["checkpoint_dir"]).steps() == [0, 1, 2]
    resumed = _trainer(_cfg(**ck))
    v = resumed.train(*data)
    assert resumed.telemetry.counter(
        "train.integrity.checksum_failures").value == 1
    assert resumed.history[0]["step"] == 2
    _assert_trees_equal(clean[0], v)


def test_checkpoint_payload_is_npy_without_pickle(tmp_path):
    """One ``.npy`` per leaf at its path, loadable with pickles refused;
    a bf16 leaf comes back bit for bit; a mismatched target raises."""
    store = AtomicCheckpointStore(str(tmp_path / "ck"))
    state = {"a": {"w": torch.randn(3, 4), "h": torch.randn(5).bfloat16()},
             "opt": {"count": torch.tensor(7, dtype=torch.int32),
                     "mu": [torch.randn(2), torch.randn(1, 1)]}}
    store.save(4, state, meta={"history": [{"loss": float("nan")}]})
    files = sorted(p.relative_to(tmp_path / "ck" / "payload-4").as_posix()
                   for p in (tmp_path / "ck" / "payload-4").rglob("*")
                   if p.is_file())
    assert files == ["a/h.npy", "a/w.npy", "opt/count.npy", "opt/mu/0.npy",
                     "opt/mu/1.npy"]
    for f in files:
        np.load(tmp_path / "ck" / "payload-4" / f, allow_pickle=False)
    got, meta, step = store.restore(state)
    assert step == 4 and np.isnan(meta["history"][0]["loss"])
    for a, b in zip(_flat(got), _flat(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(FriendlyError, match="the target"):
        store.restore({**state, "a": {**state["a"], "w": torch.zeros(4, 3)}})


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def test_incompatible_geometry_refused(tmp_path, data):
    """A resume whose batch changes steps_per_epoch would replay or skip
    data: it is refused."""
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    _trainer(_cfg(epochs=1, batch_size=32, **ck)).train(*data)
    with pytest.raises(FriendlyError, match="steps_per_epoch"):
        _trainer(_cfg(epochs=2, batch_size=48, **ck)).train(*data)


# -- the anomaly quarantine ----------------------------------------------------------


def test_anomaly_skips_update_without_advancing(tmp_path):
    x, y = _two_blob_data(n=32)
    cfg = _cfg(epochs=1, checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=1)
    graph = _mlp()
    graph.size_input(x.shape[1:])
    init = init_variables(graph, 0, device="cpu")
    tr = SPMDTrainer(graph, cfg, faults=FaultInjector(
        [Fault("train.data", "poison", tick=0)]), device="cpu")
    trained = tr.train(x, y, init_variables=init)
    _assert_trees_equal(init, trained)
    assert tr.telemetry.counter("train.anomalies_skipped").value == 1
    assert [h["step"] for h in tr.history] == [0]
    assert not np.isfinite(tr.history[0]["loss"])
    assert any(e["name"] == "anomaly" for e in tr.recorder.events())
    # the checkpoint carries the proof: adam's count is still 0, and the
    # anomaly carries persisted as (streak=1, total=1)
    state, _, step = AtomicCheckpointStore(str(tmp_path / "ck")).restore(
        _target(_mlp(), x))
    assert step == 0
    assert int(state["opt_state"]["count"]) == 0
    assert int(state["anomaly"]["streak"]) == 1
    assert int(state["anomaly"]["total"]) == 1


def test_anomaly_streak_aborts_with_recorder_dump(caplog, data):
    tr = _trainer(_cfg(epochs=1, anomaly_limit=3), FaultInjector(
        [Fault("train.data", "poison", times=10)]))
    with caplog.at_level(logging.ERROR, logger="mmlspark_tpu_torch"):
        with pytest.raises(FriendlyError, match="consecutive anomalous"):
            tr.train(*data)
    assert "flight recorder dump" in caplog.text
    anomalies = [e for e in tr.recorder.events() if e["name"] == "anomaly"]
    assert len(anomalies) == 3
    assert anomalies[-1]["attrs"]["streak"] == 3
    assert tr.telemetry.counter("train.anomalies_skipped").value == 3


def test_grad_norm_explosion_quarantined():
    x, y = _two_blob_data(n=32)
    graph = _mlp()
    graph.size_input(x.shape[1:])
    init = init_variables(graph, 0, device="cpu")
    tr = SPMDTrainer(graph, _cfg(epochs=1, max_grad_norm=1e-9,
                                 anomaly_limit=0), device="cpu")
    _assert_trees_equal(init, tr.train(x, y, init_variables=init))
    assert tr.telemetry.counter("train.anomalies_skipped").value == 1


# -- transient retry / stall -------------------------------------------------------


def test_transient_retries_are_invisible_to_results(data, clean):
    inj = FaultInjector(
        [Fault("train.step", "transient", times=2),
         Fault("train.data", "transient", times=1),
         Fault("train.step", "stall", times=1)],
        stall_s=0.001,
    )
    tr = _trainer(_cfg(), inj)
    _assert_trees_equal(clean[0], tr.train(*data))
    assert tr.telemetry.counter("train.retries_total").value == 3
    assert inj.counts.get("stall") == 1
    retries = [e for e in tr.recorder.events() if e["name"] == "retry"]
    assert len(retries) == 3


def test_transient_beyond_retry_limit_escapes():
    tr = _trainer(_cfg(epochs=1, retry_limit=2), FaultInjector(
        [Fault("train.step", "transient", times=5)]))
    with pytest.raises(TransientFault):
        tr.train(*_two_blob_data(n=32))
    assert tr.telemetry.counter("train.retries_total").value == 2


# -- resource exhaustion -> the accumulation ladder ---------------------------------


def test_oom_degrades_down_accumulation_ladder(data):
    tr = _trainer(_cfg(), FaultInjector([Fault("train.step", "oom",
                                               tick=1)]))
    tr.train(*data)
    assert tr.telemetry.gauge("train.grad_accum").value == 2
    degraded = [e for e in tr.recorder.events() if e["name"] == "degraded"]
    assert degraded and degraded[0]["attrs"]["grad_accum"] == 2
    assert [h["step"] for h in tr.history] == [0, 1, 2, 3, 4, 5]
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    # one program a rung, each counted
    assert tr.telemetry.counter("retrace.train.step").value == 2


def test_real_oom_inside_the_step_leaves_state_and_walks_the_ladder(
        data, monkeypatch):
    """An allocation failure raised inside the step (its forward) leaves
    parameters, moments and the count untouched: the step runs again at
    the next rung, so the run equals one whose hook injected the OOM."""
    want_tr = _trainer(_cfg(), FaultInjector([Fault("train.step", "oom",
                                                    tick=1)]))
    want = want_tr.train(*data)
    calls = []
    masked_loss = trainer_mod.masked_loss

    def failing(*args):
        calls.append(1)
        if len(calls) == 2:  # step 1's forward, at grad_accum 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return masked_loss(*args)

    monkeypatch.setattr(trainer_mod, "masked_loss", failing)
    tr = _trainer(_cfg())
    _assert_trees_equal(want, tr.train(*data))
    assert [h["loss"] for h in tr.history] == \
        [h["loss"] for h in want_tr.history]
    assert tr.telemetry.gauge("train.grad_accum").value == 2
    assert tr.telemetry.counter("retrace.train.step").value == 2


def test_oom_with_ladder_exhausted_aborts():
    tr = _trainer(_cfg(epochs=1, batch_size=1), FaultInjector(
        [Fault("train.step", "oom", tick=0)]))
    with pytest.raises(FriendlyError, match="ladder"):
        tr.train(*_two_blob_data(n=16))


# -- audits -----------------------------------------------------------------------


@pytest.mark.parametrize("k,tick", [(1, 1), (2, 0)],
                         ids=["per-step", "dispatch-2"])
def test_corrupt_at_an_audit_step_is_replayed_and_adopted(data, clean, k,
                                                          tick):
    """A bit flipped after an audit step's fold is caught by that audit;
    the replay from the last clean state reproduces the in-graph fold
    (``transient_sdc``), and the replayed state is adopted: the run ends
    bit-identical to the clean one. With K=2 steps a dispatch the fold
    runs once a group (3-step epochs: groups (0, 1), (2), (3, 4), (5)),
    and the drill fires once a group, at its first step's tick."""
    tr = _trainer(_cfg(audit_every=2, steps_per_dispatch=k),
                  FaultInjector([Fault("train.step", "corrupt",
                                       tick=tick)]))
    v = tr.train(*data)
    tel = tr.telemetry.to_dict()
    assert tel["train.integrity.audits"] == 3
    assert tel["train.integrity.sdc_suspected"] == 1
    assert tel["train.integrity.replay_transient_sdc"] == 1
    (verdict,) = tr.replay_verdicts
    assert verdict["verdict"] == "transient_sdc"
    assert verdict["replayed_checksum"] == verdict["device_checksum"]
    assert verdict["majority_checksum"] != verdict["device_checksum"]
    _assert_trees_equal(clean[0], v)
    # a K-step group logs its last step's loss
    assert [h["step"] for h in tr.history] == \
        ([0, 1, 2, 3, 4, 5] if k == 1 else [1, 2, 4, 5])
    assert [h["loss"] for h in tr.history] == \
        [clean[1][h["step"]] for h in tr.history]


def test_nondeterministic_replay_keeps_the_current_state(data, monkeypatch):
    """A replay that reproduces neither fold is judged
    ``software_nondeterminism``, and the state the run had stands."""
    tr = _trainer(_cfg(epochs=1, audit_every=2),
                  FaultInjector([Fault("train.step", "corrupt", tick=1)]))
    folds = []
    host = trainer_mod.integrity.tree_checksum_host

    def drifting(tree):
        folds.append(1)
        return host(tree) ^ (1 if len(folds) == 2 else 0)

    monkeypatch.setattr(trainer_mod.integrity, "tree_checksum_host",
                        drifting)
    tr.train(*_two_blob_data(n=64))
    (verdict,) = tr.replay_verdicts
    assert verdict["verdict"] == "software_nondeterminism"
    assert tr.telemetry.counter(
        "train.integrity.replay_software_nondeterminism").value == 1


# -- train -> checkpoint -> serve round trip ----------------------------------------


def test_train_checkpoint_serve_roundtrip(tmp_path):
    """A checkpoint written by the trainer, restored through the store
    into a target rebuilt from scratch, serves through the port's
    ``ServeEngine`` exactly as ``generate()`` over the trained variables,
    under the serving compile pins."""
    graph = build_model("transformer_lm", vocab_size=8, d_model=32,
                        heads=2, depth=2, max_len=32)
    ids = np.repeat(((np.arange(16)[None, :] % 4) + 1), 8, axis=0)
    ids = ids.astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    cfg = _cfg(epochs=2, batch_size=4, learning_rate=5e-2, log_every=100,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=0)
    trained = SPMDTrainer(graph, cfg, device="cpu").train(ids, labels)

    params = init_variables(graph, 1, device="cpu")
    flat = [t for block in params.values() for t in block.values()]
    target = {"params": params,
              "opt_state": {"count": torch.zeros((), dtype=torch.int32),
                            "mu": [torch.zeros_like(t) for t in flat],
                            "nu": [torch.zeros_like(t) for t in flat]},
              "anomaly": {"streak": torch.zeros((), dtype=torch.int32),
                          "total": torch.zeros((), dtype=torch.int32)}}
    state, meta, step = AtomicCheckpointStore(
        str(tmp_path / "ck")).restore(target)
    assert step == 3 and int(meta["steps_per_epoch"]) == 2
    assert int(state["opt_state"]["count"]) == 4
    _assert_trees_equal(state["params"], trained)

    prompt = ids[0, :4]
    ref = generate(graph, trained, prompt[None], 8, device="cpu")[0]
    engine = ServeEngine(graph, state["params"], slots=2, cache_len=32,
                         decode_block=4, device="cpu")
    with serve_compile_guard(engine, min_decode=1, min_prefill=1):
        rid = engine.submit(prompt, max_new_tokens=8)
        res = engine.run()[rid]
    assert res.status == "completed"
    np.testing.assert_array_equal(np.asarray(res.tokens), np.asarray(ref))


# -- against the JAX package ---------------------------------------------------------


def _jax_mlp_init(hidden, features=8, classes=2, seed=0):
    g = jax_build_model("mlp", num_outputs=classes, hidden=hidden)
    return g, jax.device_get(g.init(jax.random.PRNGKey(seed),
                                    np.zeros((1, features), np.float32)))


def test_mlp_logits_match_jax_on_bridged_weights():
    x = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    jg, jv = _jax_mlp_init((16, 8), classes=3)
    want = np.asarray(jg.apply(jv, x))
    graph = build_model("mlp", num_outputs=3, hidden=(16, 8))
    variables = load_flax_variables(graph, jv, device="cpu")
    assert variables["hidden1"]["Dense_0.weight"].shape == (16, 8)
    got = graph.apply(variables, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    linear = build_model("linear", num_outputs=1)
    with pytest.raises(FriendlyError, match="no input width"):
        init_variables(linear, 0, device="cpu")
    linear.size_input(x.shape[1:])
    with pytest.raises(FriendlyError, match="sized for 8"):
        linear.size_input((5,))
    assert linear.apply(init_variables(linear, 0, device="cpu"),
                        torch.from_numpy(x)).shape == (16, 1)


DEMO_SPECS = [
    dict(audit_every=1, faults="seed=3,train.step:corrupt=0.2"),
    dict(audit_every=2, faults="seed=3,train.step:corrupt=0.2"),
    dict(faults="seed=0,train.step:kill=0.15,train.data:poison=0.1,"
                "train.data:transient=0.1,train.checkpoint:kill=0.05,"
                "train.step:oom=0.05"),
    dict(faults="seed=6,train.step:kill=0.15,train.data:poison=0.1,"
                "train.data:transient=0.1,train.checkpoint:kill=0.05,"
                "train.step:oom=0.05"),
]


@pytest.mark.parametrize("kw", DEMO_SPECS,
                         ids=["corrupt-audit1", "corrupt-audit2",
                              "kill-mix-seed0", "kill-mix-seed6"])
def test_run_train_demo_matches_jax(kw, tmp_path, monkeypatch):
    """The same seeded fault spec drives the same faults through both
    demos: every counter, the restart count, the injected kinds, the
    history and checkpoint steps are equal, and the loss curves agree.
    The port's trainers start from the JAX demo's flax initialisation,
    carried across by the bridge."""
    _, jv = _jax_mlp_init((16,))
    port_init = load_flax_variables(
        build_model("mlp", num_outputs=2, hidden=(16,)), jv, device="cpu")
    monkeypatch.setattr(trainer_mod.bridge, "init_variables",
                        lambda graph, seed, device: port_init)
    common = dict(epochs=2, n_samples=96, batch_size=32, seed=0, **kw)
    want = jax_run_train_demo(mesh="data=1",
                              checkpoint_dir=str(tmp_path / "jax"), **common)
    got = run_train_demo(device="cpu",
                         checkpoint_dir=str(tmp_path / "port"), **common)
    assert want["restarts"] == got["restarts"]
    for key, value in want.items():
        if key.startswith(("train.", "faults_injected")) and \
                isinstance(value, (int, dict)) and not isinstance(value,
                                                                   bool):
            assert got[key] == value, key
    for key in ("steps_total", "history_len", "checkpoint_steps"):
        assert got[key] == want[key], key
    assert [v["verdict"] for v in got["replay_verdicts"]] == \
        [v["verdict"] for v in want["replay_verdicts"]]
    if kw.get("audit_every") == 2:
        # both flips land on non-audit steps (ticks 0 and 4): the next step
        # consumes each before any audit looks, on both sides alike — but
        # in another element (the port keeps a Dense kernel transposed),
        # so the trajectories part there
        assert got["train.integrity.sdc_suspected"] == 0
        assert np.isfinite(got["final_loss"])
    else:
        assert got["final_loss"] == pytest.approx(want["final_loss"],
                                                  abs=DEMO_LOSS_TOL)
    if kw.get("audit_every") == 1:
        assert got["train.integrity.sdc_suspected"] == 2


def test_demo_refuses_a_mesh_and_writes_telemetry(tmp_path):
    # a mesh needs a process group (the demo over ranks:
    # tests/test_torch_trainer_mesh_resilience.py)
    with pytest.raises(FriendlyError, match="initialised process group"):
        run_train_demo(device="cpu", mesh="data=2")
    out = run_train_demo(device="cpu", epochs=1, n_samples=64,
                         telemetry_dir=str(tmp_path / "tel"),
                         checkpoint_dir=str(tmp_path / "ck"))
    assert out["steps_total"] == 2 and out["restarts"] == 0
    events = (tmp_path / "tel" / "events.jsonl").read_text().splitlines()
    assert json.loads(events[0])["header"] == "flight_recorder"
    assert json.loads((tmp_path / "tel" / "metrics.json").read_text())[
        "train.checkpoints"] == 2
