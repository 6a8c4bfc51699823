"""The port's multi-model serving (``mmlspark_tpu_torch/serve/
multimodel.py``) against the JAX package's, mirroring the 20 tests of
``tests/test_multimodel.py``.

One engine hosts several named deployments — LM engines next to
stateless power-of-two-bucketed batch deployments (an imported ONNX
file among them) — behind one ``submit(model=...)/step()/run()``
facade. The bars:

- every LM stream equals the JAX ``MultiModelEngine``'s on the same
  bridged weights and schedule, and a dedicated port ``ServeEngine``'s;
- a bucket-size batch is bit-equal to the port graph's direct ``apply``
  on the same batch, and within 2e-2 of the JAX deployment's output (both
  compute the MLP in bf16; the ONNX file runs in f32 and agrees within
  1e-5);
- program counts, fault outcomes, admission caps, metric names and spec
  errors equal the JAX package's.

The LM is the JAX package's overfit periodic LM bridged into the port
(wide greedy margins, so bf16 rounding cannot flip a token); ONE JAX
multi-model run in the module fixture gives the reference streams,
outputs, program counts, metrics keys and Prometheus names. Spec-built
variables are seeded ``torch.Generator`` draws, which cannot equal the
JAX package's ``PRNGKey`` draws (ROADMAP.md Queue 3): the parity tests
pass bridged variables in.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.core.exceptions import FriendlyError as JaxFriendlyError
from mmlspark_tpu.core.faults import parse_fault_spec as jax_fault_spec
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.models.onnx_export import save_onnx as jax_save_onnx
from mmlspark_tpu.serve.multimodel import BatchDeployment as JaxBatch
from mmlspark_tpu.serve.multimodel import MultiModelEngine as JaxMultiModel
from mmlspark_tpu.serve.multimodel import engine_from_spec as jax_from_spec
from mmlspark_tpu.serve.multimodel import parse_models_spec as jax_parse
from mmlspark_tpu.serve.supervisor import ReplicaSet as JaxReplicaSet
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import EngineKilled, parse_fault_spec
from mmlspark_tpu_torch.core.perf import SloTargets
from mmlspark_tpu_torch.models import (
    build_model,
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.serve import (
    BatchDeployment,
    MultiModelEngine,
    ReplicaSet,
    ServeEngine,
    engine_from_spec,
    parse_models_spec,
)
from mmlspark_tpu_torch.testing import compile_guard, serve_compile_guard


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
#: the LM's prompts (prefixes of the periodic training row) and budget
LM_LENGTHS, LM_NEW = (5, 9, 4, 7), 5
#: the batch deployments' bf16-vs-bf16 tolerance (one bf16 ulp at the
#: outputs' magnitudes) and the ONNX file's f32 one
BF16_TOL, F32_TOL = 2e-2, 1e-5


def _flax_mlp(num_outputs=3, hidden=(16,), seed=1):
    """A JAX MLP and seeded flax variables shaped by ``eval_shape``."""
    g = jax_build_model("mlp", num_outputs=num_outputs, hidden=hidden)
    shapes = jax.eval_shape(g.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.float32))
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.5, s.shape).astype(np.float32), shapes)
    return g, v


def _port_mlp(num_outputs=3, hidden=(16,), seed=1):
    """(jax graph, flax variables, port graph, port variables)."""
    jg, jv = _flax_mlp(num_outputs, hidden, seed)
    tg = build_model("mlp", num_outputs=num_outputs, hidden=hidden)
    return jg, jv, tg, load_flax_variables(tg, jv, device="cpu")


def _examples(n, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(dim,)).astype(np.float32) for _ in range(n)]


def _prom_families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE")}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The bridged overfit LM, the MLP pair, an exported ONNX file and ONE
    JAX multi-model run over lm + clf + ox (device budget 2)."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    row = np.array(ids[0])
    tg = build_model("transformer_lm", **TINY)
    tv = load_flax_variables(tg, jv, device="cpu")
    jclf, jclfv, clf, clfv = _port_mlp()
    path = str(tmp_path_factory.mktemp("mm") / "clf.onnx")
    jax_save_onnx(jclf, jclfv, (1, 8), path)
    xs, oxs = _examples(4, seed=3), _examples(4, seed=4)

    eng = JaxMultiModel(device_budget=2)
    eng.add_lm("lm", jg, jv, slots=2, cache_len=32, max_queue=8)
    eng.add_batch("clf", jclf, jclfv, max_batch=4)
    eng.add_onnx("ox", path, max_batch=4)
    gids = [eng.submit(row[:n], model="lm", max_new_tokens=LM_NEW)
            for n in LM_LENGTHS[:2]]
    gids += [eng.submit(x, model="clf") for x in xs]
    gids += [eng.submit(x, model="ox") for x in oxs]
    res = eng.run()
    return dict(
        jg=jg, jv=jv, tg=tg, tv=tv, row=row, jclf=jclf, jclfv=jclfv,
        clf=clf, clfv=clfv, path=path, xs=xs, oxs=oxs,
        streams=[np.asarray(res[g].tokens) for g in gids[:2]],
        outputs=[np.asarray(res[g].output) for g in gids[2:]],
        metrics=eng.metrics_dict(), prom=eng.to_prometheus(),
        batch_counts={n: eng.deployment(n).batch_compile_count
                      for n in ("clf", "ox")},
    )


def _engine(ref, **kw) -> MultiModelEngine:
    eng = MultiModelEngine(device="cpu", **kw)
    eng.add_lm("lm", ref["tg"], ref["tv"], slots=2, cache_len=32,
               max_queue=8)
    return eng


# -- batch deployment ------------------------------------------------------


def test_batch_deployment_rejects_causal_graph(ref):
    with pytest.raises(FriendlyError, match="causal"):
        BatchDeployment(ref["tg"], ref["tv"], device="cpu")
    with pytest.raises(JaxFriendlyError, match="causal"):
        JaxBatch(ref["jg"], ref["jv"])


def test_batch_bucket_ladder(ref):
    dep = BatchDeployment(ref["clf"], ref["clfv"], max_batch=8,
                          device="cpu")
    jdep = JaxBatch(ref["jclf"], ref["jclfv"], max_batch=8)
    ks = (1, 2, 3, 4, 5, 8)
    assert [dep.batch_bucket(k) for k in ks] == \
        [jdep.batch_bucket(k) for k in ks] == [1, 2, 4, 4, 8, 8]
    assert dep.num_batch_buckets == jdep.num_batch_buckets == 4
    assert BatchDeployment(ref["clf"], ref["clfv"], max_batch=6,
                           device="cpu").max_batch == 4


def test_batch_deployment_bit_parity_and_compile_pin(ref):
    """A bucket-size group comes back bit-equal to the direct apply and
    close to the JAX deployment's rows; ragged arrivals land on existing
    buckets, and the program count equals the JAX deployment's."""
    dep = BatchDeployment(ref["clf"], ref["clfv"], max_batch=4,
                          device="cpu")
    jdep = JaxBatch(ref["jclf"], ref["jclfv"], max_batch=4)
    xs = ref["xs"]
    direct = ref["clf"].apply(ref["clfv"], torch.from_numpy(np.stack(xs)))
    with compile_guard(lambda: dep.batch_compile_count,
                       max_programs=dep.num_batch_buckets,
                       label="batch dispatch"):
        ids = [dep.submit(x) for x in xs]
        for x in xs:
            jdep.submit(x)
        got = {r.id: r for r in dep.step()}
        want = jdep.step()
        assert sorted(got) == ids
        for i, rid in enumerate(ids):
            assert got[rid].status == "completed"
            np.testing.assert_array_equal(got[rid].output,
                                          direct[i].numpy())
            np.testing.assert_allclose(got[rid].output, want[i].output,
                                       atol=BF16_TOL, rtol=BF16_TOL)
        for k in (1, 3, 2, 4):
            for x in _examples(k, seed=k):
                dep.submit(x)
                jdep.submit(x)
            assert len(dep.step()) == len(jdep.step()) == k
    assert dep.batch_compile_count == jdep.batch_compile_count \
        <= dep.num_batch_buckets


def test_batch_padding_rows_do_not_leak(ref):
    dep = BatchDeployment(ref["clf"], ref["clfv"], max_batch=8,
                          device="cpu")
    xs = _examples(3, seed=7)
    ids = [dep.submit(x) for x in xs]
    got = {r.id: r for r in dep.step()}
    assert sorted(got) == ids
    # the padded bucket's real rows equal the unpadded direct apply
    direct = ref["clf"].apply(ref["clfv"],
                              torch.from_numpy(np.stack(xs))).numpy()
    for i, rid in enumerate(ids):
        np.testing.assert_allclose(got[rid].output, direct[i], atol=1e-6)


def test_batch_admission_control(ref):
    for dep, err in (
        (BatchDeployment(ref["clf"], ref["clfv"], max_batch=4, max_queue=2,
                         device="cpu"), FriendlyError),
        (JaxBatch(ref["jclf"], ref["jclfv"], max_batch=4, max_queue=2),
         JaxFriendlyError),
    ):
        dep.submit(np.zeros(8, np.float32))
        with pytest.raises(err, match="does not match"):
            dep.submit(np.zeros(9, np.float32))
        with pytest.raises(err, match="does not match"):
            dep.submit(np.zeros(8, np.float64))
        dep.submit(np.zeros(8, np.float32))
        with pytest.raises(err, match="queue is full"):
            dep.submit(np.zeros(8, np.float32))
        assert dep.metrics.rejected == 1


# -- the multi-model engine ------------------------------------------------


def test_multimodel_concurrent_bit_identical(ref):
    """The acceptance bar: lm + clf + ox concurrently, every LM stream
    equal to the JAX multi-model engine's and to a dedicated port engine's
    under unchanged program pins, every batch row bit-equal to the direct
    apply; program counts, metrics keys and Prometheus names equal the
    JAX engine's."""
    row = ref["row"]
    solo = ServeEngine(ref["tg"], ref["tv"], slots=2, cache_len=32,
                       max_queue=8, device="cpu")
    solo_ids = [solo.submit(row[:n], LM_NEW) for n in LM_LENGTHS[:2]]
    solo_res = solo.run()

    eng = MultiModelEngine(device_budget=2, device="cpu")
    lm_dep = eng.add_lm("lm", ref["tg"], ref["tv"], slots=2, cache_len=32,
                        max_queue=8)
    clf_dep = eng.add_batch("clf", ref["clf"], ref["clfv"], max_batch=4)
    ox_dep = eng.add_onnx("ox", ref["path"], max_batch=4)
    assert eng.models == ["lm", "clf", "ox"]
    with serve_compile_guard(lm_dep):
        gids = [eng.submit(row[:n], model="lm", max_new_tokens=LM_NEW)
                for n in LM_LENGTHS[:2]]
        gids += [eng.submit(x, model="clf") for x in ref["xs"]]
        gids += [eng.submit(x, model="ox") for x in ref["oxs"]]
        res = eng.run()
    assert len(res) == len(gids) == 10
    for g, want, rid in zip(gids[:2], ref["streams"], solo_ids):
        assert res[g].status == "completed"
        np.testing.assert_array_equal(res[g].tokens, want)
        np.testing.assert_array_equal(res[g].tokens, solo_res[rid].tokens)
    clf_direct = ref["clf"].apply(
        ref["clfv"], torch.from_numpy(np.stack(ref["xs"]))).numpy()
    og = ox_dep.graph
    ox_direct = og.apply(og.init(device="cpu"),
                         torch.from_numpy(np.stack(ref["oxs"]))).numpy()
    for i in range(4):
        np.testing.assert_array_equal(res[gids[2 + i]].output, clf_direct[i])
        np.testing.assert_array_equal(res[gids[6 + i]].output, ox_direct[i])
        np.testing.assert_allclose(res[gids[2 + i]].output,
                                   ref["outputs"][i], atol=BF16_TOL,
                                   rtol=BF16_TOL)
        np.testing.assert_allclose(res[gids[6 + i]].output,
                                   ref["outputs"][4 + i], atol=F32_TOL,
                                   rtol=F32_TOL)
    assert {"clf": clf_dep.batch_compile_count,
            "ox": ox_dep.batch_compile_count} == ref["batch_counts"]

    assert eng.model_of(gids[0]) == "lm"
    assert eng.model_of(gids[-1]) == "ox"
    md, jmd = eng.metrics_dict(), ref["metrics"]
    assert set(md) == set(jmd)
    for name in ("lm", "clf", "ox"):
        assert set(md["per_model"][name]) == set(jmd["per_model"][name])
    assert set(md["registry"]) == set(jmd["registry"])
    for key in ("submitted", "completed", "failed", "rejected",
                "deployments"):
        assert md[key] == jmd[key]
    for name in ("lm", "clf", "ox"):
        assert md["registry"][f"model{name}.serve.completed"] > 0
    prom = eng.to_prometheus()
    assert _prom_families(prom) == _prom_families(ref["prom"])
    samples = [ln.split()[0] for ln in prom.splitlines()
               if ln and not ln.startswith("#")]
    assert len(samples) == len(set(samples))
    assert "modelox_serve_completed_total" in prom


def test_onnx_roundtrip_deployment_bit_equal(ref, tmp_path):
    """export (the port's own exporter) -> import -> serve: the imported
    graph's deployment output is bit-equal to its direct apply on the
    same bucket-size batch, and close to the port graph it came from."""
    from mmlspark_tpu_torch.models.onnx_export import save_onnx
    from mmlspark_tpu_torch.models.onnx_import import load_onnx

    _, _, m, v = _port_mlp(num_outputs=4, hidden=(16, 16), seed=5)
    path = str(tmp_path / "roundtrip.onnx")
    save_onnx(m, v, (1, 8), path)
    og = load_onnx(path)
    ogv = og.init(device="cpu")
    xs = _examples(4, seed=11)
    stacked = torch.from_numpy(np.stack(xs))
    direct = og.apply(ogv, stacked).numpy()
    dep = BatchDeployment(og, ogv, max_batch=4, device="cpu")
    ids = [dep.submit(x) for x in xs]
    got = {r.id: r for r in dep.step()}
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(got[rid].output, direct[i])
    np.testing.assert_allclose(direct, m.apply(v, stacked).numpy(),
                               atol=5e-2)


def test_submit_routing_errors(ref):
    for eng, err in (
        (_engine(ref), FriendlyError),
        (JaxMultiModel(), JaxFriendlyError),
    ):
        if isinstance(eng, JaxMultiModel):
            eng.add_lm("lm", ref["jg"], ref["jv"], slots=2, cache_len=32)
            eng.add_batch("classifier", ref["jclf"], ref["jclfv"],
                          max_batch=4)
        else:
            eng.add_batch("classifier", ref["clf"], ref["clfv"],
                          max_batch=4)
        with pytest.raises(err, match="pass model="):
            eng.submit(np.zeros(8, np.float32))
        with pytest.raises(err, match="did you mean 'classifier'"):
            eng.submit(np.zeros(8, np.float32), model="clasifier")
        with pytest.raises(err, match="max_new_tokens"):
            eng.submit(np.zeros(4, np.int32), model="lm")
        with pytest.raises(err, match="stateless batch"):
            eng.submit(np.zeros(8, np.float32), model="classifier",
                       max_new_tokens=4)
        with pytest.raises(err, match="unknown request id"):
            eng.model_of(123)


def test_duplicate_and_invalid_deployment_names(ref):
    eng = MultiModelEngine(device="cpu")
    eng.add_batch("clf", ref["clf"], ref["clfv"])
    with pytest.raises(FriendlyError, match="already exists"):
        eng.add_batch("clf", ref["clf"], ref["clfv"])
    with pytest.raises(FriendlyError, match="invalid"):
        eng.add_batch("a.b", ref["clf"], ref["clfv"])
    with pytest.raises(FriendlyError, match="managed by MultiModelEngine"):
        eng.add_batch("other", ref["clf"], ref["clfv"], registry=object())
    with pytest.raises(FriendlyError, match="managed by MultiModelEngine"):
        eng.add_lm("lm", ref["tg"], ref["tv"], replica=0)
    with pytest.raises(FriendlyError, match="device_budget"):
        MultiModelEngine(device_budget=0, device="cpu")


def test_fairness_under_saturating_lm_stream(ref):
    """device_budget=1 and a saturating LM stream: the classifier is
    still served within ceil(D/B) = 2 ticks."""
    eng = MultiModelEngine(device_budget=1, device="cpu")
    eng.add_lm("lm", ref["tg"], ref["tv"], slots=2, cache_len=32,
               max_queue=32, decode_block=4)
    eng.add_batch("clf", ref["clf"], ref["clfv"], max_batch=4)
    for n in (5, 9, 4, 7, 6, 8, 5, 9):
        eng.submit(ref["row"][:n], model="lm", max_new_tokens=8)
    for _ in range(3):
        eng.step()
    clf_gids = {eng.submit(x, model="clf") for x in _examples(4)}
    ticks_to_serve = None
    for t in range(1, 5):
        if clf_gids & {r.id for r in eng.step()}:
            ticks_to_serve = t
            break
    assert ticks_to_serve is not None and ticks_to_serve <= 2
    eng.run()


def test_per_model_shed_independence(ref):
    """Each deployment carries its OWN SloMonitor: one model burning its
    SLO sheds only its own admissions."""
    _, _, clf_b, v_b = _port_mlp(num_outputs=2, seed=2)
    eng = MultiModelEngine(device="cpu")
    dep_a = eng.add_batch(
        "burns", ref["clf"], ref["clfv"], max_batch=2,
        slo=SloTargets(ttft_p99_ms=1e-9, min_samples=1),
    )
    dep_b = eng.add_batch("fine", clf_b, v_b, max_batch=2)
    for round_ in range(4):
        for x in _examples(2, seed=round_):
            eng.submit(x, model="burns")
            eng.submit(x, model="fine")
        for _ in range(4):
            eng.step()
    assert dep_a.metrics.slo_shed_ticks_total > 0
    assert dep_b.metrics.slo_shed_ticks_total == 0
    assert dep_b.metrics.completed == 8
    reg = eng.registry.to_dict()
    assert reg["modelburns.serve.slo_shed_ticks"] > 0
    assert reg["modelfine.serve.slo_shed_ticks"] == 0


# -- serve.batch fault envelope --------------------------------------------


def _drain(dep, limit=50) -> dict:
    out = {}
    for _ in range(limit):
        for r in dep.step():
            out[r.id] = r
        if not dep.busy:
            break
    return out


def test_serve_batch_transient_faults_absorbed(ref):
    """One seeded transient schedule at ``serve.batch``: both
    frameworks draw the same faults, retry as often and complete every
    example."""
    spec = "seed=3,serve.batch:transient=0.4"
    dep = BatchDeployment(ref["clf"], ref["clfv"], max_batch=4,
                          faults=parse_fault_spec(spec), retry_limit=8,
                          device="cpu")
    jdep = JaxBatch(ref["jclf"], ref["jclfv"], max_batch=4,
                    faults=jax_fault_spec(spec), retry_limit=8)
    for x in _examples(8):
        dep.submit(x)
        jdep.submit(x)
    got, want = _drain(dep), _drain(jdep)
    assert {i: r.status for i, r in got.items()} == \
        {i: r.status for i, r in want.items()} == \
        dict.fromkeys(range(8), "completed")
    assert dep.metrics.retries_total == jdep.metrics.retries_total >= 1
    assert dep.metrics.faults_injected_total == \
        jdep.metrics.faults_injected_total >= 1


def test_serve_batch_retry_exhaustion_quarantines_batch(ref):
    spec = "seed=1,serve.batch:transient=1.0"
    for dep in (
        BatchDeployment(ref["clf"], ref["clfv"], max_batch=4,
                        faults=parse_fault_spec(spec), retry_limit=1,
                        device="cpu"),
        JaxBatch(ref["jclf"], ref["jclfv"], max_batch=4,
                 faults=jax_fault_spec(spec), retry_limit=1),
    ):
        ids = [dep.submit(x) for x in _examples(3)]
        got = {r.id: r for r in dep.step()}
        assert sorted(got) == ids
        assert all(r.status == "failed" and r.output is None
                   and r.generated == 0 for r in got.values())
        assert dep.metrics.quarantined_total == dep.metrics.failed == 3
        dep.submit(_examples(1)[0])
        assert all(r.status == "failed" for r in dep.step())


class _OnceOOM:
    """One resource exhaustion on the first fire, silent after."""

    listener = None

    def __init__(self, exc):
        self.exc = exc
        self.fired = False

    def fire(self, site, *, tick, request=None, replica=None):
        if not self.fired:
            self.fired = True
            raise self.exc


def _cap_walk(dep) -> tuple:
    """(admission caps tick by tick, results) while draining ``dep``."""
    caps, out = [], {}
    for _ in range(10):
        for r in dep.step():
            out[r.id] = r
        caps.append(dep._admit_cap)
        if not dep.busy and not dep.degraded:
            break
    return caps, out


def test_serve_batch_oom_degrades_and_recovers(ref):
    """Resource exhaustion halves the admission cap down the EXISTING
    ladder (no new program), requeues the batch intact, and clean
    dispatches re-escalate it — the same cap walk as the JAX deployment's
    (the port's exhaustion is PyTorch's out-of-memory error)."""
    dep = BatchDeployment(
        ref["clf"], ref["clfv"], max_batch=4, degrade_recover_ticks=2,
        faults=_OnceOOM(torch.cuda.OutOfMemoryError("injected oom drill")),
        device="cpu")
    jdep = JaxBatch(
        ref["jclf"], ref["jclfv"], max_batch=4, degrade_recover_ticks=2,
        faults=_OnceOOM(RuntimeError("RESOURCE_EXHAUSTED: injected oom")))
    for x in _examples(4):
        dep.submit(x)
        jdep.submit(x)
    assert dep.step() == [] and jdep.step() == []
    assert dep.degraded and dep.queue_depth == 4
    caps, got = _cap_walk(dep)
    jcaps, want = _cap_walk(jdep)
    assert caps == jcaps
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert all(r.status == "completed" for r in got.values())
    assert not dep.degraded
    assert dep.batch_compile_count == jdep.batch_compile_count \
        <= dep.num_batch_buckets


def test_engine_kill_is_terminal(ref):
    class _Kill:
        listener = None

        def fire(self, site, *, tick, request=None, replica=None):
            raise EngineKilled("injected kill")

    dep = BatchDeployment(ref["clf"], ref["clfv"], max_batch=2,
                          faults=_Kill(), device="cpu")
    dep.submit(_examples(1)[0])
    with pytest.raises(EngineKilled):
        dep.step()
    with pytest.raises(FriendlyError, match="killed"):
        dep.step()
    assert dep.queue_depth == 1


# -- spec grammar ----------------------------------------------------------


SPEC = ("lm=transformer_lm:slots=4:cache_len=64:"
        "slo=ttft_p99_ms=50+error_rate=0.5;"
        "clf=mlp:max_batch=8:hidden=16x16:input_shape=8;"
        "ox=onnx:path=/tmp/m.onnx")


def test_parse_models_spec_grammar():
    got, want = parse_models_spec(SPEC), jax_parse(SPEC)
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert got[0].deploy_kwargs["slo"] == "ttft_p99_ms=50,error_rate=0.5"
    assert got[1].build_config == {"hidden": (16, 16), "input_shape": 8}
    for bad, match in (("justaname", "expected 'name=arch'"),
                       ("a=mlp;a=linear", "duplicate deployment name"),
                       ("a=mlp:oops", "key=value"),
                       (" ; ", "spec is empty")):
        with pytest.raises(FriendlyError, match=match):
            parse_models_spec(bad)
        with pytest.raises(JaxFriendlyError, match=match):
            jax_parse(bad)


def test_engine_from_spec_kind_detection_and_wrong_keys():
    eng = engine_from_spec(
        "lm=transformer_lm:slots=2:cache_len=32:vocab_size=8:"
        "d_model=32:heads=2:depth=1:max_len=32;"
        "clf=mlp:max_batch=4:num_outputs=3:hidden=16x16:input_shape=8",
        seed=0, device="cpu",
    )
    assert isinstance(eng.deployment("lm"), ServeEngine)
    assert isinstance(eng.deployment("clf"), BatchDeployment)
    # a seeded spec is reproducible on one device
    again = engine_from_spec("clf=mlp:num_outputs=3:hidden=16x16:"
                             "input_shape=8", seed=0, device="cpu")
    torch.testing.assert_close(again.deployment("clf").variables,
                               eng.deployment("clf").variables)
    for spec, match in (
        ("clf=mlp:slots=4:hidden=16x16:input_shape=8",
         "'clf' .* do not apply"),
        ("lm=transformer_lm:max_batch=4:vocab_size=8:d_model=32:"
         "heads=2:depth=1:max_len=32", "'lm' .* do not apply"),
        ("clf=mlp:hidden=16x16", "input_shape"),
    ):
        with pytest.raises(FriendlyError, match=match):
            engine_from_spec(spec, seed=0, device="cpu")
        with pytest.raises(JaxFriendlyError, match=match):
            jax_from_spec(spec, seed=0)


def test_registry_unknown_model_suggests_and_names_onnx():
    with pytest.raises(FriendlyError, match="did you mean 'mlp'"):
        build_model("mpl")
    with pytest.raises(FriendlyError, match="onnx"):
        build_model("definitely_not_a_model")


# -- demo ------------------------------------------------------------------


def test_run_demo_multimodel(ref, tmp_path):
    """``run_demo(models=...)`` behaves as the JAX demo does: every
    request completes, the JSON is the multi-model engine's dict (the JAX
    engine's keys, per model too) plus the JAX demo's run keys and the
    port's ``device``, and the telemetry dir carries the hub's merged
    bundle with ``{model=...}`` labels."""
    from mmlspark_tpu_torch.serve.demo import run_demo

    tel = str(tmp_path / "tel")
    out = run_demo(
        models=("lm=transformer_lm:slots=2:cache_len=32:vocab_size=8:"
                "d_model=32:heads=2:depth=1:max_len=32;"
                "clf=mlp:max_batch=4:num_outputs=3:hidden=16x16:"
                "input_shape=8"),
        n_requests=3, max_new_tokens=4, arrivals_per_tick=2, seed=0,
        device_budget=2, telemetry_dir=tel, metrics_port=0, device="cpu",
    )
    want = ref["metrics"]
    assert set(out) == set(want) | {
        "n_requests", "arrivals_per_tick", "max_new_tokens", "models_spec",
        "metrics_port", "device"}
    assert set(out["per_model"]["lm"]) == set(want["per_model"]["lm"])
    assert set(out["per_model"]["clf"]) == set(want["per_model"]["clf"])
    assert out["multimodel"] and out["deployments"] == 2
    assert out["submitted"] == 6 and out["completed"] == 6
    assert set(out["per_model"]) == {"lm", "clf"}
    assert out["per_model"]["lm"]["decode_compile_count"] >= 1
    assert out["per_model"]["clf"]["batch_compile_count"] >= 1
    assert out["metrics_port"] > 0
    for fname in ("events.jsonl", "metrics.json", "trace.json",
                  "metrics.prom"):
        assert os.path.exists(os.path.join(tel, fname))
    with open(os.path.join(tel, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    routed = [e for e in events if e.get("name") == "routed"]
    assert {e["attrs"]["model"] for e in routed} == {"lm", "clf"}
    with open(os.path.join(tel, "metrics.prom")) as f:
        prom = f.read()
    assert 'serve_ttft_ms_count{model="lm"}' in prom
    assert 'serve_ttft_ms_count{model="clf"}' in prom


# -- replica routing with a model dimension --------------------------------


def test_replica_set_model_routing(ref):
    """Replicas partition over the models round-robin; submit needs
    model= and routes within that model's replicas. The overfit LM's
    streams equal the JAX engine's, the second model's a dedicated port
    engine's; the errors are the JAX set's."""
    other = build_model("transformer_lm", **dict(TINY, depth=1))
    ov = init_variables(other, 9, device="cpu")
    rs = ReplicaSet(ref["tg"], ref["tv"], replicas=2, slots=2, cache_len=32,
                    models={"small": (ref["tg"], ref["tv"]),
                            "big": (other, ov)}, device="cpu")
    assert rs.models == ["small", "big"]
    assert (rs.replica_model(0), rs.replica_model(1)) == ("small", "big")
    with pytest.raises(FriendlyError, match="model="):
        rs.submit(np.zeros(4, np.int32), 4)
    with pytest.raises(FriendlyError, match="unknown model"):
        rs.submit(np.zeros(4, np.int32), 4, model="medium")

    row = ref["row"]
    solo = ServeEngine(other, ov, slots=2, cache_len=32, device="cpu")
    big_ids = [solo.submit(row[:n], LM_NEW) for n in LM_LENGTHS[2:]]
    solo_res = solo.run()
    gs = [rs.submit(row[:n], LM_NEW, model="small")
          for n in LM_LENGTHS[:2]]
    gb = [rs.submit(row[:n], LM_NEW, model="big") for n in LM_LENGTHS[2:]]
    res = rs.run()
    for g, want in zip(gs, ref["streams"]):
        np.testing.assert_array_equal(res[g].tokens, want)
    for g, rid in zip(gb, big_ids):
        np.testing.assert_array_equal(res[g].tokens, solo_res[rid].tokens)
    per = rs.metrics_dict()["per_replica"]
    assert (per["replica0"]["model"], per["replica1"]["model"]) == \
        ("small", "big")

    single = ReplicaSet(ref["tg"], ref["tv"], replicas=1, slots=2,
                        cache_len=32, device="cpu")
    with pytest.raises(FriendlyError, match="multi-model"):
        single.submit(np.zeros(4, np.int32), 4, model="small")
    jsingle = JaxReplicaSet(ref["jg"], ref["jv"], replicas=1, slots=2,
                            cache_len=32)
    with pytest.raises(JaxFriendlyError, match="multi-model"):
        jsingle.submit(np.zeros(4, np.int32), 4, model="small")
    pair = (ref["tg"], ref["tv"])
    for make, err in (
        (lambda **kw: ReplicaSet(*pair, device="cpu", **kw), FriendlyError),
        (lambda **kw: JaxReplicaSet(ref["jg"], ref["jv"], **kw),
         JaxFriendlyError),
    ):
        with pytest.raises(err, match="at least one model"):
            make(replicas=2, models={})
        with pytest.raises(err, match="replicas"):
            make(replicas=1, models={"a": pair, "b": pair})
        with pytest.raises(err, match="pair"):
            make(replicas=2, models={"a": [1, 2]})
