"""The port's ``DNNLearner`` and ``TPUModel`` over ResNet-20 against the JAX
package's stages, and the trainer's carried batch statistics (the rest):
checkpointed under ``rest``, resumed bit for bit, kept on a quarantined
step.

Model: ``resnet20_cifar10(width=8)``; data: 16 seeded 32x32x3 float
images, 10 classes; batch 8, so one epoch is 2 steps. Both learners start
from the same seeded flax variables (the JAX graph's ``init`` and the
port trainer's ``init_variables`` are patched to return them, the port's
through the weight bridge), train on the same batches (the same seeded
order) with plain SGD at learning rate 1e-2, and log every step.

Tolerances (bf16 convolutions on both sides, which sum in other orders):
losses within 1e-2 (absolute, at a loss of about 3); the batch statistics
after the fit within 5e-2 of each statistic's largest magnitude (a
flipped bf16 rounding in a convolution output moves a batch mean by a
fraction of an ulp, carried through two updates); scores 3e-2 of the
largest magnitude, as in ``tests/test_torch_cnn.py``. The learners use
SGD because adam's first steps are ``lr * sign(g)``: where a gradient is
near zero, the bf16 rounding noise picks the sign, and the two runs part
by a full step in those parameters. In f32 compute adam's two steps
match to 1e-4 (``test_f32_adam_training_matches_jax``); later steps part
the same way at f32 noise.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.models import graph as jax_graph_mod
from mmlspark_tpu.stages.dnn_learner import DNNLearner as JaxDNNLearner
from mmlspark_tpu.stages.dnn_model import TPUModel as JaxTPUModel
from mmlspark_tpu.train.trainer import SPMDTrainer as JaxTrainer
from mmlspark_tpu.train.trainer import TrainConfig as JaxConfig
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.stages import DNNLearner, TPUModel
from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig
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


CFG = {"width": 8}
LOSS_TOL = 1e-2
STATS_REL_TOL = 5e-2
SCORE_REL_TOL = 3e-2


def _seeded_flax_variables(graph, sample, seed):
    """flax variables shaped by ``jax.eval_shape`` of ``graph.init``, with
    seeded values: kernels N(0, 1/fan_in), BatchNorm scales 1, biases and
    running means 0, running variances 1 (flax's own starting values
    beside the kernels)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(graph.init, jax.random.PRNGKey(0), sample)

    def walk(node, key: str = ""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key in ("scale", "var"):
            return np.ones(node.shape, np.float32)
        if key in ("bias", "mean"):
            return np.zeros(node.shape, np.float32)
        fan_in = int(np.prod(node.shape[:-1]))
        return rng.normal(0, fan_in ** -0.5, node.shape).astype(np.float32)

    return walk(dict(shapes))


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    return x, rng.integers(0, 10, size=n)


@pytest.fixture(scope="module")
def fitted():
    """(JAX model, port model, flax init, images, labels): one epoch of
    each learner from the same init over the same batches."""
    x, y = _data()
    jg = jax_build_model("resnet20_cifar10", **CFG)
    jv = _seeded_flax_variables(jg, jnp.asarray(x[:1]), seed=3)
    tv = load_flax_variables(build_model("resnet20_cifar10", **CFG), jv,
                             device="cpu")
    kw = dict(model_name="resnet20_cifar10", model_config=CFG,
              features_col="image", batch_size=8, learning_rate=1e-2,
              optimizer="sgd")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_graph_mod.NamedGraph, "init",
                   lambda self, rng, sample: jv)
        mp.setattr(trainer_mod.bridge, "init_variables",
                   lambda graph, seed, device: tv)
        for cls in (JaxDNNLearner, DNNLearner):
            base = cls._train_config
            mp.setattr(cls, "_train_config", lambda self, base=base:
                       dataclasses.replace(base(self), log_every=1))
        jm = JaxDNNLearner(mesh_axes={"data": 1}, **kw).fit(
            JaxDataset({"image": x, "label": y}))
        tm = DNNLearner(device="cpu", **kw).fit(
            Dataset({"image": x, "label": y}))
    finally:
        mp.undo()
    return jm, tm, jv, x, y


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-12))


def test_learner_losses_and_statistics_match_jax(fitted):
    jm, tm, jv, _, _ = fitted
    want = [h["loss"] for h in jm.train_history]
    got = [h["loss"] for h in tm.train_history]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    graph = tm.graph()
    n = 0
    for block in graph.layer_names:
        for key in graph.stat_keys(block):
            node, init = jm.weights[block]["batch_stats"], \
                jv[block]["batch_stats"]
            for part in key.split("."):
                node, init = node[part], init[part]
            got_t = tm.weights[block][key]
            assert not np.array_equal(got_t.numpy(), init)  # carried
            assert _rel(got_t, node) <= STATS_REL_TOL, (block, key)
            n += 1
    assert n == 42


def test_fitted_models_score_alike_and_round_trip(fitted, tmp_path):
    """The two fitted TPUModels score alike; the port's saves its own
    layout (tensors) and scores identically after loading; the JAX one
    (flax layout) loads in the port and scores as JAX does."""
    jm, tm, _, x, _ = fitted
    want = jm.set(data_parallel=False).transform(
        JaxDataset({"image": x}))["scores"]
    got = tm.transform(Dataset({"image": x}))["scores"]
    assert got.shape == (16, 10)
    assert _rel(got, want) <= SCORE_REL_TOL
    tm.save(str(tmp_path / "port"))
    back = PipelineStage.load(str(tmp_path / "port"))
    assert isinstance(back, TPUModel)
    back.set(device="cpu")
    np.testing.assert_array_equal(
        back.transform(Dataset({"image": x}))["scores"], got)
    jm.save(str(tmp_path / "jax"))
    crossed = PipelineStage.load(str(tmp_path / "jax"))
    assert isinstance(crossed, TPUModel)
    crossed.set(device="cpu", batch_size=5)  # a padded tail too
    assert _rel(crossed.transform(Dataset({"image": x}))["scores"],
                want) <= SCORE_REL_TOL


def test_tpu_model_matches_jax_stage_int8_and_pool_features(fitted):
    """TPUModel over the JAX-trained flax variables against the JAX stage:
    full scores, the ``pool`` features, and ``weight_quant="int8"``; one
    program per (output_node, weight_quant) key."""
    jm, _, _, x, _ = fitted
    stage = TPUModel(model_name="resnet20_cifar10", model_config=CFG,
                     input_col="image", batch_size=8, device="cpu")
    stage.set(weights=jm.weights)
    jstage = JaxTPUModel(model_name="resnet20_cifar10", model_config=CFG,
                         input_col="image", batch_size=8,
                         data_parallel=False).set(weights=jm.weights)
    ds, jds = Dataset({"image": x}), JaxDataset({"image": x})
    for kw in ({}, {"output_node": "pool"}, {"weight_quant": "int8"}):
        stage.set(**{"output_node": None, "weight_quant": "none", **kw})
        jstage.set(**{"output_node": None, "weight_quant": "none", **kw})
        got, want = stage.transform(ds)["scores"], \
            jstage.transform(jds)["scores"]
        assert got.shape == want.shape
        assert _rel(got, want) <= SCORE_REL_TOL, kw
    # the int8 key re-made the device weights, and with them the programs
    assert stage.program_count == 1
    stage.set(weight_quant="none", output_node=None)
    stage.transform(ds)
    stage.set(output_node="pool")
    stage.transform(ds)
    stage.transform(ds)
    assert stage.program_count == 2


def test_f32_adam_training_matches_jax():
    """Both trainers, f32 compute, adam at 1e-2, one epoch of two steps:
    the losses within 1e-4, and the running statistics with them."""
    x, y = _data()
    jg = jax_build_model("resnet20_cifar10", **CFG)
    jg.blocks = [(n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype")
                  else m) for n, m in jg.blocks]
    tg = build_model("resnet20_cifar10", **CFG)
    for _, mod in tg.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    jv = _seeded_flax_variables(jg, jnp.asarray(x[:1]), seed=3)
    kw = dict(epochs=1, batch_size=8, learning_rate=1e-2, log_every=1)
    jt = JaxTrainer(jg, JaxConfig(mesh_axes={"data": 1}, **kw))
    jout = jt.train(x, y, init_variables=jv)
    tt = SPMDTrainer(tg, TrainConfig(**kw), device="cpu")
    tout = tt.train(x, y, init_variables=load_flax_variables(tg, jv,
                                                             device="cpu"))
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=0,
                               atol=1e-4)
    node = jout["stage3"]["batch_stats"]["ResBlock_2"]["ConvBN_1"][
        "BatchNorm_0"]
    for k in ("mean", "var"):
        assert _rel(tout["stage3"][f"ResBlock_2.ConvBN_1.BatchNorm_0.{k}"],
                    node[k]) <= 1e-3


def _resnet_trainer(directory, epochs, faults=None):
    cfg = TrainConfig(epochs=epochs, batch_size=8, learning_rate=1e-2,
                      checkpoint_dir=directory, checkpoint_every=1,
                      log_every=1)
    return SPMDTrainer(build_model("resnet20_cifar10", **CFG), cfg,
                       faults=faults, device="cpu")


def test_checkpoint_carries_rest_and_resumes_bit_exactly(tmp_path):
    """A run killed after its first epoch and resumed equals the
    uninterrupted run bit for bit — parameters and running statistics;
    the statistics ride in the checkpoint under ``rest``."""
    x, y = _data()
    full = _resnet_trainer(str(tmp_path / "full"), 2).train(x, y)
    _resnet_trainer(str(tmp_path / "cut"), 1).train(x, y)
    payload = tmp_path / "cut" / "payload-1"
    rest_files = sorted(p.name for p in (payload / "rest" / "stage2").iterdir())
    assert "ResBlock_0.ConvBN_2.BatchNorm_0.var.npy" in rest_files
    assert not any(f.endswith((".mean.npy", ".var.npy")) for f in os.listdir(
        payload / "params" / "stage2"))
    resumed_trainer = _resnet_trainer(str(tmp_path / "cut"), 2)
    resumed = resumed_trainer.train(x, y)
    assert resumed_trainer.restored_history
    for block in full:
        for key, t in full[block].items():
            assert torch.equal(resumed[block][key], t), (block, key)


def test_quarantined_step_keeps_statistics():
    """A NaN image makes the step's loss non-finite: the quarantine keeps
    the parameters AND the running statistics at their old values (JAX's
    ``keep(new_rest, rest)``)."""
    x, y = _data(n=8)
    x[3, 0, 0, 0] = np.nan
    graph = build_model("resnet20_cifar10", **CFG)
    from mmlspark_tpu_torch.models import init_variables

    init = init_variables(graph, 0, device="cpu")
    trainer = SPMDTrainer(graph, TrainConfig(epochs=1, batch_size=8,
                                             log_every=1, anomaly_limit=0),
                          device="cpu")
    out = trainer.train(x, y, init_variables=init)
    assert not np.isfinite(trainer.history[0]["loss"])
    assert trainer.telemetry.counter("train.anomalies_skipped").value == 1
    for block in out:
        for key, t in out[block].items():
            assert torch.equal(t, init[block][key]), (block, key)
