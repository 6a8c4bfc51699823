"""The port's ``TPUModel`` and ``DNNLearner`` against the JAX package's
stages over the MLP and a tiny flash-attention ``transformer_lm``.

The counterparts of ``tests/test_dnn_model.py`` (but its mesh case: the
port runs on one device) and of the ``DNNLearner`` cases of
``tests/test_trainer.py``, each on the same seeded inputs through both
stages, plus the port's own contracts: one program per ``(output_node,
weight_quant)`` key and batch signature, weights resident across
transforms, and the ``cuda`` default that raises without a GPU.

Tolerances: MLP scores 2e-2 relative / 1e-2 absolute (bf16 compute, as
the JAX tests hold their own stage to); the bf16 feed 3e-2 (the input's
rounding); the MLP learners' losses 2e-3 (bf16 compute: the first step's
loss is equal, and adam's ``lr * sign(g)`` first steps let bf16 rounding
noise in near-zero gradients pick a sign); the flash LM (float32 compute
on both sides; JAX runs its Pallas kernels in interpret mode, the port
their plain versions): scores 1e-4 and losses 1e-5.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.stages.dnn_learner import DNNLearner as JaxDNNLearner
from mmlspark_tpu.stages.dnn_model import TPUModel as JaxTPUModel
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.models import transformer as transformer_mod
from mmlspark_tpu_torch.stages import DNNLearner, TPUModel
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


MLP_RTOL, MLP_ATOL = 2e-2, 1e-2
MLP_LOSS_TOL = 2e-3
FEED_TOL = 3e-2
LM_SCORE_TOL = 1e-4
LM_LOSS_TOL = 1e-5
MLP_CFG = {"num_outputs": 3, "hidden": (8,)}


@pytest.fixture(scope="module")
def mlp():
    """(port stage, JAX stage) over one flax initialisation; the port
    stage holds the port's variables (bridged), the JAX one flax's."""
    g = jax_build_model("mlp", **MLP_CFG)
    v = jax.device_get(g.init(jax.random.PRNGKey(0), jnp.zeros((1, 4))))
    jstage = JaxTPUModel.from_graph(
        g, v, "mlp", model_config=MLP_CFG, input_col="features",
        output_col="scores", batch_size=4, data_parallel=False)
    tg = build_model("mlp", **MLP_CFG)
    stage = TPUModel.from_graph(
        tg, load_flax_variables(tg, v, device="cpu"), "mlp",
        model_config=MLP_CFG, input_col="features", output_col="scores",
        batch_size=4, device="cpu")
    return stage, jstage


def _feature_ds(n=10, d=4, seed=0, cls=Dataset):
    rng = np.random.default_rng(seed)
    return cls({"features": rng.normal(size=(n, d)).astype(np.float64),
                "idx": np.arange(n)})


def test_batched_inference_matches_jax_stage_and_direct(mlp):
    stage, jstage = mlp
    ds = _feature_ds(n=10)
    out = stage.transform(ds)
    assert out["scores"].shape == (10, 3)  # 10 rows, batch 4: padded tail
    want = jstage.transform(_feature_ds(n=10, cls=JaxDataset))["scores"]
    np.testing.assert_allclose(out["scores"], want, rtol=MLP_RTOL,
                               atol=MLP_ATOL)
    direct = stage.graph().apply(
        stage.weights, torch.from_numpy(ds["features"].astype(np.float32)))
    np.testing.assert_array_equal(out["scores"], direct.numpy())
    assert list(out["idx"]) == list(range(10))


def test_batch_invariance(mlp):
    stage, _ = mlp
    ds = _feature_ds(n=7)
    a = stage.copy().set(batch_size=2).transform(ds)["scores"]
    b = stage.copy().set(batch_size=16).transform(ds)["scores"]
    np.testing.assert_allclose(a, b, rtol=MLP_RTOL, atol=MLP_ATOL)


def test_bf16_feed_matches_f32_and_jax(mlp):
    stage, jstage = mlp
    ds = _feature_ds(n=10)
    f32 = stage.transform(ds)["scores"]
    bf16 = stage.copy().set(feed_dtype="bfloat16").transform(ds)["scores"]
    assert bf16.shape == f32.shape
    np.testing.assert_allclose(bf16, f32, rtol=FEED_TOL, atol=FEED_TOL)
    want = jstage.copy().set(feed_dtype="bfloat16").transform(
        _feature_ds(n=10, cls=JaxDataset))["scores"]
    np.testing.assert_allclose(bf16, want, rtol=MLP_RTOL, atol=MLP_ATOL)


def test_output_node_cut_and_programs(mlp):
    """A headless stage returns the hidden activations; one program per
    ``(output_node, weight_quant)`` key however many batches run."""
    stage, jstage = mlp
    ds = _feature_ds(n=10)
    headless = stage.copy().set(output_node="hidden1")
    out = headless.transform(ds)
    assert out["scores"].shape == (10, 8)
    want = jstage.copy().set(output_node="hidden1").transform(
        _feature_ds(n=10, cls=JaxDataset))["scores"]
    np.testing.assert_allclose(out["scores"], want, rtol=MLP_RTOL,
                               atol=MLP_ATOL)
    assert out["scores"].dtype == np.float32  # a bf16 node, as float32
    assert headless.program_count == 1  # three batches, one program
    headless.set(output_node=None)
    headless.transform(ds)
    assert headless.program_count == 2
    assert headless.layer_names == ["hidden1", "z"]


def test_captured_forward_is_the_transforms_program(mlp):
    """``captured_forward`` hands out the program and device weights the
    last transform ran, so the model alone gives the transform's
    scores; before any transform it raises."""
    stage, _ = mlp
    fresh = stage.copy().set(weights=stage.weights)
    with pytest.raises(FriendlyError, match="no transform"):
        fresh.captured_forward()
    ds = _feature_ds(n=4)
    out = fresh.transform(ds)["scores"]
    program, weights = fresh.captured_forward()
    assert weights is fresh._device_weights(torch.device("cpu"))
    got = program(weights, torch.from_numpy(
        ds["features"].astype(np.float32)))
    np.testing.assert_array_equal(got.float().numpy(), out)


def test_object_vector_column_and_errors(mlp):
    stage, _ = mlp
    ds = Dataset({"features": [np.zeros(4), np.ones(4), np.full(4, 2.0)]})
    assert stage.transform(ds)["scores"].shape == (3, 3)
    with pytest.raises(FriendlyError, match="no weights"):
        TPUModel(model_name="mlp", input_col="features",
                 device="cpu").transform(_feature_ds())
    with pytest.raises(FriendlyError):
        stage.transform(Dataset({"features": [np.zeros(3), np.zeros(4)]}))


def test_weights_stay_resident_until_replaced(mlp):
    stage, _ = mlp
    s = stage.copy().set(weights=stage.weights)
    s.transform(_feature_ds(n=3))
    first = s._device_weights(torch.device("cpu"))
    s.transform(_feature_ds(n=5))
    assert s._device_weights(torch.device("cpu")) is first
    s.set(weights={b: dict(v) for b, v in stage.weights.items()})
    assert s._device_weights(torch.device("cpu")) is not first


def test_round_trip_and_set_model_location(tmp_path, mlp):
    stage, _ = mlp
    ds = _feature_ds(n=6)
    stage.save(str(tmp_path / "m"))
    loaded = PipelineStage.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(loaded.transform(ds)["scores"],
                                  stage.transform(ds)["scores"])
    fresh = TPUModel(input_col="features", output_col="scores",
                     model_name="mlp", device="cpu").set_model_location(
        str(tmp_path / "m"))
    assert fresh.transform(_feature_ds(n=3))["scores"].shape == (3, 3)


def test_jax_saved_stage_loads_and_scores_the_same(tmp_path, mlp):
    """A TPUModel saved by the JAX package (flax variables) loads in the
    port, bridges its weights and scores as the JAX stage does."""
    _, jstage = mlp
    jstage.save(str(tmp_path / "jax"))
    loaded = PipelineStage.load(str(tmp_path / "jax"))
    assert isinstance(loaded, TPUModel) and loaded.model_name == "mlp"
    loaded.set(device="cpu")
    want = jstage.transform(_feature_ds(n=9, cls=JaxDataset))["scores"]
    np.testing.assert_allclose(loaded.transform(_feature_ds(n=9))["scores"],
                               want, rtol=MLP_RTOL, atol=MLP_ATOL)


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(mlp,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stage, _ = mlp
    ds = _feature_ds(n=4)
    x, y = _two_blob_data(n=16)
    for call in (
        lambda: stage.copy(device=None).set(
            weights=stage.weights).transform(ds),
        lambda: DNNLearner(epochs=1, batch_size=8).fit(
            Dataset({"features": x, "label": y})),
        lambda: stage.copy(device="cuda").set(
            weights=stage.weights).transform(ds),
    ):
        with pytest.raises(FriendlyError, match="no CUDA device"):
            call()


# -- DNNLearner: tests/test_trainer.py's cases -------------------------------------


def _two_blob_data(n=128, d=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    x = rng.normal(size=(n, d)).astype(np.float32) + y[:, None] * 3.0
    return x, y


def test_dnn_learner_stage_end_to_end():
    x, y = _two_blob_data(n=128)
    ds = Dataset({"features": x, "label": y})
    model = DNNLearner(model_name="mlp", model_config={"hidden": (16,)},
                       epochs=4, batch_size=32, learning_rate=1e-2,
                       device="cpu").fit(ds)
    assert isinstance(model, TPUModel) and model.device == "cpu"
    preds = np.argmax(model.transform(ds)["scores"], axis=1)
    assert (preds == y).mean() > 0.9
    assert model.train_history
    assert model.model_config == {"hidden": (16,), "num_outputs": 2}


def test_dnn_learner_drops_nan_labels():
    x, y = _two_blob_data(n=64)
    yf = y.astype(np.float64)
    yf[:8] = np.nan
    model = DNNLearner(model_name="mlp", epochs=1, batch_size=32,
                       device="cpu").fit(Dataset({"features": x, "label": yf}))
    assert model.weights is not None
    yo = np.array([None] * 8 + list(y[8:]), dtype=object)
    model = DNNLearner(model_name="mlp", epochs=1, batch_size=32,
                       device="cpu").fit(Dataset({"features": x, "label": yo}))
    assert model.weights is not None


def test_mlp_learner_matches_jax_learner(monkeypatch):
    """Both learners from the same flax initialisation over the same
    batches: the loss histories alike, the first step's equal, and the
    fitted stages' scores alike."""
    x, y = _two_blob_data(n=96)
    jg = jax_build_model("mlp", num_outputs=2, hidden=(16,))
    jv = jax.device_get(jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 4))))
    tv = load_flax_variables(build_model("mlp", num_outputs=2, hidden=(16,)),
                             jv, device="cpu")
    monkeypatch.setattr(trainer_mod.bridge, "init_variables",
                        lambda graph, seed, device: tv)
    for cls in (JaxDNNLearner, DNNLearner):
        base = cls._train_config
        monkeypatch.setattr(cls, "_train_config", lambda self, base=base:
                            dataclasses.replace(base(self), log_every=1))
    kw = dict(model_name="mlp", model_config={"hidden": (16,)}, epochs=2,
              batch_size=32, learning_rate=1e-2)
    jm = JaxDNNLearner(mesh_axes={"data": 1}, **kw).fit(
        JaxDataset({"features": x, "label": y}))
    tm = DNNLearner(device="cpu", **kw).fit(Dataset({"features": x,
                                                     "label": y}))
    got = [h["loss"] for h in tm.train_history]
    want = [h["loss"] for h in jm.train_history]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_LOSS_TOL)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    want = jm.set(data_parallel=False).transform(
        JaxDataset({"features": x}))["scores"]
    np.testing.assert_allclose(tm.transform(Dataset({"features": x}))[
        "scores"], want, rtol=MLP_RTOL, atol=MLP_ATOL)


# -- the flash LM through both stages --------------------------------------------


LM = dict(vocab_size=32, d_model=16, heads=4, kv_heads=2, depth=2,
          max_len=16, attn_impl="flash")


def _f32_jax(graph):
    graph.blocks = [(n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype")
                     else m) for n, m in graph.blocks]
    return graph


def _f32_port(graph):
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


def _lm_rows(n=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, LM["vocab_size"], size=(n, LM["max_len"])).astype(
        np.int32)
    return x, np.roll(x, -1, axis=1)


def test_flash_lm_through_both_stages(monkeypatch):
    """TPUModel scores token rows and DNNLearner fits the flash LM (f32
    compute, both sides), from the same flax initialisation over the same
    batches; on the CPU the port's flash path runs the plain attention
    versions, and the dense one never runs."""
    jg = _f32_jax(jax_build_model("transformer_lm", **LM))
    x, y = _lm_rows()
    jv = jax.device_get(jg.init(jax.random.PRNGKey(1), jnp.asarray(x[:1])))
    tg = _f32_port(build_model("transformer_lm", **LM))
    tv = load_flax_variables(tg, jv, device="cpu")
    dense_calls = []
    dense = transformer_mod.dense_attention
    monkeypatch.setattr(transformer_mod, "dense_attention",
                        lambda *a, **k: dense_calls.append(1) or dense(*a,
                                                                       **k))
    want = JaxTPUModel.from_graph(
        jg, jv, "transformer_lm", model_config=LM, input_col="tokens",
        batch_size=4, data_parallel=False).transform(
        JaxDataset({"tokens": x}))["scores"]
    got = TPUModel.from_graph(
        tg, tv, "transformer_lm", model_config=LM, input_col="tokens",
        batch_size=4, feed_dtype="bfloat16", device="cpu").transform(
        Dataset({"tokens": x}))["scores"]  # token rows stay integers
    assert got.shape == (10, 16, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=LM_SCORE_TOL)
    # the learners build their own graphs: make both compute in f32
    from mmlspark_tpu.stages import dnn_learner as jax_learner_mod
    from mmlspark_tpu_torch.stages import dnn_learner as port_learner_mod

    jb, pb = jax_learner_mod.build_model, port_learner_mod.build_model
    monkeypatch.setattr(jax_learner_mod, "build_model",
                        lambda *a, **k: _f32_jax(jb(*a, **k)))
    monkeypatch.setattr(port_learner_mod, "build_model",
                        lambda *a, **k: _f32_port(pb(*a, **k)))
    monkeypatch.setattr(trainer_mod.bridge, "init_variables",
                        lambda graph, seed, device: tv)
    for cls in (JaxDNNLearner, DNNLearner):
        base = cls._train_config
        monkeypatch.setattr(cls, "_train_config", lambda self, base=base:
                            dataclasses.replace(base(self), log_every=1))
    kw = dict(model_name="transformer_lm", model_config=LM,
              features_col="tokens", epochs=1, batch_size=4,
              learning_rate=1e-3)
    from mmlspark_tpu.models import graph as jax_graph_mod

    monkeypatch.setattr(jax_graph_mod.NamedGraph, "init",
                        lambda self, rng, sample: jv)
    jm = JaxDNNLearner(mesh_axes={"data": 1}, **kw).fit(
        JaxDataset({"tokens": x, "label": y}))
    tm = DNNLearner(device="cpu", **kw).fit(Dataset({"tokens": x,
                                                     "label": y}))
    losses = [h["loss"] for h in tm.train_history]
    assert len(losses) == 3
    np.testing.assert_allclose(losses, [h["loss"] for h in jm.train_history],
                               rtol=0, atol=LM_LOSS_TOL)
    assert not dense_calls
