"""The port's trainer (``mmlspark_tpu_torch.train``) against the JAX
package's ``SPMDTrainer`` on one device (``mesh_axes={"data": 1}``): the
same tiny flash-attention LM, the same flax initialisation carried across
by the weight bridge, the same numpy data.

Model: ``transformer_lm(vocab 32, d_model 16, heads 4, kv_heads 2,
depth 2, max_len 16, attn_impl="flash")``, its blocks computing in float32
on both sides (the JAX side runs the Pallas kernels in interpret mode,
the port their plain versions). Data: 10 rows of 16 tokens, the labels
the rows shifted by one; batch 4, so each epoch's tail batch holds 2 real
rows and 2 padded ones.

Tolerances: loss and grad-norm histories 1e-5 (f32, sums in other
orders); final parameters 1e-4 at learning rate 1e-3 — except the key
bias of each ``qkv`` projection, whose true gradient is exactly zero
(adding a constant to every key's score of a row leaves its softmax
unchanged), so both sides hold rounding noise there and adam turns the
noise into full-size steps of either sign; it is held to its bound
instead (at most lr per step from where it started).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.core.exceptions import FriendlyError as JaxFriendlyError
from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu.data.feed import batch_iterator as jax_batch_iterator
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.train.trainer import SPMDTrainer as JaxTrainer
from mmlspark_tpu.train.trainer import TrainConfig as JaxConfig
from mmlspark_tpu.train.trainer import masked_loss as jax_masked_loss
from mmlspark_tpu_torch.core.exceptions import FriendlyError, ParamError
from mmlspark_tpu_torch.data import MASK_COL, Dataset, batch_iterator
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig, masked_loss


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(vocab_size=32, d_model=16, heads=4, kv_heads=2, depth=2,
            max_len=16, attn_impl="flash")
LR = 1e-3
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


def _f32_jax(graph):
    graph.blocks = [
        (n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype") else m)
        for n, m in graph.blocks
    ]
    return graph


def _f32_port(graph):
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


@pytest.fixture(scope="module")
def setup():
    """(x, y, JAX graph, flax variables on the host, port graph) with
    float32 compute, and the bf16 graphs of the same model."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, TINY["vocab_size"], size=(10, 16)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    jg = _f32_jax(jax_build_model("transformer_lm", **TINY))
    jv = jax.device_get(jax.jit(jg.init)(jax.random.PRNGKey(0),
                                         jnp.asarray(x[:1])))
    tg = _f32_port(build_model("transformer_lm", **TINY))
    bf16 = (jax_build_model("transformer_lm", **TINY),
            build_model("transformer_lm", **TINY))
    return x, y, jg, jv, tg, bf16


def _train_both(setup, graphs=None, epochs=2, **kw):
    """Train the JAX and the port trainer from the same weights; returns
    both trainers and both results (the JAX one bridged to the port's
    layout)."""
    x, y, jg, jv, tg, _ = setup
    jg, tg = graphs or (jg, tg)
    cfg = dict(epochs=epochs, batch_size=4, learning_rate=LR, log_every=1)
    cfg.update(kw)
    jt = JaxTrainer(jg, JaxConfig(mesh_axes={"data": 1}, **cfg))
    # the JAX trainer donates its input buffers: hand it host copies
    jout = jt.train(x, y, init_variables=jax.tree.map(np.array, jv))
    pt = SPMDTrainer(tg, TrainConfig(**cfg), device="cpu")
    pout = pt.train(x, y, init_variables=load_flax_variables(
        tg, jv, device="cpu"))
    return jt, pt, load_flax_variables(tg, jout, device="cpu"), pout


def _curve(trainer, key="loss"):
    return np.array([h[key] for h in trainer.history if key in h])


def _assert_params(want, got, steps):
    d, hk = TINY["d_model"] // TINY["heads"], TINY["kv_heads"]
    k_bias = slice(TINY["heads"] * d, (TINY["heads"] + hk) * d)
    for block, leaves in want.items():
        for name, w in leaves.items():
            g = got[block][name]
            if name == "attn.qkv.bias":
                # the key bias: no gradient, noise only (module docstring)
                assert (g[k_bias] - w[k_bias]).abs().max() <= 2 * LR * steps
                w, g = w.clone(), g.clone()
                w[k_bias] = g[k_bias] = 0.0
            err = (w - g).abs().max().item()
            assert err <= PARAM_TOL, (block, name, err)


@pytest.mark.parametrize("opt", [
    dict(optimizer="adam"),
    dict(optimizer="adamw", weight_decay=0.1, lr_schedule="cosine",
         warmup_steps=2),
], ids=["adam", "adamw_cosine"])
def test_trainer_matches_jax(setup, opt):
    jt, pt, want, got = _train_both(setup, **opt)
    assert len(pt.history) == len(jt.history) == 6
    np.testing.assert_allclose(_curve(pt), _curve(jt), atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(_curve(pt, "grad_norm"),
                               _curve(jt, "grad_norm"), atol=LOSS_TOL,
                               rtol=0)
    assert [h["step"] for h in pt.history] == [h["step"] for h in jt.history]
    _assert_params(want, got, steps=6)


def test_momentum_with_warmup_matches_jax(setup):
    """Momentum (a trace; no per-element normalisation, so the key bias
    is no special case) under a linear warmup."""
    jt, pt, want, got = _train_both(setup, epochs=1, optimizer="momentum",
                                    learning_rate=0.2, momentum=0.8,
                                    warmup_steps=2)
    np.testing.assert_allclose(_curve(pt), _curve(jt), atol=LOSS_TOL, rtol=0)
    for block, leaves in want.items():
        for name, w in leaves.items():
            assert (w - got[block][name]).abs().max().item() <= PARAM_TOL


def _port_run(setup, **kw):
    x, y, _, jv, tg, _ = setup
    cfg = dict(epochs=2, batch_size=4, learning_rate=LR, log_every=1)
    cfg.update(kw)
    trainer = SPMDTrainer(tg, TrainConfig(**cfg), device="cpu")
    out = trainer.train(x, y, init_variables=load_flax_variables(
        tg, jv, device="cpu"))
    return trainer, out


@pytest.mark.parametrize("kw", [dict(grad_accum=2), dict(remat=True),
                                dict(steps_per_dispatch=2)],
                         ids=["grad_accum2", "remat", "steps_per_dispatch2"])
def test_exact_variants_equal_the_plain_run(setup, kw):
    """grad_accum=2 (a strided split, weighted by mask counts — the
    padded tail's micro-batches hold 1 real row each), remat and two
    steps per dispatch change how a step runs, not what it computes. SGD,
    so parameters compare without adam's amplification of noise."""
    base_t, base = _port_run(setup, optimizer="sgd", learning_rate=0.5)
    t, got = _port_run(setup, optimizer="sgd", learning_rate=0.5, **kw)
    for block, leaves in base.items():
        for name, w in leaves.items():
            assert (w - got[block][name]).abs().max().item() <= 1e-5
    if "steps_per_dispatch" in kw:
        # the log cadence coarsens to the group (2 steps, then each
        # epoch's 1-step tail), with the group's last loss
        assert [h["step"] for h in t.history] == [1, 2, 4, 5]
        np.testing.assert_allclose(_curve(t), _curve(base_t)[[1, 2, 4, 5]],
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(_curve(t), _curve(base_t), atol=1e-5)


def test_quarantine_matches_jax(setup):
    """A max_grad_norm no step can meet: every step is quarantined, the
    parameters stay where they started, and the run aborts at the
    anomaly limit after the same history as the JAX trainer's."""
    x, y, jg, jv, tg, _ = setup
    cfg = dict(epochs=2, batch_size=4, learning_rate=LR, log_every=1,
               max_grad_norm=1e-6, anomaly_limit=4)
    jt = JaxTrainer(jg, JaxConfig(mesh_axes={"data": 1}, **cfg))
    with pytest.raises(JaxFriendlyError, match="4 consecutive anomalous"):
        jt.train(x, y, init_variables=jax.tree.map(np.array, jv))
    pt = SPMDTrainer(tg, TrainConfig(**cfg), device="cpu")
    with pytest.raises(FriendlyError, match="4 consecutive anomalous"):
        pt.train(x, y, init_variables=load_flax_variables(tg, jv,
                                                          device="cpu"))
    assert len(pt.history) == len(jt.history) == 4
    np.testing.assert_allclose(_curve(pt), _curve(jt), atol=LOSS_TOL, rtol=0)
    assert pt.telemetry.counter("train.anomalies_skipped").value == 4
    assert [e["name"] for e in pt.recorder.events()].count("anomaly") == 4
    # no abort: the parameters come back untouched
    _, out = _port_run(setup, max_grad_norm=1e-6, anomaly_limit=0)
    init = load_flax_variables(tg, jv, device="cpu")
    for block, leaves in init.items():
        for name, w in leaves.items():
            assert torch.equal(w, out[block][name])


def test_bf16_training_tracks_jax(setup):
    """The default bf16 compute: the first loss within 1e-2 of the JAX
    trainer's (bf16 rounds at the same places, sums differ), and both
    curves fall."""
    _, _, _, _, _, bf16 = setup
    jt, pt, _, _ = _train_both(setup, graphs=bf16, epochs=3,
                               learning_rate=1e-2)
    jl, pl = _curve(jt), _curve(pt)
    assert abs(pl[0] - jl[0]) <= 1e-2
    assert pl[-1] < pl[0] and jl[-1] < jl[0]


def test_unported_fields_raise(setup):
    _, _, _, _, tg, _ = setup
    # checkpoint_dir and audit_every are ported: their positive tests are
    # in test_torch_train_resilience.py. The mesh mode is ported too
    # (tests/test_torch_trainer_mesh*.py, over gloo ranks): a mesh wider
    # than one device needs a process group, and make_mesh says so
    with pytest.raises(FriendlyError, match="initialised process group"):
        _port_run(setup, mesh_axes={"data": 2})
    # one device on the data axis, and rules on one device, are the plain
    # trainer: the same curve as without them
    plain, _ = _port_run(setup, epochs=1)
    for kw in (dict(mesh_axes={"data": 1}),
               dict(param_rules=[("qkv", (None, "model"))])):
        got, _ = _port_run(setup, epochs=1, **kw)
        assert _curve(got).tolist() == _curve(plain).tolist()
    with pytest.raises(ParamError, match="unknown optimizer"):
        _port_run(setup, optimizer="lion")
    with pytest.raises(FriendlyError, match="grad_accum=3"):
        _port_run(setup, grad_accum=3)


def test_trainer_telemetry_and_eval(setup):
    seen = []
    x, y, _, jv, tg, _ = setup
    trainer = SPMDTrainer(tg, TrainConfig(epochs=2, batch_size=4,
                                          log_every=2), device="cpu")
    trainer.train(x, y, init_variables=load_flax_variables(tg, jv,
                                                          device="cpu"),
                  eval_fn=lambda v: seen.append(v) or {"eval": 1.0})
    tel = trainer.telemetry.to_dict()
    # 6 steps logged every 2nd: steps 1, 3, 5
    assert tel["train.loss_count"] == tel["train.step_ms_count"] == 3
    assert tel["train.tokens_per_sec_p50"] > 0
    assert tel["train.grad_accum"] == 1.0
    assert [h.get("eval") for h in trainer.history] == [
        None, None, 1.0, None, 1.0]
    assert len(seen) == 2 and not seen[0]["z"]["head.weight"].requires_grad


@pytest.mark.parametrize("kind", ["softmax_xent", "sigmoid_xent", "mse"])
def test_masked_loss_matches_jax(kind):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 5, 6)).astype(np.float32)
    if kind == "softmax_xent":
        labels = rng.integers(0, 6, size=(4, 5)).astype(np.int32)
    else:
        logits = logits[..., :1]
        labels = rng.uniform(size=(4, 5)).astype(np.float32)
    mask = np.array([True, True, False, True])
    want = jax_masked_loss(kind, jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(mask))
    got = masked_loss(kind, torch.from_numpy(logits),
                      torch.from_numpy(labels), torch.from_numpy(mask))
    assert abs(float(want) - got.item()) <= 1e-6


def test_batches_equal_jax():
    x = np.arange(30).reshape(10, 3)
    y = np.arange(10) * 2.0
    for seed in (None, 7):
        want = list(jax_batch_iterator(JaxDataset({"x": x, "y": y}),
                                       ["x", "y"], 4, shuffle_seed=seed))
        got = list(batch_iterator(Dataset({"x": x, "y": y}), ["x", "y"], 4,
                                  shuffle_seed=seed))
        assert len(got) == len(want) == 3
        for w, g in zip(want, got):
            for col in ("x", "y", MASK_COL):
                np.testing.assert_array_equal(w[col], g[col])
    assert list(got[-1][MASK_COL]) == [True, True, False, False]
