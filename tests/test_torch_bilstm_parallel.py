"""The port's sequence-parallel BiLSTM (``mmlspark_tpu_torch/parallel/
sequence_rnn.py``) and the tagger's data-parallel training, mirroring
``tests/test_bilstm_parallel.py`` test for test.

The port's side runs on one gloo group of 4 CPU ranks
(``testing/rank_pool.RankPool``), started once for the file; the
``_on_rank_*`` bodies run on every rank on the same seeded inputs, global
in and global out. Where the JAX test shards over 8 devices the port uses
4 ranks (``seq=4`` for ``seq=8``, ``data=2, seq=2`` for ``data=2,
seq=4``). The chain is held to the port's dense tagger on weights
bridged from the JAX package's flax variables, and that dense tagger to
JAX's jitted dense ``graph.apply``. JAX's own sequence-parallel function
is not called here (its gradient test alone takes minutes on a loaded
host); its error texts are, which it raises before any compile.

Tolerances: the chain against the dense tagger within f32 1e-5 (the LSTM
is f32; the head computes in bf16 on both paths over the same hidden
states); the dense tagger against JAX's within ``BF16_LOGIT_TOL`` (a
bf16 head across frameworks); gradients within the JAX test's own
bound for this comparison (the bf16 head's backward sums its tokens in
another order once the tokens are split over ranks: atol 2e-3, rtol
2e-2), and the LSTM's own leaves within 1e-4.
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
F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
HEAD_GRAD = dict(atol=2e-3, rtol=2e-2)
BF16_LOGIT_TOL = 6.25e-2
TAGGER = dict(vocab_size=31, embed_dim=8, hidden=6, num_tags=5)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD)
    try:
        yield pool
    finally:
        pool.close()


@pytest.fixture(scope="module")
def tagger():
    """The JAX tagger's flax variables (host copies) and its jitted dense
    forward."""
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model

    graph = build_model("bilstm_tagger", **TAGGER)
    variables = jax.device_get(jax.jit(graph.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32)))
    return variables, jax.jit(graph.apply)


def _ids(rng, b, t, vocab=31):
    return rng.integers(0, vocab, size=(b, t)).astype(np.int32)


# -- bodies run on every rank ---------------------------------------------


def _port(flax_vars):
    from mmlspark_tpu_torch.models import build_model, load_flax_variables

    graph = build_model("bilstm_tagger", **TAGGER)
    return graph, load_flax_variables(graph, flax_vars, device="cpu")


def _on_rank_apply(axes, flax_vars, ids):
    """The chain's logits and the dense tagger's."""
    from mmlspark_tpu_torch.parallel import (
        bilstm_seq_parallel_apply,
        make_mesh,
    )

    mesh = make_mesh(axes)
    graph, v = _port(flax_vars)
    x = torch.from_numpy(ids)
    return (bilstm_seq_parallel_apply(graph, v, ids, mesh).numpy(),
            graph.apply(v, x).numpy())


def _on_rank_errors(axes, flax_vars, ids):
    from mmlspark_tpu_torch.parallel import (
        bilstm_seq_parallel_apply,
        make_mesh,
    )

    mesh = make_mesh(axes)
    graph, v = _port(flax_vars)
    try:
        bilstm_seq_parallel_apply(graph, v, ids, mesh)
    except ValueError as e:
        return str(e)
    return None


def _xent(logits, tags):
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, torch.from_numpy(tags).long()[..., None]).mean()


def _on_rank_grads(axes, flax_vars, ids, tags):
    """Every variable's gradient of the token cross-entropy through the
    chain and through the dense tagger."""
    from mmlspark_tpu_torch.parallel import (
        bilstm_seq_parallel_apply,
        make_mesh,
    )

    mesh = make_mesh(axes)
    graph, v = _port(flax_vars)
    out = []
    for par in (True, False):
        leaves = {b: {k: t.clone().requires_grad_() for k, t in blk.items()}
                  for b, blk in v.items()}
        if par:
            logits = bilstm_seq_parallel_apply(graph, leaves, ids, mesh)
        else:
            logits, _ = graph.apply(leaves, torch.from_numpy(ids),
                                    train=True)
        _xent(logits, tags).backward()
        out.append({f"{b}.{k}": t.grad.numpy() for b, blk in leaves.items()
                    for k, t in blk.items()})
    return out


def _on_rank_mixed_step(axes, flax_vars, ids, tags):
    """Four mixed-axis SGD steps, the same four on the dense tagger, and
    the trained weights' chain against their dense forward."""
    from mmlspark_tpu_torch.parallel import (
        bilstm_seq_parallel_apply,
        bilstm_seq_parallel_train_step,
        make_mesh,
    )

    mesh = make_mesh(axes)
    graph, v = _port(flax_vars)
    losses, dense_losses = [], []
    vd = v
    for _ in range(4):
        loss, v = bilstm_seq_parallel_train_step(graph, v, ids, tags, mesh,
                                                 learning_rate=5e-2)
        losses.append(float(loss))
        leaves = {b: {k: t.clone().requires_grad_() for k, t in blk.items()}
                  for b, blk in vd.items()}
        logits, _ = graph.apply(leaves, torch.from_numpy(ids), train=True)
        dl = _xent(logits, tags)
        dl.backward()
        dense_losses.append(float(dl))
        vd = {b: {k: (t - 5e-2 * t.grad).detach() for k, t in blk.items()}
              for b, blk in leaves.items()}
    par = bilstm_seq_parallel_apply(graph, v, ids, mesh).numpy()
    dense = graph.apply(v, torch.from_numpy(ids)).numpy()
    return losses, dense_losses, par, dense


def _on_rank_dp_train(ids, tags):
    """The tagger trained by SPMDTrainer over data=4 and on one device."""
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    graph = build_model("bilstm_tagger", **TAGGER)
    cfg = dict(epochs=6, batch_size=16, learning_rate=5e-2, log_every=1,
               shuffle=False)
    curves = []
    for axes in ({"data": WORLD}, None):
        trainer = SPMDTrainer(graph, TrainConfig(mesh_axes=axes, **cfg),
                              device="cpu")
        trainer.train(ids, tags)
        curves.append([h["loss"] for h in trainer.history])
    return curves


# -- the tests ----------------------------------------------------------------


def test_seq_parallel_matches_dense(ranks, tagger):
    variables, jax_apply = tagger
    ids = _ids(np.random.default_rng(0), 3, 16)
    want = np.asarray(jax_apply(variables, ids))
    for par, dense in ranks.run(_on_rank_apply, {"seq": 4}, variables, ids):
        np.testing.assert_allclose(par, dense, **F32)
        assert np.abs(dense - want).max() <= BF16_LOGIT_TOL


def test_seq_parallel_data_seq_mesh(ranks, tagger):
    """2D data x seq mesh: batch and time sharded at once."""
    variables, jax_apply = tagger
    ids = _ids(np.random.default_rng(1), 4, 12)
    want = np.asarray(jax_apply(variables, ids))
    for par, dense in ranks.run(_on_rank_apply, {"data": 2, "seq": 2},
                                variables, ids):
        np.testing.assert_allclose(par, dense, **F32)
        assert np.abs(dense - want).max() <= BF16_LOGIT_TOL


def test_seq_parallel_rejects_indivisible(ranks, tagger):
    from mmlspark_tpu.models import build_model
    from mmlspark_tpu.parallel import bilstm_seq_parallel_apply, make_mesh

    variables, _ = tagger
    graph = build_model("bilstm_tagger", **TAGGER)
    rng = np.random.default_rng(2)
    for axes, ids in (({"seq": 4}, _ids(rng, 2, 9)),
                      ({"data": 2, "seq": 2}, _ids(rng, 3, 8)),
                      ({"data": 4}, _ids(rng, 4, 8))):
        with pytest.raises(ValueError) as e:
            bilstm_seq_parallel_apply(graph, variables, ids,
                                      make_mesh(axes))
        got = ranks.run(_on_rank_errors, axes, variables, ids)
        assert got == [str(e.value)] * WORLD
    assert "not divisible" in got[0] or "no 'seq' axis" in got[0]


def test_seq_parallel_grads_match_dense(ranks, tagger):
    """The backward runs the chain in reverse: every variable's gradient
    through it matches the dense tagger's."""
    variables, _ = tagger
    rng = np.random.default_rng(3)
    ids = _ids(rng, 2, 8)
    tags = rng.integers(0, 5, size=(2, 8)).astype(np.int32)
    for par, dense in ranks.run(_on_rank_grads, {"seq": 4}, variables, ids,
                                tags):
        assert par.keys() == dense.keys()
        for name in par:
            tol = HEAD_GRAD if name.startswith("z.") else GRAD
            np.testing.assert_allclose(par[name], dense[name], **tol,
                                       err_msg=name)


def test_bilstm_mixed_axis_training_step(ranks, tagger):
    """Batch over data AND time over seq in one SGD step: the loss falls
    over four steps, each step's loss is the dense tagger's, and the
    trained weights still agree between the chain and the dense
    forward."""
    variables, _ = tagger
    rng = np.random.default_rng(5)
    ids = _ids(rng, 4, 12)
    tags = (ids % 5).astype(np.int32)
    for losses, dense_losses, par, dense in ranks.run(
            _on_rank_mixed_step, {"data": 2, "seq": 2}, variables, ids,
            tags):
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        np.testing.assert_allclose(losses, dense_losses, atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(par, dense, **F32)


def test_bilstm_dp_training_on_mesh(ranks):
    """Data-parallel tagger training over the mesh (4 ranks), the loss
    falling as in the JAX test, and the curve within the bf16 head's
    rounding of the one-device run's."""
    rng = np.random.default_rng(4)
    ids = _ids(rng, 8 * WORLD, 8)
    tags = (ids % 5).astype(np.int32)  # a learnable rule
    for meshed, single in ranks.run(_on_rank_dp_train, ids, tags):
        assert meshed[-1] < meshed[0] * 0.8, meshed
        assert abs(meshed[0] - single[0]) <= 1e-2
        np.testing.assert_allclose(meshed, single, atol=2e-2, rtol=2e-2)
