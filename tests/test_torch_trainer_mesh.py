"""The trainer's mesh mode (``mmlspark_tpu_torch/train/distributed.py``):
data parallelism, the parameter rules (tensor, pipeline, expert) and the
expert axis, against the JAX package's trainer and the port's own
one-device trainer.

The port's side runs on one gloo group of 4 CPU ranks
(``testing/rank_pool.RankPool``), started once for the file; each
``_on_rank_*`` body runs the trainer on every rank on the same seeded
data, and ranks a smaller mesh leaves out return None. The JAX side runs
on the conftest's 8-device CPU mesh at the same mesh shape, from the same
flax variables (its trainer's ``init_variables``).

Model for the JAX parity: ``transformer_lm(vocab 32, d_model 16, heads 4,
kv_heads 2, depth 2, max_len 16, attn_impl="dense")`` computing in
float32 on both sides; 10 rows of 16 tokens, batch 4, so each epoch's
tail batch holds 2 real rows and 2 padded ones. Tolerances are those of
``tests/test_torch_train.py``: loss curves within ``LOSS_TOL`` = 1e-5 and
parameters within ``PARAM_TOL`` = 1e-4, the key bias of each ``qkv``
aside (its true gradient is zero, so adam turns both sides' rounding
noise into full steps: it is held to lr a step).
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
TINY = dict(vocab_size=32, d_model=16, heads=4, kv_heads=2, depth=2,
            max_len=16, attn_impl="dense")
#: the JAX MoE test's LM, computing in float32 on both sides
MOE = dict(vocab_size=32, d_model=16, heads=2, depth=1, n_experts=4,
           max_len=8, attn_impl="dense")
MOE_CFG = dict(epochs=2, batch_size=8, learning_rate=1e-2, log_every=1,
               shuffle=False)
LR = 1e-3
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
#: the bf16 MLP's one-device against 4-way data parallel (the JAX test's
#: bound for the same comparison)
MLP_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD)
    try:
        yield pool
    finally:
        pool.close()


def _lm_data():
    rng = np.random.default_rng(0)
    x = rng.integers(0, TINY["vocab_size"], size=(10, 16)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _f32_port(graph):
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


def _two_blob_data(n=128, d=8, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([rng.normal(-1.5, 1.0, (half, d)),
                        rng.normal(1.5, 1.0, (half, d))]).astype(np.float32)
    y = np.concatenate([np.zeros(half), np.ones(half)]).astype(np.int32)
    perm = rng.permutation(n)
    return x[perm], y[perm]


# -- bodies run on every rank ---------------------------------------------


def _losses(trainer):
    return [h["loss"] for h in trainer.history if "loss" in h]


def _on_rank_lm(axes, flax_vars, epochs=2, batch=4, **kw):
    """The f32 LM trained over ``axes`` from the bridged flax variables:
    (loss curve, grad-norm curve, final variables as numpy)."""
    from mmlspark_tpu_torch.models import build_model, load_flax_variables
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    x, y = _lm_data()
    graph = _f32_port(build_model("transformer_lm", **TINY))
    trainer = SPMDTrainer(graph, TrainConfig(
        epochs=epochs, batch_size=batch, learning_rate=LR, log_every=1,
        mesh_axes=axes, **kw), device="cpu")
    out = trainer.train(x, y, init_variables=load_flax_variables(
        graph, flax_vars, device="cpu"))
    if out is None:
        return None
    return (_losses(trainer),
            [h["grad_norm"] for h in trainer.history],
            {b: {k: t.numpy() for k, t in blk.items()}
             for b, blk in out.items()})


def _on_rank_mlp(axes):
    """The bf16 MLP over ``axes`` and on one device (the JAX test's
    mesh-against-one-device leg)."""
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    x, y = _two_blob_data()
    cfg = dict(epochs=2, batch_size=32, learning_rate=5e-3, shuffle=False,
               log_every=1)
    g = build_model("mlp", num_outputs=2, hidden=(8,))
    meshed = SPMDTrainer(g, TrainConfig(**cfg, mesh_axes=axes),
                         device="cpu").train(x, y)
    single = SPMDTrainer(g, TrainConfig(**cfg), device="cpu").train(x, y)
    return [(meshed[b][k].numpy(), single[b][k].numpy())
            for b in single for k in single[b]]


def _on_rank_rules(axes, attn_impl, rules_name):
    """The f32 LM over ``axes`` with ``attn_impl`` (ring needs a seq axis)
    under a rule set, and the same run on one device (dense attention,
    no rules): both curves, and the global logits' shape."""
    from mmlspark_tpu_torch import parallel
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import make_mesh
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    rng = np.random.default_rng(3)
    x = rng.integers(0, 32, size=(8, 8)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    config = dict(vocab_size=32, d_model=16, heads=4, depth=1, max_len=8)
    mesh = make_mesh(axes)
    graph = _f32_port(build_model("transformer_lm", attn_impl=attn_impl,
                                  mesh=mesh, **config))
    v0 = init_variables(graph, 0, device="cpu")
    cfg = dict(epochs=2, batch_size=4, learning_rate=1e-2, log_every=1,
               shuffle=False)
    trainer = SPMDTrainer(graph, TrainConfig(
        mesh_axes=axes, param_rules=getattr(parallel, rules_name), **cfg),
        device="cpu")
    out = trainer.train(x, y, init_variables=v0)
    if out is None:
        return None
    shape = tuple(graph.apply(out, torch.from_numpy(x[:2])).shape)
    dense = _f32_port(build_model("transformer_lm", attn_impl="dense",
                                  **config))
    ref = SPMDTrainer(dense, TrainConfig(**cfg), device="cpu")
    ref.train(x, y, init_variables=v0)
    return _losses(trainer), _losses(ref), shape


def _moe_data():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, MOE["vocab_size"], size=(16, 8)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _on_rank_moe_parity(axes, flax_vars, group_size):
    """The f32 switch-MoE LM trained over ``axes`` under EXPERT_RULES and
    on one device, both from the bridged flax variables, routing in
    groups of ``group_size``: (mesh curves, one-device curves, both final
    variables, the trained logits' shape)."""
    from mmlspark_tpu_torch.models import build_model, load_flax_variables
    from mmlspark_tpu_torch.parallel import EXPERT_RULES, make_mesh
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    ids, labels = _moe_data()
    graph = _f32_port(build_model("transformer_lm_moe", mesh=make_mesh(axes),
                                  **MOE))
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "group_size"):
                m.group_size = group_size
    runs = []
    for cfg in (dict(mesh_axes=axes, param_rules=EXPERT_RULES), {}):
        trainer = SPMDTrainer(graph, TrainConfig(**MOE_CFG, **cfg),
                              device="cpu")
        out = trainer.train(ids, labels, init_variables=load_flax_variables(
            graph, flax_vars, device="cpu"))
        if out is None:
            return None
        runs.append((_losses(trainer),
                     [h["grad_norm"] for h in trainer.history],
                     {b: {k: t.numpy() for k, t in blk.items()}
                      for b, blk in out.items()}))
    shape = tuple(graph.apply(out, torch.from_numpy(ids[:2])).shape)
    return runs, shape


def _on_rank_moe(axes, ckpt):
    """The JAX test's checkpoint-resume leg at data=2."""
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    rng = np.random.default_rng(2)
    graph = build_model("transformer_lm_moe", vocab_size=16, d_model=8,
                        heads=2, depth=1, n_experts=2, max_len=4)
    ids = rng.integers(0, 16, size=(8, 4)).astype(np.int32)
    cfg = dict(batch_size=4, learning_rate=1e-2, log_every=1, shuffle=False,
               mesh_axes=axes, checkpoint_dir=ckpt, checkpoint_every=1)
    SPMDTrainer(graph, TrainConfig(epochs=1, **cfg), device="cpu").train(
        ids, np.roll(ids, -1, axis=1))
    resumed = SPMDTrainer(graph, TrainConfig(epochs=2, **cfg), device="cpu")
    out = resumed.train(ids, np.roll(ids, -1, axis=1))
    if out is None:
        return None
    return ([h["step"] for h in resumed.history if "loss" in h],
            tuple(graph.apply(out, torch.from_numpy(ids[:2])).shape))


def _on_rank_layout(axes):
    """The mesh trainer's storage under EXPERT_RULES: each rank's part of
    every expert leaf, and the whole stack gathered back from the parts."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import EXPERT_RULES, make_mesh
    from mmlspark_tpu_torch.train import TrainConfig
    from mmlspark_tpu_torch.train.distributed import MeshRun

    graph = build_model("transformer_lm_moe", vocab_size=32, d_model=16,
                        heads=2, depth=1, n_experts=4, max_len=8,
                        mesh=make_mesh(axes))
    whole = init_variables(graph, 0, device="cpu")
    run = MeshRun(TrainConfig(mesh_axes=axes, param_rules=EXPERT_RULES),
                  torch.device("cpu"))
    run.plan(graph, whole)
    local = {b: {k: run.shard(b, k, t) for k, t in blk.items()}
             for b, blk in whole.items()}
    back = run.gather(local, differentiable=False)
    return ({k: tuple(t.shape) for k, t in local["block0"].items()
             if "experts" in k},
            all(torch.equal(back[b][k], whole[b][k])
                for b in whole for k in whole[b]))


def _on_rank_validate(axes, n_experts):
    from mmlspark_tpu_torch.core.exceptions import ParamError
    from mmlspark_tpu_torch.parallel import make_mesh, validate_experts

    try:
        validate_experts(n_experts, make_mesh(axes))
    except ParamError as e:
        return str(e)
    return None


# -- the JAX side -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX f32 LM and its flax variables (host copies)."""
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model

    graph = build_model("transformer_lm", **TINY)
    graph.blocks = [
        (n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype") else m)
        for n, m in graph.blocks
    ]
    x, _ = _lm_data()
    jv = jax.device_get(jax.jit(graph.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x[:1])))
    return graph, jv


def _jax_train(jax_setup, axes):
    import jax

    from mmlspark_tpu.train.trainer import SPMDTrainer, TrainConfig

    graph, jv = jax_setup
    x, y = _lm_data()
    trainer = SPMDTrainer(graph, TrainConfig(
        epochs=2, batch_size=4, learning_rate=LR, log_every=1,
        mesh_axes=axes))
    # the JAX trainer donates its inputs: hand it host copies
    out = trainer.train(x, y, init_variables=jax.tree.map(np.array, jv))
    return trainer, jax.device_get(out)


def _jax_moe_train(flax_vars, axes, group_size):
    """The JAX trainer on the f32 MoE LM over ``axes`` under EXPERT_RULES,
    routing in groups of ``group_size`` (the MoE FFN's field)."""
    import functools

    import jax

    import mmlspark_tpu.models.moe as jm
    from mmlspark_tpu.models import build_model
    from mmlspark_tpu.parallel import EXPERT_RULES
    from mmlspark_tpu.train.trainer import SPMDTrainer, TrainConfig

    graph = _jax_f32(build_model("transformer_lm_moe", **MOE))
    ids, labels = _moe_data()
    mp = pytest.MonkeyPatch()
    mp.setattr(jm, "MoEFFN", functools.partial(jm.MoEFFN,
                                               group_size=group_size))
    try:
        trainer = SPMDTrainer(graph, TrainConfig(
            **MOE_CFG, mesh_axes=axes, param_rules=EXPERT_RULES))
        out = trainer.train(ids, labels,
                            init_variables=jax.tree.map(np.array, flax_vars))
    finally:
        mp.undo()
    return trainer, jax.device_get(out)


def _jax_f32(graph):
    import jax.numpy as jnp

    graph.blocks = [
        (n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype") else m)
        for n, m in graph.blocks
    ]
    return graph


@pytest.fixture(scope="module")
def jax_moe_vars():
    """The f32 MoE LM's flax variables (host copies)."""
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model

    graph = _jax_f32(build_model("transformer_lm_moe", **MOE))
    ids, _ = _moe_data()
    return jax.device_get(jax.jit(graph.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(ids[:1])))


def _assert_params(want: dict, got: dict, steps: int, config: dict = TINY,
                   lr: float = LR):
    heads = config["heads"]
    d, hk = config["d_model"] // heads, config.get("kv_heads") or heads
    k_bias = slice(heads * d, (heads + hk) * d)
    for block, leaves in want.items():
        for name, w in leaves.items():
            g = got[block][name]
            w, g = np.array(w), np.array(g)
            if name == "attn.qkv.bias":
                # the key bias: no gradient, noise only (module docstring)
                assert np.abs(g[k_bias] - w[k_bias]).max() <= 2 * lr * steps
                w[k_bias] = g[k_bias] = 0.0
            err = np.abs(w - g).max()
            assert err <= PARAM_TOL, (block, name, err)


# -- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("n_data", [2, 4])
def test_dp_losses_match_jax(ranks, jax_setup, n_data):
    """Data parallelism at data=2 and data=4 against the JAX trainer on
    the same mesh shape and initial variables: the loss and grad-norm
    curves (the global mask count normalises the padded tail) and the
    final parameters."""
    from mmlspark_tpu_torch.models import build_model, load_flax_variables

    axes = {"data": n_data}
    pending = ranks.submit(_on_rank_lm, axes, jax_setup[1])
    jt, jout = _jax_train(jax_setup, axes)
    results = [r for r in pending.result() if r is not None]
    assert len(results) == n_data
    want_loss = [h["loss"] for h in jt.history]
    want_gnorm = [h["grad_norm"] for h in jt.history]
    port = _f32_port(build_model("transformer_lm", **TINY))
    want = {b: {k: t.numpy() for k, t in blk.items()} for b, blk in
            load_flax_variables(port, jout, device="cpu").items()}
    for losses, gnorms, params in results:
        np.testing.assert_allclose(losses, want_loss, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(gnorms, want_gnorm, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        _assert_params(want, params, len(losses))
    # the replicas hold one copy
    for _, _, params in results[1:]:
        for b in params:
            for k in params[b]:
                np.testing.assert_array_equal(params[b][k],
                                              results[0][2][b][k])


def test_batch_sharded_over_mesh_matches_single_device(ranks):
    """Gradient sync: training over the 4-way data axis matches the math
    of one-device training (same seed, same batches, same params)."""
    for pairs in ranks.run(_on_rank_mlp, {"data": WORLD}):
        for meshed, single in pairs:
            np.testing.assert_allclose(meshed, single, **MLP_TOL)


def test_masked_padded_tail_with_accumulation(ranks, jax_setup):
    """A masked, padded tail batch (10 rows, batch 8: the tail holds 2
    real rows) with grad_accum=2 over data=2 equals the one-device run
    (whose accumulation is held to JAX's in tests/test_torch_train.py):
    the counts of each micro-batch are summed over data before the
    backward."""
    jv = jax_setup[1]
    res = ranks.run(_on_rank_lm, {"data": 2}, jv, 2, 8, grad_accum=2)
    single = ranks.run(_on_rank_lm, None, jv, 2, 8, grad_accum=2)[0]
    for losses, gnorms, params in (r for r in res if r is not None):
        np.testing.assert_allclose(losses, single[0], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(gnorms, single[1], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        _assert_params(single[2], params, len(losses))


@pytest.mark.parametrize("axes,attn_impl", [
    ({"data": 2, "model": 2}, "dense"),
    ({"seq": 2, "model": 2}, "ring"),
    ({"data": 2, "seq": 2}, "ulysses"),
], ids=["data2-model2", "seq2-model2-ring", "data2-seq2-ulysses"])
def test_trainer_dp_sp_tp(ranks, axes, attn_impl):
    """A full training step over a mesh with sequence parallelism and
    the Megatron rules (the JAX test's data x seq x model on 8 devices,
    two axes at a time on 4 ranks): finite losses that fall, the
    global logits' shape, and — float32 — the one-device dense run's
    curve."""
    for losses, plain, shape in (r for r in ranks.run(
            _on_rank_rules, axes, attn_impl, "TRANSFORMER_TP_RULES")
            if r is not None):
        assert losses and all(np.isfinite(losses))
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, plain, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        assert shape == (2, 8, 32)


@pytest.mark.parametrize("group_size", [8, 1024],
                         ids=["groups-within-ranks", "groups-across-ranks"])
def test_trainer_moe_expert_parallel(ranks, jax_moe_vars, group_size):
    """The f32 switch-MoE LM over data=2, expert=2 under EXPERT_RULES
    (each rank stores two of the four experts) against the JAX trainer on
    the same mesh shape and flax variables, and against the port's
    one-device run: loss and grad-norm curves within LOSS_TOL, parameters
    within PARAM_TOL. Each data rank holds 32 tokens: groups of 8 lie
    within a rank's block (each rank routes its own), one group of all 64
    tokens spans both (the ranks route the gathered batch); either way
    the capacity and the aux loss are the global batch's."""
    from mmlspark_tpu_torch.models import build_model, load_flax_variables

    axes = {"data": 2, "expert": 2}
    pending = ranks.submit(_on_rank_moe_parity, axes, jax_moe_vars,
                           group_size)
    jt, jout = _jax_moe_train(jax_moe_vars, axes, group_size)
    results = [r for r in pending.result() if r is not None]
    assert len(results) == WORLD
    want_loss = [h["loss"] for h in jt.history if "loss" in h]
    want_gnorm = [h["grad_norm"] for h in jt.history if "loss" in h]
    port = _f32_port(build_model("transformer_lm_moe", **MOE))
    want = {b: {k: t.numpy() for k, t in blk.items()} for b, blk in
            load_flax_variables(port, jout, device="cpu").items()}
    for runs, shape in results:
        (losses, gnorms, params), (s_losses, s_gnorms, s_params) = runs
        assert len(losses) == 4 and losses[-1] < losses[0]
        for got_loss, got_gnorm, got in runs:
            np.testing.assert_allclose(got_loss, want_loss, atol=LOSS_TOL,
                                       rtol=LOSS_TOL)
            np.testing.assert_allclose(got_gnorm, want_gnorm,
                                       atol=LOSS_TOL, rtol=LOSS_TOL)
            _assert_params(want, got, len(losses), MOE, MOE_CFG[
                "learning_rate"])
        np.testing.assert_allclose(losses, s_losses, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        _assert_params(s_params, params, len(losses), MOE,
                       MOE_CFG["learning_rate"])
        assert params["block0"]["moe.experts.w_in"].shape == (4, 16, 64)
        assert shape == (2, 8, 32)
    # each rank stores two of the four experts; the gather restores all
    for shapes, restored in ranks.run(_on_rank_layout,
                                      {"data": 2, "expert": 2}):
        assert shapes == {"moe.experts.w_in": (2, 16, 64),
                          "moe.experts.b_in": (2, 64),
                          "moe.experts.w_out": (2, 64, 16),
                          "moe.experts.b_out": (2, 16)}
        assert restored


def test_trainer_moe_checkpoint_resume(ranks, tmp_path):
    """Sown losses stay out of the carried state, so a resume over
    data=2 restores and runs past the first epoch."""
    res = [r for r in ranks.run(_on_rank_moe, {"data": 2},
                                str(tmp_path / "ckpt")) if r is not None]
    for steps, shape in res:
        assert steps and min(steps) >= 2  # resumed past epoch 1
        assert shape == (2, 4, 16)


def test_validate_experts(ranks):
    from mmlspark_tpu.core.exceptions import ParamError as JaxParamError
    from mmlspark_tpu.parallel import make_mesh
    from mmlspark_tpu.parallel.expert import validate_experts

    with pytest.raises(JaxParamError) as e:
        validate_experts(6, make_mesh({"expert": 4}))
    assert ranks.run(_on_rank_validate, {"expert": 4}, 6) == \
        [str(e.value)] * WORLD
    validate_experts(8, make_mesh({"expert": 4}))
    assert ranks.run(_on_rank_validate, {"expert": 4}, 8) == [None] * WORLD
