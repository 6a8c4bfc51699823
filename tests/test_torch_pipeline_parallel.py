"""The port's pipeline parallelism (``mmlspark_tpu_torch/parallel/
pipeline.py``) and pipelined LM (``models/pipelined.py``) against the JAX
package's, mirroring ``tests/test_pipeline_parallel.py`` test for test.

The JAX side runs on the conftest's 8-device CPU mesh; the port's on one
gloo group of 4 CPU ranks (``testing/rank_pool.RankPool``), started once
for the file, one intra-op thread a rank. The ``_on_rank_*`` bodies run
on every rank (loaded by the workers from this file, so they import
nothing of JAX) on the same seeded numpy inputs, global in and global
out. Where the JAX test uses ``data=2, pipe=4`` (8 devices) the port runs
``data=2, pipe=2``, and the JAX reference runs at that mesh shape too.

Tolerances: f32 outputs within 1e-5 and gradients within 1e-4 (the
stages run in float32 on both sides: the JAX stage's Blocks built with
``dtype=float32``, the port's modules set to float32); the pipelined LM
trained at ``data=2, pipe=2`` against the same model trained as a plain
``transformer_lm`` on one device (its stages' layers as blocks) within
``LOSS_TOL`` = 1e-5 on the loss curve.
"""

from __future__ import annotations

import functools

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
LOSS_TOL = 1e-5
LM = dict(vocab_size=32, d_model=16, heads=2, max_len=8)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD)
    try:
        yield pool
    finally:
        pool.close()


def _stacked_linear(seed: int, n_stages: int, d: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(n_stages, d, d)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(n_stages, d)) * 0.1).astype(np.float32)}


def _f32_port(graph):
    for _, mod in graph.blocks:
        for m in [*mod.modules(), *getattr(mod, "template",
                                            torch.nn.Module()).modules()]:
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


# -- bodies run on every rank ---------------------------------------------


def _linear_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _sequential(params, x, n):
    for i in range(n):
        x = _linear_stage({k: v[i] for k, v in params.items()}, x)
    return x


def _on_rank_pipeline(axes, params, mb, grads=False):
    """The port's pipeline_apply over ``axes`` and the stages in turn on
    the same inputs; with ``grads``, both sides' gradients of the sum."""
    from mmlspark_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh(axes)
    if mesh.get_coordinate() is None:
        return None  # a rank the mesh leaves out
    p = {k: torch.from_numpy(v).requires_grad_(grads)
         for k, v in params.items()}
    x = torch.from_numpy(mb).requires_grad_(grads)
    got = pipeline_apply(_linear_stage, p, x, mesh)
    want = _sequential(p, x, len(params["w"]))
    out = {"got": got.detach().numpy(), "want": want.detach().numpy()}
    if grads:
        leaves = [p["w"], p["b"], x]
        out["grads"] = [g.numpy() for g in
                        torch.autograd.grad(got.sum(), leaves)]
        out["want_grads"] = [g.numpy() for g in
                             torch.autograd.grad(want.sum(), leaves)]
    return out


def _on_rank_no_cycle(axes, params, mb):
    """With the cyclic GC off (as during a CUDA-graph capture), a forward
    and backward through pipeline_apply leaves no autograd graph behind:
    the count of live tensors that carry a grad_fn afterwards."""
    import gc

    from mmlspark_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh(axes)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    gc.collect()
    gc.disable()
    try:
        pipeline_apply(_linear_stage, p, torch.from_numpy(mb), mesh
                       ).sum().backward()
        return sum(1 for o in gc.get_objects()
                   if torch.is_tensor(o) and o.grad_fn is not None)
    finally:
        gc.enable()


def _on_rank_errors(params, mb, axes):
    from mmlspark_tpu_torch.core.exceptions import FriendlyError
    from mmlspark_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh(axes)
    try:
        pipeline_apply(_linear_stage, {k: torch.from_numpy(v)
                                       for k, v in params.items()},
                       torch.from_numpy(mb), mesh)
    except FriendlyError as e:
        return str(e)
    return None


def _on_rank_lm(axes, config, flax_vars, ids, f32=True, nodes=(None,)):
    """The pipelined LM on the bridged flax variables: its output at each
    of ``nodes``, and the batch-1 rows (the stages one after another)."""
    from mmlspark_tpu_torch.models import build_model, load_flax_variables
    from mmlspark_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes)
    if mesh.get_coordinate() is None:
        return None
    graph = build_model("transformer_lm_pipelined", mesh=mesh, **config)
    if f32:
        _f32_port(graph)
    v = load_flax_variables(graph, flax_vars, device="cpu")
    x = torch.from_numpy(ids)
    out = {str(n): graph.apply(v, x, output_node=n).numpy() for n in nodes}
    out["rows"] = np.concatenate([graph.apply(v, x[i:i + 1]).numpy()
                                  for i in range(len(ids))])
    return out


def _on_rank_bad_node(config, axes):
    from mmlspark_tpu_torch.core.exceptions import FriendlyError
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes)
    if mesh.get_coordinate() is None:
        return None
    graph = build_model("transformer_lm_pipelined", mesh=mesh, **config)
    v = init_variables(graph, 0, device="cpu")
    try:
        graph.apply(v, torch.zeros((2, 4), dtype=torch.int32),
                    output_node="stage")
    except FriendlyError as e:
        return str(e)
    return None


def _on_rank_builder(axes, kw):
    from mmlspark_tpu_torch.core.exceptions import FriendlyError, ParamError
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes) if axes else None
    try:
        build_model("transformer_lm_pipelined", mesh=mesh, **kw)
    except (FriendlyError, ParamError) as e:
        return type(e).__name__, str(e)
    return None


def _on_rank_train(ids, labels):
    """The pipelined LM (f32) trained at data=2, pipe=2 under
    PIPELINE_STAGE_RULES; the curve, the output shape, the same weights
    trained as a plain transformer_lm on one device, and the stage counts
    of the stage leaves a rank stores and its step runs."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import (
        PIPELINE_STAGE_RULES,
        make_mesh,
        pipeline,
    )
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig
    from mmlspark_tpu_torch.train.distributed import MeshRun

    axes = {"data": 2, "pipe": 2}
    mesh = make_mesh(axes)
    config = dict(LM, depth=2)
    graph = _f32_port(build_model("transformer_lm_pipelined", mesh=mesh,
                                  **config))
    v0 = init_variables(graph, 0, device="cpu")
    cfg = dict(epochs=2, batch_size=8, learning_rate=1e-2, log_every=1,
               shuffle=False)
    trainer = SPMDTrainer(graph, TrainConfig(
        mesh_axes=axes, param_rules=PIPELINE_STAGE_RULES, **cfg),
        device="cpu")
    slices = []
    real = pipeline._StageSlice.apply
    pipeline._StageSlice.apply = lambda *a: slices.append(1) or real(*a)
    try:
        trained = trainer.train(ids, labels, init_variables=v0)
    finally:
        pipeline._StageSlice.apply = real
    out_shape = tuple(graph.apply(trained, torch.from_numpy(ids[:4])).shape)
    plain = _f32_port(build_model("transformer_lm", attn_impl="dense",
                                  depth=2, **LM))
    pv = {"embed": v0["embed"], "z": v0["z"]}
    for i in range(2):
        pv[f"block{i}"] = {k[len("layer0."):]: t[i]
                           for k, t in v0["stages"].items()}
    ref = SPMDTrainer(plain, TrainConfig(**cfg), device="cpu")
    ref.train(ids, labels, init_variables=pv)
    run = MeshRun(TrainConfig(mesh_axes=axes,
                              param_rules=PIPELINE_STAGE_RULES),
                  torch.device("cpu"))
    run.plan(graph, v0)
    local = {b: {k: run.shard(b, k, t) for k, t in blk.items()}
             for b, blk in v0.items()}
    step_view = run.gather(local, differentiable=False, stages=False)
    stages = {b: {t.shape[0] for t in view["stages"].values()}
              for b, view in (("stored", local), ("step", step_view))}
    stages["slices"] = len(slices)
    return ([h["loss"] for h in trainer.history],
            [h["loss"] for h in ref.history], out_shape, stages)


def _in_mesh(outs: list) -> list:
    """The results of the ranks in the case's mesh."""
    got = [o for o in outs if o is not None]
    assert got
    return got


# -- the JAX side -----------------------------------------------------------


def _jax_pipeline(axes, params, mb, grads=False):
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.parallel import make_mesh
    from mmlspark_tpu.parallel.pipeline import pipeline_apply

    mesh = make_mesh(axes)

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    p = {k: jnp.asarray(v) for k, v in params.items()}
    x = jnp.asarray(mb)
    run = jax.jit(lambda p, x: pipeline_apply(stage, p, x, mesh))
    out = {"out": np.asarray(run(p, x))}
    if grads:
        g = jax.jit(jax.grad(lambda p, x: run(p, x).sum(),
                             argnums=(0, 1)))(p, x)
        out["grads"] = [np.asarray(g[0]["w"]), np.asarray(g[0]["b"]),
                        np.asarray(g[1])]
    return out


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX pipelined LM on ``pipe=4`` with float32 stages, its flax
    variables (seeded) and its jitted logits on 8 rows of 8 tokens."""
    import jax
    import jax.numpy as jnp

    import mmlspark_tpu.models.pipelined as jp
    from mmlspark_tpu.models import build_model
    from mmlspark_tpu.parallel import make_mesh

    mp = pytest.MonkeyPatch()
    mp.setattr(jp, "Block", functools.partial(jp.Block, dtype=jnp.float32))
    try:
        mesh = make_mesh({"pipe": 4})
        graph = build_model("transformer_lm_pipelined", depth=4, mesh=mesh,
                            **LM)
        graph.embed = graph.embed.clone(dtype=jnp.float32) \
            if hasattr(graph.embed, "dtype") else graph.embed
        graph.head = graph.head.clone(dtype=jnp.float32)
        ids = np.random.default_rng(0).integers(0, 32, size=(8, 8)).astype(
            np.int32)
        variables = jax.device_get(jax.jit(graph.init)(
            jax.random.PRNGKey(0), jnp.asarray(ids[:1])))
        out = np.asarray(jax.jit(graph.apply)(variables, jnp.asarray(ids)))
    finally:
        mp.undo()
    return ids, variables, out


# -- the tests ----------------------------------------------------------------


def test_matches_sequential(ranks):
    params = _stacked_linear(0, 4, 8)
    mb = np.random.default_rng(1).normal(size=(8, 6, 8)).astype(np.float32)
    outs = ranks.run(_on_rank_pipeline, {"pipe": 4}, params, mb)
    want = _jax_pipeline({"pipe": 4}, params, mb)["out"]
    for out in outs:
        np.testing.assert_allclose(out["got"], out["want"], **F32)
        np.testing.assert_allclose(out["got"], want, **F32)


def test_matches_sequential_under_jit_dp(ranks):
    # dp x pp: the microbatches' batch dim split over data at the same
    # time (the JAX test's data=2, pipe=4 is data=2, pipe=2 on 4 ranks)
    axes = {"data": 2, "pipe": 2}
    params = _stacked_linear(2, 2, 8)
    mb = np.random.default_rng(3).normal(size=(4, 4, 8)).astype(np.float32)
    outs = ranks.run(_on_rank_pipeline, axes, params, mb)
    want = _jax_pipeline(axes, params, mb)["out"]
    for out in outs:
        np.testing.assert_allclose(out["got"], out["want"], **F32)
        np.testing.assert_allclose(out["got"], want, **F32)


@pytest.mark.parametrize("axes", [{"pipe": 2}, {"data": 2, "pipe": 2},
                                  {"pipe": 4}])
def test_gradients_match_sequential(ranks, axes):
    n = axes["pipe"]
    params = _stacked_linear(4, n, 6)
    mb = np.random.default_rng(5).normal(size=(n, 4, 6)).astype(np.float32)
    outs = ranks.run(_on_rank_pipeline, axes, params, mb, grads=True)
    jax_grads = _jax_pipeline(axes, params, mb, grads=True)["grads"]
    for out in _in_mesh(outs):
        for got, want, jax_g in zip(out["grads"], out["want_grads"],
                                    jax_grads):
            np.testing.assert_allclose(got, want, **GRAD)
            np.testing.assert_allclose(got, jax_g, **GRAD)


def test_pipeline_leaves_no_graph_behind(ranks):
    """No reference cycle holds a step's graph: a captured step that
    found the last eager step's gradient accumulators alive would
    depend on the default stream and fail its capture on the card."""
    params = _stacked_linear(6, 4, 4)
    mb = np.ones((4, 2, 4), np.float32)
    assert ranks.run(_on_rank_no_cycle, {"pipe": 4}, params, mb) == \
        [0] * WORLD


def test_shape_validation(ranks):
    from mmlspark_tpu.core.exceptions import FriendlyError as JaxError
    from mmlspark_tpu.parallel import make_mesh as jax_mesh
    from mmlspark_tpu.parallel.pipeline import (
        pipeline_apply as jax_pipeline_apply,
    )

    good = _stacked_linear(0, 4, 4)
    cases = [(_stacked_linear(0, 3, 4), np.zeros((4, 2, 4), np.float32),
              {"pipe": 4}),  # wrong stage count
             (good, np.zeros((3, 2, 4), np.float32), {"pipe": 4}),
             (good, np.zeros((4, 2, 4), np.float32), {"data": 4})]
    for params, mb, axes in cases:
        with pytest.raises(JaxError) as e:
            jax_pipeline_apply(lambda p, x: x, params, mb, jax_mesh(axes))
        # the same FriendlyError, word for word
        assert ranks.run(_on_rank_errors, params, mb, axes) == \
            [str(e.value)] * WORLD


def test_pipelined_lm_forward_matches_stage_loop(ranks, jax_lm):
    ids, variables, want = jax_lm
    outs = ranks.run(_on_rank_lm, {"pipe": 4}, dict(LM, depth=4),
                     variables, ids)
    for out in outs:
        assert out["None"].shape == (8, 8, 32)
        # the pipeline against the stages one after another (batch 1)
        np.testing.assert_allclose(out["None"], out["rows"], **F32)
        np.testing.assert_allclose(out["None"], want, **F32)


def test_pipelined_lm_output_node(ranks):
    config = dict(vocab_size=16, d_model=8, heads=2, depth=2, max_len=4)
    ids = np.zeros((2, 4), np.int32)
    flax_like = _seeded_flax(config)
    outs = ranks.run(_on_rank_lm, {"pipe": 2}, config, flax_like, ids,
                     False, (None, "stages", "embed"))
    for out in _in_mesh(outs):
        assert out["stages"].shape == (2, 4, 8)  # d_model features
        assert out["embed"].shape == (2, 4, 8)
        assert out["None"].shape == (2, 4, 16)
    errs = _in_mesh(ranks.run(_on_rank_bad_node, config, {"pipe": 2}))
    assert all("no node 'stage'" in e for e in errs)
    from mmlspark_tpu_torch.models import registered_models

    assert "transformer_lm_pipelined" in registered_models()


def _seeded_flax(config):
    """Flax variables of the JAX pipelined LM's shapes (``eval_shape`` of
    its init on a pipe=2 mesh) with seeded values."""
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model
    from mmlspark_tpu.parallel import make_mesh

    graph = build_model("transformer_lm_pipelined",
                        mesh=make_mesh({"pipe": 2}), **config)
    shapes = jax.eval_shape(graph.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, config["max_len"]), jnp.int32))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.2).astype(np.float32),
        shapes)


def test_pipelined_builder_validation(ranks):
    from mmlspark_tpu.core.exceptions import FriendlyError as JaxFriendly
    from mmlspark_tpu.core.exceptions import ParamError as JaxParam
    from mmlspark_tpu.models import build_model
    from mmlspark_tpu.parallel import make_mesh

    base = dict(vocab_size=16, d_model=8, heads=2, depth=2, max_len=4)
    for axes, kw in (({"pipe": 2}, dict(base, n_microbatches=3)),
                     ({"pipe": 2}, dict(base, depth=3)),
                     ({"pipe": 2}, dict(base, n_stages=4)),
                     (None, base)):
        with pytest.raises((JaxFriendly, JaxParam)) as e:
            build_model("transformer_lm_pipelined",
                        mesh=make_mesh(axes) if axes else None, **kw)
        got = ranks.run(_on_rank_builder, axes, kw)
        assert got == [(type(e.value).__name__, str(e.value))] * WORLD


def test_trainer_pipelined_lm(ranks):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 32, size=(16, 8)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    for losses, plain, shape, stages in ranks.run(_on_rank_train, ids,
                                                  labels):
        # a rank stores and runs its own stage alone
        assert stages == {"stored": {1}, "step": {1}, "slices": 0}
        assert len(losses) == 4 and all(np.isfinite(losses))
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, plain, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        assert shape == (4, 8, 32)
