"""The trainer's tensor and expert parallelism split the compute
(``mmlspark_tpu_torch/train/distributed.py``): under
``TRANSFORMER_TP_RULES`` each rank runs its Megatron-split copy of the LM
(``models/transformer.split_graph``) bound to its own shards, with the
vocab-parallel cross entropy; under ``EXPERT_RULES`` each ``expert``
rank runs only its experts (``models/moe.expert_local_graph``).

The port's side runs on one gloo group of 4 CPU ranks
(``testing/rank_pool.RankPool``), started once for the file; the JAX
side on the conftest's CPU mesh at the same mesh shape, from the same
flax variables through the weight bridge. Everything computes in
float32: loss and grad-norm curves within ``LOSS_TOL`` = 1e-5,
parameters within ``PARAM_TOL`` = 1e-4 (the tolerances of
``tests/test_torch_trainer_mesh.py``; the key bias of each ``qkv`` has
no true gradient, so adam turns both sides' rounding noise into steps of
lr: it is held to 2 lr a step, as there).
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
MQA = dict(TINY, kv_heads=1)
#: the JAX MoE test's LM (``test_torch_trainer_mesh.py``'s)
MOE = dict(vocab_size=32, d_model=16, heads=2, depth=1, n_experts=4,
           max_len=8, attn_impl="dense")
MOE_CFG = dict(epochs=2, batch_size=8, learning_rate=1e-2, log_every=1,
               shuffle=False)
LR = 1e-3
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
#: the step's collective calls that may move data between ranks
COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "all_to_all_single",
               "batch_isend_irecv", "all_gather_into_tensor",
               "reduce_scatter_tensor")


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


def _moe_data():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, MOE["vocab_size"], size=(16, 8)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _f32_port(graph):
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


def _numpy(tree):
    return {b: {k: t.numpy() for k, t in blk.items()}
            for b, blk in tree.items()}


# -- the probe: what the step binds, communicates and differentiates ------


def _probe():
    """Patch this rank's process to record, for every training step (from
    the step's binding of its variables to its gradient norm), the
    collectives it calls; the shapes of the variables the first
    train-mode forward is bound to; and the shapes of the gradients the
    step sums over ``data``. Returns (the record, an undo)."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.models.graph import NamedGraph
    from mmlspark_tpu_torch.train.distributed import MeshRun

    rec = {"steps": [], "bound": None, "grads": None}
    window: list = [None]
    saved = {n: getattr(dist, n) for n in COLLECTIVES}

    def wrap(name):
        fn = saved[name]

        def counted(*args, **kw):
            if window[0] is not None:
                window[0].append(name)
            return fn(*args, **kw)
        return counted

    gather, norm = MeshRun.gather, MeshRun.grad_norm
    reduce, apply = MeshRun.reduce_grads, NamedGraph.apply

    def gather_(self, local, differentiable=True, stages=True):
        if not stages:  # the step's binding opens its window
            window[0] = []
        return gather(self, local, differentiable, stages)

    def norm_(self, keys, grads):
        out = norm(self, keys, grads)
        rec["steps"].append(window[0])
        window[0] = None
        return out

    def reduce_(self, grads, extra):
        rec["grads"] = [tuple(g.shape) for g in grads]
        return reduce(self, grads, extra)

    def apply_(self, variables, x, *args, train=False, **kw):
        if train and rec["bound"] is None:
            rec["bound"] = {b: {k: tuple(t.shape) for k, t in blk.items()}
                            for b, blk in variables.items()}
        return apply(self, variables, x, *args, train=train, **kw)

    for n in COLLECTIVES:
        setattr(dist, n, wrap(n))
    MeshRun.gather, MeshRun.grad_norm = gather_, norm_
    MeshRun.reduce_grads, NamedGraph.apply = reduce_, apply_

    def undo():
        for n in COLLECTIVES:
            setattr(dist, n, saved[n])
        MeshRun.gather, MeshRun.grad_norm = gather, norm
        MeshRun.reduce_grads, NamedGraph.apply = reduce, apply

    return rec, undo


# -- bodies run on every rank ---------------------------------------------


def _on_rank_lm(axes, flax_vars, config, probe=False):
    """The f32 LM of ``config`` trained over ``axes`` (None: one device)
    under ``TRANSFORMER_TP_RULES`` from the bridged flax variables: (loss
    curve, grad-norm curve, final variables, the probe's record)."""
    from mmlspark_tpu_torch.models import build_model, load_flax_variables
    from mmlspark_tpu_torch.parallel import TRANSFORMER_TP_RULES
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    x, y = _lm_data()
    graph = _f32_port(build_model("transformer_lm", **config))
    rules = TRANSFORMER_TP_RULES if axes is not None else None
    trainer = SPMDTrainer(graph, TrainConfig(
        epochs=2, batch_size=4, learning_rate=LR, log_every=1,
        mesh_axes=axes, param_rules=rules), device="cpu")
    rec, undo = _probe() if probe else (None, None)
    try:
        out = trainer.train(x, y, init_variables=load_flax_variables(
            graph, flax_vars, device="cpu"))
    finally:
        if undo is not None:
            undo()
    if out is None:
        return None
    return ([h["loss"] for h in trainer.history],
            [h["grad_norm"] for h in trainer.history], _numpy(out), rec)


def _on_rank_moe(axes, flax_vars, group_size):
    """The f32 switch-MoE LM trained over ``axes`` under EXPERT_RULES,
    routing in groups of ``group_size``, probed: (loss curve, grad-norm
    curve, final variables, the probe's record)."""
    from mmlspark_tpu_torch.models import build_model, load_flax_variables
    from mmlspark_tpu_torch.parallel import EXPERT_RULES
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    ids, labels = _moe_data()
    graph = _f32_port(build_model("transformer_lm_moe", **MOE))
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "group_size"):
                m.group_size = group_size
    trainer = SPMDTrainer(graph, TrainConfig(
        **MOE_CFG, mesh_axes=axes, param_rules=EXPERT_RULES), device="cpu")
    rec, undo = _probe()
    try:
        out = trainer.train(ids, labels, init_variables=load_flax_variables(
            graph, flax_vars, device="cpu"))
    finally:
        undo()
    if out is None:
        return None
    return ([h["loss"] for h in trainer.history if "loss" in h],
            [h["grad_norm"] for h in trainer.history if "loss" in h],
            _numpy(out), rec)


def _on_rank_xent(model: int, logits, labels, mask):
    """The vocab-parallel cross entropy's masked mean over a
    ``{"data": 4 / model, "model": model}`` mesh: the loss and the
    rank's slice of the logits' gradient, with the rank's model index."""
    from mmlspark_tpu_torch.parallel import make_mesh
    from mmlspark_tpu_torch.parallel.mesh import MeshAxis
    from mmlspark_tpu_torch.train.distributed import (
        vocab_parallel_loss_terms,
    )

    mesh = make_mesh({"data": WORLD // model, "model": model})
    axis = MeshAxis(mesh, "model")
    local = torch.from_numpy(logits).chunk(model, dim=-1)[axis.index]
    local = local.clone().requires_grad_(True)
    total, w = vocab_parallel_loss_terms(local, torch.from_numpy(labels),
                                         torch.from_numpy(mask), axis)
    loss = total / torch.clamp(w.sum(), min=1.0)
    loss.backward()
    return loss.item(), local.grad.numpy(), axis.index


def _on_rank_ulysses(axes, heads):
    """The f32 LM with ``heads`` heads and Ulysses attention over the
    ``seq`` of ``axes`` inside the model split, and the same run on one
    device with dense attention: both loss curves, or the split's
    ParamError."""
    from mmlspark_tpu_torch.core.exceptions import ParamError
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import TRANSFORMER_TP_RULES, make_mesh
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    x, y = _lm_data()
    config = dict(TINY, heads=heads, kv_heads=None)
    graph = _f32_port(build_model("transformer_lm", mesh=make_mesh(axes),
                                  **dict(config, attn_impl="ulysses")))
    v0 = init_variables(graph, 0, device="cpu")
    cfg = dict(epochs=1, batch_size=4, learning_rate=LR, log_every=1)
    trainer = SPMDTrainer(graph, TrainConfig(
        mesh_axes=axes, param_rules=TRANSFORMER_TP_RULES, **cfg),
        device="cpu")
    try:
        trainer.train(x, y, init_variables=v0)
    except ParamError as e:
        return str(e)
    dense = SPMDTrainer(_f32_port(build_model("transformer_lm", **config)),
                        TrainConfig(**cfg), device="cpu")
    dense.train(x, y, init_variables=v0)
    return ([h["loss"] for h in trainer.history],
            [h["loss"] for h in dense.history])


def _on_rank_checkpoints(ckdir, flax_vars):
    """A ``{"data": 2, "model": 2}`` run of one epoch that checkpoints at
    its end beside a one-device run's; resumes of the mesh run's
    checkpoint for a second epoch at ``{"data": 1, "model": 4}`` and on
    one device; and the uninterrupted two-epoch one-device run. Rank 0
    returns both payloads; every rank its resumes' curves and
    variables."""
    import os
    import shutil

    import torch.distributed as dist

    from mmlspark_tpu_torch.models import build_model, load_flax_variables
    from mmlspark_tpu_torch.parallel import TRANSFORMER_TP_RULES
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    x, y = _lm_data()
    rank = dist.get_rank()
    graph = _f32_port(build_model("transformer_lm", **TINY))

    def run(axes, epochs, directory=None):
        trainer = SPMDTrainer(graph, TrainConfig(
            epochs=epochs, batch_size=4, learning_rate=LR, log_every=1,
            mesh_axes=axes, checkpoint_dir=directory,
            param_rules=TRANSFORMER_TP_RULES if axes else None),
            device="cpu")
        out = trainer.train(x, y, init_variables=load_flax_variables(
            graph, flax_vars, device="cpu"))
        return trainer, out

    mesh_dir = os.path.join(ckdir, "mesh")
    run({"data": 2, "model": 2}, 1, mesh_dir)
    one_dir = os.path.join(ckdir, f"one{rank}")
    run(None, 1, one_dir)
    wide_dir = os.path.join(ckdir, "model4")
    if rank == 0:
        shutil.copytree(mesh_dir, wide_dir)
    own_dir = os.path.join(ckdir, f"own{rank}")
    shutil.copytree(mesh_dir, own_dir)
    dist.barrier()
    wide, wide_out = run({"data": 1, "model": 4}, 2, wide_dir)
    own, own_out = run(None, 2, own_dir)
    full, full_out = run(None, 2)

    def payload(directory):
        root = os.path.join(directory, "payload-2")
        out = {}
        for base, _, files in os.walk(root):
            for f in files:
                path = os.path.join(base, f)
                out[os.path.relpath(path, root)] = np.load(path)
        return out

    def curve(t):
        return [(h["step"], h["loss"]) for h in t.history]

    return {
        "payloads": (payload(mesh_dir), payload(one_dir)) if rank == 0
        else None,
        "full": (curve(full), _numpy(full_out)),
        "resumed": [(curve(t), _numpy(v)) for t, v in
                    ((wide, wide_out), (own, own_out))],
    }


# -- the JAX side -----------------------------------------------------------


def _jax_f32(graph):
    import jax.numpy as jnp

    graph.blocks = [
        (n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype") else m)
        for n, m in graph.blocks
    ]
    return graph


@pytest.fixture(scope="module")
def jax_lm():
    """name -> (the JAX f32 LM, its flax variables as host copies) for
    the TINY and the MQA configs, made on first use."""
    made: dict = {}

    def get(name):
        if name not in made:
            import jax
            import jax.numpy as jnp

            from mmlspark_tpu.models import build_model

            config = {"tiny": TINY, "mqa": MQA}[name]
            graph = _jax_f32(build_model("transformer_lm", **config))
            x, _ = _lm_data()
            made[name] = graph, jax.device_get(jax.jit(graph.init)(
                jax.random.PRNGKey(0), jnp.asarray(x[:1])))
        return made[name]

    return get


def _jax_train(setup, axes, rules):
    import jax

    from mmlspark_tpu.train.trainer import SPMDTrainer, TrainConfig

    graph, jv = setup
    x, y = _lm_data()
    trainer = SPMDTrainer(graph, TrainConfig(
        epochs=2, batch_size=4, learning_rate=LR, log_every=1,
        mesh_axes=axes, param_rules=rules))
    # the JAX trainer donates its inputs: hand it host copies
    out = trainer.train(x, y, init_variables=jax.tree.map(np.array, jv))
    return ([h["loss"] for h in trainer.history],
            [h["grad_norm"] for h in trainer.history], jax.device_get(out))


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


def _jax_moe_train(flax_vars, axes, group_size):
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
    return ([h["loss"] for h in trainer.history if "loss" in h],
            [h["grad_norm"] for h in trainer.history if "loss" in h],
            jax.device_get(out))


def _port_params(name: str, config: dict, flax_out) -> dict:
    from mmlspark_tpu_torch.models import build_model, load_flax_variables

    port = _f32_port(build_model(name, **config))
    return _numpy(load_flax_variables(port, flax_out, device="cpu"))


def _assert_params(want: dict, got: dict, steps: int, config: dict,
                   lr: float = LR):
    heads = config["heads"]
    d, hk = config["d_model"] // heads, config.get("kv_heads") or heads
    k_bias = slice(heads * d, (heads + hk) * d)
    for block, leaves in want.items():
        for name, w in leaves.items():
            w, g = np.array(w), np.array(got[block][name])
            if name == "attn.qkv.bias":
                # the key bias: no gradient, noise only (module docstring)
                assert np.abs(g[k_bias] - w[k_bias]).max() <= 2 * lr * steps
                w[k_bias] = g[k_bias] = 0.0
            err = np.abs(w - g).max()
            assert err <= PARAM_TOL, (block, name, err)


def _assert_curves(got, want):
    (losses, gnorms), (w_losses, w_gnorms) = got, want
    np.testing.assert_allclose(losses, w_losses, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(gnorms, w_gnorms, atol=LOSS_TOL,
                               rtol=LOSS_TOL)


@pytest.fixture(scope="module")
def tp_runs(ranks, jax_lm):
    """(mesh axes as a key) -> (the port's per-rank results in the mesh,
    the JAX trainer's curves and final variables) for the TINY LM under
    TRANSFORMER_TP_RULES, made on first use."""
    from mmlspark_tpu.parallel import TRANSFORMER_TP_RULES

    made: dict = {}

    def get(axes):
        key = tuple(axes.items())
        if key not in made:
            setup = jax_lm("tiny")
            pending = ranks.submit(_on_rank_lm, axes, setup[1], TINY, True)
            jax_out = _jax_train(setup, axes, TRANSFORMER_TP_RULES)
            made[key] = ([r for r in pending.result() if r is not None],
                         jax_out)
        return made[key]

    return get


#: the JAX trainer shards its batch over a ``data`` axis, so the
#: four-way split keeps a one-rank one
TP_MESHES = [{"data": 2, "model": 2}, {"data": 1, "model": 4}]
TP_IDS = ["data2-model2", "data1-model4"]


def _local_shapes(config: dict, model: int) -> dict:
    """The shapes of the split leaves a model rank stores and binds."""
    v, dm = config["vocab_size"], config["d_model"]
    h = config["heads"]
    hk = config.get("kv_heads") or h
    d, ff = dm // h, 4 * dm
    lkh = hk // model if hk % model == 0 else 1
    rows = (h // model + 2 * lkh) * d
    block = {"attn.qkv.weight": (rows, dm), "attn.qkv.bias": (rows,),
             "attn.attn_out.weight": (dm, h // model * d),
             "mlp_in.weight": (ff // model, dm),
             "mlp_in.bias": (ff // model,),
             "mlp_out.weight": (dm, ff // model)}
    out = {"embed": {"token.weight": (v // model, dm)},
           "z": {"head.weight": (v // model, dm),
                 "head.bias": (v // model,)}}
    for i in range(config["depth"]):
        out[f"block{i}"] = block
    return out


# -- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("axes", TP_MESHES, ids=TP_IDS)
def test_split_lm_matches_jax(tp_runs, axes):
    """The split step under TRANSFORMER_TP_RULES against the JAX trainer
    (GSPMD's split) on the same mesh shape and flax variables: loss and
    grad-norm curves, and the final parameters every rank returns whole
    (the data=2 x model=2 mesh holds the kv heads split over model; the
    data=1 x model=4 one has each kv head shared by two ranks)."""
    results, (w_losses, w_gnorms, jout) = tp_runs(axes)
    assert len(results) == WORLD
    want = _port_params("transformer_lm", TINY, jout)
    for losses, gnorms, params, _ in results:
        _assert_curves((losses, gnorms), (w_losses, w_gnorms))
        _assert_params(want, params, len(losses), TINY)
    for _, _, params, _ in results[1:]:
        for b in params:
            for k in params[b]:
                np.testing.assert_array_equal(params[b][k],
                                              results[0][2][b][k])


@pytest.mark.parametrize("axes", TP_MESHES, ids=TP_IDS)
def test_split_is_real(tp_runs, axes):
    """On every rank the step binds the local shards of qkv, attn_out,
    mlp_in, mlp_out, token and head (head-aligned qkv rows), gathers none
    of them (no all-gather at all: each step's collectives are the
    embedding's and each row-parallel product's sums, the loss's max and
    sums, each column-parallel input's gradient sum, the shared kv rows'
    sum, the norm's sum over model and the two sums over data), and its
    gradients have its shards' shapes."""
    results, _ = tp_runs(axes)
    model = axes["model"]
    want = _local_shapes(TINY, model)
    depth = TINY["depth"]
    shared = model > TINY["kv_heads"]
    per_step = (1 + 2 * depth) + 2 + (2 * depth + 1) + 1 + int(shared) + 2
    for losses, _, _, rec in results:
        bound = rec["bound"]
        for b, leaves in want.items():
            for k, shape in leaves.items():
                assert bound[b][k] == shape, (b, k, bound[b][k], shape)
        order = [bound[b][k] for b in bound for k in bound[b]]
        assert rec["grads"] == order
        assert len(rec["steps"]) == len(losses)
        for calls in rec["steps"]:
            assert "all_gather" not in calls
            assert calls.count("all_reduce") == len(calls) == per_step


def test_shared_kv_head_matches_one_device_and_jax(ranks, jax_lm):
    """MQA (kv_heads=1) on data=2 x model=2: each model rank stores the
    one kv head's rows, their gradient is summed over both, and the norm
    counts them once — against the port's one-device run and the JAX
    trainer on the same mesh shape: curves, and parameters equal on
    every rank."""
    from mmlspark_tpu.parallel import TRANSFORMER_TP_RULES

    axes = {"data": 2, "model": 2}
    setup = jax_lm("mqa")
    pending = ranks.submit(_on_rank_lm, axes, setup[1], MQA, True)
    single = ranks.submit(_on_rank_lm, None, setup[1], MQA)
    w_losses, w_gnorms, jout = _jax_train(setup, axes, TRANSFORMER_TP_RULES)
    results = [r for r in pending.result() if r is not None]
    one = single.result()[0]
    want = _port_params("transformer_lm", MQA, jout)
    assert len(results) == WORLD
    for losses, gnorms, params, rec in results:
        _assert_curves((losses, gnorms), (w_losses, w_gnorms))
        _assert_curves((losses, gnorms), one[:2])
        _assert_params(want, params, len(losses), MQA)
        _assert_params(one[2], params, len(losses), MQA)
        assert rec["bound"]["block0"]["attn.qkv.weight"] == (16, 16)
    for _, _, params, _ in results[1:]:
        for b in params:
            for k in params[b]:
                np.testing.assert_array_equal(params[b][k],
                                              results[0][2][b][k])


@pytest.mark.parametrize("model", [2, 4])
def test_vocab_parallel_xent_matches_gathered(ranks, model):
    """The vocab-parallel cross entropy over model=2 and model=4 slices
    of (3, 5, 32) logits, a padded row masked out, against
    ``F.cross_entropy`` on the whole logits (the trainer's
    ``masked_loss_terms``): the masked mean and each rank's slice of the
    gradient."""
    from mmlspark_tpu_torch.train.trainer import masked_loss_terms

    rng = np.random.default_rng(5)
    logits = (3.0 * rng.standard_normal((3, 5, 32))).astype(np.float32)
    labels = rng.integers(0, 32, size=(3, 5)).astype(np.int64)
    mask = np.array([1, 1, 0], dtype=np.int32)
    whole = torch.from_numpy(logits).requires_grad_(True)
    total, w = masked_loss_terms("softmax_xent", whole,
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    want = total / torch.clamp(w.sum(), min=1.0)
    want.backward()
    grads = whole.grad.numpy()
    assert not grads[2].any()  # the padded row
    for loss, grad, index in ranks.run(_on_rank_xent, model, logits, labels,
                                       mask):
        np.testing.assert_allclose(loss, want.item(), rtol=1e-6)
        np.testing.assert_allclose(
            grad, np.split(grads, model, axis=-1)[index], atol=1e-7,
            rtol=1e-5)


@pytest.mark.parametrize("group_size", [8, 1024],
                         ids=["groups-within-ranks", "groups-across-ranks"])
def test_expert_local_ffn_matches_jax(ranks, jax_moe_vars, group_size):
    """The MoE LM on data=2 x expert=2 under EXPERT_RULES against the JAX
    trainer, routing in groups within each data rank's block and across
    both: curves and parameters. Each rank binds two of the four experts
    and its step gathers nothing (its collectives: the row counts, the
    combine's sum over expert and the tokens' and gate's gradient sums
    in each MoE block, the gradients over data, the norm over expert)."""
    axes = {"data": 2, "expert": 2}
    pending = ranks.submit(_on_rank_moe, axes, jax_moe_vars, group_size)
    w_losses, w_gnorms, jout = _jax_moe_train(jax_moe_vars, axes, group_size)
    results = [r for r in pending.result() if r is not None]
    assert len(results) == WORLD
    want = _port_params("transformer_lm_moe", MOE, jout)
    for losses, gnorms, params, rec in results:
        assert len(losses) == 4 and losses[-1] < losses[0]
        _assert_curves((losses, gnorms), (w_losses, w_gnorms))
        _assert_params(want, params, len(losses), MOE,
                       MOE_CFG["learning_rate"])
        assert params["block0"]["moe.experts.w_in"].shape == (4, 16, 64)
        bound = rec["bound"]["block0"]
        assert bound["moe.experts.w_in"] == (2, 16, 64)
        assert bound["moe.experts.w_out"] == (2, 64, 16)
        assert bound["moe.gate"] == (16, 4)
        for calls in rec["steps"]:
            # groups across the data ranks gather the tokens and the mask
            # (no weight): two all-gathers in the one MoE block
            assert calls.count("all_gather") == (
                2 if group_size == 1024 else 0)


def test_checkpoints_cross_model_widths(ranks, jax_lm, tmp_path):
    """A data=2 x model=2 run's checkpoint holds whole tensors equal to a
    one-device run's payload (parameters within PARAM_TOL, moments
    within float32 noise); it resumes at data=1 x model=4 and on one
    device, and both resumes continue the uninterrupted one-device
    run's curve and end at its parameters."""
    res = ranks.run(_on_rank_checkpoints, str(tmp_path), jax_lm("tiny")[1])
    mesh, one = res[0]["payloads"]
    assert sorted(mesh) == sorted(one)
    d = TINY["d_model"] // TINY["heads"]
    k_bias = slice(TINY["heads"] * d, (TINY["heads"] + TINY["kv_heads"]) * d)
    for path, want in one.items():
        got = mesh[path]
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if path.startswith("params"):
            if path.endswith("attn.qkv.bias.npy"):
                got, want = got.copy(), want.copy()
                assert np.abs(got[k_bias] - want[k_bias]).max() <= 6 * LR
                got[k_bias] = want[k_bias] = 0.0
            np.testing.assert_allclose(got, want, atol=PARAM_TOL, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=path)
    for r in res:
        full_curve, full_params = r["full"]
        for curve, params in r["resumed"]:
            assert [s for s, _ in curve] == [3, 4, 5]
            np.testing.assert_allclose([l for _, l in curve],
                                       [l for _, l in full_curve[3:]],
                                       atol=LOSS_TOL, rtol=LOSS_TOL)
            _assert_params(full_params, params, 6, TINY)


def test_ulysses_inside_the_split(ranks):
    """Ulysses over seq=2 on each model rank's heads (seq=2 x model=2):
    with 4 heads each rank's 2 heads re-shard over seq, and the curve is
    the one-device dense run's; with 2 heads a rank keeps 1, which seq
    cannot divide: a ParamError naming the three sizes on every rank,
    before any step."""
    axes = {"seq": 2, "model": 2}
    for losses, plain in ranks.run(_on_rank_ulysses, axes, 4):
        assert len(losses) == 3
        np.testing.assert_allclose(losses, plain, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    errs = ranks.run(_on_rank_ulysses, axes, 2)
    assert all(isinstance(e, str) and "ulysses over 'seq' (2)" in e
               and "2 heads" in e and "model (2)" in e for e in errs), errs


def _on_rank_composed(axes):
    """The f32 MoE LM under TRANSFORMER_TP_RULES and EXPERT_RULES
    together over ``axes``, and on one device: both curves, the bound
    shapes of the first block's split and expert leaves, and the final
    variables."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import EXPERT_RULES, TRANSFORMER_TP_RULES
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    ids, labels = _moe_data()
    graph = _f32_port(build_model("transformer_lm_moe", **MOE))
    v0 = init_variables(graph, 0, device="cpu")
    runs = []
    for cfg in (dict(mesh_axes=axes,
                     param_rules=TRANSFORMER_TP_RULES + EXPERT_RULES), {}):
        trainer = SPMDTrainer(graph, TrainConfig(**MOE_CFG, **cfg),
                              device="cpu")
        rec, undo = _probe()
        try:
            out = trainer.train(ids, labels, init_variables=v0)
        finally:
            undo()
        runs.append(([h["loss"] for h in trainer.history if "loss" in h],
                     _numpy(out), rec["bound"]))
    return runs


def test_split_and_expert_local_compose(ranks):
    """Both rule sets on model=2 x expert=2: the MoE LM's attention,
    embedding and head split over model and its experts over expert in
    one step, against the one-device run."""
    for (losses, params, bound), (s_losses, s_params, _) in ranks.run(
            _on_rank_composed, {"model": 2, "expert": 2}):
        np.testing.assert_allclose(losses, s_losses, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        _assert_params(s_params, params, len(losses), MOE,
                       MOE_CFG["learning_rate"])
        block = bound["block0"]
        assert block["attn.qkv.weight"] == (24, 16)
        assert block["moe.experts.w_in"] == (2, 16, 64)
        assert bound["embed"]["token.weight"] == (16, 16)
