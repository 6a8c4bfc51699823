"""The trainer's step as one program, on the CPU: ``steps_per_dispatch``
K steps against one step a dispatch (mirroring the JAX package's
``tests/test_trainer.py::test_steps_per_dispatch_exactness``), the same
K=4 run against the JAX trainer, and the fused optimizer's wrapper
(``ops/fused_optim.py``) on CPU tensors against the trainer's eager
update and quarantine as they stood before the wrapper.

Model: ``transformer_lm(vocab 32, d_model 16, heads 4, kv_heads 2, depth
2, max_len 16)`` computing in float32 on both sides, dense attention (the
point is the dispatch, not the kernel). Data: 40 rows of 16 tokens, batch
4, so an epoch is 10 steps and K=4 leaves a 2-step tail group.
Tolerances: K=1 against K=4 at the JAX test's rtol 1e-5, atol 1e-6; the
port against JAX as ``tests/test_torch_train.py`` holds them (losses
1e-5, parameters 1e-4 except the key bias of each ``qkv``, whose true
gradient is zero and which adam moves by noise, held to its bound).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.train.trainer import SPMDTrainer as JaxTrainer
from mmlspark_tpu.train.trainer import TrainConfig as JaxConfig
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.ops import fused_optim
from mmlspark_tpu_torch.ops.fused_optim import (
    moment_names,
    optimizer_update,
)
from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

TINY = dict(vocab_size=32, d_model=16, heads=4, kv_heads=2, depth=2,
            max_len=16, attn_impl="dense")
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.integers(0, TINY["vocab_size"], size=(40, 16)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    jg = jax_build_model("transformer_lm", **TINY)
    jg.blocks = [
        (n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype") else m)
        for n, m in jg.blocks
    ]
    jv = jax.device_get(jax.jit(jg.init)(jax.random.PRNGKey(0),
                                         jnp.asarray(x[:1])))
    tg = build_model("transformer_lm", **TINY)
    for _, mod in tg.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return x, y, jg, jv, tg


def _cfg(k, **kw):
    return dict(epochs=2, batch_size=4, learning_rate=LR,
                steps_per_dispatch=k, seed=3, log_every=1, **kw)


def _port(setup, k):
    x, y, _, jv, tg = setup
    trainer = SPMDTrainer(tg, TrainConfig(**_cfg(k)), device="cpu")
    out = trainer.train(x, y, init_variables=load_flax_variables(
        tg, jv, device="cpu"))
    return trainer, out


def test_steps_per_dispatch_exactness(setup):
    """K steps a dispatch is an execution strategy, not a semantic
    change: the final parameters equal the one-step path's, including an
    epoch tail that does not fill a group (10 steps, K=4). The log
    cadence coarsens to the group, with the group's last loss; one step
    program is made either way."""
    t1, v1 = _port(setup, 1)
    t4, v4 = _port(setup, 4)
    for block, leaves in v1.items():
        for name, a in leaves.items():
            np.testing.assert_allclose(a.numpy(), v4[block][name].numpy(),
                                       rtol=1e-5, atol=1e-6)
    assert [h["step"] for h in t4.history] == [3, 7, 9, 13, 17, 19]
    loss1 = {h["step"]: h["loss"] for h in t1.history}
    for h in t4.history:
        assert abs(h["loss"] - loss1[h["step"]]) <= 1e-6
    for t in (t1, t4):
        assert t.telemetry.counter("retrace.train.step").value == 1


def test_steps_per_dispatch_matches_jax(setup):
    """The K=4 run against the JAX trainer's K=4 run (one lax.scan of 4
    steps a dispatch): the same logged steps and losses, and the same
    final parameters."""
    x, y, jg, jv, tg = setup
    jt = JaxTrainer(jg, JaxConfig(mesh_axes={"data": 1}, **_cfg(4)))
    jout = jt.train(x, y, init_variables=jax.tree.map(np.array, jv))
    pt, pout = _port(setup, 4)
    assert [h["step"] for h in pt.history] == \
        [h["step"] for h in jt.history]
    np.testing.assert_allclose([h["loss"] for h in pt.history],
                               [h["loss"] for h in jt.history],
                               atol=1e-5, rtol=0)
    want = load_flax_variables(tg, jout, device="cpu")
    d, hk = TINY["d_model"] // TINY["heads"], TINY["kv_heads"]
    k_bias = slice(TINY["heads"] * d, (TINY["heads"] + hk) * d)
    steps = len(x) // 4 * 2
    for block, leaves in want.items():
        for name, w in leaves.items():
            g = pout[block][name]
            if name == "attn.qkv.bias":
                # the key bias: no gradient, noise only
                assert (g[k_bias] - w[k_bias]).abs().max() <= 2 * LR * steps
                w, g = w.clone(), g.clone()
                w[k_bias] = g[k_bias] = 0.0
            assert (w - g).abs().max().item() <= 1e-4, (block, name)


# -- the fused optimizer's wrapper on the CPU -----------------------------------


def _eager_update(kind, params, grads, state, lr_value, bad, wd, mom):
    """The trainer's update and quarantine as they were before the fused
    pass: new parameters and state from optax's formulas, then
    ``p.copy_(torch.where(bad, p, q))`` and the state's select."""
    count = state["count"]
    step_size = -torch.full((), lr_value)
    new = {"count": count + 1}
    if kind in ("adam", "adamw"):
        b1, b2, eps = 0.9, 0.999, 1e-8
        new["mu"] = [(1 - b1) * g + b1 * m
                     for g, m in zip(grads, state["mu"])]
        new["nu"] = [(1 - b2) * g * g + b2 * n
                     for g, n in zip(grads, state["nu"])]
        c1 = 1 - torch.pow(b1, new["count"])
        c2 = 1 - torch.pow(b2, new["count"])
        updates = [(m / c1) / (torch.sqrt(n / c2) + eps)
                   for m, n in zip(new["mu"], new["nu"])]
        if kind == "adamw":
            updates = [u + wd * p for u, p in zip(updates, params)]
    elif kind == "momentum":
        new["trace"] = [g + mom * t for g, t in zip(grads, state["trace"])]
        updates = new["trace"]
    else:
        updates = grads
    new_params = [p + step_size * u for p, u in zip(params, updates)]
    for p, q in zip(params, new_params):
        p.copy_(torch.where(bad, p, q))

    def keep(old, n):
        if isinstance(old, list):
            return [torch.where(bad, o, x) for o, x in zip(old, n)]
        return torch.where(bad, old, n)

    return {k: keep(old, new[k]) for k, old in state.items()}


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd", "momentum"])
def test_fused_update_on_cpu_is_the_eager_update(kind, bad):
    """Three updates through the wrapper and through the eager code, from
    the same parameters, gradients and state (nonzero moments, count 5):
    bit-equal parameters, moments and count; with ``bad`` every value
    stays. The CPU launches no kernel."""
    rng = np.random.default_rng(1)
    shapes = [(7, 5), (5,), (3, 4, 2), (1,)]

    def tensors(scale=1.0):
        return [torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                 * scale) for s in shapes]

    params, mine = tensors(), None
    mine = [p.clone() for p in params]
    state = {"count": torch.full((), 5, dtype=torch.int32)}
    for name in moment_names(kind):
        state[name] = [t.abs() if name == "nu" else t
                       for t in tensors(0.1)]
    mine_state = {k: ([t.clone() for t in v] if isinstance(v, list)
                      else v.clone()) for k, v in state.items()}
    flag = torch.tensor(bad)
    before = fused_optim.launches
    for step in range(3):
        grads = tensors()
        lr = 1e-2 * (step + 1)
        state = _eager_update(kind, params, grads, state, lr, flag, 0.1,
                              0.8)
        optimizer_update(kind, mine, grads, mine_state,
                         torch.full((), lr), flag, weight_decay=0.1,
                         momentum=0.8)
    assert fused_optim.launches == before
    for a, b in zip(params, mine):
        assert torch.equal(a, b)
    for name, want in state.items():
        got = mine_state[name]
        for a, b in zip(want if isinstance(want, list) else [want],
                        got if isinstance(got, list) else [got]):
            assert torch.equal(a, b), name
    assert int(mine_state["count"]) == (5 if bad else 8)
