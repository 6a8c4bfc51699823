"""The port's mixture of experts against the JAX package's: the routing
functions of ``parallel/expert.py``, the ``transformer_lm_moe`` graph
through the weight bridge, its sown load-balance loss, the trainer's
``moe_aux_weight`` and weight-only int8 of the stacked expert leaves.

Seeded numpy inputs go to both sides in float32. Tolerances:
- expert choices and kept (dispatch) masks: equal — argmax ties go to
  the first index on both sides and the exclusive cumsum is exact in f32;
- MoE outputs: rtol 1e-4, atol 1e-5 (``tests/test_moe.py``'s: the same
  f32 products summed in other orders); aux losses 1e-6;
- logits of the f32 model: 1e-4 (``tests/test_torch_model.py``'s);
- training: ``tests/test_torch_train.py``'s 1e-5 on the loss curve;
- int8 payloads and scales: bit-equal.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.ops.quantize import quantize_weights as jax_quantize
from mmlspark_tpu.parallel import expert as jax_expert
from mmlspark_tpu.train.trainer import SPMDTrainer as JaxTrainer
from mmlspark_tpu.train.trainer import TrainConfig as JaxConfig
from mmlspark_tpu_torch.core.exceptions import ParamError
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.models.graph import LOSSES
from mmlspark_tpu_torch.ops.quantize import _Q8, _SCALE, quantize_weights
from mmlspark_tpu_torch.parallel import expert
from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL, ATOL = 1e-4, 1e-5
AUX_TOL = 1e-6
F32_TOL = 1e-4
LOSS_TOL = 1e-5
TINY = dict(vocab_size=32, d_model=16, heads=2, depth=2, n_experts=4,
            max_len=16)


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


def _weights(rng, d, f, e):
    return [rng.normal(size=s).astype(np.float32) * k for s, k in (
        ((d, e), 1.0), ((e, d, f), 0.1), ((e, f), 0.1), ((e, f, d), 0.1),
        ((e, d), 0.1))]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the routing functions ---------------------------------------------------


@pytest.mark.parametrize("n,e,cap,masked", [
    (16, 4, 16, False), (16, 4, 3, False), (13, 3, 2, True), (8, 2, 8, True),
])
def test_dispatch_matches_jax(n, e, cap, masked):
    rng = np.random.default_rng(n + e)
    logits = rng.normal(size=(n, e)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    mask = (rng.random(n) > 0.3).astype(np.float32) if masked else None
    want = jax_expert.moe_dispatch(
        jnp.asarray(probs), cap, None if mask is None else jnp.asarray(mask))
    got = expert.moe_dispatch(
        torch.from_numpy(probs), cap,
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=AUX_TOL)
    assert abs(float(got[2]) - float(want[2])) <= AUX_TOL


def test_dispatch_groups_route_independently():
    """Leading dims are independent groups (JAX's ``vmap``)."""
    rng = np.random.default_rng(4)
    probs = torch.softmax(torch.from_numpy(
        rng.normal(size=(3, 10, 4)).astype(np.float32)), -1)
    mask = torch.from_numpy((rng.random((3, 10)) > 0.2).astype(np.float32))
    grouped = expert.moe_dispatch(probs, 2, mask)
    for g in range(3):
        one = expert.moe_dispatch(probs[g], 2, mask[g])
        for a, b in zip(grouped, one):
            torch.testing.assert_close(a[g], b, rtol=0, atol=0)


FFN_CASES = {
    # (b, t, d, f, e, capacity_factor, group_size, masked)
    "ample": (2, 4, 8, 16, 3, 3.0, 1024, False),
    "masked": (4, 2, 6, 8, 2, 2.0, 1024, True),
    "prime_tokens": (1, 13, 8, 16, 3, 3.0, 8, False),
    "overflow_drops": (2, 12, 8, 16, 4, 0.5, 8, True),
}


def _routing(x, weights, cf, gs, mask, lib):
    """Each side's expert choice and kept mask over moe_ffn's groups."""
    b, t, d = x.shape
    n = b * t
    s = min(gs, n)
    pad = (-n) % s
    e = weights[0].shape[1]
    cap = max(int(cf * s / e), 1)
    flat = np.pad(x.reshape(n, d), ((0, pad), (0, 0)))
    tok = np.pad(np.repeat(mask, t) if mask is not None else np.ones(n),
                 (0, pad)).astype(np.float32).reshape(-1, s)
    if lib is jax_expert:
        probs = np.asarray(lib.router_probs(jnp.asarray(flat),
                                            jnp.asarray(weights[0])))
        probs = probs.reshape(-1, s, e)
        disp = np.stack([np.asarray(lib.moe_dispatch(
            jnp.asarray(p), cap, jnp.asarray(m))[0])
            for p, m in zip(probs, tok)])
    else:
        probs = lib.router_probs(torch.from_numpy(flat),
                                 torch.from_numpy(weights[0]))
        probs = probs.reshape(-1, s, e)
        disp = lib.moe_dispatch(probs, cap, torch.from_numpy(tok))[0]
        probs, disp = probs.numpy(), disp.numpy()
    return probs.argmax(-1), disp.sum(-1)


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    b, t, d, f, e, cf, gs, masked = FFN_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    weights = _weights(rng, d, f, e)
    mask = np.array([1, 1, 0, 0][:b] if b == 4 else [1, 0][:b],
                    np.float32) if masked else None
    want, want_aux = jax.jit(
        jax_expert.moe_ffn, static_argnames=("capacity_factor", "group_size")
    )(jnp.asarray(x), *map(jnp.asarray, weights), capacity_factor=cf,
      group_size=gs, mask=None if mask is None else jnp.asarray(mask))
    got, got_aux = expert.moe_ffn(
        torch.from_numpy(x), *_t(weights), capacity_factor=cf,
        group_size=gs, mask=None if mask is None else torch.from_numpy(mask))
    choice_j, kept_j = _routing(x, weights, cf, gs, mask, jax_expert)
    choice_p, kept_p = _routing(x, weights, cf, gs, mask, expert)
    np.testing.assert_array_equal(choice_p, choice_j)
    np.testing.assert_array_equal(kept_p, kept_j)
    if case == "overflow_drops":
        # some real token (row 0) past its expert's capacity is dropped
        assert kept_j.sum(-1).reshape(-1)[:t].min() == 0.0
    if masked:
        assert np.all(got.numpy()[mask == 0] == 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL


def test_dropless_matches_jax_and_the_capacity_path():
    """The decode router equals JAX's, and equals the capacity path where
    nothing drops (``tests/test_moe.py:252``)."""
    rng = np.random.default_rng(1)
    b, t, d, f, e = 2, 4, 8, 16, 3
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    weights = _weights(rng, d, f, e)
    want = jax_expert.moe_ffn_dropless(jnp.asarray(x),
                                       *map(jnp.asarray, weights))
    got = expert.moe_ffn_dropless(torch.from_numpy(x), *_t(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    cap, _ = expert.moe_ffn(torch.from_numpy(x), *_t(weights),
                            capacity_factor=float(e))
    np.testing.assert_allclose(got.numpy(), cap.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_router_probs_and_validate_experts():
    x = torch.ones(3, 5, 4)
    p = expert.router_probs(x, torch.eye(4, 6))
    np.testing.assert_allclose(p.sum(-1).numpy(), np.ones((3, 5)),
                               rtol=1e-6)
    with pytest.raises(ParamError, match="2 experts"):
        expert.validate_experts(1)
    # a mesh's expert axis must split the experts evenly (over a real
    # DeviceMesh: tests/test_torch_trainer_mesh.py::test_validate_experts)
    four = types.SimpleNamespace(mesh_dim_names=("data", "expert"),
                                 shape=(2, 4))
    with pytest.raises(ParamError, match="not divisible"):
        expert.validate_experts(6, mesh=four)
    expert.validate_experts(8, mesh=four)
    expert.validate_experts(8)


# -- the model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def lms():
    """{dtype: (jax graph, flax variables, port graph, port variables)}
    over one flax initialisation."""
    ids = np.zeros((1, 16), np.int32)
    out, jv = {}, None
    for dtype in ("bfloat16", "float32"):
        jg = jax_build_model("transformer_lm_moe", attn_impl="dense", **TINY)
        tg = build_model("transformer_lm_moe", attn_impl="dense", **TINY)
        if dtype == "float32":
            _f32_jax(jg)
            _f32_port(tg)
        if jv is None:
            jv = jax.device_get(jax.jit(jg.init)(jax.random.PRNGKey(0),
                                                 jnp.asarray(ids)))
        out[dtype] = (jg, jv, tg, load_flax_variables(tg, jv, device="cpu"))
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_moe_lm_logits_match_flax(lms, masked):
    jg, jv, tg, tv = lms["float32"]
    rng = np.random.default_rng(2)
    ids = rng.integers(0, TINY["vocab_size"], size=(4, 16)).astype(np.int32)
    mask = np.array([1, 1, 1, 0], np.float32) if masked else None
    want = np.asarray(jax.jit(jg.apply)(
        jv, jnp.asarray(ids), mask=None if mask is None else jnp.asarray(mask)))
    got = tg.apply(tv, torch.from_numpy(ids), mask=None if mask is None
                   else torch.from_numpy(mask)).numpy()
    assert got.shape == (4, 16, TINY["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_bf16_moe_lm_tracks_flax(lms):
    """The default bf16 compute: within ``tests/test_torch_model.py``'s
    bf16 logit tolerance wherever both sides route alike."""
    jg, jv, tg, tv = lms["bfloat16"]
    ids = np.random.default_rng(3).integers(0, 32, (2, 16)).astype(np.int32)
    want = np.asarray(jax.jit(jg.apply)(jv, jnp.asarray(ids))).astype(
        np.float32)
    got = tg.apply(tv, torch.from_numpy(ids)).numpy()
    assert np.mean(np.abs(got - want) <= 6.25e-2) > 0.99


def test_sown_losses_in_train_mode_only(lms):
    """The load-balance loss comes back under ``updated[block]["losses"]``
    in train mode, equal to flax's sown value; never in the variables
    ``init_variables`` makes, and a second call sows afresh."""
    from mmlspark_tpu_torch.models import init_variables

    jg, jv, tg, tv = lms["float32"]
    ids = np.random.default_rng(5).integers(0, 32, (4, 16)).astype(np.int32)
    _, jup = jax.jit(jg.apply, static_argnames="train")(
        jv, jnp.asarray(ids), train=True)
    _, up = tg.apply(tv, torch.from_numpy(ids), train=True)
    for i in range(TINY["depth"]):
        block = f"block{i}"
        want = float(jax.tree_util.tree_leaves(jup[block]["losses"])[0])
        got = up[block][LOSSES]
        assert set(got) == {"moe.load_balance"}
        assert abs(float(got["moe.load_balance"]) - want) <= AUX_TOL
    assert all(LOSSES not in v for v in tv.values())
    assert all(LOSSES not in v
               for v in init_variables(tg, 0, device="cpu").values())
    # the updated variables (losses and all) go back in: stripped, resown
    _, again = tg.apply(up, torch.from_numpy(ids), train=True)
    torch.testing.assert_close(again["block0"][LOSSES],
                               up["block0"][LOSSES])
    tg.apply(up, torch.from_numpy(ids))  # eval binds without the losses


def test_moe_build_model_checks():
    with pytest.raises(ParamError, match="kv_heads"):
        build_model("transformer_lm_moe", vocab_size=32, d_model=16,
                    heads=4, depth=1, n_experts=2, max_len=16, kv_heads=3)
    with pytest.raises(ParamError, match="2 experts"):
        build_model("transformer_lm_moe", n_experts=1)
    g = build_model("transformer_lm_moe", vocab_size=32, d_model=16,
                    heads=4, depth=1, n_experts=2, max_len=16, window=6,
                    kv_heads=1, pos_embedding="rope", attn_impl="dense")
    assert g.extra["n_experts"] == 2 and g.extra["window"] == 6


def test_weight_int8_moe_bytes_bit_equal_jax(lms):
    """Every leaf JAX's ``quantize_weights`` turns int8 — the stacked
    expert kernels and the router included, one scale per index of the
    last axis — is bit-equal in the port, payload and scale."""
    jg, jv, tg, tv = lms["bfloat16"]
    jq = load_flax_variables(tg, jax.device_get(jax_quantize(jv, min_size=0)),
                             device="cpu")
    pq = quantize_weights(tg, tv, min_size=0)
    for block, leaves in jq.items():
        for key, leaf in leaves.items():
            got = pq[block][key]
            assert isinstance(leaf, dict) == isinstance(got, dict), key
            if isinstance(leaf, dict):
                assert torch.equal(got[_Q8], leaf[_Q8]), (block, key)
                assert torch.equal(got[_SCALE], leaf[_SCALE]), (block, key)
    assert isinstance(pq["block0"]["moe.experts.w_in"], dict)
    assert pq["block0"]["moe.experts.w_in"][_SCALE].shape == (1, 1, 64)


# -- training ----------------------------------------------------------------


def _data():
    rng = np.random.default_rng(0)
    x = rng.integers(0, TINY["vocab_size"], size=(10, 16)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def test_trainer_moe_aux_matches_jax(lms):
    """4 adam steps of the f32 MoE LM, ``moe_aux_weight=1e-2``, batch 4
    over 10 rows (the tail batch padded): the loss and grad-norm curves
    equal the JAX trainer's within 1e-5, and the aux term is in them."""
    jg, jv, tg, _ = lms["float32"]
    x, y = _data()
    cfg = dict(epochs=2, batch_size=4, learning_rate=1e-3, log_every=1,
               moe_aux_weight=1e-2, shuffle=False)
    jt = JaxTrainer(jg, JaxConfig(mesh_axes={"data": 1}, **cfg))
    jt.train(x[:8], y[:8], init_variables=jax.tree.map(np.array, jv))
    pt = SPMDTrainer(tg, TrainConfig(**cfg), device="cpu")
    out = pt.train(x[:8], y[:8],
                   init_variables=load_flax_variables(tg, jv, device="cpu"))
    for key in ("loss", "grad_norm"):
        want = np.array([h[key] for h in jt.history if key in h])
        got = np.array([h[key] for h in pt.history if key in h])
        assert len(got) == len(want) == 4
        np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    assert all(LOSSES not in v for v in out.values())
    plain = SPMDTrainer(tg, TrainConfig(**{**cfg, "moe_aux_weight": 0.0}),
                        device="cpu")
    plain.train(x[:8], y[:8],
                init_variables=load_flax_variables(tg, jv, device="cpu"))
    assert plain.history[0]["loss"] < pt.history[0]["loss"]


def test_trainer_moe_checkpoint_resume_carries_no_losses(lms, tmp_path):
    """The resume regression of ``tests/test_moe.py:166``: sown losses
    never enter the checkpointed state, so a resume restores against the
    init-derived state and trains on past the first epoch."""
    _, jv, tg, _ = lms["float32"]
    x, y = _data()
    cfg = dict(batch_size=4, learning_rate=1e-2, log_every=1, shuffle=False,
               checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1)
    SPMDTrainer(tg, TrainConfig(epochs=1, **cfg), device="cpu").train(
        x[:8], y[:8])
    names = {p.name for p in (tmp_path / "ckpt").rglob("*")}
    assert names and not any("losses" in n for n in names)
    resumed = SPMDTrainer(tg, TrainConfig(epochs=2, **cfg), device="cpu")
    out = resumed.train(x[:8], y[:8])
    steps = [h["step"] for h in resumed.history if "loss" in h]
    assert steps and min(steps) >= 2
    assert all(LOSSES not in v for v in out.values())
    assert tg.apply(out, torch.from_numpy(x[:2])).shape == (2, 16, 32)
