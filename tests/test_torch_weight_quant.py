"""The port's weight-only int8 against the JAX package's (mirroring
``tests/test_quantize.py``'s unit tests and the weight-int8 engine case
of ``tests/test_quantized_serve.py``): ``quantize_weights`` and
``dequantize_weights`` bit-equal to JAX's on the same bridged weights,
``quantized_bytes`` equal, JAX-quantized variables through the bridge,
the dequantized model's logits, and the weight-int8 engine's streams
against the JAX weight-int8 engine's, with both pools.

Tolerances: payloads, scales and dequantized bf16 weights are bit-equal
(the same f32 arithmetic, ``rint`` half to even on both sides); logits
of the dequantized model within the bf16 logit tolerance of
``tests/test_torch_model.py``; streams equal the JAX engine's, or first
differ at a near tie of the JAX model (``tests/test_torch_serve.py``),
and stay within ``FLIP_BUDGET`` of the port's bf16 engine — the JAX
suite's budget. The stage tests of ``tests/test_quantize.py`` wait for
``stages/dnn_model.py``.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.ops.quantize import dequantize_weights as jax_dequantize
from mmlspark_tpu.ops.quantize import quantize_weights as jax_quantize
from mmlspark_tpu.ops.quantize import quantized_bytes as jax_quantized_bytes
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.models import build_model, load_flax_variables
from mmlspark_tpu_torch.models.generate import cache_geometry
from mmlspark_tpu_torch.ops.quantize import (
    _Q8,
    _SCALE,
    _is_quantized_leaf,
    dequantize_weights,
    quantize_leaf,
    quantize_weights,
    quantized_bytes,
)
from mmlspark_tpu_torch.serve import ServeEngine, run_demo
from mmlspark_tpu_torch.serve import engine as engine_mod


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF16_LOGIT_TOL = 6.25e-2
FLIP_BUDGET = 0.25
TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)
CACHE_LEN = 32


@pytest.fixture(scope="module")
def lm():
    """The JAX package's overfit periodic LM, bridged into the port."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    tg = build_model("transformer_lm", **TINY)
    tv = load_flax_variables(tg, jv, device="cpu")
    return jg, jv, tg, tv, np.array(ids)


def _flax_leaf(jv, name, key, tg):
    """The flax leaf behind port parameter ``name.key`` and whether the
    port holds it transposed."""
    from mmlspark_tpu_torch.models.bridge import (
        _LEAVES,
        _owner_and_leaf,
        flax_channel_axis,
    )

    mod = dict(tg.blocks)[name]
    path, owner, leaf = _owner_and_leaf(mod, key)
    node = jv[name]["params"]
    for part in (path.split(".") if path else []) + [
            _LEAVES.get(type(owner), {}).get(leaf, leaf)]:
        node = node[part]
    return node, flax_channel_axis(mod, key, 2) == 0


def _assert_matches_jax(tg, port_q, jax_q):
    """Leaf for leaf: a quantized port leaf has JAX's payload (in the
    port's layout) and JAX's scale values, bit for bit; a passed-through
    leaf is passed through on both sides. Returns the quantized count."""
    n = 0
    for name, block in port_q.items():
        for key, leaf in block.items():
            ref, transposed = _flax_leaf(jax_q, name, key, tg)
            assert _is_quantized_leaf(leaf) == isinstance(ref, dict), key
            if not _is_quantized_leaf(leaf):
                continue
            n += 1
            q = np.asarray(ref[_Q8])
            np.testing.assert_array_equal(leaf[_Q8].numpy(),
                                          q.T if transposed else q)
            np.testing.assert_array_equal(
                leaf[_SCALE].numpy().reshape(-1), np.asarray(ref[_SCALE]))
            assert leaf[_SCALE].dtype == torch.float32
    return n


# -- tests/test_quantize.py's unit tests, against JAX --------------------------


def test_roundtrip_error_bounded_per_channel(lm):
    """Channels of wildly different magnitudes (per flax output channel):
    the same int8 and scales as JAX, and each channel's reconstruction
    error within half its own step."""
    jg, jv, tg, _, _ = lm
    mags = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.logspace(
        -3, 2, a.shape[-1])[None, :].astype(np.float32) if a.ndim == 2
        else np.asarray(a), jv)
    tv = load_flax_variables(tg, mags, device="cpu")
    port_q = quantize_weights(tg, tv, min_size=0)
    assert _assert_matches_jax(tg, port_q, jax_quantize(mags, min_size=0)) \
        == 11
    back = dequantize_weights(port_q, dtype=torch.float32)
    for name, block in port_q.items():
        for key, leaf in block.items():
            if _is_quantized_leaf(leaf):
                err = (back[name][key] - tv[name][key]).abs()
                assert (err <= leaf[_SCALE] * 0.51 + 1e-9).all(), key


def test_bf16_leaves_are_quantized(lm):
    """bf16 weights are quantized, not skipped, and give JAX's bytes
    (JAX's bf16 leaves have numpy kind 'V')."""
    _, jv, tg, tv, _ = lm
    bf16_port = {n: {k: t.bfloat16() for k, t in b.items()}
                 for n, b in tv.items()}
    bf16_jax = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jv)
    port_q = quantize_weights(tg, bf16_port, min_size=0)
    assert _assert_matches_jax(tg, port_q,
                               jax_quantize(bf16_jax, min_size=0)) == 11
    back = dequantize_weights(port_q, dtype=torch.float32)
    assert (back["block0"]["mlp_in.weight"]
            - tv["block0"]["mlp_in.weight"]).abs().max() < 0.05


def test_small_and_1d_tensors_pass_through(lm):
    """The default ``min_size`` (4096): 1-D leaves, 2-D leaves under it
    and non-float leaves come back as the same tensors; the quantized set
    is JAX's."""
    _, jv, tg, tv, _ = lm
    ints = {n: dict(b, ints=torch.arange(12).reshape(3, 4))
            for n, b in tv.items()}
    port_q = quantize_weights(tg, ints)
    assert _assert_matches_jax(tg, {n: {k: v for k, v in b.items()
                                        if k != "ints"}
                                    for n, b in port_q.items()},
                               jax_quantize(jv)) == 4  # mlp_in/mlp_out x 2
    for name, block in port_q.items():
        for key, leaf in block.items():
            if not _is_quantized_leaf(leaf):
                assert leaf is ints[name][key]
            else:
                assert ints[name][key].numel() >= 4096


def test_stored_bytes_shrink_4x(lm):
    """``quantized_bytes`` equals JAX's on the bridged model at every
    ``min_size``, and a 256 x 256 leaf's stored bytes are under a 3.8th
    of f32 (int8 payload + per-channel scales)."""
    _, jv, tg, tv, _ = lm
    for min_size in (0, 4096, 10 ** 9):
        want = jax_quantized_bytes(jax_quantize(jv, min_size=min_size))
        got = quantized_bytes(quantize_weights(tg, tv, min_size=min_size))
        assert got == want, min_size
    w = np.random.default_rng(1).normal(size=(256, 256)).astype(np.float32)
    for axis in (0, 1):
        stored, f32 = quantized_bytes(
            {"b": {"k": quantize_leaf(torch.from_numpy(w), axis)}})
        assert (stored, f32) == jax_quantized_bytes(jax_quantize({"k": w}))
        assert stored < f32 / 3.8


# -- the bridge, the geometry and the dequantized model --------------------------


@pytest.mark.parametrize("min_size", [0, 4096])
def test_bridge_takes_jax_quantized_variables(lm, min_size):
    """JAX-quantized variables through the bridge equal the port's own
    quantization of the bridged float weights, tensor for tensor, and
    ``cache_geometry`` reads the same geometry off the int8 payload."""
    _, jv, tg, tv, _ = lm
    bridged = load_flax_variables(tg, jax_quantize(jv, min_size=min_size),
                                  device="cpu")
    own = quantize_weights(tg, tv, min_size=min_size)
    for name, block in own.items():
        for key, leaf in block.items():
            other = bridged[name][key]
            if _is_quantized_leaf(leaf):
                assert torch.equal(leaf[_Q8], other[_Q8])
                assert torch.equal(leaf[_SCALE], other[_SCALE])
            else:
                assert torch.equal(leaf, other)
    assert cache_geometry(tg, bridged) == cache_geometry(tg, tv)


def test_dequantized_model_matches_jax(lm):
    """``dequantize_weights`` bit-equal to JAX's (bf16, two roundings),
    and the dequantized model's logits within the bf16 tolerance of
    JAX's ``graph.apply(dequantize_weights(quantize_weights(v)))`` —
    the embedding and position rows then arrive in bf16 on both sides."""
    jg, jv, tg, tv, ids = lm
    jdq = jax_dequantize(jax_quantize(jv, min_size=0))
    tdq = dequantize_weights(quantize_weights(tg, tv, min_size=0))
    for name, block in tdq.items():
        for key, t in block.items():
            ref, transposed = _flax_leaf(jdq, name, key, tg)
            ref = np.asarray(ref).astype(np.float32)
            np.testing.assert_array_equal(t.float().numpy(),
                                          ref.T if transposed else ref)
    x = np.concatenate([ids[:, :12], ids[:, 3:15]]).astype(np.int32)
    want = np.asarray(jg.apply(jdq, jnp.asarray(x)))
    got = tg.apply(tdq, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=BF16_LOGIT_TOL, rtol=0)


# -- the weight-int8 engine -------------------------------------------------------


#: prompts in one prefill bucket and budgets that keep the ladder at T=4
PROMPTS = (4, 1, 8, 7, 3)
BUDGETS = [5] * 5


def _streams(engine, ids):
    """The ragged schedule with a mid-run join; results per request."""
    prompts = [ids[0, :n] for n in PROMPTS]
    results, rids = {}, []
    for p, n in zip(prompts[:3], BUDGETS[:3]):
        rids.append(engine.submit(p, max_new_tokens=n))
    results.update({r.id: r for r in engine.step()})
    for p, n in zip(prompts[3:], BUDGETS[3:]):
        rids.append(engine.submit(p, max_new_tokens=n))
    results.update(engine.run())
    return [results[r] for r in rids]


def _flip_rate(a_streams, b_streams) -> float:
    flips = total = 0
    for a, b in zip(a_streams, b_streams):
        n = min(len(a), len(b))
        flips += int(np.sum(np.asarray(a[:n]) != np.asarray(b[:n])))
        flips += abs(len(a) - len(b))
        total += max(len(a), len(b))
    return flips / max(total, 1)


def _assert_streams_agree(jg, jv, want, got, prompt_len):
    """Equal, or first different at a near tie of the JAX model."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want, got)
    diff = np.nonzero(want != got)[0]
    if not diff.size:
        return
    i = int(diff[0])
    assert i >= prompt_len
    logits = np.asarray(jg.apply(jv, jnp.asarray(want[None, :i])))[0, -1]
    top2 = np.sort(logits.astype(np.float32))[-2:]
    assert float(top2[1] - top2[0]) < BF16_LOGIT_TOL, (i, want, got)


@pytest.fixture(scope="module")
def bf16_streams(lm):
    _, _, tg, tv, ids = lm
    engine = ServeEngine(tg, tv, slots=2, cache_len=CACHE_LEN, max_queue=8,
                         decode_block=4, device="cpu")
    return [r.tokens for r in _streams(engine, ids)]


@pytest.mark.parametrize("pool", [
    dict(),
    dict(paged=True, kv_dtype="int8"),
], ids=["dense_bf16_kv", "paged_int8_kv"])
def test_weight_int8_engine_matches_jax(lm, bf16_streams, pool):
    """``quantize_weights=True`` with the dense bf16 pool and with the
    paged int8 pool: streams equal the JAX weight-int8 engine's (near
    ties of the JAX dequantized model aside), within the flip budget of
    the port's bf16 engine, every page returned."""
    jg, jv, tg, tv, ids = lm
    kw = dict(slots=2, cache_len=CACHE_LEN, max_queue=8, decode_block=4,
              quantize_weights=True, **pool)
    jax_res = _streams(JaxServeEngine(jg, jv, **kw), ids)
    engine = ServeEngine(tg, tv, device="cpu", **kw)
    res = _streams(engine, ids)
    jdq = jax_dequantize(jax_quantize(jv, min_size=0))
    for n, jr, r in zip(PROMPTS, jax_res, res):
        assert r.status == "completed"
        _assert_streams_agree(jg, jdq, jr.tokens, r.tokens, n)
    rate = _flip_rate([s[n:] for s, n in zip(bf16_streams, PROMPTS)],
                      [r.tokens[n:] for r, n in zip(res, PROMPTS)])
    assert rate <= FLIP_BUDGET, f"weight-int8 flip rate {rate}"
    if pool:
        assert engine.pool.pages_free == engine.pool.pages_allocatable


def test_engine_keeps_no_bf16_copy_of_the_weights(lm, monkeypatch):
    """The engine holds int8 weights (every 2-D leaf, ``min_size=0``),
    dequantizes once per program call, and no dequantized tensor
    outlives its call: the graph is unbound after each one. (The
    analytics' once-per-family cost runs dequantize ``meta`` tensors,
    which hold no memory; they are not program calls.)"""
    _, _, tg, tv, ids = lm
    made = []
    real = engine_mod.dequantize_weights

    def spy(variables, *a, **kw):
        out = real(variables, *a, **kw)
        made.extend(weakref.ref(t) for b in out.values() for t in b.values()
                    if t.dtype == torch.bfloat16 and not t.is_meta)
        return out

    monkeypatch.setattr(engine_mod, "dequantize_weights", spy)
    engine = ServeEngine(tg, tv, slots=2, cache_len=CACHE_LEN,
                         decode_block=4, quantize_weights=True, device="cpu")
    for name, block in engine.variables.items():
        for key, leaf in block.items():
            assert _is_quantized_leaf(leaf) == (tv[name][key].ndim == 2)
    res = _streams(engine, ids)
    assert all(r.status == "completed" for r in res)
    n_calls = len(PROMPTS) + sum(int(n) for n in
                                 engine.metrics.decode_blocks.values())
    assert len(made) == 11 * n_calls  # one dequantization per call
    gc.collect()
    assert not [r for r in made if r() is not None]
    assert tg._bound is None
    assert all(p.is_meta for _, m in tg.blocks for p in m.parameters())


def test_run_demo_weight_int8_on_cpu():
    out = run_demo(device="cpu", quantize_weights=True, n_requests=4,
                   max_new_tokens=4)
    assert out["completed"] == 4 and out["tokens_generated"] == 16
    paged = run_demo(device="cpu", quantize_weights=True, paged=True,
                     prefix_cache=True, kv_dtype="int8", n_requests=4,
                     max_new_tokens=4)
    assert paged["completed"] == 4
