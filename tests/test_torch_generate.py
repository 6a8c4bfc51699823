"""The port's ``generate()`` against the JAX package's (mirroring
``tests/test_generate.py``; sampling is in ``test_torch_sampling.py``,
beam search in ``test_torch_beam.py``): greedy and recompute-oracle
tokens, EOS, window and RoPE decoding, the guards, and the weight
geometry read by ``init_cache``.

The models are the JAX package's overfit periodic LM
(``testing/datagen.overfit_periodic_lm``) bridged into the port, so
greedy picks have wide margins and tokens must be equal. The MoE cases
are in ``test_torch_moe_serve.py``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.models import generate as jax_generate
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models import (
    build_model,
    generate,
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.models.generate import init_cache


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PERIOD = 4  # token stream cycles 1,2,3,4,1,2,...
#: one training length for every fixture model (each config trains once)
STEPS = 60
BASE = dict(vocab_size=8, d_model=32, heads=2, depth=2, max_len=32)
CONFIGS = {
    "plain": {},
    "window": {"window": 6},
    "rope_mqa": {"pos_embedding": "rope", "kv_heads": 1},
    "window_gqa": {"window": 6, "kv_heads": 1},
}


@pytest.fixture(scope="module")
def trained():
    """``trained(steps, **cfg)`` -> (jax graph, jax variables, port
    graph, port variables, ids): the JAX overfit LM of that config,
    trained once per module and bridged into the port."""
    cache = {}

    def get(steps, **cfg):
        key = (steps, tuple(sorted(cfg.items())))
        if key not in cache:
            full = dict(BASE, **cfg)
            jg = jax_build_model("transformer_lm", **full)
            jv, ids = overfit_periodic_lm(jg, steps=steps,
                                          seq=min(16, full["max_len"]),
                                          period=PERIOD)
            tg = build_model("transformer_lm", **full)
            tv = load_flax_variables(tg, jv, device="cpu")
            cache[key] = (jg, jv, tg, tv, np.array(ids))
        return cache[key]

    return get


def _gen(tg, tv, prompt, n, **kw):
    return generate(tg, tv, torch.from_numpy(np.asarray(prompt)), n,
                    device="cpu", **kw).numpy()


def _rng(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", ["plain", "window", "rope_mqa"])
def test_overfit_lm_continues_the_period(trained, name):
    _, _, tg, tv, ids = trained(STEPS, **CONFIGS[name])
    prompt = ids[:, :8]
    out = _gen(tg, tv, prompt, 8)
    want = (np.arange(16) % PERIOD) + 1
    np.testing.assert_array_equal(out[0], want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kv_cache_matches_recompute_oracle(trained, name):
    """Cached decode = the recompute oracle = JAX's cached decode, per
    cache configuration; sampling consumes the same generator stream on
    both of the port's paths."""
    jg, jv, tg, tv, ids = trained(STEPS, **CONFIGS[name])
    prompt = ids[:, :5]
    kv = _gen(tg, tv, prompt, 9)
    rc = _gen(tg, tv, prompt, 9, kv_cache=False)
    np.testing.assert_array_equal(kv, rc)
    # jitted: one XLA program (the eager call compiles op by op)
    want = jax.jit(partial(jax_generate, jg, max_new_tokens=9))(
        jv, jnp.asarray(prompt))
    np.testing.assert_array_equal(kv, np.asarray(want))
    skv = _gen(tg, tv, prompt, 9, temperature=0.8, rng=_rng(7))
    src = _gen(tg, tv, prompt, 9, temperature=0.8, rng=_rng(7),
               kv_cache=False)
    np.testing.assert_array_equal(skv, src)


def test_recompute_on_a_flash_model_matches_the_cache_path(trained):
    """``kv_cache=False`` on an ``attn_impl="flash"`` build runs the
    flash forward over the whole buffer (its plain version here) and
    gives the dense build's cached tokens, which equal JAX's
    (``test_kv_cache_matches_recompute_oracle``)."""
    _, _, dg, dv, ids = trained(STEPS, **CONFIGS["window_gqa"])
    tg = build_model("transformer_lm", **dict(BASE, **CONFIGS["window_gqa"]),
                     attn_impl="flash")
    prompt = ids[:, :5]
    np.testing.assert_array_equal(
        _gen(tg, dv, prompt, 9, kv_cache=False), _gen(dg, dv, prompt, 9))


def test_greedy_is_deterministic_and_sampling_needs_rng(trained):
    _, _, tg, tv, ids = trained(STEPS)
    prompt = ids[:, :4]
    a = _gen(tg, tv, prompt, 6)
    b = _gen(tg, tv, prompt, 6)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(FriendlyError, match="rng"):
        _gen(tg, tv, prompt, 2, temperature=0.7)
    # the sampling path runs, keeps the prompt and repeats per seed
    s = _gen(tg, tv, prompt, 6, temperature=0.7, rng=_rng(3))
    np.testing.assert_array_equal(s[:, :4], prompt)
    np.testing.assert_array_equal(
        s, _gen(tg, tv, prompt, 6, temperature=0.7, rng=_rng(3)))


def test_generate_guards():
    m = build_model("transformer_lm", vocab_size=8, d_model=16, heads=2,
                    depth=1, max_len=8)
    v = init_variables(m, 0, device="cpu")
    prompt = np.zeros((1, 6), np.int32)
    with pytest.raises(FriendlyError, match="position table"):
        _gen(m, v, prompt, 4)  # 10 > max_len 8
    with pytest.raises(FriendlyError, match=">= 1"):
        _gen(m, v, prompt, 0)
    bidir = build_model("transformer_lm", vocab_size=8, d_model=16,
                        heads=2, depth=1, max_len=8, causal=False)
    bv = init_variables(bidir, 0, device="cpu")
    with pytest.raises(FriendlyError, match="causal"):
        _gen(bidir, bv, prompt, 1)


def test_rope_generates_past_trained_max_len(trained):
    """RoPE has no position table: generation may run past max_len."""
    _, _, tg, tv, ids = trained(STEPS, max_len=16, pos_embedding="rope")
    out = _gen(tg, tv, ids, 8)  # 24 > 16
    want = (np.arange(24) % PERIOD) + 1
    np.testing.assert_array_equal(out[0], want)


def test_eos_stops_rows_and_pads_the_tail(trained):
    """eos_id=3 keeps tokens up to AND including the first 3, then pads
    — on the cache path and the recompute oracle alike (the JAX suite's
    expected row)."""
    _, _, tg, tv, ids = trained(STEPS)
    prompt = ids[:, :8]  # ends ...3,4 -> continuation 1,2,3,4,...
    kv = _gen(tg, tv, prompt, 8, eos_id=3)
    want = np.concatenate([prompt[0], [1, 2, 3, 0, 0, 0, 0, 0]])
    np.testing.assert_array_equal(kv[0], want)
    np.testing.assert_array_equal(
        kv, _gen(tg, tv, prompt, 8, eos_id=3, kv_cache=False))
    pk = _gen(tg, tv, prompt, 8, eos_id=3, pad_id=7)
    np.testing.assert_array_equal(
        pk[0], np.concatenate([prompt[0], [1, 2, 3, 7, 7, 7, 7, 7]]))


def test_rolled_window_cache_long_generation(trained):
    """A window model generating far past its window and its max_len:
    the rolled O(window) buffers wrap many times, the period holds."""
    _, _, tg, tv, ids = trained(STEPS, max_len=16, window=8,
                                pos_embedding="rope")
    out = _gen(tg, tv, ids, 32)  # 48 >> W=8
    want = (np.arange(48) % PERIOD) + 1
    np.testing.assert_array_equal(out[0], want)


def test_generate_rejects_moe_recompute_and_negative_temperature():
    m = build_model("transformer_lm", vocab_size=8, d_model=16, heads=2,
                    depth=1, max_len=16)
    v = init_variables(m, 0, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(FriendlyError, match="temperature"):
        _gen(m, v, prompt, 2, temperature=-0.5, rng=_rng(0))
    # the guard reads graph.extra: any graph that records experts
    m.extra["n_experts"] = 2
    assert _gen(m, v, prompt, 2).shape == (1, 6)
    with pytest.raises(FriendlyError, match="kv_cache"):
        _gen(m, v, prompt, 2, kv_cache=False)


def test_init_cache_friendly_errors():
    m = build_model("transformer_lm", vocab_size=8, d_model=16, heads=2,
                    depth=1, max_len=8)
    v = init_variables(m, 0, device="cpu")
    init_cache(m, v, 1, 8)  # healthy baseline
    del m.extra["heads"]
    with pytest.raises(FriendlyError, match="heads"):
        init_cache(m, v, 1, 8)
    m2 = build_model("transformer_lm", vocab_size=8, d_model=16, heads=2,
                     depth=1, max_len=8)
    v2 = dict(v, block0={k: t for k, t in v["block0"].items()
                         if not k.startswith("attn.qkv")})
    with pytest.raises(FriendlyError, match="qkv"):
        init_cache(m2, v2, 1, 8)
