"""The switch-MoE LM generated and served by the port, against the JAX
package (mirroring the generation cases of ``tests/test_moe.py`` and the
MoE case of ``tests/test_generate.py``): greedy ``generate`` over the KV
cache against JAX's and against the unpadded recompute oracle, the
one-token-prompt prefill, ``beam_search`` in float32, and ``ServeEngine``
with the dense and the paged prefix-cache pools against the JAX engine,
prefill program counts included (MoE prefills at exact length).

The served model is the JAX package's overfit periodic MoE LM
(``testing/datagen.overfit_periodic_lm``, the default bf16 compute, as
every engine parity test of the port): greedy picks have wide margins,
so streams must be equal. The engines cannot run float32 compute on
either side (both frameworks' caches are bf16 and both decode kernels
refuse f32 queries against them), so the float32 case is beam search
over a rolled window cache, scores within 1e-4 as in
``tests/test_torch_beam.py``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import beam_search as jax_beam_search
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.models import generate as jax_generate
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models import (
    beam_search,
    build_model,
    generate,
    load_flax_variables,
)
from mmlspark_tpu_torch.serve import ServeEngine


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MOE = dict(vocab_size=8, d_model=32, heads=2, depth=2, max_len=32,
           n_experts=2, capacity_factor=2.0)
F32_TOL = 1e-4
CACHE_LEN = 32
PROMPTS = (4, 1, 9, 2, 11)
BUDGETS = (10, 7, 3, 12, 6)


@pytest.fixture(scope="module")
def moe_lm():
    """(jax graph, jax variables, port graph, port variables, ids): the
    JAX overfit MoE LM (capacity = tokens: nothing drops), bridged."""
    jg = jax_build_model("transformer_lm_moe", **MOE)
    jv, ids = overfit_periodic_lm(jg, steps=30)
    tg = build_model("transformer_lm_moe", **MOE)
    return jg, jv, tg, load_flax_variables(tg, jv, device="cpu"), \
        np.array(ids)


def test_generate_matches_jax_and_the_unpadded_oracle(moe_lm):
    """``tests/test_moe.py:273``: the prefill routes the unpadded prompt
    through the capacity path and decode steps droplessly; the tokens
    equal JAX's and the growing-buffer scoring oracle's. The pad-filled
    recompute stays refused."""
    jg, jv, tg, tv, ids = moe_lm
    prompt = ids[:, :6]
    got = generate(tg, tv, torch.from_numpy(prompt), 8, device="cpu")
    want = np.asarray(jax.jit(partial(jax_generate, jg, max_new_tokens=8))(
        jv, jnp.asarray(prompt)))
    np.testing.assert_array_equal(got.numpy(), want)
    buf = torch.from_numpy(prompt)
    for _ in range(8):
        nxt = tg.apply(tv, buf)[:, -1].argmax(-1).to(torch.int32)
        buf = torch.cat([buf, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), buf.numpy())
    with pytest.raises(FriendlyError, match="kv_cache"):
        generate(tg, tv, prompt, 2, kv_cache=False, device="cpu")


def test_one_token_prompt_prefill_uses_capacity_routing():
    """``tests/test_moe.py:301``: a (B, 1) prompt is a prefill; under a
    capacity so tight that the dropless router would disagree, its first
    token equals the scoring forward's, as JAX's does."""
    cfg = dict(vocab_size=8, d_model=16, heads=2, depth=1, max_len=8,
               n_experts=2, capacity_factor=0.5)
    jg = jax_build_model("transformer_lm_moe", **cfg)
    jv = jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tg = build_model("transformer_lm_moe", **cfg)
    tv = load_flax_variables(tg, jv, device="cpu")
    prompt = np.full((4, 1), 3, np.int32)  # identical rows: one expert
    got = generate(tg, tv, torch.from_numpy(prompt), 1, device="cpu")
    want = tg.apply(tv, torch.from_numpy(prompt))[:, -1].argmax(-1)
    np.testing.assert_array_equal(got[:, 1].numpy(), want.numpy())
    jwant = np.asarray(jax.jit(partial(jax_generate, jg, max_new_tokens=1))(
        jv, jnp.asarray(prompt)))
    np.testing.assert_array_equal(got.numpy(), jwant)


def test_beam_search_moe_f32_matches_jax():
    """``beam_search`` over a float32 window MoE (9 new tokens past a
    6-token window, so the rolled cache decodes in f32 on both sides):
    ``return_all`` scores within 1e-4 of JAX's, the best beams equal."""
    cfg = dict(vocab_size=16, d_model=32, heads=2, depth=2, max_len=32,
               n_experts=2, window=6)
    jg = jax_build_model("transformer_lm_moe", **cfg)
    jv = jax.jit(jg.init)(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    jg.blocks = [(n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype")
                  else m) for n, m in jg.blocks]
    tg = build_model("transformer_lm_moe", **cfg)
    for _, mod in tg.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    tv = load_flax_variables(tg, jv, device="cpu")
    prompt = np.random.default_rng(3).integers(0, 16, (2, 5)).astype(
        np.int32)
    wseq, wsc = jax.jit(partial(jax_beam_search, jg, max_new_tokens=9,
                                beams=3, return_all=True))(
        jv, jnp.asarray(prompt))
    gseq, gsc = beam_search(tg, tv, torch.from_numpy(prompt), 9, beams=3,
                            return_all=True, device="cpu")
    np.testing.assert_allclose(gsc.numpy(), np.asarray(wsc), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_array_equal(gseq[:, 0].numpy(), np.asarray(wseq)[:, 0])
    assert gseq.shape == (2, 3, 14)


def _drive(engine, prompts, budgets):
    """Three requests up front, two steps, then the rest join."""
    results, rids = {}, []
    for p, n in zip(prompts[:3], budgets[:3]):
        rids.append(engine.submit(p, max_new_tokens=n))
    for _ in range(2):
        results.update({r.id: r for r in engine.step()})
    for p, n in zip(prompts[3:], budgets[3:]):
        rids.append(engine.submit(p, max_new_tokens=n))
    while engine.busy:
        results.update({r.id: r for r in engine.step()})
    return [np.asarray(results[r].tokens) for r in rids]


POOLS = {
    "dense": dict(),
    "paged_prefix": dict(paged=True, page_size=8, prefix_cache=True),
}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_engine_streams_and_prefill_programs_match_jax(moe_lm, pool):
    """The JAX engine's streams on a ragged/join schedule of periodic-row
    prefixes (several of them prefix-cache hits in the paged pool), the
    port's equal to them and to its own ``generate()``; both engines
    prefill at exact length, so their prefill (and resume) program
    counts are equal."""
    jg, jv, tg, tv, ids = moe_lm
    prompts = [ids[0, :n] for n in PROMPTS]
    kw = dict(slots=2, cache_len=CACHE_LEN, max_queue=8, decode_block=4,
              **POOLS[pool])
    jax_engine = JaxServeEngine(jg, jv, **kw)
    want = _drive(jax_engine, prompts, BUDGETS)
    engine = ServeEngine(tg, tv, device="cpu", **kw)
    got = _drive(engine, prompts, BUDGETS)
    for w, g, p, n in zip(want, got, prompts, BUDGETS):
        np.testing.assert_array_equal(g, w)
        alone = generate(tg, tv, p[None], n, device="cpu")[0].numpy()
        np.testing.assert_array_equal(g, alone)
    assert engine.prefill_compile_count == jax_engine.prefill_compile_count
    assert engine.resume_compile_count == jax_engine.resume_compile_count
    if pool == "paged_prefix":
        assert engine.resume_compile_count >= 1  # prefix hits ran
    assert engine.prefill_compile_count <= engine.num_prefill_buckets


def test_engine_moe_prefills_at_exact_length(moe_lm):
    """One prefill program a distinct prompt length, under a pin of
    ``cache_len - 1``; chunked prefill stays refused."""
    _, _, tg, tv, _ = moe_lm
    engine = ServeEngine(tg, tv, slots=1, cache_len=16, device="cpu")
    assert [engine.prefill_bucket(p) for p in (1, 5, 9, 15)] == [1, 5, 9, 15]
    assert engine.num_prefill_buckets == 15
    with pytest.raises(FriendlyError, match="MoE"):
        ServeEngine(tg, tv, slots=1, cache_len=16, prefill_chunk=8,
                    device="cpu")
