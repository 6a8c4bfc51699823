"""The port's ``beam_search`` (mirroring the beam cases of
``tests/test_generate.py``): beams=1 is greedy, full width is
exhaustive, EOS and ``return_all``, the guards, the stable tie order,
the cache reorder, and parity with the JAX package's ``beam_search``
(the plain and window configurations here, RoPE + MQA and window + GQA
in ``test_torch_beam_jax.py``).

``return_all`` is compared rank by rank (:func:`assert_beams_agree`):
scores within a tolerance, and a rank's sequence equal to JAX's unless
the scores tie it with a neighbour within that tolerance; the best
sequence equal. Tolerances on the scores (sums of log-probs):
- float32 compute (every block's ``dtype`` float32 on both sides, over
  a rolled sliding-window cache, which both frameworks decode in f32):
  1e-4, the same arithmetic summed in other orders;
- the default bfloat16 compute, on the overfit LM: 0.125, two bf16
  logit tolerances of ``tests/test_torch_model.py`` (the chosen token's
  logit and a step's log-sum-exp; every step but a beam's few
  low-probability ones contributes almost nothing to the error).
The MoE case waits for ``models/moe.py``.
"""

from __future__ import annotations

import importlib
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import beam_search as jax_beam_search
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models import (
    beam_search,
    build_model,
    generate,
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.models.generate import reorder_cache, top_k_stable

#: the module (``models.generate`` the attribute is the function)
generate_mod = importlib.import_module("mmlspark_tpu_torch.models.generate")

F32_TOL = 1e-4
BF16_BEAM_TOL = 2 * 6.25e-2
BASE = dict(vocab_size=8, d_model=32, heads=2, depth=2, max_len=32)
CONFIGS = {
    "plain": {},
    "window": {"window": 6},
    "rope_mqa": {"pos_embedding": "rope", "kv_heads": 1},
    "window_gqa": {"window": 6, "kv_heads": 1},
}


@pytest.fixture(scope="module")
def trained():
    """``trained(name)`` -> (jax graph, jax variables, port graph, port
    variables, ids): the JAX overfit periodic LM of that config (60
    adam steps), trained once per module and bridged into the port."""
    cache = {}

    def get(name):
        if name not in cache:
            full = dict(BASE, **CONFIGS[name])
            jg = jax_build_model("transformer_lm", **full)
            jv, ids = overfit_periodic_lm(jg, steps=60, seq=16, period=4)
            tg = build_model("transformer_lm", **full)
            tv = load_flax_variables(tg, jv, device="cpu")
            cache[name] = (jg, jv, tg, tv, np.array(ids))
        return cache[name]

    return get


def run_beam(tg, tv, prompt, n, **kw):
    out = beam_search(tg, tv, torch.from_numpy(np.asarray(prompt)), n,
                      device="cpu", **kw)
    if isinstance(out, tuple):
        return tuple(t.numpy() for t in out)
    return out.numpy()


def run_jax_beam(jg, jv, prompt, n, **kw):
    # jitted: one XLA program (the eager call compiles op by op)
    out = jax.jit(partial(jax_beam_search, jg, max_new_tokens=n, **kw))(
        jv, jnp.asarray(prompt))
    if isinstance(out, tuple):
        return tuple(np.asarray(t) for t in out)
    return np.asarray(out)


def assert_beams_agree(want, got, tol):
    """``return_all`` results rank by rank: scores within ``tol``, and a
    rank's sequence equal to JAX's unless JAX's scores tie it with a
    neighbouring rank within ``tol`` (or it is the last rank, whose
    neighbour is the first beam left out)."""
    (wseq, wsc), (gseq, gsc) = want, got
    assert gseq.shape == wseq.shape and gsc.shape == wsc.shape
    np.testing.assert_allclose(gsc, wsc, atol=tol, rtol=0)
    k = wsc.shape[1]
    for b, j in zip(*np.nonzero((gseq != wseq).any(axis=2))):
        near = [abs(wsc[b, j] - wsc[b, i]) <= tol
                for i in (j - 1, j + 1) if 0 <= i < k]
        assert j == k - 1 or any(near), (b, j, wsc[b], gsc[b])


# -- the JAX suite's beam cases -------------------------------------------------


def test_beam_one_equals_greedy(trained):
    _, _, tg, tv, ids = trained("window")
    prompt = ids[:, :5]
    greedy = generate(tg, tv, torch.from_numpy(prompt), 9,
                      device="cpu").numpy()
    np.testing.assert_array_equal(run_beam(tg, tv, prompt, 9, beams=1),
                                  greedy)


def test_beam_full_width_is_exhaustive_at_two_steps():
    """K = V beams for N = 2 steps IS exhaustive: the best beam must be
    the brute-force argmax of the teacher-forced log-prob sum over all V²
    continuations, on an untrained model."""
    V = 6
    m = build_model("transformer_lm", vocab_size=V, d_model=16, heads=2,
                    depth=1, max_len=12)
    v = init_variables(m, 4, device="cpu")
    prompt = np.asarray([[1, 2, 3, 4], [5, 0, 1, 2]], np.int32)
    b, p = prompt.shape
    got = run_beam(m, v, prompt, 2, beams=V)
    cands = np.stack(np.meshgrid(np.arange(V), np.arange(V),
                                 indexing="ij"), -1).reshape(-1, 2)
    best = np.zeros((b, 2), np.int32)
    for row in range(b):
        seqs = np.concatenate(
            [np.tile(prompt[row][None], (V * V, 1)), cands], axis=1)
        lp = torch.log_softmax(
            m.apply(v, torch.from_numpy(seqs.astype(np.int32))), -1).numpy()
        scores = (lp[np.arange(V * V), p - 1, cands[:, 0]]
                  + lp[np.arange(V * V), p, cands[:, 1]])
        best[row] = cands[scores.argmax()]
    np.testing.assert_array_equal(got[:, p:], best)


def test_beam_eos_and_return_all(trained):
    _, _, tg, tv, ids = trained("plain")
    prompt = ids[:, :8]
    out = run_beam(tg, tv, prompt, 8, beams=3, eos_id=3)
    want = np.concatenate([prompt[0], [1, 2, 3, 0, 0, 0, 0, 0]])
    np.testing.assert_array_equal(out[0], want)
    seqs, scores = run_beam(tg, tv, prompt, 4, beams=3, return_all=True)
    assert seqs.shape == (1, 3, 12) and scores.shape == (1, 3)
    assert np.all(scores[:, :-1] >= scores[:, 1:])  # sorted best-first
    np.testing.assert_array_equal(seqs[0, 0, :8], prompt[0])


def test_beam_guards():
    m = build_model("transformer_lm", vocab_size=8, d_model=16, heads=2,
                    depth=1, max_len=16)
    v = init_variables(m, 0, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(FriendlyError, match="beams"):
        run_beam(m, v, prompt, 2, beams=0)
    with pytest.raises(FriendlyError, match="vocab"):
        run_beam(m, v, prompt, 2, beams=9)
    with pytest.raises(FriendlyError, match="length_penalty"):
        run_beam(m, v, prompt, 2, length_penalty=-1.0)
    with pytest.raises(FriendlyError, match="max_new_tokens"):
        run_beam(m, v, prompt, 0)


# -- parity with JAX ---------------------------------------------------------------


def check_beam_matches_jax_bf16(trained, name):
    """The overfit LM of one cache configuration (bf16 compute), with
    EOS and a length penalty: ``return_all`` agrees with JAX's rank by
    rank within the bf16 score tolerance, the best sequences are equal,
    and the default output is ``return_all``'s first."""
    jg, jv, tg, tv, ids = trained(name)
    prompt = ids[:, :5]
    kw = dict(beams=3, eos_id=2, length_penalty=0.6)
    want = run_jax_beam(jg, jv, prompt, 9, return_all=True, **kw)
    got = run_beam(tg, tv, prompt, 9, return_all=True, **kw)
    assert_beams_agree(want, got, BF16_BEAM_TOL)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_array_equal(run_beam(tg, tv, prompt, 9, **kw),
                                  got[0][:, 0])


@pytest.mark.parametrize("name", ["plain", "window"])
def test_beam_matches_jax_bf16(trained, name):
    check_beam_matches_jax_bf16(trained, name)


@pytest.fixture(scope="module")
def f32_window():
    """A random-weight window model with every block computing in
    float32 on both sides (beams spread over the vocabulary)."""
    cfg = dict(vocab_size=16, d_model=32, heads=2, depth=2, max_len=32,
               window=6, kv_heads=1)
    jg = jax_build_model("transformer_lm", **cfg)
    jv = jg.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    jg.blocks = [(n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype")
                  else m) for n, m in jg.blocks]
    tg = build_model("transformer_lm", **cfg)
    for _, mod in tg.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    tv = load_flax_variables(tg, jv, device="cpu")
    prompt = np.random.default_rng(3).integers(0, 16, size=(2, 5)).astype(
        np.int32)
    return jg, jv, tg, tv, prompt


@pytest.mark.parametrize("beams,eos_id,length_penalty", [
    (3, None, 0.0), (8, 5, 0.6),
])
def test_beam_matches_jax_f32_rolled(f32_window, beams, eos_id,
                                     length_penalty):
    """float32 compute over the rolled window cache (9 new tokens past a
    6-token window): ``return_all`` within 1e-4 of JAX's, rank by rank,
    and the best sequences equal."""
    jg, jv, tg, tv, prompt = f32_window
    kw = dict(beams=beams, eos_id=eos_id, length_penalty=length_penalty)
    want = run_jax_beam(jg, jv, prompt, 9, return_all=True, **kw)
    got = run_beam(tg, tv, prompt, 9, return_all=True, **kw)
    assert_beams_agree(want, got, F32_TOL)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    assert np.all(got[1][:, :-1] >= got[1][:, 1:])


# -- the tie order and the cache reorder --------------------------------------------


def test_top_k_stable_breaks_ties_to_the_lower_index():
    """``lax.top_k``'s order on rows full of ties, -inf ties included
    (the candidates of finished beams): the same values and indices."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(6, 40)).astype(np.float32)
    x[:3, ::3] = -np.inf
    x[3] = -np.inf
    x[3, 17] = 0.0
    for k in (1, 5, 12, 40):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = top_k_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_reorder_cache_gives_each_beam_its_parents_kv():
    """Rows gathered by parent into NEW tensors: beam j's K/V after the
    reorder equal its parent's before it, the input stays as it was, and
    no output shares the input's storage."""
    gen = torch.Generator().manual_seed(0)
    cache = {f"block{i}": tuple(torch.randn((6, 7, 2, 4), generator=gen)
                                for _ in range(2)) for i in range(2)}
    before = {n: tuple(t.clone() for t in c) for n, c in cache.items()}
    flat = torch.tensor([2, 2, 0, 5, 5, 5])
    out = reorder_cache(cache, flat)
    for name, entry in out.items():
        for t, src, orig in zip(entry, cache[name], before[name]):
            assert t.untyped_storage().data_ptr() != \
                src.untyped_storage().data_ptr()
            torch.testing.assert_close(src, orig, rtol=0, atol=0)
            for j, parent in enumerate(flat.tolist()):
                torch.testing.assert_close(t[j], orig[parent], rtol=0,
                                           atol=0)


@pytest.mark.parametrize("name", ["plain", "window"])
def test_beam_search_reorders_each_step_to_the_parents(trained, name,
                                                       monkeypatch):
    """Inside ``beam_search`` (linear and rolled caches): after every
    step's reorder, beam j's K/V equal those of its parent row."""
    _, _, tg, tv, ids = trained(name)
    calls = []

    def spy(cache, flat):
        out = reorder_cache(cache, flat)
        # checked at once: the next step writes the new tensors in place
        calls.append(all(
            torch.equal(t[j], src[parent])
            for block, entry in out.items()
            for t, src in zip(entry, cache[block])
            for j, parent in enumerate(flat.tolist())))
        return out

    monkeypatch.setattr(generate_mod, "reorder_cache", spy)
    run_beam(tg, tv, ids[:, :5], 9, beams=3)
    assert calls == [True] * 9  # the tiling after prefill, then each step
