"""The port's sampling against the JAX package's ``generate()``: the
top-k and nucleus filter, the draws, the sampled distribution and the
generator guards (mirroring the sampling cases of
``tests/test_generate.py``).

JAX's threefry draws cannot be reproduced by a ``torch.Generator``, so
sampling is held to JAX through its filter (:func:`filter_logits` equal
to a numpy transcription of the JAX code, ties included) and its
distribution: on a 512-row batch every token either side draws lies in
the other side's kept set, and the total-variation distance between the
two first-token histograms is at most 0.06 (two 512-draw histograms of
one 3-token distribution differ by about 0.035 on average).
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
from mmlspark_tpu_torch.models.generate import filter_logits, sample_next

TINY = dict(vocab_size=8, d_model=32, heads=2, depth=2, max_len=32)


@pytest.fixture(scope="module")
def lm():
    """The JAX overfit periodic LM, bridged: (port graph, variables,
    ids)."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=60, seq=16, period=4)
    tg = build_model("transformer_lm", **TINY)
    return tg, load_flax_variables(tg, jv, device="cpu"), np.array(ids)


def _gen(tg, tv, prompt, n, **kw):
    return generate(tg, tv, torch.from_numpy(np.asarray(prompt)), n,
                    device="cpu", **kw).numpy()


def _rng(seed):
    return torch.Generator().manual_seed(seed)


def test_top_k_and_top_p_sampling(lm):
    """top_k=1 collapses sampling to greedy; a tight nucleus on the
    peaked model does too; loose filters reproduce the unfiltered stream
    draw for draw; guards reject meaningless configs."""
    tg, tv, ids = lm
    prompt = ids[:, :8]
    greedy = _gen(tg, tv, prompt, 8)
    k1 = _gen(tg, tv, prompt, 8, temperature=1.0, top_k=1, rng=_rng(0))
    np.testing.assert_array_equal(k1, greedy)
    p_small = _gen(tg, tv, prompt, 8, temperature=1.0, top_p=0.5,
                   rng=_rng(1))
    np.testing.assert_array_equal(p_small, greedy)
    base = _gen(tg, tv, prompt, 8, temperature=1.3, rng=_rng(2))
    loose = _gen(tg, tv, prompt, 8, temperature=1.3, top_k=8, top_p=1.0,
                 rng=_rng(2))
    np.testing.assert_array_equal(base, loose)
    with pytest.raises(FriendlyError, match="temperature"):
        _gen(tg, tv, prompt, 2, top_k=2)
    with pytest.raises(FriendlyError, match="top_k"):
        _gen(tg, tv, prompt, 2, temperature=1.0, top_k=9, rng=_rng(0))
    with pytest.raises(FriendlyError, match="top_p"):
        _gen(tg, tv, prompt, 2, temperature=1.0, top_p=1.5, rng=_rng(0))


def test_rng_must_be_a_generator_on_the_compute_device(monkeypatch):
    m = build_model("transformer_lm", vocab_size=8, d_model=16, heads=2,
                    depth=1, max_len=16)
    v = init_variables(m, 0, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(FriendlyError, match="torch.Generator"):
        _gen(m, v, prompt, 2, temperature=1.0, rng=7)

    class Elsewhere:  # a generator that reports another device
        device = torch.device("cuda", 0)

    monkeypatch.setattr(torch, "Generator", Elsewhere)
    with pytest.raises(FriendlyError, match="lives on cuda:0"):
        _gen(m, v, prompt, 2, temperature=1.0, rng=Elsewhere())


# -- the filter and the sampled distribution ------------------------------------


def _numpy_filter(logits, temperature, top_k, top_p):
    """``mmlspark_tpu/models/generate.py``'s ``pick`` filter, line for
    line in numpy (f32)."""
    logits = logits.astype(np.float32) / np.float32(temperature)
    if top_k is not None:
        kth = -np.sort(-logits, axis=-1)[..., top_k - 1:top_k]
        logits = np.where(logits < kth, -np.inf, logits).astype(np.float32)
    if top_p is not None:
        sorted_desc = -np.sort(-logits, axis=-1)
        z = np.exp(sorted_desc - sorted_desc.max(axis=-1, keepdims=True))
        probs = (z / z.sum(axis=-1, keepdims=True)).astype(np.float32)
        mass_before = np.cumsum(probs, axis=-1, dtype=np.float32) - probs
        kept = mass_before < top_p
        thresh = np.min(np.where(kept, sorted_desc, np.inf), axis=-1,
                        keepdims=True)
        logits = np.where(logits < thresh, -np.inf, logits).astype(
            np.float32)
    return logits


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, None), (0.7, None, 0.9), (1.3, 3, 0.8), (0.5, 1, 0.3),
    (1.0, 40, 1.0),
])
def test_filter_logits_matches_the_jax_filter(temperature, top_k, top_p):
    """Random logits with forced ties AT the k-th value (which top-k
    keeps, all of them) and a tied top pair: the port's filter keeps
    exactly the numpy transcription's set, with equal values."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(16, 40)) * 2).astype(np.float32)
    srt = -np.sort(-x, axis=-1)
    kth = srt[:, (top_k or 1) - 1]
    for r in range(8):  # three of the lowest entries tie the k-th value
        x[r, np.argsort(x[r])[:3]] = kth[r]
    x[8:, 5] = srt[8:, 0]  # the top value twice
    got = filter_logits(torch.from_numpy(x), temperature, top_k,
                        top_p).numpy()
    want = _numpy_filter(x, temperature, top_k, top_p)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got, want)
    if top_k is not None and top_p is None:
        assert (np.isfinite(got).sum(axis=1)[:8] >= top_k + 3).all()


def test_sample_next_draws_only_kept_tokens_once_per_call():
    logits = torch.full((4, 10), float("-inf"))
    logits[:, [2, 7]] = 0.0
    gen = _rng(0)
    draws = torch.stack([sample_next(logits, gen) for _ in range(200)])
    assert set(draws.unique().tolist()) == {2, 7}
    state = _rng(1)
    sample_next(logits, state)
    after_one = state.get_state()
    twin = _rng(1)
    torch.rand((4, 10), generator=twin)
    assert torch.equal(after_one, twin.get_state())


def test_sampled_first_token_distribution_matches_jax():
    """One prompt tiled to 512 rows, one new token at temperature 1.3,
    top_k 3 and top_p 0.8, on a random-weight model (a spread
    distribution): every token either side draws lies in the other
    side's kept set (the filter recomputed from that side's logits), and
    the two histograms lie within 0.06 in total variation."""
    cfg = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)
    jg = jax_build_model("transformer_lm", **cfg)
    jv = jg.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    tg = build_model("transformer_lm", **cfg)
    tv = load_flax_variables(tg, jv, device="cpu")
    prompt = np.tile(np.arange(1, 9, dtype=np.int32)[None], (512, 1))
    kw = dict(temperature=1.3, top_k=3, top_p=0.8)
    jax_tok = np.asarray(jax.jit(partial(jax_generate, jg, max_new_tokens=1,
                                         **kw))(
        jv, jnp.asarray(prompt), rng=jax.random.PRNGKey(0)))[:, -1]
    port_tok = _gen(tg, tv, prompt, 1, rng=_rng(0), **kw)[:, -1]
    jax_logits = np.asarray(jg.apply(jv, jnp.asarray(prompt[:1])))[0, -1]
    port_logits = tg.apply(tv, torch.from_numpy(prompt[:1]))[0, -1]
    jax_kept = set(np.flatnonzero(np.isfinite(
        _numpy_filter(jax_logits[None], **kw))))
    port_kept = set(np.flatnonzero(np.isfinite(
        filter_logits(port_logits[None], **kw).numpy())))
    assert 2 <= len(port_kept) <= 3
    assert set(port_tok.tolist()) <= jax_kept
    assert set(jax_tok.tolist()) <= port_kept
    tv_dist = 0.5 * np.abs(np.bincount(jax_tok, minlength=64)
                           - np.bincount(port_tok, minlength=64)).sum() / 512
    assert tv_dist <= 0.06, tv_dist
