"""Autoregressive generation with KV-cache decode — beyond the reference.

The reference has no generative model at all (its only sequence model is
an opaque downloaded BiLSTM tagger, notebook 304). This example shows
the full decode story on the causal LM family:

1. overfit a tiny `transformer_lm` on a periodic token stream;
2. greedy-generate with the default KV-cache decode (prefill + one-token
   steps against preallocated buffers) and check the model
   CONTINUES the period — and that the O(T²) full-recompute oracle
   produces the identical tokens;
3. the same on a sliding-window + RoPE model generating far past BOTH
   its window and its trained max_len: the cache rolls (O(window)
   circular buffers, constant memory however long the generation runs)
   and RoPE extrapolates structurally;
4. nucleus/top-k sampling: temperature sampling with `top_p` truncation
   still follows the learned period on a peaked model (the nucleus
   collapses to the top token), while loose filters reproduce the
   unfiltered stream rng-for-rng;
5. beam search over the same cache: `beams=1` reproduces greedy
   exactly and wider beams return score-sorted alternatives (eos beam
   freezing is covered by the unit suite, tests/test_generate.py).

Run: python -m mmlspark_tpu_torch run e307_generation_kv_cache.py (on
the card; ``--cpu-mesh 1`` before ``run`` puts it on the CPU).
"""

import numpy as np

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.models import (
    beam_search,
    build_model,
    generate,
    init_variables,
)

VOCAB = 8
PERIOD = 4  # stream cycles 1,2,3,4,1,2,...


def _overfit(m, seq=16, steps=150):
    """Full-batch adam on the periodic stream, at 1e-2 for 150 steps from
    seed 0. The JAX example's 5e-2 for 60 steps overfits in bf16 from
    some initial weights only, and from this seed it did not learn the
    period on the card."""
    import torch
    import torch.nn.functional as F

    dev = default_device()
    v = init_variables(m, 0, device=dev)
    ids = torch.as_tensor((np.arange(seq)[None] % PERIOD) + 1,
                          dtype=torch.int32, device=dev)
    leaves = [t.requires_grad_() for block in v.values()
              for t in block.values()]
    opt = torch.optim.Adam(leaves, lr=1e-2)
    for _ in range(steps):
        lg, _ = m.apply(v, ids, train=True)
        loss = F.cross_entropy(
            lg[:, :-1].float().reshape(-1, lg.shape[-1]),
            ids[:, 1:].reshape(-1).long())
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {b: {k: t.detach() for k, t in block.items()}
            for b, block in v.items()}, ids


def main():
    import torch

    # -- 1+2. dense LM: kv-cache decode == recompute oracle ----------------
    m = build_model("transformer_lm", vocab_size=VOCAB, d_model=32,
                    heads=2, depth=2, max_len=48)
    v, ids = _overfit(m)
    dev = ids.device
    prompt = ids[:, :8]
    kv = generate(m, v, prompt, max_new_tokens=16).cpu().numpy()
    oracle = generate(m, v, prompt, max_new_tokens=16,
                      kv_cache=False).cpu().numpy()
    assert (kv == oracle).all(), "cache decode diverged from the oracle"
    want = (np.arange(24) % PERIOD) + 1
    np.testing.assert_array_equal(kv[0], want)

    # -- 3. rolled window cache: constant memory past max_len --------------
    wm = build_model("transformer_lm", vocab_size=VOCAB, d_model=32,
                     heads=2, depth=2, max_len=16, window=8,
                     pos_embedding="rope")
    wv, wids = _overfit(wm)
    LONG = 40  # 56 total >> window 8, >> trained max_len 16
    wout = generate(wm, wv, wids, max_new_tokens=LONG).cpu().numpy()
    wwant = (np.arange(16 + LONG) % PERIOD) + 1
    np.testing.assert_array_equal(wout[0], wwant)

    # -- 4. nucleus sampling on a peaked model -----------------------------
    # seeded generators on the compute device, where the sampler draws
    nucleus = generate(
        m, v, prompt, max_new_tokens=12, temperature=1.0, top_p=0.5,
        rng=torch.Generator(dev).manual_seed(3)).cpu().numpy()
    np.testing.assert_array_equal(
        nucleus[0], (np.arange(20) % PERIOD) + 1
    )
    base = generate(
        m, v, prompt, max_new_tokens=12, temperature=1.5,
        rng=torch.Generator(dev).manual_seed(4)).cpu().numpy()
    loose = generate(
        m, v, prompt, max_new_tokens=12, temperature=1.5, top_k=VOCAB,
        top_p=1.0, rng=torch.Generator(dev).manual_seed(4)).cpu().numpy()
    assert (base == loose).all()

    # -- 5. beam search over the same cache --------------------------------
    beam1 = beam_search(m, v, prompt, max_new_tokens=16,
                        beams=1).cpu().numpy()
    np.testing.assert_array_equal(beam1, kv)  # beams=1 == greedy
    seqs, scores = beam_search(m, v, prompt, max_new_tokens=8, beams=4,
                               return_all=True)
    s = scores.float().cpu().numpy()
    assert seqs.shape == (1, 4, 16) and np.all(s[:, :-1] >= s[:, 1:])

    print(
        f"OK {{'kv_matches_oracle': True, "
        f"'rolled_window_tokens': {LONG}, "
        f"'window': 8, 'nucleus_follows_period': True, "
        f"'beam1_equals_greedy': True}}"
    )


if __name__ == "__main__":
    main()
