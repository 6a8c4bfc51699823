"""Synthetic-traffic serving demo — the port of
``mmlspark_tpu/serve/demo.py`` on its single-engine path, with the
dense, paged (+ prefix cache) and int8 KV pools.

Drives a ``ServeEngine`` over a random-init ``transformer_lm`` with a
deterministic staggered arrival schedule (a few submits per tick, prompt
lengths drawn from a seeded rng) and returns the engine's metrics dict
under the JAX demo's key names. Replicas, fleets, multi-model engines,
fault injection, SLOs and the telemetry bundle wait for later slices
(ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.env import default_device


def run_demo(*, slots: int = 4, n_requests: int = 8,
             max_new_tokens: int = 8, arrivals_per_tick: int = 2,
             vocab: int = 64, d_model: int = 32, heads: int = 2,
             depth: int = 2, cache_len: int = 64, seed: int = 0,
             decode_block: int | None = None, paged: bool = False,
             page_size: int | None = None, prefix_cache: bool = False,
             kv_dtype: str = "bf16", device=None) -> dict:
    """Run the synthetic-traffic loop on ``device`` (``cuda`` unless the
    caller asks for ``"cpu"``); returns the metrics dict. ``paged``/
    ``page_size``/``prefix_cache`` select the paged KV pool and
    ``kv_dtype="int8"`` the int8 KV mode, as the JAX demo's flags do."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.serve.engine import ServeEngine

    dev = default_device(device)
    graph = build_model(
        "transformer_lm", vocab_size=vocab, d_model=d_model, heads=heads,
        depth=depth, max_len=cache_len, attn_impl="dense",
    )
    variables = init_variables(graph, seed, device=dev)
    engine = ServeEngine(
        graph, variables, slots=slots, cache_len=cache_len,
        max_queue=max(n_requests, 1), device=dev, paged=paged,
        page_size=page_size, prefix_cache=prefix_cache, kv_dtype=kv_dtype,
        **({} if decode_block is None else {"decode_block": decode_block}),
    )
    rng = np.random.default_rng(seed)
    lo, hi = 4, max(5, min(16, cache_len - max_new_tokens))
    lengths = rng.integers(lo, hi + 1, size=n_requests)
    prompts = [rng.integers(0, vocab, size=int(p)) for p in lengths]

    submitted = 0
    while submitted < n_requests or engine.busy:
        for _ in range(arrivals_per_tick):
            if submitted < n_requests:
                engine.submit(prompts[submitted], max_new_tokens)
                submitted += 1
        engine.step()

    out = engine.metrics.to_dict()
    out.update(
        prefill_bucket_count=engine.num_prefill_buckets,
        n_requests=n_requests,
        arrivals_per_tick=arrivals_per_tick,
        max_new_tokens=max_new_tokens,
        cache_len=cache_len,
        model_config={"vocab": vocab, "d_model": d_model, "heads": heads,
                      "depth": depth},
        device=str(dev),
    )
    return out
