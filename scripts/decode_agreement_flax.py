#!/usr/bin/env python3
"""Hold the port's decode proof to the JAX tool's own streams on the same
weights, on the CPU.

    python3 scripts/decode_agreement_flax.py [--threads N] [--out PATH]

The JAX package's ``tools/decode_tpu_evidence.py`` draws flax weights for
its model (``PRNGKey(0)``; vocab 8192, d_model 512, 8 heads, depth 8,
``attn_impl="dense"``) and 8 prompts of 64 tokens from
``default_rng(0)``, and gates greedy agreement >= 0.95 between the cached
``generate`` and its ``kv_cache=False`` oracle over 64 new tokens. This
script draws those weights and prompts once, then:

- runs the JAX tool's two streams (each ``generate`` jitted) and, for each
  row where they differ, the first differing position and the top-2
  margin of the JAX full forward over the cached stream there;
- runs the port's proof (``mmlspark_tpu_torch/tools/decode_evidence.run``
  on the CPU) on the same weights bridged by
  ``models.bridge.load_flax_variables`` and the same prompts, and the
  port's two streams of that proof (``generate`` cached and not);
- compares the port's cached stream with JAX's cached stream (and the two
  oracles) row by row: where they first differ, and both frameworks'
  top-2 margins there.

A position is a near tie when the margin is below 6.25e-2 (bf16 logits,
the port's ``NEAR_TIE_TOL``). Prints one JSON record (and writes it to
``--out`` when given). Needs both packages, so it runs on the CPU of a
machine with JAX; it is not part of the suite (minutes of full-width
forwards).
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def first_difference(a, b) -> list:
    """Per row: the first position where ``a`` and ``b`` differ, or
    None."""
    import numpy as np

    out = []
    for row in range(a.shape[0]):
        diff = np.nonzero(a[row] != b[row])[0]
        out.append(int(diff[0]) if diff.size else None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--threads", type=int, default=4,
                   help="PyTorch's intra-op threads")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from mmlspark_tpu.models import build_model as jax_build_model
    from mmlspark_tpu.models import generate as jax_generate
    from mmlspark_tpu_torch.models import build_model, generate
    from mmlspark_tpu_torch.models.bridge import load_flax_variables
    from mmlspark_tpu_torch.tools import decode_evidence as de

    torch.set_num_threads(args.threads)
    tool = runpy.run_path(
        os.path.join(REPO, "tools", "decode_tpu_evidence.py"),
        run_name="decode_tpu_evidence")
    vocab, d_model, heads, depth = (tool[k] for k in
                                    ("VOCAB", "D_MODEL", "HEADS", "DEPTH"))
    batch, plen, n_short, n_long = (tool[k] for k in
                                    ("B", "P", "N_SHORT", "N_LONG"))
    shape = dict(vocab_size=vocab, d_model=d_model, heads=heads,
                 depth=depth, max_len=plen + n_long, attn_impl="dense")

    # -- the JAX tool's weights, prompts and streams ------------------------
    jgraph = jax_build_model("transformer_lm", **shape)
    flax_vars = jgraph.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, plen), jnp.int32))
    prompt = np.random.default_rng(0).integers(0, vocab, size=(batch, plen))
    jstreams = {
        kv: np.asarray(jax.jit(
            lambda v, pr, kv=kv: jax_generate(jgraph, v, pr, n_short,
                                              kv_cache=kv))(
            flax_vars, jnp.asarray(prompt, jnp.int32)))
        for kv in (True, False)}
    jforward = jax.jit(lambda v, ids: jgraph.apply(v, ids))

    def jax_margin(stream, row, pos) -> float:
        logits = np.asarray(jforward(flax_vars, jnp.asarray(
            stream[row:row + 1, :pos], jnp.int32)), np.float32)[0, -1]
        top2 = np.sort(logits)[-2:]
        return float(top2[1] - top2[0])

    # -- the port's proof on the same weights --------------------------------
    graph = build_model("transformer_lm", **shape)
    variables = load_flax_variables(graph, flax_vars, device="cpu")
    record = de.run("cpu", seed=0, variables=variables)
    ids = torch.from_numpy(prompt.astype(np.int32))
    pstreams = {kv: generate(graph, variables, ids, n_short, kv_cache=kv,
                             device="cpu").numpy() for kv in (True, False)}

    def port_margin(stream, row, pos) -> float:
        ids = torch.from_numpy(stream[row:row + 1, :pos].astype(np.int32))
        with torch.no_grad():
            logits = graph.apply(variables, ids)[0, -1].float()
        top2 = logits.sort().values[-2:]
        return float(top2[1] - top2[0])

    def rows(a, b) -> list:
        out = []
        for row, pos in enumerate(first_difference(a, b)):
            if pos is None:
                continue
            jm, pm = jax_margin(a, row, pos), port_margin(a, row, pos)
            out.append({"row": row, "token": pos, "after_prompt":
                        pos >= plen, "jax_margin": jm, "port_margin": pm,
                        "near_tie": pos >= plen and min(jm, pm)
                        < de.NEAR_TIE_TOL})
        return out

    jax_div = rows(jstreams[True], jstreams[False])
    summary = {
        "model": shape, "batch": batch, "prompt": plen, "new": n_short,
        "weights": "flax init PRNGKey(0), bridged to the port",
        "prompts": "default_rng(0)",
        "near_tie_tolerance": de.NEAR_TIE_TOL,
        "jax": {"greedy_token_agreement": float(
            (jstreams[True] == jstreams[False]).mean()),
            "divergences": jax_div},
        "port": {k: record["numerics"][k] for k in (
            "greedy_token_agreement", "divergences",
            "prefill_logits_scaled_err")},
        "port_contract_problems": de.check_record(record),
        "port_cached_vs_jax_cached": rows(jstreams[True], pstreams[True]),
        "port_oracle_vs_jax_oracle": rows(jstreams[False], pstreams[False]),
        "cached_equal_tokens": float(
            (jstreams[True] == pstreams[True]).mean()),
        "oracle_equal_tokens": float(
            (jstreams[False] == pstreams[False]).mean()),
    }
    line = json.dumps(summary)
    print(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
