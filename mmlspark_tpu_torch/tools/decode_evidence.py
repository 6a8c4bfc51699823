"""Proof that KV-cache decode is right and fast on the card — the port of
the repo's ``tools/decode_tpu_evidence.py``.

Runs :func:`~mmlspark_tpu_torch.models.generate.generate` both ways — the
KV cache (the default: one prefill, then one-token steps reading the
cache through the ``flash_decode`` kernel) and the O(T²) full-recompute
oracle (``kv_cache=False``) — on ``transformer_lm`` at the JAX tool's
widths (vocab 8192, d_model 512, 8 heads, depth 8, ``attn_impl="dense"``
so that the comparison isolates the cache machinery), seeded random
weights (f32 parameters, bf16 compute, bf16 caches), batch 8, 64-token
prompts:

1. numerics: the cached prefill's last-position logits against the full
   forward (scale-normalized error <= 1e-2), and the greedy streams of
   the two paths agreeing on >= 95% of their tokens — not bit-exact: the
   weights are random, so logit gaps sit near bf16 noise and a
   reduction-order tie flip diverges every later token. Every diverging
   row is classified by the near-tie rule of ``chip_smoke.py``: the
   top-2 margin of the full forward over the cached stream where the
   rows first differ, below 6.25e-2 (bf16 logits);
2. timing: the JAX tool jits each whole ``generate`` into one program;
   here each (length, path) is one CUDA graph, captured after its first
   (eager) call and replayed. Per-token ms = (t(N=256) - t(N=64)) / 192,
   best of 3 synced trials per length, so prefill, launch and sync costs
   cancel. The record says which attention read each path launched (the
   decode kernel's launch counter over its eager call) and the dtypes.

With ``--device cpu`` the paths run eagerly on the host and nothing is
timed. Writes ``build/evidence/DECODE_GPU_EVIDENCE.json`` (``--out`` to
change it) only when :func:`check_record` finds nothing — the JAX
contract: prefill error <= 1e-2, agreement >= 0.95, on the card both
paths' t(N=256) >= t(N=64) with no noise fallback and a
``kv_vs_recompute_speedup`` >= 1.5; otherwise it prints the record and
exits 3.

Usage: python -m mmlspark_tpu_torch evidence decode [--device cpu]
[--seed N]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.models import build_model, init_variables
from mmlspark_tpu_torch.models.bridge import variables_to
from mmlspark_tpu_torch.models.generate import (
    _cached_apply,
    generate,
    init_cache,
)
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.testing.compile_guard import (
    GraphPool,
    ProgramCountingGraph,
)
from mmlspark_tpu_torch.tools import common

VOCAB, D_MODEL, HEADS, DEPTH = 8192, 512, 8, 8
BATCH, PROMPT = 8, 64
N_SHORT, N_LONG = 64, 256
TRIALS = 3
PREFILL_TOL = 1e-2
AGREEMENT_FLOOR = 0.95
SPEEDUP_FLOOR = 1.5
#: a diverging row's first differing token is a near tie when the full
#: forward's top-2 margin there is below this (bf16 logits: the
#: tolerance of tests/test_torch_model.py)
NEAR_TIE_TOL = 6.25e-2
OUT_TEMPLATE = "DECODE_{}_EVIDENCE.json"
PATHS = (("kv_cache", True), ("recompute", False))
METHOD = (
    "each (length, path) generate() call is one CUDA graph, captured "
    "after its first eager call and replayed (the counterpart of the JAX "
    "tool's whole-generate jit); per-token seconds = (t(N=256) - t(N=64))"
    " / 192, best of 3 synced trials per length — prefill, launch and "
    "sync costs cancel in the difference"
)


def _divergences(graph, variables, cached, recompute, prompt_len,
                 dev) -> list:
    """Each row where the two greedy streams differ: the first differing
    position and the full forward's top-2 margin there, over the cached
    stream."""
    out = []
    for row in np.nonzero((cached != recompute).any(axis=1))[0]:
        first = int(np.argmax(cached[row] != recompute[row]))
        ids = torch.from_numpy(cached[row:row + 1, :first].astype(np.int32))
        with torch.no_grad():
            logits = graph.apply(variables, ids.to(dev))
        top2 = logits[0, -1].float().sort().values[-2:]
        margin = float(top2[1] - top2[0])
        out.append({"row": int(row), "token": first, "margin": margin,
                    "near_tie": first >= prompt_len
                    and margin < NEAR_TIE_TOL})
    return out


def _compute_dtype(graph):
    """The dtype the model's blocks compute in."""
    return next(m.dtype for _, m in graph.blocks
                if isinstance(getattr(m, "dtype", None), torch.dtype))



def run(device=None, *, vocab: int = VOCAB, d_model: int = D_MODEL,
        heads: int = HEADS, depth: int = DEPTH, batch: int = BATCH,
        prompt: int = PROMPT, n_short: int = N_SHORT, n_long: int = N_LONG,
        trials: int = TRIALS, seed: int = 0, variables=None) -> dict:
    """The record. ``seed`` draws the prompts (``default_rng(seed)``, the
    JAX tool's ``default_rng(0)`` at 0) and, unless ``variables`` are
    given, the weights (``init_variables(graph, seed)``). ``variables``
    are the port's weights of this model, e.g. the JAX tool's flax
    weights through ``models.bridge.load_flax_variables``."""
    dev = default_device(device)
    on_card = dev.type == "cuda"
    graph = build_model("transformer_lm", vocab_size=vocab, d_model=d_model,
                        heads=heads, depth=depth, max_len=prompt + n_long,
                        attn_impl="dense")
    weights = "given" if variables is not None else f"init_variables seed " \
        f"{seed}"
    if variables is None:
        variables = init_variables(graph, seed, device=dev)
    else:
        variables = variables_to(variables, dev)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, size=(batch, prompt)).astype(np.int32)).to(dev)
    record = {
        "tool": "decode_evidence",
        "device": common.device_record(dev),
        "model": {"vocab": vocab, "d_model": d_model, "heads": heads,
                  "depth": depth, "batch": batch, "prompt": prompt,
                  "attn_impl": "dense", "param_dtype": "float32",
                  "compute_dtype": str(_compute_dtype(graph)).replace(
                      "torch.", ""), "cache_dtype": "bfloat16"},
        "lengths": {"n_short": n_short, "n_long": n_long},
        "seed": seed,
        "weights": weights,
        "method": METHOD,
    }

    # -- numerics: the prefill boundary ---------------------------------
    cache = init_cache(graph, variables, batch, prompt + n_short)
    with torch.no_grad():
        cached_logits, _ = _cached_apply(graph, variables, ids, cache, 0)
        full_logits = graph.apply(variables, ids)
    prefill_err = common.scaled_err(cached_logits[:, -1], full_logits[:, -1])
    del cache, cached_logits, full_logits

    # -- one program a (length, path); its first call eager --------------
    pool = GraphPool()
    programs = {
        (n, kv): ProgramCountingGraph(
            lambda v, p, n=n, kv=kv: generate(graph, v, p, n, kv_cache=kv,
                                              device=dev),
            state_argnums=(0,), pool=pool, label=f"generate.{n}.{kv}")
        for n in (n_short, n_long) for kv in (True, False)}
    streams, reads = {}, {}
    for name, kv in PATHS:
        before = {c: getattr(fa, c) for c in fa.COUNTERS}
        out = programs[(n_short, kv)](variables, ids)
        streams[name] = out.cpu().numpy()
        launched = {c: getattr(fa, c) - n for c, n in before.items()
                    if getattr(fa, c) - n}
        reads[name] = {
            "launch_counts": launched,
            "attention_read": (
                "flash_decode kernel (csrc/flash_decode.cu)"
                if launched.get("launches") else
                "dense_attention over the whole buffer" if not kv else
                "flash_decode_reference (plain, on the host)")}
    agree = float((streams["kv_cache"] == streams["recompute"]).mean())
    diverged = _divergences(graph, variables, streams["kv_cache"],
                            streams["recompute"], prompt, dev)
    record["numerics"] = {
        "prefill_logits_scaled_err": prefill_err,
        "greedy_token_agreement": agree,
        "n_tokens_compared": int(streams["kv_cache"].size),
        "divergences": diverged,
        "near_ties": sum(d["near_tie"] for d in diverged),
        "near_tie_tolerance": NEAR_TIE_TOL,
        "note": "random-init weights; exact equality on trained models is "
                "asserted by tests/test_torch_generate.py",
    }
    record["paths"] = reads

    # -- timing: replayed programs --------------------------------------
    if not on_card:
        record["timing"] = "not measured"
        return record
    timing, per_tok = {}, {}
    for name, kv in PATHS:
        short, long_ = programs[(n_short, kv)], programs[(n_long, kv)]
        for _ in range(2):  # the long program's eager call, then capture
            long_(variables, ids)
        short(variables, ids)
        t_short = common.best_seconds(lambda: short(variables, ids), trials,
                                      dev)
        t_long = common.best_seconds(lambda: long_(variables, ids), trials,
                                     dev)
        delta = t_long - t_short
        fallback = delta <= 0  # noise swallowed the length delta
        per = t_long / n_long if fallback else delta / (n_long - n_short)
        per_tok[name] = per
        timing[name] = {
            "t_n64_s": t_short, "t_n256_s": t_long,
            "per_token_ms": per * 1e3,
            "tokens_per_sec_per_seq": 1.0 / per,
            "tokens_per_sec_batch": batch / per,
            "noise_fallback": fallback,
            "capture_s": short.capture_seconds + long_.capture_seconds,
        }
    timing["kv_vs_recompute_speedup"] = (per_tok["recompute"]
                                         / per_tok["kv_cache"])
    timing["graph_pool_bytes"] = pool.reserved_bytes()
    record["timing"] = timing
    return record


def check_record(record: dict) -> list[str]:
    """The JAX tool's contract (``tests/test_decode_evidence.py``):
    prefill logits within 1e-2 scaled, greedy agreement >= 0.95; on the
    card the cached path read the decode kernel at every step, each
    path's t(N=256) >= t(N=64) with no noise fallback and a speedup >=
    1.5; off the card nothing timed."""
    problems = []
    num = record.get("numerics", {})
    err = num.get("prefill_logits_scaled_err")
    if err is None or not err <= PREFILL_TOL:
        problems.append(f"prefill logits scaled error {err} > {PREFILL_TOL}")
    agree = num.get("greedy_token_agreement")
    if agree is None or not agree >= AGREEMENT_FLOOR:
        ties = num.get("near_ties")
        problems.append(
            f"greedy token agreement {agree} < {AGREEMENT_FLOOR} "
            f"({ties} of {len(num.get('divergences', []))} diverging rows "
            "first differ at a near tie)")
    timing = record.get("timing")
    if not common.on_card(record):
        if timing != "not measured":
            problems.append("timing off the card must read 'not measured'")
        return problems
    # the cached path reads its cache through the kernel at every layer
    # of every one-token step (N - 1 of them after the prefill)
    want = record.get("model", {}).get("depth", 1) * (
        record.get("lengths", {}).get("n_short", 2) - 1)
    reads = record.get("paths", {})
    if not reads.get("kv_cache", {}).get("launch_counts", {}).get(
            "launches", 0) >= want:
        problems.append("the cached path did not read its cache through "
                        "the flash_decode kernel at every step")
    if reads.get("recompute", {}).get("launch_counts"):
        problems.append("the recompute oracle launched an attention kernel "
                        "(attn_impl='dense' reads none)")
    if not isinstance(timing, dict):
        return problems + ["no timing on the card"]
    for name, _ in PATHS:
        t = timing.get(name, {})
        if t.get("noise_fallback", True):
            problems.append(f"{name}: t(N=256) - t(N=64) <= 0 (timing "
                            "noise swallowed the length delta)")
        if not t.get("t_n256_s", 0) >= t.get("t_n64_s", float("inf")):
            problems.append(f"{name}: t_n256 ({t.get('t_n256_s')} s) < t_n64 "
                            f"({t.get('t_n64_s')} s)")
        if not common.positive(t.get("per_token_ms")):
            problems.append(f"{name}: no per-token time")
    speedup = timing.get("kv_vs_recompute_speedup")
    if speedup is None or not speedup >= SPEEDUP_FLOOR:
        problems.append(f"kv_vs_recompute_speedup {speedup} < "
                        f"{SPEEDUP_FLOOR}")
    return problems


def main(argv: list[str] | None = None) -> int:
    p = common.parser("evidence decode", __doc__)
    p.add_argument("--seed", type=int, default=0,
                   help="the seed of the weights and the prompts")
    args = p.parse_args(argv)
    dev = default_device(args.device)
    record = run(dev, seed=args.seed)
    return common.finish(record, check_record(record),
                         args.out or common.default_out(OUT_TEMPLATE, dev))


if __name__ == "__main__":
    sys.exit(main())
