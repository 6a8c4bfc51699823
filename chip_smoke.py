#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``csrc/``, holds each
against its plain PyTorch version, drives the serving paths and the
training path at the full width of the repo's serve model, and prints the
measured numbers.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit on error):

1. the card's name and power limit, from ``nvidia-smi``;
2. kernel vs plain, on the same CUDA tensors: ``flash_decode`` (float)
   at the serving shapes and at GQA, D=128 and strided-view cases; the
   int8 ``flash_decode``, ``paged_flash_decode`` (float pages) and its
   int8 mode at B=8, page_size 16, 32 pages a row (L=512), H=Hkv=8,
   D=64, plus Hkv=2 and D=128, live lengths {0, 1, 15, 16, 17, 300, 511,
   512}, over a shuffled page table with shared pages and trash-page
   entries past each row's live length; the attention forward and both
   backward kernels, float32 and bfloat16, at (B, S, H, Hkv, D) =
   (8, 512, 8, 8, 64) causal (the training shape), (2, 500, 8, 2, 64)
   causal with a 128 window (GQA, a padded tile), (2, 384, 8, 1, 128)
   non-causal (MQA), (1, 1, 4, 4, 64) and (2, 64, 4, 4, 256), q/k/v
   strided slices of one fused tensor and dO a strided view;
3. the engines, each a main path of its own, with every launch count
   set to 0 just before it and read just after:
   - dense bf16: ``transformer_lm(vocab_size=8192, d_model=512, heads=8,
     depth=8, max_len=512)`` with seeded random weights under
     ``ServeEngine(slots=8, cache_len=512, decode_block=32)``, 16
     requests arriving 2 a tick; every request completes, the decode
     path launched ``flash_decode`` ``depth`` times per micro-step, and
     4 streams equal the port's own ``generate()``;
   - the shared-header schedule (16 requests, 2 a tick, 64 new tokens;
     half share a 72-token header — it ends mid-page, so copy-on-extend
     fires — with 8-32-token tails, half are random 8-64-token prompts)
     through the dense bf16 engine (the streams the int8 flip rates are
     counted against), the paged engine (``paged=True, page_size=16,
     prefix_cache=True``, pages sized to the workload), and the int8
     dense and paged engines. Gates: every request completes; each
     engine's kernel launched ``depth`` times per micro-step; the paged
     engine hit the prefix cache and copied on extend, its allocator
     audit is clean after the drain, its pool holds fewer bytes than the
     dense pool, and 4 of its streams (2 prefix hits) equal
     ``generate()`` or first differ at a near tie. The int8 flip rates
     are reported, not gated;
   plus the full-width model's cached decode step on the card against
   the same step on the CPU, in float32: over a dense cache (1e-3), a
   paged float32 cache (1e-3), and int8 dense and paged caches (1e-2),
   the caches built on the CPU and copied to the card;
4. training, each run a main path with the counts set to 0 just before
   it and read just after: the same model with ``attn_impl="flash"``
   under ``SPMDTrainer`` (adam, lr 1e-3, batch 8) for 8 steps over
   seeded rows of 512 tokens that are arithmetic progressions mod the
   vocabulary (learnable), then a depth-2 GQA model with a 128 window
   and RoPE for 4 steps. Gates: every loss finite and the last below the
   first; each attention kernel launched ``depth`` times a step; no
   dense attention ran. Then one training step of the float32 model,
   card vs CPU (the plain versions), on the same weights and batch: the
   loss within 1e-4 relative, every parameter's gradient within 1e-3 of
   that leaf's largest;
5. numbers: each kernel's, its plain version's and (where one exists)
   a library call's times (CUDA events, inputs rotated through more
   memory than the 50 MB L2 so each launch reads cold), the kernel's
   bound, the engines' throughput, the training runs' step time,
   tokens/s and peak memory, and one steady decode block and one
   training step under ``torch.profiler`` (device busy share and the
   kernels that take its time).

The last line is ``{"ok": true, "device": {...}}``. float32 matrix
products and convolutions run in full float32 here: TF32 is switched off
for both, so the f32 comparisons are not loosened by it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: H100 SXM, NVIDIA's data sheet: HBM3 bandwidth, the float32 rate
#: outside the tensor cores (the decode kernels' arithmetic is f32 FMAs)
#: and the dense bf16 tensor-core rate (the attention kernels' inputs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: what the rotation of timing inputs must exceed: twice the L2 cache
ROTATE_BYTES = 2 * 50 * 2**20

SERVE_MODEL = dict(vocab_size=8192, d_model=512, heads=8, depth=8,
                   max_len=512)
SLOTS, CACHE_LEN, DECODE_BLOCK = 8, 512, 32
N_REQUESTS, MAX_NEW, ARRIVALS_PER_TICK = 16, 64, 2
N_CHECKED = 4
#: the paged engine and the shared-header schedule: a 72-token header
#: ends mid-page (72 = 4.5 pages of 16)
PAGE_SIZE, HEADER_LEN = 16, 72
#: the bf16 logit tolerance of tests/test_torch_model.py: a stream may
#: first differ from generate() only where the top-2 margin is below it
BF16_LOGIT_TOL = 6.25e-2
#: the launch counters of ops/flash_attention.py, one per kernel
COUNTERS = ("launches", "q8_launches", "paged_launches",
            "paged_q8_launches", "fwd_launches", "bwd_kv_launches",
            "bwd_q_launches")
#: where the main path runs; a CPU rehearsal of the script sets "cpu"
DEVICE = "cuda"

#: (B, L, H, Hkv, D, lengths or None for the slice's ragged set, strided)
KERNEL_CASES = [
    ("slice", 8, 512, 8, 8, 64, None, False),
    ("gqa_hkv2", 8, 512, 8, 2, 64, None, False),
    ("mqa_hkv1", 8, 512, 8, 1, 64, None, False),
    ("d128", 8, 512, 8, 4, 128, None, False),
    ("strided_views", 4, 96, 8, 8, 64, [0, 5, 64, 96], True),
]
SLICE_LENGTHS = [0, 1, 127, 128, 129, 300, 511, 512]
#: (name, B, H, Hkv, D) for the int8 and paged kernel checks, with
#: page_size PAGE_SIZE and MAX_PAGES pages a row (L = 512)
NEW_KERNEL_CASES = [
    ("slice", 8, 8, 8, 64),
    ("gqa_hkv2", 8, 8, 2, 64),
    ("d128", 8, 8, 8, 128),
]
MAX_PAGES = 32
PAGED_LENGTHS = [0, 1, 15, 16, 17, 300, 511, 512]
#: f32: both versions accumulate in f32 and differ only in the order of
#: the sums. bf16: both outputs round to bf16 at the end, and one bf16
#: ulp at |out| < 2 is 2^-7 = 0.0078
TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-2}
#: (name, B, S, H, Hkv, D, causal, window) of the attention kernel checks
ATTN_CASES = [
    ("slice", 8, 512, 8, 8, 64, True, None),
    ("gqa_window_padded", 2, 500, 8, 2, 64, True, 128),
    ("mqa_d128_noncausal", 2, 384, 8, 1, 128, False, None),
    ("one_token", 1, 1, 4, 4, 64, True, None),
    ("d256", 2, 64, 4, 4, 256, True, None),
]
#: (out, LSE, gradients): out as the decode kernels; the LSE is f32 on
#: both sides; a gradient's max abs error over the plain value's max abs
#: (or over 1 where that is smaller: dq and dk of a single token are 0 in
#: exact arithmetic and hold only rounding noise) — f32 sums in other
#: orders (1e-4); in bf16 P and dS round at the same places, but the
#: kernel sums a GQA group's dK/dV in f32 and the plain version rounds
#: each head's first (1e-2)
ATTN_TOLERANCE = {"float32": (1e-5, 1e-5, 1e-4),
                  "bfloat16": (1e-2, 1e-5, 1e-2)}
#: the training runs: the serve model with the flash attention kernels,
#: then a cheaper depth-2 model with GQA, a window and RoPE
TRAIN_MODEL = dict(SERVE_MODEL, attn_impl="flash")
SMALL_TRAIN_MODEL = dict(SERVE_MODEL, depth=2, kv_heads=2, window=128,
                         pos_embedding="rope", attn_impl="flash")
TRAIN_BATCH, TRAIN_STEPS, SMALL_TRAIN_STEPS = 8, 8, 4


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    from mmlspark_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    libs = kernel_build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s: {sorted(libs)}")
    for name, path in libs.items():
        report = path.with_name(path.name + ".log")
        if report.is_file():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"{name}: {line.strip()}")
    return libs


def kernel_inputs(b, L, h, hk, d, dtype, strided, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(DEVICE)

    if not strided:
        return normal(b, 1, h, d), normal(b, L, hk, d), normal(b, L, hk, d)
    # q as the model slices it out of a fused qkv projection, K/V as
    # every other slot of a wider pool: non-contiguous in every dim but
    # the last
    qkv = normal(b, 1, h + 2 * hk, d)
    pool_k, pool_v = normal(2 * b, L, hk, d), normal(2 * b, L, hk, d)
    return qkv[:, :, :h], pool_k[::2], pool_v[::2]


def int8_kv(shape, n_scales, gen):
    """int8 K/V over the whole range, and positive f32 scales that
    dequantize them to about [-4, 4] (an amax of about 3 with the pools'
    1.5x headroom)."""
    import torch

    vals = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    scales = torch.rand(n_scales, generator=gen) * 0.01 + 0.02
    return vals.to(DEVICE), scales.to(DEVICE)


def shuffled_page_table(b, lengths, gen):
    """(num_pages, page table on the device): distinct pages for every
    live logical page in shuffled order, rows 1-2 and 3-4 sharing their
    first page, and the trash page 0 past each row's live length."""
    import torch

    num_pages = b * MAX_PAGES + 1
    perm = (torch.randperm(num_pages - 1, generator=gen) + 1).tolist()
    pt = torch.zeros((b, MAX_PAGES), dtype=torch.int32)
    for row, n in enumerate(lengths):
        for j in range(-(-min(n, MAX_PAGES * PAGE_SIZE) // PAGE_SIZE)):
            pt[row, j] = perm.pop()
    pt[2, 0], pt[4, 0] = pt[1, 0], pt[3, 0]
    return num_pages, pt.to(DEVICE)


def compare(errors: dict, key: str, got, want, lengths) -> None:
    """Hold a kernel's output to its plain version's: within the
    tolerance of the query's dtype, and exact zeros for length-0 rows."""
    import torch

    torch.cuda.synchronize()
    dtype = str(got.dtype).split(".")[1]
    err = (got.float() - want.float()).abs().max().item()
    tol = TOLERANCE[dtype]
    errors[key] = err
    log(f"kernel vs plain {key}: max abs err {err:.3g} (tolerance {tol})")
    if got.shape != want.shape or got.dtype != want.dtype or not err <= tol:
        raise AssertionError(f"{key}: max abs err {err} > {tol}")
    for row, n in enumerate(lengths):
        if n == 0 and got[row].abs().max().item() != 0.0:
            raise AssertionError(f"{key}: length-0 row {row} is not all "
                                 "zeros")


def check_kernels() -> dict:
    import torch

    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_decode,
        flash_decode_reference,
        paged_flash_decode,
        paged_flash_decode_reference,
    )

    errors = {}
    for i, (name, b, L, h, hk, d, lengths, strided) in enumerate(
            KERNEL_CASES):
        lengths = SLICE_LENGTHS if lengths is None else lengths
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = kernel_inputs(b, L, h, hk, d, dtype, strided, seed=i)
            got = flash_decode(q, k, v, lens)
            compare(errors, f"{name}/{str(dtype).split('.')[1]}", got,
                    flash_decode_reference(q, k, v, lens), lengths)

    L = MAX_PAGES * PAGE_SIZE
    lens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=DEVICE)
    for i, (name, b, h, hk, d) in enumerate(NEW_KERNEL_CASES):
        gen = torch.Generator().manual_seed(50 + i)
        num_pages, pt = shuffled_page_table(b, PAGED_LENGTHS, gen)
        k8, ks = int8_kv((b, L, hk, d), (b, hk), gen)
        v8, vs = int8_kv((b, L, hk, d), (b, hk), gen)
        page_shape = (num_pages, hk, PAGE_SIZE, d)
        kp8, pks = int8_kv(page_shape, (num_pages, hk), gen)
        vp8, pvs = int8_kv(page_shape, (num_pages, hk), gen)
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[1]
            q = torch.randn((b, 1, h, d), generator=gen).to(dtype).to(DEVICE)
            kp, vp = (torch.randn(page_shape, generator=gen).to(dtype)
                      .to(DEVICE) for _ in range(2))
            q8 = dict(k_scale=ks, v_scale=vs)
            compare(errors, f"q8_{name}/{tag}",
                    flash_decode(q, k8, v8, lens, **q8),
                    flash_decode_reference(q, k8, v8, lens, **q8),
                    PAGED_LENGTHS)
            compare(errors, f"paged_{name}/{tag}",
                    paged_flash_decode(q, kp, vp, lens, pt),
                    paged_flash_decode_reference(q, kp, vp, lens, pt),
                    PAGED_LENGTHS)
            pq8 = dict(k_scale=pks, v_scale=pvs)
            compare(errors, f"paged_q8_{name}/{tag}",
                    paged_flash_decode(q, kp8, vp8, lens, pt, **pq8),
                    paged_flash_decode_reference(q, kp8, vp8, lens, pt,
                                                 **pq8),
                    PAGED_LENGTHS)
    return errors


def attention_inputs(b, s, h, hk, d, dtype, seed):
    """q, k, v as the model slices them out of one fused (B, S, H + 2Hkv,
    D) projection, and dO as every other head of a wider tensor: all
    strided, last dims contiguous."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, s, h + 2 * hk, d), generator=gen).to(dtype)
    wide = torch.randn((b, s, 2 * h, d), generator=gen).to(dtype)
    qkv, wide = qkv.to(DEVICE), wide.to(DEVICE)
    return (qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:],
            wide[:, :, ::2])


def check_attention_kernels() -> dict:
    """The forward kernel (out, LSE) and both backward kernels (dq; dk,
    dv), each against its plain version on the same CUDA tensors; the
    backward kernels read the plain forward's (out, lse), so each is held
    to its own plain version alone."""
    import torch

    from mmlspark_tpu_torch.ops import flash_attention as fa

    errors = {}
    for i, (name, b, s, h, hk, d, causal, window) in enumerate(ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}/{str(dtype).split('.')[1]}"
            tol_out, tol_lse, tol_grad = ATTN_TOLERANCE[tag.split("/")[1]]
            q, k, v, g = attention_inputs(b, s, h, hk, d, dtype, seed=70 + i)
            kw = dict(causal=causal, window=window, scale=d ** -0.5)
            out, lse = fa.flash_attention_forward(q, k, v, **kw)
            want_out, want_lse = fa.flash_attention_reference(q, k, v, **kw)
            grads = fa.flash_attention_backward(q, k, v, want_out, want_lse,
                                                g, **kw)
            want = fa.flash_attention_backward_reference(
                q, k, v, want_out, want_lse, g, **kw)
            torch.cuda.synchronize()
            err = {"out": (out.float() - want_out.float()).abs().max().item(),
                   "lse": (lse - want_lse).abs().max().item()}
            for gname, got, ref in zip(("dq", "dk", "dv"), grads, want):
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    raise AssertionError(f"attention {tag} {gname}: "
                                         f"{got.shape}/{got.dtype}")
                diff = (got.float() - ref.float()).abs().max().item()
                err[gname + "_abs"] = diff
                err[gname] = diff / max(ref.float().abs().max().item(),
                                        1.0)
            errors[tag] = err
            log(f"attention kernels vs plain {tag}: {err}")
            bad = [key for key, limit in (("out", tol_out), ("lse", tol_lse),
                                          ("dq", tol_grad), ("dk", tol_grad),
                                          ("dv", tol_grad))
                   if not err[key] <= limit]
            if out.shape != q.shape or out.dtype != q.dtype or bad:
                raise AssertionError(f"attention {tag}: {bad} past "
                                     f"{ATTN_TOLERANCE}: {err}")
    return errors


# -- the engines ---------------------------------------------------------------


def random_schedule() -> list:
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(8, 65, size=N_REQUESTS)
    vocab = SERVE_MODEL["vocab_size"]
    return [rng.integers(0, vocab, size=int(n)) for n in prompt_lens]


def header_schedule() -> list:
    """Even requests: the 72-token header + an 8-32-token tail; odd
    requests: a random 8-64-token prompt."""
    rng = np.random.default_rng(2)
    vocab = SERVE_MODEL["vocab_size"]
    header = rng.integers(0, vocab, size=HEADER_LEN)
    prompts = []
    for i in range(N_REQUESTS):
        if i % 2 == 0:
            tail = rng.integers(0, vocab, size=int(rng.integers(8, 33)))
            prompts.append(np.concatenate([header, tail]))
        else:
            prompts.append(
                rng.integers(0, vocab, size=int(rng.integers(8, 65))))
    return prompts


def paged_num_pages() -> int:
    """Pages sized to the workload, as bench.py's paged group does: every
    slot at the longest request (header + longest tail + new tokens),
    plus slack for the trash page and the prefix entries' pages."""
    longest = HEADER_LEN + 32 + MAX_NEW
    return SLOTS * -(-longest // PAGE_SIZE) + 8


def make_engine(graph, variables, **kw):
    from mmlspark_tpu_torch.serve import ServeEngine

    return ServeEngine(graph, variables, slots=SLOTS, cache_len=CACHE_LEN,
                       decode_block=DECODE_BLOCK, max_queue=N_REQUESTS,
                       device=DEVICE, **kw)


def drive(engine, prompts) -> dict:
    """One main path: the prompts arrive 2 a tick, each asking for
    MAX_NEW tokens. Every launch count is set to 0 just before and read
    just after. Returns the results, the engine's metrics, the counts,
    the decode micro-steps and the ids of the requests that hit the
    prefix cache."""
    import torch

    import mmlspark_tpu_torch.ops.flash_attention as fa

    hits = set()
    by_prompt = {np.asarray(p, np.int32).tobytes(): i
                 for i, p in enumerate(prompts)}
    if getattr(engine.pool, "prefix_cache_enabled", False):
        # note which admissions the prefix cache served
        inner = engine._prefill

        def prefill(slot, prompt):
            before = engine.pool.prefix_hits
            out = inner(slot, prompt)
            if engine.pool.prefix_hits > before:
                hits.add(by_prompt[np.asarray(prompt, np.int32).tobytes()])
            return out

        engine._prefill = prefill
    torch.cuda.synchronize()
    for name in COUNTERS:
        setattr(fa, name, 0)
    submitted, results = 0, {}
    while submitted < len(prompts) or engine.busy:
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < len(prompts):
                engine.submit(prompts[submitted], MAX_NEW)
                submitted += 1
        for res in engine.step():
            results[res.id] = res
    torch.cuda.synchronize()
    counts = {name: getattr(fa, name) for name in COUNTERS}
    micro_steps = sum(int(t) * n
                      for t, n in engine.metrics.decode_blocks.items())
    return dict(results=results, metrics=engine.metrics.to_dict(),
                counts=counts, micro_steps=micro_steps, hits=sorted(hits))


def check_run(label: str, run: dict, counter: str) -> None:
    """Every request completed inside the vocabulary, and the decode
    path launched its kernel once per layer per micro-step."""
    depth = SERVE_MODEL["depth"]
    results = run["results"]
    if len(results) != N_REQUESTS or any(
        r.status != "completed" or r.generated != MAX_NEW
        for r in results.values()
    ):
        raise AssertionError(
            f"{label}: not every request completed: "
            + str({i: (r.status, r.generated) for i, r in results.items()})
        )
    for r in results.values():
        gen = r.tokens[r.prompt_len:]
        if gen.min() < 0 or gen.max() >= SERVE_MODEL["vocab_size"]:
            raise AssertionError(f"{label}: request {r.id}: token out of "
                                 "vocab")
    launches, steps = run["counts"][counter], run["micro_steps"]
    log(f"{label}: {N_REQUESTS} requests completed, {steps} decode "
        f"micro-steps, launch counts {run['counts']}")
    if launches < depth * steps:
        raise AssertionError(
            f"{label}: {counter} = {launches} over {steps} micro-steps of "
            f"a {depth}-layer model: the decode path did not go through "
            "the kernel"
        )


def check_streams(graph, variables, prompts, results, ids, label: str,
                  exact: bool) -> list:
    """Each checked stream equals the port's generate(); with ``exact``
    False it may instead first differ at a near tie (top-2 margin of the
    full forward below BF16_LOGIT_TOL). Returns the divergences."""
    import torch

    from mmlspark_tpu_torch.models import generate

    diverged = []
    for rid in ids:
        want = generate(graph, variables, prompts[rid][None], MAX_NEW,
                        device=DEVICE)[0].cpu().numpy()
        got = results[int(rid)].tokens
        if np.array_equal(got, want):
            continue
        first = int(np.argmax(got != want))
        if exact or first < len(prompts[rid]):
            raise AssertionError(
                f"{label} request {rid}: stream differs from generate() "
                f"at token {first} (prompt length {len(prompts[rid])})"
            )
        ids_t = torch.from_numpy(want[None, :first].astype(np.int32))
        logits = graph.apply(variables, ids_t.to(DEVICE))[0, -1].float()
        top2 = logits.sort().values[-2:]
        margin = float(top2[1] - top2[0])
        if not margin < BF16_LOGIT_TOL:
            raise AssertionError(
                f"{label} request {rid}: stream differs from generate() at "
                f"token {first}, where the top-2 margin is {margin}"
            )
        diverged.append({"request": int(rid), "token": first,
                         "margin": margin})
    log(f"{label}: {len(ids)} streams equal generate() or first differ at "
        f"a near tie: {diverged}")
    return diverged


def flip_rate(want: dict, got: dict) -> float:
    """Share of generated tokens that differ, request by request."""
    flips = total = 0
    for rid, w in want.items():
        a, b = w.tokens[w.prompt_len:], got[rid].tokens[w.prompt_len:]
        n = min(len(a), len(b))
        flips += int(np.sum(a[:n] != b[:n])) + abs(len(a) - len(b))
        total += max(len(a), len(b))
    return flips / max(total, 1)


def check_engine(graph, variables) -> dict:
    """The dense bf16 engine on the random schedule (the first slice's
    main path)."""
    prompts = random_schedule()
    # warm the CUDA libraries up on a throwaway engine, outside the runs
    warm = make_engine(graph, variables)
    warm.submit(prompts[0], 4)
    warm.run()
    del warm

    run = drive(make_engine(graph, variables), prompts)
    check_run("dense bf16", run, "launches")
    ids = np.linspace(0, N_REQUESTS - 1, N_CHECKED).astype(int)
    check_streams(graph, variables, prompts, run["results"], ids,
                  "dense bf16", exact=True)
    return run


def check_header_engines(graph, variables) -> dict:
    """The shared-header schedule through the dense bf16, paged bf16
    (prefix cache), dense int8 and paged int8 (prefix cache) engines."""
    prompts = header_schedule()
    paged = dict(paged=True, page_size=PAGE_SIZE,
                 num_pages=paged_num_pages(), prefix_cache=True)
    runs, pools = {}, {}
    for label, kw, counter in (
        ("header dense bf16", {}, "launches"),
        ("header paged bf16", paged, "paged_launches"),
        ("header dense int8", dict(kv_dtype="int8"), "q8_launches"),
        ("header paged int8", dict(paged, kv_dtype="int8"),
         "paged_q8_launches"),
    ):
        engine = make_engine(graph, variables, **kw)
        runs[label] = drive(engine, prompts)
        check_run(label, runs[label], counter)
        pools[label] = engine.pool
        del engine

    dense = runs["header dense bf16"]
    for label in ("header paged bf16", "header paged int8"):
        pool, run = pools[label], runs[label]
        stats = pool.paging_stats()
        refs, mapped = pool.refcount_audit()
        entry_pages = {p for e in pool._prefix.values() for p in e.pages}
        log(f"{label}: {stats}, refcount audit {refs} = {mapped}, prefix "
            f"hits on requests {run['hits']}")
        if stats["prefix_cache_hits_total"] < 1:
            raise AssertionError(f"{label}: no prefix-cache hit")
        if stats["cow_copies_total"] < 1:
            raise AssertionError(f"{label}: no copy-on-extend")
        if refs != mapped or stats["pages_free"] != (
                pool.pages_allocatable - len(entry_pages)):
            raise AssertionError(
                f"{label}: allocator audit after the drain: refcounts "
                f"{refs}, mapped {mapped}, pages free {stats['pages_free']}"
                f" of {pool.pages_allocatable}, {len(entry_pages)} pinned "
                "by prefix entries"
            )
        run["paging"] = stats
    paged_bytes = runs["header paged bf16"]["metrics"][
        "cache_pool_bytes_per_device"]
    dense_bytes = dense["metrics"]["cache_pool_bytes_per_device"]
    if not paged_bytes < dense_bytes:
        raise AssertionError(f"paged pool {paged_bytes} bytes, dense "
                             f"{dense_bytes}")
    hits = runs["header paged bf16"]["hits"]
    if len(hits) < 2:
        raise AssertionError(f"paged bf16: prefix hits on {hits}, "
                             "wanted 2 to check")
    # the first header request (a miss), a random one, and two hits
    checked = [0, 1] + [h for h in hits if h > 1][:2]
    runs["header paged bf16"]["diverged"] = check_streams(
        graph, variables, prompts, runs["header paged bf16"]["results"],
        checked, "header paged bf16", exact=False)
    for label in runs:
        runs[label]["flip_rate_vs_dense_bf16"] = flip_rate(
            dense["results"], runs[label]["results"])
    log("flip rates against the dense bf16 streams: " + str({
        k: r["flip_rate_vs_dense_bf16"] for k, r in runs.items()}))
    return runs


# -- the full-width model, card vs CPU ------------------------------------------


def f32_graph(**kw):
    import torch

    from mmlspark_tpu_torch.models import build_model

    graph = build_model("transformer_lm", **dict(SERVE_MODEL, **kw))
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


def check_model_vs_cpu(seed: int = 1) -> float:
    """The full-width model in float32: prefill 15 tokens, then one
    decode step through the kernel on the card, against the same on the
    CPU (the plain path), on identical weights."""
    import torch

    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.models.generate import _cached_apply

    graph = f32_graph()
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, SERVE_MODEL["vocab_size"], size=(2, 16)).astype(np.int32))
    logits = {}
    for dev in ("cpu", DEVICE):
        variables = init_variables(graph, seed, device=dev)
        d = SERVE_MODEL["d_model"] // SERVE_MODEL["heads"]
        cache = {
            f"block{i}": tuple(
                torch.zeros((2, 32, SERVE_MODEL["heads"], d), device=dev)
                for _ in range(2))
            for i in range(SERVE_MODEL["depth"])
        }
        x = ids.to(dev)
        _, cache = _cached_apply(graph, variables, x[:, :15], cache, 0)
        out, _ = _cached_apply(
            graph, variables, x[:, 15:], cache,
            torch.full((2,), 15, dtype=torch.int32, device=dev), step=True,
        )
        logits[dev] = out.cpu()
    got = logits[DEVICE]
    if got.shape != (2, 1, SERVE_MODEL["vocab_size"]) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"bad decode logits: shape {got.shape}")
    err = (got - logits["cpu"]).abs().max().item()
    log(f"full-width f32 cached decode, card vs CPU: max abs err {err:.3g}")
    # f32 end to end; the two devices sum in other orders through 8
    # layers, so allow 1e-3 on logits of magnitude ~5
    if not err <= 1e-3:
        raise AssertionError(f"card vs CPU logits differ by {err}")
    return err


def pool_caches(linear: dict, gen) -> dict:
    """The serve pools' decode formats of one prefilled linear f32 cache
    per block ((2, 32, H, D), 16 live positions): paged float32 pages of
    8 through a shuffled table, the dense int8 4-tuple with per-(row, kv
    head) scales, and the paged int8 5-tuple with per-page scales."""
    import torch

    from mmlspark_tpu_torch.serve.cache_pool import (
        kv_head_scales,
        quantize_kv,
    )

    ps, max_pages = 8, 4
    b = 2
    num_pages = b * max_pages + 1
    perm = (torch.randperm(num_pages - 1, generator=gen) + 1).tolist()
    pt = torch.zeros((b, max_pages), dtype=torch.int32)
    pt[:, :2] = torch.tensor(perm[:4]).reshape(b, 2)  # 16 live: 2 pages
    formats = {"paged_f32": {}, "dense_int8": {}, "paged_int8": {}}
    for name, (ck, cv) in linear.items():
        pages, q8, pq8 = [], [], []
        for t in (ck, cv):
            store = torch.zeros((num_pages,) + (t.shape[2], ps, t.shape[3]))
            for row in range(b):
                for j in range(2):
                    store[pt[row, j]] = t[row, j * ps:(j + 1) * ps].transpose(
                        0, 1)
            pages.append(store)
            scale = kv_head_scales(t, axes=(1, 3))  # (B, H)
            q8.append((quantize_kv(t, scale[:, None, :]), scale))
            pscale = kv_head_scales(store, axes=(2, 3))  # (pages, H)
            pq8.append((torch.round(store / pscale[:, :, None, None])
                        .clamp(-127, 127).to(torch.int8), pscale))
        formats["paged_f32"][name] = (pages[0], pages[1], pt)
        formats["dense_int8"][name] = (q8[0][0], q8[1][0], q8[0][1],
                                       q8[1][1])
        formats["paged_int8"][name] = (pq8[0][0], pq8[1][0], pt, pq8[0][1],
                                       pq8[1][1])
    return formats


def check_cache_formats_vs_cpu(seed: int = 2) -> dict:
    """The full-width f32 model's decode step over the paged and int8
    caches, on the card (the paged and int8 kernels) against the CPU
    (their plain versions). The caches are built once on the CPU and
    copied. Paged f32 within 1e-3, as the dense cache; int8 within 1e-2:
    the step re-quantizes its own K/V on each device, and a value may
    land one int8 step apart."""
    import torch

    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.models.generate import _cached_apply

    graph = f32_graph()
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, SERVE_MODEL["vocab_size"], size=(2, 16)).astype(np.int32))
    d = SERVE_MODEL["d_model"] // SERVE_MODEL["heads"]
    cpu_vars = init_variables(graph, seed, device="cpu")
    linear = {
        f"block{i}": tuple(torch.zeros((2, 32, SERVE_MODEL["heads"], d))
                           for _ in range(2))
        for i in range(SERVE_MODEL["depth"])
    }
    _, linear = _cached_apply(graph, cpu_vars, ids[:, :15], linear, 0)
    formats = pool_caches(linear, torch.Generator().manual_seed(seed))
    dev_vars = init_variables(graph, seed, device=DEVICE)
    errors = {}
    for fmt, caches in formats.items():
        logits = {}
        for dev, variables in (("cpu", cpu_vars), (DEVICE, dev_vars)):
            cache = {n: tuple(t.clone().to(dev) for t in c)
                     for n, c in caches.items()}
            out, _ = _cached_apply(
                graph, variables, ids[:, 15:].to(dev), cache,
                torch.full((2,), 15, dtype=torch.int32, device=dev),
                step=True,
            )
            logits[dev] = out.cpu()
        got = logits[DEVICE]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{fmt}: non-finite decode logits")
        err = (got - logits["cpu"]).abs().max().item()
        tol = 1e-3 if fmt == "paged_f32" else 1e-2
        errors[fmt] = err
        log(f"full-width f32 decode over {fmt}, card vs CPU: max abs err "
            f"{err:.3g} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"{fmt}: card vs CPU logits differ by "
                                 f"{err}")
    return errors


# -- training ------------------------------------------------------------------


def progression_rows(n: int, seed: int):
    """n rows of max_len tokens, each an arithmetic progression mod the
    vocabulary with a random start and stride (each next token follows
    from the last two, so a model can learn it); labels are the rows
    shifted by one."""
    rng = np.random.default_rng(seed)
    vocab, seq = SERVE_MODEL["vocab_size"], SERVE_MODEL["max_len"]
    start = rng.integers(0, vocab, size=(n, 1))
    stride = rng.integers(1, 64, size=(n, 1))
    x = ((start + stride * np.arange(seq)) % vocab).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def make_trainer(graph, recorder=None):
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    return SPMDTrainer(graph, TrainConfig(
        epochs=1, batch_size=TRAIN_BATCH, learning_rate=1e-3,
        optimizer="adam", log_every=1, shuffle=True), recorder=recorder,
        device=DEVICE)


def run_training(label: str, model: dict, steps: int, seed: int):
    """One training main path: ``steps`` adam steps through
    ``SPMDTrainer``, the counts set to 0 just before and read just after,
    and every dense-attention call counted. Returns the summary and the
    trained variables."""
    import torch

    import mmlspark_tpu_torch.ops.flash_attention as fa
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.models import transformer

    graph = build_model("transformer_lm", **model)
    variables = init_variables(graph, seed, device=DEVICE)
    x, y = progression_rows(steps * TRAIN_BATCH, seed)
    trainer = make_trainer(graph)
    dense_calls = []
    dense = transformer.dense_attention

    def counted(*args, **kw):
        dense_calls.append(1)
        return dense(*args, **kw)

    transformer.dense_attention = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for name in COUNTERS:
            setattr(fa, name, 0)
        trained = trainer.train(x, y, init_variables=variables)
        torch.cuda.synchronize()
        counts = {name: getattr(fa, name) for name in COUNTERS}
    finally:
        transformer.dense_attention = dense
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in trainer.history]
    # log_every=1: the trainer syncs on each step's loss, so the gaps
    # between its step events are the steps' wall times (steps 2+)
    stamps = [e["t"] for e in trainer.recorder.events()
              if e["name"] == "step"]
    step_ms = statistics.median(
        (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    tokens = TRAIN_BATCH * SERVE_MODEL["max_len"]
    want = model["depth"] * steps
    log(f"training {label}: losses {losses}, counts {counts}, dense "
        f"attention calls {len(dense_calls)}, step {step_ms:.2f} ms")
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training {label}: losses {losses}")
    if not counts["fwd_launches"] == counts["bwd_kv_launches"] == \
            counts["bwd_q_launches"] == want:
        raise AssertionError(f"training {label}: {counts}, wanted {want} "
                             "launches of each attention kernel")
    if dense_calls:
        raise AssertionError(f"training {label}: dense attention ran "
                             f"{len(dense_calls)} times")
    return {
        "model": model, "steps": steps, "batch": TRAIN_BATCH,
        "losses": losses, "launch_counts": counts,
        "dense_attention_calls": len(dense_calls),
        "step_ms_median_steps_2_on": step_ms,
        "tokens_per_sec": tokens / (step_ms / 1e3),
        "peak_memory_bytes": peak,
    }, trained


def check_train_step_vs_cpu(seed: int = 3) -> dict:
    """One training step of the full-width float32 flash model — forward,
    loss, backward — on the card (the kernels) and on the CPU (their
    plain versions), from the same weights and the same 2 x 512 batch."""
    import torch

    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.train import masked_loss

    graph = f32_graph(attn_impl="flash")
    weights = init_variables(graph, seed, device="cpu")
    x, y = progression_rows(2, seed)
    results = {}
    for dev in ("cpu", DEVICE):
        variables = {
            b: {k: t.detach().to(dev, copy=True).requires_grad_(True)
                for k, t in leaves.items()}
            for b, leaves in weights.items()
        }
        mask = torch.ones(2, dtype=torch.bool, device=dev)
        out, _ = graph.apply(variables, torch.from_numpy(x).to(dev),
                             train=True, mask=mask)
        loss = masked_loss("softmax_xent", out,
                           torch.from_numpy(y).to(dev), mask)
        loss.backward()
        results[dev] = (loss.item(), {
            f"{b}.{k}": t.grad.cpu() for b, leaves in variables.items()
            for k, t in leaves.items()})
    (cpu_loss, cpu_grads), (loss, grads) = results["cpu"], results[DEVICE]
    loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
    grad_rel = {}
    for name, want in cpu_grads.items():
        err = (grads[name] - want).abs().max().item()
        scale = want.abs().max().item()
        grad_rel[name] = err / scale if scale else err
        if not err <= 1e-3 * scale:
            raise AssertionError(f"train step card vs CPU: {name} grads "
                                 f"differ by {err} (leaf max {scale})")
    worst = max(grad_rel, key=grad_rel.get)
    log(f"full-width f32 train step, card vs CPU: loss {loss} vs "
        f"{cpu_loss} (rel {loss_rel:.3g}), worst grad {worst} "
        f"{grad_rel[worst]:.3g} of its leaf's max")
    if not np.isfinite(loss) or not loss_rel <= 1e-4:
        raise AssertionError(f"train step loss {loss} vs CPU {cpu_loss}")
    return {"loss": loss, "cpu_loss": cpu_loss, "loss_rel_err": loss_rel,
            "worst_grad": worst, "worst_grad_rel_err": grad_rel[worst]}


def device_profile(prof, wall_ms: float) -> dict:
    """Device time, busy share and the top kernels of a profiled window."""
    import torch

    # a scheduled window's ProfilerStep annotation carries device time of
    # its own: it spans the kernels, it is not one
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "top_kernels": [
            {"name": e.key[:80], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in top
        ],
    }


def profile_train_step(trained: dict) -> dict:
    """One steady full-width training step under ``torch.profiler``,
    after the 8-step run warmed everything up: a 3-step ``train()`` from
    its weights whose recorder steps the profiler's schedule at each
    step's log event, so the active window is the third step alone (the
    trainer's set-up and the first step fall outside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from mmlspark_tpu_torch.core.telemetry import FlightRecorder
    from mmlspark_tpu_torch.models import build_model

    class Stepping(FlightRecorder):
        def record(self, name, **attrs):
            super().record(name, **attrs)
            if name == "step":
                prof.step()

    recorder = Stepping()
    trainer = make_trainer(build_model("transformer_lm", **TRAIN_MODEL),
                           recorder)
    x, y = progression_rows(3 * TRAIN_BATCH, 11)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1,
                                   repeat=1)) as prof:
        trainer.train(x, y, init_variables=trained)
    stamps = [e["t"] for e in recorder.events() if e["name"] == "step"]
    return dict(device_profile(prof, (stamps[2] - stamps[1]) * 1e3),
                batch=TRAIN_BATCH, seq=SERVE_MODEL["max_len"], step=2)


def profile_decode_block(graph, variables) -> dict:
    """Where one steady decode block's time goes: all 8 slots live, one
    T=32 block under ``torch.profiler``; the kernels' device time against
    the block's wall time gives the device's busy and idle shares."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine = make_engine(graph, variables)
    rng = np.random.default_rng(1)
    for _ in range(SLOTS):
        engine.submit(rng.integers(0, SERVE_MODEL["vocab_size"], size=32),
                      1 + 2 * DECODE_BLOCK)
    engine.step()  # admissions and a first block, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(device_profile(prof, wall_ms), block=DECODE_BLOCK,
                slots_live=SLOTS)


# -- timing ----------------------------------------------------------------------


def time_ms(fn, arg_sets, reps: int = 200) -> float:
    """Median CUDA-event time of ``fn(*args)``, rotating over
    ``arg_sets`` so consecutive launches read different memory."""
    import torch

    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    events = []
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        args = arg_sets[r % len(arg_sets)]
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


#: the timed shape of every kernel: the slice's (B=8, L=512, H=Hkv=8,
#: D=64, bf16 query) with every row half full; paged: pages of 16, 32 a
#: row
TIMED = dict(b=8, L=512, h=8, hk=8, d=64, live=256)


def kernel_row(name, source, replaces, launches, max_abs_err, kernel_ms,
               plain_ms, library_ms, n_bytes, n_flops, flops_per_s, shape,
               **notes):
    """One row of the ``kernels`` line; the bound is the larger of the
    bytes over the card's memory rate and the operations over its peak
    rate for the kernel's arithmetic."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / flops_per_s * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        **notes,
        "shape": shape,
        "bytes": n_bytes,
        "flops": n_flops,
    }


def decode_row(name, source, replaces, launches, max_abs_err, kernel_ms,
               plain_ms, library_ms, n_bytes, kv_dtype, library=None):
    """A decode kernel's row at the TIMED shape: q.k and p.v, 2 flops a
    multiply-add, at the f32 rate (the kernels compute in f32)."""
    t = TIMED
    return kernel_row(
        name, source, replaces, launches, max_abs_err, kernel_ms, plain_ms,
        library_ms, n_bytes, 4 * t["b"] * t["live"] * t["h"] * t["d"],
        F32_FLOPS_PER_S, dict(t, dtype="bfloat16", kv_dtype=kv_dtype),
        library=library)


def io_bytes(kv_elem: int) -> int:
    """Each live K and V row once, q in and out, the lengths."""
    t = TIMED
    return (2 * t["b"] * t["live"] * t["hk"] * t["d"] * kv_elem
            + 2 * t["b"] * t["h"] * t["d"] * 2 + t["b"] * 4)


def measure_kernels(errors: dict, launches: dict) -> list:
    """The four kernels at the timed shape: kernel, plain version and,
    where one PyTorch call computes the same function, that call."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_decode,
        flash_decode_reference,
        paged_flash_decode,
        paged_flash_decode_reference,
    )

    t = TIMED
    b, L, h, hk, d, live = (t[k] for k in ("b", "L", "h", "hk", "d", "live"))
    lens = torch.full((b,), live, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator().manual_seed(100)
    src = "mmlspark_tpu_torch/csrc/"
    jax_file = "mmlspark_tpu/ops/flash_attention.py"
    rows = []

    # float dense: bf16 slot caches, SDPA on the same live work
    sets = [kernel_inputs(b, L, h, hk, d, torch.bfloat16, False,
                          seed=100 + i)
            for i in range(ROTATE_BYTES // (2 * b * L * hk * d * 2) + 1)]
    lib_sets = [(q.transpose(1, 2).contiguous(),
                 k[:, :live].transpose(1, 2).contiguous(),
                 v[:, :live].transpose(1, 2).contiguous())
                for q, k, v in sets]
    rows.append(decode_row(
        "flash_decode", src + "flash_decode.cu", f"{jax_file}:586",
        launches["launches"], errors["slice/bfloat16"],
        time_ms(lambda q, k, v: flash_decode(q, k, v, lens), sets),
        time_ms(lambda q, k, v: flash_decode_reference(q, k, v, lens), sets),
        time_ms(F.scaled_dot_product_attention, lib_sets),
        io_bytes(2), "bfloat16", "scaled_dot_product_attention"))
    del sets, lib_sets

    # int8 dense: no single PyTorch call attends over int8 K/V with scales
    sets = []
    for _ in range(ROTATE_BYTES // (2 * b * L * hk * d) + 1):
        q = torch.randn((b, 1, h, d), generator=gen).bfloat16().to(DEVICE)
        k8, ks = int8_kv((b, L, hk, d), (b, hk), gen)
        v8, vs = int8_kv((b, L, hk, d), (b, hk), gen)
        sets.append((q, k8, v8, ks, vs))
    rows.append(decode_row(
        "flash_decode_q8", src + "flash_decode.cu", f"{jax_file}:640",
        launches["q8_launches"], errors["q8_slice/bfloat16"],
        time_ms(lambda q, k, v, ks, vs: flash_decode(
            q, k, v, lens, k_scale=ks, v_scale=vs), sets),
        time_ms(lambda q, k, v, ks, vs: flash_decode_reference(
            q, k, v, lens, k_scale=ks, v_scale=vs), sets),
        None, io_bytes(1) + 2 * b * hk * 4, "int8"))
    del sets

    # paged: shuffled tables, 16 live pages a row
    live_pages = live // PAGE_SIZE
    page_shape = (b * MAX_PAGES + 1, hk, PAGE_SIZE, d)
    table_bytes = b * live_pages * 4

    def paged_set(kv_int8: bool):
        _, pt = shuffled_page_table(b, [live] * b, gen)
        q = torch.randn((b, 1, h, d), generator=gen).bfloat16().to(DEVICE)
        if kv_int8:
            kp, ks = int8_kv(page_shape, page_shape[:2], gen)
            vp, vs = int8_kv(page_shape, page_shape[:2], gen)
            return q, kp, vp, pt, ks, vs
        kp, vp = (torch.randn(page_shape, generator=gen).bfloat16()
                  .to(DEVICE) for _ in range(2))
        return q, kp, vp, pt

    per_set = 2 * page_shape[0] * hk * PAGE_SIZE * d * 2
    sets = [paged_set(False) for _ in range(ROTATE_BYTES // per_set + 1)]

    def gathered(store, pt):  # the live K/V of each row, (B, H, S, D)
        g = store[pt[:, :live_pages].long()]  # (B, pages, Hkv, ps, D)
        return g.permute(0, 2, 1, 3, 4).reshape(b, hk, live, d).contiguous()

    lib_sets = [(q.transpose(1, 2).contiguous(), gathered(kp, pt),
                 gathered(vp, pt)) for q, kp, vp, pt in sets]
    rows.append(decode_row(
        "paged_flash_decode", src + "paged_flash_decode.cu",
        f"{jax_file}:894", launches["paged_launches"],
        errors["paged_slice/bfloat16"],
        time_ms(lambda q, k, v, pt: paged_flash_decode(q, k, v, lens, pt),
                sets),
        time_ms(lambda q, k, v, pt: paged_flash_decode_reference(
            q, k, v, lens, pt), sets),
        time_ms(F.scaled_dot_product_attention, lib_sets),
        io_bytes(2) + table_bytes, "bfloat16",
        "scaled_dot_product_attention on the gathered live K/V (a "
        "yardstick without the page indirection)"))
    del sets, lib_sets

    sets = [paged_set(True) for _ in range(ROTATE_BYTES // (per_set // 2)
                                           + 1)]
    rows.append(decode_row(
        "paged_flash_decode_q8", src + "paged_flash_decode.cu",
        f"{jax_file}:942", launches["paged_q8_launches"],
        errors["paged_q8_slice/bfloat16"],
        time_ms(lambda q, k, v, pt, ks, vs: paged_flash_decode(
            q, k, v, lens, pt, k_scale=ks, v_scale=vs), sets),
        time_ms(lambda q, k, v, pt, ks, vs: paged_flash_decode_reference(
            q, k, v, lens, pt, k_scale=ks, v_scale=vs), sets),
        None, io_bytes(1) + table_bytes + 2 * b * live_pages * hk * 4,
        "int8"))
    return rows


#: the attention kernels' timed shape: the training path's, bf16
TIMED_ATTN = dict(b=8, s=512, h=8, hk=8, d=64, causal=True, window=None)


def attention_work(b, s, h, hk, d, causal, window, elem=2) -> dict:
    """{kernel: (bytes, flops)} for one call at this shape: each input
    read once and each output written once (the backward kernels read D
    = rowsum(dO * out), not out), and 2 flops a multiply-add over the
    live (query, key) pairs: q.k and p.v forward; q.k, dO.v, dV and dK
    for dK/dV; q.k, dO.v and dQ for dQ."""
    pairs = sum(
        min(i + 1, window or s) if causal else s for i in range(s))
    qo = b * s * h * d * elem  # q, out, dO or dq
    kv = b * s * hk * d * elem  # k, v, dk or dv
    rows = b * h * s * 4  # LSE or D, f32
    per_pair = 2 * b * h * d
    return {
        "flash_attention_fwd": (2 * qo + 2 * kv + rows, 2 * per_pair * pairs),
        "flash_attention_bwd_kv": (2 * qo + 4 * kv + 2 * rows,
                                   4 * per_pair * pairs),
        "flash_attention_bwd_q": (3 * qo + 2 * kv + 2 * rows,
                                  3 * per_pair * pairs),
    }


def measure_attention_kernels(errors: dict, launches: dict) -> list:
    """The three attention kernels at the training shape: kernel, plain
    version and the SDPA yardstick. The backward rows' plain version is
    the whole plain backward (dq, dk and dv in one), and their library
    call SDPA's backward alone, both backward kernels' work together."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import flash_attention as fa

    t = TIMED_ATTN
    b, s, h, hk, d = (t[k] for k in ("b", "s", "h", "hk", "d"))
    kw = dict(causal=t["causal"], window=t["window"], scale=d ** -0.5)
    work = attention_work(b, s, h, hk, d, t["causal"], t["window"])
    # enough sets that the call reading the fewest bytes still rotates
    # through more than the rotation floor
    sets = []
    for i in range(ROTATE_BYTES // min(n for n, _ in work.values()) + 1):
        q, k, v, g = attention_inputs(b, s, h, hk, d, torch.bfloat16,
                                      seed=200 + i)
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        ops = fa._backward_operands(q, k, v, out, lse, g)
        # SDPA on the same tensors in its (B, H, S, D) layout, with the
        # forward kept so that its backward can be timed alone
        lib = [x.transpose(1, 2).detach().requires_grad_(True)
               for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
        sets.append(dict(q=q, k=k, v=v, g=g, out=out, lse=lse, ops=ops,
                         lib=lib, lib_out=lib_out, lib_g=g.transpose(1, 2)))

    def timed(fn):
        return time_ms(fn, [(st,) for st in sets])

    src = "mmlspark_tpu_torch/csrc/"
    jax_file = "mmlspark_tpu/ops/flash_attention.py"
    shape = dict(t, dtype="bfloat16")
    err = errors["slice/bfloat16"]
    plain_bwd = timed(lambda st: fa.flash_attention_backward_reference(
        st["q"], st["k"], st["v"], st["out"], st["lse"], st["g"], **kw))
    lib_bwd = timed(lambda st: torch.autograd.grad(
        st["lib_out"], st["lib"], st["lib_g"], retain_graph=True))
    bwd_notes = dict(
        plain="flash_attention_backward_reference: dq, dk and dv together",
        library="scaled_dot_product_attention's backward alone: both "
                "backward kernels together")
    rows = [
        kernel_row(
            "flash_attention_fwd", src + "flash_attention_fwd.cu",
            f"{jax_file}:123", launches["fwd_launches"], err["out"],
            timed(lambda st: fa.flash_attention_forward(
                st["q"], st["k"], st["v"], **kw)),
            timed(lambda st: fa.flash_attention_reference(
                st["q"], st["k"], st["v"], **kw)),
            timed(lambda st: F.scaled_dot_product_attention(
                *(x.detach() for x in st["lib"]), is_causal=True)),
            *work["flash_attention_fwd"], BF16_FLOPS_PER_S, shape,
            library="scaled_dot_product_attention, causal"),
        kernel_row(
            "flash_attention_bwd_kv", src + "flash_attention_bwd.cu",
            f"{jax_file}:285", launches["bwd_kv_launches"],
            max(err["dk_abs"], err["dv_abs"]),
            timed(lambda st: fa._launch_bwd_kv(st["ops"], kw["causal"],
                                               kw["window"], kw["scale"])),
            plain_bwd, lib_bwd, *work["flash_attention_bwd_kv"],
            BF16_FLOPS_PER_S, shape, **bwd_notes),
        kernel_row(
            "flash_attention_bwd_q", src + "flash_attention_bwd.cu",
            f"{jax_file}:330", launches["bwd_q_launches"], err["dq_abs"],
            timed(lambda st: fa._launch_bwd_q(st["ops"], kw["causal"],
                                              kw["window"], kw["scale"])),
            plain_bwd, lib_bwd, *work["flash_attention_bwd_q"],
            BF16_FLOPS_PER_S, shape, **bwd_notes),
    ]
    return rows


ENGINE_KEYS = (
    "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99", "per_token_ms",
    "per_token_ms_p50", "tick_ms_p50", "completed", "tokens_generated",
    "wall_s", "decode_blocks", "slot_utilization_mean",
    "cache_pool_bytes_per_device", "kv_dtype",
)


def engine_summary(run: dict) -> dict:
    out = {k: run["metrics"][k] for k in ENGINE_KEYS}
    out.update(decode_micro_steps=run["micro_steps"],
               launch_counts=run["counts"])
    for key in ("paging", "hits", "flip_rate_vs_dense_bf16", "diverged"):
        if key in run:
            out[key] = run[key]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke run needs a "
            "CUDA GPU")
        return 2
    import mmlspark_tpu_torch  # noqa: F401  (fails outside the repo)
    from mmlspark_tpu_torch.models import build_model, init_variables

    # full float32 for f32 products and convolutions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = device_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    build_kernels()
    errors = check_kernels()
    attn_errors = check_attention_kernels()

    graph = build_model("transformer_lm", **SERVE_MODEL)
    variables = init_variables(graph, 0, device=DEVICE)
    t0 = time.perf_counter()
    dense = check_engine(graph, variables)
    header = check_header_engines(graph, variables)
    log(f"engine phases took {time.perf_counter() - t0:.1f}s")
    model_err = check_model_vs_cpu()
    format_errs = check_cache_formats_vs_cpu()
    t0 = time.perf_counter()
    training, trained = run_training("full width", TRAIN_MODEL, TRAIN_STEPS,
                                     seed=5)
    small_training, _ = run_training("depth 2, GQA, window, RoPE",
                                     SMALL_TRAIN_MODEL, SMALL_TRAIN_STEPS,
                                     seed=6)
    step_vs_cpu = check_train_step_vs_cpu()
    log(f"training phases took {time.perf_counter() - t0:.1f}s")

    launches = {
        "launches": dense["counts"]["launches"],
        "q8_launches": header["header dense int8"]["counts"]["q8_launches"],
        "paged_launches":
            header["header paged bf16"]["counts"]["paged_launches"],
        "paged_q8_launches":
            header["header paged int8"]["counts"]["paged_q8_launches"],
    }
    rows = measure_kernels(errors, launches) + measure_attention_kernels(
        attn_errors, training["launch_counts"])
    print(json.dumps({"kernel_errors": errors,
                      "attention_kernel_errors": attn_errors,
                      "model_f32_card_vs_cpu_max_abs_err": model_err,
                      "model_f32_cache_formats_card_vs_cpu": format_errs,
                      "train_step_f32_card_vs_cpu": step_vs_cpu}))
    print(json.dumps({"engine": engine_summary(dense),
                      "model": SERVE_MODEL, "slots": SLOTS,
                      "cache_len": CACHE_LEN,
                      "decode_block": DECODE_BLOCK}))
    print(json.dumps({"header_engines": {
        label: engine_summary(run) for label, run in header.items()},
        "page_size": PAGE_SIZE, "num_pages": paged_num_pages(),
        "header_len": HEADER_LEN}))
    print(json.dumps({"training": training,
                      "small_training": small_training}))
    print(json.dumps({"profile": profile_decode_block(graph, variables)}))
    print(json.dumps({"train_profile": profile_train_step(trained)}))
    log(f"smoke run took {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
