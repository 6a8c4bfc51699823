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
   strided slices of one fused tensor and dO a strided view; the route
   each call took is read off the counters (bf16 at head dims 64 and 128:
   the tensor-core forward and backward pair; f32 and D = 256: the
   f32-FMA kernels); and the fused optimizer kernel against its plain
   update at the full-width model's parameter shapes, bit-equal in f32
   for adam, adamw, sgd and momentum with the quarantine's ``bad`` false
   and true;
3. the engines, each a main path of its own, with every launch count
   set to 0 just before it and read just after. Every engine runs its
   program ladder as CUDA graphs (prefill per bucket, resume per
   remainder bucket, the decode block per ladder size), and then the
   same schedule runs through its eager twin (programs counted, never
   captured). Gates: every program count within its pin, one program
   for every ladder size the run used, something captured, and every
   kernel's launches counted on replay equal to the eager twin's (the
   ``programs`` line: counts, pins, capture seconds, the graph pool's
   reserved bytes, peak memory, tokens/s, TTFT and per-token ms of both):
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
   then chunked prefill and the async host loop (the ``chunked_async``
   line), each run a main path of its own: 16 requests, 2 a tick, 64 new
   tokens, even ones 240-440-token prompts and odd ones 8-64, through the
   dense bf16 engine (a) sync and monolithic, (b) ``prefill_chunk=64``
   (the chunk ladder 8-64: 4 programs), (c) ``async_host=True``, (d)
   both; then (d) on the paged prefix-cache engines, bf16 and int8, over
   the shared-header schedule, each with a warm pass. Gates: every
   request completes; (c) bit-equal to (a); (b), (d) and the paged runs
   equal to their sync monolithic twins or first differing at a near
   tie (the twin's top-2 margin under the full forward below
   BF16_LOGIT_TOL), and every emitted token within BF16_LOGIT_TOL of the
   full forward's best; every program count within its pin; at most one
   fetch a block; on the async runs, overlapped dispatches and at least
   one fetch that returned while the next block was still running; the
   decode kernel launched ``depth`` times a micro-step. Reported: warm
   tokens/s, the short requests' TTFT p50/p99, per-token ms,
   ``host_idle_fraction``, capture seconds, and one steady T=32 block's
   wall time, busy share and host dispatch/fetch ms, sync against async.
   Then the resilience layer (the ``resilience`` line): the async
   chunked engine under a transient and two OOMs at ``serve.decode`` and
   a poisoned block for slot 1 — every request terminal, exactly the
   poisoned one failed (its tokens the real pre-fault ones), the rest
   equal to the fault-free (d) or first differing at a near tie, not
   degraded at the end, decode programs within the pin; a 2^46-element
   allocation raising an error ``is_resource_exhausted`` accepts; the
   crash drill (snapshots every tick, a kill at ``serve.prefill`` while
   fills are open, a restore from ``last_snapshot``, the streams against
   (d)'s); and a bit-flipped snapshot refused with
   ``SnapshotCorruption``;
   plus the full-width model's cached decode step on the card against
   the same step on the CPU, in float32: over a dense cache (1e-3), a
   paged float32 cache (1e-3), and int8 dense and paged caches (1e-2),
   the caches built on the CPU and copied to the card;
4. generation and weight-only int8, each a main path with the counts set
   to 0 just before it and read just after, at full width: 8 seeded
   prompts of 64 tokens (the ``generate`` line) — sampled decode at
   temperature 0.8, top-k 50, top-p 0.9 for 128 tokens from a seeded
   CUDA generator (the same seed repeats the stream; every drawn token
   lies in the support recomputed in numpy from its step's logits), the
   greedy recompute oracle ``kv_cache=False`` (the flash forward kernel)
   against the cached path (tokens equal, or a row first differs at a
   near tie under BF16_LOGIT_TOL; each cached step's logits within
   BF16_LOGIT_TOL of a teacher-forced forward), and ``beam_search(beams=
   4)`` for 32 tokens (beams=1 equals greedy, sorted scores, the best
   score within 2 BF16_LOGIT_TOL a token of its teacher-forced log-prob
   sum); then the random schedule through ``quantize_weights=True`` with
   dense bf16 KV and with paged int8 KV (the ``quantized_weights`` line:
   tokens/s, TTFT, the flip rate against the dense bf16 engine, weight
   bytes against f32, the engine's peak memory, and the per-call
   dequantization's device and host time). Each path fails the run if
   its kernel was launched no time;
5. training, each run a main path with the counts set to 0 just before
   it and read just after: the same model with ``attn_impl="flash"``
   under ``SPMDTrainer`` (adam, lr 1e-3, batch 8) for 8 steps over
   seeded rows of 512 tokens that are arithmetic progressions mod the
   vocabulary (learnable), then a depth-2 GQA model with a 128 window
   and RoPE for 4 steps. Gates: every loss finite and the last below the
   first; each attention kernel launched ``depth`` times a step, every
   forward and every backward through the tensor-core kernels; no dense
   attention ran; one step program captured and one fused-optimizer
   launch a step (step 0 runs eagerly, the rest replay the captured
   step). Then one training step of the float32 model, card vs
   CPU (the plain versions), on the same weights and batch, through the
   f32-FMA kernels: the loss within 1e-4 relative, every parameter's
   gradient within 1e-3 of that leaf's largest;
6. numbers: each kernel's, its plain version's and (where one exists)
   a library call's times (CUDA events, inputs rotated through more
   memory than the 50 MB L2 so each launch reads cold): ``ms`` the
   device's time (a spin kernel holds the stream while the host
   enqueues the timed loop, so the calls run back to back), ``call_ms``
   the host-paced time an eager caller pays; ``graph_ms`` for the decode
   kernels, the device time a call when the calls are replayed from one
   CUDA graph; the attention kernels'
   device times also from ``torch.profiler``; the fused optimizer's row
   (adam over the 33.9 M parameters, against ``torch.optim.Adam(fused=
   True).step()``); the kernel's bound, the
   engines' throughput, the training runs' step time, tokens/s and peak
   memory, and one steady (replayed) decode block and one replayed
   training step under ``torch.profiler`` (device busy share and the
   kernels that take its time). The ``attention_backward`` line: the
   whole ``flash_attention_backward`` call, its operands, the two kernels
   alone and together, the f32-FMA pair on the same inputs, and SDPA's
   backward, all device times in one call; and the pair at the GQA
   training run's shape.

The last line is ``{"ok": true, "device": {...}}``. float32 matrix
products and convolutions run in full float32 here: TF32 is switched off
for both, so the f32 comparisons are not loosened by it.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

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
#: the chunked/async phase: the chunk width (the ladder 8-64: 4 buckets);
#: the crash drill's kill tick (while long fills are open)
CHUNK, KILL_TICK = 64, 3
#: the bf16 logit tolerance of tests/test_torch_model.py: a stream may
#: first differ from generate() only where the top-2 margin is below it
BF16_LOGIT_TOL = 6.25e-2
#: the launch counters of ops/flash_attention.py, one per kernel
COUNTERS = ("launches", "q8_launches", "paged_launches",
            "paged_q8_launches", "fwd_launches", "fwd_mma_launches",
            "bwd_kv_launches", "bwd_q_launches", "bwd_kv_mma_launches",
            "bwd_q_mma_launches")
#: the attention counters a call adds to: every kernel once, and each
#: ``*_mma_launches`` once more on the tensor-core route
ATTN_COUNTERS = ("fwd_launches", "bwd_kv_launches", "bwd_q_launches")
ATTN_MMA_COUNTERS = ("fwd_mma_launches", "bwd_kv_mma_launches",
                     "bwd_q_mma_launches")
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
#: the generation phase: seeded prompts, the sampling filters, beams
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 64, 128
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
BEAMS, BEAM_NEW = 4, 32


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
    to its own plain version alone. The counters show the route each
    call took."""
    import torch

    from mmlspark_tpu_torch.ops import flash_attention as fa

    errors = {}
    for i, (name, b, s, h, hk, d, causal, window) in enumerate(ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}/{str(dtype).split('.')[1]}"
            tol_out, tol_lse, tol_grad = ATTN_TOLERANCE[tag.split("/")[1]]
            q, k, v, g = attention_inputs(b, s, h, hk, d, dtype, seed=70 + i)
            kw = dict(causal=causal, window=window, scale=d ** -0.5)
            before = {n: getattr(fa, n)
                      for n in ATTN_COUNTERS + ATTN_MMA_COUNTERS}
            out, lse = fa.flash_attention_forward(q, k, v, **kw)
            want_out, want_lse = fa.flash_attention_reference(q, k, v, **kw)
            grads = fa.flash_attention_backward(q, k, v, want_out, want_lse,
                                                g, **kw)
            want = fa.flash_attention_backward_reference(
                q, k, v, want_out, want_lse, g, **kw)
            torch.cuda.synchronize()
            mma = int(dtype == torch.bfloat16 and d in fa.MMA_HEAD_DIMS)
            added = {n: getattr(fa, n) - before[n] for n in before}
            if added != {**dict.fromkeys(ATTN_COUNTERS, 1),
                         **dict.fromkeys(ATTN_MMA_COUNTERS, mma)}:
                raise AssertionError(f"attention {tag}: launches {added}, "
                                     f"wanted the {'mma' if mma else 'simt'}"
                                     " route for every kernel")
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


# -- the fused optimizer ---------------------------------------------------------


def optimizer_inputs(kind: str, seed: int):
    """The full-width training model's parameter tensors (33.9 M f32
    elements in 102 tensors) as seeded parameters, gradients and the
    kind's moments (``nu`` positive), on the card."""
    import torch

    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.ops.fused_optim import moment_names

    graph = build_model("transformer_lm", **TRAIN_MODEL)  # on "meta"
    shapes = [t.shape for _, mod in graph.blocks
              for t in mod.state_dict().values()]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def make(scale=1.0, positive=False):
        out = [torch.randn(sh, generator=gen, device=DEVICE) * scale
               for sh in shapes]
        return [t.abs() for t in out] if positive else out

    moments = [make(0.01, positive=(name == "nu"))
               for name in moment_names(kind)]
    return make(), make(), moments


def optimizer_scalars(count: int, bad: bool):
    """-lr, adam's bias corrections at ``count`` and ``bad``, on the card
    (what ``ops/fused_optim.optimizer_update`` computes for a step)."""
    import torch

    from mmlspark_tpu_torch.ops import fused_optim as fo

    n = torch.full((), count, dtype=torch.int32, device=DEVICE)
    return (-torch.full((), 1e-3, device=DEVICE),
            1 - torch.pow(fo.ADAM_B1, n), 1 - torch.pow(fo.ADAM_B2, n),
            torch.tensor(bad, device=DEVICE))


def check_fused_optimizer() -> dict:
    """The fused optimizer kernel against its plain version on the same
    CUDA tensors at the full-width model's parameter shapes: bit-equal
    parameters and moments in f32 for adam, adamw, sgd and momentum, with
    the quarantine's ``bad`` false and true (nothing moves then)."""
    import torch

    from mmlspark_tpu_torch.ops import fused_optim as fo

    equal = {}
    for kind in fo.KINDS:
        for bad in (False, True):
            params, grads, moments = optimizer_inputs(kind, seed=9)
            plain_p = [p.clone() for p in params]
            plain_m = [[t.clone() for t in m] for m in moments]
            before = [p.clone() for p in params[:3]]
            args = optimizer_scalars(7, bad)
            kw = dict(weight_decay=0.1, momentum=0.9)
            fo._launch(kind, params, grads, moments, *args, **kw)
            fo.optimizer_update_reference(kind, plain_p, grads, plain_m,
                                          *args, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(
                params + sum(moments, []), plain_p + sum(plain_m, [])))
            if bad:
                same = same and all(torch.equal(a, b)
                                    for a, b in zip(params, before))
            equal[f"{kind}/bad={bad}"] = same
            del params, grads, moments, plain_p, plain_m
    log(f"fused optimizer vs plain, bit-equal: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"fused optimizer differs from its plain "
                             f"version: {equal}")
    return equal


def measure_fused_optimizer(equal: dict, launches: int) -> dict:
    """The fused optimizer's ``kernels`` row: adam over the full-width
    model's 33.9 M parameters; the plain version on the same tensors; and
    as the library yardstick ``torch.optim.Adam(fused=True).step()`` on
    the same tensors (no quarantine). Bound: 7 f32 a parameter (read p,
    g, m, v; write p, m, v) at the card's memory rate."""
    import torch

    from mmlspark_tpu_torch.ops import fused_optim as fo

    params, grads, moments = optimizer_inputs("adam", seed=10)
    args = optimizer_scalars(7, False)
    kernel_t = time_ms(lambda: fo._launch(
        "adam", params, grads, moments, *args, weight_decay=0.0,
        momentum=0.9), [()], reps=50)
    plain_t = time_ms(lambda: fo.optimizer_update_reference(
        "adam", params, grads, moments, *args), [()], reps=20)
    lib_params = [p.clone() for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    adam = torch.optim.Adam(lib_params, lr=1e-3, fused=True)
    library_t = time_ms(adam.step, [()], reps=50)
    n = sum(p.numel() for p in params)
    log(f"fused optimizer, adam over {n} parameters: device {kernel_t.ms:.4f}"
        f" ms, plain {plain_t.ms:.4f} ms, torch.optim.Adam(fused=True) "
        f"{library_t.ms:.4f} ms")
    return kernel_row(
        "fused_optim", "mmlspark_tpu_torch/csrc/fused_optim.cu",
        "mmlspark_tpu/train/trainer.py:575 (optax update inside the jitted "
        "step; no TPU kernel: XLA fusion in the reference)",
        launches, 0.0, kernel_t, plain_t,
        library_t, 7 * 4 * n, 13 * n, F32_FLOPS_PER_S,
        dict(parameters=n, tensors=len(params), optimizer="adam",
             dtype="float32"),
        library="torch.optim.Adam(fused=True).step(), which computes no "
                "quarantine",
        design="one multi-tensor launch: a grid over 4096-element chunks "
               "of every tensor, each element read and written once, "
               "__f*_rn arithmetic (bit-equal to the eager update)",
        bit_equal=equal)


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
    hits = set()
    by_prompt = {np.asarray(p, np.int32).tobytes(): i
                 for i, p in enumerate(prompts)}
    if getattr(engine.pool, "prefix_cache_enabled", False):
        # note which admissions the prefix cache served
        inner = engine._prefill

        def prefill(slot, prompt, *rest):
            before = engine.pool.prefix_hits
            out = inner(slot, prompt, *rest)
            if engine.pool.prefix_hits > before:
                hits.add(by_prompt[np.asarray(prompt, np.int32).tobytes()])
            return out

        engine._prefill = prefill
    zero_counts()
    submitted, results = 0, {}
    while submitted < len(prompts) or engine.busy:
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < len(prompts):
                engine.submit(prompts[submitted], MAX_NEW)
                submitted += 1
        for res in engine.step():
            results[res.id] = res
    counts = read_counts()
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


def program_summary(engine, peak: int) -> dict:
    """An engine's program ladder after a run: each family's program
    count beside its pin, the ladder sizes the run used, the captures'
    wall time, the shared graph pool's reserved bytes and the run's peak
    device memory over what was allocated before the engine."""
    return {
        "decode_compile_count": engine.decode_compile_count,
        "num_decode_blocks": engine.num_decode_blocks,
        "decode_block_sizes_run": sorted(
            int(t) for t in engine.metrics.decode_blocks),
        "prefill_compile_count": engine.prefill_compile_count,
        "resume_compile_count": engine.resume_compile_count,
        "num_prefill_buckets": engine.num_prefill_buckets,
        "capture_s": engine.capture_seconds,
        "graph_pool_bytes": engine.graph_pool_bytes(),
        "peak_memory_bytes": peak,
    }


def eager_twin(graph, variables, prompts, **kw) -> dict:
    """The same schedule through an engine whose programs are counted
    but never captured, so every call runs eagerly: the eager path's
    launch counts and speed beside the captured run's."""
    from mmlspark_tpu_torch.serve import engine as engine_mod
    from mmlspark_tpu_torch.testing.compile_guard import ProgramCountingGraph

    class EagerPrograms(ProgramCountingGraph):
        def _capture(self, args):
            return None

    engine_mod.ProgramCountingGraph = EagerPrograms
    try:
        engine = make_engine(graph, variables, **kw)
    finally:
        engine_mod.ProgramCountingGraph = ProgramCountingGraph
    return drive(engine, prompts)


def check_programs(label: str, run: dict, eager: dict) -> None:
    """The captured run's programs within their pins, one program for
    every ladder size it ran, and each kernel's launches counted on
    replay equal to the eager path's on the same schedule."""
    pr = run["programs"]
    over = [k for k, pin in (("decode_compile_count", "num_decode_blocks"),
                             ("prefill_compile_count", "num_prefill_buckets"),
                             ("resume_compile_count", "num_prefill_buckets"),
                             ("warm_resume_compile_count",
                              "num_prefill_buckets"))
            if pr[k] > pr[pin]]
    if over:
        raise AssertionError(f"{label}: {over} over their pins: {pr}")
    if pr["decode_compile_count"] != len(pr["decode_block_sizes_run"]) or \
            pr["prefill_compile_count"] < 1:
        raise AssertionError(f"{label}: a ladder size ran without its "
                             f"captured program: {pr}")
    if DEVICE == "cuda" and not (pr["capture_s"] > 0
                                 and pr["graph_pool_bytes"] > 0):
        raise AssertionError(f"{label}: nothing was captured: {pr}")
    if eager["counts"] != run["counts"] or \
            eager["micro_steps"] != run["micro_steps"]:
        raise AssertionError(
            f"{label}: launches counted on replay {run['counts']} over "
            f"{run['micro_steps']} micro-steps, eager {eager['counts']} "
            f"over {eager['micro_steps']}")
    m, e = run["metrics"], eager["metrics"]
    pr.update({k: m[k] for k in WARM_KEYS})
    pr.update(launch_counts=run["counts"], eager_launch_counts=eager["counts"],
              **{f"eager_{k}": e[k] for k in WARM_KEYS})
    log(f"{label}: programs " + str({
        k: v for k, v in pr.items() if not k.endswith("launch_counts")}))


def fresh_metrics(engine) -> None:
    """Give ``engine`` new, empty serving metrics, wired as its own."""
    from mmlspark_tpu_torch.serve import ServeMetrics

    old = engine.metrics
    engine.metrics = ServeMetrics(
        old.model, old.slots, decode_block=old.decode_block,
        cache_pool_bytes_per_device=old.cache_pool_bytes_per_device,
        kv_dtype=old.kv_dtype, prefill_chunk=old.prefill_chunk,
        async_host=old.async_host)
    if old._paging_provider is not None:
        engine.metrics.attach_paging(old._paging_provider)


WARM_KEYS = ("tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99", "per_token_ms",
             "per_token_ms_p50")


def graphed_run(label: str, graph, variables, prompts, counter: str,
                **kw):
    """One engine's main path on its captured programs, checked; then the
    same schedule again on the warm engine (every decode and prefill
    program already captured: none may be added; the prefix cache may
    send a request to a resume bucket the first pass did not use), and
    through its eager twin (``check_programs``). Returns the first run
    (with its ``programs`` summary, the warm pass's speed included) and
    the engine."""
    import torch

    from mmlspark_tpu_torch.testing import compile_guard

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine(graph, variables, **kw)
    run = drive(engine, prompts)
    peak = torch.cuda.max_memory_allocated() - base
    check_run(label, run, counter)
    run["programs"] = program_summary(engine, peak)
    fresh_metrics(engine)
    with compile_guard(lambda: engine.decode_compile_count, max_programs=0,
                       label=f"{label} warm decode"), \
            compile_guard(lambda: engine.prefill_compile_count,
                          max_programs=0, label=f"{label} warm prefill"):
        warm = drive(engine, prompts)
    check_run(f"{label} warm", warm, counter)
    run["programs"].update(
        {f"warm_{k}": warm["metrics"][k] for k in WARM_KEYS},
        warm_resume_compile_count=engine.resume_compile_count)
    check_programs(label, run, eager_twin(graph, variables, prompts, **kw))
    gc.collect()
    return run, engine


def check_engine(graph, variables) -> dict:
    """The dense bf16 engine on the random schedule (the first slice's
    main path)."""
    prompts = random_schedule()
    # warm the CUDA libraries up on a throwaway engine, outside the runs
    warm = make_engine(graph, variables)
    warm.submit(prompts[0], 4)
    warm.run()
    del warm
    gc.collect()

    run, _ = graphed_run("dense bf16", graph, variables, prompts,
                         "launches")
    ids = np.linspace(0, N_REQUESTS - 1, N_CHECKED).astype(int)
    check_streams(graph, variables, prompts, run["results"], ids,
                  "dense bf16", exact=True)
    gc.collect()
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
        runs[label], engine = graphed_run(label, graph, variables, prompts,
                                          counter, **kw)
        pools[label] = engine.pool
        del engine
        gc.collect()

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


# -- chunked prefill, the async host loop, the resilience layer ------------------


def long_short_schedule() -> list:
    """The chunked/async schedule: 16 prompts arriving 2 a tick, even ones
    long (240-440 tokens: 4-7 chunks of 64), odd ones short (8-64)."""
    rng = np.random.default_rng(7)
    vocab = SERVE_MODEL["vocab_size"]
    return [rng.integers(0, vocab, size=int(
        rng.integers(240, 441) if i % 2 == 0 else rng.integers(8, 65)))
        for i in range(N_REQUESTS)]


def watch_fetches(engine) -> dict:
    """Count the engine's block fetches, and those that returned while the
    block dispatched after the fetched one was still running on the card
    (its staging event not yet complete): the async loop's overlap."""
    seen = {"fetches": 0, "overlapped_fetches": 0}
    inner = engine._fetch

    def fetch(inflight):
        out = inner(inflight)
        seen["fetches"] += 1
        nxt = engine._inflight
        if nxt is not None and nxt["event"] is not None and \
                not nxt["event"].query():
            seen["overlapped_fetches"] += 1
        return out

    engine._fetch = fetch
    return seen


def forced_logits(graph, variables, tokens):
    """The full forward's next-token logits over a stream: row t predicts
    token t + 1 (teacher forcing, f32)."""
    import torch

    ids = torch.from_numpy(np.asarray(tokens[:-1], np.int32)[None])
    return graph.apply(variables, ids.to(DEVICE))[0].float()


def check_near_ties(graph, variables, label: str, got: dict, want: dict,
                    exact: bool) -> dict:
    """Each stream of ``got`` against its twin in ``want``: equal, or —
    unless ``exact`` — first differing at a near tie (the twin's top-2
    margin under the full forward below BF16_LOGIT_TOL); and every token
    each stream emitted within BF16_LOGIT_TOL of the best logit of the
    full forward over that stream (checked on the differing streams and
    on 4 others). Returns the divergences and the largest per-step gap."""
    import torch

    diverged, worst = [], 0.0
    checked = sorted(got)[::max(1, len(got) // N_CHECKED)]
    for rid in sorted(got):
        g, w = got[rid], want[rid]
        same = g.tokens.shape == w.tokens.shape and \
            np.array_equal(g.tokens, w.tokens)
        if same and rid not in checked:
            continue
        logits = forced_logits(graph, variables, g.tokens)
        p = g.prompt_len
        steps = logits[p - 1:]
        picked = steps.gather(1, torch.from_numpy(
            g.tokens[p:].astype(np.int64))[:, None].to(DEVICE))[:, 0]
        gap = float((steps.max(dim=1).values - picked).max())
        worst = max(worst, gap)
        if gap > BF16_LOGIT_TOL:
            raise AssertionError(f"{label} request {rid}: an emitted token "
                                 f"is {gap} below the full forward's best")
        if same:
            continue
        n = min(len(g.tokens), len(w.tokens))
        first = int(np.argmax(g.tokens[:n] != w.tokens[:n])) if \
            (g.tokens[:n] != w.tokens[:n]).any() else n
        top2 = logits[first - 1].sort().values[-2:]
        margin = float(top2[1] - top2[0])
        if exact or first < p or not margin < BF16_LOGIT_TOL:
            raise AssertionError(
                f"{label} request {rid}: differs from its twin at token "
                f"{first} (prompt {p}), top-2 margin {margin}")
        diverged.append({"request": int(rid), "token": first,
                         "margin": margin})
    log(f"{label}: streams equal their twin's or first differ at a near "
        f"tie: {diverged}; largest emitted-token gap to the full forward's "
        f"best {worst:.4g}")
    return {"diverged": diverged, "max_emitted_gap": worst}


def short_ttft(metrics, results: dict, prompts) -> dict:
    """TTFT p50/p99 (ms) of the short requests of a pass."""
    short = {rid for rid in results
             if len(prompts[rid % len(prompts)]) <= 64}
    ttft = sorted(t * 1e3 for rid, t in zip(metrics.ttft_req_ids,
                                            metrics.ttft_s) if rid in short)
    if not ttft:
        return {"short_ttft_ms_p50": None, "short_ttft_ms_p99": None}
    return {"short_ttft_ms_p50": float(np.percentile(ttft, 50)),
            "short_ttft_ms_p99": float(np.percentile(ttft, 99))}


CHUNKED_KEYS = ("tokens_per_sec", "per_token_ms", "host_idle_fraction",
                "host_sync_wait_s", "overlapped_dispatches_total",
                "chunked_prefills_total", "decode_blocks")


def chunked_async_run(label, graph, variables, prompts, counter, **kw):
    """One engine mode's main path (the counts zeroed just before, read
    just after) and a warm pass of the same schedule on it. Gates: every
    request completes; the decode kernel launched ``depth`` times a
    micro-step; every program family within its pin; at most one fetch a
    dispatched block. Returns (the first pass's results, the summary)."""
    engine = make_engine(graph, variables, **kw)
    seen = watch_fetches(engine)
    run = drive(engine, prompts)
    check_run(label, run, counter)
    blocks = sum(engine.metrics.decode_blocks.values())
    first_seen = dict(seen)
    fresh_metrics(engine)
    warm = drive(engine, prompts)
    check_run(f"{label} warm", warm, counter)
    pins = {
        "decode_compile_count": (engine.decode_compile_count,
                                 engine.num_decode_blocks),
        "prefill_compile_count": (engine.prefill_compile_count,
                                  engine.num_prefill_buckets),
        "resume_compile_count": (engine.resume_compile_count,
                                 engine.num_prefill_buckets),
    }
    over = {k: v for k, v in pins.items() if v[0] > v[1]}
    if over:
        raise AssertionError(f"{label}: programs over their pins: {over}")
    if first_seen["fetches"] > blocks:
        raise AssertionError(f"{label}: {first_seen['fetches']} fetches for "
                             f"{blocks} blocks")
    m = warm["metrics"]
    out = {k: m[k] for k in CHUNKED_KEYS}
    out.update(short_ttft(engine.metrics, warm["results"], prompts),
               programs={k: v[0] for k, v in pins.items()},
               pins={k: v[1] for k, v in pins.items()},
               capture_s=engine.capture_seconds,
               launch_counts=run["counts"], decode_micro_steps=run[
                   "micro_steps"], blocks=blocks, **first_seen)
    log(f"{label}: {out}")
    del engine
    gc.collect()
    return run["results"], out


def host_timed(acc: dict, key: str, fn):
    """``fn``, adding the host's wall ms in each call to ``acc[key]``."""
    def timed(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            acc[key] += (time.perf_counter() - t0) * 1e3
    return timed


def profile_block_modes(graph, variables) -> dict:
    """Wall time and device busy share of steady T=32 blocks, sync against
    async: all 8 slots live, the programs captured, then 4 ticks under
    ``torch.profiler`` from an idle card to a synchronize; with the host's
    ms a block in the dispatch (inputs, the replay, the staging) and in
    the fetch (the wait included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, kw in (("sync", {}), ("async", dict(async_host=True))):
        engine = make_engine(graph, variables, **kw)
        rng = np.random.default_rng(1)
        for _ in range(SLOTS):
            engine.submit(rng.integers(0, SERVE_MODEL["vocab_size"],
                                       size=32), 1 + 8 * DECODE_BLOCK)
        for _ in range(3):
            engine.step()  # admissions, the T=32 program's eager call
        torch.cuda.synchronize()
        host = {"dispatch_ms": 0.0, "fetch_ms": 0.0}
        for name, attr in (("dispatch_ms", "_dispatch_block"),
                           ("fetch_ms", "_fetch_inflight")):
            setattr(engine, attr, host_timed(host, name,
                                             getattr(engine, attr)))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof_out = device_profile(prof, wall_ms)
        out[label] = dict(prof_out, block_wall_ms=wall_ms / 4, blocks=4,
                          host_dispatch_ms=host["dispatch_ms"] / 4,
                          host_fetch_ms=host["fetch_ms"] / 4,
                          decode_compile_count=engine.decode_compile_count)
        del engine
        gc.collect()
    log("block wall, busy share, host dispatch and fetch ms, sync vs "
        "async: " + str({k: (v["block_wall_ms"], v["device_busy_share"],
                             v["host_dispatch_ms"], v["host_fetch_ms"])
                         for k, v in out.items()}))
    return out


def check_chunked_async(graph, variables, header: dict) -> tuple:
    """The chunked/async phase: the long/short schedule through the dense
    bf16 engine sync and monolithic (a), chunked (b), async (c) and both
    (d); then chunked+async on the paged prefix-cache engines, bf16 and
    int8, over the shared-header schedule, against the header phase's
    sync monolithic runs. Gates: (c) bit-equal to (a); the others equal
    to their twin or first differing at a near tie; the async runs
    overlapped a fetch with a running block. Returns (the line, (d)'s
    results)."""
    prompts = long_short_schedule()
    chunk = dict(prefill_chunk=CHUNK)
    runs, results = {}, {}
    for key, kw in (("a_sync", {}), ("b_chunked", chunk),
                    ("c_async", dict(async_host=True)),
                    ("d_chunked_async", dict(chunk, async_host=True))):
        results[key], runs[key] = chunked_async_run(
            f"chunked_async {key}", graph, variables, prompts, "launches",
            **kw)
    check_near_ties(graph, variables, "chunked_async c_async",
                    results["c_async"], results["a_sync"], exact=True)
    for key in ("b_chunked", "d_chunked_async"):
        runs[key].update(check_near_ties(
            graph, variables, f"chunked_async {key}", results[key],
            results["a_sync"], exact=False))
    paged = dict(paged=True, page_size=PAGE_SIZE,
                 num_pages=paged_num_pages(), prefix_cache=True,
                 async_host=True, **chunk)
    hprompts = header_schedule()
    for key, kw, counter, twin in (
        ("paged_bf16_chunked_async", paged, "paged_launches",
         "header paged bf16"),
        ("paged_int8_chunked_async", dict(paged, kv_dtype="int8"),
         "paged_q8_launches", "header paged int8"),
    ):
        got, runs[key] = chunked_async_run(
            f"chunked_async {key}", graph, variables, hprompts, counter,
            **kw)
        runs[key].update(check_near_ties(
            graph, variables, f"chunked_async {key}", got,
            header[twin]["results"], exact=False))
    for key, run in runs.items():
        if "async" in key and not (run["overlapped_dispatches_total"] > 0
                                   and run["overlapped_fetches"] > 0):
            raise AssertionError(f"chunked_async {key}: no pipelined "
                                 f"overlap: {run}")
    line = {"runs": runs, "block_modes": profile_block_modes(graph,
                                                             variables),
            "prefill_chunk": CHUNK, "long_prompts": [240, 440],
            "short_prompts": [8, 64]}
    return line, results["d_chunked_async"]


def drive_until_killed(engine, prompts, submitted: int, results: dict):
    """``drive``'s arrivals from request ``submitted`` on, until the
    engine drains or is killed; returns (submitted, killed)."""
    from mmlspark_tpu_torch.core.faults import EngineKilled

    while submitted < len(prompts) or engine.busy:
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < len(prompts):
                engine.submit(prompts[submitted], MAX_NEW)
                submitted += 1
        try:
            for res in engine.step():
                results[res.id] = res
        except EngineKilled:
            return submitted, True
    return submitted, False


def check_resilience(graph, variables, clean: dict) -> dict:
    """The resilience phase on the async chunked dense engine: a fault
    schedule (a transient and two OOMs at ``serve.decode``, the first
    fetched block holding slot 1 poisoned at ``serve.device_get``)
    against the fault-free run
    (``clean``); a real allocation failure; the crash drill (a kill at
    ``serve.prefill`` mid-fill, restore from ``last_snapshot``); and a
    bit-flipped snapshot."""
    import torch

    from mmlspark_tpu_torch.core import integrity
    from mmlspark_tpu_torch.core.faults import (
        Fault,
        FaultInjector,
        is_resource_exhausted,
    )
    from mmlspark_tpu_torch.core.integrity import SnapshotCorruption
    from mmlspark_tpu_torch.serve import ServeEngine

    prompts = long_short_schedule()
    kw = dict(prefill_chunk=CHUNK, async_host=True, retry_backoff_s=0.0,
              degrade_recover_ticks=4)
    inj = FaultInjector([
        Fault("serve.decode", "transient"),
        Fault("serve.decode", "oom", times=2),
        Fault("serve.device_get", "poison", slot=1),
    ])
    engine = make_engine(graph, variables, faults=inj, **kw)
    zero_counts()
    results = {}
    drive_until_killed(engine, prompts, 0, results)
    counts = read_counts()
    failed = [rid for rid, r in results.items() if r.status == "failed"]
    if len(results) != N_REQUESTS or len(failed) != 1 or \
            inj.counts != {"transient": 1, "oom": 2, "poison": 1}:
        raise AssertionError(f"resilience: results {len(results)}, failed "
                             f"{failed}, faults {inj.counts}")
    bad = results[failed[0]]
    if not np.array_equal(bad.tokens,
                          clean[failed[0]].tokens[:len(bad.tokens)]):
        raise AssertionError("resilience: the quarantined request's "
                             "tokens are not its real pre-fault tokens")
    ok = {rid: r for rid, r in results.items() if rid != failed[0]}
    ties = check_near_ties(graph, variables, "resilience", ok, clean,
                           exact=False)
    if engine.degraded or engine.decode_compile_count > \
            engine.num_decode_blocks or counts["launches"] <= 0:
        raise AssertionError(
            f"resilience: degraded {engine.degraded}, decode programs "
            f"{engine.decode_compile_count}, counts {counts}")
    faulted = {"faults": dict(inj.counts), "failed_request": failed[0],
               "retries_total": engine.metrics.retries_total,
               "quarantined_total": engine.metrics.quarantined_total,
               "decode_blocks": engine.metrics.decode_blocks,
               "decode_compile_count": engine.decode_compile_count,
               "degraded_at_end": engine.degraded, "launch_counts": counts,
               **ties}
    del engine
    gc.collect()

    try:
        torch.empty(1 << 46, device=DEVICE)
        raise AssertionError("a 256 TiB allocation succeeded")
    except AssertionError:
        raise
    except Exception as e:  # noqa: BLE001 — classified just below
        oom = {"type": type(e).__name__,
               "is_resource_exhausted": is_resource_exhausted(e)}
    if not oom["is_resource_exhausted"]:
        raise AssertionError(f"resilience: a real OOM classified {oom}")

    # the crash drill: snapshots every tick, a kill at the prefill site
    # while fills are open, a restore from the last complete snapshot
    inj = FaultInjector([Fault("serve.prefill", "kill", tick=KILL_TICK)])
    engine = make_engine(graph, variables, faults=inj,
                         snapshot_every_ticks=1, **kw)
    zero_counts()
    results = {}
    _, killed = drive_until_killed(engine, prompts, 0, results)
    snap = engine.last_snapshot
    filling = len(engine._sched.filling)
    del engine
    gc.collect()
    if not killed or not filling:
        raise AssertionError(f"resilience: the kill did not land mid-fill "
                             f"(killed {killed}, fills open {filling})")
    rebuilt = ServeEngine.restore(snap, graph, variables, slots=SLOTS,
                                  decode_block=DECODE_BLOCK,
                                  max_queue=N_REQUESTS, device=DEVICE, **kw)
    # requests submitted after the snapshot died with the engine: they
    # arrive again, and take the same ids
    drive_until_killed(rebuilt, prompts, snap["next_id"], results)
    counts = read_counts()
    if len(results) != N_REQUESTS or any(
            r.status != "completed" for r in results.values()):
        raise AssertionError("resilience crash drill: not every request "
                             "completed")
    drill = {"kill_tick": KILL_TICK, "snapshot_tick": snap["tick"],
             "restored_active": len(snap["active"]),
             "restored_queued": len(snap["queued"]),
             "launch_counts": counts,
             **check_near_ties(graph, variables, "crash drill", results,
                               clean, exact=False)}
    del rebuilt
    gc.collect()

    flipped = integrity.flip_bit_json(snap, 11)
    try:
        ServeEngine.restore(flipped, graph, variables, device=DEVICE)
        raise AssertionError("a bit-flipped snapshot restored")
    except SnapshotCorruption as e:
        corrupt = {"raised": type(e).__name__, "expected": e.expected,
                   "actual": e.actual}
    log(f"resilience: faulted run {faulted}; OOM {oom}; crash drill "
        f"{drill}; corrupt snapshot {corrupt}")
    return {"faulted": faulted, "real_oom": oom, "crash_drill": drill,
            "corrupt_snapshot": corrupt}


# -- generation and the weight-int8 engines --------------------------------------


def zero_counts() -> None:
    import torch

    import mmlspark_tpu_torch.ops.flash_attention as fa
    import mmlspark_tpu_torch.ops.fused_optim as fo

    torch.cuda.synchronize()
    for name in COUNTERS:
        setattr(fa, name, 0)
    fo.launches = 0


def read_counts() -> dict:
    import torch

    import mmlspark_tpu_torch.ops.flash_attention as fa
    import mmlspark_tpu_torch.ops.fused_optim as fo

    torch.cuda.synchronize()
    return {**{name: getattr(fa, name) for name in COUNTERS},
            "fused_optim_launches": fo.launches}


def timed_path(fn):
    """One main path: the counts set to 0 just before ``fn()`` and read
    just after; returns (its result, wall ms, the counts)."""
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    counts = read_counts()
    return out, (time.perf_counter() - t0) * 1e3, counts


def numpy_support(logits: np.ndarray, temperature, top_k, top_p):
    """The tokens JAX's ``generate`` may sample from ``logits`` (B, V):
    its top-k and nucleus filter (``mmlspark_tpu/models/generate.py``
    l.330-348) transcribed in numpy, independent of the port's code."""
    x = logits.astype(np.float32) / np.float32(temperature)
    kth = -np.sort(-x, axis=-1)[:, top_k - 1:top_k]
    x = np.where(x < kth, -np.inf, x)
    srt = -np.sort(-x, axis=-1)
    z = np.exp(srt - srt[:, :1])
    probs = z / z.sum(axis=-1, keepdims=True)
    kept = np.cumsum(probs, axis=-1) - probs < top_p
    thresh = np.min(np.where(kept, srt, np.inf), axis=-1, keepdims=True)
    return x >= thresh


def check_launches(label: str, counts: dict, counter: str, want: int):
    if counts[counter] < want:
        raise AssertionError(f"{label}: {counter} = {counts[counter]}, "
                             f"wanted at least {want}: the path did not "
                             "go through the kernel")


def check_sampling(graph, variables, prompts) -> dict:
    """Sampled generation twice from one seed: equal streams, and every
    drawn token inside the support recomputed from its step's logits."""
    import importlib

    import torch

    from mmlspark_tpu_torch.models import generate

    gen_mod = importlib.import_module("mmlspark_tpu_torch.models.generate")
    filter_logits = gen_mod.filter_logits
    steps = []

    def recorded(logits, *args):  # each step's logits, as sampled
        steps.append(logits.float().cpu().numpy())
        return filter_logits(logits, *args)

    def run(seed):
        return generate(graph, variables, prompts, GEN_NEW,
                        rng=torch.Generator(device=DEVICE).manual_seed(seed),
                        device=DEVICE, **SAMPLING)

    gen_mod.filter_logits = recorded
    try:
        first, ms, counts = timed_path(lambda: run(0))
        recorded_steps, steps[:] = list(steps), []
        again = run(0)
    finally:
        gen_mod.filter_logits = filter_logits
    depth = SERVE_MODEL["depth"]
    check_launches("sampling", counts, "launches", depth * (GEN_NEW - 1))
    if not torch.equal(first, again):
        raise AssertionError("sampling: one seed gave two streams")
    drawn = first[:, GEN_PROMPT:].cpu().numpy()
    outside = 0
    for t, logits in enumerate(recorded_steps):
        support = numpy_support(logits, **SAMPLING)
        outside += int((~support[np.arange(GEN_BATCH), drawn[:, t]]).sum())
    kept = [int(numpy_support(lg, **SAMPLING).sum(axis=1).mean())
            for lg in recorded_steps[::32]]
    log(f"sampling: {GEN_BATCH} x {GEN_NEW} tokens in {ms:.1f} ms, counts "
        f"{counts}, {outside} drawn outside the support, mean support "
        f"{kept}")
    if len(recorded_steps) != GEN_NEW or outside:
        raise AssertionError(f"sampling: {len(recorded_steps)} steps, "
                             f"{outside} tokens outside the support")
    return {"wall_ms": ms, "launch_counts": counts, "equal_streams": True,
            "tokens_outside_support": outside,
            "mean_support_every_32_steps": kept, **SAMPLING}


def check_recompute(graph, variables, prompts) -> dict:
    """Greedy ``kv_cache=False`` (the flash forward over the whole
    buffer) against the cached path (the decode kernel): tokens equal,
    or a row's first difference at a near tie of the recompute logits;
    and each cached step's logits against a teacher-forced forward over
    the cached tokens, within BF16_LOGIT_TOL."""
    import importlib

    import torch

    from mmlspark_tpu_torch.models import generate

    gen_mod = importlib.import_module("mmlspark_tpu_torch.models.generate")
    greedy_next = gen_mod.greedy_next
    steps = []

    def recorded(logits):
        steps.append(logits.float())
        return greedy_next(logits)

    gen_mod.greedy_next = recorded
    try:
        cached, cached_ms, cached_counts = timed_path(lambda: generate(
            graph, variables, prompts, GEN_NEW, device=DEVICE))
    finally:
        gen_mod.greedy_next = greedy_next
    recompute, ms, counts = timed_path(lambda: generate(
        graph, variables, prompts, GEN_NEW, kv_cache=False, device=DEVICE))
    depth = SERVE_MODEL["depth"]
    check_launches("cached greedy", cached_counts, "launches",
                   depth * (GEN_NEW - 1))
    check_launches("recompute", counts, "fwd_mma_launches", depth * GEN_NEW)
    # the recompute path's logits of the cached tokens, every position
    forced = graph.apply(variables, cached)[:, GEN_PROMPT - 1:-1].float()
    step_logits = torch.stack(steps, dim=1)  # (B, N, V)
    logit_err = (step_logits - forced).abs().max().item()
    near_ties, diverged = 0, []
    got, want = recompute.cpu().numpy(), cached.cpu().numpy()
    for row in range(GEN_BATCH):
        diff = np.nonzero(got[row] != want[row])[0]
        if not diff.size:
            continue
        i = int(diff[0])
        top2 = forced[row, i - GEN_PROMPT].sort().values[-2:]
        margin = float(top2[1] - top2[0])
        diverged.append({"row": row, "token": i, "margin": margin})
        if i < GEN_PROMPT or not margin < BF16_LOGIT_TOL:
            raise AssertionError(f"recompute: row {row} differs from the "
                                 f"cached path at token {i}, top-2 margin "
                                 f"{margin}")
        near_ties += 1
    log(f"recompute: {ms:.1f} ms (cached {cached_ms:.1f} ms), counts "
        f"{counts}, near ties {near_ties} {diverged}, cached step logits vs "
        f"teacher-forced: max abs err {logit_err:.4g} (tolerance "
        f"{BF16_LOGIT_TOL})")
    if not logit_err <= BF16_LOGIT_TOL:
        raise AssertionError(f"recompute: step logits differ by {logit_err}")
    return {"wall_ms": ms, "launch_counts": counts,
            "cached_wall_ms": cached_ms, "cached_launch_counts": cached_counts,
            "near_ties": near_ties, "diverged": diverged,
            "step_logits_max_abs_err": logit_err,
            "tolerance": BF16_LOGIT_TOL}, cached


def check_beam(graph, variables, prompts) -> dict:
    """``beam_search(beams=4)``: beams=1 equals greedy ``generate``, the
    ``return_all`` scores are sorted, and the best beam's score equals
    the sum of its tokens' log-probs under a teacher-forced forward,
    within 2 BF16_LOGIT_TOL a token (the chosen logit and a step's
    log-sum-exp)."""
    import torch

    from mmlspark_tpu_torch.models import beam_search, generate

    (seqs, scores), ms, counts = timed_path(lambda: beam_search(
        graph, variables, prompts, BEAM_NEW, beams=BEAMS, return_all=True,
        device=DEVICE))
    check_launches("beam search", counts, "launches",
                   SERVE_MODEL["depth"] * (BEAM_NEW - 1))
    one = beam_search(graph, variables, prompts, BEAM_NEW, beams=1,
                      device=DEVICE)
    greedy = generate(graph, variables, prompts, BEAM_NEW, device=DEVICE)
    if not torch.equal(one, greedy):
        raise AssertionError("beam search: beams=1 differs from greedy")
    if not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        raise AssertionError(f"beam search: scores not sorted: {scores}")
    best = seqs[:, 0]
    lp = torch.log_softmax(graph.apply(variables, best).float(), dim=-1)
    tok = best[:, GEN_PROMPT:].long()
    forced = lp[:, GEN_PROMPT - 1:-1].gather(-1, tok[..., None]).sum(
        dim=(1, 2))
    err = (forced - scores[:, 0]).abs().max().item()
    tol = BEAM_NEW * 2 * BF16_LOGIT_TOL
    log(f"beam search: {GEN_BATCH} x {BEAMS} beams x {BEAM_NEW} tokens in "
        f"{ms:.1f} ms, counts {counts}, best scores "
        f"{scores[:, 0].tolist()}, teacher-forced max abs err {err:.4g} "
        f"(tolerance {tol})")
    if not err <= tol:
        raise AssertionError(f"beam search: best score differs from the "
                             f"teacher-forced sum by {err}")
    return {"wall_ms": ms, "launch_counts": counts, "beams": BEAMS,
            "best_scores": scores[:, 0].tolist(),
            "best_score_vs_teacher_forced_max_abs_err": err,
            "tolerance": tol, "beams_1_equals_greedy": True}


def check_generate(graph, variables) -> dict:
    """The generation paths at full width on GEN_BATCH seeded prompts of
    GEN_PROMPT tokens: sampling, the recompute oracle and beam search,
    each a main path of its own."""
    import torch

    rng = np.random.default_rng(7)
    prompts = torch.from_numpy(rng.integers(
        0, SERVE_MODEL["vocab_size"], size=(GEN_BATCH, GEN_PROMPT)).astype(
        np.int32)).to(DEVICE)
    recompute, _ = check_recompute(graph, variables, prompts)
    return {"sampling": check_sampling(graph, variables, prompts),
            "recompute": recompute,
            "beam_search": check_beam(graph, variables, prompts),
            "batch": GEN_BATCH, "prompt_len": GEN_PROMPT,
            "new_tokens": GEN_NEW, "beam_new_tokens": BEAM_NEW}


def check_quantized_engines(graph, variables, dense: dict) -> dict:
    """The random schedule through ``quantize_weights=True`` with dense
    bf16 KV and with paged int8 KV: every request completes through the
    decode kernels, the flip rate against the bf16 engine's streams, the
    device-resident weight bytes against f32, the engine's peak device
    memory over what was allocated before it, and no bf16 weight left
    bound after a call. Then the per-call dequantization alone."""
    import torch

    from mmlspark_tpu_torch.ops.quantize import (
        dequantize_weights,
        quantized_bytes,
    )

    prompts = random_schedule()
    paged = dict(paged=True, page_size=PAGE_SIZE,
                 num_pages=paged_num_pages(), kv_dtype="int8")
    runs = {}
    for label, kw, counter in (
        ("weight-int8 dense bf16 KV", {}, "launches"),
        ("weight-int8 paged int8 KV", paged, "paged_q8_launches"),
    ):
        run, engine = graphed_run(label, graph, variables, prompts, counter,
                                  quantize_weights=True, **kw)
        peak = run["programs"]["peak_memory_bytes"]
        stored, f32 = quantized_bytes(engine.variables)
        if not stored <= 0.3 * f32:
            raise AssertionError(f"{label}: weights {stored} bytes of "
                                 f"{f32} as f32")
        if graph._bound is not None:
            raise AssertionError(f"{label}: the graph kept bf16 weights")
        run.update(flip_rate_vs_dense_bf16=flip_rate(dense["results"],
                                                     run["results"]),
                   weight_bytes=stored, weight_bytes_f32=f32,
                   peak_memory_bytes=peak)
        log(f"{label}: {run['metrics']['tokens_per_sec']:.1f} tokens/s, "
            f"flip rate {run['flip_rate_vs_dense_bf16']:.3f}, weights "
            f"{stored} of {f32} bytes as f32, peak {peak} bytes over the "
            f"baseline, graph pool {run['programs']['graph_pool_bytes']} "
            "bytes")
        runs[label] = run
        qvars = engine.variables
        del engine
        gc.collect()
    deq = time_ms(lambda v: dequantize_weights(v), [(qvars,)], reps=50)
    # every kernel of a call, from the profiler: the event timer's spin
    # may not outlast a host loop of ~100 launches a call
    deq_profiled = profiler_ms(lambda v: dequantize_weights(v), [(qvars,)],
                               "", reps=20)
    t0 = time.perf_counter()
    for _ in range(20):
        graph.bind(dequantize_weights(qvars))
        graph.unbind()
    bind_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    n_leaves = sum(1 for b in qvars.values() for t in b.values()
                   if isinstance(t, dict))
    log(f"dequantize_weights: device {deq.ms:.4f} ms (covered "
        f"{deq.covered}; profiler {deq_profiled:.4f} ms), host-paced "
        f"{deq.call_ms:.4f} ms a call over {n_leaves} int8 leaves; with "
        f"bind and unbind {bind_ms:.3f} ms of host time")
    return runs, {"device_ms": deq.ms, "device_timer_covered": deq.covered,
                  "profiler_ms": deq_profiled, "call_ms": deq.call_ms,
                  "bind_unbind_host_ms": bind_ms, "int8_leaves": n_leaves}


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
        zero_counts()
        trained = trainer.train(x, y, init_variables=variables)
        counts = read_counts()
    finally:
        transformer.dense_attention = dense
    peak = torch.cuda.max_memory_allocated()
    programs = trainer.telemetry.counter("retrace.train.step").value
    capture_s = trainer.telemetry.gauge("train.step_capture_s").value
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
        f"attention calls {len(dense_calls)}, step {step_ms:.2f} ms, "
        f"{programs} step program captured in {capture_s} s")
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training {label}: losses {losses}")
    if not counts["fwd_launches"] == counts["bwd_kv_launches"] == \
            counts["bwd_q_launches"] == want:
        raise AssertionError(f"training {label}: {counts}, wanted {want} "
                             "launches of each attention kernel")
    # bf16 at head dim 64: every attention launch takes the tensor cores
    for name in ATTN_COUNTERS:
        if counts[name.replace("_launches", "_mma_launches")] != want:
            raise AssertionError(f"training {label}: {counts}: a {name} "
                                 "launch did not take the mma kernel")
    if dense_calls:
        raise AssertionError(f"training {label}: dense attention ran "
                             f"{len(dense_calls)} times")
    # one step program, captured, and one fused optimizer pass a step
    # (the CPU, in a rehearsal, captures nothing and runs the plain update)
    if programs != 1 or DEVICE == "cuda" and not (
            capture_s > 0 and counts["fused_optim_launches"] == steps):
        raise AssertionError(f"training {label}: {programs} step programs "
                             f"(capture {capture_s} s), fused optimizer "
                             f"launches {counts['fused_optim_launches']}")
    return {
        "model": model, "steps": steps, "batch": TRAIN_BATCH,
        "losses": losses, "launch_counts": counts,
        "step_programs": programs, "step_capture_s": capture_s,
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

    import mmlspark_tpu_torch.ops.flash_attention as fa

    graph = f32_graph(attn_impl="flash")
    weights = init_variables(graph, seed, device="cpu")
    x, y = progression_rows(2, seed)
    results = {}
    before = {n: getattr(fa, n) for n in ATTN_COUNTERS + ATTN_MMA_COUNTERS}
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
    added = {n: getattr(fa, n) - before[n] for n in before}
    # float32: every attention kernel on the f32-FMA route, none on mma
    depth = SERVE_MODEL["depth"]
    if added != {**dict.fromkeys(ATTN_COUNTERS, depth),
                 **dict.fromkeys(ATTN_MMA_COUNTERS, 0)}:
        raise AssertionError(f"train step card vs CPU: launches {added}")
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
                batch=TRAIN_BATCH, seq=SERVE_MODEL["max_len"], step=2,
                step_programs=trainer.telemetry.counter(
                    "retrace.train.step").value)


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
    engine.step()  # admissions and a first block (eager, then captured)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(device_profile(prof, wall_ms), block=DECODE_BLOCK,
                slots_live=SLOTS,
                decode_compile_count=engine.decode_compile_count,
                replayed=engine.decode_compile_count == 1)


# -- timing ----------------------------------------------------------------------


class Timing(NamedTuple):
    """``ms``: the device's time for one call (the queue held full, so
    each pair of events brackets only the device's work); ``call_ms``:
    the same pair recorded as the host issues each call (what an eager
    caller pays a call: the wrapper's host time, or the device's where
    that is longer); ``covered``: whether the device still had work
    queued when the host finished issuing the device-timed loop."""

    ms: float
    call_ms: float
    covered: bool


_sleep_rate = []  # spin-kernel cycles per ms, measured once


def sleep_cycles_per_ms() -> float:
    """The rate at which ``torch.cuda._sleep`` spins, on this card."""
    import torch

    if not _sleep_rate:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _sleep_rate.append(10 ** 7 / start.elapsed_time(end))
    return _sleep_rate[0]


def event_loop(fn, arg_sets, reps: int) -> list:
    """``reps`` calls of ``fn``, rotating over ``arg_sets`` so consecutive
    launches read different memory, each between its own pair of CUDA
    events."""
    import torch

    events = []
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        args = arg_sets[r % len(arg_sets)]
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    return events


def time_ms(fn, arg_sets, reps: int = 200) -> Timing:
    """Median CUDA-event times of ``fn(*args)``: host-paced (``call_ms``:
    the events are recorded as the host issues each call, so an interval
    holds the wrapper's host time whenever the host is slower than the
    device), then device-only (``ms``): a spin kernel, twice as long as
    the host took to issue the whole loop, holds the stream while the
    host enqueues the loop again, so the device runs the calls back to
    back and each pair brackets only its work. Should the spin end
    before the host is done, it is doubled and the loop rerun."""
    import torch

    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = event_loop(fn, arg_sets, reps)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    call_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    stream = torch.cuda.current_stream()
    for attempt in range(3):
        torch.cuda._sleep(int(2 ** (attempt + 1) * host_ms
                              * sleep_cycles_per_ms()))
        events = event_loop(fn, arg_sets, reps)
        covered = not stream.query()  # the device still busy: never idle
        torch.cuda.synchronize()
        if covered:
            break
    ms = statistics.median(s.elapsed_time(e) for s, e in events)
    return Timing(ms, call_ms, covered)


def graph_ms(fn, arg_sets, replays: int = 20) -> float:
    """Device ms a call of ``fn`` when one CUDA graph holds a call on each
    of ``arg_sets`` (rotating through more memory than the L2) and is
    replayed back to back: the kernels' time with no launch gap between
    calls, as a captured decode block runs them."""
    import torch

    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(arg_sets))


def profiler_ms(fn, arg_sets, name: str, reps: int = 50) -> float:
    """Mean device time of the kernels whose name holds ``name`` over
    ``reps`` calls, from ``torch.profiler``: a cross-check of the event
    timer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            fn(*arg_sets[r % len(arg_sets)])
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key)
    return total / 1e3 / reps


#: the timed shape of every kernel: the slice's (B=8, L=512, H=Hkv=8,
#: D=64, bf16 query) with every row half full; paged: pages of 16, 32 a
#: row
TIMED = dict(b=8, L=512, h=8, hk=8, d=64, live=256)


def kernel_row(name, source, replaces, launches, max_abs_err, kernel_t,
               plain_t, library_t, n_bytes, n_flops, flops_per_s, shape,
               **notes):
    """One row of the ``kernels`` line from the three ``Timing``s (the
    library's None where no one call computes the function): ``ms``,
    ``plain_ms`` and ``library_ms`` are device times, the ``*call_ms``
    their host-paced twins. The bound is the larger of the bytes over
    the card's memory rate and the operations over its peak rate for the
    kernel's arithmetic."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / flops_per_s * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_t.ms,
        "plain_ms": plain_t.ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_t.ms if library_t else None,
        "call_ms": kernel_t.call_ms,
        "plain_call_ms": plain_t.call_ms,
        "library_call_ms": library_t.call_ms if library_t else None,
        "ratio_to_library": (kernel_t.ms / library_t.ms if library_t
                             else None),
        # per timing: the device still had work queued when the host
        # finished issuing the device-timed loop
        "device_timer_covered": {
            "kernel": kernel_t.covered, "plain": plain_t.covered,
            "library": library_t.covered if library_t else None},
        **notes,
        "shape": shape,
        "bytes": n_bytes,
        "flops": n_flops,
    }


def decode_row(name, source, replaces, launches, max_abs_err, kernel_t,
               plain_t, library_t, n_bytes, kv_dtype, library=None,
               **notes):
    """A decode kernel's row at the TIMED shape: q.k and p.v, 2 flops a
    multiply-add, at the f32 rate (the kernels compute in f32). The
    kernel's time is its wrapper's two launches, split-KV partials and
    their combine."""
    t = TIMED
    return kernel_row(
        name, source, replaces, launches, max_abs_err, kernel_t, plain_t,
        library_t, n_bytes, 4 * t["b"] * t["live"] * t["h"] * t["d"],
        F32_FLOPS_PER_S, dict(t, dtype="bfloat16", kv_dtype=kv_dtype),
        library=library,
        design="split-KV: one block per (chunk of 64 positions, kv head, "
               "row), then a combine kernel (decode_attention.cuh)",
        **notes)


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
    def dense(q, k, v):
        return flash_decode(q, k, v, lens)

    kernel_t = time_ms(dense, sets)
    # the event timer's device time against the profiler's: the kernels
    # of one call (split-KV partials and their combine), summed; and the
    # calls replayed from one CUDA graph
    profiled = profiler_ms(dense, sets, "decode_")
    graphed = graph_ms(dense, sets)
    log(f"flash_decode device time: events {kernel_t.ms:.5f} ms, profiler "
        f"{profiled:.5f} ms, in a CUDA graph {graphed:.5f} ms a call "
        f"(host-paced {kernel_t.call_ms:.5f})")
    rows.append(decode_row(
        "flash_decode", src + "flash_decode.cu", f"{jax_file}:586",
        launches["launches"], errors["slice/bfloat16"], kernel_t,
        time_ms(lambda q, k, v: flash_decode_reference(q, k, v, lens), sets),
        time_ms(F.scaled_dot_product_attention, lib_sets),
        io_bytes(2), "bfloat16", "scaled_dot_product_attention",
        profiler_ms=profiled, graph_ms=graphed))
    del sets, lib_sets

    # int8 dense: no single PyTorch call attends over int8 K/V with scales
    sets = []
    for _ in range(ROTATE_BYTES // (2 * b * L * hk * d) + 1):
        q = torch.randn((b, 1, h, d), generator=gen).bfloat16().to(DEVICE)
        k8, ks = int8_kv((b, L, hk, d), (b, hk), gen)
        v8, vs = int8_kv((b, L, hk, d), (b, hk), gen)
        sets.append((q, k8, v8, ks, vs))
    def q8(q, k, v, ks, vs):
        return flash_decode(q, k, v, lens, k_scale=ks, v_scale=vs)

    rows.append(decode_row(
        "flash_decode_q8", src + "flash_decode.cu", f"{jax_file}:640",
        launches["q8_launches"], errors["q8_slice/bfloat16"],
        time_ms(q8, sets),
        time_ms(lambda q, k, v, ks, vs: flash_decode_reference(
            q, k, v, lens, k_scale=ks, v_scale=vs), sets),
        None, io_bytes(1) + 2 * b * hk * 4, "int8",
        graph_ms=graph_ms(q8, sets)))
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
    def paged(q, k, v, pt):
        return paged_flash_decode(q, k, v, lens, pt)

    rows.append(decode_row(
        "paged_flash_decode", src + "paged_flash_decode.cu",
        f"{jax_file}:894", launches["paged_launches"],
        errors["paged_slice/bfloat16"],
        time_ms(paged, sets),
        time_ms(lambda q, k, v, pt: paged_flash_decode_reference(
            q, k, v, lens, pt), sets),
        time_ms(F.scaled_dot_product_attention, lib_sets),
        io_bytes(2) + table_bytes, "bfloat16",
        "scaled_dot_product_attention on the gathered live K/V (a "
        "yardstick without the page indirection)",
        graph_ms=graph_ms(paged, sets)))
    del sets, lib_sets

    sets = [paged_set(True) for _ in range(ROTATE_BYTES // (per_set // 2)
                                           + 1)]
    def paged_q8(q, k, v, pt, ks, vs):
        return paged_flash_decode(q, k, v, lens, pt, k_scale=ks, v_scale=vs)

    rows.append(decode_row(
        "paged_flash_decode_q8", src + "paged_flash_decode.cu",
        f"{jax_file}:942", launches["paged_q8_launches"],
        errors["paged_q8_slice/bfloat16"],
        time_ms(paged_q8, sets),
        time_ms(lambda q, k, v, pt, ks, vs: paged_flash_decode_reference(
            q, k, v, lens, pt, k_scale=ks, v_scale=vs), sets),
        None, io_bytes(1) + table_bytes + 2 * b * live_pages * hk * 4,
        "int8", graph_ms=graph_ms(paged_q8, sets)))
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


def backward_sets(b, s, h, hk, d, causal, window, seed, with_library):
    """Enough bf16 input sets at this shape that the backward call reading
    the fewest bytes rotates through more than the rotation floor: q, k,
    v, dO, the forward's (out, lse) and the backward's operands; with
    ``with_library``, SDPA on the same tensors in its (B, H, S, D) layout
    with the forward kept, so that its backward can be timed alone."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import flash_attention as fa

    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    work = attention_work(b, s, h, hk, d, causal, window)
    sets = []
    for i in range(ROTATE_BYTES // min(n for n, _ in work.values()) + 1):
        q, k, v, g = attention_inputs(b, s, h, hk, d, torch.bfloat16,
                                      seed=seed + i)
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        st = dict(q=q, k=k, v=v, g=g, out=out, lse=lse,
                  ops=fa._backward_operands(q, k, v, out, lse, g))
        if with_library:
            lib = [x.transpose(1, 2).detach().requires_grad_(True)
                   for x in (q, k, v)]
            st.update(lib=lib, lib_g=g.transpose(1, 2),
                      lib_out=F.scaled_dot_product_attention(
                          *lib, is_causal=causal))
        sets.append(st)
    return sets, kw, work


def backward_kernels(kw, mma: bool):
    """The two backward kernels of a route, each alone on a set's
    operands."""
    from mmlspark_tpu_torch.ops import flash_attention as fa

    args = (kw["causal"], kw["window"], kw["scale"], mma)
    return (lambda st: fa._launch_bwd_kv(st["ops"], *args),
            lambda st: fa._launch_bwd_q(st["ops"], *args))


def measure_attention_kernels(errors: dict, launches: dict):
    """The three attention kernels at the training shape: kernel, plain
    version and the SDPA yardstick, as ``kernels`` rows; and the
    ``attention_backward`` summary. The backward rows' plain version is
    the whole plain backward (dq, dk and dv in one), and their library
    call SDPA's backward alone, both backward kernels' work together;
    SDPA's backward computes D = rowsum(dO * out) itself, so the fair
    comparison is the whole ``flash_attention_backward`` call, which the
    summary times beside the two kernels."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import flash_attention as fa

    t = TIMED_ATTN
    b, s, h, hk, d = (t[k] for k in ("b", "s", "h", "hk", "d"))
    sets, kw, work = backward_sets(b, s, h, hk, d, t["causal"], t["window"],
                                   200, with_library=True)
    arg_sets = [(st,) for st in sets]

    def timed(fn):
        return time_ms(fn, arg_sets)

    src = "mmlspark_tpu_torch/csrc/"
    jax_file = "mmlspark_tpu/ops/flash_attention.py"
    shape = dict(t, dtype="bfloat16")
    err = errors["slice/bfloat16"]
    plain_bwd = timed(lambda st: fa.flash_attention_backward_reference(
        st["q"], st["k"], st["v"], st["out"], st["lse"], st["g"], **kw))
    lib_bwd = timed(lambda st: torch.autograd.grad(
        st["lib_out"], st["lib"], st["lib_g"], retain_graph=True))
    kv, dq = backward_kernels(kw, mma=True)
    kv_simt, dq_simt = backward_kernels(kw, mma=False)
    kv_t, dq_t = timed(kv), timed(dq)
    simt_t = {"bwd_kv": timed(kv_simt), "bwd_q": timed(dq_simt)}
    profiled = {"bwd_kv": profiler_ms(kv, arg_sets, "flash_bwd_kv_mma"),
                "bwd_q": profiler_ms(dq, arg_sets, "flash_bwd_q_mma")}
    whole = timed(lambda st: fa.flash_attention_backward(
        st["q"], st["k"], st["v"], st["out"], st["lse"], st["g"], **kw))
    pair = timed(lambda st: (kv(st), dq(st)))
    operands = timed(lambda st: fa._backward_operands(
        st["q"], st["k"], st["v"], st["out"], st["lse"], st["g"]))
    log(f"backward device times: dK/dV {kv_t.ms:.5f} ms (profiler "
        f"{profiled['bwd_kv']:.5f}, simt {simt_t['bwd_kv'].ms:.5f}), dQ "
        f"{dq_t.ms:.5f} (profiler {profiled['bwd_q']:.5f}, simt "
        f"{simt_t['bwd_q'].ms:.5f}), whole call {whole.ms:.5f}, SDPA's "
        f"backward {lib_bwd.ms:.5f}")
    bwd_notes = dict(
        plain="flash_attention_backward_reference: dq, dk and dv together",
        library="scaled_dot_product_attention's backward alone: both "
                "backward kernels together, and D = rowsum(dO * out)")

    def forward(st):
        return fa.flash_attention_forward(st["q"], st["k"], st["v"], **kw)

    fwd = timed(forward)
    # the event timer's device time against the profiler's, same launches
    fwd_profiled = profiler_ms(forward, arg_sets, "flash_fwd")
    log(f"forward device time: events {fwd.ms:.5f} ms, profiler "
        f"{fwd_profiled:.5f} ms a launch (host-paced {fwd.call_ms:.5f})")
    bwd_design = ("mma.sync m16n8k16 bf16 tensor cores, cp.async double "
                  "buffer, P and dS fed back in registers (the bf16 route; "
                  "f32 and other head dims keep flash_attention_bwd.cu)")
    rows = [
        kernel_row(
            "flash_attention_fwd", src + "flash_attention_fwd_mma.cu",
            f"{jax_file}:123", launches["fwd_mma_launches"], err["out"], fwd,
            timed(lambda st: fa.flash_attention_reference(
                st["q"], st["k"], st["v"], **kw)),
            timed(lambda st: F.scaled_dot_product_attention(
                *(x.detach() for x in st["lib"]), is_causal=True)),
            *work["flash_attention_fwd"], BF16_FLOPS_PER_S, shape,
            library="scaled_dot_product_attention, causal",
            design="mma.sync m16n8k16 bf16 tensor cores, cp.async double "
                   "buffer (the bf16 route; f32 and other head dims keep "
                   "flash_attention_fwd.cu)",
            profiler_ms=fwd_profiled),
        kernel_row(
            "flash_attention_bwd_kv", src + "flash_attention_bwd_mma.cu",
            f"{jax_file}:285", launches["bwd_kv_mma_launches"],
            max(err["dk_abs"], err["dv_abs"]), kv_t, plain_bwd, lib_bwd,
            *work["flash_attention_bwd_kv"], BF16_FLOPS_PER_S, shape,
            design=bwd_design, profiler_ms=profiled["bwd_kv"],
            simt_ms=simt_t["bwd_kv"].ms, **bwd_notes),
        kernel_row(
            "flash_attention_bwd_q", src + "flash_attention_bwd_mma.cu",
            f"{jax_file}:330", launches["bwd_q_mma_launches"],
            err["dq_abs"], dq_t, plain_bwd, lib_bwd,
            *work["flash_attention_bwd_q"], BF16_FLOPS_PER_S, shape,
            design=bwd_design, profiler_ms=profiled["bwd_q"],
            simt_ms=simt_t["bwd_q"].ms, **bwd_notes),
    ]
    del sets, arg_sets
    timings = {"whole_call": whole, "operands_and_row_delta": operands,
               "kernels_together": pair, "bwd_kv": kv_t, "bwd_q": dq_t,
               "simt_bwd_kv": simt_t["bwd_kv"],
               "simt_bwd_q": simt_t["bwd_q"], "sdpa_backward": lib_bwd}
    summary = {
        "shape": shape,
        **{f"{name}_ms": tm.ms for name, tm in timings.items()},
        **{f"{name}_profiler_ms": ms for name, ms in profiled.items()},
        "whole_call_call_ms": whole.call_ms,
        "whole_call_over_sdpa": whole.ms / lib_bwd.ms,
        "kernels_over_sdpa": pair.ms / lib_bwd.ms,
        "simt_over_mma": {
            name: simt_t[name].ms / tm.ms
            for name, tm in (("bwd_kv", kv_t), ("bwd_q", dq_t))},
        "device_timer_covered": {name: tm.covered
                                 for name, tm in timings.items()},
        "gqa_window": measure_gqa_backward(),
    }
    return rows, summary


#: the GQA training run's attention shape (SMALL_TRAIN_MODEL, batch 8):
#: its dK/dV grid is 8 key tiles x 16 (row, kv head) = 128 blocks
TIMED_GQA = dict(b=8, s=512, h=8, hk=2, d=64, causal=True, window=128)


def measure_gqa_backward() -> dict:
    """Both backward routes' kernels at the GQA run's shape, device
    times (no one PyTorch call computes windowed GQA attention's
    backward through a flash kernel, so no library time)."""
    t = TIMED_GQA
    sets, kw, work = backward_sets(*(t[k] for k in (
        "b", "s", "h", "hk", "d", "causal", "window")), 300,
        with_library=False)
    arg_sets = [(st,) for st in sets]
    out = {"shape": dict(t, dtype="bfloat16")}
    for mma in (True, False):
        for name, fn in zip(("bwd_kv", "bwd_q"), backward_kernels(kw, mma)):
            tm = time_ms(fn, arg_sets)
            route = "mma" if mma else "simt"
            out[f"{route}_{name}_ms"] = tm.ms
            out[f"{route}_{name}_covered"] = tm.covered
    for name in ("bwd_kv", "bwd_q"):
        n_bytes, n_flops = work[f"flash_attention_{name}"]
        out[f"{name}_bound_ms"] = max(n_bytes / HBM_BYTES_PER_S,
                                      n_flops / BF16_FLOPS_PER_S) * 1e3
    log(f"GQA window backward: {out}")
    return out


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
    for key in ("paging", "hits", "flip_rate_vs_dense_bf16", "diverged",
                "weight_bytes", "weight_bytes_f32", "peak_memory_bytes",
                "programs"):
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
    optim_equal = check_fused_optimizer()

    graph = build_model("transformer_lm", **SERVE_MODEL)
    variables = init_variables(graph, 0, device=DEVICE)
    t0 = time.perf_counter()
    dense = check_engine(graph, variables)
    header = check_header_engines(graph, variables)
    log(f"engine phases took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    chunked, clean = check_chunked_async(graph, variables, header)
    resilience = check_resilience(graph, variables, clean)
    del clean
    log(f"chunked/async and resilience phases took "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    generation = check_generate(graph, variables)
    quantized, dequantize = check_quantized_engines(graph, variables, dense)
    log(f"generation and weight-int8 phases took "
        f"{time.perf_counter() - t0:.1f}s")
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
    attn_rows, attn_backward = measure_attention_kernels(
        attn_errors, training["launch_counts"])
    rows = measure_kernels(errors, launches) + attn_rows + [
        measure_fused_optimizer(
            optim_equal, training["launch_counts"]["fused_optim_launches"])]
    print(json.dumps({"kernel_errors": errors,
                      "attention_kernel_errors": attn_errors,
                      "fused_optimizer_bit_equal": optim_equal,
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
    print(json.dumps({"generate": generation}))
    print(json.dumps({"quantized_weights": {
        label: engine_summary(run) for label, run in quantized.items()},
        "dequantize_per_call": dequantize}))
    print(json.dumps({"programs": {
        label: run["programs"] for label, run in (
            ("dense bf16", dense), *header.items(), *quantized.items())}}))
    print(json.dumps({"training": training,
                      "small_training": small_training}))
    print(json.dumps({"profile": profile_decode_block(graph, variables)}))
    print(json.dumps({"train_profile": profile_train_step(trained)}))
    print(json.dumps({"attention_backward": attn_backward}))
    print(json.dumps({"chunked_async": chunked}))
    print(json.dumps({"resilience": resilience}))
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
