#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``csrc/``, holds each
against its plain PyTorch version, drives the serving path at the full
width of the repo's serve model, and prints the measured numbers.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit on error):

1. the card's name and power limit, from ``nvidia-smi``;
2. kernel vs plain: ``flash_decode`` on the card against
   ``flash_decode_reference`` on the same CUDA tensors, at the serving
   shapes and at GQA, D=128 and strided-view cases;
3. the engine: ``transformer_lm(vocab_size=8192, d_model=512, heads=8,
   depth=8, max_len=512)`` with seeded random weights under
   ``ServeEngine(slots=8, cache_len=512, decode_block=32)``, 16 requests
   arriving 2 a tick; every request must complete, the decode path must
   have launched the kernel ``depth`` times per micro-step, and 4 of the
   streams must equal the port's own ``generate()`` token for token;
   plus the full-width model's cached decode on the card against the
   same forward on the CPU, in float32;
4. numbers: kernel, plain-version and library times (CUDA events,
   inputs rotated through more memory than the 50 MB L2 so each launch
   reads cold), the kernel's bound, the engine's throughput, and one
   steady decode block under ``torch.profiler`` (device busy share and
   the kernels that take its time).

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

#: H100 SXM, NVIDIA's data sheet: HBM3 bandwidth and the float32 rate
#: outside the tensor cores (the kernel's arithmetic is f32 FMAs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
#: what the rotation of timing inputs must exceed: twice the L2 cache
ROTATE_BYTES = 2 * 50 * 2**20

SERVE_MODEL = dict(vocab_size=8192, d_model=512, heads=8, depth=8,
                   max_len=512)
SLOTS, CACHE_LEN, DECODE_BLOCK = 8, 512, 32
N_REQUESTS, MAX_NEW, ARRIVALS_PER_TICK = 16, 64, 2
N_CHECKED = 4
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
#: f32: both versions accumulate in f32 and differ only in the order of
#: the sums. bf16: both outputs round to bf16 at the end, and one bf16
#: ulp at |out| < 2 is 2^-7 = 0.0078
TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-2}


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


def check_kernels() -> dict:
    import torch

    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_decode,
        flash_decode_reference,
    )

    errors = {}
    for i, (name, b, L, h, hk, d, lengths, strided) in enumerate(
            KERNEL_CASES):
        lengths = SLICE_LENGTHS if lengths is None else lengths
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = kernel_inputs(b, L, h, hk, d, dtype, strided, seed=i)
            got = flash_decode(q, k, v, lens)
            torch.cuda.synchronize()
            want = flash_decode_reference(q, k, v, lens)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[str(dtype).split(".")[1]]
            key = f"{name}/{str(dtype).split('.')[1]}"
            errors[key] = err
            log(f"kernel vs plain {key}: max abs err {err:.3g} "
                f"(tolerance {tol})")
            if not err <= tol:
                raise AssertionError(
                    f"flash_decode {key}: max abs err {err} > {tol}"
                )
            # a row with no live positions gives exact zeros
            for row, n in enumerate(lengths):
                if n == 0 and got[row].abs().max().item() != 0.0:
                    raise AssertionError(f"{key}: length-0 row {row} "
                                         "is not all zeros")
    return errors


def drive_engine(graph, variables):
    """The main path: 16 requests through the engine, 2 arrivals a
    tick. Returns (results, metrics, kernel launches, micro-steps,
    prompts)."""
    import torch

    import mmlspark_tpu_torch.ops.flash_attention as fa
    from mmlspark_tpu_torch.serve import ServeEngine

    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(8, 65, size=N_REQUESTS)
    vocab = SERVE_MODEL["vocab_size"]
    prompts = [rng.integers(0, vocab, size=int(n)) for n in prompt_lens]

    # warm the CUDA libraries up on a throwaway engine, outside the run
    warm = ServeEngine(graph, variables, slots=SLOTS, cache_len=CACHE_LEN,
                       decode_block=DECODE_BLOCK, device=DEVICE)
    warm.submit(prompts[0], 4)
    warm.run()
    del warm

    engine = ServeEngine(graph, variables, slots=SLOTS, cache_len=CACHE_LEN,
                         decode_block=DECODE_BLOCK, max_queue=N_REQUESTS,
                         device=DEVICE)
    torch.cuda.synchronize()
    fa.launches = 0
    submitted, results = 0, {}
    while submitted < N_REQUESTS or engine.busy:
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < N_REQUESTS:
                engine.submit(prompts[submitted], MAX_NEW)
                submitted += 1
        for res in engine.step():
            results[res.id] = res
    torch.cuda.synchronize()
    launches = fa.launches
    micro_steps = sum(int(t) * n
                      for t, n in engine.metrics.decode_blocks.items())
    return results, engine.metrics.to_dict(), launches, micro_steps, prompts


def check_engine(graph, variables) -> dict:
    from mmlspark_tpu_torch.models import generate

    depth = SERVE_MODEL["depth"]
    results, metrics, launches, micro_steps, prompts = drive_engine(
        graph, variables)
    if len(results) != N_REQUESTS or any(
        r.status != "completed" or r.generated != MAX_NEW
        for r in results.values()
    ):
        raise AssertionError(
            "not every request completed: "
            + str({i: (r.status, r.generated) for i, r in results.items()})
        )
    for r in results.values():
        gen = r.tokens[r.prompt_len:]
        if gen.min() < 0 or gen.max() >= SERVE_MODEL["vocab_size"]:
            raise AssertionError(f"request {r.id}: token out of vocab")
    log(f"engine: {N_REQUESTS} requests completed, {micro_steps} decode "
        f"micro-steps, {launches} flash_decode launches")
    if launches < depth * micro_steps:
        raise AssertionError(
            f"flash_decode launched {launches} times over {micro_steps} "
            f"micro-steps of a {depth}-layer model: the decode path did "
            "not go through the kernel"
        )
    for rid in np.linspace(0, N_REQUESTS - 1, N_CHECKED).astype(int):
        want = generate(graph, variables, prompts[rid][None], MAX_NEW,
                        device=DEVICE)[0].cpu().numpy()
        got = results[int(rid)].tokens
        if not np.array_equal(got, want):
            first = int(np.argmax(got != want))
            raise AssertionError(
                f"request {rid}: engine stream differs from generate() "
                f"at token {first} (prompt length {len(prompts[rid])})"
            )
    log(f"engine streams equal generate() for {N_CHECKED} requests")
    return dict(metrics, flash_decode_launches=launches,
                decode_micro_steps=micro_steps)


def check_model_vs_cpu(seed: int = 1) -> float:
    """The full-width model in float32: prefill 15 tokens, then one
    decode step through the kernel on the card, against the same on the
    CPU (the plain path), on identical weights."""
    import torch

    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.models.generate import _cached_apply

    graph = build_model("transformer_lm", **SERVE_MODEL)
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
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


def profile_decode_block(graph, variables) -> dict:
    """Where one steady decode block's time goes: all 8 slots live, one
    T=32 block under ``torch.profiler``; the kernels' device time against
    the block's wall time gives the device's busy and idle shares."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.serve import ServeEngine

    engine = ServeEngine(graph, variables, slots=SLOTS, cache_len=CACHE_LEN,
                         decode_block=DECODE_BLOCK, device=DEVICE)
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "block": DECODE_BLOCK,
        "slots_live": SLOTS,
        "wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "top_kernels": [
            {"name": e.key[:80], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in top
        ],
    }


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


def measure_flash_decode(max_abs_err: float, launches: int,
                         micro_steps: int) -> dict:
    """flash_decode at the slice's shape (B=8, L=512, H=Hkv=8, D=64,
    bf16) with every row half full."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_decode,
        flash_decode_reference,
    )

    b, L, h, hk, d, live = 8, 512, 8, 8, 64, 256
    dtype = torch.bfloat16
    per_set = 2 * b * L * hk * d * 2
    n_sets = ROTATE_BYTES // per_set + 1
    lens = torch.full((b,), live, dtype=torch.int32, device=DEVICE)
    sets = [kernel_inputs(b, L, h, hk, d, dtype, False, seed=100 + i)
            for i in range(n_sets)]
    kernel_ms = time_ms(lambda q, k, v: flash_decode(q, k, v, lens), sets)
    plain_ms = time_ms(
        lambda q, k, v: flash_decode_reference(q, k, v, lens), sets)
    # the library yardstick on the same live work: (B, H, S, D) layout,
    # prepared outside the timing; the port never calls it
    lib_sets = [
        (q.transpose(1, 2).contiguous(),
         k[:, :live].transpose(1, 2).contiguous(),
         v[:, :live].transpose(1, 2).contiguous())
        for q, k, v in sets
    ]
    library_ms = time_ms(F.scaled_dot_product_attention, lib_sets)
    total_live = live * b
    n_bytes = (2 * total_live * hk * d * 2  # each live K and V row once
               + 2 * b * h * d * 2          # q in, out
               + b * 4)                      # lengths
    n_flops = 4 * total_live * h * d        # q.k and p.v, 2 flops a MAC
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / F32_FLOPS_PER_S * 1e3
    return {
        "name": "flash_decode",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_decode.cu",
        "replaces": "mmlspark_tpu/ops/flash_attention.py:586",
        "launches": launches,
        "launches_per_micro_step": (
            launches / micro_steps if micro_steps else None),
        "max_abs_err": max_abs_err,
        "max_err": max_abs_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "shape": {"B": b, "L": L, "H": h, "Hkv": hk, "D": d,
                  "dtype": "bfloat16", "live_per_row": live},
        "bytes": n_bytes,
    }


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

    smi = device_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    build_kernels()
    errors = check_kernels()

    graph = build_model("transformer_lm", **SERVE_MODEL)
    variables = init_variables(graph, 0, device=DEVICE)
    t0 = time.perf_counter()
    engine = check_engine(graph, variables)
    log(f"engine phase took {time.perf_counter() - t0:.1f}s")
    model_err = check_model_vs_cpu()

    row = measure_flash_decode(
        errors["slice/bfloat16"], engine["flash_decode_launches"],
        engine["decode_micro_steps"],
    )
    print(json.dumps({"kernel_errors": errors,
                      "model_f32_card_vs_cpu_max_abs_err": model_err}))
    print(json.dumps({"engine": {
        k: engine[k] for k in (
            "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99", "per_token_ms",
            "per_token_ms_p50", "tick_ms_p50", "completed",
            "tokens_generated", "wall_s", "decode_blocks",
            "decode_micro_steps", "flash_decode_launches",
            "slot_utilization_mean", "cache_pool_bytes_per_device",
        )
    }, "model": SERVE_MODEL, "slots": SLOTS, "cache_len": CACHE_LEN,
        "decode_block": DECODE_BLOCK}))
    print(json.dumps({"profile": profile_decode_block(graph, variables)}))
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
