"""Device timing by CUDA events and the yardsticks read beside it (the
attention kernels' work, the names of matrix-product kernels), shared
by the evidence tools and ``chip_smoke.py``'s kernel table."""

from __future__ import annotations

import statistics
import time
from typing import NamedTuple

import torch

#: substrings of the kernel names that are convolutions or matrix products
#: (cuDNN's and cuBLAS's implicit-GEMM kernels on the H100)
MATMUL_KERNEL_KEYS = ("conv", "fprop", "xmma", "implicit", "cutlass", "gemm",
                      "sm90_", "sm80_")


def live_pairs(s: int, causal: bool, window) -> int:
    """The (query, key) pairs an attention over ``s`` positions scores:
    all of them, the causal triangle, or the causal band of ``window``."""
    if not causal:
        return s * s
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_work(b, s, h, hk, d, causal, window, elem=2) -> dict:
    """{kernel: (bytes, flops)} for one call of each attention kernel at
    this shape: each input read once and each output written once (the
    backward kernels read D = rowsum(dO * out), not out), and 2 flops a
    multiply-add over the live (query, key) pairs: q.k and p.v forward;
    q.k, dO.v, dV and dK for dK/dV; q.k, dO.v and dQ for dQ."""
    pairs = live_pairs(s, causal, window)
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


def attention_fwd_bwd_work(b, s, h, hk, d, causal, window,
                           elem=2) -> tuple:
    """(bytes, flops) that attention's forward and backward need as one
    function, whatever kernels split it: q, k, v and dO read once; out,
    dq, dk and dv written once; the row statistics LSE and D =
    rowsum(dO * out) once each. Seven matrix products over the live
    pairs: q.k and p.v forward, then q.k again (the probabilities are
    not stored), dO.v, dV, dK and dQ. The kernels recompute q.k and
    dO.v in each backward kernel (nine products, ``attention_work``),
    so their sum is not the function's bound."""
    pairs = live_pairs(s, causal, window)
    qo = b * s * h * d * elem
    kv = b * s * hk * d * elem
    rows = b * h * s * 4
    return (4 * qo + 4 * kv + 2 * rows, 7 * 2 * b * h * d * pairs)


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
