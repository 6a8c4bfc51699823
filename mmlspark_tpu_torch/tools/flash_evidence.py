"""Proof of the flash attention kernels at the lengths they exist for —
the port of the repo's ``tools/flash_tpu_evidence.py``.

On the card, through :func:`~mmlspark_tpu_torch.ops.flash_attention.
flash_attention` (the forward kernel, and the dK/dV and dQ kernels under
``torch.autograd``):

1. numerics at (B=4, S=2048, H=8, D=64) bfloat16: the forward and all
   three input gradients against the plain versions
   (``flash_attention_reference`` and
   ``flash_attention_backward_reference``) on the same inputs, in three
   legs — ``full`` (non-causal), ``causal``, and ``window_gqa`` (causal,
   window 256, 2 kv heads: the window's dead-block skip and the dK/dV
   sum over a query-head group across many tiles). The gate is the
   scale-normalized error, max abs err / max(1, max|want|) <= 1e-2; the
   raw abs error is recorded, not gated;
2. device ms from CUDA events (:func:`~mmlspark_tpu_torch.tools.timing.
   time_ms`, the timer of ``chip_smoke.py``'s kernel table) of each leg's
   forward and forward+backward, beside ``scaled_dot_product_attention``
   on the same tensors (a yardstick only) and the leg's bound. The JAX
   tool sweeps Pallas block sizes (128/256/512); the Hopper kernels have
   fixed tiles, so the sweep here is the routes the shape takes:
   ``route_mma`` (the tensor-core kernels, bf16 rows on 16-byte
   boundaries) and ``route_simt`` (the f32-FMA kernels, on the same
   values placed one element off that boundary);
3. a long-context leg at S=8192 (B=1, H=8, D=64), causal and causal with
   window 1024: flash forward and forward+backward ms, SDPA's ms (an
   out-of-memory error is recorded, not raised) and each leg's bound —
   FLOPs over the card's bf16 peak (``core/perf.device_peak``) or bytes
   over its HBM rate, whichever is larger. The forward and the three
   gradients are held on a slice: a few heads of each against the plain
   versions run on those heads' inputs alone, so no (S, S) f32 tensor of
   the whole batch is formed.

With ``--device cpu`` the same legs run the plain versions on the host
(``flash_attention``'s CPU path) and nothing is timed. Writes
``build/evidence/FLASH_GPU_EVIDENCE.json`` (``--out`` to change it) only
when :func:`check_record` finds nothing; otherwise prints the record and
exits 3.

Usage: python -m mmlspark_tpu_torch evidence flash [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.perf import device_peak
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.tools import common
from mmlspark_tpu_torch.tools.timing import (
    attention_fwd_bwd_work,
    attention_work,
    time_ms,
)

B, S, H, D = 4, 2048, 8, 64
WINDOW, KV_HEADS = 256, 2
LONG_S, LONG_WINDOW = 8192, 1024
#: the heads of batch row 0 whose long-context output is held against the
#: plain version
LONG_HEADS = (0, 5)
TOL = 1e-2
#: the row LSE is f32 on both sides, its sum over up to 8192 keys taken
#: in other orders (|LSE| ~ 10: ~1e-6 relative)
LSE_TOL = 1e-4
#: what one rotation of timing inputs must exceed: twice the L2 cache
ROTATE_BYTES = 2 * 50 * 2**20
OUT_TEMPLATE = "FLASH_{}_EVIDENCE.json"
GRADS = ("dq", "dk", "dv")
METHOD = (
    "device ms a call: the median of CUDA-event pairs over calls issued "
    "behind a spin kernel that holds the stream (tools/timing.time_ms, "
    "the timer of chip_smoke.py's kernel table), inputs rotated through "
    "more than twice the L2 cache; fwd_bwd is the forward with its "
    "residuals plus torch.autograd's backward through both backward "
    "kernels. The JAX tool's Pallas block sweep (128/256/512) has no "
    "counterpart: the Hopper kernels have fixed tiles (64 positions), so "
    "route_mma and route_simt time the two kernel routes the shape takes "
    "on the same values. SDPA (torch's scaled_dot_product_attention on "
    "the same tensors, (B, H, S, D) views) is a yardstick only. bound_ms: "
    "the larger of the FLOPs of the live (query, key) pairs over the "
    "bf16 peak and each input read once and output written once over "
    "the HBM rate; fwd_bwd's work is the function's (seven matrix "
    "products a live pair, tools/timing.attention_fwd_bwd_work), not the "
    "sum of the three kernels' (nine: each backward kernel recomputes "
    "q.k and dO.v)"
)


def work(b, s, h, hk, d, causal, window) -> dict:
    """{"fwd" | "fwd_bwd": (bytes, flops)}: the forward kernel's, and what
    the forward and backward need as one function."""
    return {"fwd": attention_work(b, s, h, hk, d, causal,
                                  window)["flash_attention_fwd"],
            "fwd_bwd": attention_fwd_bwd_work(b, s, h, hk, d, causal,
                                              window)}


def bound(n_bytes: int, n_flops: int, dev) -> dict:
    peak = device_peak(dev)
    by_bytes = n_bytes / peak.hbm_bytes_per_s * 1e3
    by_flops = n_flops / peak.flops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_flops),
            "bound_by": "operations" if by_flops >= by_bytes else "bytes",
            "bytes": n_bytes, "flops": n_flops}


def _inputs(b, s, h, hk, d, seed, dev):
    """q, k, v and the cotangent g, bf16: ``np.random.default_rng(seed +
    i).normal`` draws, as the JAX tool makes its inputs."""
    shapes = ((b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d))
    return [torch.from_numpy(np.random.default_rng(seed + i).normal(
        size=shape).astype(np.float32)).to(device=dev, dtype=torch.bfloat16)
        for i, shape in enumerate(shapes)]


def numerics(q, k, v, g, causal: bool, window) -> dict:
    """The kernels' forward and gradients against the plain versions on
    the same inputs."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    got = (out.detach(), *torch.autograd.grad(out, leaves, g))
    want_out, lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                 window=window)
    want = (want_out, *fa.flash_attention_backward_reference(
        q, k, v, want_out, lse, g, causal=causal, window=window))
    rec = {}
    for name, a, w in zip(("fwd", *GRADS), got, want):
        rec[f"{name}_scaled_err"] = common.scaled_err(a, w)
        rec[f"{name}_max_abs_err"] = common.max_abs_err(a, w)
    return rec


def _misaligned(t):
    """``t``'s values in a buffer one element off a 16-byte boundary:
    the rows no longer qualify for the tensor-core route."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _timing_sets(q, k, v, g, seed, simt: bool = False):
    """Input sets at this shape rotating through more than ROTATE_BYTES:
    the numerics inputs first, then fresh draws; q, k and v require grad
    (the forward-only calls run under ``no_grad``)."""
    per = sum(t.numel() * t.element_size() for t in (q, k, v, g))
    sets = []
    for i in range(ROTATE_BYTES // per + 1):
        ts = (q, k, v, g) if i == 0 else [
            torch.randn(t.shape, dtype=t.dtype, device=t.device,
                        generator=torch.Generator(t.device).manual_seed(
                            seed + 10 * i + j))
            for j, t in enumerate((q, k, v, g))]
        if simt:
            ts = [_misaligned(t) for t in ts]
        qq, kk, vv = (t.detach().requires_grad_() for t in ts[:3])
        sets.append((qq, kk, vv, ts[3].detach()))
    return sets


def _flash_calls(causal, window):
    def fwd(q, k, v, g):
        with torch.no_grad():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

    def fwd_bwd(q, k, v, g):
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(out, (q, k, v), g)

    return fwd, fwd_bwd


def _sdpa_calls(s, causal, window, gqa: bool, dev):
    """SDPA on the same tensors in its (B, H, S, D) layout: causal by its
    flag; a window by an (S, S) boolean mask."""
    mask = None
    if window is not None:
        mask = fa._attention_live(s, causal, window, dev)
    kw = dict(attn_mask=mask, is_causal=causal and mask is None,
              enable_gqa=gqa)

    def attend(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)

    def fwd(q, k, v, g):
        with torch.no_grad():
            return attend(q, k, v)

    def fwd_bwd(q, k, v, g):
        return torch.autograd.grad(attend(q, k, v), (q, k, v),
                                   g.transpose(1, 2))

    return fwd, fwd_bwd


def _timed(fn, sets, reps: int) -> dict:
    t = time_ms(fn, sets, reps=reps)
    return {"ms": t.ms, "call_ms": t.call_ms, "device_timer_covered":
            t.covered}


def _guarded(fn, sets, reps: int) -> dict:
    """A yardstick's time, or the error that stopped it (an OOM is
    evidence too)."""
    try:
        return _timed(fn, sets, reps)
    except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
        torch.cuda.empty_cache()
        return {"error": f"{type(e).__name__}: {str(e)[:200]}"}


def leg_timing(q, k, v, g, causal, window, seed, reps: int = 100) -> dict:
    """Device ms of one leg's forward and forward+backward, SDPA's beside
    them, and the bounds."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    sets = _timing_sets(q, k, v, g, seed)
    fwd, fwd_bwd = _flash_calls(causal, window)
    sfwd, sfwd_bwd = _sdpa_calls(s, causal, window, hk != h, q.device)
    rec = {"fwd": _timed(fwd, sets, reps),
           "fwd_bwd": _timed(fwd_bwd, sets, reps // 2),
           "sdpa_fwd": _guarded(sfwd, sets, reps),
           "sdpa_fwd_bwd": _guarded(sfwd_bwd, sets, reps // 2)}
    for name, (n_bytes, n_flops) in work(b, s, h, hk, d, causal,
                                         window).items():
        rec[name].update(bound(n_bytes, n_flops, q.device))
        rec[name]["tflops_per_s"] = n_flops / rec[name]["ms"] / 1e9
    del sets
    return rec


def route_timing(q, k, v, g, seed, reps: int = 20) -> dict:
    """Both kernel routes at this shape: ``mma`` on the inputs as made,
    ``simt`` on the same values one element off a 16-byte boundary. The
    launch counters confirm which kernels ran."""
    fwd, fwd_bwd = _flash_calls(False, None)
    out = {}
    for route, simt in (("route_mma", False), ("route_simt", True)):
        sets = _timing_sets(q, k, v, g, seed, simt=simt)
        before = fa.fwd_mma_launches, fa.bwd_q_mma_launches
        took = fa._fwd_route(*sets[0][:3])
        out[route] = {"fwd": _timed(fwd, sets, reps),
                      "fwd_bwd": _timed(fwd_bwd, sets, reps),
                      "route": took,
                      "mma_launches": [fa.fwd_mma_launches - before[0],
                                       fa.bwd_q_mma_launches - before[1]]}
        del sets
    return out


def long_context(dev, seed: int, s: int, window: int, heads: tuple,
                 h: int, d: int, timed: bool) -> tuple[dict, dict]:
    """The S=``s`` legs (B=1, causal and causal with ``window``): the
    forward's output and row LSE, and the kernels' dq, dk and dv, held
    on ``heads`` against the plain versions run on those heads' inputs
    alone (the heads are independent: kv heads = heads), and (on the
    card) the times. Returns (numerics, timing)."""
    q, k, v, g = _inputs(1, s, h, h, d, seed, dev)
    num, tim = {"S": s, "B": 1, "heads_checked": list(heads)}, {}
    for name, win in (("causal", None), (f"window{window}", window)):
        out, lse = fa.flash_attention_forward(q, k, v, causal=True,
                                              window=win, scale=d ** -0.5)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        grads = torch.autograd.grad(
            fa.flash_attention(*leaves, causal=True, window=win), leaves, g)
        errs = {key: [] for key in ("fwd", "lse", *GRADS)}
        abs_errs = {key: [] for key in ("fwd", *GRADS)}
        for head in heads:
            part = slice(head, head + 1)
            qh, kh, vh, gh = (t[:, :, part] for t in (q, k, v, g))
            want, want_lse = fa.flash_attention_reference(
                qh, kh, vh, causal=True, window=win)
            want_grads = fa.flash_attention_backward_reference(
                qh, kh, vh, want, want_lse, gh, causal=True, window=win)
            pairs = [("fwd", out[:, :, part], want)] + [
                (key, grad[:, :, part], w)
                for key, grad, w in zip(GRADS, grads, want_grads)]
            for key, a, w in pairs:
                errs[key].append(common.scaled_err(a, w))
                abs_errs[key].append(common.max_abs_err(a, w))
            errs["lse"].append(common.scaled_err(lse[head:head + 1],
                                                 want_lse))
            del want, want_lse, want_grads
        num[name] = {"window": win}
        num[name].update({f"{key}_scaled_err": max(e)
                          for key, e in errs.items()})
        num[name].update({f"{key}_max_abs_err": max(e)
                          for key, e in abs_errs.items()})
        del out, lse, leaves, grads
        if timed:
            tim[name] = leg_timing(q, k, v, g, True, win, seed + 100,
                                   reps=20)
    return num, tim


def run(device=None, *, b: int = B, s: int = S, h: int = H, d: int = D,
        window: int = WINDOW, kv_heads: int = KV_HEADS,
        long_s: int = LONG_S, long_window: int = LONG_WINDOW,
        long_heads: tuple = LONG_HEADS, seed: int = 0) -> dict:
    """The record: numerics of the three legs, the long-context slice,
    and on the card the timings."""
    dev = default_device(device)
    timed = dev.type == "cuda"
    counters = {c: getattr(fa, c) for c in fa.COUNTERS}
    q, k, v, g = _inputs(b, s, h, h, d, seed, dev)
    kg, vg = _inputs(b, s, kv_heads, kv_heads, d, seed + 10, dev)[1:3]
    legs = {"full": (q, k, v, False, None),
            "causal": (q, k, v, True, None),
            "window_gqa": (q, kg, vg, True, window)}
    record = {
        "tool": "flash_evidence",
        "device": common.device_record(dev),
        "shape": {"B": b, "S": s, "H": h, "D": d, "dtype": "bfloat16"},
        "tolerance": TOL,
        "numerics": {},
        "interpret_mode": False,
    }
    for name, (qq, kk, vv, causal, win) in legs.items():
        rec = numerics(qq, kk, vv, g, causal, win)
        if name == "window_gqa":
            rec.update(window=win, kv_heads=kv_heads)
        record["numerics"][name] = rec
    long_num, long_tim = long_context(dev, seed + 20, long_s, long_window,
                                      long_heads, h, d, timed)
    record["numerics"]["long_context"] = long_num
    if timed:
        timing = {"method": METHOD}
        for name, (qq, kk, vv, causal, win) in legs.items():
            timing[name] = leg_timing(qq, kk, vv, g, causal, win,
                                      seed + 1000)
        timing.update(route_timing(q, k, v, g, seed + 2000))
        timing["long_context"] = {"S": long_s, "B": 1, **long_tim}
        record["timing"] = timing
    else:
        record["timing"] = "not measured"
    record["launches"] = {c: getattr(fa, c) - n for c, n in counters.items()}
    return record


def check_record(record: dict) -> list[str]:
    """The artifact contract: every leg's forward and gradients within
    TOL scaled, the long-context slice's forward and gradients within
    TOL and its LSE within LSE_TOL; on the card the
    forward and both backward kernels launched, every time measured and
    both routes timed; off the card nothing timed."""
    problems = []
    num = record.get("numerics", {})
    for leg in ("full", "causal", "window_gqa"):
        for key in ("fwd", *GRADS):
            err = num.get(leg, {}).get(f"{key}_scaled_err")
            if err is None or not err <= TOL:
                problems.append(f"{leg} {key}: scaled error {err} > {TOL}")
    long_num = num.get("long_context", {})
    for leg in [k for k, v in long_num.items() if isinstance(v, dict)] or \
            ["causal"]:
        rec = long_num.get(leg, {})
        for key, tol in (("fwd", TOL), ("lse", LSE_TOL),
                         *((grad, TOL) for grad in GRADS)):
            err = rec.get(f"{key}_scaled_err")
            if err is None or not err <= tol:
                problems.append(f"long context {leg} {key}: scaled error "
                                f"{err} > {tol}")
    timing = record.get("timing")
    if not common.on_card(record):
        if timing != "not measured":
            problems.append("timing off the card must read 'not measured'")
        return problems
    launches = record.get("launches", {})
    for c in ("fwd_launches", "bwd_kv_launches", "bwd_q_launches",
              "fwd_mma_launches", "bwd_kv_mma_launches",
              "bwd_q_mma_launches"):
        if not launches.get(c, 0) > 0:
            problems.append(f"{c} = {launches.get(c)}: a kernel of the "
                            "path never launched")
    if not isinstance(timing, dict):
        return problems + ["no timing on the card"]
    long_tim = timing.get("long_context", {})
    entries = [(leg, timing.get(leg, {})) for leg in (
        "full", "causal", "window_gqa", "route_mma", "route_simt")]
    entries += [(f"long_context {k}", v) for k, v in long_tim.items()
                if isinstance(v, dict)]
    if len(entries) < 7:
        problems.append("the long-context leg has no timing")
    for leg, rec in entries:
        for key in ("fwd", "fwd_bwd"):
            if not common.positive(rec.get(key, {}).get("ms")):
                problems.append(f"{leg} {key}: no device time")
        for key in ("sdpa_fwd", "sdpa_fwd_bwd"):
            if key in rec and not (common.positive(rec[key].get("ms"))
                                   or rec[key].get("error")):
                problems.append(f"{leg} {key}: neither a time nor an error")
    mma, simt = timing.get("route_mma", {}), timing.get("route_simt", {})
    if mma.get("route") != "mma" or simt.get("route") != "simt" or \
            not all(n > 0 for n in mma.get("mma_launches", [0])) or \
            any(simt.get("mma_launches", [1])):
        problems.append("the route timings did not take both routes")
    return problems


def main(argv: list[str] | None = None) -> int:
    p = common.parser("evidence flash", __doc__)
    args = p.parse_args(argv)
    dev = default_device(args.device)
    record = run(dev)
    return common.finish(record, check_record(record),
                         args.out or common.default_out(OUT_TEMPLATE, dev))


if __name__ == "__main__":
    sys.exit(main())
