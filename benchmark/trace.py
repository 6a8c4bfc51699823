"""The reduction of a ``torch.profiler`` trace of the card to numbers.

Every device operation (kernel, copy or fill) is an interval on the
card's timeline. The busy time is the length of their union over the
traced window, so overlapping operations count once; a kernel's time is
the sum of its own intervals. Idle gaps are the holes in the union, each
named by the spans open on the host when it began: the harness's own
(``bench.step``, ``bench.submit``, ``bench.wait``) and, inside a step,
the program's innermost annotation (``serve.prefill``, ``serve.decode``,
...). Ranges that annotate the timeline are not operations and are left
out of the union.
"""

from __future__ import annotations

import time

import torch

#: prefixes of the names of ranges that annotate, not operate
ANNOTATIONS = ("ProfilerStep", "bench.", "serve.", "train.")


def span(name: str):
    """A harness span on the profiler's timeline (a no-op range push
    when no profiler runs)."""
    return torch.profiler.record_function(f"bench.{name}")


def _is_device_op(e) -> bool:
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return False
    if getattr(e, "is_user_annotation", False):
        return False
    return not e.name.startswith(ANNOTATIONS)


def _merge(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _open_at(spans: list, t: float) -> str | None:
    """The innermost (latest-starting) span of ``spans`` open at ``t``."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or a > best[0]):
            best = (a, name)
    return best[1] if best else None


def summarize(events, window_s: float, top: int = 10) -> dict:
    """Busy seconds, per-kernel seconds and the longest gaps of a traced
    window of ``window_s`` seconds from the profiler's events."""
    ops, bench, program = [], [], []
    for e in events:
        tr = e.time_range
        if _is_device_op(e):
            ops.append((tr.start, tr.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            if e.name.startswith("bench."):
                bench.append((tr.start, tr.end, e.name[len("bench."):]))
            elif e.name.startswith(("serve.", "train.")):
                program.append((tr.start, tr.end, e.name))
    per_kernel: dict[str, float] = {}
    for a, b, name in ops:
        per_kernel[name] = per_kernel.get(name, 0.0) + (b - a) * 1e-6
    merged = _merge([(a, b) for a, b, _ in ops])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = []
    if bench:
        lo, hi = min(s[0] for s in bench), max(s[1] for s in bench)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b > a:
                gaps.append((b - a, a))
    gaps.sort(reverse=True)
    named = []
    for length, at in gaps[:top]:
        host = _open_at(bench, at) or "none"
        inner = _open_at(program, at)
        named.append([f"{host}:{inner}" if inner else host, length * 1e-6])
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy,
        "window_s": window_s,
        "per_kernel_s": per_kernel,
        "device_ops": [[k[:120], s] for k, s in kernels[:top]],
        "idle_gaps": named,
    }


def kernel_seconds(summary: dict, *names: str) -> float:
    """The device seconds of every operation whose name holds one of
    ``names``."""
    return sum(s for k, s in summary["per_kernel_s"].items()
               if any(n in k for n in names))


class Tracer:
    """Starts the profiler at a step boundary and stops it after its
    window; ``summary`` holds the reduction once it has stopped."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._device = device
        self._make = lambda: profile(activities=acts)
        self.prof = None
        self.t_start = None
        self.summary = None

    def warm(self) -> None:
        """Start and stop the profiler once, so that its own start-up is
        paid in set-up and not inside the window."""
        with self._make():
            torch.ones(8, device=self._device).sum().item()

    def start(self) -> None:
        self._sync()
        self.prof = self._make()
        self.prof.__enter__()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        window_s = time.perf_counter() - self.t_start
        self.prof.__exit__(None, None, None)
        self.summary = summarize(self.prof.events(), window_s)
        self.prof = None

    def _sync(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize()
