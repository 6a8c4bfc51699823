"""A ``torch.profiler`` trace of the ResNet-50 forward on the card — the
port of the repo's ``tools/profile_resnet50.py``.

Scores ``batch`` seeded images through ``TPUModel`` (ResNet-50 at
``size``, seeded weights) once — the eager first batch, then the
capture — and then traces ``iters`` replays of the program it captured,
each synced, under :func:`~mmlspark_tpu_torch.utils.profiling.
trace_profile`. The Chrome trace goes under
``build/profiles/resnet50_torch/`` (``--out`` to change it), never under
the JAX tool's ``profiles/``, with the summary beside it
(``summary.json``); the summary is printed as one JSON line:

- from the trace: device ms a replay, the busy share, the top kernels by
  device time, and the share of convolution and matrix-product kernels
  (cuDNN's and cuBLAS's implicit-GEMM names);
- the BatchNorm share: a CUDA graph replay runs no host op a kernel could
  be told by, so one eager forward of the same batch is profiled with a
  range around each BatchNorm module, and the device time of the kernels
  launched inside those ranges is set over that forward's total;
- the untraced replay's ms and images/s.

With ``--device cpu`` the program runs eagerly on the host and the
summary holds its ops' host times, named as such.

Usage: python -m mmlspark_tpu_torch evidence profile [--size 224
--batch 256 --iters 10]
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time

import torch

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.tools import common
from mmlspark_tpu_torch.tools.timing import MATMUL_KERNEL_KEYS

SIZE, BATCH, ITERS = 224, 256, 10
OUT_DIR = common.REPO / "build" / "profiles" / "resnet50_torch"
TOP = 8



def trace_summary(path: str, iters: int, on_card: bool) -> dict:
    """Device ms a replay, the top kernels and the matmul share, from a
    Chrome trace written by ``trace_profile``: its ``kernel`` events on
    the card, its ``cpu_op`` events (host times) on the CPU."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    cat = "kernel" if on_card else "cpu_op"
    spans = sorted((float(ev["ts"]), float(ev["dur"]), ev["name"])
                   for ev in events if ev.get("cat") == cat and "dur" in ev)
    by_name: dict[str, list] = {}
    end = float("-inf")
    for ts, dur, name in spans:
        if ts >= end:  # kernels never nest; a host op's callees do
            by_name.setdefault(name, []).append(dur)
            end = ts + dur if not on_card else end
    total_us = sum(sum(d) for d in by_name.values())
    mm_us = sum(sum(d) for name, d in by_name.items()
                if any(k in name.lower() for k in MATMUL_KERNEL_KEYS))
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:TOP]
    unit = "device" if on_card else "host"
    return {
        "time_source": ("kernel events of the trace (device time)"
                        if on_card else
                        "cpu_op events of the trace (host time, not a "
                        "device time)"),
        f"{unit}_ms_per_batch": total_us / 1e3 / iters,
        ("kernel_launches" if on_card else "top_level_ops") + "_per_batch":
            sum(len(d) for d in by_name.values()) / iters,
        "matmul_kernel_share": mm_us / total_us if total_us else None,
        "top": [{"name": name[:100], "count": len(d),
                 "ms_per_batch": sum(d) / 1e3 / iters} for name, d in top],
    }


def _kernel_us(event) -> float:
    """Device time of the kernels a host op and its callees launched."""
    return sum(k.duration for k in event.kernels) + sum(
        _kernel_us(c) for c in event.cpu_children)


def batchnorm_share(graph, variables, x, dev) -> dict:
    """One eager forward under ``torch.profiler`` with a range around each
    BatchNorm module: the device (on the CPU: host) time of the work
    inside those ranges over the forward's total."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mmlspark_tpu_torch.models.resnet import BatchNorm

    ranges = []

    def enter(mod, args):
        ranges.append(record_function("BatchNorm"))
        ranges[-1].__enter__()

    def leave(mod, args, out):
        ranges.pop().__exit__(None, None, None)

    hooks = [h for _, block in graph.blocks for m in block.modules()
             if isinstance(m, BatchNorm)
             for h in (m.register_forward_pre_hook(enter),
                       m.register_forward_hook(leave))]
    on_card = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    try:
        with torch.no_grad():
            graph.apply(variables, x)  # warm
            common.sync(dev)
            with profile(activities=activities) as prof:
                graph.apply(variables, x)
                common.sync(dev)
    finally:
        for h in hooks:
            h.remove()
    events = prof.events()
    if on_card:
        # the profiler mirrors each range on the device as an annotation
        # event spanning its kernels: count kernels, not those spans
        total = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name != "BatchNorm")
        bn = sum(_kernel_us(c) for e in events if e.name == "BatchNorm"
                 and e.device_type == torch.autograd.DeviceType.CPU
                 for c in e.cpu_children)
    else:
        top = [e for e in events if e.cpu_parent is None]
        total = sum(e.cpu_time_total for e in top)
        bn = sum(e.cpu_time_total for e in events if e.name == "BatchNorm")
    return {"modules": len(hooks) // 2,
            ("device" if on_card else "host") + "_ms": bn / 1e3,
            "share": bn / total if total else None,
            "of_ms": total / 1e3}


def run(device=None, *, size: int = SIZE, batch: int = BATCH,
        iters: int = ITERS, out: str | None = None, seed: int = 0) -> dict:
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.stages import TPUModel
    from mmlspark_tpu_torch.utils.profiling import trace_profile

    dev = default_device(device)
    on_card = dev.type == "cuda"
    out = str(out or OUT_DIR)
    stage = TPUModel(model_name="resnet50", model_config={"input_size": size},
                     input_col="image", batch_size=batch, device=str(dev))
    graph = stage.graph()
    variables = init_variables(graph, seed, device=dev)
    stage.set(weights=variables)
    images = torch.randn((batch, size, size, 3),
                         generator=torch.Generator().manual_seed(seed)).numpy()
    t0 = time.perf_counter()
    stage.transform(Dataset({"image": images}))  # eager batch, then capture
    cold_s = time.perf_counter() - t0
    program, weights = stage.captured_forward()
    x = torch.from_numpy(images).to(dev)
    program(weights, x)
    common.sync(dev)
    before = set(glob.glob(os.path.join(out, "*.json")))
    with trace_profile(out):
        t0 = time.perf_counter()
        for _ in range(iters):
            program(weights, x)
            common.sync(dev)
        traced_s = (time.perf_counter() - t0) / iters
    (trace,) = set(glob.glob(os.path.join(out, "*.json"))) - before
    t0 = time.perf_counter()
    for _ in range(iters):
        program(weights, x)
        common.sync(dev)
    step_s = (time.perf_counter() - t0) / iters
    summary = trace_summary(trace, iters, on_card)
    record = {
        "tool": "profile_resnet50",
        "device": common.device_record(dev),
        "model": {"name": "resnet50", "input_size": size},
        "batch": batch, "iters": iters,
        "trace": os.path.relpath(trace, common.REPO)
        if trace.startswith(str(common.REPO)) else trace,
        "program_captured": on_card and stage.capture_seconds > 0,
        "cold_transform_s": cold_s,
        "replay": summary,
        "batchnorm": batchnorm_share(graph, weights, x, dev),
        ("untraced_step_ms" if on_card else "untraced_step_host_ms"):
            step_s * 1e3,
        "images_per_sec": batch / step_s,
    }
    if on_card:
        # the traced window's: device time over its wall time
        record["replay"]["busy_share"] = (summary["device_ms_per_batch"]
                                          / (traced_s * 1e3))
    return record


def check_record(record: dict) -> list[str]:
    """A trace was written; it holds work, top entries and the shares; on
    the card the program was a captured graph and the trace has device
    time below the untraced step's wall time."""
    problems = []
    replay = record.get("replay", {})
    if not record.get("trace"):
        problems.append("no trace written")
    if not replay.get("top"):
        problems.append("the trace holds no kernels or ops")
    share = replay.get("matmul_kernel_share")
    if share is None or not 0.0 <= share <= 1.0:
        problems.append(f"matmul kernel share {share}")
    bn = record.get("batchnorm", {})
    if not bn.get("modules") or bn.get("share") is None or \
            not 0.0 < bn["share"] < 1.0:
        problems.append(f"BatchNorm share {bn.get('share')} over "
                        f"{bn.get('modules')} modules")
    if not common.positive(record.get("images_per_sec")):
        problems.append("no images/s")
    if common.on_card(record):
        if not record.get("program_captured"):
            problems.append("the replayed program was not a CUDA graph")
        ms = replay.get("device_ms_per_batch")
        if not common.positive(ms) or \
                not ms <= record.get("untraced_step_ms", 0) * 1.05:
            problems.append(f"device ms a batch {ms} against the untraced "
                            f"step {record.get('untraced_step_ms')}")
        # the eager forward runs the kernels the program replays
        if not common.positive(ms) or \
                not 0.8 * ms <= bn.get("of_ms", 0) <= 1.25 * ms:
            problems.append(f"the eager forward's device ms {bn.get('of_ms')}"
                            f" against the replay's {ms}")
    return problems


def main(argv: list[str] | None = None) -> int:
    p = common.parser("evidence profile", __doc__)
    p.add_argument("--size", type=int, help=f"image side (default {SIZE})")
    p.add_argument("--batch", type=int, help=f"rows (default {BATCH})")
    p.add_argument("--iters", type=int,
                   help=f"traced replays (default {ITERS})")
    args = p.parse_args(argv)
    dev = default_device(args.device)
    out = args.out or str(OUT_DIR)
    given = {k: getattr(args, k) for k in ("size", "batch", "iters")
             if getattr(args, k) is not None}
    record = run(dev, out=out, **given)
    return common.finish(record, check_record(record),
                         os.path.join(out, "summary.json"))


if __name__ == "__main__":
    sys.exit(main())
