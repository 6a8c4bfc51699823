#!/usr/bin/env python3
"""Time the trainer's one-rank mesh step against the plain step of
several checkouts in turns, on one CUDA card, in one process per turn.

    python3 mesh_step_turns.py [--profile] DIR [DIR ...]

Each DIR is the root of a checkout (the same one may repeat, as in
``parent . . parent``). In turn, each one's own ``chip_smoke.py`` builds
that checkout's kernels, starts a one-rank NCCL group and trains the
flash LM at the serve model's widths for ``MESH_STEPS`` steps through
``mesh_train_run`` four times: plain, ``TRANSFORMER_TP_RULES`` on
``{"data": 1, "model": 1}``, plain, mesh again, from the same weights on
the same batches. With ``--profile`` each turn also profiles one steady
(replayed) step of each under ``torch.profiler``: its wall ms, device
ms and top kernels. One JSON line a turn, then a summary line
``{"turns": [...]}`` with each turn's directory and step ms (median of
steps 2+). Needs a GPU; a turn that fails stops the run with its exit
code.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
import torch.distributed as dist
import chip_smoke as c
from mmlspark_tpu_torch.core.telemetry import FlightRecorder
from mmlspark_tpu_torch.models import build_model, init_variables
from mmlspark_tpu_torch.parallel import (
    TRANSFORMER_TP_RULES, initialize_distributed)
from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig
if not torch.cuda.is_available():
    sys.exit("needs a CUDA GPU")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.build_kernels()
initialize_distributed(f"127.0.0.1:{c.free_port()}", 1, 0)
out = {"device": c.device_line()}
x, y = c.progression_rows(c.MESH_STEPS * c.TRAIN_BATCH, c.MESH_SEED)
graph = build_model("transformer_lm", attn_impl="flash", **c.SERVE_MODEL)
weights = init_variables(graph, c.MESH_SEED, device="cuda")
mesh = dict(mesh_axes={"data": 1, "model": 1},
            param_rules=TRANSFORMER_TP_RULES)
for name, cfg in (("plain", {}), ("mesh", mesh), ("plain2", {}),
                  ("mesh2", mesh)):
    run, _ = c.mesh_train_run(name, graph, weights, x, y, **cfg)
    out[name] = {"step_ms": run["step_ms_median_steps_2_on"],
                 "collective_calls": run["collective_calls"]}
if PROFILE:
    from torch.profiler import ProfilerActivity, profile, schedule
    for name, cfg in (("plain", {}), ("mesh", mesh)):
        class Stepping(FlightRecorder):
            def record(self, ev, **attrs):
                super().record(ev, **attrs)
                if ev == "step":
                    prof.step()
        rec = Stepping()
        trainer = SPMDTrainer(graph, TrainConfig(
            epochs=1, batch_size=c.TRAIN_BATCH, learning_rate=1e-3,
            log_every=1, **cfg), recorder=rec, device="cuda")
        px, py = c.progression_rows(4 * c.TRAIN_BATCH, 11)
        torch.cuda.synchronize()
        # the third step (a replay) is the active window
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=2, warmup=0, active=1,
                                       repeat=1)) as prof:
            trainer.train(px, py, init_variables=weights)
        stamps = [e["t"] for e in rec.events() if e["name"] == "step"]
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")]
        out["profile_" + name] = {
            "wall_ms": (stamps[2] - stamps[1]) * 1e3,
            "device_ms": sum(e.self_device_time_total
                             for e in kernels) / 1e3,
            "kernels": sorted(
                ({"name": e.key[:90], "count": e.count,
                  "ms": e.self_device_time_total / 1e3}
                 for e in kernels), key=lambda k: -k["ms"])[:40]}
dist.destroy_process_group()
print("TURN " + json.dumps(out))
"""


def main(argv: list[str]) -> int:
    profile = "--profile" in argv
    dirs = [a for a in argv if a != "--profile"]
    if not dirs:
        print(__doc__)
        return 2
    turns = []
    code = TURN.replace("PROFILE", str(profile))
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", code],
                              cwd=Path(d).resolve(), capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(proc.stdout[-4000:])
            return proc.returncode
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("TURN ")][-1]
        turn = dict(json.loads(line[5:]), dir=d)
        print(json.dumps(turn))
        turns.append(turn)
    print(json.dumps({"turns": [
        {"dir": t["dir"], **{k: t[k]["step_ms"] for k in (
            "plain", "mesh", "plain2", "mesh2")}} for t in turns]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
