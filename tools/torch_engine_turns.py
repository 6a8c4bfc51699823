#!/usr/bin/env python3
"""Time the port's dense serving engine and its training step of several
checkouts in turns, on one CUDA card, in one process per turn.

    python3 tools/torch_engine_turns.py DIR [DIR ...]

Each DIR is the root of a checkout (the same one may repeat, as in
``parent . . parent``). In turn, each one's own ``chip_smoke.py`` builds
that checkout's kernels, runs its dense bf16 engine phase
(``check_engine``: the full-width model, 16 requests of the random
schedule), profiles one steady decode block (``profile_decode_block``),
then trains the full-width model for its 8 steps (``run_training``) and
profiles one steady training step (``profile_train_step``). One JSON
line a turn, then a summary line: ``{"turns": [...]}`` with each turn's
directory, tokens/s, TTFT p50/p99, per-token ms, wall s, the decode
block's device busy share and wall ms, and the training step's wall ms
(median of steps 2+) and device busy share. Needs a GPU; a turn that
fails stops the run with its exit code.
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
import chip_smoke as c
from mmlspark_tpu_torch.models import build_model, init_variables
if not torch.cuda.is_available():
    sys.exit("needs a CUDA GPU")
c.build_kernels()
graph = build_model("transformer_lm", **c.SERVE_MODEL)
variables = init_variables(graph, 0, device="cuda")
run = c.check_engine(graph, variables)
profile = c.profile_decode_block(graph, variables)
training, trained = c.run_training("full width", c.TRAIN_MODEL,
                                   c.TRAIN_STEPS, seed=5)
train_profile = c.profile_train_step(trained)
print(json.dumps(dict(c.engine_summary(run), profile=profile,
                      training=training, train_profile=train_profile)))
"""

KEYS = ("tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99", "per_token_ms",
        "wall_s")
#: a tree whose engine captures its programs also reports the warm pass
#: (the schedule again, every program captured) and the capture time
PROGRAM_KEYS = ("capture_s", "warm_tokens_per_sec", "warm_per_token_ms",
                "warm_per_token_ms_p50", "eager_tokens_per_sec")


def main(dirs: list[str]) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    turns = []
    for d in dirs:
        root = Path(d).resolve()
        out = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            print(f"turn in {d} failed with exit code {out.returncode}",
                  file=sys.stderr)
            return out.returncode
        summary = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"dir": d, **summary}), flush=True)
        programs = summary.get("programs", {})  # trees with CUDA graphs
        turns.append({"dir": d, **{k: summary[k] for k in KEYS},
                      **{k: programs[k] for k in PROGRAM_KEYS
                         if k in programs},
                      "decode_block_busy_share":
                          summary["profile"]["device_busy_share"],
                      "decode_block_wall_ms": summary["profile"]["wall_ms"],
                      "train_step_ms":
                          summary["training"]["step_ms_median_steps_2_on"],
                      "train_step_busy_share":
                          summary["train_profile"]["device_busy_share"],
                      "train_step_profiled_wall_ms":
                          summary["train_profile"]["wall_ms"]})
    print(json.dumps({"turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
