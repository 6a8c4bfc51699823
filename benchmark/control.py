"""Read a cell's compared number for the program and for its control.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at the cell's own load, then the comparison of the
sample with the reference (the program's widest and mean gap) and, at
the same positions of the same sequences, the gaps of the tokens that
the float8 control ranks first. Both are judged by the harness's own
``correct`` (``benchmark.check.verdict``) with the workload file's
limits. One JSON line a seed, with both verdicts; the exit code is 0
only when the program is correct and the control is not on every seed.
The benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import cache_dirs, end_to_end, judge, serve_window
from benchmark.spec import ROOT, load_cell


def main(argv=None, *, root=ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cache_dirs(root)
    cell = load_cell(args.workload, root)
    import torch

    device = torch.device(args.device)
    separated = True
    for seed in (int(s) for s in args.seeds.split(",")):
        w = serve_window(cell, seed, args.seconds, False, device)
        verdict = judge(cell, seed, w.outcome, device, control=True)
        separated &= verdict["correct"] and not verdict["control_correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": verdict["correct"],
                          "control_correct": verdict["control_correct"],
                          **verdict["gaps"],
                          "readings": end_to_end(w.outcome, w.setup_s)}),
              flush=True)
    print(f"benchmark.control: {args.workload}: program correct and "
          f"control not on every seed: {separated}", file=sys.stderr)
    return 0 if separated else 1


if __name__ == "__main__":
    sys.exit(main())
