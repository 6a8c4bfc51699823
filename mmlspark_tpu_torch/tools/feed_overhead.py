"""``TPUModel``'s feed machinery against the model-only ceiling — the
port of the repo's ``tools/feed_overhead_bench.py``.

ResNet-20 (CIFAR-10, seeded weights) over ``rows`` seeded images:

- the model-only ceiling: the batches sliced and copied to the device
  beforehand, then the stage's own forward program (a replayed CUDA
  graph on the card) on each with a host fetch of its output (the stage
  fetches its outputs too, so the ceiling includes that);
- the stage: ``TPUModel.transform`` end to end at feed depths 1, 2, 4
  and 8 from the same host-memory ``Dataset``, best of ``trials``.

The JAX tool runs on its CPU backend, where host->device is a memcpy, so
its gap is the machinery alone. Here the tool runs on the card unless
``--device cpu`` is given: on the card the gap also holds the real
pinned host-to-device copy of every batch, which the ceiling does not
pay. The stage's scores are held against the ceiling's outputs (the same
program on the same rows). ``MMLTPU_FEED_BATCH``, ``MMLTPU_FEED_ROWS``
and ``MMLTPU_FEED_TRIALS`` set the sizes, as in the JAX tool.

Writes ``build/evidence/FEED_OVERHEAD_GPU.json`` (``..._CPU.json`` with
``--device cpu``; ``--out`` to change it) when :func:`check_record` finds
nothing, and prints the record as one JSON line.

Usage: python -m mmlspark_tpu_torch evidence feed [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.tools import common

BATCH = int(os.environ.get("MMLTPU_FEED_BATCH", "256"))
ROWS = int(os.environ.get("MMLTPU_FEED_ROWS", "4096"))
DEPTHS = (1, 2, 4, 8)
TRIALS = int(os.environ.get("MMLTPU_FEED_TRIALS", "3"))
OUT_TEMPLATE = "FEED_OVERHEAD_{}.json"
#: the stage's scores against the ceiling's: the same program on the
#: same rows, so only a lost or misplaced row (an O(1) change) fails it
SCORE_TOL = 1e-5




def run(device=None, *, rows: int = ROWS, batch: int = BATCH,
        trials: int = TRIALS, depths: tuple = DEPTHS, seed: int = 0) -> dict:
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.stages import TPUModel

    dev = default_device(device)
    graph = build_model("resnet20_cifar10")
    variables = init_variables(graph, seed, device=dev)
    x = np.random.default_rng(3).normal(size=(rows, 32, 32, 3)).astype(
        np.float32)
    ds = Dataset({"image": x})

    def stage_at(depth: int):
        return TPUModel.from_graph(
            graph, variables, "resnet20_cifar10", input_col="image",
            output_col="scores", batch_size=batch, feed_depth=depth,
            device=str(dev))

    # -- model-only ceiling: the stage's own program, inputs resident ----
    ceiling = stage_at(1)
    ceiling.transform(ds)  # the eager batch, then the capture
    program, weights = ceiling.captured_forward()
    batches = [torch.from_numpy(x[i:i + batch]).to(dev)
               for i in range(0, rows - rows % batch, batch)]
    model_rows = len(batches) * batch
    outs = []

    def model_only():
        outs.clear()
        for b in batches:
            outs.append(program(weights, b).cpu().numpy())

    t_model = common.best_seconds(model_only, trials, dev)
    model_ips = model_rows / t_model
    want = np.concatenate(outs)

    # -- the whole stage at each feed depth -----------------------------
    per_depth, err = {}, 0.0
    for depth in depths:
        stage = stage_at(depth)
        got = stage.transform(ds)["scores"]  # warm: eager batch + capture
        err = max(err, float(np.abs(got[:model_rows] - want).max()))
        dt = common.best_seconds(lambda s=stage: s.transform(ds), trials,
                                 dev)
        per_depth[depth] = rows / dt
    best = max(per_depth, key=per_depth.get)
    on_card = dev.type == "cuda"
    return {
        "tool": "feed_overhead",
        "device": common.device_record(dev),
        "metric": "feed_overhead_fraction",
        # the share of the model-only ceiling the stage loses at its best
        # depth
        "value": 1.0 - per_depth[best] / model_ips,
        "unit": "fraction_of_ceiling_lost",
        "model_only_images_per_sec": model_ips,
        "stage_images_per_sec_per_depth": {str(d): v
                                           for d, v in per_depth.items()},
        "stage_over_model_ratio_best": per_depth[best] / model_ips,
        "best_feed_depth": best,
        "scores_max_abs_diff_vs_model_only": err,
        "batch": batch, "rows": rows, "trials": trials,
        "backend": (
            "the card: the stage copies every batch from pinned host memory "
            "(a real host-to-device copy) and the ceiling reads batches "
            "already on the card, so the gap holds that copy as well as the "
            "feed machinery" if on_card else
            "the CPU: host-to-device is no copy, so the gap is the feed "
            "machinery alone (host times, not device times)"),
    }


def check_record(record: dict) -> list[str]:
    """Every depth measured, every rate a positive number, the best depth
    one of them, and the stage's scores equal to the ceiling's."""
    problems = []
    rates = record.get("stage_images_per_sec_per_depth", {})
    if sorted(int(d) for d in rates) != sorted(DEPTHS):
        problems.append(f"feed depths measured: {sorted(rates)}")
    for name, value in [("model only", record.get(
            "model_only_images_per_sec"))] + list(rates.items()):
        if not common.positive(value):
            problems.append(f"images/s at {name}: {value}")
    if str(record.get("best_feed_depth")) not in rates:
        problems.append(f"best depth {record.get('best_feed_depth')}")
    err = record.get("scores_max_abs_diff_vs_model_only")
    if err is None or not err <= SCORE_TOL:
        problems.append(f"the stage's scores differ from the model-only "
                        f"outputs by {err} > {SCORE_TOL}")
    return problems


def main(argv: list[str] | None = None) -> int:
    p = common.parser("evidence feed", __doc__)
    args = p.parse_args(argv)
    dev = default_device(args.device)
    record = run(dev, rows=ROWS, batch=BATCH, trials=TRIALS)
    return common.finish(record, check_record(record),
                         args.out or common.default_out(OUT_TEMPLATE, dev))


if __name__ == "__main__":
    sys.exit(main())
