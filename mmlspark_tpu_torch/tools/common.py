"""What the evidence tools share: the card a record names, the
scale-normalized error, the default record paths, the command-line
arguments, how a checked record is written, and the synced host timer."""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

#: the checkout the package lives in; the tools write under its
#: ``build/`` (listed in ``.gitignore``), never over a committed artifact
REPO = Path(__file__).resolve().parents[2]
EVIDENCE_DIR = REPO / "build" / "evidence"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


def device_record(dev: torch.device) -> dict:
    """What a record says of the device it ran on: ``platform`` ``gpu``
    with the card's name, count and ``nvidia-smi`` line, or ``cpu``."""
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count(),
                "card": card_line()}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "card": None}


def on_card(record: dict) -> bool:
    return record.get("device", {}).get("platform") == "gpu"


def scaled_err(got, want) -> float:
    """Max abs error over the tensor's scale, max(1, max|want|): a bf16
    result carries precision relative to its magnitude, and a real fault
    (a mask off by one, a wrong tile) moves outputs by O(max|want|)."""
    got = torch.as_tensor(got).float()
    want = torch.as_tensor(want).float()
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / scale


def max_abs_err(got, want) -> float:
    return float((torch.as_tensor(got).float()
                  - torch.as_tensor(want).float()).abs().max())


def positive(x) -> bool:
    """A measured time or rate: a finite number above 0."""
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def default_out(template: str, dev: torch.device) -> Path:
    """A record's default path: ``template`` with ``GPU`` or ``CPU`` for
    the device, under ``build/evidence/``."""
    return EVIDENCE_DIR / template.format("GPU" if dev.type == "cuda"
                                          else "CPU")


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, description=doc,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where to run: the card (default; raises without "
                   "one) or the plain PyTorch path on the host")
    p.add_argument("--out", default="", metavar="PATH",
                   help="where the record goes (default: under "
                   "build/evidence/)")
    return p


def finish(record: dict, problems: list[str], out) -> int:
    """Write ``record`` to ``out`` when its contract holds and print it as
    one JSON line; otherwise print it with the violations on stderr and
    return 3, writing nothing."""
    if problems:
        print(json.dumps(record, default=str), file=sys.stderr)
        print(f"the record FAILED its contract; not writing {out}:",
              file=sys.stderr)
        for problem in problems:
            print(f"  - {problem}", file=sys.stderr)
        return 3
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=str),
                   encoding="utf-8")
    print(json.dumps(record, default=str), flush=True)
    print(f"wrote {out}", file=sys.stderr)
    return 0


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def best_seconds(fn, trials: int, dev: torch.device) -> float:
    """The best host wall time of ``trials`` calls of ``fn``, each
    between two syncs of ``dev``."""
    best = float("inf")
    for _ in range(trials):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best
