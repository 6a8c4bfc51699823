"""A checkout of its own for the benchmark's tests: a ``BENCHMARK.json``
whose cells run a tiny GPT (two layers of width 64, grouped K/V heads)
on the CPU, the benchmark's metric readers, and the tiny configuration
and traffic files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY = {"vocab_size": 512, "d_model": 64, "heads": 4, "kv_heads": 2,
        "depth": 2, "d_ff": 256, "max_len": 128, "ln_eps": 1e-6}

TRAFFIC = {
    "block": 16,
    "prompt_len": {"dist": "log_uniform", "lo": 4, "hi": 40},
    "output_len": {"dist": "uniform", "lo": 4, "hi": 16},
    "engine": {"slots": 4, "cache_len": 128, "decode_block": 8,
               "max_queue": 256},
    "trace_seconds": 0.5,
    # the tiny cell's limits, from its readings on the CPU over seeds
    # 11-20: the program's widest gap 0 to 0.0098 and mean gap 0 to
    # 0.00024, the float8 control's 0.117 to 0.645 and 0.0055 to 0.039
    "check": {"min_tokens": 40, "widest_gap_limit": 0.06,
              "mean_gap_limit": 0.0015},
    "why": "a tiny cell for the CPU tests",
}


def write_root(root: Path) -> Path:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [
        {"name": "tiny.batch", "config": "tiny", "traffic": "batch",
         "chips": 1, "why": "tests"},
        {"name": "tiny.open", "config": "tiny", "traffic": "open",
         "chips": 1, "why": "tests"},
    ]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = (["tiny.batch"]
                              if m["name"] == "serve_tokens_per_s"
                              else ["tiny.open"])
    for m in bench["per_layer"]:
        m["workloads"] = (["tiny.batch"] if m["name"].endswith(".batch")
                          else ["tiny.open"])
    (root / "benchmark" / "configs").mkdir(parents=True)
    (root / "benchmark" / "workloads").mkdir()
    shutil.copytree(REPO / "benchmark" / "metrics",
                    root / "benchmark" / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "source": "test", "port": TINY, "reduced": []}))
    closed = dict(TRAFFIC, config="tiny", driver="closed", clients=8,
                  requests=256)
    open_ = dict(TRAFFIC, config="tiny", driver="open",
                 arrivals={"dist": "poisson", "rate": 20.0})
    for name, wl in (("tiny.batch", closed), ("tiny.open", open_)):
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(
            json.dumps(wl))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return write_root(tmp_path)
