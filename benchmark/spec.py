"""Finding a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) names the cells, the
configurations and the metrics. Everything that belongs to one of them is
a file of its own, found by its name:

- a configuration: ``benchmark/configs/<config>.json``;
- a traffic mix: ``benchmark/workloads/<cell>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, or, for a
  quantity split by cell (``decode_block_mean.batch``), the reader of the
  part before the first dot (``decode_block_mean.py``).

A later cell, configuration or metric is therefore added as files and
``BENCHMARK.json`` entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

#: the checkout's root: the directory that holds ``BENCHMARK.json``
ROOT = Path(__file__).resolve().parents[1]


class SpecError(RuntimeError):
    """A cell, configuration or metric that the files do not define."""


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    end_to_end: list
    per_layer: list
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json under {root}")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its workload and configuration files and the
    metrics it reports."""
    root = Path(root)
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"BENCHMARK.json has no workload '{name}'")
    wl_path = root / "benchmark" / "workloads" / f"{name}.json"
    if not wl_path.is_file():
        raise SpecError(f"no traffic file {wl_path}")
    workload = json.loads(wl_path.read_text())
    cfg_entry = next((c for c in bench["configs"]
                      if c["name"] == entry["config"]), None)
    if cfg_entry is None:
        raise SpecError(f"BENCHMARK.json has no config '{entry['config']}'")
    config = json.loads((root / cfg_entry["file"]).read_text())
    if workload.get("config") != entry["config"]:
        raise SpecError(
            f"{wl_path.name} names config {workload.get('config')!r}, "
            f"BENCHMARK.json {entry['config']!r}")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(entry["chips"]), workload, config, e2e, per_layer,
                root)


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of a per-layer metric's reader file."""
    folder = Path(root) / "benchmark" / "metrics"
    for stem in (metric, metric.split(".", 1)[0]):
        path = folder / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"benchmark_metric_{stem.replace('.', '_').replace('-', '_')}",
                path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise SpecError(f"no reader for per-layer metric '{metric}' in {folder}")
