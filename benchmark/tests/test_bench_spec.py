"""Cells, configurations and per-layer metrics are found by name: new
ones are files and BENCHMARK.json entries alone."""

import json

import pytest

from benchmark.spec import ROOT, SpecError, load_benchmark, load_cell, reader


def test_committed_cells_load():
    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        # the traffic's lengths come from a published source
        assert cell.workload["source"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(reader(m["name"]))


def test_new_cell_config_and_metric_by_files_alone(tiny_root):
    """A configuration, a traffic mix and a per-layer metric added as
    files plus BENCHMARK.json entries, with no code edited."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "benchmark/configs/tiny.json").read_text())
    cfg["port"]["depth"] = 3
    (tiny_root / "benchmark/configs/tiny3.json").write_text(json.dumps(cfg))
    wl = json.loads((tiny_root / "benchmark/workloads/tiny.batch.json")
                    .read_text())
    wl.update(config="tiny3", clients=2)
    (tiny_root / "benchmark/workloads/tiny3.pair.json").write_text(
        json.dumps(wl))
    (tiny_root / "benchmark/metrics/prefills.py").write_text(
        "def read(run):\n    return len(run.counters['prefill_lengths'])"
        " or None\n")
    bench["configs"].append({"name": "tiny3", "source": "test",
                             "file": "benchmark/configs/tiny3.json",
                             "reduced": ["depth"], "why": "test"})
    bench["workloads"].append({"name": "tiny3.pair", "config": "tiny3",
                               "traffic": "pair", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "prefills.pair", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["tiny3.pair"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("tiny3.pair", tiny_root)
    assert cell.config["port"]["depth"] == 3
    assert cell.workload["clients"] == 2
    assert [m["name"] for m in cell.per_layer] == ["prefills.pair"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    read = reader("prefills.pair", tiny_root)
    assert read(type("R", (), {"counters": {"prefill_lengths": [3]}})) == 1


def test_unknown_names_are_refused(tiny_root):
    with pytest.raises(SpecError):
        load_cell("nope.batch", tiny_root)
    with pytest.raises(SpecError):
        reader("no_such_metric.batch", ROOT)
