"""Whole runs of the harness on the CPU, at a tiny size: the result line
and its keys, the comparison with the reference, the faults that must
turn ``correct`` false, the float8 control, and the modules a run
loads."""

import importlib
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.spec import load_cell

REPO = run.ROOT


def last_line(capsys):
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def run_tiny(root, cell, seed, trace, capsys, seconds=3.0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device="cpu")
    assert rc == 0
    return last_line(capsys)


@pytest.mark.parametrize("cell,trace", [("tiny.batch", 0), ("tiny.open", 1)])
def test_result_line(tiny_root, capsys, cell, trace):
    res, err = run_tiny(tiny_root, cell, 2 ** 31 + 77, trace, capsys)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    names = set(res["metrics"])
    if trace == 0:
        assert names == {"setup_s", "serve_tokens_per_s"}
    else:
        assert "decode_block_mean.complete" in names
        assert "serve_mfu.complete" in names
        # no device on the CPU: the trace readers find nothing to read
        assert "device_idle_share.complete" not in names
    # the numbers compared close standard error, each with its limit
    tail = err.strip().splitlines()[-len(res["compared"]):]
    assert [t.split()[0] for t in tail] == list(res["compared"])
    assert all(" limit " in t for t in tail)


def test_no_card_no_result(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tiny.batch", "--seed", "1", "--seconds",
                   "1", "--trace", "0"], root=tiny_root)
    assert rc == 2
    assert capsys.readouterr().out == ""


def broken_token(monkeypatch):
    """A served token altered where it is produced: the greedy pick
    returns the next vocabulary id."""
    generate = importlib.import_module("mmlspark_tpu_torch.models.generate")
    engine = importlib.import_module("mmlspark_tpu_torch.serve.engine")
    orig = generate.greedy_next

    def off_by_one(logits, vocab_split=None):
        return (orig(logits, vocab_split) + 1) % logits.shape[-1]

    monkeypatch.setattr(generate, "greedy_next", off_by_one)
    monkeypatch.setattr(engine, "greedy_next", off_by_one)


def broken_state(monkeypatch):
    """A decode step that leaves the slot pool as it was: the step's K/V
    go into a copy, so later steps never see them."""
    from mmlspark_tpu_torch.models.transformer import SelfAttention

    orig = SelfAttention._slot_decode

    def unchanged(self, q, k, v, cache, pos, rolled, decode, live):
        if decode:
            cache = tuple(c.clone() for c in cache)
        return orig(self, q, k, v, cache, pos, rolled, decode, live)

    monkeypatch.setattr(SelfAttention, "_slot_decode", unchanged)


@pytest.mark.parametrize("fault", [broken_token, broken_state])
@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.open"])
def test_faults_turn_correct_false(tiny_root, capsys, monkeypatch, fault,
                                   cell):
    fault(monkeypatch)
    res, _ = run_tiny(tiny_root, cell, 5, 0, capsys)
    assert res["correct"] is False
    gap = res["compared"]["widest_gap"]
    assert gap["value"] > gap["limit"]


def test_control_fails_the_limit(tiny_root, capsys):
    """The float8 control in the program's place comes out not correct by
    the harness's own verdict on every seed, where the program comes out
    correct; the control tool says so in its exit code."""
    from benchmark import control

    # a sample of 120 served tokens: at the tiny cell's 40 the control
    # can pick the reference's token at every position
    path = tiny_root / "benchmark" / "workloads" / "tiny.batch.json"
    wl = json.loads(path.read_text())
    wl["check"]["min_tokens"] = 120
    path.write_text(json.dumps(wl))
    cell = load_cell("tiny.batch", tiny_root)
    dev = torch.device("cpu")
    for seed in (11, 12, 13):
        # a window long enough to finish the sample on a busy CPU
        w = run.serve_window(cell, seed, 8.0, False, dev)
        verdict = run.judge(cell, seed, w.outcome, dev, control=True)
        assert verdict["correct"] is True, verdict["compared"]
        assert verdict["control_correct"] is False, verdict["gaps"]
    rc = control.main(["--workload", "tiny.batch", "--seeds", "11",
                       "--seconds", "8", "--device", "cpu"], root=tiny_root)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rc, line["correct"], line["control_correct"]) == (0, True, False)


def fresh(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def test_a_run_loads_no_jax(tiny_root):
    code = f"""
import sys
from pathlib import Path
from benchmark import run
rc = run.main(["--workload", "tiny.batch", "--seed", "3", "--seconds",
               "1", "--trace", "0"], root=Path({str(tiny_root)!r}),
              device="cpu")
mods = {{m.split(".", 1)[0] for m in sys.modules}}
print("RC", rc, sorted(mods & {{"jax", "jaxlib", "flax", "mmlspark_tpu"}}),
      "mmlspark_tpu_torch" in mods)
"""
    assert fresh(code).strip().splitlines()[-1] == "RC 0 [] True"


def test_reference_loads_nothing_of_the_program():
    code = """
import sys
import benchmark.check, benchmark.reference.gpt, benchmark.weights
print(sorted(m for m in sys.modules if m.split(".", 1)[0] in
             ("mmlspark_tpu_torch", "mmlspark_tpu", "jax", "flax")))
"""
    assert fresh(code).strip() == "[]"


def test_sweep_summary_by_hand():
    """The knee sweep's reading of a window: two requests meet both
    limits, one waits too long for its first token."""
    import numpy as np

    from benchmark.serve import Record
    from benchmark.sweep import summarize

    def rec(due, first, finish, n):
        return Record(np.zeros(n, np.int32), 4, due, first, finish,
                      np.zeros(4, np.int32))

    out = SimpleNamespace(t0=0.0, records={
        0: rec(0.0, 0.1, 0.13, 6), 1: rec(1.0, 1.2, 1.23, 300),
        2: rec(2.5, 4.0, 4.03, 300)})
    s = summarize(out, {"ttft_ms": 1000, "tpot_ms": 50}, 3.0,
                  lambda p: 8 if p <= 8 else 512)
    assert s["met_share"] == pytest.approx(2 / 3)
    assert s["ttft_p95_ms"] == pytest.approx(1500.0)
    assert s["ttft_ms_by_bucket"] == {8: [100.0], 512: [200.0, 1500.0]}
    assert s["unfinished"] == 0
    assert s["live_max"] == 1  # no two requests decode at once
