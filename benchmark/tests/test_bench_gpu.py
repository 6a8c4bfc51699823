"""A short run of the harness on the card (marked ``gpu``; it skips where
PyTorch sees no card, which it decides inside the test)."""

import json

import pytest
import torch

from benchmark import run


@pytest.mark.gpu
def test_tiny_cell_on_the_card(tiny_root, capsys):
    """The tiny cell, traced over its whole window, reads device time.

    On the H100 a trace of the tiny cell's last 0.5 s, begun 1.5 s or more
    into its window, has held no CUDA record at all (some 20,000 host
    events and no kernel or copy), while one begun 0.1 s in and held for
    1.9 s held 68,990 device records: the profiler hands the reduction
    nothing in the first case. So the trace here covers the window."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    path = tiny_root / "benchmark" / "workloads" / "tiny.batch.json"
    wl = json.loads(path.read_text())
    wl["trace_seconds"] = 2.0
    path.write_text(json.dumps(wl))
    rc = run.main(["--workload", "tiny.batch", "--seed", "2", "--seconds",
                   "2", "--trace", "1"], root=tiny_root)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name()
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
    assert "device_idle_share.batch" in res["metrics"]
