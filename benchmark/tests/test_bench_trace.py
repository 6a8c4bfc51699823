"""The trace reduction on a hand-made timeline."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.trace import kernel_seconds, summarize

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, a, b, dev=CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


def test_union_kernels_and_named_gaps():
    events = [
        ev("bench.step", 0, 100, CPU),
        ev("serve.prefill", 10, 40, CPU),
        ev("bench.step", 100, 200, CPU),
        ev("gemm", 0, 10),
        ev("decode_partial_kernel", 5, 20),  # overlaps gemm
        ev("serve.decode", 0, 50),  # an annotation on the card's row
        ev("gemm", 60, 150),
        ev("decode_combine_kernel", 185, 200),
    ]
    s = summarize(events, 200e-6)
    # union: [0, 20] + [60, 150] + [185, 200] = 125 us
    assert s["busy_s"] == pytest.approx(125e-6)
    assert kernel_seconds(s, "decode_partial", "decode_combine") == \
        pytest.approx(30e-6)
    assert s["per_kernel_s"]["gemm"] == pytest.approx(100e-6)
    assert "serve.decode" not in s["per_kernel_s"]
    # the gap [20, 60] opened inside the first step's prefill, the gap
    # [150, 185] inside the second step
    assert s["idle_gaps"][0] == ["step:serve.prefill", pytest.approx(40e-6)]
    assert s["idle_gaps"][1] == ["step", pytest.approx(35e-6)]
    assert s["device_ops"][0][0] == "gemm"
