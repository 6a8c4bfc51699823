"""The frozen arithmetic against shapes worked out by hand."""

import json
from types import SimpleNamespace

import pytest

from benchmark.arith import (
    GptShape,
    attention_fwd_bwd_work,
    attention_work,
    live_pairs,
)
from benchmark.spec import ROOT, reader


def shape(name):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                     .read_text())
    return GptShape(cfg["port"])


def test_live_pairs():
    assert live_pairs(4, False, None) == 16
    assert live_pairs(4, True, None) == 10  # 1 + 2 + 3 + 4
    assert live_pairs(5, True, 2) == 3 + 3 * 2  # band of 2


def test_attention_work_by_hand():
    # B=1, S=2, H=Hk=1, D=2, causal: 3 live pairs, bf16
    work = attention_work(1, 2, 1, 1, 2, True, None)
    q = 1 * 2 * 1 * 2 * 2  # 8 bytes of q (or k, v, out)
    rows = 1 * 1 * 2 * 4  # 8 bytes of LSE
    assert work["flash_attention_fwd"] == (4 * q + rows, 2 * 2 * 2 * 3)
    assert attention_fwd_bwd_work(1, 2, 1, 1, 2, True, None) == (
        8 * q + 2 * rows, 7 * 2 * 2 * 3)


def test_gpt2_xl_parameters():
    # GPT-2 XL's published 1,557,611,200 (tied head) plus the port's
    # untied head: 50,257 x 1,600 weights and 50,257 biases
    assert shape("gpt2-xl").params() == 1_557_611_200 + 50257 * 1601


def test_starcoderbase_3b_kv_row():
    s = shape("starcoderbase-3b")
    # one K/V head of 128 (MQA) in 36 layers, K and V, bf16
    assert s.kv_bytes_per_position() == 2 * 36 * 1 * 128 * 2
    assert s.head_dim == 128


def test_flops_by_hand():
    s = GptShape({"vocab_size": 10, "d_model": 4, "heads": 2, "depth": 1,
                  "d_ff": 8, "max_len": 16})
    # qkv 4x12 + 12, out 4x4 + 4, in 4x8 + 8, out 8x4 + 4, two LNs 16
    assert s.layer_params() == 60 + 20 + 40 + 36 + 16
    mm = 2 * (60 + 20 + 40 + 36)
    # a 3-token prompt: 3 rows of the block, one head row, 6 pairs
    assert s.prefill_flops(3) == 3 * mm + 2 * 4 * 10 + 4 * 2 * 2 * 6
    # 2 decode steps that attended 5 positions together
    assert s.decode_flops(2, 5) == 2 * (mm + 2 * 4 * 10) + 4 * 2 * 2 * 5
    # K and V of 5 positions (2 heads of 2, bf16) and q/out of 2 steps
    assert s.decode_bytes(2, 5) == 5 * 2 * 2 * 2 * 2 + 2 * 2 * 2 * 2 * 2


def ctx(**kw):
    base = dict(shape=GptShape({"vocab_size": 10, "d_model": 4, "heads": 2,
                                "depth": 1, "d_ff": 8, "max_len": 16}),
                window_s=2.0, trace=None, trace_counters=None,
                counters={"decode_tokens": 6, "decode_live_kv": 20,
                          "decode_blocks": 2, "decode_microsteps": 3,
                          "prefill_lengths": [3, 5],
                          "prefill_buckets": [8, 8]})
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_by_hand():
    c = ctx()
    assert reader("decode_block_mean.batch")(c) == 1.5
    assert reader("prefill_pad_share.complete")(c) == 50.0
    s = c.shape
    flops = s.prefill_flops(3) + s.prefill_flops(5) + s.decode_flops(6, 20)
    assert reader("serve_mfu.batch")(c) == pytest.approx(
        100.0 * flops / (2.0 * 989e12))


def test_trace_readers_by_hand():
    trace = {"busy_s": 1.5, "window_s": 2.0, "per_kernel_s": {
        "void mml::decode_partial_kernel<bf16>(mml::DecodeArgs)": 0.001,
        "void mml::decode_combine_kernel<bf16>(mml::DecodeArgs)": 0.001,
        "gemm": 1.0}}
    c = ctx(trace=trace, trace_counters={"decode_tokens": 6,
                                         "decode_live_kv": 20})
    least = c.shape.decode_bytes(6, 20) / 3.35e12
    assert reader("decode_roofline.batch")(c) == pytest.approx(
        100.0 * least / 0.002)
    assert reader("device_idle_share.batch")(c) == pytest.approx(25.0)


def test_readers_find_nothing_to_read():
    empty = ctx(counters={"decode_tokens": 0, "decode_live_kv": 0,
                          "decode_blocks": 0, "decode_microsteps": 0,
                          "prefill_lengths": [], "prefill_buckets": []})
    for name in ("decode_block_mean.batch", "prefill_pad_share.complete",
                 "serve_mfu.batch",
                 "decode_roofline.batch", "device_idle_share.batch"):
        assert reader(name)(empty) is None
