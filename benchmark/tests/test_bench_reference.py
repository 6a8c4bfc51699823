"""The plain reference against the port's forward at tiny widths on the
CPU, for multi-head, grouped and multi-query attention."""

import pytest
import torch

from benchmark.reference.gpt import Gpt, fp8_round
from benchmark.weights import leaf_specs, make_weights


def port(kv_heads):
    return {"vocab_size": 300, "d_model": 64, "heads": 4,
            "kv_heads": kv_heads, "depth": 2, "d_ff": 128, "max_len": 64,
            "ln_eps": 1e-6}


@pytest.mark.parametrize("kv_heads", [None, 2, 1], ids=["mha", "gqa", "mqa"])
def test_reference_matches_the_port(kv_heads):
    from mmlspark_tpu_torch.models.transformer import transformer_lm

    p = port(kv_heads)
    graph = transformer_lm(**{k: p[k] for k in (
        "vocab_size", "d_model", "heads", "depth", "d_ff", "max_len",
        "kv_heads")}, attn_impl="dense")
    weights = make_weights(p, 7, "cpu")
    ids = torch.randint(0, 300, (1, 40), generator=torch.Generator()
                        .manual_seed(1))
    got = graph.apply(weights, ids)[0]
    want = Gpt(p, weights).logits(ids[0])
    # the port computes the projections in bfloat16 (8 bits of mantissa)
    assert (got - want).abs().max() < 0.05 * want.abs().max()
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() > 0.9


def test_weights_match_the_port_layout():
    from mmlspark_tpu_torch.models.transformer import transformer_lm

    p = port(1)
    graph = transformer_lm(**{k: p[k] for k in (
        "vocab_size", "d_model", "heads", "depth", "d_ff", "max_len",
        "kv_heads")})
    want = {(b, k): tuple(v.shape) for b, mod in graph.blocks
            for k, v in mod.state_dict().items()}
    assert {(b, k): s for b, k, s, _ in leaf_specs(p)} == want


def test_weights_repeat_for_a_seed():
    p = port(2)
    a, b, c = (make_weights(p, s, "cpu") for s in (2 ** 31 + 9, 2 ** 31 + 9,
                                                    4))
    for blk in a:
        for k in a[blk]:
            assert torch.equal(a[blk][k], b[blk][k])
    assert not torch.equal(a["block0"]["attn.qkv.weight"],
                           c["block0"]["attn.qkv.weight"])
    assert a["block1"]["mlp_in.weight"].dtype == torch.bfloat16
    assert a["block1"]["ln1.weight"].dtype == torch.float32


def test_fp8_round_is_coarser_than_bfloat16():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    e8 = ((fp8_round(x) - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    e16 = ((x.bfloat16().float() - x).abs()
           / x.abs().amax(-1, keepdim=True)).max()
    assert e8 > 4 * e16
    assert e8 < 2 ** -4  # e4m3: 3 bits of mantissa
