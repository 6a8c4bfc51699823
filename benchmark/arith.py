"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the H100's peaks, the attention work counts, a GPT
block's parameters and the model FLOPs of served tokens.

The attention counts are copied from ``mmlspark_tpu_torch/tools/timing.py``
(``live_pairs``, ``attention_work``, ``attention_fwd_bwd_work``) and the
peaks from ``mmlspark_tpu_torch/core/perf.py``'s H100 row; the copies are
the ones the benchmark reads.
"""

from __future__ import annotations

#: NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core FLOP/s and HBM3
#: bytes/s, both at the card's full 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def live_pairs(s: int, causal: bool, window) -> int:
    """The (query, key) pairs an attention over ``s`` positions scores:
    all of them, the causal triangle, or the causal band of ``window``."""
    if not causal:
        return s * s
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_work(b, s, h, hk, d, causal, window, elem=2) -> dict:
    """{kernel: (bytes, flops)} for one call of each attention kernel: each
    input read once and each output written once, 2 flops a multiply-add
    over the live pairs (q.k and p.v forward; q.k, dO.v, dV and dK for
    dK/dV; q.k, dO.v and dQ for dQ)."""
    pairs = live_pairs(s, causal, window)
    qo = b * s * h * d * elem
    kv = b * s * hk * d * elem
    rows = b * h * s * 4
    per_pair = 2 * b * h * d
    return {
        "flash_attention_fwd": (2 * qo + 2 * kv + rows, 2 * per_pair * pairs),
        "flash_attention_bwd_kv": (2 * qo + 4 * kv + 2 * rows,
                                   4 * per_pair * pairs),
        "flash_attention_bwd_q": (3 * qo + 2 * kv + 2 * rows,
                                  3 * per_pair * pairs),
    }


def attention_fwd_bwd_work(b, s, h, hk, d, causal, window,
                           elem=2) -> tuple:
    """(bytes, flops) that attention's forward and backward need as one
    function: q, k, v and dO read once; out, dq, dk and dv written once;
    LSE and D once each; seven matrix products over the live pairs."""
    pairs = live_pairs(s, causal, window)
    qo = b * s * h * d * elem
    kv = b * s * hk * d * elem
    rows = b * h * s * 4
    return (4 * qo + 4 * kv + 2 * rows, 7 * 2 * b * h * d * pairs)


class GptShape:
    """The sizes of a GPT-2 / GPT-BigCode decoder as the arithmetic needs
    them (read from a configuration file's ``port`` entry)."""

    def __init__(self, port: dict):
        self.vocab = int(port["vocab_size"])
        self.d = int(port["d_model"])
        self.heads = int(port["heads"])
        self.kv_heads = int(port.get("kv_heads") or self.heads)
        self.layers = int(port["depth"])
        self.d_ff = int(port.get("d_ff") or 4 * self.d)
        self.max_len = int(port["max_len"])
        self.head_dim = self.d // self.heads

    def layer_params(self) -> int:
        """One block's parameters: two LayerNorms, the fused qkv and the
        attention output, the MLP's two projections, all with biases."""
        d, hd = self.d, self.head_dim
        qkv_out = (self.heads + 2 * self.kv_heads) * hd
        return (4 * d + d * qkv_out + qkv_out + self.heads * hd * d + d
                + d * self.d_ff + self.d_ff + self.d_ff * d + d)

    def head_params(self) -> int:
        """The final LayerNorm and the untied LM head with its bias."""
        return 2 * self.d + self.d * self.vocab + self.vocab

    def params(self) -> int:
        """Every parameter, the token and position tables included."""
        return (self.vocab * self.d + self.max_len * self.d
                + self.layers * self.layer_params() + self.head_params())

    def kv_bytes_per_position(self, elem: int = 2) -> int:
        """K and V of one cached position over every layer."""
        return 2 * self.layers * self.kv_heads * self.head_dim * elem

    def prefill_flops(self, p: int) -> int:
        """A prompt of ``p`` real tokens: the blocks' matrix products for
        every token, the head for the one row whose logits are read, and
        causal attention over the p(p+1)/2 live pairs (q.k and p.v)."""
        per_layer_mm = 2 * (self.layer_params() - 4 * self.d)
        attn = 4 * self.heads * self.head_dim * self.layers \
            * (p * (p + 1) // 2)
        return p * self.layers * per_layer_mm + 2 * self.d * self.vocab + attn

    def decode_flops(self, tokens: int, live_positions: int) -> int:
        """``tokens`` one-token decode steps that together attended
        ``live_positions`` cached positions (each step t + 1 at position
        t): the blocks' products and the head per token, plus q.k and p.v
        over the live positions."""
        per_layer_mm = 2 * (self.layer_params() - 4 * self.d)
        return (tokens * (self.layers * per_layer_mm
                          + 2 * self.d * self.vocab)
                + 4 * self.heads * self.head_dim * self.layers
                * live_positions)

    def decode_bytes(self, tokens: int, live_positions: int,
                     elem: int = 2) -> int:
        """The least a decode attention kernel moves over those steps: each
        live K and V row read once, each step's q read and out written
        once, in every layer."""
        kv = live_positions * self.kv_bytes_per_position(elem)
        qo = tokens * 2 * self.layers * self.heads * self.head_dim * elem
        return kv + qo
