"""The plain reference: a GPT-2 / GPT-BigCode decoder in float32.

Pre-LN blocks: ``x + attn(LN1(x))``, then ``x + mlp(LN2(x))`` with a
tanh-approximated GELU between the MLP's projections, learned position
rows added to the token rows, a final LayerNorm and an untied LM head
with a bias. Attention is causal, over ``heads`` query heads that share
``kv_heads`` key and value heads (query head ``h`` reads kv head
``h // (heads / kv_heads)``: 1 for MQA, ``heads`` for MHA). The fused
projection's output columns hold the query heads, then the key heads,
then the value heads, ``head_dim`` columns each: the layout of the
weights the benchmark makes.

Plain ``torch`` only, with TF32 off, run layer by layer and attention
in blocks of query rows so that a long sequence fits. ``quant="fp8"``
is the control: every projection's weight (a scale per output row) and
input (a scale per token) rounded through float8 e4m3 before a float32
product, the step below the bfloat16 that the configurations state.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

#: the largest finite float8 e4m3 value
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32: TF32 off for the matmuls and cuDNN,
    and the old settings back afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale per last-axis row
    (its largest magnitude maps to the format's largest value)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Gpt:
    """The reference over a weights dict ``{block: {leaf: tensor}}`` and a
    configuration's ``port`` sizes."""

    def __init__(self, port: dict, weights: dict, quant: str | None = None):
        self.heads = int(port["heads"])
        self.kv_heads = int(port.get("kv_heads") or self.heads)
        self.d = int(port["d_model"])
        self.head_dim = self.d // self.heads
        self.depth = int(port["depth"])
        self.eps = float(port["ln_eps"])
        self.w = weights
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown reference precision {quant!r}")
        self.quant = quant

    def _leaf(self, block: str, name: str) -> torch.Tensor:
        return self.w[block][name].float()

    def _dense(self, x, block: str, name: str):
        w = self._leaf(block, f"{name}.weight")
        if self.quant == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return x @ w.T + self._leaf(block, f"{name}.bias")

    def _ln(self, x, block: str, name: str):
        return F.layer_norm(x, (self.d,), self._leaf(block, f"{name}.weight"),
                            self._leaf(block, f"{name}.bias"), self.eps)

    def _attention(self, q, k, v):
        """Causal attention of (T, H, D) queries over (T, Hk, D) keys and
        values, a block of query rows at a time."""
        t, h, d = q.shape
        group = h // self.kv_heads
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        out = torch.empty_like(q)
        rows = max(1, (1 << 28) // max(1, h * t))
        scale = d ** -0.5
        for a in range(0, t, rows):
            b = min(t, a + rows)
            s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
            pos_q = torch.arange(a, b, device=q.device)[:, None]
            pos_k = torch.arange(b, device=q.device)[None, :]
            s = s.masked_fill(pos_k > pos_q, float("-inf"))
            out[a:b] = torch.einsum("hqk,khd->qhd", s.softmax(dim=-1), v[:b])
        return out

    def logits(self, ids: torch.Tensor, rows: torch.Tensor | None = None):
        """Float32 logits of the 1-D token sequence ``ids`` at the positions
        ``rows`` (all positions when None): (len(rows), vocab)."""
        with exact_float32(), torch.no_grad():
            t = ids.shape[0]
            x = (self._leaf("embed", "token.weight")[ids]
                 + self._leaf("embed", "pos")[:t])
            h, hk, hd = self.heads, self.kv_heads, self.head_dim
            for i in range(self.depth):
                blk = f"block{i}"
                qkv = self._dense(self._ln(x, blk, "ln1"), blk, "attn.qkv")
                qkv = qkv.view(t, h + 2 * hk, hd)
                o = self._attention(qkv[:, :h], qkv[:, h:h + hk],
                                    qkv[:, h + hk:])
                x = x + self._dense(o.reshape(t, h * hd), blk,
                                    "attn.attn_out")
                y = self._dense(self._ln(x, blk, "ln2"), blk, "mlp_in")
                x = x + self._dense(F.gelu(y, approximate="tanh"), blk,
                                    "mlp_out")
            if rows is not None:
                x = x[rows]
            return self._dense(self._ln(x, "z", "ln_f"), "z", "head")
