"""The model FLOPs of the window's real tokens over the window, as a
share of the H100's bf16 peak, in percent: every prefill's prompt (no
pads) and every decode step (``benchmark.arith.GptShape``), attention
over the live positions only."""

from benchmark.arith import PEAK_BF16_FLOPS


def read(run):
    c, shape = run.counters, run.shape
    flops = sum(shape.prefill_flops(p) for p in c["prefill_lengths"])
    flops += shape.decode_flops(c["decode_tokens"], c["decode_live_kv"])
    if not flops:
        return None
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
