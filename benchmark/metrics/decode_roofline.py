"""The decode attention kernels' share of their roofline over the traced
steps, in percent: the least time the bytes they must move take at the
H100's 3.35 TB/s (each live K and V row read once, q read and out
written once, per step and layer) over the device time of the split-KV
template's partial and combine kernels in the profiler's trace."""

from benchmark.arith import PEAK_HBM_BYTES_PER_S
from benchmark.trace import kernel_seconds

KERNELS = ("decode_partial_kernel", "decode_combine_kernel")


def read(run):
    if run.trace is None or run.trace_counters is None:
        return None
    seconds = kernel_seconds(run.trace, *KERNELS)
    c = run.trace_counters
    if seconds <= 0 or not c["decode_tokens"]:
        return None
    least = run.shape.decode_bytes(c["decode_tokens"],
                                   c["decode_live_kv"]) / PEAK_HBM_BYTES_PER_S
    return 100.0 * least / seconds
