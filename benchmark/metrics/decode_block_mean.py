"""Micro-steps per decode dispatch over the window: the scheduler's
clamp of each block to the smallest remaining budget, from the engine's
block counts (``ServeMetrics.decode_blocks``) at the window's ends."""


def read(run):
    c = run.counters
    if not c["decode_blocks"]:
        return None
    return c["decode_microsteps"] / c["decode_blocks"]
