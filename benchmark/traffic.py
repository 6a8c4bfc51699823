"""The one traffic generator: a workload file's parameters and a seed in,
the requests out.

Every seed gets the same work at the same times; the seed draws the
token ids. Sizes and gaps are the quantiles ``(i + 0.5) / B`` of their
distributions, ``B`` (the file's ``block``, 64 by default) at a time,
each block of prompt lengths, output lengths and arrival gaps in an
order of its own that is fixed (drawn from the block's index, not from
the seed). So a window of whole blocks offers the same multiset of
sizes and lasts the same time on every seed, and two seeds differ only
in their token ids and weights: an open loop's tail then moves with the
program and not with where a seed happened to put its longest prompts.
The token ids are uniform over the vocabulary, so no two prompts share
a prefix.

Distributions (``{"dist": ..., ...}``): ``fixed`` (``value``),
``uniform`` (integers ``lo``..``hi``), ``log_uniform`` (``lo``..``hi``,
uniform in the logarithm). Arrivals (open loop): ``poisson`` at
``rate`` requests a second. A file's ``max_total`` cuts each output so
that its prompt and output fit that many positions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Request:
    prompt: np.ndarray  # int32 token ids
    max_new: int
    due: float  # seconds after the first due request (open loop); 0 closed


def levels(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def quantiles(dist: dict, u: np.ndarray) -> np.ndarray:
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(u.shape, int(dist["value"]), np.int64)
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if kind == "uniform":
        return np.floor(lo + u * (hi - lo + 1)).astype(np.int64)
    if kind == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown size distribution {kind!r}")


def gap_quantiles(arrivals: dict, u: np.ndarray) -> np.ndarray:
    """Inter-arrival gaps at the levels ``u``, scaled so that their mean is
    exactly ``1 / rate``."""
    if arrivals["dist"] != "poisson":
        raise ValueError(f"unknown arrival process {arrivals['dist']!r}")
    g = -np.log1p(-u)
    return g / g.mean() / float(arrivals["rate"])


def make_requests(workload: dict, seed: int, seconds: float,
                  vocab: int) -> list[Request]:
    """The cell's requests for a run of ``seconds``: a closed loop's
    ``requests`` (its clients take them in order), or an open loop's
    arrivals, enough whole blocks to cover the window."""
    block = int(workload.get("block", 64))
    rng = np.random.default_rng(int(seed))
    open_loop = workload["driver"] == "open"
    if open_loop:
        rate = float(workload["arrivals"]["rate"])
        n_blocks = max(1, math.ceil(rate * seconds / block))
    else:
        n_blocks = max(1, math.ceil(int(workload["requests"]) / block))
    u = levels(block)
    p_levels = quantiles(workload["prompt_len"], u)
    o_levels = quantiles(workload["output_len"], u)
    g_levels = gap_quantiles(workload["arrivals"], u) if open_loop else None
    max_total = int(workload.get("max_total", 0))
    out, t = [], 0.0
    for b in range(n_blocks):
        order = np.random.default_rng(b)
        prompts = order.permutation(p_levels)
        outputs = order.permutation(o_levels)
        gaps = order.permutation(g_levels) if open_loop else None
        for i in range(block):
            ids = rng.integers(0, vocab, size=int(prompts[i]),
                               dtype=np.int64).astype(np.int32)
            n_out = int(outputs[i])
            if max_total:
                n_out = min(n_out, max_total - len(ids))
            out.append(Request(ids, n_out, t))
            if open_loop:
                t += float(gaps[i])
    return out
