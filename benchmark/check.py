"""What decides ``correct`` for a served model.

Once the window has closed and the program is freed, a sample of the
requests it finished, drawn from the seed, always with the longest of
them, is run through the float32 reference: one forward over each
prompt and its served tokens. At every served position the reference's
best logit minus its logit of the served token is the token's gap; the
number compared is the widest gap over the sample (0 when every served
token is the reference's argmax), and beside it the mean gap over the
sample's served tokens, which a lower precision raises at every
position where it ranks another token first. Greedy decoding in
bfloat16 lands on a near-tie now and then, which is what the limits
leave room for.

The control (``served_gaps(..., control=...)``) puts the reference
computed through float8 in the program's place: at the same positions
of the same sequences, the widest and the mean gap of the tokens that
it ranks first. ``verdict`` judges the program's gaps and the control's
by the same limits.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.gpt import Gpt


def pick_sample(finished: list, seed: int, min_tokens: int) -> list:
    """The longest finished request (most served tokens), then others in
    an order drawn from the seed until the sample holds ``min_tokens``
    served tokens. ``finished`` holds ``(prompt, served)`` arrays."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: (len(finished[i][1]), len(finished[i][0])))
    order = np.random.default_rng(int(seed) + 1).permutation(len(finished))
    chosen, tokens = [longest], len(finished[longest][1])
    for i in order:
        if tokens >= min_tokens:
            break
        if i != longest:
            chosen.append(int(i))
            tokens += len(finished[i][1])
    return [finished[i] for i in chosen]


def _positions(prompt: np.ndarray, served: np.ndarray, device):
    seq = np.concatenate([prompt, served]).astype(np.int64)
    ids = torch.from_numpy(seq[:-1]).to(device)
    rows = torch.arange(len(prompt) - 1, len(seq) - 1, device=device)
    return ids, rows, torch.from_numpy(served.astype(np.int64)).to(device)


def served_gaps(ref: Gpt, sample: list, device,
                control: Gpt | None = None) -> dict:
    """The widest and the mean gap of the served tokens over ``sample``
    (and, with ``control``, of the tokens the control ranks first)."""
    widest, total, tokens = 0.0, 0.0, 0
    ctl_widest, ctl_total = 0.0, 0.0
    for prompt, served in sample:
        ids, rows, got = _positions(prompt, served, device)
        logits = ref.logits(ids, rows)
        best = logits.max(dim=-1).values
        at = torch.arange(len(got), device=device)
        gaps = best - logits[at, got]
        widest = max(widest, float(gaps.max()))
        total += float(gaps.sum())
        if control is not None:
            pick = control.logits(ids, rows).argmax(dim=-1)
            ctl = best - logits[at, pick]
            ctl_widest = max(ctl_widest, float(ctl.max()))
            ctl_total += float(ctl.sum())
        tokens += len(got)
    out = {"widest_gap": widest, "mean_gap": total / max(1, tokens),
           "tokens": tokens}
    if control is not None:
        out["control"] = {"widest_gap": ctl_widest,
                          "mean_gap": ctl_total / max(1, tokens),
                          "tokens": tokens}
    return out


def compared(gaps: dict, check: dict, unfinished: int) -> dict:
    """The numbers compared, each with its limit from the workload's
    ``check``."""
    return {
        "widest_gap": {"value": gaps["widest_gap"],
                       "limit": float(check["widest_gap_limit"])},
        "mean_gap": {"value": gaps["mean_gap"],
                     "limit": float(check["mean_gap_limit"])},
        "tokens_compared": {"value": gaps["tokens"],
                            "limit": int(check["min_tokens"])},
        "unfinished": {"value": unfinished, "limit": 0},
    }


def verdict(gaps: dict, check: dict, unfinished: int) -> bool:
    """``correct``: both gaps at or under their limits, at least the
    sample's tokens compared, and every due request finished."""
    c = compared(gaps, check, unfinished)
    return bool(c["widest_gap"]["value"] <= c["widest_gap"]["limit"]
                and c["mean_gap"]["value"] <= c["mean_gap"]["limit"]
                and c["tokens_compared"]["value"]
                >= c["tokens_compared"]["limit"]
                and c["unfinished"]["value"] == 0)
