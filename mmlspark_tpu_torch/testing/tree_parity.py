"""Near-tie accounting between two fits of one tree configuration.

Two fits on the same rows — the card's and the CPU's, or the port's and
the JAX package's — sum float statistics, and the boosted fits compute
their gradients with ``exp`` implementations that may differ by an ulp.
Where two candidate splits' gains are that close, the fits may pick
different ones. This module finds the nodes where two fits part (those
whose ancestors agree), recomputes the gains of both candidates there
from the reference fit's statistics (float64 sums of the float32
statistics the fit builds), and says whether each pair agrees within a
relative tolerance: a near tie, not a fault. In a boosted fit every
later round sees other margins once the partitions differ, so only the
first tree where the fits part is examined; the trees of a
variance-reduction forest are independent, so each is.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.stages import trees

#: two candidate splits whose gains agree within this relative gap are a
#: near tie
NEAR_TIE_RTOL = 1e-5


def _node_rows(bins, feats, threshs, node: int) -> torch.Tensor:
    """Rows routed to heap ``node`` by one tree's splits."""
    level = node.bit_length() - 1
    at = torch.ones(bins.shape[0], dtype=torch.int64)
    for _ in range(level):
        at = trees._route(bins, at, feats, threshs)
    return at == node


def _split_gain(bins, stats, rows, feat: int, thresh: int, lam: float,
                max_bins: int) -> float:
    """The xgb gain of splitting ``rows`` at (feat, thresh) in float64;
    the sentinel ``thresh == max_bins`` (no split) gains 0."""
    if thresh >= max_bins:
        return 0.0
    hist = trees._level_histogram(
        bins[rows], stats[rows].double(),
        torch.zeros(int(rows.sum()), dtype=torch.int64), 1, max_bins)
    gain, _, _ = trees.xgb_gain(hist, lam)
    return float(gain[0, feat, thresh])


def _differing_splits(i, bins, stats, feats, threshs, o_feats, o_threshs,
                      lam: float, max_bins: int) -> list:
    """Each differing node of tree ``i`` whose ancestors agree, with both
    candidates' (feature, bin, gain) and their relative gap."""
    differ = (feats[i] != o_feats[i]) | (threshs[i] != o_threshs[i])
    f_t, t_t = torch.from_numpy(feats[i]), torch.from_numpy(threshs[i])
    out = []
    for node in np.flatnonzero(differ):
        if any(differ[a] for a in _ancestors(int(node))):
            continue
        rows = _node_rows(bins, f_t, t_t, int(node))
        cand = []
        for fs, ts in ((feats, threshs), (o_feats, o_threshs)):
            f, t = int(fs[i, node]), int(ts[i, node])
            cand.append((f, t, _split_gain(bins, stats, rows, f, t, lam,
                                           max_bins)))
        gap = abs(cand[0][2] - cand[1][2]) / max(
            abs(cand[0][2]), abs(cand[1][2]), 1e-30)
        out.append({"tree": i, "node": int(node), "rows": int(rows.sum()),
                    "ref": cand[0], "other": cand[1], "rel_gap": gap,
                    "near_tie": gap <= NEAR_TIE_RTOL})
    return out


def gbt_divergence(ref, other, x: np.ndarray, y: np.ndarray, *,
                   lam: float = 1.0, max_bins: int = 32) -> dict:
    """Compare two fitted GBT models (``GBTClassifierModel`` or
    ``GBTRegressorModel``) of one configuration on their training rows
    ``x`` (features) and ``y`` (class indices or targets).

    Returns ``{"trees", "first_diverged_tree", "splits"}``: ``splits``
    lists each differing node of the first tree where the structures
    part whose ancestors agree, with both candidates' (feature, bin,
    gain), their relative gap and ``near_tie``. Trees after that one grow
    on other margins and are not compared."""
    bins = torch.from_numpy(trees.bin_features(x, np.asarray(ref.edges)))
    feats, threshs = np.asarray(ref.feats), np.asarray(ref.threshs)
    o_feats, o_threshs = np.asarray(other.feats), np.asarray(other.threshs)
    values = torch.from_numpy(np.asarray(ref.values, np.float32))
    depth, step = int(ref.max_depth), float(ref.step_size)
    classify = np.ndim(ref.base) == 1
    n = len(y)
    ones = torch.ones(n)
    if classify:
        k = len(ref.base)
        margins = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            np.asarray(ref.base, np.float32)[None, :], (n, k))))
        onehot = torch.from_numpy(np.eye(k, dtype=np.float32)[y])
    else:
        k = 1
        margins = torch.full((n, 1), float(ref.base), dtype=torch.float32)
        target = torch.from_numpy(np.asarray(y, np.float32))
    out = {"trees": int(feats.shape[0]), "first_diverged_tree": None,
           "splits": []}
    for i in range(feats.shape[0]):
        c = i % k
        if c == 0 and classify:
            p = trees._softmax(margins)
            g, h = p - onehot, p * (1.0 - p)
        if classify:
            stats = torch.stack([g[:, c], h[:, c], ones], dim=1)
        else:
            stats = torch.stack([margins[:, 0] - target, ones, ones], dim=1)
        if (feats[i] != o_feats[i]).any() or \
                (threshs[i] != o_threshs[i]).any():
            out["first_diverged_tree"] = i
            out["splits"] = _differing_splits(i, bins, stats, feats, threshs,
                                              o_feats, o_threshs, lam,
                                              max_bins)
            return out
        leaf = trees._predict_leaves(bins, torch.from_numpy(feats[i:i + 1]),
                                     torch.from_numpy(threshs[i:i + 1]),
                                     depth)[:, 0]
        margins = margins.clone()
        margins[:, c] += step * values[i, :, c][leaf]
    return out


def forest_divergence(ref, other, x: np.ndarray, y: np.ndarray, *,
                      seed: int, subsample: bool, feature_subset: str,
                      lam: float = 0.0, max_bins: int = 32) -> dict:
    """Compare two fitted variance-reduction forests
    (``TreeRegressorModel``: a decision tree or random forest regressor) of
    one configuration on their training rows, tree by tree: each tree's
    bootstrap weights are redrawn from ``seed`` in the fit's order.
    Returns ``{"trees", "diverged_trees", "splits"}``."""
    bins = torch.from_numpy(trees.bin_features(x, np.asarray(ref.edges)))
    feats, threshs = np.asarray(ref.feats), np.asarray(ref.threshs)
    o_feats, o_threshs = np.asarray(other.feats), np.asarray(other.threshs)
    target = torch.from_numpy(np.asarray(y, np.float32))
    rng = np.random.default_rng(seed)
    heap = 1 << int(ref.max_depth)
    out = {"trees": int(feats.shape[0]), "diverged_trees": [], "splits": []}
    for i in range(feats.shape[0]):
        w = (rng.poisson(1.0, size=len(y)).astype(np.float32) if subsample
             else np.ones(len(y), np.float32))
        trees._per_node_masks(x.shape[1], feature_subset, rng, heap)
        if (feats[i] == o_feats[i]).all() and \
                (threshs[i] == o_threshs[i]).all():
            continue
        wt = torch.from_numpy(w)
        stats = torch.stack([-target * wt, wt, wt], dim=1)
        out["diverged_trees"].append(i)
        out["splits"] += _differing_splits(i, bins, stats, feats, threshs,
                                           o_feats, o_threshs, lam, max_bins)
    return out


def _ancestors(node: int):
    node >>= 1
    while node >= 1:
        yield node
        node >>= 1
