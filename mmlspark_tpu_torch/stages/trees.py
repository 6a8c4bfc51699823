"""Histogram tree learners: decision tree / random forest / gradient
boosting — the port of ``mmlspark_tpu/stages/trees.py`` onto torch.

Reference learner dispatch: train-classifier/src/main/scala/
TrainClassifier.scala:45-52 (DecisionTreeClassifier, GBTClassifier,
RandomForestClassifier) and train-regressor/src/main/scala/
TrainRegressor.scala:21-130. The design is the JAX package's, step for
step; only the device code changes:

- features are quantile-binned once on the host (``quantile_edges`` and
  ``bin_features``, bit-equal copies of the JAX package's) into small-int
  codes, shipped to the device as ``uint8`` through pinned memory when
  ``max_bins <= 256`` and widened on the device where an index needs it
- a depth level's ``(node, feature, bin)`` histograms are segment sums
  over row-major segment ids, feature-chunked by ``_FEATURE_CHUNK``
  columns so the ``[n, chunk]`` id tensor stays bounded at hashed widths.
  The JAX package computes them with ``jax.ops.segment_sum`` (an XLA op,
  no Pallas kernel), so the port uses a stock PyTorch op:
  ``index_put_(accumulate=True)`` under a scoped
  ``torch.use_deterministic_algorithms(True)``, which PyTorch documents
  as deterministic on CUDA (it sorts the ids and sums each run of equal
  ids in row order). A float ``index_add_`` sums in a varying order on
  the card, so two fits of one seed could part at a near-tie split; this
  way a seed reproduces its forest bit for bit. Every other segment sum
  of a fit (the leaf statistics, the per-feature importance) goes the
  same way
- split gain, the first-max argmax and row routing are vectorized tensor
  ops — no data-dependent Python control flow and no host sync anywhere
  in the build loop
- each tree (forests) or boosting round (GBT) is one function over device
  tensors; every fitted tree stays on the device until ONE fetch after the
  last (``_fetch_trees``, which counts its calls in :data:`fetches`)
- prediction is the depth-unrolled gather chain

Randomness stays numpy's, on the host: bootstrap weights
(``rng.poisson``) and per-node feature masks come from
``np.random.default_rng(seed)`` exactly as in the JAX package, so both
packages grow the same forests from a seed. This is a deliberate
exception to the port's rule of drawing from a ``torch.Generator``.

Trees are flat heap-indexed arrays (split feature, threshold bin, leaf
values); the fitted parameters (``edges``, ``feats``, ``threshs``,
``values``, ``base``, ``feature_importances``) stay numpy arrays in the
stage's params, as in the JAX package, so saved tree models cross between
the frameworks both ways; a device copy is cached for scoring. A node
whose best gain fails the threshold keeps the sentinel "route everything
left" split (``thresh = max_bins``), and since its left child sees
identical statistics it fails again — leaf values accumulate at the
bottom level.

Every estimator and fitted model takes ``device``: ``None`` is the card
(``cuda``; raises without a GPU), ``"cpu"`` the plain path the tests run.
Defaults follow Spark MLlib's (maxDepth=5, maxBins=32, numTrees=20,
stepSize=0.1, maxIter=20).
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import default_device, host_to_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import (
    HasFeaturesCol,
    HasLabelCol,
    HasOutputCol,
    Param,
    positive,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import stack_column

_EPS = 1e-12
#: features are processed in chunks of this many columns per segment sum
#: so the [n, chunk] id tensor stays small at d = 2^12 hashed dims
_FEATURE_CHUNK = 256

#: host fetches of fitted trees in this process — added to in
#: ``_fetch_trees`` (one per fit) and nowhere else
fetches = 0


# ---------------------------------------------------------------------------
# binning (host numpy; bit-equal to the JAX package's)


def quantile_edges(x: np.ndarray, max_bins: int) -> np.ndarray:
    """Per-column quantile bin edges, shape [d, max_bins - 1].

    Duplicate quantiles (constant / few-valued columns) collapse to +inf
    padding so they never split rows. One column-wise sort plus
    fancy-indexed gathers (linear interpolation, ``np.quantile``'s
    default method) instead of a per-column quantile loop.
    """
    n, d = x.shape
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
    # sort once; non-finite values (nan/±inf) become trailing nans so
    # each column's finite prefix is its sorted finite sample
    xf = np.where(np.isfinite(x), x, np.nan)
    xs = np.sort(xf, axis=0)  # nans sort last
    cnt = np.count_nonzero(~np.isnan(xf), axis=0)  # finite count per col
    v = qs[:, None] * (cnt[None, :] - 1).clip(min=0)  # [Q, d]
    lo = np.floor(v).astype(np.intp)
    hi = np.ceil(v).astype(np.intp)
    cols = np.arange(d)[None, :]
    elo = xs[lo, cols]
    ehi = xs[hi, cols]
    e = (elo + (v - lo) * (ehi - elo)).T  # [d, Q], rows sorted
    # collapse duplicates and edges >= column max to +inf padding; the
    # comparison is False for nan edges (empty columns) so those pad too
    colmax = np.where(cnt > 0, xs[(cnt - 1).clip(min=0), np.arange(d)], np.nan)
    bad = ~(e < colmax[:, None])
    bad[:, 1:] |= e[:, 1:] == e[:, :-1]
    e = np.where(bad, np.inf, e)
    e.sort(axis=1)  # re-pack: finite edges left, +inf padding right
    return e


def bin_features(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin values into [0, max_bins) codes via the per-column edges.

    Edge-major accumulation: edge k of every column is applied in one
    whole-matrix compare, restricted to the columns that still have a
    finite edge at position k. Matches ``searchsorted(side='right')``
    semantics incl. nan -> last bin (the negated ``<`` keeps nan on the
    "past every edge" side).
    """
    xf = x.astype(np.float32, copy=False)
    ef = edges.astype(np.float32, copy=False)
    n, d = xf.shape
    out = np.zeros((n, d), dtype=np.int32)
    n_edges = np.isfinite(ef).sum(axis=1)  # finite prefix per column
    for k in range(int(n_edges.max(initial=0))):
        cols = np.flatnonzero(n_edges > k)
        if cols.size == d:
            out += ~(xf < ef[:, k])
        else:
            out[:, cols] += ~(xf[:, cols] < ef[cols, k])
    return out


def _device_bins(codes: np.ndarray, max_bins: int,
                 device: torch.device) -> torch.Tensor:
    """Ship the [n, d] bin-code matrix to the device as uint8 when the
    codes fit (max_bins <= 256, the Spark-default 32 included) — 4x less
    transfer than int32: at census scale x 2^12 hashed dims, 133 MB
    instead of 533 MB. Pinned memory, so the copy does not wait for the
    stream; device code widens the codes where an index needs it."""
    dtype = np.uint8 if max_bins <= 256 else np.int32
    return host_to_device(
        np.ascontiguousarray(codes.astype(dtype, copy=False)), device)


# ---------------------------------------------------------------------------
# device build steps


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, the
    caller's setting restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _segment_sum(out: torch.Tensor, ids: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``out[ids[i]] += values[i]`` in place, in the same order on every
    run and device: each id's values summed in row order (the order of
    ``jax.ops.segment_sum`` on the CPU). Repeated ids accumulate."""
    with _deterministic():
        out.index_put_((ids,), values, accumulate=True)
    return out


def _level_histogram(bins, stats, slot, n_nodes: int, max_bins: int):
    """[n_nodes, d, max_bins, s] sums of per-row stats.

    Feature-chunked segment sums: ids are row-major over (node, feature,
    bin), written straight into the level's histogram, so a last chunk
    narrower than ``_FEATURE_CHUNK`` needs no padding.
    """
    n, d = bins.shape
    s = stats.shape[1]
    chunk = min(d, _FEATURE_CHUNK)
    hist = stats.new_zeros(n_nodes * d * max_bins, s)
    cols = torch.arange(chunk, device=bins.device)
    row = slot.long()[:, None] * d  # [n, 1]
    for c0 in range(0, d, chunk):
        width = min(chunk, d - c0)
        seg = (row + c0 + cols[:width]) * max_bins + bins[:, c0:c0 + width]
        data = stats[:, None, :].expand(n, width, s).reshape(n * width, s)
        _segment_sum(hist, seg.reshape(-1), data)
    return hist.reshape(n_nodes, d, max_bins, s)


def fold_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in a fixed order: sequentially within each run of
    32 entries, then sequentially over the runs' sums. It is the order
    XLA's CPU reductions take at these lengths (up to 32 and multiples of
    32: every bin count, class count and ensemble size the repo uses), so
    split gains and scores come out bit-equal to the JAX package's on the
    CPU and alike on every device. A plain ``sum`` reduces in whatever
    order the backend picks."""
    n = x.shape[dim]
    total = None
    for c0 in range(0, n, 32):
        run = x.select(dim, c0)
        for i in range(c0 + 1, min(c0 + 32, n)):
            run = run + x.select(dim, i)
        total = run if total is None else total + run
    return total


def block_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sums over ``dim`` in ``jnp.cumsum``'s CPU order:
    sequential within blocks of 16, each block offset by the running sum
    of the blocks before it (XLA rewrites the windowed reduction so)."""
    outs: list = []
    carry = None
    for c0 in range(0, x.shape[dim], 16):
        acc = x.select(dim, c0)
        block = [acc]
        for i in range(c0 + 1, min(c0 + 16, x.shape[dim])):
            acc = acc + x.select(dim, i)
            block.append(acc)
        if carry is None:
            carry = acc
        else:
            block = [b + carry for b in block]
            carry = carry + acc
        outs += block
    return torch.stack(outs, dim)


def _mask3(feat_mask):
    """Broadcast a feature mask onto [nodes, d, bins]: (d,) = one subset
    for every node; (nodes, d) = an independent subset per node (Spark's
    featureSubsetStrategy draws per split candidate, not per tree)."""
    if feat_mask.dim() == 1:
        return feat_mask[None, :, None]
    return feat_mask[:, :, None]


def xgb_gain(hist, lam: float):
    """Second-order split gain of every (node, feature, threshold) over a
    [nodes, d, B, 3] (grad, hess, count) histogram, with the left and
    right child sums: ``(gain [nodes, d, B-1], left, right)``."""
    left = block_cumsum(hist, 2)[:, :, :-1, :]  # thresh t: bins <= t
    total = fold_sum(hist, 2)[:, :, None, :]
    right = total - left

    def score(g, h):
        return (g * g) / (h + lam + _EPS)

    gain = (
        score(left[..., 0], left[..., 1])
        + score(right[..., 0], right[..., 1])
        - score(total[..., 0], total[..., 1])
    )
    return gain, left, right


def gini_gain(hist):
    """Gini impurity decrease of every (node, feature, threshold) over a
    [nodes, d, B, K] class-count histogram: ``(gain, left, right)``."""
    left = block_cumsum(hist, 2)[:, :, :-1, :]
    total = fold_sum(hist, 2)[:, :, None, :]
    right = total - left

    def impurity(c):  # sum-formulation: N * gini = N - sum(c^2)/N
        cnt = fold_sum(c, -1)
        return cnt - fold_sum(c * c, -1) / cnt.clamp(min=_EPS)

    return impurity(total) - impurity(left) - impurity(right), left, right


def _pick(gain, valid, max_bins: int, min_gain: float):
    """Per-node best split: the first maximal valid gain (``argmax``'s
    tie rule, JAX's too), or the sentinel ``thresh = max_bins`` when no
    valid split clears ``min_gain``. ``>=``: zero-gain ties still split
    (sklearn semantics) — on XOR-like data every root split has exactly
    zero gain and refusing would freeze the tree at depth 0."""
    gain = torch.where(valid, gain, -torch.inf)
    flat = gain.reshape(gain.shape[0], -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    nbins = max_bins - 1
    feat = (best // nbins).to(torch.int32)
    thresh = (best % nbins).to(torch.int32)
    ok = best_gain >= min_gain
    return (
        torch.where(ok, feat, 0),
        torch.where(ok, thresh, max_bins),  # sentinel: everything goes left
        torch.where(ok, best_gain.clamp(min=0.0), 0.0),
    )


def _best_split_xgb(hist, feat_mask, max_bins: int, lam: float,
                    min_child: float, min_gain: float):
    """Second-order (g, h, count) split search; per-node (feat,
    thresh_bin, gain)."""
    gain, left, right = xgb_gain(hist, lam)
    valid = ((left[..., 2] >= min_child) & (right[..., 2] >= min_child)
             & _mask3(feat_mask))
    return _pick(gain, valid, max_bins, min_gain)


def _best_split_gini(hist, feat_mask, max_bins: int, min_child: float,
                     min_gain: float):
    """Gini split search over per-class count stats [nodes, d, B, K]."""
    gain, left, right = gini_gain(hist)
    valid = ((fold_sum(left, -1) >= min_child)
             & (fold_sum(right, -1) >= min_child) & _mask3(feat_mask))
    return _pick(gain, valid, max_bins, min_gain)


def _route(bins, node, feat, thresh):
    """One level of heap routing: right iff bin > threshold bin."""
    b = torch.gather(bins, 1, feat[node].long()[:, None])[:, 0]
    return 2 * node + (b > thresh[node]).long()


def _build_tree(
    bins,
    stats,
    *,
    criterion: str,
    max_depth: int,
    max_bins: int,
    feat_mask,
    lam: float = 1.0,
    min_child: float = 1.0,
    min_gain: float = 0.0,
):
    """One histogram tree. Returns (feat [2^L], thresh [2^L], leaf stat
    sums [2^L, s], raw per-feature split-gain sums [d]) — all device
    tensors; leaf VALUES and importance normalization are derived by the
    caller (criterion-specific)."""
    n, d = bins.shape
    dev = bins.device
    heap = 1 << max_depth
    feat = torch.zeros(heap, dtype=torch.int32, device=dev)
    thresh = torch.full((heap,), max_bins, dtype=torch.int32, device=dev)
    node = torch.ones(n, dtype=torch.int64, device=dev)
    importance = torch.zeros(d, dtype=torch.float32, device=dev)
    for level in range(max_depth):
        base = 1 << level
        hist = _level_histogram(bins, stats, node - base, base, max_bins)
        # mask shapes: (d,) = one subset for the whole tree; (max_depth,
        # d) = one per level; (2^max_depth, d) = one per heap slot, this
        # level's nodes occupying [base, 2*base). max_depth != 2^max_depth
        # for every max_depth >= 1, so the dispatch is unambiguous.
        if feat_mask.dim() == 1:
            level_mask = feat_mask
        elif feat_mask.shape[0] == max_depth:
            level_mask = feat_mask[level]
        else:
            level_mask = feat_mask[base:2 * base]
        if criterion == "xgb":
            f, t, g = _best_split_xgb(hist, level_mask, max_bins, lam,
                                      min_child, min_gain)
        else:
            f, t, g = _best_split_gini(hist, level_mask, max_bins,
                                       min_child, min_gain)
        # per-feature split-gain accumulation stays on the device; a
        # feature split at several nodes of the level adds every gain;
        # sentinel (no-split) nodes carry zero gain
        _segment_sum(importance, f.long(), g)
        feat[base:2 * base] = f
        thresh[base:2 * base] = t
        node = _route(bins, node, feat, thresh)
    leaves = _segment_sum(stats.new_zeros(heap, stats.shape[1]),
                          node - heap, stats)
    return feat, thresh, leaves, importance


# ---------------------------------------------------------------------------
# whole-tree / whole-round functions: one per tree (forests) or per
# boosting round (GBT), the JAX package's jitted programs. Each enqueues
# device work only; the fit fetches every tree once at the end.


def _gini_tree(bins, onehot, w, feat_mask, min_child, min_gain, *, k,
               max_depth, max_bins):
    """One gini classification tree: build + leaf probabilities."""
    f, t, leaves, imp = _build_tree(
        bins, onehot * w[:, None], criterion="gini", max_depth=max_depth,
        max_bins=max_bins, feat_mask=feat_mask, min_child=min_child,
        min_gain=min_gain,
    )
    cnt = fold_sum(leaves, 1)[:, None]
    # empty leaves are unreachable (min_instances >= 1 forbids empty
    # children; sentinel splits route all rows left) — uniform filler
    probs = torch.where(cnt > 0, leaves / cnt.clamp(min=_EPS), 1.0 / k)
    return f, t, probs.float(), imp


def _variance_tree(bins, y, w, feat_mask, lam, min_child, min_gain, *,
                   max_depth, max_bins):
    """One variance-reduction regression tree (second-order gain with
    g=-y, h=1, so the leaf value -G/(H+lam) is the within-leaf mean)."""
    stats = torch.stack([-y * w, w, w], dim=1)
    f, t, leaves, imp = _build_tree(
        bins, stats, criterion="xgb", max_depth=max_depth,
        max_bins=max_bins, feat_mask=feat_mask, lam=lam,
        min_child=min_child, min_gain=min_gain,
    )
    val = -leaves[:, 0:1] / (leaves[:, 1:2] + lam + _EPS)
    return f, t, val.float(), imp


def _softmax(margins):
    """``jax.nn.softmax``'s arithmetic: exp(x - max) / sum."""
    e = torch.exp(margins - margins.max(dim=1, keepdim=True).values)
    return e / fold_sum(e, 1)[:, None]


def _gbt_class_round(bins, margins, onehot, feat_mask, lam, min_child,
                     min_gain, step_size, *, k, max_depth, max_bins):
    """One softmax boosting round: k trees on this round's (g, h), each
    folded into the margins before the next class's gradient step."""
    ones = torch.ones(margins.shape[0], dtype=torch.float32,
                      device=margins.device)
    p = _softmax(margins)
    g = p - onehot  # d/dF of softmax cross-entropy
    h = p * (1.0 - p)
    margins = margins.clone()
    fs, ts, vals, imps = [], [], [], []
    for c in range(k):
        stats = torch.stack([g[:, c], h[:, c], ones], dim=1)
        f, t, leaves, imp = _build_tree(
            bins, stats, criterion="xgb", max_depth=max_depth,
            max_bins=max_bins, feat_mask=feat_mask, lam=lam,
            min_child=min_child, min_gain=min_gain,
        )
        val = -leaves[:, 0] / (leaves[:, 1] + lam + _EPS)
        leaf_idx = _predict_leaves(bins, f[None], t[None], max_depth)[:, 0]
        margins[:, c] += step_size * val[leaf_idx]
        fs.append(f)
        ts.append(t)
        vals.append(val.float())
        imps.append(imp)
    return (margins, torch.stack(fs), torch.stack(ts), torch.stack(vals),
            torch.stack(imps))


def _gbt_reg_round(bins, pred, y, feat_mask, lam, min_child, min_gain,
                   step_size, *, max_depth, max_bins):
    """One squared-loss boosting round: tree on g = pred - y, folded into
    the running prediction."""
    ones = torch.ones(pred.shape[0], dtype=torch.float32, device=pred.device)
    stats = torch.stack([pred - y, ones, ones], dim=1)
    f, t, leaves, imp = _build_tree(
        bins, stats, criterion="xgb", max_depth=max_depth,
        max_bins=max_bins, feat_mask=feat_mask, lam=lam,
        min_child=min_child, min_gain=min_gain,
    )
    val = -leaves[:, 0] / (leaves[:, 1] + lam + _EPS)
    leaf_idx = _predict_leaves(bins, f[None], t[None], max_depth)[:, 0]
    pred = pred + step_size * val[leaf_idx]
    return pred, f, t, val.float(), imp


def _predict_leaves(bins, feats, threshs, max_depth: int):
    """Leaf index per (row, tree): depth-unrolled gather chain.

    feats/threshs: [T, 2^L]. Returns [n, T] int64 leaf indices.
    """
    n = bins.shape[0]
    t_count = feats.shape[0]
    tree = torch.arange(t_count, device=bins.device)[None, :]
    node = torch.ones((n, t_count), dtype=torch.int64, device=bins.device)
    for _ in range(max_depth):
        f = feats[tree, node]  # feats[t, node[i, t]]
        th = threshs[tree, node]
        b = torch.gather(bins, 1, f.long())
        node = 2 * node + (b > th).long()
    return node - (1 << max_depth)


def _ensemble_leaf_values(values, leaf_idx):
    """values [T, leaves, V], leaf_idx [n, T] -> [n, T, V]."""
    tree = torch.arange(values.shape[0], device=values.device)[None, :]
    return values[tree, leaf_idx]


# ---------------------------------------------------------------------------
# shared estimator plumbing


class _TreeParams:
    max_depth = Param("maximum tree depth", 5, ptype=int, validator=positive)
    max_bins = Param(
        "histogram bins per feature", 32, ptype=int, validator=positive
    )
    min_instances_per_node = Param(
        "minimum rows per child", 1, ptype=int, validator=positive
    )
    min_gain = Param("minimum split gain", 0.0, ptype=float)
    seed = Param("rng seed", 0, ptype=int)
    device = Param(
        "the device the fit runs on: None = the card (cuda; raises "
        "without a GPU), or 'cpu'/'cuda'/'cuda:N'", ptype=str,
    )


def _prep_xy(stage, dataset, classification: bool):
    """Shared learner input hygiene (also used by stages/classical.py):
    dense float features, labels na-dropped (CNTKLearner.scala:58),
    classification labels validated as indices in [0, k)."""
    dataset.require(stage.features_col, stage.label_col)
    x = stack_column(dataset, stage.features_col)
    if x.dtype == object:
        raise FriendlyError(
            f"features column '{stage.features_col}' is ragged", stage.uid
        )
    x = np.asarray(x, np.float64)
    y = np.asarray(dataset[stage.label_col])
    if y.dtype == object:  # na.drop on labels (CNTKLearner.scala:58)
        keep = np.array([v is not None for v in y])
        x, y = x[keep], y[keep].astype(np.float64)
    elif np.issubdtype(y.dtype, np.floating):
        keep = ~np.isnan(y)
        x, y = x[keep], y[keep]
    if classification:
        y = y.astype(np.int32)
        if y.size and y.min() < 0:
            # np.eye(k)[y] would silently wrap -1 onto class k-1
            raise FriendlyError(
                f"classification labels must be indices in [0, k); got "
                f"min {int(y.min())} — reindex (e.g. ValueIndexer / "
                f"TrainClassifier) first",
                stage.uid,
            )
        k = int(y.max()) + 1 if y.size else 2
        return x, y, max(k, 2)
    return x, y.astype(np.float32), None


#: per-node masks above this many entries fall back to one subset per
#: DEPTH LEVEL (shared by that level's nodes) so deep trees don't
#: materialize a [2^depth, d] array
_MAX_MASK_ENTRIES = 1 << 22


def _subset_size(d, strategy):
    if strategy == "sqrt":
        return max(1, int(np.sqrt(d)))
    if strategy == "onethird":
        return max(1, d // 3)
    if strategy == "log2":
        return max(1, int(np.log2(d)))
    raise ValueError(f"unknown feature_subset strategy {strategy!r}")


def _per_node_masks(d, strategy, rng, heap):
    """One independent feature subset per internal heap slot (rows
    [1, heap)); row 0 is unused. Matches Spark semantics, where the
    subset is redrawn for every split candidate. The draw is one
    vectorized rank-threshold over numpy uniforms (the JAX package's
    draws, value for value); past _MAX_MASK_ENTRIES the shape degrades to
    one subset per depth level, which _build_tree indexes by level."""
    if strategy == "all":
        return np.ones(d, bool)
    m = _subset_size(d, strategy)
    if heap * d <= _MAX_MASK_ENTRIES:
        u = rng.random((heap, d))
        return u.argsort(axis=1).argsort(axis=1) < m
    depth = max(1, heap.bit_length() - 1)
    return rng.random((depth, d)).argsort(axis=1).argsort(axis=1) < m


def _normalize_importance(imp: np.ndarray) -> np.ndarray:
    total = imp.sum()
    return imp / total if total > 0 else imp


def _mean_importance(imps: np.ndarray) -> np.ndarray:
    """Spark featureImportances semantics: each tree's gain vector [d]
    normalizes to 1 BEFORE averaging, so every tree votes equally
    regardless of its absolute gain scale; the average renormalizes."""
    imps = np.asarray(imps, np.float64)
    tot = imps.sum(axis=1, keepdims=True)
    normed = np.divide(
        imps, tot, out=np.zeros_like(imps), where=tot > 0
    )
    return _normalize_importance(normed.sum(axis=0))


def _to_host(tensors: list) -> list:
    """Copy device tensors to the host behind ONE wait: every copy is
    enqueued into pinned memory first, then a single event is waited
    on. CPU tensors come back as owned copies."""
    if tensors[0].device.type != "cuda":
        return [t.numpy().copy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return [h.numpy() for h in host]


def _fetch_trees(outs):
    """THE one host sync of a fit: fetch every queued tree's (feat,
    thresh, value, importance) after all of them are enqueued. Entries
    are per-tree ([heap]-leading) or per-boosting-round ([k,
    heap]-leading); the result is tree-major [T, ...] either way."""
    global fetches
    fs, ts, vs, imps = zip(*outs)
    cat = torch.cat if fs[0].dim() > 1 else torch.stack
    host = _to_host([cat(fs), cat(ts), cat(vs), cat(imps)])
    fetches += 1
    return tuple(host)


class _FittedTreeBase(Model, HasFeaturesCol, HasOutputCol):
    """Shared transform path: bin with saved edges, run the gather chain
    on the device over a cached device copy of the trees."""

    _abstract = True

    edges = Param("per-feature quantile bin edges [d, B-1]")
    feature_importances = Param(
        "per-feature importance: each tree's split gains normalized to "
        "sum 1, averaged across trees (Spark featureImportances "
        "semantics), renormalized"
    )
    feats = Param("split feature per heap node, [T, 2^L]")
    threshs = Param("split threshold bin per heap node, [T, 2^L]")
    values = Param("leaf values, [T, 2^L, V]")
    max_depth = Param("tree depth", 5, ptype=int)
    device = Param(
        "the device the model scores on: None = the card (cuda; raises "
        "without a GPU), or 'cpu'/'cuda'/'cuda:N'", ptype=str,
    )

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("output_col", "scores")
        super().__init__(**kwargs)
        self._dev_trees_src: tuple = (None, None, None, None)
        self._dev_trees: tuple = ()

    def _device_trees(self, dev: torch.device) -> tuple:
        """(feats, threshs, values) resident on ``dev`` across transform
        calls; remade only when one of the arrays or the device changes
        (an identity check against strong references to the arrays)."""
        src = (self.feats, self.threshs, self.values, dev)
        cached = self._dev_trees_src
        if all(a is b for a, b in zip(cached[:3], src[:3])) and \
                cached[3] == dev:
            return self._dev_trees
        self._dev_trees = tuple(
            host_to_device(np.ascontiguousarray(a), dev) for a in (
                np.asarray(self.feats), np.asarray(self.threshs),
                np.asarray(self.values, np.float32)))
        self._dev_trees_src = src
        return self._dev_trees

    def _leaf_values(self, dataset: Dataset):
        x = stack_column(dataset, self.features_col)
        x = np.asarray(x, np.float64)
        edges = np.asarray(self.edges)
        dev = default_device(self.device)
        # codes lie in [0, n_edges]; the fitted model doesn't carry
        # max_bins, but edges bound the code range the same way
        bins = _device_bins(bin_features(x, edges), edges.shape[1] + 1, dev)
        feats, threshs, values = self._device_trees(dev)
        leaf_idx = _predict_leaves(bins, feats, threshs, int(self.max_depth))
        return _ensemble_leaf_values(values, leaf_idx)


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _tree_mean(per_tree: torch.Tensor) -> torch.Tensor:
    """The f32 mean over trees as ``jnp.mean`` takes it: the fixed-order
    sum times the f32 reciprocal of the count."""
    return fold_sum(per_tree, 1) * (1.0 / per_tree.shape[1])


class TreeClassifierModel(_FittedTreeBase):
    """Averaged-probability tree/forest classifier.

    ``values`` hold per-leaf class probabilities; scores are
    log(mean probability) so the downstream softmax recovers the mean
    probabilities exactly.
    """

    def _transform(self, dataset: Dataset) -> Dataset:
        per_tree = self._leaf_values(dataset)  # [n, T, K]
        probs = _f64(_tree_mean(per_tree))
        scores = np.log(np.maximum(probs, 1e-15))
        return dataset.with_column(self.output_col, scores)


class GBTClassifierModel(_FittedTreeBase):
    """Boosted softmax-margin classifier: scores = prior + lr * sum(trees).

    ``values`` hold per-leaf per-class margin increments [T, leaves, K].
    """

    step_size = Param("shrinkage", 0.1, ptype=float)
    base = Param("prior logits [K]")

    def _transform(self, dataset: Dataset) -> Dataset:
        per_tree = self._leaf_values(dataset)  # [n, T, K]
        margins = fold_sum(per_tree, 1) * self.step_size
        scores = _f64(margins) + np.asarray(self.base)
        return dataset.with_column(self.output_col, scores)


class TreeRegressorModel(_FittedTreeBase):
    """Mean-over-trees regressor (decision tree = T-of-1 forest)."""

    def _transform(self, dataset: Dataset) -> Dataset:
        per_tree = self._leaf_values(dataset)  # [n, T, 1]
        pred = _f64(_tree_mean(per_tree)[:, 0])
        return dataset.with_column(self.output_col, pred)


class GBTRegressorModel(_FittedTreeBase):
    step_size = Param("shrinkage", 0.1, ptype=float)
    base = Param("initial prediction (label mean)", 0.0, ptype=float)

    def _transform(self, dataset: Dataset) -> Dataset:
        per_tree = self._leaf_values(dataset)  # [n, T, 1]
        pred = _f64(fold_sum(per_tree, 1)[:, 0]) * self.step_size + self.base
        return dataset.with_column(self.output_col, pred)


def _fitted(model: Model, device) -> Model:
    """A fitted model scores where its estimator fitted."""
    if device is not None:
        model.set(device=device)
    return model


# ---------------------------------------------------------------------------
# estimators


class DecisionTreeClassifier(
    Estimator, _TreeParams, HasFeaturesCol, HasLabelCol
):
    """Gini histogram decision tree (TrainClassifier.scala:46)."""

    num_trees = Param("trees in the forest", 1, ptype=int, validator=positive)
    subsample = Param(
        "bootstrap rows per tree (False = use all rows)", False, ptype=bool
    )
    feature_subset = Param(
        "features considered per split candidate", "all",
        domain=("all", "sqrt", "onethird", "log2"),
    )

    def _fit(self, dataset: Dataset) -> TreeClassifierModel:
        dev = default_device(self.device)
        x, y, k = _prep_xy(self, dataset, classification=True)
        edges = quantile_edges(x, self.max_bins)
        bins = _device_bins(bin_features(x, edges), self.max_bins, dev)
        onehot = host_to_device(np.eye(k, dtype=np.float32)[y], dev)
        rng = np.random.default_rng(self.seed)
        outs = []  # device tensors; the fit fetches them once at the end
        for _ in range(self.num_trees):
            w = (
                rng.poisson(1.0, size=len(y)).astype(np.float32)
                if self.subsample
                else np.ones(len(y), np.float32)
            )
            mask = host_to_device(_per_node_masks(
                x.shape[1], self.feature_subset, rng, 1 << self.max_depth
            ), dev)
            outs.append(_gini_tree(
                bins, onehot, host_to_device(w, dev), mask, k=k,
                max_depth=self.max_depth, max_bins=self.max_bins,
                min_child=float(self.min_instances_per_node),
                min_gain=float(self.min_gain),
            ))
        feats, threshs, values, imps = _fetch_trees(outs)
        return _fitted(TreeClassifierModel(
            edges=edges,
            feats=feats,
            threshs=threshs,
            values=values,
            max_depth=self.max_depth,
            features_col=self.features_col,
            feature_importances=_mean_importance(imps),
        ), self.device)


class RandomForestClassifier(DecisionTreeClassifier):
    """Bootstrap + feature-subsampled forest (TrainClassifier.scala:50).

    Spark defaults: numTrees=20, featureSubsetStrategy auto -> sqrt.
    """

    num_trees = Param("trees in the forest", 20, ptype=int, validator=positive)
    subsample = Param("bootstrap rows per tree", True, ptype=bool)
    feature_subset = Param(
        "features considered per split candidate", "sqrt",
        domain=("all", "sqrt", "onethird", "log2"),
    )


class DecisionTreeRegressor(
    Estimator, _TreeParams, HasFeaturesCol, HasLabelCol
):
    """Variance-reduction histogram regression tree (TrainRegressor)."""

    num_trees = Param("trees in the forest", 1, ptype=int, validator=positive)
    subsample = Param(
        "bootstrap rows per tree (False = use all rows)", False, ptype=bool
    )
    feature_subset = Param(
        "features considered per split candidate", "all",
        domain=("all", "sqrt", "onethird", "log2"),
    )
    lambda_ = Param("L2 regularization on leaf values", 0.0, ptype=float)

    def _fit(self, dataset: Dataset) -> TreeRegressorModel:
        dev = default_device(self.device)
        x, y, _ = _prep_xy(self, dataset, classification=False)
        edges = quantile_edges(x, self.max_bins)
        bins = _device_bins(bin_features(x, edges), self.max_bins, dev)
        yd = host_to_device(y, dev)
        rng = np.random.default_rng(self.seed)
        outs = []  # device tensors; the fit fetches them once at the end
        for _ in range(self.num_trees):
            w = (
                rng.poisson(1.0, size=len(y)).astype(np.float32)
                if self.subsample
                else np.ones(len(y), np.float32)
            )
            mask = host_to_device(_per_node_masks(
                x.shape[1], self.feature_subset, rng, 1 << self.max_depth
            ), dev)
            outs.append(_variance_tree(
                bins, yd, host_to_device(w, dev), mask,
                max_depth=self.max_depth, max_bins=self.max_bins,
                lam=float(self.lambda_),
                min_child=float(self.min_instances_per_node),
                min_gain=float(self.min_gain),
            ))
        feats, threshs, values, imps = _fetch_trees(outs)
        return _fitted(TreeRegressorModel(
            edges=edges,
            feats=feats,
            threshs=threshs,
            values=values,
            max_depth=self.max_depth,
            features_col=self.features_col,
            feature_importances=_mean_importance(imps),
        ), self.device)


class RandomForestRegressor(DecisionTreeRegressor):
    """Spark defaults: numTrees=20, featureSubsetStrategy auto -> onethird."""

    num_trees = Param("trees in the forest", 20, ptype=int, validator=positive)
    subsample = Param("bootstrap rows per tree", True, ptype=bool)
    feature_subset = Param(
        "features considered per split candidate", "onethird",
        domain=("all", "sqrt", "onethird", "log2"),
    )


class GBTClassifier(Estimator, _TreeParams, HasFeaturesCol, HasLabelCol):
    """Softmax gradient boosting (TrainClassifier.scala:47).

    Spark's GBTClassifier is binary-only; this one boosts K softmax margins
    directly, so multiclass needs no OneVsRest wrap — an intentional
    capability superset.
    """

    max_iter = Param("boosting rounds", 20, ptype=int, validator=positive)
    step_size = Param("shrinkage", 0.1, ptype=float)
    lambda_ = Param("L2 regularization on leaf values", 1.0, ptype=float)

    def _fit(self, dataset: Dataset) -> GBTClassifierModel:
        dev = default_device(self.device)
        x, y, k = _prep_xy(self, dataset, classification=True)
        edges = quantile_edges(x, self.max_bins)
        bins = _device_bins(bin_features(x, edges), self.max_bins, dev)
        onehot = host_to_device(np.eye(k, dtype=np.float32)[y], dev)
        prior = np.log(
            np.maximum(np.bincount(y, minlength=k) / max(len(y), 1), 1e-15)
        )
        margins = host_to_device(np.ascontiguousarray(np.broadcast_to(
            prior.astype(np.float32)[None, :], (len(y), k))), dev)
        mask = torch.ones(x.shape[1], dtype=torch.bool, device=dev)
        outs = []  # per-round device tensors; fetched once at the end
        for _ in range(self.max_iter):
            margins, f, t, v, imp = _gbt_class_round(
                bins, margins, onehot, mask, k=k,
                max_depth=self.max_depth, max_bins=self.max_bins,
                lam=float(self.lambda_),
                min_child=float(self.min_instances_per_node),
                min_gain=float(self.min_gain),
                step_size=float(self.step_size),
            )
            outs.append((f, t, v, imp))
        feats, threshs, vals, imps = _fetch_trees(outs)
        # one tree per class per round (fit order round-major): tree
        # r*k + c updates only class c, so its leaf-value vector is the
        # class-c one-hot of the margin increment
        heap = 1 << self.max_depth
        values = np.zeros((len(vals), heap, k), np.float32)
        for i in range(len(vals)):
            values[i, :, i % k] = vals[i]
        return _fitted(GBTClassifierModel(
            edges=edges,
            feats=feats,
            threshs=threshs,
            values=values,
            max_depth=self.max_depth,
            step_size=self.step_size,
            base=prior,
            features_col=self.features_col,
            feature_importances=_mean_importance(imps),
        ), self.device)


class GBTRegressor(Estimator, _TreeParams, HasFeaturesCol, HasLabelCol):
    """Squared-loss gradient boosting (TrainRegressor.scala learner list)."""

    max_iter = Param("boosting rounds", 20, ptype=int, validator=positive)
    step_size = Param("shrinkage", 0.1, ptype=float)
    lambda_ = Param("L2 regularization on leaf values", 1.0, ptype=float)

    def _fit(self, dataset: Dataset) -> GBTRegressorModel:
        dev = default_device(self.device)
        x, y, _ = _prep_xy(self, dataset, classification=False)
        edges = quantile_edges(x, self.max_bins)
        bins = _device_bins(bin_features(x, edges), self.max_bins, dev)
        base = float(np.mean(y)) if len(y) else 0.0
        pred = torch.full((len(y),), base, dtype=torch.float32, device=dev)
        yd = host_to_device(y, dev)
        mask = torch.ones(x.shape[1], dtype=torch.bool, device=dev)
        outs = []  # per-round device tensors; fetched once at the end
        for _ in range(self.max_iter):
            pred, f, t, val, imp = _gbt_reg_round(
                bins, pred, yd, mask,
                max_depth=self.max_depth, max_bins=self.max_bins,
                lam=float(self.lambda_),
                min_child=float(self.min_instances_per_node),
                min_gain=float(self.min_gain),
                step_size=float(self.step_size),
            )
            outs.append((f, t, val, imp))
        feats, threshs, vals, imps = _fetch_trees(outs)
        values = vals[:, :, None]  # [T, heap, 1]
        return _fitted(GBTRegressorModel(
            edges=edges,
            feats=feats,
            threshs=threshs,
            values=values,
            max_depth=self.max_depth,
            step_size=self.step_size,
            base=base,
            features_col=self.features_col,
            feature_importances=_mean_importance(imps),
        ), self.device)
