"""The port's histogram tree learners (``mmlspark_tpu_torch/stages/
trees.py``) against the JAX package's on the CPU.

The same seeded numpy inputs go through both: binning bit-equal, the
level histogram and both split searches equal, whole fits of every
learner with equal structures (split features and thresholds) and
leaf values, importances and scores within the stated tolerances, saved
models crossing the frameworks both ways, and the port's own
determinism and one host fetch per fit. The JAX fits are shared at
module scope: each costs a compile of its tree program.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mmlspark_tpu.stages.trees as jt
import mmlspark_tpu_torch.stages.trees as pt
from mmlspark_tpu.core.stage import PipelineStage as JaxStage
from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.data.dataset import Dataset

#: gini trees count rows (exact in f32); leaf values of the xgb trees sum
#: f32 gradients whose exp differs by an ulp between XLA and torch
VALUE_TOL = {"gini": 0.0, "xgb": 1e-5}
SCORE_TOL = 1e-6
GBT_SCORE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its tensors are small, so one
    thread is faster and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def xor_data(n=400, seed=0, noise=0.0):
    """``tests/test_trees.py``'s asymmetric XOR."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = ((x[:, 0] > 0.45) ^ (x[:, 1] > -0.35)).astype(np.int32)
    if noise:
        flip = rng.random(n) < noise
        y = np.where(flip, 1 - y, y)
    return x, y


def step_data(n=500, seed=1):
    """``tests/test_trees.py``'s regression target (a step plus a sine)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (2.0 * x[:, 0] + np.sin(3.0 * x[:, 1])).astype(np.float32)
    return x, y


def census_data():
    """Census compact featurized tree-style (the JAX package's
    ``Featurize``; the same matrix feeds both learners), three classes
    from the income label and the education column."""
    from mmlspark_tpu.stages.featurize import Featurize
    from mmlspark_tpu.testing.datagen import make_census

    ds = make_census(600, seed=7)
    cols = [c for c in ds.columns if c != "income"]
    feats = Featurize(feature_columns={"features": cols},
                      number_of_features=1 << 12,
                      one_hot_encode_categoricals=False).fit(ds).transform(ds)
    x = np.asarray(feats["features"], np.float64)
    edu = np.asarray(ds["education"])
    y = (np.asarray(ds["income"]) == ">50K").astype(np.int32)
    return x, np.where(edu == "phd", 2, y).astype(np.int32)


DATA = {"xor": xor_data, "xor_noisy": lambda: xor_data(noise=0.2),
        "step": step_data, "census3": census_data}

#: (estimator, dataset, kwargs, criterion)
FITS = {
    "decision_tree": ("DecisionTreeClassifier", "xor", {}, "gini"),
    "decision_tree_census3": ("DecisionTreeClassifier", "census3",
                              {"max_depth": 4}, "gini"),
    "random_forest": ("RandomForestClassifier", "xor_noisy",
                      {"num_trees": 6}, "gini"),
    "gbt_binary": ("GBTClassifier", "xor", {"max_iter": 4}, "xgb"),
    "gbt_3class": ("GBTClassifier", "census3",
                   {"max_iter": 3, "max_depth": 4}, "xgb"),
    "decision_tree_regressor": ("DecisionTreeRegressor", "step", {}, "xgb"),
    "random_forest_regressor": ("RandomForestRegressor", "step",
                                {"num_trees": 5}, "xgb"),
    "gbt_regressor": ("GBTRegressor", "step", {"max_iter": 4}, "xgb"),
}


@pytest.fixture(scope="module")
def data():
    return {name: make() for name, make in DATA.items()}


@pytest.fixture(scope="module")
def jax_fits(data):
    """Every JAX fit of ``FITS``, made once for the module."""
    out = {}
    for key, (est, ds, kw, _) in FITS.items():
        x, y = data[ds]
        out[key] = getattr(jt, est)(**kw).fit(
            JaxDataset({"features": x, "label": y}))
    return out


def port_fit(name: str, x, y, **kw):
    return getattr(pt, name)(device="cpu", **kw).fit(
        Dataset({"features": x, "label": y}))


def scores(model, x) -> np.ndarray:
    ds = (JaxDataset if model.__module__.startswith("mmlspark_tpu.")
          else Dataset)({"features": x})
    return np.asarray(model.transform(ds)["scores"])


# -- binning ---------------------------------------------------------------


def test_binning_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    n, d = 500, 23
    x = rng.normal(size=(n, d))
    x[:, 0] = 1.0  # constant
    x[:, 1] = rng.integers(0, 3, n)  # few-valued: duplicate quantiles
    x[rng.random((n, d)) < 0.05] = np.nan
    x[rng.random((n, d)) < 0.02] = np.inf
    x[rng.random((n, d)) < 0.02] = -np.inf
    x[:, 2] = np.nan  # an empty column
    for max_bins in (2, 16, 32, 256):
        edges = pt.quantile_edges(x, max_bins)
        np.testing.assert_array_equal(edges, jt.quantile_edges(x, max_bins))
        np.testing.assert_array_equal(pt.bin_features(x, edges),
                                      jt.bin_features(x, edges))
    assert np.all(np.isinf(pt.quantile_edges(x, 8)[0]))


def test_device_bins_ship_uint8_and_wider_codes_int32():
    codes = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert pt._device_bins(codes, 32, torch.device("cpu")).dtype == torch.uint8
    wide = pt._device_bins(codes + 300, 512, torch.device("cpu"))
    assert wide.dtype == torch.int32 and int(wide.max()) == 311


# -- the device steps ------------------------------------------------------


def test_level_histogram_bit_equal_to_jax_across_feature_chunks():
    """d = 300 > _FEATURE_CHUNK: a full chunk and a padded one in JAX, a
    narrower last chunk in the port."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n, d, max_bins, nodes = 2000, 300, 32, 4
    bins = rng.integers(0, max_bins, (n, d)).astype(np.uint8)
    stats = np.stack([rng.normal(size=n), rng.random(n) * 0.25,
                      np.ones(n)], axis=1).astype(np.float32)
    slot = rng.integers(0, nodes, n).astype(np.int32)
    want = np.asarray(jt._level_histogram(
        jnp.asarray(bins).astype(jnp.int32), jnp.asarray(stats),
        jnp.asarray(slot), nodes, max_bins))
    got = pt._level_histogram(torch.from_numpy(bins), torch.from_numpy(stats),
                              torch.from_numpy(slot), nodes, max_bins)
    assert got.shape == (nodes, d, max_bins, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_searches_agree_with_jax_on_one_histogram():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    nodes, d, max_bins = 4, 40, 32
    g = rng.normal(size=(nodes, d, max_bins)) * 5
    h = rng.random((nodes, d, max_bins)) * 3
    cnt = rng.integers(0, 20, (nodes, d, max_bins)).astype(np.float64)
    cnt[0, :, 1:] = 0  # a node whose rows all share one bin: no split
    xgb = np.stack([g, h, cnt], axis=-1).astype(np.float32)
    gini = rng.integers(0, 30, (nodes, d, max_bins, 3)).astype(np.float32)
    mask = rng.random((nodes, d)) < 0.6
    for kind, hist in (("xgb", xgb), ("gini", gini)):
        if kind == "xgb":
            want = jt._best_split_xgb(
                jnp.asarray(hist), jnp.asarray(mask), max_bins,
                jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0))
            got = pt._best_split_xgb(torch.from_numpy(hist),
                                     torch.from_numpy(mask), max_bins,
                                     1.0, 1.0, 0.0)
        else:
            want = jt._best_split_gini(
                jnp.asarray(hist), jnp.asarray(mask), max_bins,
                jnp.float32(1.0), jnp.float32(0.0))
            got = pt._best_split_gini(torch.from_numpy(hist),
                                      torch.from_numpy(mask), max_bins,
                                      1.0, 0.0)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5, atol=0)
        if kind == "xgb":
            assert int(got[1][0]) == max_bins  # the sentinel split


def test_fold_sum_and_block_cumsum_follow_jax_cpu_order():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    for shape, dim in (((3, 7, 32, 3), 2), ((50, 3), 1), ((20, 64), 1),
                       ((4, 5, 16, 2), 2)):
        x = (rng.normal(size=shape) * 1e3).astype(np.float32)
        t = torch.from_numpy(x)
        np.testing.assert_array_equal(pt.fold_sum(t, dim).numpy(),
                                      np.asarray(jnp.sum(x, axis=dim)))
        np.testing.assert_array_equal(pt.block_cumsum(t, dim).numpy(),
                                      np.asarray(jnp.cumsum(x, axis=dim)))


def test_importance_accumulates_a_feature_split_twice_in_one_level():
    """Both depth-1 nodes split on feature 1: its importance is the sum of
    both gains (a plain ``imp[f] += g`` keeps one of them)."""
    imp = torch.zeros(3)
    pt._segment_sum(imp, torch.tensor([1, 1, 0]), torch.tensor([2.0, 3.0,
                                                                0.5]))
    assert imp.tolist() == [0.5, 5.0, 0.0]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(400, 3)).astype(np.float32)
    y = (4.0 * (x[:, 0] > 0) + 1.0 * (x[:, 1] > 0.2)).astype(np.float32)
    port = port_fit("DecisionTreeRegressor", x, y, max_depth=2)
    ref = jt.DecisionTreeRegressor(max_depth=2).fit(
        JaxDataset({"features": x, "label": y}))
    assert port.feats[0, 1] == 0 and list(port.feats[0, 2:4]) == [1, 1]
    np.testing.assert_array_equal(port.feats, ref.feats)
    np.testing.assert_allclose(port.feature_importances,
                               ref.feature_importances, rtol=1e-6)
    # two level-1 gains, both on feature 1, against the root's on feature 0
    assert 0.0 < port.feature_importances[1] < port.feature_importances[0]


# -- whole fits --------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(FITS))
def test_fit_matches_jax(key, data, jax_fits):
    est, ds, kw, criterion = FITS[key]
    x, y = data[ds]
    ref = jax_fits[key]
    before = pt.fetches
    port = port_fit(est, x, y, **kw)
    assert pt.fetches == before + 1  # one host fetch for the whole fit
    np.testing.assert_array_equal(port.feats, ref.feats)
    np.testing.assert_array_equal(port.threshs, ref.threshs)
    assert port.values.dtype == np.float32
    assert port.values.shape == np.asarray(ref.values).shape
    np.testing.assert_allclose(port.values, ref.values,
                               atol=VALUE_TOL[criterion], rtol=0)
    np.testing.assert_allclose(port.feature_importances,
                               ref.feature_importances, atol=1e-6)
    tol = GBT_SCORE_TOL if est.startswith("GBT") else SCORE_TOL
    np.testing.assert_allclose(scores(port, x), scores(ref, x), atol=tol,
                               rtol=0)
    if est == "GBTClassifier":
        np.testing.assert_array_equal(port.base, ref.base)


def test_fit_is_deterministic_under_a_seed(data):
    x, y = data["xor_noisy"]
    a = port_fit("RandomForestClassifier", x, y, num_trees=4, seed=3)
    b = port_fit("RandomForestClassifier", x, y, num_trees=4, seed=3)
    c = port_fit("RandomForestClassifier", x, y, num_trees=4, seed=4)
    for name in ("feats", "threshs", "values", "feature_importances"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.feats, c.feats)


def test_saved_models_cross_the_frameworks_both_ways(tmp_path, data,
                                                     jax_fits):
    x, y = data["xor_noisy"]
    for key in ("random_forest", "gbt_3class", "gbt_regressor"):
        est, ds, kw, _ = FITS[key]
        xs = data[ds][0]
        ref = jax_fits[key]
        ref.save(str(tmp_path / key))
        loaded = PipelineStage.load(str(tmp_path / key))
        assert type(loaded).__name__ == type(ref).__name__
        assert loaded.__module__ == "mmlspark_tpu_torch.stages.trees"
        loaded.set(device="cpu")
        np.testing.assert_allclose(scores(loaded, xs), scores(ref, xs),
                                   atol=SCORE_TOL, rtol=0)
    # the reverse: a port fit, saved without its device, scores alike in JAX
    port = port_fit("GBTClassifier", x, y, max_iter=3)
    params = {k: v for k, v in port.param_values().items() if k != "device"}
    type(port)(**params).save(str(tmp_path / "port"))
    back = JaxStage.load(str(tmp_path / "port"))
    assert back.__module__ == "mmlspark_tpu.stages.trees"
    np.testing.assert_allclose(scores(back, x), scores(port, x),
                               atol=SCORE_TOL, rtol=0)


def test_the_default_device_is_the_card():
    from mmlspark_tpu_torch.core.exceptions import FriendlyError

    x, y = xor_data(n=40)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(FriendlyError, match="no CUDA device"):
        pt.DecisionTreeClassifier().fit(Dataset({"features": x, "label": y}))


def test_tree_parity_finds_the_split_where_two_fits_part(data):
    """The near-tie accounting the card gates use: equal fits do not
    part; a fit with one split moved parts at that node, and its gain
    gap is far from a tie."""
    from mmlspark_tpu_torch.testing.tree_parity import (
        forest_divergence,
        gbt_divergence,
    )

    x, y = data["step"]
    kw = dict(num_trees=3, seed=5)
    a = port_fit("RandomForestRegressor", x, y, **kw)
    b = port_fit("RandomForestRegressor", x, y, **kw)
    fit = dict(seed=5, subsample=True, feature_subset="onethird")
    assert forest_divergence(a, b, x, y, **fit)["splits"] == []
    b.feats[1, 2] = (b.feats[1, 2] + 1) % x.shape[1]
    div = forest_divergence(a, b, x, y, **fit)
    assert div["diverged_trees"] == [1]
    [split] = div["splits"]
    assert (split["tree"], split["node"]) == (1, 2)
    assert not split["near_tie"] and split["rel_gap"] > 1e-3
    xc, yc = data["xor"]
    g = port_fit("GBTClassifier", xc, yc, max_iter=3)
    h = port_fit("GBTClassifier", xc, yc, max_iter=3)
    assert gbt_divergence(g, h, xc, yc)["first_diverged_tree"] is None
    h.threshs[2, 1] = (h.threshs[2, 1] + 5) % 31
    div = gbt_divergence(g, h, xc, yc)
    assert div["first_diverged_tree"] == 2
    assert [(s["tree"], s["node"]) for s in div["splits"]] == [(2, 1)]
