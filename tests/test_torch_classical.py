"""The port's classical surface against the JAX package's on the CPU:
the datagen tables, the value indexer, ``Featurize``, the prep stages,
naive Bayes and one-vs-rest, ``TrainClassifier``/``TrainRegressor`` end
to end, the evaluation stages, ``FindBestModel``, ``EnsembleByKey`` and
``TextFeaturizer``.

Everything but the learners is host numpy on both sides, so those
comparisons are exact; the tree learners inside the Train* stages are
held to ``tests/test_torch_trees.py``'s tolerances. The JAX fits are
shared at module scope.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mmlspark_tpu.stages as jstages  # noqa: F401  (registers the stages)
import mmlspark_tpu_torch.stages  # noqa: F401
from mmlspark_tpu.core import schema as jschema
from mmlspark_tpu.core.stage import PipelineStage as JaxStage
from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu.testing import datagen as jdatagen
from mmlspark_tpu_torch.core import schema as pschema
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.testing import datagen as pdatagen

GBT_SCORE_TOL = 1e-4
SCORE_TOL = 1e-6
#: a bf16 linear layer's scores (tests/test_torch_dnn_stages.py's MLP tol)
BF16_RTOL, BF16_ATOL = 2e-2, 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its tensors are small, so one
    thread is faster and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_cls(module: str, name: str):
    import importlib

    return getattr(importlib.import_module(f"mmlspark_tpu.stages.{module}"),
                   name)


def port_cls(module: str, name: str):
    import importlib

    return getattr(importlib.import_module(
        f"mmlspark_tpu_torch.stages.{module}"), name)


def both(columns: dict):
    """The same columns as a port Dataset and a JAX Dataset."""
    return Dataset(dict(columns)), JaxDataset(dict(columns))


def _norm(v):
    """A comparable form of an object cell (``np.str_`` == ``str``, nan ==
    nan)."""
    if isinstance(v, str):
        return str(v)
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return repr(v)


def assert_same_column(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    if a.dtype == object or b.dtype == object:
        assert [_norm(v) for v in a.ravel()] == [_norm(v) for v in
                                                 b.ravel()], name
    else:
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_same_dataset(port, ref):
    assert port.columns == ref.columns
    assert port.num_rows == ref.num_rows
    assert port.num_partitions == ref.num_partitions
    for c in port.columns:
        assert_same_column(port[c], ref[c], c)
        pm, jm = port.meta_of(c), ref.meta_of(c)
        assert (pm.kind, pm.value_kind) == (jm.kind, jm.value_kind), c
        pc, jc = pm.categorical, jm.categorical
        assert (pc is None) == (jc is None), c
        if pc is not None:
            assert (pc.levels, pc.has_null) == (jc.levels, jc.has_null), c


# -- datagen and the value indexer ---------------------------------------------


def test_datagen_tables_equal_the_jax_ones():
    opts = dict(num_rows=40, num_vector=1, missing_ratio=0.2)
    for kind in ("binary", "multiclass", "continuous"):
        assert_same_dataset(
            pdatagen.generate_dataset(
                pdatagen.DatasetOptions(label_kind=kind, **opts), seed=3),
            jdatagen.generate_dataset(
                jdatagen.DatasetOptions(label_kind=kind, **opts), seed=3))
    for full in (False, True):
        assert_same_dataset(pdatagen.make_census(50, 7, full_schema=full),
                            jdatagen.make_census(50, 7, full_schema=full))
    assert_same_dataset(pdatagen.make_flights(60, 3),
                        jdatagen.make_flights(60, 3))
    for fn in ("blob_images", "bar_images"):
        (pi, py), (ji, jy) = (getattr(m, fn)(6, 1) for m in (pdatagen,
                                                             jdatagen))
        np.testing.assert_array_equal(np.stack(pi), np.stack(ji))
        np.testing.assert_array_equal(py, jy)
    # the generation recipe is the port's own too (tests/test_torch_cli.py)
    assert callable(pdatagen.overfit_periodic_lm)


def test_value_indexer_round_trips_like_jax():
    cols = {"c": ["b", "a", None, "c", "a"], "n": np.array([3.0, 1.0, 2.0,
                                                            np.nan, 1.0])}
    p, j = both(cols)
    for col in ("c", "n"):
        pm = port_cls("value_indexer", "ValueIndexer")(
            input_col=col, output_col="i").fit(p)
        jm = jax_cls("value_indexer", "ValueIndexer")(
            input_col=col, output_col="i").fit(j)
        assert pm.levels == jm.levels and pm.has_null == jm.has_null
        pi, ji = pm.transform(p), jm.transform(j)
        assert_same_dataset(pi, ji)
        back = port_cls("value_indexer", "IndexToValue")(
            input_col="i", output_col="v").transform(pi)
        assert_same_dataset(back, jax_cls("value_indexer", "IndexToValue")(
            input_col="i", output_col="v").transform(ji))
    with pytest.raises(FriendlyError, match="unseen level"):
        pm.transform(Dataset({"n": np.array([7.0])}))


# -- Featurize -------------------------------------------------------------------


def mixed_columns(n=30, seed=0):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n)
    num[3] = np.nan
    return {
        "num": num,
        "count": rng.integers(0, 9, n),
        "flag": rng.random(n) > 0.5,
        "text": [None if i == 5 else " ".join(rng.choice(
            ["red", "green", "pear", "apple", "the", "ripe"], 3))
            for i in range(n)],
        "when": (np.datetime64("2017-06-04T10:30:00")
                 + rng.integers(0, 10**7, n).astype("timedelta64[s]")),
        "vec": rng.normal(size=(n, 3)),
        "cat": list(rng.choice(["x", "y", "z"], n)),
    }


@pytest.mark.parametrize("kw", [
    {}, {"one_hot_encode_categoricals": False, "number_of_features": 64},
    {"standardize": False, "number_of_features": 1 << 12},
])
def test_featurize_bit_equal_to_jax(kw):
    p, j = both(mixed_columns())
    p = port_cls("value_indexer", "ValueIndexer")(
        input_col="cat", output_col="cat").fit(p).transform(p)
    j = jax_cls("value_indexer", "ValueIndexer")(
        input_col="cat", output_col="cat").fit(j).transform(j)
    pm = port_cls("featurize", "Featurize")(**kw).fit(p)
    jm = jax_cls("featurize", "Featurize")(**kw).fit(j)
    po, jo = pm.transform(p), jm.transform(j)
    assert_same_dataset(po, jo)
    assert po.num_rows == 28  # the nan and the missing-text rows drop
    assert pm.models[0].feature_dim == jm.models[0].feature_dim
    sub = {"num": p["num"], "text": p["text"]}
    asm = port_cls("featurize", "AssembleFeatures")(
        number_of_features=32, output_col="f").fit(Dataset(sub))
    ref = jax_cls("featurize", "AssembleFeatures")(
        number_of_features=32, output_col="f").fit(JaxDataset(sub))
    assert_same_dataset(asm.transform(Dataset(sub)),
                        ref.transform(JaxDataset(sub)))


# -- the prep stages ---------------------------------------------------------


PREP_CASES = [
    ("CleanMissingData", {"input_cols": ["num"]}),
    ("CleanMissingData", {"cleaning_mode": "Median"}),
    ("CleanMissingData", {"input_cols": ["num"], "cleaning_mode": "Custom",
                          "custom_value": -1.0, "output_cols": ["num2"]}),
    ("DataConversion", {"cols": ["count"], "convert_to": "float"}),
    ("DataConversion", {"cols": ["count", "flag"], "convert_to": "string"}),
    ("DataConversion", {"cols": ["when"], "convert_to": "string"}),
    ("DataConversion", {"cols": ["cat"], "convert_to": "toCategorical"}),
    ("ClassBalancer", {"input_col": "cat"}),
    ("SummarizeData", {}),
    ("PartitionSample", {"mode": "Head", "count": 7}),
    ("PartitionSample", {"random_sample_mode": "Absolute", "count": 9,
                         "seed": 2}),
    ("PartitionSample", {"percent": 0.5, "seed": 1}),
    ("PartitionSample", {"mode": "AssignToPartition", "num_parts": 3}),
    ("Cacher", {}),
    ("Repartition", {"n": 4}),
    ("DropColumns", {"cols": ["vec", "text"]}),
    ("SelectColumns", {"cols": ["num", "cat"]}),
]


@pytest.mark.parametrize("name,kw", PREP_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(PREP_CASES)])
def test_prep_stage_matches_jax(name, kw):
    cols = mixed_columns()
    if name == "SummarizeData":
        cols = {k: v for k, v in cols.items() if k not in ("vec", "when")}
    p, j = both(cols)
    ps, js = port_cls("prep", name)(**kw), jax_cls("prep", name)(**kw)
    if hasattr(ps, "fit"):
        ps, js = ps.fit(p), js.fit(j)
    assert_same_dataset(ps.transform(p), js.transform(j))


def test_prep_wrappers_match_jax(tmp_path):
    p, j = both(mixed_columns())
    # MultiColumnAdapter over the value indexer
    pad = port_cls("prep", "MultiColumnAdapter")(
        base_stage=port_cls("value_indexer", "ValueIndexer")(),
        input_cols=["cat", "count"], output_cols=["ci", "ni"])
    jad = jax_cls("prep", "MultiColumnAdapter")(
        base_stage=jax_cls("value_indexer", "ValueIndexer")(),
        input_cols=["cat", "count"], output_cols=["ci", "ni"])
    assert_same_dataset(pad.transform(p), jad.transform(j))
    # CheckpointData writes, reloads and removes
    pck = port_cls("prep", "CheckpointData")(
        checkpoint_dir=str(tmp_path / "ck"), remove_checkpoint=True)
    assert_same_dataset(pck.transform(p), j)
    assert not (tmp_path / "ck").exists()
    # Timer: the wrapped stage's output, one record an op, a torch trace
    timer = port_cls("prep", "Timer")(
        stage=port_cls("prep", "CleanMissingData")(input_cols=["num"]),
        profile_dir=str(tmp_path / "trace"))
    jtimer = jax_cls("prep", "Timer")(
        stage=jax_cls("prep", "CleanMissingData")(input_cols=["num"]))
    assert_same_dataset(timer.transform(p), jtimer.transform(j))
    assert [r["op"] for r in timer.records] == ["fit", "transform"]
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 2 and all(t.stat().st_size > 0 for t in traces)


# -- naive Bayes and one-vs-rest ----------------------------------------------


def count_data(n=200, seed=5, k=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    x = rng.poisson(1.0 + 2.0 * (np.arange(6)[None, :] % k == y[:, None]))
    return x.astype(np.float64), y.astype(np.int64)


def test_naive_bayes_and_one_vs_rest_match_jax():
    x, y = count_data()
    p, j = both({"features": x, "label": y})
    pm = port_cls("classical", "NaiveBayes")(smoothing=0.5).fit(p)
    jm = jax_cls("classical", "NaiveBayes")(smoothing=0.5).fit(j)
    np.testing.assert_array_equal(pm.log_likelihood, jm.log_likelihood)
    np.testing.assert_array_equal(pm.log_prior, jm.log_prior)
    assert_same_dataset(pm.transform(p), jm.transform(j))
    with pytest.raises(FriendlyError, match="non-negative"):
        port_cls("classical", "NaiveBayes")().fit(
            Dataset({"features": -x, "label": y}))
    labels = np.array(["a", "b", "c", None], dtype=object)[
        np.minimum(y, 3)]
    labels[::17] = None
    p, j = both({"features": x, "label": labels})
    pm = port_cls("classical", "OneVsRest")(
        learner=port_cls("classical", "NaiveBayes")()).fit(p)
    jm = jax_cls("classical", "OneVsRest")(
        learner=jax_cls("classical", "NaiveBayes")()).fit(j)
    assert pm.levels == jm.levels == ["a", "b", "c"]
    assert_same_dataset(pm.transform(p), jm.transform(j))
    # around a tree learner, on the device path
    ptree = port_cls("trees", "DecisionTreeClassifier")(max_depth=3,
                                                        device="cpu")
    po = port_cls("classical", "OneVsRest")(learner=ptree).fit(p)
    jo = jax_cls("classical", "OneVsRest")(
        learner=jax_cls("trees", "DecisionTreeClassifier")(max_depth=3)
    ).fit(j)
    np.testing.assert_allclose(np.asarray(po.transform(p)["scores"]),
                               np.asarray(jo.transform(j)["scores"]),
                               atol=SCORE_TOL, rtol=0)


# -- TrainClassifier / TrainRegressor ------------------------------------------


CLASSIFIERS = ("decision_tree", "random_forest", "gbt", "naive_bayes")
REGRESSORS = ("decision_tree", "random_forest", "gbt")


@pytest.fixture(scope="module")
def census():
    return jdatagen.make_census(300, seed=9), jdatagen.make_census(120, 10)


@pytest.fixture(scope="module")
def flights():
    return jdatagen.make_flights(300, seed=3), jdatagen.make_flights(100, 4)


def to_port(ds) -> Dataset:
    return Dataset({c: ds[c] for c in ds.columns})


TREE_KW = {"num_trees": 5, "max_iter": 4, "max_depth": 4}


@pytest.fixture(scope="module")
def jax_classifiers(census):
    train, _ = census
    TC = jax_cls("train_classifier", "TrainClassifier")
    return {m: TC(label_col="income", model=m, seed=0, **TREE_KW).fit(train)
            for m in CLASSIFIERS}


@pytest.fixture(scope="module")
def jax_regressors(flights):
    train, _ = flights
    TR = jax_cls("train_regressor", "TrainRegressor")
    return {m: TR(label_col="arr_delay", model=m, seed=0,
                  **TREE_KW).fit(train) for m in REGRESSORS}


def assert_scored_alike(port, ref, own_uid, tol, labels=True):
    assert port.columns == ref.columns
    for c in port.columns:
        pm, jm = port.meta_of(c), ref.meta_of(c)
        assert (pm.kind, pm.value_kind) == (jm.kind, jm.value_kind), c
        assert (pm.categorical is None) == (jm.categorical is None), c
        if pm.categorical is not None:
            assert pm.categorical.levels == jm.categorical.levels, c
        if pm.kind is not None:
            assert pm.model == own_uid, c
    for c in ("scores", "scored_probabilities"):
        if c in port.columns:
            np.testing.assert_allclose(np.asarray(port[c]),
                                       np.asarray(ref[c]), atol=tol, rtol=0)
    assert_same_column(port["scored_labels"], ref["scored_labels"])


def staged(gbt, upto: int, device="cpu"):
    """The port's model of a fitted GBT's first ``upto`` trees."""
    cls = port_cls("trees", type(gbt).__name__)
    return cls(edges=np.asarray(gbt.edges), feats=gbt.feats[:upto],
               threshs=gbt.threshs[:upto], values=gbt.values[:upto],
               max_depth=gbt.max_depth, step_size=gbt.step_size,
               base=gbt.base, device=device)


def gbt_parts_at_near_ties(port, ref, train_port, labels, test_port):
    """When two boosted fits part, every differing split of the first tree
    where they part must be a near tie, and the trees before it must
    score alike. Returns the near-tie splits (empty: the fits agree)."""
    from mmlspark_tpu_torch.testing.tree_parity import gbt_divergence

    x = np.asarray(port.featurizer.transform(train_port)["features"])
    div = gbt_divergence(ref.learner_model, port.learner_model, x, labels)
    if div["first_diverged_tree"] is None:
        return []
    assert div["splits"] and all(s["near_tie"] for s in div["splits"]), div
    upto = div["first_diverged_tree"]
    feats = port.featurizer.transform(test_port)
    a = staged(port.learner_model, upto).transform(feats)["scores"]
    b = staged(ref.learner_model, upto).transform(feats)["scores"]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               atol=GBT_SCORE_TOL, rtol=0)
    return div["splits"]


@pytest.mark.parametrize("learner", CLASSIFIERS)
def test_train_classifier_matches_jax(learner, census, jax_classifiers):
    train, test = census
    ref = jax_classifiers[learner]
    TC = port_cls("train_classifier", "TrainClassifier")
    model = TC(label_col="income", model=learner, seed=0, device="cpu",
               **TREE_KW).fit(to_port(train))
    assert model.levels == ref.levels
    if learner == "gbt":
        labels = np.asarray([model.levels.index(v) for v in train["income"]])
        ties = gbt_parts_at_near_ties(model, ref, to_port(train), labels,
                                      to_port(test))
        if ties:  # listed in CHANGES.md with their gains
            assert [(s["tree"], s["node"]) for s in ties] == [(3, 10)]
            got, want = model.transform(to_port(test)), ref.transform(test)
            assert_scored_alike(got, want, model.uid, np.inf, labels=False)
            return
    tol = GBT_SCORE_TOL if learner == "gbt" else SCORE_TOL
    assert_scored_alike(model.transform(to_port(test)), ref.transform(test),
                        model.uid, tol)


@pytest.mark.parametrize("learner", REGRESSORS)
def test_train_regressor_matches_jax(learner, flights, jax_regressors):
    train, test = flights
    ref = jax_regressors[learner]
    TR = port_cls("train_regressor", "TrainRegressor")
    model = TR(label_col="arr_delay", model=learner, seed=0, device="cpu",
               **TREE_KW).fit(to_port(train))
    tol = GBT_SCORE_TOL if learner == "gbt" else SCORE_TOL
    assert_scored_alike(model.transform(to_port(test)), ref.transform(test),
                        model.uid, tol)


def test_train_stages_pass_the_device_to_their_learners():
    TC = port_cls("train_classifier", "TrainClassifier")
    TR = port_cls("train_regressor", "TrainRegressor")
    for m in ("gbt", "random_forest", "logistic_regression", "mlp"):
        assert TC(model=m, device="cpu")._make_learner(2).device == "cpu"
    for m in ("gbt", "decision_tree", "linear_regression", "mlp"):
        assert TR(model=m, device="cpu")._make_learner().device == "cpu"


def test_jax_logistic_regression_model_scores_alike_in_the_port(
        tmp_path, census):
    train, test = census
    ref = jax_cls("train_classifier", "TrainClassifier")(
        label_col="income", epochs=2, learning_rate=5e-2).fit(train)
    ref.save(str(tmp_path / "lr"))
    model = PipelineStage.load(str(tmp_path / "lr"))
    assert type(model).__module__ == (
        "mmlspark_tpu_torch.stages.train_classifier")
    model.learner_model.set(device="cpu")
    got, want = model.transform(to_port(test)), ref.transform(test)
    # the linear layer computes in bf16 in both packages (flax's
    # ``Dense(dtype=bfloat16)``), with other accumulation orders: the
    # stage tests' bf16 tolerance (tests/test_torch_dnn_stages.py)
    for c in ("scores", "scored_probabilities"):
        np.testing.assert_allclose(np.asarray(got[c]), np.asarray(want[c]),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
    margin = np.abs(np.diff(np.asarray(want["scores"]), axis=1))[:, 0]
    clear = margin > 2 * BF16_ATOL
    assert clear.mean() > 0.9
    assert_same_column(np.asarray(got["scored_labels"])[clear],
                       np.asarray(want["scored_labels"])[clear])
    assert got.meta_of("scored_labels").model == model.uid


# -- evaluation and model selection ------------------------------------------


def scored_pair(kind: str, seed=0, n=150):
    """One scored dataset, as a port and a JAX Dataset with the same
    values and the same metadata."""
    rng = np.random.default_rng(seed)
    out = []
    for schema, D in ((pschema, Dataset), (jschema, JaxDataset)):
        r = np.random.default_rng(seed)
        if kind == "classification":
            levels = ("no", "yes")
            p1 = r.random(n)
            probs = np.stack([1 - p1, p1], axis=1)
            truth = np.where(r.random(n) < p1, "yes", "no")
            pred = np.where(p1 > 0.5, "yes", "no")
            cat = schema.CategoricalMeta(levels)
            ds = D({"label": list(truth), "scored_probabilities": probs,
                    "scored_labels": list(pred)})
            ds = ds.with_meta("label", schema.ColumnMeta(
                kind=schema.LABEL_KIND, model="m",
                value_kind=schema.CLASSIFICATION, categorical=cat))
            ds = ds.with_meta("scored_probabilities", schema.ColumnMeta(
                kind=schema.SCORED_PROBABILITIES_KIND, model="m",
                value_kind=schema.CLASSIFICATION))
            ds = ds.with_meta("scored_labels", schema.ColumnMeta(
                kind=schema.SCORED_LABELS_KIND, model="m",
                value_kind=schema.CLASSIFICATION, categorical=cat))
        else:
            y = r.normal(size=n) * 3
            ds = D({"label": y, "scored_labels": y + r.normal(size=n)})
            ds = ds.with_meta("label", schema.ColumnMeta(
                kind=schema.LABEL_KIND, model="m",
                value_kind=schema.REGRESSION))
            ds = ds.with_meta("scored_labels", schema.ColumnMeta(
                kind=schema.SCORED_LABELS_KIND, model="m",
                value_kind=schema.REGRESSION))
        out.append(ds)
    del rng
    return out


@pytest.mark.parametrize("kind", ["classification", "regression"])
def test_model_statistics_equal_jax(kind):
    p, j = scored_pair(kind)
    pstats = port_cls("eval_metrics", "ComputeModelStatistics")()
    jstats = jax_cls("eval_metrics", "ComputeModelStatistics")()
    po, jo = pstats.transform(p), jstats.transform(j)
    assert po.columns == jo.columns
    for c in po.columns:
        np.testing.assert_allclose(np.asarray(po[c], np.float64),
                                   np.asarray(jo[c], np.float64),
                                   rtol=1e-12, atol=1e-12, err_msg=c)
    assert [(m.name, m.value) for m in pstats.metrics] == [
        (m.name, m.value) for m in jstats.metrics]
    if kind == "classification":
        assert "AUC" in po.columns
        np.testing.assert_array_equal(pstats.confusion_matrix,
                                      jstats.confusion_matrix)
        np.testing.assert_allclose(pstats.roc_curve, jstats.roc_curve,
                                   rtol=1e-12, atol=1e-12)
    pp = port_cls("eval_metrics", "ComputePerInstanceStatistics")()
    jp = jax_cls("eval_metrics", "ComputePerInstanceStatistics")()
    pi, ji = pp.transform(p), jp.transform(j)
    for c in ("log_loss",) if kind == "classification" else ("L1_loss",
                                                              "L2_loss"):
        np.testing.assert_allclose(np.asarray(pi[c]), np.asarray(ji[c]),
                                   rtol=1e-12, atol=1e-12)


def test_binary_auc_matches_jax():
    from mmlspark_tpu.stages.eval_metrics import binary_auc as jauc
    from mmlspark_tpu_torch.stages.eval_metrics import ROC_BINS, binary_auc

    assert ROC_BINS == 1000
    rng = np.random.default_rng(8)
    y = rng.integers(0, 2, 500)
    p = np.clip(y * 0.3 + rng.random(500) * 0.7, 0, 1)
    (a, ra), (b, rb) = binary_auc(y, p), jauc(y, p)
    assert a == b
    np.testing.assert_array_equal(ra, rb)


def test_find_best_model_picks_what_jax_picks(census, jax_classifiers):
    train, test = census
    TC = port_cls("train_classifier", "TrainClassifier")
    models = [TC(label_col="income", model=m, seed=0, device="cpu",
                 **TREE_KW).fit(to_port(train)) for m in CLASSIFIERS]
    for metric in ("AUC", "accuracy"):
        best = port_cls("find_best", "FindBestModel")(
            models=models, evaluation_metric=metric).fit(to_port(test))
        ref = jax_cls("find_best", "FindBestModel")(
            models=[jax_classifiers[m] for m in CLASSIFIERS],
            evaluation_metric=metric).fit(test)
        assert models.index(best.best_model) == [
            jax_classifiers[m] for m in CLASSIFIERS].index(ref.best_model)
        np.testing.assert_allclose(best.best_metric_value,
                                   ref.best_metric_value, atol=1e-9)
        assert best.all_model_metrics.num_rows == len(CLASSIFIERS)
    assert "scored_labels" in best.transform(to_port(test)).columns


# -- EnsembleByKey and TextFeaturizer ------------------------------------------


@pytest.mark.parametrize("collapse", [True, False])
def test_ensemble_by_key_matches_jax(collapse):
    rng = np.random.default_rng(6)
    cols = {"k": list(rng.choice(["a", "b", "c"], 20)),
            "k2": rng.integers(0, 2, 20), "s": rng.normal(size=20),
            "v": rng.normal(size=(20, 3))}
    p, j = both(cols)
    kw = dict(keys=["k", "k2"], cols=["s", "v"], collapse_group=collapse)
    assert_same_dataset(
        port_cls("ensemble", "EnsembleByKey")(**kw).transform(p),
        jax_cls("ensemble", "EnsembleByKey")(**kw).transform(j))


@pytest.mark.parametrize("kw", [
    {"num_features": 256},
    {"remove_stop_words": True, "use_ngram": True, "n_gram_length": 2,
     "use_idf": False, "num_features": 128},
    {"to_lowercase": False, "min_doc_freq": 2},
])
def test_text_featurizer_matches_jax(kw):
    text = ["The cat sat on the mat", "a dog in the park", "Cat sat",
            "dog ran park", None] * 3
    p, j = both({"text": text})
    pm = port_cls("text", "TextFeaturizer")(input_col="text",
                                            output_col="tf", **kw).fit(p)
    jm = jax_cls("text", "TextFeaturizer")(input_col="text",
                                           output_col="tf", **kw).fit(j)
    assert pm.slots == jm.slots
    assert_same_dataset(pm.transform(p), jm.transform(j))
    toks = {"toks": [["a", "b"], ["b", "c"]]}
    pt_ = port_cls("text", "TextFeaturizer")(input_col="toks",
                                             output_col="tf", use_idf=False)
    assert pt_.fit(Dataset(toks)).transform(Dataset(toks))["tf"].sum() == 4


def test_fitted_pipeline_round_trips_through_save(tmp_path, census):
    train, test = census
    model = port_cls("train_classifier", "TrainClassifier")(
        label_col="income", model="gbt", max_iter=3, device="cpu").fit(
        to_port(train))
    model.save(str(tmp_path / "tc"))
    loaded = PipelineStage.load(str(tmp_path / "tc"))
    a, b = model.transform(to_port(test)), loaded.transform(to_port(test))
    assert_same_column(a["scored_labels"], b["scored_labels"])
    np.testing.assert_array_equal(np.asarray(a["scores"]),
                                  np.asarray(b["scores"]))
    assert JaxStage.registry().keys() >= {"TrainClassifier"}
