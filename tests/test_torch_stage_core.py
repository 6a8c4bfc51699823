"""The port's stage layer — params, the Dataset, stages, pipelines and
stage serialization — against the JAX package's.

The counterparts of ``tests/test_core_params.py`` (but its two
``core/config`` cases: the config namespace is not ported),
``tests/test_core_dataset.py`` and ``tests/test_core_stage.py`` (but the
TPU-platform probe), on the port's classes; plus the cross-framework
checks: the same seeded operations give the same rows on both Datasets,
stages without tensors round-trip between the packages both ways, and a
port ``Pipeline`` transforms identically after a save/load round trip.
Every comparison here is exact: no arithmetic differs between the sides.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.stage import PipelineStage as JaxStage
from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu.stages.dnn_learner import DNNLearner as JaxDNNLearner
from mmlspark_tpu_torch.core.exceptions import ParamError, SchemaError
from mmlspark_tpu_torch.core.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    positive,
)
from mmlspark_tpu_torch.core.schema import (
    CLASSIFICATION,
    LABEL_KIND,
    SCORED_LABELS_KIND,
    CategoricalMeta,
    ColumnMeta,
    find_label_column,
    find_scored_labels_column,
    fresh_column_name,
    get_score_value_kind,
    tag_column,
)
from mmlspark_tpu_torch.core.serialize import (
    FORMAT_VERSION,
    load_dataset,
    save_dataset,
)
from mmlspark_tpu_torch.core.stage import (
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    PipelineStage,
    Transformer,
)
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.stages import DNNLearner


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def basic_dataset():
    """The port's copy of the conftest fixture (reference
    TestBase.makeBasicDF)."""
    return Dataset(
        {
            "numbers": np.array([0, 1, 2, 3], dtype=np.int64),
            "doubles": np.array([0.0, 1.5, 3.0, 4.5]),
            "words": ["guitars", "drums", "bass", "keys"],
            "flags": np.array([True, False, True, False]),
        }
    )


# -- tests/test_core_params.py ---------------------------------------------------


class _Toy(Transformer, HasInputCol, HasOutputCol):
    n = Param("a positive int", 3, ptype=int, validator=positive)
    mode = Param("string-enum domain", "mean",
                 domain=("mean", "median", "custom"))

    def _transform(self, ds):
        return ds


def test_defaults_and_set():
    t = _Toy()
    assert t.n == 3
    assert t.input_col == "input"
    t.set(n=5, input_col="x")
    assert t.n == 5 and t.input_col == "x"
    assert t.is_set("n") and not t.is_set("mode")
    assert t.set(n=7) is t  # chainable


@pytest.mark.parametrize("bad", [dict(n="seven"), dict(n=True), dict(n=0),
                                 dict(n=2.7), dict(mode="bogus"),
                                 dict(nope=1)])
def test_invalid_values_rejected(bad):
    """Type, bool-not-int, validator, fractional float, domain and
    unknown-name checks."""
    with pytest.raises(ParamError):
        _Toy().set(**bad)


def test_numeric_coercion():
    t = _Toy().set(n=4.0)
    assert t.n == 4 and isinstance(t.n, int)
    assert _Toy().set(n=np.int64(5)).n == 5
    assert _Toy().set(mode="median").mode == "median"


def test_params_table_copy_and_explain():
    assert {"n", "mode", "input_col", "output_col"} <= set(_Toy.params())
    t = _Toy().set(n=9)
    c = t.copy()
    assert c.n == 9 and not c.is_set("mode") and c.uid != t.uid
    c2 = t.copy(n=11)
    assert c2.n == 11 and t.n == 9
    text = _Toy().explain_params()
    assert "median" in text and "positive int" in text
    a, b = _Toy(), _Toy()
    assert a.uid != b.uid and a.uid.startswith("_Toy")


def test_param_table_matches_jax_dnn_learner():
    """The port's DNNLearner declares the JAX learner's params, defaults
    and domains, plus its own ``device``."""
    jax_params, port_params = JaxDNNLearner.params(), DNNLearner.params()
    assert set(port_params) == set(jax_params) | {"device"}
    for name, p in jax_params.items():
        q = port_params[name]
        assert (q.get_default(), q.domain) == (p.get_default(), p.domain), \
            name


# -- tests/test_core_dataset.py --------------------------------------------------


def test_basic_shape(basic_dataset):
    assert basic_dataset.num_rows == 4 and len(basic_dataset) == 4
    assert set(basic_dataset.columns) == {"numbers", "doubles", "words",
                                          "flags"}
    assert basic_dataset["numbers"].dtype == np.int64
    assert basic_dataset["words"].dtype == object
    with pytest.raises(SchemaError):
        Dataset({"a": [1, 2], "b": [1, 2, 3]})


def test_select_drop_rename(basic_dataset):
    sel = basic_dataset.select("numbers", "words")
    assert sel.columns == ["numbers", "words"]
    assert "flags" not in basic_dataset.drop("flags")
    ren = basic_dataset.rename({"numbers": "ints"})
    assert "ints" in ren and "numbers" not in ren
    assert "numbers" in basic_dataset  # immutability
    with pytest.raises(SchemaError):
        basic_dataset.rename({"numbers": "doubles"})


def test_with_column_and_meta(basic_dataset):
    meta = ColumnMeta(categorical=CategoricalMeta(("a", "b")))
    ds = basic_dataset.with_column("cat", ["a", "b", "a", "b"], meta)
    assert ds.meta_of("cat").categorical.num_levels == 2
    with pytest.raises(SchemaError):
        basic_dataset.with_column("bad", [1, 2])
    tagged = basic_dataset.with_meta(
        "numbers", ColumnMeta(categorical=CategoricalMeta(("a", "b"))))
    assert tagged.with_column("numbers", np.zeros(4)).meta_of(
        "numbers").is_empty()
    kept = tagged.with_column("numbers", np.zeros(4),
                              tagged.meta_of("numbers"))
    assert kept.meta_of("numbers").categorical is not None


def test_filter_take_gather_concat(basic_dataset):
    f = basic_dataset.filter(basic_dataset["numbers"] > 1)
    assert f.num_rows == 2 and list(f["words"]) == ["bass", "keys"]
    assert basic_dataset.take(2).num_rows == 2
    g = basic_dataset.gather(np.array([3, 0]))
    assert list(g["words"]) == ["keys", "guitars"]
    d1 = Dataset({"v": np.ones((2, 3)), "s": ["x", "y"]})
    d2 = Dataset({"v": np.zeros((1, 3)), "s": ["z"]})
    cat = Dataset.concat([d1, d2])
    assert cat.num_rows == 3 and cat["v"].shape == (3, 3)
    with pytest.raises(SchemaError):
        Dataset.concat([d1, d1.rename({"v": "w"})])
    ragged = Dataset({"seq": [np.arange(2), np.arange(5), np.arange(1)]})
    assert ragged["seq"].dtype == object and len(ragged["seq"][1]) == 5


def test_pandas_round_trip(basic_dataset):
    pytest.importorskip("pandas")
    back = Dataset.from_pandas(basic_dataset.to_pandas())
    assert back.num_rows == 4
    assert list(back["words"]) == list(basic_dataset["words"])


def test_map_column_and_partitions(basic_dataset):
    ds = basic_dataset.map_column("words", str.upper, output="loud")
    assert list(ds["loud"]) == ["GUITARS", "DRUMS", "BASS", "KEYS"]
    assert basic_dataset.with_partitions(4).num_partitions == 4
    assert basic_dataset.num_partitions == 1
    rows = list(basic_dataset.iter_rows())
    assert rows[2]["words"] == "bass" and rows[2]["numbers"] == 2
    assert basic_dataset.schema() == {"numbers": "int64",
                                      "doubles": "float64",
                                      "words": "object<str>",
                                      "flags": "bool"}


def test_score_column_protocol(basic_dataset):
    ds = basic_dataset.with_meta(
        "numbers", tag_column(None, LABEL_KIND, "m1", CLASSIFICATION)
    ).with_meta("flags", tag_column(None, SCORED_LABELS_KIND, "m1",
                                    CLASSIFICATION))
    assert find_label_column(ds) == "numbers"
    assert find_scored_labels_column(ds, "m1") == "flags"
    assert get_score_value_kind(ds, "m1") == CLASSIFICATION
    assert find_label_column(ds, "other") is None
    assert fresh_column_name(basic_dataset, "new") == "new"
    assert fresh_column_name(basic_dataset, "numbers") == "numbers_1"


def test_bucket_by_length_and_to_device():
    """The feed's bucketing (zero-padded to each bucket, one subset a
    bucket, too long raises) and placement (CPU tensors sharing the
    rows' values), as the JAX feed buckets the same column."""
    from mmlspark_tpu.data.feed import bucket_by_length as jax_bucket
    from mmlspark_tpu_torch.data import bucket_by_length, to_device

    seqs = [np.arange(n) for n in (2, 5, 1, 7, 3)]
    got = bucket_by_length(Dataset({"seq": seqs}), "seq", [4, 8])
    want = jax_bucket(JaxDataset({"seq": seqs}), "seq", [4, 8])
    assert [b for b, _ in got] == [b for b, _ in want] == [4, 8]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g["seq"], w["seq"])
    with pytest.raises(SchemaError, match="exceeds"):
        bucket_by_length(Dataset({"seq": seqs}), "seq", [4])
    batch = {"x": np.arange(6.0).reshape(2, 3), "m": np.array([True, False])}
    dev = to_device(batch, torch.device("cpu"))
    assert dev["x"].dtype == torch.float64 and dev["m"].dtype == torch.bool
    np.testing.assert_array_equal(dev["x"].numpy(), batch["x"])


@pytest.mark.parametrize("op", [
    lambda d: d.sample(fraction=0.5, seed=7),
    lambda d: d.sample(n=9, seed=3, replace=True),
    lambda d: d.shuffle(seed=11),
    lambda d: d.random_split(0.3, seed=5)[0],
    lambda d: d.random_split(0.3, seed=5)[1],
    lambda d: d.filter(d["x"] % 3 == 0).take(4),
], ids=["sample", "sample_replace", "shuffle", "split_first",
        "split_second", "filter_take"])
def test_seeded_row_operations_match_jax(op):
    """The same seeded operation picks the same rows on both Datasets."""
    cols = {"x": np.arange(20), "v": np.random.default_rng(0).normal(
        size=(20, 3))}
    got, want = op(Dataset(cols)), op(JaxDataset(cols))
    assert got.columns == want.columns
    for c in got.columns:
        np.testing.assert_array_equal(got[c], want[c])


# -- tests/test_core_stage.py ----------------------------------------------------


class AddConstant(Transformer):
    input_col = Param("input column", "numbers", ptype=str)
    output_col = Param("output column", "plus", ptype=str)
    amount = Param("amount to add", 1.0, ptype=float)

    def _transform(self, ds):
        return ds.with_column(self.output_col,
                              ds[self.input_col] + self.amount)


class MeanCenter(Estimator):
    input_col = Param("input column", "numbers", ptype=str)
    output_col = Param("output column", "centered", ptype=str)

    def _fit(self, ds):
        return MeanCenterModel(
            input_col=self.input_col,
            output_col=self.output_col,
            mean=float(np.mean(ds[self.input_col])),
        )


class MeanCenterModel(Model):
    input_col = Param("input column", "numbers", ptype=str)
    output_col = Param("output column", "centered", ptype=str)
    mean = Param("learned mean", 0.0, ptype=float)

    def _transform(self, ds):
        return ds.with_column(self.output_col, ds[self.input_col] - self.mean)


def test_transformer_estimator_pipeline(basic_dataset):
    out = AddConstant(amount=2.0).transform(basic_dataset)
    assert list(out["plus"]) == [2, 3, 4, 5]
    model = MeanCenter().fit(basic_dataset)
    assert abs(float(np.mean(model.transform(basic_dataset)["centered"]))) \
        < 1e-12
    pm = Pipeline([AddConstant(amount=10.0),
                   MeanCenter(input_col="plus")]).fit(basic_dataset)
    assert isinstance(pm, PipelineModel)
    out = pm.transform(basic_dataset)
    assert "plus" in out and "centered" in out
    p = Pipeline()
    p.stages.append(AddConstant(amount=4.0))  # mutable default kept
    assert list(p.fit(basic_dataset).transform(basic_dataset)["plus"]) == \
        [4, 5, 6, 7]


def test_registry_is_the_ports_own():
    reg = PipelineStage.registry()
    for name in ("AddConstant", "MeanCenter", "MeanCenterModel", "Pipeline",
                 "TPUModel", "DNNLearner"):
        assert name in reg
    assert "Transformer" not in reg and "Estimator" not in reg
    assert all(c.__module__.startswith(("mmlspark_tpu_torch.", __name__))
               for c in reg.values())
    assert all(not c.__module__.startswith("mmlspark_tpu_torch.")
               for c in JaxStage.registry().values())


def test_pipeline_skips_transform_after_last_estimator(basic_dataset):
    calls = []

    class Spy(Transformer):
        def _transform(self, ds):
            calls.append("t")
            return ds

    class SpyEst(Estimator):
        def _fit(self, ds):
            return Spy()

    Pipeline([SpyEst(), Spy()]).fit(basic_dataset)
    assert calls == []


def test_stage_and_pipeline_round_trip(tmp_path, basic_dataset):
    """A fitted port Pipeline transforms identically after save/load."""
    stage = AddConstant(amount=3.5)
    stage.save(str(tmp_path / "s"))
    loaded = PipelineStage.load(str(tmp_path / "s"))
    assert type(loaded) is AddConstant and loaded.amount == 3.5
    model = Pipeline([AddConstant(amount=1.0),
                      MeanCenter(input_col="plus")]).fit(basic_dataset)
    model.save(str(tmp_path / "pm"))
    back = PipelineStage.load(str(tmp_path / "pm"))
    assert [type(s) for s in back.stages] == [AddConstant, MeanCenterModel]
    a, b = model.transform(basic_dataset), back.transform(basic_dataset)
    for col in a.columns:
        np.testing.assert_array_equal(a[col], b[col])


def test_array_and_tensor_params_round_trip(tmp_path):
    class Weighted(Transformer):
        weights = Param("weight matrix")

        def _transform(self, ds):
            return ds

    w = np.arange(12.0).reshape(3, 4)
    t = torch.randn(3, 4).to(torch.bfloat16)
    stage = Weighted().set(weights={"layer": {"kernel": w, "bias": np.zeros(4)},
                                    "t": {"w": t, "i": torch.arange(5)}})
    stage.save(str(tmp_path / "w"))
    loaded = PipelineStage.load(str(tmp_path / "w"))
    np.testing.assert_array_equal(loaded.weights["layer"]["kernel"], w)
    got = loaded.weights["t"]["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    assert torch.equal(loaded.weights["t"]["i"], torch.arange(5))


def test_dataset_round_trip(tmp_path, basic_dataset):
    ds = basic_dataset.with_meta(
        "words",
        ColumnMeta(categorical=CategoricalMeta(("a", "b"), has_null=True)),
    ).with_partitions(3)
    save_dataset(ds, str(tmp_path / "d"))
    back = load_dataset(str(tmp_path / "d"))
    assert back.num_rows == 4 and back.num_partitions == 3
    assert list(back["words"]) == list(ds["words"])
    assert back.meta_of("words").categorical.has_null
    np.testing.assert_array_equal(back["doubles"], ds["doubles"])
    ds2 = Dataset({"file": np.arange(3), "x": np.ones(3)}).with_meta(
        "x", ColumnMeta(extra={"centers": np.zeros(3)}))
    save_dataset(ds2, str(tmp_path / "d2"))
    back2 = load_dataset(str(tmp_path / "d2"))
    np.testing.assert_array_equal(back2["file"], np.arange(3))
    np.testing.assert_array_equal(back2.meta_of("x").extra["centers"],
                                  np.zeros(3))


# -- across the packages ---------------------------------------------------------


def test_stages_without_tensors_cross_both_ways(tmp_path):
    """A DNNLearner (params only) saved by either package loads in the
    other with the same params; the format version is the JAX one."""
    from mmlspark_tpu.core import serialize as jax_serialize

    assert FORMAT_VERSION == jax_serialize.FORMAT_VERSION
    kw = dict(model_name="resnet20_cifar10", model_config={"width": 8},
              epochs=3, batch_size=16, optimizer="momentum",
              features_col="image", checkpoint_every=2)
    JaxDNNLearner(**kw).save(str(tmp_path / "jax"))
    port = PipelineStage.load(str(tmp_path / "jax"))
    assert type(port) is DNNLearner
    assert port.param_values() == kw
    DNNLearner(**kw).save(str(tmp_path / "port"))
    back = JaxStage.load(str(tmp_path / "port"))
    assert type(back) is JaxDNNLearner and back.param_values() == kw
    # a pipeline of them, nested stage directories and all
    from mmlspark_tpu.core.stage import Pipeline as JaxPipeline

    JaxPipeline([JaxDNNLearner(**kw)]).save(str(tmp_path / "jp"))
    pipe = PipelineStage.load(str(tmp_path / "jp"))
    assert type(pipe) is Pipeline and type(pipe.stages[0]) is DNNLearner
    assert pipe.stages[0].param_values() == kw
