"""The port's image path against the JAX package's (mirroring
``tests/test_image_pipeline.py``): the host image ops, the batched
resize, ``ImageTransformer``, ``UnrollImage``, ``ImageSetAugmenter`` and
``ImageFeaturizer`` over ResNet-20, including the committed
``ResNet20_Digits04`` zoo payload on the committed fixture images.

Tolerances:
- the numpy ops (crop, colour format, blur, gaussian, threshold, flip):
  bit-equal — the same numpy code on both sides;
- bilinear resize: within one uint8 level on at most 0.5% of the pixels
  (``F.interpolate`` with antialiasing against ``jax.image.resize``: the
  same filter summed in another order, so a value at a rounding step may
  land one level apart); the integer-factor upsamples and the equal size
  below bit-equal;
- features through ``ImageFeaturizer`` in float32 compute (both graphs'
  blocks set to f32), on images whose resize is exact: 1e-4 of the
  largest feature magnitude (the same convolutions summed in other
  orders).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.core.schema import ImageRow as JaxImageRow
from mmlspark_tpu.core.stage import PipelineStage as JaxPipelineStage
from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.ops import image_ops as jax_image_ops
from mmlspark_tpu.stages import dnn_model as jax_dnn_model
from mmlspark_tpu.stages import image as jax_image
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.schema import ImageRow
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.ops import image_ops
from mmlspark_tpu_torch.stages import dnn_model, image
from mmlspark_tpu_torch.stages.image import (
    ImageFeaturizer,
    ImageSetAugmenter,
    ImageTransformer,
    UnrollImage,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "images"
ZOO = REPO / "models" / "zoo_repo"
FEATURE_REL_TOL = 1e-4
RESIZE_FLIP_SHARE = 5e-3


def _img(h=8, w=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _rows(cls, n=3, h=8, w=6, sizes=None):
    sizes = sizes or [(h, w)] * n
    return [cls(path=f"img{i}", data=_img(*hw, seed=i))
            for i, hw in enumerate(sizes)]


def _both_ds(n=3, h=8, w=6, sizes=None):
    """The same images as a JAX dataset and as a port dataset."""
    return (JaxDataset({"image": _rows(JaxImageRow, n, h, w, sizes),
                        "idx": np.arange(len(sizes or range(n)))}),
            Dataset({"image": _rows(ImageRow, n, h, w, sizes),
                     "idx": np.arange(len(sizes or range(n)))}))


# -- op semantics --------------------------------------------------------------


OPS = {
    "crop": ("crop", (1, 2, 4, 3)),
    "gray": ("color_format", ("gray",)),
    "bgr": ("color_format", ("bgr",)),
    "blur": ("blur", (3, 3)),
    "gaussian": ("gaussian_kernel", (5, 1.2)),
    "gaussian_default_sigma": ("gaussian_kernel", (3, 0.0)),
    "binary": ("threshold", (99, 255, "binary")),
    "binary_inv": ("threshold", (99, 255, "binary_inv")),
    "trunc": ("threshold", (99, 255, "trunc")),
    "tozero": ("threshold", (99, 255, "tozero")),
    "tozero_inv": ("threshold", (99, 255, "tozero_inv")),
    "flip_v": ("flip", (0,)),
    "flip_h": ("flip", (1,)),
    "flip_both": ("flip", (-1,)),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_host_ops_bit_equal_jax(case):
    name, args = OPS[case]
    img = _img(9, 7, seed=len(case))
    want = getattr(jax_image_ops, name)(img, *args)
    got = getattr(image_ops, name)(img, *args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_op_errors_match_jax():
    img = _img(8, 6)
    for lib in (image_ops, jax_image_ops):
        with pytest.raises(Exception, match="outside image"):
            lib.crop(img, 4, 4, 10, 10)
        with pytest.raises(Exception, match="color format"):
            lib.color_format(img, "hsv")
        with pytest.raises(Exception, match="threshold type"):
            lib.threshold(img, 1, 2, "nope")


@pytest.mark.parametrize("src,dst", [
    ((48, 64), (32, 32)), ((256, 256), (224, 224)), ((30, 50), (17, 90)),
    ((16, 16), (32, 32)), ((32, 32), (224, 224)), ((8, 6), (8, 6)),
])
def test_resize_within_one_level_of_jax(src, dst):
    """Host resize: within one uint8 level of JAX's on at most 0.5% of
    the pixels; these upsamples and the equal size bit-equal."""
    img = _img(*src, seed=src[0])
    want = jax_image_ops.resize(img, *dst)
    got = image_ops.resize(img, *dst)
    assert got.shape == (*dst, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= RESIZE_FLIP_SHARE
    if dst[0] >= src[0] and dst[1] >= src[1]:
        np.testing.assert_array_equal(got, want)


def test_batched_resize_scale_matches_jax_program():
    """The featurizer's batched resize + round + scale (torch on the
    batch's device) against JAX's jitted ``_resize_scale_fn``."""
    batch = np.stack([_img(40, 56, seed=i) for i in range(4)])
    want = np.asarray(jax_image._resize_scale_fn(32, 32, 1 / 255)(
        batch.astype(np.float32)))
    got = image.resize_scale(torch.from_numpy(batch), 32, 32, 1 / 255)
    assert got.dtype == torch.float32 and got.shape == (4, 32, 32, 3)
    diff = np.abs(got.numpy() - want) * 255
    assert diff.max() <= 1 + 1e-3
    assert (diff > 0.5).mean() <= RESIZE_FLIP_SHARE
    norm = image_ops.batch_normalize_nhwc(torch.from_numpy(batch), mean=0.5,
                                          std=0.25)
    jnorm = jax_image_ops.batch_normalize_nhwc(jnp.asarray(batch), mean=0.5,
                                               std=0.25)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), rtol=1e-6)


# -- ImageTransformer, UnrollImage, ImageSetAugmenter -------------------------


def test_transformer_pipeline_matches_jax_and_round_trips(tmp_path):
    """The op pipeline bit-equal to JAX's without a resize, and within
    the resize tolerance with one."""
    jds, ds = _both_ds(n=3, h=40, w=30)
    exact = lambda t: t.crop(1, 1, 32, 24).flip(1).blur(3, 3)  # noqa: E731
    want = exact(jax_image.ImageTransformer()).transform(jds)
    for w, g in zip(want["image"], exact(ImageTransformer()).transform(
            ds)["image"]):
        np.testing.assert_array_equal(g.data, w.data)
    ops = lambda t: exact(t.resize(50, 44))  # noqa: E731
    want = ops(jax_image.ImageTransformer()).transform(jds)
    t = ops(ImageTransformer())
    out = t.transform(ds)
    for w, g in zip(want["image"], out["image"]):
        assert g.data.shape == (32, 24, 3)
        diff = np.abs(g.data.astype(np.int32) - w.data.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= RESIZE_FLIP_SHARE
    t.save(str(tmp_path / "it"))
    loaded = PipelineStage.load(str(tmp_path / "it"))
    np.testing.assert_array_equal(loaded.transform(ds)["image"][0].data,
                                  out["image"][0].data)
    # a stage the JAX package saved loads in the port
    ops(jax_image.ImageTransformer()).save(str(tmp_path / "jit"))
    from_jax = PipelineStage.load(str(tmp_path / "jit"))
    np.testing.assert_array_equal(from_jax.transform(ds)["image"][1].data,
                                  out["image"][1].data)


def test_transformer_accepts_binary_and_drops_bad():
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_img(5, 5)[:, :, ::-1]).save(buf, "PNG")
    ds = Dataset({"image": [buf.getvalue(), b"garbage bytes here"],
                  "tag": ["good", "bad"]})
    out = ImageTransformer().resize(4, 4).transform(ds)
    assert out.num_rows == 1 and out["tag"][0] == "good"


def test_op_dsl_errors_surface():
    ds = Dataset({"image": _rows(ImageRow, 1)})
    for stages in ([{"op": "sharpen"}],
                   [{"op": "crop", "x": 0, "hight": 5, "width": 5}],
                   [{"op": "crop", "x": 0}]):
        t = ImageTransformer()
        t.stages = stages
        with pytest.raises(FriendlyError):
            t.transform(ds)


def test_all_rows_failing_raises_and_one_bad_row_drops():
    ds = Dataset({"image": [ImageRow(path=str(i),
                                     data=np.zeros((8, 8, 3), np.uint8))
                            for i in range(3)]})
    boom = lambda img, *a: (_ for _ in ()).throw(  # noqa: E731
        RuntimeError("backend dead"))
    t = ImageTransformer(output_col="out").resize(4, 4)
    t._compile_ops = lambda: [(boom, [])]
    with pytest.raises(FriendlyError,
                       match="all 3 rows that reached the op pipeline"):
        t.transform(ds)
    t2 = ImageTransformer(output_col="out").resize(4, 4)
    real = t2._compile_ops()
    calls = {"n": 0}

    def flaky(img, *a):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("corrupt row")
        return real[0][0](img, *real[0][1])

    t2._compile_ops = lambda: [(flaky, [])]
    assert t2.transform(ds).num_rows == 2


def test_unroll_and_augmenter_match_jax():
    jds, ds = _both_ds(n=2, h=2, w=3)
    np.testing.assert_array_equal(
        UnrollImage().transform(ds)["unrolled"],
        np.asarray(jax_image.UnrollImage().transform(jds)["unrolled"]))
    with pytest.raises(FriendlyError, match="differ in size"):
        UnrollImage().transform(Dataset({"image": _rows(
            ImageRow, sizes=[(2, 2), (3, 3)])}))
    aug = ImageSetAugmenter(flip_left_right=True, flip_up_down=True)
    out = aug.transform(ds)
    want = jax_image.ImageSetAugmenter(flip_left_right=True,
                                       flip_up_down=True).transform(jds)
    assert out.num_rows == want.num_rows == 6
    for w, g in zip(want["image"], out["image"]):
        np.testing.assert_array_equal(g.data, w.data)


# -- ImageFeaturizer -----------------------------------------------------------


def _f32(build):
    """``build_model`` whose graphs compute in float32 (either side)."""
    def f32_build(name, **cfg):
        graph = build(name, **cfg)
        if hasattr(graph.blocks[0][1], "clone"):  # flax modules
            graph.blocks = [
                (n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype")
                 else m) for n, m in graph.blocks]
        else:
            for _, mod in graph.blocks:
                for m in mod.modules():
                    if hasattr(m, "dtype"):
                        m.dtype = torch.float32
        return graph

    return f32_build


@pytest.fixture
def f32_stages(monkeypatch):
    monkeypatch.setattr(jax_dnn_model, "build_model",
                        _f32(jax_dnn_model.build_model))
    monkeypatch.setattr(dnn_model, "build_model",
                        _f32(dnn_model.build_model))


@pytest.fixture(scope="module")
def resnet_weights():
    """Seeded flax variables of ``resnet20_cifar10(width=8)``."""
    g = jax_build_model("resnet20_cifar10", width=8)
    return jax.device_get(jax.jit(g.init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3))))


def _stages(weights, **kw):
    cfg = dict(model_name="resnet20_cifar10", model_config={"width": 8},
               input_col="image", output_col="scores")
    return (jax_dnn_model.TPUModel(**cfg).set(weights=weights),
            dnn_model.TPUModel(device="cpu", **cfg).set(weights=weights))


def _assert_features(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) / scale <= FEATURE_REL_TOL


@pytest.mark.parametrize("sizes", [None, [(16, 16), (32, 32), (8, 16)]],
                         ids=["uniform_upsample", "ragged_host_path"])
def test_featurizer_matches_jax(f32_stages, resnet_weights, sizes):
    """Uniform images (resized on the device path) and ragged ones (the
    host path), upsampled so the resize is exact: the cut ``pool``
    features and the full net's scores equal JAX's within 1e-4."""
    jds, ds = _both_ds(n=5, h=16, w=16, sizes=sizes)
    jm, pm = _stages(resnet_weights)
    for cut, width in ((1, 32), (0, 10)):
        want = jax_image.ImageFeaturizer(
            model=jm, cut_output_layers=cut, batch_size=2).transform(jds)
        feat = ImageFeaturizer(model=pm, cut_output_layers=cut, batch_size=2)
        got = feat.transform(ds)
        assert got["features"].shape == (len(ds["idx"]), width)
        assert list(got["idx"]) == list(want["idx"])
        assert sorted(got.columns) == sorted(want.columns)
        _assert_features(got["features"], want["features"])
        # a second call reuses the scorer: its weights and programs stay
        scorer = feat._scorer
        again = feat.transform(ds)
        assert feat._scorer is scorer
        np.testing.assert_array_equal(again["features"], got["features"])


def test_featurizer_cut_out_of_range(resnet_weights):
    _, pm = _stages(resnet_weights)
    with pytest.raises(FriendlyError, match="out of range"):
        ImageFeaturizer(model=pm, cut_output_layers=99).transform(
            Dataset({"image": _rows(ImageRow, 1)}))


def test_digits_backbone_featurizes_fixture_images_like_jax(f32_stages):
    """The committed ``ResNet20_Digits04`` (a JAX-saved ``TPUModel``) on the
    committed 32x32 fixture images, read and decoded by each package's
    own reader (decoded bytes bit-equal): the port's ``pool`` features
    equal the JAX stage's within 1e-4."""
    from mmlspark_tpu.data.readers import read_images as jax_read_images
    from mmlspark_tpu_torch.data.readers import read_images

    jds = jax_read_images(str(FIXTURES))
    ds = read_images(str(FIXTURES))
    assert ds.num_rows == jds.num_rows == 24
    for w, g in zip(jds["image"], ds["image"]):
        assert os.path.basename(g.path) == os.path.basename(w.path)
        np.testing.assert_array_equal(g.data, w.data)
    payload = str(ZOO / "resnet20_digits04")
    jm = JaxPipelineStage.load(payload)
    pm = PipelineStage.load(payload)
    assert isinstance(pm, dnn_model.TPUModel)
    pm.set(device="cpu")
    kw = dict(cut_output_layers=1, batch_size=8, scale=1 / 255)
    want = jax_image.ImageFeaturizer(model=jm, **kw).transform(jds)
    got = ImageFeaturizer(model=pm, **kw).transform(ds)
    assert got["features"].shape == (24, 64)
    _assert_features(got["features"], want["features"])
