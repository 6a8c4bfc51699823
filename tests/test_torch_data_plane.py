"""The port's host data plane against the JAX package's (mirroring
``tests/test_data_plane.py``, ``tests/test_ctf_native.py``,
``tests/test_zoo.py`` and the config cases of
``tests/test_core_params.py``): the port's own native builds, decoded
images, the readers, CTF, the sample digits, the model zoo and the
config namespace.

Every comparison is exact: the port's ``decode.cpp`` and ``ctf.cpp``
are copies of the JAX package's, built against the same libjpeg and
libpng, so decoded BGR arrays and parsed CTF arrays are bit-equal; the
readers, the zoo and the config are the same Python.
"""

from __future__ import annotations

import io
import os
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mmlspark_tpu.data import ctf as jax_ctf
from mmlspark_tpu.data import readers as jax_readers
from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu.models import zoo as jax_zoo
from mmlspark_tpu.ops import decode as jax_decode
from mmlspark_tpu_torch.core import config
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.data import Dataset, ctf, readers
from mmlspark_tpu_torch.models import zoo
from mmlspark_tpu_torch.ops import decode, native_build


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


def _write_image(path, h=8, w=6, color=(10, 20, 30), fmt="PNG"):
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[:] = color
    Image.fromarray(rgb).save(path, fmt)


@pytest.fixture
def image_dir(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    _write_image(d / "a.png", color=(255, 0, 0))
    _write_image(d / "b.jpg", fmt="JPEG", color=(0, 255, 0))
    sub = d / "sub"
    sub.mkdir()
    _write_image(sub / "c.png", color=(0, 0, 255))
    (d / "notes.txt").write_bytes(b"not an image")
    return str(d)


# -- the port's native builds --------------------------------------------------


def test_native_libraries_build_into_the_port_build_dir():
    """Both libraries build from the port's own sources into
    ``build/torch_native/`` — never the JAX package's ``.so`` files."""
    for name in ("decode", "ctf"):
        lib = native_build.load_native(name)
        assert lib is not None, native_build.build_error(name)
        path = native_build.library_path(name)
        assert path.is_file() and path.parent == native_build.BUILD_DIR
        assert native_build.SRC_DIR.parts[-2:] == ("ops", "native")
        assert "mmlspark_tpu_torch" in native_build.SRC_DIR.parts
    assert decode.native_available()
    assert native_build.load_native("decode").mml_decoder_version() == \
        b"mml-decode 1.0 (jpeg/png/bmp)"


def test_failed_build_reports_the_compiler_and_falls_back(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_CC", "no-such-compiler-xyz")
    config.reset()
    entry = native_build._LIBS["ctf"]
    monkeypatch.setattr(entry, "lib", None)
    monkeypatch.setattr(entry, "error", None)
    try:
        assert native_build.load_native("ctf") is None
        assert "no-such-compiler-xyz" in native_build.build_error("ctf")
        # the Python parser takes over
        path = str(tmp_path / "d.ctf")
        ctf.write_ctf(Dataset({"label": np.array([1.0]),
                               "features": np.array([[0.0, 2.0]])}), path)
        np.testing.assert_array_equal(
            ctf.read_ctf(path, feature_dim=2)["features"], [[0.0, 2.0]])
    finally:
        config.reset()


# -- decode --------------------------------------------------------------------


def _encoded(fmt, seed):
    rgb = np.random.default_rng(seed).integers(0, 256, (11, 7, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG", "BMP", "GIF"])
def test_decode_bit_equal_jax(fmt):
    """Native formats (PNG, JPEG, BMP) through the same libjpeg/libpng;
    GIF through the PIL fallback on both sides."""
    data = _encoded(fmt, seed=len(fmt))
    want = jax_decode.decode_image(data)
    got = decode.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (11, 7, 3)
    np.testing.assert_array_equal(got, want)


def test_decode_bgr_convention_and_bad_input():
    buf = io.BytesIO()
    rgb = np.zeros((4, 5, 3), np.uint8)
    rgb[..., 0] = 200  # pure red
    Image.fromarray(rgb).save(buf, "PNG")
    out = decode.decode_image(buf.getvalue())
    assert out[0, 0, 2] == 200 and out[0, 0, 0] == 0  # red lands in ch. 2
    for bad in (b"short", b"garbage bytes here", "not bytes"):
        assert decode.decode_image(bad) is None


def test_fixture_images_decode_bit_equal_jax():
    for path in sorted(FIXTURES.iterdir()):
        data = path.read_bytes()
        np.testing.assert_array_equal(decode.decode_image(data),
                                      jax_decode.decode_image(data))


def test_no_decoder_raises_naming_both(monkeypatch):
    """A deliberate difference: where neither the native decoder nor PIL
    can run, the port raises (JAX returns None, so a reader would drop
    every row) — and so does a reader."""
    monkeypatch.setattr(native_build, "load_native", lambda name: None)
    monkeypatch.setattr(decode, "_pil_image", lambda: None)
    data = _encoded("PNG", seed=1)
    assert jax_decode._decode_pil(data) is not None  # JAX still has PIL
    with pytest.raises(FriendlyError, match="native decoder.*PIL"):
        decode.decode_image(data)
    with pytest.raises(FriendlyError, match="no image decoder"):
        readers.read_images(str(FIXTURES))


# -- readers -------------------------------------------------------------------


def _same_rows(got, want):
    assert got.num_rows == want.num_rows
    for g, w in zip(got["image"], want["image"]):
        assert g.path == w.path
        np.testing.assert_array_equal(g.data, w.data)


def test_readers_match_jax(image_dir):
    bin_p = readers.read_binary_files(image_dir)
    bin_j = jax_readers.read_binary_files(image_dir)
    assert list(bin_p["path"]) == list(bin_j["path"])
    assert list(bin_p["bytes"]) == list(bin_j["bytes"])
    assert bin_p.num_rows == 4
    assert readers.read_binary_files(image_dir, recursive=False).num_rows == 3
    imgs = readers.read_images(image_dir)
    _same_rows(imgs, jax_readers.read_images(image_dir))
    assert imgs.num_rows == 3 and imgs.meta_of("image").image is not None
    assert readers.list_files(image_dir, pattern="*.png") == \
        jax_readers.list_files(image_dir, pattern="*.png")
    with pytest.raises(FriendlyError, match="no files"):
        readers.list_files(os.path.join(image_dir, "nothing*"))


def test_stream_images_chunks_match_jax(image_dir):
    got = list(readers.stream_images(image_dir, chunk_rows=2))
    want = list(jax_readers.stream_images(image_dir, chunk_rows=2))
    assert [c.num_rows for c in got] == [c.num_rows for c in want] == [2, 1]
    for g, w in zip(got, want):
        _same_rows(g, w)


def test_zip_traversal_and_seeded_subsample_match_jax(tmp_path,
                                                      monkeypatch):
    z = tmp_path / "z"
    z.mkdir()
    with zipfile.ZipFile(z / "bundle.zip", "w") as zf:
        zf.writestr("one.txt", b"alpha")
        zf.writestr("nested/two.txt", b"beta")
    ds = readers.read_binary_files(str(z))
    assert ds.num_rows == 2
    assert any(p.endswith("nested/two.txt") for p in ds["path"])
    d = tmp_path / "many"
    d.mkdir()
    for i in range(60):
        (d / f"f{i:03d}.bin").write_bytes(bytes([i]))
    # each file is sampled by a hash of its path: read the directory
    # through a relative path, so the sample does not depend on where the
    # temporary directory lies
    monkeypatch.chdir(tmp_path)
    for ratio, seed in ((0.5, 7), (0.5, 8), (0.25, 7)):
        got = readers.read_binary_files("many", sample_ratio=ratio,
                                        seed=seed)
        want = jax_readers.read_binary_files("many", sample_ratio=ratio,
                                             seed=seed)
        assert list(got["path"]) == list(want["path"])
        assert 5 < got.num_rows < 50


def test_csv_reader_matches_jax(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("x,y\n1,a\n2,b\n")
    ds = readers.read_csv(str(p))
    assert ds.num_rows == 2 and list(ds["y"]) == ["a", "b"]
    assert list(ds["x"]) == list(jax_readers.read_csv(str(p))["x"])


def test_transform_stream_matches_batch(image_dir):
    """The streaming leg: chunked stream -> fitted pipeline == one batch
    transform."""
    from mmlspark_tpu_torch.core.stage import Pipeline
    from mmlspark_tpu_torch.stages.image import ImageTransformer, UnrollImage

    pipe = Pipeline([
        ImageTransformer(output_col="scaled").resize(height=4, width=4),
        UnrollImage(input_col="scaled", output_col="features"),
    ])
    batch = readers.read_images(image_dir)
    fitted = pipe.fit(batch)
    streamed = list(fitted.transform_stream(
        readers.stream_images(image_dir, chunk_rows=2)))
    assert len(streamed) == 2
    got = np.concatenate([np.asarray(c["features"]) for c in streamed])
    np.testing.assert_array_equal(
        got, np.asarray(fitted.transform(batch)["features"]))


def test_sample_digits_match_jax():
    from mmlspark_tpu.data.sample_data import load_digit_images as jax_digits
    from mmlspark_tpu_torch.data.sample_data import load_digit_images

    got = load_digit_images((0, 1, 2, 3, 4), max_shift=4, seed=5)
    want = jax_digits((0, 1, 2, 3, 4), max_shift=4, seed=5)
    assert got[0].shape[1:] == (32, 32, 3) and got[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# -- CTF -----------------------------------------------------------------------


def _sample_ds(cls, n=50, d=16, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d))
    feats[rng.random((n, d)) < 0.6] = 0.0
    return cls({"label": rng.integers(0, 5, n).astype(np.float64),
                "features": feats})


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_ctf_native_bit_equal_jax(tmp_path, form):
    path = str(tmp_path / "data.ctf")
    ds = _sample_ds(Dataset)
    ctf.write_ctf(ds, path, features_form=form)
    jpath = str(tmp_path / "jax.ctf")
    jax_ctf.write_ctf(_sample_ds(JaxDataset), jpath, features_form=form)
    assert Path(path).read_bytes() == Path(jpath).read_bytes()
    dim = 16 if form == "sparse" else None
    native = ctf._read_ctf_native(path, dim, "label", "features")
    assert native is not None, "the port's native parser did not engage"
    want = jax_ctf._read_ctf_native(path, dim, "label", "features")
    for col in ("label", "features"):
        np.testing.assert_array_equal(native[col], want[col])
        np.testing.assert_array_equal(native[col], ds[col])


def test_ctf_python_fallback_matches_native(tmp_path, monkeypatch):
    ds = _sample_ds(Dataset, n=10, d=6, seed=4)
    path = str(tmp_path / "p.ctf")
    ctf.write_ctf(ds, path)
    native = ctf.read_ctf(path, feature_dim=6)
    monkeypatch.setattr(ctf, "_read_ctf_native", lambda *a, **k: None)
    python = ctf.read_ctf(path, feature_dim=6)
    for col in ("label", "features"):
        np.testing.assert_array_equal(native[col], python[col])
    empty = str(tmp_path / "e.ctf")
    open(empty, "w").close()
    assert ctf.read_ctf(empty, feature_dim=4).num_rows == 0


@pytest.mark.parametrize("text,kw,match", [
    ("|label 1 |wrongname 0:1\n", {"feature_dim": 4}, "missing"),
    ("|label 1 |features 1 2 3\n|label 1 |features 1 2\n", {}, "ragged"),
    ("|label 1 |features 1 2:3 4\n", {}, "malformed"),
    ("|label 1 |features 0:1\n", {}, "feature_dim"),
    ("|label 1 |features\t0:1\n", {"feature_dim": 3}, "missing"),
])
def test_ctf_errors_match_jax(tmp_path, text, kw, match):
    path = str(tmp_path / "bad.ctf")
    Path(path).write_text(text)
    with pytest.raises(FriendlyError, match=match):
        ctf.read_ctf(path, **kw)
    with pytest.raises(Exception, match=match):
        jax_ctf.read_ctf(path, **kw)


def test_ctf_lines_and_duplicates(tmp_path):
    ds = Dataset({"label": np.array([0.0, 1.0]),
                  "features": np.array([[0.0, 1.5, 0.0, 2.0],
                                        [3.0, 0.0, 0.0, 0.0]])})
    assert ctf.dataset_to_ctf_lines(ds)[0] == "|label 0 |features 1:1.5 3:2"
    (line,) = ctf.dataset_to_ctf_lines(
        Dataset({"label": np.array([1.0]),
                 "features": np.array([[1.0, 0.0, 2.5]])}),
        features_form="dense")
    assert line == "|label 1 |features 1 0 2.5"
    path = str(tmp_path / "dup.ctf")
    Path(path).write_text("|label 1 |features 0:1 |features 0:2\n")
    assert float(ctf.read_ctf(path, feature_dim=3)["features"][0][0]) == 2.0
    multi = Dataset({"label": np.array([[1.0, 0.0], [0.0, 1.0]]),
                     "features": np.array([[0.5, 0.0], [0.0, 2.0]])})
    ctf.write_ctf(multi, path, features_form="dense")
    assert ctf.read_ctf(path)["label"].shape == (2, 2)


# -- the model zoo -------------------------------------------------------------


@pytest.fixture(scope="module")
def remote_repo(tmp_path_factory):
    """A repo holding a TPUModel payload the JAX package saved and
    published, and a plain file payload."""
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model as jax_build_model
    from mmlspark_tpu.stages.dnn_model import TPUModel as JaxTPUModel

    root = str(tmp_path_factory.mktemp("remote_repo"))
    g = jax_build_model("mlp", num_outputs=2, hidden=(4,))
    v = g.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    stage = JaxTPUModel.from_graph(
        g, v, "mlp", model_config={"num_outputs": 2, "hidden": (4,)},
        input_col="features")
    payload = os.path.join(root, "_stage_payload")
    stage.save(payload)
    jax_zoo.publish_model(root, "TinyMLP", payload,
                          layer_names=tuple(g.layer_names),
                          model_type="classifier", dataset="toy")
    return root


def test_manifest_schema_and_hash_match_jax(remote_repo):
    repo = zoo.Repository("file://" + remote_repo)
    (schema,) = list(repo.list_schemas())
    assert schema.name == "TinyMLP" and schema.layer_names[-1] == "z"
    want = jax_zoo._sha256_path(os.path.join(remote_repo, schema.uri))
    assert zoo._sha256_path(os.path.join(remote_repo, schema.uri)) == want \
        == schema.hash
    with pytest.raises(FriendlyError, match="no model named"):
        repo.get_schema("NoSuchModel")
    s = zoo.ModelSchema(name="m", uri="m.bin", hash="ab", size=3,
                        layer_names=("a", "z"))
    assert zoo.ModelSchema.from_json(s.to_json()) == s
    assert jax_zoo.ModelSchema.from_json(s.to_json()).hash == "ab"


def test_jax_published_payload_downloads_and_scores(tmp_path, remote_repo):
    """sha256-verified download into a local repo (then a cache hit with
    no remote), loaded as the port's ``TPUModel``, scoring as JAX's."""
    from mmlspark_tpu.stages.dnn_model import TPUModel as JaxTPUModel
    from mmlspark_tpu_torch.stages import TPUModel

    local = str(tmp_path / "local")
    dl = zoo.ModelDownloader(local, remote="file://" + remote_repo)
    schema = dl.download_by_name("TinyMLP")
    path = dl.local_path(schema)
    assert os.path.isdir(path)
    assert zoo.ModelDownloader(local).download_by_name("TinyMLP").hash == \
        schema.hash
    model = TPUModel(input_col="features", model_name="mlp",
                     device="cpu").set_model_location(path)
    x = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    got = model.transform(Dataset({"features": x}))["scores"]
    want = JaxTPUModel(input_col="features", model_name="mlp"
                       ).set_model_location(path).transform(
        JaxDataset({"features": x}))["scores"]
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=3e-2)


def test_tampered_payload_is_refetched(tmp_path, remote_repo):
    dl = zoo.ModelDownloader(str(tmp_path / "local"), remote=remote_repo)
    schema = dl.download_by_name("TinyMLP")
    victim = next(p for p in Path(dl.local_path(schema)).rglob("*")
                  if p.is_file())
    with open(victim, "ab") as f:
        f.write(b"tampered")
    assert not dl._verify(schema)
    assert dl._verify(dl.download_by_name("TinyMLP"))


def test_torn_download_names_both_hashes_and_deletes(tmp_path):
    remote = str(tmp_path / "remote")
    payload = tmp_path / "weights.bin"
    payload.write_bytes(b"trained weights v1")
    schema = zoo.publish_model(remote, "Torn", str(payload))
    with open(os.path.join(remote, schema.uri), "ab") as f:
        f.write(b"...torn mid-transfer")
    dl = zoo.ModelDownloader(str(tmp_path / "local"), remote=remote)
    with pytest.raises(FriendlyError) as ei:
        dl.download_by_name("Torn")
    actual = zoo._sha256_path(os.path.join(remote, schema.uri))
    assert schema.hash in str(ei.value) and actual in str(ei.value)
    assert not os.path.exists(dl.local_path(schema))
    assert not os.path.exists(os.path.join(str(tmp_path / "local"),
                                           "Torn.meta"))


class _FlakyRepository(zoo.Repository):
    def __init__(self, root, fail_times):
        super().__init__(root)
        self.fails_left = fail_times
        self.payload_reads = 0

    def _read(self, rel):
        if rel.endswith(".bin"):
            self.payload_reads += 1
            if self.fails_left > 0:
                self.fails_left -= 1
                raise OSError("injected transient read failure")
        return super()._read(rel)


def test_retries_then_surfaces_the_last_error(tmp_path):
    remote = str(tmp_path / "remote")
    payload = tmp_path / "weights.bin"
    payload.write_bytes(b"trained weights v1")
    schema = zoo.publish_model(remote, "Retry", str(payload))
    repo = _FlakyRepository(remote, fail_times=2)
    dl = zoo.ModelDownloader(str(tmp_path / "a"), remote=repo)
    assert dl.download_by_name("Retry").hash == schema.hash
    assert repo.payload_reads == 3
    repo = _FlakyRepository(remote, fail_times=100)
    dl = zoo.ModelDownloader(str(tmp_path / "b"), remote=repo,
                             retry_limit=2)
    with pytest.raises(OSError, match="injected transient"):
        dl.download_by_name("Retry")
    assert repo.payload_reads == 3
    with pytest.raises(FriendlyError, match="retry_limit"):
        zoo.ModelDownloader(str(tmp_path / "c"), retry_limit=-1)


def test_committed_digits_backbone_through_file_uri(tmp_path):
    """``ResNet20_Digits04`` fetched from the committed repo through a
    ``file://`` URI, sha256-verified, loads as the port's ``TPUModel``."""
    from mmlspark_tpu_torch.core.stage import PipelineStage
    from mmlspark_tpu_torch.stages import TPUModel

    dl = zoo.ModelDownloader(str(tmp_path), remote=f"file://{ZOO}")
    schema = dl.download_by_name("ResNet20_Digits04")
    assert schema.layer_names[-2:] == ("pool", "z")
    assert schema.extra["test_accuracy"] > 0.9
    stage = PipelineStage.load(dl.local_path(schema))
    assert isinstance(stage, TPUModel) and stage.model_name == \
        "resnet20_cifar10"


# -- the config namespace ------------------------------------------------------


def test_config_defaults_and_env_override(monkeypatch):
    config.reset()
    try:
        assert config.get("native_cc") == "c++"
        assert config.get("native_build") is True
        monkeypatch.setenv("MMLSPARK_TPU_NATIVE_BUILD", "false")
        monkeypatch.setenv("MMLSPARK_TPU_NATIVE_CC", "g++-12")
        config.reset()
        assert config.get("native_build") is False
        assert config.get("native_cc") == "g++-12"
    finally:
        config.reset()


def test_config_file_layer_and_unknown_keys(tmp_path, monkeypatch):
    import json

    path = tmp_path / "conf.json"
    path.write_text(json.dumps({"log_level": "DEBUG"}))
    monkeypatch.setenv("MMLSPARK_TPU_CONFIG", str(path))
    config.reset()
    try:
        assert config.get("log_level") == "DEBUG"
        info = config.explain()
        assert info["log_level"]["value"] == "DEBUG"
        assert "doc" in info["cache_dir"]
        with pytest.raises(FriendlyError):
            config.get("nope")
        path.write_text(json.dumps({"not_a_key": 1}))
        config.reset()
        with pytest.raises(FriendlyError, match="unknown config key"):
            config.get("log_level")
    finally:
        monkeypatch.delenv("MMLSPARK_TPU_CONFIG")
        config.reset()


def test_default_downloader_reads_the_config(tmp_path, monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("MMLSPARK_TPU_MODEL_REPO", str(ZOO))
    config.reset()
    try:
        dl = zoo.default_downloader()
        assert dl.local_repo == str(tmp_path / "cache" / "models")
        assert dl.remote.root == str(ZOO)
    finally:
        config.reset()
