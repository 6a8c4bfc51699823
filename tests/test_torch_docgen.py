"""The port's API docs generator (``mmlspark_tpu_torch/tools/docgen.py``)
against the JAX package's (``tools/docgen.py``): the cases of
``tests/test_docgen_profiling.py`` over the port, then the same pages
and param tables from both registries (name, default, domain), with the
``device`` rows the port's stages declare as the only difference, and
``docgen`` through the port's launcher."""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path

import pytest
import torch

from mmlspark_tpu_torch.__main__ import main
from mmlspark_tpu_torch.tools import docgen

REPO = Path(__file__).resolve().parents[1]
#: the stages to which the port adds a ``device`` param (the card unless
#: the caller asks for the CPU), the one param the JAX stages lack
DEVICE_STAGES = 15


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_docgen():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_docgen", REPO / "tools" / "docgen.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_docgen_emits_rst_for_every_stage_module(tmp_path):
    paths = docgen.generate(str(tmp_path))
    names = {os.path.basename(p) for p in paths}
    assert "index.rst" in names and "models.rst" in names
    for expected in ("train_classifier.rst", "prep.rst", "image.rst",
                     "dnn_model.rst"):
        assert expected in names, names
    text = (tmp_path / "train_classifier.rst").read_text()
    assert "TrainClassifier" in text
    assert "label_col" in text and "learner" in text.lower()
    mtext = (tmp_path / "models.rst").read_text()
    assert "resnet20_cifar10" in mtext and "transformer_lm" in mtext
    itext = (tmp_path / "index.rst").read_text()
    assert "train_classifier" in itext


def test_docgen_param_table_shape():
    from mmlspark_tpu_torch.stages.train_classifier import TrainClassifier

    rows = docgen._param_table(TrainClassifier)
    assert any("label_col" in r for r in rows)
    assert any("=" * 5 in r for r in rows)  # rst table rules


def test_docgen_html_rendering(tmp_path):
    rst_dir = str(tmp_path / "api")
    html_dir = str(tmp_path / "html")
    docgen.generate(rst_dir)
    written = docgen.render_html(rst_dir, html_dir)
    assert len(written) > 10
    with open(os.path.join(html_dir, "dnn_learner.html")) as f:
        page = f.read()
    assert "<table><tr><th>param</th>" in page
    assert "batch_size" in page and "<h2>DNNLearner</h2>" in page
    with open(os.path.join(html_dir, "index.html")) as f:
        index = f.read()
    assert "<a href='dnn_learner.html'>" in index


def _tables(page: str) -> dict:
    """{class name: [(param, default, domain), ...]} of one generated
    page: each class section's simple-format rst table, cut at the
    columns its border line gives."""
    lines = page.splitlines()
    out, current, i = {}, None, 0
    while i < len(lines):
        line = lines[i]
        nxt = lines[i + 1] if i + 1 < len(lines) else ""
        if nxt and set(nxt) == {"-"} and len(nxt) == len(line):
            current, i = line, i + 2
            out[current] = []
            continue
        if current and line and set(line) <= {"=", " "} and " " in line:
            cols, start = [], 0
            for seg in line.split():
                begin = line.index(seg, start)
                cols.append((begin, begin + len(seg)))
                start = begin + len(seg)
            j = i + 3  # border, header, border, then the rows
            while j < len(lines) and not set(lines[j]) <= {"=", " "}:
                row = lines[j]
                out[current].append(tuple(
                    row[a:b].strip() for a, b in cols[:3]))
                j += 1
            i = j + 1
            continue
        i += 1
    return out


def _own_stages(monkeypatch, stage_cls, package: str) -> None:
    """The stage registry read as the package's own classes: test files
    that ran earlier in this process register classes of their own."""
    everything = stage_cls.registry
    monkeypatch.setattr(stage_cls, "registry", classmethod(
        lambda cls: {name: c for name, c in everything().items()
                     if c.__module__.startswith(package + ".")}))


def test_port_pages_and_param_tables_equal_the_jax_docgens(tmp_path,
                                                           monkeypatch):
    from mmlspark_tpu_torch.core.stage import PipelineStage

    from mmlspark_tpu.core.stage import PipelineStage as JaxPipelineStage

    _own_stages(monkeypatch, PipelineStage, "mmlspark_tpu_torch")
    _own_stages(monkeypatch, JaxPipelineStage, "mmlspark_tpu")
    jax_paths = _jax_docgen().generate(str(tmp_path / "jax"))
    port_paths = docgen.generate(str(tmp_path / "port"))
    jax_pages = {os.path.basename(p) for p in jax_paths}
    assert jax_pages == {os.path.basename(p) for p in port_paths}
    device_rows = 0
    for page in sorted(jax_pages - {"index.rst", "models.rst"}):
        want = _tables((tmp_path / "jax" / page).read_text())
        got = _tables((tmp_path / "port" / page).read_text())
        assert got.keys() == want.keys(), page
        for cls, rows in want.items():
            extra = [r for r in got[cls] if r not in rows]
            assert [r for r in got[cls] if r not in extra] == rows, (page,
                                                                     cls)
            # the port's only addition: its declared device param
            assert [r[0] for r in extra] in ([], ["device"]), (cls, extra)
            device_rows += len(extra)
    assert device_rows == DEVICE_STAGES

    def models(root):
        text = (root / "models.rst").read_text()
        return [ln for ln in text.splitlines() if ln.startswith("``")]

    assert models(tmp_path / "port") == models(tmp_path / "jax")
    index = (tmp_path / "port" / "index.rst").read_text()
    assert index == (tmp_path / "jax" / "index.rst").read_text()


def test_docgen_through_the_launcher(tmp_path, capsys):
    assert main(["docgen", str(tmp_path / "api")]) == 0
    assert "rst +" in capsys.readouterr().out
    assert len(list((tmp_path / "api").glob("*.rst"))) > 10
    assert (tmp_path / "html" / "index.html").is_file()
    # by default under build/, which is not committed: the JAX package's
    # docs/api and docs/html are never written
    default = Path(docgen.DEFAULT_OUT)
    assert default.parent.parent == REPO / "build"
    assert not str(default).startswith(str(REPO / "docs"))
