"""The port's image workflows (``mmlspark_tpu_torch/examples/e302``,
``e303``, ``e305``: notebooks 302, 303 and 305; e301 is
``tests/test_torch_examples_cnn.py``) on the CPU, each run through the
port's harness (``python -m mmlspark_tpu_torch --cpu-mesh 1 run
<script>``, one process, one intra-op thread; the three start
together and overlap): it passes within the JAX
example's own floors, and its ``OK`` line has exactly the keys of the
JAX example's under ``examples/`` (read with ``ast``). Every value of
e302's line equals the JAX example's ``main()`` run in-process beside
it (the image ops are held equal to JAX's elsewhere). e303's and e305's
classifiers train from the port's own ``torch.Generator`` draws, so
they are held to the JAX floors, not to JAX's numbers."""

from __future__ import annotations

import contextlib
import io
import os
import runpy
import signal

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.examples import harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = os.path.join(REPO, "examples")
#: this module's examples and their rank processes (None: the harness's)
EXAMPLES = {"e302": None, "e303": None, "e305": None}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module (the JAX run is in-process; the
    port's examples run in their own one-thread processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_example(prefix: str) -> str:
    (path,) = harness.discover([prefix], use_shard=False)
    return path


@pytest.fixture(scope="module")
def started():
    """The module's examples, started together at set-up, each in its own
    one-thread process, so that their runs overlap; each test waits for
    its own. A child no test waited for is stopped at tear-down."""
    children = {prefix: harness.start_example(port_example(prefix),
                                              cpu=True, ranks=ranks)
                for prefix, ranks in EXAMPLES.items()}
    yield children
    for child in children.values():
        if child.proc.poll() is None:
            os.killpg(child.proc.pid, signal.SIGKILL)
            child.proc.communicate()


def jax_example(prefix: str) -> str:
    (name,) = [n for n in os.listdir(JAX_EXAMPLES)
               if n.startswith(prefix) and n.endswith(".py")]
    return os.path.join(JAX_EXAMPLES, name)


def passed_with_jax_keys(prefix: str, run: harness.Run) -> dict:
    assert run.ok, f"{prefix} failed after {run.seconds:.1f}s:\n" \
        f"{run.output[-4000:]}"
    want, _ = harness.ok_fields(jax_example(prefix))
    assert list(run.result) == list(want)
    return run.result


def test_image_transforms_equal_the_jax_example(started):
    """Notebook 302: PNGs written by PIL, read back through the binary
    reader and decoder, an ``ImageTransformer`` chain and the augmenter:
    every value of the OK line equals the JAX example's."""
    module = runpy.run_path(jax_example("e302"), run_name="jax_e302")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module["main"]()
    want, _ = harness.parse_output(out.getvalue())
    got = passed_with_jax_keys("e302",
                               harness.finish_example(started["e302"]))
    assert got == want


def test_digits_need_no_scikit_learn(monkeypatch):
    """The port's ``load_digit_images`` reads its own copy of the digits
    table, so e303 and e305 run where scikit-learn is not installed (the
    GPU machine): with every ``sklearn`` import failing it returns e303's
    896 scans of digits 5-9 (100 labelled, 796 held out). That its images
    equal the JAX loader's is ``tests/test_torch_data_plane.py``'s
    check."""
    import sys

    from mmlspark_tpu_torch.data.sample_data import load_digit_images

    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    imgs, y = load_digit_images((5, 6, 7, 8, 9), max_shift=4, seed=9)
    assert imgs.shape == (896, 32, 32, 3) and imgs.dtype == np.uint8
    assert np.array_equal(np.unique(y), np.arange(5))
    full, labels = load_digit_images()
    assert full.shape[0] == 1797 and np.bincount(labels).min() >= 174
    assert not any(m.split(".")[0] == "sklearn" and mod is not None
                   for m, mod in sys.modules.items())


@pytest.mark.parametrize("prefix,key,baseline,lift", [
    ("e303", "transfer_accuracy", "raw_accuracy", 0.08),
    ("e305", "dnn_accuracy", "basic_accuracy", 0.15),
])
def test_zoo_featurizer_holds_the_jax_floors(started, prefix, key, baseline,
                                            lift):
    """Notebooks 303 and 305: the committed zoo's JAX-saved
    ``ResNet20_Digits04`` backbone downloaded through the port's
    ``ModelDownloader``, cut one layer from the top by
    ``ImageFeaturizer``, against raw pixels on the same real digit scans:
    the pretrained features clear 0.8 and beat the raw pixels by the JAX
    example's margin. The classifiers on top train from the port's own
    draws, so they are held to the JAX floors."""
    got = passed_with_jax_keys(
        prefix, harness.finish_example(started[prefix]))
    assert got[key] > 0.8
    assert got[key] >= got[baseline] + lift
    if prefix == "e303":
        assert got["backbone"] == "ResNet20_Digits04"
        assert got["backbone_test_accuracy"] > 0.9
    else:
        assert got["train_rows"] == 120
