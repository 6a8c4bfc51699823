"""The port's text and sequence workflows (``mmlspark_tpu_torch/
examples/e103``, ``e201``, ``e202``, ``e304``: notebooks 103, 201, 202
and 304) on the CPU, each run through the port's harness (``python -m
mmlspark_tpu_torch --cpu-mesh 1 run <script>``, one process, one
intra-op thread; the four start together and overlap): it passes within
the JAX example's own floors, and its ``OK`` line has exactly the keys
of the JAX example's under ``examples/``, read from the JAX source with
``ast``. Every learner here
is an NN trained from the port's own initial weights (e103's
hand-written logistic regression and its sweep, the ``DNNLearner``, the
logistic candidate, the skip-gram embeddings, the BiLSTM tagger), so the
examples are held to the JAX floors, not to JAX's numbers; the floors
are asserted inside each example and again here."""

from __future__ import annotations

import os
import signal

import pytest

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.examples import harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: this module's examples and their rank processes (None: the harness's)
EXAMPLES = {"e103": None, "e201": None, "e202": None, "e304": None}


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


def jax_keys(prefix: str) -> list:
    (name,) = [n for n in os.listdir(os.path.join(REPO, "examples"))
               if n.startswith(prefix) and n.endswith(".py")]
    want, _ = harness.ok_fields(os.path.join(REPO, "examples", name))
    return list(want)


def run_port(started: dict, prefix: str) -> dict:
    run = harness.finish_example(started[prefix])
    assert run.ok, f"{prefix} failed after {run.seconds:.1f}s:\n" \
        f"{run.output[-4000:]}"
    assert list(run.result) == jax_keys(prefix)
    return run.result


def test_before_and_after_holds_the_jax_floors(started):
    """Notebook 103: the hand-written PyTorch path (an autograd step,
    ``torch.optim.Adam`` at 1e-1) and the framework's ``TrainClassifier``
    sweep reach AUC > 0.85 each and agree within 0.08 — the JAX floors,
    asserted inside the example. Both halves train from the port's own
    initial weights, so they are held to the floors, not to JAX's
    numbers."""
    got = run_port(started, "e103")
    assert got["sweep"] == 4
    assert got["auc_before"] > 0.85 and got["auc_after"] > 0.85
    assert abs(got["auc_before"] - got["auc_after"]) < 0.08


def test_text_featurizer_holds_the_jax_floor(started):
    """Notebook 201: ``TextFeaturizer`` (tokenize, stop words, hashing,
    TF-IDF) then a ``DNNLearner``: held-out accuracy > 0.85."""
    got = run_port(started, "e201")
    assert got["accuracy"] > 0.85
    assert got["feature_dim"] > 0


def test_word2vec_holds_the_jax_floor(started):
    """Notebook 202: skip-gram ``Word2Vec``, averaged document vectors,
    ``TrainClassifier`` x2 ranked by ``FindBestModel``: accuracy > 0.9
    and three synonyms of "great"."""
    got = run_port(started, "e202")
    assert got["accuracy"] > 0.9
    assert len(got["synonyms_of_great"]) == 3


def test_entity_extraction_holds_the_jax_floors(started):
    """Notebook 304: the BiLSTM tagger trained, exported to ONNX,
    imported as an opaque graph and served through ``TPUModel``: token
    accuracy and entity recall > 0.9, and the first sentence's
    entities extracted."""
    got = run_port(started, "e304")
    assert got["token_accuracy"] > 0.9 and got["entity_recall"] > 0.9
    assert set(got["example_entities"]) <= {"DRUG", "DOSE"}


def test_examples_run_on_the_card_unless_told_otherwise(monkeypatch):
    """Without ``--cpu-mesh`` an example's first device use resolves to
    the card, and with no GPU the entry point raises naming it: no
    example falls back to the CPU on its own."""
    import sys

    import torch

    from mmlspark_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    with pytest.raises(FriendlyError, match="no CUDA device"):
        main(["run", port_example("e201")])
