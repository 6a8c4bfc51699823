"""The port's ``Word2Vec`` (``mmlspark_tpu_torch/stages/word2vec.py``)
against the JAX package's on the CPU: the same vocabulary and the same
(center, context) training pairs fed to the trainer, the ``skipgram``
graph's flax weights bridged across with equal logits, and a port fit
whose embeddings place co-occurring words together. The JAX side's
trainer is replaced by a recorder (its pairs are what is compared; its
training is the JAX package's own tests' business)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mmlspark_tpu.train.trainer as jax_trainer
import mmlspark_tpu_torch.train.trainer as port_trainer
from mmlspark_tpu.data.dataset import Dataset as JaxDataset
from mmlspark_tpu.stages.word2vec import Word2Vec as JaxWord2Vec
from mmlspark_tpu.stages.word2vec import skipgram as jax_skipgram
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.models import build_model
from mmlspark_tpu_torch.models.bridge import load_flax_variables
from mmlspark_tpu_torch.stages.word2vec import Word2Vec

DOCS = (["The cat sat on the mat", "the dog sat on the log",
         "a cat and a dog", None, ["pre", "tokenized", "cat"]] * 8
        + ["rare words appear once"])
KW = dict(input_col="text", vector_size=8, window=2, min_count=2,
          epochs=2, batch_size=32, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its tensors are small, so one
    thread is faster and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Recorder:
    """Stands in for a trainer: records the pairs, returns seeded
    embeddings in the trainer's own variable layout."""

    calls: list = []

    def __init__(self, graph, config, device=None):
        self.graph, self.config = graph, config

    def train(self, x, y):
        _Recorder.calls.append((np.asarray(x), np.asarray(y),
                                self.config))
        v, d = self.graph.extra["vocab_size"], self.graph.extra["vector_size"]
        emb = np.random.default_rng(0).normal(size=(v, d)).astype(np.float32)
        if isinstance(self.graph.blocks[0][1], torch.nn.Module):
            return {"embed": {"embedding.weight": torch.from_numpy(emb)}}
        return {"embed": {"params": {"embedding": {"embedding": emb}}}}


def test_vocabulary_and_pairs_equal_the_jax_ones(monkeypatch):
    _Recorder.calls = []
    monkeypatch.setattr(jax_trainer, "SPMDTrainer", _Recorder)
    monkeypatch.setattr(port_trainer, "SPMDTrainer", _Recorder)
    ref = JaxWord2Vec(**KW).fit(JaxDataset({"text": DOCS}))
    got = Word2Vec(device="cpu", **KW).fit(Dataset({"text": DOCS}))
    assert got.vocabulary == ref.vocabulary
    assert "rare" not in got.vocabulary
    (jx, jy, jcfg), (px, py, pcfg) = _Recorder.calls
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
    assert px.dtype == np.int32 and len(px) > 100
    for k in ("epochs", "batch_size", "learning_rate", "optimizer", "loss",
              "seed"):
        assert getattr(pcfg, k) == getattr(jcfg, k), k
    # the same vectors give the same document means and synonyms
    np.testing.assert_array_equal(got.vectors, ref.vectors)
    docs = {"text": DOCS[:5]}
    np.testing.assert_allclose(
        np.asarray(got.transform(Dataset(docs))["features"]),
        np.asarray(ref.transform(JaxDataset(docs))["features"]),
        rtol=0, atol=1e-12)
    assert got.find_synonyms("cat", 3) == ref.find_synonyms("cat", 3)


def test_skipgram_weights_bridge_from_flax():
    import jax
    import jax.numpy as jnp

    vocab, dim = 12, 8
    ids = np.arange(vocab, dtype=np.int32)
    jg = jax_skipgram(vocab_size=vocab, vector_size=dim)
    flax_vars = jax.tree_util.tree_map(
        np.asarray, jg.init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    graph = build_model("skipgram", vocab_size=vocab, vector_size=dim)
    port = load_flax_variables(graph, flax_vars, device="cpu")
    np.testing.assert_array_equal(
        port["embed"]["embedding.weight"].numpy(),
        flax_vars["embed"]["params"]["embedding"]["embedding"])
    assert "z" in port and set(port["z"]) == {"context.weight"}
    want = np.asarray(jg.apply(flax_vars, jnp.asarray(ids)))
    got = graph.apply(port, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_port_fit_learns_co_occurrence_and_round_trips(tmp_path):
    docs = ["red apple green pear", "red apple ripe", "green pear ripe",
            "blue sky white cloud", "blue sky clear", "white cloud clear"]
    model = Word2Vec(input_col="text", vector_size=16, window=3,
                     min_count=1, epochs=40, batch_size=64,
                     learning_rate=0.05, device="cpu").fit(
        Dataset({"text": docs * 10}))
    fruit = {"red", "green", "pear", "ripe"}
    assert {w for w, _ in model.find_synonyms("apple", 3)} <= fruit
    assert {w for w, _ in model.find_synonyms("sky", 3)}.isdisjoint(fruit)
    model.save(str(tmp_path / "w2v"))
    back = PipelineStage.load(str(tmp_path / "w2v"))
    np.testing.assert_array_equal(back.vectors, model.vectors)
    with pytest.raises(Exception, match="not in vocabulary"):
        model.find_synonyms("zebra", 1)
