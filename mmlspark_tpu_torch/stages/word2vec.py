"""Word2Vec — skip-gram embeddings, notebook-202 capability; the port of
``mmlspark_tpu/stages/word2vec.py``, trained by the port's trainer on the
card by default (``device``).

Reference: notebooks/samples/202 - Amazon Book Reviews - Word2Vec.ipynb
drives Spark MLlib's ``Word2Vec`` (vector size / window / min count) and
classifies over the per-document averaged embeddings. The
re-design trains the skip-gram objective with full-softmax cross entropy
(an embedding lookup and a vocabulary projection per step) through the
same :class:`~mmlspark_tpu_torch.train.trainer.SPMDTrainer` the DNN
learners use, on one device. The graph's blocks keep flax's names
(``embed/params/embedding/embedding``, ``z/params/context/kernel``), so
the weight bridge carries a JAX-trained skip-gram across; the vocabulary
and the (center, context) pairs are host Python, built exactly as the
JAX package builds them.

The fitted model mirrors Spark's ``Word2VecModel``: ``transform`` writes
per-document mean vectors, ``find_synonyms`` ranks by cosine similarity.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    positive,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.registry import register_model
from mmlspark_tpu_torch.models.transformer import Dense
from mmlspark_tpu_torch.utils.text import tokenize


class _Embed(nn.Module):
    def __init__(self, vocab_size: int, vector_size: int):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, vector_size)

    def forward(self, ids):
        return self.embedding(ids.long())


class _Project(nn.Module):
    def __init__(self, vocab_size: int, vector_size: int):
        super().__init__()
        self.context = Dense(vector_size, vocab_size, bias=False)

    def forward(self, v):
        return self.context(v, torch.float32)


@register_model("skipgram")
def skipgram(vocab_size: int = 1024, vector_size: int = 100) -> NamedGraph:
    """Embedding + tied-dim vocab projection; logits over context words
    (float32 throughout, as flax's modules here)."""
    with torch.device("meta"):
        blocks = [("embed", _Embed(vocab_size, vector_size)),
                  (FINAL_NODE, _Project(vocab_size, vector_size))]
    return NamedGraph(
        name="skipgram",
        blocks=blocks,
        extra={"vocab_size": vocab_size, "vector_size": vector_size},
    )


class Word2Vec(Estimator, HasInputCol, HasOutputCol):
    """Skip-gram word embeddings over a text (or pre-tokenized) column."""

    vector_size = Param("embedding dimension", 100, ptype=int,
                        validator=positive)
    window = Param("context window radius", 5, ptype=int, validator=positive)
    min_count = Param("minimum token frequency kept in the vocab", 5,
                      ptype=int, validator=positive)
    epochs = Param("training epochs over the pair set", 1, ptype=int,
                   validator=positive)
    batch_size = Param("global batch size", 512, ptype=int,
                       validator=positive)
    learning_rate = Param("learning rate", 0.025, ptype=float)
    max_vocab = Param("vocabulary cap (most frequent kept)", 1 << 16,
                      ptype=int)
    seed = Param("rng seed", 0, ptype=int)
    device = Param(
        "the device the embeddings train on: None = the card (cuda; "
        "raises without a GPU), or 'cpu'/'cuda'/'cuda:N'", ptype=str,
    )

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("output_col", "features")
        super().__init__(**kwargs)

    def _docs(self, dataset: Dataset) -> list[list[str]]:
        dataset.require(self.input_col)
        docs = []
        for v in dataset[self.input_col]:
            if v is None:
                docs.append([])
            elif isinstance(v, str):
                docs.append(tokenize(v))
            else:
                docs.append([str(t) for t in v])
        return docs

    def _fit(self, dataset: Dataset) -> "Word2VecModel":
        from mmlspark_tpu_torch.train.trainer import SPMDTrainer, TrainConfig

        docs = self._docs(dataset)
        counts: dict[str, int] = {}
        for doc in docs:
            for t in doc:
                counts[t] = counts.get(t, 0) + 1
        vocab = sorted(
            (t for t, c in counts.items() if c >= self.min_count),
            key=lambda t: (-counts[t], t),
        )[: self.max_vocab]
        if not vocab:
            raise FriendlyError(
                f"no token reaches min_count={self.min_count}", self.uid
            )
        index = {t: i for i, t in enumerate(vocab)}

        centers: list[int] = []
        contexts: list[int] = []
        w = self.window
        for doc in docs:
            ids = [index[t] for t in doc if t in index]
            for i, c in enumerate(ids):
                for j in range(max(0, i - w), min(len(ids), i + w + 1)):
                    if j != i:
                        centers.append(c)
                        contexts.append(ids[j])
        if not centers:
            raise FriendlyError(
                "no skip-gram pairs (documents too short?)", self.uid
            )
        graph = skipgram(vocab_size=len(vocab),
                         vector_size=self.vector_size)
        trainer = SPMDTrainer(
            graph,
            TrainConfig(
                epochs=self.epochs,
                batch_size=min(self.batch_size, len(centers)),
                learning_rate=self.learning_rate,
                optimizer="adam",
                loss="softmax_xent",
                seed=self.seed,
            ),
            device=self.device,
        )
        variables = trainer.train(
            np.asarray(centers, np.int32), np.asarray(contexts, np.int32)
        )
        emb = variables["embed"]["embedding.weight"].detach().cpu() \
            .numpy().astype(np.float32)
        return Word2VecModel(
            vocabulary=list(vocab),
            vectors=emb,
            input_col=self.input_col,
            output_col=self.output_col,
        )


class Word2VecModel(Model, HasInputCol, HasOutputCol):
    vocabulary = Param("tokens, row-aligned with vectors", default=list)
    vectors = Param("embedding matrix [V, D]")

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("output_col", "features")
        super().__init__(**kwargs)

    def _doc_tokens(self, v) -> list[str]:
        if v is None:
            return []
        if isinstance(v, str):
            return tokenize(v)
        return [str(t) for t in v]

    def _transform(self, dataset: Dataset) -> Dataset:
        dataset.require(self.input_col)
        vecs = np.asarray(self.vectors, np.float32)
        index = {t: i for i, t in enumerate(self.vocabulary)}
        out = np.zeros((dataset.num_rows, vecs.shape[1]), np.float64)
        for r, v in enumerate(dataset[self.input_col]):
            ids = [index[t] for t in self._doc_tokens(v) if t in index]
            if ids:
                # Spark Word2VecModel.transform: average of word vectors
                out[r] = vecs[ids].mean(axis=0)
        return dataset.with_column(self.output_col, out)

    def find_synonyms(self, word: str, num: int) -> list[tuple[str, float]]:
        """Cosine-ranked neighbors (Spark ``findSynonyms``)."""
        if word not in self.vocabulary:
            raise FriendlyError(f"'{word}' not in vocabulary", self.uid)
        vecs = np.asarray(self.vectors, np.float64)
        norms = np.linalg.norm(vecs, axis=1) + 1e-12
        q = vecs[self.vocabulary.index(word)]
        sims = vecs @ q / (norms * (np.linalg.norm(q) + 1e-12))
        order = np.argsort(-sims)
        out = []
        for i in order:
            if self.vocabulary[i] != word:
                out.append((self.vocabulary[i], float(sims[i])))
            if len(out) == num:
                break
        return out
