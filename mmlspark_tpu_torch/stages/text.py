"""TextFeaturizer — configurable text featurization pipeline.

Reference: text-featurizer/src/main/scala/TextFeaturizer.scala:180-405:
RegexTokenizer -> StopWordsRemover -> NGram -> HashingTF -> IDF, each stage
optional, tokenization auto-detected from the input type. Tokenization +
hashing live in :mod:`mmlspark_tpu_torch.utils.text` (shared with Featurize so
fit/transform paths can never diverge).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param, positive
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.utils.text import DEFAULT_PATTERN, hash_token, tokenize

DEFAULT_NUM_FEATURES = 1 << 18


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol):
    use_tokenizer = Param("split strings into tokens", True, ptype=bool)
    tokenizer_pattern = Param("regex split pattern", DEFAULT_PATTERN, ptype=str)
    to_lowercase = Param("lowercase before tokenizing", True, ptype=bool)
    remove_stop_words = Param("drop english stop words", False, ptype=bool)
    use_ngram = Param("emit n-grams instead of unigrams", False, ptype=bool)
    n_gram_length = Param("n-gram order", 2, ptype=int, validator=positive)
    num_features = Param(
        "hashing-TF space", DEFAULT_NUM_FEATURES, ptype=int, validator=positive
    )
    use_idf = Param("apply inverse-document-frequency weighting", True,
                    ptype=bool)
    min_doc_freq = Param("min docs a slot must appear in for IDF", 1,
                         ptype=int)

    def _tokenizer_config(self) -> dict:
        return {
            "use_tokenizer": self.use_tokenizer,
            "tokenizer_pattern": self.tokenizer_pattern,
            "to_lowercase": self.to_lowercase,
            "remove_stop_words": self.remove_stop_words,
            "use_ngram": self.use_ngram,
            "n_gram_length": self.n_gram_length,
        }

    def _fit(self, dataset: Dataset) -> "TextFeaturizerModel":
        dataset.require(self.input_col)
        nf = self.num_features
        cfg = self._tokenizer_config()
        # document frequency per used hash slot
        df_counts: dict[int, int] = {}
        for v in dataset[self.input_col]:
            slots = {hash_token(t, nf) for t in tokenize(v, cfg)}
            for s in slots:
                df_counts[s] = df_counts.get(s, 0) + 1
        slots = sorted(
            s for s, c in df_counts.items() if c >= self.min_doc_freq
        )
        n_docs = dataset.num_rows
        if self.use_idf:
            idf = np.array(
                [np.log((n_docs + 1.0) / (df_counts[s] + 1.0)) for s in slots]
            )
        else:
            idf = np.ones(len(slots))
        return TextFeaturizerModel(
            input_col=self.input_col,
            output_col=self.output_col,
            slots=list(slots),
            idf=idf,
            num_features=nf,
            tokenizer_config=cfg,
        )


class TextFeaturizerModel(Model, HasInputCol, HasOutputCol):
    slots = Param("selected hash slots", default=list)
    idf = Param("per-slot idf weights")
    num_features = Param("hash space", DEFAULT_NUM_FEATURES, ptype=int)
    tokenizer_config = Param("tokenizer settings", default=dict)

    def _transform(self, dataset: Dataset) -> Dataset:
        dataset.require(self.input_col)
        pos = {s: j for j, s in enumerate(self.slots)}
        nf = self.num_features
        cfg = self.tokenizer_config
        idf = np.asarray(self.idf, dtype=np.float64)
        out = np.zeros((dataset.num_rows, len(self.slots)))
        for i, v in enumerate(dataset[self.input_col]):
            for t in tokenize(v, cfg):
                j = pos.get(hash_token(t, nf))
                if j is not None:
                    out[i, j] += 1.0
        out *= idf
        return dataset.with_column(self.output_col, out)
