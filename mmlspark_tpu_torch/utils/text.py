"""Shared tokenization + feature hashing — the port's copy of
``mmlspark_tpu/utils/text.py``, byte for byte in what it computes, so
that hashed slots land where the JAX package puts them.

One implementation used by both the featurizers' fit and transform paths
(Featurize's hashed text columns and TextFeaturizer) — fit-time and
transform-time tokenization MUST agree or learned slot alignment silently
diverges. Hashing is ``crc32 % num_features``: process-stable (Python's
``hash`` is salted) and cheap.
"""

from __future__ import annotations

import re
import zlib
from typing import Any

#: compact english stopword list (Spark StopWordsRemover default subset)
STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)

DEFAULT_PATTERN = r"\W+"


def tokenize(value: Any, config: dict | None = None) -> list[str]:
    """value -> token list. ``config`` keys (all optional): use_tokenizer,
    tokenizer_pattern, to_lowercase, remove_stop_words, use_ngram,
    n_gram_length. Pre-tokenized input (list/tuple/array) passes through
    the post-processing steps only."""
    cfg = config or {}
    if value is None:
        return []
    if isinstance(value, float) and value != value:  # NaN in a real CSV's
        return []  # string column (pandas encodes missing cells this way)
    if isinstance(value, (list, tuple)) or (
        hasattr(value, "dtype") and getattr(value, "ndim", 0) == 1
    ):
        toks = [str(t) for t in value]
    else:
        if not isinstance(value, str):
            value = str(value)  # mixed object column: featurize, not crash
        if cfg.get("use_tokenizer", True):
            v = value.lower() if cfg.get("to_lowercase", True) else value
            toks = [
                t
                for t in re.split(
                    cfg.get("tokenizer_pattern", DEFAULT_PATTERN), v
                )
                if t
            ]
        else:
            toks = [value]
    if cfg.get("remove_stop_words"):
        toks = [t for t in toks if t.lower() not in STOP_WORDS]
    if cfg.get("use_ngram"):
        n = cfg.get("n_gram_length", 2)
        toks = [" ".join(toks[i : i + n]) for i in range(len(toks) - n + 1)]
    return toks


def hash_token(token: str, num_features: int) -> int:
    return zlib.crc32(token.encode("utf-8")) % num_features
