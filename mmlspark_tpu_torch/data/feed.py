"""Host batch feed — the port of ``mmlspark_tpu/data/feed.py``'s batching.

Every batch has exactly ``batch_size`` rows: the tail is padded by
repeating its last row and a boolean validity mask (``MASK_COL``) marks
the real ones, so the loss can weight padding 0. A shuffle seed gives
``np.random.default_rng(seed).permutation(n)``, the JAX package's order,
so the port and the JAX trainer see identical batches. Moving a batch to
the card is the caller's ``torch.from_numpy(...).to(device)``.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from mmlspark_tpu_torch.core.exceptions import SchemaError
from mmlspark_tpu_torch.data.dataset import Dataset

MASK_COL = "__mask__"


def stack_column(dataset: Dataset, name: str) -> np.ndarray:
    """A column as one dense ndarray: typed columns pass through; object
    columns of equal-shape arrays are stacked."""
    arr = dataset.column(name)
    if arr.dtype != object:
        return arr
    if len(arr) == 0:
        return np.zeros((0,))
    first = np.asarray(arr[0])
    shapes = {np.asarray(v).shape for v in arr}
    if len(shapes) != 1:
        raise SchemaError(
            f"column '{name}' is ragged ({sorted(shapes)}); bucket or pad "
            "first"
        )
    return np.stack([np.asarray(v) for v in arr]).astype(first.dtype,
                                                         copy=False)


def pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to length n by repeating the last row (the mask marks
    validity)."""
    if len(arr) == n:
        return arr
    if len(arr) == 0:
        raise SchemaError("cannot pad an empty batch")
    pad = np.repeat(arr[-1:], n - len(arr), axis=0)
    return np.concatenate([arr, pad], axis=0)


def batch_iterator(
    dataset: Dataset,
    columns: Sequence[str],
    batch_size: int,
    *,
    drop_remainder: bool = False,
    shuffle_seed: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield dicts of fixed-shape arrays plus a boolean ``MASK_COL``."""
    dataset.require(*columns)
    n = dataset.num_rows
    order = np.arange(n)
    if shuffle_seed is not None:
        order = np.random.default_rng(shuffle_seed).permutation(n)
    stacked = {c: stack_column(dataset, c) for c in columns}
    for start in range(0, n, batch_size):
        idx = order[start: start + batch_size]
        if len(idx) < batch_size and drop_remainder:
            return
        mask = np.zeros(batch_size, dtype=bool)
        mask[: len(idx)] = True
        yield {
            **{c: pad_to(stacked[c][idx], batch_size) for c in columns},
            MASK_COL: mask,
        }
