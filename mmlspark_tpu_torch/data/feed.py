"""Host -> device batch feed — the port of ``mmlspark_tpu/data/feed.py``.

- **Fixed shapes**: every batch has exactly ``batch_size`` rows: the tail
  is padded by repeating its last row and a boolean validity mask
  (``MASK_COL``) marks the real ones, so the loss can weight padding 0
  and a captured program sees one shape. The padded rows enter a
  BatchNorm's batch statistics in train mode, as in the JAX package. A
  shuffle seed gives ``np.random.default_rng(seed).permutation(n)``, the
  JAX package's order, so the port and the JAX trainer see identical
  batches.
- **Bucketing** (:func:`bucket_by_length`) pads ragged sequences to a few
  lengths, one program per bucket.
- **Placement** (:func:`to_device`): a batch goes to the device through
  :func:`~mmlspark_tpu_torch.core.env.host_to_device` (pinned memory, a
  copy that does not wait for the stream) in place of
  ``jax.device_put``. Over a mesh, :func:`data_sharding` names the
  calling rank's rows of a batch split over the ``data`` axis (the JAX
  ``NamedSharding(mesh, P("data"))``) and ``to_device(batch, device,
  sharding)`` places only those: every rank of the SPMD program holds
  the global batch on the host and its own rows on its device. The
  trainer's mesh mode gives each rank its rows of a batch the same way
  (``train/distributed.py``); the serving engine's mesh mode splits its
  slot rows over ``data`` (``serve/cache_pool.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import host_to_device
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
    """Pad axis 0 to length n by repeating the last row (keeps values in
    distribution for BatchNorm's batch statistics; the mask marks
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


def bucket_by_length(
    dataset: Dataset,
    column: str,
    buckets: Sequence[int],
) -> list[tuple[int, Dataset]]:
    """Split by ragged-sequence length into (bucket_len, subset) groups;
    each subset pads its column to bucket_len with zeros — one program per
    bucket."""
    arr = dataset.column(column)
    lengths = np.asarray([len(np.asarray(v)) for v in arr])
    buckets = sorted(buckets)
    if not buckets:
        raise SchemaError("bucket_by_length needs at least one bucket size")
    if lengths.size and lengths.max() > buckets[-1]:
        raise SchemaError(
            f"sequence length {int(lengths.max())} exceeds largest bucket "
            f"{buckets[-1]}"
        )
    out = []
    assigned = np.zeros(len(arr), dtype=bool)
    for b in buckets:
        mask = (~assigned) & (lengths <= b)
        if not mask.any():
            continue
        assigned |= mask
        subset = dataset.filter(mask)
        padded = []
        for v in subset.column(column):
            v = np.asarray(v)
            pad_width = [(0, b - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
            padded.append(np.pad(v, pad_width))
        out.append((b, subset.with_column(column, np.stack(padded))))
    return out


@dataclass(frozen=True)
class RowShard:
    """The calling rank's part of a batch split over one mesh axis: the
    ``index``-th of ``size`` equal, contiguous row blocks."""

    index: int
    size: int

    def take(self, arr: np.ndarray) -> np.ndarray:
        n = arr.shape[0]
        if n % self.size:
            raise SchemaError(
                f"a batch of {n} rows does not split evenly over a mesh "
                f"axis of {self.size} ranks; pad it to a multiple "
                "(iter_batches pads the tail)"
            )
        per = n // self.size
        return arr[self.index * per:(self.index + 1) * per]


def data_sharding(mesh, axis: str = "data") -> RowShard:
    """The calling rank's rows of a batch split over ``axis`` of
    ``mesh`` (a DeviceMesh or a ``parallel.mesh.MeshPlace``); the whole
    batch when the mesh has no such axis."""
    from mmlspark_tpu_torch.parallel.mesh import MeshAxis, MeshPlace

    if isinstance(mesh, MeshPlace):
        mesh = mesh.mesh
    if axis not in mesh.mesh_dim_names:
        return RowShard(0, 1)
    ax = MeshAxis(mesh, axis)
    return RowShard(ax.index, ax.size)


def to_device(batch: dict[str, np.ndarray], device: torch.device,
              sharding: RowShard | None = None) -> dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device``, each through
    :func:`~mmlspark_tpu_torch.core.env.host_to_device` (to the card from
    pinned memory, without waiting for the stream); with a ``sharding``
    (:func:`data_sharding`), only the calling rank's rows."""
    if sharding is not None:
        batch = {k: sharding.take(np.asarray(v)) for k, v in batch.items()}
    return {k: host_to_device(np.ascontiguousarray(v), device)
            for k, v in batch.items()}
