"""Data: the columnar ``Dataset`` and the fixed-shape batch feed."""

from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import (
    MASK_COL,
    batch_iterator,
    bucket_by_length,
    pad_to,
    to_device,
)

__all__ = ["MASK_COL", "Dataset", "batch_iterator", "bucket_by_length",
           "pad_to", "to_device"]
