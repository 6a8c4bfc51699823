"""Data: the columnar ``Dataset`` minimum and the fixed-shape batch feed."""

from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import MASK_COL, batch_iterator, pad_to

__all__ = ["MASK_COL", "Dataset", "batch_iterator", "pad_to"]
