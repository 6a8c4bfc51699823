"""Data: the columnar ``Dataset``, the fixed-shape batch feed, the file
readers (``readers``: binary files, images, CSV/parquet), CTF read/write
(``ctf``) and the offline sample digits (``sample_data``)."""

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
