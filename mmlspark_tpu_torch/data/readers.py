"""File readers: binary files, images, CSV/parquet tables — the port of
``mmlspark_tpu/data/readers.py`` (host code; the images go to the card
through ``stages/image.py`` and ``TPUModel``).

Re-expression of the reference IO layer (SURVEY.md §2.2):

- :func:`read_binary_files` mirrors ``BinaryFileFormat``
  (readers/src/main/scala/BinaryFileFormat.scala): whole-file records,
  recursive directory traversal, transparent zip iteration, per-file seeded
  subsampling.
- :func:`read_images` mirrors ``ImageFileFormat`` + ``ImageReader``
  (ImageFileFormat.scala:22-90, ImageReader.scala:15-99): decode each file
  into image rows; non-decodable files dropped (when no decoder can run
  at all, :func:`~mmlspark_tpu_torch.ops.decode.decode_image` raises
  instead of dropping every row).
- :func:`stream_binary_files` / :func:`stream_images` mirror the structured-
  streaming entry points (Readers.scala:30-48) as chunked generators.

Determinism: the per-file sample decision is seeded by
``crc32(path) ^ seed`` — the analog of the reference's
``filename.hashCode ^ seed`` (BinaryFileFormat.scala:75) — so re-partitioning
or re-listing never changes which files are kept. (Python's builtin ``hash``
is salted per process and would break this.)
"""

from __future__ import annotations

import fnmatch
import os
import zipfile
import zlib
from typing import Iterable, Iterator

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.schema import ColumnMeta, ImageMeta, ImageRow
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.ops.decode import decode_image

_log = get_logger("readers")

IMAGE_COL = "image"
PATH_COL = "path"
BYTES_COL = "bytes"


def _keep_file(path: str, sample_ratio: float, seed: int) -> bool:
    if sample_ratio >= 1.0:
        return True
    file_seed = zlib.crc32(path.encode("utf-8")) ^ (seed & 0xFFFFFFFF)
    return np.random.default_rng(file_seed).random() <= sample_ratio


def list_files(
    path: str, recursive: bool = True, pattern: str | None = None
) -> list[str]:
    """Expand a file/dir/glob path into a sorted file list (reference
    ``BinaryFileReader.recursePath`` + glob handling, BinaryFileReader.scala:
    13-60). Sorted for cross-host determinism."""
    import glob as _glob

    if os.path.isfile(path):
        files = [path]
    elif os.path.isdir(path):
        if recursive:
            files = [
                os.path.join(root, f)
                for root, _dirs, fs in os.walk(path)
                for f in fs
            ]
        else:
            files = [
                os.path.join(path, f)
                for f in os.listdir(path)
                if os.path.isfile(os.path.join(path, f))
            ]
    else:
        files = [f for f in _glob.glob(path, recursive=True) if os.path.isfile(f)]
        if not files:
            raise FriendlyError(f"no files found at '{path}'")
    if pattern:
        files = [f for f in files if fnmatch.fnmatch(os.path.basename(f), pattern)]
    return sorted(files)


def _iter_file_records(
    files: Iterable[str],
    sample_ratio: float,
    seed: int,
    inspect_zip: bool,
) -> Iterator[tuple[str, bytes]]:
    """(path, whole-file bytes) records with zip traversal + seeded sampling
    (reference BinaryRecordReader, BinaryFileFormat.scala:36-115; ZipIterator,
    core/env/.../StreamUtilities.scala:44-83)."""
    for path in files:
        if inspect_zip and zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as zf:
                for info in zf.infolist():
                    if info.is_dir():
                        continue
                    entry_path = f"{path}/{info.filename}"
                    if not _keep_file(entry_path, sample_ratio, seed):
                        continue
                    yield entry_path, zf.read(info)
        else:
            if not _keep_file(path, sample_ratio, seed):
                continue
            with open(path, "rb") as f:
                yield path, f.read()


def read_binary_files(
    path: str,
    recursive: bool = True,
    sample_ratio: float = 1.0,
    seed: int = 0,
    inspect_zip: bool = True,
    pattern: str | None = None,
) -> Dataset:
    """Whole files as rows ``(path, bytes)`` (reference
    ``spark.readBinaryFiles``, Readers.scala:14-48)."""
    records = list(
        _iter_file_records(
            list_files(path, recursive, pattern), sample_ratio, seed, inspect_zip
        )
    )
    return Dataset(
        {
            PATH_COL: [p for p, _ in records],
            BYTES_COL: [b for _, b in records],
        }
    )


def decode_image_rows(paths: Iterable[str], blobs: Iterable[bytes]):
    """Decode (path, bytes) pairs, dropping failures (reference
    ImageFileFormat.buildReader: non-decodable files silently dropped,
    ImageFileFormat.scala:43-82)."""
    rows = []
    dropped = 0
    for p, b in zip(paths, blobs):
        arr = decode_image(b)
        if arr is None:
            dropped += 1
            continue
        rows.append(ImageRow(path=p, data=arr))
    if dropped:
        _log.info("dropped %d non-decodable file(s)", dropped)
    return rows


def read_images(
    path: str,
    recursive: bool = True,
    sample_ratio: float = 1.0,
    seed: int = 0,
    inspect_zip: bool = True,
    image_col: str = IMAGE_COL,
) -> Dataset:
    """Decode files under ``path`` into an image column (reference
    ``spark.readImages``, Readers.scala:14-29; ImageReader.scala:71-84)."""
    binary = read_binary_files(path, recursive, sample_ratio, seed, inspect_zip)
    rows = decode_image_rows(binary[PATH_COL], binary[BYTES_COL])
    return Dataset(
        {image_col: rows},
        {image_col: ColumnMeta(image=ImageMeta())},
    )


def stream_binary_files(
    path: str,
    chunk_rows: int = 256,
    recursive: bool = True,
    sample_ratio: float = 1.0,
    seed: int = 0,
    inspect_zip: bool = True,
) -> Iterator[Dataset]:
    """Chunked streaming variant (reference ``streamBinaryFiles``)."""
    buf_p: list[str] = []
    buf_b: list[bytes] = []
    for p, b in _iter_file_records(
        list_files(path, recursive), sample_ratio, seed, inspect_zip
    ):
        buf_p.append(p)
        buf_b.append(b)
        if len(buf_p) >= chunk_rows:
            yield Dataset({PATH_COL: buf_p, BYTES_COL: buf_b})
            buf_p, buf_b = [], []
    if buf_p:
        yield Dataset({PATH_COL: buf_p, BYTES_COL: buf_b})


def stream_images(
    path: str,
    chunk_rows: int = 256,
    image_col: str = IMAGE_COL,
    **kwargs,
) -> Iterator[Dataset]:
    """Chunked streaming image decode (reference ``streamImages``)."""
    for chunk in stream_binary_files(path, chunk_rows, **kwargs):
        rows = decode_image_rows(chunk[PATH_COL], chunk[BYTES_COL])
        if rows:
            yield Dataset(
                {image_col: rows}, {image_col: ColumnMeta(image=ImageMeta())}
            )


# -- tabular ingestion -------------------------------------------------------


def read_csv(path: str, **pandas_kwargs) -> Dataset:
    import pandas as pd

    return Dataset.from_pandas(pd.read_csv(path, **pandas_kwargs))


def read_parquet(path: str, **pandas_kwargs) -> Dataset:
    import pandas as pd

    return Dataset.from_pandas(pd.read_parquet(path, **pandas_kwargs))
