"""Real sample datasets available offline — the port of
``mmlspark_tpu/data/sample_data.py``.

The reference installs real sample datasets at build time with sha256
pinning (tools/config.sh:62-117 — Adult Census, Flight Delay, CIFAR) and
its notebooks run on them. This environment has no egress, so the real
data that ships inside installed packages is the sample source:

- ``load_digit_images``: the scikit-learn handwritten-digits scans
  (1,797 real 8x8 grayscale images, 10 classes — test set of the UCI
  Optical Recognition of Handwritten Digits dataset), rendered to the
  framework's 32x32x3 uint8 image form with optional random placement
  ("unregistered" digits) for augmentation and robustness evaluation.

These back the committed model zoo's pretrained backbone
(tools/publish_zoo.py ``ResNet20_Digits04``) and the transfer-learning
examples (e303) the way the reference zoo's ImageNet CNNs back
notebooks 303/305.

The port reads the scans from its own copy of scikit-learn's
``datasets/data/digits.csv.gz`` (:data:`DIGITS_CSV`, the table
``sklearn.datasets.load_digits`` parses: 64 pixel counts and the label a
row), so it needs no scikit-learn (the GPU machine has none) and no
import of it (seconds of start-up a call).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError

#: the digits table, a copy of scikit-learn's ``digits.csv.gz``
DIGITS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits.csv.gz")

__all__ = ["load_digit_images"]


def _render(img8: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Upscale an 8x8 [0,1] digit 4x (nearest) and place it on a 32x32
    canvas at offset (dy, dx) — translation without interpolation."""
    big = img8.repeat(4, axis=0).repeat(4, axis=1)
    out = np.zeros((32, 32), np.float32)
    ys, xs = max(0, dy), max(0, dx)
    ye, xe = min(32, 32 + dy), min(32, 32 + dx)
    out[ys:ye, xs:xe] = big[ys - dy:ye - dy, xs - dx:xe - dx]
    return out


def load_digit_images(
    classes: tuple | None = None,
    *,
    max_shift: int = 0,
    seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Real handwritten-digit images as (N, 32, 32, 3) uint8 + int labels.

    ``classes`` restricts to a label subset (e.g. ``(0,1,2,3,4)`` for the
    zoo backbone's source task). ``max_shift`` > 0 places each digit at a
    uniform random offset in [-max_shift, max_shift]^2 ("unregistered"
    scans): the training augmentation, and the evaluation condition under
    which raw-pixel models break while convolutional features hold up.
    """
    if not os.path.exists(DIGITS_CSV):
        raise FriendlyError(
            f"load_digit_images reads {DIGITS_CSV}, which is missing"
        )
    with gzip.open(DIGITS_CSV, "rt") as f:
        table = np.loadtxt(f, delimiter=",")
    x8 = (table[:, :-1].reshape(-1, 8, 8) / 16.0).astype(np.float32)
    y = table[:, -1].astype(np.int32)
    if classes is not None:
        keep = np.isin(y, np.asarray(classes))
        x8, y = x8[keep], y[keep]
        remap = {c: i for i, c in enumerate(sorted(classes))}
        y = np.array([remap[int(v)] for v in y], np.int32)
    rng = np.random.default_rng(seed)
    shifts = (
        rng.integers(-max_shift, max_shift + 1, size=(len(x8), 2))
        if max_shift > 0
        else np.zeros((len(x8), 2), np.int64)
    )
    imgs = np.stack([
        _render(im, int(dy), int(dx)) for im, (dy, dx) in zip(x8, shifts)
    ])
    imgs = (imgs * 255.0 + 0.5).astype(np.uint8)[..., None].repeat(3, axis=3)
    return imgs, y
