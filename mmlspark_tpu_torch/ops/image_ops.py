"""Image ops: OpenCV-semantics transforms, host (per-row numpy) and device
(batched NHWC torch) paths — the port of ``mmlspark_tpu/ops/image_ops.py``.

The reference runs OpenCV ops inside a per-row UDF via JNI
(image-transformer/src/main/scala/ImageTransformer.scala:21-252:
resize/crop/colorFormat/blur/threshold/gaussianKernel/flip on BGR CV_8U
Mats). Here every op has:

- a numpy implementation on one HWC uint8 BGR image (exact, handles
  per-image sizes), used by ImageTransformer for ragged inputs, and
- where it matters for the hot path, a torch NHWC batch implementation on
  the caller's device (resize for the featurizer feed).

Bilinear resize is ``jax.image.resize(method="bilinear")`` in the JAX
package, which antialiases when it shrinks; its counterpart here is
``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``:
the same triangle filter widened by the scale when shrinking. The two
sum in other orders, so a value on the edge of a uint8 rounding step can
land one level apart (a few pixels in a thousand when shrinking); an
upsample or an equal size gives the same bytes.

Threshold type codes mirror OpenCV: binary, binary_inv, trunc, tozero,
tozero_inv. Flip codes mirror OpenCV: 0 = vertical (up/down), 1 =
horizontal (left/right), -1 = both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.exceptions import FriendlyError

# -- host (single image, HWC uint8) -----------------------------------------


def resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize (OpenCV INTER_LINEAR default semantics), on the
    host."""
    out = batch_resize_nhwc(torch.from_numpy(
        np.ascontiguousarray(img, dtype=np.float32))[None], height, width)
    return np.clip(out[0].numpy(), 0, 255).round().astype(np.uint8)


def crop(img: np.ndarray, x: int, y: int, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    if y + height > h or x + width > w or x < 0 or y < 0:
        raise FriendlyError(
            f"crop ({x},{y},{height},{width}) outside image {h}x{w}"
        )
    return img[y : y + height, x : x + width]


def color_format(img: np.ndarray, format: str) -> np.ndarray:
    """'gray' via OpenCV BGR weights; 'bgr' passthrough."""
    if format == "bgr":
        return img
    if format == "gray":
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        gray = 0.114 * b + 0.587 * g + 0.299 * r
        return np.clip(gray, 0, 255).round().astype(np.uint8)[..., None]
    raise FriendlyError(f"unknown color format '{format}'")


def _box_kernel(ky: int, kx: int) -> np.ndarray:
    return np.full((ky, kx), 1.0 / (ky * kx))


def _conv2d_same(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Depthwise 2-D convolution, reflect-101 border (OpenCV default)."""
    ky, kx = kernel.shape
    py, px = ky // 2, kx // 2
    out = np.empty_like(img, dtype=np.float64)
    for c in range(img.shape[2]):
        padded = np.pad(
            img[..., c].astype(np.float64), ((py, py), (px, px)), mode="reflect"
        )
        acc = np.zeros(img.shape[:2], dtype=np.float64)
        for dy in range(ky):
            for dx in range(kx):
                acc += kernel[dy, dx] * padded[
                    dy : dy + img.shape[0], dx : dx + img.shape[1]
                ]
        out[..., c] = acc
    return np.clip(out, 0, 255).round().astype(np.uint8)


def blur(img: np.ndarray, ky: int, kx: int) -> np.ndarray:
    """Normalized box blur (OpenCV blur)."""
    return _conv2d_same(img, _box_kernel(int(ky), int(kx)))


def gaussian_kernel(img: np.ndarray, aperture: int, sigma: float) -> np.ndarray:
    """Gaussian filter (OpenCV GaussianBlur/filter2D w/ getGaussianKernel)."""
    n = int(aperture)
    if sigma <= 0:
        sigma = 0.3 * ((n - 1) * 0.5 - 1) + 0.8  # OpenCV default sigma rule
    ax = np.arange(n) - (n - 1) / 2.0
    g = np.exp(-(ax**2) / (2 * sigma**2))
    g /= g.sum()
    return _conv2d_same(img, np.outer(g, g))


THRESHOLD_TYPES = ("binary", "binary_inv", "trunc", "tozero", "tozero_inv")


def threshold(
    img: np.ndarray, thresh: float, max_val: float, kind: str = "binary"
) -> np.ndarray:
    f = img.astype(np.float64)
    if kind == "binary":
        out = np.where(f > thresh, max_val, 0.0)
    elif kind == "binary_inv":
        out = np.where(f > thresh, 0.0, max_val)
    elif kind == "trunc":
        out = np.minimum(f, thresh)
    elif kind == "tozero":
        out = np.where(f > thresh, f, 0.0)
    elif kind == "tozero_inv":
        out = np.where(f > thresh, 0.0, f)
    else:
        raise FriendlyError(
            f"unknown threshold type '{kind}'; one of {THRESHOLD_TYPES}"
        )
    return np.clip(out, 0, 255).round().astype(np.uint8)


def flip(img: np.ndarray, code: int = 1) -> np.ndarray:
    """OpenCV flip codes: 0 vertical, positive horizontal, negative both."""
    if code == 0:
        return img[::-1]
    if code > 0:
        return img[:, ::-1]
    return img[::-1, ::-1]


# -- device (batched NHWC) ---------------------------------------------------


def batch_resize_nhwc(batch: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """Bilinear (antialiased when shrinking) resize of an NHWC float
    batch, on the batch's device — the featurizer's resize-to-model-input
    feed. Returns NHWC float32."""
    x = batch.float().permute(0, 3, 1, 2)
    if x.shape[2:] != (height, width):
        x = F.interpolate(x, size=(height, width), mode="bilinear",
                          antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1)


def batch_normalize_nhwc(batch: torch.Tensor, mean=None, std=None,
                         scale: float = 1.0 / 255.0) -> torch.Tensor:
    """uint8 NHWC -> float32 normalized, on the batch's device."""
    x = batch.float() * scale
    if mean is not None:
        x = x - torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    if std is not None:
        x = x / torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return x
