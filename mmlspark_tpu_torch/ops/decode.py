"""Image decode: encoded bytes -> HWC uint8 BGR array — the port of
``mmlspark_tpu/ops/decode.py``.

Equivalent of reference ``ImageReader.decode``
(readers/src/main/scala/ImageReader.scala:45-63): OpenCV ``imdecode`` behind
JNI, always producing 3-channel BGR CV_8U; decode failure -> row dropped.

The primary path is the port's own C++ op (``ops/native/decode.cpp``
through ``ops/native_build.py`` and ctypes; the same libjpeg/libpng as
the JAX package's, so the arrays are bit-equal); the fallback is PIL
where it is importable (decodes RGB, converted to BGR here) and for the
formats the native op does not cover.

One deliberate difference from the JAX package: where NEITHER decoder
can run (no native build and no PIL), :func:`decode_image` raises a
``FriendlyError`` naming both, where the JAX package returns None for
every row and a reader silently drops the whole dataset.
"""

from __future__ import annotations

import ctypes
import io

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.ops import native_build


def _decode_native(lib, data: bytes) -> np.ndarray | None:
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    out = ctypes.POINTER(ctypes.c_uint8)()
    rc = lib.mml_decode_image(
        data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
        ctypes.byref(out),
    )
    if rc != 0:
        return None
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
        return arr.reshape(h.value, w.value, c.value)
    finally:
        lib.mml_free(out)


def _pil_image():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _decode_pil(image_mod, data: bytes) -> np.ndarray | None:
    try:
        img = image_mod.open(io.BytesIO(data)).convert("RGB")
    except Exception:  # noqa: BLE001 — any undecodable input drops the row
        return None
    rgb = np.asarray(img, dtype=np.uint8)
    return rgb[:, :, ::-1].copy()  # RGB -> BGR


def decode_image(data: bytes) -> np.ndarray | None:
    """Decode to (H, W, 3) uint8 BGR, or None for non-decodable input (the
    caller drops the row, mirroring ImageReader.decode => None). Raises
    :class:`FriendlyError` when no decoder can run here."""
    if not isinstance(data, (bytes, bytearray)) or len(data) < 8:
        return None
    lib = native_build.load_native("decode")
    pil = _pil_image()
    if lib is None and pil is None:
        raise FriendlyError(
            "no image decoder can run here: the native decoder "
            "(ops/native/decode.cpp, libjpeg + libpng) did not build "
            f"({native_build.build_error('decode') or 'native_build off'})"
            " and PIL is not installed"
        )
    out = _decode_native(lib, bytes(data)) if lib is not None else None
    if out is None and pil is not None:
        # PIL covers the formats the native op does not (GIF, TIFF, WebP,
        # CMYK JPEG, ...), so row counts do not depend on the toolchain
        out = _decode_pil(pil, bytes(data))
    return out


def native_available() -> bool:
    return native_build.load_native("decode") is not None


def encode_ppm(arr: np.ndarray) -> bytes:
    """Tiny BGR->PPM encoder used by tests/fixtures (no native dep)."""
    h, w, _ = arr.shape
    header = f"P6\n{w} {h}\n255\n".encode()
    return header + arr[:, :, ::-1].astype(np.uint8).tobytes()
