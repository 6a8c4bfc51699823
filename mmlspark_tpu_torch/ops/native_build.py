"""Build and load the port's native host libraries — the port of
``mmlspark_tpu/ops/native_build.py``.

The reference's ``NativeLoader`` (core/env/src/main/scala/
NativeLoader.java) extracted a shared library and loaded it once per
JVM; here each of the port's own sources under ``ops/native/``
(``decode.cpp``: JPEG/PNG/BMP to BGR through libjpeg and libpng;
``ctf.cpp``: the CNTK-text-format parser) is compiled with the system
toolchain (``native_cc`` of :mod:`mmlspark_tpu_torch.core.config`) on
first use into ``build/torch_native/``, under a name that carries a hash
of the source and the flags (an edit rebuilds), and ``ctypes``-loaded
once per process. The JAX package writes its libraries beside its
sources; the port never loads those.

These are host libraries: a missing toolchain or header degrades to the
callers' Python paths, as in the JAX package, and
:func:`build_error` keeps the compiler's message for whoever reports it
(``chip_smoke.py`` prints it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from mmlspark_tpu_torch.core.logging_utils import get_logger

_log = get_logger("native")

SRC_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


def _configure_decode(lib: ctypes.CDLL) -> None:
    lib.mml_decode_image.restype = ctypes.c_int
    lib.mml_decode_image.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.mml_free.restype = None
    lib.mml_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.mml_decoder_version.restype = ctypes.c_char_p


def _configure_ctf(lib: ctypes.CDLL) -> None:
    lib.mml_parse_ctf.restype = ctypes.c_int
    lib.mml_parse_ctf.argtypes = [
        ctypes.c_char_p,  # path
        ctypes.c_char_p,  # label field name
        ctypes.c_char_p,  # features field name
        ctypes.c_int,     # feature_dim (<=0: dense only)
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.mml_ctf_free.restype = None
    lib.mml_ctf_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.mml_ctf_version.restype = ctypes.c_char_p


@dataclass
class _NativeLib:
    src: Path
    configure: Callable[[ctypes.CDLL], None]
    link_flags: tuple = ()
    lock: threading.Lock = field(default_factory=threading.Lock)
    lib: ctypes.CDLL | None = None
    #: the compiler's (or the loader's) message when the build failed
    error: str | None = None


_LIBS: dict[str, _NativeLib] = {
    "decode": _NativeLib(SRC_DIR / "decode.cpp", _configure_decode,
                         ("-ljpeg", "-lpng")),
    "ctf": _NativeLib(SRC_DIR / "ctf.cpp", _configure_ctf),
}


def library_path(name: str) -> Path:
    """Where library ``name`` is built: its name plus a hash of its
    source and flags."""
    entry = _LIBS[name]
    h = hashlib.sha256(entry.src.read_bytes())
    h.update(" ".join(CXX_FLAGS + entry.link_flags).encode())
    return BUILD_DIR / f"libmml{name}-{h.hexdigest()[:12]}.so"


def _compile(entry: _NativeLib, out: Path) -> str | None:
    """Compile ``entry`` to ``out``; None on success, else the error."""
    from mmlspark_tpu_torch.core import config

    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a reader never sees a
    # half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [config.get("native_cc"), *CXX_FLAGS, str(entry.src), "-o",
           str(tmp), *entry.link_flags]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # no toolchain
        return f"{type(e).__name__}: {e}"
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return res.stderr[-2000:] or f"exit {res.returncode}"
    os.replace(tmp, out)
    return None


def load_native(name: str) -> ctypes.CDLL | None:
    """Compile if needed and load a registered native library; None when
    it cannot be built or loaded (the callers' Python paths take over;
    :func:`build_error` says why)."""
    from mmlspark_tpu_torch.core import config

    entry = _LIBS[name]
    with entry.lock:
        if entry.lib is not None:
            return entry.lib
        if entry.error is not None or not config.get("native_build"):
            return None
        so = library_path(name)
        if not so.is_file():
            entry.error = _compile(entry, so)
            if entry.error is not None:
                _log.warning("native build failed for %s:\n%s", entry.src,
                             entry.error)
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            entry.error = f"load failed: {e}"
            _log.warning("native load failed for %s: %s", so, e)
            return None
        entry.configure(lib)
        entry.lib = lib
        return lib


def load_library() -> ctypes.CDLL | None:
    """The image-decode library (the JAX package's single-library entry
    point)."""
    return load_native("decode")


def build_error(name: str) -> str | None:
    """The compiler's or loader's message from library ``name``'s failed
    build in this process, else None."""
    return _LIBS[name].error
