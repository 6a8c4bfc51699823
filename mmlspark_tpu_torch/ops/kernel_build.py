"""Build the port's hand-written CUDA kernels on first use and load them
with ``ctypes``.

Counterpart in spirit of ``mmlspark_tpu/ops/native_build.py``: sources
ship in the package (``mmlspark_tpu_torch/csrc/*.cu``, with the
``*.cuh`` headers they include) and are compiled
lazily, on the machine with the card, into ``build/torch_kernels/`` at
the root of the checkout. Each source becomes its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>-<hash>.so
         csrc/<name>.cu

The library name carries a hash of the source and the headers, so an
edited kernel is never served from a stale build. All sources compile in
parallel (one
``nvcc`` per source, started together) the first time any kernel is
asked for. A failed build raises with the compiler's output; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from mmlspark_tpu_torch.core.exceptions import FriendlyError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: Hopper only: keep the ``a`` — wgmma/setmaxnreg exist only for sm_90a
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises when there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise FriendlyError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ on the machine with "
        "the GPU and need the CUDA toolkit there"
    )


def sources() -> dict[str, Path]:
    """``{kernel library name: source path}`` for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(src: Path) -> Path:
    """Where the build of ``src`` lands: its name plus a hash of the
    source, every ``*.cuh`` header beside it (a source may include any
    of them) and the flags, so any edit rebuilds."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns ``{name: library path}``. The compiler's output (ptxas
    register and shared-memory report included) is kept beside each
    library as ``<library>.log``."""
    todo = {}
    for name, src in sources().items():
        lib = library_path(src)
        if not lib.is_file():
            todo[name] = (src, lib)
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, (src, lib) in todo.items():
            # compile to a private name, then rename: a reader never
            # sees a half-written library
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (
                subprocess.Popen(
                    nvcc_command(nvcc, src, tmp),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp, lib,
            )
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            Path(str(lib) + ".log").write_text(log)
            if proc.returncode:
                tmp.unlink(missing_ok=True)
                failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError(
                "nvcc failed to build the port's kernels:\n"
                + "\n".join(failed)
            )
    return {name: library_path(src) for name, src in sources().items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    kernel on the first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise FriendlyError(
                    f"no kernel source csrc/{name}.cu; have "
                    f"{sorted(paths)}"
                )
            lib = ctypes.CDLL(str(paths[name]))
            _libs[name] = lib
        return lib


PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C signatures: every pointer and the stream as ``c_void_p`` (an
#: undeclared argument would pass as a 32-bit int and cut the pointer),
#: strides as 64-bit
SIGNATURES = {
    "mml_flash_decode": (
        [I32] + [PTR] * 6 + [I32] * 7 + [I64] * 8
        + [ctypes.c_float, PTR]
    ),
    "mml_flash_decode_q8": (
        [I32] + [PTR] * 8 + [I32] * 8 + [I64] * 8
        + [ctypes.c_float, PTR]
    ),
    "mml_paged_flash_decode": (
        [I32] * 2 + [PTR] * 9 + [I32] * 10 + [I64] * 2
        + [ctypes.c_float, PTR]
    ),
    "mml_flash_attention_fwd": (
        [I32] + [PTR] * 5 + [I32] * 5 + [I64] * 9
        + [ctypes.c_float, I32, I32, PTR]
    ),
    "mml_flash_attention_fwd_mma": (
        [PTR] * 5 + [I32] * 5 + [I64] * 9
        + [ctypes.c_float, I32, I32, PTR]
    ),
    "mml_flash_attention_bwd_kv": (
        [I32] + [PTR] * 8 + [I32] * 5 + [I64] * 12
        + [ctypes.c_float, I32, I32, PTR]
    ),
    "mml_flash_attention_bwd_q": (
        [I32] + [PTR] * 7 + [I32] * 5 + [I64] * 12
        + [ctypes.c_float, I32, I32, PTR]
    ),
    "mml_flash_attention_bwd_kv_mma": (
        [PTR] * 8 + [I32] * 5 + [I64] * 12
        + [ctypes.c_float, I32, I32, PTR]
    ),
    "mml_flash_attention_bwd_q_mma": (
        [PTR] * 7 + [I32] * 5 + [I64] * 12
        + [ctypes.c_float, I32, I32, PTR]
    ),
    # the optimizer's kind and tensor count, the p/g/m/v pointer tables
    # and the numel table (host arrays), the four scalar pointers, the
    # seven f32 constants, the stream
    "mml_fused_optim": (
        [I32] * 2 + [PTR] * 9 + [ctypes.c_float] * 7 + [PTR]
    ),
}


def bind(lib):
    """Declare the C signatures of the entry points ``lib`` exports (and
    of its ``mml_cuda_error_string``), once per library."""
    err = lib.mml_cuda_error_string
    if err.argtypes is None:
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return lib
