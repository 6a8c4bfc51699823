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
