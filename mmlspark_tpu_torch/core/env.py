"""Accelerator discovery for the port: a CUDA probe, and the topology
view the launcher's ``env`` command prints.

The JAX package asks its backend whether it drives TPU silicon
(``mmlspark_tpu/core/env.py:is_tpu``) and picks interpret mode for the
Pallas kernels elsewhere. The port decides differently: its entry points
run on ``cuda`` unless the caller asks for the CPU, and with no GPU
present they raise instead of carrying on quietly on the host. The
topology half (``device_count`` .. ``describe``) reads ``torch.cuda``
and the ``torch.distributed`` process group.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError


#: what ``device=None`` means in this process: the card, unless the
#: launcher's ``--cpu-mesh`` asked for the CPU (:func:`process_default`)
_process_default = "cuda"


def has_cuda() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


@contextmanager
def process_default(device: str):
    """Within the block ``device=None`` means ``device``: how ``python -m
    mmlspark_tpu_torch --cpu-mesh N run script.py`` puts a script that
    names no device on the CPU, as ``JAX_PLATFORMS=cpu`` does a JAX
    script. The old meaning comes back when the block ends."""
    global _process_default
    before, _process_default = _process_default, device
    try:
        yield
    finally:
        _process_default = before


def default_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the card: ``cuda`` when a GPU is present, else a
    :class:`FriendlyError` — the port never falls back to the CPU on its
    own (inside :func:`process_default`, the device it names). An
    explicit ``"cpu"`` (what the tests pass) is honoured, and an
    explicit CUDA device raises the same error when no GPU is present."""
    dev = torch.device(_process_default if device is None else device)
    if dev.type == "cuda" and not has_cuda():
        raise FriendlyError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run the plain PyTorch path "
            "on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise FriendlyError(
            f"device must be 'cuda' or 'cpu', got {str(dev)!r}"
        )
    return dev


def host_to_device(array, device: torch.device) -> torch.Tensor:
    """A host numpy array on ``device``. To the card it goes through pinned
    memory, a copy that does not wait for the stream (a program's per-call
    inputs add no host sync); on the CPU it is the array's own memory."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@dataclass(frozen=True)
class CardInfo:
    """Name and compute capability of one CUDA device."""

    name: str
    capability: tuple[int, int]
    count: int


def card_info(index: int = 0) -> CardInfo:
    """The card's name and compute capability; raises without a GPU."""
    default_device("cuda")
    return CardInfo(
        name=torch.cuda.get_device_name(index),
        capability=tuple(torch.cuda.get_device_capability(index)),
        count=torch.cuda.device_count(),
    )


# -- topology: the launcher's ``env`` view ---------------------------------


def local_device_count() -> int:
    """The CUDA devices this process sees (0 without a GPU)."""
    return torch.cuda.device_count() if has_cuda() else 0


def process_count() -> int:
    """Ranks of the ``torch.distributed`` process group (1 when none is
    initialised): the counterpart of JAX's controller processes."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def device_count() -> int:
    """Global card count. Under an NCCL process group each rank drives
    one card, so it is the world size; otherwise the cards this process
    sees."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and \
            dist.get_backend() == "nccl":
        return dist.get_world_size()
    return local_device_count()


def backend() -> str:
    """``"gpu"`` when PyTorch sees a CUDA device, else ``"cpu"`` (JAX's
    ``default_backend()`` names)."""
    return "gpu" if has_cuda() else "cpu"


@dataclass(frozen=True)
class TopologyInfo:
    """Device and process facts, with the JAX package's field names.

    ``platform`` is ``"gpu"`` or ``"cpu"`` (never ``"tpu"``);
    ``device_kind`` is the card's name (``torch.cuda.get_device_name``),
    where the JAX package reports a TPU generation, or ``"cpu"``."""

    num_devices: int
    num_local_devices: int
    num_processes: int
    platform: str
    device_kind: str
    host_os: str


def topology(device=None) -> TopologyInfo:
    """The topology seen from ``device`` (the card unless the caller asks
    for ``"cpu"``; without a GPU, ``None`` raises as every entry point
    does). On the CPU each rank is one host device."""
    import platform as _platform

    dev = default_device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return TopologyInfo(
            num_devices=device_count(),
            num_local_devices=local_device_count(),
            num_processes=process_count(),
            platform="gpu",
            device_kind=torch.cuda.get_device_name(index),
            host_os=_platform.system(),
        )
    return TopologyInfo(
        num_devices=process_count(),
        num_local_devices=1,
        num_processes=process_count(),
        platform="cpu",
        device_kind="cpu",
        host_os=_platform.system(),
    )


def describe(device=None) -> dict:
    """Topology as a plain dict (the launcher's ``env`` view)."""
    import dataclasses

    return dataclasses.asdict(topology(device))
