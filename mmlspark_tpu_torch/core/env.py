"""Accelerator discovery for the port: a CUDA probe.

The JAX package asks its backend whether it drives TPU silicon
(``mmlspark_tpu/core/env.py:is_tpu``) and picks interpret mode for the
Pallas kernels elsewhere. The port decides differently: its entry points
run on ``cuda`` unless the caller asks for the CPU, and with no GPU
present they raise instead of carrying on quietly on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError


def has_cuda() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


def default_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the card: ``cuda`` when a GPU is present, else a
    :class:`FriendlyError` — the port never falls back to the CPU on its
    own. An explicit ``"cpu"`` (what the tests pass) is honoured, and an
    explicit CUDA device raises the same error when no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
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
