"""The integrity fold over a list of tensors as one pass.

:func:`tree_fold` computes the position-salted wraparound fold of
``core/integrity.py`` over leaves in a given order: for leaf ``i`` and
word ``j`` of its bitcast word stream, ``sum w[j] * (j * MIX + 2i + 1)``
mod 2^32. A leaf of 1-byte elements (bool: 0 or 1) or 2-byte elements
gives one zero-extended word an element, 4-byte elements one word, 8-byte
elements two little-endian words. The fold lands in ``out``, a 0-d int32
tensor holding the uint32's bits (:func:`as_uint32` reads it), and only
where ``flag`` (a 0-d bool tensor) is true; elsewhere ``out`` keeps its
value. So one captured training step serves audit and non-audit steps:
the flag, not the host, decides.

There is no TPU kernel behind it: in the reference XLA fuses the fold into
the jitted step under ``lax.cond``. On a CUDA tensor the fold is one
launch of ``csrc/tree_checksum.cu`` over a :class:`FoldPlan`, a device
table of the leaves' pointers and word counts built once for leaves that
keep their addresses (the trainer's state); on a CPU tensor it runs
:func:`tree_fold_reference`, the plain version, which splits each 32-bit
product into 16-bit halves so that int64 arithmetic never overflows
(PyTorch has no uint32 sum).
"""

from __future__ import annotations

import numpy as np
import torch

#: launches of the kernel in this process — added to where the wrapper
#: launches it and nowhere else
launches = 0
COUNTERS = ("launches",)

#: word-position multiplier stride (even; golden-ratio mix constant)
MIX = 0x9E3779B8
M32 = 0xFFFFFFFF
#: words a chunk of the kernel's grid walk (csrc/tree_checksum.cu)
CHUNK_WORDS = 8192
#: the grid's ceiling: blocks walk the chunks with a stride
MAX_BLOCKS = 2048

_ENTRY = np.dtype([("ptr", "<u8"), ("n_words", "<i8"),
                   ("chunk_start", "<i8"), ("salt", "<u4"),
                   ("word_bytes", "<i4")])


def fold_route(t: torch.Tensor) -> str:
    """``"cuda"``, the kernel, for a CUDA tensor; ``"plain"``, the plain
    version, for a CPU tensor; anything else raises."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(
        f"the fold runs on cuda (the kernel) or cpu (its plain version), "
        f"got {t.device}")


def word_layout(t: torch.Tensor) -> tuple[int, int]:
    """``(word bytes, word count)`` of a leaf's word stream."""
    size = t.element_size()
    if size == 8:
        return 4, 2 * t.numel()
    if size not in (1, 2, 4):
        raise ValueError(f"the fold takes 1-, 2-, 4- and 8-byte elements, "
                         f"got {t.dtype}")
    return size, t.numel()


def as_uint32(out: torch.Tensor) -> int:
    """The fold held in an int32 tensor, as a non-negative int."""
    return int(out.item()) & M32


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 ``a`` and ``b`` in ``[0, 2^32)``,
    through 16-bit halves of ``a`` (each partial product under 2^48)."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _words(t: torch.Tensor) -> torch.Tensor:
    """A leaf's word stream as int64 values in ``[0, 2^32)``."""
    t = t.detach().reshape(-1)
    if t.dtype == torch.bool:
        return t.to(torch.int64)
    size = t.element_size()
    if size == 1:
        return t.view(torch.uint8).to(torch.int64)
    if size == 2:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    if size in (4, 8):
        return t.view(torch.int32).to(torch.int64) & M32
    raise ValueError(f"the fold takes 1-, 2-, 4- and 8-byte elements, got "
                     f"{t.dtype}")


def _select(out, fold, flag):
    """``fold`` into ``out`` where ``flag``, as an int32 bit pattern."""
    bits = torch.where(fold >= 2 ** 31, fold - 2 ** 32, fold).to(torch.int32)
    if flag is not None:
        bits = torch.where(flag, bits, out)
    out.copy_(bits)
    return out


def tree_fold_reference(leaves: list, *, out=None, flag=None):
    """The plain version: the fold in int64 tensor ops on the leaves' own
    device, exact mod 2^32 (no host sync, no branch on ``flag``)."""
    dev = leaves[0].device if leaves else torch.device("cpu")
    if out is None:
        out = torch.zeros((), dtype=torch.int32, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for i, leaf in enumerate(leaves):
        w = _words(leaf)
        if not w.numel():
            continue
        j = torch.arange(w.numel(), dtype=torch.int64, device=w.device)
        mult = (_mulmod32(j & M32, MIX) + (2 * i + 1)) & M32
        acc = (acc + _mulmod32(w, mult).sum()) & M32
    return _select(out, acc, flag)


class FoldPlan:
    """The kernel's device table for one list of CUDA leaves: their
    pointers, word counts, salts and chunk offsets, and the kernel's
    two-word workspace. Built once for leaves that keep their addresses
    (a captured program reads the table on every replay); the plan keeps
    the leaves alive. One plan serves one stream at a time."""

    def __init__(self, leaves: list):
        if not leaves:
            raise ValueError("a fold plan needs at least one leaf")
        dev = leaves[0].device
        rows = []
        chunks = 0
        for i, t in enumerate(leaves):
            if t.device != dev or dev.type != "cuda" or \
                    not t.is_contiguous():
                raise ValueError(
                    f"the fold kernel takes contiguous tensors on one CUDA "
                    f"device, got leaf {i} {t.dtype} {tuple(t.shape)} on "
                    f"{t.device} (contiguous: {t.is_contiguous()})")
            word_bytes, n_words = word_layout(t)
            if not n_words:
                continue  # an empty leaf adds nothing; its salt is skipped
            rows.append((t.data_ptr(), n_words, chunks, 2 * i + 1,
                         word_bytes))
            chunks += -(-n_words // CHUNK_WORDS)
        table = np.array(rows, dtype=_ENTRY)
        self.device = dev
        self.leaves = list(leaves)
        self.ptrs = [t.data_ptr() for t in leaves]
        self.n_leaves = len(rows)
        self.total_chunks = chunks
        self.n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        self.table = (torch.from_numpy(table.view(np.uint8)).to(dev)
                      if rows else None)
        self.workspace = torch.zeros(2, dtype=torch.int32, device=dev)

    def matches(self, leaves: list) -> bool:
        """Whether ``leaves`` are the plan's tensors, at its addresses."""
        return len(leaves) == len(self.ptrs) and all(
            t.data_ptr() == p for t, p in zip(leaves, self.ptrs))


def tree_fold(leaves: list, *, out=None, flag=None, plan=None):
    """The fold of ``leaves`` into ``out`` (made when None) where ``flag``
    is true; returns ``out``. CUDA leaves: one kernel launch over ``plan``
    (built here when None); CPU leaves: the plain version."""
    if not leaves or fold_route(leaves[0]) == "plain":
        return tree_fold_reference(leaves, out=out, flag=flag)
    if plan is None:
        plan = FoldPlan(leaves)
    elif not plan.matches(leaves):
        raise ValueError("the fold plan was built for other tensors than "
                         "these leaves")
    dev = plan.device
    if out is None:
        out = torch.zeros((), dtype=torch.int32, device=dev)
    _check_scalar("out", out, torch.int32, dev)
    if flag is not None:
        _check_scalar("flag", flag, torch.bool, dev)
    _launch(plan, out, flag)
    return out


def _check_scalar(name, t, dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or t.numel() != 1:
        raise ValueError(f"{name} must be one {dtype} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(plan: FoldPlan, out, flag) -> None:
    global launches
    from mmlspark_tpu_torch.ops.kernel_build import bind, load

    lib = bind(load("tree_checksum"))
    blocks = max(1, min(plan.total_chunks, MAX_BLOCKS))
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        rc = lib.mml_tree_checksum(
            plan.table.data_ptr() if plan.table is not None else None,
            plan.n_leaves, plan.total_chunks,
            flag.data_ptr() if flag is not None else None,
            plan.workspace.data_ptr(), out.data_ptr(), blocks, stream)
    if rc:
        raise RuntimeError(
            f"tree checksum kernel launch failed: CUDA error {rc} "
            f"({lib.mml_cuda_error_string(rc).decode()})")
    launches += 1
