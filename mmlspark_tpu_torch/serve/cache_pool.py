"""Slot-based KV-cache pool for the serving engine — the port of
``mmlspark_tpu/serve/cache_pool.py`` (dense bf16 pool on one device; the
int8 mode and meshes wait for later slices).

ONE ``(S, cache_len, Hkv, D)`` bf16 buffer pair per block for the whole
process, where ``S`` is the number of serving slots. A request leases a
slot for its lifetime, the prefill writes its prompt's K/V into positions
``[0, P)`` of that slot row, decode steps append one position per step
(in place, ``models/transformer.py``), and retirement frees the slot.

Stale K/V from a previous lease is harmless: a new lease always prefills
``[0, P)`` with ``P >= 1`` before its first decode step, and the decode
read sees only ``[0, pos + 1)``. All writes go to the buffers in place on
one stream, so they land in the order they were issued.
"""

from __future__ import annotations

import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.generate import cache_geometry


class SlotCachePool:
    """Preallocated per-block K/V buffers with slot lease/free accounting.

    ``buffers`` is ``{block: (K, V)}`` with each tensor
    ``(slots, cache_len, hk, d)`` bf16 on ``device``. The pool also owns
    the DEVICE-resident per-slot decode state that the fused decode
    block advances between host syncs: ``positions`` ((S,) int32, each
    slot's next write position) and ``live`` ((S,) bool, True = active
    tenant). Free-slot convention: (pos 0, dead).
    """

    def __init__(self, graph, variables, slots: int, cache_len: int, *,
                 device):
        if slots < 1:
            raise FriendlyError(f"slots must be >= 1, got {slots}")
        if cache_len < 2:
            raise FriendlyError(
                f"cache_len must be >= 2 (one prompt token + one "
                f"generated), got {cache_len}"
            )
        geometry = cache_geometry(graph, variables)
        if not geometry:
            raise FriendlyError(
                f"'{graph.name}' has no cache-accepting blocks; the "
                "serving engine needs the KV-cache decode path "
                "(transformer_lm family)"
            )
        self.device = torch.device(device)
        self.num_slots = slots
        self.cache_len = cache_len
        # K and V are DISTINCT tensors: the decode step writes both in
        # place
        self.buffers = {
            name: tuple(
                torch.zeros((slots, cache_len, hk, d), dtype=torch.bfloat16,
                            device=self.device)
                for _ in range(2)
            )
            for name, (hk, d) in geometry.items()
        }
        # LIFO free list popping the lowest id first keeps slot
        # assignment deterministic for the parity tests
        self._free = list(range(slots - 1, -1, -1))
        self._leased: set[int] = set()
        self.positions = torch.zeros((slots,), dtype=torch.int32,
                                     device=self.device)
        self.live = torch.zeros((slots,), dtype=torch.bool,
                                device=self.device)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def leased_count(self) -> int:
        return len(self._leased)

    def lease(self) -> int:
        if not self._free:
            raise FriendlyError(
                f"no free KV-cache slots (all {self.num_slots} leased); "
                "the scheduler should admit only into free slots — free "
                "a retired slot first or build the pool with more slots"
            )
        slot = self._free.pop()
        self._leased.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._leased:
            raise FriendlyError(
                f"slot {slot} is not leased (double free, or never "
                f"leased from this pool of {self.num_slots})"
            )
        self._leased.remove(slot)
        self._free.append(slot)
        # restore the free-slot convention (pos 0, dead) so the fused
        # decode block keeps this row's writes at position 0 and its
        # flash-decode length reads as zero
        self.positions[slot] = 0
        self.live[slot] = False

    def write_prefill(self, slot: int, prefill_cache: dict,
                      length: int) -> None:
        """Copy a batch-1 prefill cache (valid K/V for positions
        ``[0, length)``) into the slot's row, in place, and mark the slot
        live with its first decode write at ``length``."""
        if slot not in self._leased:
            raise FriendlyError(f"slot {slot} is not leased")
        if not 1 <= length <= self.cache_len:
            raise FriendlyError(
                f"prefill length {length} must lie in [1, cache_len "
                f"{self.cache_len}]"
            )
        for name, (pk, pv) in self.buffers.items():
            ck, cv = prefill_cache[name]
            pk[slot, :length].copy_(ck[0, :length])
            pv[slot, :length].copy_(cv[0, :length])
        self.positions[slot] = length
        self.live[slot] = True

    def device_bytes_per_device(self) -> int:
        """KV-pool bytes resident on the device: every K/V buffer plus the
        per-slot position/live state."""
        tensors = [t for pair in self.buffers.values() for t in pair]
        tensors += [self.positions, self.live]
        return int(sum(t.numel() * t.element_size() for t in tensors))
