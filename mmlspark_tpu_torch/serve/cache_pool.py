"""Slot-based KV-cache pool for the serving engine — the port of
``mmlspark_tpu/serve/cache_pool.py``, with the bf16 and the int8 KV
modes, on one device or sharded over a serving mesh.

ONE ``(S, cache_len, Hkv, D)`` buffer pair per block for the whole
process, where ``S`` is the number of serving slots. A request leases a
slot for its lifetime, the prefill writes its prompt's K/V into positions
``[0, P)`` of that slot row, decode steps append one position per step
(in place, ``models/transformer.py``), and retirement frees the slot.

Stale K/V from a previous lease is harmless: a new lease always prefills
``[0, P)`` with ``P >= 1`` before its first decode step, and the decode
read sees only ``[0, pos + 1)``. All writes go to the buffers in place on
one stream, so they land in the order they were issued.

``kv_dtype="int8"`` stores K/V as int8 — half the bf16 pool's bytes —
with per-(slot, kv head) f32 scales fixed at prefill from the prompt's
amax (+ ``KV_SCALE_MARGIN`` headroom); decode steps quantize against
them and ``flash_decode`` dequantizes on use. :func:`quantize_kv` and
:func:`kv_head_scales` are the one definition of the int8 rounding shared
by the pools' prefill writes and the transformer's decode-step writes
(the paged pool's per-page scales included), so both land the same int8
bytes as the JAX package on the same f32 inputs.

Under a serving mesh (``place``, a ``parallel.mesh.MeshPlace``) the host
bookkeeping — leases, the free list, the deferred frees — is the same on
every rank and counts every slot, while the device holds the rank's
shard: ``data`` rank ``r`` keeps slot rows ``[r·S/d, (r+1)·S/d)`` and the
kv heads its ``model`` rank reads (the split forward's, from the graph's
geometry), the int8 scales sharded like the dimensions they index. A
write to a slot another data rank owns is that rank's to make: here it
changes the host state only.
"""

from __future__ import annotations

import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.generate import cache_geometry

#: headroom multiplied onto the prefill amax when fixing an int8
#: quantization scale: decode steps quantize with the SAME scale (a
#: per-step rescale would invalidate already-written int8 rows), so the
#: margin absorbs decode K/V drifting above the prompt's range; values
#: beyond it saturate at ±127
KV_SCALE_MARGIN = 1.5
#: the factor JAX multiplies the amax by, rounded to f32 as JAX's weakly
#: typed constant is: the f32 product then rounds exactly as JAX's
_SCALE_FACTOR = torch.tensor(KV_SCALE_MARGIN / 127.0,
                             dtype=torch.float32).item()

VALID_KV_DTYPES = ("bf16", "int8")


def validate_kv_dtype(kv_dtype: str, geometry: dict) -> None:
    """Shared pool-level contract for ``kv_dtype`` (dense and paged
    pools): the flag must name a supported dtype, and int8 requires an
    even head_dim (the JAX package's int8 kernel tile packs lanes
    pairwise; the port keeps the contract, so both packages take the
    same models)."""
    if kv_dtype not in VALID_KV_DTYPES:
        raise FriendlyError(
            f"kv_dtype must be one of {VALID_KV_DTYPES}, got "
            f"{kv_dtype!r}"
        )
    if kv_dtype == "int8":
        for name, (hk, d) in geometry.items():
            if d % 2:
                raise FriendlyError(
                    f"kv_dtype='int8' requires an even head_dim (the "
                    f"int8 decode contract), but block '{name}' has "
                    f"head_dim {d}. Use kv_dtype='bf16' or an even "
                    f"d_model/heads split"
                )


def quantize_kv(values, scales):
    """Symmetric int8 quantization of K/V ``values`` (..., hk, d) with
    per-kv-head ``scales`` broadcastable over (..., hk); out-of-range
    values saturate at ±127. ``torch.round`` rounds half to even, like
    ``jnp.round``."""
    q = torch.round(values.float() / scales[..., None])
    return q.clamp(-127, 127).to(torch.int8)


def kv_head_scales(values, axes) -> torch.Tensor:
    """Per-kv-head f32 quantization scales from the amax of ``values``
    over ``axes`` (every dim but the kv-head dim), with the
    ``KV_SCALE_MARGIN`` headroom and a 1.0 floor substituted for
    all-zero heads (a zero scale would divide by zero; scale 1.0 maps
    zeros to zeros exactly)."""
    amax = values.float().abs().amax(dim=axes)
    scale = amax * _SCALE_FACTOR
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def check_slot_split(slots: int, place) -> int:
    """The mesh's ``data`` size (1 without a mesh); raises unless it
    divides ``slots``."""
    data = place.data_size if place is not None else 1
    if slots % data:
        raise FriendlyError(
            f"slots ({slots}) must be a multiple of the mesh's 'data' axis "
            f"({data}): each data rank holds slots/data whole slot rows of "
            "every K/V buffer. Round slots up (free slots are natural pad "
            "rows: dead on the device) or shrink the axis"
        )
    return data


class SlotCachePool:
    """Preallocated per-block K/V buffers with slot lease/free accounting.

    ``buffers`` is ``{block: (K, V)}`` with each tensor
    ``(slots, cache_len, hk, d)`` bf16 on ``device``, or, with
    ``kv_dtype="int8"``, ``{block: (K, V, k_scale, v_scale)}``: int8 K/V
    and (slots, hk) f32 scales (1.0 while a slot is free). The pool also
    owns the DEVICE-resident per-slot decode state that the fused decode
    block advances between host syncs: ``positions`` ((S,) int32, each
    slot's next write position) and ``live`` ((S,) bool, True = active
    tenant). Free-slot convention: (pos 0, dead). Every buffer and both
    state vectors keep their addresses for the pool's life: the engine's
    captured programs read and write them in place (the decode program
    advances ``positions`` and ``live`` from the block's outputs).
    """

    def __init__(self, graph, variables, slots: int, cache_len: int, *,
                 device, kv_dtype: str = "bf16", place=None):
        if slots < 1:
            raise FriendlyError(f"slots must be >= 1, got {slots}")
        data = check_slot_split(slots, place)
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
        validate_kv_dtype(kv_dtype, geometry)
        self.kv_dtype = kv_dtype
        self.device = torch.device(device)
        self.num_slots = slots
        self.cache_len = cache_len
        #: this rank's slot rows: ``[slot_base, slot_base + local_slots)``
        self.local_slots = slots // data
        self.slot_base = (place.data_index if place is not None
                          else 0) * self.local_slots
        local = self.local_slots
        quantized = kv_dtype == "int8"
        store = torch.int8 if quantized else torch.bfloat16
        # K, V (and the two scale tensors) are DISTINCT tensors: the
        # decode step writes each in place
        self.buffers = {}
        for name, (hk, d) in geometry.items():
            entry = tuple(
                torch.zeros((local, cache_len, hk, d), dtype=store,
                            device=self.device)
                for _ in range(2)
            )
            if quantized:
                entry += tuple(
                    torch.ones((local, hk), dtype=torch.float32,
                               device=self.device)
                    for _ in range(2)
                )
            self.buffers[name] = entry
        # LIFO free list popping the lowest id first keeps slot
        # assignment deterministic for the parity tests
        self._free = list(range(slots - 1, -1, -1))
        self._leased: set[int] = set()
        # the deferred-free window (the async engine): the dispatch
        # generation frees are stamped with while it is open, and the
        # (generation, slot) frees waiting for their block's fetch
        self._defer_gen: int | None = None
        self._deferred: list[tuple[int, int]] = []
        self._deferred_slots: set[int] = set()
        self.positions = torch.zeros((local,), dtype=torch.int32,
                                     device=self.device)
        self.live = torch.zeros((local,), dtype=torch.bool,
                                device=self.device)

    def local_row(self, slot: int) -> int | None:
        """``slot``'s row in this rank's buffers, or None when another
        data rank holds it."""
        row = slot - self.slot_base
        return row if 0 <= row < self.local_slots else None

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def leased_count(self) -> int:
        return len(self._leased)

    def leased_slots(self) -> list[int]:
        """Leased slot ids, ascending — what the engine's kill-parking
        walks to return every held slot deterministically."""
        return sorted(self._leased)

    @property
    def utilization(self) -> float:
        """The share of the pool's slots leased."""
        return len(self._leased) / self.num_slots

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

    def defer_frees(self, gen: int) -> None:
        """Open (or advance) a deferred-free window: until
        :meth:`flush_frees` passes ``gen``, a freed slot resets its device
        row state at once but stays OFF the free list — no new lease can
        collide with a decode block dispatched before the free (the async
        engine's protection of a row still in flight)."""
        self._defer_gen = gen

    def flush_frees(self, completed_gen: int | None = None) -> None:
        """Return every deferred slot whose stamped dispatch generation is
        ``<= completed_gen`` (all of them when None) to the free list, and
        close the window when None."""
        if completed_gen is None:
            self._defer_gen = None
        keep = []
        for gen, slot in self._deferred:
            if completed_gen is None or gen <= completed_gen:
                self._deferred_slots.discard(slot)
                self._leased.discard(slot)
                self._free.append(slot)
            else:
                keep.append((gen, slot))
        self._deferred = keep

    def free(self, slot: int) -> None:
        if slot not in self._leased or slot in self._deferred_slots:
            raise FriendlyError(
                f"slot {slot} is not leased (double free, or never "
                f"leased from this pool of {self.num_slots})"
            )
        if self._defer_gen is not None:
            self._deferred.append((self._defer_gen, slot))
            self._deferred_slots.add(slot)
        else:
            self._leased.remove(slot)
            self._free.append(slot)
        # restore the free-slot convention (pos 0, dead) so the fused
        # decode block keeps this row's writes at position 0 and its
        # flash-decode length reads as zero. The writes go on the
        # engine's one stream after any block in flight, which keeps the
        # row state it was dispatched with
        row = self.local_row(slot)
        if row is None:
            return
        self.positions[row] = 0
        self.live[row] = False
        if self.kv_dtype == "int8":
            # the slot's scales go back to the 1.0 init: a freed lease
            # must not leak its calibration into the next tenant
            for _k, _v, ks, vs in self.buffers.values():
                ks[row] = 1.0
                vs[row] = 1.0

    def write_prefill(self, slot: int, prefill_cache: dict,
                      length: int, start: int = 0) -> None:
        """Copy a batch-1 prefill cache (valid K/V for positions
        ``[0, length)``) into positions ``[start, length)`` of the slot's
        row, in place, and mark the slot live with its first decode
        write at ``length``. The int8 mode fixes the slot's scales from
        the whole prompt, so it takes ``start=0`` only."""
        if slot not in self._leased:
            raise FriendlyError(f"slot {slot} is not leased")
        if not 1 <= length <= self.cache_len:
            raise FriendlyError(
                f"prefill length {length} must lie in [1, cache_len "
                f"{self.cache_len}]"
            )
        if not 0 <= start < length:
            raise FriendlyError(
                f"write_prefill start {start} must lie in [0, length "
                f"{length})"
            )
        quantized = self.kv_dtype == "int8"
        if quantized and start:
            # a lease's int8 scales are FIXED from its whole-prompt amax
            # before the first decode dispatch; a partial write cannot
            # re-derive them without dequantizing the resident prefix
            raise FriendlyError(
                "dense int8 pools require start=0 writes: quantization "
                "scales are fixed per lease from the whole prompt "
                "(use the paged pool for resumable int8 fills)"
            )
        slot = self.local_row(slot)
        if slot is None:
            return
        for name, entry in self.buffers.items():
            ck, cv = prefill_cache[name][:2]
            if quantized:
                pk, pv, pks, pvs = entry
                ck0, cv0 = ck[0, :length], cv[0, :length]
                k_scl = kv_head_scales(ck0, axes=(0, 2))  # (hk,)
                v_scl = kv_head_scales(cv0, axes=(0, 2))
                pk[slot, :length].copy_(quantize_kv(ck0, k_scl))
                pv[slot, :length].copy_(quantize_kv(cv0, v_scl))
                pks[slot].copy_(k_scl)
                pvs[slot].copy_(v_scl)
            else:
                pk, pv = entry
                pk[slot, start:length].copy_(ck[0, start:length])
                pv[slot, start:length].copy_(cv[0, start:length])
        self.positions[slot] = length
        self.live[slot] = True

    def device_bytes_per_device(self) -> int:
        """KV-pool bytes resident on the device: every buffer (int8 scales
        included) plus the per-slot position/live state — this rank's
        shard under a mesh."""
        tensors = [t for entry in self.buffers.values() for t in entry]
        tensors += [self.positions, self.live]
        return int(sum(t.numel() * t.element_size() for t in tensors))
