"""Paged KV-cache pool — the port of ``mmlspark_tpu/serve/paging.py`` on
one device.

``SlotCachePool`` reserves the worst case: one dense ``(slots, cache_len,
Hkv, D)`` slab per block, every slot paying for ``cache_len`` positions
however short its request is, and identical prompt prefixes prefilled per
request. :class:`PagedCachePool` keeps the device tensors fixed-shape
while a HOST-side allocator re-maps which physical pages each slot's
logical positions live in.

Layout per transformer block::

    K, V : (num_pages, Hkv, page_size, D)  bf16 or int8  page stores
    PT   : (slots, max_pages)              int32         page table

``max_pages = cache_len // page_size``. A slot's logical position ``p``
lives in page ``PT[slot, p // page_size]`` at offset ``p % page_size``.
Each page holds one contiguous ``(page_size, D)`` face per kv head, which
the paged decode kernel (``csrc/paged_flash_decode.cu``) reads in one
walk.

Host-side accounting:

- a FREE LIST with refcounts — a page is owned by one slot (refcount 1)
  or SHARED between slots and the prefix cache (refcount > 1);
- physical page 0 is a reserved TRASH page, never allocated: a freed
  slot's page-table row points every entry at it, so the fused decode
  block's fixed-shape writes for dead rows land in a page nothing reads
  (dead rows decode with live length 0);
- a PREFIX CACHE keyed on the prompt: a completed prefill registers its
  pages under its prompt, and a later prompt sharing a prefix maps those
  pages instead of recomputing them — COPY-ON-EXTEND, a slot privatizes
  a shared page only when its write frontier enters it. Page pressure
  evicts least-recently-used entries first; if the free list is still
  empty the allocator raises
  :class:`~mmlspark_tpu_torch.core.faults.ResourceExhausted`.

Device-state discipline: host bookkeeping mutates only BETWEEN decode
block dispatches. ``ServeEngine`` calls :meth:`ensure_decode_pages`
before each block so every page the block can write is mapped and private
up front, and the page table reaches the device before the block runs: a
copy of the host mirror staged in a fresh pinned buffer, enqueued on the
engine's stream (no host sync, and the mirror may change right after).
Every device write the pool makes — the table, page copies, prefill
scatters, the per-slot state — is ordered on that one stream behind any
block already in flight, so an in-flight block keeps the table it was
dispatched with. The async engine's DEFERRED FREES (:meth:`defer_frees`)
point a freed slot's row at the trash page at once but drop its pages'
refcounts only at :meth:`flush_frees`, after the block in flight has been
fetched.

Where the JAX package differs, and why: it threads the pool functionally
and DONATES it to the decode program, and donation forbids aliased
leaves, so every block carries its own device copy of the page table and
page copies are per-block functional updates. The port updates in place:
ONE device page table serves every block (each block's entry holds the
same tensor), and a copy-on-extend is ``pk[dst].copy_(pk[src])``.

Not ported: mesh shards (one data shard here; ROADMAP.md Queue 1 item
13).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import host_to_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import ResourceExhausted
from mmlspark_tpu_torch.models.generate import cache_geometry
from mmlspark_tpu_torch.ops.flash_attention import MIN_PAGE_SIZE
from mmlspark_tpu_torch.serve.cache_pool import (
    kv_head_scales,
    quantize_kv,
    validate_kv_dtype,
)

#: the reserved page that absorbs dead rows' writes
TRASH_PAGE = 0


def default_page_size(cache_len: int) -> int:
    """Smallest multiple of ``MIN_PAGE_SIZE`` in [8, cache_len] dividing
    ``cache_len``: small pages maximize how much of the pool short
    requests leave free. Raises at build time when ``cache_len`` admits
    no such page size."""
    for cand in range(MIN_PAGE_SIZE, cache_len + 1, MIN_PAGE_SIZE):
        if cache_len % cand == 0:
            return cand
    raise FriendlyError(
        f"cache_len ({cache_len}) has no page size that is a multiple "
        f"of {MIN_PAGE_SIZE} (the paged pool's page unit) and divides it "
        f"evenly; round cache_len to a multiple of {MIN_PAGE_SIZE} to "
        "serve paged"
    )


@dataclasses.dataclass
class _PrefixEntry:
    """One cached prompt prefill: the prompt that produced it, and the
    physical pages holding its K/V (refcounted — the entry itself holds
    one reference per page)."""

    prompt: np.ndarray          # (P,) int32
    length: int                 # P — positions [0, P) are valid
    pages: list[int]            # physical pages covering [0, P)
    last_used: int              # monotonic use counter (LRU eviction)


class PagedCachePool:
    """Drop-in replacement for ``SlotCachePool`` backed by paged storage.
    Same engine-facing surface (``lease``/``free``/``write_prefill``/
    ``buffers``/``positions``/``live``/``device_bytes_per_device``), plus
    the paging plane: :meth:`ensure_decode_pages`, the prefix-cache trio
    (:meth:`prefix_lookup` / :meth:`map_prefix` + :meth:`gather_prefix`
    / :meth:`prefix_insert`), :meth:`paging_stats` and
    :meth:`refcount_audit`.

    ``buffers`` is ``{block: (K, V, PT)}``, which
    ``models/transformer.py`` recognizes as the paged cache.
    ``kv_dtype="int8"`` stores int8 page faces — half the bf16 store's
    bytes — and each entry grows to ``(K, V, PT, k_scale, v_scale)`` with
    (num_pages, Hkv) f32 PER-PAGE scales: a page's scale is fixed at its
    FIRST write (prefill slice amax, or the first decode token's amax, +
    headroom), later writes into the page quantize against it, and
    copy-on-extend copies it with the page.

    The page stores, the one device page table (refreshed by an in-place
    copy from its host mirror), ``positions`` and ``live`` keep their
    addresses for the pool's life: the engine's captured decode program
    reads them there, and advances ``positions`` and ``live`` in place.
    :meth:`gather_prefix` returns fixed ``(1, cache_len, Hkv, D)``
    caches, the resume program's static inputs.
    """

    def __init__(self, graph, variables, slots: int, cache_len: int, *,
                 device, page_size: int | None = None,
                 num_pages: int | None = None,
                 prefix_cache: bool = False, kv_dtype: str = "bf16"):
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
        if page_size is None:
            page_size = default_page_size(cache_len)
        if page_size < MIN_PAGE_SIZE:
            raise FriendlyError(
                f"page_size must be >= {MIN_PAGE_SIZE} (the paged pool's "
                f"page unit), got {page_size}"
            )
        if page_size % MIN_PAGE_SIZE:
            raise FriendlyError(
                f"page_size ({page_size}) must be a multiple of "
                f"{MIN_PAGE_SIZE}: paged_flash_decode takes whole "
                "8-position page units and rejects ragged pages"
            )
        if cache_len % page_size:
            raise FriendlyError(
                f"page_size ({page_size}) must divide cache_len "
                f"({cache_len}): a slot's logical positions tile into "
                "whole pages"
            )
        validate_kv_dtype(kv_dtype, geometry)
        self.kv_dtype = kv_dtype
        self.device = torch.device(device)
        self.num_slots = slots
        self.cache_len = cache_len
        self.page_size = page_size
        self.max_pages = cache_len // page_size
        if num_pages is None:
            # worst case: every slot fully paged, plus the trash page —
            # a budget that can never exhaust. Callers size it DOWN to
            # realize the memory win.
            num_pages = slots * self.max_pages + 1
        if num_pages < 2:
            raise FriendlyError(
                f"num_pages ({num_pages}) leaves no allocatable page; the "
                "pool needs its reserved trash page plus at least one "
                "allocatable page"
            )
        self.num_pages = num_pages
        self.prefix_cache_enabled = bool(prefix_cache)

        # -- host allocator state --------------------------------------
        # page table mirror: every entry starts at the trash page, so
        # unmapped (and freed) rows absorb the fused block's fixed-shape
        # writes without touching a live page
        self._pt_host = np.full((slots, self.max_pages), TRASH_PAGE,
                                np.int32)
        #: logical pages currently mapped per slot (contiguous [0, n))
        self._npages = [0] * slots
        self._refcount = np.zeros((num_pages,), np.int64)
        # LIFO free list popping the lowest page id first (the slot
        # pool's determinism convention); the trash page never enters it
        self._free_pages = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._pt_dirty = False

        # -- prefix cache ----------------------------------------------
        #: prompt bytes -> entry
        self._prefix: dict[bytes, _PrefixEntry] = {}
        self._use_counter = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.prefix_evictions = 0
        self.cow_copies = 0

        # -- device tensors --------------------------------------------
        quantized = kv_dtype == "int8"
        store = torch.int8 if quantized else torch.bfloat16
        #: the ONE device page table every block's entry holds
        self.page_table = torch.from_numpy(self._pt_host.copy()).to(
            self.device)
        self.buffers = {}
        for name, (hk, d) in geometry.items():
            k, v = (
                torch.zeros((num_pages, hk, page_size, d), dtype=store,
                            device=self.device)
                for _ in range(2)
            )
            entry = (k, v, self.page_table)
            if quantized:
                entry += tuple(
                    torch.ones((num_pages, hk), dtype=torch.float32,
                               device=self.device)
                    for _ in range(2)
                )
            self.buffers[name] = entry
        self._free = list(range(slots - 1, -1, -1))
        self._leased: set[int] = set()
        # the deferred-free window: the stamp of frees while it is open,
        # and the (generation, slot, held pages) frees awaiting a fetch
        self._defer_gen: int | None = None
        self._deferred: list[tuple[int, int, list[int]]] = []
        self._deferred_slots: set[int] = set()
        self.positions = torch.zeros((slots,), dtype=torch.int32,
                                     device=self.device)
        self.live = torch.zeros((slots,), dtype=torch.bool,
                                device=self.device)

    # -- page allocator ----------------------------------------------------

    def _alloc_page(self) -> int:
        if not self._free_pages:
            self._evict_prefix_entries()
        if not self._free_pages:
            raise ResourceExhausted(
                f"page allocator exhausted: all {self.pages_allocatable} "
                "allocatable pages are mapped and the prefix cache has "
                "nothing left to evict"
            )
        page = self._free_pages.pop()
        self._refcount[page] = 1
        return page

    def _decref(self, page: int) -> None:
        rc = int(self._refcount[page])
        if rc <= 0:
            raise FriendlyError(
                f"page {page} refcount underflow (double free: the page "
                "is not mapped by any slot or prefix entry)"
            )
        rc -= 1
        self._refcount[page] = rc
        if rc == 0:
            self._free_pages.append(page)

    def _evict_prefix_entries(self) -> None:
        """Free-list pressure valve: drop least-recently-used prefix
        entries until a page is free (or no entry is left). Pages still
        mapped by active slots survive their entry's eviction — the
        refcount only reaches zero once the last slot frees too."""
        while not self._free_pages and self._prefix:
            key = min(self._prefix, key=lambda k: self._prefix[k].last_used)
            entry = self._prefix.pop(key)
            for page in entry.pages:
                self._decref(page)
            self.prefix_evictions += 1

    def _ensure_writable(self, slot: int, start: int, stop: int) -> None:
        """Map — and privatize — the logical pages covering positions
        ``[start, stop)`` of ``slot``: allocate unmapped pages and
        COPY-ON-EXTEND shared ones (refcount > 1: the slot's write
        frontier entered a prefix-cache page). Raises
        :class:`ResourceExhausted` under page pressure; pages mapped
        before the failure stay accounted to the slot, so a later
        ``free`` releases them."""
        if stop <= start:
            return
        first_pg = start // self.page_size
        last_pg = (stop - 1) // self.page_size
        for pg in range(min(self._npages[slot], first_pg), last_pg + 1):
            if pg >= self._npages[slot]:
                self._pt_host[slot, pg] = self._alloc_page()
                self._npages[slot] = pg + 1
                self._pt_dirty = True
            elif pg >= first_pg:
                phys = int(self._pt_host[slot, pg])
                if int(self._refcount[phys]) > 1:
                    # copy-on-extend: privatize before the write lands
                    page = self._alloc_page()
                    self._copy_page(phys, page)
                    self._decref(phys)
                    self._pt_host[slot, pg] = page
                    self._pt_dirty = True
                    self.cow_copies += 1

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page, in place — with its int8 scales, or
        the copied values would decode through the wrong multipliers."""
        for pk, pv, _pt, *scales in self.buffers.values():
            pk[dst].copy_(pk[src])
            pv[dst].copy_(pv[src])
            for s in scales:
                s[dst].copy_(s[src])

    def _commit_pt(self) -> None:
        """Copy the host page table to the device, in place: a copy of the
        mirror staged in a fresh pinned buffer (the mirror is mutated
        again right after), enqueued without a host sync."""
        if not self._pt_dirty:
            return
        self.page_table.copy_(host_to_device(self._pt_host.copy(),
                                             self.device))
        self._pt_dirty = False

    # -- accounting --------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def leased_count(self) -> int:
        return len(self._leased)

    def leased_slots(self) -> list[int]:
        """Leased slot ids, ascending — what the engine's kill-parking
        walks to return every held slot (and its page mappings)
        deterministically."""
        return sorted(self._leased)

    @property
    def pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def pages_allocatable(self) -> int:
        """Capacity net of the reserved trash page."""
        return self.num_pages - 1

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
        """Open (or advance) a deferred-free window — see
        ``SlotCachePool.defer_frees``. The paged split: a freed slot's
        PAGE-TABLE row points at the trash page at once (so the next
        dispatch's dead-row writes are absorbed, as after a synchronous
        free), but its pages' refcounts drop only at :meth:`flush_frees` —
        the block already in flight writes through the table it was
        dispatched with, so its frontier page must stay owned until that
        block has been fetched."""
        self._defer_gen = gen

    def flush_frees(self, completed_gen: int | None = None) -> None:
        """Decref the held pages and return the slot for every deferred
        free whose stamped generation is ``<= completed_gen`` (all when
        None, which also closes the window)."""
        if completed_gen is None:
            self._defer_gen = None
        keep = []
        for gen, slot, pages in self._deferred:
            if completed_gen is None or gen <= completed_gen:
                self._deferred_slots.discard(slot)
                self._leased.discard(slot)
                self._free.append(slot)
                for pg in pages:
                    self._decref(pg)
            else:
                keep.append((gen, slot, pages))
        self._deferred = keep

    def free(self, slot: int) -> None:
        if slot not in self._leased or slot in self._deferred_slots:
            raise FriendlyError(
                f"slot {slot} is not leased (double free, or never "
                f"leased from this pool of {self.num_slots})"
            )
        if self._defer_gen is not None:
            # hold the refcounts, retarget the table: the deferred entry
            # keeps the pages alive past the block in flight, while the
            # trash-pointing row reaches every LATER dispatch
            pages = [int(self._pt_host[slot, pg])
                     for pg in range(self._npages[slot])]
            self._deferred.append((self._defer_gen, slot, pages))
            self._deferred_slots.add(slot)
            if self._npages[slot]:
                self._pt_host[slot, :] = TRASH_PAGE
                self._npages[slot] = 0
                self._pt_dirty = True
        else:
            self._leased.remove(slot)
            self._free.append(slot)
            self._release_mappings(slot)
        self._commit_pt()
        self.positions[slot] = 0
        self.live[slot] = False

    def _release_mappings(self, slot: int) -> None:
        """Unmap every logical page of ``slot``: decref (pages shared
        with the prefix cache or other slots survive; exclusive ones
        return to the free list) and point the row back at the trash
        page."""
        if not self._npages[slot]:
            return
        for pg in range(self._npages[slot]):
            self._decref(int(self._pt_host[slot, pg]))
        self._pt_host[slot, :] = TRASH_PAGE
        self._npages[slot] = 0
        self._pt_dirty = True

    # -- data path ---------------------------------------------------------

    def write_prefill(self, slot: int, prefill_cache: dict, length: int,
                      start: int = 0) -> None:
        """Scatter a batch-1 LINEAR cache's positions ``[start, length)``
        into the slot's pages (allocating/privatizing them as needed) and
        mark the slot live at write frontier ``length``. ``start > 0`` is
        the prefix-cache resume path: positions ``[0, start)`` are
        already mapped to shared pages and only the remainder lands —
        the first write into a shared partial page is where
        copy-on-extend fires."""
        if slot not in self._leased:
            raise FriendlyError(f"slot {slot} is not leased")
        if length > self.cache_len:
            raise FriendlyError(
                f"prefill length {length} exceeds the pool's cache_len "
                f"{self.cache_len}"
            )
        if not 0 <= start < length:
            raise FriendlyError(
                f"prefill start ({start}) must lie in [0, length="
                f"{length})"
            )
        self._ensure_writable(slot, start, length)
        ps = self.page_size
        pos = np.arange(start, length)
        pages = host_to_device(
            self._pt_host[slot, pos // ps].astype(np.int64), self.device)
        offs = host_to_device(pos % ps, self.device)
        quantized = self.kv_dtype == "int8"
        for name, (pk, pv, _pt, *scales) in self.buffers.items():
            ck, cv = prefill_cache[name][:2]
            idx = (pages[:, None],
                   torch.arange(pk.shape[1], device=self.device)[None, :],
                   offs[:, None])
            if quantized:
                ks, vs = scales
                # per-page scales are fixed at each page's FIRST write: a
                # page is fresh here iff its first logical position is
                # at or past ``start`` — the resume path's shared partial
                # page keeps its registered scale (its written half
                # dequantizes through it), and the remainder saturates
                # into the budget instead
                k_rows, v_rows = [], []
                for pg in range(start // ps, (length - 1) // ps + 1):
                    lo, hi = max(pg * ps, start), min((pg + 1) * ps, length)
                    sk, sv = ck[0, lo:hi].float(), cv[0, lo:hi].float()
                    page = int(self._pt_host[slot, pg])
                    if pg * ps >= start:
                        ks[page] = kv_head_scales(sk, axes=(0, 2))
                        vs[page] = kv_head_scales(sv, axes=(0, 2))
                    k_rows.append(quantize_kv(sk, ks[page]))
                    v_rows.append(quantize_kv(sv, vs[page]))
                pk.index_put_(idx, torch.cat(k_rows))
                pv.index_put_(idx, torch.cat(v_rows))
            else:
                pk.index_put_(idx, ck[0, start:length].to(pk.dtype))
                pv.index_put_(idx, cv[0, start:length].to(pv.dtype))
        self._commit_pt()
        self.positions[slot] = length
        self.live[slot] = True

    def ensure_decode_pages(self, positions: dict[int, int],
                            t_block: int) -> None:
        """Pre-map every page the next fused decode block can write:
        slot ``s`` at frontier ``p`` writes positions ``[p, p +
        t_block)`` (clipped to ``cache_len``). Called by the engine
        BEFORE the dispatch: the page table is read-only while the block
        runs."""
        for slot, pos in positions.items():
            if slot in self._leased:
                self._ensure_writable(
                    slot, pos, min(pos + t_block, self.cache_len))
        self._commit_pt()

    # -- prefix cache ------------------------------------------------------

    def prefix_lookup(self, seq, bucket_fn):
        """Best reusable prefix for ``seq``: the cached entry sharing the
        longest common prefix, trimmed to ``keep`` positions such that
        (a) at least one remainder token is left to prefill (its logits
        seed decode), and (b) the remainder's padded bucket still fits
        the linear resume cache (``keep + bucket_fn(len - keep) <=
        cache_len``). Returns ``(entry, keep)`` or None when nothing
        covers at least one page. (The JAX pool's ``slot`` argument
        breaks ties between data shards; one device has one shard.)"""
        if not self._prefix:
            return None
        seq = np.asarray(seq, np.int32)
        best, best_c = None, 0
        for entry in self._prefix.values():
            m = min(int(seq.size), entry.length)
            if m < best_c:
                continue
            neq = np.nonzero(seq[:m] != entry.prompt[:m])[0]
            c = int(neq[0]) if neq.size else m
            if c > best_c:
                best, best_c = entry, c
        keep = min(best_c, int(seq.size) - 1)
        while (
            keep >= self.page_size
            and keep + bucket_fn(int(seq.size) - keep) > self.cache_len
        ):
            keep -= 1
        if best is None or keep < self.page_size:
            return None
        return best, keep

    def map_prefix(self, slot: int, entry: _PrefixEntry,
                   keep: int) -> bool:
        """Map the entry's pages covering ``[0, keep)`` into ``slot``,
        SHARED (refcounts rise, nothing is copied — the prefix prefilled
        once). Any mappings the slot already holds are released first.

        Returns False — mapping nothing — when the entry is STALE
        (evicted since the lookup): mapping it could resurrect pages
        already on the free list, so the caller must fall back to a full
        prefill. A registered entry's own references pin every page
        above zero through the re-map."""
        if slot not in self._leased:
            raise FriendlyError(f"slot {slot} is not leased")
        if self._prefix.get(entry.prompt.tobytes()) is not entry:
            return False
        self._release_mappings(slot)
        n = -(-keep // self.page_size)  # ceil
        for i in range(n):
            phys = entry.pages[i]
            self._refcount[phys] += 1
            self._pt_host[slot, i] = phys
        self._npages[slot] = n
        self._pt_dirty = True
        self._use_counter += 1
        entry.last_used = self._use_counter
        self.prefix_hits += 1
        self.prefix_tokens_saved += keep
        self._commit_pt()
        return True

    def gather_prefix(self, entry: _PrefixEntry, keep: int) -> dict:
        """Linearize the entry's first ``keep`` positions into fresh
        ``(1, cache_len, Hkv, D)`` bf16 caches — the resume prefill's
        input (the transformer's scalar-pos prefill path wants a linear
        cache; the paged layout is a decode-side format). int8 pages
        dequantize through their per-page scales."""
        n = -(-keep // self.page_size)
        idx = host_to_device(np.asarray(entry.pages[:n], np.int64),
                             self.device)
        out = {}
        for name, (pk, pv, _pt, *scales) in self.buffers.items():
            hk, d = pk.shape[1], pk.shape[3]
            lin = []
            for store, scl in zip((pk, pv), scales or (None, None)):
                g = store[idx]  # (n, hk, ps, d)
                if scl is not None:
                    g = g.float() * scl[idx][:, :, None, None]
                g = g.transpose(1, 2).reshape(n * self.page_size, hk, d)
                arr = torch.zeros((1, self.cache_len, hk, d),
                                  dtype=torch.bfloat16, device=self.device)
                arr[0, :keep] = g[:keep].to(torch.bfloat16)
                lin.append(arr)
            out[name] = tuple(lin)
        return out

    def prefix_insert(self, slot: int, seq) -> None:
        """Register ``slot``'s freshly prefilled pages under its prompt.
        The entry takes one reference per page, keeping the K/V alive
        after the slot retires; a prompt already cached is a no-op."""
        seq = np.asarray(seq, np.int32)
        if int(seq.size) < self.page_size:
            return  # can never satisfy a lookup's one-page minimum
        key = seq.tobytes()
        if key in self._prefix:
            return
        n = -(-int(seq.size) // self.page_size)
        pages = [int(self._pt_host[slot, i]) for i in range(n)]
        for page in pages:
            self._refcount[page] += 1
        self._use_counter += 1
        self._prefix[key] = _PrefixEntry(
            prompt=seq.copy(), length=int(seq.size), pages=pages,
            last_used=self._use_counter,
        )

    # -- accounting for telemetry ------------------------------------------

    def device_bytes_per_device(self) -> int:
        """Pool bytes resident on the device: page stores, int8 scales,
        the one page table and the per-slot state. Below the dense
        pool's reservation whenever ``num_pages < slots * max_pages``."""
        tensors = {id(t): t for entry in self.buffers.values()
                   for t in entry}
        tensors[id(self.positions)] = self.positions
        tensors[id(self.live)] = self.live
        return int(sum(t.numel() * t.element_size()
                       for t in tensors.values()))

    def paging_stats(self) -> dict:
        """The paging plane's metric keys, under the JAX names."""
        allocatable = self.pages_allocatable
        free = self.pages_free
        return {
            "page_size": int(self.page_size),
            "pages_total": int(self.num_pages),
            "pages_free": int(free),
            "page_utilization": (
                round((allocatable - free) / allocatable, 4)
                if allocatable else None
            ),
            "prefix_cache_hits_total": int(self.prefix_hits),
            "prefix_cache_entries": len(self._prefix),
            "cow_copies_total": int(self.cow_copies),
            "prefix_tokens_saved_total": int(self.prefix_tokens_saved),
        }

    def snapshot(self) -> dict:
        """JSON-able paging state under the JAX package's keys: page
        table, refcounts, prefix-cache entries. Informational in a
        restore (the engine re-prefills every request and rebuilds the
        mappings), but it keeps a crash dump auditable."""
        return {
            "kv_dtype": self.kv_dtype,
            "page_size": int(self.page_size),
            "num_pages": int(self.num_pages),
            "max_pages": int(self.max_pages),
            "page_table": self._pt_host.tolist(),
            "npages": list(self._npages),
            "refcounts": [int(x) for x in self._refcount],
            "prefix_entries": [
                {
                    "prompt": e.prompt.tolist(),
                    "length": e.length,
                    "pages": list(e.pages),
                    "last_used": e.last_used,
                }
                for e in self._prefix.values()
            ],
            "prefix_cache_hits_total": int(self.prefix_hits),
            "prefix_tokens_saved_total": int(self.prefix_tokens_saved),
            "cow_copies_total": int(self.cow_copies),
        }

    def refcount_audit(self) -> tuple[int, int]:
        """``(refcount_total, mapped_references)`` — the allocator's
        conservation law: every unit of refcount is owned by exactly one
        mapping, a slot page-table entry (``npages`` per slot) or a
        prefix-cache entry's page list. A leak shows as a difference."""
        refcount_total = int(self._refcount.sum())
        mapped = sum(self._npages) + sum(
            len(e.pages) for e in self._prefix.values()
        )
        return refcount_total, int(mapped)
