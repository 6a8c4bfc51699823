"""Serving observability: queue depth, time-to-first-token, per-token
latency, slot utilization, throughput — a trimmed port of
``mmlspark_tpu/serve/metrics.py``.

It keeps the keys the demo prints, under the JAX package's names, with
the log-bucketed histogram of :mod:`mmlspark_tpu_torch.core.telemetry`
for deterministic p50/p95/p99: the chunked-prefill and async-host figures
(chunk dispatches, overlapped dispatches, the host's wait in the block
fetch and ``host_idle_fraction``, its share of the ticks' wall time) and
the resilience plane's (faults, retries, quarantines, preemptions,
degradation, snapshots, cancels, snapshot checksum failures). The device
analytics, SLO monitor, hand-off counters and Prometheus exposition wait
for a later slice (ROADMAP.md Queue 1 item 12).

Tick-count figures (TTFT in ticks, queue depth) are deterministic given
the arrival schedule; wall-clock figures (TTFT ms, per-token ms,
tokens/sec) describe the host and device together and are only
meaningful from a run on the card.
"""

from __future__ import annotations

import time

from mmlspark_tpu_torch.core.telemetry import Histogram


def _mean(xs) -> float | None:
    xs = list(xs)
    return (sum(xs) / len(xs)) if xs else None


def _rnd(value: float | None, digits: int = 3) -> float | None:
    return round(value, digits) if value is not None else None


class ServeMetrics:
    def __init__(self, model: str, slots: int, decode_block: int = 1,
                 cache_pool_bytes_per_device: int = 0,
                 kv_dtype: str = "bf16", prefill_chunk: int = 0,
                 async_host: bool = False):
        self.model = model
        self.slots = slots
        self.decode_block = decode_block
        self.cache_pool_bytes_per_device = cache_pool_bytes_per_device
        self.kv_dtype = kv_dtype
        #: the chunk width (0 = monolithic prefill) and whether the
        #: pipelined async host loop is on
        self.prefill_chunk = prefill_chunk
        self.async_host = bool(async_host)
        #: the paged pool's ``paging_stats`` (attach_paging); None: a
        #: dense pool, whose paging keys report inert defaults
        self._paging_provider = None
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.expired = 0
        self.failed = 0
        self.stalled = 0
        self.tokens_generated = 0
        #: chunk dispatches (intermediate and final) and decode blocks
        #: dispatched while the previous block was still in flight
        self.chunked_prefills_total = 0
        self.overlapped_dispatches_total = 0
        #: host seconds spent BLOCKED fetching decode blocks — measured
        #: alike in sync and async mode, host_idle_fraction's numerator
        self.host_sync_wait_s = 0.0
        # the resilience plane
        self.retries_total = 0
        self.faults_injected_total = 0
        self.quarantined_total = 0
        self.preemptions_total = 0
        self.snapshots_total = 0
        self.snapshot_failures_total = 0
        self.cancelled_total = 0
        self.integrity_snapshot_checksum_failures_total = 0
        #: 1 while memory-pressure degradation holds the engine below its
        #: block-ladder top or admission cap
        self.degraded_mode = 0
        #: injected-fault count per kind
        self.faults_by_kind: dict[str, int] = {}
        self._ttft_ms = Histogram()
        self._per_token_ms = Histogram()
        self._tick_ms = Histogram()
        self.queue_depth_samples: list[int] = []
        self.util_samples: list[float] = []
        self.tick_tokens: list[int] = []
        self.tick_seconds: list[float] = []
        self.ttft_ticks: list[int] = []
        self.ttft_s: list[float] = []
        #: the request of each ``ttft_s`` entry
        self.ttft_req_ids: list[int] = []
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        # KV rows the length-aware decode read vs what a dense read over
        # the full cache_len would have touched for the same steps
        self.decode_live_kv = 0
        self.decode_dense_kv = 0
        #: prefill count per padded bucket length
        self.prefill_buckets: dict[str, int] = {}
        #: fused-block count per block size run (ladder usage)
        self.decode_blocks: dict[str, int] = {}
        self._t0: float | None = None
        self._t_last: float | None = None

    def _touch(self) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self._t_last = now

    def attach_paging(self, provider) -> None:
        """Wire the paged pool's ``paging_stats`` callable in;
        ``to_dict`` then reports live allocator / prefix-cache /
        copy-on-extend figures instead of the dense defaults."""
        self._paging_provider = provider

    def _paging_dict(self) -> dict:
        """The paging keys, ALWAYS present: dense engines report zeros
        (and ``page_utilization: None``)."""
        stats = (dict(self._paging_provider())
                 if self._paging_provider is not None else {})
        out = {
            key: int(stats.get(key, 0))
            for key in ("page_size", "pages_total", "pages_free",
                        "prefix_cache_hits_total", "prefix_cache_entries",
                        "cow_copies_total", "prefix_tokens_saved_total")
        }
        out["page_utilization"] = stats.get("page_utilization")
        return out

    def record_submit(self) -> None:
        self.submitted += 1
        self._touch()

    def record_reject(self) -> None:
        self.rejected += 1
        self._touch()

    def record_first_token(self, req, tick: int,
                           bucket: int | None = None) -> None:
        self.ttft_ticks.append(tick - req.submit_tick)
        ttft = time.perf_counter() - req.submit_wall
        self.ttft_s.append(ttft)
        self.ttft_req_ids.append(req.id)
        self._ttft_ms.record(ttft * 1e3)
        if bucket is not None:
            key = str(bucket)
            self.prefill_buckets[key] = self.prefill_buckets.get(key, 0) + 1

    def record_decode(self, seconds: float, tokens_emitted: int,
                      block: int, live_kv: int, cache_len: int) -> None:
        """One fused decode block: ``seconds`` of wall time that emitted
        ``tokens_emitted`` REAL tokens (per-token latency divides by
        those, not by slots times block size)."""
        self.decode_seconds += seconds
        self.decode_tokens += tokens_emitted
        if tokens_emitted:
            self._per_token_ms.record(seconds / tokens_emitted * 1e3)
        key = str(block)
        self.decode_blocks[key] = self.decode_blocks.get(key, 0) + 1
        self.decode_live_kv += live_kv
        self.decode_dense_kv += tokens_emitted * cache_len

    def record_finish(self, result) -> None:
        if result.status == "expired":
            self.expired += 1
        elif result.status == "failed":
            self.failed += 1
        elif result.status == "stalled":
            self.stalled += 1
        else:
            self.completed += 1
        self.tokens_generated += result.generated
        self._touch()

    def record_prefill_chunk(self) -> None:
        """One chunk dispatch of a chunked prefill (intermediate or
        final)."""
        self.chunked_prefills_total += 1

    def record_overlapped_dispatch(self) -> None:
        """One decode block dispatched while the previous block was still
        in flight (the async host loop's pipelining hit)."""
        self.overlapped_dispatches_total += 1

    def record_host_sync(self, seconds: float) -> None:
        """Host seconds spent blocked in one decode block's fetch."""
        self.host_sync_wait_s += max(0.0, seconds)

    def record_fault(self, kind: str) -> None:
        """One injected fault (the injector's listener calls this)."""
        self.faults_injected_total += 1
        self.faults_by_kind[kind] = self.faults_by_kind.get(kind, 0) + 1

    def record_retry(self) -> None:
        """One dispatch retry the backoff loop absorbed."""
        self.retries_total += 1

    def record_quarantine(self) -> None:
        """One request retired as ``"failed"`` by fault handling."""
        self.quarantined_total += 1

    def record_preemption(self) -> None:
        """One active request evicted and requeued under memory
        pressure."""
        self.preemptions_total += 1

    def record_snapshot(self) -> None:
        """One periodic checkpoint written completely."""
        self.snapshots_total += 1

    def record_snapshot_failure(self) -> None:
        """One checkpoint that failed mid-write (not restorable — the
        engine keeps the previous complete snapshot)."""
        self.snapshot_failures_total += 1

    def record_integrity_snapshot_failure(self) -> None:
        """One snapshot rejected at restore because its stamped checksum
        did not re-hash."""
        self.integrity_snapshot_checksum_failures_total += 1

    def record_cancel(self) -> None:
        """One pending request cancelled without a terminal result."""
        self.cancelled_total += 1

    def set_degraded(self, degraded: bool) -> None:
        self.degraded_mode = int(degraded)

    def sample_tick(self, queue_depth: int, leased: int, seconds: float,
                    tokens_emitted: int = 0) -> None:
        """One scheduler tick; ``tokens_emitted`` is the REAL token count
        it produced (first tokens + the decode block's consumed
        tokens)."""
        self.queue_depth_samples.append(queue_depth)
        self.util_samples.append(leased / self.slots)
        self.tick_tokens.append(tokens_emitted)
        self.tick_seconds.append(seconds)
        self._tick_ms.record(seconds * 1e3)
        self._touch()

    def to_dict(self) -> dict:
        wall = (
            (self._t_last - self._t0)
            if self._t0 is not None and self._t_last is not None
            else 0.0
        )
        per_tok = (
            self.decode_seconds / self.decode_tokens
            if self.decode_tokens else None
        )
        tick_s = sum(self.tick_seconds)
        return {
            "model": self.model,
            "slots": self.slots,
            "ticks": len(self.tick_tokens),
            "submitted": self.submitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "expired": self.expired,
            "failed": self.failed,
            "stalled": self.stalled,
            "tokens_generated": self.tokens_generated,
            "queue_depth_mean": _mean(self.queue_depth_samples),
            "queue_depth_max": (
                max(self.queue_depth_samples)
                if self.queue_depth_samples else None
            ),
            "ttft_ticks_mean": _mean(self.ttft_ticks),
            "ttft_ms_mean": (
                round(_mean(self.ttft_s) * 1e3, 3) if self.ttft_s else None
            ),
            "ttft_ms_p50": _rnd(self._ttft_ms.percentile(50)),
            "ttft_ms_p95": _rnd(self._ttft_ms.percentile(95)),
            "ttft_ms_p99": _rnd(self._ttft_ms.percentile(99)),
            "per_token_ms": (
                round(per_tok * 1e3, 4) if per_tok is not None else None
            ),
            "per_token_ms_p50": _rnd(self._per_token_ms.percentile(50), 4),
            "per_token_ms_p95": _rnd(self._per_token_ms.percentile(95), 4),
            "per_token_ms_p99": _rnd(self._per_token_ms.percentile(99), 4),
            "tick_ms_p50": _rnd(self._tick_ms.percentile(50)),
            "tick_ms_p95": _rnd(self._tick_ms.percentile(95)),
            "tick_ms_p99": _rnd(self._tick_ms.percentile(99)),
            "slot_utilization_mean": (
                round(_mean(self.util_samples), 4)
                if self.util_samples else None
            ),
            "slot_utilization_peak": (
                round(max(self.util_samples), 4)
                if self.util_samples else None
            ),
            "tokens_per_sec": (
                round(self.tokens_generated / wall, 1) if wall > 0 else None
            ),
            "wall_s": round(wall, 4),
            "decode_live_kv_tokens": self.decode_live_kv,
            "decode_dense_kv_tokens": self.decode_dense_kv,
            "decode_flop_utilization": (
                round(self.decode_live_kv / self.decode_dense_kv, 4)
                if self.decode_dense_kv else None
            ),
            "prefill_buckets": dict(self.prefill_buckets),
            "prefill_chunk": self.prefill_chunk,
            "chunked_prefills_total": self.chunked_prefills_total,
            "async_host": int(self.async_host),
            "overlapped_dispatches_total": self.overlapped_dispatches_total,
            "host_sync_wait_s": round(self.host_sync_wait_s, 4),
            "host_idle_fraction": (
                round(min(1.0, self.host_sync_wait_s / tick_s), 4)
                if tick_s > 0 else None
            ),
            "decode_block": self.decode_block,
            "tokens_per_tick": (
                _rnd(_mean(self.tick_tokens)) if self.tick_tokens else 0.0
            ),
            "decode_blocks": dict(self.decode_blocks),
            "cache_pool_bytes_per_device": self.cache_pool_bytes_per_device,
            "kv_dtype": self.kv_dtype,
            **self._paging_dict(),
            "retries_total": self.retries_total,
            "faults_injected_total": self.faults_injected_total,
            "quarantined_total": self.quarantined_total,
            "preemptions_total": self.preemptions_total,
            "degraded_mode": self.degraded_mode,
            "faults_by_kind": dict(self.faults_by_kind),
            "snapshots_total": self.snapshots_total,
            "snapshot_failures_total": self.snapshot_failures_total,
            "cancelled_total": self.cancelled_total,
            "integrity_snapshot_checksum_failures_total":
                self.integrity_snapshot_checksum_failures_total,
        }
