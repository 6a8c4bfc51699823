"""Serving observability: queue depth, time-to-first-token, per-token
latency, slot utilization, throughput — the port of
``mmlspark_tpu/serve/metrics.py``.

Built on the telemetry plane (:mod:`mmlspark_tpu_torch.core.telemetry`):
counts are registry ``Counter``s and the latency figures feed
log-bucketed ``Histogram``s, so ``to_dict()`` carries exact means and
deterministic p50/p95/p99 for TTFT, per-token decode latency and tick
duration, under the JAX package's key names. With a ``namespace``
(``"replica0."``) every registry name is prefixed, so the registries of
a replica set's engines concatenate into one Prometheus exposition; the
flat ``to_dict`` keys stay unprefixed. ``perf`` is the device-analytics
plane (:class:`~mmlspark_tpu_torch.core.perf.PerfAnalytics`): the engine
registers each program family's analytic cost once and attributes every
dispatch interval to it, with no new host sync. ``attach_slo`` feeds an
:class:`~mmlspark_tpu_torch.core.perf.SloMonitor` from the same hooks.
``snapshot()`` returns structured
:class:`~mmlspark_tpu_torch.core.metrics_contracts.MetricData` records.

The serving topology: ``mesh_shape`` (axis -> size; ``{}`` on one
device), ``mesh_devices`` and ``cache_pool_bytes_per_device`` (the KV
pool bytes one device holds: a rank's shard under a mesh, below the
pool's total). Tick-count
figures (TTFT in ticks, queue depth) are deterministic given the arrival
schedule; wall-clock figures (TTFT ms, per-token ms, tokens/sec, MFU)
describe the host and device together and are only meaningful from a
run on the card.
"""

from __future__ import annotations

import time

from mmlspark_tpu_torch.core.metrics_contracts import MetricData
from mmlspark_tpu_torch.core.perf import PerfAnalytics, SloMonitor
from mmlspark_tpu_torch.core.telemetry import MetricRegistry


def _mean(xs) -> float | None:
    xs = list(xs)
    return (sum(xs) / len(xs)) if xs else None


def _rnd(value: float | None, digits: int = 3) -> float | None:
    return round(value, digits) if value is not None else None


class ServeMetrics:
    def __init__(self, model: str, slots: int,
                 registry: MetricRegistry | None = None,
                 decode_block: int = 1,
                 cache_pool_bytes_per_device: int = 0,
                 kv_dtype: str = "bf16",
                 prefill_chunk: int = 0,
                 async_host: bool = False,
                 namespace: str = "",
                 mesh_shape: dict[str, int] | None = None,
                 mesh_devices: int = 1):
        self.model = model
        self.slots = slots
        #: per-replica metric namespacing (serve/supervisor.py): a
        #: non-empty namespace ("replica0.") prefixes every registry
        #: metric name, so N replicas' registries concatenate into ONE
        #: Prometheus exposition without name collisions; the flat
        #: ``to_dict`` keys stay unprefixed (consumers see one schema,
        #: the supervisor nests per-replica dicts instead)
        self.namespace = namespace
        #: the engine's configured max fused-block size (T); surfaced in
        #: to_dict so dashboards can normalize block-aware figures
        self.decode_block = decode_block
        #: the serving topology: axis name -> size of the engine's mesh
        #: ({} on one device), its device count — what dashboards
        #: normalize tokens/sec by across mesh shapes — and the KV-pool
        #: bytes one device holds
        self.mesh_shape: dict[str, int] = dict(mesh_shape or {})
        self.mesh_devices = mesh_devices
        self.cache_pool_bytes_per_device = cache_pool_bytes_per_device
        #: KV-store dtype of the engine's cache pool ("bf16" or "int8"
        #: — the quantized decode path); paired with
        #: cache_pool_bytes_per_device so dashboards can attribute a
        #: bytes drop to quantization rather than a smaller pool
        self.kv_dtype = kv_dtype
        #: chunked-prefill configuration: the fixed chunk width (0 =
        #: monolithic prefill) and whether the pipelined async host
        #: loop is on — surfaced so a metrics line is self-describing
        self.prefill_chunk = prefill_chunk
        self.async_host = bool(async_host)
        self.registry = registry if registry is not None else MetricRegistry()
        r = self.registry

        def n(name: str) -> str:
            return f"{namespace}{name}"

        self._submitted = r.counter(n("serve.submitted"))
        self._rejected = r.counter(n("serve.rejected"))
        self._completed = r.counter(n("serve.completed"))
        self._expired = r.counter(n("serve.expired"))
        self._failed = r.counter(n("serve.failed"))
        self._stalled = r.counter(n("serve.stalled"))
        self._tokens_generated = r.counter(n("serve.tokens_generated"))
        self._prefills = r.counter(n("serve.prefills"))
        # chunked prefill + async host loop:
        # chunk dispatches (intermediate AND final) and decode blocks
        # dispatched while the previous block was still in flight
        self._chunked_prefills = r.counter(n("serve.chunked_prefills"))
        self._overlapped = r.counter(n("serve.overlapped_dispatches"))
        #: cumulative host seconds spent BLOCKED in a decode block's
        #: fetch — host_idle_fraction's numerator, measured
        #: identically in sync and async mode so the two are comparable
        self.host_sync_wait_s = 0.0
        # resilience plane:
        # injected faults, retry absorptions, quarantines, preemptions
        self._retries = r.counter(n("serve.retries"))
        self._faults_injected = r.counter(n("serve.faults_injected"))
        self._quarantined = r.counter(n("serve.quarantined"))
        self._preemptions = r.counter(n("serve.preemptions"))
        # control plane:
        # periodic checkpoints taken/failed and hedge-loser cancels
        self._snapshots = r.counter(n("serve.snapshots"))
        self._snapshot_failures = r.counter(n("serve.snapshot_failures"))
        self._cancelled = r.counter(n("serve.cancelled"))
        # disaggregated fleet:
        # KV hand-off payloads produced by a prefill-role engine,
        # adopted by a decode-role engine, and adoption failures that
        # fell back to a full local prefill
        self._handoffs_out = r.counter(n("serve.handoffs_out"))
        self._handoffs_adopted = r.counter(n("serve.handoffs_adopted"))
        self._handoff_fallbacks = r.counter(n("serve.handoff_fallbacks"))
        # integrity plane:
        # checksum verification failures on adopted hand-off payloads
        # and on engine snapshots at restore — every one means silent
        # corruption was caught before it reached a stream
        self._integrity_handoff_failures = r.counter(
            n("serve.integrity.handoff_checksum_failures")
        )
        self._integrity_snapshot_failures = r.counter(
            n("serve.integrity.snapshot_checksum_failures")
        )
        #: 1 while the engine runs below its configured decode-block
        #: ladder top or admission cap (memory-pressure degradation),
        #: 0 once the recovery probe has re-escalated to full service
        self.degraded_mode = 0
        #: injected-fault count per kind (mirrors the injector's own
        #: ``counts``; rides to_dict as a table like prefill_buckets)
        self.faults_by_kind: dict[str, int] = {}
        self._ttft_ms = r.histogram(n("serve.ttft_ms"))
        self._per_token_ms = r.histogram(n("serve.per_token_ms"))
        self._tick_ms = r.histogram(n("serve.tick_ms"))
        # the per-tick samples as running count, sums and maxima (both
        # sampled values are never negative): to_dict reads no more
        self._ticks = 0
        self._queue_depth_sum = self._queue_depth_max = 0
        self._util_sum = self._util_max = 0.0
        self._tick_s_sum = 0.0
        self.ttft_ticks: list[int] = []
        self.ttft_s: list[float] = []
        #: request id per ttft_s entry — first-token ARRIVAL order is
        #: not submit order under chunked fills (short prompts finish
        #: ahead of a long prompt's multi-chunk fill), so per-class
        #: TTFT slicing (a long-vs-short split) needs the ids
        self.ttft_req_ids: list[int] = []
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        # length-aware decode accounting: KV rows the split-KV kernel
        # actually read vs what a dense read over the full cache_len
        # would have touched for the same steps
        self.decode_live_kv = 0
        self.decode_dense_kv = 0
        #: prefill count per padded bucket length (str keys: the dict
        #: rides the flat JSON line as-is)
        self.prefill_buckets: dict[str, int] = {}
        #: fused-block count per actual block size run (ladder usage)
        self.decode_blocks: dict[str, int] = {}
        #: real tokens emitted per tick (first tokens + block tokens)
        self.tick_tokens: list[int] = []
        self._t0: float | None = None
        self._t_last: float | None = None
        #: device-level analytics: the engine registers each program
        #: family's analytic cost once and attributes every dispatch
        #: interval here — to_dict() grows mfu / hbm_bw_util_pct / the
        #: device-vs-host time split from it, with zero new host syncs
        self.perf = PerfAnalytics(registry=r,
                                  n_devices=max(1, mesh_devices))
        #: rolling-window SLO monitor (attach_slo); None -> undeclared
        self.slo: SloMonitor | None = None
        self._slo_shed_ticks = r.counter(n("serve.slo_shed_ticks"))
        #: paged KV-cache stats provider (attach_paging); None -> dense
        #: pool, the paging keys report inert defaults so the flat
        #: schema stays fixed across pool kinds
        self._paging_provider = None

    def attach_slo(self, monitor: SloMonitor) -> None:
        """Feed the monitor from this plane's hooks: TTFT per first
        token, per-token latency per decode dispatch, ok/error per
        terminal status."""
        self.slo = monitor

    def attach_paging(self, provider) -> None:
        """Wire the paged pool's ``paging_stats`` callable
        (serve/paging.py) in; ``to_dict`` then reports live allocator /
        prefix-cache / copy-on-extend figures instead of the dense
        defaults."""
        self._paging_provider = provider

    def _paging_dict(self) -> dict:
        """The paging plane's flat keys — ALWAYS present: dense engines
        report zeros (and ``page_utilization: None``), so downstream
        consumers never branch on key existence."""
        if self._paging_provider is not None:
            stats = dict(self._paging_provider())
        else:
            stats = {}
        return {
            "page_size": int(stats.get("page_size", 0)),
            "pages_total": int(stats.get("pages_total", 0)),
            "pages_free": int(stats.get("pages_free", 0)),
            "page_utilization": stats.get("page_utilization"),
            "prefix_cache_hits_total": int(
                stats.get("prefix_cache_hits_total", 0)
            ),
            "prefix_cache_entries": int(
                stats.get("prefix_cache_entries", 0)
            ),
            "cow_copies_total": int(stats.get("cow_copies_total", 0)),
            "prefix_tokens_saved_total": int(
                stats.get("prefix_tokens_saved_total", 0)
            ),
        }

    def record_slo_shed(self) -> None:
        """One tick during which SLO shedding suppressed admissions."""
        self._slo_shed_ticks.inc()

    @property
    def slo_shed_ticks_total(self) -> int:
        return self._slo_shed_ticks.value

    # -- registry-backed counts (the attribute API tests assert on) --------

    @property
    def submitted(self) -> int:
        return self._submitted.value

    @property
    def rejected(self) -> int:
        return self._rejected.value

    @property
    def completed(self) -> int:
        return self._completed.value

    @property
    def expired(self) -> int:
        return self._expired.value

    @property
    def failed(self) -> int:
        return self._failed.value

    @property
    def stalled(self) -> int:
        return self._stalled.value

    @property
    def retries_total(self) -> int:
        return self._retries.value

    @property
    def faults_injected_total(self) -> int:
        return self._faults_injected.value

    @property
    def quarantined_total(self) -> int:
        return self._quarantined.value

    @property
    def preemptions_total(self) -> int:
        return self._preemptions.value

    @property
    def snapshots_total(self) -> int:
        return self._snapshots.value

    @property
    def snapshot_failures_total(self) -> int:
        return self._snapshot_failures.value

    @property
    def cancelled_total(self) -> int:
        return self._cancelled.value

    @property
    def handoffs_out_total(self) -> int:
        return self._handoffs_out.value

    @property
    def handoffs_adopted_total(self) -> int:
        return self._handoffs_adopted.value

    @property
    def handoff_fallbacks_total(self) -> int:
        return self._handoff_fallbacks.value

    @property
    def integrity_handoff_checksum_failures_total(self) -> int:
        return self._integrity_handoff_failures.value

    @property
    def integrity_snapshot_checksum_failures_total(self) -> int:
        return self._integrity_snapshot_failures.value

    @property
    def integrity_checksum_failures_total(self) -> int:
        """All checksum verifications that failed on this engine, any
        surface (the headline integrity scalar)."""
        return (self._integrity_handoff_failures.value
                + self._integrity_snapshot_failures.value)

    @property
    def tokens_generated(self) -> int:
        return self._tokens_generated.value

    @property
    def prefills(self) -> int:
        return self._prefills.value

    @property
    def chunked_prefills_total(self) -> int:
        return self._chunked_prefills.value

    @property
    def overlapped_dispatches_total(self) -> int:
        return self._overlapped.value

    # -- recording hooks (called by the engine) ---------------------------

    def _touch(self) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self._t_last = now

    def record_submit(self) -> None:
        self._submitted.inc()
        self._touch()

    def record_reject(self) -> None:
        self._rejected.inc()
        # a run that ends in rejections still happened: without the
        # touch, wall_s (and tokens/sec's denominator) would exclude it
        self._touch()

    def record_first_token(self, req, tick: int,
                           bucket: int | None = None) -> None:
        self._prefills.inc()
        self.ttft_ticks.append(tick - req.submit_tick)
        ttft = time.perf_counter() - req.submit_wall
        self.ttft_s.append(ttft)
        self.ttft_req_ids.append(req.id)
        self._ttft_ms.record(ttft * 1e3)
        if self.slo is not None:
            self.slo.observe_ttft(ttft * 1e3)
        if bucket is not None:
            key = str(bucket)
            self.prefill_buckets[key] = self.prefill_buckets.get(key, 0) + 1

    def record_decode(self, n_active: int, seconds: float,
                      tokens_emitted: int | None = None,
                      block: int = 1,
                      live_kv: int | None = None,
                      cache_len: int | None = None) -> None:
        """One fused decode dispatch: ``seconds`` of wall time that
        emitted ``tokens_emitted`` REAL tokens. Defaults to ``n_active``
        — the T=1 step, where every active slot emits exactly one token
        — so the single-step path is unchanged (asserted equal-path in
        tests). For T>1 blocks the caller passes the consumed count, so
        ``per_token_ms`` divides by tokens actually emitted, not by
        slots times scan length."""
        tokens = n_active if tokens_emitted is None else tokens_emitted
        self.decode_seconds += seconds
        self.decode_tokens += tokens
        if tokens:
            self._per_token_ms.record(seconds / tokens * 1e3)
            if self.slo is not None:
                self.slo.observe_per_token(seconds / tokens * 1e3)
        key = str(block)
        self.decode_blocks[key] = self.decode_blocks.get(key, 0) + 1
        if live_kv is not None and cache_len is not None:
            self.decode_live_kv += live_kv
            self.decode_dense_kv += tokens * cache_len

    def record_finish(self, result) -> None:
        if result.status == "expired":
            self._expired.inc()
        elif result.status == "failed":
            self._failed.inc()
        elif result.status == "stalled":
            self._stalled.inc()
        elif result.status == "handed_off":
            # terminal on a prefill-role engine only: the request
            # continues on a decode replica, so it is neither a
            # completion nor an error here — and it must NOT feed the
            # SLO error-rate window
            self._handoffs_out.inc()
        else:
            self._completed.inc()
        self._tokens_generated.inc(result.generated)
        if self.slo is not None and result.status != "handed_off":
            self.slo.observe_finish(result.status == "completed")
        self._touch()

    def record_prefill_chunk(self) -> None:
        """One chunk dispatch of a chunked prefill (intermediate or
        final)."""
        self._chunked_prefills.inc()

    def record_overlapped_dispatch(self) -> None:
        """One decode block dispatched while the previous block was
        still in flight (the async host loop's pipelining hit)."""
        self._overlapped.inc()

    def record_host_sync(self, seconds: float) -> None:
        """Host seconds spent blocked in one decode block's
        fetch."""
        self.host_sync_wait_s += max(0.0, seconds)

    def record_fault(self, kind: str) -> None:
        """One injected fault (the injector's listener calls this)."""
        self._faults_injected.inc()
        self.faults_by_kind[kind] = self.faults_by_kind.get(kind, 0) + 1

    def record_retry(self) -> None:
        """One dispatch retry the backoff loop absorbed."""
        self._retries.inc()

    def record_quarantine(self) -> None:
        """One request retired as ``"failed"`` by fault handling."""
        self._quarantined.inc()

    def record_preemption(self) -> None:
        """One active request evicted + requeued under memory
        pressure."""
        self._preemptions.inc()

    def record_snapshot(self) -> None:
        """One periodic checkpoint written completely."""
        self._snapshots.inc()

    def record_snapshot_failure(self) -> None:
        """One checkpoint that failed mid-write (NOT restorable — the
        engine keeps serving from the previous complete snapshot)."""
        self._snapshot_failures.inc()

    def record_cancel(self) -> None:
        """One pending request cancelled by the supervisor (a hedge's
        losing copy, or failover dedup)."""
        self._cancelled.inc()

    def record_handoff_out(self) -> None:
        """One KV hand-off payload produced (prefill-role engine)."""
        self._handoffs_out.inc()

    def record_handoff_adopt(self) -> None:
        """One hand-off payload adopted by direct KV write (no local
        prefill program ran)."""
        self._handoffs_adopted.inc()

    def record_handoff_fallback(self) -> None:
        """One hand-off adoption that failed (fault/retry exhaustion)
        and fell back to a full local prefill."""
        self._handoff_fallbacks.inc()

    def record_integrity_handoff_failure(self) -> None:
        """One adopted hand-off payload whose checksum did not verify
        (the adoption fell back to a full local prefill)."""
        self._integrity_handoff_failures.inc()

    def record_integrity_snapshot_failure(self) -> None:
        """One snapshot rejected at restore because its stamped
        checksum did not re-hash (failover fell back to a fresh
        engine)."""
        self._integrity_snapshot_failures.inc()

    def ttft_p99_ms(self) -> float:
        """The routing signal the supervisor reads per replica (with
        queue depth): TTFT p99 from the live histogram, no device
        sync. Returns 0.0 on an empty histogram — a cold replica must
        look CHEAP to route to, and autoscale arithmetic on NaN/None
        poisons every comparison downstream."""
        p = self._ttft_ms.percentile(99)
        return 0.0 if p is None else p

    def per_token_p99_ms(self) -> float:
        """Per-token decode latency p99; 0.0 on an empty histogram
        (same cold-replica contract as :meth:`ttft_p99_ms`)."""
        p = self._per_token_ms.percentile(99)
        return 0.0 if p is None else p

    def tick_p99_ms(self) -> float:
        """Scheduler-tick duration p99; 0.0 on an empty histogram
        (same cold-replica contract as :meth:`ttft_p99_ms`)."""
        p = self._tick_ms.percentile(99)
        return 0.0 if p is None else p

    def set_degraded(self, degraded: bool) -> None:
        self.degraded_mode = int(degraded)

    def sample_tick(self, queue_depth: int, leased: int, seconds: float,
                    tokens_emitted: int = 0) -> None:
        """One scheduler tick. ``tokens_emitted`` is the REAL token
        count the tick produced (admissions' first tokens + the decode
        block's consumed tokens) — explicit, because with fused blocks a
        tick emits up to S*T tokens and attributing its wall time to one
        token would inflate every per-token figure T-fold."""
        util = leased / self.slots
        self._ticks += 1
        self._queue_depth_sum += queue_depth
        self._queue_depth_max = max(self._queue_depth_max, queue_depth)
        self._util_sum += util
        self._util_max = max(self._util_max, util)
        self._tick_s_sum += seconds
        self.tick_tokens.append(tokens_emitted)
        self._tick_ms.record(seconds * 1e3)
        self.perf.record_tick(seconds)
        self._touch()

    # -- views -------------------------------------------------------------

    def to_dict(self) -> dict:
        wall = (
            (self._t_last - self._t0)
            if self._t0 is not None and self._t_last is not None
            else 0.0
        )
        per_tok = (
            self.decode_seconds / self.decode_tokens
            if self.decode_tokens
            else None
        )
        return {
            "model": self.model,
            "slots": self.slots,
            "ticks": self._ticks,
            "submitted": self.submitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "expired": self.expired,
            "failed": self.failed,
            "stalled": self.stalled,
            "tokens_generated": self.tokens_generated,
            "queue_depth_mean": (
                self._queue_depth_sum / self._ticks if self._ticks else None
            ),
            "queue_depth_max": (
                self._queue_depth_max if self._ticks else None
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
                round(self._util_sum / self._ticks, 4)
                if self._ticks else None
            ),
            "slot_utilization_peak": (
                round(self._util_max, 4) if self._ticks else None
            ),
            "tokens_per_sec": (
                round(self.tokens_generated / wall, 1) if wall > 0 else None
            ),
            "wall_s": round(wall, 4),
            # what fraction of a dense-over-cache_len read's attention
            # work the length-aware decode actually performed: KV rows
            # LIVE at each step / slots * cache_len rows a dense read
            # touches — the direct measure of what flash_decode's
            # block-level early-out saves
            "decode_live_kv_tokens": self.decode_live_kv,
            "decode_dense_kv_tokens": self.decode_dense_kv,
            "decode_flop_utilization": (
                round(self.decode_live_kv / self.decode_dense_kv, 4)
                if self.decode_dense_kv else None
            ),
            "prefill_buckets": dict(self.prefill_buckets),
            # chunked prefill + async host loop:
            # configuration echoes, chunk-dispatch volume, pipelining
            # hits, and the fraction of tick wall time the host spent
            # BLOCKED in decode-block fetches — the figure
            # --async-host exists to shrink (inert zeros/None on
            # monolithic-synchronous engines, so the schema stays fixed)
            "prefill_chunk": self.prefill_chunk,
            "chunked_prefills_total": self.chunked_prefills_total,
            "async_host": int(self.async_host),
            "overlapped_dispatches_total": self.overlapped_dispatches_total,
            "host_sync_wait_s": round(self.host_sync_wait_s, 4),
            "host_idle_fraction": (
                round(
                    min(1.0, self.host_sync_wait_s / self._tick_s_sum), 4
                )
                if self._tick_s_sum > 0 else None
            ),
            # fused decode blocks:
            # the configured max T, mean real tokens per tick, and how
            # often each ladder size actually ran
            "decode_block": self.decode_block,
            "tokens_per_tick": (
                _rnd(_mean(self.tick_tokens))
                if self.tick_tokens else 0.0
            ),
            "decode_blocks": dict(self.decode_blocks),
            # the serving topology (one device here)
            "mesh_shape": dict(self.mesh_shape),
            "mesh_devices": self.mesh_devices,
            "cache_pool_bytes_per_device": self.cache_pool_bytes_per_device,
            "kv_dtype": self.kv_dtype,
            # paged KV cache:
            # allocator occupancy, prefix-cache traffic,
            # copy-on-extend count — inert defaults on dense pools
            **self._paging_dict(),
            # resilience plane:
            # fault-handling activity and whether the
            # engine is currently degraded
            "retries_total": self.retries_total,
            "faults_injected_total": self.faults_injected_total,
            "quarantined_total": self.quarantined_total,
            "preemptions_total": self.preemptions_total,
            "degraded_mode": self.degraded_mode,
            "faults_by_kind": dict(self.faults_by_kind),
            # replica control plane: periodic-checkpoint activity and
            # supervisor-initiated cancels — zeros on unsupervised
            # engines, so the flat schema stays fixed
            "snapshots_total": self.snapshots_total,
            "snapshot_failures_total": self.snapshot_failures_total,
            "cancelled_total": self.cancelled_total,
            # disaggregated fleet: KV hand-off traffic — zeros on
            # engines outside a DisaggFleet, so the schema stays fixed
            "handoffs_out_total": self.handoffs_out_total,
            "handoffs_adopted_total": self.handoffs_adopted_total,
            "handoff_fallbacks_total": self.handoff_fallbacks_total,
            # integrity plane:
            # checksum failures caught at hand-off
            # adoption and snapshot restore — zeros on a healthy
            # engine, so the flat schema stays fixed
            "integrity_checksum_failures_total":
                self.integrity_checksum_failures_total,
            "integrity_handoff_checksum_failures_total":
                self.integrity_handoff_checksum_failures_total,
            "integrity_snapshot_checksum_failures_total":
                self.integrity_snapshot_checksum_failures_total,
            # device-level analytics:
            # headline utilization, the device-vs-host time split, the
            # per-family breakdown, and the peak figures MFU is
            # measured against (so a number is never context-free)
            **self._perf_dict(),
            # SLO plane:
            # always-present scalars for dashboards plus the full
            # window state under "slo"
            "slo_burning": (
                int(self.slo.should_shed) if self.slo is not None else 0
            ),
            "slo_violations_total": (
                self.slo.violations_total if self.slo is not None else 0
            ),
            "slo_shed_ticks_total": self.slo_shed_ticks_total,
            "slo": (
                self.slo.state() if self.slo is not None
                else {"declared": False}
            ),
        }

    def _perf_dict(self) -> dict:
        s = self.perf.summary()
        return {
            "mfu": s["mfu"],
            "hbm_bw_util_pct": s["hbm_bw_util_pct"],
            "device_time_s": s["device_time_s"],
            "host_time_s": s["host_time_s"],
            "device_time_pct": s["device_time_pct"],
            "perf_families": s["families"],
            "perf_peak": s["peak"],
        }

    def snapshot(self) -> list[MetricData]:
        """Structured records for the logging/metrics plane: one
        MetricData per scalar (group ``"serve"``) and one
        ``create_table`` record per non-scalar metric — the
        ``prefill_buckets`` dict reaches the metrics plane instead of
        being silently dropped."""
        out = []
        for name, value in self.to_dict().items():
            if isinstance(value, bool):
                continue
            if isinstance(value, (int, float)):
                out.append(MetricData(
                    name=f"serve.{name}", value=float(value),
                    model=self.model, group="serve",
                ))
            elif isinstance(value, dict):
                out.append(MetricData.create_table(
                    f"serve.{name}", dict(value), self.model,
                ))
        return out
