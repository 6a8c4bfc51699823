"""``DisaggFleet`` — the disaggregated prefill/decode serving fleet, the
port of ``mmlspark_tpu/serve/fleet.py``.

Splits replicas into dedicated roles behind the same ``submit()/step()/
run()`` facade as :class:`~mmlspark_tpu_torch.serve.supervisor.ReplicaSet`:
prefill is compute-bound and bursty, decode bandwidth-bound and steady,
so each role runs on replicas of its own. Three planes, all host-side
control (no fleet code touches device buffers, so every per-engine
invariant — program pins, one fetch a decode block, paged refcounts —
holds exactly as on an unsupervised engine):

- **KV hand-off plane** — a prefill-role engine runs admission and
  prefill only and retires each request as ``"handed_off"``, leaving a
  payload in its outbox: the prefill (or resume, or final chunk)
  program's linear K/V rows ``[0, p)`` — cloned out of the program's
  static outputs — and the first greedy token, checksummed. The fleet
  routes the payload to a decode replica, which writes the K/V straight
  into a slot at admission (``write_prefill``, on dense and paged pools,
  bf16 or int8) through the ``serve.handoff`` fault site: no prefill
  program runs there, and greedy determinism keeps the continued stream
  equal to a homogeneous run. A payload that is lost (a fault, a dead
  replica) or corrupt falls back to a full local prefill with the same
  guarantee.
- **Fleet-wide prefix index** — every collected payload enters an index
  keyed by its exact token sequence, refcounted by the OPEN requests
  seeded from each entry (LRU eviction of unreferenced entries past
  ``prefix_index_capacity``) and locality-aware (it prefers the decode
  replicas that already adopted the entry). A later submit of the same
  prompt skips prefill fleet-wide (``fleet_prefill_tokens_saved``).
  Entries hold the payloads' own K/V copies on the card, never live page
  references, so every pool's refcount audit is untouched.
- **Elastic autoscaling** — an :class:`AutoscalePolicy` driven by the
  SLO monitor's consecutive-burn signal (``SloMonitor.burn_ticks``) and
  per-role load spawns replicas from a parked budget and retires idle
  ones through the zero-loss drain. Decisions are per role and
  cooldown-gated.

Health, failover and drain mirror the ReplicaSet state machine (healthy
-> degraded -> quarantined -> restoring -> drained): a killed or stalled
replica rebuilds from its last periodic snapshot, role kept, and every
in-flight stream resumes through the emitted-prefix path. The fleet's
own :meth:`DisaggFleet.snapshot` is JSON with no K/V, the JAX package's
format: one taken by either framework restores on the other.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import EngineKilled, FaultInjector
from mmlspark_tpu_torch.core.integrity import SnapshotCorruption
from mmlspark_tpu_torch.core.telemetry import FlightRecorder, MetricRegistry
from mmlspark_tpu_torch.serve.engine import ServeEngine
from mmlspark_tpu_torch.serve.scheduler import RequestResult
from mmlspark_tpu_torch.parallel.mesh import serve_mesh
from mmlspark_tpu_torch.serve.supervisor import (
    _LIVE_RANK,
    agreed_ttft,
    mesh_clock,
)

_log = logging.getLogger("mmlspark_tpu_torch.serve.fleet")

#: replica roles a fleet partitions engines into (``ServeEngine.role``)
ROLES = ("prefill", "decode")


@dataclass
class AutoscalePolicy:
    """Elastic-fleet policy knobs. ``queue_high`` is the mean
    per-replica load (queue depth + leased slots) above which a role
    scales up; ``slo_burn_ticks`` is
    the consecutive-burn streak (``SloMonitor.burn_ticks``) that also
    triggers scale-up (0 disables the SLO signal); ``idle_ticks`` is
    how long a replica must sit idle before it drains back to the
    parked budget; ``cooldown_ticks`` gates consecutive actions so one
    burst cannot slam the fleet to max and back."""

    min_prefill: int = 1
    max_prefill: int = 2
    min_decode: int = 1
    max_decode: int = 4
    queue_high: float = 2.0
    slo_burn_ticks: int = 3
    idle_ticks: int = 8
    cooldown_ticks: int = 2

    def __post_init__(self):
        for name in ("min_prefill", "min_decode"):
            if getattr(self, name) < 1:
                raise FriendlyError(
                    f"autoscale {name} must be >= 1, got "
                    f"{getattr(self, name)}"
                )
        if self.max_prefill < self.min_prefill:
            raise FriendlyError(
                f"autoscale max_prefill ({self.max_prefill}) must be "
                f">= min_prefill ({self.min_prefill})"
            )
        if self.max_decode < self.min_decode:
            raise FriendlyError(
                f"autoscale max_decode ({self.max_decode}) must be "
                f">= min_decode ({self.min_decode})"
            )
        if self.queue_high <= 0:
            raise FriendlyError(
                f"autoscale queue_high must be > 0, got "
                f"{self.queue_high}"
            )
        for name in ("slo_burn_ticks", "idle_ticks", "cooldown_ticks"):
            if getattr(self, name) < 0:
                raise FriendlyError(
                    f"autoscale {name} must be >= 0, got "
                    f"{getattr(self, name)}"
                )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_autoscale_spec(spec: str) -> AutoscalePolicy:
    """CLI spelling -> policy: ``"min_decode=1,max_decode=4,
    queue_high=2,slo_burn_ticks=3,idle_ticks=8,cooldown_ticks=2"``
    (any subset; the rest keep their defaults)."""
    fields = {f.name for f in dataclasses.fields(AutoscalePolicy)}
    kwargs: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise FriendlyError(
                f"autoscale spec entries are key=value, got {part!r}"
            )
        key, _, value = part.partition("=")
        key = key.strip()
        if key not in fields:
            raise FriendlyError(
                f"unknown autoscale key {key!r}; keys are "
                f"{tuple(sorted(fields))}"
            )
        kwargs[key] = (
            float(value) if key == "queue_high" else int(value)
        )
    return AutoscalePolicy(**kwargs)


def _p99(values: list[float]) -> float:
    """Nearest-rank p99 over a plain list; 0.0 when empty (the same
    cold contract as ``ServeMetrics.ttft_p99_ms``)."""
    if not values:
        return 0.0
    xs = sorted(values)
    rank = max(0, int(np.ceil(0.99 * len(xs))) - 1)
    return float(xs[rank])


@dataclass
class _Copy:
    """One engine-local copy of a request (replica idx + engine-local
    id)."""

    replica: int
    rid: int


@dataclass
class _Pending:
    """Fleet-side record of one submitted request."""

    gid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None
    deadline_ticks: int | None
    submit_t: float
    submit_tick: int
    copies: list[_Copy] = field(default_factory=list)
    #: "prefill" until the hand-off payload lands, then "decode"
    stage: str = "prefill"
    #: prefix-index key this request's decode copy was seeded from
    #: (refcounted on the entry until the request commits)
    index_key: bytes | None = None
    committed: bool = False
    #: fleet-wide trace-context id (``f{gid}``): stamped on the prefill
    #: submit, carried by the hand-off payload onto the decode replica
    #: and by every failover replay and drain migration
    trace_id: str = ""
    #: ``time.perf_counter()`` when the set took the request: its
    #: result's ``submitted_at``, whichever copy commits
    submitted_at: float = field(default_factory=time.perf_counter)


@dataclass
class _FleetReplica:
    """One managed engine + its control-plane state + its role."""

    idx: int
    role: str
    engine: ServeEngine
    state: str = "healthy"
    routed: dict[int, int] = field(default_factory=dict)
    failovers: int = 0
    last_tokens: int = -1
    last_progress_t: float = 0.0
    #: consecutive fleet ticks this replica sat idle (autoscaler's
    #: scale-down clock)
    idle_ticks: int = 0


@dataclass
class _IndexEntry:
    """One fleet prefix-index entry: the linear K/V + first token
    for an exact token sequence, refcounted by the OPEN requests
    seeded from it and locality-tagged with the decode replicas that
    already hold it."""

    key: bytes
    prompt: np.ndarray
    length: int
    kv: object
    first_token: int
    refs: int = 0
    hits: int = 0
    last_used: int = 0
    #: decode replica idxs that adopted this entry (routing prefers
    #: them — their paged prefix caches already hold the pages)
    home: set = field(default_factory=set)
    #: the producing engine's payload checksum: rides every
    #: index-served hand-off so the adopting engine re-verifies the
    #: KV even when it came out of the fleet index, not the wire
    checksum: str | None = None


class DisaggFleet:
    """Dedicated prefill + decode replicas behind one facade.

    ``prefill_replicas``/``decode_replicas`` size the baseline fleet;
    ``autoscale`` (an :class:`AutoscalePolicy`, or the CLI string
    spelling) makes decode/prefill counts elastic within the policy's
    bounds — the headroom between baseline and max is the parked
    device-resource budget. Remaining ``**engine_kwargs`` (slots,
    cache_len, paged, prefix_cache, kv_dtype, device, ...) configure
    every replica identically — hand-off requires equal cache
    geometry.
    """

    def __init__(self, graph, variables, *, prefill_replicas: int = 1,
                 decode_replicas: int = 1,
                 autoscale: AutoscalePolicy | str | None = None,
                 snapshot_every_ticks: int | None = 4,
                 probe_stall_s: float = 30.0,
                 clock=None,
                 recorder: FlightRecorder | None = None,
                 faults: FaultInjector | None = None,
                 max_failovers: int = 8,
                 prefix_index_capacity: int = 32,
                 **engine_kwargs):
        if prefill_replicas < 1 or decode_replicas < 1:
            raise FriendlyError(
                f"the fleet needs at least one replica per role, got "
                f"prefill_replicas={prefill_replicas}, "
                f"decode_replicas={decode_replicas}"
            )
        if max_failovers < 0:
            raise FriendlyError(
                f"max_failovers must be >= 0, got {max_failovers}"
            )
        if prefix_index_capacity < 0:
            raise FriendlyError(
                f"prefix_index_capacity must be >= 0, got "
                f"{prefix_index_capacity}"
            )
        for key in ("replica", "faults", "snapshot_every_ticks",
                    "recorder", "role"):
            if key in engine_kwargs:
                raise FriendlyError(
                    f"'{key}' is managed by DisaggFleet — pass it to "
                    "the DisaggFleet constructor, not through engine "
                    "kwargs"
                )
        if isinstance(autoscale, str):
            autoscale = parse_autoscale_spec(autoscale)
        if autoscale is not None:
            if prefill_replicas < autoscale.min_prefill:
                raise FriendlyError(
                    f"prefill_replicas ({prefill_replicas}) is below "
                    f"the autoscale floor ({autoscale.min_prefill})"
                )
            if decode_replicas < autoscale.min_decode:
                raise FriendlyError(
                    f"decode_replicas ({decode_replicas}) is below "
                    f"the autoscale floor ({autoscale.min_decode})"
                )
        self._graph = graph
        self._variables = variables
        self._engine_kwargs = dict(engine_kwargs)
        self._snapshot_every = snapshot_every_ticks
        self._probe_stall_s = probe_stall_s
        #: the replicas' serving mesh (None: one device each); over one
        #: the clock and the routing key's TTFT are agreed by every rank
        #: (serve/supervisor.py's "Mesh replicas")
        self._place = serve_mesh(engine_kwargs.get("mesh"))
        self._clock = clock if clock is not None else mesh_clock(self._place)
        self._faults = faults
        self._max_failovers = max_failovers
        self._autoscale = autoscale
        self._cooldown = 0
        #: per-role parked device-resource budget: replicas the
        #: autoscaler may still spawn (baseline-to-max headroom)
        self._parked = {
            "prefill": (
                max(0, autoscale.max_prefill - prefill_replicas)
                if autoscale is not None else 0
            ),
            "decode": (
                max(0, autoscale.max_decode - decode_replicas)
                if autoscale is not None else 0
            ),
        }
        self.recorder = (
            recorder if recorder is not None else FlightRecorder()
        )
        # claim the shared injector's listener BEFORE engines can, so
        # fault events from every replica land in ONE control-plane
        # timeline (engines only claim an unset listener)
        if faults is not None and faults.listener is None:
            def _on_fault(kind: str, site: str) -> None:
                self.recorder.record("fault_injected", tick=self._tick,
                                     kind=kind, site=site)
            faults.listener = _on_fault
        self.registry = MetricRegistry()
        r = self.registry
        self._m_failovers = r.counter("serve.replica_failovers")
        self._m_drains = r.counter("serve.drains")
        self._m_handoffs = r.counter("serve.fleet_handoffs")
        self._m_handoff_failures = r.counter(
            "serve.fleet_handoff_failures"
        )
        self._m_index_hits = r.counter("serve.fleet_prefix_hits")
        self._m_tokens_saved = r.counter(
            "serve.fleet_prefill_tokens_saved"
        )
        self._m_index_evictions = r.counter(
            "serve.fleet_index_evictions"
        )
        self._m_scale_ups = r.counter("serve.scale_ups")
        self._m_scale_downs = r.counter("serve.scale_downs")
        self._m_snapshot_checksum_failures = r.counter(
            "serve.integrity.snapshot_checksum_failures"
        )
        self._tick = 0
        self._next_gid = 0
        self._next_idx = 0
        self._total_failovers = 0
        self._requests: dict[int, _Pending] = {}
        self._open: set[int] = set()
        self._results: dict[int, RequestResult] = {}
        #: fleet prefix index: exact-sequence bytes -> entry
        self._index: dict[bytes, _IndexEntry] = {}
        self._index_capacity = prefix_index_capacity
        #: fleet-level TTFT samples for INDEX HITS only (ms, submit ->
        #: cached first token); hand-off TTFTs live in the prefill
        #: replicas' own histograms and ttft_p99_ms() merges both
        self._ttft_ms: list[float] = []
        self._reps: list[_FleetReplica] = []
        for _ in range(prefill_replicas):
            self._spawn("prefill")
        for _ in range(decode_replicas):
            self._spawn("decode")

    # -- replica lifecycle -------------------------------------------------

    def _build_engine(self, idx: int, role: str) -> ServeEngine:
        return ServeEngine(
            self._graph, self._variables, replica=idx, role=role,
            faults=self._faults,
            snapshot_every_ticks=self._snapshot_every,
            **self._engine_kwargs,
        )

    def _spawn(self, role: str) -> _FleetReplica:
        idx = self._next_idx
        self._next_idx += 1
        rep = _FleetReplica(
            idx=idx, role=role, engine=self._build_engine(idx, role),
        )
        rep.last_progress_t = self._clock()
        # baseline recovery point: a replica killed before its first
        # periodic checkpoint still restores (to empty)
        rep.engine.checkpoint()
        self._reps.append(rep)
        return rep

    # -- introspection -----------------------------------------------------

    @property
    def tick(self) -> int:
        return self._tick

    @property
    def busy(self) -> bool:
        return bool(self._open)

    def _role_reps(self, role: str,
                   live_only: bool = False) -> list[_FleetReplica]:
        return [
            r for r in self._reps
            if r.role == role
            and (not live_only or r.state in _LIVE_RANK)
        ]

    @property
    def prefill_replicas(self) -> int:
        """LIVE prefill replicas (scale-downs and drains excluded)."""
        return len(self._role_reps("prefill", live_only=True))

    @property
    def decode_replicas(self) -> int:
        """LIVE decode replicas (scale-downs and drains excluded)."""
        return len(self._role_reps("decode", live_only=True))

    def _rep(self, idx: int) -> _FleetReplica:
        for rep in self._reps:
            if rep.idx == idx:
                return rep
        raise FriendlyError(
            f"replica index {idx} is not in this fleet (known: "
            f"{[r.idx for r in self._reps]})"
        )

    def engine(self, idx: int) -> ServeEngine:
        """The replica's CURRENT engine (failover swaps it)."""
        return self._rep(idx).engine

    def replica_state(self, idx: int) -> str:
        return self._rep(idx).state

    def replica_role(self, idx: int) -> str:
        return self._rep(idx).role

    # -- routing -----------------------------------------------------------

    def _route_order(self, role: str,
                     exclude: set[int] = frozenset(),
                     prefer: set[int] = frozenset()
                     ) -> list[_FleetReplica]:
        """Live replicas of one role, best route first: locality
        preference (prefix-index homes), then state rank, then load,
        then TTFT p99, then index for determinism."""
        live = [
            r for r in self._role_reps(role, live_only=True)
            if r.idx not in exclude
        ]
        ttft = agreed_ttft(self._place, live)
        return sorted(live, key=lambda r: (
            0 if r.idx in prefer else 1,
            _LIVE_RANK[r.state],
            r.engine.queue_depth + r.engine.pool.leased_count,
            ttft[r.idx],
            r.idx,
        ))

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: int | None = None,
               deadline_ticks: int | None = None) -> int:
        """Route one request; returns its GLOBAL id. A fleet
        prefix-index hit skips prefill entirely — the cached KV +
        first token route straight to a decode replica (the
        prefill-once-per-FLEET path); otherwise the request goes to
        the least-loaded live prefill replica (falling back to a
        decode replica if the prefill role is fully down — decode
        engines keep full prefill capability)."""
        prompt = np.asarray(prompt, np.int32)
        gid = self._next_gid
        p = _Pending(
            gid=gid, prompt=prompt, max_new_tokens=max_new_tokens,
            eos_id=eos_id, deadline_ticks=deadline_ticks,
            submit_t=self._clock(), submit_tick=self._tick,
            trace_id=f"f{gid}",
        )
        entry = self._index.get(prompt.tobytes())
        if entry is not None and len(prompt) == entry.length:
            # fleet-wide prefix hit: this exact sequence prefilled
            # somewhere already — seed a decode replica directly
            self._route_indexed(p, entry)
        else:
            order = self._route_order("prefill")
            if not order:
                order = self._route_order("decode")
            if not order:
                raise FriendlyError(
                    "no live replica to route to (all drained or "
                    "quarantined); drain fewer replicas or build a "
                    "larger fleet"
                )
            target = next(
                (r for r in order if not r.engine.queue_full), order[0]
            )
            rid = target.engine.submit(
                prompt, max_new_tokens, eos_id=eos_id,
                deadline_ticks=deadline_ticks, trace_id=p.trace_id,
            )
            target.routed[rid] = gid
            p.copies = [_Copy(target.idx, rid)]
            self.recorder.record(
                "routed", tick=self._tick, gid=gid,
                replica=target.idx, rid=rid, stage="prefill",
                trace=p.trace_id,
            )
        self._next_gid += 1
        self._requests[gid] = p
        self._open.add(gid)
        return gid

    # -- prefix index ------------------------------------------------------

    def _route_indexed(self, p: _Pending, entry: _IndexEntry) -> None:
        """Seed a decode replica from a fleet prefix-index entry: the
        request's first token already exists, so TTFT is route time
        and the prefill tokens are saved fleet-wide."""
        payload = {
            "prompt": p.prompt,
            "prefix": np.zeros(0, np.int32),
            "length": int(entry.length),
            "first_token": int(entry.first_token),
            "kv": entry.kv,
            "max_new_tokens": p.max_new_tokens,
            "eos_id": p.eos_id,
            # the producer's stamp: payload_checksum hashes the
            # CONCATENATED prompt+prefix sequence, so the entry's
            # re-spelling (full seq as prompt, empty prefix) still
            # verifies on adopt
            "checksum": entry.checksum,
            # THIS request's trace context, not the producer's: the
            # index entry is shared, the causal chain is per-request
            "trace_id": p.trace_id,
        }
        target = self._adopt_on_decode(p.gid, payload,
                                       prefer=set(entry.home))
        entry.refs += 1
        entry.hits += 1
        entry.last_used = self._tick
        entry.home.add(target.idx)
        p.index_key = entry.key
        p.stage = "decode"
        self._m_index_hits.inc()
        self._m_tokens_saved.inc(int(entry.length))
        self._ttft_ms.append((self._clock() - p.submit_t) * 1e3)
        self.recorder.record(
            "fleet_prefix_hit", tick=self._tick, gid=p.gid,
            replica=target.idx, tokens_saved=int(entry.length),
            trace=p.trace_id,
        )

    def _index_insert(self, pay: dict) -> bytes:
        """Insert (or refresh) the index entry for a collected
        payload; LRU-evicts an unreferenced entry when over
        capacity. Returns the entry key."""
        seq = np.concatenate([
            np.asarray(pay["prompt"], np.int32),
            np.asarray(pay["prefix"], np.int32),
        ])
        key = seq.tobytes()
        entry = self._index.get(key)
        if entry is None:
            if self._index_capacity == 0:
                return key
            while len(self._index) >= self._index_capacity:
                victim = min(
                    (e for e in self._index.values() if e.refs == 0),
                    key=lambda e: (e.last_used, e.key),
                    default=None,
                )
                if victim is None:
                    # every entry is pinned by an open request — the
                    # index grows past capacity rather than dropping a
                    # referenced payload
                    break
                del self._index[victim.key]
                self._m_index_evictions.inc()
            entry = _IndexEntry(
                key=key, prompt=seq, length=int(pay["length"]),
                kv=pay["kv"], first_token=int(pay["first_token"]),
                last_used=self._tick,
                checksum=pay.get("checksum"),
            )
            self._index[key] = entry
        else:
            entry.last_used = self._tick
        return key

    def _index_decref(self, p: _Pending) -> None:
        if p.index_key is None:
            return
        entry = self._index.get(p.index_key)
        if entry is not None and entry.refs > 0:
            entry.refs -= 1
        p.index_key = None

    def prefix_index_stats(self) -> dict:
        """Fleet-index occupancy + its own refcount conservation law:
        ``refs_total`` must equal the number of OPEN requests seeded
        from an index entry (asserted in tests alongside every pool's
        ``refcount_audit``)."""
        return {
            "entries": len(self._index),
            "capacity": self._index_capacity,
            "refs_total": sum(e.refs for e in self._index.values()),
            "open_indexed": sum(
                1 for gid in self._open
                if self._requests[gid].index_key is not None
            ),
            "hits_total": self._m_index_hits.value,
            "tokens_saved_total": self._m_tokens_saved.value,
            "evictions_total": self._m_index_evictions.value,
        }

    # -- hand-off plane ----------------------------------------------------

    def _adopt_on_decode(self, gid: int, payload: dict,
                         prefer: set = frozenset()) -> _FleetReplica:
        """Land one KV payload on the best live decode replica and
        record the routing. Raises when the decode role is fully down
        (the fleet cannot continue the stream anywhere)."""
        order = self._route_order("decode", prefer=prefer)
        if not order:
            raise FriendlyError(
                "no live decode replica to adopt the hand-off; the "
                "fleet cannot continue this stream (raise "
                "max_failovers or add decode replicas)"
            )
        target = order[0]
        rid = target.engine.adopt_handoff(payload)
        target.routed[rid] = gid
        p = self._requests.get(gid)
        if p is not None:
            p.copies = [_Copy(target.idx, rid)]
            p.stage = "decode"
        self._m_handoffs.inc()
        self.recorder.record(
            "handoff_routed", tick=self._tick, gid=gid,
            replica=target.idx, rid=rid,
            seq_len=int(payload["length"]),
            trace=str(payload.get("trace_id", "")),
        )
        return target

    def _collect_handoffs(self, rep: _FleetReplica) -> None:
        """Drain one prefill replica's outbox: index every payload
        fleet-wide, then route it to a decode replica."""
        for pay in rep.engine.take_handoffs():
            gid = rep.routed.pop(pay["id"], None)
            if gid is None:
                continue  # cancelled while the payload was in flight
            p = self._requests[gid]
            p.copies = [
                c for c in p.copies
                if not (c.replica == rep.idx and c.rid == pay["id"])
            ]
            # NO fleet-level TTFT sample here: the prefill engine
            # already recorded the precise submit -> first-token wall
            # time at admission (ttft_p99_ms merges those histograms)
            key = self._index_insert(pay)
            try:
                target = self._adopt_on_decode(gid, pay)
            except FriendlyError:
                self._m_handoff_failures.inc()
                raise
            entry = self._index.get(key)
            if entry is not None:
                entry.refs += 1
                entry.home.add(target.idx)
                p.index_key = key

    # -- commit ------------------------------------------------------------

    def _commit(self, rep: _FleetReplica, res: RequestResult):
        """Fold one replica-local terminal result into the global
        ledger — exactly one result per gid, ever. ``handed_off``
        results never reach here (the hand-off disposition arrives
        through the outbox instead)."""
        gid = rep.routed.pop(res.id, None)
        if gid is None:
            return None
        p = self._requests.get(gid)
        if p is None:
            return None
        p.copies = [
            c for c in p.copies
            if not (c.replica == rep.idx and c.rid == res.id)
        ]
        if p.committed:
            return None
        p.committed = True
        self._open.discard(gid)
        self._index_decref(p)
        for c in p.copies:
            other = self._rep(c.replica)
            other.routed.pop(c.rid, None)
            other.engine.cancel(c.rid)
        p.copies = []
        out = dataclasses.replace(res, id=gid, submitted_at=p.submitted_at)
        self._results[gid] = out
        return out

    # -- health / failover -------------------------------------------------

    def _probe(self, rep: _FleetReplica) -> None:
        """One health probe through the ``serve.health`` fault site —
        same scoring as the ReplicaSet probe (stall clock, degraded /
        SLO-burn demotion, recovery promotion)."""
        eng = rep.engine
        if self._faults is not None:
            try:
                self._faults.fire("serve.health", tick=eng.tick,
                                  replica=rep.idx)
            except Exception as e:  # noqa: BLE001 — ANY probe failure
                # means the replica cannot be trusted
                self._failover(rep, e, reason="health_probe")
                return
        h = eng.health_counters()
        if h["dead"]:
            self._failover(rep, None, reason="dead_engine")
            return
        now = self._clock()
        if h["tokens_generated"] != rep.last_tokens or not h["busy"]:
            rep.last_tokens = h["tokens_generated"]
            rep.last_progress_t = now
        elif now - rep.last_progress_t > self._probe_stall_s:
            self._failover(rep, None, reason="stalled")
            return
        if rep.state == "restoring":
            rep.state = "healthy"
            self.recorder.record("recovered", tick=self._tick,
                                 replica=rep.idx)
        if h["degraded"] or h["slo_burning"]:
            if rep.state == "healthy":
                rep.state = "degraded"
        elif rep.state == "degraded":
            rep.state = "healthy"

    def _failover(self, rep: _FleetReplica, cause, reason: str) -> None:
        """Quarantine + rebuild one replica from its last complete
        periodic snapshot (role preserved). Snapshot-covered requests
        resume from their emitted prefixes; requests routed AFTER the
        snapshot re-adopt from their prompts — greedy determinism
        keeps every final stream bit-identical. A rebuilt DECODE
        replica re-prefills locally (its pending hand-off payloads
        died with the old engine; decode engines keep full prefill
        capability for exactly this path)."""
        rep.state = "quarantined"
        rep.failovers += 1
        self._total_failovers += 1
        self._m_failovers.inc()
        old = rep.engine
        self.recorder.record(
            "failover", tick=self._tick, replica=rep.idx, role=rep.role,
            reason=reason, engine_tick=old.tick,
        )
        if self._total_failovers > self._max_failovers:
            err = FriendlyError(
                f"fleet exceeded max_failovers "
                f"({self._max_failovers}): replica {rep.idx} "
                f"({rep.role}) failed again ({reason}) — a "
                "deterministic crash is burning the rebuild loop; "
                "inspect the fault schedule or raise max_failovers"
            )
            if isinstance(cause, BaseException):
                raise err from cause
            raise err
        if not old._dead:
            old._park_after_kill()
        snap = old.last_snapshot
        rep.state = "restoring"
        eng = None
        snap_ids: set[int] = set()
        if snap is not None:
            try:
                eng = ServeEngine.restore(
                    snap, self._graph, self._variables, replica=rep.idx,
                    role=rep.role, faults=self._faults,
                    snapshot_every_ticks=self._snapshot_every,
                    **self._engine_kwargs,
                )
                snap_ids = {
                    int(e["id"])
                    for e in list(snap["active"]) + list(snap["queued"])
                }
            except SnapshotCorruption as e:
                # the snapshot's bytes changed since its checksum stamp:
                # resuming from it would be resuming from lying state.
                # Fall through to a fresh engine — every routed request
                # re-adopts from its prompt below, so the corruption
                # costs re-prefill work, never a wrong token.
                self._m_snapshot_checksum_failures.inc()
                self.recorder.record(
                    "integrity.snapshot_checksum", tick=self._tick,
                    replica=rep.idx, expected=e.expected,
                    actual=e.actual,
                )
                _log.warning(
                    "replica %d snapshot failed checksum verification "
                    "(%s); rebuilding fresh and re-admitting from "
                    "prompts", rep.idx, e,
                )
        if eng is None:
            eng = self._build_engine(rep.idx, rep.role)
            snap_ids = set()
        new_routed: dict[int, int] = {}
        missing: list[tuple[int, int]] = []
        for rid, gid in rep.routed.items():
            if rid in snap_ids:
                new_routed[rid] = gid
            else:
                missing.append((rid, gid))
        for sid in sorted(snap_ids):
            if sid not in rep.routed:
                eng.cancel(sid)
        resumed = len(new_routed)
        for rid, gid in sorted(missing):
            p = self._requests[gid]
            new_rid = eng.adopt(
                p.prompt, max_new_tokens=p.max_new_tokens,
                eos_id=p.eos_id, trace_id=p.trace_id,
            )
            new_routed[new_rid] = gid
            for c in p.copies:
                if c.replica == rep.idx and c.rid == rid:
                    c.rid = new_rid
        rep.engine = eng
        rep.routed = new_routed
        rep.last_tokens = -1
        rep.last_progress_t = self._clock()
        self.recorder.record(
            "restored", tick=self._tick, replica=rep.idx,
            role=rep.role, resumed=resumed, resubmitted=len(missing),
        )

    # -- drain -------------------------------------------------------------

    def drain(self, replica: int) -> None:
        """Zero-loss drain (same contract as the ReplicaSet): stop
        admissions, migrate pending requests to same-role survivors
        (emitted tokens ride along as resume prefixes), retire. With
        no same-role survivor the replica serves its own backlog and
        retires when idle."""
        rep = self._rep(replica)
        if rep.state in ("draining", "drained"):
            raise FriendlyError(
                f"replica {replica} is already {rep.state}"
            )
        if rep.state == "quarantined":
            raise FriendlyError(
                f"replica {replica} is quarantined mid-failover; it "
                "cannot drain"
            )
        rep.state = "draining"
        self.recorder.record(
            "drain", tick=self._tick, replica=replica, role=rep.role,
            pending=len(rep.routed),
        )
        survivors = [
            r for r in self._role_reps(rep.role, live_only=True)
            if r.idx != rep.idx
        ]
        if survivors:
            for pay in rep.engine.steal_all():
                gid = rep.routed.pop(pay["id"], None)
                if gid is None:
                    continue
                target = self._route_order(
                    rep.role, exclude={rep.idx}
                )[0]
                new_rid = target.engine.adopt(
                    pay["prompt"], prefix=pay["prefix"],
                    max_new_tokens=pay["max_new_tokens"],
                    eos_id=pay["eos_id"],
                    trace_id=pay.get("trace_id") or None,
                )
                target.routed[new_rid] = gid
                p = self._requests[gid]
                for c in p.copies:
                    if c.replica == rep.idx and c.rid == pay["id"]:
                        c.replica = target.idx
                        c.rid = new_rid
                self.recorder.record(
                    "migrated", tick=self._tick, gid=gid,
                    src=rep.idx, dst=target.idx,
                    prefix_len=len(pay["prefix"]),
                    trace=pay.get("trace_id", ""),
                )
        if not rep.engine.busy and not rep.routed:
            self._retire(rep)

    def _retire(self, rep: _FleetReplica) -> None:
        rep.state = "drained"
        self._m_drains.inc()
        # the drained replica's pages are gone; drop it from locality
        # preferences so future hits route to replicas that hold them
        for entry in self._index.values():
            entry.home.discard(rep.idx)
        self.recorder.record("drained", tick=self._tick,
                             replica=rep.idx, role=rep.role)

    # -- autoscaling -------------------------------------------------------

    def _autoscale_tick(self) -> None:
        """One policy evaluation: scale a role up when its mean
        per-replica load or the SLO consecutive-burn streak crosses
        the policy thresholds (budget permitting), else drain one
        sufficiently idle replica back to the parked budget. One
        action per evaluation, cooldown-gated."""
        pol = self._autoscale
        if pol is None:
            return
        # idle clocks advance every fleet tick regardless of cooldown
        for rep in self._reps:
            if rep.state in _LIVE_RANK and not rep.engine.busy \
                    and not rep.routed:
                rep.idle_ticks += 1
            else:
                rep.idle_ticks = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        for role in ("decode", "prefill"):
            live = self._role_reps(role, live_only=True)
            if not live:
                continue
            hi = pol.max_decode if role == "decode" else pol.max_prefill
            load = sum(
                r.engine.queue_depth + r.engine.pool.leased_count
                for r in live
            ) / len(live)
            burn = max(
                r.engine.health_counters()["slo_burn_ticks"]
                for r in live
            )
            slo_up = pol.slo_burn_ticks > 0 and burn >= pol.slo_burn_ticks
            if (
                (load > pol.queue_high or slo_up)
                and len(live) < hi and self._parked[role] > 0
            ):
                rep = self._spawn(role)
                self._parked[role] -= 1
                self._m_scale_ups.inc()
                self._cooldown = pol.cooldown_ticks
                self.recorder.record(
                    "scale_up", tick=self._tick, replica=rep.idx,
                    role=role, load=round(load, 2), slo_burn=burn,
                )
                return
        for role in ("decode", "prefill"):
            live = self._role_reps(role, live_only=True)
            lo = pol.min_decode if role == "decode" else pol.min_prefill
            if len(live) <= lo:
                continue
            # retire the most recently spawned idle replica first
            for rep in sorted(live, key=lambda r: -r.idx):
                if rep.idle_ticks >= pol.idle_ticks:
                    self.drain(rep.idx)
                    self._parked[role] += 1
                    self._m_scale_downs.inc()
                    self._cooldown = pol.cooldown_ticks
                    self.recorder.record(
                        "scale_down", tick=self._tick,
                        replica=rep.idx, role=role,
                        idle_ticks=rep.idle_ticks,
                    )
                    return

    # -- the tick loop -----------------------------------------------------

    def step(self) -> list[RequestResult]:
        """One fleet tick: step prefill replicas and route their
        hand-off payloads (indexing each fleet-wide), step decode
        replicas and commit terminal results, probe health, then
        evaluate the autoscale policy. Returns the results COMMITTED
        this tick, keyed by global id."""
        out: list[RequestResult] = []
        ordered = (
            self._role_reps("prefill") + self._role_reps("decode")
        )
        for rep in ordered:
            if rep.state in ("quarantined", "drained"):
                continue
            if rep.state == "draining":
                if not rep.engine.busy and not rep.routed:
                    self._retire(rep)
                    continue
            elif not rep.engine.busy:
                # idle standby: skip the device tick, keep probing
                self._probe(rep)
                continue
            try:
                finished = rep.engine.step()
            except EngineKilled as e:
                self._failover(rep, e, reason="killed")
                continue
            for res in finished:
                if res.status == "handed_off":
                    # the disposition arrives with the payload below
                    continue
                committed = self._commit(rep, res)
                if committed is not None:
                    out.append(committed)
            if rep.role == "prefill":
                self._collect_handoffs(rep)
            self._probe(rep)
        self._autoscale_tick()
        self._tick += 1
        return out

    def run(self, max_ticks: int = 100_000) -> dict[int, RequestResult]:
        """Step until every submitted request commits; results keyed
        by global id. Hitting ``max_ticks`` retires every open request
        as ``"stalled"`` and raises the typed error with partial
        results attached as ``err.results``."""
        start = self._tick
        with self.recorder.dump_on_friendly_error():
            while self._open:
                if self._tick - start >= max_ticks:
                    self._stall_open()
                    err = FriendlyError(
                        f"DisaggFleet run() exceeded max_ticks "
                        f"({max_ticks}) with requests still open; "
                        "partial results (completed + 'stalled') are "
                        "attached as err.results"
                    )
                    err.results = dict(self._results)
                    raise err
                self.step()
        return dict(self._results)

    def _stall_open(self) -> None:
        best: dict[int, np.ndarray] = {}
        for rep in self._reps:
            if rep.state in ("quarantined", "drained"):
                continue
            for pay in rep.engine.steal_all():
                gid = rep.routed.pop(pay["id"], None)
                if gid is None:
                    continue
                prev = best.get(gid)
                if prev is None or len(pay["prefix"]) > len(prev):
                    best[gid] = pay["prefix"]
            rep.routed.clear()
        now = self._clock()
        for gid in sorted(self._open):
            p = self._requests[gid]
            self._index_decref(p)
            prefix = np.asarray(best.get(gid, ()), np.int32)
            p.committed = True
            p.copies = []
            self._results[gid] = RequestResult(
                id=gid, status="stalled",
                tokens=np.concatenate([p.prompt, prefix]),
                prompt_len=len(p.prompt), generated=len(prefix),
                submit_tick=p.submit_tick, first_token_tick=None,
                finish_tick=self._tick, wall_s=now - p.submit_t,
                submitted_at=p.submitted_at,
            )
        self._open.clear()

    # -- checkpoint / restore ----------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able checkpoint of the FLEET's host-side state: the
        ledger of open requests with the longest emitted prefix each
        stream's current replica has checkpointed, plus per-role
        replica counts. Like the engine's snapshot it carries NO
        device state and no KV: :meth:`restore` re-submits every open
        request with its emitted prefix, and greedy determinism makes
        every post-restore stream bit-identical. The prefix index is
        deliberately not snapshotted — it is a cache, rebuilt by
        traffic."""
        emitted: dict[int, list[int]] = {}
        for rep in self._reps:
            if rep.state in ("quarantined", "drained"):
                continue
            snap = rep.engine.snapshot()
            by_rid = {
                int(e["id"]): [int(x) for x in e["emitted"]]
                for e in list(snap["active"]) + list(snap["queued"])
            }
            for rid, gid in rep.routed.items():
                toks = by_rid.get(rid)
                if toks is not None and (
                    gid not in emitted or len(toks) > len(emitted[gid])
                ):
                    emitted[gid] = toks
        open_reqs = []
        for gid in sorted(self._open):
            p = self._requests[gid]
            open_reqs.append({
                "gid": gid,
                "prompt": [int(x) for x in p.prompt],
                "emitted": emitted.get(gid, []),
                "max_new_tokens": p.max_new_tokens,
                "eos_id": p.eos_id,
                "trace": p.trace_id,
            })
        return {
            "version": 1,
            "model": self._graph.name,
            "prefill_replicas": len(self._role_reps("prefill",
                                                    live_only=True)),
            "decode_replicas": len(self._role_reps("decode",
                                                   live_only=True)),
            "tick": self._tick,
            "next_gid": self._next_gid,
            "open": open_reqs,
        }

    @classmethod
    def restore(cls, snapshot: dict, graph, variables,
                **kwargs) -> "DisaggFleet":
        """Rebuild a fleet from :meth:`snapshot`: fresh replicas at
        the checkpointed per-role counts, every open request
        re-submitted with its emitted tokens as a resume prefix (the
        stream continues bit-identically; results keep their global
        ids)."""
        if snapshot.get("version") != 1:
            raise FriendlyError(
                f"unknown fleet snapshot version "
                f"{snapshot.get('version')!r} (this build reads "
                "version 1)"
            )
        if snapshot.get("model") != graph.name:
            raise FriendlyError(
                f"snapshot is for model {snapshot.get('model')!r}, "
                f"cannot restore onto {graph.name!r}"
            )
        kwargs.setdefault("prefill_replicas",
                          int(snapshot["prefill_replicas"]))
        kwargs.setdefault("decode_replicas",
                          int(snapshot["decode_replicas"]))
        fleet = cls(graph, variables, **kwargs)
        fleet._tick = int(snapshot["tick"])
        for entry in snapshot["open"]:
            gid = int(entry["gid"])
            prompt = np.asarray(entry["prompt"], np.int32)
            prefix = np.asarray(entry.get("emitted", ()), np.int32)
            p = _Pending(
                gid=gid, prompt=prompt,
                max_new_tokens=int(entry["max_new_tokens"]),
                eos_id=entry["eos_id"], deadline_ticks=None,
                submit_t=fleet._clock(), submit_tick=fleet._tick,
                trace_id=str(entry.get("trace") or f"f{gid}"),
            )
            # emitted tokens resume through adopt (prefix re-prefill);
            # fresh requests route through the normal prefill path
            order = fleet._route_order("prefill")
            if len(prefix) or not order:
                order = fleet._route_order("decode")
            target = order[0]
            rid = target.engine.adopt(
                prompt, prefix=prefix,
                max_new_tokens=int(entry["max_new_tokens"]),
                eos_id=entry["eos_id"], trace_id=p.trace_id,
            )
            target.routed[rid] = gid
            p.copies = [_Copy(target.idx, rid)]
            if len(prefix) or not fleet._role_reps("prefill",
                                                   live_only=True):
                p.stage = "decode"
            fleet._requests[gid] = p
            fleet._open.add(gid)
        fleet._next_gid = int(snapshot["next_gid"])
        return fleet

    # -- metrics -----------------------------------------------------------

    @property
    def replica_failovers_total(self) -> int:
        return self._m_failovers.value

    @property
    def drains_total(self) -> int:
        return self._m_drains.value

    @property
    def handoffs_total(self) -> int:
        return self._m_handoffs.value

    @property
    def fleet_prefix_hits_total(self) -> int:
        return self._m_index_hits.value

    @property
    def fleet_prefill_tokens_saved_total(self) -> int:
        return self._m_tokens_saved.value

    @property
    def scale_ups_total(self) -> int:
        return self._m_scale_ups.value

    @property
    def scale_downs_total(self) -> int:
        return self._m_scale_downs.value

    def ttft_p99_ms(self) -> float:
        """Fleet-level TTFT p99 (submit -> first token known), merged
        from the prefill replicas' first-token histograms (the precise
        admission-time wall clock) and the fleet's index-hit samples
        (route time — the first token was cached); 0.0 before any
        first token. Decode replicas' histograms are deliberately excluded: an
        adopted request's "first token" there is hand-off latency,
        not TTFT."""
        samples = list(self._ttft_ms)
        for rep in self._reps:
            if rep.role == "prefill":
                samples += [
                    t * 1e3 for t in rep.engine.metrics.ttft_s
                ]
        return _p99(samples)

    def metrics_dict(self) -> dict:
        """Flat fleet metrics + per-role aggregates + one nested dict
        per replica — the JAX package's keys."""
        by_status = {"completed": 0, "failed": 0, "expired": 0,
                     "stalled": 0}
        committed_tokens = 0
        for res in self._results.values():
            by_status[res.status] = by_status.get(res.status, 0) + 1
            committed_tokens += res.generated
        per_replica = {}
        per_role = {
            role: {
                "replicas": 0,
                "submitted": 0,
                "tokens_generated": 0,
                "queue_depth": 0,
                "handoffs_out_total": 0,
                "handoffs_adopted_total": 0,
                "handoff_fallbacks_total": 0,
            }
            for role in ROLES
        }
        handoff_fallbacks = 0
        integrity_handoff_failures = 0
        wall = 0.0
        for rep in self._reps:
            m = rep.engine.metrics
            d = m.to_dict()
            wall = max(wall, d["wall_s"] or 0.0)
            handoff_fallbacks += d["handoff_fallbacks_total"]
            integrity_handoff_failures += d[
                "integrity_handoff_checksum_failures_total"
            ]
            if rep.state in _LIVE_RANK:
                agg = per_role[rep.role]
                agg["replicas"] += 1
                agg["submitted"] += d["submitted"]
                agg["tokens_generated"] += d["tokens_generated"]
                agg["queue_depth"] += rep.engine.queue_depth
                agg["handoffs_out_total"] += d["handoffs_out_total"]
                agg["handoffs_adopted_total"] += (
                    d["handoffs_adopted_total"]
                )
                agg["handoff_fallbacks_total"] += (
                    d["handoff_fallbacks_total"]
                )
            per_replica[f"replica{rep.idx}"] = {
                "role": rep.role,
                "state": rep.state,
                "failovers": rep.failovers,
                "ticks": d["ticks"],
                "submitted": d["submitted"],
                "completed": d["completed"],
                "failed": d["failed"],
                "expired": d["expired"],
                "tokens_generated": d["tokens_generated"],
                "handoffs_out_total": d["handoffs_out_total"],
                "handoffs_adopted_total": d["handoffs_adopted_total"],
                "handoff_fallbacks_total": (
                    d["handoff_fallbacks_total"]
                ),
                "retries_total": d["retries_total"],
                "quarantined_total": d["quarantined_total"],
                "snapshots_total": d["snapshots_total"],
                "snapshot_failures_total": d["snapshot_failures_total"],
                "cancelled_total": d["cancelled_total"],
                "degraded_mode": d["degraded_mode"],
                "queue_depth": rep.engine.queue_depth,
                "decode_compile_count": rep.engine.decode_compile_count,
                "prefill_compile_count": (
                    rep.engine.prefill_compile_count
                ),
                "chunked_prefills_total": d["chunked_prefills_total"],
                "overlapped_dispatches_total": (
                    d["overlapped_dispatches_total"]
                ),
                "host_idle_fraction": d["host_idle_fraction"],
            }
        idx = self.prefix_index_stats()
        return {
            "disagg": True,
            "prefill_replicas": self.prefill_replicas,
            "decode_replicas": self.decode_replicas,
            "fleet_ticks": self._tick,
            "submitted": self._next_gid,
            "completed": by_status["completed"],
            "failed": by_status["failed"],
            "expired": by_status["expired"],
            "stalled": by_status["stalled"],
            "tokens_generated": committed_tokens,
            "tokens_per_sec": (
                round(committed_tokens / wall, 1) if wall > 0 else None
            ),
            "wall_s": round(wall, 4),
            "ttft_ms_p99": round(self.ttft_p99_ms(), 3),
            "handoffs_total": self.handoffs_total,
            "handoff_fallbacks_total": handoff_fallbacks,
            "fleet_prefix_hits_total": self.fleet_prefix_hits_total,
            "fleet_prefix_entries": idx["entries"],
            "fleet_prefill_tokens_saved_total": (
                self.fleet_prefill_tokens_saved_total
            ),
            "replica_failovers_total": self.replica_failovers_total,
            "integrity_snapshot_checksum_failures_total": (
                self._m_snapshot_checksum_failures.value
            ),
            "integrity_handoff_checksum_failures_total": (
                integrity_handoff_failures
            ),
            "drains_total": self.drains_total,
            "scale_ups_total": self.scale_ups_total,
            "scale_downs_total": self.scale_downs_total,
            "parked_prefill": self._parked["prefill"],
            "parked_decode": self._parked["decode"],
            "autoscale": (
                self._autoscale.to_dict()
                if self._autoscale is not None else None
            ),
            "per_role": per_role,
            "per_replica": per_replica,
        }
