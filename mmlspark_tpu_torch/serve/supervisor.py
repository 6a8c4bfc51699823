"""``ReplicaSet`` — the replicated serving control plane, the port of
``mmlspark_tpu/serve/supervisor.py``.

Owns N :class:`~mmlspark_tpu_torch.serve.engine.ServeEngine` replicas
(each with its own slot pool, program ladder and graph pool; all serving
one model's weights) behind a single ``submit()/run()`` facade, and
keeps requests flowing when replicas fail:

- **Health model** — every supervisor tick probes each replica through
  the ``serve.health`` fault site and scores the engine's host-side
  :meth:`~ServeEngine.health_counters`: token progress (liveness),
  degradation and SLO burn (readiness). The probe clock is injectable,
  so stall detection is deterministic under test.
- **Failover** — an :class:`EngineKilled` escaping a replica's step (or
  a failed probe) quarantines the replica, parks the dead engine (its
  slots, paged mappings and captured programs released) and rebuilds
  it from its last PERIODIC snapshot (``snapshot_every_ticks``).
  In-flight requests resume through the emitted-prefix path: the
  rebuilt engine re-prefills prompt + prefix, and greedy determinism
  makes every final stream equal to a no-failure run; requests routed
  after the snapshot re-submit from their prompts. ``max_failovers``
  caps the rebuild loop.
- **Routing and hedging** — ``submit`` routes to the healthiest,
  least-loaded replica (state rank, queue depth + leased slots, TTFT
  p99). With ``hedge_ms`` set, a request older than the hedge deadline
  duplicates onto a second replica; FIRST-COMMITTED-WINS: the first copy
  to complete commits, the loser is cancelled and its emitted tokens
  count as ``hedge_wasted_tokens_total``. Exactly one result per
  request.
- **Zero-loss drain** — :meth:`drain` stops admissions to a replica,
  migrates its pending requests to the survivors (``steal_all`` /
  ``adopt``) and retires it.
- **Model routing** — with ``models={name: (graph, variables)}`` the
  replicas partition round-robin over the models in insertion order, and
  every routing decision (submit, hedge, drain migration, failover
  rebuild) stays within ONE model's replicas: the routing key is
  ``(model, health, load)``.

Pure host-side control: the supervisor never touches device buffers,
and reads no clock on the engines' hot path, so every per-replica
invariant (program pins, one fetch a decode block) holds exactly as on
an unsupervised engine.

**Mesh replicas** (``mesh=`` among the engine kwargs): every replica is a
mesh engine over the same mesh, and every rank runs this same control
plane. Its decisions must then be the same on every rank, so what reads
a rank's own clock is agreed over the mesh: the default clock is the
mesh's (``MeshPlace.clock``, the latest of the ranks' readings) and the
routing key's TTFT p99 is each replica's worst over the ranks
(:func:`agreed_ttft`).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import EngineKilled, FaultInjector
from mmlspark_tpu_torch.core.integrity import SnapshotCorruption
from mmlspark_tpu_torch.core.telemetry import FlightRecorder, MetricRegistry
from mmlspark_tpu_torch.parallel.mesh import serve_mesh
from mmlspark_tpu_torch.serve.engine import ServeEngine
from mmlspark_tpu_torch.serve.scheduler import RequestResult

#: replica states that accept routed work (rank = routing preference)
_LIVE_RANK = {"healthy": 0, "degraded": 1, "restoring": 2}
#: every reachable replica state, for validation/docs
STATES = (
    "healthy", "degraded", "draining", "quarantined", "restoring",
    "drained",
)


@dataclass
class _Copy:
    """One engine-local copy of a request: which replica holds it and
    under which engine-local id (the supervisor's global id maps to 1+
    of these while hedged)."""

    replica: int
    rid: int


@dataclass
class _Pending:
    """Supervisor-side record of one submitted request — everything
    needed to re-route it (failover/drain) or duplicate it (hedge)."""

    gid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None
    deadline_ticks: int | None
    submit_t: float
    submit_tick: int
    copies: list[_Copy] = field(default_factory=list)
    hedged: bool = False
    committed: bool = False
    #: which model this request belongs to (multi-model sets route,
    #: hedge and migrate strictly within one model's replicas)
    model: str | None = None
    #: the set-wide trace-context id (``g{gid}``): every copy — hedge
    #: twins, failover replays, drain migrations — submits with it, so
    #: all of a request's fragments across replicas join on one id
    trace_id: str = ""
    #: ``time.perf_counter()`` when the set took the request: its
    #: result's ``submitted_at``, whichever copy commits
    submitted_at: float = field(default_factory=time.perf_counter)


@dataclass
class _Replica:
    """One managed engine + its control-plane state."""

    idx: int
    engine: ServeEngine
    state: str = "healthy"
    #: engine-local request id -> supervisor global id, for every
    #: uncommitted copy routed to this replica
    routed: dict[int, int] = field(default_factory=dict)
    failovers: int = 0
    #: last observed token-progress figure + the probe-clock time it
    #: last ADVANCED (or the replica was idle) — the stall detector
    last_tokens: int = -1
    last_progress_t: float = 0.0
    #: the model this replica serves (None on single-model sets): the
    #: routing key's first dimension — (model, health, load)
    model: str | None = None


def mesh_clock(place):
    """A control plane's default clock: ``time.monotonic``, or over a
    serving mesh of several ranks the mesh's agreed clock."""
    if place is not None and place.control is not None:
        return place.clock
    return time.monotonic


def agreed_ttft(place, reps) -> dict[int, float]:
    """Replica index -> its engine's TTFT p99 in ms (a routing key), over
    a serving mesh the worst of every rank's reading, so every rank
    routes alike."""
    vals = [r.engine.metrics.ttft_p99_ms() for r in reps]
    if place is not None and vals:
        vals = place.agree_max(vals)
    return {r.idx: v for r, v in zip(reps, vals)}


class ReplicaSet:
    """N health-checked ServeEngine replicas behind one facade.

    ``clock`` (default ``time.monotonic``) drives hedging deadlines and
    stall probes — inject a fake for deterministic tests. ``faults`` is
    ONE shared :class:`FaultInjector` whose replica-pinned entries
    target individual engines (``Fault(..., replica=1)``). Remaining
    ``**engine_kwargs`` (slots, cache_len, paged, device, ...) configure
    every replica identically — migration requires equal cache
    geometry.
    """

    def __init__(self, graph, variables, *, replicas: int = 2,
                 hedge_ms: float | None = None,
                 snapshot_every_ticks: int | None = 4,
                 probe_stall_s: float = 30.0,
                 clock=None,
                 recorder: FlightRecorder | None = None,
                 faults: FaultInjector | None = None,
                 max_failovers: int = 8,
                 models: dict | None = None,
                 **engine_kwargs):
        if replicas < 1:
            raise FriendlyError(f"replicas must be >= 1, got {replicas}")
        if models is not None:
            if not models:
                raise FriendlyError(
                    "models= must name at least one model; for a "
                    "single-model set pass (graph, variables) "
                    "positionally instead"
                )
            if replicas < len(models):
                raise FriendlyError(
                    f"replicas ({replicas}) < models ({len(models)}); "
                    "every model needs at least one replica to route to"
                )
            for mname, pair in models.items():
                if not (isinstance(pair, tuple) and len(pair) == 2):
                    raise FriendlyError(
                        f"models[{mname!r}] must be a (graph, "
                        "variables) pair"
                    )
        self._models = dict(models) if models is not None else None
        if hedge_ms is not None and hedge_ms < 0:
            raise FriendlyError(
                f"hedge_ms must be >= 0, got {hedge_ms}"
            )
        if max_failovers < 0:
            raise FriendlyError(
                f"max_failovers must be >= 0, got {max_failovers}"
            )
        for key in ("replica", "faults", "snapshot_every_ticks",
                    "recorder"):
            if key in engine_kwargs:
                raise FriendlyError(
                    f"'{key}' is managed by ReplicaSet — pass it to the "
                    "ReplicaSet constructor, not through engine kwargs"
                )
        self._graph = graph
        self._variables = variables
        self._engine_kwargs = dict(engine_kwargs)
        self._snapshot_every = snapshot_every_ticks
        self._hedge_ms = hedge_ms
        self._probe_stall_s = probe_stall_s
        #: the replicas' serving mesh (None: one device each)
        self._place = serve_mesh(engine_kwargs.get("mesh"))
        self._clock = clock if clock is not None else mesh_clock(self._place)
        self._faults = faults
        self._max_failovers = max_failovers
        #: the supervisor's OWN flight recorder (routing, failover,
        #: hedge and drain events); each engine keeps its own
        self.recorder = (
            recorder if recorder is not None else FlightRecorder()
        )
        # claim the shared injector's listener BEFORE engines can (an
        # engine only claims it when unset): fault events from every
        # replica land in ONE control-plane timeline
        if faults is not None and faults.listener is None:
            def _on_fault(kind: str, site: str) -> None:
                self.recorder.record("fault_injected", tick=self._tick,
                                     kind=kind, site=site)
            faults.listener = _on_fault
        #: supervisor-level metric registry (the engines' registries
        #: are separate; their serve.* names carry the ``replica{i}.``
        #: namespace so expositions can be concatenated without
        #: collisions on the serve plane)
        self.registry = MetricRegistry()
        r = self.registry
        self._m_failovers = r.counter("serve.replica_failovers")
        self._m_hedges = r.counter("serve.hedges")
        self._m_hedge_waste = r.counter("serve.hedge_wasted_tokens")
        self._m_drains = r.counter("serve.drains")
        self._m_snapshot_checksum_failures = r.counter(
            "serve.integrity.snapshot_checksum_failures"
        )
        self._tick = 0
        self._next_gid = 0
        self._total_failovers = 0
        #: gid -> _Pending, kept after commit for dup accounting
        self._requests: dict[int, _Pending] = {}
        #: gids not yet committed (run()'s loop condition)
        self._open: set[int] = set()
        #: gid -> committed RequestResult
        self._results: dict[int, RequestResult] = {}
        self._reps = [
            _Replica(idx=i, engine=self._build_engine(i),
                     model=self._model_name(i))
            for i in range(replicas)
        ]
        now = self._clock()
        for rep in self._reps:
            rep.last_progress_t = now
            # baseline recovery point: a replica killed before its
            # first periodic checkpoint still restores (to empty)
            rep.engine.checkpoint()

    def _model_name(self, idx: int) -> str | None:
        """Which model replica ``idx`` serves: round-robin over the
        models in insertion order; None on single-model sets."""
        if self._models is None:
            return None
        names = list(self._models)
        return names[idx % len(names)]

    def _model_src(self, idx: int):
        """The (graph, variables) a replica builds and restores from."""
        name = self._model_name(idx)
        if name is None:
            return self._graph, self._variables
        return self._models[name]

    def _build_engine(self, idx: int) -> ServeEngine:
        graph, variables = self._model_src(idx)
        return ServeEngine(
            graph, variables, replica=idx,
            faults=self._faults,
            snapshot_every_ticks=self._snapshot_every,
            **self._engine_kwargs,
        )

    # -- introspection -----------------------------------------------------

    @property
    def replicas(self) -> int:
        return len(self._reps)

    @property
    def tick(self) -> int:
        """Supervisor ticks (one per :meth:`step`); each replica keeps
        its own engine tick counter."""
        return self._tick

    @property
    def busy(self) -> bool:
        return bool(self._open)

    @property
    def models(self) -> list[str] | None:
        """Served model names (insertion order) on a multi-model set;
        None on a single-model set."""
        return list(self._models) if self._models is not None else None

    def replica_model(self, idx: int) -> str | None:
        return self._rep(idx).model

    def replica_state(self, idx: int) -> str:
        return self._rep(idx).state

    def engine(self, idx: int) -> ServeEngine:
        """The replica's CURRENT engine (failover swaps it)."""
        return self._rep(idx).engine

    def _rep(self, idx: int) -> _Replica:
        if not 0 <= idx < len(self._reps):
            raise FriendlyError(
                f"replica index {idx} out of range (this set has "
                f"{len(self._reps)} replicas)"
            )
        return self._reps[idx]

    # -- routing -----------------------------------------------------------

    def _route_order(self, exclude: set[int] = frozenset(),
                     model: str | None = None) -> list[_Replica]:
        """Live replicas, best route first: model (a request only ever
        routes within its own model's replicas), then state rank
        (healthy before degraded before restoring), then load (queue
        depth + leased slots), then TTFT p99, then index for
        determinism."""
        live = [
            r for r in self._reps
            if r.state in _LIVE_RANK and r.idx not in exclude
            and r.model == model
        ]
        ttft = agreed_ttft(self._place, live)
        return sorted(live, key=lambda r: (
            _LIVE_RANK[r.state],
            r.engine.queue_depth + r.engine.pool.leased_count,
            # 0.0 on a cold replica's empty histogram (the helper's
            # contract) — cold replicas route as cheapest
            ttft[r.idx],
            r.idx,
        ))

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: int | None = None,
               deadline_ticks: int | None = None,
               model: str | None = None) -> int:
        """Route one request to the best live replica; returns its
        GLOBAL id (stable across failover, hedging and migration —
        results come back keyed by it). Raises the typed error when every
        live replica's queue is full (backpressure) or no replica is
        live. A multi-model set (``models=`` at construction) requires
        ``model=`` — the first routing dimension."""
        if self._models is not None:
            if model is None:
                raise FriendlyError(
                    "this replica set serves several models — pass "
                    f"model=<name>; models: {sorted(self._models)}"
                )
            if model not in self._models:
                raise FriendlyError(
                    f"unknown model '{model}'; models: "
                    f"{sorted(self._models)}"
                )
        elif model is not None:
            raise FriendlyError(
                "model= routing needs a multi-model set (pass models= "
                "to the ReplicaSet constructor)"
            )
        order = self._route_order(model=model)
        if not order:
            raise FriendlyError(
                "no live replica to route to (all drained or "
                "quarantined); drain fewer replicas or build a larger "
                "set"
            )
        target = next((r for r in order if not r.engine.queue_full),
                      order[0])
        # the trace id is minted BEFORE the engine call (the gid is
        # only consumed on success, so a rejected submit re-mints the
        # same id for the next request — no gap, no collision)
        trace = f"g{self._next_gid}"
        # target.engine.submit validates and may reject (queue full on
        # EVERY replica -> the best one's canonical rejection)
        rid = target.engine.submit(
            prompt, max_new_tokens, eos_id=eos_id,
            deadline_ticks=deadline_ticks, trace_id=trace,
        )
        gid = self._next_gid
        self._next_gid += 1
        target.routed[rid] = gid
        self._requests[gid] = _Pending(
            gid=gid,
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            deadline_ticks=deadline_ticks,
            submit_t=self._clock(),
            submit_tick=self._tick,
            copies=[_Copy(target.idx, rid)],
            trace_id=trace,
            model=model,
        )
        self._open.add(gid)
        self.recorder.record(
            "routed", tick=self._tick, gid=gid, replica=target.idx,
            rid=rid, model=model, trace=trace,
        )
        return gid

    # -- commit (first-committed-wins) -------------------------------------

    def _commit(self, rep: _Replica, res: RequestResult):
        """Fold one replica-local terminal result into the global
        ledger. A ``completed`` stream commits immediately; a
        non-completed status commits only when it is the LAST live copy
        (a hedge twin may still succeed). Committing cancels every
        surviving copy — exactly one result per gid, ever."""
        gid = rep.routed.pop(res.id, None)
        if gid is None:
            # a copy the supervisor already cancelled surfacing a late
            # terminal result — nothing to do
            return None
        p = self._requests.get(gid)
        if p is None:
            return None
        p.copies = [
            c for c in p.copies
            if not (c.replica == rep.idx and c.rid == res.id)
        ]
        if p.committed:
            # hedge race: the twin committed in this same supervisor
            # tick before this copy could be cancelled — its tokens are
            # pure waste, the committed stream already shipped
            self._m_hedge_waste.inc(res.generated)
            self.recorder.record(
                "hedge_dup", tick=self._tick, gid=gid, replica=rep.idx,
                wasted=res.generated,
            )
            return None
        if res.status != "completed" and p.copies:
            # this copy died (failed/expired) but a twin is still
            # running — let it race on
            self.recorder.record(
                "copy_lost", tick=self._tick, gid=gid, replica=rep.idx,
                status=res.status,
            )
            return None
        p.committed = True
        self._open.discard(gid)
        for c in p.copies:
            other = self._reps[c.replica]
            other.routed.pop(c.rid, None)
            emitted = other.engine.cancel(c.rid)
            if emitted:
                self._m_hedge_waste.inc(emitted)
            self.recorder.record(
                "hedge_cancel", tick=self._tick, gid=gid,
                replica=c.replica, wasted=emitted or 0,
            )
        p.copies = []
        out = dataclasses.replace(res, id=gid, submitted_at=p.submitted_at)
        self._results[gid] = out
        return out

    # -- health ------------------------------------------------------------

    def _probe(self, rep: _Replica) -> None:
        """One health probe: fire the ``serve.health`` fault site (an
        injected failure here IS a failed probe -> failover), then
        score the engine's counters — stalled progress past
        ``probe_stall_s`` fails the replica; degradation/SLO burn
        demotes it to ``degraded`` (routed around, still serving); a
        clean probe promotes ``restoring``/``degraded`` back up."""
        eng = rep.engine
        if self._faults is not None:
            try:
                self._faults.fire("serve.health", tick=eng.tick,
                                  replica=rep.idx)
            except Exception as e:  # noqa: BLE001 — ANY probe failure
                # (transient, kill, ...) means the replica cannot be
                # trusted: quarantine + failover
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

    # -- failover ----------------------------------------------------------

    def _failover(self, rep: _Replica, cause, reason: str) -> None:
        """Quarantine a failed replica and rebuild it from its last
        complete periodic snapshot (or fresh, if it never finished
        one). Snapshot-covered requests resume from their emitted
        prefixes on the rebuilt engine; requests routed AFTER the
        snapshot re-submit from their prompts. Already-committed gids
        whose (stale) snapshot entries would re-run are cancelled —
        exactly-once results survive the crash."""
        rep.state = "quarantined"
        rep.failovers += 1
        self._total_failovers += 1
        self._m_failovers.inc()
        old = rep.engine
        self.recorder.record(
            "failover", tick=self._tick, replica=rep.idx, reason=reason,
            engine_tick=old.tick,
        )
        if self._total_failovers > self._max_failovers:
            err = FriendlyError(
                f"replica set exceeded max_failovers "
                f"({self._max_failovers}): replica {rep.idx} failed "
                f"again ({reason}) — a deterministic crash is burning "
                "the rebuild loop; inspect the fault schedule or raise "
                "max_failovers"
            )
            if isinstance(cause, BaseException):
                raise err from cause
            raise err
        # park the old engine's device resources (slots back to the
        # pool, paged mappings released) — a probe-detected failure
        # leaves the engine un-parked, and the rebuilt engine must
        # never double-hold device state in this process
        if not old._dead:
            old._park_after_kill()
        snap = old.last_snapshot
        rep.state = "restoring"
        eng = None
        snap_ids: set[int] = set()
        if snap is not None:
            graph, variables = self._model_src(rep.idx)
            try:
                eng = ServeEngine.restore(
                    snap, graph, variables, replica=rep.idx,
                    faults=self._faults,
                    snapshot_every_ticks=self._snapshot_every,
                    **self._engine_kwargs,
                )
                snap_ids = {
                    int(e["id"])
                    for e in list(snap["active"]) + list(snap["queued"])
                }
            except SnapshotCorruption as e:
                # a snapshot whose bytes no longer match its stamp is
                # untrusted: rebuild fresh and re-admit every routed
                # request from its prompt below (re-prefill cost, never
                # a wrong token)
                self._m_snapshot_checksum_failures.inc()
                self.recorder.record(
                    "integrity.snapshot_checksum", tick=self._tick,
                    replica=rep.idx, expected=e.expected,
                    actual=e.actual,
                )
        if eng is None:
            eng = self._build_engine(rep.idx)
            snap_ids = set()
        # reconcile the routing table against what the snapshot
        # actually restored
        new_routed: dict[int, int] = {}
        missing: list[tuple[int, int]] = []
        for rid, gid in rep.routed.items():
            if rid in snap_ids:
                new_routed[rid] = gid
            else:
                missing.append((rid, gid))
        for sid in sorted(snap_ids):
            if sid not in rep.routed:
                # the stale snapshot would re-run a stream that already
                # committed (or was cancelled) — cancel, don't re-emit
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
            resumed=resumed, resubmitted=len(missing),
        )

    # -- hedging -----------------------------------------------------------

    def _maybe_hedge(self) -> None:
        """Duplicate requests older than the hedge deadline onto a
        second replica (tail-latency insurance). At most one hedge per
        request; first-committed-wins at commit time."""
        if self._hedge_ms is None:
            return
        now = self._clock()
        for gid in sorted(self._open):
            p = self._requests[gid]
            if p.hedged or len(p.copies) != 1:
                continue
            if (now - p.submit_t) * 1e3 < self._hedge_ms:
                continue
            holder = {c.replica for c in p.copies}
            # hedge within the request's own model only — a twin on
            # another model's replica would decode the wrong graph
            order = self._route_order(exclude=holder, model=p.model)
            target = next(
                (r for r in order if not r.engine.queue_full), None
            )
            if target is None:
                continue  # nowhere to hedge right now; retry next tick
            try:
                # the twin carries the SAME trace id: in the merged
                # trace both copies hang off one causal chain and the
                # loser is visibly the hedge that lost
                rid = target.engine.submit(
                    p.prompt, p.max_new_tokens, eos_id=p.eos_id,
                    trace_id=p.trace_id,
                )
            except FriendlyError:
                continue
            p.hedged = True
            p.copies.append(_Copy(target.idx, rid))
            target.routed[rid] = gid
            self._m_hedges.inc()
            self.recorder.record(
                "hedge", tick=self._tick, gid=gid, replica=target.idx,
                age_ms=round((now - p.submit_t) * 1e3, 3),
                trace=p.trace_id,
            )

    # -- drain -------------------------------------------------------------

    def drain(self, replica: int) -> None:
        """Zero-loss drain: stop admissions to the replica, migrate its
        pending requests to the survivors (emitted tokens ride along as
        resume prefixes — nothing re-emits, nothing is lost), and
        retire it. With no surviving replica it keeps serving its own
        backlog and retires when idle (step() notices)."""
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
            "drain", tick=self._tick, replica=replica,
            pending=len(rep.routed),
        )
        if self._route_order(exclude={rep.idx}, model=rep.model):
            for pay in rep.engine.steal_all():
                gid = rep.routed.pop(pay["id"], None)
                if gid is None:
                    continue
                # re-route per payload: migration load-balances too —
                # strictly within the drained replica's own model
                target = self._route_order(
                    exclude={rep.idx}, model=rep.model,
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

    def _retire(self, rep: _Replica) -> None:
        rep.state = "drained"
        self._m_drains.inc()
        self.recorder.record("drained", tick=self._tick,
                             replica=rep.idx)

    # -- the tick loop -----------------------------------------------------

    def step(self) -> list[RequestResult]:
        """One supervisor tick: step every live replica (catching
        kills -> failover), commit terminal results
        (first-committed-wins), probe health, then evaluate hedge
        deadlines. Returns the results COMMITTED this tick, keyed by
        global id."""
        out: list[RequestResult] = []
        for rep in self._reps:
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
                committed = self._commit(rep, res)
                if committed is not None:
                    out.append(committed)
            self._probe(rep)
        self._maybe_hedge()
        self._tick += 1
        return out

    def run(self, max_ticks: int = 100_000) -> dict[int, RequestResult]:
        """Step until every submitted request commits; results keyed by
        global id. Failures along the way (kills, failed probes) are
        absorbed by failover up to ``max_failovers``. Hitting
        ``max_ticks`` retires every open request with the definite
        status ``"stalled"`` (folding in whatever tokens its best copy
        had emitted) and raises the typed error with partial results
        attached as ``err.results``."""
        start = self._tick
        with self.recorder.dump_on_friendly_error():
            while self._open:
                if self._tick - start >= max_ticks:
                    self._stall_open()
                    err = FriendlyError(
                        f"ReplicaSet run() exceeded max_ticks "
                        f"({max_ticks}) with requests still open; "
                        "partial results (completed + 'stalled') are "
                        "attached as err.results"
                    )
                    err.results = dict(self._results)
                    raise err
                self.step()
        return dict(self._results)

    def _stall_open(self) -> None:
        """Retire every open gid as ``"stalled"``, keeping the longest
        emitted prefix any copy reached (steal_all folds active slots'
        tokens into prefixes first)."""
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

    # -- metrics -----------------------------------------------------------

    @property
    def replica_failovers_total(self) -> int:
        return self._m_failovers.value

    @property
    def hedges_total(self) -> int:
        return self._m_hedges.value

    @property
    def hedge_wasted_tokens_total(self) -> int:
        return self._m_hedge_waste.value

    @property
    def drains_total(self) -> int:
        return self._m_drains.value

    def metrics_dict(self) -> dict:
        """Flat control-plane metrics + one nested dict per replica
        (the engines' flat to_dict keys stay unprefixed; the nesting IS
        the namespacing here) — the JAX package's keys; a replica's
        ``model`` is None on a single-model set."""
        by_status = {"completed": 0, "failed": 0, "expired": 0,
                     "stalled": 0}
        committed_tokens = 0
        for res in self._results.values():
            by_status[res.status] = by_status.get(res.status, 0) + 1
            committed_tokens += res.generated
        per_replica = {}
        wall = 0.0
        for rep in self._reps:
            m = rep.engine.metrics
            d = m.to_dict()
            wall = max(wall, d["wall_s"] or 0.0)
            per_replica[f"replica{rep.idx}"] = {
                "state": rep.state,
                "model": rep.model,
                "failovers": rep.failovers,
                "ticks": d["ticks"],
                "submitted": d["submitted"],
                "completed": d["completed"],
                "failed": d["failed"],
                "expired": d["expired"],
                "tokens_generated": d["tokens_generated"],
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
        return {
            "replicas": len(self._reps),
            "hedge_ms": self._hedge_ms,
            "supervisor_ticks": self._tick,
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
            "replica_failovers_total": self.replica_failovers_total,
            "integrity_snapshot_checksum_failures_total": (
                self._m_snapshot_checksum_failures.value
            ),
            "hedges_total": self.hedges_total,
            "hedge_wasted_tokens_total": self.hedge_wasted_tokens_total,
            "drains_total": self.drains_total,
            "per_replica": per_replica,
        }
