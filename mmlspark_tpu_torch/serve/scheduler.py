"""Continuous-batching scheduler: queue, slot states and tick bookkeeping
for the serving engine — the port's own copy of
``mmlspark_tpu/serve/scheduler.py`` (numpy and ``FriendlyError`` only).

One TICK = admit joiners -> one fused decode BLOCK of up to T tokens for
every active slot -> retire finished sequences. A sequence hitting EOS
mid-block goes dead on the device (emitting pads for the rest of the
block) and frees its slot when the block's tokens are consumed. With
chunked prefill a request holds its slot in a FILL state while the engine
advances its fill one chunk a tick, and joins the decode batch when the
fill completes. The resilience layer's transitions — quarantine
(``fail``), preemption with a resume prefix, ``requeue`` and ``cancel`` —
and the async engine's identity fence (``consume(..., states=)``) are
here too, and so are the replica plane's hand-off transitions:
``handoff_all`` (a drain's migration of every pending request) and
``handoff_result`` (a prefill-role engine's ``"handed_off"`` terminal).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError

_EMPTY_PREFIX = np.zeros(0, np.int32)


@dataclass(frozen=True)
class ServeRequest:
    """One admitted-or-queued generation request (engine-internal; users
    go through ``ServeEngine.submit``, which validates and ids it)."""

    id: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    eos_id: int | None
    #: absolute tick by which the request must FINISH, else it expires
    #: (queued or mid-decode); None = no deadline
    deadline_tick: int | None
    submit_tick: int
    submit_wall: float
    #: tokens ALREADY generated before (re)admission — non-empty only
    #: for preempted or restored requests, whose admission re-prefills
    #: prompt + prefix so decode resumes exactly where it stopped (greedy
    #: determinism keeps the stream unchanged). Counts against
    #: ``max_new_tokens``.
    prefix: np.ndarray = field(default_factory=lambda: _EMPTY_PREFIX)
    #: trace-context id stamped at the first submit and carried through
    #: snapshots; the engine mints ``t{id}``
    trace_id: str = ""
    #: ``time.perf_counter()`` at the first admission and when the first
    #: token was in hand; a preempted request keeps both (a restored one
    #: starts afresh: a snapshot holds no host clock)
    admitted_at: float | None = None
    first_token_at: float | None = None


@dataclass
class RequestResult:
    """Terminal record for one request: ``status`` is ``"completed"``
    (budget or EOS reached), ``"expired"`` (deadline passed while queued
    or mid-decode), ``"failed"`` (quarantined by the engine's fault
    handling: a poisoned token stream, or a dispatch failure that retries
    could not absorb), ``"stalled"`` (``run()`` hit its ``max_ticks``
    bound) or ``"handed_off"`` (a prefill-role engine finished the
    prefill and shipped the KV to a decode replica). ``tokens`` includes
    the prompt, like ``generate()``, and for a non-completed status
    whatever was generated. ``submitted_at``, ``admitted_at`` and
    ``first_token_at`` are ``time.perf_counter()`` stamps (the profiler's
    timeline maps them through ``utils.profiling.clock_anchor``); None
    where the request never got that far."""

    id: int
    status: str
    tokens: np.ndarray
    prompt_len: int
    generated: int
    submit_tick: int
    first_token_tick: int | None
    finish_tick: int
    wall_s: float
    submitted_at: float | None = None
    admitted_at: float | None = None
    first_token_at: float | None = None


@dataclass
class _SlotState:
    """Decode-side state of one active slot."""

    req: ServeRequest
    pos: int  # absolute position the NEXT decode step writes
    last_token: int
    out: list = field(default_factory=list)
    first_token_tick: int = 0


@dataclass
class _FillState:
    """Chunked-prefill state of one slot mid-fill: the request holds its
    slot lease while the engine advances ``filled`` one chunk a tick, and
    joins the decode batch when ``filled`` reaches ``total``. ``carry`` is
    engine-owned (the fill's carry cache); ``keep`` is the prefix-cache
    resume frontier — positions ``[0, keep)`` came from a shared prefix
    and are already in the carry."""

    req: ServeRequest
    filled: int  # positions [0, filled) already computed into the carry
    total: int  # len(prompt) + len(prefix): the fill target
    keep: int = 0
    started_tick: int = 0
    carry: object = None


class ContinuousBatchScheduler:
    def __init__(self, pool, max_queue: int):
        if max_queue < 1:
            raise FriendlyError(f"max_queue must be >= 1, got {max_queue}")
        self.pool = pool
        self.max_queue = max_queue
        self.queue: deque[ServeRequest] = deque()
        self.active: dict[int, _SlotState] = {}  # slot -> state
        #: slot -> mid-fill state (empty with monolithic prefill)
        self.filling: dict[int, _FillState] = {}
        self.tick_count = 0

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def busy(self) -> bool:
        return bool(self.queue or self.active or self.filling)

    def enqueue(self, req: ServeRequest) -> None:
        """Admission control: the queue is BOUNDED — a full queue rejects
        at submit time with the typed error."""
        if len(self.queue) >= self.max_queue:
            raise FriendlyError(
                f"serve queue is full ({self.max_queue} requests "
                "waiting); step() the engine to drain it, or build the "
                "engine with a larger max_queue"
            )
        self.queue.append(req)

    def pop_next(self) -> ServeRequest:
        return self.queue.popleft()

    # -- tick phases -------------------------------------------------------

    def expire(self, tick: int) -> list[RequestResult]:
        """Retire every request (queued, filling or active) whose
        deadline has passed; active and filling expiries free their
        slot."""
        out: list[RequestResult] = []
        kept: deque[ServeRequest] = deque()
        for req in self.queue:
            if req.deadline_tick is not None and tick >= req.deadline_tick:
                out.append(self._queued_result(req, "expired", tick))
            else:
                kept.append(req)
        self.queue = kept
        for slot, st in list(self.active.items()):
            req = st.req
            if req.deadline_tick is not None and tick >= req.deadline_tick:
                del self.active[slot]
                self.pool.free(slot)
                out.append(self._finish(st, "expired", tick))
        for slot, fs in list(self.filling.items()):
            req = fs.req
            if req.deadline_tick is not None and tick >= req.deadline_tick:
                del self.filling[slot]
                self.pool.free(slot)
                out.append(self._queued_result(req, "expired", tick))
        return out

    # -- chunked prefill ---------------------------------------------------

    def start_fill(self, slot: int, req: ServeRequest, total: int,
                   keep: int, carry, tick: int) -> _FillState:
        """Begin a chunked fill in a freshly leased slot: the request
        leaves the queue and holds the slot while the engine's fill loop
        advances ``filled`` from ``keep`` toward ``total``."""
        fs = _FillState(req=req, filled=keep, total=total, keep=keep,
                        started_tick=tick, carry=carry)
        self.filling[slot] = fs
        return fs

    def fill_done(self, slot: int) -> _FillState:
        """Pop a completed (or abandoned) fill; the caller activates the
        request or frees the slot."""
        return self.filling.pop(slot)

    def activate(self, slot: int, req: ServeRequest, first_token: int,
                 tick: int) -> RequestResult | None:
        """Install a prefilled request into its slot. Returns a terminal
        result at once when the FIRST token already finishes it (budget
        reached, or the token is EOS) — the slot is freed without ever
        joining the decode batch. A request carrying a ``prefix`` was
        prefilled over prompt + prefix, so its decode frontier starts past
        the prefix and the prefix counts against the budget."""
        st = _SlotState(req=req, pos=len(req.prompt) + len(req.prefix),
                        last_token=first_token,
                        out=list(req.prefix) + [first_token],
                        first_token_tick=tick)
        if (
            len(st.out) >= req.max_new_tokens
            or (req.eos_id is not None and first_token == req.eos_id)
        ):
            self.pool.free(slot)
            return self._finish(st, "completed", tick)
        self.active[slot] = st
        return None

    def decode_block_inputs(
        self, pad_id: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Host-side inputs for one fused decode BLOCK: the ``(S,)``
        last-token, remaining-budget and EOS-id vectors (-1 = no EOS),
        plus the MINIMUM remaining budget over active slots — the engine
        clamps the block size to it, so budget death only ever lands on
        a block boundary. Positions and the live mask live on the device
        (``pool.positions`` / ``pool.live``). Free slots carry
        (pad, 0 budget, -1). Requires at least one active slot."""
        s = self.pool.num_slots
        tok = np.full((s,), pad_id, np.int32)
        rem = np.zeros((s,), np.int32)
        eos = np.full((s,), -1, np.int32)
        for slot, st in self.active.items():
            tok[slot] = st.last_token
            rem[slot] = st.req.max_new_tokens - len(st.out)
            eos[slot] = -1 if st.req.eos_id is None else st.req.eos_id
        min_rem = int(min(
            st.req.max_new_tokens - len(st.out)
            for st in self.active.values()
        ))
        return tok, rem, eos, min_rem

    def consume(
        self, token_block: np.ndarray, tick: int,
        states: dict[int, _SlotState] | None = None,
    ) -> tuple[list[RequestResult], dict[int, int]]:
        """Fold one fused decode BLOCK's ``(S, T)`` token output back into
        per-slot state: each active slot consumes its row left to right
        until its EOS or token budget retires it (later columns are
        device-emitted pads, discarded), freeing retired slots. Returns
        ``(finished results, {slot: real tokens consumed})``.

        ``states`` is the async engine's identity fence: the slot->state
        map captured AT DISPATCH. A block fetched a tick late feeds only
        rows whose slot still holds the SAME request — a slot retired
        after dispatch (expiry, quarantine, cancel, preemption) and
        perhaps re-leased contributes pads that belong to nobody."""
        token_block = np.asarray(token_block)
        if token_block.ndim == 1:
            token_block = token_block[:, None]
        finished: list[RequestResult] = []
        consumed: dict[int, int] = {}
        rows = self.active if states is None else states
        for slot, st in list(rows.items()):
            if states is not None and self.active.get(slot) is not st:
                continue
            req = st.req
            taken = 0
            for col in range(token_block.shape[1]):
                nxt = int(token_block[slot, col])
                st.out.append(nxt)
                st.pos += 1
                st.last_token = nxt
                taken += 1
                if len(st.out) >= req.max_new_tokens or (
                    req.eos_id is not None and nxt == req.eos_id
                ):
                    del self.active[slot]
                    self.pool.free(slot)
                    finished.append(self._finish(st, "completed", tick))
                    break
            consumed[slot] = taken
        return finished, consumed

    # -- fault handling (the engine's resilience layer calls these) --------

    def fail(self, slot: int, tick: int) -> RequestResult:
        """Quarantine one ACTIVE request: pop it, free its slot (which
        forces the device live mask dead and the position to 0), and
        retire it as ``"failed"`` — the blast radius of a poisoned or
        undispatchable request is that request."""
        st = self.active.pop(slot)
        self.pool.free(slot)
        return self._finish(st, "failed", tick)

    def fail_unactivated(self, req: ServeRequest,
                         tick: int) -> RequestResult:
        """Quarantine a request whose prefill never succeeded (its slot is
        freed by the caller, which still holds the lease)."""
        return self._queued_result(req, "failed", tick)

    def preempt(self, slot: int) -> ServeRequest:
        """Evict one ACTIVE request under memory pressure, folding its
        emitted tokens into a resume ``prefix``; the slot is freed and the
        caller requeues the returned request."""
        st = self.active.pop(slot)
        self.pool.free(slot)
        return dataclasses.replace(
            st.req, prefix=np.asarray(st.out, np.int32)
        )

    def requeue(self, req: ServeRequest) -> None:
        """Put a preempted request back at the FRONT of the queue,
        bypassing ``max_queue``: the engine already accepted it."""
        self.queue.appendleft(req)

    def cancel(self, request_id: int) -> int | None:
        """Remove one pending request WITHOUT a terminal result: a queued
        entry leaves the queue, an active or filling one frees its slot.
        Returns the count of tokens already emitted for it, or None when
        the id is unknown or already terminal."""
        for req in self.queue:
            if req.id == request_id:
                self.queue.remove(req)
                return len(req.prefix)
        for slot, st in list(self.active.items()):
            if st.req.id == request_id:
                del self.active[slot]
                self.pool.free(slot)
                return len(st.out)
        for slot, fs in list(self.filling.items()):
            if fs.req.id == request_id:
                del self.filling[slot]
                self.pool.free(slot)
                return len(fs.req.prefix)
        return None

    def handoff_all(self) -> list[ServeRequest]:
        """Pop EVERY pending request for migration to another replica:
        active slots preempt first (slots free, emitted tokens folded
        into resume prefixes — re-prefilling prompt + prefix elsewhere
        continues each stream unchanged), then mid-fill requests (the
        fill restarts from scratch on the adopting replica), then the
        queue in FIFO order. A zero-loss drain's hand-off."""
        out = [self.preempt(slot) for slot in sorted(self.active)]
        for slot in sorted(self.filling):
            fs = self.filling.pop(slot)
            self.pool.free(slot)
            out.append(fs.req)
        while self.queue:
            out.append(self.queue.popleft())
        return out

    def handoff_result(self, req: ServeRequest, first_token: int,
                       tick: int) -> RequestResult:
        """Terminal record for a PREFILL-ROLE engine: the request's KV
        and first token went to a decode replica, so it is terminal here
        with status ``"handed_off"`` and never activates a decode slot.
        ``tokens`` carries prompt + resume prefix + the first token — the
        frontier the decode replica resumes from."""
        return self._result(
            req, "handed_off",
            tokens=np.concatenate([
                req.prompt, req.prefix,
                np.asarray([first_token], np.int32),
            ]),
            generated=len(req.prefix) + 1,
            first_token_tick=tick, tick=tick,
        )

    def stall_pending(self, tick: int) -> list[RequestResult]:
        """Retire EVERY still-pending request (queued, active, filling)
        with the status ``"stalled"`` — ``run()``'s ``max_ticks`` bound
        calls this so no request is silently discarded."""
        out: list[RequestResult] = []
        while self.queue:
            out.append(self._queued_result(
                self.queue.popleft(), "stalled", tick
            ))
        for slot, st in sorted(self.active.items()):
            self.pool.free(slot)
            out.append(self._finish(st, "stalled", tick))
        self.active.clear()
        for slot, fs in sorted(self.filling.items()):
            self.pool.free(slot)
            out.append(self._queued_result(fs.req, "stalled", tick))
        self.filling.clear()
        return out

    # -- result assembly ---------------------------------------------------

    def _queued_result(self, req: ServeRequest, status: str,
                       tick: int) -> RequestResult:
        """Terminal record for a request that never (re)activated — its
        tokens are the prompt plus any resume prefix."""
        return self._result(
            req, status,
            tokens=np.concatenate([req.prompt, req.prefix]),
            generated=len(req.prefix), first_token_tick=None, tick=tick,
        )

    def _finish(self, st: _SlotState, status: str,
                tick: int) -> RequestResult:
        tokens = np.concatenate(
            [st.req.prompt, np.asarray(st.out, np.int32)]
        )
        return self._result(
            st.req, status, tokens=tokens, generated=len(st.out),
            first_token_tick=st.first_token_tick, tick=tick,
        )

    @staticmethod
    def _result(req: ServeRequest, status: str, *, tokens, generated: int,
                first_token_tick: int | None, tick: int) -> RequestResult:
        return RequestResult(
            id=req.id,
            status=status,
            tokens=np.asarray(tokens, np.int32),
            prompt_len=len(req.prompt),
            generated=generated,
            submit_tick=req.submit_tick,
            first_token_tick=first_token_tick,
            finish_tick=tick,
            wall_s=time.perf_counter() - req.submit_wall,
            submitted_at=req.submit_wall,
            admitted_at=req.admitted_at,
            first_token_at=req.first_token_at,
        )
