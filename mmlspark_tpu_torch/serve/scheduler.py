"""Continuous-batching scheduler: queue, slot states and tick bookkeeping
for the serving engine — the port's own copy of
``mmlspark_tpu/serve/scheduler.py`` (numpy and ``FriendlyError`` only),
trimmed to this slice: no chunked fills, preemption, quarantine or
hand-offs.

One TICK = admit joiners -> one fused decode BLOCK of up to T tokens for
every active slot -> retire finished sequences. A sequence hitting EOS
mid-block goes dead on the device (emitting pads for the rest of the
block) and frees its slot when the block's tokens are consumed.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError


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


@dataclass
class RequestResult:
    """Terminal record for one request: ``status`` is ``"completed"``
    (budget or EOS reached), ``"expired"`` (deadline passed while queued
    or mid-decode) or ``"stalled"`` (``run()`` hit its ``max_ticks``
    bound). ``tokens`` includes the prompt, like ``generate()``."""

    id: int
    status: str
    tokens: np.ndarray
    prompt_len: int
    generated: int
    submit_tick: int
    first_token_tick: int | None
    finish_tick: int
    wall_s: float


@dataclass
class _SlotState:
    """Decode-side state of one active slot."""

    req: ServeRequest
    pos: int  # absolute position the NEXT decode step writes
    last_token: int
    out: list = field(default_factory=list)
    first_token_tick: int = 0


class ContinuousBatchScheduler:
    def __init__(self, pool, max_queue: int):
        if max_queue < 1:
            raise FriendlyError(f"max_queue must be >= 1, got {max_queue}")
        self.pool = pool
        self.max_queue = max_queue
        self.queue: deque[ServeRequest] = deque()
        self.active: dict[int, _SlotState] = {}  # slot -> state
        self.tick_count = 0

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def busy(self) -> bool:
        return bool(self.queue or self.active)

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

    def expire(self, tick: int) -> list[RequestResult]:
        """Retire every request (queued or active) whose deadline has
        passed; active expiries free their slot."""
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
        return out

    def activate(self, slot: int, req: ServeRequest, first_token: int,
                 tick: int) -> RequestResult | None:
        """Install a prefilled request into its slot. Returns a terminal
        result at once when the FIRST token already finishes it (budget
        reached, or the token is EOS) — the slot is freed without ever
        joining the decode batch."""
        st = _SlotState(req=req, pos=len(req.prompt),
                        last_token=first_token, out=[first_token],
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
        self, token_block: np.ndarray, tick: int
    ) -> tuple[list[RequestResult], dict[int, int]]:
        """Fold one fused decode BLOCK's ``(S, T)`` token output back into
        per-slot state: each active slot consumes its row left to right
        until its EOS or token budget retires it (later columns are
        device-emitted pads, discarded), freeing retired slots. Returns
        ``(finished results, {slot: real tokens consumed})``."""
        token_block = np.asarray(token_block)
        if token_block.ndim == 1:
            token_block = token_block[:, None]
        finished: list[RequestResult] = []
        consumed: dict[int, int] = {}
        for slot, st in list(self.active.items()):
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

    def stall_pending(self, tick: int) -> list[RequestResult]:
        """Retire EVERY still-pending request (queued and active) with the
        status ``"stalled"`` — ``run()``'s ``max_ticks`` bound calls
        this so no request is silently discarded."""
        out: list[RequestResult] = []
        while self.queue:
            out.append(self._queued_result(
                self.queue.popleft(), "stalled", tick
            ))
        for slot, st in sorted(self.active.items()):
            self.pool.free(slot)
            out.append(self._finish(st, "stalled", tick))
        self.active.clear()
        return out

    def _queued_result(self, req: ServeRequest, status: str,
                       tick: int) -> RequestResult:
        """Terminal record for a request that never activated."""
        return self._result(req, status, tokens=req.prompt, generated=0,
                            first_token_tick=None, tick=tick)

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
        )
