"""Deterministic fault injection and error classification for the serving
engine and the trainer — the port's own copy of
``mmlspark_tpu/core/faults.py`` (numpy only there; the port imports
nothing of the JAX package).

The engine's hook points (``serve.prefill``, ``serve.decode``,
``serve.device_get``, the periodic-checkpoint ``serve.snapshot`` and the
hand-off's ``serve.handoff``), the supervisors' ``serve.health`` and
the trainer's (``train.step``, ``train.data``, ``train.checkpoint``,
``train.restore``) fire into a :class:`FaultInjector`:

- **Zero overhead when disabled.** The engine holds ``faults=None`` by
  default and every hook is one ``is not None`` check on the host path —
  nothing enters the captured programs.
- **Deterministic.** Faults come from an explicit :class:`Fault` schedule
  (fire at site X on tick N for request R, ``times`` firings) and/or a
  seeded rate table (one ``default_rng(seed)`` draw per hook firing): the
  same seed over the same traffic replays the same faults, on either
  framework.
- **Typed.** Injected failures raise :class:`TransientFault`,
  :class:`ResourceExhausted` or :class:`EngineKilled`. The classifiers
  (:func:`is_transient`, :func:`is_resource_exhausted`) match the
  injected types and the real errors of this runtime, so one retry,
  degrade and quarantine policy covers simulated and genuine failures.

Fault kinds: ``transient`` (a retryable dispatch error, raised at the hook
BEFORE the program call, so a failed attempt never touches the pool),
``oom`` (a simulated allocation failure: the engine's degradation
ladder), ``stall`` (sleeps ``stall_s``: a slow tick, no error), ``poison``
(an out-of-vocabulary token in one request's stream, via
:meth:`FaultInjector.poison_value` / :meth:`FaultInjector.poison_block`:
the engine quarantines exactly that request), ``kill`` (raises
:class:`EngineKilled`, the simulated process crash; never retried — the
engine is rebuilt with ``ServeEngine.restore``) and ``corrupt`` (a seeded
bit-flip decided by :meth:`FaultInjector.corrupt_spec` and applied by the
call site through ``core/integrity.py``).

Real errors on the card:

- ``torch.cuda.OutOfMemoryError`` is resource exhaustion, and so is any
  error whose ``__cause__``/``__context__`` chain holds one: a program
  that runs out of memory while it is captured as a CUDA graph surfaces
  as the ``RuntimeError`` ``testing/compile_guard.py`` wraps it in.
- A sticky CUDA error (an illegal address, a launch failure) is NEVER
  transient. After one the CUDA context is unusable and every later call
  fails too, so retrying would only hide the bug behind a quarantine:
  such errors propagate.

The site table keeps the JAX package's names, so one fault spec parses on
both frameworks and, over the same traffic, draws the same faults. The
port's serving engine fires the four ``serve.*`` sites above and the
hand-off's ``serve.handoff``, its supervisors (``serve/supervisor.py``,
``serve/fleet.py``) the health probe's ``serve.health``, the multi-model
engine's batch deployments (``serve/multimodel.py``) ``serve.batch``
before each batch dispatch, and its trainer the four ``train.*`` sites.
A fault's ``replica`` pins it to one replica of a supervised set: every
engine tags its firings with its replica index.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError

#: hook points a fault can target, under the JAX package's names
SITES = (
    "serve.prefill", "serve.decode", "serve.device_get",
    "serve.snapshot", "serve.health", "serve.handoff", "serve.batch",
    "train.step", "train.data", "train.checkpoint", "train.restore",
)
#: fault kinds fire() raises/sleeps for, in rate-table draw order
FIRE_KINDS = ("transient", "oom", "stall", "kill")
#: value kinds — never raised; the call site applies the corruption
KINDS = FIRE_KINDS + ("poison", "corrupt")

#: poison token injected when a Fault does not name its own value —
#: negative, so it is out of range for every vocabulary
POISON_TOKEN = -7


class InjectedFault(RuntimeError):
    """Base of every injector-raised failure (never a FriendlyError:
    faults simulate the RUNTIME failing, not the user misusing the
    API)."""


class TransientFault(InjectedFault):
    """A retryable dispatch failure — the engine's capped deterministic
    backoff absorbs up to ``retry_limit`` of these per dispatch."""


class ResourceExhausted(InjectedFault):
    """An allocation failure: injected, or the paged pool's page
    allocator running dry. The message carries the ``RESOURCE_EXHAUSTED``
    spelling so that string-matching classifiers see every out-of-memory
    error alike."""

    def __init__(self, message: str = ""):
        super().__init__(
            f"RESOURCE_EXHAUSTED: {message or 'injected allocation failure'}"
        )


class EngineKilled(InjectedFault):
    """Simulated process crash. Escapes ``ServeEngine.run()`` by design —
    recovery is ``ServeEngine.restore(snapshot)``, not a retry."""


def _chain(exc: BaseException):
    """``exc`` and every error of its ``__cause__``/``__context__``
    chain, each once."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for :class:`ResourceExhausted`, for ``torch.cuda.
    OutOfMemoryError``, for any error whose cause/context chain holds
    either (a capture that ran out of memory, wrapped by the program
    counter), and for any error whose text carries the
    ``RESOURCE_EXHAUSTED`` status."""
    return any(
        isinstance(e, (ResourceExhausted, torch.cuda.OutOfMemoryError))
        or "RESOURCE_EXHAUSTED" in str(e)
        for e in _chain(exc)
    )


#: runtime statuses safe to retry: the dispatch failed to START, it did
#: not half-execute (resource exhaustion is handled separately —
#: retrying without degrading would just run out of memory again)
_TRANSIENT_STATUSES = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "CANCELLED")


def is_transient(exc: BaseException) -> bool:
    """True for :class:`TransientFault`, and for a runtime error of the
    JAX package's ``XlaRuntimeError`` spelling whose status is a
    retryable one (so one fault log classifies alike on both
    frameworks). CUDA errors are never transient here: a sticky error
    leaves the context unusable, and an allocation failure is
    :func:`is_resource_exhausted`'s."""
    if isinstance(exc, TransientFault):
        return True
    if isinstance(exc, (ResourceExhausted, EngineKilled)):
        return False
    if type(exc).__name__ == "XlaRuntimeError":
        msg = str(exc)
        return any(s in msg for s in _TRANSIENT_STATUSES)
    return False


@dataclass
class Fault:
    """One scheduled fault: fire ``kind`` at ``site``, optionally pinned
    to an engine ``tick`` and/or a ``request`` id (prefill and poison
    targeting) or a ``slot`` (device_get poison targeting); ``times``
    firings before the entry is spent. ``replica`` pins the fault to one
    replica of a supervised set (None matches any firing)."""

    site: str
    kind: str
    tick: int | None = None
    request: int | None = None
    slot: int | None = None
    replica: int | None = None
    times: int = 1
    value: int = POISON_TOKEN

    def __post_init__(self):
        if self.site not in SITES:
            raise FriendlyError(
                f"unknown fault site {self.site!r}; hook points are "
                f"{SITES}"
            )
        if self.kind not in KINDS:
            raise FriendlyError(
                f"unknown fault kind {self.kind!r}; kinds are {KINDS}"
            )


def _check_rate(label: str, rate) -> None:
    if not 0.0 <= float(rate) <= 1.0:
        raise FriendlyError(
            f"fault rate for {label} must be in [0, 1], got {rate}"
        )


class FaultInjector:
    """Deterministic fault source for the engine's hook points.

    Two composable modes: an explicit ``schedule`` of :class:`Fault`
    entries (matched first) and a seeded ``rates`` table (``{"transient":
    0.05, "oom": 0.02, ...}`` — one ``default_rng(seed)`` uniform draw per
    hook firing, walked cumulatively in :data:`FIRE_KINDS` order, plus
    one draw per row for ``poison``), with ``site_rates`` overriding the
    table for one site. The draw sequence — and so the whole fault replay
    — is a pure function of ``seed`` and the engine's traffic.

    ``listener(kind, site)`` is called on every injection (the engine
    wires it to its metrics and flight recorder).
    """

    def __init__(self, schedule=(), *, seed: int | None = None,
                 rates: dict[str, float] | None = None,
                 site_rates: dict[str, dict[str, float]] | None = None,
                 stall_s: float = 0.001, listener=None):
        self.schedule: list[Fault] = list(schedule)
        self.rates = dict(rates or {})
        for kind, rate in self.rates.items():
            if kind not in KINDS:
                raise FriendlyError(
                    f"unknown fault kind {kind!r} in rates; kinds are "
                    f"{KINDS}"
                )
            _check_rate(repr(kind), rate)
        self.site_rates = {
            site: dict(kinds) for site, kinds in (site_rates or {}).items()
        }
        for site, kinds in self.site_rates.items():
            if site not in SITES:
                raise FriendlyError(
                    f"unknown fault site {site!r} in site_rates; hook "
                    f"points are {SITES}"
                )
            for kind, rate in kinds.items():
                if kind not in KINDS:
                    raise FriendlyError(
                        f"unknown fault kind {kind!r} in site_rates"
                        f"[{site!r}]; kinds are {KINDS}"
                    )
                _check_rate(f"{site}:{kind}", rate)
        if (self.rates or self.site_rates) and seed is None:
            raise FriendlyError(
                "rate-based fault injection needs a seed — unseeded "
                "faults cannot be replayed, which defeats the harness"
            )
        self._rng = np.random.default_rng(seed) if seed is not None else None
        self.stall_s = stall_s
        self.listener = listener
        #: kind -> injections so far
        self.counts: dict[str, int] = {}
        self.injected_total = 0

    # -- bookkeeping -------------------------------------------------------

    def _record(self, kind: str, site: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.injected_total += 1
        if self.listener is not None:
            self.listener(kind, site)

    def _take(self, site: str, kinds: tuple, *, tick: int,
              request: int | None, slot: int | None = None,
              replica: int | None = None) -> Fault | None:
        """Pop (decrement) the first matching unspent schedule entry."""
        for f in self.schedule:
            if f.times <= 0 or f.site != site or f.kind not in kinds:
                continue
            if f.tick is not None and f.tick != tick:
                continue
            if f.request is not None and f.request != request:
                continue
            if f.slot is not None and slot is not None and f.slot != slot:
                continue
            if f.replica is not None and f.replica != replica:
                continue
            f.times -= 1
            return f
        return None

    def _rate(self, site: str, kind: str) -> float:
        over = self.site_rates.get(site)
        if over is not None and kind in over:
            return float(over[kind])
        return float(self.rates.get(kind, 0.0))

    def _draw(self, site: str, kinds: tuple) -> str | None:
        """One seeded uniform against the cumulative rate table."""
        if self._rng is None:
            return None
        active = [(k, self._rate(site, k)) for k in kinds]
        if not any(r for _, r in active):
            return None
        u = float(self._rng.random())
        acc = 0.0
        for kind, rate in active:
            acc += rate
            if u < acc:
                return kind
        return None

    # -- the engine-facing surface -----------------------------------------

    def fire(self, site: str, *, tick: int, request: int | None = None,
             replica: int | None = None) -> None:
        """One hook firing: raise/stall per the schedule and rate table,
        or return silently. The engine calls it immediately BEFORE the
        guarded program call, so a raised fault never touches the
        pool."""
        f = self._take(site, FIRE_KINDS, tick=tick, request=request,
                       replica=replica)
        kind = f.kind if f is not None else self._draw(site, FIRE_KINDS)
        if kind is None:
            return
        self._record(kind, site)
        if kind == "transient":
            raise TransientFault(
                f"injected transient fault at {site} (tick {tick})"
            )
        if kind == "oom":
            raise ResourceExhausted(f"injected at {site} (tick {tick})")
        if kind == "kill":
            raise EngineKilled(
                f"injected engine kill at {site} (tick {tick})"
            )
        time.sleep(self.stall_s)  # stall: a slow tick, not an error

    def poison_value(self, site: str, *, tick: int,
                     request: int | None = None,
                     replica: int | None = None) -> int | None:
        """Poison token for one request's scalar token (the first token
        of a prefill), or None."""
        f = self._take(site, ("poison",), tick=tick, request=request,
                       replica=replica)
        if f is not None:
            self._record("poison", site)
            return int(f.value)
        if self._draw(site, ("poison",)) is not None:
            self._record("poison", site)
            return POISON_TOKEN
        return None

    def poison_block(self, site: str, tokens: np.ndarray, *, tick: int,
                     slots: list[int],
                     replica: int | None = None) -> np.ndarray:
        """Poison the fetched ``(S, T)`` decode block: corrupt column 0 of
        a targeted (or the lowest, or a seeded-drawn) active slot's row.
        Returns a fresh array; the device state is untouched."""
        if not slots:
            return tokens
        hit: list[tuple[int, int]] = []
        for slot in slots:
            f = self._take(site, ("poison",), tick=tick, request=None,
                           slot=slot, replica=replica)
            if f is not None:
                self._record("poison", site)
                hit.append((slot if f.slot is None else f.slot, f.value))
                continue
            if self._draw(site, ("poison",)) is not None:
                self._record("poison", site)
                hit.append((slot, POISON_TOKEN))
        if not hit:
            return tokens
        tokens = np.array(tokens, copy=True)
        for slot, value in hit:
            tokens[slot, 0] = value
        return tokens

    def corrupt_spec(self, site: str, *, tick: int,
                     request: int | None = None,
                     slot: int | None = None,
                     replica: int | None = None) -> int | None:
        """Decide whether this hook firing suffers silent data
        corruption: a deterministic bit-flip seed (for
        ``core/integrity.py``'s ``flip_bit_*``), or None. A scheduled
        :class:`Fault` with a non-default ``value`` pins the seed; else
        it derives from the injector's corrupt count, so rate-drawn flips
        replay too."""
        f = self._take(site, ("corrupt",), tick=tick, request=request,
                       slot=slot, replica=replica)
        if f is None and self._draw(site, ("corrupt",)) is None:
            return None
        ordinal = self.counts.get("corrupt", 0)
        self._record("corrupt", site)
        if f is not None and f.value != POISON_TOKEN:
            return int(f.value)
        return ordinal * 1_000_003 + 17


def parse_fault_spec(spec: str) -> FaultInjector:
    """CLI spelling -> injector: ``"seed=7,transient=0.05,oom=0.02,
    poison=0.02,stall=0.01,stall_s=0.001"``. Kind keys are rates; ``seed``
    and ``stall_s`` configure the injector; a ``site:kind`` key
    (``"serve.snapshot:transient=0.5"``) scopes a rate to one hook."""
    seed = None
    stall_s = 0.001
    rates: dict[str, float] = {}
    site_rates: dict[str, dict[str, float]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise FriendlyError(
                f"bad fault spec entry {part!r}: expected key=value "
                "pairs like 'seed=7,transient=0.05'"
            )
        key, _, value = part.partition("=")
        key = key.strip()
        try:
            if key == "seed":
                seed = int(value)
            elif key == "stall_s":
                stall_s = float(value)
            elif ":" in key:
                site, _, kind = key.partition(":")
                site, kind = site.strip(), kind.strip()
                if site not in SITES:
                    raise FriendlyError(
                        f"unknown fault site {site!r} in spec key "
                        f"{key!r}; hook points are {SITES}"
                    )
                if kind not in KINDS:
                    raise FriendlyError(
                        f"unknown fault kind {kind!r} in spec key "
                        f"{key!r}; kinds are {KINDS}"
                    )
                site_rates.setdefault(site, {})[kind] = float(value)
            elif key in KINDS:
                rates[key] = float(value)
            else:
                raise FriendlyError(
                    f"unknown fault spec key {key!r}; use 'seed', "
                    f"'stall_s', a kind rate from {KINDS}, or a "
                    "site-scoped 'site:kind' rate"
                )
        except ValueError as e:
            raise FriendlyError(
                f"bad fault spec value {value!r} for {key!r}: {e}"
            ) from e
    return FaultInjector(seed=seed, rates=rates, site_rates=site_rates,
                         stall_s=stall_s)
