"""Device-level performance analytics — the port of
``mmlspark_tpu/core/perf.py``: program cost attribution (MFU, HBM
bandwidth), the Chrome/Perfetto trace export and the SLO monitor.

The telemetry plane sees host wall-clock: a decode block "took 12 ms".
This module turns those intervals into device figures by combining each
program family's ANALYTIC cost with the dispatch intervals the engine
already measures at its existing sync points:

- :func:`analyze_program_cost` + :class:`PerfAnalytics`: every program
  family (a prefill bucket, a decode block of T steps, a resume or chunk
  bucket) is analyzed once, by running its eager body on ``meta`` copies
  of its inputs — shapes only: no device work, no host sync, no program
  made or counted — under a counting dispatch mode (:class:`CostCounter`:
  each op's FLOPs by ``torch.utils.flop_counter``'s formulas, its bytes
  as each input read once and each output written once; views move
  nothing). The
  decode kernels are ``ctypes`` launches no dispatch mode sees: their
  wrappers take a path on ``meta`` tensors that launches nothing and
  adds the kernel's own FLOPs and bytes, by the formula behind
  ``PERF.md``'s bounds, to :func:`~mmlspark_tpu_torch.ops.flash_attention.meta_cost`.
  Dividing by the measured dispatch interval gives per-family ``mfu``
  and ``hbm_bw_util_pct`` against :func:`device_peak`, plus the
  device-vs-host time split, with no new host sync. A body that cannot
  run on ``meta`` tensors degrades to ``source="unavailable"`` and
  ``None`` figures, never an error.
- :func:`export_chrome_trace`: FlightRecorder events and request spans
  -> Chrome trace-event JSON (``trace.json``), loadable in Perfetto with
  one track per request, a tick track and program-dispatch slices.
- :class:`SloMonitor`: declared TTFT / per-token p99 targets and an
  error-rate budget over a rolling window; burning the budget records
  ``slo_violation`` and raises ``should_shed``, which the engine's
  admission honours; recovery records ``slo_recovered``. The clock is
  injectable.

Host-side only; the JAX package's names, keys and messages.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from collections import deque
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.integrity import tree_leaves

_log = logging.getLogger("mmlspark_tpu_torch.perf")


# --------------------------------------------------------------------------
# device peaks
# --------------------------------------------------------------------------

#: device-name prefix -> (peak dense bf16 FLOP/s, peak HBM bytes/s) of one
#: card, NVIDIA's data sheet (H100 SXM, dense, at its 700 W limit) — the
#: figures PERF.md's kernel bounds use. Matched by longest prefix against
#: ``torch.cuda.get_device_name``.
DEVICE_PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100": (989e12, 3.35e12),
}

#: nominal single-core CPU figures used when the device is not a known
#: card: MFU against them is a smoke-scale sanity number, not a hardware
#: claim — ``peak_source`` says so
_CPU_NOMINAL = (5e10, 2e10)


@dataclasses.dataclass(frozen=True)
class DevicePeak:
    """Peak FLOP/s and HBM bandwidth one device can sustain, and where
    the figure came from (``"table"`` for known cards, ``"nominal"`` for
    the CPU fallback, ``"env"`` for the ``MMLTPU_PEAK_FLOPS`` /
    ``MMLTPU_PEAK_HBM_BYTES_PER_S`` overrides)."""

    flops_per_s: float
    hbm_bytes_per_s: float
    source: str
    device_kind: str

    def to_dict(self) -> dict:
        return {
            "flops_per_s": self.flops_per_s,
            "hbm_bytes_per_s": self.hbm_bytes_per_s,
            "source": self.source,
            "device_kind": self.device_kind,
        }


def _device_kind(device) -> str:
    """The name a peak is looked up by: an object's ``device_kind``, a
    string as given, a CUDA device's name (default: card 0 when one is
    present), else ``"cpu"``."""
    kind = getattr(device, "device_kind", None)
    if kind:
        return str(kind)
    if isinstance(device, str):
        return device
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device.index or 0)
    return device.type


def device_peak(device=None) -> DevicePeak:
    """Resolve the peak figures for ``device`` (default: CUDA card 0, or
    the CPU without one). Env overrides win; unknown kinds get the
    nominal CPU figures, so MFU is always computable (and labelled)."""
    env_flops = os.environ.get("MMLTPU_PEAK_FLOPS")
    env_bw = os.environ.get("MMLTPU_PEAK_HBM_BYTES_PER_S")
    kind = "unknown"
    try:
        kind = _device_kind(device) or "unknown"
    except Exception:  # noqa: BLE001 — analytics must never raise
        pass
    if env_flops or env_bw:
        base = _lookup_peak(kind) or _CPU_NOMINAL
        return DevicePeak(
            float(env_flops) if env_flops else base[0],
            float(env_bw) if env_bw else base[1],
            "env", kind,
        )
    hit = _lookup_peak(kind)
    if hit is not None:
        return DevicePeak(hit[0], hit[1], "table", kind)
    return DevicePeak(*_CPU_NOMINAL, "nominal", kind)


def _lookup_peak(kind: str) -> tuple[float, float] | None:
    best = None
    for prefix, peaks in DEVICE_PEAKS.items():
        if kind.startswith(prefix) and (
            best is None or len(prefix) > len(best[0])
        ):
            best = (prefix, peaks)
    return best[1] if best else None


# --------------------------------------------------------------------------
# program cost analysis
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """Analytic cost of ONE program execution: total FLOPs and bytes
    moved. ``source`` is ``"meta"`` when the body ran on ``meta``
    tensors and ``"unavailable"`` when it could not — the figures are
    then ``None``, and every ratio derived from them follows suit."""

    flops: float | None
    bytes_accessed: float | None
    source: str = "meta"

    @classmethod
    def unavailable(cls) -> "ProgramCost":
        return cls(None, None, "unavailable")

    def over_devices(self, n: int) -> "ProgramCost":
        """The cost of a program that ``n`` devices each run at this
        per-device cost (a serving mesh: every rank runs the same shapes
        on its shard, and a prefill on every data rank), as one whole
        execution — what :class:`PerfAnalytics` over ``n_devices`` divides
        by ``n`` peaks again, so its MFU and bandwidth are per device."""
        if self.flops is None:
            return self
        return ProgramCost(self.flops * n, self.bytes_accessed * n,
                           self.source)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "source": self.source,
        }


#: ops that write into part of their mutated argument: the part written
#: is the source's size, not the whole destination's
_SCATTERS = frozenset({
    "aten::index_put_", "aten::_index_put_impl_", "aten::index_copy_",
    "aten::index_add_", "aten::scatter_", "aten::scatter_add_",
    "aten::scatter_reduce_", "aten::masked_scatter_",
})


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts each op's FLOPs (``torch.utils.flop_counter``'s formulas,
    the ones ``FlopCounterMode`` applies: 2 a multiply-add of a matrix
    product, ...) and the bytes it moves: every input it reads once,
    every output it writes once. Views move nothing. An op's mutated
    argument is written, not read (an elementwise in-place op also reads
    it); a scatter writes the size of its source, not its whole
    destination."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_formulas = flop_registry
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        formula = self._flop_formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        schema = func._schema
        written: set[int] = set()
        for i, arg in enumerate(schema.arguments):
            info = arg.alias_info
            if info is not None and info.is_write:
                val = args[i] if i < len(args) else kwargs.get(arg.name)
                written.update(id(t) for t in _tensors(val))
        read = {id(t): t for t in _tensors((args, kwargs))
                if id(t) not in written}
        n = sum(_nbytes(t) for t in read.values())
        if written and schema.name in _SCATTERS:
            # the destination keeps its other rows: the values (the
            # largest non-index input) are what lands
            n += max((_nbytes(t) for t in read.values()
                      if t.is_floating_point() or t.dtype == torch.int8),
                     default=0)
        else:
            outs = {id(t): t for t in _tensors(out)}
            n += sum(_nbytes(t) for t in outs.values())
            if schema.name.endswith("_") and written:
                # an elementwise in-place op reads what it overwrites
                n += sum(_nbytes(t) for t in outs.values())
        self.bytes += n
        return out


def _to_meta(tree):
    """Tensor leaves -> ``meta`` tensors of the same shape, strides and
    dtype (no data is touched, so no copy and no sync); other leaves as
    they are."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tuple(tree.shape), tuple(tree.stride()),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def analyze_program_cost(fn, *args, **kwargs) -> ProgramCost:
    """Run ``fn`` (a program's eager body) on ``meta`` copies of its
    arguments and count its FLOPs and bytes (:class:`CostCounter`), the
    decode kernels' own figures included
    (their wrappers count themselves on ``meta`` tensors). The port's
    counterpart of the JAX package's ``analyze_jit_cost``: shapes only —
    no device work, no host sync, no program made or counted, so the
    engine's program pins and its one fetch a block hold. Any failure (a
    body that needs tensor values) degrades to
    :meth:`ProgramCost.unavailable`, never an exception."""
    from mmlspark_tpu_torch.ops.flash_attention import meta_cost

    try:
        a, kw = _to_meta((args, kwargs))
        counter = CostCounter()
        with torch.no_grad(), meta_cost() as kernels, counter:
            fn(*a, **kw)
        return ProgramCost(
            float(counter.flops + kernels["flops"]),
            float(counter.bytes + kernels["bytes"]),
            "meta",
        )
    except Exception as e:  # noqa: BLE001 — analytics must never raise
        _log.info("cost analysis unavailable: %s", e)
        return ProgramCost.unavailable()


# --------------------------------------------------------------------------
# per-family dispatch attribution
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _FamilyStats:
    cost: ProgramCost
    dispatches: int = 0
    device_s: float = 0.0
    #: issue-to-start time under a pipelined host loop: the span a
    #: dispatch spent QUEUED behind the previous block's in-flight
    #: execution — excluded from device_s so MFU/BW stay honest
    queued_s: float = 0.0
    tokens: int = 0


class PerfAnalytics:
    """Per-program-family MFU / bandwidth attribution and the
    device-vs-host time split.

    The serve engine registers each program family ONCE (``ensure`` /
    ``register_program``) with its analytic :class:`ProgramCost`, then
    reports every dispatch's measured interval — the wall time between
    issuing the program and the block's one existing host sync
    completing — via :meth:`record_dispatch`. No new syncs, no device
    round-trips: everything here is host arithmetic over numbers the
    engine already had. Per-family and overall gauges
    (``perf.mfu``, ``perf.hbm_bw_util_pct``, ``perf.device_time_pct``)
    land in the shared registry; :meth:`summary` is the JSON view
    ``ServeMetrics.to_dict()`` embeds (schema-gated)."""

    def __init__(self, *, registry=None, n_devices: int = 1,
                 peak: DevicePeak | None = None, enabled: bool = True):
        self.enabled = enabled
        self.n_devices = max(1, int(n_devices))
        self._peak: DevicePeak | None = peak
        self._families: dict[str, _FamilyStats] = {}
        self._tick_s = 0.0
        self._registry = registry

    @property
    def peak(self) -> DevicePeak:
        # resolved lazily: construction must not initialise CUDA
        if self._peak is None:
            self._peak = device_peak()
        return self._peak

    def wants_program(self, family: str) -> bool:
        """True when ``family`` has not been analyzed yet (and the
        plane is enabled) — the engine's one-branch guard before paying
        the once-per-family analysis."""
        return self.enabled and family not in self._families

    def register_program(self, family: str, cost: ProgramCost) -> None:
        if family in self._families:
            return
        self._families[family] = _FamilyStats(cost=cost)
        _log.info(
            "perf: program family %s registered (flops=%s bytes=%s "
            "source=%s)", family, cost.flops, cost.bytes_accessed,
            cost.source,
        )

    def ensure(self, family: str,
               analyze: Callable[[], ProgramCost]) -> None:
        """Register ``family`` via ``analyze()`` on first sight; no-op
        (zero work beyond one dict probe) afterwards."""
        if self.wants_program(family):
            self.register_program(family, analyze())

    def record_dispatch(self, family: str, seconds: float,
                        tokens: int = 0, queued_s: float = 0.0) -> None:
        """One dispatched execution of ``family`` that took ``seconds``
        measured at the block's EXISTING sync point. ``queued_s`` is
        the portion of that interval the dispatch spent queued behind a
        still-executing previous block (the async host loop's
        pipelining): it is real wall time but NOT device execution, so
        it is excluded from the device_s the MFU/BW denominators use —
        without the split, a perfectly pipelined engine would halve its
        apparent MFU while doing exactly the same math."""
        if not self.enabled:
            return
        st = self._families.get(family)
        if st is None:
            # dispatch observed before/without registration (analytics
            # partially disabled): still attribute the time
            st = _FamilyStats(cost=ProgramCost.unavailable())
            self._families[family] = st
        st.dispatches += 1
        queued_s = min(max(0.0, queued_s), max(0.0, seconds))
        st.device_s += seconds - queued_s
        st.queued_s += queued_s
        st.tokens += tokens
        if self._registry is not None:
            g = self._registry.gauge(f"perf.{family}.mfu")
            mfu = self._family_mfu(st)
            if mfu is not None:
                g.set(mfu)
            bw = self._family_bw_pct(st)
            if bw is not None:
                self._registry.gauge(
                    f"perf.{family}.hbm_bw_util_pct"
                ).set(bw)
            overall = self.overall()
            if overall["mfu"] is not None:
                self._registry.gauge("perf.mfu").set(overall["mfu"])
            if overall["hbm_bw_util_pct"] is not None:
                self._registry.gauge("perf.hbm_bw_util_pct").set(
                    overall["hbm_bw_util_pct"]
                )

    def record_tick(self, seconds: float) -> None:
        """One engine tick's total wall time — the denominator of the
        device-vs-host split."""
        if self.enabled:
            self._tick_s += seconds
            if self._registry is not None:
                pct = self.device_time_pct()
                if pct is not None:
                    self._registry.gauge("perf.device_time_pct").set(pct)

    # -- derived figures ---------------------------------------------------

    def _family_mfu(self, st: _FamilyStats) -> float | None:
        if st.cost.flops is None or st.device_s <= 0:
            return None
        achieved = st.cost.flops * st.dispatches / st.device_s
        return achieved / (self.peak.flops_per_s * self.n_devices)

    def _family_bw_pct(self, st: _FamilyStats) -> float | None:
        if st.cost.bytes_accessed is None or st.device_s <= 0:
            return None
        achieved = st.cost.bytes_accessed * st.dispatches / st.device_s
        return 100.0 * achieved / (
            self.peak.hbm_bytes_per_s * self.n_devices
        )

    def device_seconds(self) -> float:
        return sum(st.device_s for st in self._families.values())

    def host_seconds(self) -> float:
        """Tick wall time NOT inside a device dispatch interval:
        scheduling, admission bookkeeping, span/metric recording."""
        return max(0.0, self._tick_s - self.device_seconds())

    def device_time_pct(self) -> float | None:
        if self._tick_s <= 0:
            return None
        return 100.0 * min(1.0, self.device_seconds() / self._tick_s)

    def overall(self) -> dict:
        """Dispatch-weighted MFU / bandwidth over every family with an
        analyzed cost; ``None`` while nothing analyzable ran."""
        flops = bts = 0.0
        flops_s = bytes_s = 0.0
        for st in self._families.values():
            if st.device_s <= 0:
                continue
            if st.cost.flops is not None:
                flops += st.cost.flops * st.dispatches
                flops_s += st.device_s
            if st.cost.bytes_accessed is not None:
                bts += st.cost.bytes_accessed * st.dispatches
                bytes_s += st.device_s
        mfu = (
            flops / flops_s / (self.peak.flops_per_s * self.n_devices)
            if flops_s > 0 else None
        )
        bw = (
            100.0 * bts / bytes_s
            / (self.peak.hbm_bytes_per_s * self.n_devices)
            if bytes_s > 0 else None
        )
        return {"mfu": mfu, "hbm_bw_util_pct": bw}

    def summary(self) -> dict:
        """The JSON-able analytics view ``ServeMetrics.to_dict()``
        embeds (and ``tools/check_metrics_schema.py`` gates)."""
        overall = self.overall()
        fams = {}
        for family in sorted(self._families):
            st = self._families[family]
            fams[family] = {
                "flops": st.cost.flops,
                "bytes_accessed": st.cost.bytes_accessed,
                "cost_source": st.cost.source,
                "dispatches": st.dispatches,
                "device_s": round(st.device_s, 6),
                "queued_s": round(st.queued_s, 6),
                "tokens": st.tokens,
                "mfu": _rnd(self._family_mfu(st), 6),
                "hbm_bw_util_pct": _rnd(self._family_bw_pct(st), 4),
            }
        return {
            "mfu": _rnd(overall["mfu"], 6),
            "hbm_bw_util_pct": _rnd(overall["hbm_bw_util_pct"], 4),
            "device_time_s": round(self.device_seconds(), 6),
            "host_time_s": round(self.host_seconds(), 6),
            "device_time_pct": _rnd(self.device_time_pct(), 4),
            "families": fams,
            "peak": {**self.peak.to_dict(), "devices": self.n_devices},
        }


def _rnd(value: float | None, digits: int) -> float | None:
    return round(value, digits) if value is not None else None


# --------------------------------------------------------------------------
# SLO monitor
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SloTargets:
    """Declared service-level objectives over a rolling window.
    ``None`` targets are not monitored; ``error_rate`` is the budgeted
    fraction of non-``completed`` terminal statuses."""

    ttft_p99_ms: float | None = None
    per_token_p99_ms: float | None = None
    error_rate: float | None = None
    window_s: float = 60.0
    #: a signal needs at least this many window samples before it can
    #: violate — one slow warm-up request must not trip a p99 alert
    min_samples: int = 5

    def declared(self) -> bool:
        return any(
            t is not None
            for t in (self.ttft_p99_ms, self.per_token_p99_ms,
                      self.error_rate)
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_slo_spec(spec: str) -> SloTargets:
    """CLI spelling -> :class:`SloTargets`:
    ``"ttft_p99_ms=50,per_token_p99_ms=5,error_rate=0.05,window_s=30"``.
    Unknown keys raise the typed error with the valid vocabulary."""
    fields = {f.name for f in dataclasses.fields(SloTargets)}
    out: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise FriendlyError(
                f"bad SLO spec item {part!r}: expected key=value "
                f"(keys: {sorted(fields)})"
            )
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in fields:
            raise FriendlyError(
                f"unknown SLO key {key!r} (keys: {sorted(fields)})"
            )
        try:
            out[key] = (
                int(val) if key == "min_samples" else float(val)
            )
        except ValueError:
            raise FriendlyError(
                f"SLO key {key!r} needs a number, got {val!r}"
            ) from None
    targets = SloTargets(**out)
    if not targets.declared():
        raise FriendlyError(
            "SLO spec declares no target: set at least one of "
            "ttft_p99_ms, per_token_p99_ms, error_rate"
        )
    return targets


def _p99(values: list[float]) -> float:
    """Exact p99 over the window samples (nearest-rank) — small windows
    deserve exactness, and exactness is what makes the unit tests'
    synthetic-clock arithmetic deterministic."""
    ordered = sorted(values)
    rank = max(1, math.ceil(0.99 * len(ordered)))
    return ordered[rank - 1]


class SloMonitor:
    """Rolling-window SLO evaluation with alert events and a shed
    signal.

    Observations arrive from the metrics plane (TTFT per admission,
    per-token latency per decode block, ok/error per terminal status);
    :meth:`evaluate` — called once per engine tick — prunes the window,
    compares each declared target, and:

    - entering violation: records one ``slo_violation`` flight-recorder
      event naming every violated target and raises :attr:`should_shed`
      — the engine's admission control stops admitting NEW requests
      while in-flight ones finish (load shedding composes with the
      memory-pressure degraded mode: both squeeze admissions, neither
      touches compiled programs);
    - leaving violation: one ``slo_recovered`` event, shedding clears.

    ``clock`` is injectable (default ``time.monotonic``) so burn /
    recover / shed arithmetic is testable on synthetic time.
    """

    def __init__(self, targets: SloTargets, *, recorder=None,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if not isinstance(targets, SloTargets):
            raise FriendlyError(
                f"SloMonitor needs SloTargets, got {type(targets).__name__}"
            )
        self.targets = targets
        self._recorder = recorder
        self._clock = clock
        self._ttft: deque[tuple[float, float]] = deque()
        self._per_token: deque[tuple[float, float]] = deque()
        self._finish: deque[tuple[float, bool]] = deque()
        self.should_shed = False
        self.violations_total = 0
        #: CONSECUTIVE burning evaluations (reset on recovery) — the
        #: fleet autoscaler's scale-up signal (serve/fleet.py): a
        #: single bad window hedges noise, a streak means the current
        #: replica count cannot meet the declared targets
        self.burn_ticks = 0
        self._burning = (
            registry.gauge("slo.burning") if registry is not None else None
        )
        self._viol_counter = (
            registry.counter("slo.violations")
            if registry is not None else None
        )
        self._last: dict[str, Any] = {}
        if self._burning is not None:
            self._burning.set(0)

    # -- observations ------------------------------------------------------

    def observe_ttft(self, ms: float, now: float | None = None) -> None:
        self._ttft.append((self._now(now), float(ms)))

    def observe_per_token(self, ms: float,
                          now: float | None = None) -> None:
        self._per_token.append((self._now(now), float(ms)))

    def observe_finish(self, ok: bool, now: float | None = None) -> None:
        self._finish.append((self._now(now), bool(ok)))

    def _now(self, now: float | None) -> float:
        return self._clock() if now is None else now

    def _prune(self, now: float) -> None:
        horizon = now - self.targets.window_s
        for dq in (self._ttft, self._per_token, self._finish):
            while dq and dq[0][0] < horizon:
                dq.popleft()

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now: float | None = None,
                 tick: int | None = None) -> dict:
        """Prune the window, compare every declared target, drive the
        alert/shed state machine; returns the current window state (the
        dict ``ServeMetrics.to_dict()`` embeds under ``"slo"``)."""
        now = self._now(now)
        self._prune(now)
        t = self.targets
        violations: list[dict] = []

        ttft_p99 = (
            _p99([v for _, v in self._ttft]) if self._ttft else None
        )
        if (
            t.ttft_p99_ms is not None and ttft_p99 is not None
            and len(self._ttft) >= t.min_samples
            and ttft_p99 > t.ttft_p99_ms
        ):
            violations.append({
                "slo": "ttft_p99_ms", "value": round(ttft_p99, 3),
                "target": t.ttft_p99_ms,
            })

        ptok_p99 = (
            _p99([v for _, v in self._per_token])
            if self._per_token else None
        )
        if (
            t.per_token_p99_ms is not None and ptok_p99 is not None
            and len(self._per_token) >= t.min_samples
            and ptok_p99 > t.per_token_p99_ms
        ):
            violations.append({
                "slo": "per_token_p99_ms", "value": round(ptok_p99, 4),
                "target": t.per_token_p99_ms,
            })

        err_rate = (
            sum(1 for _, ok in self._finish if not ok) / len(self._finish)
            if self._finish else None
        )
        if (
            t.error_rate is not None and err_rate is not None
            and len(self._finish) >= t.min_samples
            and err_rate > t.error_rate
        ):
            violations.append({
                "slo": "error_rate", "value": round(err_rate, 4),
                "target": t.error_rate,
            })

        burning = bool(violations)
        if burning:
            self.violations_total += 1
            if self._viol_counter is not None:
                self._viol_counter.inc()
        if burning and not self.should_shed:
            if self._recorder is not None:
                self._recorder.record(
                    "slo_violation", tick=tick,
                    violations=violations,
                )
            _log.warning("SLO violation, shedding load: %s", violations)
        elif self.should_shed and not burning:
            if self._recorder is not None:
                self._recorder.record("slo_recovered", tick=tick)
            _log.info("SLO recovered, admissions resume")
        self.should_shed = burning
        self.burn_ticks = self.burn_ticks + 1 if burning else 0
        if self._burning is not None:
            self._burning.set(int(burning))

        self._last = {
            "declared": True,
            "targets": t.to_dict(),
            "window": {
                "ttft_p99_ms": _rnd(ttft_p99, 3),
                "per_token_p99_ms": _rnd(ptok_p99, 4),
                "error_rate": _rnd(err_rate, 4),
                "ttft_samples": len(self._ttft),
                "per_token_samples": len(self._per_token),
                "finish_samples": len(self._finish),
            },
            "burning": burning,
            "burn_ticks": self.burn_ticks,
            "violations": violations,
            "violations_total": self.violations_total,
        }
        return self._last

    def state(self) -> dict:
        """Last evaluation (empty-window shape before the first)."""
        return self._last or {
            "declared": True,
            "targets": self.targets.to_dict(),
            "window": {},
            "burning": False,
            "burn_ticks": 0,
            "violations": [],
            "violations_total": 0,
        }


# --------------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)
# --------------------------------------------------------------------------

#: trace process ids: one pseudo-process for request tracks, one for
#: the engine's tick / dispatch / event tracks
_PID_REQUESTS = 1
_PID_ENGINE = 2
_TID_TICKS = 0
_TID_DISPATCH = 1
_TID_EVENTS = 2

#: terminal span statuses (the exporter closes a request slice on the
#: first of these it sees); ``handed_off`` is terminal on a
#: prefill-role engine — the request continues on a decode replica
_TERMINAL = ("completed", "expired", "failed", "stalled", "handed_off")


def export_chrome_trace(recorder, *, path: str | None = None,
                        extra_meta: dict | None = None) -> dict:
    """FlightRecorder events -> Chrome trace-event JSON.

    Layout (open the file at ui.perfetto.dev, or
    ``chrome://tracing``):

    - process ``serve.requests``: ONE thread/track per request span —
      a complete ("X") slice from span start to its terminal status,
      with every lifecycle event (queued, admitted, prefill, decode,
      ...) as an instant on the same track carrying its attrs;
    - process ``serve.engine``: a ``ticks`` track (one slice per
      scheduler tick), a ``dispatch`` track (one slice per program
      dispatch, named by family — ``decode[T=8]``, ``prefill[16]``),
      and an ``events`` track with everything else (retrace,
      fault_injected, degraded, slo_violation, ...) as instants.

    Timestamps are microseconds since the UNIX epoch via the
    recorder's ``t0_unix`` anchor, so traces recorded by different
    processes (or an engine restored from a snapshot) line up on one
    Perfetto timeline. Output ordering is deterministic: events sort
    by (ts, pid, tid, name), metadata first — two exports of the same
    recorder are byte-identical.

    Returns the trace dict; also writes it to ``path`` when given.
    """
    events = recorder.events()
    t0_unix = getattr(recorder, "t0_unix", 0.0)

    def ts(mono_t: float) -> float:
        return round((t0_unix + mono_t) * 1e6, 3)

    trace: list[dict] = []
    meta: list[dict] = [
        _meta("process_name", _PID_REQUESTS, 0,
              {"name": "serve.requests"}),
        _meta("process_name", _PID_ENGINE, 0, {"name": "serve.engine"}),
        _meta("thread_name", _PID_ENGINE, _TID_TICKS, {"name": "ticks"}),
        _meta("thread_name", _PID_ENGINE, _TID_DISPATCH,
              {"name": "dispatch"}),
        _meta("thread_name", _PID_ENGINE, _TID_EVENTS, {"name": "events"}),
    ]

    # request spans -> one track per span
    spans: dict[int, list[dict]] = {}
    for ev in events:
        if ev.get("span_name") == "request" and "span" in ev:
            spans.setdefault(ev["span"], []).append(ev)
    for sid in sorted(spans):
        evs = spans[sid]
        start = next((e for e in evs if e["name"] == "start"), None)
        req_id = (
            start.get("attrs", {}).get("id", sid)
            if start is not None else sid
        )
        tid = int(req_id)
        meta.append(_meta("thread_name", _PID_REQUESTS, tid,
                          {"name": f"request {req_id}"}))
        end = next(
            (e for e in evs if e["name"] in _TERMINAL), None
        )
        if start is not None:
            dur = (
                round((end["t"] - start["t"]) * 1e6, 3)
                if end is not None else 0.0
            )
            trace.append({
                "name": (
                    f"request {req_id}"
                    + (f" [{end['name']}]" if end is not None else "")
                ),
                "ph": "X", "pid": _PID_REQUESTS, "tid": tid,
                "ts": ts(start["t"]), "dur": dur,
                "args": dict(start.get("attrs", {})),
            })
        for ev in evs:
            if ev is start:
                continue
            trace.append({
                "name": ev["name"], "ph": "i", "s": "t",
                "pid": _PID_REQUESTS, "tid": tid, "ts": ts(ev["t"]),
                "args": _instant_args(ev),
            })

    # engine tracks
    for ev in events:
        if ev.get("span_name") == "request":
            continue
        name = ev["name"]
        if name == "tick":
            dur_ms = ev.get("attrs", {}).get("ms", 0.0)
            trace.append({
                "name": f"tick {ev.get('tick', '?')}",
                "ph": "X", "pid": _PID_ENGINE, "tid": _TID_TICKS,
                "ts": ts(ev["t"] - dur_ms * 1e-3),
                "dur": round(dur_ms * 1e3, 3),
                "args": _instant_args(ev),
            })
        elif name == "dispatch":
            attrs = ev.get("attrs", {})
            dur_ms = attrs.get("ms", 0.0)
            trace.append({
                "name": attrs.get("family", "dispatch"),
                "ph": "X", "pid": _PID_ENGINE, "tid": _TID_DISPATCH,
                "ts": ts(ev["t"] - dur_ms * 1e-3),
                "dur": round(dur_ms * 1e3, 3),
                "args": _instant_args(ev),
            })
        else:
            trace.append({
                "name": name, "ph": "i", "s": "t",
                "pid": _PID_ENGINE, "tid": _TID_EVENTS,
                "ts": ts(ev["t"]), "args": _instant_args(ev),
            })

    trace.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"]))
    doc = {
        "traceEvents": meta + trace,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "mmlspark_tpu_torch.core.perf.export_chrome_trace",
            "t0_unix": round(t0_unix, 6),
            **(extra_meta or {}),
        },
    }
    if path is not None:
        from mmlspark_tpu_torch.core.telemetry import atomic_write_text

        atomic_write_text(path, json.dumps(
            doc, sort_keys=True, separators=(",", ":"), default=str,
        ))
        _log.info("chrome trace: %d events -> %s",
                  len(doc["traceEvents"]), path)
    return doc


def _meta(name: str, pid: int, tid: int, args: dict) -> dict:
    return {"name": name, "ph": "M", "pid": pid, "tid": tid,
            "args": args, "ts": 0.0}


def _instant_args(ev: dict) -> dict:
    args = dict(ev.get("attrs", {}))
    if "tick" in ev:
        args["tick"] = ev["tick"]
    return args
