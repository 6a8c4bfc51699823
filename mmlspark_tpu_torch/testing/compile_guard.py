"""Program counting and the compile-count guard — the port of
``mmlspark_tpu/testing/compile_guard.py``.

The JAX package runs each serving program (prefill per bucket, resume per
remainder bucket, the fused decode block per ladder size) and each
training dispatch as one compiled XLA program, counts the programs, and
pins the counts. In the port a program is a CUDA graph:
:class:`ProgramCountingGraph` keys a callable by its static signature
(each tensor argument's shape, dtype and device, and every non-tensor
argument's value), captures one graph per key on a CUDA device and
replays it, and counts the keys — the counterpart of
``ProgramCountingJit``. On the CPU, which a caller must ask for, it runs
the callable eagerly and counts keys the same way, so the CPU tests can
compare its counts with the JAX engine's.

A key's FIRST call runs eagerly: lazy initialisation (cuBLAS handles,
kernel module loads, shared-memory attributes) happens outside capture,
and its result is the real result. The graph is captured right after it.
Capture executes nothing, so the state the first call left stands: no
KV write, position advance or optimizer update runs twice. Later calls
copy their tensor arguments into the graph's static inputs and replay;
the outputs are the graph's static outputs, valid until the next replay
of any graph that shares its memory pool. Arguments named in
``state_argnums`` are the program's state: their tensors are read and
written at their own addresses (the KV pool, positions, weights), so
they are not copied, and a replay with tensors at other addresses
raises.

Python's cyclic garbage collector is held off while a graph is captured
(:func:`no_cyclic_gc`; ``torch.cuda.graph`` collects once just before).
A collection that ran inside the capture could free objects from earlier
work — captured graphs, pinned buffers, events — whose release makes
CUDA calls that are illegal while a stream is capturing, and so
invalidates the capture: a program then fails to capture for a reason
outside it (``tests/test_torch_cuda.py::
test_collection_inside_a_capture_cannot_invalidate_it``).

The kernel wrappers count their launches in Python, and a replay runs no
Python, so a capture records each launch counter's delta and every
replay adds it (:data:`LAUNCH_COUNTER_MODULES`). A program that fails to
capture (a host sync inside it, or an allocation failure under memory
pressure) raises a ``RuntimeError`` naming the program, chained to the
cause; nothing falls back. The failed capture leaves no program behind —
the capture stream is closed and the key stays unknown, so the next call
with that signature runs eagerly and captures again — but the eager call
before it has run, so its writes to state arguments stand (a caller that
retries restores what it needs).

The guard itself::

    with compile_guard(lambda: engine.decode_compile_count,
                       max_programs=engine.num_decode_blocks,
                       min_programs=1, label="decode"):
        ... drive traffic ...

or, pinning both serve programs to the engine's own ceilings at once::

    with serve_compile_guard(engine):
        ... drive traffic ...
"""

from __future__ import annotations

import gc
import importlib
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Iterator

import torch

from mmlspark_tpu_torch.utils.profiling import annotate

#: modules whose ``COUNTERS`` name module-level launch counters that a
#: replay adds to (the kernel wrappers)
LAUNCH_COUNTER_MODULES = (
    "mmlspark_tpu_torch.ops.flash_attention",
    "mmlspark_tpu_torch.ops.fused_optim",
    "mmlspark_tpu_torch.ops.tree_checksum",
)


def program_count(fn) -> int:
    """Program count of a counting callable, -1 when the object exposes
    no ``_cache_size`` — the one counting contract that
    ``compile_guard`` callers, ``ServeEngine``'s compile-count properties
    and ``RetraceWatchdog`` read through (``jit_cache_size`` in the JAX
    package)."""
    cache_size = getattr(fn, "_cache_size", None)
    return cache_size() if callable(cache_size) else -1


def launch_counts() -> dict:
    """``{(module, counter): value}`` over every kernel launch counter."""
    counts = {}
    for name in LAUNCH_COUNTER_MODULES:
        mod = importlib.import_module(name)
        for counter in mod.COUNTERS:
            counts[(name, counter)] = getattr(mod, counter)
    return counts


def _add_launches(delta: dict) -> None:
    for (name, counter), n in delta.items():
        if n:
            mod = importlib.import_module(name)
            setattr(mod, counter, getattr(mod, counter) + n)


def _set_launches(counts: dict) -> None:
    for (name, counter), n in counts.items():
        setattr(importlib.import_module(name), counter, n)


def _signature(x) -> Any:
    """The static part of an argument: a tensor's shape, dtype and device;
    the structure of dicts, lists and tuples; any other value itself."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return ("D", tuple((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_signature(v) for v in x))
    return ("S", x)


def _tensors(x) -> list:
    """Every tensor leaf of ``x``, in the order :func:`_signature` walks."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _clone(x):
    """``x`` with every tensor leaf cloned (the static inputs)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


def _on_cuda(args) -> bool:
    return any(t.device.type == "cuda" for a in args for t in _tensors(a))


class GraphPool:
    """One CUDA graph memory pool that several programs share, made on
    first use: the workspace of a program family (an engine's ladder) is
    paid once, not once per program. Programs that share a pool must not
    replay while another's outputs are still in use; the engine consumes
    each program's outputs before its next replay."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def reserved_bytes(self) -> int:
        """Device bytes the pool's segments hold (0 before any capture)."""
        if self._handle is None:
            return 0
        want = tuple(self._handle)
        return int(sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == want))


class _Program:
    """One captured graph: its static inputs, outputs and launch delta."""

    def __init__(self, graph, args, statics, out, delta, state):
        self.graph = graph
        self.out = out
        self.delta = delta
        # (argument index, the static tensor leaves) of the copied args
        self.copied = [(i, _tensors(s)) for i, s in enumerate(statics)
                       if i not in state and _tensors(s)]
        # state args: the object captured, and its tensors' addresses
        self.state = {i: (args[i], [t.data_ptr() for t in _tensors(args[i])])
                      for i in state}

    def replay(self, args, label: str):
        for i, (obj, ptrs) in self.state.items():
            if args[i] is not obj and [
                    t.data_ptr() for t in _tensors(args[i])] != ptrs:
                raise RuntimeError(
                    f"{label}: state argument {i} holds tensors at other "
                    "addresses than the captured program reads; a "
                    "program's state must keep its addresses"
                )
        for i, statics in self.copied:
            for static, t in zip(statics, _tensors(args[i])):
                if t is not static:
                    static.copy_(t, non_blocking=True)
        self.graph.replay()
        _add_launches(self.delta)
        return self.out


class ProgramCountingGraph:
    """Wrap ``fn`` so each distinct static signature is one program: a
    CUDA graph captured after the signature's first (eager) call and
    replayed on every later one, or on the CPU an eager call. ``_cache_size``
    counts programs (the JAX ``ProgramCountingJit`` contract);
    ``capture_seconds`` sums the captures' wall time. ``pool``, a
    :class:`GraphPool`, is shared by the programs of one family. ``span``
    names a profiler range around a key's first call and capture on the
    card, so a trace tells a capture from the work around it."""

    def __init__(self, fn: Callable, *, state_argnums=(),
                 pool: GraphPool | None = None, label: str = "program",
                 span: str | None = None):
        self._fn = fn
        self._state = frozenset(state_argnums)
        self.pool = pool if pool is not None else GraphPool()
        self.label = label
        self._span = span
        self._programs: dict = {}
        self.capture_seconds = 0.0

    def _cache_size(self) -> int:
        return len(self._programs)

    def release(self) -> None:
        """Drop every captured graph — and with the last of them the
        pool's memory — keeping the program count (a killed engine's
        post-mortem reads it). A released key runs eagerly if called
        again."""
        self._programs = dict.fromkeys(self._programs)

    def __call__(self, *args):
        key = tuple(_signature(a) for a in args)
        if key not in self._programs:
            if not _on_cuda(args):
                out = self._fn(*args)
                self._programs[key] = None
                return out
            with (annotate(self._span) if self._span is not None
                  else nullcontext()):
                out = self._fn(*args)
                self._programs[key] = self._capture(args)
            return out
        program = self._programs[key]
        if program is None:
            return self._fn(*args)
        return program.replay(args, self.label)

    def _capture(self, args) -> _Program:
        statics = [a if i in self._state else _clone(a)
                   for i, a in enumerate(args)]
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with no_cyclic_gc(), torch.cuda.graph(graph,
                                                  pool=self.pool.handle()):
                out = self._fn(*statics)
        except Exception as e:
            raise RuntimeError(
                f"{self.label}: the program failed to capture as a CUDA "
                f"graph ({type(e).__name__}: {e}); a program may not sync "
                "the host, copy from pageable host memory or branch on a "
                "device value"
            ) from e
        finally:
            # capture executed nothing: the launches it counted are the
            # delta each replay adds
            after = launch_counts()
            _set_launches(before)
        self.capture_seconds += time.perf_counter() - t0
        delta = {k: after[k] - before[k] for k in before}
        return _Program(graph, args, statics, out, delta, self._state)


@contextmanager
def no_cyclic_gc() -> Iterator[None]:
    """Python's automatic cyclic garbage collection held off for the
    block, and restored after it (an explicit ``gc.collect()`` still
    runs)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@contextmanager
def compile_guard(count_fn: Callable[[], int], *, max_programs: int,
                  min_programs: int = 0,
                  label: str = "jitted program") -> Iterator[None]:
    """Assert that at most ``max_programs`` (and at least
    ``min_programs``) NEW programs are made inside the block.

    ``count_fn`` is sampled on entry and exit; the delta is what is
    asserted, as a plain ``AssertionError``. Exceptions from the block
    propagate untouched.
    """
    if max_programs < min_programs:
        raise ValueError(
            f"max_programs ({max_programs}) < min_programs "
            f"({min_programs})"
        )
    before = count_fn()
    yield
    grown = count_fn() - before
    if grown > max_programs:
        raise AssertionError(
            f"{label}: {grown} programs compiled, expected at most "
            f"{max_programs} — a shape or static argument is varying "
            "across calls that the design says must share one program"
        )
    if grown < min_programs:
        raise AssertionError(
            f"{label}: {grown} programs compiled, expected at least "
            f"{min_programs} — the guarded block never reached the "
            "jitted path it was meant to exercise"
        )


@contextmanager
def serve_compile_guard(engine, *, min_decode: int = 0,
                        min_prefill: int = 0,
                        label: str = "serve") -> Iterator[None]:
    """Pin BOTH of a ``ServeEngine``'s program families to their design
    ceilings across the block: the fused decode block to its power-of-two
    ladder (``num_decode_blocks``) and bucketed prefill to
    ``num_prefill_buckets``."""
    with compile_guard(
        lambda: engine.decode_compile_count,
        max_programs=engine.num_decode_blocks,
        min_programs=min_decode, label=f"{label}.decode",
    ), compile_guard(
        lambda: engine.prefill_compile_count,
        max_programs=engine.num_prefill_buckets,
        min_programs=min_prefill, label=f"{label}.prefill",
    ):
        yield
