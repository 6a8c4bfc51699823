"""``ServeEngine`` — the continuous-batching serving API, ported from
``mmlspark_tpu/serve/engine.py`` for one device.

Requests of different prompt lengths and arrival times share the slot
pool's fixed-shape buffers. Each tick admits queued requests into free
slots (one bucketed prefill each), runs ONE fused decode block of up to
``decode_block`` greedy micro-steps for every active slot
(``models.generate.make_decode_block``: sampling, position advance and
the live/EOS/budget mask stay on the device), and then syncs the host
once, to read the block's ``(S, T)`` tokens and the live vector. Every
micro-step reads each slot's cache through a hand-written CUDA decode
kernel.

The program ladder: as the JAX engine runs each serving program as one
compiled XLA program, the port runs each as one CUDA graph
(``testing/compile_guard.ProgramCountingGraph``): the prefill (one
program per prefill bucket), the prefix-cache resume (one per remainder
bucket; ``pos`` and ``last`` are device tensors, so the program does not
depend on them) and the fused decode block (one per ladder size T). A
program is captured after its signature's first, eager call and replayed
after that; all of an engine's programs share one graph memory pool. The
counts are ``decode_compile_count``, ``prefill_compile_count`` and
``resume_compile_count``, under the JAX engine's pins, each program
family behind a ``RetraceWatchdog``. On the CPU (``device="cpu"``) the
programs run eagerly and are counted the same way. A program that fails to
capture raises; there is no eager fallback.

Prefill is bucketed by prompt length: prompts right-pad to power-of-two
buckets (causality makes the pads invisible). Block sizes clamp to a
power-of-two ladder and to the smallest remaining budget, so budget
exhaustion only ever lands on a block boundary. The pool's buffers and
its per-slot positions and live mask are updated in place where the JAX
engine donates them.

Usage::

    engine = ServeEngine(graph, variables, slots=8)    # on cuda
    # or: ServeEngine(..., paged=True, prefix_cache=True, kv_dtype="int8")
    rid = engine.submit(prompt_ids, max_new_tokens=32)
    results = engine.run()
    results[rid].tokens                                # prompt + generated

Pools: the dense bf16 slot pool (the default), its int8 mode
(``kv_dtype="int8"``: int8 K/V with per-(slot, kv head) scales, read by
``flash_decode``'s int8 kernel), and the paged pool (``paged=True``,
``serve/paging.py``: pages mapped on demand, read by the CUDA
``paged_flash_decode`` kernel; with ``kv_dtype="int8"`` too). With
``prefix_cache=True`` a paged engine prefills a prompt that shares a
cached prefix over the REMAINDER only: the prefix's K/V is gathered into
a linear cache, the remainder runs at ``pos=keep`` against it, and the
prefix's pages are mapped shared into the slot (copy-on-extend when the
slot's writes enter a shared page).

Weights: the bf16 engine casts each ``Dense`` leaf to its compute dtype
once, when it is built (``models.transformer.compute_dtype_variables``),
on its own copy of the variables; the caller's are untouched and the
streams are bit-equal. Weight-only int8 (``quantize_weights=True``,
``ops/quantize.py``): the engine keeps per-output-channel int8 weights on
the device and dequantizes them to bf16 inside every program — each
prefill or resume forward and each decode block — as the JAX engine runs
``_deq`` inside each of its programs; the graph drops its binding after
each call. No bf16 copy is reachable between calls, but the shared graph
pool keeps the memory one call's bf16 workspace needs reserved
(``graph_pool_bytes``). It composes with both pools and both KV dtypes.

Decode is greedy — the same tokens as ``generate()`` per request, which
is the engine's correctness contract (int8 pools and int8 weights:
within a token-flip budget of the bf16 streams). Not in this slice:
meshes, fault injection, retries and the degradation ladder (page exhaustion raises
``ResourceExhausted``), chunked prefill and its ``chunk`` programs, the
async host loop, snapshots, hand-offs and SLOs (ROADMAP.md Queue 1 items
8-9, 12-13).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import default_device, host_to_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.telemetry import (
    FlightRecorder,
    MetricRegistry,
    RetraceWatchdog,
)
from mmlspark_tpu_torch.models.bridge import variables_to
from mmlspark_tpu_torch.models.generate import (
    _cached_apply,
    greedy_next,
    init_cache,
    make_decode_block,
)
from mmlspark_tpu_torch.models.transformer import compute_dtype_variables
from mmlspark_tpu_torch.ops.quantize import dequantize_weights
from mmlspark_tpu_torch.ops.quantize import (
    quantize_weights as _quantize_variables,
)
from mmlspark_tpu_torch.serve.cache_pool import SlotCachePool
from mmlspark_tpu_torch.serve.metrics import ServeMetrics
from mmlspark_tpu_torch.serve.paging import PagedCachePool
from mmlspark_tpu_torch.serve.scheduler import (
    ContinuousBatchScheduler,
    RequestResult,
    ServeRequest,
)
from mmlspark_tpu_torch.testing.compile_guard import (
    GraphPool,
    ProgramCountingGraph,
    program_count,
)


class ServeEngine:
    def __init__(self, graph, variables, *, slots: int = 4,
                 cache_len: int | None = None, max_queue: int = 16,
                 pad_id: int = 0, decode_block: int = 32,
                 paged: bool = False, page_size: int | None = None,
                 num_pages: int | None = None, prefix_cache: bool = False,
                 kv_dtype: str = "bf16", quantize_weights: bool = False,
                 device=None):
        if not graph.extra.get("causal", False):
            raise FriendlyError(
                f"serving needs a causal LM; '{graph.name}' has "
                "causal=False"
            )
        max_len = graph.input_shape[0] if graph.input_shape else None
        if cache_len is None:
            if not max_len:
                raise FriendlyError(
                    f"'{graph.name}' records no input_shape; pass "
                    "cache_len explicitly to size the slot KV buffers"
                )
            cache_len = max_len
        if (
            max_len
            and cache_len > max_len
            and graph.extra.get("pos_embedding", "learned") == "learned"
        ):
            raise FriendlyError(
                f"cache_len ({cache_len}) exceeds the learned position "
                f"table ({max_len}); build the model with a larger "
                "max_len or pos_embedding='rope'"
            )
        window = graph.extra.get("window")
        if window and window < cache_len:
            raise FriendlyError(
                f"'{graph.name}' uses a sliding window ({window}) "
                f"smaller than cache_len ({cache_len}); the slot pool "
                "holds linear per-slot buffers only. Serve with "
                "cache_len <= window, or build the model without window"
            )
        if decode_block < 1:
            raise FriendlyError(
                f"decode_block must be >= 1, got {decode_block} "
                "(1 = per-token dispatch, larger fuses T micro-steps "
                "into one block)"
            )
        self.device = default_device(device)
        self.graph = graph
        self.variables = variables_to(variables, self.device)
        # weight-only int8: EVERY projection goes int8 (min_size=0: at
        # decode batch sizes each call streams the whole weight set for
        # a handful of FLOPs); the engine keeps no reference to the float
        # weights, and the pools size their buffers from the int8 qkv
        # payloads (models.generate.cache_geometry)
        self._quantized_weights = bool(quantize_weights)
        if quantize_weights:
            self.variables = _quantize_variables(graph, self.variables,
                                                 min_size=0)
        else:
            # every Dense leaf in its compute dtype once, in place of the
            # f32 leaf Dense.forward would cast on every call
            self.variables = compute_dtype_variables(graph, self.variables)
        self.pad_id = pad_id
        self.cache_len = cache_len
        # floor to a power of two: block sizes live on the ladder
        # {1, 2, 4, ..., decode_block}
        self.decode_block = 1 << (int(decode_block).bit_length() - 1)
        if not paged and (
            page_size is not None or num_pages is not None or prefix_cache
        ):
            raise FriendlyError(
                "page_size/num_pages/prefix_cache configure the paged "
                "KV cache; pass paged=True to enable it"
            )
        self._paged = bool(paged)
        self._prefix_cache = bool(paged and prefix_cache)
        self.kv_dtype = kv_dtype
        if paged:
            self.pool = PagedCachePool(
                graph, self.variables, slots, cache_len, device=self.device,
                page_size=page_size, num_pages=num_pages,
                prefix_cache=prefix_cache, kv_dtype=kv_dtype,
            )
        else:
            self.pool = SlotCachePool(graph, self.variables, slots,
                                      cache_len, device=self.device,
                                      kv_dtype=kv_dtype)
        self.metrics = ServeMetrics(
            graph.name, slots, decode_block=self.decode_block,
            cache_pool_bytes_per_device=self.pool.device_bytes_per_device(),
            kv_dtype=kv_dtype,
        )
        if paged:
            self.metrics.attach_paging(self.pool.paging_stats)
        self._sched = ContinuousBatchScheduler(self.pool,
                                               max_queue=max_queue)
        self._vocab = graph.extra.get("vocab_size")
        self._next_id = 0
        self._block = make_decode_block(graph, pad_id)
        self.registry = MetricRegistry()
        self.recorder = FlightRecorder()
        # the program ladder: each family behind the retrace watchdog,
        # with the JAX engine's budgets; the weights (argument 0) and the
        # decode block's pool state (1-3) are read and written at their
        # own addresses, everything else is copied into a program's
        # static inputs
        self._graph_pool = GraphPool()
        self._prefill_program = self._program(
            self._prefill_body, "serve.prefill", self.num_prefill_buckets,
            state_argnums=(0,))
        self._resume = None
        if self._prefix_cache:
            self._resume = self._program(
                self._resume_body, "serve.resume", self.num_prefill_buckets,
                state_argnums=(0,))
        self._decode = self._program(
            self._decode_body, "serve.decode", self.num_decode_blocks,
            state_argnums=(0, 1, 2, 3))

    def _program(self, fn, label: str, expected: int,
                 state_argnums) -> RetraceWatchdog:
        return RetraceWatchdog(
            ProgramCountingGraph(fn, state_argnums=state_argnums,
                                 pool=self._graph_pool, label=label),
            label, registry=self.registry, recorder=self.recorder,
            expected_programs=expected,
        )

    # -- the programs --------------------------------------------------------

    def _prefill_body(self, variables, ids, last):
        """(1, bucket) padded prompt -> (the first greedy token, read at
        position ``last``, the true prompt end; a bucket-long linear
        cache)."""
        cache = init_cache(self.graph, variables, 1, ids.shape[1])
        return self._resume_body(variables, ids, cache, 0, last)

    def _resume_body(self, variables, ids, cache, pos, last):
        """``ids`` at absolute position ``pos`` (0 for a prefill, a 0-d
        device tensor for the prefix-cache remainder) against the linear
        ``cache``."""
        with self._weights(variables) as weights:
            logits, cache = _cached_apply(self.graph, weights, ids, cache,
                                          pos)
        return greedy_next(_row(logits, last)), cache

    def _decode_body(self, variables, buffers, positions, live, tok, rem,
                     eos, t):
        """One fused decode block of ``t`` micro-steps. The pool's
        buffers are written in place, and its per-slot positions and live
        mask advance in place from the block's outputs (the JAX engine
        donates them); returns the (S, t) tokens."""
        with self._weights(variables) as weights:
            toks, new_live, _, new_pos = self._block(
                weights, buffers, positions, live, tok, rem, eos, t)
        positions.copy_(new_pos)
        live.copy_(new_live)
        return toks

    # -- prefill buckets ---------------------------------------------------

    def prefill_bucket(self, prompt_len: int) -> int:
        """Padded length the prefill runs at for a prompt of
        ``prompt_len``: the next power of two >= max(prompt_len, 8),
        capped at ``cache_len``."""
        bucket = 8
        while bucket < prompt_len:
            bucket *= 2
        return min(bucket, self.cache_len)

    @property
    def num_prefill_buckets(self) -> int:
        """How many distinct prefill shapes CAN run on this engine."""
        return len({
            self.prefill_bucket(p) for p in range(1, self.cache_len)
        })

    # -- decode-block ladder ----------------------------------------------

    def _block_size(self, min_rem: int) -> int:
        """This tick's block length: the largest ladder power of two
        <= min(decode_block, minimum remaining budget over active
        slots)."""
        cap = min(self.decode_block, max(1, min_rem))
        t = 1
        while t * 2 <= cap:
            t *= 2
        return t

    @property
    def num_decode_blocks(self) -> int:
        """How many distinct block sizes CAN run — one per ladder size T
        in {1, 2, 4, ..., decode_block}."""
        return self.decode_block.bit_length()

    # -- program counts ------------------------------------------------------

    @property
    def decode_compile_count(self) -> int:
        """How many DISTINCT decode-block programs exist — one per ladder
        size actually run, never more than ``num_decode_blocks`` (the
        micro-steps inside a block do not count)."""
        return program_count(self._decode)

    @property
    def prefill_compile_count(self) -> int:
        """How many prefill programs exist — bounded by
        ``num_prefill_buckets``, however many distinct prompt lengths
        arrive."""
        return program_count(self._prefill_program)

    @property
    def resume_compile_count(self) -> int:
        """How many prefix-resume programs exist — keyed by the REMAINDER
        bucket, so bounded by ``num_prefill_buckets``; 0 without the
        prefix cache."""
        if self._resume is None:
            return 0
        return program_count(self._resume)

    @property
    def capture_seconds(self) -> float:
        """Wall seconds the engine's programs took to capture (0 on the
        CPU)."""
        return sum(w.capture_seconds for w in (
            self._prefill_program, self._resume, self._decode)
            if w is not None)

    def graph_pool_bytes(self) -> int:
        """Device bytes the programs' shared graph pool holds reserved."""
        return self._graph_pool.reserved_bytes()

    # -- introspection -----------------------------------------------------

    @property
    def tick(self) -> int:
        return self._sched.tick_count

    @property
    def queue_depth(self) -> int:
        return self._sched.queue_depth

    @property
    def busy(self) -> bool:
        return self._sched.busy

    # -- public API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: int | None = None,
               deadline_ticks: int | None = None) -> int:
        """Queue one request; returns its id. Raises
        :class:`FriendlyError` on invalid budgets or a full queue.
        ``deadline_ticks``: the request must FINISH within that many
        ticks of submission or it expires (status ``"expired"``)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise FriendlyError(
                f"prompt must be a non-empty 1-D token vector, got "
                f"shape {prompt.shape} (the engine serves one request "
                "per submit; batch by submitting several)"
            )
        if max_new_tokens < 1:
            raise FriendlyError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if int(prompt.size) >= self.cache_len:
            raise FriendlyError(
                f"prompt length ({prompt.size}) must be < the engine's "
                f"cache_len ({self.cache_len}); truncate the prompt or "
                "build the engine with a larger cache_len"
            )
        if self._vocab is not None:
            lo, hi = int(prompt.min()), int(prompt.max())
            if lo < 0 or hi >= int(self._vocab):
                raise FriendlyError(
                    f"prompt tokens must be in [0, {self._vocab}) for "
                    f"'{self.graph.name}', got range [{lo}, {hi}]"
                )
        if int(prompt.size) + max_new_tokens > self.cache_len:
            raise FriendlyError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's cache_len "
                f"({self.cache_len}); shorten the request or build the "
                "engine with a larger cache_len"
            )
        if deadline_ticks is not None and deadline_ticks < 1:
            raise FriendlyError(
                f"deadline_ticks must be >= 1, got {deadline_ticks}"
            )
        req = ServeRequest(
            id=self._next_id,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            deadline_tick=(
                self.tick + deadline_ticks
                if deadline_ticks is not None else None
            ),
            submit_tick=self.tick,
            submit_wall=time.perf_counter(),
        )
        try:
            self._sched.enqueue(req)
        except FriendlyError:
            self.metrics.record_reject()
            raise
        self._next_id += 1
        self.metrics.record_submit()
        return req.id

    def step(self) -> list[RequestResult]:
        """One scheduler tick: expire deadlines, admit queued requests
        into free slots (one prefill per joiner), ONE fused decode block
        for all active slots, retire finished sequences. Returns the
        requests that reached a terminal state this tick."""
        t0 = time.perf_counter()
        tick = self._sched.tick_count
        finished = self._sched.expire(tick)
        tokens_this_tick = 0
        while self._sched.queue_depth and self.pool.free_count:
            req = self._sched.pop_next()
            slot = self.pool.lease()
            first, bucket = self._prefill(slot, req.prompt)
            self.metrics.record_first_token(req, tick, bucket)
            tokens_this_tick += 1
            done = self._sched.activate(slot, req, first, tick)
            if done is not None:
                finished.append(done)
        # slot occupancy AS OF the decode block: a request can join and
        # retire inside one tick
        leased_this_tick = self.pool.leased_count
        if self._sched.active:
            tokens_this_tick += self._decode_phase(tick, finished)
        self._sched.tick_count += 1
        self.metrics.sample_tick(
            self._sched.queue_depth, leased_this_tick,
            time.perf_counter() - t0, tokens_emitted=tokens_this_tick,
        )
        for res in finished:
            self.metrics.record_finish(res)
        return finished

    def _prefill(self, slot: int, prompt: np.ndarray) -> tuple[int, int]:
        """Prefill ``prompt`` into ``slot`` and return (the first greedy
        token, a host sync; the bucket the forward ran at). A prefix-cache
        hit runs only the remainder, over the cached prefix's gathered
        K/V; a miss (or a stale entry) runs the whole prompt on a batch-1
        linear cache of one bucket."""
        p = len(prompt)
        hit = (self.pool.prefix_lookup(prompt, self.prefill_bucket)
               if self._prefix_cache else None)
        if hit is not None:
            entry, keep = hit
            r = p - keep
            bucket = self.prefill_bucket(r)
            lin = self.pool.gather_prefix(entry, keep)
            tok, cache = self._resume(
                self.variables, self._padded(prompt[keep:], bucket), lin,
                self._scalar(keep), self._scalar(r - 1))
            # map the shared pages FIRST (the slot's references keep them
            # alive through any eviction the remainder write triggers),
            # then scatter only the remainder [keep, p)
            if self.pool.map_prefix(slot, entry, keep):
                self.pool.write_prefill(slot, cache, p, start=keep)
                return int(tok), bucket
            # the entry was evicted since the lookup: its pages may be
            # free or reallocated, so fall back to the full prefill
        bucket = self.prefill_bucket(p)
        tok, cache = self._prefill_program(
            self.variables, self._padded(prompt, bucket),
            self._scalar(p - 1))
        # only the REAL prompt's K/V enter the slot; the pad tail of the
        # bucket cache is dropped here (the program's outputs are consumed
        # before any other program replays)
        self.pool.write_prefill(slot, cache, p)
        if self._prefix_cache:
            self.pool.prefix_insert(slot, prompt)
        return int(tok), bucket

    def _padded(self, tokens: np.ndarray, bucket: int):
        """``tokens`` right-padded to (1, ``bucket``) on the device."""
        padded = np.full((1, bucket), self.pad_id, np.int32)
        padded[0, :len(tokens)] = tokens
        return host_to_device(padded, self.device)

    def _scalar(self, value: int):
        """An int32 0-d device tensor (a fill, no host copy): a program's
        position input."""
        return torch.full((), value, dtype=torch.int32, device=self.device)

    @contextlib.contextmanager
    def _weights(self, variables: dict):
        """The weights one program runs on: the resident variables, or —
        weight-int8 — a bf16 dequantization made inside the program,
        which the graph drops when the call ends (no bf16 copy outlives
        it)."""
        if not self._quantized_weights:
            yield variables
            return
        try:
            yield dequantize_weights(variables)
        finally:
            self.graph.unbind()

    def _decode_phase(self, tick: int, finished: list) -> int:
        """One fused decode BLOCK for all active slots, with ONE host
        sync; appends terminal results to ``finished`` and returns the
        real tokens consumed."""
        states = list(self._sched.active.items())
        pre_pos = {slot: st.pos for slot, st in states}
        tok, rem, eos, min_rem = self._sched.decode_block_inputs(
            self.pad_id
        )
        t_block = self._block_size(min_rem)
        td = time.perf_counter()
        if self._paged:
            # pre-map every page this block can write; the page table is
            # read-only during the block (its one host sync)
            self.pool.ensure_decode_pages(pre_pos, t_block)
        # the buffers, positions and live mask advance in place
        toks = self._decode(
            self.variables, self.pool.buffers, self.pool.positions,
            self.pool.live, *(host_to_device(a, self.device)
                              for a in (tok, rem, eos)), t_block,
        )
        # the ONE host sync per block: (S, T) tokens + the live vector
        toks_h = toks.cpu().numpy()
        live_h = self.pool.live.cpu().numpy()
        decode_s = time.perf_counter() - td
        blk_finished, consumed = self._sched.consume(toks_h, tick)
        n_tokens = sum(consumed.values())
        # live KV rows the block attended per slot: its c consumed
        # micro-steps read frontiers pos0+1 .. pos0+c
        live_kv = sum(
            c * (pre_pos[slot] + 1) + c * (c - 1) // 2
            for slot, c in consumed.items()
        )
        self.metrics.record_decode(
            decode_s, n_tokens, block=t_block, live_kv=live_kv,
            cache_len=self.cache_len,
        )
        for slot, _ in states:
            # the device live mask and the host's retirement bookkeeping
            # must agree slot for slot
            if bool(live_h[slot]) != (slot in self._sched.active):
                raise RuntimeError(
                    f"device live mask and host retirement disagree for "
                    f"slot {slot} (block T={t_block})"
                )
        finished.extend(blk_finished)
        return n_tokens

    def run(self, max_ticks: int = 100_000) -> dict[int, RequestResult]:
        """Step until queue and slots drain; results keyed by request id.
        Hitting ``max_ticks`` retires every pending request as
        ``"stalled"`` and raises, with all results on ``err.results``."""
        results: dict[int, RequestResult] = {}
        start = self.tick
        while self._sched.busy:
            if self.tick - start >= max_ticks:
                n_queued = self._sched.queue_depth
                n_active = len(self._sched.active)
                for res in self._sched.stall_pending(self.tick):
                    results[res.id] = res
                    self.metrics.record_finish(res)
                err = FriendlyError(
                    f"serve run() exceeded max_ticks ({max_ticks}) with "
                    f"{n_queued} queued and {n_active} active requests; "
                    "partial results (completed + 'stalled') are "
                    "attached as err.results"
                )
                err.results = results
                raise err
            for res in self.step():
                results[res.id] = res
        return results


def _row(logits, last):
    """Row ``last`` (a 0-d device tensor) of batch-1 ``logits`` (1, B, V):
    a gather, so the host never reads the position."""
    return torch.index_select(logits[0], 0, last.reshape(1).long())[0]
