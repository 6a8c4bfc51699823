"""``ServeEngine`` — the continuous-batching serving API, ported from
``mmlspark_tpu/serve/engine.py``, on one device or over a serving mesh.

Requests of different prompt lengths and arrival times share the slot
pool's fixed-shape buffers. Each tick admits queued requests into free
slots (one bucketed prefill each, or the start of a chunked fill), runs
ONE fused decode block of up to ``decode_block`` greedy micro-steps for
every active slot (``models.generate.make_decode_block``: sampling,
position advance and the live/EOS/budget mask stay on the device), and
fetches the block's ``(S, T)`` tokens and live vector with one host sync.
Every micro-step reads each slot's cache through a hand-written CUDA
decode kernel.

The program ladder: as the JAX engine runs each serving program as one
compiled XLA program, the port runs each as one CUDA graph
(``testing/compile_guard.ProgramCountingGraph``): the prefill (one
program per prefill bucket), the prefix-cache resume (one per remainder
bucket; ``pos`` and ``last`` are device tensors, so the program does not
depend on them), the chunked fill (one per chunk bucket) and the fused
decode block (one per ladder size T). A program is captured after its
signature's first, eager call and replayed after that; all of an engine's
programs share one graph memory pool. The counts are
``decode_compile_count``, ``prefill_compile_count`` and
``resume_compile_count``, under the JAX engine's pins, each program
family behind a ``RetraceWatchdog``. On the CPU (``device="cpu"``) the
programs run eagerly and are counted the same way. A program that fails
to capture raises; there is no eager fallback.

Prefill is bucketed by prompt length: prompts right-pad to power-of-two
buckets (causality makes the pads invisible). MoE models
(``transformer_lm_moe``) prefill at exact length, as the JAX engine
does: expert-capacity routing is not causal (a pad would consume
capacity that can change a real token's expert), so they take one
prefill (and prefix-cache resume) program per distinct prompt
(remainder) length, under a pin of ``cache_len - 1``. Block sizes clamp
to a power-of-two ladder and to the smallest remaining budget, so budget
exhaustion only ever lands on a block boundary. The pool's buffers and
its per-slot positions and live mask are updated in place where the JAX
engine donates them.

**Chunked prefill** (``prefill_chunk=N``, a power of two >= 8): admission
only starts a fill; every tick advances each open fill by ONE chunk
program over a window of its sequence against the fill's carry — a
batch-1 linear cache of the full ``cache_len``, in a tensor of its own
outside the graph pool. Intermediate chunks are exactly N wide and sync
nothing; the chunk program's static output carry is copied back into the
fill's tensor before any other program replays. The final chunk pads to
its ladder bucket (window trick: ``start = min(filled, cache_len -
bucket)``, the overlap recomputed to the same values), lands the carry in
the slot with ``write_prefill(start=keep)`` and pays the fill's one sync,
for the first token. A long prompt can then never hold every co-resident
stream behind one monolithic prefill. With chunking on,
``prefill_compile_count`` counts the chunk programs (at most
``num_chunk_buckets``).

**The async host loop** (``async_host=True``): block N+1 is dispatched
before block N is fetched, so the host's scheduling and bookkeeping
overlap N's device time. Right after each replay the block's tokens and
live vector are copied (non-blocking) into pinned host buffers owned by
its in-flight record, its last tokens are copied on the device, and a
CUDA event is recorded: the static outputs are overwritten by later
replays, and the fetch waits on that event only, never on block N+1.
Block N+1's inputs come from the device (the in-flight last tokens
selected on the device) and from budgets and page frontiers advanced by
N's block size; the fetch's identity fence drops every row whose slot
changed hands after dispatch; frees are DEFERRED (a freed slot is not
re-leased, and a paged slot's pages not released) until the block that
saw it live has been fetched. Every device write — per-slot resets, page
tables, prefill scatters — is enqueued on the one stream after the block
in flight. Streams are bit-equal to the synchronous loop, which is the
same dispatch and fetch with nothing in between.

**The resilience layer**: a ``faults`` injector (``core/faults.py``) fires
at ``serve.prefill``, ``serve.decode``, ``serve.device_get`` and
``serve.snapshot`` before the guarded call. Transient errors retry behind
a capped deterministic backoff (``retry_limit``, ``retry_backoff_s``);
resource exhaustion — injected, the paged allocator's, or a real
``torch.cuda.OutOfMemoryError``, even one raised inside a capture —
halves the decode-block cap down the existing ladder (no new program),
preempts the youngest request at the floor (its emitted tokens fold into
a resume prefix; it re-prefills ``prompt + prefix`` later and its stream
is unchanged) and tightens the admission cap; ``degrade_recover_ticks``
clean blocks re-escalate one notch. A decode call that failed after its
first, eager run wrote the pool's positions and live mask gets them
restored before the retry. A request whose dispatch stays impossible, or
whose token is out of the vocabulary (a poison), is QUARANTINED: status
``"failed"``, its slot freed, everyone else unharmed. ``cancel`` removes a
request without a result. ``snapshot`` is a JSON-able checkpoint of the
host's request state (no device state; checksummed, the JAX engine's keys
and ``version`` 1, so snapshots cross between the frameworks);
``restore`` re-hashes it first (``SnapshotCorruption`` names both
hashes) and re-queues every request with its emitted tokens as a resume
prefix. ``snapshot_every_ticks`` keeps ``last_snapshot`` fresh through
``checkpoint``; an injected ``kill`` (``EngineKilled``) parks every held
slot and the dead engine refuses further steps.

Usage::

    engine = ServeEngine(graph, variables, slots=8)    # on cuda
    # or: ServeEngine(..., paged=True, prefix_cache=True, kv_dtype="int8",
    #                 prefill_chunk=64, async_host=True)
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
prefill, resume or chunk forward and each decode block — as the JAX
engine runs ``_deq`` inside each of its programs; the graph drops its
binding after each call. It composes with both pools and both KV dtypes.

**Observability**: one request span per lifecycle (``SpanTracer`` over
the engine's ``FlightRecorder``: queued, admitted, prefill or hand-off,
decode blocks, the terminal status), a ``tick`` and a ``dispatch`` event
per tick and per program, and ``metrics.perf`` (``core/perf.py``): each
program family (``prefill[B]``, ``resume[B]``, ``chunk[W]``,
``decode[T=t]``) is costed once, on ``meta`` tensors, before its first
dispatch, and every dispatch interval ending at an EXISTING sync point is
attributed to it — MFU and HBM bandwidth with no new host sync. ``slo``
(a spec string, ``SloTargets`` or a ``SloMonitor``) sheds new admissions
while its budget burns; an idle engine always admits.

**The replica plane** (``serve/supervisor.py``, ``serve/fleet.py``):
``replica`` tags every fault-hook firing (replica-pinned faults target
this engine) and namespaces the registry's names (``replica0.serve.*``);
``registry`` hands the metrics a shared registry; ``queue_full``,
``steal_all``/``adopt`` (a drain's migration: emitted tokens ride as a
resume prefix) and ``health_counters`` (the probe surface; host only) are
what a supervisor drives. ``role="prefill"`` engines run admission and
prefill only and retire each request as ``"handed_off"``, leaving a
payload in the outbox (``take_handoffs``): the prefill (or resume, or
final chunk) program's K/V rows ``[0, p)`` CLONED out of the program's
static outputs before any other program of the engine replays (the next
prefill would overwrite them), the first token and the trace id, stamped
with ``integrity.payload_checksum`` (the hand-off's one host copy).
``role="decode"`` engines take payloads through ``adopt_handoff``: at
admission the payload is re-verified and its K/V written straight into
the leased slot by ``write_prefill`` (no program runs) through the
``serve.handoff`` fault site; a payload that is corrupt or cannot land
falls back to a full local prefill, and greedy determinism keeps the
stream unchanged either way.

**The mesh mode** (``mesh=``: a spec string ``"data=2,model=2"``, an
axes mapping or a built DeviceMesh, over an initialised process group —
NCCL, one rank a card; gloo when the caller asks for the CPU): every rank
runs this same host loop on the same requests, so the scheduler, the
leases, the page tables, the free lists and the prefix index are the same
everywhere, while the device state is sharded. ``data`` rank ``r`` holds
slots ``[r·S/d, (r+1)·S/d)`` (``slots`` must be a multiple of the axis)
and each ``model`` rank its heads and its columns or rows of the weights
(``parallel/sharding.model_split``, ``models/transformer.split_graph``):
the compute splits Megatron-style, as GSPMD partitions the JAX engine's
programs. A prefill runs on every data rank (replicated over ``data``,
split over ``model``, as XLA runs a batch of one) and only the owner's
rows take its K/V, so every rank knows the first token without a
collective; a decode block runs each rank's slots and gathers the
block's tokens and live flags over ``data`` inside the program, so the
host still fetches once a block. The programs are captured as CUDA graphs
with their collectives inside them. Weight-int8 engines keep the JAX
engine's trade: the int8 tree is replicated, and each rank dequantizes
it and runs on its own slices. A fault site firing on one rank is agreed
by every rank before any retries or degrades (``parallel.mesh.
MeshPlace.agree_error``, over a gloo group beside the mesh), as are the
SLO monitor's shed signal and its burn counters; a call that fails on
some ranks after others ran its collectives stops every rank with
``MeshDesync``. Snapshots hold host state only, so they cross between
mesh and one-device engines both ways.

Decode is greedy — the same tokens as ``generate()`` per request, which
is the engine's correctness contract (int8 pools and int8 weights:
within a token-flip budget of the bf16 streams).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from mmlspark_tpu_torch.core import integrity
from mmlspark_tpu_torch.core.env import default_device, host_to_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.faults import (
    EngineKilled,
    FaultInjector,
    is_resource_exhausted,
    is_transient,
)
from mmlspark_tpu_torch.core.integrity import SnapshotCorruption
from mmlspark_tpu_torch.core.perf import (
    ProgramCost,
    SloMonitor,
    SloTargets,
    analyze_program_cost,
    parse_slo_spec,
)
from mmlspark_tpu_torch.core.telemetry import (
    FlightRecorder,
    RetraceWatchdog,
    SpanTracer,
)
from mmlspark_tpu_torch.models.bridge import variables_to
from mmlspark_tpu_torch.models.generate import (
    _cached_apply,
    greedy_next,
    init_cache,
    make_decode_block,
)
from mmlspark_tpu_torch.models.transformer import (
    compute_dtype_variables,
    split_graph,
)
from mmlspark_tpu_torch.ops.quantize import dequantize_weights
from mmlspark_tpu_torch.ops.quantize import (
    quantize_weights as _quantize_variables,
)
from mmlspark_tpu_torch.parallel.mesh import serve_mesh
from mmlspark_tpu_torch.parallel.sharding import (
    local_variables,
    model_split,
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
from mmlspark_tpu_torch.utils.profiling import annotate


class ServeEngine:
    def __init__(self, graph, variables, *, slots: int = 4,
                 cache_len: int | None = None, max_queue: int = 16,
                 pad_id: int = 0, decode_block: int = 32, mesh=None,
                 recorder: FlightRecorder | None = None,
                 faults: FaultInjector | None = None,
                 retry_limit: int = 3, retry_backoff_s: float = 0.02,
                 degrade_recover_ticks: int = 8, slo=None,
                 paged: bool = False, page_size: int | None = None,
                 num_pages: int | None = None, prefix_cache: bool = False,
                 replica: int | None = None,
                 snapshot_every_ticks: int | None = None,
                 kv_dtype: str = "bf16", quantize_weights: bool = False,
                 role: str = "both", prefill_chunk: int | None = None,
                 async_host: bool = False, registry=None, device=None):
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
        # chunked prefill: chunk widths live on the prefill bucket
        # ladder {8, 16, ..., prefill_chunk}, one program per width
        if prefill_chunk is not None:
            if (
                prefill_chunk < 8
                or prefill_chunk & (prefill_chunk - 1)
            ):
                raise FriendlyError(
                    f"prefill_chunk must be a power of two >= 8 (the "
                    f"prefill bucket ladder's floor), got {prefill_chunk}"
                )
            if prefill_chunk > cache_len:
                raise FriendlyError(
                    f"prefill_chunk ({prefill_chunk}) exceeds cache_len "
                    f"({cache_len}); a chunk wider than the KV buffers "
                    "can never be dispatched — drop the flag or shrink "
                    "the chunk"
                )
            if graph.extra.get("n_experts"):
                raise FriendlyError(
                    f"'{graph.name}' is a MoE model, which prefills at "
                    "exact length (expert-capacity routing is not "
                    "causal, so padded chunk windows could change real "
                    "tokens' expert assignment); chunked prefill "
                    "requires bucketed prefill — drop prefill_chunk"
                )
        if retry_limit < 0:
            raise FriendlyError(
                f"retry_limit must be >= 0, got {retry_limit}"
            )
        if snapshot_every_ticks is not None and snapshot_every_ticks < 1:
            raise FriendlyError(
                f"snapshot_every_ticks must be >= 1, got "
                f"{snapshot_every_ticks}"
            )
        self._prefill_chunk = prefill_chunk
        # MoE models prefill at exact length (see the module docstring)
        self._bucketed = not graph.extra.get("n_experts")
        self._async_host = bool(async_host)
        #: the in-flight decode block's record (async mode): set at
        #: dispatch, consumed by the NEXT tick's fetch
        self._inflight: dict | None = None
        #: monotone dispatch generation stamping the pools' deferred
        #: frees
        self._dispatch_gen = 0
        #: when the previously fetched block's outputs were in hand: the
        #: anchor of the next pipelined block's queued time
        self._prev_block_done = 0.0
        self.device = default_device(device)
        self.graph = graph
        # the mesh mode: this rank's place on the (data, model) mesh, the
        # compute split and this rank's copy of the graph for it
        self._place = place = serve_mesh(mesh)
        self.mesh = place.mesh if place is not None else None
        self._split = None
        self._model = graph
        whole = variables_to(variables, self.device)
        if place is not None:
            if not place.member:
                raise FriendlyError(
                    f"this rank is outside the serving mesh "
                    f"{place.shape} (ranks {place.ranks}); every rank of "
                    "a mesh engine serves, so start one rank per mesh "
                    "device"
                )
            if self.mesh.device_type != self.device.type:
                raise FriendlyError(
                    f"the serving mesh lives on {self.mesh.device_type} "
                    f"and the engine on {self.device.type}: NCCL meshes "
                    "serve on the card, gloo meshes only when the caller "
                    "asks for the CPU"
                )
            self._split = model_split(graph, whole, place)
            self._model = split_graph(graph, self._split, place)
        # weight-only int8: EVERY projection goes int8 (min_size=0: at
        # decode batch sizes each call streams the whole weight set for
        # a handful of FLOPs); the engine keeps no reference to the float
        # weights, and the pools size their buffers from the int8 qkv
        # payloads (models.generate.cache_geometry). Under a mesh the
        # int8 tree is replicated and each program slices its dequantized
        # weights to the rank's shard (the JAX engine's trade)
        self._quantized_weights = bool(quantize_weights)
        if quantize_weights:
            self.variables = _quantize_variables(graph, whole, min_size=0)
        else:
            if self._split is not None:
                whole = local_variables(graph, whole, self._split)
            # every Dense leaf in its compute dtype once, in place of the
            # f32 leaf Dense.forward would cast on every call
            self.variables = compute_dtype_variables(self._model, whole)
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
                self._model, self.variables, slots, cache_len,
                device=self.device, page_size=page_size,
                num_pages=num_pages, prefix_cache=prefix_cache,
                kv_dtype=kv_dtype, place=place,
            )
        else:
            self.pool = SlotCachePool(self._model, self.variables, slots,
                                      cache_len, device=self.device,
                                      kv_dtype=kv_dtype, place=place)
        # the replica identity: tags every fault-hook firing (so
        # replica-pinned faults target THIS engine) and namespaces the
        # registry's metric names
        if replica is not None and replica < 0:
            raise FriendlyError(
                f"replica index must be >= 0, got {replica}"
            )
        self._replica = replica
        # the disaggregated fleet's role: "prefill" engines admit and
        # prefill only, retiring each request as "handed_off" with its
        # payload in the outbox; "decode" engines adopt payloads by
        # direct KV write (and keep full prefill, the fallback); "both"
        # is the homogeneous engine
        if role not in ("both", "prefill", "decode"):
            raise FriendlyError(
                f"role must be 'both', 'prefill' or 'decode', got "
                f"{role!r}"
            )
        self.role = role
        #: hand-off payloads awaiting collection (prefill role)
        self._outbox: list[dict] = []
        #: engine-local request id -> the pending payload its admission
        #: adopts
        self._handoffs: dict[int, dict] = {}
        self._snapshot_every = snapshot_every_ticks
        self._last_snapshot: dict | None = None
        #: set once an EngineKilled escaped and the slots were parked
        self._dead = False
        self.metrics = ServeMetrics(
            graph.name, slots, registry=registry,
            decode_block=self.decode_block,
            cache_pool_bytes_per_device=self.pool.device_bytes_per_device(),
            kv_dtype=kv_dtype, prefill_chunk=prefill_chunk or 0,
            async_host=self._async_host,
            namespace=f"replica{replica}." if replica is not None else "",
            mesh_shape=place.shape if place is not None else None,
            mesh_devices=place.devices if place is not None else 1,
        )
        if paged:
            self.metrics.attach_paging(self.pool.paging_stats)
        #: the registry the metrics, the SLO monitor and the retrace
        #: watchdogs record into
        self.registry = self.metrics.registry
        #: one span per request lifecycle, in the flight recorder
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self._tracer = SpanTracer(self.recorder)
        self._spans: dict[int, object] = {}
        self._sched = ContinuousBatchScheduler(self.pool,
                                               max_queue=max_queue)
        self._vocab = graph.extra.get("vocab_size")
        self._next_id = 0
        self._block = make_decode_block(self._model, pad_id)
        # the SLO plane: a spec string, SloTargets or a SloMonitor; while
        # its budget burns, new admissions wait (in-flight requests
        # finish)
        if isinstance(slo, str):
            slo = parse_slo_spec(slo)
        if isinstance(slo, SloTargets):
            slo = SloMonitor(slo, recorder=self.recorder,
                             registry=self.registry)
        self._slo: SloMonitor | None = slo
        if slo is not None:
            self.metrics.attach_slo(slo)
        # the resilience layer; faults=None keeps every hook one
        # attribute check
        self._faults = faults
        self._retry_limit = retry_limit
        self._retry_backoff_s = retry_backoff_s
        self._degrade_recover_ticks = max(1, degrade_recover_ticks)
        #: memory-pressure degradation: the decode-block ceiling (walks
        #: DOWN the existing ladder) and the concurrent-admission cap
        self._block_cap = self.decode_block
        self._admit_cap = slots
        self._ok_ticks = 0
        if self._faults is not None and self._faults.listener is None:
            def _on_fault(kind: str, site: str) -> None:
                self.metrics.record_fault(kind)
                self.recorder.record("fault_injected", tick=self.tick,
                                     kind=kind, site=site)
            self._faults.listener = _on_fault
        # the program ladder: each family behind the retrace watchdog,
        # with the JAX engine's budgets; the weights (argument 0) and the
        # decode block's pool state (1-3) are read and written at their
        # own addresses, everything else is copied into a program's
        # static inputs
        self._graph_pool = GraphPool()
        self._prefill_program = self._program(
            self._prefill_body, "serve.prefill",
            len({self.prefill_bucket(p) for p in range(1, cache_len)}),
            state_argnums=(0,))
        self._resume = None
        if self._prefix_cache:
            self._resume = self._program(
                self._resume_body, "serve.resume", self.num_prefill_buckets,
                state_argnums=(0,))
        # the chunked fill IS the resume body over a full-cache_len
        # carry, keyed by the chunk width alone
        self._chunk = None
        if prefill_chunk is not None:
            self._chunk = self._program(
                self._resume_body, "serve.chunk", self.num_chunk_buckets,
                state_argnums=(0,))
        self._decode = self._program(
            self._decode_body, "serve.decode", self.num_decode_blocks,
            state_argnums=(0, 1, 2, 3))
        #: each program family's analytic cost, worked out once in the
        #: engine's life (``_analyze``, ``_analyze_block``)
        self._costs: dict[str, ProgramCost] = {}
        #: ladder sizes whose decode program exists: a size's first call
        #: runs eagerly before its capture, so a capture failure leaves
        #: the pool's positions and live mask advanced
        self._decode_sizes: set[int] = set()

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
        cache = init_cache(self._model, variables, 1, ids.shape[1])
        return self._resume_body(variables, ids, cache, 0, last)

    def _resume_body(self, variables, ids, cache, pos, last):
        """``ids`` at absolute position ``pos`` (0 for a prefill, a 0-d
        device tensor for the prefix-cache remainder and a chunk) against
        the linear ``cache``, written in place and returned."""
        with self._weights(variables) as weights:
            logits, cache = _cached_apply(self._model, weights, ids, cache,
                                          pos)
        return greedy_next(_row(logits, last),
                           self._model.extra.get("vocab_split")), cache

    def _decode_body(self, variables, buffers, positions, live, tok, rem,
                     eos, t):
        """One fused decode block of ``t`` micro-steps. The pool's
        buffers are written in place, and its per-slot positions and live
        mask advance in place from the block's outputs (the JAX engine
        donates them); returns the (S, t) tokens — under a mesh every
        data rank's, with the live flags as a last column."""
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
        capped at ``cache_len``; a MoE engine's is the exact length."""
        if not self._bucketed:
            return prompt_len
        bucket = 8
        while bucket < prompt_len:
            bucket *= 2
        return min(bucket, self.cache_len)

    def chunk_bucket(self, n: int) -> int:
        """Padded width the chunk program runs at for a chunk of ``n``
        real tokens: the next power of two >= max(n, 8), capped at
        ``prefill_chunk``. Intermediate chunks are exactly
        ``prefill_chunk`` wide; only a fill's FINAL chunk can land on a
        smaller rung."""
        bucket = 8
        while bucket < n:
            bucket *= 2
        return min(bucket, self._prefill_chunk)

    @property
    def num_chunk_buckets(self) -> int:
        """How many distinct chunk programs CAN exist — one per ladder
        width in {8, 16, ..., prefill_chunk}; 0 with chunking off."""
        if self._prefill_chunk is None:
            return 0
        return self._prefill_chunk.bit_length() - 3

    @property
    def num_prefill_buckets(self) -> int:
        """How many distinct prefill shapes CAN run on this engine. With
        chunked prefill the monolithic program never runs and the ceiling
        is the chunk ladder's."""
        if self._prefill_chunk is not None:
            return self.num_chunk_buckets
        return len({
            self.prefill_bucket(p) for p in range(1, self.cache_len)
        })

    # -- decode-block ladder ----------------------------------------------

    def _block_size(self, min_rem: int) -> int:
        """This tick's block length: the largest ladder power of two
        <= min(block cap, minimum remaining budget over active slots).
        The cap is ``decode_block``, or lower under memory-pressure
        degradation — still on the ladder, so no new programs."""
        cap = min(self._block_cap, max(1, min_rem))
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
        arrive. With chunked prefill every fill runs through the chunk
        programs, so the count (and its ``num_chunk_buckets`` ceiling) is
        theirs."""
        if self._chunk is not None:
            return program_count(self._chunk)
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
            self._prefill_program, self._resume, self._chunk, self._decode)
            if w is not None)

    def graph_pool_bytes(self) -> int:
        """Device bytes the programs' shared graph pool holds reserved."""
        return self._graph_pool.reserved_bytes()

    # -- fault handling ----------------------------------------------------

    @property
    def degraded(self) -> bool:
        """True while memory-pressure degradation holds the engine below
        full service (a reduced block-ladder ceiling or admission cap);
        the recovery probe clears it."""
        return (
            self._block_cap < self.decode_block
            or self._admit_cap < self.pool.num_slots
        )

    def _backoff(self, attempts: int) -> None:
        """Capped DETERMINISTIC backoff before a retry: linear in the
        attempt number, no jitter."""
        self.metrics.record_retry()
        self.recorder.record("retry", tick=self.tick, attempt=attempts)
        if self._retry_backoff_s > 0:
            time.sleep(self._retry_backoff_s * attempts)

    def _absorb(self, err: Exception, attempts: int, tick: int,
                site: str) -> bool:
        """The retry policy for one failed call at ``site``: resource
        exhaustion degrades (:meth:`_note_oom`), a transient error passes,
        anything else re-raises. Returns True after backing off when
        attempt ``attempts`` may be followed by another, False when the
        retries are spent."""
        if is_resource_exhausted(err):
            self._note_oom(tick, site)
        elif not is_transient(err):
            raise err
        if attempts > self._retry_limit:
            return False
        self._backoff(attempts)
        return True

    def _note_oom(self, tick: int, site: str) -> None:
        """Graceful degradation on resource exhaustion: step DOWN the
        existing power-of-two decode-block ladder (never a new program)
        and tighten the admission cap; at the ladder floor, preempt the
        youngest active request — its emitted tokens fold into a resume
        prefix and it re-queues, so memory pressure costs latency, not
        data. A recovery probe re-escalates after
        ``degrade_recover_ticks`` clean blocks."""
        if self._block_cap > 1:
            self._block_cap //= 2
        elif len(self._sched.active) > 1:
            slot = next(reversed(self._sched.active))
            req = self._sched.preempt(slot)
            self._sched.requeue(req)
            self.metrics.record_preemption()
            self._span_event(req.id, "preempted", tick=tick, slot=slot,
                             prefix_len=len(req.prefix))
            self.recorder.record("preempted", tick=tick, id=req.id,
                                 slot=slot, prefix_len=len(req.prefix))
        self._admit_cap = max(1, self._admit_cap - 1)
        self._ok_ticks = 0
        self.metrics.set_degraded(True)
        self.recorder.record("degraded", tick=tick, site=site,
                             block_cap=self._block_cap,
                             admit_cap=self._admit_cap)

    def _note_clean_dispatch(self, tick: int) -> None:
        """Recovery probe: after ``degrade_recover_ticks`` consecutive
        clean decode blocks, re-escalate one notch (block ladder up one
        power of two, admission cap up one slot)."""
        if not self.degraded:
            return
        self._ok_ticks += 1
        if self._ok_ticks < self._degrade_recover_ticks:
            return
        self._ok_ticks = 0
        self._block_cap = min(self.decode_block, self._block_cap * 2)
        self._admit_cap = min(self.pool.num_slots, self._admit_cap + 1)
        self.metrics.set_degraded(self.degraded)
        self.recorder.record(
            "recovered" if not self.degraded else "re_escalated",
            tick=tick, block_cap=self._block_cap,
            admit_cap=self._admit_cap,
        )

    def _token_ok(self, token: int) -> bool:
        """Greedy tokens are argmax indices, so non-negative and < vocab;
        anything else is corruption (an injected poison, for one)."""
        if token < 0:
            return False
        return self._vocab is None or token < int(self._vocab)

    def _quarantine_slot(self, slot: int, tick: int,
                         reason: str) -> RequestResult:
        """Retire one ACTIVE request as ``"failed"``: the slot frees (live
        mask dead, position 0) and the engine keeps serving everyone
        else."""
        res = self._sched.fail(slot, tick)
        self.metrics.record_quarantine()
        self._span_event(res.id, "quarantined", tick=tick, slot=slot,
                         reason=reason)
        self.recorder.record("quarantine", tick=tick, id=res.id, slot=slot,
                             reason=reason)
        return res

    def _quarantine_unactivated(self, req, slot: int, tick: int,
                                reason: str) -> RequestResult:
        """Retire a request whose prefill never succeeded (its lease still
        held by the admit loop or its fill) as ``"failed"``."""
        self.pool.free(slot)
        res = self._sched.fail_unactivated(req, tick)
        self.metrics.record_quarantine()
        self._span_event(req.id, "quarantined", tick=tick, slot=slot,
                         reason=reason)
        self.recorder.record("quarantine", tick=tick, id=req.id, slot=slot,
                             reason=reason)
        return res

    def _fire(self, site: str, tick: int, request: int | None = None):
        """The fault hook before a guarded call. Under a mesh of several
        ranks the outcome is agreed first: a firing on any rank raises
        the same kind of error on every rank, so all of them retry,
        degrade or die together and their collectives keep pairing."""
        err = None
        if self._faults is not None:
            try:
                self._faults.fire(site, tick=tick, request=request,
                                  replica=self._replica)
            except Exception as e:  # noqa: BLE001 — agreed, then raised
                err = e
        if self._place is not None and self._place.control is not None:
            err = self._place.agree_error(err, site)
        if err is not None:
            raise err

    def _call(self, site: str, fn, *args):
        """``fn(*args)``, a guarded call; under a mesh of several ranks
        its outcome is agreed after it (``MeshPlace.agree_after``): a
        failure on some ranks only stops every rank with ``MeshDesync``,
        since the others ran its collectives."""
        place = self._place
        if place is None or place.control is None:
            return fn(*args)
        try:
            out = fn(*args)
        except Exception as e:
            place.agree_after(e, site)
            raise
        place.agree_after(None, site)
        return out

    # -- spans and analytics -------------------------------------------------

    def _open_span(self, req, event: str, **attrs) -> None:
        """Open request ``req``'s lifecycle span with its first event."""
        span = self._tracer.span(
            "request", tick=self.tick, id=req.id, trace=req.trace_id,
            prompt_len=int(req.prompt.size),
            max_new_tokens=req.max_new_tokens,
        )
        span.event(event, tick=self.tick, **attrs)
        self._spans[req.id] = span

    def _span_event(self, rid: int, name: str, **attrs) -> None:
        span = self._spans.get(rid)
        if span is not None:
            span.event(name, **attrs)

    def _end_span(self, rid: int, status: str, **attrs) -> None:
        span = self._spans.pop(rid, None)
        if span is not None:
            span.end(status, **attrs)

    def _analyze(self, family: str, body, *args) -> None:
        """Register ``family``'s cost with the metrics before its first
        dispatch. The cost is worked out once in the engine's life —
        ``body`` runs on meta copies of ``args``: no device work, no
        sync, no program made or counted — and kept, so metrics made
        afresh take it without a second run."""
        perf = self.metrics.perf
        if perf.wants_program(family):
            cost = self._costs.get(family)
            if cost is None:
                cost = self._costs[family] = self._whole(
                    analyze_program_cost(body, *args))
            perf.register_program(family, cost)

    def _analyze_block(self, t_block: int, *args) -> str:
        """Register the cost of the decode block of ``t_block``
        micro-steps; returns its family. A block is ``t_block`` copies of
        one micro-step plus the stacking of their tokens, so its cost is
        affine in the block size: the body runs on meta tensors at 1 and
        2 steps, once per engine, and the line is extended to every
        ladder size."""
        family = f"decode[T={t_block}]"
        if not self.metrics.perf.wants_program(family):
            return family
        if family not in self._costs:
            one, two = (self._costs.get(f"decode[T={t}]") for t in (1, 2))
            if one is None or two is None:
                one, two = (self._whole(analyze_program_cost(
                    self._decode_body, *args, t)) for t in (1, 2))
            if one.flops is None or two.flops is None:
                cost = ProgramCost.unavailable()
            else:
                cost = ProgramCost(
                    one.flops + (t_block - 1) * (two.flops - one.flops),
                    one.bytes_accessed + (t_block - 1)
                    * (two.bytes_accessed - one.bytes_accessed),
                    one.source)
            self._costs.update({"decode[T=1]": one, "decode[T=2]": two,
                                family: cost})
        self.metrics.perf.register_program(family, self._costs[family])
        return family

    def _whole(self, cost: ProgramCost) -> ProgramCost:
        """A program's cost as the meta run counts it — this rank's shard
        of the work — over every device of the mesh."""
        if self._place is None:
            return cost
        return cost.over_devices(self._place.devices)

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
               deadline_ticks: int | None = None,
               trace_id: str | None = None) -> int:
        """Queue one request; returns its id. Raises
        :class:`FriendlyError` on invalid budgets or a full queue.
        ``deadline_ticks``: the request must FINISH within that many
        ticks of submission or it expires (status ``"expired"``).
        ``trace_id``: the request's trace-context id (default
        ``t{id}``), carried through snapshots."""
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
            trace_id=trace_id or f"t{self._next_id}",
        )
        try:
            self._sched.enqueue(req)
        except FriendlyError:
            self.metrics.record_reject()
            self.recorder.record("rejected", tick=self.tick,
                                 prompt_len=int(prompt.size),
                                 reason="queue_full")
            raise
        self._next_id += 1
        self.metrics.record_submit()
        self._open_span(req, "queued", queue_depth=self.queue_depth)
        return req.id

    def step(self) -> list[RequestResult]:
        """One scheduler tick: expire deadlines, admit queued requests
        into free slots (one prefill per joiner, or the start of a
        chunked fill), advance every open fill by one chunk, ONE fused
        decode block for all active slots, retire finished sequences.
        Returns the requests that reached a terminal state this tick.

        An :class:`EngineKilled` escaping the tick first PARKS every held
        slot (a paged pool's mappings release), and the dead engine then
        refuses further steps."""
        if self._dead:
            raise FriendlyError(
                "this engine was killed (EngineKilled) and its device "
                "resources parked; rebuild it with "
                "ServeEngine.restore(snapshot, ...) instead of "
                "stepping it again"
            )
        try:
            return self._step_inner()
        except EngineKilled:
            self._park_after_kill()
            raise

    def _step_inner(self) -> list[RequestResult]:
        t0 = time.perf_counter()
        tick = self._sched.tick_count
        finished = self._sched.expire(tick)
        tokens_this_tick = 0
        # SLO load shedding: while the budget burns, NEW admissions wait
        # (in-flight requests keep decoding, so the overload drains); an
        # idle engine admits regardless, or it could never observe the
        # recovery
        shedding = (
            self._slo is not None and self._slo.should_shed
            and self.pool.leased_count > 0
        )
        if self._slo is not None and self._place is not None:
            # the monitor reads this rank's clock: every rank sheds if any
            # does, so the admissions stay the same everywhere
            shedding = bool(self._place.agree_max([shedding])[0])
        if shedding and self._sched.queue_depth:
            self.metrics.record_slo_shed()
            self.recorder.record("slo_shed", tick=tick,
                                 queue_depth=self._sched.queue_depth)
        with annotate("serve.admit"):
            while (
                not shedding
                and self._sched.queue_depth
                and self.pool.free_count
                # memory-pressure degradation admits fewer concurrent
                # requests than the pool has slots
                and self.pool.leased_count < self._admit_cap
            ):
                req = self._sched.pop_next()
                slot = self.pool.lease()
                self._span_event(req.id, "admitted", tick=tick, slot=slot)
                # preempted and restored requests re-prefill prompt + the
                # tokens already emitted: greedy determinism makes the
                # resumed stream equal to an uninterrupted one
                seq = _sequence(req)
                payload = self._handoffs.pop(req.id, None)
                attempts = 0
                if payload is not None:
                    # another replica's prefill output for this exact
                    # sequence, written straight into the slot
                    first, attempts = self._adopt_payload(req, slot, seq,
                                                          payload, tick)
                    if first is not None:
                        if self._first_token(req, slot, first, None, tick,
                                             finished,
                                             site="serve.handoff"):
                            tokens_this_tick += 1
                        continue
                if self._chunk is not None:
                    # admission only STARTS the fill; _advance_fills runs
                    # every chunk
                    self._start_fill(req, slot, seq, tick)
                    continue
                first, bucket, cache = self._prefill(slot, seq, req.id,
                                                     tick, attempts)
                if first is None:
                    finished.append(self._quarantine_unactivated(
                        req, slot, tick, "prefill_failed"))
                    continue
                if self._first_token(req, slot, first, bucket, tick,
                                     finished, kv=cache):
                    tokens_this_tick += 1
        if self._sched.filling:
            tokens_this_tick += self._advance_fills(tick, finished)
        # slot occupancy AS OF the decode block: a request can join and
        # retire inside one tick
        leased_this_tick = self.pool.leased_count
        if self._async_host:
            tokens_this_tick += self._decode_phase_async(tick, finished)
        elif self._sched.active:
            tokens_this_tick += self._decode_phase(tick, finished)
        self._sched.tick_count += 1
        tick_s = time.perf_counter() - t0
        self.metrics.sample_tick(
            self._sched.queue_depth, leased_this_tick, tick_s,
            tokens_emitted=tokens_this_tick,
        )
        self.recorder.record("tick", tick=tick, ms=round(tick_s * 1e3, 3),
                             tokens=tokens_this_tick)
        for res in finished:
            self.metrics.record_finish(res)
            # a request retired before admission (a deadline) abandons
            # its pending hand-off payload
            self._handoffs.pop(res.id, None)
            self._end_span(res.id, res.status, tick=res.finish_tick,
                           generated=res.generated)
        # once a tick, after the finish feed: the next tick's admission
        # sees the freshest shed signal
        if self._slo is not None:
            self._slo.evaluate(tick=tick)
        if (
            self._snapshot_every is not None
            and self._sched.tick_count % self._snapshot_every == 0
        ):
            self.checkpoint()
        return finished

    def _first_token(self, req, slot: int, first: int, bucket: int | None,
                     tick: int, finished: list, *,
                     site: str = "serve.prefill", kv=None) -> bool:
        """Admit a prefilled (or adopted: ``bucket`` None, ``site``
        ``serve.handoff``) request with its first token: the poison
        check, then activation — or, on a prefill-role engine, the
        hand-off of ``kv`` (the program's output cache, valid over the
        request's sequence). Returns whether the token was emitted
        (False: quarantined)."""
        if self._faults is not None:
            poison = self._faults.poison_value(site, tick=tick,
                                               request=req.id,
                                               replica=self._replica)
            if poison is not None:
                first = int(poison)
        if not self._token_ok(first):
            # a corrupted first token never enters results or seeds the
            # decode frontier
            finished.append(self._quarantine_unactivated(
                req, slot, tick, "poisoned_token"))
            return False
        self.metrics.record_first_token(req, tick, bucket)
        if self.role == "prefill" and kv is not None and not (
            len(req.prefix) + 1 >= req.max_new_tokens
            or (req.eos_id is not None and first == req.eos_id)
        ):
            # a request the first token already finishes completes here
            self._hand_off(req, slot, first, kv,
                           len(req.prompt) + len(req.prefix), tick)
            finished.append(self._sched.handoff_result(req, first, tick))
            return True
        done = self._sched.activate(slot, req, first, tick)
        if done is not None:
            finished.append(done)
        return True

    def _hand_off(self, req, slot: int, first: int, kv: dict, length: int,
                  tick: int) -> None:
        """A prefill-role terminal: the slot frees (a prefix cache's entry
        keeps its pages) and the payload enters the outbox — K/V rows
        ``[0, length)`` CLONED from ``kv``, a program's static output
        that the engine's next replay overwrites, then stamped with the
        payload checksum (its one host copy)."""
        self.pool.free(slot)
        payload = {
            "id": req.id,
            "prompt": np.asarray(req.prompt, np.int32),
            "prefix": np.asarray(req.prefix, np.int32),
            "length": length,
            "first_token": int(first),
            "kv": {name: tuple(t[:, :length].clone() for t in leaves)
                   for name, leaves in kv.items()},
            "max_new_tokens": req.max_new_tokens,
            "eos_id": req.eos_id,
            # the trace context rides the hand-off: the decode replica's
            # span carries the same id
            "trace_id": req.trace_id,
        }
        payload["checksum"] = integrity.payload_checksum(payload)
        self._outbox.append(payload)
        self.recorder.record("handoff_out", tick=tick, id=req.id,
                             seq_len=length, trace=req.trace_id)

    def _adopt_payload(self, req, slot: int, seq: np.ndarray, payload: dict,
                       tick: int) -> tuple[int | None, int]:
        """Land a hand-off payload in ``slot``: re-verify its checksum,
        then write its K/V straight into the slot (no program runs)
        through the ``serve.handoff`` fault site, behind the retry
        policy. Returns (the first token, or None when the payload is
        corrupt or could not land — the caller then prefills locally;
        the attempts spent, which carry over into that prefill's
        budget)."""
        attempts = 0
        with annotate("serve.handoff"):
            if self._faults is not None:
                # the silent-corruption drill: a seeded bit-flip in one KV
                # leaf between production and adoption
                cseed = self._faults.corrupt_spec(
                    "serve.handoff", tick=tick, request=req.id,
                    replica=self._replica)
                if cseed is not None:
                    payload = integrity.corrupt_payload(payload, cseed)
            ok, expected, actual = integrity.verify_payload(payload)
            if not ok:
                self.metrics.record_integrity_handoff_failure()
                self.recorder.record("integrity.handoff_checksum",
                                     tick=tick, id=req.id,
                                     expected=expected, actual=actual)
                self.metrics.record_handoff_fallback()
                self.recorder.record("handoff_fallback", tick=tick,
                                     id=req.id)
                return None, attempts
            p = len(seq)
            tp = time.perf_counter()
            while True:
                try:
                    self._fire("serve.handoff", tick, req.id)
                    self.pool.write_prefill(slot, payload["kv"], p)
                    if self._prefix_cache:
                        self.pool.prefix_insert(slot, seq)
                    break
                except Exception as e:
                    attempts += 1
                    if not self._absorb(e, attempts, tick,
                                        "serve.handoff"):
                        self.metrics.record_handoff_fallback()
                        self.recorder.record("handoff_fallback", tick=tick,
                                             id=req.id)
                        return None, attempts
        ms = round((time.perf_counter() - tp) * 1e3, 3)
        self.metrics.record_handoff_adopt()
        self._span_event(req.id, "handoff_adopted", tick=tick, seq_len=p,
                         ms=ms)
        self.recorder.record("handoff_adopted", tick=tick, id=req.id,
                             seq_len=p, ms=ms)
        return int(payload["first_token"]), attempts

    def _prefill(self, slot: int, seq: np.ndarray, rid: int, tick: int,
                 attempts: int = 0) -> tuple[int | None, int, dict | None]:
        """Prefill ``seq`` into ``slot`` behind the retry policy
        (``attempts`` already spent count against it); returns (the first
        greedy token — a host sync — or None when the retries are spent;
        the bucket the forward ran at; the program's output cache, valid
        over ``[0, len(seq))`` until the engine's next replay). A
        prefix-cache hit runs only the remainder, over the cached
        prefix's gathered K/V; a miss (or an entry evicted since the
        lookup) runs the whole sequence on a batch-1 linear cache of one
        bucket. The dispatch interval, ending at the existing sync, is
        attributed to the program's family."""
        p = len(seq)
        hit = (self.pool.prefix_lookup(seq, self.prefill_bucket, slot)
               if self._prefix_cache else None)
        with annotate("serve.prefill"):
            if hit is not None:
                entry, keep = hit
                r = p - keep
                bucket = self.prefill_bucket(r)
                ids = self._padded(seq[keep:], bucket)
                # the prefix's K/V gathered back into a linear cache:
                # retries reuse it (a repeated write lands the same
                # values)
                lin = self.pool.gather_prefix(entry, keep)
                family = f"resume[{bucket}]"
                self._analyze(family, self._resume_body, self.variables,
                              ids, lin, self._scalar(keep),
                              self._scalar(r - 1))
                tp = time.perf_counter()
                while True:
                    try:
                        self._fire("serve.prefill", tick, rid)
                        tok, cache = self._call(
                            "serve.prefill", self._resume, self.variables,
                            ids, lin, self._scalar(keep),
                            self._scalar(r - 1))
                        # map the shared pages FIRST (the slot's
                        # references keep them alive through any eviction
                        # the remainder write triggers), then scatter only
                        # [keep, p)
                        if not self.pool.map_prefix(slot, entry, keep):
                            # evicted since the lookup: its pages may be
                            # free or reallocated — fall back to the full
                            # prefill
                            hit = None
                            break
                        self.pool.write_prefill(slot, cache, p, start=keep)
                        first = int(tok)
                        self._prefilled(rid, family, tp, tick, bucket, keep)
                        return first, bucket, cache
                    except Exception as e:
                        attempts += 1
                        if not self._absorb(e, attempts, tick,
                                            "serve.prefill"):
                            return None, bucket, None
            bucket = self.prefill_bucket(p)
            ids = self._padded(seq, bucket)
            family = f"prefill[{bucket}]"
            self._analyze(family, self._prefill_body, self.variables, ids,
                          self._scalar(p - 1))
            tp = time.perf_counter()
            while True:
                try:
                    self._fire("serve.prefill", tick, rid)
                    tok, cache = self._call(
                        "serve.prefill", self._prefill_program,
                        self.variables, ids, self._scalar(p - 1))
                    # only the REAL prompt's K/V enter the slot; the pad
                    # tail of the bucket cache is dropped (the program's
                    # outputs are consumed before any other program
                    # replays)
                    self.pool.write_prefill(slot, cache, p)
                    if self._prefix_cache:
                        self.pool.prefix_insert(slot, seq)
                    first = int(tok)
                    self._prefilled(rid, family, tp, tick, bucket, 0)
                    return first, bucket, cache
                except Exception as e:
                    attempts += 1
                    if not self._absorb(e, attempts, tick,
                                        "serve.prefill"):
                        return None, bucket, None

    def _prefilled(self, rid: int, family: str, tp: float, tick: int,
                   bucket: int, reused: int) -> None:
        """Account one prefill whose first token is in hand: the dispatch
        interval since ``tp`` (ending at the prefill's own sync) goes to
        ``family``."""
        prefill_s = time.perf_counter() - tp
        ms = round(prefill_s * 1e3, 3)
        self._span_event(rid, "prefill", tick=tick, bucket=bucket, ms=ms,
                         reused=reused)
        self.metrics.perf.record_dispatch(family, prefill_s, tokens=1)
        self.recorder.record("dispatch", tick=tick, family=family, ms=ms,
                             tokens=1)

    def _padded(self, tokens: np.ndarray, bucket: int):
        """``tokens`` right-padded to (1, ``bucket``) on the device."""
        padded = np.full((1, bucket), self.pad_id, np.int32)
        padded[0, :len(tokens)] = tokens
        return host_to_device(padded, self.device)

    def _rows(self, a):
        """This rank's slot rows of a per-slot vector (all of them
        without a mesh)."""
        if self._place is None:
            return a
        base = self.pool.slot_base
        return a[base:base + self.pool.local_slots]

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
            weights = dequantize_weights(variables)
            if self._split is not None:
                weights = local_variables(self.graph, weights, self._split)
            yield weights
        finally:
            self._model.unbind()

    # -- chunked prefill -----------------------------------------------------

    def _fresh_carry(self) -> dict:
        """A zeroed batch-1 linear cache spanning the FULL cache_len: a
        fill's carry, which every chunk program reads and extends. Its
        fixed shape keys the chunk programs by width alone; it lives
        outside the graph pool, so it survives every replay."""
        return init_cache(self._model, self.variables, 1, self.cache_len)

    def _start_fill(self, req, slot: int, seq, tick: int) -> None:
        """Begin a chunked fill in a freshly leased slot: probe the prefix
        cache (a hit seeds the carry with the shared prefix, gathered
        once) and register the fill with the scheduler. No forward runs
        here."""
        keep, entry = 0, None
        hit = (self.pool.prefix_lookup(seq, self.chunk_bucket, slot)
               if self._prefix_cache else None)
        if hit is not None:
            entry, keep = hit
            carry = self.pool.gather_prefix(entry, keep)
        else:
            carry = self._fresh_carry()
        self._sched.start_fill(slot, req, len(seq), keep,
                               {"cache": carry, "entry": entry}, tick)
        self._span_event(req.id, "fill_started", tick=tick, total=len(seq),
                         reused=keep)

    def _chunk_call(self, fs, ids, start: int, last: int):
        """One chunk program over the fill's carry. The program's carry
        is a static input (the fill's tensor is copied in) written in
        place; the result is copied back into the fill's own tensor
        before any other program replays. Returns (token, cache)."""
        tok, cache = self._call("serve.prefill", self._chunk,
                                self.variables, ids, fs.carry["cache"],
                                self._scalar(start), self._scalar(last))
        for name, leaves in cache.items():
            for dst, src in zip(fs.carry["cache"][name], leaves):
                if dst is not src:
                    dst.copy_(src)
        return tok, cache

    def _advance_fills(self, tick: int, finished: list) -> int:
        """Advance every open fill by ONE chunk program. Intermediate
        chunks are exactly ``prefill_chunk`` wide and sync nothing; a
        fill's FINAL chunk pads to its ladder bucket, lands the carry in
        the slot with ``write_prefill(start=keep)`` and pays the fill's
        one host sync, for the first token. The chunks recompute the
        monolithic prefill's K/V at the same positions from the same
        tokens, and the final logits row is the true last position.
        Returns the first tokens emitted by fills completed this tick."""
        tokens = 0
        for slot in sorted(self._sched.filling):
            fs = self._sched.filling[slot]
            req = fs.req
            seq = _sequence(req)
            r = fs.total - fs.filled
            final = r <= self._prefill_chunk
            if final:
                bucket = self.chunk_bucket(r)
                # the window trick: the padded window must not overflow
                # cache_len, so its start slides down and the overlap
                # [start, filled) is recomputed to the same values
                start = min(fs.filled, self.cache_len - bucket)
                padded = np.full((bucket,), self.pad_id, np.int32)
                padded[:fs.total - start] = seq[start:fs.total]
                last = (fs.total - 1) - start
            else:
                bucket = self._prefill_chunk
                start = fs.filled
                padded = seq[start:start + bucket]
                last = bucket - 1
            ids = self._padded(padded, bucket)
            family = f"chunk[{bucket}]"
            self._analyze(family, self._resume_body, self.variables, ids,
                          fs.carry["cache"], self._scalar(start),
                          self._scalar(last))
            attempts = 0
            tp = time.perf_counter()
            if not final:
                ok = False
                with annotate("serve.prefill"):
                    while True:
                        try:
                            self._fire("serve.prefill", tick, req.id)
                            self._chunk_call(fs, ids, start, last)
                            ok = True
                            break
                        except Exception as e:
                            attempts += 1
                            if not self._absorb(e, attempts, tick,
                                                "serve.prefill"):
                                break
                if not ok:
                    self._sched.fill_done(slot)
                    finished.append(self._quarantine_unactivated(
                        req, slot, tick, "prefill_failed"))
                    continue
                fs.filled += bucket
                chunk_s = time.perf_counter() - tp
                self.metrics.record_prefill_chunk()
                # no host sync here: the interval is enqueue-side only;
                # the device time rides the final chunk's sync
                self.metrics.perf.record_dispatch(family, chunk_s)
                self.recorder.record("prefill_chunk", tick=tick, id=req.id,
                                     filled=fs.filled, total=fs.total,
                                     ms=round(chunk_s * 1e3, 3))
                self._span_event(req.id, "prefill_chunk", tick=tick,
                                 filled=fs.filled, total=fs.total)
                continue

            # -- the final chunk: compute, land in the slot, sync ----------
            entry = fs.carry["entry"]
            first, stale = None, False
            with annotate("serve.prefill"):
                while True:
                    try:
                        self._fire("serve.prefill", tick, req.id)
                        tok, cache = self._chunk_call(fs, ids, start, last)
                        # map the shared prefix pages FIRST, then scatter
                        # only [keep, total)
                        if entry is not None and not self.pool.map_prefix(
                                slot, entry, fs.keep):
                            stale = True
                            break
                        self.pool.write_prefill(slot, cache, fs.total,
                                                start=fs.keep)
                        first = int(tok)
                        break
                    except Exception as e:
                        attempts += 1
                        if not self._absorb(e, attempts, tick,
                                            "serve.prefill"):
                            break
            if stale:
                # the prefix entry was evicted since the fill started: the
                # fill restarts from scratch (the stream is unchanged)
                fs.filled = fs.keep = 0
                fs.carry = {"cache": self._fresh_carry(), "entry": None}
                continue
            self._sched.fill_done(slot)
            if first is None:
                finished.append(self._quarantine_unactivated(
                    req, slot, tick, "prefill_failed"))
                continue
            fs.filled = fs.total
            self.metrics.record_prefill_chunk()
            if self._prefix_cache and entry is None:
                self.pool.prefix_insert(slot, seq)
            self._prefilled(req.id, family, tp, tick, bucket, fs.keep)
            # a prefill-role hand-off fires at fill completion: the
            # carry's rows [0, total) are the monolithic prefill's output
            if self._first_token(req, slot, first, bucket, tick, finished,
                                 kv=fs.carry["cache"]):
                tokens += 1
        return tokens

    # -- the decode block: dispatch and fetch --------------------------------

    def _decode_phase(self, tick: int, finished: list) -> int:
        """One fused decode BLOCK for all active slots, dispatched and
        then fetched at once (the synchronous loop), behind the
        resilience layer: a dispatch that stays impossible through the
        retries and the degradation quarantines the remaining batch.
        Appends terminal results to ``finished``; returns the real tokens
        consumed."""
        status = self._dispatch_block(tick, None)
        inflight, self._inflight = self._inflight, None
        n_tokens = self._fetch_inflight(inflight, tick, finished)
        if status == "failed":
            for slot in list(self._sched.active):
                finished.append(self._quarantine_slot(
                    slot, tick, "decode_failed"))
        return n_tokens

    def _decode_phase_async(self, tick: int, finished: list) -> int:
        """One PIPELINED decode round: dispatch this tick's block N+1
        behind the in-flight block N, then fetch N's tokens — the host's
        bookkeeping between the two (and the admit and fill phase before
        them) overlaps N's device time. At most one host sync a block,
        as in the synchronous loop, landing one tick late."""
        prev = self._inflight
        self._inflight = None
        status = self._dispatch_block(tick, prev)
        n_tokens = self._fetch_inflight(prev, tick, finished)
        if status == "failed":
            # quarantine what is left of the batch AFTER the previous
            # block's tokens were committed above
            for slot in list(self._sched.active):
                finished.append(self._quarantine_slot(
                    slot, tick, "decode_failed"))
        if self._inflight is not None and not self._sched.busy:
            # every request retired at the fetch above while a block is
            # still in flight: drain it now (all its rows fail the
            # identity fence), so run() never exits with an open
            # deferred-free window
            inf, self._inflight = self._inflight, None
            n_tokens += self._fetch_inflight(inf, tick, finished)
        return n_tokens

    def _dispatch_block(self, tick: int, prev: dict | None) -> str:
        """Dispatch one fused decode block WITHOUT fetching it; returns
        ``"ok"`` (the in-flight record stored), ``"idle"`` (no active
        slot, or every active slot's budget may exhaust inside ``prev``)
        or ``"failed"`` (retries spent).

        With ``prev`` in flight, input by input: a slot riding ``prev``
        takes ``prev``'s last emitted token, selected ON THE DEVICE; its
        budget is reduced by ``prev``'s block size (the block-size clamp
        reads only positive budgets, so no surviving stream overruns its
        budget mid-block); its page frontier advances by the same, so
        ``ensure_decode_pages`` covers what ``prev`` may still write."""
        attempts = 0
        while self._sched.active:
            states = dict(self._sched.active)
            lag = {}
            if prev is not None:
                for slot, st in prev["states"].items():
                    if states.get(slot) is st:
                        lag[slot] = prev["t_block"]
            pre_pos = {slot: st.pos + lag.get(slot, 0)
                       for slot, st in states.items()}
            tok, rem, eos, _ = self._sched.decode_block_inputs(self.pad_id)
            rems = []
            for slot, st in states.items():
                adj = (st.req.max_new_tokens - len(st.out)
                       - lag.get(slot, 0))
                rem[slot] = adj
                if adj > 0:
                    rems.append(adj)
            if not rems:
                return "idle"
            t_block = self._block_size(min(rems))
            tok_d, rem_d, eos_d = (host_to_device(self._rows(a), self.device)
                                   for a in (tok, rem, eos))
            if lag:
                sel = np.zeros((self.pool.num_slots,), bool)
                sel[list(lag)] = True
                tok_d = torch.where(host_to_device(self._rows(sel),
                                                   self.device),
                                    prev["last"], tok_d)
            pool = self.pool
            family = self._analyze_block(t_block, self.variables,
                                         pool.buffers, pool.positions,
                                         pool.live, tok_d, rem_d, eos_d)
            try:
                with annotate("serve.decode"):
                    issued = time.perf_counter()
                    if self._paged:
                        # pre-map every page this block can write; page
                        # exhaustion walks the degradation ladder like an
                        # allocator OOM
                        self.pool.ensure_decode_pages(pre_pos, t_block)
                    # the hook fires BEFORE the call: an injected failure
                    # never touches the pool
                    self._fire("serve.decode", tick)
                    staged = self._call("serve.decode", self._decode_call,
                                        t_block, tok_d, rem_d, eos_d)
            except Exception as e:
                attempts += 1
                if not self._absorb(e, attempts, tick, "serve.decode"):
                    return "failed"
                continue
            self._dispatch_gen += 1
            self.pool.defer_frees(self._dispatch_gen)
            self._inflight = dict(
                staged, states=states, pre_pos=pre_pos,
                t_block=t_block, family=family, issued=issued,
                gen=self._dispatch_gen, n_active=len(states),
                overlapped=prev is not None)
            if prev is not None:
                self.metrics.record_overlapped_dispatch()
            return "ok"
        return "idle"

    def _decode_call(self, t_block: int, tok_d, rem_d, eos_d) -> dict:
        """Run the decode program of size ``t_block`` and return its staged
        outputs: the tokens and the live vector copied into host buffers
        (pinned, non-blocking, on the card), the last tokens copied on the
        device, and an event recorded after them — all enqueued before
        anything else, since later replays overwrite the program's static
        outputs and rewrite ``pool.live``. A call of a size without a
        program runs eagerly before its capture; should the capture fail,
        the positions and live mask its eager run advanced are
        restored."""
        pool = self.pool
        saved = None
        if t_block not in self._decode_sizes:
            saved = (pool.positions.clone(), pool.live.clone())
        try:
            toks = self._decode(self.variables, pool.buffers, pool.positions,
                                pool.live, tok_d, rem_d, eos_d, t_block)
        except Exception:
            if saved is not None:
                pool.positions.copy_(saved[0])
                pool.live.copy_(saved[1])
            raise
        self._decode_sizes.add(t_block)
        on_card = self.device.type == "cuda"
        if self._place is not None:
            # every data rank's rows, the live flags as a last column
            toks, live = toks[:, :-1], toks[:, -1]
            last = self._rows(toks[:, -1]).clone()
        else:
            live = pool.live
            last = toks[:, -1].clone()
        toks_h = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=on_card)
        live_h = torch.empty(live.shape, dtype=live.dtype,
                             pin_memory=on_card)
        toks_h.copy_(toks, non_blocking=on_card)
        live_h.copy_(live, non_blocking=on_card)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        return {"toks_h": toks_h, "live_h": live_h, "last": last,
                "event": event}

    def _fetch(self, inflight: dict) -> tuple[np.ndarray, np.ndarray]:
        """The block's ONE host sync: wait for its staging event (never
        for a block dispatched after it) and read the (S, T) tokens and
        the live vector."""
        if inflight["event"] is not None:
            inflight["event"].synchronize()
        return (inflight["toks_h"].numpy().copy(),
                inflight["live_h"].numpy().copy())

    def _fetch_inflight(self, inflight: dict | None, tick: int,
                        finished: list) -> int:
        """Fetch and consume one dispatched block: the host sync (behind
        its own retry loop — the block ran, so re-dispatching would skip
        its tokens), the poison check, the identity fence, the metrics,
        and the flush of the deferred frees stamped up to the block's
        generation."""
        if inflight is None:
            if self._inflight is None:
                # nothing in flight either way: close the deferred-free
                # window so frees turn immediate again
                self.pool.flush_frees(None)
            return 0
        states = inflight["states"]
        pre_pos = inflight["pre_pos"]
        t_block = inflight["t_block"]

        def live_rows():
            return [s for s, st in states.items()
                    if self._sched.active.get(s) is st]

        toks_h = live_h = None
        fetch_attempts = 0
        wait0 = time.perf_counter()
        while True:
            try:
                self._fire("serve.device_get", tick)
                toks_h, live_h = self._call("serve.device_get", self._fetch,
                                            inflight)
                break
            except Exception as e:
                if not (is_transient(e) or is_resource_exhausted(e)):
                    raise
                fetch_attempts += 1
                if fetch_attempts > self._retry_limit:
                    break
                self._backoff(fetch_attempts)
        done = time.perf_counter()
        self.metrics.record_host_sync(done - wait0)
        prev_done = self._prev_block_done
        self._prev_block_done = done
        if toks_h is None:
            # the block's tokens are unrecoverable: every stream in it
            # now has a gap — a definite failure beats resuming past it
            for slot in live_rows():
                finished.append(self._quarantine_slot(
                    slot, tick, "device_get_failed"))
            self._close_frees(inflight["gen"])
            return 0
        # a pipelined block could not start before the previous block's
        # outputs were in: the span from its issue to that fetch is queue
        # time, not the block's own
        dispatch_s = done - inflight["issued"]
        queued_s = 0.0
        if inflight["overlapped"]:
            queued_s = min(dispatch_s,
                           max(0.0, prev_done - inflight["issued"]))
        if self._faults is not None:
            toks_h = self._faults.poison_block(
                "serve.device_get", toks_h, tick=tick, slots=live_rows(),
                replica=self._replica)
        # token-stream validation: greedy tokens are argmax indices in
        # [0, vocab); quarantine a corrupted row BEFORE consume() folds it
        bad_rows = (toks_h < 0).any(axis=1)
        if self._vocab is not None:
            bad_rows |= (toks_h >= int(self._vocab)).any(axis=1)
        quarantined: set[int] = set()
        if bad_rows.any():
            for slot in live_rows():
                if bad_rows[slot]:
                    finished.append(self._quarantine_slot(
                        slot, tick, "poisoned_token"))
                    quarantined.add(slot)
        blk_finished, consumed = self._sched.consume(toks_h, tick,
                                                     states=states)
        n_tokens = sum(consumed.values())
        # live KV rows the block attended per slot: its c consumed
        # micro-steps read frontiers pos0+1 .. pos0+c
        live_kv = sum(
            c * (pre_pos[slot] + 1) + c * (c - 1) // 2
            for slot, c in consumed.items()
        )
        exec_s = max(0.0, dispatch_s - queued_s)
        n_active = inflight["n_active"]
        self.metrics.record_decode(
            n_active, exec_s, tokens_emitted=n_tokens, block=t_block,
            live_kv=live_kv, cache_len=self.cache_len,
        )
        family = inflight["family"]
        self.metrics.perf.record_dispatch(family, dispatch_s,
                                          tokens=n_tokens, queued_s=queued_s)
        decode_ms = round(exec_s * 1e3, 3)
        self.recorder.record("dispatch", tick=tick, family=family,
                             ms=decode_ms, queued_ms=round(queued_s * 1e3, 3),
                             tokens=n_tokens)
        for slot, st in states.items():
            if slot in quarantined or consumed.get(slot) is None:
                continue
            # for every request that kept its slot from dispatch to
            # fetch, the device live mask and the host's retirement
            # bookkeeping agree row by row
            if bool(live_h[slot]) != (self._sched.active.get(slot) is st):
                raise RuntimeError(
                    f"device live mask and host retirement disagree for "
                    f"slot {slot} (block T={t_block})"
                )
        for slot, st in states.items():
            if consumed.get(slot) is not None:
                self._span_event(st.req.id, "decode", tick=tick,
                                 pos=pre_pos[slot], n_active=n_active,
                                 block=t_block, tokens=consumed[slot],
                                 step_ms=decode_ms)
        finished.extend(blk_finished)
        self._note_clean_dispatch(tick)
        self._close_frees(inflight["gen"])
        return n_tokens

    def _close_frees(self, gen: int) -> None:
        """Release the frees deferred up to block ``gen``; with no block
        left in flight, close the window."""
        self.pool.flush_frees(gen)
        if self._inflight is None:
            self.pool.flush_frees(None)

    def run(self, max_ticks: int = 100_000) -> dict[int, RequestResult]:
        """Step until queue, fills and slots drain; results keyed by
        request id. Hitting ``max_ticks`` retires every pending request as
        ``"stalled"`` and raises, with all results on ``err.results``."""
        results: dict[int, RequestResult] = {}
        start = self.tick
        with self.recorder.dump_on_friendly_error():
            while self._sched.busy:
                if self.tick - start >= max_ticks:
                    n_queued = self._sched.queue_depth
                    n_active = len(self._sched.active)
                    # abandon the in-flight block and close the
                    # deferred-free window: the stall's frees land at once
                    self._inflight = None
                    self.pool.flush_frees(None)
                    for res in self._sched.stall_pending(self.tick):
                        results[res.id] = res
                        self.metrics.record_finish(res)
                        self._end_span(res.id, res.status,
                                       tick=res.finish_tick,
                                       generated=res.generated)
                    err = FriendlyError(
                        f"serve run() exceeded max_ticks ({max_ticks}) "
                        f"with {n_queued} queued and {n_active} active "
                        "requests; partial results (completed + "
                        "'stalled') are attached as err.results"
                    )
                    err.results = results
                    raise err
                for res in self.step():
                    results[res.id] = res
        return results

    # -- the replica plane (serve/supervisor.py, serve/fleet.py) -------------

    @property
    def queue_full(self) -> bool:
        """True when the next ``submit`` would bounce off admission
        control — the router's check before choosing a replica."""
        return self._sched.queue_depth >= self._sched.max_queue

    def cancel(self, request_id: int) -> int | None:
        """Cancel one pending request WITHOUT a terminal result (a hedge's
        losing copy, failover dedup): a queued entry leaves the queue, an
        active or filling one frees its slot. Returns the emitted-token
        count discarded, or None when the id is unknown or terminal (or
        the engine is dead)."""
        if self._dead:
            return None
        emitted = self._sched.cancel(request_id)
        if emitted is None:
            return None
        self._handoffs.pop(request_id, None)
        self.metrics.record_cancel()
        self._end_span(request_id, "cancelled", tick=self.tick)
        self.recorder.record("cancelled", tick=self.tick, id=request_id,
                             emitted=emitted)
        return emitted

    def steal_all(self) -> list[dict]:
        """Hand off EVERY pending request for migration to another replica
        (a zero-loss drain, or stall cleanup): active slots preempt (their
        emitted tokens fold into resume prefixes, their slots free), then
        the fills and the queue. Returns plain payload dicts for
        :meth:`adopt` on the target engine; re-prefilling prompt + prefix
        there continues each stream unchanged."""
        reqs = self._sched.handoff_all() if not self._dead else []
        out = []
        for req in reqs:
            # a pending KV payload stays behind: the adopting engine
            # re-prefills from the prompt
            self._handoffs.pop(req.id, None)
            out.append({
                "id": req.id,
                "prompt": np.asarray(req.prompt, np.int32),
                "prefix": np.asarray(req.prefix, np.int32),
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "trace_id": req.trace_id,
            })
            self._end_span(req.id, "migrated", tick=self.tick,
                           prefix_len=len(req.prefix))
        if out:
            self.recorder.record("handoff", tick=self.tick, n=len(out))
        return out

    def adopt(self, prompt, *, prefix=(), max_new_tokens: int,
              eos_id: int | None = None,
              trace_id: str | None = None) -> int:
        """Admit a request MIGRATED from another replica (a drain or a
        failover re-route): ``prefix`` is the tokens the source already
        emitted, re-prefilled with the prompt so decode resumes where it
        stopped. Bypasses ``max_queue`` — the request was admitted once
        already. Returns the new engine-local id."""
        prompt = np.asarray(prompt, np.int32)
        prefix = np.asarray(prefix, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise FriendlyError(
                f"adopt needs a non-empty 1-D prompt, got shape "
                f"{prompt.shape}"
            )
        if len(prefix) >= max_new_tokens:
            raise FriendlyError(
                f"adopted prefix ({len(prefix)} tokens) already meets "
                f"the request budget ({max_new_tokens}); the source "
                "replica should have retired it as completed"
            )
        if int(prompt.size) + max_new_tokens > self.cache_len:
            raise FriendlyError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds this engine's cache_len "
                f"({self.cache_len}); migrate to a replica with equal "
                "cache geometry"
            )
        req = self._queue_migrated(prompt, prefix, max_new_tokens, eos_id,
                                   trace_id)
        self._open_span(req, "adopted", prefix_len=len(prefix))
        return req.id

    def take_handoffs(self) -> list[dict]:
        """Drain the prefill-role outbox: every hand-off payload produced
        since the last call, in hand-off order; [] on a dead engine (the
        fleet re-routes those requests from its own ledger)."""
        if self._dead:
            return []
        out, self._outbox = self._outbox, []
        return out

    def adopt_handoff(self, payload: dict) -> int:
        """Admit a hand-off payload (what :meth:`take_handoffs` returns,
        routed by ``serve/fleet.py``): like :meth:`adopt`, but carrying
        the source's prefill K/V and first token, so admission writes the
        K/V straight into the leased slot — no prefill program runs here
        and the stream continues unchanged. A payload that is corrupt or
        cannot land falls back to a full local prefill. Returns the new
        engine-local id."""
        prompt = np.asarray(payload["prompt"], np.int32)
        prefix = np.asarray(payload.get("prefix", ()), np.int32)
        max_new_tokens = int(payload["max_new_tokens"])
        if prompt.ndim != 1 or prompt.size == 0:
            raise FriendlyError(
                f"hand-off payload needs a non-empty 1-D prompt, got "
                f"shape {prompt.shape}"
            )
        if len(prefix) + 1 > max_new_tokens:
            raise FriendlyError(
                f"hand-off prefix ({len(prefix)} tokens) + the first "
                f"token exceed the request budget ({max_new_tokens}); "
                "the prefill replica should have completed it locally"
            )
        if int(payload["length"]) != int(prompt.size) + len(prefix):
            raise FriendlyError(
                f"hand-off payload length ({payload['length']}) does "
                f"not match prompt ({prompt.size}) + prefix "
                f"({len(prefix)}); the payload is torn"
            )
        if int(prompt.size) + max_new_tokens > self.cache_len:
            raise FriendlyError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds this engine's cache_len "
                f"({self.cache_len}); hand off to a replica with equal "
                "cache geometry"
            )
        req = self._queue_migrated(prompt, prefix, max_new_tokens,
                                   payload.get("eos_id"),
                                   payload.get("trace_id"))
        self._handoffs[req.id] = dict(payload)
        self._open_span(req, "handoff_queued",
                        seq_len=int(payload["length"]))
        return req.id

    def _queue_migrated(self, prompt, prefix, max_new_tokens: int,
                        eos_id, trace_id) -> ServeRequest:
        """Queue a migrated request (no deadline, past ``max_queue``)
        under a new engine-local id; the trace id survives the move."""
        req = ServeRequest(
            id=self._next_id,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            deadline_tick=None,
            submit_tick=self.tick,
            submit_wall=time.perf_counter(),
            prefix=prefix,
            trace_id=str(trace_id or f"t{self._next_id}"),
        )
        self._sched.queue.append(req)
        self._next_id += 1
        self.metrics.record_submit()
        return req

    def health_counters(self) -> dict:
        """The supervisor's probe surface, host-side only (no device
        sync): tick progress, queue and slot load, degradation, SLO burn
        and the fault and retry totals."""
        burning, burn_ticks = (
            (bool(self._slo.should_shed), int(self._slo.burn_ticks))
            if self._slo is not None else (False, 0))
        if self._slo is not None and self._place is not None:
            # each rank's monitor reads its own clock; the probe (a fleet's
            # autoscaler) sees the same figures on every rank
            burning, burn_ticks = self._place.agree_max([burning,
                                                         burn_ticks])
        return {
            "tick": self.tick,
            "busy": self.busy,
            "dead": self._dead,
            "role": self.role,
            "queue_depth": self.queue_depth,
            "active": len(self._sched.active),
            "filling": len(self._sched.filling),
            "degraded": self.degraded,
            "slo_burning": bool(burning),
            # consecutive burning SLO evaluations: the fleet
            # autoscaler's scale-up signal
            "slo_burn_ticks": int(burn_ticks),
            "retries_total": self.metrics.retries_total,
            "quarantined_total": self.metrics.quarantined_total,
            "faults_injected_total": self.metrics.faults_injected_total,
            "tokens_generated": self.metrics.tokens_generated,
        }

    # -- kill, checkpoint and restore -------------------------------------------

    def _park_after_kill(self) -> None:
        """Deterministic parking for a killed engine: the outbox empties,
        the in-flight block is dropped, the deferred-free window closes,
        every leased slot frees back to the pool (a paged pool's mappings
        release) and the captured programs are released, so an engine
        restored from the snapshot in the same process never double-holds
        device state. The host's request bookkeeping (and the program
        counts) are kept for a post-mortem."""
        if self._dead:
            return
        self._dead = True
        # undelivered hand-off payloads die with the engine: the fleet
        # re-routes those requests from its ledger
        self._outbox.clear()
        self._inflight = None
        self.pool.flush_frees(None)
        leased = self.pool.leased_slots()
        for slot in leased:
            self.pool.free(slot)
        # the captured programs and their graph pool go too: a supervisor
        # rebuilding replicas in this process must not hold one pool per
        # failover
        self.release_programs()
        self.recorder.record("killed", tick=self.tick,
                             parked_slots=len(leased))

    def release_programs(self) -> None:
        """Drop every captured program and, with the last of them, the
        shared graph pool's memory; the program counts stay (a killed
        engine's post-mortem reads them), and a released program runs
        eagerly if it is called again."""
        for program in (self._prefill_program, self._resume, self._chunk,
                        self._decode):
            if program is not None:
                program._fn.release()

    @property
    def last_snapshot(self) -> dict | None:
        """The most recent COMPLETE periodic checkpoint (see
        ``snapshot_every_ticks`` / :meth:`checkpoint`); a checkpoint that
        failed mid-write never lands here."""
        return self._last_snapshot

    def checkpoint(self) -> dict | None:
        """Take one periodic checkpoint through the ``serve.snapshot``
        fault hook. A fault there is a checkpoint failing MID-WRITE: it is
        counted, ``last_snapshot`` keeps the previous complete one and
        serving continues (returns None). An injected ``kill`` there is a
        crash while checkpointing: it parks and re-raises."""
        try:
            self._fire("serve.snapshot", self.tick)
            snap = self.snapshot()
        except EngineKilled:
            self._park_after_kill()
            raise
        except Exception as e:  # noqa: BLE001 — a torn checkpoint must
            # not take serving down; the engine keeps the previous one
            self.metrics.record_snapshot_failure()
            self.recorder.record("snapshot_failed", tick=self.tick,
                                 error=str(e))
            return None
        if self._faults is not None:
            # the silent-corruption drill: the flip lands AFTER the
            # checksum stamp, latent until a restore re-hashes
            cseed = self._faults.corrupt_spec("serve.snapshot",
                                              tick=self.tick,
                                              replica=self._replica)
            if cseed is not None:
                snap = integrity.flip_bit_json(snap, cseed)
        self._last_snapshot = snap
        self.metrics.record_snapshot()
        self.recorder.record("snapshot", tick=self.tick,
                             active=len(snap["active"]),
                             queued=len(snap["queued"]))
        return snap

    def snapshot(self) -> dict:
        """JSON-able checkpoint of ALL host-side request state: every
        queued, filling and active request's prompt, emitted tokens,
        budget and deadline, and the engine tick — no device state:
        restore re-prefills prompt + emitted prefix, and greedy decode
        rebuilds the same frontier. The JAX engine's keys and ``version``
        1, stamped with the JAX engine's canonical-JSON checksum. Call
        between ``step()``s."""
        def entry(req, emitted):
            return {
                "id": req.id,
                "prompt": [int(x) for x in req.prompt],
                "emitted": [int(x) for x in emitted],
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "deadline_tick": req.deadline_tick,
                "submit_tick": req.submit_tick,
                "trace": req.trace_id,
            }

        active = [entry(st.req, st.out)
                  for _slot, st in sorted(self._sched.active.items())]
        # mid-fill requests checkpoint as queued entries with their
        # resume prefix: a fill emits no token before it completes
        queued = [entry(fs.req, fs.req.prefix)
                  for _slot, fs in sorted(self._sched.filling.items())]
        queued += [entry(req, req.prefix) for req in self._sched.queue]
        snap = {
            "version": 1,
            "model": self.graph.name,
            "cache_len": self.cache_len,
            "pad_id": self.pad_id,
            "tick": self.tick,
            "next_id": self._next_id,
            "active": active,
            "queued": queued,
        }
        if self._paged:
            # informational: restore rebuilds the mappings from scratch,
            # but the crash dump stays auditable
            snap["paging"] = self.pool.snapshot()
        snap["checksum"] = integrity.json_checksum(snap)
        return snap

    @classmethod
    def restore(cls, snapshot: dict, graph, variables,
                **kwargs) -> "ServeEngine":
        """Rebuild a crashed engine from :meth:`snapshot` (the port's or
        the JAX engine's): a fresh engine (``kwargs`` as for the
        constructor) whose queue re-admits every checkpointed request —
        active ones first, their emitted tokens as a resume prefix, so
        re-prefilling prompt + prefix continues each stream unchanged.
        Deadlines and the tick counter are absolute and survive.

        A snapshot that carries a ``checksum`` is re-hashed FIRST: a
        mismatch raises :class:`SnapshotCorruption` naming both hashes
        before any engine state is built."""
        stamp = snapshot.get("checksum")
        if stamp is not None:
            actual = integrity.json_checksum(snapshot)
            if actual != stamp:
                raise SnapshotCorruption(expected=stamp, actual=actual)
        if snapshot.get("version") != 1:
            raise FriendlyError(
                f"unknown serve snapshot version "
                f"{snapshot.get('version')!r} (this build reads "
                "version 1)"
            )
        if snapshot.get("model") != graph.name:
            raise FriendlyError(
                f"snapshot is for model {snapshot.get('model')!r}, "
                f"cannot restore onto {graph.name!r}"
            )
        kwargs.setdefault("cache_len", snapshot["cache_len"])
        kwargs.setdefault("pad_id", snapshot["pad_id"])
        engine = cls(graph, variables, **kwargs)
        engine._sched.tick_count = int(snapshot["tick"])
        engine._next_id = int(snapshot["next_id"])
        now = time.perf_counter()
        # appended directly, bypassing max_queue: these were admitted
        # once already
        for entry in list(snapshot["active"]) + list(snapshot["queued"]):
            engine._sched.queue.append(ServeRequest(
                id=int(entry["id"]),
                prompt=np.asarray(entry["prompt"], np.int32),
                max_new_tokens=int(entry["max_new_tokens"]),
                eos_id=entry["eos_id"],
                deadline_tick=entry["deadline_tick"],
                submit_tick=int(entry["submit_tick"]),
                submit_wall=now,
                prefix=np.asarray(entry.get("emitted", ()), np.int32),
                trace_id=str(entry.get("trace") or f"t{int(entry['id'])}"),
            ))
            engine.metrics.record_submit()
            req = engine._sched.queue[-1]
            engine._open_span(req, "restored", prefix_len=len(req.prefix))
        # the restored engine's first recovery point IS its snapshot
        engine._last_snapshot = snapshot
        return engine


def _sequence(req) -> np.ndarray:
    """What a request's (re)admission prefills: the prompt, plus the
    tokens already emitted for a preempted or restored request."""
    if len(req.prefix):
        return np.concatenate([req.prompt, req.prefix])
    return req.prompt


def _row(logits, last):
    """Row ``last`` (a 0-d device tensor) of batch-1 ``logits`` (1, B, V):
    a gather, so the host never reads the position."""
    return torch.index_select(logits[0], 0, last.reshape(1).long())[0]
