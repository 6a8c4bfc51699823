"""Single-device trainer with step-level checkpoints and fault-tolerant
execution — the port of ``mmlspark_tpu/train/trainer.py``.

``SPMDTrainer.train(x, y)`` owns the epoch loop over fixed-shape batches
from :func:`~mmlspark_tpu_torch.data.feed.batch_iterator` (the JAX
package's seeded order, padded tail and validity mask; token rows, float
rows or float NHWC images alike). Each step runs the graph in train
mode, a mask-weighted mean loss, ``backward()``, the global gradient
norm, the optimizer update and the in-graph anomaly quarantine: a
non-finite loss or gradient norm, or a norm past ``max_grad_norm``,
keeps the old parameters, optimizer state (its step count included) and
model statistics, so a skipped step is a pure data advance and costs no
host sync.

The variables split as the JAX trainer's do (``_split_variables``):
the trained parameters, and the rest — the statistics a block keeps
(:meth:`~mmlspark_tpu_torch.models.graph.NamedGraph.stat_keys`:
BatchNorm's running mean and variance). The rest is not differentiated;
train mode returns new values for it, which the step writes in place
(JAX's ``new_rest``, kept at its old values on a quarantined step), and
under gradient accumulation each micro-batch's forward starts from the
statistics the one before it left, as JAX's scan carries them.

A block that sows losses (the MoE router's load-balance loss,
``models/moe.py``) returns them in train mode under
``updated[block]["losses"]``; the step adds ``moe_aux_weight`` times
their sum to the loss (JAX's ``_sown_aux_loss``), inside the captured
step, and never carries them into the state, its checkpoints or the
returned variables. Under gradient accumulation the aux loss is each
micro-batch's, weighted with its loss (the JAX package's documented
non-equivalence). In the mesh step a sown loss is the rank's share of
the global one: the shares sum over ``data`` with the loss.

The quarantine's streak and total stay on the device; the host reads
them at the ``log_every`` cadence, when it already syncs for the loss,
and aborts after ``anomaly_limit`` consecutive bad steps.

The step is one program, as the JAX trainer jits it: on the card the
first step runs eagerly (a real step of the trajectory, and the
warm-up), then the whole step — forward, backward, gradient norm, update
and quarantine — is captured once as a CUDA graph
(``testing/compile_guard.ProgramCountingGraph``, behind a
``RetraceWatchdog`` labelled ``train.step`` with one expected program)
and replayed for every later step, each batch copied into its static
inputs. All state — parameters, gradients, moments, the count and the
quarantine's carries — is updated in place, at the addresses the program
reads; everything that writes the state from outside (a restore, the
corrupt drill, the audit's replay, a new rung of the ladder) writes into
those tensors and never rebinds one. ``steps_per_dispatch`` K steps are K
replays with no host sync between them. The blocks draw no random
numbers in train mode, so the captured step reads no generator state. On
the CPU the step runs eagerly.

Resilience, as in the JAX package (its ``docs/TRAINING.md``):

- **Checkpoints** (``checkpoint_dir``): parameters, the rest (manifest
  key ``rest``), optimizer state and the anomaly carries go through
  :class:`~mmlspark_tpu_torch.train.resilience.AtomicCheckpointStore`
  at ``checkpoint_every`` and at the end, with the loss history and
  ``steps_per_epoch`` in the manifest. A resume restores the newest
  intact checkpoint (a corrupt one is quarantined and the one before it
  tried), skips the batches of the epoch already taken, and reproduces
  the uninterrupted run bit for bit (an eager step and a replayed one
  give the same bits).
- **Fault hooks** (``faults=``): ``train.step`` before each dispatch,
  ``train.data`` before each batch is used (``poison`` NaN-corrupts the
  first float column), ``train.checkpoint`` between the payload and the
  commit, ``train.restore`` before a resume's read. Transient faults are
  retried with linear backoff up to ``retry_limit``; ``kill`` escapes as
  ``EngineKilled``.
- **The accumulation ladder**: resource exhaustion — injected at the
  hook, or a real allocation failure in the step or its capture — doubles
  ``grad_accum`` (:func:`~mmlspark_tpu_torch.train.resilience.
  next_accum_rung`) and captures the step again for the new rung: one
  program a rung.
- **Integrity audits** (``audit_every``): the step also folds parameters
  and optimizer state (not the rest, as in the JAX package) into a
  uint32 carry (``ops/tree_checksum.py``), only where a device flag is
  set, so one captured program serves audit and non-audit steps. At the
  cadence the host folds its copy and compares; a mismatch is replayed
  from the last clean state and judged ``transient_sdc`` or
  ``software_nondeterminism``. With ``audit_every=0`` the step holds no
  fold at all.

The optimizers are optax's: ``adam`` (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected), ``adamw`` (adam plus the decoupled ``weight_decay * p``
before the learning rate), ``sgd`` and ``momentum`` (a trace, not
Nesterov), with a constant, a linear-warmup or a warmup-cosine-decay
learning rate read at the optimizer's count before it is incremented.
The update and the quarantine's select are one pass
(``ops/fused_optim.py``): one multi-tensor CUDA launch on the card, the
plain tensor updates on the CPU.

The mesh mode (``mesh_axes`` other than None or ``{"data": 1}``, or
``{"data": 1}`` inside an initialised process group) runs the same step
on every rank of a :func:`~mmlspark_tpu_torch.parallel.mesh.make_mesh`
mesh: data parallelism over ``data`` with the loss normalised by the
global mask count and the gradients summed in one flat bucket;
``param_rules`` that split the compute as GSPMD does in the JAX package
— under ``TRANSFORMER_TP_RULES`` a transformer LM runs each rank's
Megatron-split copy bound to its shards, ungathered, its loss the
vocab-parallel cross entropy, and under ``EXPERT_RULES`` each ``expert``
rank runs only its experts; whole-tensor checkpoints (rank 0 writes;
elastic resume at another data or model width) and the audit's
cross-replica vote (``train/distributed.py``).
``mesh_axes=None`` is one device, group or not. Checkpoints are the
port's own ``.npy`` payloads and do not cross to the JAX package's orbax
ones.
"""

from __future__ import annotations

import itertools
import logging
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core import integrity
from mmlspark_tpu_torch.core.env import default_device, host_to_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError, ParamError
from mmlspark_tpu_torch.core.faults import (
    EngineKilled,
    FaultInjector,
    is_resource_exhausted,
    is_transient,
)
from mmlspark_tpu_torch.core.integrity import CheckpointCorruption
from mmlspark_tpu_torch.core.telemetry import (
    FlightRecorder,
    MetricRegistry,
    RetraceWatchdog,
)
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import MASK_COL, batch_iterator
from mmlspark_tpu_torch.models import bridge
from mmlspark_tpu_torch.models.graph import LOSSES
from mmlspark_tpu_torch.ops.fused_optim import moment_names, optimizer_update
from mmlspark_tpu_torch.ops.tree_checksum import FoldPlan, as_uint32, tree_fold
from mmlspark_tpu_torch.parallel.mesh import Gather, local_batch
from mmlspark_tpu_torch.testing.compile_guard import ProgramCountingGraph
from mmlspark_tpu_torch.train.distributed import (
    MeshRun,
    vocab_parallel_loss_terms,
    wants_mesh,
)
from mmlspark_tpu_torch.train.resilience import (
    AtomicCheckpointStore,
    next_accum_rung,
)

_log = logging.getLogger("mmlspark_tpu_torch.train")

SOFTMAX_XENT = "softmax_xent"
SIGMOID_XENT = "sigmoid_xent"
MSE = "mse"

#: the trainer's counters, made up front so that the exported schema is
#: the same whether or not a fault ever fires (the JAX package's names)
COUNTER_NAMES = (
    "train.retries_total", "train.anomalies_skipped", "train.checkpoints",
    "train.checkpoint_failures", "train.faults_injected_total",
    "train.integrity.audits", "train.integrity.checksum_failures",
    "train.integrity.sdc_suspected",
    "train.integrity.replay_transient_sdc",
    "train.integrity.replay_software_nondeterminism",
)


@dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``: the same fields and defaults."""

    epochs: int = 1
    batch_size: int = 128
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # adam | adamw | sgd | momentum
    loss: str = SOFTMAX_XENT
    weight_decay: float = 0.0
    momentum: float = 0.9
    lr_schedule: str = "constant"  # constant | cosine
    warmup_steps: int = 0
    seed: int = 0
    log_every: int = 50
    shuffle: bool = True
    # K steps per dispatch: one compiled scan in the JAX package; here K
    # replays of the captured step with no host sync between them. The
    # log, audit and checkpoint cadences coarsen to the K-step group as
    # there
    steps_per_dispatch: int = 1
    # recompute each block's activations in the backward
    remat: bool = False
    # K equal micro-batches per optimizer step: a strided split, each
    # micro weighted by its mask count
    grad_accum: int = 1
    moe_aux_weight: float = 1e-2
    mesh_axes: dict | None = None
    param_rules: Any = None
    # step-level checkpoints (train/resilience.py's atomic store)
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0  # steps; 0 = only at the end
    max_checkpoints: int = 3
    resume: bool = True
    # abort after this many CONSECUTIVE quarantined steps (read at the
    # log cadence); 0 disables the abort
    anomaly_limit: int = 5
    # grad-norm explosion threshold of the quarantine; 0 = only
    # non-finite loss/grad_norm count
    max_grad_norm: float = 0.0
    # capped retries of transient train.step/train.data/train.restore
    # faults, with the linear backoff retry_backoff_s * attempt
    retry_limit: int = 3
    retry_backoff_s: float = 0.0
    # integrity audit cadence in steps; 0 = no audit, and no fold in the
    # step program at all
    audit_every: int = 0


# -- the learning-rate schedules and optimizers, as optax computes them --------


def _lr_schedule(cfg: TrainConfig, total_steps: int) -> Callable:
    """count (an int32 tensor) -> learning rate (an f32 tensor)."""
    lr = float(cfg.learning_rate)

    def linear(count, steps: int):
        # optax.linear_schedule(0, lr, steps)
        c = count.clamp(0, steps).float()
        return (0.0 - lr) * (1 - c / steps) + lr

    if cfg.lr_schedule == "cosine":
        warm = max(cfg.warmup_steps, 1)
        decay = max(total_steps, 2) - warm
        if not decay > 0:
            raise ParamError(
                f"the cosine schedule needs more steps ({total_steps}) than "
                f"warmup_steps ({warm})"
            )

        def cosine(count):
            c = torch.clamp((count - warm).float(), max=float(decay))
            return lr * (0.5 * (1 + torch.cos(math.pi * c / decay)))

        return lambda count: torch.where(count < warm, linear(count, warm),
                                         cosine(count))
    if cfg.warmup_steps > 0:
        return lambda count: linear(count, cfg.warmup_steps)
    return lambda count: torch.full((), lr, device=count.device)


class _Optimizer:
    """One of optax's ``adam``/``adamw``/``sgd``/``momentum`` on a list of
    tensors: ``init`` makes the state (``count`` and the moments or the
    trace), ``update`` advances parameters and state in place unless the
    step is bad (``ops/fused_optim.optimizer_update``)."""

    def __init__(self, cfg: TrainConfig, total_steps: int):
        if cfg.optimizer not in ("adam", "adamw", "sgd", "momentum"):
            raise ParamError(f"unknown optimizer '{cfg.optimizer}'")
        self.kind = cfg.optimizer
        self.lr = _lr_schedule(cfg, total_steps)
        self.weight_decay = float(cfg.weight_decay)
        self.momentum = float(cfg.momentum)

    def init(self, params: list) -> dict:
        state = {"count": torch.zeros((), dtype=torch.int32,
                                      device=params[0].device)}
        for name in moment_names(self.kind):
            state[name] = [torch.zeros_like(p) for p in params]
        return state

    def update(self, params: list, grads: list, state: dict, bad) -> None:
        optimizer_update(self.kind, params, grads, state,
                         self.lr(state["count"]), bad,
                         weight_decay=self.weight_decay,
                         momentum=self.momentum)


def sown_aux_loss(variables: dict):
    """The sum of every loss a train-mode forward sowed (the
    ``updated[block]["losses"]`` dicts, ``models/graph.py``); 0.0 when
    none exist."""
    total = 0.0
    for block in variables.values():
        for loss in block.get(LOSSES, {}).values():
            total = total + loss.sum()
    return total


def masked_loss(kind: str, logits, labels, mask):
    """Mask-weighted mean loss; the mask marks real (non-padding) rows.
    (B, T, C) logits are a sequence model's: the loss is per token and
    the row mask spans T."""
    total, w = masked_loss_terms(kind, logits, labels, mask)
    return total / torch.clamp(torch.sum(w), min=1.0)


def masked_loss_terms(kind: str, logits, labels, mask):
    """The masked loss's numerator (the weighted sum of per-token losses)
    and its weights ((B,) or (B, T)): the mesh trainer divides the sum by
    the weights' count over every data rank."""
    w = mask.float()
    if logits.ndim == 3:
        w = w[:, None] * torch.ones(logits.shape[:2], device=logits.device)
    if kind == SOFTMAX_XENT:
        per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                              labels.reshape(-1).long(), reduction="none"
                              ).reshape(labels.shape)
    elif kind == SIGMOID_XENT:
        z, t = logits[..., 0].float(), labels.float()
        per = -t * F.logsigmoid(z) - (1.0 - t) * F.logsigmoid(-z)
    elif kind == MSE:
        pred = logits[..., 0] if logits.ndim > w.ndim else logits
        per = torch.square(pred.float() - labels.float())
    else:
        raise ParamError(f"unknown loss '{kind}'")
    return torch.sum(per * w), w




class SPMDTrainer:
    """Train a :class:`~mmlspark_tpu_torch.models.graph.NamedGraph` on one
    device (``cuda`` unless ``device="cpu"``), or on every rank of a mesh
    (``config.mesh_axes``; ``train()`` returns None on a rank the mesh
    leaves out).

    ``telemetry`` records the ``train.step_ms``, ``train.tokens_per_sec``,
    ``train.loss`` and ``train.grad_norm`` histograms at the log cadence
    and the resilience counters (:data:`COUNTER_NAMES`); ``recorder`` the
    step, checkpoint, restore, anomaly, retry, degraded and integrity
    events, logged when a :class:`FriendlyError` (the anomaly abort, an
    exhausted ladder) escapes ``train()``. ``faults`` (a
    :class:`~mmlspark_tpu_torch.core.faults.FaultInjector`, or None) drives
    the ``train.*`` drill sites.
    """

    def __init__(self, graph, config: TrainConfig,
                 telemetry: MetricRegistry | None = None,
                 recorder: FlightRecorder | None = None,
                 faults: FaultInjector | None = None, *, device=None):
        self.graph = graph
        self.config = config
        self.device = default_device(device)
        self.history: list[dict] = []
        #: loss-curve entries of a restored checkpoint's manifest, apart
        #: from :attr:`history` (this run's own);
        #: ``restored_history + history`` is the whole curve, and what the
        #: next checkpoint keeps
        self.restored_history: list[dict] = []
        #: the replay adjudications, newest last: the audit step, the
        #: verdict (``transient_sdc`` when the replay reproduces the
        #: in-graph or the host fold, ``software_nondeterminism`` when it
        #: reproduces neither) and the three folds compared
        self.replay_verdicts: list[dict] = []
        self.telemetry = telemetry if telemetry is not None \
            else MetricRegistry()
        self.recorder = recorder if recorder is not None \
            else FlightRecorder()
        self._faults = faults
        self._step = 0  # the current global step, the fault listener's tick
        if faults is not None and faults.listener is None:
            def _on_fault(kind: str, site: str) -> None:
                self.telemetry.counter("train.faults_injected_total").inc()
                self.recorder.record("fault_injected", tick=self._step,
                                     kind=kind, site=site)
            faults.listener = _on_fault
        for name in COUNTER_NAMES:
            self.telemetry.counter(name)
        self.telemetry.gauge("train.grad_accum").set(
            max(int(config.grad_accum), 1))

    # -- checkpoints and fault hooks ----------------------------------------

    def _ckpt_store(self) -> AtomicCheckpointStore | None:
        cfg = self.config
        if not cfg.checkpoint_dir:
            return None

        def pre_commit(step: int) -> None:
            # the torn-write drill window, between payload and commit
            if self._faults is not None:
                self._faults.fire("train.checkpoint", tick=step)

        def post_hash(step: int, payload_dir: str) -> None:
            # the silent-corruption drill window: a flip after the hash, so
            # the manifest commits a hash the bytes no longer match
            if self._faults is None:
                return
            seed = self._faults.corrupt_spec("train.checkpoint", tick=step)
            if seed is not None:
                integrity.flip_bit_in_dir(payload_dir, seed)

        return AtomicCheckpointStore(
            cfg.checkpoint_dir, max_to_keep=cfg.max_checkpoints,
            pre_commit=pre_commit, post_hash=post_hash,
        )

    def _fire_hook(self, site: str, tick: int) -> None:
        """Fire one hook site BEFORE the work it guards; transient faults
        are absorbed by up to ``retry_limit`` retries with linear backoff.
        Resource exhaustion and ``kill`` escape to the caller's policy."""
        if self._faults is None:
            return
        cfg = self.config
        attempt = 0
        while True:
            try:
                self._faults.fire(site, tick=tick)
                return
            except Exception as e:
                if is_transient(e) and attempt < cfg.retry_limit:
                    attempt += 1
                    self.telemetry.counter("train.retries_total").inc()
                    self.recorder.record("retry", tick=tick, site=site,
                                         attempt=attempt)
                    if cfg.retry_backoff_s:
                        time.sleep(cfg.retry_backoff_s * attempt)
                    continue
                raise

    # -- the main loop ---------------------------------------------------------

    def train(self, x: np.ndarray, y: np.ndarray,
              init_variables: dict | None = None,
              eval_fn: Callable[[dict], dict] | None = None) -> dict:
        """Run the configured epochs over (x, y); returns the trained
        variables (``{block: {name: tensor}}`` on the trainer's device).
        Weights come from ``init_variables`` (copied, never written), or
        from :func:`~mmlspark_tpu_torch.models.bridge.init_variables` at
        ``config.seed``; a configured checkpoint directory with a
        committed checkpoint overrides both (``resume``)."""
        with self.recorder.dump_on_friendly_error():
            return self._train_impl(x, y, init_variables, eval_fn)

    def _train_impl(self, x, y, init_variables, eval_fn) -> dict:
        cfg = self.config
        dev = self.device
        n = len(x)
        if n == 0:
            raise FriendlyError("empty training set")
        mrun = MeshRun(cfg, dev) if wants_mesh(cfg) else None
        if mrun is not None and not mrun.in_mesh:
            # a rank the mesh does not use has made the groups with the
            # others and takes no part in the run
            _log.info("this rank is not in the mesh %s: nothing to train",
                      mrun.shape)
            return None
        n_data = mrun.n_data if mrun is not None else 1
        batch = cfg.batch_size
        if batch % n_data:
            batch += n_data - batch % n_data
        steps_per_epoch = -(-n // batch)
        opt = _Optimizer(cfg, steps_per_epoch * cfg.epochs)
        accum = max(int(cfg.grad_accum), 1)
        if accum > 1 and batch % (accum * n_data):
            raise FriendlyError(
                f"grad_accum={accum} needs the (data-axis rounded) batch "
                f"size {batch} divisible by accum x data-axis size "
                f"({accum * n_data})"
            )

        self.graph.size_input(np.shape(x)[1:])
        if init_variables is None:
            init_variables = bridge.init_variables(self.graph, cfg.seed,
                                                   device=dev)
        # the trainer's own leaves: updated in place, never the caller's
        variables = {
            b: {k: t.detach().to(dev, copy=True) for k, t in block.items()}
            for b, block in init_variables.items()
        }
        stat_keys = {b: self.graph.stat_keys(b) for b in variables}
        if mrun is not None:
            # under param_rules a rank keeps only its part of each sharded
            # weight (and of its optimizer state)
            mrun.plan(self.graph, {b: {k: t for k, t in block.items()
                                       if k not in stat_keys[b]}
                                   for b, block in variables.items()})
            variables = {b: {k: mrun.shard(b, k, t) for k, t in block.items()}
                         for b, block in variables.items()}
        # the trained parameters and the rest (the blocks' statistics):
        # two views of variables' tensors
        weights = {b: {k: t.requires_grad_(True) for k, t in block.items()
                       if k not in stat_keys[b]}
                   for b, block in variables.items()}
        rest = {b: {k: t for k, t in block.items() if k in stat_keys[b]}
                for b, block in variables.items() if stat_keys[b]}
        params = [t for block in weights.values() for t in block.values()]
        opt_state = opt.init(params)
        streak = torch.zeros((), dtype=torch.int32, device=dev)
        anoms = torch.zeros((), dtype=torch.int32, device=dev)
        # everything a checkpoint holds; its tensors are the step's state
        state = {"params": weights, "rest": rest, "opt_state": opt_state,
                 "anomaly": {"streak": streak, "total": anoms}}
        state_tensors = integrity.tree_leaves(state)

        store = self._ckpt_store()
        step0 = self._resume(store, state, steps_per_epoch, batch, mrun)
        seen_anoms = int(anoms)

        def to_dev(a):
            # no host sync: K steps a dispatch run back to back; a mesh
            # rank takes its block of the global batch's rows
            if mrun is not None:
                a = mrun.local_rows(a)
            return host_to_device(np.ascontiguousarray(a), dev)

        def loss_of(current, bx, by, bm):
            """The loss on one batch from ``current`` variables, and the
            variables with the new statistics."""
            out, updated = self.graph.apply(current, bx, train=True,
                                            mask=bm, remat=cfg.remat)
            loss = masked_loss(cfg.loss, out, by, bm)
            if any(LOSSES in block for block in updated.values()):
                loss = loss + cfg.moe_aux_weight * sown_aux_loss(updated)
            return loss, updated

        # -- the integrity audit's state: the fold's leaves, its carry and
        # the device flags that gate it
        audit_every = max(int(cfg.audit_every), 0)
        audit = audit_every > 0
        fold_tree = (weights, opt_state)
        fold_leaves = integrity.tree_leaves(fold_tree) if audit else []
        plan = FoldPlan(fold_leaves) if audit and dev.type == "cuda" \
            else None
        chk = torch.zeros((), dtype=torch.int32, device=dev)
        flag_on = torch.ones((), dtype=torch.bool, device=dev)
        flag_off = torch.zeros((), dtype=torch.bool, device=dev)
        # an eager call's outputs: a step whose capture ran out of memory
        # has run all the same, and these are its results
        eager_out: list = [None]

        def make_step(accum: int):
            if mrun is not None:
                return make_mesh_step(accum)

            def step(bx, by, bm, *flag):
                for p in params:
                    p.grad = None
                if accum == 1:
                    loss, current = loss_of(variables, bx, by, bm)
                    loss.backward()
                    denom = None
                else:
                    # strided split (row i -> micro i % accum); each micro
                    # contributes its loss SUM and mask count, normalized
                    # once — the JAX package's two exactness rules; the
                    # statistics carry from micro to micro
                    lsum = csum = torch.zeros((), device=dev)
                    current = variables
                    for i in range(accum):
                        mm = bm[i::accum]
                        cnt = mm.float().sum()
                        micro, current = loss_of(current, bx[i::accum],
                                                 by[i::accum], mm)
                        weighted = micro * torch.clamp(cnt, min=1.0)
                        weighted.backward()
                        lsum = lsum + weighted.detach()
                        csum = csum + cnt
                    denom = torch.clamp(csum, min=1.0)
                    loss = lsum / denom
                with torch.no_grad():
                    grads = [torch.zeros_like(p) if p.grad is None
                             else (p.grad if denom is None
                                   else p.grad / denom)
                             for p in params]
                    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                return finish(loss.detach(), grads, gnorm, current, flag)

            return step

        def make_mesh_step(accum: int):
            """The step over the mesh (``train/distributed.py``): this
            rank's rows, the counts and then the gradients summed over
            ``data``; the rank's split (and expert-local) graph on its
            shards, the other sharded weights gathered for the forward. At
            one rank every collective is an identity and the arithmetic is
            the one-device step's, in its order (the vocab-parallel loss
            included: its part beyond ``log_softmax`` is exactly 0)."""
            keys = [(b, k) for b, block in weights.items() for k in block]
            vocab = mrun.model if mrun.split is not None \
                and mrun.split.vocab else None

            def terms(current, bx, by, bm):
                """The rank's loss sum, its weights' tokens a row, the aux
                loss (the rank's share of the global one: the MoE layer
                routes the global batch's groups, ``parallel/expert.py``)
                and the new statistics."""
                with local_batch(mrun.data):
                    out, updated = mrun.step_graph.apply(
                        current, bx, train=True, mask=bm, remat=cfg.remat)
                if vocab is not None and cfg.loss == SOFTMAX_XENT:
                    # the logits are the rank's vocab slice
                    total, w = vocab_parallel_loss_terms(out, by, bm, vocab)
                else:
                    if vocab is not None:
                        out = Gather.apply(out, -1, vocab)
                    total, w = masked_loss_terms(cfg.loss, out, by, bm)
                aux = None
                if any(LOSSES in block for block in updated.values()):
                    aux = cfg.moe_aux_weight * sown_aux_loss(updated)
                return total, w.numel() // w.shape[0], aux, updated

            def step(bx, by, bm, *flag):
                for p in params:
                    p.grad = None
                # the split's shards, the pipeline's stages and the local
                # experts as stored; any other sharded leaf gathered
                bound = mrun.gather(variables, stages=False)
                if accum == 1:
                    rows = mrun.sum_over_data(bm.float().sum())
                    total, per_row, aux, current = terms(bound, bx, by, bm)
                    loss = total / torch.clamp(rows * per_row, min=1.0)
                    if aux is not None:
                        loss = loss + aux
                    loss.backward()
                    lsum, denom = loss.detach(), None
                else:
                    # the one-device step's strided split and weighting,
                    # every micro's row count summed over data up front
                    rows = mrun.sum_over_data(torch.stack(
                        [bm[i::accum].float().sum() for i in range(accum)]))
                    lsum = csum = torch.zeros((), device=dev)
                    current = bound
                    for i in range(accum):
                        mm = bm[i::accum]
                        total, per_row, aux, current = terms(
                            current, bx[i::accum], by[i::accum], mm)
                        micro = total / torch.clamp(rows[i] * per_row,
                                                    min=1.0)
                        if aux is not None:
                            micro = micro + aux
                        weighted = micro * torch.clamp(rows[i], min=1.0)
                        weighted.backward()
                        lsum = lsum + weighted.detach()
                        csum = csum + rows[i]
                    denom = torch.clamp(csum, min=1.0)
                with torch.no_grad():
                    grads = [torch.zeros_like(p) if p.grad is None
                             else p.grad for p in params]
                    grads = mrun.sum_shared_kv(keys, grads)
                    grads, (lsum,) = mrun.reduce_grads(grads, [lsum])
                    loss = lsum
                    if denom is not None:
                        grads = [g / denom for g in grads]
                        loss = lsum / denom
                    gnorm = mrun.grad_norm(keys, grads)
                return finish(loss, grads, gnorm, current, flag)

            return step

        def finish(loss, grads, gnorm, current, flag):
            """The quarantine, the update and the audit's fold, in place."""
            with torch.no_grad():
                bad = ~torch.isfinite(loss) | ~torch.isfinite(gnorm)
                if cfg.max_grad_norm > 0.0:
                    bad = bad | (gnorm > cfg.max_grad_norm)
                # made before the update, so that an allocation failure
                # leaves the state as it was
                new_streak = torch.where(bad, streak + 1,
                                         torch.zeros_like(streak))
                bad_count = bad.int()
                new_rest = [(t, torch.where(bad, t, current[b][k]))
                            for b, block in rest.items()
                            for k, t in block.items()]
                # the update and the quarantine's select, in place
                opt.update(params, grads, opt_state, bad)
                streak.copy_(new_streak)
                anoms.add_(bad_count)
                for t, new in new_rest:
                    t.copy_(new)
                if audit:
                    tree_fold(fold_leaves, out=chk, flag=flag[0], plan=plan)
            out = (loss, gnorm)
            if dev.type != "cuda" or \
                    not torch.cuda.is_current_stream_capturing():
                eager_out[0] = out
            return out

        capture_s = [0.0]

        def build_program(accum: int):
            """The step program at one accumulation rung: one capture a
            rung, each counted by ``retrace.train.step``."""
            return RetraceWatchdog(
                ProgramCountingGraph(make_step(accum), label="train.step"),
                "train.step", registry=self.telemetry,
                recorder=self.recorder, expected_programs=1,
            )

        program = build_program(accum)

        def degrade(tick: int, cause: BaseException) -> None:
            """Walk one rung down the accumulation ladder and make its
            program; the state keeps its addresses."""
            nonlocal accum, program
            nxt = next_accum_rung(accum, batch=batch, n_data=n_data)
            if nxt is None:
                raise FriendlyError(
                    f"RESOURCE_EXHAUSTED at step {tick} with the "
                    f"gradient-accumulation ladder exhausted (grad_accum="
                    f"{accum}, batch {batch} over {n_data} data shards) — "
                    "reduce batch_size or model size"
                ) from cause
            accum = nxt
            self.telemetry.gauge("train.grad_accum").set(accum)
            self.recorder.record("degraded", tick=tick, grad_accum=accum)
            _log.warning("step %d: RESOURCE_EXHAUSTED -> degrading to "
                         "grad_accum=%d and capturing its step", tick, accum)
            capture_s[0] += program.capture_seconds
            program = build_program(accum)

        def guarded_fire(tick: int) -> None:
            """The ``train.step`` hook and its policy: transients retried
            in :meth:`_fire_hook`, resource exhaustion walks the ladder,
            ``kill`` escapes."""
            while True:
                try:
                    self._fire_hook("train.step", tick)
                    return
                except Exception as e:
                    if not is_resource_exhausted(e):
                        raise
                    degrade(tick, e)

        def dispatch(tick: int, bx, by, bm, flags: tuple):
            """One step through the current rung's program. A real
            allocation failure walks the ladder too: raised by an eager
            call, it left the state untouched (the update is the step's
            last write) and the step runs again at the new rung; raised by
            a capture, the eager call before it has taken the step."""
            while True:
                eager_out[0] = None
                try:
                    return program(bx, by, bm, *flags)
                except Exception as e:
                    if not is_resource_exhausted(e):
                        raise
                    done = eager_out[0]
                    degrade(tick, e)
                    if done is not None:
                        return done

        # -- the audit: the last clean state and the batches since
        audit_base: list | None = None
        audit_buf: list[tuple] = []

        def snapshot() -> list:
            return [t.detach().clone() for t in state_tensors]

        def load(snap: list) -> None:
            with torch.no_grad():
                for t, s in zip(state_tensors, snap):
                    t.copy_(s)

        def refresh_base() -> None:
            """The replay's known-good start — a device copy of the state —
            and an empty batch buffer; refreshed after every audit."""
            nonlocal audit_base
            audit_base = snapshot()
            audit_buf.clear()

        def run_audit(at_step: int) -> None:
            """Compare the in-graph fold with host folds of the state. On a
            mesh without rules every rank holds a replica: the ranks' host
            folds vote, and a divergent replica is re-replicated from the
            lowest rank holding the majority. A mismatch is then replayed
            from the last clean state through the same program: the replay
            reproducing either fold makes the flip a one-off
            (``transient_sdc``), and the replayed state is adopted unless
            the vote already repaired it; reproducing neither makes the
            step program nondeterministic, and the current state stands.
            Under rules a rank's copy is a shard: no vote and no replay, as
            in the JAX package."""
            self.telemetry.counter("train.integrity.audits").inc()
            chk_val = as_uint32(chk)
            voting = mrun is not None and not cfg.param_rules
            if voting:
                majority, divergent, chk_val, _ = mrun.vote(
                    integrity.tree_checksum_host(fold_tree), chk_val)
            else:
                # one rank's copy: the "majority" is its own fold
                (majority,) = integrity.per_device_checksums(
                    fold_tree).values()
                divergent = []
            if not divergent and majority == chk_val:
                refresh_base()
                return
            self.telemetry.counter("train.integrity.sdc_suspected").inc()
            self.recorder.record(
                "integrity.sdc_suspected", tick=at_step,
                device_checksum=chk_val, majority_checksum=majority,
                divergent_devices=divergent,
            )
            _log.warning(
                "step %d: integrity audit mismatch (in-graph fold %d, "
                "majority host fold %d, divergent replicas %s) — silent "
                "data corruption suspected", at_step, chk_val, majority,
                divergent)
            if divergent:
                src = min(r for r in range(len(mrun.ranks))
                          if r not in divergent)
                mrun.replicate_from(state_tensors, src)
                self.recorder.record("integrity.replica_quarantined",
                                     tick=at_step, devices=divergent,
                                     source=src)
                _log.warning("step %d: quarantined divergent replicas %s; "
                             "re-replicated from rank %d", at_step,
                             divergent, src)
            if audit_buf and not cfg.param_rules:
                current = snapshot()
                load(audit_base)
                for bx, by, bm in audit_buf:
                    program(to_dev(bx), to_dev(by), to_dev(bm), flag_off)
                fold = integrity.tree_checksum_host(fold_tree)
                verdict = ("transient_sdc" if fold in (majority, chk_val)
                           else "software_nondeterminism")
                self.telemetry.counter(
                    f"train.integrity.replay_{verdict}").inc()
                entry = {"step": int(at_step), "verdict": verdict,
                         "replayed_checksum": int(fold),
                         "device_checksum": int(chk_val),
                         "majority_checksum": int(majority)}
                self.replay_verdicts.append(entry)
                self.recorder.record(
                    "integrity.replay", tick=at_step,
                    **{k: v for k, v in entry.items() if k != "step"})
                _log.warning("step %d: replay adjudication -> %s", at_step,
                             verdict)
                if verdict != "transient_sdc" or divergent:
                    load(current)  # the replayed state is not adopted
            refresh_base()

        def corrupt_drill(tick: int) -> None:
            """The ``train.step`` silent-corruption drill: a seeded bit-flip
            in one parameter AFTER the dispatch, so the in-graph fold
            precedes it and the next audit's host fold sees it. On a mesh
            it lands in one rank's replica (none under rules, as in the
            JAX package)."""
            seed = self._faults.corrupt_spec("train.step", tick=tick)
            if seed is None:
                return
            if mrun is not None:
                if cfg.param_rules or mrun.corrupt_target(
                        seed, len(params)) != mrun.rank:
                    return
            integrity.corrupt_replica(weights, seed)

        def pull_guard(b: dict, tick: int) -> dict:
            """The ``train.data`` hook: transients retried, ``poison``
            NaN-corrupts the first float column's first row — the stand-in
            for a bad gradient that the quarantine must skip."""
            self._fire_hook("train.data", tick)
            if self._faults.poison_value("train.data", tick=tick) is None:
                return b
            b = dict(b)
            for col in ("x", "y"):
                arr = np.asarray(b[col])
                if np.issubdtype(arr.dtype, np.floating):
                    arr = np.array(arr, copy=True)
                    arr[0] = np.nan
                    b[col] = arr
                    break
            else:
                _log.warning("train.data poison skipped at step %d: no "
                             "float column to corrupt", tick)
            return b

        def save_checkpoint(at_step: int) -> None:
            """Atomic checkpoint of the whole resume state; a failure other
            than the ``kill`` drill is counted and the previous checkpoint
            stands."""
            meta = {"steps_per_epoch": steps_per_epoch,
                    "history": self.restored_history + self.history}
            try:
                if mrun is None:
                    store.save(at_step, state, meta=meta)
                else:
                    # whole tensors, written by rank 0; the others fire
                    # the drill hook with it and wait for the commit
                    whole = mrun.whole_state(state)
                    try:
                        if mrun.is_root:
                            store.save(at_step, whole, meta=meta)
                        elif self._faults is not None:
                            self._faults.fire("train.checkpoint",
                                              tick=at_step)
                    finally:
                        mrun.barrier()
            except EngineKilled:
                raise  # the torn-write crash drill escapes train()
            except Exception as e:
                self.telemetry.counter("train.checkpoint_failures").inc()
                self.recorder.record("checkpoint", tick=at_step, ok=False,
                                     error=type(e).__name__)
                _log.warning("checkpoint at step %d failed (%s); previous "
                             "checkpoint stands", at_step, e)
                return
            self.telemetry.counter("train.checkpoints").inc()
            self.recorder.record("checkpoint", tick=at_step, ok=True)

        def run_one(b: dict, tick: int, flag: bool):
            bx, by, bm = (to_dev(b[c]) for c in ("x", "y", MASK_COL))
            if not audit:
                return dispatch(tick, bx, by, bm, ())
            audit_buf.append(tuple(np.asarray(b[c])
                                   for c in ("x", "y", MASK_COL)))
            return dispatch(tick, bx, by, bm,
                            (flag_on if flag else flag_off,))

        if audit:
            refresh_base()
        k_steps = max(int(cfg.steps_per_dispatch), 1)
        if cfg.param_rules:
            k_steps = 1  # one step a dispatch under rules, as in JAX
        log_every = max(cfg.log_every, 1)
        tokens_per_step = batch * (x.shape[1] if np.ndim(x) == 2 else 1)
        step = step0
        self._step = step
        start_epoch = step0 // steps_per_epoch
        # mid-epoch resume: the seeded order makes skipping the first
        # step0 % steps_per_epoch batches land on the checkpoint's position
        skip_in_first = step0 % steps_per_epoch
        for epoch in range(start_epoch, cfg.epochs):
            it: Iterator = batch_iterator(
                Dataset({"x": x, "y": y}), ["x", "y"], batch,
                shuffle_seed=(cfg.seed + epoch) if cfg.shuffle else None,
            )
            if epoch == start_epoch and skip_in_first:
                it = itertools.islice(it, skip_in_first, None)
            while group := list(itertools.islice(it, k_steps)):
                t_group = time.perf_counter()
                self._step = step
                if self._faults is not None:
                    group = [pull_guard(b, step + i)
                             for i, b in enumerate(group)]
                if k_steps > 1 and len(group) == k_steps:
                    # one dispatch of K steps: one hook firing, the fold
                    # (when due) after the last step, one corrupt drill
                    guarded_fire(step)
                    audit_due = audit and any(
                        (s + 1) % audit_every == 0
                        for s in range(step, step + len(group)))
                    for i, b in enumerate(group):
                        loss, gnorm = run_one(
                            b, step + i, audit_due and i == len(group) - 1)
                    if self._faults is not None:
                        corrupt_drill(step)
                else:
                    audit_due = False
                    for i, b in enumerate(group):
                        guarded_fire(step + i)
                        due = audit and (step + i + 1) % audit_every == 0
                        loss, gnorm = run_one(b, step + i, due)
                        audit_due = audit_due or due
                        if self._faults is not None:
                            corrupt_drill(step + i)
                # log once if any step of the group hits the cadence,
                # with the group's last loss (the JAX chunk rule)
                next_log = step + (-step) % log_every
                step += len(group)
                self._step = step
                if next_log < step:
                    self._log_step(step - 1, epoch, loss, gnorm,
                                   (time.perf_counter() - t_group)
                                   / len(group), tokens_per_step)
                    self._check_anomalies(streak, anoms, seen_anoms,
                                          step - 1)
                    seen_anoms = max(seen_anoms, int(anoms))
                if audit_due:
                    # before the checkpoint, so that a detected corruption
                    # is never committed to disk
                    run_audit(step - 1)
                if store is not None and cfg.checkpoint_every and any(
                        s % cfg.checkpoint_every == 0
                        for s in range(step - len(group), step)):
                    save_checkpoint(step - 1)
            if eval_fn is not None:
                metrics = eval_fn(_detached(
                    variables if mrun is None else mrun.whole(variables)))
                self.history.append({"step": step, "epoch": epoch,
                                     **metrics})
        # the end-of-run sweep: a bad streak that never met the cadence
        self._check_anomalies(streak, anoms, seen_anoms, step - 1)
        if store is not None and store.latest_step() != step - 1:
            save_checkpoint(step - 1)
        self.telemetry.gauge("train.step_capture_s").set(
            capture_s[0] + program.capture_seconds)
        if mrun is not None:
            return _detached(mrun.whole(variables))
        return _detached(variables)

    def _resume(self, store, state: dict, steps_per_epoch: int,
                batch: int, mrun=None) -> int:
        """Restore the newest intact checkpoint into ``state``'s tensors
        (in place, before the first step); returns the first step to run.
        A corrupt checkpoint is counted, quarantined by the store, and the
        one before it tried; with none intact the run starts cold. On a
        mesh rank 0 searches (its ``train.restore`` hooks fire), and every
        rank then reads the step it found and keeps its part."""
        cfg = self.config
        if store is None or not cfg.resume:
            return 0
        if mrun is None:
            restored, meta, latest = self._find_checkpoint(store, state)
        else:
            target = mrun.whole_template(state)
            found = None
            if mrun.is_root:
                found = self._find_checkpoint(store, target)[2]
            latest = mrun.broadcast_object(found)
            restored = meta = None
            if latest is not None:
                restored, meta, latest = store.restore(target, step=latest)
        if restored is None:
            return 0
        if mrun is None:
            with torch.no_grad():
                for t, r in zip(integrity.tree_leaves(state),
                                integrity.tree_leaves(restored)):
                    t.copy_(r)
        else:
            mrun.load_whole(state, restored)
        self.restored_history = list(meta.get("history", []))
        spe = meta.get("steps_per_epoch")
        n_data = mrun.n_data if mrun is not None else 1
        if spe is not None and int(spe) != steps_per_epoch:
            raise FriendlyError(
                f"checkpoint at {cfg.checkpoint_dir!r} was taken with "
                f"steps_per_epoch={spe} but this run computes "
                f"{steps_per_epoch} (batch {batch} over {n_data} data "
                "shards): elastic resume needs a batch_size divisible by "
                "both the old and new data-axis widths so the "
                "deterministic data order is unchanged"
            )
        total = int(state["anomaly"]["total"])
        self.recorder.record("restore", tick=latest, anomalies_total=total)
        _log.info("resumed from checkpoint step %d", latest)
        return latest + 1

    def _find_checkpoint(self, store, target: dict):
        """``(state, meta, step)`` of the newest intact checkpoint, or
        ``(None, None, None)``; each corrupt one is counted and
        quarantined by the store."""
        latest = store.latest_step()
        while latest is not None:
            # the train.restore drill site: transient -> a retried read,
            # kill -> the restore itself crashed (escapes)
            self._fire_hook("train.restore", latest)
            try:
                return store.restore(target)
            except CheckpointCorruption as e:
                self.telemetry.counter(
                    "train.integrity.checksum_failures").inc()
                self.recorder.record(
                    "integrity.checksum_failure", tick=e.step,
                    surface="checkpoint", expected=e.expected,
                    actual=e.actual)
                _log.warning("%s", e)
                latest = store.latest_step()
        return None, None, None

    def _log_step(self, at_step: int, epoch: int, loss, gnorm,
                  step_s: float, tokens_per_step: int) -> None:
        loss_val, gnorm_val = float(loss), float(gnorm)
        # the fetch above synchronizes: step_s spans dispatch and device
        step_s = max(step_s, 1e-9)
        tel = self.telemetry
        tel.histogram("train.step_ms").record(step_s * 1e3)
        tel.histogram("train.tokens_per_sec").record(tokens_per_step / step_s)
        # a quarantined step's figures are non-finite: history and the
        # anomaly counter carry them, the histograms do not
        if np.isfinite(loss_val):
            tel.histogram("train.loss").record(loss_val)
        if np.isfinite(gnorm_val):
            tel.histogram("train.grad_norm").record(gnorm_val)
        self.history.append({"step": at_step, "epoch": epoch,
                             "loss": loss_val, "grad_norm": gnorm_val})
        self.recorder.record("step", tick=at_step, epoch=epoch,
                             loss=loss_val, grad_norm=gnorm_val)
        _log.info("step %d epoch %d loss %.5f grad_norm %.4f step_ms %.1f",
                  at_step, epoch, loss_val, gnorm_val, step_s * 1e3)

    def _check_anomalies(self, streak, anoms, seen_anoms: int,
                         at_step: int) -> None:
        """Host read of the quarantine's carries: count newly skipped
        steps and abort on a streak past the limit."""
        cfg = self.config
        streak_val, anoms_val = int(streak), int(anoms)
        if anoms_val > seen_anoms:
            self.telemetry.counter("train.anomalies_skipped").inc(
                anoms_val - seen_anoms)
            self.recorder.record("anomaly", tick=at_step, streak=streak_val,
                                 skipped_total=anoms_val)
            _log.warning(
                "step %d: %d anomalous gradient step(s) quarantined (streak "
                "%d) — params/optimizer not advanced", at_step,
                anoms_val - seen_anoms, streak_val)
        if cfg.anomaly_limit and streak_val >= cfg.anomaly_limit:
            raise FriendlyError(
                f"{streak_val} consecutive anomalous gradient steps "
                f"(non-finite or exploding grad_norm) at step {at_step}; "
                f"aborting after anomaly_limit={cfg.anomaly_limit}. The "
                "quarantine kept params and optimizer state at their last "
                "healthy values"
            )


def _detached(variables: dict) -> dict:
    return {b: {k: t.detach() for k, t in block.items()}
            for b, block in variables.items()}
