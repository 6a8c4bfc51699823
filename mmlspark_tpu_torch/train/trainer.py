"""Single-device trainer — the port of ``mmlspark_tpu/train/trainer.py``.

``SPMDTrainer.train(x, y)`` owns the epoch loop over fixed-shape batches
from :func:`~mmlspark_tpu_torch.data.feed.batch_iterator` (the JAX
package's seeded order, padded tail and validity mask). Each step runs
the graph in train mode, a mask-weighted mean loss, ``backward()``, the
global gradient norm, the optimizer update and the in-graph anomaly
quarantine: a non-finite loss or gradient norm, or a norm past
``max_grad_norm``, keeps the old parameters and optimizer state
(its step count included), so a skipped step is a pure data advance and
costs no host sync. The quarantine's streak and total stay on the
device; the host reads them at the ``log_every`` cadence, when it already
syncs for the loss, and aborts after ``anomaly_limit`` consecutive bad
steps.

The step is one program, as the JAX trainer jits it: on the card the
first step runs eagerly (a real step of the trajectory, and the
warm-up), then the whole step — forward, backward, gradient norm, update
and quarantine — is captured once as a CUDA graph
(``testing/compile_guard.ProgramCountingGraph``, behind a
``RetraceWatchdog`` labelled ``train.step`` with one expected program)
and replayed for every later step, each batch copied into its static
inputs. All state — parameters, gradients, moments, the count and the
quarantine's carries — is updated in place, at the addresses the program
reads. ``steps_per_dispatch`` K steps are K replays with no host sync
between them. The blocks draw no random numbers in train mode, so the
captured step reads no generator state (``remat``'s recompute keeps
none either). On the CPU the step runs eagerly.

The optimizers are optax's: ``adam`` (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected), ``adamw`` (adam plus the decoupled ``weight_decay * p``
before the learning rate), ``sgd`` and ``momentum`` (a trace, not
Nesterov), with a constant, a linear-warmup or a warmup-cosine-decay
learning rate read at the optimizer's count before it is incremented.
The update and the quarantine's select are one pass
(``ops/fused_optim.py``): one multi-tensor CUDA launch on the card, the
plain tensor updates on the CPU.

Ported here for one device; left out, each a ``ParamError`` naming its
ROADMAP item when asked for: checkpoints and resume
(``checkpoint_dir``), integrity audits (``audit_every``), meshes and
tensor parallelism (``mesh_axes`` wider than one device,
``param_rules``). The ``train.*`` fault sites and retries are not ported
either (the trainer takes no fault injector).
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

from mmlspark_tpu_torch.core.env import default_device, host_to_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError, ParamError
from mmlspark_tpu_torch.core.telemetry import (
    FlightRecorder,
    MetricRegistry,
    RetraceWatchdog,
)
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import MASK_COL, batch_iterator
from mmlspark_tpu_torch.models import bridge
from mmlspark_tpu_torch.ops.fused_optim import moment_names, optimizer_update
from mmlspark_tpu_torch.testing.compile_guard import ProgramCountingGraph

_log = logging.getLogger("mmlspark_tpu_torch.train")

SOFTMAX_XENT = "softmax_xent"
SIGMOID_XENT = "sigmoid_xent"
MSE = "mse"


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
    # log cadence coarsens to the K-step group as there
    steps_per_dispatch: int = 1
    # recompute each block's activations in the backward
    remat: bool = False
    # K equal micro-batches per optimizer step: a strided split, each
    # micro weighted by its mask count
    grad_accum: int = 1
    moe_aux_weight: float = 1e-2
    mesh_axes: dict | None = None
    param_rules: Any = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    max_checkpoints: int = 3
    resume: bool = True
    # abort after this many CONSECUTIVE quarantined steps (read at the
    # log cadence); 0 disables the abort
    anomaly_limit: int = 5
    # grad-norm explosion threshold of the quarantine; 0 = only
    # non-finite loss/grad_norm count
    max_grad_norm: float = 0.0
    retry_limit: int = 3
    retry_backoff_s: float = 0.0
    audit_every: int = 0


def _check_ported(cfg: TrainConfig) -> None:
    """Refuse the fields whose machinery this port has not brought over."""
    if cfg.checkpoint_dir:
        raise ParamError(
            "checkpoint_dir: atomic checkpoints and resume are not ported "
            "yet (ROADMAP.md Queue 1 item 10, left-out 1)"
        )
    if cfg.audit_every:
        raise ParamError(
            "audit_every: integrity audits are not ported yet (ROADMAP.md "
            "Queue 1 item 10, left-out 3)"
        )
    if cfg.param_rules is not None:
        raise ParamError(
            "param_rules: tensor parallelism is not ported yet (ROADMAP.md "
            "Queue 1 item 13)"
        )
    if cfg.mesh_axes not in (None, {"data": 1}):
        raise ParamError(
            f"mesh_axes={cfg.mesh_axes}: meshes are not ported yet (ROADMAP.md"
            " Queue 1 item 13); the trainer runs on one device"
        )


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


def masked_loss(kind: str, logits, labels, mask):
    """Mask-weighted mean loss; the mask marks real (non-padding) rows.
    (B, T, C) logits are a sequence model's: the loss is per token and
    the row mask spans T."""
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
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)


class SPMDTrainer:
    """Train a :class:`~mmlspark_tpu_torch.models.graph.NamedGraph` on one
    device (``cuda`` unless ``device="cpu"``).

    ``telemetry`` records the ``train.step_ms``, ``train.tokens_per_sec``,
    ``train.loss`` and ``train.grad_norm`` histograms at the log cadence;
    ``recorder`` the step and anomaly events, logged when a
    :class:`FriendlyError` (the anomaly abort) escapes ``train()``.
    """

    def __init__(self, graph, config: TrainConfig,
                 telemetry: MetricRegistry | None = None,
                 recorder: FlightRecorder | None = None, *, device=None):
        _check_ported(config)
        self.graph = graph
        self.config = config
        self.device = default_device(device)
        self.history: list[dict] = []
        self.telemetry = telemetry if telemetry is not None \
            else MetricRegistry()
        self.recorder = recorder if recorder is not None \
            else FlightRecorder()
        self.telemetry.counter("train.anomalies_skipped")
        self.telemetry.gauge("train.grad_accum").set(
            max(int(config.grad_accum), 1))

    def train(self, x: np.ndarray, y: np.ndarray,
              init_variables: dict | None = None,
              eval_fn: Callable[[dict], dict] | None = None) -> dict:
        """Run the configured epochs over (x, y); returns the trained
        variables (``{block: {name: tensor}}`` on the trainer's device).
        Weights come from ``init_variables`` (copied, never written), or
        from :func:`~mmlspark_tpu_torch.models.bridge.init_variables` at
        ``config.seed``."""
        with self.recorder.dump_on_friendly_error():
            return self._train_impl(x, y, init_variables, eval_fn)

    def _train_impl(self, x, y, init_variables, eval_fn) -> dict:
        cfg = self.config
        dev = self.device
        n = len(x)
        if n == 0:
            raise FriendlyError("empty training set")
        batch = cfg.batch_size
        steps_per_epoch = -(-n // batch)
        opt = _Optimizer(cfg, steps_per_epoch * cfg.epochs)
        accum = max(int(cfg.grad_accum), 1)
        if accum > 1 and batch % accum:
            raise FriendlyError(
                f"grad_accum={accum} needs the (data-axis rounded) batch "
                f"size {batch} divisible by accum x data-axis size "
                f"({accum})"
            )

        if init_variables is None:
            init_variables = bridge.init_variables(self.graph, cfg.seed,
                                                   device=dev)
        # the trainer's own leaves: updated in place, never the caller's
        variables = {
            b: {k: t.detach().to(dev, copy=True).requires_grad_(True)
                for k, t in block.items()}
            for b, block in init_variables.items()
        }
        params = [t for block in variables.values() for t in block.values()]
        opt_state = opt.init(params)
        streak = torch.zeros((), dtype=torch.int32, device=dev)
        anoms = torch.zeros((), dtype=torch.int32, device=dev)
        seen_anoms = 0

        def to_dev(a):
            # no host sync: K steps a dispatch run back to back
            return host_to_device(np.ascontiguousarray(a), dev)

        def loss_of(bx, by, bm):
            out, _ = self.graph.apply(variables, bx, train=True, mask=bm,
                                      remat=cfg.remat)
            return masked_loss(cfg.loss, out, by, bm)

        def step(bx, by, bm):
            for p in params:
                p.grad = None
            if accum == 1:
                loss = loss_of(bx, by, bm)
                loss.backward()
                denom = None
            else:
                # strided split (row i -> micro i % accum); each micro
                # contributes its loss SUM and mask count, normalized
                # once — the JAX package's two exactness rules
                lsum = csum = torch.zeros((), device=dev)
                for i in range(accum):
                    mm = bm[i::accum]
                    cnt = mm.float().sum()
                    weighted = loss_of(bx[i::accum], by[i::accum], mm) \
                        * torch.clamp(cnt, min=1.0)
                    weighted.backward()
                    lsum = lsum + weighted.detach()
                    csum = csum + cnt
                denom = torch.clamp(csum, min=1.0)
                loss = lsum / denom
            with torch.no_grad():
                grads = [torch.zeros_like(p) if p.grad is None
                         else (p.grad if denom is None else p.grad / denom)
                         for p in params]
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                bad = ~torch.isfinite(loss) | ~torch.isfinite(gnorm)
                if cfg.max_grad_norm > 0.0:
                    bad = bad | (gnorm > cfg.max_grad_norm)
                # the update and the quarantine's select, in place
                opt.update(params, grads, opt_state, bad)
                streak.copy_(torch.where(bad, streak + 1,
                                         torch.zeros_like(streak)))
                anoms.add_(bad.int())
            return loss.detach(), gnorm

        program = RetraceWatchdog(
            ProgramCountingGraph(step, label="train.step"), "train.step",
            registry=self.telemetry, recorder=self.recorder,
            expected_programs=1,
        )
        k_steps = max(int(cfg.steps_per_dispatch), 1)
        log_every = max(cfg.log_every, 1)
        tokens_per_step = batch * (x.shape[1] if np.ndim(x) == 2 else 1)
        step_no = 0
        for epoch in range(cfg.epochs):
            it: Iterator = batch_iterator(
                Dataset({"x": x, "y": y}), ["x", "y"], batch,
                shuffle_seed=(cfg.seed + epoch) if cfg.shuffle else None,
            )
            while group := list(itertools.islice(it, k_steps)):
                t_group = time.perf_counter()
                for b in group:
                    loss, gnorm = program(to_dev(b["x"]), to_dev(b["y"]),
                                          to_dev(b[MASK_COL]))
                # log once if any step of the group hits the cadence,
                # with the group's last loss (the JAX chunk rule)
                next_log = step_no + (-step_no) % log_every
                step_no += len(group)
                if next_log < step_no:
                    self._log_step(step_no - 1, epoch, loss, gnorm,
                                   (time.perf_counter() - t_group)
                                   / len(group), tokens_per_step)
                    self._check_anomalies(streak, anoms, seen_anoms,
                                          step_no - 1)
                    seen_anoms = max(seen_anoms, int(anoms))
            if eval_fn is not None:
                metrics = eval_fn(_detached(variables))
                self.history.append({"step": step_no, "epoch": epoch,
                                     **metrics})
        # the end-of-run sweep: a bad streak that never met the cadence
        self._check_anomalies(streak, anoms, seen_anoms, step_no - 1)
        self.telemetry.gauge("train.step_capture_s").set(
            program.capture_seconds)
        return _detached(variables)

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
