"""Synthetic-data training demo — the port of ``mmlspark_tpu/train/demo.py``.

Trains a small MLP classifier on seeded synthetic float blobs through
:class:`~mmlspark_tpu_torch.train.trainer.SPMDTrainer` and returns one
metrics dict: the trainer's step-time, loss and grad-norm histograms, the
resilience counters (``train.retries_total``, ``train.anomalies_skipped``,
``train.checkpoints``, ``train.checkpoint_failures``, ``train.
integrity.*``) and the run's checkpoint and restart summary — the JAX
demo's keys. The demo owns the restart loop a fleet supervisor would run:
an injected ``kill`` (``faults="seed=1,train.step:kill=0.1"``) crashes the
trainer, and the demo builds a new one that resumes from the last
committed checkpoint — bit-exact, per the drill tests.

Float features on purpose: ``train.data`` poison NaN-corrupts a feature
row, which drives the grad-anomaly quarantine. With ``telemetry_dir`` the
flight recorder's timeline lands in ``events.jsonl``, the metrics dict in
``metrics.json`` and the registry's Prometheus text exposition in
``metrics.prom`` — the JAX demo's bundle, each file written atomically.

``mesh`` (``"data=2,model=2"``) trains over the trainer's mesh mode:
every rank of an initialised process group calls the demo, and a rank
the mesh leaves out returns the metrics of a run with no steps.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def run_train_demo(*, epochs: int = 2, batch_size: int = 32,
                   n_samples: int = 192, features: int = 8,
                   classes: int = 2, hidden: tuple = (16,),
                   seed: int = 0, log_every: int = 1,
                   checkpoint_every: int = 1, max_restarts: int = 5,
                   anomaly_limit: int = 5, max_grad_norm: float = 0.0,
                   audit_every: int = 0,
                   mesh: str | None = None,
                   checkpoint_dir: str | None = None,
                   telemetry_dir: str | None = None,
                   faults: str | None = None,
                   device=None) -> dict:
    """Run the synthetic training loop with crash-restart supervision on
    ``device`` (the card unless the caller asks for ``"cpu"``); returns
    the metrics dict."""
    from mmlspark_tpu_torch.core.env import default_device
    from mmlspark_tpu_torch.core.faults import EngineKilled, parse_fault_spec
    from mmlspark_tpu_torch.core.telemetry import (
        FlightRecorder,
        MetricRegistry,
    )
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train.resilience import AtomicCheckpointStore
    from mmlspark_tpu_torch.train.trainer import SPMDTrainer, TrainConfig

    from mmlspark_tpu_torch.parallel.mesh import parse_mesh_axes

    dev = default_device(device)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_samples, features)).astype(np.float32)
    w = rng.normal(size=(features, classes)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(n_samples, classes)),
                  axis=1)
    graph = build_model("mlp", num_outputs=classes, hidden=tuple(hidden))

    # the kill-restart drill needs somewhere durable to resume from even
    # when the caller did not ask to keep checkpoints
    ckpt_dir = checkpoint_dir or _shared_tempdir(mesh)
    cfg = TrainConfig(
        epochs=epochs, batch_size=batch_size, learning_rate=1e-2,
        seed=seed, log_every=log_every, shuffle=False,
        mesh_axes=parse_mesh_axes(mesh) if mesh else None,
        checkpoint_dir=ckpt_dir, checkpoint_every=checkpoint_every,
        anomaly_limit=anomaly_limit, max_grad_norm=max_grad_norm,
        retry_backoff_s=0.0, audit_every=audit_every,
    )
    # ONE registry, recorder and injector across restarts: the resumed
    # trainer appends to the same timeline, and the injector's remaining
    # schedule and rate stream carry over
    registry = MetricRegistry()
    recorder = FlightRecorder()
    injector = parse_fault_spec(faults) if faults else None
    if injector is not None and injector.listener is None:
        def _on_fault(kind: str, site: str) -> None:
            registry.counter("train.faults_injected_total").inc()
            recorder.record("fault_injected", kind=kind, site=site)
        injector.listener = _on_fault

    restarts = 0
    while True:
        trainer = SPMDTrainer(graph, cfg, telemetry=registry,
                              recorder=recorder, faults=injector,
                              device=dev)
        try:
            trainer.train(x, y)
            break
        except EngineKilled:
            # the crash drill: a new trainer resumes from the last
            # committed checkpoint
            restarts += 1
            recorder.record("restart", attempt=restarts)
            if restarts >= max_restarts:
                raise

    full_history = trainer.restored_history + trainer.history
    loss_hist = [h for h in full_history if "loss" in h]
    out = registry.to_dict()
    out.update(
        steps_total=(loss_hist[-1]["step"] + 1) if loss_hist else 0,
        final_loss=loss_hist[-1]["loss"] if loss_hist else None,
        restarts=restarts,
        epochs=epochs,
        batch_size=batch_size,
        history_len=len(full_history),
        checkpoint_steps=AtomicCheckpointStore(ckpt_dir).steps(),
        checkpoint_dir=ckpt_dir,
        model_config={"features": features, "classes": classes,
                      "hidden": list(hidden)},
        audit_every=audit_every,
        replay_verdicts=trainer.replay_verdicts,
    )
    if injector is not None:
        out["faults_injected"] = dict(injector.counts)
    if telemetry_dir:
        from mmlspark_tpu_torch.core.telemetry import (
            atomic_write_json,
            atomic_write_text,
        )

        # a kill mid-dump never leaves a torn telemetry file
        os.makedirs(telemetry_dir, exist_ok=True)
        recorder.dump(os.path.join(telemetry_dir, "events.jsonl"))
        atomic_write_json(os.path.join(telemetry_dir, "metrics.json"), out,
                          indent=1, default=str)
        atomic_write_text(os.path.join(telemetry_dir, "metrics.prom"),
                          registry.to_prometheus())
    return out


def _shared_tempdir(mesh: str | None) -> str:
    """A fresh checkpoint directory; over a mesh rank 0 makes it and every
    rank takes its path (rank 0 writes, every rank restores)."""
    import torch.distributed as dist

    if not (mesh and dist.is_available() and dist.is_initialized()):
        # without a group the trainer's make_mesh says what is missing
        return tempfile.mkdtemp(prefix="mmltpu-train-ck-")

    box = [tempfile.mkdtemp(prefix="mmltpu-train-ck-")
           if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
