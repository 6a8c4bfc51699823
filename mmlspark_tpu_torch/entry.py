"""The port's entry point — the twin of ``__graft_entry__.py``'s
``entry()`` at the repo root.

``entry()`` returns a forward step on the flagship model (ResNet-20 for
CIFAR-10, the reference notebook-301 eval model) with its example
arguments, on the card unless the caller asks for the CPU.
``dryrun_multichip(n)`` is the twin of its data-parallel leg: one full
training step of ResNet-20 (width 8) over a ``data=n`` mesh of ``n``
gloo ranks on the CPU, as the JAX module validates sharding on ``n``
virtual CPU devices. Its other legs (tensor, pipeline, expert and
sequence parallelism, the BiLSTM chain) are the mesh tests'.
"""

from __future__ import annotations

import torch


def entry(device=None):
    """Return ``(forward, (variables, example_x))`` for ResNet-20: the
    port's seeded variables (seed 0) and a zero batch of 128 NHWC 32x32
    RGB images, both on ``device``; ``forward(variables, x)`` returns the
    (128, 10) f32 logits."""
    from mmlspark_tpu_torch.core.env import default_device
    from mmlspark_tpu_torch.models import build_model, init_variables

    dev = default_device(device)
    graph = build_model("resnet20_cifar10")
    variables = init_variables(graph, 0, device=dev)

    def forward(variables, x):
        return graph.apply(variables, x)

    example_x = torch.zeros((128, 32, 32, 3), dtype=torch.float32,
                            device=dev)
    return forward, (variables, example_x)


def dryrun_multichip(n_devices: int) -> list[float]:
    """One full training step of ``resnet20_cifar10(width=8)`` over a
    ``{"data": n_devices}`` mesh: ``n_devices`` gloo rank processes on
    the CPU (started and stopped here, each under a time limit), a
    seeded batch of ``2 * n_devices`` images, then one forward on the
    trained variables. Returns every rank's loss (equal: the ranks hold
    one replica); raises when a rank fails."""
    from mmlspark_tpu_torch.testing.rank_pool import RankPool

    pool = RankPool(n_devices, timeout=600.0)
    try:
        losses = pool.run(_dryrun_rank, n_devices)
    finally:
        pool.close()
    if len(set(losses)) != 1:
        raise RuntimeError(f"the data-parallel replicas disagree: {losses}")
    return losses


def _dryrun_rank(n_devices: int) -> float:
    """One rank of :func:`dryrun_multichip`."""
    import numpy as np

    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    graph = build_model("resnet20_cifar10", width=8)
    rng = np.random.default_rng(0)
    batch = 2 * n_devices
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=batch).astype(np.int32)
    trainer = SPMDTrainer(graph, TrainConfig(
        epochs=1, batch_size=batch, learning_rate=1e-2,
        mesh_axes={"data": n_devices}, log_every=1, shuffle=False,
    ), device="cpu")
    variables = trainer.train(x, y)
    loss = trainer.history[0]["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    out = graph.apply(variables, torch.from_numpy(x[:n_devices]))
    if tuple(out.shape) != (n_devices, 10):
        raise RuntimeError(f"logits {tuple(out.shape)}")
    return float(loss)
