"""The port's CNN workflow (``mmlspark_tpu_torch/examples/e301``,
notebook 301) on the CPU, run through the port's harness (``python -m
mmlspark_tpu_torch --cpu-mesh 1 run <script>``, one process, one
intra-op thread): it passes within the JAX example's floor, its ``OK``
line has exactly the keys of the JAX example's under ``examples/``
(read with ``ast``), and its parameter count equals the JAX graph's
``param_count`` (no JAX training). The ResNet-20 trains from the port's
own ``torch.Generator`` draws, so its accuracy is held to the JAX
floor, not to JAX's number. It has a file of its own: its 80 training
steps take most of half a minute on one thread, the rest of the image
examples sit in ``tests/test_torch_examples_images.py``."""

from __future__ import annotations

import os

from mmlspark_tpu_torch.examples import harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_param_count(name: str, **config) -> int:
    """The JAX graph's ``param_count`` of its variables, from their
    shapes (``jax.eval_shape`` of ``init``: nothing is drawn)."""
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model

    graph = build_model(name, **config)
    shapes = jax.eval_shape(graph.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    return graph.param_count(shapes)


def test_cnn_eval_holds_the_jax_floor_and_parameter_count():
    """ResNet-20 (width 8) trained by ``SPMDTrainer``, then scored through
    ``TPUModel`` over a dataset: accuracy > 0.5, the JAX graph's
    parameter count, and one device (no process group)."""
    (path,) = harness.discover(["e301"], use_shard=False)
    started = harness.start_example(path, cpu=True)
    want_params = jax_param_count("resnet20_cifar10", width=8)
    run = harness.finish_example(started)
    assert run.ok, f"e301 failed after {run.seconds:.1f}s:\n" \
        f"{run.output[-4000:]}"
    jax_path = os.path.join(REPO, "examples", "e301_cifar10_cnn_eval.py")
    want, _ = harness.ok_fields(jax_path)
    got = run.result
    assert list(got) == list(want)
    assert got["accuracy"] > 0.5
    assert got["params"] == want_params
    assert got["devices"] == 1
