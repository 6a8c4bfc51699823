"""The port's entry point (``mmlspark_tpu_torch/entry.py``, the twin of
``__graft_entry__.py``), the ``-m`` launcher in a fresh process, the
topology view, the profiling re-exports and ``overfit_periodic_lm``,
against the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
#: the bf16 ResNet forward against JAX's (tests/test_torch_cnn.py)
BF16_REL_TOL = 3e-2


@pytest.fixture(autouse=True)
def _one_thread():
    # small tensors: one intra-op thread leaves the cores to other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _seeded_jax_init():
    """The JAX package's ``NamedGraph.init`` replaced, for this module, by
    ``jax.eval_shape`` of it with seeded values (kernels N(0, 1/fan_in),
    scales and variances 1, biases and means 0): the JAX side's eager
    init is most of its demos' and its entry's time on the CPU, and no
    test here depends on init's own draws."""
    import jax

    from mmlspark_tpu.models.graph import NamedGraph

    init = NamedGraph.init
    rng = np.random.default_rng(0)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key in ("scale", "var"):
            return np.ones(node.shape, np.float32)
        if key in ("bias", "mean"):
            return np.zeros(node.shape, np.float32)
        fan_in = int(np.prod(node.shape[:-1])) or 1
        return rng.normal(0, fan_in ** -0.5, node.shape).astype(np.float32)

    def seeded_init(self, key, sample):
        return walk(jax.eval_shape(lambda k, x: init(self, k, x), key,
                                   sample))

    mp = pytest.MonkeyPatch()
    mp.setattr(NamedGraph, "init", seeded_init)
    yield
    mp.undo()


def test_topology_functions():
    from mmlspark_tpu_torch.core import env

    assert env.process_count() == 1
    assert env.local_device_count() == torch.cuda.device_count()
    assert env.device_count() == env.local_device_count()
    assert env.backend() == ("gpu" if torch.cuda.is_available() else "cpu")
    topo = env.topology("cpu")
    assert (topo.platform, topo.num_devices, topo.device_kind) == \
        ("cpu", 1, "cpu")


def test_module_entry_in_a_fresh_process():
    out = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch", "--cpu-mesh", "1",
         "env"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["platform"] == "cpu"


def test_entry_matches_jax_graft_entry():
    """``entry()``'s forward on the JAX entry's variables, bridged,
    against the JAX forward on a seeded batch; the example is the JAX
    one's shape, on the device asked for."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(REPO))
    try:
        from __graft_entry__ import entry as jax_entry
    finally:
        sys.path.remove(str(REPO))
    from mmlspark_tpu_torch.entry import entry
    from mmlspark_tpu_torch.models import build_model, load_flax_variables

    forward, (variables, example_x) = entry(device="cpu")
    jax_forward, (jax_variables, jax_x) = jax_entry()
    assert tuple(example_x.shape) == jax_x.shape
    assert example_x.dtype == torch.float32 and example_x.device.type == "cpu"
    assert tuple(forward(variables, example_x).shape) == (128, 10)
    x = np.random.default_rng(3).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    bridged = load_flax_variables(build_model("resnet20_cifar10"),
                                  jax_variables, device="cpu")
    got = forward(bridged, torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_forward)(jax_variables, jnp.asarray(x)))
    # both compute in bf16: tests/test_torch_cnn.py's bound
    assert np.abs(got - want).max() <= BF16_REL_TOL * np.abs(want).max()


def test_profiling_reexports():
    """One observability import, as in the JAX package: every name the
    JAX module re-exports, from the port's core modules (the port costs
    programs with ``analyze_program_cost`` where JAX has
    ``analyze_jit_cost``)."""
    import mmlspark_tpu.utils.profiling as jax_profiling
    import mmlspark_tpu_torch.core.perf as perf
    import mmlspark_tpu_torch.core.telemetry as telemetry
    import mmlspark_tpu_torch.utils.profiling as profiling

    names = [n for n in dir(jax_profiling)
             if getattr(getattr(jax_profiling, n), "__module__", "")
             in ("mmlspark_tpu.core.perf", "mmlspark_tpu.core.telemetry")]
    assert len(names) == 19
    for name in names:
        port_name = "analyze_program_cost" if name == "analyze_jit_cost" \
            else name
        obj = getattr(profiling, port_name)
        assert obj is getattr(perf, port_name, None) or \
            obj is getattr(telemetry, port_name, None), name
    assert callable(profiling.trace_profile) and callable(profiling.annotate)


def test_overfit_periodic_lm_continues_the_period():
    """The JAX recipe in plain torch: the same ids, a loss that falls to
    memorisation, and a greedy continuation of the period."""
    from mmlspark_tpu.testing.datagen import overfit_periodic_lm as jax_fit
    from mmlspark_tpu_torch.models import build_model, generate
    from mmlspark_tpu_torch.testing.datagen import overfit_periodic_lm

    graph = build_model("transformer_lm", vocab_size=8, d_model=32,
                        heads=2, depth=2, max_len=32, attn_impl="dense")
    variables, ids = overfit_periodic_lm(graph, device="cpu")
    assert ids.dtype == torch.int64 and ids.device.type == "cpu"
    assert ids.tolist() == [[1, 2, 3, 4] * 4]
    import inspect

    assert list(inspect.signature(jax_fit).parameters) == \
        list(inspect.signature(overfit_periodic_lm).parameters)[:5]
    out = generate(graph, variables, ids[:, :7], 9, device="cpu")
    assert out[0].tolist() == [1, 2, 3, 4] * 4
