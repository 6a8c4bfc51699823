"""The port's long-context and generation workflows
(``mmlspark_tpu_torch/examples/e306``, ``e307``) on the CPU through the
port's harness, the port's notebook tier (``notebooks/samples_torch/``,
generated by ``mmlspark_tpu_torch/tools/make_notebooks.py``) and the
harness's discovery.

e306 runs at ``--cpu-mesh 4``: four gloo rank processes, a data 1 x
seq 4 mesh (the JAX example's seq width on its 8 devices), one intra-op
thread each. e307 runs in one process. The two start together and
overlap. Each passes within the JAX
example's floors (asserted inside it: e307's cache == oracle, the period
followed 24 and 56 tokens long, the nucleus collapsed, loose filters
reproducing the unfiltered stream, ``beams=1`` == greedy, sorted
scores), and its ``OK`` line has exactly the JAX example's keys, read
from the JAX source with ``ast``. The values no random draw decides
equal the JAX example's: e306's ``seq_shards`` and
``window_ring_rounds`` (the JAX package's ``_ring_window_steps`` at the
same seq width), every value of e307's line. Both train from the port's
own ``torch.Generator`` draws and sample from a seeded
``torch.Generator``, so the losses and errors are held to the JAX floors,
not to JAX's numbers."""

from __future__ import annotations

import json
import os
import signal

import pytest

from mmlspark_tpu_torch.examples import harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "notebooks", "samples_torch")
JAX_EXAMPLES = os.path.join(REPO, "examples")
#: e306's rank processes here: data 1 x seq 4
E306_RANKS = 4
#: this module's examples and their rank processes (None: the harness's)
EXAMPLES = {"e306": E306_RANKS, "e307": None}


def port_example(prefix: str) -> str:
    (path,) = harness.discover([prefix], use_shard=False)
    return path


@pytest.fixture(scope="module")
def started():
    """The module's examples, started together at set-up, each in its own
    one-thread process, so that their runs overlap; each test waits for
    its own. A child no test waited for is stopped at tear-down."""
    children = {prefix: harness.start_example(port_example(prefix),
                                              cpu=True, ranks=ranks)
                for prefix, ranks in EXAMPLES.items()}
    yield children
    for child in children.values():
        if child.proc.poll() is None:
            os.killpg(child.proc.pid, signal.SIGKILL)
            child.proc.communicate()


def jax_fields(prefix: str) -> tuple[dict, set]:
    (name,) = [n for n in os.listdir(JAX_EXAMPLES)
               if n.startswith(prefix) and n.endswith(".py")]
    return harness.ok_fields(os.path.join(JAX_EXAMPLES, name))


def run_port(started: dict, prefix: str) -> dict:
    run = harness.finish_example(started[prefix])
    assert run.ok, f"{prefix} failed after {run.seconds:.1f}s:\n" \
        f"{run.output[-4000:]}"
    want, _ = jax_fields(prefix)
    assert list(run.result) == list(want)
    return run.result


def test_ring_attention_example_over_four_ranks(started):
    """The ring-attention LM trained over data x seq, ring == dense on
    the same weights, the windowed ring's live rounds, the
    sequence-parallel BiLSTM: losses fall, ring within 2e-2 of dense."""
    from mmlspark_tpu.parallel.context_parallel import _ring_window_steps

    got = run_port(started, "e306")
    seq, length = 4, 32  # e306's SEQ over the seq axis
    assert got["seq_shards"] == seq
    live = _ring_window_steps(seq, length // seq, length // 4, True)
    assert got["window_ring_rounds"] == f"{live}/{seq}"
    assert got["lm_loss_drop"] > 0 and got["bilstm_loss_drop"] > 0


def test_generation_example_equals_the_jax_line(started):
    """Greedy, windowed, nucleus and beam decoding over the overfit LMs:
    the port's OK line is the JAX source's, value for value."""
    got = run_port(started, "e307")
    want, unfixed = jax_fields("e307")
    assert not unfixed
    assert got == want


def _cells(path):
    with open(path, encoding="utf-8") as f:
        nb = json.load(f)
    return [("".join(c["source"]), c["cell_type"]) for c in nb["cells"]]


def test_committed_notebooks_match_scripts(tmp_path):
    """The committed ``notebooks/samples_torch/`` are what the port's
    generator writes from the port's examples (cell sources and kinds,
    as ``tests/test_notebooks.py`` holds the JAX tier)."""
    from mmlspark_tpu_torch.tools import make_notebooks

    written = make_notebooks.main(str(tmp_path))
    assert len(written) == len(make_notebooks.TITLES) == 12
    assert sorted(written) == sorted(os.listdir(SAMPLES))
    for name in written:
        assert _cells(os.path.join(SAMPLES, name)) == \
            _cells(str(tmp_path / name)), (
            f"{name} drifted — regenerate with python -m "
            "mmlspark_tpu_torch.tools.make_notebooks")


def test_notebook_titles_are_the_jax_tiers():
    """The port's notebooks carry the JAX tier's titles (read from
    ``tools/make_notebooks.py`` with ``ast``)."""
    import ast

    from mmlspark_tpu_torch.tools import make_notebooks

    path = os.path.join(REPO, "tools", "make_notebooks.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    (titles,) = [ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "TITLES"]
    assert make_notebooks.TITLES == titles


def test_harness_discovers_and_shards(monkeypatch):
    """Twelve examples, ``PROC_SHARD=i/m`` takes every m-th from i, a
    prefix selects one; e306 alone spans ranks on the CPU."""
    names = [os.path.basename(p) for p in harness.discover([], False)]
    jax_names = sorted(n for n in os.listdir(JAX_EXAMPLES)
                       if n.startswith("e") and n.endswith(".py"))
    assert names == jax_names
    monkeypatch.setenv("PROC_SHARD", "1/3")
    assert harness.discover([]) == harness.discover([], False)[1::3]
    monkeypatch.delenv("PROC_SHARD")
    (only,) = harness.discover(["e301"])
    assert os.path.basename(only).startswith("e301")
    assert [harness.cpu_ranks(p) for p in harness.discover([])] == \
        [8 if n.startswith("e306") else 1 for n in names]
    assert "--cpu-mesh" not in harness.command(only)
    assert harness.command(only, cpu=True)[-4:] == \
        ["--cpu-mesh", "1", "run", only]


@pytest.mark.parametrize("prefix", ["e101", "e303", "e305"])
def test_examples_find_the_repo_data_from_the_package(prefix):
    """The examples sit two levels under the repo: their fixture and zoo
    paths resolve to the committed files."""
    import runpy

    module = runpy.run_path(port_example(prefix), run_name="probe")
    path = module.get("FIXTURE") or module["ZOO"]
    assert os.path.exists(path), path
