"""The port's table workflows (``mmlspark_tpu_torch/examples/e101``,
``e102``: notebooks 101 and 102; e103 is in
``tests/test_torch_examples_text.py``) on the CPU, each run through the
port's harness (``python -m mmlspark_tpu_torch --cpu-mesh 1 run <script>``, one
process, one intra-op thread; the two start together and overlap) and
held to its JAX twin under
``examples/``: it passes within the JAX example's own floors, and its
``OK`` line has exactly the keys of the JAX example's, read from the JAX
source with ``ast``.

e101 and e102 also run the JAX example's ``main()`` in-process on the
CPU (``runpy``), beside the port's process: their row and candidate
counts are equal, and their metrics agree within the recorded matrix's
``TOL`` (0.015) where a tree or naive-Bayes learner wins
``FindBestModel``, within ``NN_TOL`` (0.05) where an NN learner wins
(the port's NN learners start from ``torch.Generator`` draws, not
flax's)."""

from __future__ import annotations

import contextlib
import io
import os
import runpy
import signal

import pytest
import torch

from mmlspark_tpu_torch.examples import harness
from mmlspark_tpu_torch.testing.benchmark_metrics import NN_TOL, TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = os.path.join(REPO, "examples")
#: this module's examples and their rank processes (None: the harness's)
EXAMPLES = {"e101": None, "e102": None}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module (the JAX runs are in-process;
    the port's examples run in their own one-thread processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def jax_example(prefix: str) -> str:
    (name,) = [n for n in os.listdir(JAX_EXAMPLES)
               if n.startswith(prefix) and n.endswith(".py")]
    return os.path.join(JAX_EXAMPLES, name)


def check_against_jax_source(prefix: str, run: harness.Run) -> dict:
    """The port's run passed and its OK line has the JAX line's keys;
    returns the port's OK dict."""
    assert run.ok, f"{prefix} failed after {run.seconds:.1f}s:\n" \
        f"{run.output[-4000:]}"
    want, _ = harness.ok_fields(jax_example(prefix))
    assert list(run.result) == list(want)
    return run.result


def run_jax_main(prefix: str, monkeypatch):
    """The JAX example's ``main()`` in this process: its OK dict and the
    learner model that won its ``FindBestModel``."""
    import mmlspark_tpu.stages.find_best as jax_find_best

    fitted = []
    fit = jax_find_best.FindBestModel.fit
    monkeypatch.setattr(jax_find_best.FindBestModel, "fit",
                        lambda self, ds: fitted.append(fit(self, ds))
                        or fitted[-1])
    module = runpy.run_path(jax_example(prefix), run_name=f"jax_{prefix}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module["main"]()
    result, _ = harness.parse_output(out.getvalue())
    return result, fitted[-1].best_model.learner_model


def tolerance(learner_model) -> float:
    """TOL where a tree or naive-Bayes learner won, NN_TOL where an NN
    (a ``TPUModel`` scoring the features) won."""
    return NN_TOL if type(learner_model).__name__ == "TPUModel" else TOL


@pytest.mark.parametrize("prefix,metrics", [
    ("e101", ("accuracy", "AUC")),
    ("e102", ("R^2", "RMSE")),
])
def test_table_example_matches_the_jax_example(started, prefix, metrics,
                                               monkeypatch):
    """Notebooks 101 (``TrainClassifier`` x3 on the Titanic table,
    ``FindBestModel``, save/load, statistics) and 102
    (``TrainRegressor`` x3 on the CPU-performance table): the port's
    process and the JAX example in-process on the same data."""
    want, winner = run_jax_main(prefix, monkeypatch)
    got = check_against_jax_source(prefix,
                                   harness.finish_example(started[prefix]))
    assert (got["rows"], got["candidates"]) == \
        (want["rows"], want["candidates"])
    tol = tolerance(winner)
    for key in metrics:
        scale = max(1.0, abs(want[key])) if key == "RMSE" else 1.0
        assert abs(got[key] - want[key]) <= tol * scale, (key, got, want,
                                                          tol)


@pytest.mark.parametrize("name", ["titanic", "machine_cpu"])
def test_csv_tables_read_as_the_jax_reader(name):
    """The port's ``read_csv`` of e101's and e102's tables: the columns,
    dtypes, values and gaps equal the JAX package's read, and so does
    ``random_split``'s 3:1 cut."""
    import numpy as np

    from mmlspark_tpu.data.readers import read_csv as jax_read_csv
    from mmlspark_tpu_torch.data.readers import read_csv

    path = os.path.join(REPO, "tests", "fixtures", f"{name}.csv")
    want = jax_read_csv(path)
    got = read_csv(path)
    assert got.columns == want.columns and got.num_rows == want.num_rows
    for col in want.columns:
        a, b = np.asarray(got[col]), np.asarray(want[col])
        assert a.dtype == b.dtype, col
        if a.dtype == object:
            gaps = np.array([isinstance(v, float) for v in b])
            assert (np.array([isinstance(v, float) for v in a]) == gaps).all()
            assert list(a[~gaps]) == list(b[~gaps]), col
        else:
            np.testing.assert_array_equal(a, b, err_msg=col)
    cut = [len(part) for part in got.random_split(0.25, seed=0)]
    assert cut == [len(part) for part in want.random_split(0.25, seed=0)]
