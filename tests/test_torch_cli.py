"""The port's launcher (``python -m mmlspark_tpu_torch``) against the JAX
package's, mirroring ``tests/test_cli.py``. The commands run in-process
through ``main(argv)`` (``tests/test_torch_entry.py`` runs the ``-m``
entry in a fresh process), on the CPU with ``--cpu-mesh 1``: the port's
commands run on the card otherwise. ``--cpu-mesh N`` with N > 1 starts N
gloo rank processes.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.__main__ import main
from mmlspark_tpu_torch.core.exceptions import FriendlyError

REPO = Path(__file__).resolve().parents[1]
#: keys only the port's demos report: the device they ran on, the serve
#: run's stream digest, and the trainer's captured-step program counter
#: and capture seconds
PORT_ONLY_SERVE_KEYS = {"device", "stream_digest"}
PORT_ONLY_TRAIN_KEYS = {"retrace.train.step", "train.step_capture_s"}


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


def _cli(capsys, *argv) -> str:
    assert main(list(argv)) == 0
    return capsys.readouterr().out


def _jax_cli(capsys, monkeypatch, *argv) -> str:
    from mmlspark_tpu.__main__ import main as jax_main

    # the JAX launcher edits the backend environment; keep it to the test
    for var in ("JAX_PLATFORMS", "XLA_FLAGS"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    assert jax_main(list(argv)) == 0
    return capsys.readouterr().out


def test_env_on_cpu_mesh(capsys):
    from mmlspark_tpu.core import env as jax_env

    info = json.loads(_cli(capsys, "--cpu-mesh", "1", "env"))
    assert info == {"num_devices": 1, "num_local_devices": 1,
                    "num_processes": 1, "platform": "cpu",
                    "device_kind": "cpu", "host_os": info["host_os"]}
    assert info.keys() == jax_env.describe().keys()
    # N > 1: N gloo rank processes, rank 0's view printed (JAX's N
    # virtual CPU devices of one process are N ranks here)
    info = json.loads(_cli(capsys, "--cpu-mesh", "4", "env"))
    assert info.keys() == jax_env.describe().keys()
    assert (info["num_devices"], info["num_processes"]) == (4, 4)
    if not torch.cuda.is_available():
        # no card and no --cpu-mesh: no quiet fall back to the host
        with pytest.raises(FriendlyError, match="no CUDA device"):
            main(["env"])


def test_config_listing(capsys, monkeypatch):
    conf = json.loads(_cli(capsys, "config"))
    assert conf["native_cc"]["value"] == "c++"
    assert "doc" in conf["cache_dir"]
    want = json.loads(_jax_cli(capsys, monkeypatch, "config"))
    assert conf.keys() == want.keys()


def test_run_script(tmp_path, capsys, monkeypatch):
    script = tmp_path / "user.py"
    script.write_text(
        "import os, sys\n"
        "from mmlspark_tpu_torch.data.dataset import Dataset\n"
        "ds = Dataset({'a': [1.0, 2.0]})\n"
        "print('rows', ds.num_rows, 'argv', sys.argv[1:],\n"
        "      'cards', repr(os.environ['CUDA_VISIBLE_DEVICES']))\n"
    )
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES",
                       os.environ.get("CUDA_VISIBLE_DEVICES", "0"))
    out = _cli(capsys, "--cpu-mesh", "1", "run", str(script), "--flag", "x")
    assert "rows 2 argv ['--flag', 'x'] cards ''" in out


def test_run_script_names_no_device_under_cpu_mesh(tmp_path, capsys,
                                                   monkeypatch):
    """A script that names no device runs on the CPU under ``--cpu-mesh
    1 run`` (``core.env.process_default``), and the card is the default
    again once the script has run."""
    from mmlspark_tpu_torch.core import env

    script = tmp_path / "user.py"
    script.write_text(
        "from mmlspark_tpu_torch.core.env import default_device\n"
        "from mmlspark_tpu_torch.models import build_model, "
        "init_variables\n"
        "v = init_variables(build_model('bilstm_tagger', vocab_size=8, "
        "embed_dim=4, hidden=4, num_tags=2), 0)\n"
        "print('device', default_device(), next(iter(next(iter("
        "v.values())).values())).device)\n")
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES",
                       os.environ.get("CUDA_VISIBLE_DEVICES", "0"))
    out = _cli(capsys, "--cpu-mesh", "1", "run", str(script))
    assert "device cpu cpu" in out
    assert env._process_default == "cuda"
    with env.process_default("cpu"):
        assert env.default_device() == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(FriendlyError, match="no CUDA device"):
            env.default_device()


def test_zoo_list_and_download(tmp_path, capsys):
    repo = ["--local-repo", str(tmp_path / "repo"),
            "--remote", str(REPO / "models" / "zoo_repo")]
    assert "ResNet20_Blobs" in _cli(capsys, "zoo", "list", *repo)
    out = _cli(capsys, "zoo", "download", "ResNet20_Blobs", *repo)
    assert "ResNet20_Blobs ->" in out
    with pytest.raises(SystemExit):
        main(["zoo", "download"])


def test_multihost_env_contract(monkeypatch):
    """``torchrun``'s variables reach ``init_process_group``; gloo only
    when the caller asks for the CPU, NCCL otherwise."""
    import torch.distributed as dist

    import mmlspark_tpu_torch.parallel.mesh as mesh

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh.initialize_distributed(device="cpu")  # nothing set: a no-op
    assert calls == []
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "8476")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    mesh.initialize_distributed(device="cpu")
    assert calls == [("gloo", {"init_method": "tcp://10.0.0.1:8476",
                               "world_size": 4, "rank": 2})]
    if not torch.cuda.is_available():
        with pytest.raises(FriendlyError, match="no CUDA device"):
            mesh.initialize_distributed()
    monkeypatch.delenv("RANK")
    with pytest.raises(FriendlyError, match="RANK"):
        mesh.initialize_distributed(device="cpu")


@pytest.mark.parametrize("argv", [["bench"]])
def test_jax_scripts_raise_naming_item_20(argv):
    # evidence and docgen run over the port (tests/test_torch_evidence.py,
    # tests/test_torch_docgen.py); bench waits for the first benchmark PR
    with pytest.raises(FriendlyError, match="item 20.*first benchmark"):
        main(argv)


def test_serve_json_matches_jax_keys(capsys, monkeypatch):
    args = ("serve", "--requests", "2", "--max-new-tokens", "2", "--slots",
            "2", "--decode-block", "2")
    got = json.loads(_cli(capsys, "--cpu-mesh", "1", *args).splitlines()[-1])
    want = json.loads(_jax_cli(capsys, monkeypatch, *args).splitlines()[-1])
    assert got.keys() == want.keys() | PORT_ONLY_SERVE_KEYS
    assert got["completed"] == want["completed"] == 2
    assert got["tokens_generated"] == want["tokens_generated"] == 4


def test_serve_mesh_streams_match_one_device(capsys):
    """``serve --mesh data=2,model=2`` over 4 gloo rank processes: one
    JSON line (rank 0's), the mesh topology, and every request's token
    stream (``stream_digest``) equal to the one-device run's."""
    args = ("serve", "--requests", "4", "--max-new-tokens", "4", "--slots",
            "4", "--decode-block", "2")
    single = json.loads(_cli(capsys, "--cpu-mesh", "1", *args)
                        .splitlines()[-1])
    meshed = _cli(capsys, "--cpu-mesh", "4", *args, "--mesh",
                  "data=2,model=2").splitlines()
    assert len(meshed) == 1
    got = json.loads(meshed[0])
    assert got["mesh_shape"] == {"data": 2, "model": 2}
    assert got["mesh_devices"] == 4 and single["mesh_devices"] == 1
    assert got["completed"] == single["completed"] == 4
    assert got["stream_digest"] == single["stream_digest"]


def test_train_json_matches_jax_keys(capsys, monkeypatch, tmp_path):
    args = ("train", "--epochs", "1", "--samples", "32", "--batch-size",
            "32")
    got = json.loads(_cli(capsys, "--cpu-mesh", "1", *args,
                          "--checkpoint-dir", str(tmp_path / "p"))
                     .splitlines()[-1])
    want = json.loads(_jax_cli(capsys, monkeypatch, *args,
                               "--checkpoint-dir", str(tmp_path / "j"))
                      .splitlines()[-1])
    assert got.keys() == want.keys() | PORT_ONLY_TRAIN_KEYS
    # train --mesh over two gloo rank processes: the same keys, one line
    meshed = _cli(capsys, "--cpu-mesh", "2", *args, "--mesh", "data=2",
                  "--checkpoint-dir", str(tmp_path / "m")).splitlines()
    assert len(meshed) == 1
    assert json.loads(meshed[0]).keys() == got.keys()
