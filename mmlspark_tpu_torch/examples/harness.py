"""Run every example headless with a per-script timeout — the port of
``examples/harness.py``, the analog of the reference's notebook test
runner (tools/notebook/tester/NotebookTestSuite.py: nbconvert
ExecutePreprocessor(timeout=600) per notebook, PROC_SHARD=i/m sharding at
TestNotebooksLocally.py:46-52).

Usage:
    python -m mmlspark_tpu_torch.examples.harness            # all, on the card
    python -m mmlspark_tpu_torch.examples.harness --cpu      # all, on the CPU
    PROC_SHARD=0/2 python -m mmlspark_tpu_torch.examples.harness  # shard 0 of 2
    python -m mmlspark_tpu_torch.examples.harness e301 e304  # by prefix

Each script runs in its own process through the port's entry point,
``python -m mmlspark_tpu_torch [--cpu-mesh N] run <script>``, so a crash
or hang in one cannot take down the runner, exactly like the reference's
per-notebook subprocesses. On the card (the default) no ``--cpu-mesh`` is
given. With ``--cpu`` each script gets ``--cpu-mesh N`` with N from
:data:`CPU_RANKS` (the JAX harness's 8 virtual CPU devices become 8 gloo
rank processes where an example spans a mesh), every process on one
intra-op thread. After the script's output the child prints one more
line, ``LAUNCHES {...}``: every kernel launch counter of the port
(``ops/flash_attention.py``'s and ``ops/fused_optim.py``'s), read after
the script ran.
"""

from __future__ import annotations

import ast
import json
import os
import re
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field

TIMEOUT_S = 600  # NotebookTestSuite.py:13
#: rank processes an example gets on the CPU (``--cpu-mesh N``); 1 for
#: every example not named. e306 spans a data x seq mesh: 8 ranks are
#: the JAX harness's 8 virtual devices (data 2 x seq 4)
CPU_RANKS = {"e306": 8}

#: the child: the port's entry point as ``python -m mmlspark_tpu_torch``,
#: then the launch counters on a line of their own
BOOT = r"""
import json, runpy, sys
argv = sys.argv[1:]
if "--cpu-mesh" in argv:
    import torch
    torch.set_num_threads(1)
sys.argv = ["mmlspark_tpu_torch", *argv]
code = 0
try:
    runpy.run_module("mmlspark_tpu_torch", run_name="__main__",
                     alter_sys=True)
except SystemExit as exc:
    code = exc.code
from mmlspark_tpu_torch.ops import flash_attention, fused_optim
counts = {c: getattr(flash_attention, c) for c in flash_attention.COUNTERS}
counts["fused_optim_launches"] = fused_optim.launches
sys.stdout.flush()
print("LAUNCHES " + json.dumps(counts), flush=True)
sys.exit(code)
"""


@dataclass
class Run:
    """One example's run: whether it passed, its wall seconds, its last
    line (the ``OK {...}`` line on success, the last error line on
    failure), the ``OK`` dict, the launch counters and the output."""

    ok: bool
    seconds: float
    detail: str
    result: dict | None = None
    launches: dict = field(default_factory=dict)
    output: str = ""


def discover(selectors: list[str], use_shard: bool = True) -> list[str]:
    root = os.path.dirname(os.path.abspath(__file__))
    names = sorted(
        f for f in os.listdir(root)
        if f.startswith("e") and f.endswith(".py")
    )
    if selectors:
        names = [
            n for n in names if any(n.startswith(s) for s in selectors)
        ]
    shard = os.environ.get("PROC_SHARD") if use_shard else None
    if shard:
        i, m = (int(p) for p in shard.split("/"))
        names = [n for k, n in enumerate(names) if k % m == i]
    return [os.path.join(root, n) for n in names]


def cpu_ranks(path: str) -> int:
    """The rank processes ``path``'s example gets on the CPU."""
    return CPU_RANKS.get(os.path.basename(path)[:4], 1)


def command(path: str, cpu: bool = False, ranks: int | None = None) -> list:
    """The child's command line: on the card, or (``cpu``) on ``ranks``
    CPU rank processes (default :func:`cpu_ranks`)."""
    mesh = []
    if cpu:
        mesh = ["--cpu-mesh", str(ranks or cpu_ranks(path))]
    return [sys.executable, "-c", BOOT, *mesh, "run", path]


def parse_output(stdout: str) -> tuple[dict | None, dict]:
    """The script's ``OK {...}`` dict (None when it printed none) and the
    child's ``LAUNCHES`` dict."""
    result, launches = None, {}
    for line in stdout.splitlines():
        if line.startswith("OK {"):
            result = ast.literal_eval(line[3:])
        elif line.startswith("LAUNCHES {"):
            launches = json.loads(line[len("LAUNCHES "):])
    return result, launches


@dataclass
class Started:
    """A child that :func:`start_example` started."""

    proc: subprocess.Popen
    t0: float


def start_example(path: str, cpu: bool = False,
                  ranks: int | None = None) -> Started:
    """Start one example in its own process group (see :func:`command`);
    :func:`finish_example` waits for it."""
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(path))))
    env["PYTHONPATH"] = (
        repo_root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH") else repo_root
    )
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        command(path, cpu, ranks), env=env, stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return Started(proc, time.time())


def finish_example(started: Started) -> Run:
    """Wait for a started example under :data:`TIMEOUT_S` from its start;
    on a timeout every process of its group is stopped."""
    proc = started.proc
    left = max(TIMEOUT_S - (time.time() - started.t0), 1.0)
    try:
        out, err = proc.communicate(timeout=left)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return Run(False, time.time() - started.t0,
                   f"TIMEOUT after {TIMEOUT_S}s", output=out + err)
    finally:
        try:  # rank processes the child left behind
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    seconds = time.time() - started.t0
    result, launches = parse_output(out)
    ok = proc.returncode == 0 and result is not None
    # on success surface the script's headline OK line; on failure the
    # last error line
    lines = [ln for ln in (out if ok else out + err).splitlines()
             if ln.strip() and not ln.startswith("LAUNCHES {")]
    heads = [ln for ln in lines if ln.startswith("OK {")]
    detail = heads[-1] if ok else (lines[-1] if lines else "")
    return Run(ok, seconds, detail, result, launches, out + err)


def run_example(path: str, cpu: bool = False,
                ranks: int | None = None) -> Run:
    """Run one example (:func:`start_example`, :func:`finish_example`)."""
    return finish_example(start_example(path, cpu, ranks))


def ok_fields(path: str) -> tuple[dict, set]:
    """The ``OK {...}`` line an example's source prints, read with ``ast``
    without running it: the dict, and the keys whose values the source
    does not fix (a value computed at run time reads 0 there). A value
    is fixed when it is a literal, or an expression over names the
    source binds to literals (``LONG = 40``)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    consts = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "print" and node.args and
                isinstance(node.args[0], ast.JoinedStr)):
            continue
        parts = node.args[0].values
        if not (parts and isinstance(parts[0], ast.Constant) and
                str(parts[0].value).startswith("OK {")):
            continue
        text, unfixed = "", set()
        for part in parts:
            if isinstance(part, ast.Constant):
                text += str(part.value)
                continue
            key = re.findall(r"'([^']+)':", text)[-1]
            try:
                text += eval(  # noqa: S307 - literals of the source only
                    compile(ast.fix_missing_locations(ast.Expression(
                        ast.JoinedStr([part]))), path, "eval"),
                    {"__builtins__": {}}, dict(consts))
            except Exception:  # a value computed at run time
                text += "0"
                unfixed.add(key)
        return ast.literal_eval(text[3:]), unfixed
    raise ValueError(f"{path} prints no OK line")


def run_one(path: str, cpu: bool = False,
            ranks: int | None = None) -> tuple[bool, float, str]:
    """``(ok, seconds, detail)``, as ``examples/harness.py`` returns."""
    run = run_example(path, cpu, ranks)
    return run.ok, run.seconds, run.detail


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in args
    paths = discover([a for a in args if a != "--cpu"])
    if not paths:
        print("no examples matched")
        return 2
    failures = 0
    for path in paths:
        name = os.path.basename(path)
        ok, dt, detail = run_one(path, cpu)
        status = "PASS" if ok else "FAIL"
        print(f"{status} {name} ({dt:.1f}s) {detail}", flush=True)
        failures += 0 if ok else 1
    print(f"{len(paths) - failures}/{len(paths)} examples passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
