"""A standing pool of CPU ranks over gloo, for tests of the parallel layer.

The JAX package tests its meshes on one process with eight virtual CPU
devices; PyTorch has no such device, so a mesh on the CPU needs real
processes. :class:`RankPool` starts ``world_size`` worker processes once,
each one rank of a gloo process group with one intra-op thread, and
:meth:`RankPool.run` runs a module-level function on every rank and
returns the per-rank results — so a test file pays for the start-up once
and every case reuses the group::

    pool = RankPool(4)
    try:
        outs = pool.run(my_case, q, k, v)   # my_case(q, k, v) on 4 ranks
        pending = pool.submit(my_case, q, k, v)
        ...                                 # work here meanwhile
        outs = pending.result()
    finally:
        pool.close()

The function is sent by its source file and name and loaded in each
worker from that file (not run as ``__main__``), so it may live in a test
module whose other imports happen inside its functions. Arguments and
results travel pickled; an exception on a rank comes back as a
:class:`RuntimeError` carrying its traceback. Every wait has a time
limit: a rank that hangs fails the call with :class:`TimeoutError`
naming the function, and the pool is closed.

Run as a module (``python -m mmlspark_tpu_torch.testing.rank_pool``) it
is the worker.
"""

from __future__ import annotations

import importlib.util
import inspect
import os
import secrets
import subprocess
import sys
import traceback

_READY = "ready"


class RankPool:
    """``world_size`` gloo ranks on the CPU, started once."""

    def __init__(self, world_size: int = 4, timeout: float = 120.0):
        from datetime import timedelta

        import torch.distributed as dist

        self.world_size = world_size
        self.timeout = timeout
        self._conns: list = []
        authkey = secrets.token_bytes(16)
        # the group's rendezvous store lives here, on a port the OS picks;
        # each rank also publishes there the address it takes tasks on
        self._store = dist.TCPStore("127.0.0.1", 0, world_size + 1,
                                    is_master=True, wait_for_workers=False,
                                    timeout=timedelta(seconds=timeout))
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="", RANK_POOL_AUTHKEY=authkey.hex(),
                   PYTHONPATH=os.pathsep.join(
                       [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
        self._procs = [
            subprocess.Popen(
                [sys.executable, "-m", "mmlspark_tpu_torch.testing.rank_pool",
                 str(self._store.port), str(rank), str(world_size)],
                env=env, stdin=subprocess.DEVNULL,
            )
            for rank in range(world_size)
        ]
        try:
            self._connect(authkey)
        except BaseException:
            self.close()
            raise

    def _connect(self, authkey: bytes) -> None:
        from datetime import timedelta
        from multiprocessing.connection import Client

        keys = [f"rank_pool/{rank}" for rank in range(self.world_size)]
        try:
            self._store.wait(keys, timedelta(seconds=self.timeout))
        except Exception as e:  # the store's own timeout error
            raise TimeoutError(
                f"RankPool: not every rank started within {self.timeout} s "
                f"({e})") from None
        for key in keys:
            port = int(self._store.get(key))
            self._conns.append(Client(("127.0.0.1", port), authkey=authkey))
        for rank, conn in enumerate(self._conns):
            if self._recv(conn, "the process group") != _READY:
                raise RuntimeError(f"RankPool: rank {rank} failed to start")

    def _recv(self, conn, what: str):
        if not conn.poll(self.timeout):
            self.close()
            raise TimeoutError(
                f"RankPool: no answer for {what} within {self.timeout} s")
        try:
            status, value = conn.recv()
        except EOFError:
            self.close()
            raise RuntimeError(
                f"RankPool: a rank exited during {what}") from None
        if status == "err":
            raise RuntimeError(f"RankPool: {what} failed on a rank:\n{value}")
        return value

    def submit(self, fn, *args, **kwargs) -> "_Pending":
        """Start ``fn(*args, **kwargs)`` on every rank and return at once;
        ``.result()`` of the returned handle waits for the per-rank
        results (so the caller can compute meanwhile)."""
        path = inspect.getsourcefile(fn)
        for conn in self._conns:
            conn.send((path, fn.__name__, args, kwargs))
        return _Pending(self, f"{fn.__name__} ({os.path.basename(path)})")

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results in rank
        order."""
        return self.submit(fn, *args, **kwargs).result()

    def _collect(self, what: str) -> list:
        results, errors = [], []
        for conn in self._conns:
            try:
                results.append(self._recv(conn, what))
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError(errors[0])
        return results

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for proc in self._procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []


class _Pending:
    """A call running on every rank of a :class:`RankPool`."""

    def __init__(self, pool: RankPool, what: str):
        self._pool, self._what = pool, what

    def result(self) -> list:
        return self._pool._collect(self._what)


def _load(path: str, cache: dict):
    if path not in cache:
        name = f"_rank_pool_{len(cache)}"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        cache[path] = module
    return cache[path]


def _worker(store_port: int, rank: int, world_size: int) -> None:
    from datetime import timedelta
    from multiprocessing.connection import Listener

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", store_port, world_size + 1,
                          is_master=False)
    listener = Listener(("127.0.0.1", 0),
                        authkey=bytes.fromhex(os.environ["RANK_POOL_AUTHKEY"]))
    store.set(f"rank_pool/{rank}", str(listener.address[1]))
    conn = listener.accept()
    listener.close()
    try:
        # a collective that one rank never joins fails in a minute
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=60))
        conn.send(("ok", _READY))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    modules: dict = {}
    while True:
        task = conn.recv()
        if task is None:
            break
        path, name, args, kwargs = task
        try:
            out = getattr(_load(path, modules), name)(*args, **kwargs)
            conn.send(("ok", out))
        except BaseException:
            conn.send(("err", f"rank {rank}: {traceback.format_exc()}"))
    dist.destroy_process_group()
    conn.close()
    os._exit(0)  # skip the interpreter's teardown of torch


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
