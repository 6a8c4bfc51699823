"""The port's public surface against the JAX package's: for every module
of ``mmlspark_tpu`` its counterpart under ``mmlspark_tpu_torch`` has each
public module-level name the JAX module defines (a package's
``__init__`` also its re-exports from the package), and each class both
define has the JAX class's public methods — but for the JAX-only names
of :data:`JAX_ONLY`, each with its reason.

Names a JAX module imports from another library (``jax``, ``jnp``,
``P``, ``nn``, ``np``, ...) or from another of its own modules are not
its public surface and are not compared; a compat shim it defines for a
JAX API (``shard_map``) is, and stands in the allowlist."""

from __future__ import annotations

import ast
import importlib
import inspect
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = "mmlspark_tpu"
PORT_PKG = "mmlspark_tpu_torch"

_PROGRAMS = ("the port's programs are CUDA graphs: "
             "testing/compile_guard.ProgramCountingGraph counts them and "
             "program_count reads the count")
_SHARDING = ("a jax.sharding placement of the pool's arrays; the port's "
             "pools place each shard on its rank (local_row, MeshPlace)")
_FLAX_INIT = ("flax's init(rng, sample); the port draws seeded weights "
              "with models.init_variables(graph, seed, device)")
#: (JAX module, name or Class.method) -> why the port has no such name
JAX_ONLY = {
    ("mmlspark_tpu.core.env", "is_tpu"):
        "asks JAX's backend for TPU silicon; the port asks has_cuda() and "
        "runs on the card unless told otherwise",
    ("mmlspark_tpu.core.perf", "analyze_jit_cost"):
        "asks XLA's cost model of a jitted program; the port's "
        "analyze_program_cost counts an eager body on meta tensors",
    ("mmlspark_tpu.ops.flash_attention", "LANES"):
        "the TPU vector register's lane width, a Pallas tiling constant; "
        "the Hopper kernels tile by their own (csrc/)",
    ("mmlspark_tpu.ops.flash_attention", "SUBLANES"):
        "the TPU vector register's sublane count, as LANES",
    ("mmlspark_tpu.parallel.mesh", "shard_map"):
        "a compat shim over jax's shard_map; the port's collectives are "
        "torch.distributed calls on each rank",
    ("mmlspark_tpu.parallel.mesh", "pcast_varying"):
        "a compat shim for shard_map's varying-axis casts, as shard_map",
    ("mmlspark_tpu.testing", "jit_cache_size"): _PROGRAMS,
    ("mmlspark_tpu.testing.compile_guard", "jit_cache_size"): _PROGRAMS,
    ("mmlspark_tpu.testing.compile_guard", "ProgramCountingJit"): _PROGRAMS,
    ("mmlspark_tpu.models", "NamedGraph.init"): _FLAX_INIT,
    ("mmlspark_tpu.models.graph", "NamedGraph.init"): _FLAX_INIT,
    ("mmlspark_tpu.models.pipelined", "PipelinedGraph.init"): _FLAX_INIT,
    ("mmlspark_tpu.serve", "SlotCachePool.kv_shardings"): _SHARDING,
    ("mmlspark_tpu.serve", "SlotCachePool.slot_sharding"): _SHARDING,
    ("mmlspark_tpu.serve.cache_pool", "SlotCachePool.kv_shardings"):
        _SHARDING,
    ("mmlspark_tpu.serve.cache_pool", "SlotCachePool.slot_sharding"):
        _SHARDING,
    ("mmlspark_tpu.serve.paging", "PagedCachePool.kv_shardings"): _SHARDING,
    ("mmlspark_tpu.serve.paging", "PagedCachePool.slot_sharding"):
        _SHARDING,
}


def _jax_modules() -> list[str]:
    """Every module of the JAX package, from its files (no import at
    collection, so every worker collects the same tests)."""
    root = REPO / JAX_PKG
    names = []
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _defined(module) -> set[str]:
    """The public names ``module``'s source binds at top level (and, in
    a package's ``__init__``, imports from its own package)."""
    path = Path(module.__file__)
    is_pkg = path.name == "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif is_pkg and isinstance(node, ast.ImportFrom) and (
                node.level or (node.module or "").startswith(JAX_PKG)):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _methods(cls) -> set[str]:
    """The public methods and properties the JAX package's own classes in
    ``cls``'s MRO define (not flax's or other libraries')."""
    out = set()
    for klass in inspect.getmro(cls):
        if not klass.__module__.startswith(JAX_PKG + "."):
            continue
        for name, value in vars(klass).items():
            if not name.startswith("_") and isinstance(
                    value, (types.FunctionType, classmethod, staticmethod,
                            property)):
                out.add(name)
    return out


def _gaps(jax_name: str) -> set[str]:
    jax_mod = importlib.import_module(jax_name)
    port_mod = importlib.import_module(
        PORT_PKG + jax_name[len(JAX_PKG):])
    gaps = set()
    for name in _defined(jax_mod):
        if not hasattr(port_mod, name):
            gaps.add(name)
            continue
        ours, theirs = getattr(port_mod, name), getattr(jax_mod, name, None)
        if isinstance(ours, type) and isinstance(theirs, type):
            gaps.update(f"{name}.{m}" for m in _methods(theirs)
                        if not hasattr(ours, m))
    return gaps


@pytest.mark.parametrize("jax_name", _jax_modules())
def test_port_module_has_the_jax_modules_public_names(jax_name):
    allowed = {name for (mod, name) in JAX_ONLY if mod == jax_name}
    gaps = _gaps(jax_name)
    assert gaps <= allowed, (
        f"{jax_name}: public names the port lacks: {sorted(gaps - allowed)}"
        " (port them, or add each to JAX_ONLY with its reason)")
    # an entry whose name the port has since gained is stale
    assert allowed <= gaps, f"stale JAX_ONLY entries: {allowed - gaps}"


def test_allowlist_names_real_jax_modules_with_reasons():
    modules = set(_jax_modules())
    for (mod, name), why in JAX_ONLY.items():
        assert mod in modules and name and len(why) > 20, (mod, name)


def test_root_re_exports_and_all_stages_match_jax():
    import mmlspark_tpu
    import mmlspark_tpu_torch

    for name in ("Estimator", "Model", "Pipeline", "PipelineModel",
                 "PipelineStage", "Transformer", "Dataset"):
        assert getattr(mmlspark_tpu_torch, name).__name__ == \
            getattr(mmlspark_tpu, name).__name__
    # each package's own stages (test files register classes of their own)
    assert [name for name, c in sorted(mmlspark_tpu_torch.all_stages().items())
            if c.__module__.startswith("mmlspark_tpu_torch.")] == \
        [name for name, c in sorted(mmlspark_tpu.all_stages().items())
         if c.__module__.startswith("mmlspark_tpu.")]


def test_pool_utilization_and_the_other_closed_names():
    from mmlspark_tpu_torch.core.integrity import HANDOFF_CHECKSUM_FIELDS
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.ops import native_build
    from mmlspark_tpu_torch.serve.cache_pool import SlotCachePool
    from mmlspark_tpu_torch.serve.paging import PagedCachePool

    from mmlspark_tpu.core import integrity

    assert HANDOFF_CHECKSUM_FIELDS == integrity.HANDOFF_CHECKSUM_FIELDS
    assert native_build.load_library is not None
    graph = build_model("transformer_lm", vocab_size=8, d_model=16, heads=2,
                        depth=1, max_len=16)
    variables = init_variables(graph, 0, device="cpu")
    for pool in (SlotCachePool(graph, variables, slots=4, cache_len=16,
                               device="cpu"),
                 PagedCachePool(graph, variables, slots=4, cache_len=16,
                                page_size=8, device="cpu")):
        assert pool.utilization == 0.0
        slots = [pool.lease() for _ in range(3)]
        assert pool.utilization == 0.75
        pool.free(slots[0])
        assert pool.utilization == 0.5
