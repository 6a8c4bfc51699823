"""Testing helpers: the program counter and the compile-count guard, and
(imported by path) ``datagen`` (seeded tables), ``benchmark_metrics``
(the recorded learner matrices) and ``tree_parity`` (near ties between
two tree fits)."""

from mmlspark_tpu_torch.testing.compile_guard import (
    GraphPool,
    ProgramCountingGraph,
    compile_guard,
    program_count,
    serve_compile_guard,
)

__all__ = [
    "GraphPool",
    "ProgramCountingGraph",
    "compile_guard",
    "program_count",
    "serve_compile_guard",
]
