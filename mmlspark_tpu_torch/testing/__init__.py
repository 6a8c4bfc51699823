"""Testing helpers: the program counter and the compile-count guard."""

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
