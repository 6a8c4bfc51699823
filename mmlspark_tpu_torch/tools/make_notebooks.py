"""Generate the port's sample-notebook tier from its example scripts —
the counterpart of the repo's ``tools/make_notebooks.py``.

The reference ships 10 runnable sample notebooks under
``notebooks/samples/`` and its CI executes them headless
(tools/notebook/tester/NotebookTestSuite.py). The port's examples are
maintained once, as ``mmlspark_tpu_torch/examples/e*.py`` scripts, and
this tool derives the committed notebooks under
``notebooks/samples_torch/`` from them with the JAX generator's layout:
a markdown cell from the module docstring under the notebook's title,
one code cell per top-level block (imports and constants grouped, each
function or class its own), a final ``main()`` cell. It writes plain
nbformat-4 JSON with :mod:`json` (no ``nbformat`` import: the GPU
machine has none), with cell ids numbered in order, so a rerun writes
the same bytes.

Run: ``python -m mmlspark_tpu_torch.tools.make_notebooks [out_dir]``.
A notebook resolves the repo's data through ``__file__``, which its
first code cell sets from the working directory: start the kernel in
``mmlspark_tpu_torch/examples/``. The notebooks run on the card; on the
CPU, call the last cell's ``main()`` inside ``with
mmlspark_tpu_torch.core.env.process_default("cpu"):``.
"""

from __future__ import annotations

import ast
import json
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
EXAMPLES = os.path.join(PKG, "examples")
OUT = os.path.join(REPO, "notebooks", "samples_torch")

#: examples -> notebook titles (the JAX tier's, reference numbering)
TITLES = {
    "e101": "101 - Classification on a Real Table (TrainClassifier)",
    "e102": "102 - Regression on a Real Table (TrainRegressor)",
    "e103": "103 - Before and After mmlspark_tpu",
    "e201": "201 - Text Analytics - TextFeaturizer",
    "e202": "202 - Text Analytics - Word2Vec",
    "e301": "301 - CIFAR10-style CNN Evaluation (TPUModel)",
    "e302": "302 - Pipeline Image Transformations",
    "e303": "303 - Transfer Learning by DNN Featurization",
    "e304": "304 - Medical Entity Extraction (BiLSTM)",
    "e305": "305 - ImageFeaturizer: basic vs DNN featurization",
    # beyond the reference's ten: the long-context and generation samples
    "e306": "306 - Long-Context Ring Attention (sequence parallelism)",
    "e307": "307 - Generation with KV-Cache Decode (rolled window, "
            "nucleus sampling)",
}


def _cell(kind: str, source: str) -> dict:
    cell = {"cell_type": kind, "metadata": {},
            "source": source.splitlines(keepends=True)}
    if kind == "code":
        cell.update(execution_count=None, outputs=[])
    return cell


def script_to_cells(path: str) -> list:
    """Split a script into notebook cells at top-level statement groups:
    docstring -> markdown; imports+constants -> one cell; each def/class
    -> its own cell; trailing __main__ guard -> a bare main() call."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src)
    lines = src.splitlines()

    cells = []
    doc = ast.get_docstring(tree)
    body = list(tree.body)
    if doc is not None:
        body.pop(0)
        title = TITLES.get(os.path.basename(path)[:4], "")
        cells.append(_cell("markdown", f"# {title}\n\n{doc}"))
    # the scripts resolve repo paths via __file__, which kernels don't
    # define; start the kernel in mmlspark_tpu_torch/examples/
    cells.append(_cell(
        "code",
        "import os\n"
        f"__file__ = os.path.join(os.getcwd(), {os.path.basename(path)!r})"))

    def segment(node) -> str:
        return "\n".join(lines[node.lineno - 1: node.end_lineno])

    # group consecutive non-def statements (imports, constants) into one
    # cell; each function/class gets its own
    group: list[str] = []
    for node in body:
        is_main_guard = (
            isinstance(node, ast.If)
            and isinstance(node.test, ast.Compare)
            and getattr(node.test.left, "id", "") == "__name__"
        )
        if is_main_guard:
            continue  # replaced by the explicit call cell below
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if group:
                cells.append(_cell("code", "\n".join(group)))
                group = []
            cells.append(_cell("code", segment(node)))
        else:
            group.append(segment(node))
    if group:
        cells.append(_cell("code", "\n".join(group)))
    cells.append(_cell("code", "main()"))
    for i, cell in enumerate(cells):
        cell["id"] = f"cell-{i:02d}"
    return cells


def notebook(path: str) -> dict:
    """The nbformat-4 notebook of one example script."""
    return {
        "cells": script_to_cells(path),
        "metadata": {"kernelspec": {
            "display_name": "Python 3", "language": "python",
            "name": "python3"}},
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def main(out_dir: str = OUT) -> list:
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(EXAMPLES)):
        if not (name.startswith("e") and name.endswith(".py")):
            continue
        key = name[:4]
        if key not in TITLES:
            continue
        out = os.path.join(out_dir, f"{TITLES[key]}.ipynb")
        with open(out, "w", encoding="utf-8") as f:
            json.dump(notebook(os.path.join(EXAMPLES, name)), f, indent=1,
                      ensure_ascii=False)
            f.write("\n")
        written.append(os.path.basename(out))
    print(f"wrote {len(written)} notebooks under {out_dir}")
    for w in written:
        print(" ", w)
    return written


if __name__ == "__main__":
    main(*sys.argv[1:2])
