"""The port's ``beam_search`` against the JAX package's on the overfit
periodic LM for the RoPE + MQA and window + GQA cache configurations, in
the default bfloat16 compute (``test_torch_beam.py`` holds the plain and
window ones, and its docstring the tolerance).
"""

from __future__ import annotations

import pytest
import torch

from test_torch_beam import (  # noqa: unused (the fixture ``trained``)
    check_beam_matches_jax_bf16,
    trained,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["rope_mqa", "window_gqa"])
def test_beam_matches_jax_bf16(trained, name):
    check_beam_matches_jax_bf16(trained, name)
