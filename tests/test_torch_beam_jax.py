"""The port's ``beam_search`` against the JAX package's on the overfit
periodic LM for the RoPE + MQA and window + GQA cache configurations, in
the default bfloat16 compute (``test_torch_beam.py`` holds the plain and
window ones, and its docstring the tolerance).
"""

from __future__ import annotations

import pytest

from test_torch_beam import (  # noqa: unused (the fixture ``trained``)
    check_beam_matches_jax_bf16,
    trained,
)


@pytest.mark.parametrize("name", ["rope_mqa", "window_gqa"])
def test_beam_matches_jax_bf16(trained, name):
    check_beam_matches_jax_bf16(trained, name)
