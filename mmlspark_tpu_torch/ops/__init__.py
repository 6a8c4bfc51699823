"""Ops: attention math, RoPE, and the hand-written CUDA kernels.

- :mod:`attention` — the dense oracle and the masking conventions
- :mod:`rope` — rotary position embeddings
- :mod:`flash_attention` — ``flash_decode``, the decode attention read,
  wrapping ``csrc/flash_decode.cu``
- :mod:`kernel_build` — builds ``csrc/*.cu`` with ``nvcc`` on first use
"""
