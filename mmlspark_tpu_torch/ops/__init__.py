"""Ops: attention math, RoPE, and the hand-written CUDA kernels.

- :mod:`attention` — the dense oracle and the masking conventions
- :mod:`rope` — rotary position embeddings
- :mod:`flash_attention` — ``flash_attention`` (the cache-free forward
  and its gradient, wrapping ``csrc/flash_attention_fwd.cu`` and
  ``csrc/flash_attention_bwd.cu``), and ``flash_decode`` and
  ``paged_flash_decode``, the decode attention reads (float and int8
  K/V), wrapping ``csrc/flash_decode.cu`` and
  ``csrc/paged_flash_decode.cu``
- :mod:`quantize` — weight-only int8 (``quantize_weights``,
  ``dequantize_weights``, ``quantized_bytes``) and KV-cache byte
  accounting for the int8 pools
- :mod:`fused_optim` — the trainer's optimizer update and quarantine as
  one multi-tensor pass, wrapping ``csrc/fused_optim.cu``
- :mod:`tree_checksum` — the integrity fold over the trainer's state as
  one multi-tensor pass, gated by a device flag, wrapping
  ``csrc/tree_checksum.cu``
- :mod:`kernel_build` — builds ``csrc/*.cu`` with ``nvcc`` on first use,
  and holds the C signature of every entry point
- :mod:`native_build` — builds the host libraries ``native/decode.cpp``
  and ``native/ctf.cpp`` with the system C++ compiler on first use
- :mod:`decode` — JPEG/PNG bytes to BGR (native, then PIL)
- :mod:`image_ops` — the OpenCV-semantics image ops on the host, and the
  batched NHWC resize on the caller's device
"""
