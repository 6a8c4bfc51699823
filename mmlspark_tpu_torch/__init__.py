"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

The package mirrors the JAX package's subpackage layout so each module
has one counterpart (``core``, ``ops``, ``models``, ``serve``). It
imports ``torch`` and never ``jax``, ``flax`` or ``mmlspark_tpu``: what
it needs of the JAX package's jax-free modules it keeps as its own copy.

The first slice ports the dense-pool LM serving path: ``transformer_lm``,
greedy ``generate``, the fused decode block, the slot KV pool and
``ServeEngine``, with the decode attention read as a hand-written CUDA
kernel (``csrc/flash_decode.cu``). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
