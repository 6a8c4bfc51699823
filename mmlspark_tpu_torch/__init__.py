"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

The package mirrors the JAX package's subpackage layout so each module
has one counterpart (``core``, ``data``, ``ops``, ``models``, ``serve``,
``testing``, ``train``). It imports ``torch`` and never ``jax``, ``flax`` or
``mmlspark_tpu``: what it needs of the JAX package's jax-free modules it
keeps as its own copy.

The port so far is the LM serving path — ``transformer_lm``, greedy
``generate``, the fused decode block, the dense slot KV pool, the paged
pool with its prefix cache, the int8 KV mode of both, and
``ServeEngine`` — and LM training on one device: the cache-free
``flash_attention`` with its gradient, the graph's train mode and
``SPMDTrainer``. Every attention kernel is hand-written CUDA
(``csrc/flash_decode.cu``, ``csrc/paged_flash_decode.cu``,
``csrc/flash_attention_fwd*.cu``, ``csrc/flash_attention_bwd*.cu``), and
so is the trainer's fused optimizer pass (``csrc/fused_optim.cu``). On
the card the engine's programs and the trainer's step run as CUDA graphs,
counted as the JAX package counts its compiled programs
(``testing/compile_guard.py``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
