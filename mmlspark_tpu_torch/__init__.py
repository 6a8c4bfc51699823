"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

The package mirrors the JAX package's subpackage layout so each module
has one counterpart (``core``, ``data``, ``ops``, ``models``, ``serve``,
``stages``, ``testing``, ``train``). It imports ``torch`` and never ``jax``, ``flax`` or
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
(``testing/compile_guard.py``). The stage layer — ``Params``,
``PipelineStage``, ``Pipeline``, stage serialization on the JAX package's
format, the full ``Dataset`` — carries ``TPUModel`` and ``DNNLearner``
over ResNet-20, ResNet-50, the BiLSTM tagger, the MLP family and the
transformer LM; the convolutions and the LSTM are cuDNN's. The
switch-MoE LM (``transformer_lm_moe``, ``parallel/expert.py``) is served
and trained on the same paths, and the image pipeline — the native
decoder, the readers, ``ImageTransformer``/``ImageFeaturizer`` and the
model zoo — feeds ``TPUModel``, resizing on the card. The classical
one-liner path — ``Featurize``, the histogram tree learners fitting on
the card, ``TrainClassifier``/``TrainRegressor``,
``ComputeModelStatistics`` and ``FindBestModel`` — runs on the stage
layer too.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The stage layer's names are re-exported here, as the JAX package's root
does, with :func:`all_stages`.
"""

__version__ = "0.1.0"

from mmlspark_tpu_torch.core.stage import (  # noqa: F401
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    PipelineStage,
    Transformer,
)
from mmlspark_tpu_torch.data.dataset import Dataset  # noqa: F401


def all_stages():
    """The registry of every stage class, by class name (the JAX
    package's ``all_stages``: importing the stages populates it)."""
    import mmlspark_tpu_torch.stages  # noqa: F401  (populates the registry)

    return dict(PipelineStage.registry())
