"""Model-architecture registry: name -> NamedGraph builder — the port of
``mmlspark_tpu/models/registry.py``, with every architecture the JAX
package registers: ``transformer_lm``, ``mlp``, ``linear``,
``resnet20_cifar10``, ``resnet50``, ``bilstm_tagger``,
``transformer_lm_moe``, ``transformer_lm_pipelined``, ``onnx`` (an
imported ONNX file, ``models/onnx_import.py``) and ``skipgram``
(``stages/word2vec.py``). A serialized ``TPUModel`` stores
``(model_name, model_config)`` and rebuilds its graph here at load
time."""

from __future__ import annotations

from typing import Any, Callable

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.graph import NamedGraph

_BUILDERS: dict[str, Callable[..., NamedGraph]] = {}


def register_model(name: str):
    def deco(fn: Callable[..., NamedGraph]):
        _BUILDERS[name] = fn
        return fn

    return deco


def build_model(name: str, **config: Any) -> NamedGraph:
    _ensure_loaded()
    if name not in _BUILDERS:
        import difflib

        hint = difflib.get_close_matches(name, sorted(_BUILDERS), n=1)
        suggest = f"; did you mean '{hint[0]}'?" if hint else ""
        raise FriendlyError(
            f"unknown model '{name}'; registered: "
            f"{sorted(_BUILDERS)}{suggest} (foreign graphs load via "
            "name 'onnx' with path=<file.onnx>)"
        )
    return _BUILDERS[name](**config)


def registered_models() -> list[str]:
    _ensure_loaded()
    return sorted(_BUILDERS)


def _ensure_loaded() -> None:
    # builder modules self-register on import
    import mmlspark_tpu_torch.models.bilstm  # noqa: F401
    import mmlspark_tpu_torch.models.mlp  # noqa: F401
    import mmlspark_tpu_torch.models.moe  # noqa: F401
    import mmlspark_tpu_torch.models.onnx_import  # noqa: F401
    import mmlspark_tpu_torch.models.pipelined  # noqa: F401
    import mmlspark_tpu_torch.models.resnet  # noqa: F401
    import mmlspark_tpu_torch.models.transformer  # noqa: F401
    import mmlspark_tpu_torch.stages.word2vec  # noqa: F401  (skipgram)
