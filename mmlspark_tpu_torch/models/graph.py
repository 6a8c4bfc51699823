"""Named-node model graphs — the port of ``mmlspark_tpu/models/graph.py``.

A model is an ordered sequence of named blocks, each an ``nn.Module``,
run in order by ``apply(variables, x)``. As in the JAX package the graph
holds the STRUCTURE and the variables are passed beside it:
``variables`` is
``{block name: {parameter name: tensor}}`` (each block's ``state_dict``
layout), made by :func:`mmlspark_tpu_torch.models.bridge.init_variables`
or :func:`~mmlspark_tpu_torch.models.bridge.load_flax_variables`.

The blocks are built on the ``meta`` device, so a graph owns no memory
until it runs. In eval mode :meth:`NamedGraph.bind` assigns a variables
dict's tensors into the blocks (no copy) before a forward; binding is
skipped when the same dict is already bound, so the decode loop pays one
identity check per call. Variables are treated as immutable, like a JAX
pytree: to change weights, pass a new dict. Train mode runs each block
on the dict's own tensors through ``torch.func.functional_call``, so
gradients reach them.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mmlspark_tpu_torch.core.exceptions import FriendlyError

#: conventional name of the final (logits) node
FINAL_NODE = "z"


@dataclass(eq=False)
class NamedGraph:
    """An ordered, named-block model. ``blocks`` maps name -> module;
    order is the dataflow order."""

    name: str
    blocks: list[tuple[str, torch.nn.Module]]
    #: static metadata: expected input shape (per example, no batch dim)
    input_shape: tuple[int, ...] = ()
    extra: dict = field(default_factory=dict)
    _bound: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        for _, mod in self.blocks:
            mod.requires_grad_(False)

    @property
    def layer_names(self) -> list[str]:
        """Ordered node names."""
        return [n for n, _ in self.blocks]

    def _block_variables(self, variables: dict, block_name: str) -> dict:
        try:
            return variables[block_name]
        except KeyError as e:
            raise FriendlyError(
                f"variables lack block '{block_name}' of graph "
                f"'{self.name}'; have {sorted(variables)}"
            ) from e

    def size_input(self, example_shape) -> None:
        """Size the blocks that learn their input width from the first
        input, as a flax Dense does (the MLP family), from one example's
        shape (no batch dim); other graphs are left as they are."""
        width = int(example_shape[-1]) if len(example_shape) else 1
        for _, mod in self.blocks:
            size = getattr(mod, "size_input", None)
            if size is None:
                return
            width = size(width)

    def bind(self, variables: dict) -> None:
        """Make the blocks' parameters the tensors of ``variables``
        (assigned, not copied); a no-op when ``variables`` is already
        bound."""
        if self._bound is variables:
            return
        self._bound = None  # a bind that fails half-way binds nothing
        for block_name, mod in self.blocks:
            mod.load_state_dict(self._block_variables(variables, block_name),
                                strict=True, assign=True)
        self._bound = variables

    def unbind(self) -> None:
        """Drop the bound variables' tensors from the blocks (their
        parameters go back to the ``meta`` device), so the graph keeps no
        reference to them: the weight-int8 engine's per-call bf16 weights
        are freed once its call returns."""
        for _, mod in self.blocks:
            mod.to_empty(device="meta")
        self._bound = None

    def apply(self, variables: dict, x, train: bool = False, mask=None,
              remat: bool = False):
        """Forward pass through every block.

        Eval mode (the default) returns the output, run under
        ``no_grad`` on the bound variables. Train mode returns ``(out,
        variables)``, as the JAX package's does (the port's blocks keep
        no batch statistics, so the variables come back as they went
        in), and runs each block on the dict's own tensors, so
        ``backward()`` reaches them; ``remat`` recomputes each block's
        activations in the backward (``torch.utils.checkpoint``) instead
        of keeping them. ``mask`` ((B,) 0/1 real-row mask) goes to the
        blocks whose ``forward`` accepts it.
        """
        if not train:
            self.bind(variables)
            with torch.no_grad():
                for _, mod in self.blocks:
                    x = mod(x, **_mask_kwarg(mod, mask))
            return x
        for block_name, mod in self.blocks:
            params = self._block_variables(variables, block_name)
            kwargs = _mask_kwarg(mod, mask)
            if remat:
                # the blocks draw no random numbers, so no RNG state is
                # kept for the recompute (which also keeps a captured
                # training step free of generator-state reads)
                x = checkpoint(_call_block, mod, params, x, kwargs,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _call_block(mod, params, x, kwargs)
        return x, variables


def _call_block(mod, params: dict, x, kwargs: dict):
    return functional_call(mod, params, (x,), kwargs, strict=True)


def _mask_kwarg(mod, mask) -> dict:
    if mask is not None and _accepts_kwarg(mod, "mask"):
        return {"mask": mask}
    return {}


def _accepts_kwarg(mod, name: str) -> bool:
    try:
        return name in inspect.signature(type(mod).forward).parameters
    except (ValueError, TypeError):  # pragma: no cover
        return False
