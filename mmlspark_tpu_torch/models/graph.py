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

A block's variables hold its parameters and its statistics (the
BatchNorm running mean and variance, registered as buffers — flax's
``batch_stats`` collection): :meth:`NamedGraph.stat_keys` names the
latter, which the trainer carries beside the parameters and does not
differentiate. In train mode a block that keeps statistics computes new
ones and leaves them in its ``new_stats`` attribute; ``apply`` collects
them into the variables it returns, as the JAX package's ``apply``
returns flax's mutated ``batch_stats``. A block that sows auxiliary
losses (the MoE router's load-balance loss, ``models/moe.py``) leaves
them in its ``new_losses`` attribute in train mode; ``apply`` returns
them under ``updated[block]["losses"]`` (flax's sown ``losses``
collection, keyed by the sowing submodule's path), never carries them
into the next call and never binds them.

``apply(output_node=...)`` runs the prefix ending at that block, and
:meth:`NamedGraph.cut` makes a graph of that prefix (the reference's
``AsComposite`` graph surgery, CNTKModel.scala:97-108).
"""

from __future__ import annotations

import copy
import inspect
import itertools
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mmlspark_tpu_torch.core.exceptions import FriendlyError

#: conventional name of the final (logits) node
FINAL_NODE = "z"
#: the key of a block's sown per-call losses in the variables ``apply``
#: returns in train mode
LOSSES = "losses"


@dataclass(eq=False)
class NamedGraph:
    """An ordered, named-block model. ``blocks`` maps name -> module;
    order is the dataflow order."""

    name: str
    blocks: list[tuple[str, torch.nn.Module]]
    #: static metadata: expected input shape (per example, no batch dim)
    input_shape: tuple[int, ...] = ()
    #: dtype used for compute (bfloat16 feeds the tensor cores; params
    #: stay f32). Informational, as in the JAX package: each block casts
    #: to its own compute dtype
    compute_dtype: Any = None
    extra: dict = field(default_factory=dict)
    _bound: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        for _, mod in self.blocks:
            mod.requires_grad_(False)

    @property
    def layer_names(self) -> list[str]:
        """Ordered node names."""
        return [n for n, _ in self.blocks]

    def _check_node(self, node: str | int | None) -> str | None:
        return resolve_node(self.layer_names, node, self.name)

    def stat_keys(self, block_name: str) -> frozenset:
        """The keys of block ``block_name``'s variables that are statistics
        (buffers: BatchNorm's running mean and variance), not trained
        parameters."""
        mod = dict(self.blocks)[block_name]
        return frozenset(k for k, _ in mod.named_buffers())

    def _block_variables(self, variables: dict, block_name: str) -> dict:
        """Block ``block_name``'s variables, without the losses a
        train-mode call sowed (per-call values, not state)."""
        try:
            block = variables[block_name]
        except KeyError as e:
            raise FriendlyError(
                f"variables lack block '{block_name}' of graph "
                f"'{self.name}'; have {sorted(variables)}"
            ) from e
        if LOSSES in block:
            block = {k: v for k, v in block.items() if k != LOSSES}
        return block

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

    def apply(self, variables: dict, x, output_node: str | int | None = None,
              train: bool = False, mask=None, remat: bool = False):
        """Forward pass; stops after ``output_node`` when given (a headless
        net).

        Eval mode (the default) returns the output, run under
        ``no_grad`` on the bound variables, the blocks' statistics as
        they are. Train mode returns ``(out, updated_variables)``, as the
        JAX package's does: a block that keeps statistics normalises with
        its batch's and comes back with new running ones in
        ``updated_variables``; every other entry is the tensor that went
        in. Train mode runs each block on the dict's own tensors, so
        ``backward()`` reaches them; ``remat`` recomputes each block's
        activations in the backward (``torch.utils.checkpoint``) instead
        of keeping them. ``mask`` ((B,) 0/1 real-row mask) goes to the
        blocks whose ``forward`` accepts it, and ``train`` to those that
        accept it.
        """
        stop = self._check_node(output_node)
        if not train:
            self.bind(variables)
            with torch.no_grad():
                for block_name, mod in self.blocks:
                    x = mod(x, **_mask_kwarg(mod, mask))
                    if block_name == stop:
                        break
            return x
        updated = dict(variables)
        for block_name, mod in self.blocks:
            params = self._block_variables(variables, block_name)
            kwargs = _mask_kwarg(mod, mask)
            if _accepts_kwarg(mod, "train"):
                kwargs["train"] = True
            if remat:
                # the blocks draw no random numbers, so no RNG state is
                # kept for the recompute (which also keeps a captured
                # training step free of generator-state reads)
                x = checkpoint(_call_block, mod, params, x, kwargs,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _call_block(mod, params, x, kwargs)
            stats = _take_new(mod, "new_stats")
            losses = _take_new(mod, "new_losses")
            if stats or losses:
                updated[block_name] = {**params, **stats}
            if losses:
                updated[block_name][LOSSES] = losses
            if block_name == stop:
                break
        return x, updated

    def cut(self, node: str | int) -> "NamedGraph":
        """A new graph truncated after ``node`` (AsComposite equivalent).
        Its blocks are copies on the ``meta`` device, so binding one
        graph's variables never rebinds the other's."""
        stop = self._check_node(node)
        idx = self.layer_names.index(stop)
        return NamedGraph(
            name=f"{self.name}@{stop}",
            blocks=[(n, _meta_copy(m)) for n, m in self.blocks[: idx + 1]],
            input_shape=self.input_shape,
            compute_dtype=self.compute_dtype,
            extra=dict(self.extra),
        )

    def param_count(self, variables) -> int:
        return count_params(variables)


def resolve_node(layer_names: Sequence[str], node: str | int | None,
                 graph_name: str) -> str | None:
    """Resolve an output-node selector (name or index, the CNTKModel
    setOutputNode variants, CNTKModel.scala:166-170) against ordered node
    names; raises FriendlyError for unknown selectors."""
    if node is None:
        return None
    if isinstance(node, int):
        try:
            return layer_names[node]
        except IndexError:
            raise FriendlyError(
                f"output node index {node} out of range for "
                f"{len(layer_names)} nodes"
            )
    if node not in layer_names:
        raise FriendlyError(
            f"no node '{node}' in graph '{graph_name}'; "
            f"nodes: {list(layer_names)}"
        )
    return node


def count_params(variables) -> int:
    """Total element count of a variables nest (dicts of tensors or
    arrays; a weight-quantized leaf counts its payload and scales)."""
    if isinstance(variables, dict):
        return sum(count_params(v) for v in variables.values())
    return int(variables.numel() if isinstance(variables, torch.Tensor)
               else variables.size)


def _take_new(mod, attr: str) -> dict:
    """What a train-mode call left in attribute ``attr`` (``new_stats``:
    statistics; ``new_losses``: sown losses) of ``mod``'s submodules,
    keyed by the submodule's path as ``mod``'s variables are; the
    attributes are cleared."""
    out = {}
    for path, sub in mod.named_modules():
        stats = getattr(sub, attr, None)
        if stats is None:
            continue
        setattr(sub, attr, None)
        prefix = f"{path}." if path else ""
        out.update({prefix + k: t for k, t in stats.items()})
    return out


def _meta_copy(mod: torch.nn.Module) -> torch.nn.Module:
    """A deep copy of ``mod`` whose parameters and buffers are new tensors
    on the ``meta`` device (nothing bound is copied)."""
    memo = {}
    for t in itertools.chain(mod.parameters(), mod.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = (torch.nn.Parameter(meta, requires_grad=False)
                       if isinstance(t, torch.nn.Parameter) else meta)
    return copy.deepcopy(mod, memo)


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
