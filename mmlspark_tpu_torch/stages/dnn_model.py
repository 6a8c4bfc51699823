"""TPUModel — DNN inference as a pipeline stage, the port of
``mmlspark_tpu/stages/dnn_model.py`` (the reference's CNTKModel,
cntk-model/src/main/scala/CNTKModel.scala).

| reference                                    | here                          |
|----------------------------------------------|-------------------------------|
| model bytes broadcast to executors (:248)    | weights resident on the card  |
| per-partition clone + minibatch loop (:51-88)| fixed-shape batch iterator +  |
|                                              | one program per output node   |
| output-node surgery via AsComposite (:97-108)| ``output_node`` name/index on |
|                                              | the NamedGraph prefix         |
| input coercion UDFs Double/Vector->Float     | stack + astype float32/int32  |
|   (:228-245)                                 |                               |
| ``setModelLocation`` file load (:151-154)    | ``set_model_location``        |

The forward is one program per ``(output_node, weight_quant)`` and batch
signature (:class:`~mmlspark_tpu_torch.testing.compile_guard.
ProgramCountingGraph`, the JAX package's one ``jit`` per key): on the card
a CUDA graph captured after the signature's first, eager call and
replayed for every later batch, the weights its state argument (read at
their own addresses); on the CPU an eager call. :attr:`TPUModel.
program_count` counts them.

Weights: the ``weights`` param holds the port's variables (``{block:
{name: tensor}}``, what :class:`~mmlspark_tpu_torch.stages.dnn_learner.
DNNLearner` returns) or the JAX package's flax variables (numpy leaves,
``{block: {"params": ..., "batch_stats": ...}}``, what a stage saved by
the JAX package holds), which cross through the weight bridge. Either
way they are moved to the device once and stay there across ``transform``
calls, until the ``weights`` object, ``weight_quant`` or the device
changes (an identity check on the object, as the JAX package's
``_device_weights``). ``weight_quant="int8"`` keeps per-output-channel
int8 on the device and dequantizes to bf16 inside the program.

The feed is asynchronous: a batch is copied from pinned memory without
waiting, its program enqueued, and its output copied back into pinned
memory behind a CUDA event; at most ``feed_depth`` batches are in flight
before the oldest is fetched and masked to its real rows.
``feed_dtype="bfloat16"`` casts float rows to bf16 on the host before the
copy, so half the bytes cross; integer (token) rows are left alone. A
bf16 output (a cut at a bf16 node) comes back as float32 holding the same
values, where the JAX package returns an ``ml_dtypes`` bfloat16 array.

``data_parallel`` inside an initialised process group of more than one
rank (NCCL, one card a rank; gloo on the CPU) splits the rows: every
rank scores its contiguous block of them and the scores are gathered in
row order, so every rank returns the whole column. On one device it is a
no-op, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    positive,
)
from mmlspark_tpu_torch.core.schema import SCORES_COLUMN
from mmlspark_tpu_torch.core.stage import Model
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import MASK_COL, batch_iterator, stack_column
from mmlspark_tpu_torch.models import bridge
from mmlspark_tpu_torch.models.graph import NamedGraph
from mmlspark_tpu_torch.models.registry import build_model
from mmlspark_tpu_torch.ops.quantize import (
    dequantize_weights,
    quantize_weights,
)
from mmlspark_tpu_torch.testing.compile_guard import (
    ProgramCountingGraph,
    program_count,
)


def is_port_variables(weights) -> bool:
    """Whether ``weights`` is the port's variables (every leaf a tensor)
    rather than the JAX package's flax variables (numpy leaves)."""
    if isinstance(weights, torch.Tensor):
        return True
    if isinstance(weights, dict):
        return all(is_port_variables(v) for v in weights.values())
    return False


class TPUModel(Model, HasInputCol, HasOutputCol):
    """Batched DNN inference on the card; the NN is just another stage."""

    model_name = Param("registered architecture name", ptype=str, required=True)
    model_config = Param("architecture config kwargs", default=dict, ptype=dict)
    weights = Param("model variables (the port's, or flax's per-block)")
    batch_size = Param(
        "rows per program call (minibatch)", 128, ptype=int,
        validator=positive,
    )
    output_node = Param(
        "output node name or index; None = full net (CNTK 'z' convention)"
    )
    data_parallel = Param(
        "shard the rows over the ranks of an initialised process group "
        "(each scores its contiguous block; the scores are gathered in "
        "order); a no-op on one device", True,
        ptype=bool,
    )
    feed_depth = Param(
        "max in-flight batches in the async host->device pipeline (batch "
        "i+1's copy overlaps batch i's compute; higher = more overlap, "
        "more pinned memory held by pending outputs)", 2, ptype=int,
        validator=positive,
    )
    weight_quant = Param(
        "device-resident weight precision: 'none' keeps the trained "
        "dtype; 'int8' stores the large weights as per-output-channel "
        "symmetric int8 on the device and dequantizes to bf16 inside the "
        "program (weight-only W8, a bandwidth lever; ops/quantize.py)",
        "none", domain=("none", "int8"),
    )
    feed_dtype = Param(
        "host->device transfer dtype for FLOAT inputs: 'float32' ships "
        "rows as they are; 'bfloat16' casts on the host before the copy, "
        "half the bytes. The conv stack computes in bf16 either way, so "
        "only the input's rounding moves. Integer (token) inputs are "
        "unaffected.",
        "float32", domain=("float32", "bfloat16"),
    )
    device = Param(
        "the device the stage runs on: None = the card (cuda; raises "
        "without a GPU), or 'cpu'/'cuda'/'cuda:N'", ptype=str,
    )

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("output_col", SCORES_COLUMN)
        super().__init__(**kwargs)
        self._graph: NamedGraph | None = None
        self._programs: dict = {}
        self._dev_weights_src = (None, None, None)

    # -- construction helpers ----------------------------------------------

    @classmethod
    def from_graph(
        cls, graph: NamedGraph, variables, model_name: str, **kwargs: Any
    ) -> "TPUModel":
        m = cls(model_name=model_name, **kwargs)
        m.set(weights=variables)
        m._graph = graph
        return m

    def set_model_location(self, path: str) -> "TPUModel":
        """Load weights from a saved stage directory (reference
        ``setModelLocation`` reading model bytes off the filesystem,
        CNTKModel.scala:151-154)."""
        from mmlspark_tpu_torch.core.stage import PipelineStage

        loaded = PipelineStage.load(path)
        if not isinstance(loaded, TPUModel):
            raise FriendlyError(f"{path} does not hold a TPUModel")
        self.set(
            model_name=loaded.model_name,
            model_config=loaded.model_config,
            weights=loaded.weights,
        )
        self._graph = None
        self._programs = {}
        return self

    def graph(self) -> NamedGraph:
        if self._graph is None:
            self._graph = build_model(self.model_name,
                                      **(self.model_config or {}))
        return self._graph

    @property
    def layer_names(self) -> list[str]:
        return self.graph().layer_names

    @property
    def program_count(self) -> int:
        """Programs made so far, over every ``(output_node,
        weight_quant)`` key."""
        return sum(program_count(p) for p in self._programs.values())

    @property
    def capture_seconds(self) -> float:
        return sum(p.capture_seconds for p in self._programs.values())

    def captured_forward(self) -> tuple:
        """``(program, weights)``: the forward program of the current
        output node and weight precision, as the last ``transform`` ran
        it, and the device weights it reads — to time or trace the model
        alone, with no feed. ``program(weights, x)`` runs one batch."""
        key = (self.output_node, self.weight_quant)
        if key not in self._programs:
            raise FriendlyError("captured_forward: no transform has run "
                                "this stage's forward yet")
        return self._programs[key], self._dev_weights

    # -- execution ----------------------------------------------------------

    def _forward(self) -> ProgramCountingGraph:
        """The forward program family for the current output node and
        weight precision, made once per key and reused across batches
        (the per-executor model clone reused per partition)."""
        key = (self.output_node, self.weight_quant)
        if key not in self._programs:
            graph = self.graph()
            node = self.output_node
            quant = self.weight_quant

            def fwd(variables, x):
                if quant == "int8":
                    # inside the program: the device holds the int8 copy
                    variables = dequantize_weights(variables)
                return graph.apply(variables, x, output_node=node)

            self._programs[key] = ProgramCountingGraph(
                fwd, state_argnums=(0,), label="tpu_model.forward")
        return self._programs[key]

    def _device_weights(self, dev: torch.device) -> dict:
        """Weights resident on ``dev`` across transform calls (the analog
        of the broadcast model staying resident per executor,
        CNTKModel.scala:248); remade only when the weights object, the
        precision or the device changes. Validity is an identity check
        against a STRONG reference to the weights object — never a raw
        id(), which CPython reuses once the old object is collected. The
        programs read the weights at their addresses, so new weights
        start a new program family."""
        src = (self.weights, self.weight_quant, dev)
        cached = self._dev_weights_src
        if cached[0] is src[0] and cached[1:] == src[1:]:
            return self._dev_weights
        graph = self.graph()
        if is_port_variables(self.weights):
            variables = bridge.variables_to(self.weights, dev)
        else:
            variables = bridge.load_flax_variables(graph, self.weights,
                                                   device=dev)
        if self.weight_quant == "int8":
            variables = quantize_weights(graph, variables)
        self._dev_weights = variables
        self._dev_weights_src = src
        self._programs = {}
        return variables

    def _coerce_input(self, dataset: Dataset) -> Dataset:
        """Input coercion (reference CNTKModel.scala:228-245): whatever the
        column holds — lists, object vectors, int sequences — becomes one
        typed ndarray column."""
        col = self.input_col
        arr = stack_column(dataset, col)
        if arr.dtype == object:
            raise FriendlyError(
                f"input column '{col}' is ragged; bucket or pad first", self.uid
            )
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.int32)
        elif arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        return dataset.with_column(col, arr, dataset.meta_of(col))

    def _transform(self, dataset: Dataset) -> Dataset:
        dev = default_device(self.device)
        ds = self._coerce_input(dataset)
        # blocks that learn their input width from the first input (the
        # MLP family, as a flax Dense does) take it from the rows
        self.graph().size_input(ds[self.input_col].shape[1:])
        ranks = _data_parallel_ranks() if self.data_parallel else None
        if ranks is not None:
            rank, world = ranks
            per = -(-ds.num_rows // world)
            ds = ds.gather(np.arange(rank * per,
                                   min((rank + 1) * per, ds.num_rows)))
        batches = ((torch.from_numpy(b[self.input_col]), b[MASK_COL])
                   for b in batch_iterator(ds, [self.input_col],
                                           self.batch_size))
        scores = self.score(batches, dev)
        if ranks is not None:
            import torch.distributed as dist

            parts = [None] * ranks[1]
            dist.all_gather_object(parts, scores)
            scores = np.concatenate([p for p in parts if len(p)], axis=0)
        return dataset.with_column(self.output_col, scores)

    def score(self, batches, dev: torch.device) -> np.ndarray:
        """The outputs of the net over ``batches`` — ``(x, mask)`` pairs of
        fixed-shape input rows, on the host or already on ``dev``, and
        the boolean mask of the real ones — concatenated on the host.

        Async pipeline (replaces the reference's strictly serial
        per-minibatch JNI copy->evaluate->copy loop, CNTKModel.scala:51-88):
        a host batch is copied in from pinned memory and its program
        enqueued without a host sync, so batch i+1's copy overlaps batch
        i's compute; each output is copied back behind an event and
        fetched ``feed_depth`` batches later."""
        if self.weights is None:
            raise FriendlyError("no weights set; fit or set_model_location first",
                                self.uid)
        weights = self._device_weights(dev)
        fwd = self._forward()
        on_card = dev.type == "cuda"
        cast_bf16 = self.feed_dtype == "bfloat16"
        inflight: list = []
        outs = []

        def drain(limit: int):
            while len(inflight) > limit:
                host, event, mask = inflight.pop(0)
                if event is not None:
                    event.synchronize()
                if host.dtype == torch.bfloat16:
                    host = host.float()  # numpy has no bfloat16; exact
                outs.append(host.numpy()[mask])

        for x, mask in batches:
            if cast_bf16 and x.is_floating_point():
                x = x.to(torch.bfloat16)
            if on_card and x.device.type != "cuda":
                x = x.pin_memory().to(dev, non_blocking=True)
            y = fwd(weights, x)
            if on_card:
                # the program's output is overwritten by its next replay:
                # copied out in stream order, before that replay runs
                host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                host.copy_(y, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = y.clone(), None
            inflight.append((host, event, mask))
            drain(self.feed_depth)
        drain(0)
        return (
            np.concatenate(outs, axis=0)
            if outs
            else np.zeros((0,), dtype=np.float32)
        )


def _data_parallel_ranks():
    """``(rank, world size)`` of an initialised process group of more
    than one rank, else None (one device: nothing to split)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return None
    return dist.get_rank(), dist.get_world_size()
