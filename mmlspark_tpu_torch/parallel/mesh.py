"""Device meshes over a ``torch.distributed`` process group — the port of
``mmlspark_tpu/parallel/mesh.py``.

The JAX package builds a named :class:`jax.sharding.Mesh` over every
device one controller sees and lets XLA insert the collectives. In
PyTorch every rank runs the program, so a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of an
initialised process group (:func:`initialize_distributed`): NCCL, one
rank a card, on the GPU; gloo only when the caller asks for the CPU.
Axis names are the API, as in the JAX package.

JAX's ``shard_map`` and ``pcast_varying`` have no counterpart here: in
torch every rank already runs the body on its own shard, and nothing
types values as varying across ranks. :func:`axis_size` reads an axis
off the mesh instead of a ``shard_map`` frame.

The parallel functions take the JAX package's GLOBAL view: every rank
passes the same global tensors and gets the global result, each rank
computing its part (:class:`Scatter` to its chunk, :class:`Gather` back).
A data-parallel trainer hands its model the rank's shard of the batch
instead; inside :func:`local_batch` the functions leave the batch dim as
it is and split only their own axis.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError

#: canonical axis names
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "seq"
PIPELINE_AXIS = "pipe"
EXPERT_AXIS = "expert"


def parse_mesh_axes(spec: str) -> dict[str, int]:
    """Parse the CLI/bench mesh spelling ``"data=4,model=2"`` into the
    axes mapping :func:`make_mesh` takes. A size of ``-1`` (one axis at
    most) is inferred from the rank count, exactly as in
    :func:`make_mesh`; whitespace around entries is ignored."""
    axes: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, size = part.partition("=")
        name = name.strip()
        try:
            if not eq or not name:
                raise ValueError
            axes[name] = int(size)
        except ValueError:
            raise FriendlyError(
                f"bad mesh spec {spec!r}: each entry must be "
                f"'axis=size' (e.g. 'data=4,model=2'), got {part!r}"
            ) from None
    if not axes:
        raise FriendlyError(
            f"bad mesh spec {spec!r}: no axes (e.g. 'data=4,model=2')"
        )
    return axes


def _group_device_type() -> str:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise FriendlyError(
            "make_mesh needs an initialised process group: call "
            "initialize_distributed(...) first (NCCL on the card; "
            "device='cpu' for gloo)"
        )
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axes: Mapping[str, int] | None = None,
              devices: Sequence[int] | None = None):
    """Build a :class:`~torch.distributed.device_mesh.DeviceMesh` over
    the process group's ranks.

    ``axes`` maps axis name -> size, in major-to-minor order; a single
    axis may be -1 (inferred). ``devices`` lists the global ranks to lay
    out (default: every rank). Default axes: pure data parallelism over
    every rank. A smaller mesh uses the first ranks it needs; every rank
    must call this (sub-groups are made collectively), and a rank outside
    the mesh has no coordinate in it. The mesh lives on ``cuda`` under
    NCCL and on ``cpu`` under gloo — never another backend than the one
    the group was started with."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = _group_device_type()
    ranks = list(devices) if devices is not None else \
        list(range(dist.get_world_size()))
    n = len(ranks)
    if axes is None:
        axes = {DATA_AXIS: n}
    names = list(axes)
    sizes = list(axes.values())
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise FriendlyError("at most one mesh axis may be -1")
    if unknown:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if n % known:
            raise FriendlyError(
                f"cannot infer axis '{names[unknown[0]]}': {n} devices not "
                f"divisible by {known}"
            )
        sizes[unknown[0]] = n // known
    need = int(np.prod(sizes))
    if need > n:
        raise FriendlyError(
            f"mesh {dict(zip(names, sizes))} needs {need} devices, have {n}"
        )
    grid = torch.tensor(ranks[:need], dtype=torch.int64).reshape(sizes)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, the JAX ``Mesh.shape`` mapping."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis_name: str) -> int:
    """Size of the named mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def batch_spec(mesh, axis: str = DATA_AXIS):
    """DTensor placements splitting the leading (batch) dim over ``axis``
    and replicating over every other mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated_spec(mesh):
    """Fully-replicated DTensor placements (params under pure DP)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> None:
    """Start the process group every rank of a multi-process run joins.

    Arguments default to the ``torch.distributed`` environment contract
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets them); ``coordinator_address`` is ``"host:port"``.
    With neither arguments nor environment this is a single-process
    no-op, as in the JAX package. The group uses NCCL on the card (rank
    ``r`` on card ``r`` modulo the cards this host sees); ``device="cpu"``
    asks for gloo. Without a GPU, the default raises rather than taking
    gloo."""
    import torch
    import torch.distributed as dist

    from mmlspark_tpu_torch.core.env import default_device

    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        return  # single process: nothing to do
    if num_processes is None or process_id is None:
        raise FriendlyError(
            f"coordinator {coordinator_address!r} given without the "
            "process count and id (WORLD_SIZE and RANK)"
        )
    dev = default_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


# -- a rank's place on an axis, and the differentiable moves between views ---

#: set inside :func:`local_batch`: True, or the data axis to reduce batch
#: statistics over
_LOCAL_BATCH = contextvars.ContextVar("mmlspark_tpu_torch_local_batch",
                                      default=False)


@contextlib.contextmanager
def local_batch(data: "MeshAxis | None" = None):
    """Within this block the batch dim of what the parallel functions
    receive is the calling rank's data shard already (the mesh trainer's
    step): they do not split it over ``data`` again. With ``data`` (the
    rank's :class:`MeshAxis` on it), a train-mode BatchNorm reduces its
    batch statistics over that axis: the global batch's."""
    token = _LOCAL_BATCH.set(data if data is not None else True)
    try:
        yield
    finally:
        _LOCAL_BATCH.reset(token)


def in_local_batch() -> bool:
    """Whether the caller is inside :func:`local_batch`."""
    return _LOCAL_BATCH.get() is not False


def batch_stats_axis() -> "MeshAxis | None":
    """The data axis of more than one rank that batch statistics reduce
    over inside :func:`local_batch`, else None."""
    axis = _LOCAL_BATCH.get()
    if isinstance(axis, MeshAxis) and axis.size > 1:
        return axis
    return None


def batch_split_axis(mesh, batch_axis: str | None, batch: int) -> str | None:
    """The axis a parallel function splits a global batch of ``batch``
    rows over: ``batch_axis`` when the mesh has it and it divides the
    batch (the JAX package's dp x sp / dp x pp rule), else None — and
    always None inside :func:`local_batch`."""
    if batch_axis is None or in_local_batch():
        return None
    shape = mesh_shape(mesh)
    if batch_axis in shape and batch % shape[batch_axis] == 0:
        return batch_axis
    return None


class MeshAxis:
    """The calling rank's place along one mesh axis: its process group,
    the group's global ranks in axis order, its index and the size."""

    def __init__(self, mesh, axis: str):
        import torch.distributed as dist

        self.name = axis
        self.group = mesh.get_group(axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.index = mesh.get_local_rank(axis)
        self.size = len(self.ranks)

    def __deepcopy__(self, memo):
        # a handle on a process group: a copied module shares it
        return self

    def peer(self, hops: int) -> int:
        return self.ranks[(self.index + hops) % self.size]


def all_gather_cat(x: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in axis
    order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis`` (a new tensor)."""
    import torch.distributed as dist

    out = x.detach().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class Scatter(torch.autograd.Function):
    """A replicated tensor -> this rank's chunk along ``dim``; the
    backward gathers every rank's chunk of the gradient back."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return x.chunk(axis.size, dim=dim)[axis.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.axis), None, None


class Gather(torch.autograd.Function):
    """Every rank's chunk along ``dim`` -> the replicated tensor; the
    backward keeps this rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather_cat(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.axis.size, dim=ctx.dim)[ctx.axis.index]
                .contiguous(), None, None)


class AllReduce(torch.autograd.Function):
    """The sum over ``axis`` of a per-rank partial (every rank's loss
    depends on the sum, so the backward sums the ranks' gradients too)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class CopyToAxis(torch.autograd.Function):
    """A tensor every rank of ``axis`` holds whole, entering a product
    each rank computes only its part of (a column-parallel ``Dense``,
    the rank's experts): the forward is the identity, the backward sums
    the ranks' partial gradients over ``axis`` — Megatron's ``f``."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class ReduceFromAxis(torch.autograd.Function):
    """The sum over ``axis`` of every rank's partial product (a
    row-parallel ``Dense``, the vocab-parallel embedding rows, the
    experts' combine), which every rank then uses whole: the backward is
    the identity — Megatron's ``g``, the conjugate of
    :class:`CopyToAxis`."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class SumGrads(torch.autograd.Function):
    """Tensors every rank holds whole while each rank works on its own
    part of the data: the forward is the identity, the backward sums
    every gradient over ``axes`` (one flat bucket, one all-reduce an
    axis) — the transpose of the JAX package's replicated ``shard_map``
    inputs."""

    @staticmethod
    def forward(ctx, axes, *leaves):
        ctx.axes = axes
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads])
        for axis in ctx.axes:
            dist.all_reduce(flat, group=axis.group)
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return (None, *out)


# -- the serving mesh: a rank's data and model axes --------------------------

#: outcome codes of one guarded engine step, in the order agreement takes
#: the worst of them
_OK, _TRANSIENT, _EXHAUSTED, _KILLED, _FATAL = range(5)


def _error_code(err: BaseException | None) -> int:
    from mmlspark_tpu_torch.core.faults import (
        EngineKilled,
        is_resource_exhausted,
        is_transient,
    )

    if err is None:
        return _OK
    if isinstance(err, EngineKilled):
        return _KILLED
    if is_resource_exhausted(err):
        return _EXHAUSTED
    if is_transient(err):
        return _TRANSIENT
    return _FATAL


class MeshDesync(FriendlyError):
    """A guarded call failed on some ranks of a serving mesh and ran on
    others: their collectives no longer pair up, so no rank may retry."""


class ModelPlace:
    """The calling rank's place on a mesh's ``model`` axis, and the two
    moves of the Megatron split over it (``models/transformer.
    split_graph``). The mesh may hold any other axes (the trainer's
    ``data``, ``seq``, ``pipe``, ``expert``); an absent ``model`` axis
    is None and both moves are identities. An axis the mesh has, of one
    rank included, issues its collectives; on ``meta`` tensors (the
    engine's cost analysis) nothing is communicated.

    The moves record their transposes when autograd tracks the tensor
    (the trainer's split step): :meth:`model_copy` is
    :class:`CopyToAxis`, :meth:`model_sum` :class:`ReduceFromAxis`.
    Otherwise (``no_grad``, the serving engine's captured programs) the
    copy is the tensor itself and the sum is taken in place."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        self.ranks = ranks
        self.devices = len(ranks)
        self.member = dist.get_rank() in ranks
        self.model = None
        if self.member and MODEL_AXIS in self.shape:
            self.model = MeshAxis(mesh, MODEL_AXIS)

    def __deepcopy__(self, memo):
        # held by the split graph's modules: a copied module shares it
        return self

    @property
    def model_size(self) -> int:
        return self.model.size if self.model is not None else 1

    @property
    def model_index(self) -> int:
        return self.model.index if self.model is not None else 0

    def _tracked(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and x.requires_grad

    def model_copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering a column-parallel product: itself; under
        autograd its gradient is summed over ``model``."""
        if self.model is None or x.device.type == "meta" \
                or not self._tracked(x):
            return x
        return CopyToAxis.apply(x, self.model)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``model``: the row-parallel partial products
        and the vocab-parallel embedding rows. In place, unless autograd
        tracks ``x`` (then a new tensor whose gradient is the
        identity)."""
        import torch.distributed as dist

        if self.model is None or x.device.type == "meta":
            return x
        if self._tracked(x):
            return ReduceFromAxis.apply(x, self.model)
        dist.all_reduce(x, group=self.model.group)
        return x


class MeshPlace(ModelPlace):
    """The calling rank's place on a serving mesh of ``data`` and
    ``model`` axes, and the moves the engine's mesh mode makes over them.

    Every rank runs the same host loop on the same requests. ``data``
    splits the slot rows, ``model`` the heads, the MLP's hidden columns
    and the vocabulary (Megatron, :class:`ModelPlace`); an axis the mesh
    lacks is None and its moves are identities. An axis the mesh has, of
    one rank included, issues its collectives (NCCL on the card, inside
    the captured programs; gloo on the CPU). On ``meta`` tensors (the
    engine's cost analysis) every move returns its shape and
    communicates nothing.

    A mesh of several ranks also holds a gloo group over them, the
    control plane: :meth:`agree_max`, :meth:`agree_error` and
    :meth:`clock` make host decisions that one rank could take
    differently (an error it alone saw, a wall-clock reading) the same on
    every rank before any collective depends on them."""

    def __init__(self, mesh):
        import torch.distributed as dist

        shape = mesh_shape(mesh)
        other = {a: s for a, s in shape.items()
                 if a not in (DATA_AXIS, MODEL_AXIS) and s > 1}
        if other:
            raise FriendlyError(
                f"a serving mesh splits slots over '{DATA_AXIS}' and the "
                f"model over '{MODEL_AXIS}'; axes {other} have no serving "
                "meaning (the sequence, pipeline and expert axes train)"
            )
        super().__init__(mesh)
        # a collective of the whole group: every rank makes it, in or out
        self.control = (dist.new_group(self.ranks, backend="gloo")
                        if len(self.ranks) > 1 else None)
        self.data = None
        if self.member and DATA_AXIS in self.shape:
            self.data = MeshAxis(mesh, DATA_AXIS)

    @property
    def data_size(self) -> int:
        return self.data.size if self.data is not None else 1

    @property
    def data_index(self) -> int:
        return self.data.index if self.data is not None else 0

    # -- the device moves ------------------------------------------------

    def _gather(self, x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
        """(n, *x.shape): every rank's ``x`` along ``axis``, in axis
        order."""
        if x.device.type == "meta":
            return x.unsqueeze(0).expand(axis.size, *x.shape).clone()
        return all_gather_cat(x[None], 0, axis)

    def data_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every ``data`` rank's rows of ``x``, concatenated in slot
        order (dim 0)."""
        if self.data is None:
            return x
        parts = self._gather(x, self.data)
        return parts.reshape(parts.shape[0] * parts.shape[1],
                             *parts.shape[2:])

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token over vocab-parallel ``logits`` (this rank's
        contiguous slice of the vocabulary on the last dim): each rank's
        local maximum and its global id, gathered over ``model`` in one
        collective, and the best of them — ties to the lowest rank, so
        to the lowest vocab id, as ``torch.argmax`` and ``jnp.argmax``
        break them. int32."""
        logits = logits.float()
        idx = logits.argmax(dim=-1)
        if self.model is None:
            return idx.to(torch.int32)
        n = logits.shape[-1]
        if self.model.size * n > 2 ** 24:
            raise FriendlyError(
                f"vocab {self.model.size * n} exceeds 2**24: the greedy "
                "combine carries token ids in float32"
            )
        vals = torch.gather(logits, -1, idx[..., None])[..., 0]
        gid = (idx + self.model.index * n).float()
        parts = self._gather(torch.stack([vals, gid], dim=-1), self.model)
        best = parts[..., 0].argmax(dim=0)
        return torch.gather(parts[..., 1], 0, best[None])[0].to(torch.int32)

    def data_broadcast(self, x: torch.Tensor, src_index: int) -> None:
        """``x`` of data rank ``src_index`` into every data rank's ``x``,
        in place (one collective; the same model rank on each)."""
        import torch.distributed as dist

        if self.data is not None:
            dist.broadcast(x, src=self.data.ranks[src_index],
                           group=self.data.group)

    # -- the control plane -------------------------------------------------

    def agree_max(self, values: Sequence[float]) -> list[float]:
        """Every rank's ``values``, reduced by max over the mesh (the
        same list on every rank)."""
        import torch.distributed as dist

        if self.control is None:
            return list(values)
        t = torch.tensor(list(values), dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return t.tolist()

    def clock(self) -> float:
        """A wall clock every rank reads alike: the latest of the ranks'
        ``time.monotonic()`` (a supervisor's hedging and stall probes)."""
        import time

        return self.agree_max([time.monotonic()])[0]

    def agree_error(self, err: BaseException | None, site: str):
        """The outcome of one guarded step BEFORE its call, agreed by
        every rank: the worst error any rank saw (a fault site firing, a
        failed allocation), so all retry, degrade or die together. A rank
        that saw nothing gets an error of the agreed kind; returns None
        when no rank failed."""
        from mmlspark_tpu_torch.core.faults import (
            EngineKilled,
            ResourceExhausted,
            TransientFault,
        )

        code = _error_code(err)
        worst = int(self.agree_max([code])[0])
        if worst == code:
            return err
        what = f"at {site} on another rank of the serving mesh"
        return {
            _TRANSIENT: TransientFault(f"transient fault {what}"),
            _EXHAUSTED: ResourceExhausted(what),
            _KILLED: EngineKilled(f"engine killed {what}"),
        }.get(worst) or MeshDesync(f"a non-retryable error {what}")

    def agree_after(self, err: BaseException | None, site: str) -> None:
        """The outcome of one guarded CALL, agreed: nothing when every
        rank succeeded or every rank failed alike (the caller handles its
        own error); :class:`MeshDesync` on every rank when the call
        failed on some ranks only — the others ran its collectives, so
        no retry can pair them up again."""
        if self.control is None:
            return
        code = _error_code(err)
        lo, hi = self.agree_max([-code, code])
        lo = -lo
        if lo == hi:
            return
        raise MeshDesync(
            f"{site} failed on some ranks of the serving mesh and ran on "
            "others; their collectives no longer match, so the mesh engine "
            "stops (rebuild it from a snapshot)"
        ) from err


#: (default group, axes or mesh, place) of every serving mesh resolved in
#: this process: a mesh's subgroups are made collectively, so every engine
#: asking for the same axes in one process group must share them
_SERVE_MESHES: list = []


def serve_mesh(mesh) -> MeshPlace | None:
    """The serving engine's ``mesh`` argument — a spec string
    (``"data=2,model=2"``), an axes mapping or a built DeviceMesh, the
    forms of the JAX engine's ``_resolve_mesh`` — as the calling rank's
    :class:`MeshPlace`, or None. A spec or a mapping resolves once per
    process group: engines asking for the same axes (the replicas of a
    supervised set) share one mesh and its groups, which are made
    collectively on every rank."""
    import torch.distributed as dist

    if mesh is None:
        return None
    if isinstance(mesh, str):
        mesh = parse_mesh_axes(mesh)
    _group_device_type()
    world = dist.distributed_c10d._get_default_group()
    key = dict(mesh) if isinstance(mesh, Mapping) else mesh
    for group, k, place in _SERVE_MESHES:
        if group is world and (k is key or (
                isinstance(k, dict) and isinstance(key, dict) and k == key)):
            return place
    place = MeshPlace(make_mesh(mesh) if isinstance(mesh, Mapping) else mesh)
    _SERVE_MESHES.append((world, key, place))
    return place
