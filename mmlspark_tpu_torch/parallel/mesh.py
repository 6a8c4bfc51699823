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
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np

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
