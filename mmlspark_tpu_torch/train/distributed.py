"""The trainer's mesh mode: what :class:`~mmlspark_tpu_torch.train.trainer.
SPMDTrainer` does over a :func:`~mmlspark_tpu_torch.parallel.mesh.
make_mesh` DeviceMesh of an initialised process group (NCCL on the card,
gloo when the caller asks for the CPU) — the part of
``mmlspark_tpu/train/trainer.py`` that GSPMD does there.

Every rank runs the same step program on its own shard of the data:

- **Data parallelism.** The global batch (rounded up to a multiple of the
  ``data`` width) splits into contiguous row blocks, one a ``data``
  coordinate; every other axis sees the same rows. The loss is normalised
  by the GLOBAL mask count — the counts are all-reduced before the
  backward, so a padded tail or a mask leaves the step the global math —
  and the gradients (with the loss) are summed over ``data`` in one flat
  bucket: one collective for the counts and one for the gradients a step.
- **Parameter rules** (``param_rules``: ``TRANSFORMER_TP_RULES``,
  ``PIPELINE_STAGE_RULES``, ``EXPERT_RULES``). Each leaf's layout comes
  from :func:`~mmlspark_tpu_torch.parallel.sharding.build_param_shardings`
  (the JAX package's spec, carried to the port's axes through the weight
  bridge); a rank stores only its shard of a sharded leaf, and the
  optimizer state follows it. The step gathers the shards of each axis in
  one all-gather of a flat bucket and runs the model on whole tensors —
  the placement is a storage layout, the arithmetic the global one; the
  gather's backward keeps the rank's part of the gradient (every rank of
  the axis computed the same one). The pipeline's stacked stages are the
  exception: each ``pipe`` rank keeps and runs its own stage, ungathered,
  so a rank holds one stage's weights and gradients. The fused optimizer updates the local
  shards; the gradient norm counts every replicated leaf once and sums
  each sharded leaf's squares over its axes. A rule that shards over
  ``data`` is refused.
- **Checkpoints** hold whole tensors: rank 0 writes them, every rank
  restores and keeps its shard, so a mesh run's payload equals a
  one-device run's and a resume at another ``data`` width works.
- **The audit's vote.** Without rules every rank holds a whole replica:
  each folds its copy on the host, the folds are all-gathered, the
  majority wins, and a divergent replica is re-replicated from the lowest
  rank that holds the majority. Under rules a rank's copy is a shard and
  there is no vote (as in the JAX package): each rank compares its own
  folds.

Inside the step the model runs under :func:`~mmlspark_tpu_torch.parallel.
mesh.local_batch`, so ring/Ulysses attention, the pipeline and the
sequence-parallel BiLSTM split only their own axes, and BatchNorm reduces
its batch statistics over ``data`` (the global batch's, as the JAX
package's BatchNorm computes them on the sharded array).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError, ParamError
from mmlspark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    PIPELINE_AXIS,
    MeshAxis,
    make_mesh,
    mesh_shape,
)


def wants_mesh(cfg) -> bool:
    """Whether a config asks for the mesh mode: ``mesh_axes`` other than
    None or ``{"data": 1}``, or ``{"data": 1}`` inside an initialised
    process group. ``mesh_axes=None`` is one device (a process holds one
    card); ``param_rules`` on one device are identities."""
    import torch.distributed as dist

    if cfg.mesh_axes is None:
        return False
    if dict(cfg.mesh_axes) == {DATA_AXIS: 1}:
        return dist.is_available() and dist.is_initialized()
    return True


class _GatherShards(torch.autograd.Function):
    """The whole tensors of leaves sharded over one axis: one all-gather
    of the ranks' flat buckets. The backward keeps the rank's part of
    each whole gradient (the same on every rank of the axis)."""

    @staticmethod
    def forward(ctx, axis, dims, *shards):
        import torch.distributed as dist

        ctx.axis, ctx.dims = axis, dims
        flat = torch.cat([s.reshape(-1) for s in shards])
        out = torch.empty(axis.size, flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        dist.all_gather(list(out.unbind(0)), flat, group=axis.group)
        whole, off = [], 0
        for s, dim in zip(shards, dims):
            part = out[:, off:off + s.numel()].reshape(axis.size, *s.shape)
            whole.append(torch.cat(part.unbind(0), dim=dim))
            off += s.numel()
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        axis = ctx.axis
        return (None, None, *(
            None if g is None else
            g.chunk(axis.size, dim=d)[axis.index].contiguous()
            for g, d in zip(grads, ctx.dims)))


class MeshRun:
    """One training run's mesh: the axes, the rank's place, the layout of
    every parameter and the collectives of the step."""

    def __init__(self, cfg, device):
        import torch.distributed as dist

        self.mesh = make_mesh(cfg.mesh_axes)
        if (self.mesh.device_type == "cuda") != (device.type == "cuda"):
            raise FriendlyError(
                f"the process group runs {dist.get_backend()} on "
                f"{self.mesh.device_type}, the trainer on {device}: NCCL "
                "groups train on the card, gloo groups on the CPU")
        self.shape = mesh_shape(self.mesh)
        ranks = self.mesh.mesh.flatten().tolist()
        # every rank of the world takes part in making the groups
        self.group = dist.new_group(ranks) \
            if len(ranks) != dist.get_world_size() else dist.group.WORLD
        self.in_mesh = self.mesh.get_coordinate() is not None
        self.ranks = ranks
        self.rank = ranks.index(dist.get_rank()) if self.in_mesh else None
        self.n_data = self.shape.get(DATA_AXIS, 1)
        self.data = MeshAxis(self.mesh, DATA_AXIS) \
            if self.in_mesh and DATA_AXIS in self.shape else None
        self.rules = cfg.param_rules
        self.layout: dict = {}  # (block, key) -> [(dim, axis name)]
        # stacked pipeline stages sharded one a pipe rank: the step runs
        # the rank's stage as it is stored (parallel/pipeline.py)
        self.stage_local: set = set()

    @property
    def data_index(self) -> int:
        return self.data.index if self.data is not None else 0

    # -- the batch ------------------------------------------------------------

    def local_rows(self, arr: np.ndarray) -> np.ndarray:
        """The rank's contiguous block of a global batch's rows."""
        rows = len(arr) // self.n_data
        i = self.data_index
        return arr[i * rows:(i + 1) * rows]

    # -- parameter layout -------------------------------------------------------

    def plan(self, graph, weights: dict) -> None:
        """Each weight's sharded dims by the rules (none without rules)."""
        if not self.rules:
            return
        from mmlspark_tpu_torch.parallel.sharding import (
            build_param_shardings,
        )

        shardings = build_param_shardings(weights, self.mesh, self.rules,
                                          graph)
        modules = dict(getattr(graph, "blocks", ()))
        for b, block in weights.items():
            for k in block:
                spec = shardings[b][k].spec
                dims = [(d, a) for d, a in enumerate(spec) if a is not None]
                if any(a == DATA_AXIS for _, a in dims):
                    raise ParamError(
                        f"param_rules shard '{b}.{k}' over '{DATA_AXIS}': "
                        "the trainer shards parameters over the other axes "
                        "only (the batch splits over data)")
                if dims:
                    self.layout[(b, k)] = dims
                if dims == [(0, PIPELINE_AXIS)] and getattr(
                        modules.get(b), "stacked", False):
                    self.stage_local.add((b, k))

    def shard(self, b: str, k: str, whole: torch.Tensor) -> torch.Tensor:
        """The rank's part of a whole leaf."""
        t = whole
        for dim, name in self.layout.get((b, k), ()):
            ax = MeshAxis(self.mesh, name)
            t = t.chunk(ax.size, dim=dim)[ax.index]
        return t.contiguous()

    def gather(self, local: dict, differentiable: bool = True,
               stages: bool = True) -> dict:
        """Whole tensors of ``local`` (``{block: {key: tensor}}`` holding
        the rank's shards): one all-gather a bucket of leaves that share
        their sharded axis; leaves sharded over several axes are gathered
        axis by axis. Without ``stages`` (the step) the pipeline's stage
        leaves stay the rank's own stage."""
        out = {b: dict(block) for b, block in local.items()}
        pending = {key: list(dims) for key, dims in self.layout.items()
                   if key[0] in local and key[1] in local[key[0]]
                   and (stages or key not in self.stage_local)}
        while pending:
            # innermost sharded dim first: the reverse of shard()'s order
            by_axis: dict = {}
            for key, dims in pending.items():
                by_axis.setdefault(dims[-1][1], []).append(key)
            for name, keys in by_axis.items():
                ax = MeshAxis(self.mesh, name)
                dims = tuple(pending[key][-1][0] for key in keys)
                shards = [out[b][k] for b, k in keys]
                if differentiable:
                    whole = _GatherShards.apply(ax, dims, *shards)
                else:
                    with torch.no_grad():
                        whole = _GatherShards.apply(ax, dims, *shards)
                for (b, k), t in zip(keys, whole):
                    out[b][k] = t
                    pending[(b, k)].pop()
            pending = {k: v for k, v in pending.items() if v}
        return out

    # -- the step's collectives ---------------------------------------------------

    def sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over ``data`` (a new tensor; every mesh has one
        collective here, a one-rank axis included)."""
        import torch.distributed as dist

        out = t.detach().clone()
        if self.data is not None:
            dist.all_reduce(out, group=self.data.group)
        return out

    def reduce_grads(self, grads: list, extra: list) -> tuple[list, list]:
        """Sum ``grads`` and the scalars ``extra`` over ``data`` in one
        flat bucket; returns them in their shapes."""
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [e.reshape(1).to(grads[0].dtype) for e in extra])
        if self.data is not None:
            dist.all_reduce(flat, group=self.data.group)
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return out, [flat[off + i] for i in range(len(extra))]

    def grad_norm(self, keys: list, grads: list):
        """The global gradient norm: the replicated leaves' squares once,
        each sharded leaf's summed over its axes (one all-reduce an axis
        set)."""
        import torch.distributed as dist

        rep = [g for key, g in zip(keys, grads) if key not in self.layout]
        sq = sum(torch.sum(g * g) for g in rep)
        by_axes: dict = {}
        for key, g in zip(keys, grads):
            if key in self.layout:
                axes = tuple(sorted({a for _, a in self.layout[key]}))
                by_axes.setdefault(axes, []).append(torch.sum(g * g))
        for axes, parts in by_axes.items():
            part = torch.stack(parts).sum()
            for name in axes:
                dist.all_reduce(part, group=MeshAxis(self.mesh, name).group)
            sq = sq + part
        return torch.sqrt(sq)

    # -- whole-state views (checkpoints, the vote) -------------------------------

    def whole_state(self, state: dict) -> dict:
        """``state`` with every sharded leaf — the weight and its moments
        — gathered whole (a host-bound copy: no autograd)."""
        out = dict(state)
        out["params"] = self.gather(state["params"], differentiable=False)
        opt = dict(state["opt_state"])
        keys = [(b, k) for b, block in state["params"].items()
                for k in block]
        for name, moments in opt.items():
            if isinstance(moments, list):
                nest = _nest(keys, moments)
                whole = self.gather(nest, differentiable=False)
                opt[name] = [whole[b][k] for b, k in keys]
        out["opt_state"] = opt
        return out

    def load_whole(self, state: dict, whole: dict) -> None:
        """Copy a whole-tensor state (a restored checkpoint, on the CPU)
        into the rank's ``state`` tensors, each sharded leaf as its
        part."""
        keys = [(b, k) for b, block in state["params"].items()
                for k in block]
        with torch.no_grad():
            for b, k in keys:
                state["params"][b][k].copy_(
                    self.shard(b, k, whole["params"][b][k]))
            for name, moments in state["opt_state"].items():
                if isinstance(moments, list):
                    for (b, k), t, w in zip(keys, moments,
                                            whole["opt_state"][name]):
                        t.copy_(self.shard(b, k, w))
                else:
                    moments.copy_(whole["opt_state"][name])
            for b, block in state["rest"].items():
                for k, t in block.items():
                    t.copy_(whole["rest"][b][k])
            for k, t in state["anomaly"].items():
                t.copy_(whole["anomaly"][k])

    def whole_template(self, state: dict) -> dict:
        """Meta tensors of the whole state's shapes and dtypes (the
        restore target)."""
        def meta(t, shape=None):
            return torch.empty(shape or t.shape, dtype=t.dtype,
                               device="meta")

        keys = [(b, k) for b, block in state["params"].items()
                for k in block]
        whole_shape = {key: self._whole_shape(key, state["params"][key[0]][
            key[1]].shape) for key in keys}
        return {
            "params": {b: {k: meta(t, whole_shape[(b, k)])
                           for k, t in block.items()}
                       for b, block in state["params"].items()},
            "rest": {b: {k: meta(t) for k, t in block.items()}
                     for b, block in state["rest"].items()},
            "opt_state": {
                name: ([meta(t, whole_shape[key])
                        for key, t in zip(keys, v)]
                       if isinstance(v, list) else meta(v))
                for name, v in state["opt_state"].items()},
            "anomaly": {k: meta(t) for k, t in state["anomaly"].items()},
        }

    def _whole_shape(self, key, shape) -> tuple:
        shape = list(shape)
        for dim, name in self.layout.get(key, ()):
            shape[dim] *= self.shape[name]
        return tuple(shape)

    # -- host-side agreement -----------------------------------------------------

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.mesh.device_type == "cuda":
            dist.barrier(group=self.group,
                         device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=self.group)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank of the mesh."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        return box[0]

    def all_gather_ints(self, values: list[int]) -> list[list[int]]:
        """Every rank's list of ints (uint32 folds), in mesh-rank order."""
        import torch.distributed as dist

        dev = "cuda" if self.mesh.device_type == "cuda" else "cpu"
        t = torch.tensor(values, dtype=torch.int64, device=dev)
        parts = [torch.empty_like(t) for _ in self.ranks]
        dist.all_gather(parts, t, group=self.group)
        return [[int(v) for v in p.cpu().tolist()] for p in parts]

    def vote(self, host_fold: int, device_fold: int):
        """The cross-replica vote: ``(majority, divergent ranks, rank 0's
        in-graph fold, the folds by rank)``; ties go to the smaller fold,
        as in the JAX package."""
        table = self.all_gather_ints([host_fold, device_fold])
        folds = {r: f for r, (f, _) in enumerate(table)}
        counts = Counter(folds.values())
        top = max(counts.values())
        majority = min(v for v, c in counts.items() if c == top)
        divergent = sorted(r for r, f in folds.items() if f != majority)
        return majority, divergent, table[0][1], folds

    def replicate_from(self, tensors: list, src: int) -> None:
        """Overwrite every rank's ``tensors`` with mesh rank ``src``'s."""
        import torch.distributed as dist

        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=self.ranks[src], group=self.group)

    def corrupt_target(self, seed: int, n_candidates: int) -> int:
        """The mesh rank whose copy the ``train.step`` corrupt drill flips:
        drawn after the leaf from ``default_rng(seed)``, as the JAX
        package draws the device among a leaf's shards."""
        rng = np.random.default_rng(seed)
        rng.integers(n_candidates)
        return int(rng.integers(len(self.ranks)))


def _nest(keys: list, values: list) -> dict:
    out: dict = {}
    for (b, k), v in zip(keys, values):
        out.setdefault(b, {})[k] = v
    return out
