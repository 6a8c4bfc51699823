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
  optimizer state follows it. The rules split the COMPUTE, as GSPMD does
  in the JAX package:

  - **Tensor parallelism.** A transformer LM on a mesh with a ``model``
    axis runs each rank's copy of :func:`~mmlspark_tpu_torch.models.
    transformer.split_graph` bound to its shards, ungathered: ``qkv`` and
    ``mlp_in`` column-parallel (``qkv`` head-aligned, :func:`~
    mmlspark_tpu_torch.parallel.sharding.cut_leaf`), ``attn_out`` and
    ``mlp_out`` row-parallel with one sum over ``model`` each, the
    vocab-parallel embedding rows and ``head`` columns, and the loss
    over the rank's vocab slice (:func:`vocab_parallel_loss_terms`).
    Every collective has its transpose in the backward, so each shard's
    gradient is local and each replicated leaf's whole. Under GQA with
    ``model % kv_heads == 0`` a rank stores the kv head its q heads
    share; those rows' gradients are summed over the ranks that read
    them and the gradient norm counts them once. A ``{"model": 1}`` axis
    runs the same code path.
  - **Expert parallelism.** Under ``EXPERT_RULES`` each ``expert`` rank
    runs only its experts (:func:`~mmlspark_tpu_torch.models.moe.
    expert_local_graph`, ``parallel/expert.py``).
  - **Pipeline stages.** Each ``pipe`` rank keeps and runs its own
    stacked stage, ungathered.

  Any other sharded leaf (a rule set on a model with no split form, a
  layer the split degrades to whole) is gathered for the step, one
  all-gather of a flat bucket an axis, whose backward keeps the rank's
  part of the gradient (every rank of the axis computed the same one).
  The fused optimizer updates the local shards; the gradient norm
  counts every replicated leaf once and sums each sharded leaf's
  squares over its axes. A rule that shards over ``data`` is refused.
- **Checkpoints** hold whole tensors: rank 0 writes them (the split's
  shards joined over ``model``), every rank restores and cuts its part,
  so a mesh run's payload equals a one-device run's and a resume at
  another ``data`` or ``model`` width works.
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
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    MeshAxis,
    make_mesh,
    mesh_shape,
)

#: the graphs the trainer splits over ``model`` (``split_graph``'s)
SPLIT_MODELS = ("transformer_lm", "transformer_lm_moe")


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


class _XentRest(torch.autograd.Function):
    """The vocab-parallel cross entropy of each row less the rank's own
    term, ``-log_softmax(x_r)[t]`` on the rank ``r`` that holds the
    target (0 elsewhere), which the caller computes through
    ``torch.log_softmax``. With ``lse_r`` the rank's log-sum-exp, the
    global one ``lse`` (the ranks' maximum through an all-reduce max,
    their shifted exponentials through an all-reduce sum, with the
    owner's ``lse_r`` and its term) and ``x_t = lse_r + log_softmax
    (x_r)[t]`` on the owner, the row's loss ``lse - x_t`` is
    ``(lse - lse_owner) + own term``. The backward gives the local
    logits ``softmax(x)`` on the rank's slice less the owner's
    ``softmax(x_r)``: with the own term's gradient, softmax minus
    one-hot. At one rank the rest and its gradient are exact zeros, so
    the loss and its gradients are ``F.cross_entropy``'s bit for bit."""

    @staticmethod
    def forward(ctx, logits, own, inside, axis):
        import torch.distributed as dist

        lse_r = torch.logsumexp(logits, dim=-1)
        top = lse_r.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=axis.group)
        parts = torch.stack([torch.exp(lse_r - top),
                             torch.where(inside, lse_r, 0.0), own])
        dist.all_reduce(parts, group=axis.group)
        lse = top + torch.log(parts[0])
        ctx.save_for_backward(logits, lse, lse_r, inside)
        return (lse - parts[1]) + (parts[2] - own)

    @staticmethod
    def backward(ctx, g):
        logits, lse, lse_r, inside = ctx.saved_tensors
        # softmax(x) - [owner] softmax(x_r) = softmax(x) (1 - e^(lse -
        # lse_r)): one exponential over the slice, exactly 0 at one rank
        scale = 1.0 - torch.where(inside, torch.exp(lse - lse_r), 0.0)
        grad = torch.exp(logits - lse[:, None]) * (scale * g)[:, None]
        return grad, None, None, None


def vocab_parallel_loss_terms(logits, labels, mask, axis: MeshAxis):
    """The softmax cross entropy's masked terms (the trainer's
    ``masked_loss_terms``: the weighted sum of per-token losses and the
    weights, (B,) or (B, T)) over vocab-parallel ``logits``: the last
    dim is the rank's ``axis.index``-th contiguous slice of the
    vocabulary, ``labels`` global ids. Each rank gets the same values
    (the whole loss's in another summation order; at one rank the same
    bits) and its slice's logit gradients, two all-reduces a call."""
    w = mask.float()
    if logits.ndim == 3:
        w = w[:, None] * torch.ones(logits.shape[:2], device=logits.device)
    n = logits.shape[-1]
    x = logits.reshape(-1, n).float()
    local = labels.reshape(-1).long() - axis.index * n
    inside = (local >= 0) & (local < n)
    picked = torch.log_softmax(x, dim=-1).gather(
        -1, torch.where(inside, local, 0)[:, None])[:, 0]
    own = -torch.where(inside, picked, 0.0)
    per = own + _XentRest.apply(x, own.detach(), inside, axis)
    return torch.sum(per.reshape(labels.shape) * w), w


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
        # (block, key) -> [(dim, axis name)]: the leaves stored as
        # contiguous chunks (the split's leaves are cut by split_how)
        self.layout: dict = {}
        # chunked leaves the step binds as stored: the pipeline's stacked
        # stages (parallel/pipeline.py) and the expert-local experts
        self.step_local: set = set()
        # the Megatron split over model: its ModelSplit, the rank's model
        # axis and how it cuts each leaf it computes on
        self.split = None
        self.model: MeshAxis | None = None
        self.split_how: dict = {}
        # the expert-local FFN's expert axis
        self.experts: MeshAxis | None = None
        self.whole_shapes: dict = {}
        # the graph the step runs (the rank's split and expert-local copy)
        self.step_graph = None

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
        """Each weight's layout by the rules (none without rules), the
        split over ``model`` and the expert-local FFN where the graph and
        the rules have them, and the graph the step runs."""
        self.whole_shapes = {(b, k): tuple(t.shape)
                             for b, block in weights.items()
                             for k, t in block.items()}
        self.step_graph = graph
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
                    self.step_local.add((b, k))
        self._plan_split(graph, weights)
        self._plan_experts(graph, weights)

    def _plan_split(self, graph, weights: dict) -> None:
        """The Megatron split of a transformer LM over a ``model`` axis
        (one rank included) where the rules shard a layer's leaves."""
        from mmlspark_tpu_torch.models.transformer import split_graph
        from mmlspark_tpu_torch.parallel.mesh import ModelPlace
        from mmlspark_tpu_torch.parallel.sharding import (
            model_split,
            split_leaves,
        )

        if MODEL_AXIS not in self.shape or graph.name not in SPLIT_MODELS:
            return
        place = ModelPlace(self.mesh)
        split = model_split(graph, weights, place, self.rules)
        if not (split.attn or split.mlp or split.vocab):
            return
        self.split, self.model = split, place.model
        self.split_how = split_leaves(graph, weights, split)
        for key in self.split_how:
            self.layout.pop(key, None)
        self.step_graph = split_graph(graph, split, place)

    def _plan_experts(self, graph, weights: dict) -> None:
        """The expert-local FFN where the rules put every expert leaf's
        stacked dim on an ``expert`` axis (one rank included)."""
        from mmlspark_tpu_torch.models.moe import MoEFFN, expert_local_graph
        from mmlspark_tpu_torch.parallel.sharding import (
            build_param_shardings,
        )

        if EXPERT_AXIS not in self.shape or not any(
                isinstance(m, MoEFFN) for _, mod in graph.blocks
                for m in mod.modules()):
            return
        sh = build_param_shardings(weights, self.mesh, self.rules, graph,
                                   keep_unit_axes=True)
        experts = [(b, k) for b, block in weights.items() for k in block
                   if ".experts." in f".{k}"]
        if not experts or any(sh[b][k].spec[:1] != (EXPERT_AXIS,)
                              for b, k in experts):
            return
        self.experts = MeshAxis(self.mesh, EXPERT_AXIS)
        self.step_local.update(key for key in experts if key in self.layout)
        self.step_graph = expert_local_graph(self.step_graph, self.experts)

    def shard(self, b: str, k: str, whole: torch.Tensor) -> torch.Tensor:
        """The rank's part of a whole leaf."""
        from mmlspark_tpu_torch.parallel.sharding import cut_leaf

        if (b, k) in self.split_how:
            return cut_leaf(self.split, self.split_how[(b, k)], whole)
        t = whole
        for dim, name in self.layout.get((b, k), ()):
            ax = MeshAxis(self.mesh, name)
            t = t.chunk(ax.size, dim=dim)[ax.index]
        return t.contiguous()

    def gather(self, local: dict, differentiable: bool = True,
               stages: bool = True) -> dict:
        """Whole tensors of the chunked leaves of ``local`` (``{block:
        {key: tensor}}`` holding the rank's shards): one all-gather a
        bucket of leaves that share their sharded axis; leaves sharded
        over several axes are gathered axis by axis. The split's leaves
        stay as they are (:meth:`whole` joins them). Without ``stages``
        (the step's binding) the pipeline's stage leaves and the
        expert-local experts stay the rank's own too."""
        out = {b: dict(block) for b, block in local.items()}
        pending = {key: list(dims) for key, dims in self.layout.items()
                   if key[0] in local and key[1] in local[key[0]]
                   and (stages or key not in self.step_local)}
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

    def whole(self, local: dict) -> dict:
        """Whole tensors of every leaf of ``local`` (no autograd): the
        chunked leaves gathered, the split's joined over ``model`` in one
        all-gather (:func:`~mmlspark_tpu_torch.parallel.sharding.
        join_leaf`)."""
        import torch.distributed as dist

        from mmlspark_tpu_torch.parallel.sharding import join_leaf

        out = self.gather(local, differentiable=False)
        keys = [key for key in self.split_how
                if key[0] in local and key[1] in local[key[0]]]
        if not keys:
            return out
        with torch.no_grad():
            flat = torch.cat([local[b][k].reshape(-1) for b, k in keys])
            parts = torch.empty(self.model.size, flat.numel(),
                                dtype=flat.dtype, device=flat.device)
            dist.all_gather(list(parts.unbind(0)), flat,
                            group=self.model.group)
            off = 0
            for b, k in keys:
                t = local[b][k]
                out[b][k] = join_leaf(self.split, self.split_how[(b, k)], [
                    p[off:off + t.numel()].view_as(t) for p in parts])
                off += t.numel()
        return out

    # -- the step's collectives ---------------------------------------------------

    def sum_shared_kv(self, keys: list, grads: list) -> list:
        """``grads`` with the rows of each kv head that several ``model``
        ranks hold (GQA, ``model`` > ``kv_heads``) summed over those
        ranks: each rank's ``qkv`` kv rows (all its kv head's) at the kv
        head's place in a zeroed bucket, one all-reduce over ``model``.
        The same list when no kv head is shared."""
        import torch.distributed as dist

        split = self.split
        if split is None or split.kv_share == 1:
            return grads
        q = split.local_heads * split.head_dim
        idx = [i for i, key in enumerate(keys)
               if self.split_how.get(key) == "qkv"]
        flat = torch.cat([grads[i][q:].reshape(-1) for i in idx])
        bucket = flat.new_zeros(split.kv_heads, flat.numel())
        kv = split.kv_range[0]
        bucket[kv] = flat
        dist.all_reduce(bucket, group=self.model.group)
        out, off = list(grads), 0
        for i in idx:
            g = grads[i]
            n = g[q:].numel()
            out[i] = torch.cat([g[:q], bucket[kv, off:off + n].view_as(
                g[q:])])
            off += n
        return out

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

        rep = [g for key, g in zip(keys, grads)
               if key not in self.layout and key not in self.split_how]
        sq = sum(torch.sum(g * g) for g in rep)
        by_axes: dict = {}
        for key, g in zip(keys, grads):
            if key in self.layout:
                axes = tuple(sorted({a for _, a in self.layout[key]}))
                by_axes.setdefault(axes, []).append(torch.sum(g * g))
            elif key in self.split_how:
                by_axes.setdefault((MODEL_AXIS,), []).append(
                    self._split_sq(key, g))
        for axes, parts in by_axes.items():
            part = torch.stack(parts).sum()
            for name in axes:
                dist.all_reduce(part, group=MeshAxis(self.mesh, name).group)
            sq = sq + part
        return torch.sqrt(sq)

    def _split_sq(self, key, g):
        """The squares of a split leaf's gradient this rank counts: all
        of them, but a shared kv head's rows on the first of its ranks
        only."""
        split = self.split
        if self.split_how[key] != "qkv" or split.kv_share == 1:
            return torch.sum(g * g)
        q = split.local_heads * split.head_dim
        sq = torch.sum(g[:q] * g[:q])
        if split.index % split.kv_share == 0:
            sq = sq + torch.sum(g[q:] * g[q:])
        return sq

    # -- whole-state views (checkpoints, the vote) -------------------------------

    def whole_state(self, state: dict) -> dict:
        """``state`` with every sharded leaf — the weight and its moments
        — gathered whole (a host-bound copy: no autograd)."""
        out = dict(state)
        out["params"] = self.whole(state["params"])
        opt = dict(state["opt_state"])
        keys = [(b, k) for b, block in state["params"].items()
                for k in block]
        for name, moments in opt.items():
            if isinstance(moments, list):
                nest = _nest(keys, moments)
                whole = self.whole(nest)
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
        whole_shape = self.whole_shapes  # recorded by plan()
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
