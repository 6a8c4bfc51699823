"""Pipeline parallelism: GPipe-style microbatched stage rotation — the port
of ``mmlspark_tpu/parallel/pipeline.py``.

A model's homogeneous trunk (transformer blocks) is cut into contiguous
stages laid out over the ``pipe`` mesh axis, and microbatches stream
through the stages with one point-to-point hop a tick.

The schedule is the JAX package's, one program on every rank:

- stage parameters are *stacked* on a leading dim of size ``n_stages``;
  rank ``i`` of the ``pipe`` axis applies stage ``i``;
- ``M + n_stages - 1`` ticks run. At tick ``t`` rank 0 feeds microbatch
  ``min(t, M - 1)`` (the drain ticks re-feed the last one, whose outputs
  are never kept), every rank applies its stage, and the last rank keeps
  microbatch ``t - (n_stages - 1)`` once that is >= 0;
- outputs move one rank down the axis (``batch_isend_irecv``; no
  wrap-around: rank 0 receives zeros, which it never uses);
- one masked sum over ``pipe`` hands every rank the last rank's buffer.

The calling convention is the parallel layer's global one
(``parallel/mesh.py``): the stacked parameters and the ``(M, b, ...)``
microbatches are the same global tensors on every rank, and every rank
gets the global ``(M, b, ...)`` result and, in the backward, the global
gradients. JAX differentiates ``scan`` and ``ppermute``; here the
backward is written out:

- :class:`_Hop`'s backward is the reverse hop (each gradient goes one
  rank up);
- the masked sum (:func:`_from_last`) hands the output cotangent to the
  last rank ONCE — every rank holds the same cotangent of the replicated
  output, so summing them would count it ``n_stages`` times — and a zero
  to every other rank's last hop, which starts that rank's reverse chain
  (every hop's output feeds the next tick's select, so every rank runs
  every reverse hop, and the pairs match);
- the stage slice of the stacked parameters (:class:`_StageSlice`)
  gathers every rank's stage gradient back in one collective, and the
  microbatches' gradient (rank 0's, the only rank that reads them) is
  summed over ``pipe`` (:class:`_ReplicatedInput`).

The mesh trainer under :data:`PIPELINE_STAGE_RULES` stores one stage a
rank and passes it as it is (``local_stage``): there is no slice, and
the stage gradient stays on its rank.

The drain ticks' re-fed microbatch gets a gradient of exactly zero: its
outputs never reach the kept buffer. With a ``data`` axis the microbatch
batch dim splits over ``data`` when it divides (dp x pp), as in the JAX
package (the stage gradients then sum over ``data``) — except inside
:func:`~mmlspark_tpu_torch.parallel.mesh.local_batch`, where the batch is
the rank's shard already.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    PIPELINE_AXIS,
    Gather,
    MeshAxis,
    Scatter,
    SumGrads,
    all_reduce_sum,
    batch_split_axis,
    mesh_shape,
)

#: param-sharding rule stacking pipeline stages over the ``pipe`` axis
#: (leading stacked dim); used with the trainer's ``param_rules`` for the
#: pipelined transformer family (models/pipelined.py).
PIPELINE_STAGE_RULES: list[tuple[str, tuple]] = [
    (r"^stages/", (PIPELINE_AXIS,)),
]


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def _tree_unflatten(tree, leaves: list):
    """``tree``'s structure over ``leaves`` (in :func:`_tree_leaves`'
    order). No closure refers to itself here: a reference cycle would
    keep the step's autograd graph alive past the step, and a CUDA-graph
    capture of the next step must not find it."""
    return _rebuild(tree, iter(leaves))


def _rebuild(node, leaves):
    if isinstance(node, dict):
        return {k: _rebuild(v, leaves) for k, v in node.items()}
    return next(leaves)


class _StageSlice(torch.autograd.Function):
    """Stacked leaves -> this rank's stage (index ``axis.index`` of dim
    0); the backward gathers every rank's stage gradients in ONE
    all-gather of a flat bucket and restacks them."""

    @staticmethod
    def forward(ctx, axis, *leaves):
        ctx.axis = axis
        ctx.shapes = [tuple(t.shape[1:]) for t in leaves]
        ctx.like = [(t.dtype, t.device) for t in leaves]
        return tuple(t[axis.index].clone() for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        import torch.distributed as dist

        axis = ctx.axis
        # a leaf the stage never read has no gradient: its stage's is 0
        grads = [torch.zeros(shape, dtype=dt, device=dev) if g is None
                 else g for g, shape, (dt, dev)
                 in zip(grads, ctx.shapes, ctx.like)]
        flat = torch.cat([g.reshape(-1) for g in grads])
        out = torch.empty(axis.size * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        out = out.view(axis.size, -1)
        dist.all_gather(list(out.unbind(0)), flat, group=axis.group)
        full, off = [], 0
        for shape in ctx.shapes:
            n = int(torch.Size(shape).numel())
            full.append(out[:, off:off + n].reshape(axis.size, *shape))
            off += n
        return (None, *full)


class _ReplicatedInput(torch.autograd.Function):
    """A tensor every rank of the axis holds: the forward is the identity,
    the backward sums the ranks' gradients (only rank 0 reads the
    microbatches, so the sum is its gradient, on every rank)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class _Hop(torch.autograd.Function):
    """One tick's move: ``y`` to the next rank of the axis, the previous
    rank's ``y`` back (zeros on rank 0: no wrap-around). The backward is
    the reverse hop: the gradient of what came in goes back up, and the
    gradient of ``y`` comes from the next rank (zeros on the last)."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        return _exchange(y, axis, down=True)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis, down=False), None


def _exchange(t: torch.Tensor, axis: MeshAxis, down: bool) -> torch.Tensor:
    """Send ``t`` one rank down (``down``) or up the axis and receive the
    tensor the rank on the other side sends; zeros at the end that has no
    neighbour."""
    import torch.distributed as dist

    i, n = axis.index, axis.size
    to, frm = (i + 1, i - 1) if down else (i - 1, i + 1)
    buf = torch.zeros_like(t)
    ops = []
    if 0 <= to < n:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), axis.ranks[to],
                              axis.group))
    if 0 <= frm < n:
        ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[frm], axis.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return buf


def _from_last(out, anchor, axis):
    """The masked all-reduce: every rank gets the last rank's ``out``.
    The backward hands the (replicated) output cotangent to the last rank
    once, and a zero to ``anchor`` — the rank's last hop — so that every
    rank runs its reverse chain."""
    if anchor is None:
        return _FromLastNoAnchor.apply(out, axis)
    return _FromLastAnchored.apply(out, anchor, axis)


class _FromLastAnchored(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, anchor, axis):
        ctx.axis = axis
        ctx.last = axis.index == axis.size - 1
        ctx.anchor_shape = anchor.shape
        buf = out if ctx.last else torch.zeros_like(out)
        return all_reduce_sum(buf, axis)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None,
                g.new_zeros(ctx.anchor_shape), None)


class _FromLastNoAnchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, axis):
        return all_reduce_sum(out, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _pipeline_inner(stage_fn: Callable[[Any, Any], Any], params, mb,
                    axis: MeshAxis, local_stage: bool = False):
    """This rank's part of the schedule: ``params`` is the stacked tree
    (global, or this rank's stage alone with ``local_stage``), ``mb`` the
    ``(M, b, ...)`` microbatches. Returns the ``(M, b, ...)`` outputs, the
    same on every rank of the axis."""
    n, idx = axis.size, axis.index
    leaves = _tree_leaves(params)
    if local_stage:
        local = _tree_unflatten(params, [t[0] for t in leaves])
    else:
        local = _tree_unflatten(params,
                                list(_StageSlice.apply(axis, *leaves)))
    mb = _ReplicatedInput.apply(mb, axis)
    n_micro = mb.shape[0]
    # a fill, not a host copy: the step may be captured as a CUDA graph
    first = torch.full((), idx == 0, device=mb.device)
    state = torch.zeros_like(mb[0])
    kept: list = [None] * n_micro
    y = None
    for t in range(n_micro + n - 1):
        # rank 0 feeds microbatch t (re-feeds the last one on drain ticks,
        # whose outputs are never kept); the others take what came in
        feed = mb[min(t, n_micro - 1)]
        x = torch.where(first, feed, state) if n > 1 else feed
        y = stage_fn(local, x)
        done = t - (n - 1)
        if idx == n - 1 and done >= 0:
            kept[done] = y
        if n > 1:
            state = _Hop.apply(y, axis)
    if idx == n - 1:
        out = torch.stack(kept)
    else:
        out = torch.zeros((n_micro, *y.shape), dtype=y.dtype,
                          device=y.device)
    return _from_last(out, state if n > 1 else None, axis)


def pipeline_apply(
    stage_fn: Callable[[Any, Any], Any],
    stacked_params,
    microbatches: torch.Tensor,
    mesh,
    *,
    axis: str = PIPELINE_AXIS,
    batch_axis: str = DATA_AXIS,
    local_stage: bool = False,
):
    """Run ``microbatches`` (M, b, ...) through ``n_stages`` copies of
    ``stage_fn`` whose params are stacked on dim 0 of ``stacked_params``
    (a tensor or a nested dict of tensors).

    Equivalent (up to float tolerance) to applying the stages in turn,
    ``y = stage_fn(p[n-1], ... stage_fn(p[0], x))`` per microbatch, but
    stage ``i`` runs on rank ``i`` of ``axis`` and activations move with
    one hop a tick. Global arguments and result on every rank.

    With ``local_stage`` the stacked params hold this rank's stage alone
    (a leading dim of 1), as the mesh trainer stores them under
    :data:`PIPELINE_STAGE_RULES`: the stage is used as it is, its
    gradient stays on the rank (no gather in either direction), and any
    microbatch count runs (one microbatch is the stages in turn)."""
    shape = mesh_shape(mesh)
    if axis not in shape:
        raise FriendlyError(
            f"pipeline_apply needs axis '{axis}' in the mesh; mesh axes: "
            f"{shape}"
        )
    n = shape[axis]
    leaves = _tree_leaves(stacked_params)
    if local_stage:
        if leaves and leaves[0].shape[0] != 1:
            raise FriendlyError(
                f"local_stage params have {leaves[0].shape[0]} stages; "
                "a rank holds one")
    elif leaves and leaves[0].shape[0] != n:
        raise FriendlyError(
            f"stacked params have {leaves[0].shape[0]} stages but mesh axis "
            f"'{axis}' has size {n}"
        )
    if microbatches.shape[0] % n and not local_stage:
        raise FriendlyError(
            f"microbatch count {microbatches.shape[0]} must be a multiple "
            f"of the pipeline depth {n} (keeps the bubble fraction bounded)"
        )
    if mesh.get_coordinate() is None:
        import torch.distributed as dist

        raise FriendlyError(
            f"rank {dist.get_rank()} is not in the mesh {shape}")
    # shard the microbatch batch dim over data when it divides evenly
    # (dp x pp); otherwise every rank of the data axis runs it whole
    split = batch_split_axis(mesh, batch_axis, microbatches.shape[1])
    data = MeshAxis(mesh, split) if split is not None else None
    mb = microbatches
    if data is not None:
        # each data rank runs its part of the batch: the stage gradients
        # sum over data, as the JAX package's replicated shard_map input
        leaves = SumGrads.apply((data,), *_tree_leaves(stacked_params))
        stacked_params = _tree_unflatten(stacked_params, list(leaves))
        mb = Scatter.apply(mb, 1, data)
    out = _pipeline_inner(stage_fn, stacked_params, mb, MeshAxis(mesh, axis),
                          local_stage)
    if data is not None:
        out = Gather.apply(out, 1, data)
    return out
