"""Top-1 switch routing for a mixture-of-experts FFN — the port of
``mmlspark_tpu/parallel/expert.py``.

The expert FFN weights are stacked on a leading dim of ``n_experts``.
Tokens route top-1 over a float32 softmax router with capacity-bounded
dispatch: one-hot ``(G, S, E, C)`` dispatch and combine tensors scatter
the tokens into an ``(E, C, D)`` buffer a group, the experts run as one
batched product over the stacked dim, and the results gather back
weighted by the router probability. Tokens past an expert's capacity
are dropped (the residual keeps them in the block output). Decode steps
route droplessly (:func:`moe_ffn_dropless`).

Everything is fixed-shape arithmetic, as in the JAX package: every
one-hot is a comparison with an ``arange`` (an all-zero row for a
position past capacity, where ``F.one_hot`` would raise and, on the
card, sync the host), with no ``nonzero``, boolean indexing or host
read, so a step captures into one CUDA graph per shape. The casts
follow JAX's order: the router runs in f32 on the compute-dtype input,
the dispatch and combine products in f32, the expert products in the
compute dtype. No Pallas kernel stands behind MoE in the JAX package;
the products are ``torch.einsum`` here as they are XLA's there.

Expert parallelism splits the experts' compute: :data:`EXPERT_RULES`
places the stacked expert dim on the ``expert`` mesh axis, and the
trainer's mesh mode (``train/trainer.py``) stores each rank's experts
and runs only them (``models/moe.expert_local_graph``). As in the JAX
trainer, whose batch shards over ``data`` only, every ``expert`` rank
holds the same tokens: the router, the dispatch and the aux loss are
computed on every rank; each rank runs its ``E / expert`` experts on its
slice of the dispatch buffer, the tokens and the gate entering through
copy-to-axis over ``expert`` (the backward sums the ranks' partial
gradients), and its partial combine is summed over ``expert`` by
reduce-from-axis (the backward is the identity). So the gate's gradient
holds the combine's part summed over ``expert`` and the aux loss's part
once, and each expert's gradient is computed only where it lives.
:func:`validate_experts` checks ``n_experts`` against that axis.

Inside the mesh step each ``data`` rank holds a contiguous block of the
global batch's tokens, and the routing is the global batch's, as the JAX
package's sharded arrays compute it: where the global groups lie whole
within the ranks' blocks (the group size divides a rank's token count)
each rank routes its own groups; otherwise the ranks' tokens are
gathered and every rank routes the global groups and keeps its rows.
Either way the aux loss a rank returns is its share of the global one
(the sum of the per-group losses it computed over the global group
count), so the shares summed over ``data`` are the global mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.exceptions import ParamError
from mmlspark_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    CopyToAxis,
    Gather,
    ReduceFromAxis,
    SumGrads,
    batch_stats_axis,
    mesh_shape,
)

#: param-sharding rules placing the stacked expert dim on the ``expert``
#: mesh axis (leading dim of every leaf under an ``experts`` module)
EXPERT_RULES: list[tuple[str, tuple]] = [
    (r"/experts/", (EXPERT_AXIS,)),
]


def _one_hot(idx, n: int):
    """f32 one-hot of integer ``idx`` over ``n`` classes by comparison:
    an index outside [0, n) gives an all-zero row (``jax.nn.one_hot``'s
    rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def router_probs(x, gate_w):
    """Softmax router over experts in f32. x: (..., D); gate_w: (D, E)."""
    # f32 routing whatever the compute dtype: gate decisions are
    # precision-sensitive
    return torch.softmax(x.float() @ gate_w.float(), dim=-1)


def moe_dispatch(probs, capacity: int, mask=None):
    """Dispatch and combine tensors from router probabilities.

    probs: (..., N, E) per-token expert probabilities (leading dims are
    independent groups, JAX's ``vmap``); mask: optional (..., N) 0/1
    real-token mask — padding tokens route nowhere, consume no capacity
    and are left out of the balance loss. Returns ``(dispatch, combine,
    aux)``: the f32 (..., N, E, C) scatter mask, its gate-weighted
    version, and the Switch load-balance loss ``E * sum_e f_e p_e`` per
    group.
    """
    dispatch, gate, aux = _route(probs, capacity, mask)
    return dispatch, dispatch * gate[..., None, None], aux


def _route(probs, capacity: int, mask=None):
    """:func:`moe_dispatch`'s dispatch mask, the chosen expert's
    probability a token (0 when dropped; the combine is the dispatch
    scaled by it) and the aux loss."""
    e = probs.shape[-1]
    expert = probs.argmax(dim=-1)  # top-1; ties to the first index
    onehot = _one_hot(expert, e)  # (..., N, E)
    if mask is not None:
        onehot = onehot * mask.float()[..., None]
    # each token's place in its expert's queue (exclusive cumsum, exact
    # in f32)
    pos = torch.cumsum(onehot, dim=-2) * onehot - onehot
    kept = (pos < capacity).float() * onehot  # overflow dropped
    slot = _one_hot(pos.long(), capacity)  # (..., N, E, C)
    dispatch = kept[..., None] * slot
    gate = (probs * kept).sum(-1)  # chosen-expert prob, 0 when dropped
    n_real = onehot.sum(dim=(-2, -1)).clamp(min=1.0)
    frac = onehot.sum(dim=-2) / n_real[..., None]
    if mask is not None:
        w = mask.float()[..., None]
        mean_prob = (probs * w).sum(-2) / w.sum(dim=(-2, -1)).clamp(
            min=1.0)[..., None]
    else:
        mean_prob = probs.mean(dim=-2)
    aux = e * (frac * mean_prob).sum(-1)
    return dispatch, gate, aux


def moe_ffn(x, gate_w, w_in, b_in, w_out, b_out, *,
            capacity_factor: float = 1.25, mask=None,
            group_size: int = 1024, expert=None):
    """Top-1 switch FFN. x: (B, T, D); w_in: (E, D, F); w_out: (E, F, D);
    mask: optional (B,) real-row mask (padding rows route nowhere).
    With ``expert`` (the rank's :class:`~mmlspark_tpu_torch.parallel.
    mesh.MeshAxis` on the ``expert`` axis) the expert leaves are the
    rank's ``E / expert`` experts and the FFN is expert-local (see the
    module docstring); the router's ``gate_w`` stays whole.

    Tokens route in groups of ``group_size`` (the token dim padded up to
    a multiple with masked tokens, so a prime token count keeps full
    groups), with ``capacity = max(int(capacity_factor * S / E), 1)``
    per group and expert — Python ints from static shapes. Returns
    ``(out, aux)``; ``out`` in ``x``'s dtype. Inside the mesh trainer's
    step the groups are the global batch's, and ``aux`` is this ``data``
    rank's share of the global loss (see the module docstring).
    """
    data = batch_stats_axis()
    if data is None:
        out, aux = _moe_groups(x, gate_w, w_in, b_in, w_out, b_out,
                               capacity_factor, mask, group_size, expert)
        return out, aux.mean()
    n_local = x.shape[0] * x.shape[1]
    if n_local % min(group_size, n_local * data.size) == 0:
        # the global groups lie whole within the ranks' blocks (and no
        # padding group exists): route this rank's own; every rank holds
        # as many groups, so the global count is theirs times the width
        out, aux = _moe_groups(x, gate_w, w_in, b_in, w_out, b_out,
                               capacity_factor, mask, group_size, expert)
        return out, aux.sum() / (aux.numel() * data.size)
    # groups straddle the ranks' blocks: route the gathered global batch
    # (every rank computes every group; the gradient of each rank's rows
    # is summed over the ranks that used them) and keep this rank's rows
    b = x.shape[0]
    xs = SumGrads.apply((data,), Gather.apply(x, 0, data))[0]
    ms = None if mask is None else Gather.apply(mask, 0, data)
    out, aux = _moe_groups(xs, gate_w, w_in, b_in, w_out, b_out,
                           capacity_factor, ms, group_size, expert)
    return out[data.index * b:(data.index + 1) * b], aux.mean() / data.size


def _moe_groups(x, gate_w, w_in, b_in, w_out, b_out, capacity_factor,
                mask, group_size, expert=None):
    """:func:`moe_ffn` over the tokens of ``x``: the output and the
    per-group aux losses."""
    b, t, d = x.shape
    e = gate_w.shape[-1]
    n = b * t
    flat = x.reshape(n, d)
    tok_mask = (mask.float().repeat_interleave(t) if mask is not None
                else torch.ones(n, device=x.device))
    s = min(group_size, n)
    pad = (-n) % s
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
        tok_mask = F.pad(tok_mask, (0, pad))
    g = (n + pad) // s
    capacity = max(int(capacity_factor * s / e), 1)
    probs = router_probs(flat, gate_w).reshape(g, s, e)
    dispatch, gate, aux = _route(probs, capacity, tok_mask.reshape(g, s))
    grouped = flat.reshape(g, s, d).float()
    if expert is not None:
        # the rank's experts on their slice of the dispatch: the tokens
        # and the gate enter through copy-to-axis (each rank's products
        # give a part of their gradients), the combine leaves through
        # reduce-from-axis
        lo = expert.index * w_in.shape[0]
        dispatch = dispatch[:, :, lo:lo + w_in.shape[0]]
        grouped = CopyToAxis.apply(grouped, expert)
        gate = CopyToAxis.apply(gate, expert)
    combine = dispatch * gate[..., None, None]
    dt = x.dtype
    buf = torch.einsum("gsec,gsd->gecd", dispatch, grouped).to(dt)
    h = torch.einsum("gecd,edf->gecf", buf, w_in.to(dt))
    h = F.gelu(h + b_in[None, :, None, :].to(dt), approximate="tanh")
    y = torch.einsum("gecf,efd->gecd", h, w_out.to(dt))
    y = y + b_out[None, :, None, :].to(dt)
    out = torch.einsum("gsec,gecd->gsd", combine, y.float())
    if expert is not None:
        out = ReduceFromAxis.apply(out, expert)
    out = out.reshape(n + pad, d)[:n]
    return out.reshape(b, t, d).to(dt), aux


def moe_ffn_dropless(x, gate_w, w_in, b_in, w_out, b_out):
    """Dropless top-1 routing for DECODE steps: each token gathers its
    argmax expert's weights ((N, D, F) per-token reads, affordable at
    decode batch sizes) and is scaled by its gate probability as the
    capacity path scales a kept token, so wherever that path drops
    nothing the two agree. No aux loss: balance is a training concern."""
    b, t, d = x.shape
    dt = x.dtype
    flat = x.reshape(b * t, d)
    probs = router_probs(flat, gate_w)  # (N, E) f32
    expert = probs.argmax(dim=-1)
    gate = probs.gather(-1, expert[:, None])[:, 0]
    h = torch.einsum("nd,ndf->nf", flat, w_in[expert].to(dt))
    h = F.gelu(h + b_in[expert].to(dt), approximate="tanh")
    y = torch.einsum("nf,nfd->nd", h, w_out[expert].to(dt))
    y = y + b_out[expert].to(dt)
    out = y.float() * gate[:, None]
    return out.reshape(b, t, d).to(dt)


def validate_experts(n_experts: int, mesh=None) -> None:
    """At least two experts, and as many as split evenly over the mesh's
    ``expert`` axis (a :func:`~mmlspark_tpu_torch.parallel.mesh.make_mesh`
    DeviceMesh) when it has one."""
    if n_experts < 2:
        raise ParamError(f"need >= 2 experts, got {n_experts}")
    if mesh is None:
        return
    shape = mesh_shape(mesh)
    if EXPERT_AXIS in shape and n_experts % shape[EXPERT_AXIS]:
        raise ParamError(
            f"n_experts {n_experts} not divisible by mesh axis "
            f"'{EXPERT_AXIS}' ({shape[EXPERT_AXIS]})"
        )
