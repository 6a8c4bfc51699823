"""Sequence-dim sharding for the BiLSTM tagger — the port of
``mmlspark_tpu/parallel/sequence_rnn.py``.

Long sequences shard over a mesh axis: each rank holds T/S tokens of
activations, so the memory high-water mark scales down with the axis
size (the long-context story for recurrent nets, beside ring and
Ulysses attention for transformers).

A recurrence is sequential in time, so sharding time cannot shard the
latency: the design is the JAX package's CHUNKED RECURRENCE CHAIN. Every
rank holds one contiguous time chunk; the chain runs S rounds. In each
round every rank scans its chunk from the carry it holds, keeps that
round's outputs when it is its turn, and hands its final state on: the
forward direction to the next rank, the reverse direction to the one
before (no wrap-around: the first rank of each direction starts from
zeros, as the dense scan does). Rank k's round-k scan starts from the
true upstream state. Compute per rank is S * (T/S) = T steps, the
activations O(T/S).

Each chunk scan is one ``torch.lstm`` call per direction with the initial
state it is handed (cuDNN on the card, as the dense tagger runs,
``models/bilstm.py``); the reverse direction scans the time-flipped
chunk. flax's carry is ``(c, h)``, torch's ``(h, c)``. Both directions'
hand-offs of a round travel in one exchange (:class:`_Exchange`), whose
backward is the reverse exchange, so the backward is the chain run
backwards. The head computes in bf16 and returns f32 logits, as the
tagger's ``TokenLogits`` does.

The calling convention is the parallel layer's global one: the same
``ids`` and variables on every rank, the global logits on every rank,
and the global gradients (every rank's parameter gradients summed over
the axes the tokens split over, in one bucket an axis).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.parallel.mesh import (
    Gather,
    MeshAxis,
    SumGrads,
    in_local_batch,
    mesh_shape,
)

__all__ = ["bilstm_seq_parallel_apply", "bilstm_seq_parallel_train_step"]


def _exchange(fwd: list, bwd: list, axis: MeshAxis) -> tuple[list, list]:
    """``fwd`` tensors one rank down the axis and ``bwd`` tensors one rank
    up, in one batch; returns what came from above (``fwd``'s receive
    buffers, zeros on the first rank) and from below (``bwd``'s, zeros on
    the last)."""
    import torch.distributed as dist

    i, n = axis.index, axis.size
    got_f = [torch.zeros_like(t) for t in fwd]
    got_b = [torch.zeros_like(t) for t in bwd]
    ops = []
    for send, recv, to, frm in ((fwd, got_f, i + 1, i - 1),
                                (bwd, got_b, i - 1, i + 1)):
        for t, buf in zip(send, recv):
            if 0 <= to < n:
                ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                      axis.ranks[to], axis.group))
            if 0 <= frm < n:
                ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[frm],
                                      axis.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got_f, got_b


class _Exchange(torch.autograd.Function):
    """One round's hand-offs: the forward direction's ``(h, c)`` one rank
    down, the reverse direction's one rank up. The backward sends each
    received state's gradient back where the state came from."""

    @staticmethod
    def forward(ctx, axis, hf, cf, hb, cb):
        ctx.axis = axis
        ctx.like = hf
        (hf2, cf2), (hb2, cb2) = _exchange([hf, cf], [hb, cb], axis)
        return hf2, cf2, hb2, cb2

    @staticmethod
    def backward(ctx, *grads):
        ghf, gcf, ghb, gcb = (torch.zeros_like(ctx.like) if g is None else g
                              for g in grads)
        # the forward direction's gradients go up, the reverse's down
        (ghb2, gcb2), (ghf2, gcf2) = _exchange([ghb, gcb], [ghf, gcf],
                                               ctx.axis)
        return None, ghf2, gcf2, ghb2, gcb2


def _scan(x, h, c, w_ih, w_hh, b_hh, reverse: bool):
    """One direction over a (B, Tc, E) chunk from the state (h, c): the
    (B, Tc, H) outputs in time order and the final (h, c)."""
    if reverse:
        x = x.flip(1)
    out, h_n, c_n = torch.lstm(
        x, (h[None], c[None]), [w_ih, w_hh, torch.zeros_like(b_hh), b_hh],
        True, 1, 0.0, torch.is_grad_enabled(), False, True)
    if reverse:
        out = out.flip(1)
    return out, h_n[0], c_n[0]


def _bilstm_chain(x, weights: dict, hidden: int, seq: MeshAxis):
    """The chunked recurrence chain over ``seq`` for both directions:
    (B, Tc, 2 * hidden) on this rank's chunk."""
    n, idx = seq.size, seq.index
    b = x.shape[0]
    zero = x.new_zeros(b, hidden)
    hf = cf = hb = cb = zero
    ys_f = ys_b = None
    for k in range(n):
        out_f, hf_n, cf_n = _scan(x, hf, cf, weights["weight_ih"],
                                  weights["weight_hh"], weights["bias_hh"],
                                  False)
        out_b, hb_n, cb_n = _scan(x, hb, cb, weights["weight_ih_reverse"],
                                  weights["weight_hh_reverse"],
                                  weights["bias_hh_reverse"], True)
        # keep exactly this round's outputs where it is the rank's turn
        # (a select on every rank, so every rank's graph has one shape;
        # the flags are fills, not host copies, so a step captures)
        turn_f = torch.full((), idx == k, device=x.device)
        turn_b = torch.full((), idx == n - 1 - k, device=x.device)
        ys_f = out_f if ys_f is None else torch.where(turn_f, out_f, ys_f)
        ys_b = out_b if ys_b is None else torch.where(turn_b, out_b, ys_b)
        if k == n - 1:
            break
        got = _Exchange.apply(seq, hf_n, cf_n, hb_n, cb_n)
        nxt_f = torch.full((), idx == k + 1, device=x.device)
        nxt_b = torch.full((), idx == n - 2 - k, device=x.device)
        hf = torch.where(nxt_f, got[0], hf)
        cf = torch.where(nxt_f, got[1], cf)
        hb = torch.where(nxt_b, got[2], hb)
        cb = torch.where(nxt_b, got[3], cb)
    return torch.cat([ys_f, ys_b], dim=-1)


def _leaves(variables: dict) -> tuple[dict, list]:
    """The tagger's parameters by role and in a fixed order."""
    names = [("embed", "Embed_0.weight"),
             *(("bilstm", f"{w}{sfx}") for sfx in ("", "_reverse")
               for w in ("weight_ih", "weight_hh", "bias_hh")),
             ("z", "Dense_0.weight"), ("z", "Dense_0.bias")]
    return names, [variables[b][k] for b, k in names]


def bilstm_seq_parallel_apply(
    graph: Any,
    variables: dict,
    ids,
    mesh,
    *,
    seq_axis: str = "seq",
    data_axis: str | None = "data",
) -> torch.Tensor:
    """Forward pass of a ``bilstm_tagger`` graph with the time dimension
    sharded over ``mesh[seq_axis]`` (and the batch over
    ``mesh[data_axis]`` when the mesh has it). Differentiable: the same
    function serves seq-sharded training.

    ``ids``: (B, T) ints, T divisible by the seq-axis size; ``variables``
    the port's (``models/bridge.py``). Returns the global (B, T,
    num_tags) float32 logits on every rank."""
    shape = mesh_shape(mesh)
    if seq_axis not in shape:
        raise ValueError(
            f"mesh {dict(shape)} has no '{seq_axis}' axis — add one "
            "(size 1 is fine) or use graph.apply for unsharded inference"
        )
    n_seq = shape[seq_axis]
    d_ax = data_axis if data_axis in shape and not in_local_batch() \
        else None
    ids = torch.as_tensor(ids)
    if ids.shape[1] % n_seq:
        raise ValueError(
            f"sequence length {ids.shape[1]} not divisible by "
            f"{seq_axis} axis size {n_seq}"
        )
    if d_ax is not None and ids.shape[0] % shape[d_ax]:
        raise ValueError(
            f"batch size {ids.shape[0]} not divisible by "
            f"{d_ax} axis size {shape[d_ax]}"
        )
    seq = MeshAxis(mesh, seq_axis)
    data = MeshAxis(mesh, d_ax) if d_ax is not None else None
    names, leaves = _leaves(variables)
    dev = leaves[0].device
    ids = ids.to(dev)
    axes = (seq,) if data is None else (seq, data)
    params = dict(zip(names, SumGrads.apply(axes, *leaves)))
    if data is not None:
        ids = ids.chunk(data.size, dim=0)[data.index]
    ids = ids.chunk(seq.size, dim=1)[seq.index]
    x = F.embedding(ids.long(), params[("embed", "Embed_0.weight")]).float()
    hidden = params[("bilstm", "weight_hh")].shape[1]
    h = _bilstm_chain(x, {k: v for (b, k), v in params.items()
                          if b == "bilstm"}, hidden, seq)
    # TokenLogits: bf16 compute, f32 params and output
    w, bias = params[("z", "Dense_0.weight")], params[("z", "Dense_0.bias")]
    out = F.linear(h.to(torch.bfloat16), w.to(torch.bfloat16))
    out = (out + bias.to(torch.bfloat16)).float()
    out = Gather.apply(out, 1, seq)
    if data is not None:
        out = Gather.apply(out, 0, data)
    return out


def bilstm_seq_parallel_train_step(
    graph: Any,
    variables: dict,
    ids,
    tags,
    mesh,
    *,
    learning_rate: float = 5e-2,
    seq_axis: str = "seq",
    data_axis: str | None = "data",
):
    """One plain-SGD step with the batch sharded over ``data_axis`` AND
    time over ``seq_axis`` at once: the backward runs through the chunked
    recurrence chain in reverse, and every parameter's gradient is summed
    over both axes. The loss is the mean token cross-entropy of the
    global logits.

    Returns ``(loss, new_variables)``; call it again with the returned
    variables. The step runs eagerly, so nothing is cached between calls
    (the JAX package bounds its cache of compiled steps instead)."""
    names, leaves = _leaves(variables)
    live = [t.detach().requires_grad_(True) for t in leaves]
    current = {b: dict(block) for b, block in variables.items()}
    for (b, k), t in zip(names, live):
        current[b][k] = t
    logits = bilstm_seq_parallel_apply(
        graph, current, ids, mesh, seq_axis=seq_axis, data_axis=data_axis)
    lp = torch.log_softmax(logits, dim=-1)
    tags_t = torch.as_tensor(tags, device=logits.device).long()
    loss = -lp.gather(-1, tags_t[..., None]).mean()
    grads = torch.autograd.grad(loss, live)
    new = {b: dict(block) for b, block in variables.items()}
    with torch.no_grad():
        for (b, k), p, g in zip(names, leaves, grads):
            new[b][k] = p - learning_rate * g
    return loss.detach(), new
