"""Sequence/context parallelism: ring attention and all-to-all (Ulysses) —
the port of ``mmlspark_tpu/parallel/context_parallel.py``.

Sequences shard over a mesh axis and attention runs either

- **ring**: K/V chunks rotate around the ``seq`` axis (one
  ``batch_isend_irecv`` hop a step, the next chunk in flight while the
  current one is folded) while each rank folds the visiting chunk into a
  streaming softmax — memory per rank stays O(S/n · S/n); or
- **ulysses**: ``all_to_all_single`` re-shards q, k and v from
  sequence-sharded to head-sharded, the local attention runs over full
  sequences for H/n heads, and one more ``all_to_all_single`` shards the
  output back.

The calling convention is the JAX package's: q, k and v are the GLOBAL
(B, S, H, D) tensors, the same on every rank of the mesh (as a model
that runs replicated holds them), and the result is the global output on
every rank. Each rank takes its batch (``batch_axis``, when it divides)
and sequence chunk, runs its part, and the chunks are gathered back. The
gradient follows the same convention: the global gradients on every
rank, each rank's part computed locally and gathered.

Where the JAX package gets its backward from the transpose of ``scan``
plus ``ppermute``, the ring's is written here
(:class:`_RingAttention`): the saved log-sum-exp re-forms each block's
probabilities, each visiting chunk's dK/dV partials travel with it around
the ring, and a last hop sends each finished gradient to the chunk's
owner. Ulysses' all-to-all has the inverse all-to-all as its backward,
and its local attention is
:func:`~mmlspark_tpu_torch.ops.flash_attention.flash_attention` on a
CUDA tensor — the hand-written forward and backward kernels, with no
dense fallback there — and :func:`~mmlspark_tpu_torch.ops.attention.
dense_attention` on the CPU, as the JAX package runs its dense path off
the TPU.
"""

from __future__ import annotations

import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.ops.attention import (
    NEG_INF,
    causal_block_mask,
    dense_attention,
    finalize_softmax,
    softmax_block_update,
)
from mmlspark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQUENCE_AXIS,
    Gather as _Gather,
    MeshAxis as _Axis,
    Scatter as _Scatter,
    batch_split_axis,
    mesh_shape,
)


def _ring_window_steps(n: int, chunk: int, window: int | None,
                       causal: bool) -> int:
    """Number of LIVE ring rotations. Causal+window bounds the oldest
    attended key of q chunk i at ``i*chunk - window + 1``; rotation t
    hands rank i the kv chunk i - t (older positions as t grows), and
    the chunk at t is fully outside the window iff
    ``t*chunk > window + chunk - 2`` — a bound INDEPENDENT of i, so the
    dead rotations (their compute and their hops) are dropped for every
    rank at once: windowed ring attention communicates O(window), not
    O(S). Rotations t > i wrap to causal-dead chunks anyway, so dropping
    the tail is exact."""
    if not causal or window is None:
        return n
    return min(n, (window + chunk - 2) // chunk + 1)


# -- placement: the rank's shard of a replicated global tensor ---------------


def _place(mesh, axis: str, batch_axis: str, batch: int):
    """The rank's (dim, axis) splits: the batch over ``batch_axis`` when
    the mesh has it and it divides the batch (dp × sp), else replicated
    within the map as in the JAX package (and never inside
    :func:`~mmlspark_tpu_torch.parallel.mesh.local_batch`, where the batch
    is the rank's data shard already); the sequence over ``axis``."""
    if mesh.get_coordinate() is None:
        import torch.distributed as dist

        raise FriendlyError(
            f"rank {dist.get_rank()} is not in the mesh {mesh_shape(mesh)}"
        )
    splits = []
    if batch_split_axis(mesh, batch_axis, batch) is not None:
        splits.append((0, _Axis(mesh, batch_axis)))
    seq = _Axis(mesh, axis)
    splits.append((1, seq))
    return splits, seq


def _sharded_call(inner, q, k, v, mesh, axis: str, batch_axis: str):
    splits, seq = _place(mesh, axis, batch_axis, q.shape[0])
    local = []
    for t in (q, k, v):
        for dim, ax in splits:
            t = _Scatter.apply(t, dim, ax)
        local.append(t)
    o = inner(*local, seq)
    for dim, ax in reversed(splits):
        o = _Gather.apply(o, dim, ax)
    return o


# -- ring ------------------------------------------------------------------


def _shift(tensors, axis: _Axis, hops: int = 1):
    """Post the sends of ``tensors`` to the rank ``hops`` ahead on the
    ring and the receives of as many from the rank ``hops`` behind;
    returns the pending works (with the operations, which keep the sent
    tensors alive) and the receive buffers."""
    import torch.distributed as dist

    tensors = [t.contiguous() for t in tensors]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, buf in zip(tensors, bufs):
        ops.append(dist.P2POp(dist.isend, t, axis.peer(hops),
                              axis.group))
        ops.append(dist.P2POp(dist.irecv, buf, axis.peer(-hops),
                              axis.group))
    return (dist.batch_isend_irecv(ops), ops), bufs


def _wait(pending) -> None:
    works, _ = pending
    for w in works:
        w.wait()


def _expand(t, rep: int):
    return t if rep == 1 else t.repeat_interleave(rep, dim=2)


def _fold(t, rep: int):
    """The gradient of :func:`_expand`: sum each group of ``rep`` heads."""
    if rep == 1:
        return t
    b, s, h, d = t.shape
    return t.reshape(b, s, h // rep, rep, d).sum(dim=3)


class _RingAttention(torch.autograd.Function):
    """Ring attention over local chunks: q (B, S/n, H, D), k/v
    (B, S/n, Hkv, D) — the NARROW chunks rotate, so grouped-query
    attention keeps its traffic saving, and the repeat to query heads
    happens per step. After ``step`` rotations rank i holds chunk
    ``(i - step) mod n``, which gives the global kv offset of the causal
    mask."""

    @staticmethod
    def forward(ctx, q, k, v, seq, causal, window, scale):
        n, idx = seq.size, seq.index
        b, sq, h, d = q.shape
        sk = k.shape[1]
        rep = h // k.shape[2]
        n_steps = _ring_window_steps(n, sk, window, causal)
        m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, sq, h, d), dtype=torch.float32,
                          device=q.device)
        kc, vc = k, v
        for step in range(n_steps):
            pending = _shift([kc, vc], seq) if step + 1 < n_steps else None
            mask = (causal_block_mask(sq, sk, idx * sq,
                                      ((idx - step) % n) * sk,
                                      window=window, device=q.device)
                    if causal else None)
            m, l, acc = softmax_block_update(
                (m, l, acc), q, _expand(kc, rep), _expand(vc, rep), scale,
                mask)
            if pending is not None:
                _wait(pending[0])
                kc, vc = pending[1]
        out = finalize_softmax(l, acc, q.dtype)
        # rows that saw no key (none under causal attention) get +inf,
        # so the backward's probabilities there are exactly 0
        lse = torch.where(l > 0, m + torch.log(l),
                          torch.full_like(l, float("inf")))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seq, ctx.causal, ctx.window, ctx.scale = seq, causal, window, \
            scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        seq, causal, window, scale = ctx.seq, ctx.causal, ctx.window, \
            ctx.scale
        n, idx = seq.size, seq.index
        sq, h = q.shape[1], q.shape[2]
        sk = k.shape[1]
        rep = h // k.shape[2]
        n_steps = _ring_window_steps(n, sk, window, causal)
        qf, do = q.float(), dout.float()
        # D = rowsum(dO * O), (B, H, Q)
        delta = (do * out.float()).sum(dim=-1).transpose(1, 2)
        dq = torch.zeros_like(qf)
        kc, vc = k, v
        partial = None  # the visiting chunk's dK/dV from earlier ranks
        for step in range(n_steps):
            pending = _shift([kc, vc], seq) if step + 1 < n_steps else None
            mask = (causal_block_mask(sq, sk, idx * sq,
                                      ((idx - step) % n) * sk,
                                      window=window, device=q.device)
                    if causal else None)
            kf, vf = _expand(kc, rep).float(), _expand(vc, rep).float()
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
            if mask is not None:
                s = s + mask
            p = torch.exp(s - lse[..., None])
            dv = _fold(torch.einsum("bhqk,bqhd->bkhd", p, do), rep)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
            ds = p * (dp - delta[..., None])
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
            dk = _fold(torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale, rep)
            if partial is not None:
                _wait(partial[0])
                dk, dv = dk + partial[1][0], dv + partial[1][1]
            if pending is not None:
                # the partials travel on with their chunk
                partial = _shift([dk, dv], seq)
                _wait(pending[0])
                kc, vc = pending[1]
        if n_steps > 1:
            # rank i finished chunk i - (n_steps - 1): send it home
            works, (dk, dv) = _shift([dk, dv], seq, hops=1 - n_steps)
            _wait(works)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q, k, v, mesh, *, axis: str = SEQUENCE_AXIS,
                   causal: bool = False, window: int | None = None,
                   scale=None, batch_axis: str = DATA_AXIS):
    """Exact attention with q/k/v sharded on ``axis`` over ``mesh`` (a
    :func:`~mmlspark_tpu_torch.parallel.mesh.make_mesh` DeviceMesh):
    global inputs on every rank, the global output on every rank.
    ``window`` is the causal sliding window (flash-kernel semantics),
    applied through the per-step block mask."""
    if window is not None:
        if not causal:
            raise FriendlyError("window requires causal=True")
        if int(window) < 1:
            raise FriendlyError(f"window must be >= 1, got {window}")
        window = int(window)
    _check_gqa(q, k, v, "ring")
    _check(mesh, axis, q.shape[1], "ring")
    scale = float(scale) if scale else q.shape[-1] ** -0.5

    def inner(ql, kl, vl, seq):
        return _RingAttention.apply(ql, kl, vl, seq, causal, window, scale)

    return _sharded_call(inner, q, k, v, mesh, axis, batch_axis)


# -- ulysses -----------------------------------------------------------------


def _all_to_all(x, seq: _Axis, split_dim: int, concat_dim: int):
    """Tiled all-to-all: ``x`` split into ``n`` chunks along
    ``split_dim``, chunk j sent to rank j, the chunks received
    concatenated along ``concat_dim`` in rank order."""
    import torch.distributed as dist

    inp = torch.stack(x.chunk(seq.size, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=seq.group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, split_dim, concat_dim):
        ctx.seq, ctx.split_dim, ctx.concat_dim = seq, split_dim, concat_dim
        return _all_to_all(x, seq, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        # the inverse all-to-all
        return (_all_to_all(g, ctx.seq, ctx.concat_dim, ctx.split_dim),
                None, None, None)


def _local_attention(q, k, v, *, causal, window, scale):
    """The full-sequence attention on H/n heads: the hand-written flash
    kernels on a CUDA tensor (a build or launch failure raises), the
    dense oracle on the CPU."""
    if q.is_cuda:
        from mmlspark_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    return dense_attention(q, k, v, causal=causal, window=window,
                           scale=scale)


def ulysses_attention(q, k, v, mesh, *, axis: str = SEQUENCE_AXIS,
                      causal: bool = False, window: int | None = None,
                      scale=None, batch_axis: str = DATA_AXIS):
    """All-to-all sequence-parallel attention; q heads AND kv heads must
    divide by the axis size (each rank attends H/n full-length query
    heads against Hkv/n key/value heads — the all-to-all re-shard
    preserves the GQA group ratio, and the local flash/dense call does
    the grouped expansion). Global inputs and output, as
    :func:`ring_attention`."""
    _check_gqa(q, k, v, "ulysses")
    n = _check(mesh, axis, q.shape[1], "ulysses")
    if q.shape[2] % n or k.shape[2] % n:
        raise FriendlyError(
            f"ulysses needs q heads ({q.shape[2]}) and kv heads "
            f"({k.shape[2]}) divisible by mesh axis '{axis}' ({n})"
        )
    if window is not None:
        if not causal:
            raise FriendlyError("window requires causal=True")
        if int(window) < 1:
            raise FriendlyError(f"window must be >= 1, got {window}")
        window = int(window)

    def inner(ql, kl, vl, seq):
        # (B, S/n, H, D) -> (B, S, H/n, D): split heads, concat sequence
        ql, kl, vl = (_AllToAll.apply(t, seq, 2, 1) for t in (ql, kl, vl))
        o = _local_attention(ql, kl, vl, causal=causal, window=window,
                             scale=scale)
        # back to the sequence-sharded layout
        return _AllToAll.apply(o, seq, 1, 2)

    return _sharded_call(inner, q, k, v, mesh, axis, batch_axis)


def _check_gqa(q, k, v, what: str) -> None:
    """Same grouped-query contract as dense/flash: a direct caller gets
    this message, not a shape error deep in the inner body."""
    if k.shape[2] != v.shape[2] or q.shape[2] % k.shape[2]:
        raise FriendlyError(
            f"{what} attention needs k/v heads equal and dividing q "
            f"heads, got q={q.shape[2]} k={k.shape[2]} v={v.shape[2]}"
        )


def _check(mesh, axis: str, seq_len: int, what: str) -> int:
    shape = mesh_shape(mesh)
    if axis not in shape:
        raise FriendlyError(
            f"{what} attention needs axis '{axis}' in the mesh; "
            f"mesh axes: {shape}"
        )
    n = shape[axis]
    if seq_len % n:
        raise FriendlyError(
            f"{what} attention needs sequence length ({seq_len}) divisible "
            f"by mesh axis '{axis}' ({n})"
        )
    return n
