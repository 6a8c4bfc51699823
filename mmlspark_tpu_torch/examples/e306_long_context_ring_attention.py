"""Long-context sequence parallelism — beyond the reference's ceiling.

The reference "scales sequence length" by not scaling it (SURVEY.md §5:
no attention, no sequence parallelism anywhere in its tree; the only
sequence model pads to max length in notebook UDFs). This example shows
the long-context story end to end over the ranks of a process group:

1. a `transformer_lm` built with RING attention (context parallelism:
   each rank holds S/n_seq tokens of activations; K/V blocks rotate
   around the mesh by point-to-point hops) trains over a data x seq
   mesh;
2. the same weights then serve a sequence FOUR TIMES the per-rank
   activation budget, and the ring output is checked against the dense
   attention path on identical weights — exactness, not vibes;
3. the BiLSTM chunked-recurrence chain (the recurrent long-context
   analog, parallel/sequence_rnn.py) trains with batch AND time sharded
   in one SGD step.

Run on the CPU over 8 gloo ranks:
     python -m mmlspark_tpu_torch --cpu-mesh 8 run e306_long_context_ring_attention.py
On the card (``python -m mmlspark_tpu_torch run ...``) the example starts
a one-rank NCCL group of its own, so every mesh axis has size 1 there.
"""

import numpy as np

from mmlspark_tpu_torch.models import build_model, init_variables
from mmlspark_tpu_torch.parallel import (
    TRANSFORMER_TP_RULES,
    bilstm_seq_parallel_train_step,
    initialize_distributed,
    make_mesh,
)
from mmlspark_tpu_torch.train.trainer import SPMDTrainer, TrainConfig

VOCAB = 64
SEQ = 32  # 4 seq-shards x 8 tokens per rank on the 8-rank mesh


def process_group() -> bool:
    """Join the launcher's ranks, or start a one-rank group (NCCL on the
    card) when no group runs; True when this example started it."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        return False
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    return True


def main():
    import torch
    import torch.distributed as dist

    owned = process_group()
    n_dev = dist.get_world_size()
    seq_ax = 4 if n_dev % 4 == 0 else 1
    data_ax = max(n_dev // seq_ax, 1)
    mesh_axes = {"data": data_ax, "seq": seq_ax}
    mesh = make_mesh(mesh_axes)

    # -- 1. train a ring-attention LM over data x seq -----------------------
    graph = build_model(
        "transformer_lm", vocab_size=VOCAB, d_model=32, heads=4, depth=2,
        max_len=SEQ, attn_impl="ring", mesh=mesh,
    )
    rng = np.random.default_rng(0)
    ids = rng.integers(1, VOCAB, size=(8 * data_ax, SEQ)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    trainer = SPMDTrainer(
        graph,
        TrainConfig(
            epochs=4, batch_size=4 * data_ax, learning_rate=5e-3,
            mesh_axes=mesh_axes, param_rules=TRANSFORMER_TP_RULES,
            log_every=5, shuffle=False,
        ),
    )
    variables = trainer.train(ids, labels)
    losses = [h["loss"] for h in trainer.history]
    assert losses[-1] < losses[0], losses
    dev = trainer.device

    # -- 2. ring == dense on the SAME weights ------------------------------
    dense_graph = build_model(
        "transformer_lm", vocab_size=VOCAB, d_model=32, heads=4, depth=2,
        max_len=SEQ, attn_impl="dense",
    )
    probe = torch.as_tensor(ids[:2], device=dev)
    ring_out = graph.apply(variables, probe).float().cpu().numpy()
    dense_out = dense_graph.apply(variables, probe).float().cpu().numpy()
    np.testing.assert_allclose(ring_out, dense_out, atol=2e-2, rtol=2e-2)
    max_err = float(np.max(np.abs(ring_out - dense_out)))

    # -- 2b. sliding window: O(window) ring communication ------------------
    # a windowed LM (Mistral-style local attention) over the same mesh:
    # the ring drops rotations whose kv chunks lie wholly outside the
    # window, so communication scales with the window, not the sequence
    from mmlspark_tpu_torch.ops.attention import dense_attention
    from mmlspark_tpu_torch.parallel import ring_attention
    from mmlspark_tpu_torch.parallel.context_parallel import (
        _ring_window_steps,
    )

    W = SEQ // 4
    qkv = rng.normal(size=(3, 2, SEQ, 4, 8)).astype(np.float32)
    qw, kw, vw = (torch.as_tensor(t, device=dev) for t in qkv)
    ring_w = ring_attention(qw, kw, vw, mesh, causal=True,
                            window=W).cpu().numpy()
    dense_w = dense_attention(qw, kw, vw, causal=True,
                              window=W).cpu().numpy()
    np.testing.assert_allclose(ring_w, dense_w, atol=1e-5, rtol=1e-5)
    live_rounds = _ring_window_steps(seq_ax, SEQ // seq_ax, W, True)

    # -- 3. recurrent long-context: mixed-axis BiLSTM training -------------
    bgraph = build_model(
        "bilstm_tagger", vocab_size=VOCAB, embed_dim=8, hidden=8, num_tags=4
    )
    bvars = init_variables(bgraph, 0)
    bids = rng.integers(0, VOCAB, size=(2 * data_ax, SEQ)).astype(np.int32)
    btags = (bids % 4).astype(np.int32)
    bmesh = make_mesh({"data": data_ax, "seq": 2 if n_dev % 2 == 0 else 1})
    blosses = []
    # a smaller mesh takes the first ranks; the others sit this leg out
    if bmesh.get_coordinate() is not None:
        for _ in range(3):
            loss, bvars = bilstm_seq_parallel_train_step(
                bgraph, bvars, bids, btags, bmesh, learning_rate=5e-2
            )
            blosses.append(float(loss))
        assert blosses[-1] < blosses[0], blosses

    if dist.get_rank() == 0:
        print(
            f"OK {{'lm_loss_drop': {losses[0] - losses[-1]:.3f}, "
            f"'ring_vs_dense_max_err': {max_err:.4f}, "
            f"'seq_shards': {seq_ax}, "
            f"'window_ring_rounds': '{live_rounds}/{seq_ax}', "
            f"'bilstm_loss_drop': {blosses[0] - blosses[-1]:.4f}}}"
        )
    if owned:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
