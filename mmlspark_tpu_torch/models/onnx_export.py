"""ONNX export: the port's trained graphs -> serialized .onnx bytes — the
port of ``mmlspark_tpu/models/onnx_export.py``.

The save side of the reference's serialized-graph story (CNTK models leave
MMLSpark as native ``.model`` files, SerializableFunction.scala:62-81):
trained models leave as ONNX, the format :mod:`~mmlspark_tpu_torch.
models.onnx_import` and every mainstream runtime reads. The writer emits
the protobuf wire format directly (the encode mirror of the importer's
decoder), with the fields external checkers require (``ir_version``,
``opset_import`` at 13, typed attributes and ``value_info``). Exported
graphs are shape-specialized to the sample shape: reshape targets bake
the dims.

The exporters read the port's variables (``{block: {name: tensor}}``)
and write what the JAX package's exporters write from flax's, node for
node and byte for byte on the same weights: a port Dense weight is
``(out, in)``, the transpose of flax's kernel, so it is transposed back;
the BiLSTM's packed ``weight_ih``/``weight_hh``/``bias_hh`` rows are in
PyTorch's gate order ``i, f, g, o`` (``models/bilstm.py``) and are
restacked in ONNX's ``i, o, f, c``.

Supported families: ``linear`` / ``mlp`` (Gemm + Relu chains),
``bilstm_tagger`` (Gather -> bidirectional LSTM -> per-token projection)
and ``transformer_lm`` (LayerNorm, multi-head attention and the tanh
gelu decomposed into primitive ops; the block outputs keep the layer
names, so named-node cuts survive the round trip; the causal mask is
built in-graph from O(T) position vectors — with the window leg when the
model slides — RoPE as an in-graph rotate-half, and GQA's narrow K/V
expanded with Reshape/Expand). Convolutional families persist through
the stage format (``core/serialize.py``).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError

# ---------------------------------------------------------------------------
# protobuf wire-format encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wt: int, payload: bytes) -> bytes:
    return _varint(num << 3 | wt) + payload


def _msg(num: int, body: bytes) -> bytes:
    return _field(num, 2, _varint(len(body)) + body)


def _s(num: int, s: str) -> bytes:
    b = s.encode()
    return _field(num, 2, _varint(len(b)) + b)


def _i(num: int, v: int) -> bytes:
    return _field(num, 0, _varint(v & (1 << 64) - 1))


def _f(num: int, v: float) -> bytes:
    return _field(num, 5, struct.pack("<f", v))


_TENSOR_DTYPES = {
    np.dtype("float32"): 1,
    np.dtype("int32"): 6,
    np.dtype("int64"): 7,
}


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _TENSOR_DTYPES:
        raise FriendlyError(f"cannot export tensor dtype {arr.dtype}")
    body = b"".join(_i(1, d) for d in arr.shape)
    body += _i(2, _TENSOR_DTYPES[arr.dtype]) + _s(8, name)
    body += _field(9, 2, _varint(arr.nbytes) + arr.tobytes())
    return body


# AttributeProto.type values (required by onnx.checker; the importer
# infers from the populated field but external runtimes validate it)
_ATTR_INT, _ATTR_STRING, _ATTR_INTS = 2, 3, 7


def attr_i(name: str, v: int) -> bytes:
    return _s(1, name) + _i(3, v) + _i(20, _ATTR_INT)


def attr_s(name: str, v: str) -> bytes:
    return _s(1, name) + _s(4, v) + _i(20, _ATTR_STRING)


def attr_ints(name: str, vs) -> bytes:
    return _s(1, name) + b"".join(_i(8, v) for v in vs) + _i(20, _ATTR_INTS)


def node(op: str, inputs, outputs, name: str = "", attrs=()) -> bytes:
    body = b"".join(_s(1, i) for i in inputs)
    body += b"".join(_s(2, o) for o in outputs)
    body += _s(3, name) + _s(4, op)
    body += b"".join(_msg(5, a) for a in attrs)
    return body


def value_info(name: str, shape, elem_type: int = 1) -> bytes:
    """elem_type: ONNX TensorProto dtype (1=float32, 6=int32, 7=int64)."""
    dims = b"".join(_msg(1, _i(1, d)) for d in shape)
    tensor_type = _i(1, elem_type) + _msg(2, dims)
    return _s(1, name) + _msg(2, _msg(1, tensor_type))


#: every op this exporter emits exists with these semantics at opset 13
_OPSET_VERSION = 13


def model_proto(nodes, initializers, inputs, outputs,
                gname: str = "mmlspark_tpu") -> bytes:
    g = b"".join(_msg(1, n) for n in nodes)
    g += _s(2, gname)
    g += b"".join(_msg(5, t) for t in initializers)
    g += b"".join(_msg(11, v) for v in inputs)
    g += b"".join(_msg(12, v) for v in outputs)
    opset = _msg(8, _s(1, "") + _i(2, _OPSET_VERSION))
    return (
        _i(1, 8)  # ir_version
        + _s(2, "mmlspark_tpu")  # producer_name
        + _msg(7, g)
        + opset
    )


# ---------------------------------------------------------------------------
# reading the port's variables


def _np(block: dict, key: str) -> np.ndarray:
    """One leaf of a block's variables as float32 numpy."""
    leaf = block.get(key)
    if not isinstance(leaf, torch.Tensor):
        raise FriendlyError(
            f"variables lack a float tensor '{key}' (have {sorted(block)}); "
            "export needs the port's float variables"
        )
    return leaf.detach().to("cpu", torch.float32).numpy()


def _kernel(block: dict, key: str) -> np.ndarray:
    """A Dense weight ``(out, in)`` as flax's kernel ``(in, out)``."""
    return np.ascontiguousarray(_np(block, key).T)


# ---------------------------------------------------------------------------
# family exporters


def _export_dense_chain(variables, sample_shape, layer_names):
    """linear / mlp: per-block Dense (+ Relu on hidden blocks)."""
    nodes, inits = [], []
    prev = "x"
    for i, block in enumerate(layer_names):
        k = _kernel(variables[block], "Dense_0.weight")
        b = _np(variables[block], "Dense_0.bias")
        inits += [tensor_proto(f"{block}_w", k), tensor_proto(f"{block}_b", b)]
        out = block if i == len(layer_names) - 1 else f"{block}_pre"
        nodes.append(
            node("Gemm", [prev, f"{block}_w", f"{block}_b"], [out],
                 name=block)
        )
        if i < len(layer_names) - 1:
            nodes.append(node("Relu", [out], [f"{block}_act"],
                              name=f"{block}_relu"))
            prev = f"{block}_act"
        out_dim = k.shape[1]
    return model_proto(
        nodes, inits,
        [value_info("x", sample_shape)],
        [value_info(layer_names[-1], (sample_shape[0], out_dim))],
    )


#: PyTorch's packed gate rows (i, f, g, o) restacked in ONNX's i, o, f, c
_GATES_ONNX_ORDER = (0, 3, 1, 2)


def _lstm_dir_weights(block: dict, sfx: str):
    """One direction of the port's BiLSTM -> ONNX (W [4H, E], R [4H, H],
    B [8H]) in i, o, f, c gate order."""

    def onnx_order(arr):
        parts = np.split(arr, 4, axis=0)
        return np.concatenate([parts[g] for g in _GATES_ONNX_ORDER])

    w = onnx_order(_np(block, f"weight_ih{sfx}"))
    r = onnx_order(_np(block, f"weight_hh{sfx}"))
    rb = onnx_order(_np(block, f"bias_hh{sfx}"))
    b = np.concatenate([np.zeros_like(rb), rb])  # no input-side bias
    return w, r, b


def _export_bilstm_tagger(variables, sample_shape):
    """embed -> bidirectional LSTM -> per-token projection; batch-major
    (B, T) ids in, (B, T, num_tags) logits out."""
    batch, seq = sample_shape
    emb = _np(variables["embed"], "Embed_0.weight")
    wf, rf, bf = _lstm_dir_weights(variables["bilstm"], "")
    wb_, rb_, bb = _lstm_dir_weights(variables["bilstm"], "_reverse")
    w = np.stack([wf, wb_])
    r = np.stack([rf, rb_])
    b = np.stack([bf, bb])
    hidden = r.shape[-1]
    proj_k = _kernel(variables["z"], "Dense_0.weight")
    proj_b = _np(variables["z"], "Dense_0.bias")
    num_tags = proj_k.shape[1]

    nodes = [
        # (B, T) ids -> (B, T, E) -> seq-major (T, B, E)
        node("Gather", ["embedding", "x"], ["embedded"], name="embed",
             attrs=[attr_i("axis", 0)]),
        node("Transpose", ["embedded"], ["seq_major"], name="to_seq",
             attrs=[attr_ints("perm", [1, 0, 2])]),
        node("LSTM", ["seq_major", "W", "R", "B"], ["y", "yh", "yc"],
             name="bilstm",
             attrs=[attr_i("hidden_size", hidden),
                    attr_s("direction", "bidirectional")]),
        # Y (T, 2, B, H) -> (B, T, 2, H) -> (B, T, 2H): forward and
        # backward halves side by side
        node("Transpose", ["y"], ["y_bm"], name="to_batch",
             attrs=[attr_ints("perm", [2, 0, 1, 3])]),
        node("Reshape", ["y_bm", "merge_shape"], ["states"], name="merge"),
        node("MatMul", ["states", "proj_w"], ["proj"], name="proj"),
        node("Add", ["proj", "proj_b"], ["z"], name="z"),
    ]
    inits = [
        tensor_proto("embedding", emb),
        tensor_proto("W", w),
        tensor_proto("R", r),
        tensor_proto("B", b),
        tensor_proto(
            "merge_shape",
            np.array([batch, seq, 2 * hidden], np.int64),
        ),
        tensor_proto("proj_w", proj_k),
        tensor_proto("proj_b", proj_b),
    ]
    return model_proto(
        nodes, inits,
        [value_info("x", (batch, seq), elem_type=6)],  # int32 ids
        [value_info("z", (batch, seq, num_tags))],
    )


def _ln_nodes(prefix, x_name, out_name, nodes, inits, scale, bias):
    """A LayerNorm over the last axis decomposed into primitive ONNX ops
    (ReduceMean/Sub/Mul/Sqrt/Div), so the graph needs no opset-17 fused
    op; the biased variance and epsilon 1e-6 of the model's LayerNorm."""
    p = prefix
    inits += [
        tensor_proto(f"{p}_scale", scale),
        tensor_proto(f"{p}_bias", bias),
    ]
    red = [attr_ints("axes", [-1]), attr_i("keepdims", 1)]
    nodes += [
        node("ReduceMean", [x_name], [f"{p}_mu"], name=f"{p}_mu",
             attrs=red),
        node("Sub", [x_name, f"{p}_mu"], [f"{p}_c"], name=f"{p}_c"),
        node("Mul", [f"{p}_c", f"{p}_c"], [f"{p}_c2"], name=f"{p}_c2"),
        node("ReduceMean", [f"{p}_c2"], [f"{p}_var"], name=f"{p}_var",
             attrs=red),
        node("Add", [f"{p}_var", "ln_eps"], [f"{p}_ve"], name=f"{p}_ve"),
        node("Sqrt", [f"{p}_ve"], [f"{p}_sd"], name=f"{p}_sd"),
        node("Div", [f"{p}_c", f"{p}_sd"], [f"{p}_n"], name=f"{p}_n"),
        node("Mul", [f"{p}_n", f"{p}_scale"], [f"{p}_ns"], name=f"{p}_ns"),
        node("Add", [f"{p}_ns", f"{p}_bias"], [out_name], name=out_name),
    ]


def _gelu_nodes(prefix, x_name, out_name, nodes):
    """tanh-approximate gelu:
    0.5·x·(1 + tanh(√(2/π)·(x + 0.044715·x³)))."""
    p = prefix
    nodes += [
        node("Mul", [x_name, x_name], [f"{p}_x2"], name=f"{p}_x2"),
        node("Mul", [f"{p}_x2", x_name], [f"{p}_x3"], name=f"{p}_x3"),
        node("Mul", [f"{p}_x3", "gelu_c0"], [f"{p}_cx3"], name=f"{p}_cx3"),
        node("Add", [x_name, f"{p}_cx3"], [f"{p}_in"], name=f"{p}_in"),
        node("Mul", [f"{p}_in", "gelu_c1"], [f"{p}_si"], name=f"{p}_si"),
        node("Tanh", [f"{p}_si"], [f"{p}_t"], name=f"{p}_t"),
        node("Add", [f"{p}_t", "one"], [f"{p}_t1"], name=f"{p}_t1"),
        node("Mul", [x_name, f"{p}_t1"], [f"{p}_xt"], name=f"{p}_xt"),
        node("Mul", [f"{p}_xt", "half"], [out_name], name=out_name),
    ]


def _rope_nodes(prefix, x_name, out_name, nodes):
    """Rotate-half RoPE on a (B, S, H, D) tensor against the rope_cos /
    rope_sin constants — ``ops/rope.py``'s ``apply_rope``: out =
    concat(x1·cos − x2·sin, x1·sin + x2·cos) over the last-dim halves."""
    p = prefix
    nodes += [
        node("Slice", [x_name, "rope_st0", "rope_mid", "rope_axes"],
             [f"{p}_a"], name=f"{p}_a"),
        node("Slice", [x_name, "rope_mid", "rope_end", "rope_axes"],
             [f"{p}_b"], name=f"{p}_b"),
        node("Mul", [f"{p}_a", "rope_cos"], [f"{p}_ac"], name=f"{p}_ac"),
        node("Mul", [f"{p}_b", "rope_sin"], [f"{p}_bs"], name=f"{p}_bs"),
        node("Sub", [f"{p}_ac", f"{p}_bs"], [f"{p}_lo"], name=f"{p}_lo"),
        node("Mul", [f"{p}_a", "rope_sin"], [f"{p}_as"], name=f"{p}_as"),
        node("Mul", [f"{p}_b", "rope_cos"], [f"{p}_bc"], name=f"{p}_bc"),
        node("Add", [f"{p}_as", f"{p}_bc"], [f"{p}_hi"], name=f"{p}_hi"),
        node("Concat", [f"{p}_lo", f"{p}_hi"], [out_name], name=out_name,
             attrs=[attr_i("axis", 3)]),
    ]


def _export_transformer_lm(graph, variables, sample_shape):
    """Decoder/encoder transformer -> primitive-op ONNX. Block outputs are
    named ``block{i}`` and the logits node ``z`` (= graph.layer_names), so
    the importer's named-node cut works as on the port's graph."""
    batch, seq = sample_shape
    extra = graph.extra
    causal = bool(extra.get("causal", True))
    emb = _np(variables["embed"], "token.weight")
    rope = extra.get("pos_embedding") == "rope"
    # RoPE models have no learned position table: position enters as the
    # in-graph rotate-half of q/k against (1, S, 1, D/2) cos/sin
    # constants for THIS export length (ops/rope.py is the contract)
    pos = None if rope else _np(variables["embed"], "pos")[:seq]
    d_model = emb.shape[1]
    blocks = [n for n in graph.layer_names if n.startswith("block")]
    if not blocks:
        raise FriendlyError("transformer_lm export needs depth >= 1")
    heads = int(extra.get("heads", 0))
    if not heads:
        raise FriendlyError(
            "transformer_lm export needs the head count in graph.extra"
        )
    head_dim = d_model // heads
    # GQA-aware qkv layout: (E, (H + 2·Hkv)·D); MHA is Hkv == H
    kv_heads = int(extra.get("kv_heads") or heads)
    group = heads // kv_heads
    hd3 = _kernel(variables[blocks[0]], "attn.qkv.weight").shape[1]
    if hd3 != (heads + 2 * kv_heads) * head_dim:
        raise FriendlyError(
            f"qkv kernel must be (E, (H+2Hkv)·D); got {hd3} for "
            f"H={heads} Hkv={kv_heads} D={head_dim}"
        )

    nodes, inits = [], []
    inits += [
        tensor_proto("embedding", emb),
        tensor_proto("ln_eps", np.array(1e-6, np.float32)),
        tensor_proto("one", np.array(1.0, np.float32)),
        tensor_proto("half", np.array(0.5, np.float32)),
        tensor_proto("gelu_c0", np.array(0.044715, np.float32)),
        tensor_proto(
            "gelu_c1", np.array(np.sqrt(2.0 / np.pi), np.float32)
        ),
        tensor_proto(
            "attn_scale", np.array(1.0 / np.sqrt(head_dim), np.float32)
        ),
        tensor_proto(
            "shape_split",
            np.array([batch, seq, heads, head_dim], np.int64),
        ),
        tensor_proto(
            "shape_merge", np.array([batch, seq, d_model], np.int64)
        ),
        tensor_proto("sl_axes", np.array([2], np.int64)),
    ]
    if group > 1:
        # grouped-query expansion shapes: narrow (B,S,Hkv,D) K/V gain a
        # broadcast group axis, then flatten to (B,S,H,D) — kv head
        # i//group per query head i
        inits += [
            tensor_proto(
                "shape_kv",
                np.array([batch, seq, kv_heads, head_dim], np.int64),
            ),
            tensor_proto(
                "shape_kv5",
                np.array([batch, seq, kv_heads, 1, head_dim], np.int64),
            ),
            tensor_proto(
                "kv_expand",
                np.array([batch, seq, kv_heads, group, head_dim],
                         np.int64),
            ),
        ]
    if pos is not None:
        inits.append(tensor_proto("pos", pos))
    if rope:
        half = head_dim // 2
        inv_freq = 10000.0 ** (
            -np.arange(half, dtype=np.float32) / half
        )
        ang = np.arange(seq, dtype=np.float32)[:, None] * inv_freq[None, :]
        inits += [
            tensor_proto(
                "rope_cos",
                np.cos(ang).astype(np.float32).reshape(1, seq, 1, half),
            ),
            tensor_proto(
                "rope_sin",
                np.sin(ang).astype(np.float32).reshape(1, seq, 1, half),
            ),
            tensor_proto("rope_st0", np.array([0], np.int64)),
            tensor_proto("rope_mid", np.array([half], np.int64)),
            tensor_proto("rope_end", np.array([head_dim], np.int64)),
            tensor_proto("rope_axes", np.array([3], np.int64)),
        ]
    window = extra.get("window")
    if causal:
        # the (T, T) additive mask is built IN-GRAPH from two O(T)
        # position vectors — clip(relu(j - i), 0, 1) is exactly 1 above
        # the diagonal for integer-valued positions — so the payload
        # stays linear in sequence length
        ar = np.arange(seq, dtype=np.float32)
        inits += [
            tensor_proto("pos_row", ar.reshape(seq, 1)),
            tensor_proto("pos_col", ar.reshape(1, seq)),
            tensor_proto("zero", np.array(0.0, np.float32)),
            tensor_proto("neg_big", np.array(-1e9, np.float32)),
        ]
        cau_out = "mask_cau" if window else "causal_mask"
        nodes += [
            node("Sub", ["pos_col", "pos_row"], ["mask_d"], name="mask_d"),
            node("Relu", ["mask_d"], ["mask_r"], name="mask_r"),
            node("Clip", ["mask_r", "zero", "one"], ["mask_c"],
                 name="mask_c"),
            node("Mul", ["mask_c", "neg_big"], [cau_out], name=cau_out),
        ]
        if window:
            # sliding window: keys older than qpos - W + 1 die too —
            # clip(relu((i - j) - (W-1)), 0, 1) is 1 exactly where
            # i - j >= W, the dense attention's window contract
            inits.append(tensor_proto(
                "win_off", np.array(float(window) - 1.0, np.float32)
            ))
            nodes += [
                node("Sub", ["pos_row", "pos_col"], ["win_d"],
                     name="win_d"),
                node("Sub", ["win_d", "win_off"], ["win_o"],
                     name="win_o"),
                node("Relu", ["win_o"], ["win_r"], name="win_r"),
                node("Clip", ["win_r", "zero", "one"], ["win_c"],
                     name="win_c"),
                node("Mul", ["win_c", "neg_big"], ["win_mask"],
                     name="win_mask"),
                node("Add", ["mask_cau", "win_mask"], ["causal_mask"],
                     name="causal_mask"),
            ]

    nodes.append(
        node("Gather", ["embedding", "x"], ["tok"], name="tok",
             attrs=[attr_i("axis", 0)])
    )
    if pos is not None:
        nodes.append(node("Add", ["tok", "pos"], ["embed"], name="embed"))
        prev = "embed"
    else:
        prev = "tok"  # RoPE: position lives in the attention rotation
    for blk in blocks:
        params = variables[blk]
        p = blk
        _ln_nodes(f"{p}_ln1", prev, f"{p}_y1", nodes, inits,
                  _np(params, "ln1.weight"), _np(params, "ln1.bias"))
        # qkv projection + per-head split (contiguous q: H·D, then k and
        # v: Hkv·D each — thirds only in the MHA case)
        inits += [
            tensor_proto(f"{p}_qkv_w", _kernel(params, "attn.qkv.weight")),
            tensor_proto(f"{p}_qkv_b", _np(params, "attn.qkv.bias")),
            tensor_proto(f"{p}_ao_w",
                         _kernel(params, "attn.attn_out.weight")),
            tensor_proto(f"{p}_ao_b", _np(params, "attn.attn_out.bias")),
        ]
        nodes += [
            node("MatMul", [f"{p}_y1", f"{p}_qkv_w"], [f"{p}_qkv0"],
                 name=f"{p}_qkv0"),
            node("Add", [f"{p}_qkv0", f"{p}_qkv_b"], [f"{p}_qkv"],
                 name=f"{p}_qkv"),
        ]
        b0 = heads * head_dim
        b1 = b0 + kv_heads * head_dim
        b2 = b1 + kv_heads * head_dim
        # k/v land on the NARROW (B,S,Hkv,D) shape first: RoPE (when
        # enabled) rotates there — the (1,S,1,D/2) constants broadcast
        # over any head count — before the group expansion
        kv_shape = "shape_split" if group == 1 else "shape_kv"
        for nm, lo, hi, shp in (
            ("q", 0, b0, "shape_split"),
            ("k", b0, b1, kv_shape),
            ("v", b1, b2, kv_shape),
        ):
            inits += [
                tensor_proto(f"{p}_{nm}_st", np.array([lo], np.int64)),
                tensor_proto(f"{p}_{nm}_en", np.array([hi], np.int64)),
            ]
            nodes += [
                node("Slice",
                     [f"{p}_qkv", f"{p}_{nm}_st", f"{p}_{nm}_en",
                      "sl_axes"],
                     [f"{p}_{nm}f"], name=f"{p}_{nm}f"),
                node("Reshape", [f"{p}_{nm}f", shp],
                     [f"{p}_{nm}s"], name=f"{p}_{nm}s"),
            ]
        q_in, k_in, v_in = f"{p}_qs", f"{p}_ks", f"{p}_vs"
        if rope:
            _rope_nodes(f"{p}_rq", q_in, f"{p}_qr", nodes)
            _rope_nodes(f"{p}_rk", k_in, f"{p}_kr", nodes)
            q_in, k_in = f"{p}_qr", f"{p}_kr"
        if group > 1:
            for nm, src in (("k", k_in), ("v", v_in)):
                nodes += [
                    node("Reshape", [src, "shape_kv5"],
                         [f"{p}_{nm}5"], name=f"{p}_{nm}5"),
                    node("Expand", [f"{p}_{nm}5", "kv_expand"],
                         [f"{p}_{nm}e"], name=f"{p}_{nm}e"),
                    node("Reshape", [f"{p}_{nm}e", "shape_split"],
                         [f"{p}_{nm}x"], name=f"{p}_{nm}x"),
                ]
            k_in, v_in = f"{p}_kx", f"{p}_vx"
        nodes += [
            node("Transpose", [q_in], [f"{p}_qh"], name=f"{p}_qh",
                 attrs=[attr_ints("perm", [0, 2, 1, 3])]),
            node("Transpose", [k_in], [f"{p}_kT"], name=f"{p}_kT",
                 attrs=[attr_ints("perm", [0, 2, 3, 1])]),
            node("Transpose", [v_in], [f"{p}_vh"], name=f"{p}_vh",
                 attrs=[attr_ints("perm", [0, 2, 1, 3])]),
            node("MatMul", [f"{p}_qh", f"{p}_kT"], [f"{p}_sc0"],
                 name=f"{p}_sc0"),
            node("Mul", [f"{p}_sc0", "attn_scale"], [f"{p}_sc"],
                 name=f"{p}_sc"),
        ]
        score = f"{p}_sc"
        if causal:
            nodes.append(node("Add", [score, "causal_mask"],
                              [f"{p}_scm"], name=f"{p}_scm"))
            score = f"{p}_scm"
        nodes += [
            node("Softmax", [score], [f"{p}_pr"], name=f"{p}_pr",
                 attrs=[attr_i("axis", -1)]),
            node("MatMul", [f"{p}_pr", f"{p}_vh"], [f"{p}_ctx"],
                 name=f"{p}_ctx"),
            node("Transpose", [f"{p}_ctx"], [f"{p}_ctxT"],
                 name=f"{p}_ctxT",
                 attrs=[attr_ints("perm", [0, 2, 1, 3])]),
            node("Reshape", [f"{p}_ctxT", "shape_merge"], [f"{p}_ctxm"],
                 name=f"{p}_ctxm"),
            node("MatMul", [f"{p}_ctxm", f"{p}_ao_w"], [f"{p}_ao0"],
                 name=f"{p}_ao0"),
            node("Add", [f"{p}_ao0", f"{p}_ao_b"], [f"{p}_ao"],
                 name=f"{p}_ao"),
            node("Add", [prev, f"{p}_ao"], [f"{p}_res1"],
                 name=f"{p}_res1"),
        ]
        _ln_nodes(f"{p}_ln2", f"{p}_res1", f"{p}_y2", nodes, inits,
                  _np(params, "ln2.weight"), _np(params, "ln2.bias"))
        inits += [
            tensor_proto(f"{p}_mi_w", _kernel(params, "mlp_in.weight")),
            tensor_proto(f"{p}_mi_b", _np(params, "mlp_in.bias")),
            tensor_proto(f"{p}_mo_w", _kernel(params, "mlp_out.weight")),
            tensor_proto(f"{p}_mo_b", _np(params, "mlp_out.bias")),
        ]
        nodes += [
            node("MatMul", [f"{p}_y2", f"{p}_mi_w"], [f"{p}_h0"],
                 name=f"{p}_h0"),
            node("Add", [f"{p}_h0", f"{p}_mi_b"], [f"{p}_h"],
                 name=f"{p}_h"),
        ]
        _gelu_nodes(f"{p}_g", f"{p}_h", f"{p}_ga", nodes)
        nodes += [
            node("MatMul", [f"{p}_ga", f"{p}_mo_w"], [f"{p}_o0"],
                 name=f"{p}_o0"),
            node("Add", [f"{p}_o0", f"{p}_mo_b"], [f"{p}_o"],
                 name=f"{p}_o"),
            node("Add", [f"{p}_res1", f"{p}_o"], [blk], name=blk),
        ]
        prev = blk
    zp = variables["z"]
    _ln_nodes("zln", prev, "z_n", nodes, inits,
              _np(zp, "ln_f.weight"), _np(zp, "ln_f.bias"))
    head_k = _kernel(zp, "head.weight")
    inits += [
        tensor_proto("head_w", head_k),
        tensor_proto("head_b", _np(zp, "head.bias")),
    ]
    nodes += [
        node("MatMul", ["z_n", "head_w"], ["z0"], name="z0"),
        node("Add", ["z0", "head_b"], ["z"], name="z"),
    ]
    vocab = head_k.shape[1]
    return model_proto(
        nodes, inits,
        [value_info("x", (batch, seq), elem_type=6)],  # int32 ids
        [value_info("z", (batch, seq, vocab))],
    )


def export_onnx(graph, variables, sample_shape) -> bytes:
    """Serialize a trained graph and its port variables to ONNX bytes.

    ``sample_shape`` is the full batched input shape the export is
    specialized to (e.g. ``(batch, features)`` for mlp, ``(batch, seq)``
    for the tagger and the LM).
    """
    name = graph.name
    if name in ("linear", "mlp"):
        return _export_dense_chain(
            variables, tuple(sample_shape), graph.layer_names
        )
    if name == "bilstm_tagger":
        return _export_bilstm_tagger(variables, tuple(sample_shape))
    if name == "transformer_lm":
        return _export_transformer_lm(
            graph, variables, tuple(sample_shape)
        )
    raise FriendlyError(
        f"no ONNX exporter for model family '{name}'; supported: linear, "
        "mlp, bilstm_tagger, transformer_lm (conv families persist via "
        "the stage format)"
    )


def save_onnx(graph, variables, sample_shape, path: str) -> None:
    with open(path, "wb") as f:
        f.write(export_onnx(graph, variables, sample_shape))
