"""ONNX graph import: a serialized model file -> an executable PyTorch
graph — the port of ``mmlspark_tpu/models/onnx_import.py``.

The reference's DNN stage loads serialized CNTK-v2 graphs through JNI
(``Function.load``, cntk-model/src/main/scala/SerializableFunction.scala:
19-38) and cuts them by node name (CNTKModel.scala:97-108); node names
are what ``ImageFeaturizer`` truncates by (ImageFeaturizer.scala:122).

Here the ONNX protobuf is parsed directly (a small wire-format decoder,
no onnx package), each node becomes PyTorch ops, and the result is an
:class:`OnnxGraph` with the port's named-node protocol
(:class:`~mmlspark_tpu_torch.models.graph.NamedGraph`): ``layer_names``,
``apply(variables, x, output_node=...)`` (stop at any node), ``cut``,
``init``, ``param_count``, and the no-op ``bind``/``unbind``/
``size_input``/``stat_keys`` the stages call, so ``TPUModel.from_graph``
and ``ImageFeaturizer`` take an imported graph unchanged.

The graph runs as the file says: NCHW convolutions and pools (the port's
own ResNets are NHWC ``channels_last``; only they are), ONNX's LSTM gate
order ``i, o, f, c`` and GRU's ``z, r, h``, both directions. The
variables are ``{"onnx": {initializer name: tensor}}``; :meth:`OnnxGraph.
init` makes them from the file's initializers on a device (``cuda``
unless the caller asks for ``"cpu"``), and the JAX package's
``{"onnx": {"params": {...}}}`` crosses through
:func:`~mmlspark_tpu_torch.models.bridge.load_flax_variables`.

Captured programs: a replayed CUDA graph may not read a value back to
the host or copy from host memory. Every shape the graph computes
(``Shape``, ``Range``, ``ConstantOfShape``, the ``Reshape``/``Expand``
targets and the ``Slice``/``Split``/``Squeeze`` arguments) is folded to
numpy from the input's static shape and the integer initializers, as the
JAX importer folds them under ``jit``; a folded value the graph then uses
as data is put on the device once per input signature, on the first
(eager) call, and kept, so a capture reads it at the same address and
makes no copy. The folding reads the caller's small integer parameters
in place of the file's only when they are host tensors (the JAX importer
prefers the caller's concrete values outside ``jit`` and the file's
under it).

Where the port follows ONNX and the JAX importer does not (ROADMAP.md
Queue 3): ``Softmax`` before opset 13 defaults to axis 1 and normalizes
over the input coerced to 2-D at that axis. Integer ``Div`` truncates
toward zero and ``Mod`` follows the divisor's sign (``fmod=1``: the
dividend's), as in the JAX importer.

Registered as model ``"onnx"`` (config: ``path``), so a serialized
``TPUModel`` stage rebuilds it on load.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models.graph import resolve_node
from mmlspark_tpu_torch.models.registry import register_model

# ---------------------------------------------------------------------------
# protobuf wire-format decoding (proto3 subset: varint, 64-bit, length-
# delimited, 32-bit)
# ---------------------------------------------------------------------------


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    r = 0
    sh = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << sh
        if not b & 0x80:
            return r, i
        sh += 7


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf: bytes) -> dict[int, list[tuple[int, Any]]]:
    """Decode one message into {field_number: [(wire_type, raw_value)]}."""
    i = 0
    out: dict[int, list] = {}
    while i < len(buf):
        tag, i = _varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:  # pragma: no cover
            raise FriendlyError(f"unsupported protobuf wire type {wt}")
        out.setdefault(fn, []).append((wt, v))
    return out


def _first(fs, n, default=None):
    vals = fs.get(n)
    return vals[0][1] if vals else default


def _int(fs, n, default=0) -> int:
    v = _first(fs, n)
    return default if v is None else int(v)


def _str(fs, n, default="") -> str:
    v = _first(fs, n)
    return default if v is None else v.decode("utf-8")


def _strs(fs, n) -> list[str]:
    return [v.decode("utf-8") for _, v in fs.get(n, [])]


def _ints(fs, n) -> list[int]:
    """Repeated int64: a mix of plain varints and packed chunks."""
    out: list[int] = []
    for wt, v in fs.get(n, []):
        if wt == 0:
            out.append(_signed(v))
        else:  # packed
            i = 0
            while i < len(v):
                x, i = _varint(v, i)
                out.append(_signed(x))
    return out


def _floats(fs, n) -> list[float]:
    out: list[float] = []
    for wt, v in fs.get(n, []):
        if wt == 5:
            out.append(float(np.frombuffer(v, "<f4")[0]))
        else:  # packed
            out.extend(np.frombuffer(v, "<f4").tolist())
    return out


_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
    7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
#: ONNX dtype code -> the torch dtype a Cast produces; torch has no
#: general uint32/uint64 arithmetic, so those widen to int64
_TORCH_DTYPES = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 5: torch.int16,
    6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16,
    11: torch.float64, 12: torch.int64, 13: torch.int64,
}


def _tensor(buf: bytes) -> tuple[str, np.ndarray]:
    fs = _fields(buf)
    dims = _ints(fs, 1)
    dt = _int(fs, 2, 1)
    name = _str(fs, 8)
    if dt not in _DTYPES:
        raise FriendlyError(f"unsupported ONNX tensor dtype {dt} ({name})")
    dtype = _DTYPES[dt]
    raw = _first(fs, 9)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif dt == 1:
        arr = np.array(_floats(fs, 4), np.float32)
    elif dt in (6, 7):
        arr = np.array(_ints(fs, 5 if dt == 6 else 7), _DTYPES[dt])
    elif dt == 11:
        arr = np.concatenate(
            [np.frombuffer(v, "<f8") for _, v in fs.get(10, [])]
        ) if fs.get(10) else np.array([], np.float64)
    else:
        raise FriendlyError(f"tensor '{name}': no data fields for dtype {dt}")
    if dims:
        arr = arr.reshape(dims)
    elif arr.size == 1:
        arr = arr.reshape(())  # empty dims = an ONNX scalar, not a 1-vector
    return name, arr


@dataclasses.dataclass
class _Attr:
    f: float = 0.0
    i: int = 0
    s: str = ""
    t: np.ndarray | None = None
    floats: tuple = ()
    ints: tuple = ()
    strings: tuple = ()


def _attributes(node_fs) -> dict[str, _Attr]:
    out: dict[str, _Attr] = {}
    for _, buf in node_fs.get(5, []):
        fs = _fields(buf)
        a = _Attr(
            f=float(np.frombuffer(_first(fs, 2, b"\0\0\0\0"), "<f4")[0]),
            i=_signed(_int(fs, 3)),
            s=_str(fs, 4),
            floats=tuple(_floats(fs, 7)),
            ints=tuple(_ints(fs, 8)),
            strings=tuple(_strs(fs, 9)),
        )
        if fs.get(5):
            a.t = _tensor(_first(fs, 5))[1]
        out[_str(fs, 1)] = a
    return out


@dataclasses.dataclass
class OnnxNode:
    name: str
    op: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, _Attr]


def _host_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (a copy; unsigned words
    torch cannot compute with widen to int64)."""
    arr = np.asarray(arr)
    if arr.dtype in (np.uint16, np.uint32, np.uint64):
        arr = arr.astype(np.int64)
    return torch.tensor(arr, device=device)


def _is_int(t: torch.Tensor) -> bool:
    return not t.is_floating_point() and t.dtype != torch.bool


# ---------------------------------------------------------------------------
# op conversion (NCHW, as ONNX lays tensors out)
# ---------------------------------------------------------------------------


def _torch_pads(padding) -> list[int]:
    """Per-spatial-dim ``(lo, hi)`` pairs as ``F.pad``'s flat list (last
    dim first)."""
    flat: list[int] = []
    for lo, hi in reversed(padding):
        flat += [int(lo), int(hi)]
    return flat


_CONVS = {1: F.conv1d, 2: F.conv2d}


def _conv(x, w, b, a: dict[str, _Attr]):
    spatial = w.ndim - 2
    strides = tuple(a["strides"].ints) if "strides" in a else (1,) * spatial
    dil = tuple(a["dilations"].ints) if "dilations" in a else (1,) * spatial
    group = a["group"].i if "group" in a else 1
    if "pads" in a and a["pads"].ints:
        p = a["pads"].ints
        padding = tuple((p[i], p[i + spatial]) for i in range(spatial))
    elif a.get("auto_pad") and a["auto_pad"].s in ("SAME_UPPER", "SAME_LOWER"):
        # ONNX puts the odd padding pixel at the END for SAME_UPPER and at
        # the START for SAME_LOWER: explicit per-side pads from the static
        # input shape
        lower = a["auto_pad"].s == "SAME_LOWER"
        padding = []
        for i in range(spatial):
            size = x.shape[2 + i]
            k_eff = (w.shape[2 + i] - 1) * dil[i] + 1
            total = max(
                0, (-(-size // strides[i]) - 1) * strides[i] + k_eff - size
            )
            small, big = total // 2, total - total // 2
            padding.append((big, small) if lower else (small, big))
        padding = tuple(padding)
    else:
        padding = tuple((0, 0) for _ in range(spatial))
    if spatial not in _CONVS:
        raise FriendlyError(f"Conv over {spatial} spatial dims is not "
                            "supported")
    if any(lo != hi for lo, hi in padding):
        # asymmetric: pad explicitly, then convolve unpadded
        x = F.pad(x, _torch_pads(padding))
        padding = tuple((0, 0) for _ in range(spatial))
    y = _CONVS[spatial](x, w, None, strides, tuple(lo for lo, _ in padding),
                        dil, group)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * spatial)
    return y


_MAX_POOLS = {2: F.max_pool2d, 3: F.max_pool3d}
_SUM_POOLS = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(x, a: dict[str, _Attr], kind: str):
    if a.get("ceil_mode") and a["ceil_mode"].i:
        raise FriendlyError(
            "pool ceil_mode=1 is not supported (the window count floors "
            "the output shape); re-export the model with ceil_mode=0"
        )
    k = tuple(a["kernel_shape"].ints)
    spatial = len(k)
    strides = tuple(a["strides"].ints) if "strides" in a else k
    if "pads" in a and a["pads"].ints:
        p = a["pads"].ints
        pads = tuple((p[i], p[i + spatial]) for i in range(spatial))
    else:
        pads = tuple((0, 0) for _ in range(spatial))
    one_d = spatial == 1
    if one_d:  # (N, C, W) runs as (N, C, 1, W)
        x = x.unsqueeze(2)
        k, strides, pads = (1,) + k, (1,) + strides, ((0, 0),) + pads
        spatial = 2
    if spatial not in _MAX_POOLS:
        raise FriendlyError(f"pooling over {spatial} spatial dims is not "
                            "supported")
    flat = _torch_pads(pads)
    if kind == "max":
        out = _MAX_POOLS[spatial](F.pad(x, flat, value=-float("inf")), k,
                                  strides)
    else:
        # window sums (divisor 1) over zero padding, divided by the window
        # size or by the count of real (unpadded) elements
        total = _SUM_POOLS[spatial](F.pad(x, flat), k, strides,
                                    divisor_override=1)
        if a.get("count_include_pad") and a["count_include_pad"].i:
            out = total / float(np.prod(k))
        else:
            ones = F.pad(torch.ones_like(x), flat)
            out = total / _SUM_POOLS[spatial](ones, k, strides,
                                              divisor_override=1)
    return out.squeeze(2) if one_d else out


def _gemm(x, w, b, a: dict[str, _Attr]):
    alpha = a["alpha"].f if "alpha" in a else 1.0
    beta = a["beta"].f if "beta" in a else 1.0
    if a.get("transA") and a["transA"].i:
        x = x.T
    if a.get("transB") and a["transB"].i:
        w = w.T
    y = alpha * (x @ w)
    if b is not None:
        y = y + beta * b
    return y


def _gather(data, idx, axis: int):
    """``jnp.take``/``np.take``: negative indices wrap; the output shape is
    ``data.shape[:axis] + idx.shape + data.shape[axis + 1:]``."""
    axis = axis % data.ndim
    idx = idx.long()
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)
    out = data.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(data.shape[:axis]) + tuple(idx.shape)
                       + tuple(data.shape[axis + 1:]))


def _slice(x, starts, ends, axes, steps):
    """ONNX Slice on static arguments: clamped like Python slices,
    negative steps walking backwards (torch slices step forward only, so
    the axis is flipped first)."""
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % x.ndim
        n = x.shape[ax]
        start, stop, step = slice(st, en, sp).indices(n)
        if step > 0:
            x = x[(slice(None),) * ax + (slice(start, stop, step),)]
            continue
        picked = range(start, stop, step)
        if not picked:
            x = x.narrow(ax, 0, 0)
            continue
        # the reversed axis holds index i at n - 1 - i
        lo, hi = n - 1 - picked[0], n - 1 - picked[-1]
        x = x.flip(ax)[(slice(None),) * ax + (slice(lo, hi + 1, -step),)]
    return x


def _softmax(x, axis: int, opset: int | None, explicit: bool):
    """Softmax: per-axis from opset 13 on (and for an unknown opset);
    before opset 13 the input is coerced to 2-D at ``axis`` (default 1)
    and normalized over everything from ``axis`` on."""
    if opset is None or opset >= 13:
        return torch.softmax(x, dim=axis)
    axis = (axis if explicit else 1) % max(x.ndim, 1)
    lead = int(np.prod(x.shape[:axis]))
    return torch.softmax(x.reshape(lead, -1), dim=-1).reshape(x.shape)


def _opt_input(node, env, i):
    """Optional ONNX input: None when absent or named '' (spec sentinel)."""
    if i >= len(node.inputs) or not node.inputs[i]:
        return None
    return env[node.inputs[i]]


#: scan directions per the RNN 'direction' attribute; True runs the
#: sequence backwards
_RNN_DIRECTIONS = {
    "": (False,),
    "forward": (False,),
    "reverse": (True,),
    "bidirectional": (False, True),
}

_DEFAULT_ACTS = {
    "LSTM": ("Sigmoid", "Tanh", "Tanh"),
    "GRU": ("Sigmoid", "Tanh"),
}


def _rnn_parts(node, env, a, n_gates: int):
    """Common LSTM/GRU input unpacking per the ONNX spec: X (S, B, I),
    W (D, n_gates*H, I), R (D, n_gates*H, H), optional B (D, 2*n_gates*H).
    Returns (x, w, r, wb, rb, hidden, reverses)."""
    x, w, r = (_opt_input(node, env, i) for i in range(3))
    hidden = a["hidden_size"].i if "hidden_size" in a else r.shape[-1]
    direction = a["direction"].s if "direction" in a else ""
    if direction not in _RNN_DIRECTIONS:
        raise FriendlyError(
            f"ONNX {node.op} '{node.name}': unknown direction "
            f"'{direction}'"
        )
    reverses = _RNN_DIRECTIONS[direction]
    dirs = w.shape[0]
    if dirs != len(reverses):
        raise FriendlyError(
            f"ONNX {node.op} '{node.name}': weight dirs {dirs} != "
            f"direction '{direction or 'forward'}'"
        )
    acts = tuple(a["activations"].strings) if "activations" in a else ()
    if acts and acts != _DEFAULT_ACTS[node.op] * dirs:
        raise FriendlyError(
            f"ONNX {node.op} '{node.name}': only default activations "
            f"{_DEFAULT_ACTS[node.op]} are supported, got {acts}"
        )
    if "clip" in a and a["clip"].f:
        raise FriendlyError(
            f"ONNX {node.op} '{node.name}': cell clipping (clip="
            f"{a['clip'].f}) is not supported"
        )
    if "layout" in a and a["layout"].i:
        raise FriendlyError(
            f"ONNX {node.op} '{node.name}': layout=1 (batch-major) is "
            "not supported; export with the default seq-major layout"
        )
    b = _opt_input(node, env, 3)
    if b is None:
        wb = x.new_zeros((dirs, n_gates * hidden))
        rb = x.new_zeros((dirs, n_gates * hidden))
    else:
        wb, rb = b[:, : n_gates * hidden], b[:, n_gates * hidden:]
    if _opt_input(node, env, 4) is not None:
        raise FriendlyError(
            f"ONNX {node.op} '{node.name}': per-row sequence_lens is not "
            "supported — pad to a fixed length (data/feed.py bucketing)"
        )
    return x, w, r, wb, rb, hidden, reverses


def _run_direction(step, xw, carry, reverse: bool):
    """Run ``step(carry, xw_t) -> (carry, y_t)`` over time (backwards when
    ``reverse``); returns the last carry and the (S, ...) outputs in
    sequence order."""
    steps = range(xw.shape[0] - 1, -1, -1) if reverse else range(xw.shape[0])
    ys = [None] * xw.shape[0]
    for t in steps:
        carry, ys[t] = step(carry, xw[t])
    return carry, torch.stack(ys)


def _onnx_lstm(node, env, a):
    """ONNX LSTM (opset 7+ semantics, default activations; gate order
    i, o, f, c). Outputs Y (S, D, B, H), Y_h (D, B, H), Y_c (D, B, H). The
    input projection of every step is one product up front; the
    recurrence is a loop over time per direction."""
    x, w, r, wb, rb, hidden, reverses = _rnn_parts(node, env, a, 4)
    _, batch, _ = x.shape
    dirs = len(reverses)
    if _opt_input(node, env, 7) is not None:
        raise FriendlyError(
            f"ONNX LSTM '{node.name}': peephole weights (input P) are "
            "not supported"
        )
    h0 = _opt_input(node, env, 5)
    c0 = _opt_input(node, env, 6)
    h0 = x.new_zeros((dirs, batch, hidden)) if h0 is None else h0
    c0 = x.new_zeros((dirs, batch, hidden)) if c0 is None else c0

    ys, hts, cts = [], [], []
    for d, rev in enumerate(reverses):
        rd = r[d]
        xw = x @ w[d].T  # (S, B, 4H)
        bias = wb[d] + rb[d]

        def step(carry, xw_t, rd=rd, bias=bias):
            h, c = carry
            g = xw_t + h @ rd.T + bias
            i_, o, f, cc = torch.split(g, hidden, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i_) * torch.tanh(cc)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            return (h_new, c_new), h_new

        (ht, ct), y = _run_direction(step, xw, (h0[d], c0[d]), rev)
        ys.append(y)
        hts.append(ht)
        cts.append(ct)
    return [torch.stack(ys, dim=1), torch.stack(hts), torch.stack(cts)]


def _onnx_gru(node, env, a):
    """ONNX GRU (gate order z, r, h; ``linear_before_reset`` honored)."""
    x, w, r, wb, rb, hidden, reverses = _rnn_parts(node, env, a, 3)
    _, batch, _ = x.shape
    dirs = len(reverses)
    lbr = bool(a["linear_before_reset"].i) if "linear_before_reset" in a \
        else False
    h0 = _opt_input(node, env, 5)
    h0 = x.new_zeros((dirs, batch, hidden)) if h0 is None else h0

    ys, hts = [], []
    for d, rev in enumerate(reverses):
        rz, rr, rh = torch.split(r[d], hidden, dim=0)
        wbz, wbr, wbh = torch.split(wb[d], hidden)
        rbz, rbr, rbh = torch.split(rb[d], hidden)
        xw = x @ w[d].T  # (S, B, 3H): the z, r, h input projections

        def step(h, xw_t, rz=rz, rr=rr, rh=rh, wbz=wbz, wbr=wbr, wbh=wbh,
                 rbz=rbz, rbr=rbr, rbh=rbh):
            xz, xr, xh = torch.split(xw_t, hidden, dim=-1)
            z = torch.sigmoid(xz + h @ rz.T + wbz + rbz)
            rg = torch.sigmoid(xr + h @ rr.T + wbr + rbr)
            if lbr:
                hh = torch.tanh(xh + rg * (h @ rh.T + rbh) + wbh)
            else:
                hh = torch.tanh(xh + (rg * h) @ rh.T + wbh + rbh)
            h_new = (1.0 - z) * hh + z * h
            return h_new, h_new

        ht, y = _run_direction(step, xw, h0[d], rev)
        ys.append(y)
        hts.append(ht)
    return [torch.stack(ys, dim=1), torch.stack(hts)]


def _fold_constants(node: OnnxNode, consts: dict) -> bool:
    """Propagate shape arithmetic through ``consts`` with numpy so a
    downstream Reshape/Expand/Slice can treat it as static. Fires only
    when every input is already a known constant; returns True when the
    node was folded (its torch evaluation is then skipped)."""
    a = node.attrs
    ins = []
    for nm in node.inputs:
        if not nm:
            ins.append(None)
            continue
        if nm not in consts:
            return False
        arr = np.asarray(consts[nm])
        # fold SHAPE math only (small integer/bool tensors): folding float
        # data would bake initializer values in and ignore retrained
        # ``variables`` for the same names
        if arr.dtype.kind not in "iub" or arr.size > 1024:
            return False
        ins.append(arr)
    try:
        if node.op == "Concat":
            out = np.concatenate(ins, axis=a["axis"].i)
        elif node.op == "Gather":
            axis = a["axis"].i if "axis" in a else 0
            out = np.take(ins[0], ins[1].astype(np.int64), axis=axis)
        elif node.op == "Squeeze":
            axes = tuple(int(v) for v in ins[1].ravel()) if len(ins) > 1 \
                else tuple(a.get("axes", _Attr()).ints)
            out = np.squeeze(ins[0], axis=axes or None)
        elif node.op == "Unsqueeze":
            axes = tuple(int(v) for v in ins[1].ravel()) if len(ins) > 1 \
                else tuple(a["axes"].ints)
            out = ins[0]
            for ax in sorted(axes):
                out = np.expand_dims(out, ax)
        elif node.op == "Add":
            out = ins[0] + ins[1]
        elif node.op == "Sub":
            out = ins[0] - ins[1]
        elif node.op == "Mul":
            out = ins[0] * ins[1]
        elif node.op == "Div":
            # integer Div truncates toward zero in ONNX; a zero divisor
            # stays dynamic, and the integer ops stay exact past 2^53
            if ins[0].dtype.kind in "iu":
                if not np.all(ins[1]):
                    return False
                out = (
                    np.sign(ins[0]) * np.sign(ins[1])
                    * (np.abs(ins[0]) // np.abs(ins[1]))
                ).astype(ins[0].dtype)
            else:
                out = ins[0] / ins[1]
        elif node.op == "Mod":
            # fmod=1 -> the dividend's sign (C fmod); default -> the
            # divisor's (Python %); a zero divisor stays dynamic
            if not np.all(ins[1]):
                return False
            fmod = bool(a["fmod"].i) if "fmod" in a else False
            out = np.fmod(ins[0], ins[1]) if fmod else np.mod(ins[0], ins[1])
        elif node.op == "Cast":
            to = a["to"].i
            if to not in _DTYPES:
                return False
            out = ins[0].astype(_DTYPES[to])
        elif node.op == "Reshape":
            shape = [int(v) for v in ins[1].ravel()]
            if any(v == 0 for v in shape):
                return False  # 0 = copy-input-dim in ONNX; stay dynamic
            out = np.reshape(ins[0], shape)
        elif node.op == "Slice" and len(ins) > 1:
            idx = [slice(None)] * ins[0].ndim
            starts = [int(v) for v in ins[1].ravel()]
            ends = [int(v) for v in ins[2].ravel()]
            axes = ([int(v) for v in ins[3].ravel()]
                    if len(ins) > 3 and ins[3] is not None
                    else list(range(len(starts))))
            steps = ([int(v) for v in ins[4].ravel()]
                     if len(ins) > 4 and ins[4] is not None
                     else [1] * len(starts))
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                idx[ax] = slice(st, en, sp)
            out = ins[0][tuple(idx)]
        else:
            return False
    except Exception:
        return False  # stay dynamic; the torch path handles the node
    out = np.asarray(out)
    if out.dtype.kind not in "iub":
        return False  # int-in/float-out (Cast) must stay on the data path
    consts[node.outputs[0]] = out
    return True


def _static_ints(name, consts) -> list[int]:
    if name in consts:
        return [int(v) for v in np.asarray(consts[name]).ravel()]
    raise FriendlyError(
        f"'{name}' must be a constant (initializer or Constant node) — "
        "a data-dependent shape cannot be part of a captured program"
    )


# ---------------------------------------------------------------------------
# the executable graph
# ---------------------------------------------------------------------------


class OnnxGraph:
    """Topologically-ordered ONNX nodes executed with PyTorch ops.

    Duck-types the port's :class:`NamedGraph` protocol (``layer_names``,
    ``apply`` with ``output_node``, ``cut``, ``init``, ``param_count``,
    and ``bind``/``unbind``/``size_input``/``stat_keys``, which have
    nothing to do for an imported graph) so ``TPUModel.from_graph`` and
    ``ImageFeaturizer`` work unchanged on imported models.
    """

    def __init__(self, name: str, nodes: list[OnnxNode],
                 initializers: dict[str, np.ndarray],
                 input_name: str, output_name: str,
                 input_shape: tuple = (), opset: int | None = None):
        self.name = name
        self.nodes = nodes
        self.initializers = initializers
        self.input_name = input_name
        self.output_name = output_name
        self.input_shape = input_shape
        self.opset = opset  # default-domain ai.onnx version (None: unknown)
        self.compute_dtype = None
        self.extra: dict = {"format": "onnx"}
        #: folded values used as data on the card, per (input signature,
        #: tensor name): made on a signature's first (eager) call and
        #: kept, so a captured replay reads them at a fixed address
        self._device_consts: dict[tuple, torch.Tensor] = {}
        consumed = {output_name}
        for n in nodes:
            consumed.update(i for i in n.inputs if i)
        #: tensor names THIS graph reads (a cut graph sees only its own
        #: consumers): unconsumed optional outputs (an exporter may name
        #: LayerNormalization's Mean/InvStdDev) are never bound
        self._consumed = consumed

    # -- the NamedGraph protocol -------------------------------------------

    @property
    def layer_names(self) -> list[str]:
        return [n.name for n in self.nodes]

    @property
    def blocks(self):  # parity helper: (name, node) pairs
        return [(n.name, n) for n in self.nodes]

    def _check_node(self, node: str | int | None) -> str | None:
        return resolve_node(self.layer_names, node, self.name)

    def init(self, rng=None, sample=None, *, device=None) -> dict:
        """Imported graphs arrive trained: the variables are the
        initializers, on ``device`` (``cuda`` unless the caller asks for
        ``"cpu"``)."""
        dev = default_device(device)
        return {"onnx": {k: _host_tensor(v, dev)
                         for k, v in self.initializers.items()}}

    def from_flax_variables(self, variables, *, device=None) -> dict:
        """The JAX package's ``{"onnx": {"params": {name: array}}}`` as
        the port's variables on ``device``."""
        dev = default_device(device)
        try:
            params = variables["onnx"]["params"]
        except (KeyError, TypeError) as e:
            raise FriendlyError(
                "flax variables of an imported graph must be "
                "{'onnx': {'params': {...}}}") from e
        return {"onnx": {k: _host_tensor(np.asarray(v), dev)
                         for k, v in params.items()}}

    def bind(self, variables) -> None:
        """Nothing to bind: :meth:`apply` reads the variables' tensors."""

    def unbind(self) -> None:
        """Nothing bound, nothing to drop."""

    def size_input(self, example_shape) -> None:
        """An imported graph's widths are the file's."""

    def stat_keys(self, block_name: str) -> frozenset:
        """Imported graphs keep no running statistics apart from their
        parameters (BatchNormalization's mean and variance are
        initializers)."""
        return frozenset()

    def apply(self, variables, x, output_node: str | int | None = None,
              train: bool = False, rngs=None, mask=None):
        """Run the nodes on ``x`` (stopping after ``output_node`` when
        given). Eval mode runs under ``no_grad``; train mode returns
        ``(out, variables)``. ``rngs`` and ``mask`` are accepted for the
        trainer interface: imported graphs draw no random numbers and
        route nothing by padding rows."""
        params = variables["onnx"]
        stop = self._check_node(output_node)
        with contextlib.nullcontext() if train else torch.no_grad():
            out = self._run(params, x, stop)
        return (out, variables) if train else out

    def _fold_source(self, params: dict, x) -> dict:
        """The integer constants shape folding reads: the initializers,
        with the caller's small integer parameters in their place where
        those are host tensors (a card tensor would need a host sync)."""
        consts = dict(self.initializers)
        if x.device.type != "cpu":
            return consts
        for k, v in params.items():
            if isinstance(v, torch.Tensor) and v.device.type == "cpu" \
                    and not v.is_floating_point() and v.numel() <= 1024:
                consts[k] = v.numpy()
        return consts

    def _run(self, params: dict, x, stop: str | None):
        consts = self._fold_source(params, x)
        sig = (tuple(x.shape), x.dtype, x.device)
        on_card = x.device.type == "cuda"

        def const(name: str, arr: np.ndarray) -> torch.Tensor:
            if not on_card:
                return _host_tensor(arr, x.device)
            key = (sig, name)
            t = self._device_consts.get(key)
            if t is None:
                t = self._device_consts[key] = _host_tensor(arr, x.device)
            return t

        env: dict[str, Any] = dict(params)
        env[self.input_name] = x
        out = None
        for node in self.nodes:
            if _fold_constants(node, consts):
                vals = [const(node.outputs[0], consts[node.outputs[0]])]
            else:
                vals = _apply_node(node, env, consts, const, self._consumed,
                                   self.opset)
            for oname, v in zip(node.outputs, vals):
                env[oname] = v
            out = vals[0]
            if node.name == stop:
                break
        if stop is None and self.output_name in env:
            out = env[self.output_name]
        return out

    def cut(self, node: str | int) -> "OnnxGraph":
        stop = self._check_node(node)
        idx = self.layer_names.index(stop)
        kept = self.nodes[: idx + 1]
        return OnnxGraph(
            name=f"{self.name}@{stop}",
            nodes=kept,
            initializers=self.initializers,
            input_name=self.input_name,
            output_name=kept[-1].outputs[0],
            input_shape=self.input_shape,
            opset=self.opset,
        )

    def param_count(self, variables=None) -> int:
        if variables:
            return sum(int(t.numel()) for t in variables["onnx"].values())
        return sum(int(np.asarray(v).size)
                   for v in self.initializers.values())


def _apply_node(node: OnnxNode, env: dict, consts: dict, const,
                consumed: set | None = None,
                opset: int | None = None) -> list:
    """One node's outputs. ``const(name, array)`` makes a host value the
    node computed into a tensor beside the input (kept on the card)."""
    a = node.attrs
    op = node.op

    def inp(i, default=None):
        v = _opt_input(node, env, i)
        return default if v is None else v

    if op == "Conv":
        return [_conv(inp(0), inp(1), inp(2), a)]
    if op == "Gemm":
        return [_gemm(inp(0), inp(1), inp(2), a)]
    if op == "MatMul":
        return [inp(0) @ inp(1)]
    if op == "Add":
        return [inp(0) + inp(1)]
    if op == "Sub":
        return [inp(0) - inp(1)]
    if op == "Mul":
        return [inp(0) * inp(1)]
    if op == "Div":
        x0, x1 = inp(0), inp(1)
        if _is_int(x0) and _is_int(x1):
            # C-style truncation, the ONNX (and lax.div) semantics
            return [torch.div(x0, x1, rounding_mode="trunc")]
        return [x0 / x1]
    if op == "Mod":
        x0, x1 = inp(0), inp(1)
        fmod = bool(a["fmod"].i) if "fmod" in a else False
        if fmod or not _is_int(x0):
            return [torch.fmod(x0, x1)]  # the dividend's sign (C fmod)
        return [torch.remainder(x0, x1)]  # default int Mod: the divisor's
    if op == "Relu":
        return [F.relu(inp(0))]
    if op == "LeakyRelu":
        alpha = a["alpha"].f if "alpha" in a else 0.01
        return [F.leaky_relu(inp(0), alpha)]
    if op == "Sigmoid":
        return [torch.sigmoid(inp(0))]
    if op == "Tanh":
        return [torch.tanh(inp(0))]
    if op == "Erf":
        return [torch.erf(inp(0))]
    if op == "Sqrt":
        return [torch.sqrt(inp(0))]
    if op == "Pow":
        return [inp(0) ** inp(1)]
    if op == "Exp":
        return [torch.exp(inp(0))]
    if op == "Softmax":
        axis = a["axis"].i if "axis" in a else -1
        return [_softmax(inp(0), axis, opset, "axis" in a)]
    if op == "MaxPool":
        return [_pool(inp(0), a, "max")]
    if op == "AveragePool":
        return [_pool(inp(0), a, "avg")]
    if op == "GlobalAveragePool":
        x = inp(0)
        return [x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)]
    if op == "BatchNormalization":
        x, scale, bias, mean, var = (inp(i) for i in range(5))
        eps = a["epsilon"].f if "epsilon" in a else 1e-5
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return [
            (x - mean.reshape(shape))
            * (scale.reshape(shape) / torch.sqrt(var.reshape(shape) + eps))
            + bias.reshape(shape)
        ]
    if op == "Flatten":
        axis = a["axis"].i if "axis" in a else 1
        x = inp(0)
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return [x.reshape(lead, -1)]
    if op == "Reshape":
        x = inp(0)
        shape = _static_ints(node.inputs[1], consts)
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        return [x.reshape(shape)]
    if op == "Transpose":
        x = inp(0)
        perm = list(a["perm"].ints) if "perm" in a \
            else list(range(x.ndim))[::-1]
        return [x.permute(perm)]
    if op == "Concat":
        xs = [env[i] for i in node.inputs]
        return [torch.cat(xs, dim=a["axis"].i)]
    if op in ("Identity", "Dropout"):  # Dropout = identity at inference
        return [inp(0)]
    if op == "Constant":
        val = a["value"].t
        consts[node.outputs[0]] = val
        return [const(node.outputs[0], val)]
    if op == "Squeeze":
        axes = (_static_ints(node.inputs[1], consts)
                if len(node.inputs) > 1 else list(a.get("axes", _Attr()).ints))
        x = inp(0)
        return [x.squeeze(tuple(axes)) if axes else x.squeeze()]
    if op == "Unsqueeze":
        axes = (_static_ints(node.inputs[1], consts)
                if len(node.inputs) > 1 else list(a["axes"].ints))
        x = inp(0)
        for ax in sorted(axes):
            x = x.unsqueeze(ax)
        return [x]
    if op == "ReduceMean":
        axes = tuple(a["axes"].ints) if "axes" in a else ()
        keep = bool(a["keepdims"].i) if "keepdims" in a else True
        x = inp(0)
        if not x.is_floating_point():
            x = x.float()  # an integer mean is a float, as in jnp.mean
        return [x.mean(dim=axes or tuple(range(x.ndim)), keepdim=keep)]
    if op == "Gather":
        axis = a["axis"].i if "axis" in a else 0
        return [_gather(inp(0), inp(1), axis)]
    if op == "Clip":
        lo = inp(1, a["min"].f if "min" in a else None)
        hi = inp(2, a["max"].f if "max" in a else None)
        x = inp(0)
        # one bound at a time: a bound may be a tensor or a number
        if lo is not None:
            x = torch.clamp(x, min=lo)
        if hi is not None:
            x = torch.clamp(x, max=hi)
        return [x]
    if op == "Shape":
        # shapes are static, so Shape folds to a constant — the anchor of
        # torch's Shape->Gather->Concat->Reshape chains; opset 15 adds
        # start/end slicing of the shape vector
        full = np.array(inp(0).shape, np.int64)
        start = a["start"].i if "start" in a else 0
        end = a["end"].i if "end" in a else len(full)
        shape = full[start:end]
        consts[node.outputs[0]] = shape
        return [const(node.outputs[0], shape)]
    if op == "Expand":
        shape = _static_ints(node.inputs[1], consts)
        x = inp(0)
        return [x.expand(np.broadcast_shapes(tuple(x.shape), tuple(shape)))]
    if op == "Range":
        vals = []
        for i in range(3):
            nm = node.inputs[i]
            if nm not in consts:
                raise FriendlyError(
                    f"Range input '{nm}' must be constant — a "
                    "data-dependent shape cannot be part of a captured "
                    "program"
                )
            vals.append(np.asarray(consts[nm]).ravel()[0])
        out = np.arange(vals[0], vals[1], vals[2])  # dtype from operands
        if out.dtype.kind in "iub":
            consts[node.outputs[0]] = out
        return [const(node.outputs[0], out)]
    if op == "ConstantOfShape":
        shape = _static_ints(node.inputs[0], consts)
        fill = a["value"].t if "value" in a and a["value"].t is not None \
            else np.zeros(1, np.float32)
        out = np.full(tuple(shape), fill.ravel()[0], fill.dtype)
        consts[node.outputs[0]] = out
        return [const(node.outputs[0], out)]
    if op == "Neg":
        return [-inp(0)]
    if op == "Cast":
        to = a["to"].i
        if to not in _TORCH_DTYPES:
            raise FriendlyError(f"Cast to unsupported dtype code {to}")
        return [inp(0).to(_TORCH_DTYPES[to])]
    if op == "Where":
        return [torch.where(inp(0).bool(), inp(1), inp(2))]
    if op == "ReduceSum":
        if len(node.inputs) > 1 and node.inputs[1]:  # opset 13: axes input
            axes = tuple(_static_ints(node.inputs[1], consts))
        else:
            axes = tuple(a["axes"].ints) if "axes" in a else ()
        keep = bool(a["keepdims"].i) if "keepdims" in a else True
        x = inp(0)
        if not axes:
            # empty axes: noop_with_empty_axes=1 -> identity, else (the
            # default) reduce over ALL axes
            if "noop_with_empty_axes" in a and a["noop_with_empty_axes"].i:
                return [x]
            axes = tuple(range(x.ndim))
        # an integer sum keeps its dtype, as jnp.sum does (torch widens)
        return [x.sum(dim=axes, keepdim=keep, dtype=x.dtype)]
    if op == "Split":
        x = inp(0)
        axis = a["axis"].i if "axis" in a else 0
        dim = x.shape[axis]
        if len(node.inputs) > 1 and node.inputs[1]:  # opset 13: sizes input
            sizes = _static_ints(node.inputs[1], consts)
        elif "split" in a:
            sizes = list(a["split"].ints)
        else:  # equal parts, one per declared output
            n_out = len(node.outputs)
            if opset is not None and opset < 18 and dim % n_out:
                # before opset 18 an even split is required when no sizes
                # are given (onnxruntime errors); only opset 18's
                # num_outputs form defines the smaller final chunk
                raise FriendlyError(
                    f"Split (opset {opset}): dim {dim} is not divisible "
                    f"by {n_out} outputs and no 'split' sizes given"
                )
            # opset-18 num_outputs semantics: ceil-sized chunks, a smaller
            # final chunk when the dim is indivisible
            chunk = -(-dim // n_out)
            sizes = [chunk] * (n_out - 1)
            sizes.append(dim - chunk * (n_out - 1))
            if sizes[-1] <= 0:
                raise FriendlyError(
                    f"Split: dim {dim} cannot fill {n_out} outputs"
                )
        if sum(sizes) != dim:
            raise FriendlyError(
                f"Split sizes {sizes} do not sum to dim {dim}"
            )
        return list(torch.split(x, sizes, dim=axis))
    if op == "LayerNormalization":  # opset 17 fused form
        # reject only optional outputs this graph actually reads; names
        # merely declared by the exporter are never bound
        extra = [o for o in node.outputs[1:]
                 if o and (consumed is None or o in consumed)]
        if extra:
            raise FriendlyError(
                f"LayerNormalization node '{node.name}' has consumed "
                f"optional outputs {extra} (Mean/InvStdDev) — only the "
                "primary output is supported"
            )
        x, scale = inp(0), inp(1)
        bias = inp(2) if len(node.inputs) > 2 and node.inputs[2] else None
        axis = a["axis"].i if "axis" in a else -1
        eps = a["epsilon"].f if "epsilon" in a else 1e-5
        axes = tuple(range(axis % x.ndim, x.ndim))
        # statistics in float32 (the spec's stash_type default): fp16
        # inputs would overflow the squared term around |x| ~ 256
        xs = x.float()
        mu = xs.mean(dim=axes, keepdim=True)
        var = ((xs - mu) ** 2).mean(dim=axes, keepdim=True)
        out = ((xs - mu) / torch.sqrt(var + eps)).to(x.dtype) * scale
        if bias is not None:
            out = out + bias
        return [out]
    if op == "Sum":
        out = env[node.inputs[0]]
        for nm in node.inputs[1:]:
            out = out + env[nm]
        return [out]
    if op == "Slice":
        x = inp(0)
        if len(node.inputs) > 1:  # opset 10+: starts/ends/axes/steps inputs
            starts = _static_ints(node.inputs[1], consts)
            ends = _static_ints(node.inputs[2], consts)
            axes = (_static_ints(node.inputs[3], consts)
                    if len(node.inputs) > 3 and node.inputs[3]
                    else list(range(len(starts))))
            steps = (_static_ints(node.inputs[4], consts)
                     if len(node.inputs) > 4 and node.inputs[4]
                     else [1] * len(starts))
        else:  # opset 1: attributes
            starts = list(a["starts"].ints)
            ends = list(a["ends"].ints)
            axes = (list(a["axes"].ints) if "axes" in a
                    else list(range(len(starts))))
            steps = [1] * len(starts)
        return [_slice(x, starts, ends, axes, steps)]
    if op == "LSTM":
        return _onnx_lstm(node, env, a)
    if op == "GRU":
        return _onnx_gru(node, env, a)
    raise FriendlyError(
        f"unsupported ONNX op '{op}' (node '{node.name}'); supported ops "
        "cover the CNN/MLP, LSTM/GRU and transformer families — extend "
        "_apply_node for more"
    )


# ---------------------------------------------------------------------------
# model file -> OnnxGraph
# ---------------------------------------------------------------------------


def load_onnx(src) -> OnnxGraph:
    """Parse an ONNX file (a path) or its bytes into an
    :class:`OnnxGraph`."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            data = f.read()
        name = str(src)
    else:
        data = bytes(src)
        name = "onnx"
    model = _fields(data)
    graph_buf = _first(model, 7)
    if graph_buf is None:
        raise FriendlyError("not an ONNX ModelProto (no graph field)")
    g = _fields(graph_buf)
    gname = _str(g, 2) or name

    initializers: dict[str, np.ndarray] = {}
    for _, buf in g.get(5, []):
        tname, arr = _tensor(buf)
        initializers[tname] = arr

    nodes: list[OnnxNode] = []
    seen: set[str] = set()
    for idx, (_, buf) in enumerate(g.get(1, [])):
        fs = _fields(buf)
        outputs = _strs(fs, 2)
        nm = _str(fs, 3) or (outputs[0] if outputs else f"node{idx}")
        if nm in seen:  # uniquify: names address nodes
            nm = f"{nm}#{idx}"
        seen.add(nm)
        nodes.append(
            OnnxNode(
                name=nm,
                op=_str(fs, 4),
                inputs=_strs(fs, 1),
                outputs=outputs,
                attrs=_attributes(fs),
            )
        )

    input_name = ""
    input_shape: tuple = ()
    for _, buf in g.get(11, []):  # graph inputs
        fs = _fields(buf)
        nm = _str(fs, 1)
        if nm not in initializers:
            input_name = nm
            input_shape = _value_info_shape(fs)
            break
    out_name = ""
    outs = g.get(12, [])
    if outs:
        out_name = _str(_fields(outs[0][1]), 1)
    if not input_name:
        raise FriendlyError("ONNX graph has no non-initializer input")
    # ModelProto.opset_import (field 8): the default-domain ai.onnx version
    # gates version-dependent op semantics (Split's uneven chunks,
    # Softmax's axis)
    opset = None
    for _, buf in model.get(8, []):
        fs = _fields(buf)
        if _str(fs, 1) in ("", "ai.onnx"):
            v = _int(fs, 2)
            opset = v if opset is None else max(opset, v)
    return OnnxGraph(
        name=gname,
        nodes=nodes,
        initializers=initializers,
        input_name=input_name,
        output_name=out_name,
        input_shape=input_shape,
        opset=opset,
    )


def _value_info_shape(fs) -> tuple:
    type_buf = _first(fs, 2)
    if type_buf is None:
        return ()
    tt = _first(_fields(type_buf), 1)
    if tt is None:
        return ()
    shape_buf = _first(_fields(tt), 2)
    if shape_buf is None:
        return ()
    dims = []
    for _, dbuf in _fields(shape_buf).get(1, []):
        dims.append(_int(_fields(dbuf), 1, -1))
    return tuple(dims[1:])  # drop the batch dim


@register_model("onnx")
def _onnx_builder(path: str = "", **_ignored) -> OnnxGraph:
    if not path:
        raise FriendlyError("model 'onnx' needs config {'path': <file>}")
    return load_onnx(path)
