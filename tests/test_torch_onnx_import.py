"""The port's ONNX importer (``mmlspark_tpu_torch/models/onnx_import.py``)
against the JAX package's (``mmlspark_tpu/models/onnx_import.py``),
mirroring ``tests/test_onnx_import.py`` and ``tests/test_onnx_golden.py``.

Every proto is written byte by byte with a minimal protobuf writer (the
mirror of the importer's decoder), loaded by BOTH importers, and run on
the same numpy inputs: the JAX graph as the JAX suite runs it on the CPU,
the port's on CPU tensors. Tolerance: float32 outputs within 1e-5
(absolute and relative; both compute in f32 and differ only in the order
of sums), integer outputs exactly. The golden files come from PyTorch's
own exporter (the legacy TorchScript path; with the ``onnx`` package
absent its one no-op post-pass is stubbed, as the golden JAX test does)
and are held to PyTorch's forward and to the JAX importer.

Where the port follows the ONNX spec and the JAX importer does not
(``Softmax`` before opset 13; ROADMAP.md Queue 3), the port is held to
numpy's reading of the spec and the JAX importer's output is recorded
beside it.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.onnx_import import load_onnx as jax_load_onnx
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models import build_model
from mmlspark_tpu_torch.models.onnx_import import OnnxGraph, load_onnx


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(atol=1e-5, rtol=1e-5)

# -- minimal protobuf writer -------------------------------------------------


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


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    dt = {np.dtype("float32"): 1, np.dtype("int64"): 7,
          np.dtype("int32"): 6}[arr.dtype]
    body = b"".join(_i(1, d) for d in arr.shape)
    body += _i(2, dt) + _s(8, name)
    body += _field(9, 2, _varint(arr.nbytes) + arr.tobytes())
    return body


def attr(name: str, *, i=None, f=None, ints=None, t=None, s=None,
         strings=None) -> bytes:
    body = _s(1, name)
    if i is not None:
        body += _i(3, i)
    if f is not None:
        body += _f(2, f)
    if ints is not None:
        body += b"".join(_i(8, v) for v in ints)
    if t is not None:
        body += _msg(5, t)
    if s is not None:
        body += _s(4, s)
    if strings is not None:
        for v in strings:
            body += _s(9, v)
    return body


def node(op: str, inputs, outputs, name="", attrs=()) -> bytes:
    body = b"".join(_s(1, x) for x in inputs)
    body += b"".join(_s(2, x) for x in outputs)
    body += _s(3, name) + _s(4, op)
    body += b"".join(_msg(5, a) for a in attrs)
    return body


def value_info(name: str, shape) -> bytes:
    dims = b"".join(_msg(1, _i(1, d)) for d in shape)
    tensor_type = _i(1, 1) + _msg(2, dims)
    return _s(1, name) + _msg(2, _msg(1, tensor_type))


def model_proto(nodes, initializers, inputs, outputs, gname="test",
                opset=None) -> bytes:
    g = b"".join(_msg(1, n) for n in nodes)
    g += _s(2, gname)
    g += b"".join(_msg(5, t) for t in initializers)
    g += b"".join(_msg(11, v) for v in inputs)
    g += b"".join(_msg(12, v) for v in outputs)
    out = _i(1, 8) + _msg(7, g)
    if opset is not None:
        out += _msg(8, _s(1, "") + _i(2, opset))
    return out


def _graph(nodes, inits, in_shape, out_name="z", opset=None):
    return model_proto(nodes, inits, [value_info("x", in_shape)],
                       [value_info(out_name, ())], opset=opset)


def _both(data, x, output_node=None):
    """(JAX output, port output) of one proto on the same input."""
    jg, tg = jax_load_onnx(data), load_onnx(data)
    want = np.asarray(jg.apply(jg.init(), jnp.asarray(x),
                               output_node=output_node))
    got = tg.apply(tg.init(device="cpu"), torch.from_numpy(np.asarray(x)),
                   output_node=output_node)
    return want, got.numpy()


def _assert_same(data, x, output_node=None, tol=TOL):
    want, got = _both(data, x, output_node)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **tol)
    else:
        np.testing.assert_array_equal(got, want)
    return got


# -- fixtures ----------------------------------------------------------------


@pytest.fixture
def mlp_onnx(rng):
    """x(2,4) -> Gemm(w1 4x8,b1) -> Relu -> Gemm(w2 8x3,b2)."""
    w1 = rng.normal(size=(4, 8)).astype(np.float32)
    b1 = rng.normal(size=(8,)).astype(np.float32)
    w2 = rng.normal(size=(8, 3)).astype(np.float32)
    b2 = rng.normal(size=(3,)).astype(np.float32)
    data = model_proto(
        nodes=[
            node("Gemm", ["x", "w1", "b1"], ["h"], name="fc1"),
            node("Relu", ["h"], ["hr"], name="relu1"),
            node("Gemm", ["hr", "w2", "b2"], ["z"], name="z"),
        ],
        initializers=[
            tensor_proto("w1", w1), tensor_proto("b1", b1),
            tensor_proto("w2", w2), tensor_proto("b2", b2),
        ],
        inputs=[value_info("x", (2, 4))],
        outputs=[value_info("z", (2, 3))],
    )
    return data, (w1, b1, w2, b2)


# -- the graph protocol ------------------------------------------------------


def test_mlp_roundtrip(mlp_onnx, rng):
    data, (w1, b1, w2, b2) = mlp_onnx
    graph = load_onnx(data)
    assert graph.layer_names == jax_load_onnx(data).layer_names \
        == ["fc1", "relu1", "z"]
    assert graph.input_shape == (4,)
    x = rng.normal(size=(2, 4)).astype(np.float32)
    got = _assert_same(data, x)
    np.testing.assert_allclose(got, np.maximum(x @ w1 + b1, 0) @ w2 + b2,
                               **TOL)
    assert graph.param_count() == graph.param_count(
        graph.init(device="cpu")) == 4 * 8 + 8 + 8 * 3 + 3


def test_cut_at_node(mlp_onnx, rng):
    data, (w1, b1, *_) = mlp_onnx
    x = rng.normal(size=(2, 4)).astype(np.float32)
    hidden = _assert_same(data, x, output_node="relu1")
    np.testing.assert_allclose(hidden, np.maximum(x @ w1 + b1, 0), **TOL)
    assert np.array_equal(_both(data, x, output_node=1)[1], hidden)
    head = load_onnx(data).cut("fc1")
    assert head.layer_names == ["fc1"]
    out = head.apply(head.init(device="cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, x @ w1 + b1, **TOL)
    with pytest.raises(FriendlyError, match="no node"):
        load_onnx(data).cut("nope")


def test_unsupported_op_message():
    data = _graph([node("TotallyMadeUp", ["x"], ["z"], name="z")], [],
                  (1, 2))
    graph = load_onnx(data)
    with pytest.raises(FriendlyError, match="TotallyMadeUp"):
        graph.apply(graph.init(device="cpu"), torch.zeros(1, 2))


def test_registry_builds_onnx_and_names_it(mlp_onnx, tmp_path):
    data, _ = mlp_onnx
    path = tmp_path / "m.onnx"
    path.write_bytes(data)
    g = build_model("onnx", path=str(path))
    assert isinstance(g, OnnxGraph) and g.layer_names[-1] == "z"
    with pytest.raises(FriendlyError, match="path"):
        build_model("onnx")
    with pytest.raises(FriendlyError, match="onnx"):
        build_model("definitely_not_a_model")


def test_tpu_model_runs_onnx_graph(mlp_onnx, tmp_path, rng):
    """TPUModel.from_graph takes an imported graph unchanged, with the
    port's variables or the JAX importer's (bridged on first use)."""
    from mmlspark_tpu_torch.data.dataset import Dataset
    from mmlspark_tpu_torch.stages.dnn_model import TPUModel

    data, (w1, b1, w2, b2) = mlp_onnx
    path = tmp_path / "mlp.onnx"
    path.write_bytes(data)
    graph = load_onnx(str(path))
    x = rng.normal(size=(6, 4)).astype(np.float32)
    expect = np.maximum(x @ w1 + b1, 0) @ w2 + b2
    for weights in (graph.init(device="cpu"), jax_load_onnx(data).init()):
        model = TPUModel.from_graph(
            graph, weights, model_name="onnx", input_col="feats",
            batch_size=4, device="cpu",
        )
        model.set(model_config={"path": str(path)})
        out = model.transform(Dataset({"feats": x}))
        np.testing.assert_allclose(np.stack(out["scores"]), expect,
                                   atol=1e-4, rtol=1e-4)
    assert model.program_count >= 1


# -- convolutions and pools (NCHW) ----------------------------------------------


def _conv_bn_pool(rng, conv_attrs, pool_op, pool_attrs, in_ch=2, out_ch=4,
                  k=3, groups=1, hw=9):
    w = rng.normal(size=(out_ch, in_ch // groups, k, k)).astype(
        np.float32) * 0.5
    b = rng.normal(size=(out_ch,)).astype(np.float32)
    scale = np.abs(rng.normal(size=(out_ch,))).astype(np.float32)
    bias = rng.normal(size=(out_ch,)).astype(np.float32)
    mean = rng.normal(size=(out_ch,)).astype(np.float32) * 0.1
    var = np.abs(rng.normal(size=(out_ch,))).astype(np.float32) + 0.5
    data = _graph(
        [
            node("Conv", ["x", "w", "b"], ["c"], name="conv1",
                 attrs=[attr("group", i=groups), *conv_attrs]),
            node("BatchNormalization",
                 ["c", "scale", "bias", "mean", "var"], ["bn"],
                 name="bn1", attrs=[attr("epsilon", f=1e-5)]),
            node("Relu", ["bn"], ["r"], name="relu1"),
            node(pool_op, ["r"], ["z"], name="z", attrs=pool_attrs),
        ],
        [tensor_proto("w", w), tensor_proto("b", b),
         tensor_proto("scale", scale), tensor_proto("bias", bias),
         tensor_proto("mean", mean), tensor_proto("var", var)],
        (2, in_ch, hw, hw),
    )
    return data, rng.normal(size=(2, in_ch, hw, hw)).astype(np.float32)


CONV_CASES = {
    "pads": [attr("pads", ints=[1, 1, 1, 1])],
    "asymmetric_pads_stride2": [attr("pads", ints=[0, 1, 2, 1]),
                                attr("strides", ints=[2, 2])],
    "same_upper_stride2": [attr("auto_pad", s="SAME_UPPER"),
                           attr("strides", ints=[2, 2])],
    "same_lower_stride2": [attr("auto_pad", s="SAME_LOWER"),
                           attr("strides", ints=[2, 2])],
    "dilated": [attr("dilations", ints=[2, 2]),
                attr("pads", ints=[2, 2, 2, 2])],
}
POOL_CASES = {
    "max": ("MaxPool", [attr("kernel_shape", ints=[2, 2]),
                        attr("strides", ints=[2, 2])]),
    "max_asymmetric_pads": ("MaxPool", [attr("kernel_shape", ints=[3, 3]),
                                        attr("strides", ints=[2, 2]),
                                        attr("pads", ints=[1, 0, 0, 1])]),
    "avg_excluding_pads": ("AveragePool",
                           [attr("kernel_shape", ints=[3, 3]),
                            attr("strides", ints=[2, 2]),
                            attr("pads", ints=[1, 1, 1, 1])]),
    "avg_including_pads": ("AveragePool",
                           [attr("kernel_shape", ints=[3, 3]),
                            attr("pads", ints=[1, 1, 1, 1]),
                            attr("count_include_pad", i=1)]),
    "global_avg": ("GlobalAveragePool", []),
}


@pytest.mark.parametrize("conv", sorted(CONV_CASES))
def test_conv_bn_relu_matches_jax(rng, conv):
    data, x = _conv_bn_pool(rng, CONV_CASES[conv], "Identity", [])
    _assert_same(data, x)


@pytest.mark.parametrize("pool", sorted(POOL_CASES))
def test_pools_match_jax(rng, pool):
    op, attrs = POOL_CASES[pool]
    data, x = _conv_bn_pool(rng, CONV_CASES["pads"], op, attrs)
    _assert_same(data, x)


def test_grouped_and_1d_convolutions(rng):
    data, x = _conv_bn_pool(rng, CONV_CASES["pads"], "Identity", [],
                            in_ch=4, out_ch=4, groups=4)
    _assert_same(data, x)
    w = rng.normal(size=(3, 2, 3)).astype(np.float32)
    data = _graph(
        [node("Conv", ["x", "w"], ["c"], name="c",
              attrs=[attr("pads", ints=[2, 0])]),
         node("MaxPool", ["c"], ["z"], name="z",
              attrs=[attr("kernel_shape", ints=[2]),
                     attr("pads", ints=[0, 1])])],
        [tensor_proto("w", w)], (2, 2, 7))
    _assert_same(data, rng.normal(size=(2, 2, 7)).astype(np.float32))


def test_pool_ceil_mode_is_refused_by_both(rng):
    data, x = _conv_bn_pool(rng, CONV_CASES["pads"], "MaxPool",
                            [attr("kernel_shape", ints=[2, 2]),
                             attr("ceil_mode", i=1)])
    g = load_onnx(data)
    with pytest.raises(FriendlyError, match="ceil_mode"):
        g.apply(g.init(device="cpu"), torch.from_numpy(x))
    jg = jax_load_onnx(data)
    with pytest.raises(Exception, match="ceil_mode"):
        jg.apply(jg.init(), jnp.asarray(x))


# -- shapes, folding, indexing ---------------------------------------------------


def test_reshape_constant_and_softmax(rng):
    data = _graph(
        [node("Reshape", ["x", "shape"], ["r"], name="reshape"),
         node("Softmax", ["r"], ["z"], name="z",
              attrs=[attr("axis", i=-1)])],
        [tensor_proto("shape", np.array([2, 6], np.int64))], (2, 2, 3))
    x = rng.normal(size=(2, 2, 3)).astype(np.float32)
    got = _assert_same(data, x)
    flat = x.reshape(2, 6)
    e = np.exp(flat - flat.max(-1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(-1, keepdims=True), **TOL)


def test_shape_chain_constant_folds(rng):
    """torch's dynamic-reshape idiom Shape -> Gather -> Unsqueeze ->
    Concat -> Reshape folds to host constants."""
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    data = _graph(
        [
            node("Shape", ["x"], ["sh"], name="sh"),
            node("Gather", ["sh", "idx0"], ["b"], name="b",
                 attrs=[attr("axis", i=0)]),
            node("Unsqueeze", ["b", "ax0"], ["bu"], name="bu"),
            node("Concat", ["bu", "minus1"], ["tgt"], name="tgt",
                 attrs=[attr("axis", i=0)]),
            node("Reshape", ["x", "tgt"], ["flat"], name="flat"),
            node("Expand", ["one_row", "row_shape"], ["ones2"],
                 name="ones2"),
            node("Mul", ["flat", "ones2"], ["z"], name="z"),
        ],
        [
            tensor_proto("idx0", np.array(0, np.int64)),
            tensor_proto("ax0", np.array([0], np.int64)),
            tensor_proto("minus1", np.array([-1], np.int64)),
            tensor_proto("one_row", np.ones((1, 1), np.float32)),
            tensor_proto("row_shape", np.array([1, 12], np.int64)),
        ],
        (2, 3, 4),
    )
    got = _assert_same(data, x)
    np.testing.assert_allclose(got, x.reshape(2, 12), atol=1e-6)


def test_range_constant_of_shape_where_cast_clip_gather(rng):
    """Range and ConstantOfShape fold to host values; Gather wraps
    negative indices; Where, Cast and a one-sided Clip run as in JAX."""
    x = rng.normal(size=(3, 5)).astype(np.float32)
    fill = np.array([2.0], np.float32)
    data = _graph(
        [
            node("Range", ["r0", "r1", "r2"], ["idx"], name="idx"),
            node("Gather", ["x", "idx"], ["g"], name="g",
                 attrs=[attr("axis", i=1)]),
            node("Gather", ["x", "neg"], ["gn"], name="gn",
                 attrs=[attr("axis", i=1)]),
            node("ConstantOfShape", ["cs"], ["twos"], name="twos",
                 attrs=[attr("value", t=tensor_proto("", fill))]),
            node("Mul", ["g", "twos"], ["g2"], name="g2"),
            node("Cast", ["g2"], ["gi"], name="gi", attrs=[attr("to", i=6)]),
            node("Cast", ["gi"], ["gf"], name="gf", attrs=[attr("to", i=1)]),
            node("Clip", ["gf", "lo"], ["gc"], name="gc"),
            node("Where", ["mask", "gc", "gn"], ["z"], name="z"),
        ],
        [
            tensor_proto("r0", np.array(0, np.int64)),
            tensor_proto("r1", np.array(5, np.int64)),
            tensor_proto("r2", np.array(2, np.int64)),
            tensor_proto("neg", np.array([-1, -2, 0], np.int64)),
            tensor_proto("cs", np.array([3, 3], np.int64)),
            tensor_proto("lo", np.array(-1.0, np.float32)),
            tensor_proto("mask", np.array([[1, 0, 1]], np.int32)),
        ],
        (3, 5),
    )
    _assert_same(data, x)


def test_slice_op_steps_and_sentinels(rng):
    x = rng.normal(size=(4, 6)).astype(np.float32)
    for starts, ends, axes, steps, want in (
        ([1], [5], [1], [2], x[:, 1:5:2]),
        ([-1], [-7], [1], [-2], x[:, -1:-7:-2]),
        ([0, 2**62], [2**62, 0], [0, 1], [1, -1], x[0:, 2**62:0:-1]),
        ([3], [1], [0], [1], x[3:1]),
    ):
        data = _graph(
            [node("Slice", ["x", "st", "en", "ax", "sp"], ["z"], name="z")],
            [tensor_proto("st", np.array(starts, np.int64)),
             tensor_proto("en", np.array(ends, np.int64)),
             tensor_proto("ax", np.array(axes, np.int64)),
             tensor_proto("sp", np.array(steps, np.int64))],
            (4, 6))
        got = _assert_same(data, x)
        np.testing.assert_array_equal(got, want)


def test_transformer_support_ops(rng):
    """Split, Cast, Neg, Where, ReduceSum and fused LayerNormalization
    (opset 17), as external transformer exports use them."""
    x = rng.normal(size=(2, 6)).astype(np.float32)
    scale = rng.normal(size=(6,)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    data = _graph(
        [
            node("LayerNormalization", ["x", "scale", "bias"], ["ln"],
                 name="ln", attrs=[attr("axis", i=-1)]),
            node("Split", ["ln"], ["a", "b"], name="split",
                 attrs=[attr("axis", i=1)]),
            node("Neg", ["a"], ["na"], name="na"),
            node("Cast", ["cond_i"], ["cond"], name="cond",
                 attrs=[attr("to", i=9)]),
            node("Where", ["cond", "na", "b"], ["w"], name="w"),
            node("Cast", ["w"], ["wc"], name="wc", attrs=[attr("to", i=6)]),
            node("ReduceSum", ["wc"], ["z"], name="z",
                 attrs=[attr("axes", ints=[1])]),
        ],
        [tensor_proto("scale", scale), tensor_proto("bias", bias),
         tensor_proto("cond_i", np.array([[1, 0, 1]], np.int32))],
        (2, 6),
    )
    got = _assert_same(data, x)
    assert got.dtype == np.int32


def test_split_uneven_opset_gate(rng):
    x = rng.normal(size=(2, 7)).astype(np.float32)

    def build(opset):
        return _graph([node("Split", ["x"], ["a", "b"], name="split",
                            attrs=[attr("axis", i=1)])], [], (2, 7),
                      out_name="a", opset=opset)

    for opset in (18, None):
        got = _assert_same(build(opset), x)
        np.testing.assert_allclose(got, x[:, :4])
    g13 = load_onnx(build(13))
    assert g13.opset == 13
    with pytest.raises(FriendlyError, match="not divisible"):
        g13.apply(g13.init(device="cpu"), torch.from_numpy(x))


@pytest.mark.parametrize("op,fmod", [("Div", None), ("Mod", 0),
                                     ("Mod", 1)])
def test_integer_div_and_mod_semantics(op, fmod):
    """Integer Div truncates toward zero; Mod follows the divisor's sign
    (``fmod=1``: the dividend's) — on the data path and folded."""
    a = np.array([[-7, 7, -5, 5, 9, -9]], np.int32)
    b = np.array([[2, -2, 3, -3, 4, 4]], np.int32)
    attrs = [attr("fmod", i=fmod)] if fmod is not None else []
    runtime = _graph([node(op, ["x", "b"], ["z"], name="z", attrs=attrs)],
                     [tensor_proto("b", b)], (1, 6))
    got = _assert_same(runtime, a)
    ref = {"Div": np.trunc(a / b), "Mod": np.fmod(a, b) if fmod
           else np.mod(a, b)}[op].astype(np.int32)
    np.testing.assert_array_equal(got, ref)
    # the same arithmetic on constants folds on the host and comes out
    # as data through an Add with the input
    folded = _graph(
        [node(op, ["ca", "b"], ["q"], name="q", attrs=attrs),
         node("Add", ["x", "q"], ["z"], name="z")],
        [tensor_proto("ca", a.astype(np.int64)),
         tensor_proto("b", b.astype(np.int64))], (1, 6))
    got = _assert_same(folded, np.zeros((1, 6), np.int64))
    np.testing.assert_array_equal(got, ref)
    # the file's int64 stays int64 in the port; JAX (x64 off) computes
    # it in 32 bits — equal values, other dtypes (ROADMAP.md Queue 3)
    want, _ = _both(folded, np.zeros((1, 6), np.int64))
    assert (got.dtype, want.dtype) == (np.int64, np.int32)


def test_softmax_follows_the_opset():
    """From opset 13 (or with no opset) Softmax is per-axis, as in the
    JAX importer; before 13 its default axis is 1 and it normalizes over
    the input coerced to 2-D — the spec's reading, where the JAX importer
    stays per-axis at -1 (ROADMAP.md Queue 3)."""
    x = np.random.default_rng(3).normal(size=(2, 3, 4)).astype(np.float32)
    for opset in (13, None):
        _assert_same(_graph([node("Softmax", ["x"], ["z"], name="z")], [],
                            (2, 3, 4), opset=opset), x)
    old = _graph([node("Softmax", ["x"], ["z"], name="z")], [], (2, 3, 4),
                 opset=11)
    want_jax, got = _both(old, x)
    flat = x.reshape(2, 12)
    e = np.exp(flat - flat.max(-1, keepdims=True))
    np.testing.assert_allclose(
        got, (e / e.sum(-1, keepdims=True)).reshape(x.shape), **TOL)
    e = np.exp(x - x.max(-1, keepdims=True))
    np.testing.assert_allclose(want_jax, e / e.sum(-1, keepdims=True),
                               **TOL)


def test_constant_nodes_and_unconsumed_layernorm_outputs(rng):
    """A Constant tensor feeds a Reshape target; LayerNormalization's
    declared but unread Mean/InvStdDev outputs are never bound, and a
    graph that reads one is refused by both importers."""
    x = rng.normal(size=(2, 6)).astype(np.float32)
    scale = np.ones(6, np.float32)
    shape_t = tensor_proto("", np.array([3, 4], np.int64))
    ok = _graph(
        [node("Constant", [], ["shp"], name="shp",
              attrs=[attr("value", t=shape_t)]),
         node("LayerNormalization", ["x", "scale"], ["ln", "mu", "isd"],
              name="ln"),
         node("Reshape", ["ln", "shp"], ["z"], name="z")],
        [tensor_proto("scale", scale)], (2, 6))
    _assert_same(ok, x)
    bad = _graph(
        [node("LayerNormalization", ["x", "scale"], ["ln", "mu"],
              name="ln"),
         node("Add", ["ln", "mu"], ["z"], name="z")],
        [tensor_proto("scale", scale)], (2, 6))
    g = load_onnx(bad)
    with pytest.raises(FriendlyError, match="optional outputs"):
        g.apply(g.init(device="cpu"), torch.from_numpy(x))


# -- recurrent ops ---------------------------------------------------------------


def _torch_lstm_to_onnx_weights(m, reverse_too=False):
    """torch's gate order is i,f,g,o; ONNX's is i,o,f,c."""

    def reorder(wmat):
        i, f, g, o = torch.chunk(wmat, 4, dim=0)
        return torch.cat([i, o, f, g], dim=0).detach().numpy()

    suffixes = ["", "_reverse"] if reverse_too else [""]
    w = np.stack([reorder(getattr(m, f"weight_ih_l0{s}")) for s in suffixes])
    r = np.stack([reorder(getattr(m, f"weight_hh_l0{s}")) for s in suffixes])
    b = np.stack([
        np.concatenate([reorder(getattr(m, f"bias_ih_l0{s}")),
                        reorder(getattr(m, f"bias_hh_l0{s}"))])
        for s in suffixes
    ])
    return w.astype(np.float32), r.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("direction", ["forward", "bidirectional",
                                       "reverse"])
def test_lstm_matches_torch_and_jax(rng, direction):
    s_len, batch, d_in, hidden = 9, 3, 5, 7
    torch.manual_seed(0)
    m = torch.nn.LSTM(d_in, hidden, bidirectional=direction != "forward")
    x = rng.normal(size=(s_len, batch, d_in)).astype(np.float32)
    with torch.no_grad():
        want, _ = m(torch.from_numpy(x))
    w, r, b = _torch_lstm_to_onnx_weights(m, direction != "forward")
    if direction == "reverse":  # only the reverse weights
        w, r, b = w[1:], r[1:], b[1:]
        want = want[:, :, hidden:]
    dirs = w.shape[0]
    data = model_proto(
        [node("LSTM", ["x", "W", "R", "B"], ["y", "yh", "yc"], name="lstm",
              attrs=[attr("hidden_size", i=hidden),
                     attr("direction", s=direction)])],
        [tensor_proto("W", w), tensor_proto("R", r), tensor_proto("B", b)],
        [value_info("x", (s_len, batch, d_in))],
        [value_info("y", (s_len, dirs, batch, hidden))],
    )
    y = _assert_same(data, x, tol=dict(atol=2e-5, rtol=2e-5))
    got = np.moveaxis(y, 1, 2).reshape(s_len, batch, dirs * hidden)
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lbr", [0, 1])
def test_gru_matches_jax(rng, lbr):
    s_len, batch, d_in, hidden = 8, 2, 4, 6
    w = rng.normal(size=(2, 3 * hidden, d_in)).astype(np.float32) * 0.5
    r = rng.normal(size=(2, 3 * hidden, hidden)).astype(np.float32) * 0.5
    b = rng.normal(size=(2, 6 * hidden)).astype(np.float32) * 0.5
    data = model_proto(
        [node("GRU", ["x", "W", "R", "B"], ["y", "yh"], name="gru",
              attrs=[attr("hidden_size", i=hidden),
                     attr("linear_before_reset", i=lbr),
                     attr("direction", s="bidirectional")])],
        [tensor_proto("W", w), tensor_proto("R", r), tensor_proto("B", b)],
        [value_info("x", (s_len, batch, d_in))],
        [value_info("y", (s_len, 2, batch, hidden))],
    )
    _assert_same(data, rng.normal(size=(s_len, batch, d_in)).astype(
        np.float32), tol=dict(atol=2e-5, rtol=2e-5))


def test_gru_matches_torch(rng):
    s_len, batch, d_in, hidden = 8, 2, 4, 6
    torch.manual_seed(1)
    m = torch.nn.GRU(d_in, hidden)
    x = rng.normal(size=(s_len, batch, d_in)).astype(np.float32)
    with torch.no_grad():
        want, _ = m(torch.from_numpy(x))

    def reorder(wmat):  # torch r,z,n -> ONNX z,r,h
        r_, z, n = torch.chunk(wmat, 3, dim=0)
        return torch.cat([z, r_, n], dim=0).detach().numpy()

    w = np.stack([reorder(m.weight_ih_l0)]).astype(np.float32)
    r = np.stack([reorder(m.weight_hh_l0)]).astype(np.float32)
    b = np.stack([np.concatenate([reorder(m.bias_ih_l0),
                                  reorder(m.bias_hh_l0)])]).astype(np.float32)
    data = model_proto(
        [node("GRU", ["x", "W", "R", "B"], ["y", "yh"], name="gru",
              attrs=[attr("hidden_size", i=hidden),
                     attr("linear_before_reset", i=1)])],
        [tensor_proto("W", w), tensor_proto("R", r), tensor_proto("B", b)],
        [value_info("x", (s_len, batch, d_in))],
        [value_info("y", (s_len, 1, batch, hidden))],
    )
    y = _assert_same(data, x, tol=dict(atol=2e-5, rtol=2e-5))[:, 0]
    np.testing.assert_allclose(y, want.numpy(), rtol=2e-5, atol=2e-5)


def test_bilstm_tagger_roundtrip_and_cut(rng):
    s_len, batch, d_in, hidden, n_tags = 12, 2, 8, 16, 5
    w = rng.normal(size=(2, 4 * hidden, d_in)).astype(np.float32) * 0.3
    r = rng.normal(size=(2, 4 * hidden, hidden)).astype(np.float32) * 0.3
    proj = rng.normal(size=(2 * hidden, n_tags)).astype(np.float32) * 0.3
    data = model_proto(
        [
            node("LSTM", ["x", "W", "R"], ["y", "yh", "yc"], name="bilstm",
                 attrs=[attr("hidden_size", i=hidden),
                        attr("direction", s="bidirectional")]),
            node("Transpose", ["y"], ["yt"], name="t",
                 attrs=[attr("perm", ints=[0, 2, 1, 3])]),
            node("Reshape", ["yt", "shape"], ["flat"], name="merge"),
            node("MatMul", ["flat", "proj"], ["logits"], name="tags"),
        ],
        [tensor_proto("W", w), tensor_proto("R", r),
         tensor_proto("proj", proj),
         tensor_proto("shape", np.array([s_len, batch, 2 * hidden],
                                        np.int64))],
        [value_info("x", (s_len, batch, d_in))],
        [value_info("logits", (s_len, batch, n_tags))],
    )
    x = rng.normal(size=(s_len, batch, d_in)).astype(np.float32)
    out = _assert_same(data, x, tol=dict(atol=2e-5, rtol=2e-5))
    assert out.shape == (s_len, batch, n_tags)
    hidden_states = _assert_same(data, x, output_node="bilstm",
                                 tol=dict(atol=2e-5, rtol=2e-5))
    assert hidden_states.shape == (s_len, 2, batch, hidden)


@pytest.mark.parametrize("case", ["dirs", "activations", "clip",
                                  "sequence_lens"])
def test_rnn_refusals(rng, case):
    w = rng.normal(size=(2 if case == "dirs" else 1, 16, 3)).astype(
        np.float32)
    r = rng.normal(size=(w.shape[0], 16, 4)).astype(np.float32)
    attrs = [attr("hidden_size", i=4)]
    inputs = ["x", "W", "R"]
    inits = [tensor_proto("W", w), tensor_proto("R", r)]
    match = {"dirs": "weight dirs", "activations": "activations",
             "clip": "clip", "sequence_lens": "sequence_lens"}[case]
    if case == "activations":
        attrs.append(attr("activations", strings=["Relu", "Tanh", "Tanh"]))
    if case == "clip":
        attrs.append(attr("clip", f=3.0))
    if case == "sequence_lens":
        inputs += ["", "lens"]
        inits.append(tensor_proto("lens", np.array([5], np.int32)))
    g = load_onnx(model_proto(
        [node("LSTM", inputs, ["y"], name="bad", attrs=attrs)], inits,
        [value_info("x", (5, 1, 3))], [value_info("y", ())]))
    with pytest.raises(FriendlyError, match=match):
        g.apply(g.init(device="cpu"), torch.zeros(5, 1, 3))


# -- golden files from PyTorch's exporter -------------------------------------------


def _export_onnx(model, args, path, opset=13):
    """``torch.onnx.export`` through the TorchScript exporter; with the
    ``onnx`` package absent its one no-op onnxscript post-pass is
    stubbed (the bytes come from torch's C++ exporter either way)."""
    kw = dict(dynamo=False, opset_version=opset, do_constant_folding=False,
              input_names=["input"], output_names=["output"])
    try:
        torch.onnx.export(model, args, str(path), **kw)
        return
    except Exception as e:  # noqa: BLE001 — retry only the known gap
        if "onnx is not installed" not in str(e):
            raise
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda b, _ops: b
    try:
        torch.onnx.export(model, args, str(path), **kw)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


class _BasicBlock(torch.nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.down is None else self.down(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + idt)


class _ResNet18(torch.nn.Module):
    """The standard ResNet-18 layer plan (torchvision's)."""

    def __init__(self, num_classes=1000):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        blocks, cin = [], 64
        for cout, stride in [(64, 1), (64, 1), (128, 2), (128, 1),
                             (256, 2), (256, 1), (512, 2), (512, 1)]:
            blocks.append(_BasicBlock(cin, cout, stride))
            cin = cout
        self.layers = nn.Sequential(*blocks)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.avgpool(self.layers(x)).flatten(1)
        return self.fc(x)


@pytest.fixture(scope="module")
def rn18(tmp_path_factory):
    """An exported ResNet-18 (BatchNormalization kept as nodes, its
    statistics perturbed so the BN math is exercised) at 112x112."""
    torch.manual_seed(0)
    model = _ResNet18().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.7, 1.3)
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0, 0.1)
    x = torch.randn(2, 3, 112, 112)
    with torch.no_grad():
        y = model(x)
    path = tmp_path_factory.mktemp("onnx_golden") / "rn18.onnx"
    _export_onnx(model, (x,), path)
    return model, path.read_bytes(), x, y


def test_resnet18_matches_torch_and_jax(rn18):
    model, data, x, y_ref = rn18
    graph = load_onnx(data)
    ops = {n.op for n in graph.nodes}
    assert {"Conv", "BatchNormalization", "MaxPool", "GlobalAveragePool",
            "Flatten", "Gemm", "Add"} <= ops
    want, got = _both(data, x.numpy())
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, y_ref.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_resnet18_cut_matches_torch_hook(rn18):
    """cut() at a real mid-graph node equals torch's activation at that
    module — the ImageFeaturizer headless-net contract."""
    model, data, x, _ = rn18
    graph = load_onnx(data)
    target = [n for n in graph.layer_names if n.endswith("relu_1/Relu")][-1]
    headless = graph.cut(target)
    assert headless.layer_names[-1] == target
    captured = {}
    hook = model.layers[7].register_forward_hook(
        lambda _m, _i, out: captured.__setitem__("act", out.detach()))
    with torch.no_grad():
        model(x)
    hook.remove()
    feat = headless.apply(graph.init(device="cpu"), x).numpy()
    np.testing.assert_allclose(feat, captured["act"].numpy(), atol=1e-4,
                               rtol=1e-4)


class _MiniEncoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.layer = torch.nn.TransformerEncoderLayer(
            d_model=32, nhead=4, dim_feedforward=64, batch_first=True,
            dropout=0.0)

    def forward(self, x):
        return self.layer(x)


class _MobileBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.net = nn.Sequential(
            nn.Conv2d(3, 16, 3, 2, 1, bias=False), nn.BatchNorm2d(16),
            nn.ReLU(),
            nn.Conv2d(16, 16, 3, 1, 1, groups=16, bias=False),
            nn.BatchNorm2d(16), nn.ReLU(),
            nn.Conv2d(16, 32, 1, bias=False), nn.BatchNorm2d(32),
            nn.ReLU6(), nn.AdaptiveAvgPool2d(1), nn.Flatten(),
            nn.Linear(32, 10))

    def forward(self, x):
        return self.net(x)


class _BiLSTMTagger(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(23, 12)
        self.lstm = torch.nn.LSTM(12, 8, bidirectional=True)
        self.head = torch.nn.Linear(16, 5)

    def forward(self, ids):
        h, _ = self.lstm(self.emb(ids))
        return self.head(h)


@pytest.mark.parametrize("name", ["encoder_opset17", "depthwise",
                                  "bilstm"])
def test_golden_exports_match_torch_and_jax(tmp_path, name):
    torch.manual_seed(1)
    if name == "encoder_opset17":
        model, x, opset = _MiniEncoder().eval(), torch.randn(2, 7, 32), 17
    elif name == "depthwise":
        model, x, opset = _MobileBlock().eval(), torch.randn(2, 3, 32, 32), 13
    else:
        model, x, opset = _BiLSTMTagger().eval(), torch.randint(0, 23, (9, 2)), 13
    with torch.no_grad():
        y = model(x)
    path = tmp_path / f"{name}.onnx"
    _export_onnx(model, (x,), path, opset=opset)
    data = path.read_bytes()
    feed = x.numpy().astype(np.int32) if name == "bilstm" else x.numpy()
    want, got = _both(data, feed)
    np.testing.assert_allclose(got, y.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
