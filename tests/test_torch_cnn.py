"""The port's ResNets and BiLSTM tagger against the JAX package's, through
the weight bridge: the same flax variables (batch statistics included),
the same seeded numpy inputs.

Tolerances:
- bf16 compute (the models' default, both sides): logits within 3e-2 of
  max |logit|. Both sides round each convolution's output to bf16 at the
  same places, but XLA and PyTorch's CPU convolutions sum in other
  orders, so a rounding boundary may flip; BatchNorm (f32) carries a
  flipped ulp on, and depth compounds it;
- f32 compute (every ``dtype`` set to float32 on both sides): outputs
  within 1e-4 of their max, the running statistics after one train-mode
  call within 1e-3 relative (to each statistic's largest magnitude) —
  the same f32 arithmetic summed in other orders;
- SAME padding, each stride-2 layer alone in f32: 1e-5 of the max;
- the BiLSTM (f32 LSTM, both directions): 1e-5;
- int8 weights: bit-equal to JAX's ``quantize_weights``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax import lax

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.ops.quantize import dequantize_weights as jax_dequantize
from mmlspark_tpu.ops.quantize import quantize_weights as jax_quantize
from mmlspark_tpu.ops.quantize import quantized_bytes as jax_quantized_bytes
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models import (
    build_model,
    init_variables,
    load_flax_variables,
    registered_models,
)
from mmlspark_tpu_torch.models.resnet import Conv, same_max_pool, same_pads
from mmlspark_tpu_torch.ops.quantize import (
    _Q8,
    _SCALE,
    dequantize_weights,
    quantize_weights,
    quantized_bytes,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF16_REL_TOL = 3e-2
F32_REL_TOL = 1e-4
STATS_REL_TOL = 1e-3
PAD_REL_TOL = 1e-5
LSTM_TOL = 1e-5
MODELS = {
    "resnet20": ("resnet20_cifar10", dict(width=8), (4, 32, 32, 3)),
    "resnet50": ("resnet50", dict(input_size=64), (2, 64, 64, 3)),
}


def _seeded_flax_variables(graph, sample, seed):
    """flax variables for ``graph`` with seeded values, shaped by
    ``jax.eval_shape`` of its ``init`` (no init runs): kernels and
    embeddings N(0, 1/fan_in), biases N(0, 0.1^2), BatchNorm scales and
    running variances U(0.5, 1.5), running means N(0, 0.1^2) — so eval
    mode normalises with statistics that are not the identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(graph.init, jax.random.PRNGKey(0), sample)

    def leaf(key: str, shape):
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        if key in ("bias", "mean"):
            return rng.normal(0, 0.1, shape)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return rng.normal(0, fan_in ** -0.5, shape)

    def walk(node, key: str = ""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return leaf(key, node.shape).astype(np.float32)

    return walk(dict(shapes))


@pytest.fixture(scope="module")
def nets():
    """{key: (jax graph, flax variables, port graph, port variables,
    input)} for both ResNets, from seeded flax variables."""
    out = {}
    for i, (key, (name, cfg, shape)) in enumerate(MODELS.items()):
        jg = jax_build_model(name, **cfg)
        x = np.random.default_rng(i).normal(size=shape).astype(np.float32)
        jv = _seeded_flax_variables(jg, jnp.asarray(x[:1]), seed=i)
        tg = build_model(name, **cfg)
        out[key] = (jg, jv, tg, load_flax_variables(tg, jv, device="cpu"), x)
    return out


def _f32(jg, tg):
    """Copies of both graphs computing in float32."""
    jf = dataclasses.replace(jg, blocks=[
        (n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype") else m)
        for n, m in jg.blocks])
    tf = tg.cut(tg.layer_names[-1])
    for _, mod in tf.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return jf, tf


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-12))


def _flax_leaf(tree, key: str):
    node = tree
    for part in key.split("."):
        node = node[part]
    return np.asarray(node)


@pytest.mark.parametrize("key", list(MODELS))
def test_eval_logits_match_jax(nets, key):
    """bf16 compute on both sides, the running statistics randomised."""
    jg, jv, tg, tv, x = nets[key]
    want = np.asarray(jg.apply(jv, jnp.asarray(x)))
    got = tg.apply(tv, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= BF16_REL_TOL


def test_train_mode_matches_jax_updated_statistics(nets):
    """One train-mode call of ResNet-20: the output and every updated
    running mean and variance against flax's mutated ``batch_stats`` —
    in f32 compute (the stated 1e-3 bound) and in bf16 (the output)."""
    jg, jv, tg, tv, x = nets["resnet20"]
    want, _ = jg.apply(jv, jnp.asarray(x), train=True)
    got, _ = tg.apply(tv, torch.from_numpy(x), train=True)
    assert _rel(got.detach(), want) <= BF16_REL_TOL
    jf, tf = _f32(jg, tg)
    want, jnew = jf.apply(jv, jnp.asarray(x), train=True)
    got, tnew = tf.apply(tv, torch.from_numpy(x), train=True)
    assert _rel(got.detach(), want) <= F32_REL_TOL
    n = 0
    for block, stats in tnew.items():
        for k in tf.stat_keys(block):
            new = stats[k]
            assert new is not tv[block][k] and not new.requires_grad
            ref = _flax_leaf(jnew[block]["batch_stats"], k)
            assert _rel(new, ref) <= STATS_REL_TOL, (block, k)
            assert not np.array_equal(ref, _flax_leaf(jv[block][
                "batch_stats"], k))  # they moved
            n += 1
    assert n == 2 * 21  # 19 conv layers + 2 projections, mean and var
    for block in tf.layer_names:  # parameters come back as they went in
        for k, t in tv[block].items():
            if k not in tf.stat_keys(block):
                assert tnew[block][k] is t


#: (kernel, size) of the stride-2 layers: the blocks' 3x3 and the
#: projections' 1x1 at the sizes the blocks see, odd and even, and
#: ResNet-50's 7x7 stem at 224 and at odd and even small sizes
STRIDE2_CASES = [(k, n) for k in (1, 3) for n in (7, 8, 15, 16, 33)] + [
    (7, n) for n in (15, 16, 64, 224)]


@pytest.mark.parametrize("kernel,size", STRIDE2_CASES)
def test_same_padding_stride2_conv_matches_flax(kernel, size):
    """Every stride-2 convolution of both ResNets at odd and even sizes,
    f32, against flax's SAME ``nn.Conv``; and the padding against XLA's
    own rule."""
    rng = np.random.default_rng(size * 10 + kernel)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 4, 6)).astype(np.float32)
    flax_conv = fnn.Conv(6, (kernel, kernel), (2, 2), padding="SAME",
                         use_bias=False, dtype=jnp.float32)
    want = np.asarray(flax_conv.apply({"params": {"kernel": w}}, x))
    conv = Conv(4, 6, (kernel, kernel), (2, 2))
    conv.weight = torch.nn.Parameter(torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    with torch.no_grad():
        got = conv(torch.from_numpy(x), torch.float32)
    assert got.shape == want.shape
    assert _rel(got, want) <= PAD_REL_TOL
    ((lo, hi),) = lax.padtype_to_pads((size,), (kernel,), (2,), "SAME")
    assert same_pads(size, kernel, 2) == (lo, hi)


@pytest.mark.parametrize("size", [15, 16, 112])
def test_same_padding_max_pool_matches_flax(size):
    """ResNet-50's 3x3 stride-2 SAME max pool pads with -inf, at odd and
    even sizes (112 is the stem's output at 224): all-negative inputs,
    where a zero pad would show. Exact."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
        np.float32) - 5.0
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    got = same_max_pool(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_odd_input_size_through_resnet20(nets):
    """A 33x33 input takes every stride-2 layer of ResNet-20 at an odd
    size (33 -> 17 -> 9), f32, against JAX."""
    jg, jv, tg, tv, _ = nets["resnet20"]
    jf, tf = _f32(jg, tg)
    x = np.random.default_rng(9).normal(size=(2, 33, 33, 3)).astype(
        np.float32)
    for node in ("stage2", "z"):
        want = np.asarray(jf.apply(jv, jnp.asarray(x), output_node=node))
        got = tf.apply(tv, torch.from_numpy(x), output_node=node)
        assert got.shape == want.shape
        assert _rel(got, want) <= F32_REL_TOL, node


def test_cut_and_output_node_pool_features(nets):
    """ResNet-50 cut at ``pool``: the 2048-d features, through
    ``output_node`` and through ``cut``, against JAX's; the cut graph owns
    its blocks."""
    jg, jv, tg, tv, x = nets["resnet50"]
    want = np.asarray(jg.apply(jv, jnp.asarray(x), output_node="pool"))
    got = tg.apply(tv, torch.from_numpy(x), output_node="pool")
    assert got.shape == (2, 2048)
    assert _rel(got, want) <= BF16_REL_TOL
    head = tg.cut("pool")
    assert head.layer_names == tg.layer_names[:-1]
    assert head.name == "resnet50@pool"
    torch.testing.assert_close(head.apply(tv, torch.from_numpy(x)), got,
                               rtol=0, atol=0)
    assert dict(head.blocks)["stem"] is not dict(tg.blocks)["stem"]
    assert tg.apply(tv, torch.from_numpy(x), output_node=-2).shape == \
        (2, 2048)
    with pytest.raises(FriendlyError, match="no node"):
        tg.apply(tv, torch.from_numpy(x), output_node="nope")
    assert tg.param_count(tv) == jg.param_count(jv)


def test_registry_and_seeded_init():
    assert {"resnet20_cifar10", "resnet50", "bilstm_tagger", "mlp",
            "linear", "transformer_lm"} <= set(registered_models())
    g = build_model("resnet20_cifar10", width=8)
    a, b = (init_variables(g, 3, device="cpu") for _ in range(2))
    for block in a:
        for k in a[block]:
            assert torch.equal(a[block][k], b[block][k])
    bn = "ResBlock_0.ConvBN_0.BatchNorm_0"
    assert torch.equal(a["stage1"][f"{bn}.var"], torch.ones(8))
    assert not a["stage1"][f"{bn}.mean"].any()
    assert g.stat_keys("stage1") >= {f"{bn}.mean", f"{bn}.var"}
    assert not g.stat_keys("z")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    assert torch.isfinite(g.apply(a, x)).all()


# -- the BiLSTM tagger ---------------------------------------------------------


@pytest.fixture(scope="module")
def tagger():
    cfg = dict(vocab_size=50, embed_dim=6, hidden=5, num_tags=3)
    jg = jax_build_model("bilstm_tagger", **cfg)
    ids = np.random.default_rng(4).integers(0, 50, size=(3, 9)).astype(
        np.int32)
    jv = _seeded_flax_variables(jg, jnp.asarray(ids[:1]), seed=4)
    tg = build_model("bilstm_tagger", **cfg)
    return jg, jv, tg, load_flax_variables(tg, jv, device="cpu"), ids


def test_bilstm_tagger_matches_jax(tagger):
    """Both directions' f32 outputs and the logits within 1e-5 (the logits
    in f32 compute; in the default bf16 Dense within one bf16 step of
    their largest magnitude)."""
    jg, jv, tg, tv, ids = tagger
    want = np.asarray(jg.apply(jv, jnp.asarray(ids), output_node="bilstm"))
    got = tg.apply(tv, torch.from_numpy(ids), output_node="bilstm")
    assert got.shape == (3, 9, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LSTM_TOL)
    want = np.asarray(jg.apply(jv, jnp.asarray(ids)))
    got = tg.apply(tv, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.abs(want).max() * 2.0 ** -7)
    jg.blocks[-1] = (jg.blocks[-1][0], jg.blocks[-1][1].clone(
        dtype=jnp.float32))
    dict(tg.blocks)["z"].dtype = torch.float32
    try:
        want = np.asarray(jg.apply(jv, jnp.asarray(ids)))
        got = tg.apply(tv, torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=LSTM_TOL)
    finally:
        dict(tg.blocks)["z"].dtype = torch.bfloat16


# -- conv int8 weights -------------------------------------------------------------


def test_conv_int8_matches_jax_quantize(nets):
    """Per-output-channel int8 of ResNet-20's 4-D conv weights (and every
    other quantized leaf): the bytes and the dequantized weights
    bit-equal to JAX's ``quantize_weights``; JAX-quantized flax variables
    cross the bridge to the same tensors."""
    jg, jv, tg, tv, x = nets["resnet20"]
    for min_size in (0, 4096):
        jq = jax_quantize(jv, min_size=min_size)
        tq = quantize_weights(tg, tv, min_size=min_size)
        assert quantized_bytes(tq) == jax_quantized_bytes(jq)
        bridged = load_flax_variables(tg, jq, device="cpu")
        jdq = jax.device_get(jax_dequantize(jq, dtype=jnp.float32))
        tdq = dequantize_weights(tq, dtype=torch.float32)
        convs = 0
        want_convs = sum(t.ndim == 4 and t.numel() >= min_size
                         for leaves in tv.values() for t in leaves.values())
        for block, leaves in tq.items():
            for k, leaf in leaves.items():
                if not isinstance(leaf, dict):
                    continue
                other = bridged[block][k]
                assert torch.equal(leaf[_Q8], other[_Q8]), (block, k)
                assert torch.equal(leaf[_SCALE], other[_SCALE]), (block, k)
                if leaf[_Q8].ndim == 4:
                    convs += 1
                    assert leaf[_SCALE].shape == (leaf[_Q8].shape[0], 1, 1, 1)
                    want = _flax_leaf(jdq[block]["params"],
                                      k.replace(".weight", ".kernel"))
                    np.testing.assert_array_equal(
                        tdq[block][k].numpy(), want.transpose(3, 2, 0, 1))
        assert convs == want_convs and convs >= 6
    stage = quantize_weights(tg, tv)  # the TPUModel default threshold
    got = tg.apply(dequantize_weights(stage), torch.from_numpy(x))
    want = np.asarray(jg.apply(jax_dequantize(jax_quantize(jv)),
                               jnp.asarray(x)))
    assert _rel(got, want) <= BF16_REL_TOL
