"""The port's ONNX exporter (``mmlspark_tpu_torch/models/onnx_export.py``)
against the JAX package's, mirroring ``tests/test_onnx_export.py``.

Each family is built in both frameworks, the JAX package's flax
variables made from a seed (shaped by ``jax.eval_shape`` of ``init``,
which is far cheaper than running it) and bridged into the port
(``load_flax_variables``). Both exporters write the same graph from the
same weights: the files must be byte-identical. Each file is then
imported by the OTHER framework's importer and run on the same ids or
features: the two imports agree within 1e-5 (both compute the file in
f32), and the port's import agrees with the port's own bf16 model to
bf16 resolution (the JAX test's 2e-2 for the MLP family and the tagger,
5e-2 for the LM, as the model computes in bf16 and the file in f32).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.models.onnx_export import export_onnx as jax_export_onnx
from mmlspark_tpu.models.onnx_import import load_onnx as jax_load_onnx
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models import (
    build_model,
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.models.onnx_export import export_onnx, save_onnx
from mmlspark_tpu_torch.models.onnx_import import load_onnx


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LM = dict(vocab_size=32, d_model=16, heads=4, attn_impl="dense")
#: name -> (family, config, export shape, input dtype, model tolerance)
CASES = {
    "mlp": ("mlp", dict(num_outputs=3, hidden=(8, 6)), (5, 4),
            np.float32, 2e-2),
    "linear": ("linear", dict(num_outputs=2), (4, 6), np.float32, 2e-2),
    "bilstm_tagger": ("bilstm_tagger", dict(vocab_size=30, embed_dim=6,
                                            hidden=5, num_tags=4),
                      (3, 7), np.int32, 2e-2),
    "lm_causal": ("transformer_lm", dict(LM, depth=2, max_len=10), (2, 10),
                  np.int32, 5e-2),
    "lm_encoder": ("transformer_lm", dict(LM, depth=1, max_len=6,
                                          causal=False), (2, 6),
                   np.int32, 5e-2),
    "lm_rope": ("transformer_lm", dict(LM, depth=2, max_len=10,
                                       pos_embedding="rope"), (2, 10),
                np.int32, 5e-2),
    "lm_window": ("transformer_lm", dict(LM, depth=1, max_len=12,
                                         window=4), (2, 12), np.int32, 5e-2),
    "lm_window_rope": ("transformer_lm", dict(LM, depth=1, max_len=12,
                                              window=4,
                                              pos_embedding="rope"),
                       (2, 12), np.int32, 5e-2),
    "lm_gqa_rope": ("transformer_lm", dict(LM, depth=2, max_len=8,
                                           kv_heads=2,
                                           pos_embedding="rope"), (2, 8),
                    np.int32, 5e-2),
}


def _seeded_flax_variables(graph, sample, seed: int) -> dict:
    """flax variables shaped by ``jax.eval_shape`` of ``graph.init``,
    with seeded values: kernels, embeddings and positions N(0, 1/fan_in),
    biases N(0, 0.1^2), LayerNorm scales U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(graph.init, jax.random.PRNGKey(0), sample)

    def walk(node, key: str = ""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key == "scale":
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
        if key == "bias":
            return rng.normal(0, 0.1, node.shape).astype(np.float32)
        fan_in = int(np.prod(node.shape[:-1])) if len(node.shape) > 1 else 1
        return rng.normal(0, fan_in ** -0.5, node.shape).astype(np.float32)

    return walk(dict(shapes))


def _pair(case: str, seed: int = 0):
    family, cfg, shape, dtype, _ = CASES[case]
    jg = jax_build_model(family, **cfg)
    jv = _seeded_flax_variables(
        jg, jnp.zeros((1,) + shape[1:], dtype), seed)
    tg = build_model(family, **cfg)
    return jg, jv, tg, load_flax_variables(tg, jv, device="cpu")


def _inputs(case: str, seed: int = 1) -> np.ndarray:
    family, cfg, shape, dtype, _ = CASES[case]
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(0, cfg["vocab_size"], size=shape).astype(
            np.int32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_is_byte_identical_and_cross_imports(case):
    jg, jv, tg, tv = _pair(case)
    shape, tol = CASES[case][2], CASES[case][4]
    port_bytes = export_onnx(tg, tv, shape)
    assert port_bytes == jax_export_onnx(jg, jv, shape)
    x = _inputs(case)
    # the port's file through the JAX importer, and back through the
    # port's: the same f32 computation
    jax_imported = jax_load_onnx(port_bytes)
    want = np.asarray(jax_imported.apply(jax_imported.init(),
                                         jnp.asarray(x)))
    imported = load_onnx(port_bytes)
    got = imported.apply(imported.init(device="cpu"),
                         torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    native = tg.apply(tv, torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, native, atol=tol, rtol=tol)


def test_lm_block_cut_survives_the_round_trip():
    """The exported LM's block outputs keep the layer names: a cut at
    ``block0`` of the import equals the port model's ``block0``."""
    _, _, tg, tv = _pair("lm_causal", seed=3)
    x = _inputs("lm_causal", seed=4)
    imported = load_onnx(export_onnx(tg, tv, CASES["lm_causal"][2]))
    assert imported.layer_names[-1] == "z"
    hidden = imported.apply(imported.init(device="cpu"), torch.from_numpy(x),
                            output_node="block0").numpy()
    assert hidden.shape == (2, 10, 16)
    want = tg.apply(tv, torch.from_numpy(x), output_node="block0").float()
    np.testing.assert_allclose(hidden, want.numpy(), atol=5e-2, rtol=5e-2)


def test_port_initialised_lm_exports_and_the_argmax_agrees():
    """An LM with the port's own seeded weights (no flax in sight)
    round-trips: the import's per-token argmax agrees with the model's
    on nearly every position (bf16 model vs f32 file)."""
    tg = build_model("transformer_lm", **CASES["lm_gqa_rope"][1])
    tv = init_variables(tg, 7, device="cpu")
    x = _inputs("lm_gqa_rope", seed=5)
    imported = load_onnx(export_onnx(tg, tv, (2, 8)))
    got = imported.apply(imported.init(device="cpu"),
                         torch.from_numpy(x)).numpy()
    want = tg.apply(tv, torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.85


def test_save_onnx_writes_file(tmp_path):
    _, _, tg, tv = _pair("linear")
    path = str(tmp_path / "m.onnx")
    save_onnx(tg, tv, (2, 6), path)
    with open(path, "rb") as f:
        g2 = load_onnx(f.read())
    assert g2.layer_names == ["z"]


def test_unsupported_family_and_variables_errors():
    g = build_model("resnet20_cifar10", width=8)
    with pytest.raises(FriendlyError, match="no ONNX exporter"):
        export_onnx(g, init_variables(g, 0, device="cpu"), (1, 32, 32, 3))
    _, _, tg, tv = _pair("mlp")
    broken = {k: dict(v) for k, v in tv.items()}
    del broken["z"]["Dense_0.weight"]
    with pytest.raises(FriendlyError, match="Dense_0.weight"):
        export_onnx(tg, broken, (5, 4))
