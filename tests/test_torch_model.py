"""The port's transformer LM against the JAX package's, through the weight
bridge: the same flax variables, the same numpy token ids.

Tolerances on logits (magnitude up to ~4):
- float32 compute (every block's ``dtype`` set to float32 on both
  sides): 1e-4 — the same f32 arithmetic summed in other orders;
- the default bfloat16 compute: 6.25e-2 — bf16 rounds at the same
  places on both sides, but the frameworks' matmul and gelu kernels sum
  in other orders, so a rounding boundary may flip; each flip moves a
  logit by about one bf16 ulp (2^-6 at |x| in [2, 4)), and we allow
  four.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.models.generate import _cached_apply as jax_cached_apply
from mmlspark_tpu.models.generate import generate as jax_generate
from mmlspark_tpu.models.generate import init_cache as jax_init_cache
from mmlspark_tpu_torch.core.exceptions import FriendlyError, ParamError
from mmlspark_tpu_torch.models import (
    build_model,
    generate,
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.models.generate import (
    _cached_apply,
    cache_geometry,
    init_cache,
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


F32_TOL = 1e-4
BF16_LOGIT_TOL = 6.25e-2
TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)
VARIANTS = {
    "mha_learned": {},
    "gqa_rope": dict(kv_heads=1, pos_embedding="rope"),
    "window": dict(window=8),
}


def _f32_blocks_jax(graph):
    graph.blocks = [
        (n, m.clone(dtype=jnp.float32) if hasattr(m, "dtype") else m)
        for n, m in graph.blocks
    ]
    return graph


def _f32_blocks_port(graph):
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


@pytest.fixture(scope="module")
def models():
    """{(variant, dtype): (jax graph, jax variables, port graph, port
    variables)} over one random flax initialisation per variant."""
    out = {}
    for name, kw in VARIANTS.items():
        jv = tv = None
        for dtype in ("bfloat16", "float32"):
            jg = jax_build_model("transformer_lm", attn_impl="dense",
                                 **TINY, **kw)
            tg = build_model("transformer_lm", **TINY, **kw)
            if dtype == "float32":
                _f32_blocks_jax(jg)
                _f32_blocks_port(tg)
            if jv is None:  # parameters are f32 whatever the compute dtype
                jv = jax.jit(jg.init)(jax.random.PRNGKey(len(name)),
                                      jnp.zeros((1, 8), jnp.int32))
                tv = load_flax_variables(tg, jv, device="cpu")
            out[name, dtype] = (jg, jv, tg, tv)
    return out


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=shape).astype(np.int32)


def _assert_logits(want, got, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=tol,
                               rtol=0)


# -- (c) logits through the bridge ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_full_forward_logits_match_jax(models, variant, dtype):
    jg, jv, tg, tv = models[variant, dtype]
    ids = _ids(0, (2, 12))
    want = jax.jit(jg.apply)(jv, jnp.asarray(ids))
    got = tg.apply(tv, torch.from_numpy(ids))
    assert got.shape == (2, 12, TINY["vocab_size"])
    _assert_logits(want, got, dtype)


def _caches(dtype, hk, d, b=2, total=16):
    """Matching zero caches: bf16 is what init_cache gives both sides;
    the f32 test builds f32 caches by hand (the decode read takes one
    dtype for q, k and v)."""
    if dtype == "bfloat16":
        return None
    return (
        {f"block{i}": (jnp.zeros((b, total, hk, d)),) * 2
         for i in range(TINY["depth"])},
        {f"block{i}": tuple(torch.zeros(b, total, hk, d) for _ in range(2))
         for i in range(TINY["depth"])},
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["mha_learned", "gqa_rope"])
def test_cached_prefill_and_decode_step_match_jax(models, variant, dtype):
    """Prefill 8 tokens into the linear cache, then one per-row decode
    step (rows at different positions, one row dead) through
    flash_decode on both sides."""
    jg, jv, tg, tv = models[variant, dtype]
    (hk, d), = set(cache_geometry(tg, tv).values())
    caches = _caches(dtype, hk, d)
    if caches is None:
        jc, tc = jax_init_cache(jg, jv, 2, 16), init_cache(tg, tv, 2, 16)
    else:
        jc, tc = caches
    ids = _ids(1, (2, 9))
    jax_apply = jax.jit(partial(jax_cached_apply, jg),
                        static_argnames=("step",))
    want, jc = jax_apply(jv, jnp.asarray(ids[:, :8]), jc, 0)
    got, tc = _cached_apply(tg, tv, torch.from_numpy(ids[:, :8]), tc, 0)
    _assert_logits(want, got, dtype)
    pos, live = np.asarray([8, 5], np.int32), np.asarray([True, False])
    want, jc = jax_apply(jv, jnp.asarray(ids[:, 8:]), jc, jnp.asarray(pos),
                         step=True, live=jnp.asarray(live))
    got, tc = _cached_apply(tg, tv, torch.from_numpy(ids[:, 8:]), tc,
                            torch.from_numpy(pos), step=True,
                            live=torch.from_numpy(live))
    _assert_logits(want, got, dtype)
    # the step's K/V landed at each row's own position, in place
    for name, (ck, cv) in tc.items():
        np.testing.assert_allclose(
            np.asarray(jc[name][0], np.float32)[[0, 1], pos],
            ck.float().numpy()[[0, 1], pos],
            atol=F32_TOL if dtype == "float32" else BF16_LOGIT_TOL,
        )


def test_rolled_window_generate_matches_jax(models):
    """A window smaller than the generation rolls the cache on both
    sides (f32, so the streams must be equal)."""
    jg, jv, tg, tv = models["window", "float32"]
    prompt = _ids(2, (2, 6))
    want = np.asarray(jax_generate(jg, jv, jnp.asarray(prompt), 14))
    got = generate(tg, tv, torch.from_numpy(prompt), 14, device="cpu")
    np.testing.assert_array_equal(want, got.numpy())


def test_generate_eos_emits_eos_then_pads(models):
    """generate()'s EOS contract (the JAX ``advance``): the EOS token is
    emitted, then the row fills with ``pad_id``; other rows run on."""
    _, _, tg, tv = models["mha_learned", "bfloat16"]
    prompt = torch.from_numpy(_ids(3, (2, 4)))
    free = generate(tg, tv, prompt, 10, device="cpu")
    eos = int(free[0, 6])
    got = generate(tg, tv, prompt, 10, eos_id=eos, pad_id=0, device="cpu")
    stop = 4 + int(torch.nonzero(free[0, 4:] == eos)[0])
    torch.testing.assert_close(got[0, :stop + 1], free[0, :stop + 1])
    assert (got[0, stop + 1:] == 0).all()
    if not (free[1, 4:] == eos).any():
        torch.testing.assert_close(got[1], free[1])


# -- the bridge and the graph -----------------------------------------------


def test_bridge_transposes_dense_kernels_and_renames_leaves(models):
    jg, jv, tg, tv = models["gqa_rope", "float32"]
    p = jv["block0"]["params"]
    np.testing.assert_array_equal(
        tv["block0"]["attn.qkv.weight"].numpy(),
        np.asarray(p["attn"]["qkv"]["kernel"]).T,
    )
    np.testing.assert_array_equal(tv["block0"]["ln1.weight"].numpy(),
                                  np.asarray(p["ln1"]["scale"]))
    np.testing.assert_array_equal(
        tv["embed"]["token.weight"].numpy(),
        np.asarray(jv["embed"]["params"]["token"]["embedding"]),
    )
    assert "pos" not in tv["embed"]  # RoPE: no learned table
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for v in tv.values() for t in v.values())


def test_bridge_reports_missing_and_misshapen_leaves(models):
    jg, jv, tg, _ = models["mha_learned", "float32"]
    broken = jax.tree_util.tree_map(np.asarray, jv)
    del broken["block1"]["params"]["mlp_out"]["bias"]
    with pytest.raises(FriendlyError, match="mlp_out/bias"):
        load_flax_variables(tg, broken, device="cpu")
    misshapen = jax.tree_util.tree_map(np.asarray, jv)
    misshapen["z"]["params"]["head"]["kernel"] = np.zeros((8, 8))
    with pytest.raises(FriendlyError, match="shape"):
        load_flax_variables(tg, misshapen, device="cpu")


def test_init_variables_is_seeded_and_shaped():
    g = build_model("transformer_lm", **TINY)
    a, b = init_variables(g, 7, device="cpu"), init_variables(g, 7,
                                                              device="cpu")
    c = init_variables(g, 8, device="cpu")
    assert a.keys() == b.keys() == {n for n, _ in g.blocks}
    for name in a:
        for key in a[name]:
            assert torch.equal(a[name][key], b[name][key])
    assert not torch.equal(a["block0"]["attn.qkv.weight"],
                           c["block0"]["attn.qkv.weight"])
    assert torch.equal(a["z"]["ln_f.weight"], torch.ones(TINY["d_model"]))
    assert not a["block1"]["mlp_in.bias"].any()
    logits = g.apply(a, torch.from_numpy(_ids(4, (1, 5))))
    assert logits.shape == (1, 5, 64) and torch.isfinite(logits).all()


def test_graph_binds_variables_by_identity(models):
    """Binding assigns the variables' tensors (no copy) and is skipped
    for the dict already bound; a new dict rebinds."""
    _, _, tg, tv = models["mha_learned", "float32"]
    ids = torch.from_numpy(_ids(5, (1, 4)))
    first = tg.apply(tv, ids)
    assert tg._bound is tv
    qkv = dict(tg.blocks)["block0"].attn.qkv.weight
    assert qkv.data_ptr() == tv["block0"]["attn.qkv.weight"].data_ptr()
    scaled = {n: dict(v) for n, v in tv.items()}
    scaled["z"]["head.weight"] = tv["z"]["head.weight"] * 2
    torch.testing.assert_close(tg.apply(scaled, ids),
                               2 * first - tv["z"]["head.bias"])
    assert tg.layer_names == ["embed", "block0", "block1", "z"]
    with pytest.raises(FriendlyError, match="lack block"):
        tg.apply({"embed": tv["embed"]}, ids)
    assert tg._bound is None  # half-bound: the next call binds afresh
    torch.testing.assert_close(tg.apply(tv, ids), first)


def test_registry_and_geometry():
    with pytest.raises(FriendlyError, match="did you mean"):
        build_model("transformer_lmm")
    g = build_model("transformer_lm", **dict(TINY, heads=4, kv_heads=2))
    v = init_variables(g, 0, device="cpu")
    assert cache_geometry(g, v) == {"block0": (2, 8), "block1": (2, 8)}
    cache = init_cache(g, v, 3, 10)
    k, vv = cache["block0"]
    assert k.shape == (3, 10, 2, 8) and k.dtype == torch.bfloat16
    assert k.data_ptr() != vv.data_ptr()  # distinct: written in place
    g.extra.pop("heads")
    with pytest.raises(FriendlyError, match="heads"):
        cache_geometry(g, v)


def test_unported_paths_raise_param_error():
    # ring/ulysses are ported: without a mesh they degrade to dense, as in
    # the JAX package (tests/test_torch_context_parallel.py runs them on
    # a mesh)
    ids = torch.tensor([[1, 2, 3, 4, 5, 6]])
    dense = build_model("transformer_lm", attn_impl="dense", **TINY)
    v = init_variables(dense, 0, device="cpu")
    for impl in ("ring", "ulysses"):
        g = build_model("transformer_lm", attn_impl=impl, **TINY)
        assert g.extra["attn_impl"] == impl
        torch.testing.assert_close(g.apply(v, ids), dense.apply(v, ids),
                                   rtol=0, atol=0)
    # auto is flash only with a GPU; flash itself is ported
    assert build_model("transformer_lm", **TINY).extra["attn_impl"] == "dense"
    assert build_model("transformer_lm", attn_impl="flash",
                       **TINY).extra["attn_impl"] == "flash"
    with pytest.raises(ParamError, match="unknown attn_impl"):
        build_model("transformer_lm", attn_impl="sparse", **TINY)
    with pytest.raises(ParamError, match="kv_heads"):
        build_model("transformer_lm", kv_heads=3, **TINY)
    g = build_model("transformer_lm", **TINY)
    v = init_variables(g, 0, device="cpu")
    block = dict(g.blocks)["block0"]
    x = torch.zeros(2, 1, TINY["d_model"])
    buf = torch.zeros(2, 8, 2, 16, dtype=torch.bfloat16)
    pos = torch.tensor([1, 2], dtype=torch.int32)
    g.bind(v)
    # the paged and int8 caches are the serve pools' decode formats: a
    # prefill-style call with them raises, as in the JAX package
    pages = torch.zeros(3, 2, 8, 16, dtype=torch.bfloat16)
    table = torch.zeros(2, 1, dtype=torch.int32)
    q8 = torch.zeros(2, 8, 2, 16, dtype=torch.int8)
    scales = torch.ones(2, 2)
    for cache, kw, match in (
        ((pages, pages, table), dict(pos=pos), "per-row single-token"),
        ((q8, q8, scales, scales), dict(pos=1, decode=True),
         "int8 dense caches"),
        ((buf,) * 6, dict(pos=pos, decode=True), "6-tuple"),
    ):
        with pytest.raises(ParamError, match=match):
            block(x, cache=cache, **kw)
