"""The port's meshes, TP rules and sequence parallelism (``mmlspark_tpu_
torch/parallel/{mesh,sharding,context_parallel}.py``) against the JAX
package's, mirroring ``tests/test_parallel_attention.py``.

The JAX side runs on the conftest's 8-device CPU mesh. The port's side
runs on one gloo group of 4 CPU ranks (``testing/rank_pool.RankPool``),
started once for the file and reused by every case, one intra-op thread
a rank. Each rank runs the case's body (the ``_on_rank_*`` functions,
loaded by the workers from this file: they import nothing of JAX) on the
same seeded numpy inputs, global in and global out, so every rank in the
mesh must return the same arrays. Tolerances: f32 outputs within 1e-5
and gradients within 1e-4 of JAX's, bf16 within 2e-2. The transformer
computes in bf16: its logits are held within 2e-2 of the port's dense
model (the JAX test's tolerance between its own paths) and within
``BF16_LOGIT_TOL`` of JAX's (the bound ``tests/test_torch_model.py``
holds the port's bf16 forward to across the frameworks).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.testing.rank_pool import RankPool


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WORLD = 4
F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
BF16_LOGIT_TOL = 6.25e-2
LM = dict(vocab_size=64, d_model=32, heads=4, depth=2, max_len=16)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD)
    try:
        yield pool
    finally:
        pool.close()


# -- bodies run on every rank ---------------------------------------------


def _on_rank_attend(axes, impl, q, k, v, causal=False, window=None,
                    g=None, dtype="float32", flash_inner=False):
    """``impl`` attention of the global numpy q/k/v over ``make_mesh(
    axes)``: the output (and with ``g`` the gradients of sum(out * g)) as
    f32 numpy, or None on a rank outside the mesh; a FriendlyError comes
    back as its message."""
    import mmlspark_tpu_torch.parallel.context_parallel as cp
    from mmlspark_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes)
    if mesh.get_coordinate() is None:
        return None
    if flash_inner:
        # the flash branch of Ulysses' local attention (CUDA-only in
        # the port) through the flash wrapper's plain CPU path
        from mmlspark_tpu_torch.ops.flash_attention import flash_attention

        cp._local_attention = flash_attention
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(t).to(dt).requires_grad_(g is not None)
               for t in (q, k, v))
    fn = cp.ring_attention if impl == "ring" else cp.ulysses_attention
    try:
        o = fn(q, k, v, mesh, causal=causal, window=window)
    except FriendlyError as e:
        return str(e)
    if g is None:
        return o.detach().float().numpy()
    (o.float() * torch.tensor(g)).sum().backward()
    return tuple(t.detach().float().numpy()
                 for t in (o, q.grad, k.grad, v.grad))


def _on_rank_lm(jax_variables, ids):
    """The transformer's logits under ``dense``, and ``ring``/``ulysses``
    over ``make_mesh({"seq": 4})``, on the bridged JAX variables; and the
    dense and ring models' parameter gradients of the logits' sum of
    squares."""
    from mmlspark_tpu_torch.models import build_model, load_flax_variables
    from mmlspark_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"seq": 4})
    x = torch.tensor(ids)
    logits, grads = {}, {}
    for impl in ("dense", "ring", "ulysses"):
        graph = build_model("transformer_lm", attn_impl=impl,
                            mesh=None if impl == "dense" else mesh, **LM)
        variables = load_flax_variables(graph, jax_variables, device="cpu")
        logits[impl] = graph.apply(variables, x).numpy()
        if impl == "ulysses":
            continue
        leaves = {(n, k): t.requires_grad_() for n, b in variables.items()
                  for k, t in b.items()}
        out, _ = graph.apply(variables, x, train=True)
        (out.float() ** 2).sum().backward()
        grads[impl] = {f"{n}.{k}": t.grad.numpy()
                       for (n, k), t in leaves.items()}
    return logits, grads


def _on_rank_shardings(axes, vocab, paths):
    """Each parameter's sharding under the TP rules, the coverage audit,
    and whether every rank's DTensor shard is its slice of the leaf."""
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import (
        TRANSFORMER_TP_RULES,
        build_param_shardings,
        make_mesh,
        shard_params,
        spec_for_path,
        unmatched_param_paths,
    )

    mesh = make_mesh(axes)
    graph = build_model("transformer_lm", **dict(LM, vocab_size=vocab))
    variables = init_variables(graph, 0, device="cpu")
    sh = build_param_shardings(variables, mesh, TRANSFORMER_TP_RULES,
                               graph=graph)
    placed = shard_params(variables, mesh, TRANSFORMER_TP_RULES, graph=graph)
    specs, slices_ok = {}, []
    for name, block in variables.items():
        for key, leaf in block.items():
            s = sh[name][key]
            specs[s.flax_path] = (s.flax_spec, s.spec,
                                  tuple(map(repr, s.placements)))
            local = placed[name][key].to_local()
            want = leaf
            for dim, axis in enumerate(s.spec):
                if axis is not None:
                    n = mesh.size(mesh.mesh_dim_names.index(axis))
                    want = want.chunk(n, dim=dim)[mesh.get_local_rank(axis)]
            slices_ok.append(torch.equal(local, want))
    uneven = build_param_shardings(
        {"x": {"qkv": {"kernel": torch.zeros(8, 6)}}}, make_mesh(
            {"model": WORLD}), TRANSFORMER_TP_RULES)
    by_path = {path: spec_for_path(path, TRANSFORMER_TP_RULES, mesh)
               for path in paths}
    return (specs, unmatched_param_paths(variables, TRANSFORMER_TP_RULES,
                                         graph=graph),
            all(slices_ok), uneven["x"]["qkv"]["kernel"].spec, by_path)


def _on_rank_mesh_errors():
    """make_mesh's refusals and the DTensor specs, on the rank's group."""
    from mmlspark_tpu_torch.parallel import (
        batch_spec,
        make_mesh,
        mesh_shape,
        replicated_spec,
    )

    out = []
    for axes in ({"data": -1, "seq": -1}, {"data": 3, "seq": -1},
                 {"data": 2, "seq": 4}):
        try:
            make_mesh(axes)
            out.append(None)
        except FriendlyError as e:
            out.append(str(e))
    mesh = make_mesh({"data": -1, "seq": 2})
    return (out, mesh_shape(mesh), mesh_shape(make_mesh()),
            repr(batch_spec(mesh)), repr(replicated_spec(mesh)))


# -- helpers on the test's side ----------------------------------------------


def _qkv(rng, b=2, s=16, h=4, d=8, hk=None):
    hk = hk or h
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, hk, d)).astype(np.float32),
            rng.normal(size=(b, s, hk, d)).astype(np.float32))


def _jax_attend(jax_axes, impl, q, k, v, causal=False, window=None, g=None,
                dtype="float32"):
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.parallel import make_mesh, ring_attention
    from mmlspark_tpu.parallel import ulysses_attention

    mesh = make_mesh(jax_axes)
    fn = ring_attention if impl == "ring" else ulysses_attention
    args = tuple(jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v))

    def f(q, k, v):
        return fn(q, k, v, mesh, causal=causal, window=window)

    # jitted: one compile a case (eager shard_map dispatches op by op)
    if g is None:
        return np.asarray(jax.jit(f)(*args).astype(jnp.float32))

    @jax.jit
    def with_grads(q, k, v):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(jnp.asarray(g, out.dtype)))

    return tuple(np.asarray(t.astype(jnp.float32))
                 for t in with_grads(*args))


def _same_on_every_rank(results):
    """The in-mesh ranks' result, checked equal across them (the output
    is replicated); ``results`` may be a pending ``RankPool.submit``."""
    if hasattr(results, "result"):
        results = results.result()
    live = [r for r in results if r is not None]

    def equal(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for key in a:
                equal(a[key], b[key])
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                equal(x, y)
        elif isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)

    for r in live[1:]:
        equal(r, live[0])
    return live[0]


def _check(got, want, tol=F32, grad_tol=GRAD):
    if isinstance(want, tuple):
        np.testing.assert_allclose(got[0], want[0], **tol)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, **grad_tol)
    else:
        np.testing.assert_allclose(got, want, **tol)


# -- ring and Ulysses against JAX's ------------------------------------------
#
# Each case starts on the ranks, computes JAX's twin meanwhile, then
# compares.


def _case(ranks, axes, jax_axes, impl, q, k, v, causal=False, window=None,
          g=None, dtype="float32", tol=F32, grad_tol=GRAD):
    pending = ranks.submit(_on_rank_attend, axes, impl, q, k, v, causal,
                           window, g, dtype)
    want = _jax_attend(jax_axes, impl, q, k, v, causal, window, g, dtype)
    _check(_same_on_every_rank(pending), want, tol, grad_tol)


def _jax_error(jax_axes, impl, q, k, v, causal=False):
    from mmlspark_tpu.core.exceptions import FriendlyError as JaxFriendly

    with pytest.raises(JaxFriendly) as e:
        _jax_attend(jax_axes, impl, q, k, v, causal)
    return str(e.value)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(ranks, rng, causal):
    _case(ranks, {"seq": 4}, {"seq": 8}, "ring", *_qkv(rng), causal)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(ranks, rng, causal):
    _case(ranks, {"seq": 4}, {"seq": 4}, "ulysses", *_qkv(rng), causal)


@pytest.mark.parametrize("window", [None, 6])
def test_ring_gqa_matches_jax(ranks, rng, window):
    """Narrow kv chunks rotate; with window 6 over chunks of 4, three of
    the four rotations are live."""
    _case(ranks, {"seq": 4}, {"seq": 8}, "ring", *_qkv(rng, hk=2), True,
          window)


def test_ulysses_gqa_matches_jax(ranks, rng):
    _case(ranks, {"seq": 2}, {"seq": 2}, "ulysses", *_qkv(rng, hk=2), True)


def test_ring_gqa_gradients_match_jax(ranks, rng):
    q, k, v = _qkv(rng, s=8, hk=2)
    g = rng.normal(size=q.shape).astype(np.float32)
    _case(ranks, {"seq": 4}, {"seq": 4}, "ring", q, k, v, True, None, g)


def test_gqa_head_mismatch_is_friendly(ranks, rng):
    """The same FriendlyError texts as the JAX package's, from a rank."""
    q, _, _ = _qkv(rng)
    _, k3, v3 = _qkv(rng, hk=3)
    for impl in ("ring", "ulysses"):
        msg = _same_on_every_rank(ranks.run(
            _on_rank_attend, {"seq": 4}, impl, q, k3, v3, True))
        assert msg == _jax_error({"seq": 4}, impl, q, k3, v3, True)
        assert "heads" in msg


def test_ring_with_data_axis(ranks, rng):
    # dp × sp: batch on 'data', sequence on 'seq'
    q, k, v = _qkv(rng, b=4, s=8)
    g = rng.normal(size=q.shape).astype(np.float32)
    _case(ranks, {"data": 2, "seq": 2}, {"data": 2, "seq": 4}, "ring", q, k,
          v, True)
    _case(ranks, {"data": 2, "seq": 2}, {"data": 2, "seq": 2}, "ulysses", q,
          k, v, True, None, g)


def test_ring_gradients_match_jax(ranks, rng):
    q, k, v = _qkv(rng, b=1, s=8, h=2, d=4)
    g = rng.normal(size=q.shape).astype(np.float32)
    _case(ranks, {"seq": 4}, {"seq": 4}, "ring", q, k, v, True, None, g)


def test_ring_rejects_bad_seq_len(ranks, rng):
    q, k, v = _qkv(rng, s=6)  # 6 % 4 != 0
    for impl in ("ring", "ulysses"):
        msg = _same_on_every_rank(ranks.run(
            _on_rank_attend, {"seq": 4}, impl, q, k, v))
        assert msg == _jax_error({"seq": 4}, impl, q, k, v)
    msg = _same_on_every_rank(ranks.run(
        _on_rank_attend, {"data": 4}, "ring", q, k, v))
    assert msg == _jax_error({"data": 4}, "ring", q, k, v)


def test_ulysses_flash_inner_matches_jax(ranks, rng):
    """Ulysses' flash branch (the CUDA kernels on the card) through the
    flash wrapper's plain version, against JAX's Ulysses and the dense
    function (JAX's own test holds its interpret-mode flash branch to
    dense)."""
    import jax.numpy as jnp

    from mmlspark_tpu.ops.attention import dense_attention

    q, k, v = _qkv(rng, s=32, h=8)
    pending = ranks.submit(_on_rank_attend, {"seq": 4}, "ulysses", q, k, v,
                           True, flash_inner=True)
    want = _jax_attend({"seq": 8}, "ulysses", q, k, v, True)
    dense = np.asarray(dense_attention(*map(jnp.asarray, (q, k, v)),
                                       causal=True))
    got = _same_on_every_rank(pending)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, dense, **F32)


def test_ring_and_ulysses_sliding_window_match_jax(ranks):
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, s=32)
    for impl in ("ring", "ulysses"):
        _case(ranks, {"seq": 4}, {"seq": 4}, impl, q, k, v, True, 9)


def test_ring_window_step_bound():
    from mmlspark_tpu.parallel.context_parallel import (
        _ring_window_steps as jax_steps,
    )
    from mmlspark_tpu_torch.parallel.context_parallel import (
        _ring_window_steps,
    )

    for n in (1, 2, 4, 8):
        for chunk in (1, 4, 8, 16):
            for window in (None, 1, 5, 16, 17, 18, 1000):
                for causal in (False, True):
                    assert _ring_window_steps(n, chunk, window, causal) == \
                        jax_steps(n, chunk, window, causal)
    assert _ring_window_steps(8, 16, 18, True) == 3


@pytest.mark.parametrize("window", [1, 5, 8, 9, 24])
def test_ring_window_skipped_rotations_exact(ranks, window):
    """Windows smaller than, equal to and spanning the chunk (S=32 over 4
    ranks: chunks of 8), forward against JAX's."""
    rng = np.random.default_rng(15)
    _case(ranks, {"seq": 4}, {"seq": 4}, "ring", *_qkv(rng, s=32), True,
          window)


def test_ring_window_gradients_match_jax(ranks):
    """Gradients through the truncated ring (2 of 4 rotations live): the
    partials' last hop home."""
    rng = np.random.default_rng(16)
    q, k, v = _qkv(rng, b=1, s=32)
    g = rng.normal(size=q.shape).astype(np.float32)
    _case(ranks, {"seq": 4}, {"seq": 4}, "ring", q, k, v, True, 9, g)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_bf16_matches_jax(ranks, rng, impl):
    _case(ranks, {"seq": 2}, {"seq": 2}, impl, *_qkv(rng, s=16, hk=2), True,
          dtype="bfloat16", tol=BF16)


# -- the transformer over a mesh ----------------------------------------------


@pytest.fixture(scope="module")
def jax_lm():
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model

    rng = np.random.default_rng(42)
    ids = rng.integers(0, 64, size=(2, 16))
    graph = build_model("transformer_lm", attn_impl="dense", **LM)
    # seeded values on init's shapes (faster than running init): unit
    # LayerNorm scales, small N(0, 0.2^2) draws elsewhere
    shapes = jax.eval_shape(graph.init, jax.random.PRNGKey(0),
                            jnp.asarray(ids))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.ones(leaf.shape, np.float32)
        if str(getattr(path[-1], "key", "")) == "scale"
        else (0.2 * rng.normal(size=leaf.shape)).astype(np.float32), shapes)
    return (variables, ids,
            np.asarray(jax.jit(graph.apply)(variables, jnp.asarray(ids))))


def test_transformer_impls_agree(ranks, jax_lm):
    """``ring``/``ulysses`` over a 4-rank mesh and ``dense`` on bridged
    JAX variables against the JAX logits, and the ring model's parameter
    gradients against the dense one's."""
    variables, ids, want = jax_lm
    logits, grads = _same_on_every_rank(ranks.run(_on_rank_lm, variables,
                                                  ids))
    np.testing.assert_allclose(logits["dense"], want, atol=BF16_LOGIT_TOL,
                               rtol=0)
    for impl in ("ring", "ulysses"):
        np.testing.assert_allclose(logits[impl], logits["dense"], **BF16)
        np.testing.assert_allclose(logits[impl], want, atol=BF16_LOGIT_TOL,
                                   rtol=0)
    dense, ring = grads["dense"], grads["ring"]
    assert dense.keys() == ring.keys()
    for key in dense:
        scale = np.abs(dense[key]).max() + 1e-6
        np.testing.assert_allclose(ring[key] / scale, dense[key] / scale,
                                   atol=2e-2, err_msg=key)


# -- TP rules and meshes --------------------------------------------------------


def test_tp_sharding_rules_match_jax(ranks):
    """Every parameter path of ``transformer_lm`` gets JAX's spec (the
    odd vocabulary of 65 leaves the embedding rows and the head columns
    uneven over model=2, so they replicate), the port's own spec is that
    spec in the port's axes, each rank's shard is its slice, and the
    uneven (8, 6) kernel over model=4 replicates."""
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model
    from mmlspark_tpu.parallel import TRANSFORMER_TP_RULES, make_mesh
    from mmlspark_tpu.parallel.sharding import (
        build_param_shardings,
        spec_for_path,
        unmatched_param_paths,
    )
    axes = {"data": 2, "model": 2}
    mesh = make_mesh(axes)
    graph = build_model("transformer_lm", **dict(LM, vocab_size=65))
    shapes = jax.eval_shape(graph.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16), jnp.int32))
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(
            build_param_shardings(shapes, mesh, TRANSFORMER_TP_RULES)):
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        want[key] = tuple(sh.spec)
    paths = ("block0/attn/qkv/kernel", "embed/token/embedding",
             "z/head/kernel", "some/unknown/param")
    results = ranks.run(_on_rank_shardings, axes, 65, paths)
    for specs, unmatched, slices_ok, uneven, by_path in results:
        assert {p: s[0] for p, s in specs.items()} == want
        for flax_spec, spec, _ in specs.values():
            assert spec in (flax_spec, tuple(reversed(flax_spec)))
        assert specs["block0/params/attn/qkv/kernel"][1:] == (
            ("model", None), ("Replicate()", "Shard(dim=0)"))
        assert specs["embed/params/token/embedding"][0] == (None, None)
        assert unmatched == unmatched_param_paths(
            shapes, TRANSFORMER_TP_RULES) == []
        assert slices_ok
        assert uneven == (None, None)
        assert by_path == {path: tuple(spec_for_path(
            path, TRANSFORMER_TP_RULES, mesh)) for path in paths}


def test_mesh_errors_and_specs_match_jax(ranks):
    from mmlspark_tpu.core.exceptions import FriendlyError as JaxFriendly
    from mmlspark_tpu.parallel import make_mesh, parse_mesh_axes
    from mmlspark_tpu_torch.parallel import parse_mesh_axes as port_parse

    devices = __import__("jax").devices()[:WORLD]
    want = []
    for axes in ({"data": -1, "seq": -1}, {"data": 3, "seq": -1},
                 {"data": 2, "seq": 4}):
        with pytest.raises(JaxFriendly) as e:
            make_mesh(axes, devices=devices)
        want.append(str(e.value))
    for errors, inferred, default, batch, replicated in ranks.run(
            _on_rank_mesh_errors):
        assert errors == want
        assert inferred == {"data": 2, "seq": 2}
        assert default == {"data": WORLD}
        assert batch == "(Shard(dim=0), Replicate())"
        assert replicated == "(Replicate(), Replicate())"
    for spec in ("data=4,model=2", " seq = -1 ", "data=4,,model=2"):
        assert port_parse(spec) == parse_mesh_axes(spec)
    for bad in ("data", "data=x", "=4", ""):
        with pytest.raises(JaxFriendly) as e:
            parse_mesh_axes(bad)
        with pytest.raises(FriendlyError, match="bad mesh spec") as p:
            port_parse(bad)
        assert str(p.value) == str(e.value)


def test_make_mesh_needs_a_process_group():
    from mmlspark_tpu_torch.parallel import make_mesh

    with pytest.raises(FriendlyError, match="initialize_distributed"):
        make_mesh({"seq": 1})
