"""The port's serving path against the JAX package's: token streams of
the port's ``generate()`` and ``ServeEngine`` against the JAX
``ServeEngine`` on the same flax weights (mirroring
``tests/test_decode_block.py``), the port's engine against its own
``generate()``, the scheduler/pool/metrics mechanics, the device rule,
and that the port never imports JAX.

Streams must be equal. The model is the JAX package's overfit periodic
LM (``testing/datagen.overfit_periodic_lm``), so greedy picks have wide
margins; a divergence between the two frameworks is accepted only at a
step where the JAX model's top-2 logit margin is below the bf16 logit
tolerance of ``tests/test_torch_model.py`` (a near-tie that bf16 rounding
may break either way), and the test checks that margin.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.serve.metrics import ServeMetrics as JaxServeMetrics
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core import env
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.models import (
    build_model,
    generate,
    init_variables,
    load_flax_variables,
)
from mmlspark_tpu_torch.models.generate import (
    _cached_apply,
    greedy_next,
    init_cache,
    make_decode_block,
)
from mmlspark_tpu_torch.serve import ServeEngine, ServeMetrics, run_demo
from mmlspark_tpu_torch.serve.cache_pool import SlotCachePool


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent
#: the bf16 logit tolerance of tests/test_torch_model.py
BF16_LOGIT_TOL = 6.25e-2
TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)
CACHE_LEN = 32


@pytest.fixture(scope="module")
def lm():
    """(jax graph, jax variables, port graph, port variables, ids): the
    JAX package's overfit periodic LM, bridged into the port."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    tg = build_model("transformer_lm", **TINY)
    tv = load_flax_variables(tg, jv, device="cpu")
    return jg, jv, tg, tv, np.array(ids)  # a writable copy


def _port_generate(tg, tv, prompt, n, eos_id=None):
    return generate(tg, tv, np.asarray(prompt, np.int32)[None], n,
                    eos_id=eos_id, device="cpu")[0].numpy()


def _assert_streams_agree(jg, jv, want, got, prompt_len):
    """``got`` equals ``want`` (both prompt + generated), or first
    differs at a step where the JAX model's top-2 margin is a near-tie
    under the bf16 logit tolerance; equal lengths either way."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want, got)
    diff = np.nonzero(want != got)[0]
    if not diff.size:
        return
    i = int(diff[0])
    assert i >= prompt_len
    logits = np.asarray(jg.apply(jv, jnp.asarray(want[None, :i])))[0, -1]
    top2 = np.sort(logits.astype(np.float32))[-2:]
    margin = float(top2[1] - top2[0])
    assert margin < BF16_LOGIT_TOL, (
        f"streams diverge at token {i} where the JAX margin is {margin} "
        f"(>= {BF16_LOGIT_TOL}): {want} vs {got}"
    )


RAGGED_PROMPTS = (4, 1, 9, 6, 2)  # prefixes of the periodic row
RAGGED_BUDGETS = [10, 7, 3, 12, 5]


@pytest.fixture(scope="module")
def jax_ragged(lm):
    """The JAX engine's results on the ragged/join schedule (T=4)."""
    jg, jv, _, _, ids = lm
    prompts = [ids[0, :n] for n in RAGGED_PROMPTS]
    engine = JaxServeEngine(jg, jv, slots=2, cache_len=CACHE_LEN,
                            max_queue=8, decode_block=4)
    return prompts, _drive(engine, prompts, RAGGED_BUDGETS)


def _drive(engine, prompts, budgets, eos=None):
    """Three requests up front, two steps, then the rest join mid-run
    (tests/test_decode_block.py's schedule)."""
    results, rids = {}, []
    for p, n in zip(prompts[:3], budgets[:3]):
        rids.append(engine.submit(p, max_new_tokens=n, eos_id=eos))
    for _ in range(2):
        results.update({r.id: r for r in engine.step()})
    for p, n in zip(prompts[3:], budgets[3:]):
        rids.append(engine.submit(p, max_new_tokens=n, eos_id=eos))
    while engine.busy:
        results.update({r.id: r for r in engine.step()})
    return [results[r] for r in rids]


# -- (d) + (e): token streams -------------------------------------------------


@pytest.mark.parametrize("block", [1, 4, 32])
def test_streams_match_jax_engine_ragged_prompts_and_joins(lm, jax_ragged,
                                                          block):
    """Ragged prompts, heterogeneous budgets and a mid-run join: the
    JAX engine's streams = the port engine's = the port's generate()."""
    jg, jv, tg, tv, _ = lm
    prompts, jax_res = jax_ragged
    engine = ServeEngine(tg, tv, slots=2, cache_len=CACHE_LEN, max_queue=8,
                         decode_block=block, device="cpu")
    port_res = _drive(engine, prompts, RAGGED_BUDGETS)
    for p, n, jr, pr in zip(prompts, RAGGED_BUDGETS, jax_res, port_res):
        assert pr.status == "completed" and pr.generated == n
        _assert_streams_agree(jg, jv, jr.tokens, pr.tokens, len(p))
        # (e) the port's engine equals the port's generate(), exactly
        np.testing.assert_array_equal(pr.tokens,
                                      _port_generate(tg, tv, p, n))
    assert set(engine.metrics.decode_blocks) <= {
        str(1 << i) for i in range(engine.num_decode_blocks)}


def test_streams_match_jax_engine_mid_block_eos(lm):
    """A request hitting EOS inside a T=4 block goes dead on the device,
    retires at the block boundary, and its stream (EOS included) matches
    the JAX engine and the port's generate()."""
    jg, jv, tg, tv, ids = lm
    prompt = ids[0, :3]
    free = _port_generate(tg, tv, prompt, 12)
    eos = int(free[len(prompt) + 2])
    jax_res = JaxServeEngine(jg, jv, slots=2, cache_len=CACHE_LEN,
                             decode_block=4)
    rid = jax_res.submit(prompt, max_new_tokens=12, eos_id=eos)
    want = jax_res.run()[rid].tokens
    engine = ServeEngine(tg, tv, slots=2, cache_len=CACHE_LEN,
                         decode_block=4, device="cpu")
    rid = engine.submit(prompt, max_new_tokens=12, eos_id=eos)
    res = engine.run()[rid]
    _assert_streams_agree(jg, jv, want, res.tokens, len(prompt))
    assert res.status == "completed" and int(res.tokens[-1]) == eos
    assert res.generated < 12
    full = _port_generate(tg, tv, prompt, 12, eos_id=eos)
    np.testing.assert_array_equal(res.tokens, full[:len(res.tokens)])
    assert (full[len(res.tokens):] == 0).all()


def test_decode_block_budget_death_mid_block(lm):
    """The raw block program: a row whose budget (3) is smaller than the
    block (8) dies inside it — real tokens up to the budget, pads after,
    live flag down, position frozen."""
    _, _, tg, tv, ids = lm
    prompt = ids[0, :5]
    p, budget, t = len(prompt), 3, 8
    want = _port_generate(tg, tv, prompt, budget + 1)
    cache = init_cache(tg, tv, 1, CACHE_LEN)
    logits, cache = _cached_apply(tg, tv, torch.from_numpy(prompt)[None],
                                  cache, 0)
    first = int(greedy_next(logits[0, p - 1]))
    assert first == int(want[p])
    toks, live, _, pos = make_decode_block(tg, pad_id=0)(
        tv, cache, torch.tensor([p], dtype=torch.int32),
        torch.tensor([True]), torch.tensor([first], dtype=torch.int32),
        torch.tensor([budget], dtype=torch.int32),
        torch.tensor([-1], dtype=torch.int32), t,
    )
    toks = toks[0].numpy()
    assert toks.shape == (t,)
    np.testing.assert_array_equal(toks[:budget], want[p + 1:])
    assert not bool(live[0]) and (toks[budget:] == 0).all()
    assert int(pos[0]) == p + budget


def test_random_weights_engine_matches_generate_or_near_tie():
    """Random weights (narrow greedy margins) through the port's engine
    and its generate(): equal streams, or a divergence only at a near
    tie of the port's own logits."""
    g = build_model("transformer_lm", **TINY)
    v = init_variables(g, 5, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, size=n) for n in (3, 9, 5, 1, 7)]
    engine = ServeEngine(g, v, slots=2, cache_len=CACHE_LEN,
                         decode_block=4, device="cpu")
    res = _drive(engine, prompts, [10] * 5)
    for p, r in zip(prompts, res):
        want = _port_generate(g, v, p, 10)
        diff = np.nonzero(want != r.tokens)[0]
        if diff.size:
            i = int(diff[0])
            logits = g.apply(v, torch.from_numpy(want[None, :i]))[0, -1]
            top2 = logits.sort().values[-2:]
            assert float(top2[1] - top2[0]) < BF16_LOGIT_TOL


# -- engine, pool, scheduler and metrics mechanics ---------------------------


def test_engine_validation_and_ladder(lm):
    _, _, tg, tv, _ = lm
    with pytest.raises(FriendlyError, match="decode_block"):
        ServeEngine(tg, tv, slots=1, cache_len=32, decode_block=0,
                    device="cpu")
    with pytest.raises(FriendlyError, match="learned position"):
        ServeEngine(tg, tv, slots=1, cache_len=64, device="cpu")
    e = ServeEngine(tg, tv, slots=1, cache_len=32, decode_block=5,
                    max_queue=1, device="cpu")
    assert e.decode_block == 4 and e.num_decode_blocks == 3
    assert [e._block_size(n) for n in (1, 3, 4, 100)] == [1, 2, 4, 4]
    assert [e.prefill_bucket(n) for n in (1, 8, 9, 17, 31)] == [
        8, 8, 16, 32, 32]
    assert e.num_prefill_buckets == 3
    with pytest.raises(FriendlyError, match="cache_len"):
        e.submit(np.ones(32, np.int32), 1)
    with pytest.raises(FriendlyError, match="exceeds"):
        e.submit(np.ones(30, np.int32), 5)
    with pytest.raises(FriendlyError, match=r"\[0, 64\)"):
        e.submit(np.asarray([1, 64]), 2)
    with pytest.raises(FriendlyError, match="non-empty"):
        e.submit(np.zeros(0, np.int32), 2)
    e.submit(np.ones(3, np.int32), 2)
    with pytest.raises(FriendlyError, match="queue is full"):
        e.submit(np.ones(3, np.int32), 2)
    assert e.metrics.rejected == 1 and e.queue_depth == 1


def test_deadlines_expire_and_max_ticks_stalls(lm):
    _, _, tg, tv, ids = lm
    e = ServeEngine(tg, tv, slots=1, cache_len=32, decode_block=1,
                    device="cpu")
    a = e.submit(ids[0, :4], 20, deadline_ticks=3)
    b = e.submit(ids[0, :4], 2, deadline_ticks=2)  # waits behind a
    res = e.run()
    assert res[a].status == "expired" and res[b].status == "expired"
    assert res[a].generated > 0 and res[b].generated == 0
    assert not e.busy and e.pool.free_count == 1
    e.submit(ids[0, :4], 20)
    with pytest.raises(FriendlyError, match="max_ticks") as err:
        e.run(max_ticks=2)
    (stalled,) = err.value.results.values()
    assert stalled.status == "stalled" and not e.busy


def test_slot_pool_leases_writes_and_frees(lm):
    _, _, tg, tv, _ = lm
    pool = SlotCachePool(tg, tv, 3, 16, device="cpu")
    assert [pool.lease() for _ in range(3)] == [0, 1, 2]  # lowest first
    with pytest.raises(FriendlyError, match="no free"):
        pool.lease()
    pool.free(1)
    with pytest.raises(FriendlyError, match="not leased"):
        pool.free(1)
    assert pool.lease() == 1
    prefill = {n: tuple(torch.full((1, 8, 2, 16), float(i + 1),
                                   dtype=torch.bfloat16) for i in range(2))
               for n in pool.buffers}
    pool.write_prefill(2, prefill, 5)
    k, v = pool.buffers["block0"]
    assert (k[2, :5] == 1).all() and (v[2, :5] == 2).all()
    assert not k[2, 5:].any() and not k[:2].any()
    assert int(pool.positions[2]) == 5 and bool(pool.live[2])
    pool.free(2)
    assert int(pool.positions[2]) == 0 and not bool(pool.live[2])
    # 2 blocks x (K, V) x 3 slots x 16 x 2 heads x 16 x bf16, plus state
    assert pool.device_bytes_per_device() == 2 * 2 * 3 * 16 * 2 * 16 * 2 \
        + 3 * 4 + 3


def test_metrics_keys_are_the_jax_names():
    """Every key the port reports exists under the same name in the JAX
    ServeMetrics, and per-token latency divides by tokens emitted."""
    port = ServeMetrics("m", slots=2, decode_block=8)
    port.record_decode(2, 0.013, tokens_emitted=13, block=8, live_kv=40,
                       cache_len=32)
    port.sample_tick(1, 2, 0.02, tokens_emitted=13)
    d = port.to_dict()
    assert set(d) <= set(JaxServeMetrics("m", 2).to_dict())
    assert d["per_token_ms"] == 1.0 and d["decode_blocks"] == {"8": 1}
    assert d["decode_flop_utilization"] == round(40 / (13 * 32), 4)
    assert d["tokens_per_tick"] == 13.0


def test_run_demo_on_cpu():
    out = run_demo(device="cpu", n_requests=6, max_new_tokens=6,
                   decode_block=4)
    assert out["completed"] == 6 and out["tokens_generated"] == 36
    assert out["device"] == "cpu"
    assert sum(out["prefill_buckets"].values()) == 6
    assert set(out["decode_blocks"]) <= {"1", "2", "4"}


# -- (g) the device rule -----------------------------------------------------


def test_cuda_is_the_default_and_raises_without_a_gpu(lm, monkeypatch):
    _, jv, tg, tv, _ = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(FriendlyError, match="no CUDA device"):
            env.default_device(device)
    assert env.default_device("cpu") == torch.device("cpu")
    with pytest.raises(FriendlyError, match="device must be"):
        env.default_device("meta")
    calls = (
        lambda: ServeEngine(tg, tv, slots=1, cache_len=32),
        lambda: generate(tg, tv, np.ones((1, 3), np.int32), 2),
        lambda: init_variables(tg, 0),
        lambda: load_flax_variables(tg, jv),
        lambda: run_demo(n_requests=1),
        lambda: env.card_info(),
    )
    for call in calls:
        with pytest.raises(FriendlyError, match="no CUDA device"):
            call()


# -- (f) the port imports no JAX ---------------------------------------------


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import sys\n"
        "import mmlspark_tpu_torch, mmlspark_tpu_torch.models, "
        "mmlspark_tpu_torch.serve, mmlspark_tpu_torch.ops.kernel_build, "
        "mmlspark_tpu_torch.ops.flash_attention, "
        "mmlspark_tpu_torch.ops.quantize, mmlspark_tpu_torch.core.faults, "
        "mmlspark_tpu_torch.serve.paging, mmlspark_tpu_torch.train, "
        "mmlspark_tpu_torch.data, mmlspark_tpu_torch.core.telemetry, "
        "mmlspark_tpu_torch.core.integrity, mmlspark_tpu_torch.models.mlp, "
        "mmlspark_tpu_torch.ops.tree_checksum, "
        "mmlspark_tpu_torch.train.resilience, "
        "mmlspark_tpu_torch.train.demo, mmlspark_tpu_torch.stages, "
        "mmlspark_tpu_torch.core.serialize, mmlspark_tpu_torch.core.stage, "
        "mmlspark_tpu_torch.core.schema, mmlspark_tpu_torch.core.params, "
        "mmlspark_tpu_torch.core.logging_utils, "
        "mmlspark_tpu_torch.models.resnet, mmlspark_tpu_torch.models.bilstm, "
        "mmlspark_tpu_torch.parallel, mmlspark_tpu_torch.parallel.expert, "
        "mmlspark_tpu_torch.models.moe, mmlspark_tpu_torch.core.config, "
        "mmlspark_tpu_torch.ops.native_build, mmlspark_tpu_torch.ops.decode, "
        "mmlspark_tpu_torch.data.readers, mmlspark_tpu_torch.data.sample_data, "
        "mmlspark_tpu_torch.ops.image_ops, mmlspark_tpu_torch.stages.image, "
        "mmlspark_tpu_torch.models.zoo, mmlspark_tpu_torch.data.ctf, "
        "mmlspark_tpu_torch.core.perf, mmlspark_tpu_torch.serve.supervisor, "
        "mmlspark_tpu_torch.serve.fleet, mmlspark_tpu_torch.serve.demo, "
        "mmlspark_tpu_torch.utils.profiling, "
        "mmlspark_tpu_torch.core.metrics_contracts, "
        "mmlspark_tpu_torch.models.onnx_import, "
        "mmlspark_tpu_torch.models.onnx_export, "
        "mmlspark_tpu_torch.serve.multimodel, "
        "mmlspark_tpu_torch.core.tracehub, "
        "mmlspark_tpu_torch.utils.text, mmlspark_tpu_torch.testing.datagen, "
        "mmlspark_tpu_torch.testing.benchmark_metrics, "
        "mmlspark_tpu_torch.testing.tree_parity, "
        "mmlspark_tpu_torch.stages.value_indexer, "
        "mmlspark_tpu_torch.stages.prep, mmlspark_tpu_torch.stages.featurize, "
        "mmlspark_tpu_torch.stages.trees, mmlspark_tpu_torch.stages.classical, "
        "mmlspark_tpu_torch.stages.train_classifier, "
        "mmlspark_tpu_torch.stages.train_regressor, "
        "mmlspark_tpu_torch.stages.eval_metrics, "
        "mmlspark_tpu_torch.stages.find_best, "
        "mmlspark_tpu_torch.stages.ensemble, mmlspark_tpu_torch.stages.text, "
        "mmlspark_tpu_torch.stages.word2vec, "
        "mmlspark_tpu_torch.parallel.mesh, "
        "mmlspark_tpu_torch.parallel.sharding, "
        "mmlspark_tpu_torch.parallel.context_parallel, "
        "mmlspark_tpu_torch.parallel.pipeline, "
        "mmlspark_tpu_torch.parallel.sequence_rnn, "
        "mmlspark_tpu_torch.models.pipelined, "
        "mmlspark_tpu_torch.train.distributed, "
        "mmlspark_tpu_torch.__main__, mmlspark_tpu_torch.entry, "
        "mmlspark_tpu_torch.testing.rank_pool, "
        "mmlspark_tpu_torch.tools.docgen, mmlspark_tpu_torch.tools.common, "
        "mmlspark_tpu_torch.tools.timing, "
        "mmlspark_tpu_torch.tools.flash_evidence, "
        "mmlspark_tpu_torch.tools.decode_evidence, "
        "mmlspark_tpu_torch.tools.profile_resnet50, "
        "mmlspark_tpu_torch.tools.feed_overhead, "
        "mmlspark_tpu_torch.tools.make_notebooks, "
        "mmlspark_tpu_torch.examples, mmlspark_tpu_torch.examples.harness\n"
        "import importlib, pkgutil, mmlspark_tpu_torch.examples as ex\n"
        "names = sorted(m.name for m in pkgutil.iter_modules(ex.__path__) "
        "if m.name.startswith('e'))\n"
        "assert len(names) == 12, names\n"
        "for name in names:\n"
        "    importlib.import_module('mmlspark_tpu_torch.examples.' + name)\n"
        "from mmlspark_tpu_torch.models import build_model\n"
        "for name in ('resnet20_cifar10', 'resnet50', 'bilstm_tagger', "
        "'transformer_lm_moe', 'skipgram'):\n"
        "    build_model(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'optax', 'mmlspark_tpu') or m.startswith(('jax.', 'flax.', "
        "'optax.', 'mmlspark_tpu.')))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_name_no_jax_import():
    files = sorted((REPO / "mmlspark_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for name in ("train/resilience.py", "train/demo.py", "models/mlp.py",
                 "ops/tree_checksum.py", "core/integrity.py",
                 "core/params.py", "core/schema.py", "core/stage.py",
                 "core/serialize.py", "core/logging_utils.py",
                 "models/resnet.py", "models/bilstm.py",
                 "stages/dnn_model.py", "stages/dnn_learner.py",
                 "stages/__init__.py", "parallel/__init__.py",
                 "parallel/expert.py", "models/moe.py", "core/config.py",
                 "ops/native_build.py", "ops/decode.py", "data/readers.py",
                 "data/sample_data.py", "ops/image_ops.py",
                 "stages/image.py", "models/zoo.py", "data/ctf.py",
                 "core/perf.py", "serve/supervisor.py", "serve/fleet.py",
                 "utils/profiling.py", "core/metrics_contracts.py",
                 "models/onnx_import.py", "models/onnx_export.py",
                 "serve/multimodel.py", "core/tracehub.py",
                 "utils/text.py", "testing/datagen.py",
                 "testing/benchmark_metrics.py", "testing/tree_parity.py",
                 "stages/value_indexer.py", "stages/prep.py",
                 "stages/featurize.py", "stages/trees.py",
                 "stages/classical.py", "stages/train_classifier.py",
                 "stages/train_regressor.py", "stages/eval_metrics.py",
                 "stages/find_best.py", "stages/ensemble.py",
                 "stages/text.py", "stages/word2vec.py",
                 "parallel/mesh.py", "parallel/sharding.py",
                 "parallel/context_parallel.py", "__main__.py", "entry.py",
                 "testing/rank_pool.py", "parallel/pipeline.py",
                 "parallel/sequence_rnn.py", "models/pipelined.py",
                 "train/distributed.py", "tools/__init__.py",
                 "tools/docgen.py", "tools/common.py", "tools/timing.py",
                 "tools/flash_evidence.py", "tools/decode_evidence.py",
                 "tools/profile_resnet50.py", "tools/feed_overhead.py",
                 "tools/make_notebooks.py", "examples/__init__.py",
                 "examples/harness.py"):
        assert REPO / "mmlspark_tpu_torch" / name in files, name
    examples = [f for f in files if f.parent.name == "examples"
                and f.name.startswith("e")]
    assert len(examples) == 12, examples
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "flax", "optax", "mmlspark_tpu"), (
                path, mod)


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """No card: a non-zero exit and no result line."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch\n"
         "torch.cuda.is_available = lambda: False\n"
         "sys.argv = ['chip_smoke.py']\n"
         "import runpy\n"
         "runpy.run_path('chip_smoke.py', run_name='__main__')\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
