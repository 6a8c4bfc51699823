"""The port's program ladder on the CPU: ``testing/compile_guard.py``
(``compile_guard``, ``serve_compile_guard``, ``ProgramCountingGraph``),
``core/telemetry.py``'s ``RetraceWatchdog`` and the engine's
``decode_compile_count``/``prefill_compile_count``/
``resume_compile_count``, mirroring the JAX package's
``tests/test_serve.py::test_compile_guard_raises_on_violation``,
``::test_mixed_length_soak_pins_compile_counts`` and
``tests/test_telemetry.py::test_retrace_watchdog_fires_once_per_new_shape``,
and the counts against the JAX engine's on one schedule.

On the CPU a program runs eagerly and is counted by its static
signature, as a CUDA graph is keyed on the card. The model is the JAX
package's overfit periodic LM bridged into the port (wide greedy
margins), so streams compare exactly.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from mmlspark_tpu.models import build_model as jax_build_model
from mmlspark_tpu.serve import ServeEngine as JaxServeEngine
from mmlspark_tpu.testing.datagen import overfit_periodic_lm
from mmlspark_tpu_torch.core.telemetry import (
    FlightRecorder,
    MetricRegistry,
    RetraceWatchdog,
    watch_retrace,
)
from mmlspark_tpu_torch.models import build_model, generate
from mmlspark_tpu_torch.models import load_flax_variables
from mmlspark_tpu_torch.serve import ServeEngine
from mmlspark_tpu_torch.testing import (
    ProgramCountingGraph,
    compile_guard,
    program_count,
    serve_compile_guard,
)

TINY = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=32)


@pytest.fixture(scope="module")
def lm():
    """(jax graph, jax variables, port graph, port variables, ids)."""
    jg = jax_build_model("transformer_lm", **TINY)
    jv, ids = overfit_periodic_lm(jg, steps=30, seq=16, period=4)
    tg = build_model("transformer_lm", **TINY)
    tv = load_flax_variables(tg, jv, device="cpu")
    return jg, jv, tg, tv, np.array(ids)


def _generate(tg, tv, prompt, n):
    return generate(tg, tv, np.asarray(prompt, np.int32)[None], n,
                    device="cpu")[0].numpy()


def test_compile_guard_raises_on_violation():
    calls = {"n": 0}

    def count():
        return calls["n"]

    with pytest.raises(AssertionError, match="at most"):
        with compile_guard(count, max_programs=0, label="demo"):
            calls["n"] += 1
    with pytest.raises(AssertionError, match="at least"):
        with compile_guard(count, max_programs=3, min_programs=1,
                           label="demo"):
            pass
    with pytest.raises(ValueError, match="max_programs"):
        with compile_guard(count, max_programs=0, min_programs=1):
            pass


def test_retrace_watchdog_fires_once_per_new_shape(caplog):
    reg = MetricRegistry()
    rec = FlightRecorder()
    fn = ProgramCountingGraph(lambda x: torch.sum(x * 2))
    dog = RetraceWatchdog(fn, "unit", registry=reg, recorder=rec)

    with caplog.at_level(logging.INFO,
                         logger="mmlspark_tpu_torch.telemetry"):
        dog(torch.zeros(4))  # first program: INFO
        assert dog.compilations == 1 and dog.retraces == 0
        dog(torch.ones(4))  # same signature: silent
        assert dog.compilations == 1
        dog(torch.zeros(8))  # NEW shape: the retrace
    assert dog.compilations == 2 and dog.retraces == 1
    warnings = [r for r in caplog.records
                if r.levelno == logging.WARNING and "retrace" in r.message]
    assert len(warnings) == 1
    assert "float32[8]" in warnings[0].message  # triggering signature
    assert reg.counter("retrace.unit").value == 2
    retrace_evs = [e for e in rec.events() if e["name"] == "retrace"]
    assert len(retrace_evs) == 2
    assert "float32[8]" in retrace_evs[-1]["attrs"]["signature"]
    # compile_guard's counting contract passes through the wrapper
    assert dog._cache_size() == 2 == program_count(dog)


def test_program_key_is_the_static_signature():
    """Shapes, dtypes, containers and non-tensor values make the key;
    tensor values do not. The eager CPU call returns the real result."""
    prog = ProgramCountingGraph(lambda x, extra, t: x.sum() * t)
    assert prog(torch.ones(3), {"a": torch.zeros(2)}, 2).item() == 6.0
    assert prog(torch.full((3,), 2.0), {"a": torch.ones(2)}, 2).item() \
        == 12.0
    assert prog._cache_size() == 1
    prog(torch.ones(3), {"a": torch.zeros(2)}, 3)  # a static value
    prog(torch.ones(3, dtype=torch.float64), {"a": torch.zeros(2)}, 3)
    prog(torch.ones(3), {"b": torch.zeros(2)}, 3)  # another structure
    assert prog._cache_size() == 4
    dog = watch_retrace(prog, "fn")
    assert dog.expected_programs == 1 and dog._cache_size() == 4


def test_mixed_length_soak_pins_compile_counts(lm):
    """Soak with mixed-length joiners: every prompt length in [1, 12]
    flows through 2 slots. The decode block makes one program per ladder
    size run and bucketed prefill at most one per power-of-two bucket —
    not one per distinct length — while every request still matches
    single-request ``generate()`` token for token."""
    _, _, tg, tv, ids = lm
    lengths = [4, 1, 12, 7, 8, 3, 10, 2, 5, 9]  # raggedy on purpose
    prompts = [np.asarray(ids[0, :n]) for n in lengths]
    engine = ServeEngine(tg, tv, slots=2, cache_len=32, max_queue=16,
                         device="cpu")
    assert engine.num_prefill_buckets == 3  # 8, 16, 32
    rids = []
    with serve_compile_guard(engine, min_decode=1, min_prefill=1):
        results = {}
        for i, p in enumerate(prompts):  # two joiners per tick
            rids.append(engine.submit(p, max_new_tokens=4))
            if i % 2:
                results.update({r.id: r for r in engine.step()})
        results.update(engine.run())
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(results[rid].tokens,
                                      _generate(tg, tv, p, 4))
    # the 10 distinct lengths landed in at most 2 buckets (8 and 16)
    assert engine.prefill_compile_count <= 2
    buckets = engine.metrics.prefill_buckets
    assert set(buckets) <= {"8", "16"}
    assert sum(buckets.values()) == len(prompts)
    assert engine.decode_compile_count == len(engine.metrics.decode_blocks)
    assert engine.resume_compile_count == 0
    d = engine.metrics.to_dict()
    assert 0.0 < d["decode_flop_utilization"] < 1.0
    # the watchdog saw every program, within its budget
    assert engine.registry.counter("retrace.serve.prefill").value \
        == engine.prefill_compile_count
    assert engine._decode.retraces == 0


def _run(engine, prompts, budgets):
    """Three requests up front, two steps, then the rest join mid-run."""
    results, rids = {}, []
    for p, n in zip(prompts[:3], budgets[:3]):
        rids.append(engine.submit(p, max_new_tokens=n))
    for _ in range(2):
        results.update({r.id: r for r in engine.step()})
    for p, n in zip(prompts[3:], budgets[3:]):
        rids.append(engine.submit(p, max_new_tokens=n))
    while engine.busy:
        results.update({r.id: r for r in engine.step()})
    return [results[r] for r in rids]


def test_program_counts_equal_the_jax_engine(lm):
    """One schedule of ragged prompts sharing a prefix (prefixes of the
    periodic row, so later requests hit the prefix cache at several
    ``keep`` values) through the JAX paged engine with the prefix cache
    and the port's: equal token streams, and equal decode, prefill and
    resume program counts."""
    jg, jv, tg, tv, ids = lm
    prompts = [ids[0, :n] for n in (12, 14, 9, 13)]
    budgets = [5, 7, 3, 2]
    kw = dict(slots=2, cache_len=32, max_queue=8, decode_block=4,
              paged=True, prefix_cache=True)
    jax_engine = JaxServeEngine(jg, jv, **kw)
    jax_res = _run(jax_engine, prompts, budgets)
    port = ServeEngine(tg, tv, device="cpu", **kw)
    port_res = _run(port, prompts, budgets)
    for jr, pr in zip(jax_res, port_res):
        assert pr.status == jr.status == "completed"
        np.testing.assert_array_equal(pr.tokens, np.asarray(jr.tokens))
    assert port.pool.prefix_hits >= 3
    counts = [(e.decode_compile_count, e.prefill_compile_count,
               e.resume_compile_count) for e in (jax_engine, port)]
    assert counts[0] == counts[1]
    assert counts[1][2] >= 1


def test_resume_at_two_keeps_in_one_bucket_is_one_program(lm):
    """Two prefix hits whose remainders share a bucket but whose ``keep``
    positions differ: the resume program takes the position as a 0-d
    device tensor, so the second hit makes no new program."""
    _, _, tg, tv, ids = lm
    engine = ServeEngine(tg, tv, slots=1, cache_len=32, decode_block=4,
                         paged=True, prefix_cache=True, device="cpu")
    row = ids[0]
    engine.submit(row[:16], 2)
    engine.run()
    assert engine.resume_compile_count == 0
    for n in (12, 15):  # keep 11 then 14, remainder bucket 8 both times
        rid = engine.submit(row[:n], 3)
        res = engine.run()[rid]
        np.testing.assert_array_equal(res.tokens,
                                      _generate(tg, tv, row[:n], 3))
        assert engine.resume_compile_count == 1
    assert engine.pool.prefix_hits == 2
    assert engine.metrics.prefill_buckets == {"16": 1, "8": 2}
