"""The port's evidence tools (``mmlspark_tpu_torch/tools/``) on the CPU:
each tool's ``run(device="cpu")`` at tiny sizes gives a record its own
``check_record`` accepts; ``check_record`` refuses records over their
tolerance, with non-monotone timings or a speedup under 1.5; a failing
record is never written; no default output names a committed file; and
without a card ``evidence`` raises naming the missing CUDA device (the
port's counterpart of ``tests/test_cli.py``'s probe gate). On the card
the tools run from ``chip_smoke.py``'s ``evidence`` phase."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from mmlspark_tpu_torch.__main__ import main
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.tools import (
    common,
    decode_evidence,
    feed_overhead,
    flash_evidence,
    profile_resnet50,
)

REPO = Path(__file__).resolve().parents[1]
TOOLS = {"flash": flash_evidence, "decode": decode_evidence,
         "profile": profile_resnet50, "feed": feed_overhead}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(which: str, tmp_path) -> dict:
    if which == "flash":
        return flash_evidence.run(
            "cpu", b=1, s=64, h=2, d=16, window=16, kv_heads=1, long_s=128,
            long_window=32, long_heads=(0, 1))
    if which == "decode":
        return decode_evidence.run(
            "cpu", vocab=64, d_model=32, heads=2, depth=2, batch=2,
            prompt=8, n_short=8, n_long=16)
    if which == "profile":
        return profile_resnet50.run("cpu", size=32, batch=1, iters=1,
                                    out=str(tmp_path / "trace"))
    return feed_overhead.run("cpu", rows=32, batch=8, trials=1)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evidence")
    return {which: _tiny(which, tmp) for which in TOOLS}


@pytest.mark.parametrize("which", sorted(TOOLS))
def test_cpu_run_meets_its_contract(records, which):
    record = records[which]
    assert TOOLS[which].check_record(record) == []
    assert record["device"] == {"platform": "cpu", "kind": "cpu",
                                "count": 1, "card": None}
    json.dumps(record)  # a record is plain JSON


def test_flash_numerics_cover_every_leg(records):
    num = records["flash"]["numerics"]
    assert set(num) == {"full", "causal", "window_gqa", "long_context"}
    assert num["window_gqa"]["window"] == 16
    assert num["window_gqa"]["kv_heads"] == 1
    assert {"causal", "window32"} <= set(num["long_context"])
    for leg in ("causal", "window32"):
        assert {f"{key}_scaled_err" for key in ("fwd", "lse", "dq", "dk",
                                                "dv")} <= set(
            num["long_context"][leg])
    # off the card the flash path IS the plain version: nothing is timed
    assert records["flash"]["timing"] == "not measured"


def test_flash_refuses_an_error_over_tolerance(records):
    for leg, key in (("causal", "dk"), ("window_gqa", "dv"),
                     ("full", "fwd")):
        bad = copy.deepcopy(records["flash"])
        bad["numerics"][leg][f"{key}_scaled_err"] = 2 * flash_evidence.TOL
        assert any(leg in p and key in p
                   for p in flash_evidence.check_record(bad))
    bad = copy.deepcopy(records["flash"])
    bad["numerics"]["long_context"]["window32"]["lse_scaled_err"] = 1e-2
    assert flash_evidence.check_record(bad)
    for leg, key in (("causal", "dq"), ("window32", "dk"), ("causal", "dv")):
        bad = copy.deepcopy(records["flash"])
        bad["numerics"]["long_context"][leg][f"{key}_scaled_err"] = \
            2 * flash_evidence.TOL
        assert any(f"long context {leg} {key}" in p
                   for p in flash_evidence.check_record(bad))
    bad = copy.deepcopy(records["flash"])
    bad["timing"] = {"full": {"fwd": {"ms": 1.0}}}
    assert flash_evidence.check_record(bad)  # a CPU record times nothing


def test_fwd_bwd_bound_is_the_functions_work():
    """The forward+backward bound counts seven matrix products a live
    pair (q.k and p.v forward; q.k, dO.v, dV, dK and dQ backward), not
    the nine the three kernels do between them, and reads q, k, v and
    dO once."""
    from mmlspark_tpu_torch.tools.timing import (
        attention_fwd_bwd_work,
        attention_work,
        live_pairs,
    )

    for s, causal, window in ((64, False, None), (64, True, None),
                              (64, True, 16), (8, True, 100)):
        brute = sum(min(i + 1, window or s) if causal else s
                    for i in range(s))
        assert live_pairs(s, causal, window) == brute
    args = (2, 64, 4, 2, 16, True, 16)
    kernels = attention_work(*args)
    n_bytes, n_flops = attention_fwd_bwd_work(*args)
    assert 9 * n_flops == 7 * sum(f for _, f in kernels.values())
    assert 2 * n_flops == 7 * kernels["flash_attention_fwd"][1]
    qo, kv, rows = 2 * 64 * 4 * 16 * 2, 2 * 64 * 2 * 16 * 2, 2 * 4 * 64 * 4
    assert n_bytes == 4 * qo + 4 * kv + 2 * rows
    assert n_bytes < sum(b for b, _ in kernels.values())
    timing = flash_evidence.work(*args)
    assert timing == {"fwd": kernels["flash_attention_fwd"],
                      "fwd_bwd": (n_bytes, n_flops)}


def _card_decode(record: dict) -> dict:
    """The CPU decode record dressed as a card's that meets the
    contract."""
    rec = copy.deepcopy(record)
    rec["device"] = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                     "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    steps = rec["model"]["depth"] * (rec["lengths"]["n_short"] - 1)
    rec["paths"]["kv_cache"]["launch_counts"] = {"launches": steps}
    rec["timing"] = {
        "kv_cache": {"t_n64_s": 0.10, "t_n256_s": 0.20,
                     "per_token_ms": 0.52, "noise_fallback": False},
        "recompute": {"t_n64_s": 0.30, "t_n256_s": 0.90,
                      "per_token_ms": 3.1, "noise_fallback": False},
        "kv_vs_recompute_speedup": 3.1 / 0.52,
    }
    return rec


def test_decode_refuses_what_the_jax_contract_refuses(records):
    good = _card_decode(records["decode"])
    assert decode_evidence.check_record(good) == []
    cases = {
        "non-monotone": lambda r: r["timing"]["kv_cache"].update(
            t_n256_s=0.05),
        "noise fallback": lambda r: r["timing"]["recompute"].update(
            noise_fallback=True),
        "speedup": lambda r: r["timing"].update(kv_vs_recompute_speedup=1.4),
        "agreement": lambda r: r["numerics"].update(
            greedy_token_agreement=0.94),
        "prefill": lambda r: r["numerics"].update(
            prefill_logits_scaled_err=0.02),
        "kernel": lambda r: r["paths"]["kv_cache"].update(launch_counts={}),
    }
    for name, spoil in cases.items():
        bad = copy.deepcopy(good)
        spoil(bad)
        assert decode_evidence.check_record(bad), name


def test_decode_proof_runs_on_given_weights(records, monkeypatch):
    """``decode_evidence.run(variables=...)``: the proof over weights the
    caller gives — here the JAX tool's kind, flax's ``init`` bridged by
    ``load_flax_variables`` — and the record names them; both streams are
    generated from exactly those weights."""
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models import build_model as jax_build_model
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.models.bridge import load_flax_variables

    shape = dict(vocab_size=64, d_model=32, heads=2, depth=2, max_len=24,
                 attn_impl="dense")
    flax_vars = jax_build_model("transformer_lm", **shape).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    variables = load_flax_variables(build_model("transformer_lm", **shape),
                                    flax_vars, device="cpu")
    seen = []
    generate = decode_evidence.generate

    def spy(graph, v, prompt, n, **kw):
        seen.append(v)
        return generate(graph, v, prompt, n, **kw)

    monkeypatch.setattr(decode_evidence, "generate", spy)
    rec = decode_evidence.run(
        "cpu", vocab=64, d_model=32, heads=2, depth=2, batch=2, prompt=8,
        n_short=8, n_long=16, variables=variables)
    assert rec["weights"] == "given"
    assert records["decode"]["weights"] == "init_variables seed 0"
    assert len(seen) == 2 and all(v is variables for v in seen)
    num = rec["numerics"]
    assert num["prefill_logits_scaled_err"] <= decode_evidence.PREFILL_TOL
    assert num["n_tokens_compared"] == 2 * 16


def test_feed_and_profile_refuse_broken_records(records):
    bad = copy.deepcopy(records["feed"])
    bad["scores_max_abs_diff_vs_model_only"] = 0.5
    assert feed_overhead.check_record(bad)
    bad = copy.deepcopy(records["feed"])
    del bad["stage_images_per_sec_per_depth"]["8"]
    assert feed_overhead.check_record(bad)
    bad = copy.deepcopy(records["profile"])
    bad["replay"]["top"] = []
    assert profile_resnet50.check_record(bad)
    bad = copy.deepcopy(records["profile"])
    bad["batchnorm"]["share"] = None
    assert profile_resnet50.check_record(bad)


def test_a_failing_record_is_never_written(records, tmp_path, monkeypatch,
                                           capsys):
    out = tmp_path / "record.json"
    assert common.finish({"x": 1}, ["a violation"], out) == 3
    assert not out.exists()
    bad = copy.deepcopy(records["decode"])
    bad["numerics"]["greedy_token_agreement"] = 0.5
    monkeypatch.setattr(decode_evidence, "run", lambda dev, seed: bad)
    assert decode_evidence.main(["--device", "cpu", "--out", str(out)]) == 3
    assert not out.exists()
    assert "greedy token agreement 0.5" in capsys.readouterr().err
    monkeypatch.setattr(decode_evidence, "run",
                        lambda dev, seed: records["decode"])
    assert decode_evidence.main(["--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text()) == json.loads(
        json.dumps(records["decode"]))


def test_no_default_output_names_a_committed_file():
    ignored = {".git"} | {
        line.strip().rstrip("/")
        for line in (REPO / ".gitignore").read_text().splitlines()
        if line.strip().endswith("/")}
    committed = {p.relative_to(REPO) for p in REPO.rglob("*") if p.is_file()
                 and not ignored & set(p.relative_to(REPO).parts)}
    # the JAX tools' artifacts, committed or not
    taken = {p.name for p in committed} | {"DECODE_TPU_EVIDENCE.json"}
    for which, tool in TOOLS.items():
        for dev in ("cpu", "cuda"):
            path = (tool.OUT_DIR / "summary.json" if which == "profile"
                    else common.default_out(tool.OUT_TEMPLATE,
                                            torch.device(dev)))
            assert REPO / "build" in path.parents, path
            assert path.relative_to(REPO) not in committed, path
            assert which == "profile" or path.name not in taken, path


@pytest.mark.parametrize("which", sorted(TOOLS))
def test_evidence_without_a_card_names_the_missing_device(which):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(FriendlyError, match="no CUDA device"):
        main(["evidence", which])


def test_evidence_through_the_launcher_on_the_cpu(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(feed_overhead, "ROWS", 16)
    monkeypatch.setattr(feed_overhead, "BATCH", 8)
    monkeypatch.setattr(feed_overhead, "TRIALS", 1)
    out = tmp_path / "feed.json"
    assert main(["--cpu-mesh", "1", "evidence", "feed", "--out",
                 str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(out.read_text())
    assert line["rows"] == 16 and line["device"]["platform"] == "cpu"
