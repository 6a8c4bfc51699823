"""``mml-tpu-torch`` — the launcher of the PyTorch/CUDA port, the port of
``mmlspark_tpu/__main__.py`` (the ``mml-tpu`` CLI, the ``mml-exec``
analog: run user code or framework tooling in a configured environment).

Subcommands, flags and defaults are the JAX CLI's:
  run <script.py> [args...]   run a user script (the spark-submit role)
  serve                       continuous-batching serve demo (one JSON line)
  train                       fault-tolerant training demo (one JSON line)
  config                      print the resolved app config namespace
  env                         print the device/topology view
  zoo list|download <name>    model-zoo operations
  evidence flash|profile|decode|feed
                              an on-card proof over the port
                              (``mmlspark_tpu_torch/tools/``, the
                              counterparts of the JAX package's
                              ``tools/*`` scripts): one JSON record
  docgen [out_dir]            the API docs from the port's registries
                              (.rst + html; default build/docs_torch/api)
  bench                       the JAX package's ``bench.py``, which runs
                              JAX: over the port it waits for the port's
                              first benchmark (ROADMAP.md Queue 1 item 20)
                              and raises

Everything runs on the card unless ``--cpu-mesh`` is given, which here
means "on the CPU": ``--cpu-mesh 1`` runs the plain PyTorch path on the
host. JAX makes N virtual CPU devices in one process; PyTorch has no
such device, so ``--cpu-mesh N`` (N > 1) starts N gloo rank processes on
the host for ``run``, ``serve``, ``train`` and ``env`` (each under a
time limit of ``RANK_TIMEOUT_S`` seconds), and rank 0's output is the
command's; ``serve`` and ``train`` there run over ``data=N`` unless
``--mesh`` says otherwise, as the JAX engine and trainer span every
device. ``serve --mesh`` and ``train --mesh`` without ranks from a
launcher start a one-process group of their own (NCCL on the card, gloo
on the CPU); ``serve --mesh AXES`` runs the engine's mesh mode (slots
over ``data``, the model split over ``model``). Without a GPU and
without ``--cpu-mesh`` the commands raise rather than run on the
host.

Usage: ``python -m mmlspark_tpu_torch <cmd> ...`` or the
``mml-tpu-torch`` console script (pyproject [project.scripts]).
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys

from mmlspark_tpu_torch.core.exceptions import FriendlyError

#: set in the rank processes ``--cpu-mesh N`` starts
_RANK_ENV = "MML_TPU_TORCH_CPU_RANK"
#: the commands ``--cpu-mesh N`` runs on N ranks
_RANK_COMMANDS = ("run", "serve", "train", "env")
#: the time limit of every rank process ``--cpu-mesh N`` starts
RANK_TIMEOUT_S = 900.0
_BENCH = ("ROADMAP.md Queue 1 item 20: bench over the port comes with the "
          "port's first benchmark PR")
#: the evidence tools under ``mmlspark_tpu_torch/tools/``, by subcommand
EVIDENCE_TOOLS = {"flash": "flash_evidence", "profile": "profile_resnet50",
                   "decode": "decode_evidence", "feed": "feed_overhead"}


def _apply_backend(args):
    """The device the command runs on: the card, or the CPU with
    ``--cpu-mesh N`` (then a ``run`` script sees no card either)."""
    if not args.cpu_mesh:
        return None
    if args.cpu_mesh < 1:
        raise FriendlyError(
            f"--cpu-mesh {args.cpu_mesh}: the CPU mesh needs at least one "
            "rank")
    return "cpu"


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_ranks(argv: list[str], n: int) -> int:
    """Run this command line on ``n`` gloo rank processes of the host:
    rank 0's standard output becomes this process's, the others' is
    dropped; every rank has the time limit, and all are stopped when one
    outlives it. Returns the ranks' worst exit code."""
    import subprocess
    import time

    timeout = RANK_TIMEOUT_S
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(n),
                   RANK=str(rank), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1", **{_RANK_ENV: "1"},
                   PYTHONPATH=os.pathsep.join(
                       [root, *filter(None,
                                      [os.environ.get("PYTHONPATH")])]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mmlspark_tpu_torch", *argv], env=env,
            stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL))
    deadline = time.monotonic() + timeout
    try:
        out, _ = procs[0].communicate(timeout=timeout)
        codes = [procs[0].returncode]
        for proc in procs[1:]:
            codes.append(proc.wait(timeout=max(deadline - time.monotonic(),
                                               1.0)))
    except subprocess.TimeoutExpired:
        raise FriendlyError(
            f"--cpu-mesh {n}: a rank outlived the {timeout:g} s limit; "
            "every rank was stopped"
        ) from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    sys.stdout.write(out.decode())
    sys.stdout.flush()
    return max(codes, key=abs)


class _Group:
    """The process group a command trains over: the launcher's ranks
    (``RANK``/``WORLD_SIZE`` in the environment), or one process of its
    own; a group this command started ends with it."""

    def __init__(self, device):
        self.device = device
        self.owned = False

    def __enter__(self):
        import torch.distributed as dist

        from mmlspark_tpu_torch.parallel.mesh import initialize_distributed

        if dist.is_available() and dist.is_initialized():
            return self
        if "RANK" in os.environ:
            initialize_distributed(device=self.device)
        else:
            initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                   device=self.device)
        self.owned = True
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        if self.owned:
            dist.destroy_process_group()
        return False

    @property
    def rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank()


def cmd_run(args) -> int:
    from mmlspark_tpu_torch.core.env import process_default

    device = _apply_backend(args) or "cuda"
    if device == "cpu":
        # the card becomes unavailable and the script's default device is
        # the CPU, as JAX_PLATFORMS=cpu hides the TPU from a JAX script
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.argv = [args.script, *args.script_args]
    with process_default(device):
        if os.environ.get(_RANK_ENV):
            # a --cpu-mesh rank: the script starts in the group
            with _Group("cpu"):
                runpy.run_path(args.script, run_name="__main__")
            return 0
        runpy.run_path(args.script, run_name="__main__")
    return 0


def cmd_bench(args) -> int:
    raise FriendlyError(
        f"bench runs the JAX package's bench.py; it waits for {_BENCH}"
    )


def cmd_serve(args) -> int:
    """Continuous-batching serve demo: synthetic traffic through a
    ``ServeEngine`` slot pool, ONE JSON metrics line out."""
    device = _apply_backend(args)
    from mmlspark_tpu_torch.serve.demo import run_demo

    ranked = bool(os.environ.get(_RANK_ENV))
    mesh = args.mesh or (f"data={args.cpu_mesh}" if ranked else None)

    def run() -> dict:
        return run_demo(
            slots=args.slots,
            n_requests=args.requests,
            max_new_tokens=args.max_new_tokens,
            arrivals_per_tick=args.arrivals_per_tick,
            seed=args.seed,
            decode_block=args.decode_block,
            mesh=mesh,
            telemetry_dir=args.telemetry_dir or None,
            faults=args.faults or None,
            slo=args.slo or None,
            trace_out=args.trace_out or None,
            paged=args.paged,
            page_size=args.page_size,
            prefix_cache=args.prefix_cache,
            replicas=args.replicas,
            hedge_ms=args.hedge_ms,
            kv_dtype=args.kv_dtype,
            quantize_weights=args.quantize_weights,
            disagg=args.disagg,
            prefill_replicas=args.prefill_replicas,
            decode_replicas=args.decode_replicas,
            autoscale=args.autoscale or None,
            models=args.models or None,
            device_budget=args.device_budget,
            prefill_chunk=args.prefill_chunk,
            async_host=args.async_host,
            metrics_port=args.metrics_port,
            device=device,
        )

    if mesh is None:
        metrics, rank = run(), 0
    else:
        with _Group(device) as group:
            metrics, rank = run(), group.rank
    if rank == 0:
        print(json.dumps(metrics, default=str))
    return 0


def cmd_train(args) -> int:
    """Fault-tolerant training demo: synthetic data through an
    ``SPMDTrainer`` with crash-restart supervision, ONE JSON metrics
    line out."""
    device = _apply_backend(args)
    from mmlspark_tpu_torch.train.demo import run_train_demo

    ranked = bool(os.environ.get(_RANK_ENV))
    mesh = args.mesh or (f"data={args.cpu_mesh}" if ranked else None)

    def run() -> dict:
        return run_train_demo(
            epochs=args.epochs,
            batch_size=args.batch_size,
            n_samples=args.samples,
            seed=args.seed,
            checkpoint_every=args.checkpoint_every,
            anomaly_limit=args.anomaly_limit,
            max_grad_norm=args.max_grad_norm,
            audit_every=args.audit_every,
            mesh=mesh,
            checkpoint_dir=args.checkpoint_dir or None,
            telemetry_dir=args.telemetry_dir or None,
            faults=args.faults or None,
            device=device,
        )

    if mesh is None:
        metrics, rank = run(), 0
    else:
        with _Group(device) as group:
            metrics, rank = run(), group.rank
    if rank == 0:
        print(json.dumps(metrics, default=str))
    return 0


def cmd_evidence(args) -> int:
    """Run an evidence tool over the port: on the card, or with
    ``--cpu-mesh`` on the CPU (the tool's ``--device cpu``). Its exit
    code is the command's: 3 when the record failed its contract."""
    import importlib

    tool = importlib.import_module(
        f"mmlspark_tpu_torch.tools.{EVIDENCE_TOOLS[args.which]}")
    argv = list(args.tool_args)
    if _apply_backend(args) == "cpu":
        argv = ["--device", "cpu", *argv]
    return tool.main(argv)


def cmd_docgen(args) -> int:
    from mmlspark_tpu_torch.tools import docgen

    return docgen.main([args.out_dir] if args.out_dir else [])


def cmd_config(args) -> int:
    from mmlspark_tpu_torch.core import config

    print(json.dumps(config.explain(), indent=1, default=str))
    return 0


def cmd_env(args) -> int:
    device = _apply_backend(args)
    from mmlspark_tpu_torch.core import env

    if os.environ.get(_RANK_ENV):
        with _Group(device) as group:
            info, rank = env.describe(device), group.rank
    else:
        info, rank = env.describe(device), 0
    if rank == 0:
        print(json.dumps(info, indent=1, default=str))
    return 0


def cmd_zoo(args) -> int:
    from mmlspark_tpu_torch.models.zoo import (
        ModelDownloader,
        default_downloader,
    )

    if args.local_repo:
        dl = ModelDownloader(args.local_repo, remote=args.remote)
    else:
        dl = default_downloader()
        if args.remote:
            from mmlspark_tpu_torch.models.zoo import Repository

            dl.remote = Repository(args.remote)
    if args.zoo_cmd == "list":
        names = [s.name for s in dl.local_models()]
        if dl.remote is not None:
            names += [
                f"{s.name} (remote)"
                for s in dl.remote.list_schemas()
                if s.name not in names
            ]
        print("\n".join(names) if names else "(no models)")
        return 0
    schema = dl.download_by_name(args.name)
    print(f"{schema.name} -> {dl.local_path(schema)}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="mml-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument(
        "--cpu-mesh", type=int, metavar="N", default=0,
        help="run on the CPU instead of the card: N = 1 in this process, "
        "N > 1 as N gloo rank processes for run, serve, train and env",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("run", help="run a user script")
    sp.add_argument("script")
    sp.add_argument("script_args", nargs=argparse.REMAINDER)
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("bench", help="the JAX package's repo benchmark; "
                        "raises over the port until its first benchmark")
    sp.add_argument(
        "--telemetry-dir", default="", metavar="DIR",
        help="write the serve group's events.jsonl + metrics.json "
        "telemetry under DIR (docs/OBSERVABILITY.md)",
    )
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser(
        "serve", help="continuous-batching serve demo (one JSON line)"
    )
    sp.add_argument(
        "--demo", action="store_true",
        help="run the synthetic-traffic demo (the only mode today)",
    )
    sp.add_argument("--slots", type=int, default=4,
                    help="KV-cache pool slots (concurrent requests)")
    sp.add_argument("--requests", type=int, default=8,
                    help="synthetic requests to submit")
    sp.add_argument("--max-new-tokens", type=int, default=8)
    sp.add_argument("--arrivals-per-tick", type=int, default=2)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument(
        "--decode-block", type=int, default=None, metavar="T",
        help="max fused decode-block size: up to T tokens per dispatch "
        "and per host sync (power-of-two ladder; default: engine's 32; "
        "1 = the old per-token stepping)",
    )
    sp.add_argument(
        "--mesh", default="", metavar="AXES",
        help="run the SHARDED engine on a (data, model) mesh, e.g. "
        "'data=2,model=2': slots split over data, the model "
        "Megatron-split over model, one rank a device (--cpu-mesh N: "
        "N gloo ranks on the CPU; on the card one NCCL rank a card, "
        "from a launcher, or a one-rank group of its own)",
    )
    sp.add_argument(
        "--telemetry-dir", default="", metavar="DIR",
        help="write events.jsonl (per-request trace spans), "
        "metrics.json (latency percentiles), trace.json (Perfetto-"
        "loadable Chrome trace), and metrics.prom (Prometheus text "
        "exposition) under DIR; --replicas/--disagg/--models runs "
        "write the MERGED TelemetryHub bundle — every replica's "
        "telemetry stitched by trace id (docs/OBSERVABILITY.md "
        "'Distributed tracing')",
    )
    sp.add_argument(
        "--trace-out", default="", metavar="PATH",
        help="write the run's Chrome trace-event JSON to PATH — open "
        "it at ui.perfetto.dev: one track per request, tick + program-"
        "dispatch tracks (docs/OBSERVABILITY.md 'Trace export')",
    )
    sp.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve live telemetry on 127.0.0.1:PORT while the demo "
        "runs: /metrics (merged Prometheus exposition), /traces "
        "(merged Perfetto trace), /healthz. 0 picks an ephemeral "
        "port (docs/OBSERVABILITY.md 'Distributed tracing')",
    )
    sp.add_argument(
        "--slo", default="", metavar="SPEC",
        help="declare rolling-window SLOs, e.g. 'ttft_p99_ms=50,"
        "per_token_p99_ms=5,error_rate=0.05,window_s=30': burning a "
        "target emits slo_violation flight-recorder alerts and SHEDS "
        "LOAD (new admissions pause until the window recovers); the "
        "JSON line grows slo_burning / slo_violations_total / "
        "slo_shed_ticks_total and the full window state under 'slo' "
        "(docs/OBSERVABILITY.md 'Declaring SLOs')",
    )
    sp.add_argument(
        "--faults", default="", metavar="SPEC",
        help="seeded chaos injection through the engine's fault hooks, "
        "e.g. 'seed=7,transient=0.05,oom=0.02,poison=0.02': per-kind "
        "fire rates plus 'seed' (required with rates) and 'stall_s'. "
        "Faulted requests quarantine as status 'failed'; the run's "
        "retry/quarantine/degradation counters land in the JSON line "
        "(docs/OBSERVABILITY.md 'Fault injection')",
    )
    sp.add_argument(
        "--paged", action="store_true",
        help="serve from the PAGED KV-cache pool: fixed-size pages + "
        "per-slot page tables instead of dense worst-case slot slabs — "
        "same compiled programs and bit-identical greedy tokens, HBM "
        "scales with pages actually mapped (docs/SERVING.md 'Paged KV "
        "cache')",
    )
    sp.add_argument(
        "--page-size", type=int, default=None, metavar="P",
        help="tokens per KV page (requires --paged; a multiple of 8 "
        "dividing cache_len; default: smallest such multiple). "
        "Doubles as the paged decode kernel's KV block",
    )
    sp.add_argument(
        "--prefix-cache", action="store_true",
        help="reuse shared prompt prefixes across requests (requires "
        "--paged): completed prefills register their pages under the "
        "prompt hash, later prompts map them refcounted and prefill "
        "only the remainder (copy-on-extend on divergence); the JSON "
        "line grows prefix_cache_hits_total / cow_copies_total",
    )
    sp.add_argument(
        "--kv-dtype", choices=["bf16", "int8"], default="bf16",
        help="KV-cache store dtype: int8 halves the pool's HBM bytes "
        "(per-head scales on the dense pool, per-page on --paged; the "
        "decode kernels dequantize in registers) at a declared "
        "token-flip "
        "budget vs the bf16 oracle; requires an even head_dim "
        "(docs/PERFORMANCE.md 'Quantized decode')",
    )
    sp.add_argument(
        "--quantize-weights", action="store_true",
        help="serve with per-channel int8 weights, dequantized inside "
        "each captured program: ~2x less weight HBM per decode "
        "dispatch (docs/PERFORMANCE.md 'Quantized decode')",
    )
    sp.add_argument(
        "--prefill-chunk", type=int, default=None, metavar="N",
        help="split every prefill into fixed N-token chunks (power of "
        "two >= 8) interleaved with decode ticks: a long prompt no "
        "longer stalls the whole batch for its full fill, and the "
        "prefill compile ceiling drops to the chunk ladder's bucket "
        "count; token streams stay bit-identical to monolithic "
        "prefill (docs/PERFORMANCE.md 'Chunked prefill & async host "
        "loop')",
    )
    sp.add_argument(
        "--async-host", action="store_true",
        help="pipelined host loop: dispatch decode block N+1 behind "
        "block N's in-flight execution and fetch N's tokens only "
        "after N+1 is enqueued — host scheduling work overlaps into "
        "device time (watch host_idle_fraction drop); still at most "
        "one host sync per block, and token streams stay "
        "bit-identical to the synchronous loop (docs/PERFORMANCE.md)",
    )
    sp.add_argument(
        "--replicas", type=int, default=1, metavar="N",
        help="serve through a ReplicaSet of N health-checked engine "
        "replicas (one mesh/slot pool each, shared params) with "
        "snapshot-based failover and zero-loss drain; the JSON line "
        "becomes the supervisor's metrics (replica_failovers_total, "
        "hedges_total, drains_total, per_replica) "
        "(docs/SERVING.md 'Replicated serving')",
    )
    sp.add_argument(
        "--hedge-ms", type=float, default=None, metavar="X",
        help="with --replicas > 1: duplicate a request onto a second "
        "replica once it has waited X ms (tail-latency hedging, "
        "first-committed-wins; the loser cancels and its tokens count "
        "as hedge_wasted_tokens_total)",
    )
    sp.add_argument(
        "--disagg", action="store_true",
        help="serve through a DisaggFleet of dedicated prefill and "
        "decode replicas: prefill replicas hand each request's KV + "
        "first token to decode replicas over the cross-replica "
        "hand-off plane, and a fleet-wide prefix index makes repeat "
        "prompts prefill-free fleet-wide; the JSON line becomes the "
        "fleet's metrics (handoffs_total, fleet_prefix_hits_total, "
        "scale_ups_total, per_role, per_replica) "
        "(docs/SERVING.md 'Disaggregated fleet')",
    )
    sp.add_argument(
        "--prefill-replicas", type=int, default=1, metavar="N",
        help="with --disagg: dedicated prefill replicas (default 1)",
    )
    sp.add_argument(
        "--decode-replicas", type=int, default=1, metavar="N",
        help="with --disagg: dedicated decode replicas (default 1)",
    )
    sp.add_argument(
        "--autoscale", default="", metavar="SPEC",
        help="with --disagg: elastic per-role scaling policy as "
        "key=value pairs, e.g. 'max_decode=4,queue_high=2,"
        "slo_burn_ticks=3,idle_ticks=8' — scale-up draws from the "
        "parked budget (max minus baseline), scale-down drains idle "
        "replicas back to it (docs/SERVING.md 'Disaggregated fleet')",
    )
    sp.add_argument(
        "--models", default="", metavar="SPEC",
        help="serve SEVERAL named deployments through one "
        "MultiModelEngine: ';'-separated 'name=arch' entries with "
        "':key=value' fields, e.g. 'lm=transformer_lm:slots=4;"
        "clf=mlp:max_batch=8;ox=onnx:path=m.onnx' — causal graphs get "
        "stateful LM-decode engines (slots/cache_len/decode_block), "
        "everything else stateless power-of-two-bucketed batch "
        "deployments (max_batch); per-entry 'slo=' specs spell ',' as "
        "'+'. The JSON line becomes the engine's metrics_dict: totals "
        "plus one nested dict per model and the shared registry's "
        "model{name}.serve.* keys (docs/SERVING.md 'Multi-model "
        "serving')",
    )
    sp.add_argument(
        "--device-budget", type=int, default=None, metavar="B",
        help="with --models: deployments stepped per engine tick "
        "(round-robin over the zoo; default: all with queued work) — "
        "the knob the fairness guarantee is stated against",
    )
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "train", help="fault-tolerant training demo (one JSON line)"
    )
    sp.add_argument("--epochs", type=int, default=2)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--samples", type=int, default=192,
                    help="synthetic training rows")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument(
        "--checkpoint-every", type=int, default=1, metavar="K",
        help="atomic checkpoint cadence in optimizer steps (0 = only "
        "at the end); each checkpoint carries params, optimizer state, "
        "the anomaly streak, and the loss history, committed by a "
        "manifest rename so a torn write keeps the previous one "
        "restorable (docs/TRAINING.md 'Checkpoint atomicity')",
    )
    sp.add_argument(
        "--checkpoint-dir", default="", metavar="DIR",
        help="where checkpoints land (default: a fresh temp dir); "
        "point a second run at the same DIR to resume it bit-exactly",
    )
    sp.add_argument(
        "--anomaly-limit", type=int, default=5, metavar="N",
        help="abort (FriendlyError + flight-recorder dump) after N "
        "CONSECUTIVE quarantined gradient steps; each quarantined step "
        "skips the update without advancing params "
        "(docs/TRAINING.md 'Anomaly policy')",
    )
    sp.add_argument(
        "--max-grad-norm", type=float, default=0.0, metavar="G",
        help="treat grad_norm > G as an anomaly too (0 = only "
        "non-finite loss/grad count)",
    )
    sp.add_argument(
        "--audit-every", type=int, default=0, metavar="K",
        help="fold an in-graph params+opt-state checksum into the "
        "compiled step every K steps and cross-check every replica's "
        "copy on the host — the silent-data-corruption audit "
        "(docs/TRAINING.md 'Integrity audits'; 0 = off)",
    )
    sp.add_argument(
        "--mesh", default="", metavar="AXES",
        help="the (data, model) training mesh, e.g. 'data=4,model=2', "
        "over the launcher's ranks (--cpu-mesh N, torchrun) or a "
        "one-process group of its own",
    )
    sp.add_argument(
        "--telemetry-dir", default="", metavar="DIR",
        help="write events.jsonl (step/checkpoint/restore/anomaly/"
        "retry/degraded timeline), metrics.json, and metrics.prom "
        "under DIR (docs/OBSERVABILITY.md)",
    )
    sp.add_argument(
        "--faults", default="", metavar="SPEC",
        help="seeded chaos through the trainer's train.* hook sites, "
        "e.g. 'seed=7,train.step:transient=0.1,train.data:poison=0.05,"
        "train.step:kill=0.02': transients retry, poison NaN-batches "
        "drive the anomaly quarantine, oom walks the gradient-"
        "accumulation ladder, kill crashes the trainer and the demo "
        "resumes it from the last committed checkpoint "
        "(docs/TRAINING.md 'Failure semantics')",
    )
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser(
        "evidence",
        help="an evidence tool over the port (flash | profile | decode | "
        "feed), on the card unless --cpu-mesh is given",
    )
    sp.add_argument("which", choices=["flash", "profile", "decode", "feed"])
    sp.add_argument("tool_args", nargs=argparse.REMAINDER)
    sp.set_defaults(fn=cmd_evidence)

    sp = sub.add_parser("docgen", help="regenerate the API docs from the "
                        "port's registries")
    sp.add_argument("out_dir", nargs="?", default="",
                    help="where the .rst pages go (default "
                    "build/docs_torch/api; the html goes beside it)")
    sp.set_defaults(fn=cmd_docgen)

    sp = sub.add_parser("config", help="print resolved app config")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("env", help="print device/topology view")
    sp.set_defaults(fn=cmd_env)

    sp = sub.add_parser("zoo", help="model-zoo operations")
    sp.add_argument("zoo_cmd", choices=["list", "download"])
    sp.add_argument("name", nargs="?")
    sp.add_argument("--local-repo", default="")
    sp.add_argument("--remote", default="")
    sp.set_defaults(fn=cmd_zoo)

    raw = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(raw)
    if args.cmd == "zoo" and args.zoo_cmd == "download" and not args.name:
        p.error("zoo download requires a model name")
    if args.cpu_mesh > 1 and args.cmd in _RANK_COMMANDS and \
            not os.environ.get(_RANK_ENV):
        return _spawn_ranks(raw, args.cpu_mesh)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
