#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``csrc/``, holds each
against its plain PyTorch version, drives the serving paths and the
training path at the full width of the repo's serve model, the stage
layer (``TPUModel``, ``DNNLearner``) over ResNet-20, ResNet-50, the
BiLSTM tagger and the flash LM, the switch-MoE LM served and trained,
the image path (decode, ``ImageFeaturizer`` over ResNet-50, the model
zoo), the replica planes (``ReplicaSet``, ``DisaggFleet`` with KV
hand-offs), multi-model serving over an ONNX-imported graph with the
telemetry hub, and the classical one-liner path (``Featurize``, the
histogram tree learners, ``TrainClassifier``/``TrainRegressor``,
``ComputeModelStatistics``, ``FindBestModel``), sequence-parallel
attention (Ulysses and ring over a one-rank NCCL mesh), the trainer's
mesh mode with the pipelined LM and the sequence-parallel BiLSTM over
the same group, the launcher
(``python -m mmlspark_tpu_torch``), the entry point, the evidence tools
and the twelve sample workflows (``mmlspark_tpu_torch/examples/``), and
prints the measured numbers.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit on error):

1. the card's name and power limit, from ``nvidia-smi``;
2. kernel vs plain, on the same CUDA tensors: ``flash_decode`` (float)
   at the serving shapes and at GQA, D=128 and strided-view cases, and
   at e307's head dim 16 (B=4 beams over a 48-token cache, and the
   rolled window cache of 8); the
   int8 ``flash_decode``, ``paged_flash_decode`` (float pages) and its
   int8 mode at B=8, page_size 16, 32 pages a row (L=512), H=Hkv=8,
   D=64, plus Hkv=2 and D=128, live lengths {0, 1, 15, 16, 17, 300, 511,
   512}, over a shuffled page table with shared pages and trash-page
   entries past each row's live length; the attention forward and both
   backward kernels, float32 and bfloat16, at (B, S, H, Hkv, D) =
   (8, 512, 8, 8, 64) causal (the training shape), (2, 500, 8, 2, 64)
   causal with a 128 window (GQA, a padded tile), (2, 384, 8, 1, 128)
   non-causal (MQA), (1, 1, 4, 4, 64), (2, 64, 4, 4, 256) and e307's
   head dim 16 ((1, 16, 2, 2, 16) with a window of 8, (1, 48, 2, 2, 16)
   and (2, 130, 2, 2, 16) with a window of 8, all causal), q/k/v
   strided slices of one fused tensor and dO a strided view; the route
   each call took is read off the counters (bf16 at head dims 64 and 128:
   the tensor-core forward and backward pair; f32, D = 16 and 256: the
   f32-FMA kernels); and the fused optimizer kernel against its plain
   update at the full-width model's parameter shapes, bit-equal in f32
   for adam, adamw, sgd and momentum with the quarantine's ``bad`` false
   and true;
3. the engines, each a main path of its own, with every launch count
   set to 0 just before it and read just after. Every engine runs its
   program ladder as CUDA graphs (prefill per bucket, resume per
   remainder bucket, the decode block per ladder size), and then the
   same schedule runs through its eager twin (programs counted, never
   captured). Gates: every program count within its pin, one program
   for every ladder size the run used, something captured, and every
   kernel's launches counted on replay equal to the eager twin's (the
   ``programs`` line: counts, pins, capture seconds, the graph pool's
   reserved bytes, peak memory, tokens/s, TTFT and per-token ms of both):
   - dense bf16: ``transformer_lm(vocab_size=8192, d_model=512, heads=8,
     depth=8, max_len=512)`` with seeded random weights under
     ``ServeEngine(slots=8, cache_len=512, decode_block=32)``, 16
     requests arriving 2 a tick; every request completes, the decode
     path launched ``flash_decode`` ``depth`` times per micro-step, and
     4 streams equal the port's own ``generate()``;
   - the shared-header schedule (16 requests, 2 a tick, 64 new tokens;
     half share a 72-token header — it ends mid-page, so copy-on-extend
     fires — with 8-32-token tails, half are random 8-64-token prompts)
     through the dense bf16 engine (the streams the int8 flip rates are
     counted against), the paged engine (``paged=True, page_size=16,
     prefix_cache=True``, pages sized to the workload), and the int8
     dense and paged engines. Gates: every request completes; each
     engine's kernel launched ``depth`` times per micro-step; the paged
     engine hit the prefix cache and copied on extend, its allocator
     audit is clean after the drain, its pool holds fewer bytes than the
     dense pool, and 4 of its streams (2 prefix hits) equal
     ``generate()`` or first differ at a near tie. The int8 flip rates
     are reported, not gated;
   then chunked prefill and the async host loop (the ``chunked_async``
   line), each run a main path of its own: 16 requests, 2 a tick, 64 new
   tokens, even ones 240-440-token prompts and odd ones 8-64, through the
   dense bf16 engine (a) sync and monolithic, (b) ``prefill_chunk=64``
   (the chunk ladder 8-64: 4 programs), (c) ``async_host=True``, (d)
   both; then (d) on the paged prefix-cache engines, bf16 and int8, over
   the shared-header schedule, each with a warm pass. Gates: every
   request completes; (c) bit-equal to (a); (b), (d) and the paged runs
   equal to their sync monolithic twins or first differing at a near
   tie (the twin's top-2 margin under the full forward below
   BF16_LOGIT_TOL), and every emitted token within BF16_LOGIT_TOL of the
   full forward's best; every program count within its pin; at most one
   fetch a block; on the async runs, overlapped dispatches and at least
   one fetch that returned while the next block was still running; the
   decode kernel launched ``depth`` times a micro-step. Reported: warm
   tokens/s, the short requests' TTFT p50/p99, per-token ms,
   ``host_idle_fraction``, capture seconds, and one steady T=32 block's
   wall time, busy share and host dispatch/fetch ms, sync against async.
   Then the resilience layer (the ``resilience`` line): the async
   chunked engine under a transient and two OOMs at ``serve.decode`` and
   a poisoned block for slot 1 — every request terminal, exactly the
   poisoned one failed (its tokens the real pre-fault ones), the rest
   equal to the fault-free (d) or first differing at a near tie, not
   degraded at the end, decode programs within the pin; a 2^46-element
   allocation raising an error ``is_resource_exhausted`` accepts; the
   crash drill (snapshots every tick, a kill at ``serve.prefill`` while
   fills are open, a restore from ``last_snapshot``, the streams against
   (d)'s); and a bit-flipped snapshot refused with
   ``SnapshotCorruption``;
   plus the full-width model's cached decode step on the card against
   the same step on the CPU, in float32: over a dense cache (1e-3), a
   paged float32 cache (1e-3), and int8 dense and paged caches (1e-2),
   the caches built on the CPU and copied to the card;
4. generation and weight-only int8, each a main path with the counts set
   to 0 just before it and read just after, at full width: 8 seeded
   prompts of 64 tokens (the ``generate`` line) — sampled decode at
   temperature 0.8, top-k 50, top-p 0.9 for 128 tokens from a seeded
   CUDA generator (the same seed repeats the stream; every drawn token
   lies in the support recomputed in numpy from its step's logits), the
   greedy recompute oracle ``kv_cache=False`` (the flash forward kernel)
   against the cached path (tokens equal, or a row first differs at a
   near tie under BF16_LOGIT_TOL; each cached step's logits within
   BF16_LOGIT_TOL of a teacher-forced forward), and ``beam_search(beams=
   4)`` for 32 tokens (beams=1 equals greedy, sorted scores, the best
   score within 2 BF16_LOGIT_TOL a token of its teacher-forced log-prob
   sum); then the random schedule through ``quantize_weights=True`` with
   dense bf16 KV and with paged int8 KV (the ``quantized_weights`` line:
   tokens/s, TTFT, the flip rate against the dense bf16 engine, weight
   bytes against f32, the engine's peak memory, and the per-call
   dequantization's device and host time). Each path fails the run if
   its kernel was launched no time. Then the int8 flip budget on a
   trained model (the ``trained_int8`` line): the serve model at full
   width trained on the periodic stream (``overfit_periodic_lm``, period
   4, seq 16), the JAX suite's int8 schedule through the bf16 engine,
   int8 KV dense and paged, and weight-int8 over int8 KV: the bf16
   streams follow the period, each int8 engine launched its int8 decode
   kernel, and each flip rate against the bf16 streams is within the
   suite's FLIP_BUDGET (0.25); then the same on a recall task that needs
   the cache (each row a random 4-id motif repeated, 200 adam steps on
   fresh rows; the bf16 streams must follow the motif);
5. training, each run a main path with the counts set to 0 just before
   it and read just after: the same model with ``attn_impl="flash"``
   under ``SPMDTrainer`` (adam, lr 1e-3, batch 8) for 8 steps over
   seeded rows of 512 tokens that are arithmetic progressions mod the
   vocabulary (learnable), then a depth-2 GQA model with a 128 window
   and RoPE for 4 steps. Gates: every loss finite and the last below the
   first; each attention kernel launched ``depth`` times a step, every
   forward and every backward through the tensor-core kernels; no dense
   attention ran; one step program captured and one fused-optimizer
   launch a step (step 0 runs eagerly, the rest replay the captured
   step). Then one training step of the float32 model, card vs
   CPU (the plain versions), on the same weights and batch, through the
   f32-FMA kernels: the loss within 1e-4 relative, every parameter's
   gradient within 1e-3 of that leaf's largest;
6. the trainer's resilience (the ``train_resilience`` line), each run a
   main path with the counts set to 0 just before it and read just
   after, on the full-width training model (adam, batch 8, 8 steps,
   checkpoints every 2 steps in a temporary directory deleted at the
   end): the fold kernel (``csrc/tree_checksum.cu``) bit-equal to its
   plain version and to numpy's host fold on random trees of every word
   size (odd lengths, empty leaves, an unaligned leaf) and on the
   full-width parameters and adam moments, the carry kept with the flag
   at 0; a kill at step 5 and a resume from the step-4 checkpoint,
   parameters and the stitched loss curve bit-equal to the uninterrupted
   run; a kill between payload and commit at step 4 (the store keeps
   steps 0 and 2, the resume is bit-exact) and a bit flipped after the
   hash at step 4 (the resume refuses it, counts one checksum failure,
   falls back to step 2, bit-exact); transients at ``train.step`` and
   ``train.data`` retried, bit-equal; a poison at ``train.data`` skipped
   on token rows (bit-equal) and quarantined on an MLP's float rows (the
   step's loss NaN, adam's count one short); an injected OOM walking
   ``grad_accum`` 1 -> 2 with a second captured program, the loss curve
   within LADDER_LOSS_TOL of the clean one; ``audit_every=2``: clean
   audits, one step program, one fold launch a step; the seeded
   ``train.step`` corrupt spec with every suspicion adjudicated; a flip
   after an audit step's fold replayed and adopted, bit-equal; the costs
   of a checkpoint at full width (save, sha256, restore, bytes) and of a
   host audit's fold; step ms with audits on and off; and the resumed
   run's last checkpoint restored into a target rebuilt from scratch and
   served by the dense engine (4 greedy requests, equal to
   ``generate()`` or first differing at a near tie, ``flash_decode``
   launched);
7. the stage layer (the ``dnn_stages`` line), each run a main path with
   the counts set to 0 just before it and read just after, through the
   entry points a user calls (``TPUModel.transform``, ``DNNLearner.fit``)
   with seeded random weights: ResNet-20 at width 16 (bf16, batch 1024)
   over 16,384 seeded 32x32x3 images at ``feed_depth`` 2, 4 and 8 and
   with ``feed_dtype="bfloat16"``, beside the model alone (its captured
   program replayed) and an eager twin (programs counted, never
   captured: launch counts equal), its logits within STAGE_LOGIT_TOL of
   the CPU's f32 forward on the same weights; ResNet-50 at 224 (batch
   256, 2,048 images) with the logits, with the ``pool`` features and
   with ``weight_quant="int8"``: images/s, FLOPs per image counted from
   the layer shapes, MFU against the bf16 dense peak, weight bytes, the
   logits against the CPU's f32 forward; ``DNNLearner`` on ResNet-20 for
   6 adam steps (the loss falls, the running statistics move, one step
   program); ``DNNLearner`` on the flash LM at full width for 6 steps and
   its ``TPUModel`` over 8 rows of 512 tokens (the tensor-core forward
   and backward kernels launched through the stages, the scores against
   the CPU's plain bf16 forward, the eager twin's launches equal); and
   the BiLSTM tagger at its default widths (cuDNN's LSTM) over 1,024
   rows of 128 tokens against the CPU's forward. Each with its peak
   device memory and seconds;
8. the switch-MoE LM (the ``moe`` line), each run a main path with the
   counts set to 0 just before it and read just after:
   ``transformer_lm_moe`` at the serve model's widths with 8 experts,
   d_ff 2048 and capacity factor 1.25 (~151 M parameters, seeded random
   weights) through the dense bf16 engine and the paged bf16
   prefix-cache engine on the random schedule, each with its warm pass
   and eager twin (as in phase 3). Gates: every request completes; the
   decode kernel launched exactly ``depth`` times a micro-step; one
   prefill program a distinct prompt length (MoE prefills at exact
   length) under the engine's pin of ``cache_len - 1``; every stream
   equal to the port's ``generate()`` and paged equal to dense, or first
   differing at a near tie (margins from each stream's own cached
   decode: a scoring forward routes through the capacity path, which may
   drop tokens the dropless decode keeps); a small float32 MoE's scoring
   forward and cached decode step within 1e-4 of the CPU's. Reported:
   cold and warm tokens/s beside the eager twin's, TTFT, programs,
   capture seconds, graph pool bytes, peak memory, and a replayed T=32
   block under ``torch.profiler`` (busy share; device ms of the decode
   kernels, of all matrix products and of the rest) with the MoE FFN's
   pieces (router, expert-weight gather, expert products) timed alone
   from CUDA graphs at the block's shapes. Then ``SPMDTrainer`` on the
   same model with ``attn_impl="flash"``, batch 8 x 512, 8 adam steps:
   losses finite and falling, the sown load-balance loss positive, each
   attention kernel launched ``depth`` times a step on the tensor-core
   route, one step program; and one float32 step of a small MoE (the
   loss with ``moe_aux_weight``) on the card against the CPU, within
   phase 5's tolerances;
9. the image path (the ``image`` line): the port's native decoder's
   build status (with the compiler's message; a missing decoder is host
   code, printed, not a failure) and host decode images/s over the
   committed fixtures; ``ImageFeaturizer`` over ResNet-50 at 224 cut to
   ``pool`` on 2,048 seeded uint8 256x256 images (resized, rounded and
   scaled on the card a batch of 256 at a time, straight into the
   captured program) — images/s beside the model alone, the resize's
   device ms, and 16 images' features within 1e-2 of the CPU's float32
   forward on the same resized input; 64 images of mixed sizes through
   the host-resize path; and ``ResNet20_Digits04`` fetched by
   ``ModelDownloader`` from the committed ``models/zoo_repo`` through a
   ``file://`` URI, featurizing the committed fixture images (numpy-made
   ones where no decoder runs);
10. the replica planes (the ``fleet`` line), each run a main path with
   the counts set to 0 just before it and read just after, every replica
   an engine of phase 3's configuration: ``ReplicaSet(replicas=2)`` on
   the dense bf16 pool over the random schedule — a clean run (cold, then
   warm), a run with a kill of replica 0 at engine tick 6 (rebuilt from
   its tick-4 snapshot), and a ``drain(1)`` at tick 4 — and
   ``DisaggFleet(prefill_replicas=1, decode_replicas=2)`` over dense bf16
   (random schedule), dense int8, paged prefix-cache bf16 and paged
   prefix-cache int8 (header schedule; the int8 one then repeats the
   header requests, which the fleet index serves decode-only). Gates:
   every stream equal to the single engine's of the same pool on the
   same schedule — or first differing at a near tie where a request
   re-prefilled its emitted tokens (the drain's migrations, the kill's
   restore: bf16 K/V recomputed by a prefill round otherwise than the
   decode steps that made them) and on paged int8 (the decode replica
   re-quantizes the prefix rows the prefill replica dequantized out of
   its shared pages) — one failover, the device memory
   held after it within 25% of the clean set's, the drained replica
   retired, the prefill replica 0 decode launches and each decode
   replica > 0, no hand-off fallback, no prefill program on a decode
   replica and no decode program on the prefill replica, every repeat a
   fleet-index hit. Reported: tokens/s beside the single engine's,
   rebuild and recapture seconds, memory at the failover, per-replica
   launches, payload bytes and production/adoption ms. Drills: a corrupt
   hand-off falls back to a full prefill with equal streams; a tight
   ``slo`` sheds and still completes every request; the engine's Chrome
   trace written and parsed. Analytics: ``device_peak()`` resolves the
   card from the table, and every program family's MFU and HBM share
   (``metrics.perf``, costed on meta tensors) reads at or under 100%;
11. multi-model serving (the ``multimodel`` line), each run a main path
   with the counts set to 0 just before it and read just after:
   ``engine_from_spec`` over ``lm`` (the serve model on phase 3's weights
   and configuration), ``r50`` (ResNet-50 at 224, ``max_batch=64``,
   seeded weights drawn on the card) and ``ox`` (the serve model written
   by the port's ONNX exporter at one 128-token row and imported back),
   a ``TelemetryHub`` attached and scraped between ticks: phase 3's
   random schedule 2 a tick beside 168 images (64 + 64 + 40, padded)
   and 8 id rows.
   Gates: every ``lm`` stream bit-equal to the dense engine's, its
   program counts equal to it and one fetch a decode block (the hub adds
   none), ``flash_decode`` launched ``depth`` times a micro-step; every
   ``r50`` batch bit-equal to a direct apply of the same bucket-size
   batch on the card, the padded batch within MM_PAD_TOL of the unpadded
   one's; every ``ox`` row bit-equal to the imported graph's direct
   apply and within MM_OX_F32_TOL of the native graph computing in f32
   on the same weights; one program per bucket used, within
   ``num_batch_buckets``; a warm pass adding no program; at
   ``device_budget=1`` under a saturating ``lm`` each batch deployment
   served within 3 ticks; a fresh ResNet-50 deployment absorbing a
   ``serve.batch`` transient and walking an OOM down to bucket 32 and
   back without a new program; the hub's timeline ordered by wall time,
   one chain per request, its trace through JSON and ``GET /metrics`` on
   an ephemeral loopback port with every deployment's labeled series;
   ``close()`` leaving every graph pool empty; and ``ReplicaSet(models=
   {"lm", "lm2"}, replicas=2)`` routing each request to its model's
   replica, every stream equal to its dedicated engine's. Reported: warm
   tokens/s beside the dense engine's, ``r50`` images/s through the
   facade and its program alone beside ``dnn_stages``' figure, ``ox`` ms
   a batch beside the native bf16 graph's (both replayed from a CUDA
   graph), capture seconds and graph-pool bytes per deployment, and the
   hub's refresh, export and bundle ms, beside the card's name and power
   limit;
12. the classical one-liner path (the ``classical`` line), through the
   entry points a user calls, on the card by default:
   ``TrainClassifier(label_col="income", seed=0)`` on
   ``make_census(32561, seed=11, full_schema=True)`` (the real Adult
   train split's rows and 14-column schema) over ``gbt`` (10 rounds,
   depth 5), ``random_forest`` (20 trees), ``decision_tree``,
   ``naive_bayes``, ``logistic_regression`` (1 and 5 epochs, batch 256)
   and ``mlp``; ``TrainRegressor(label_col="arr_delay", seed=0)`` on
   ``make_flights(32561, seed=3)`` over ``linear_regression``,
   ``decision_tree``, ``random_forest``, ``gbt`` and ``mlp``; each a cold
   and a warm fit. Gates: a tree learner's two card fits bit-identical
   (``feats``, ``threshs``, ``values``, ``feature_importances``) with one
   host fetch each (``trees.fetches``); each tree fit against the same fit
   on the CPU (the plain path): gini trees equal in structure with values
   within GINI_VALUE_TOL, boosted and variance trees equal in structure
   or parting only at near ties (both candidates' gains within 1e-5
   relative, ``testing/tree_parity.py``; the line counts them) with
   predictions within GBT_PRED_TOL; one fitted model scored on the card
   and on the CPU within SCORE_TOL. The wide case:
   ``GBTClassifier(max_iter=4, max_depth=5, max_bins=32)`` on a seeded
   [32561, 4096] table (64 dense columns, 4032 sparse hashed counts; 133
   MB of uint8 codes on the card, 16 feature chunks a level), two card
   fits bit-identical, and the first round's root histogram against a
   float64 numpy ``bincount`` (counts exact, sums within HIST_REL_TOL).
   The recorded learner matrices (``testing/benchmark_metrics``) retrained
   on the card: tree and naive-Bayes rows within the JAX test's TOL of
   ``tests/fixtures/benchmark_metrics*.csv``, the logistic, linear and
   MLP rows (the port's own initial weights) within NN_TOL. Notebook
   101's flow on ``tests/fixtures/titanic.csv`` (``CleanMissingData``,
   three ``TrainClassifier`` candidates, ``FindBestModel`` by AUC, a save
   and ``PipelineStage.load``, ``ComputeModelStatistics``) on the card
   and on the CPU: the same best model, accuracy above 0.73. Reported:
   every fit's cold and warm seconds with its host binning and
   ``Featurize`` seconds and peak device memory, scoring rows/s, the
   training-set metrics, the level histogram's device ms at the wide
   shape (1 and 16 nodes) beside its byte bound, a profiled warm census
   GBT fit (busy share, top kernels), and every recorded row's gap;
13. sequence parallelism (the ``context_parallel`` line): a one-rank
   NCCL process group on the card (``parallel.initialize_distributed``)
   and ``make_mesh({"seq": 1})``; the serve model's widths with
   ``attn_impl="ulysses"`` and ``"ring"`` over that mesh, each one
   training forward and backward on CP_BATCH x CP_SEQ seeded tokens a
   main path, against ``"flash"`` on the same variables. Gates: Ulysses
   bit-equal to flash (logits and every gradient: the all-to-alls and
   gathers are identities at one rank) and the forward and both backward
   kernels launched ``depth`` times each through it, on the tensor
   cores; the ring's logits within BF16_LOGIT_TOL and its gradients
   within CP_GRAD_TOL of flash's. The arithmetic across several ranks is
   held on the CPU over gloo (``tests/test_torch_context_parallel.py``):
   the card machine has one GPU and NCCL puts one rank on a GPU. Then,
   over the same group, the trainer's mesh mode (the ``mesh_train``
   line, ``check_mesh_train``): the flash LM under
   ``TRANSFORMER_TP_RULES`` on ``{"data": 1, "model": 1}`` through the
   split step (the Megatron-split copy on its shards, the vocab-parallel
   loss) against the plain trainer, bit-equal in loss curve and final
   parameters, one captured step with its collectives inside, the
   forward and both backward kernels depth x steps times each on the
   tensor cores; the MoE LM at ``MOE_MODEL``'s widths under
   ``EXPERT_RULES`` on ``{"data": 1, "expert": 1}`` through the
   expert-local FFN, gated the same way; the
   pipelined LM on ``{"data": 1, "pipe": 1}`` against its own stage loop
   and the CPU's f32 forward, and 8 steps under
   ``PIPELINE_STAGE_RULES``; the sequence-parallel BiLSTM tagger on
   ``{"data": 1, "seq": 1}`` against the dense one and 4 SGD steps; and
   ``python -m mmlspark_tpu_torch train --mesh data=1`` as a process.
   Then, over the same group, the serving engine's mesh mode (the
   ``mesh_serve`` line, ``check_mesh_serve``): ``ServeEngine(...,
   mesh={"data": 1, "model": 1})`` at the serve model's full width — the
   dense bf16 engine on the random schedule, the paged bf16 and paged
   int8 engines with the prefix cache and the dense int8 engine on the
   shared-header schedule — each a main path with the counts set to 0
   just before it and read just after, then a warm pass. Gates: every
   request completes; ``flash_decode`` and ``paged_flash_decode``, float
   and int8, launched ``depth`` times a micro-step through the mesh
   engines; every stream bit-equal to the one-device engine's on the
   same schedule (at one rank every collective is an identity and the
   split is the whole); programs within their pins, none new on the warm
   pass, captured with their collectives inside; and ``python -m
   mmlspark_tpu_torch serve --mesh data=1,model=1`` as a process.
   Reported: capture seconds, collective calls, warm tokens/s and
   per-token ms beside the one-device engine's. The multi-rank
   arithmetic is held on the CPU over gloo
   (``tests/test_torch_serve_mesh.py``);
14. the launcher (the ``cli`` line): ``python -m mmlspark_tpu_torch
   serve --requests 8`` as a subprocess on the card (one JSON line, every
   request completed, the decode kernel launched in that process, read
   at its exit) and ``python -m mmlspark_tpu_torch env`` naming the
   card;
15. the entry point (the ``entry`` line): ``entry()``'s ResNet-20
   forward on the card on a seeded batch of its example's shape against
   the port's f32 forward on the CPU, within STAGE_LOGIT_TOL; then the
   evidence tools (the ``evidence`` line): ``python -m mmlspark_tpu_torch
   evidence flash|decode|profile|feed`` and ``docgen`` as subprocesses at
   the tools' own sizes (flash: B=4, S=2048, H=8, D=64 and S=8192;
   decode: the serve model's widths, 8 x 64-token prompts, N=64 and
   256), each record accepted by its tool's ``check_record``, the flash
   process's forward and backward kernels and the decode process's
   decode kernel launched (their counters read at exit);
16. the sample workflows (the ``examples`` line): the port's twelve
   examples (``mmlspark_tpu_torch/examples/e101``-``e307``, the
   reference's notebooks 101-305 and the long-context and generation
   samples), each a process of its own through the port's harness
   (``python -m mmlspark_tpu_torch run <script>``, no ``--cpu-mesh``):
   each prints its ``OK`` line with its JAX twin's keys and its launch
   counters (read at its exit); every example passes its own floors,
   and e307 (``d_model=32``, 2 heads: head dim 16) launches the
   attention forward, both backward kernels (their f32-FMA route: the
   ``kernels`` line's attention rows count it as ``simt_launches``) and
   the dense decode kernel;
17. numbers: each kernel's, its plain version's and (where one exists)
   a library call's times (CUDA events, inputs rotated through more
   memory than the 50 MB L2 so each launch reads cold): ``ms`` the
   device's time (a spin kernel holds the stream while the host
   enqueues the timed loop, so the calls run back to back), ``call_ms``
   the host-paced time an eager caller pays; ``graph_ms`` for the decode
   kernels, the device time a call when the calls are replayed from one
   CUDA graph; the attention kernels'
   device times also from ``torch.profiler``; the fused optimizer's row
   (adam over the 33.9 M parameters, against ``torch.optim.Adam(fused=
   True).step()``); the fold's row (``tree_checksum`` over the
   full-width parameters and adam moments, with its ``graph_ms`` and the
   flag-0 launch's; no library call computes it); the kernel's bound, the
   engines' throughput, the training runs' step time, tokens/s and peak
   memory, and one steady (replayed) decode block and one replayed
   training step under ``torch.profiler`` (device busy share and the
   kernels that take its time). The ``attention_backward`` line: the
   whole ``flash_attention_backward`` call, its operands, the two kernels
   alone and together, the f32-FMA pair on the same inputs, and SDPA's
   backward, all device times in one call; and the pair at the GQA
   training run's shape.

The last line is ``{"ok": true, "device": {...}}``. float32 matrix
products and convolutions run in full float32 here: TF32 is switched off
for both, so the f32 comparisons are not loosened by it.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# shared with the evidence tools: the kernel table's device timer, the
# attention kernels' work count and the matmul kernels' names
from mmlspark_tpu_torch.tools.timing import (
    MATMUL_KERNEL_KEYS,
    attention_work,
    time_ms,
)

#: H100 SXM, NVIDIA's data sheet: HBM3 bandwidth, the float32 rate
#: outside the tensor cores (the decode kernels' arithmetic is f32 FMAs)
#: and the dense bf16 tensor-core rate (the attention kernels' inputs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: what the rotation of timing inputs must exceed: twice the L2 cache
ROTATE_BYTES = 2 * 50 * 2**20

SERVE_MODEL = dict(vocab_size=8192, d_model=512, heads=8, depth=8,
                   max_len=512)
SLOTS, CACHE_LEN, DECODE_BLOCK = 8, 512, 32
N_REQUESTS, MAX_NEW, ARRIVALS_PER_TICK = 16, 64, 2
N_CHECKED = 4
#: the paged engine and the shared-header schedule: a 72-token header
#: ends mid-page (72 = 4.5 pages of 16)
PAGE_SIZE, HEADER_LEN = 16, 72
#: the chunked/async phase: the chunk width (the ladder 8-64: 4 buckets);
#: the crash drill's kill tick (while long fills are open)
CHUNK, KILL_TICK = 64, 3
#: the bf16 logit tolerance of tests/test_torch_model.py: a stream may
#: first differ from generate() only where the top-2 margin is below it
BF16_LOGIT_TOL = 6.25e-2
#: the launch counters of ops/flash_attention.py, one per kernel
COUNTERS = ("launches", "q8_launches", "paged_launches",
            "paged_q8_launches", "fwd_launches", "fwd_mma_launches",
            "bwd_kv_launches", "bwd_q_launches", "bwd_kv_mma_launches",
            "bwd_q_mma_launches")
#: the attention counters a call adds to: every kernel once, and each
#: ``*_mma_launches`` once more on the tensor-core route
ATTN_COUNTERS = ("fwd_launches", "bwd_kv_launches", "bwd_q_launches")
ATTN_MMA_COUNTERS = ("fwd_mma_launches", "bwd_kv_mma_launches",
                     "bwd_q_mma_launches")
#: where the main path runs; a CPU rehearsal of the script sets "cpu"
DEVICE = "cuda"

#: (B, L, H, Hkv, D, lengths or None for the slice's ragged set, strided)
KERNEL_CASES = [
    ("slice", 8, 512, 8, 8, 64, None, False),
    ("gqa_hkv2", 8, 512, 8, 2, 64, None, False),
    ("mqa_hkv1", 8, 512, 8, 1, 64, None, False),
    ("d128", 8, 512, 8, 4, 128, None, False),
    ("strided_views", 4, 96, 8, 8, 64, [0, 5, 64, 96], True),
    # e307's models (the examples phase): head dim 16, the dense cache
    # of four beams and the rolled window cache of 8
    ("e307_d16", 4, 48, 2, 2, 16, [1, 9, 24, 48], False),
    ("e307_d16_window", 1, 8, 2, 2, 16, [8], False),
]
SLICE_LENGTHS = [0, 1, 127, 128, 129, 300, 511, 512]
#: (name, B, H, Hkv, D) for the int8 and paged kernel checks, with
#: page_size PAGE_SIZE and MAX_PAGES pages a row (L = 512)
NEW_KERNEL_CASES = [
    ("slice", 8, 8, 8, 64),
    ("gqa_hkv2", 8, 8, 2, 64),
    ("d128", 8, 8, 8, 128),
]
MAX_PAGES = 32
PAGED_LENGTHS = [0, 1, 15, 16, 17, 300, 511, 512]
#: f32: both versions accumulate in f32 and differ only in the order of
#: the sums. bf16: both outputs round to bf16 at the end, and one bf16
#: ulp at |out| < 2 is 2^-7 = 0.0078
TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-2}
#: (name, B, S, H, Hkv, D, causal, window) of the attention kernel checks
ATTN_CASES = [
    ("slice", 8, 512, 8, 8, 64, True, None),
    ("gqa_window_padded", 2, 500, 8, 2, 64, True, 128),
    ("mqa_d128_noncausal", 2, 384, 8, 1, 128, False, None),
    ("one_token", 1, 1, 4, 4, 64, True, None),
    ("d256", 2, 64, 4, 4, 256, True, None),
    # e307's models (the examples phase): head dim 16, windows smaller
    # than a tile
    ("e307_d16_window", 1, 16, 2, 2, 16, True, 8),
    ("e307_d16", 1, 48, 2, 2, 16, True, None),
    ("e307_d16_tiles_window", 2, 130, 2, 2, 16, True, 8),
]
#: (out, LSE, gradients): out as the decode kernels; the LSE is f32 on
#: both sides; a gradient's max abs error over the plain value's max abs
#: (or over 1 where that is smaller: dq and dk of a single token are 0 in
#: exact arithmetic and hold only rounding noise) — f32 sums in other
#: orders (1e-4); in bf16 P and dS round at the same places, but the
#: kernel sums a GQA group's dK/dV in f32 and the plain version rounds
#: each head's first (1e-2)
ATTN_TOLERANCE = {"float32": (1e-5, 1e-5, 1e-4),
                  "bfloat16": (1e-2, 1e-5, 1e-2)}
#: the training runs: the serve model with the flash attention kernels,
#: then a cheaper depth-2 model with GQA, a window and RoPE
TRAIN_MODEL = dict(SERVE_MODEL, attn_impl="flash")
SMALL_TRAIN_MODEL = dict(SERVE_MODEL, depth=2, kv_heads=2, window=128,
                         pos_embedding="rope", attn_impl="flash")
TRAIN_BATCH, TRAIN_STEPS, SMALL_TRAIN_STEPS = 8, 8, 4
#: the generation phase: seeded prompts, the sampling filters, beams
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 64, 128
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
BEAMS, BEAM_NEW = 4, 32


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    from mmlspark_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    libs = kernel_build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s: {sorted(libs)}")
    for name, path in libs.items():
        report = path.with_name(path.name + ".log")
        if report.is_file():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"{name}: {line.strip()}")
    return libs


def kernel_inputs(b, L, h, hk, d, dtype, strided, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(DEVICE)

    if not strided:
        return normal(b, 1, h, d), normal(b, L, hk, d), normal(b, L, hk, d)
    # q as the model slices it out of a fused qkv projection, K/V as
    # every other slot of a wider pool: non-contiguous in every dim but
    # the last
    qkv = normal(b, 1, h + 2 * hk, d)
    pool_k, pool_v = normal(2 * b, L, hk, d), normal(2 * b, L, hk, d)
    return qkv[:, :, :h], pool_k[::2], pool_v[::2]


def int8_kv(shape, n_scales, gen):
    """int8 K/V over the whole range, and positive f32 scales that
    dequantize them to about [-4, 4] (an amax of about 3 with the pools'
    1.5x headroom)."""
    import torch

    vals = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    scales = torch.rand(n_scales, generator=gen) * 0.01 + 0.02
    return vals.to(DEVICE), scales.to(DEVICE)


def shuffled_page_table(b, lengths, gen):
    """(num_pages, page table on the device): distinct pages for every
    live logical page in shuffled order, rows 1-2 and 3-4 sharing their
    first page, and the trash page 0 past each row's live length."""
    import torch

    num_pages = b * MAX_PAGES + 1
    perm = (torch.randperm(num_pages - 1, generator=gen) + 1).tolist()
    pt = torch.zeros((b, MAX_PAGES), dtype=torch.int32)
    for row, n in enumerate(lengths):
        for j in range(-(-min(n, MAX_PAGES * PAGE_SIZE) // PAGE_SIZE)):
            pt[row, j] = perm.pop()
    pt[2, 0], pt[4, 0] = pt[1, 0], pt[3, 0]
    return num_pages, pt.to(DEVICE)


def compare(errors: dict, key: str, got, want, lengths) -> None:
    """Hold a kernel's output to its plain version's: within the
    tolerance of the query's dtype, and exact zeros for length-0 rows."""
    import torch

    torch.cuda.synchronize()
    dtype = str(got.dtype).split(".")[1]
    err = (got.float() - want.float()).abs().max().item()
    tol = TOLERANCE[dtype]
    errors[key] = err
    log(f"kernel vs plain {key}: max abs err {err:.3g} (tolerance {tol})")
    if got.shape != want.shape or got.dtype != want.dtype or not err <= tol:
        raise AssertionError(f"{key}: max abs err {err} > {tol}")
    for row, n in enumerate(lengths):
        if n == 0 and got[row].abs().max().item() != 0.0:
            raise AssertionError(f"{key}: length-0 row {row} is not all "
                                 "zeros")


def check_kernels() -> dict:
    import torch

    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_decode,
        flash_decode_reference,
        paged_flash_decode,
        paged_flash_decode_reference,
    )

    errors = {}
    for i, (name, b, L, h, hk, d, lengths, strided) in enumerate(
            KERNEL_CASES):
        lengths = SLICE_LENGTHS if lengths is None else lengths
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = kernel_inputs(b, L, h, hk, d, dtype, strided, seed=i)
            got = flash_decode(q, k, v, lens)
            compare(errors, f"{name}/{str(dtype).split('.')[1]}", got,
                    flash_decode_reference(q, k, v, lens), lengths)

    L = MAX_PAGES * PAGE_SIZE
    lens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=DEVICE)
    for i, (name, b, h, hk, d) in enumerate(NEW_KERNEL_CASES):
        gen = torch.Generator().manual_seed(50 + i)
        num_pages, pt = shuffled_page_table(b, PAGED_LENGTHS, gen)
        k8, ks = int8_kv((b, L, hk, d), (b, hk), gen)
        v8, vs = int8_kv((b, L, hk, d), (b, hk), gen)
        page_shape = (num_pages, hk, PAGE_SIZE, d)
        kp8, pks = int8_kv(page_shape, (num_pages, hk), gen)
        vp8, pvs = int8_kv(page_shape, (num_pages, hk), gen)
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[1]
            q = torch.randn((b, 1, h, d), generator=gen).to(dtype).to(DEVICE)
            kp, vp = (torch.randn(page_shape, generator=gen).to(dtype)
                      .to(DEVICE) for _ in range(2))
            q8 = dict(k_scale=ks, v_scale=vs)
            compare(errors, f"q8_{name}/{tag}",
                    flash_decode(q, k8, v8, lens, **q8),
                    flash_decode_reference(q, k8, v8, lens, **q8),
                    PAGED_LENGTHS)
            compare(errors, f"paged_{name}/{tag}",
                    paged_flash_decode(q, kp, vp, lens, pt),
                    paged_flash_decode_reference(q, kp, vp, lens, pt),
                    PAGED_LENGTHS)
            pq8 = dict(k_scale=pks, v_scale=pvs)
            compare(errors, f"paged_q8_{name}/{tag}",
                    paged_flash_decode(q, kp8, vp8, lens, pt, **pq8),
                    paged_flash_decode_reference(q, kp8, vp8, lens, pt,
                                                 **pq8),
                    PAGED_LENGTHS)
    return errors


def attention_inputs(b, s, h, hk, d, dtype, seed):
    """q, k, v as the model slices them out of one fused (B, S, H + 2Hkv,
    D) projection, and dO as every other head of a wider tensor: all
    strided, last dims contiguous."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, s, h + 2 * hk, d), generator=gen).to(dtype)
    wide = torch.randn((b, s, 2 * h, d), generator=gen).to(dtype)
    qkv, wide = qkv.to(DEVICE), wide.to(DEVICE)
    return (qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:],
            wide[:, :, ::2])


def check_attention_kernels() -> dict:
    """The forward kernel (out, LSE) and both backward kernels (dq; dk,
    dv), each against its plain version on the same CUDA tensors; the
    backward kernels read the plain forward's (out, lse), so each is held
    to its own plain version alone. The counters show the route each
    call took."""
    import torch

    from mmlspark_tpu_torch.ops import flash_attention as fa

    errors = {}
    for i, (name, b, s, h, hk, d, causal, window) in enumerate(ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}/{str(dtype).split('.')[1]}"
            tol_out, tol_lse, tol_grad = ATTN_TOLERANCE[tag.split("/")[1]]
            q, k, v, g = attention_inputs(b, s, h, hk, d, dtype, seed=70 + i)
            kw = dict(causal=causal, window=window, scale=d ** -0.5)
            before = {n: getattr(fa, n)
                      for n in ATTN_COUNTERS + ATTN_MMA_COUNTERS}
            out, lse = fa.flash_attention_forward(q, k, v, **kw)
            want_out, want_lse = fa.flash_attention_reference(q, k, v, **kw)
            grads = fa.flash_attention_backward(q, k, v, want_out, want_lse,
                                                g, **kw)
            want = fa.flash_attention_backward_reference(
                q, k, v, want_out, want_lse, g, **kw)
            torch.cuda.synchronize()
            mma = int(dtype == torch.bfloat16 and d in fa.MMA_HEAD_DIMS)
            added = {n: getattr(fa, n) - before[n] for n in before}
            if added != {**dict.fromkeys(ATTN_COUNTERS, 1),
                         **dict.fromkeys(ATTN_MMA_COUNTERS, mma)}:
                raise AssertionError(f"attention {tag}: launches {added}, "
                                     f"wanted the {'mma' if mma else 'simt'}"
                                     " route for every kernel")
            err = {"out": (out.float() - want_out.float()).abs().max().item(),
                   "lse": (lse - want_lse).abs().max().item()}
            for gname, got, ref in zip(("dq", "dk", "dv"), grads, want):
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    raise AssertionError(f"attention {tag} {gname}: "
                                         f"{got.shape}/{got.dtype}")
                diff = (got.float() - ref.float()).abs().max().item()
                err[gname + "_abs"] = diff
                err[gname] = diff / max(ref.float().abs().max().item(),
                                        1.0)
            errors[tag] = err
            log(f"attention kernels vs plain {tag}: {err}")
            bad = [key for key, limit in (("out", tol_out), ("lse", tol_lse),
                                          ("dq", tol_grad), ("dk", tol_grad),
                                          ("dv", tol_grad))
                   if not err[key] <= limit]
            if out.shape != q.shape or out.dtype != q.dtype or bad:
                raise AssertionError(f"attention {tag}: {bad} past "
                                     f"{ATTN_TOLERANCE}: {err}")
    return errors


# -- the fused optimizer ---------------------------------------------------------


def optimizer_inputs(kind: str, seed: int):
    """The full-width training model's parameter tensors (33.9 M f32
    elements in 102 tensors) as seeded parameters, gradients and the
    kind's moments (``nu`` positive), on the card."""
    import torch

    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.ops.fused_optim import moment_names

    graph = build_model("transformer_lm", **TRAIN_MODEL)  # on "meta"
    shapes = [t.shape for _, mod in graph.blocks
              for t in mod.state_dict().values()]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def make(scale=1.0, positive=False):
        out = [torch.randn(sh, generator=gen, device=DEVICE) * scale
               for sh in shapes]
        return [t.abs() for t in out] if positive else out

    moments = [make(0.01, positive=(name == "nu"))
               for name in moment_names(kind)]
    return make(), make(), moments


def optimizer_scalars(count: int, bad: bool):
    """-lr, adam's bias corrections at ``count`` and ``bad``, on the card
    (what ``ops/fused_optim.optimizer_update`` computes for a step)."""
    import torch

    from mmlspark_tpu_torch.ops import fused_optim as fo

    n = torch.full((), count, dtype=torch.int32, device=DEVICE)
    return (-torch.full((), 1e-3, device=DEVICE),
            1 - torch.pow(fo.ADAM_B1, n), 1 - torch.pow(fo.ADAM_B2, n),
            torch.tensor(bad, device=DEVICE))


def check_fused_optimizer() -> dict:
    """The fused optimizer kernel against its plain version on the same
    CUDA tensors at the full-width model's parameter shapes: bit-equal
    parameters and moments in f32 for adam, adamw, sgd and momentum, with
    the quarantine's ``bad`` false and true (nothing moves then)."""
    import torch

    from mmlspark_tpu_torch.ops import fused_optim as fo

    equal = {}
    for kind in fo.KINDS:
        for bad in (False, True):
            params, grads, moments = optimizer_inputs(kind, seed=9)
            plain_p = [p.clone() for p in params]
            plain_m = [[t.clone() for t in m] for m in moments]
            before = [p.clone() for p in params[:3]]
            args = optimizer_scalars(7, bad)
            kw = dict(weight_decay=0.1, momentum=0.9)
            fo._launch(kind, params, grads, moments, *args, **kw)
            fo.optimizer_update_reference(kind, plain_p, grads, plain_m,
                                          *args, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(
                params + sum(moments, []), plain_p + sum(plain_m, [])))
            if bad:
                same = same and all(torch.equal(a, b)
                                    for a, b in zip(params, before))
            equal[f"{kind}/bad={bad}"] = same
            del params, grads, moments, plain_p, plain_m
    log(f"fused optimizer vs plain, bit-equal: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"fused optimizer differs from its plain "
                             f"version: {equal}")
    return equal


def measure_fused_optimizer(equal: dict, launches: int) -> dict:
    """The fused optimizer's ``kernels`` row: adam over the full-width
    model's 33.9 M parameters; the plain version on the same tensors; and
    as the library yardstick ``torch.optim.Adam(fused=True).step()`` on
    the same tensors (no quarantine). Bound: 7 f32 a parameter (read p,
    g, m, v; write p, m, v) at the card's memory rate."""
    import torch

    from mmlspark_tpu_torch.ops import fused_optim as fo

    params, grads, moments = optimizer_inputs("adam", seed=10)
    args = optimizer_scalars(7, False)
    kernel_t = time_ms(lambda: fo._launch(
        "adam", params, grads, moments, *args, weight_decay=0.0,
        momentum=0.9), [()], reps=50)
    plain_t = time_ms(lambda: fo.optimizer_update_reference(
        "adam", params, grads, moments, *args), [()], reps=20)
    lib_params = [p.clone() for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    adam = torch.optim.Adam(lib_params, lr=1e-3, fused=True)
    library_t = time_ms(adam.step, [()], reps=50)
    n = sum(p.numel() for p in params)
    log(f"fused optimizer, adam over {n} parameters: device {kernel_t.ms:.4f}"
        f" ms, plain {plain_t.ms:.4f} ms, torch.optim.Adam(fused=True) "
        f"{library_t.ms:.4f} ms")
    return kernel_row(
        "fused_optim", "mmlspark_tpu_torch/csrc/fused_optim.cu",
        "mmlspark_tpu/train/trainer.py:575 (optax update inside the jitted "
        "step; no TPU kernel: XLA fusion in the reference)",
        launches, 0.0, kernel_t, plain_t,
        library_t, 7 * 4 * n, 13 * n, F32_FLOPS_PER_S,
        dict(parameters=n, tensors=len(params), optimizer="adam",
             dtype="float32"),
        library="torch.optim.Adam(fused=True).step(), which computes no "
                "quarantine",
        design="one multi-tensor launch: a grid over 4096-element chunks "
               "of every tensor, each element read and written once, "
               "__f*_rn arithmetic (bit-equal to the eager update)",
        bit_equal=equal)


# -- the engines ---------------------------------------------------------------


def random_schedule() -> list:
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(8, 65, size=N_REQUESTS)
    vocab = SERVE_MODEL["vocab_size"]
    return [rng.integers(0, vocab, size=int(n)) for n in prompt_lens]


def header_schedule() -> list:
    """Even requests: the 72-token header + an 8-32-token tail; odd
    requests: a random 8-64-token prompt."""
    rng = np.random.default_rng(2)
    vocab = SERVE_MODEL["vocab_size"]
    header = rng.integers(0, vocab, size=HEADER_LEN)
    prompts = []
    for i in range(N_REQUESTS):
        if i % 2 == 0:
            tail = rng.integers(0, vocab, size=int(rng.integers(8, 33)))
            prompts.append(np.concatenate([header, tail]))
        else:
            prompts.append(
                rng.integers(0, vocab, size=int(rng.integers(8, 65))))
    return prompts


def paged_num_pages() -> int:
    """Pages sized to the workload, as bench.py's paged group does: every
    slot at the longest request (header + longest tail + new tokens),
    plus slack for the trash page and the prefix entries' pages."""
    longest = HEADER_LEN + 32 + MAX_NEW
    return SLOTS * -(-longest // PAGE_SIZE) + 8


def make_engine(graph, variables, **kw):
    from mmlspark_tpu_torch.serve import ServeEngine

    return ServeEngine(graph, variables, slots=SLOTS, cache_len=CACHE_LEN,
                       decode_block=DECODE_BLOCK, max_queue=N_REQUESTS,
                       device=DEVICE, **kw)


def drive(engine, prompts) -> dict:
    """One main path: the prompts arrive 2 a tick, each asking for
    MAX_NEW tokens. Every launch count is set to 0 just before and read
    just after. Returns the results, the engine's metrics, the counts,
    the decode micro-steps and the ids of the requests that hit the
    prefix cache."""
    hits = set()
    by_prompt = {np.asarray(p, np.int32).tobytes(): i
                 for i, p in enumerate(prompts)}
    if getattr(engine.pool, "prefix_cache_enabled", False):
        # note which admissions the prefix cache served
        inner = engine._prefill

        def prefill(slot, prompt, *rest):
            before = engine.pool.prefix_hits
            out = inner(slot, prompt, *rest)
            if engine.pool.prefix_hits > before:
                hits.add(by_prompt[np.asarray(prompt, np.int32).tobytes()])
            return out

        engine._prefill = prefill
    zero_counts()
    submitted, results = 0, {}
    while submitted < len(prompts) or engine.busy:
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < len(prompts):
                engine.submit(prompts[submitted], MAX_NEW)
                submitted += 1
        for res in engine.step():
            results[res.id] = res
    counts = read_counts()
    micro_steps = sum(int(t) * n
                      for t, n in engine.metrics.decode_blocks.items())
    return dict(results=results, metrics=engine.metrics.to_dict(),
                counts=counts, micro_steps=micro_steps, hits=sorted(hits))


def check_run(label: str, run: dict, counter: str) -> None:
    """Every request completed inside the vocabulary, and the decode
    path launched its kernel once per layer per micro-step."""
    depth = SERVE_MODEL["depth"]
    results = run["results"]
    if len(results) != N_REQUESTS or any(
        r.status != "completed" or r.generated != MAX_NEW
        for r in results.values()
    ):
        raise AssertionError(
            f"{label}: not every request completed: "
            + str({i: (r.status, r.generated) for i, r in results.items()})
        )
    for r in results.values():
        gen = r.tokens[r.prompt_len:]
        if gen.min() < 0 or gen.max() >= SERVE_MODEL["vocab_size"]:
            raise AssertionError(f"{label}: request {r.id}: token out of "
                                 "vocab")
    launches, steps = run["counts"][counter], run["micro_steps"]
    log(f"{label}: {N_REQUESTS} requests completed, {steps} decode "
        f"micro-steps, launch counts {run['counts']}")
    if launches < depth * steps:
        raise AssertionError(
            f"{label}: {counter} = {launches} over {steps} micro-steps of "
            f"a {depth}-layer model: the decode path did not go through "
            "the kernel"
        )


def check_streams(graph, variables, prompts, results, ids, label: str,
                  exact: bool) -> list:
    """Each checked stream equals the port's generate(); with ``exact``
    False it may instead first differ at a near tie (top-2 margin of the
    full forward below BF16_LOGIT_TOL). Returns the divergences."""
    import torch

    from mmlspark_tpu_torch.models import generate

    diverged = []
    for rid in ids:
        want = generate(graph, variables, prompts[rid][None], MAX_NEW,
                        device=DEVICE)[0].cpu().numpy()
        got = results[int(rid)].tokens
        if np.array_equal(got, want):
            continue
        first = int(np.argmax(got != want))
        if exact or first < len(prompts[rid]):
            raise AssertionError(
                f"{label} request {rid}: stream differs from generate() "
                f"at token {first} (prompt length {len(prompts[rid])})"
            )
        ids_t = torch.from_numpy(want[None, :first].astype(np.int32))
        logits = graph.apply(variables, ids_t.to(DEVICE))[0, -1].float()
        top2 = logits.sort().values[-2:]
        margin = float(top2[1] - top2[0])
        if not margin < BF16_LOGIT_TOL:
            raise AssertionError(
                f"{label} request {rid}: stream differs from generate() at "
                f"token {first}, where the top-2 margin is {margin}"
            )
        diverged.append({"request": int(rid), "token": first,
                         "margin": margin})
    log(f"{label}: {len(ids)} streams equal generate() or first differ at "
        f"a near tie: {diverged}")
    return diverged


def flip_rate(want: dict, got: dict) -> float:
    """Share of generated tokens that differ, request by request."""
    flips = total = 0
    for rid, w in want.items():
        a, b = w.tokens[w.prompt_len:], got[rid].tokens[w.prompt_len:]
        n = min(len(a), len(b))
        flips += int(np.sum(a[:n] != b[:n])) + abs(len(a) - len(b))
        total += max(len(a), len(b))
    return flips / max(total, 1)


def program_summary(engine, peak: int) -> dict:
    """An engine's program ladder after a run: each family's program
    count beside its pin, the ladder sizes the run used, the captures'
    wall time, the shared graph pool's reserved bytes and the run's peak
    device memory over what was allocated before the engine."""
    return {
        "decode_compile_count": engine.decode_compile_count,
        "num_decode_blocks": engine.num_decode_blocks,
        "decode_block_sizes_run": sorted(
            int(t) for t in engine.metrics.decode_blocks),
        "prefill_compile_count": engine.prefill_compile_count,
        "resume_compile_count": engine.resume_compile_count,
        "num_prefill_buckets": engine.num_prefill_buckets,
        "capture_s": engine.capture_seconds,
        "graph_pool_bytes": engine.graph_pool_bytes(),
        "peak_memory_bytes": peak,
    }


def eager_twin(graph, variables, prompts, **kw) -> dict:
    """The same schedule through an engine whose programs are counted
    but never captured, so every call runs eagerly: the eager path's
    launch counts and speed beside the captured run's."""
    from mmlspark_tpu_torch.serve import engine as engine_mod
    from mmlspark_tpu_torch.testing.compile_guard import ProgramCountingGraph

    class EagerPrograms(ProgramCountingGraph):
        def _capture(self, args):
            return None

    engine_mod.ProgramCountingGraph = EagerPrograms
    try:
        engine = make_engine(graph, variables, **kw)
    finally:
        engine_mod.ProgramCountingGraph = ProgramCountingGraph
    return drive(engine, prompts)


def check_programs(label: str, run: dict, eager: dict) -> None:
    """The captured run's programs within their pins, one program for
    every ladder size it ran, and each kernel's launches counted on
    replay equal to the eager path's on the same schedule."""
    pr = run["programs"]
    over = [k for k, pin in (("decode_compile_count", "num_decode_blocks"),
                             ("prefill_compile_count", "num_prefill_buckets"),
                             ("resume_compile_count", "num_prefill_buckets"),
                             ("warm_resume_compile_count",
                              "num_prefill_buckets"))
            if pr[k] > pr[pin]]
    if over:
        raise AssertionError(f"{label}: {over} over their pins: {pr}")
    if pr["decode_compile_count"] != len(pr["decode_block_sizes_run"]) or \
            pr["prefill_compile_count"] < 1:
        raise AssertionError(f"{label}: a ladder size ran without its "
                             f"captured program: {pr}")
    if DEVICE == "cuda" and not (pr["capture_s"] > 0
                                 and pr["graph_pool_bytes"] > 0):
        raise AssertionError(f"{label}: nothing was captured: {pr}")
    if eager["counts"] != run["counts"] or \
            eager["micro_steps"] != run["micro_steps"]:
        raise AssertionError(
            f"{label}: launches counted on replay {run['counts']} over "
            f"{run['micro_steps']} micro-steps, eager {eager['counts']} "
            f"over {eager['micro_steps']}")
    m, e = run["metrics"], eager["metrics"]
    pr.update({k: m[k] for k in WARM_KEYS})
    pr.update(launch_counts=run["counts"], eager_launch_counts=eager["counts"],
              **{f"eager_{k}": e[k] for k in WARM_KEYS})
    log(f"{label}: programs " + str({
        k: v for k, v in pr.items() if not k.endswith("launch_counts")}))


def fresh_metrics(engine) -> None:
    """Give ``engine`` new, empty serving metrics, wired as its own."""
    from mmlspark_tpu_torch.serve import ServeMetrics

    old = engine.metrics
    engine.metrics = ServeMetrics(
        old.model, old.slots, decode_block=old.decode_block,
        cache_pool_bytes_per_device=old.cache_pool_bytes_per_device,
        kv_dtype=old.kv_dtype, prefill_chunk=old.prefill_chunk,
        async_host=old.async_host)
    if old._paging_provider is not None:
        engine.metrics.attach_paging(old._paging_provider)


WARM_KEYS = ("tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99", "per_token_ms",
             "per_token_ms_p50")


def graphed_run(label: str, graph, variables, prompts, counter: str,
                **kw):
    """One engine's main path on its captured programs, checked; then the
    same schedule again on the warm engine (every decode and prefill
    program already captured: none may be added; the prefix cache may
    send a request to a resume bucket the first pass did not use), and
    through its eager twin (``check_programs``). Returns the first run
    (with its ``programs`` summary, the warm pass's speed included) and
    the engine."""
    import torch

    from mmlspark_tpu_torch.testing import compile_guard

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine(graph, variables, **kw)
    run = drive(engine, prompts)
    peak = torch.cuda.max_memory_allocated() - base
    check_run(label, run, counter)
    run["programs"] = program_summary(engine, peak)
    fresh_metrics(engine)
    with compile_guard(lambda: engine.decode_compile_count, max_programs=0,
                       label=f"{label} warm decode"), \
            compile_guard(lambda: engine.prefill_compile_count,
                          max_programs=0, label=f"{label} warm prefill"):
        warm = drive(engine, prompts)
    check_run(f"{label} warm", warm, counter)
    run["programs"].update(
        {f"warm_{k}": warm["metrics"][k] for k in WARM_KEYS},
        warm_resume_compile_count=engine.resume_compile_count)
    check_programs(label, run, eager_twin(graph, variables, prompts, **kw))
    gc.collect()
    return run, engine


def check_engine(graph, variables) -> dict:
    """The dense bf16 engine on the random schedule (the first slice's
    main path)."""
    prompts = random_schedule()
    # warm the CUDA libraries up on a throwaway engine, outside the runs
    warm = make_engine(graph, variables)
    warm.submit(prompts[0], 4)
    warm.run()
    del warm
    gc.collect()

    run, _ = graphed_run("dense bf16", graph, variables, prompts,
                         "launches")
    ids = np.linspace(0, N_REQUESTS - 1, N_CHECKED).astype(int)
    check_streams(graph, variables, prompts, run["results"], ids,
                  "dense bf16", exact=True)
    gc.collect()
    return run


def check_header_engines(graph, variables) -> dict:
    """The shared-header schedule through the dense bf16, paged bf16
    (prefix cache), dense int8 and paged int8 (prefix cache) engines."""
    prompts = header_schedule()
    paged = dict(paged=True, page_size=PAGE_SIZE,
                 num_pages=paged_num_pages(), prefix_cache=True)
    runs, pools = {}, {}
    for label, kw, counter in (
        ("header dense bf16", {}, "launches"),
        ("header paged bf16", paged, "paged_launches"),
        ("header dense int8", dict(kv_dtype="int8"), "q8_launches"),
        ("header paged int8", dict(paged, kv_dtype="int8"),
         "paged_q8_launches"),
    ):
        runs[label], engine = graphed_run(label, graph, variables, prompts,
                                          counter, **kw)
        pools[label] = engine.pool
        del engine
        gc.collect()

    dense = runs["header dense bf16"]
    for label in ("header paged bf16", "header paged int8"):
        pool, run = pools[label], runs[label]
        stats = pool.paging_stats()
        refs, mapped = pool.refcount_audit()
        entry_pages = {p for e in pool._prefix.values() for p in e.pages}
        log(f"{label}: {stats}, refcount audit {refs} = {mapped}, prefix "
            f"hits on requests {run['hits']}")
        if stats["prefix_cache_hits_total"] < 1:
            raise AssertionError(f"{label}: no prefix-cache hit")
        if stats["cow_copies_total"] < 1:
            raise AssertionError(f"{label}: no copy-on-extend")
        if refs != mapped or stats["pages_free"] != (
                pool.pages_allocatable - len(entry_pages)):
            raise AssertionError(
                f"{label}: allocator audit after the drain: refcounts "
                f"{refs}, mapped {mapped}, pages free {stats['pages_free']}"
                f" of {pool.pages_allocatable}, {len(entry_pages)} pinned "
                "by prefix entries"
            )
        run["paging"] = stats
    paged_bytes = runs["header paged bf16"]["metrics"][
        "cache_pool_bytes_per_device"]
    dense_bytes = dense["metrics"]["cache_pool_bytes_per_device"]
    if not paged_bytes < dense_bytes:
        raise AssertionError(f"paged pool {paged_bytes} bytes, dense "
                             f"{dense_bytes}")
    hits = runs["header paged bf16"]["hits"]
    if len(hits) < 2:
        raise AssertionError(f"paged bf16: prefix hits on {hits}, "
                             "wanted 2 to check")
    # the first header request (a miss), a random one, and two hits
    checked = [0, 1] + [h for h in hits if h > 1][:2]
    runs["header paged bf16"]["diverged"] = check_streams(
        graph, variables, prompts, runs["header paged bf16"]["results"],
        checked, "header paged bf16", exact=False)
    for label in runs:
        runs[label]["flip_rate_vs_dense_bf16"] = flip_rate(
            dense["results"], runs[label]["results"])
    log("flip rates against the dense bf16 streams: " + str({
        k: r["flip_rate_vs_dense_bf16"] for k, r in runs.items()}))
    return runs


# -- chunked prefill, the async host loop, the resilience layer ------------------


def long_short_schedule() -> list:
    """The chunked/async schedule: 16 prompts arriving 2 a tick, even ones
    long (240-440 tokens: 4-7 chunks of 64), odd ones short (8-64)."""
    rng = np.random.default_rng(7)
    vocab = SERVE_MODEL["vocab_size"]
    return [rng.integers(0, vocab, size=int(
        rng.integers(240, 441) if i % 2 == 0 else rng.integers(8, 65)))
        for i in range(N_REQUESTS)]


def watch_fetches(engine) -> dict:
    """Count the engine's block fetches, and those that returned while the
    block dispatched after the fetched one was still running on the card
    (its staging event not yet complete): the async loop's overlap."""
    seen = {"fetches": 0, "overlapped_fetches": 0}
    inner = engine._fetch

    def fetch(inflight):
        out = inner(inflight)
        seen["fetches"] += 1
        nxt = engine._inflight
        if nxt is not None and nxt["event"] is not None and \
                not nxt["event"].query():
            seen["overlapped_fetches"] += 1
        return out

    engine._fetch = fetch
    return seen


def forced_logits(graph, variables, tokens):
    """The full forward's next-token logits over a stream: row t predicts
    token t + 1 (teacher forcing, f32)."""
    import torch

    ids = torch.from_numpy(np.asarray(tokens[:-1], np.int32)[None])
    return graph.apply(variables, ids.to(DEVICE))[0].float()


def check_near_ties(graph, variables, label: str, got: dict, want: dict,
                    exact: bool) -> dict:
    """Each stream of ``got`` against its twin in ``want``: equal, or —
    unless ``exact`` — first differing at a near tie (the twin's top-2
    margin under the full forward below BF16_LOGIT_TOL); and every token
    each stream emitted within BF16_LOGIT_TOL of the best logit of the
    full forward over that stream (checked on the differing streams and
    on 4 others). Returns the divergences and the largest per-step gap."""
    import torch

    diverged, worst = [], 0.0
    checked = sorted(got)[::max(1, len(got) // N_CHECKED)]
    for rid in sorted(got):
        g, w = got[rid], want[rid]
        same = g.tokens.shape == w.tokens.shape and \
            np.array_equal(g.tokens, w.tokens)
        if same and rid not in checked:
            continue
        logits = forced_logits(graph, variables, g.tokens)
        p = g.prompt_len
        steps = logits[p - 1:]
        picked = steps.gather(1, torch.from_numpy(
            g.tokens[p:].astype(np.int64))[:, None].to(DEVICE))[:, 0]
        gap = float((steps.max(dim=1).values - picked).max())
        worst = max(worst, gap)
        if gap > BF16_LOGIT_TOL:
            raise AssertionError(f"{label} request {rid}: an emitted token "
                                 f"is {gap} below the full forward's best")
        if same:
            continue
        n = min(len(g.tokens), len(w.tokens))
        first = int(np.argmax(g.tokens[:n] != w.tokens[:n])) if \
            (g.tokens[:n] != w.tokens[:n]).any() else n
        top2 = logits[first - 1].sort().values[-2:]
        margin = float(top2[1] - top2[0])
        if exact or first < p or not margin < BF16_LOGIT_TOL:
            raise AssertionError(
                f"{label} request {rid}: differs from its twin at token "
                f"{first} (prompt {p}), top-2 margin {margin}")
        diverged.append({"request": int(rid), "token": first,
                         "margin": margin})
    log(f"{label}: streams equal their twin's or first differ at a near "
        f"tie: {diverged}; largest emitted-token gap to the full forward's "
        f"best {worst:.4g}")
    return {"diverged": diverged, "max_emitted_gap": worst}


def short_ttft(metrics, results: dict, prompts) -> dict:
    """TTFT p50/p99 (ms) of the short requests of a pass."""
    short = {rid for rid in results
             if len(prompts[rid % len(prompts)]) <= 64}
    ttft = sorted(t * 1e3 for rid, t in zip(metrics.ttft_req_ids,
                                            metrics.ttft_s) if rid in short)
    if not ttft:
        return {"short_ttft_ms_p50": None, "short_ttft_ms_p99": None}
    return {"short_ttft_ms_p50": float(np.percentile(ttft, 50)),
            "short_ttft_ms_p99": float(np.percentile(ttft, 99))}


CHUNKED_KEYS = ("tokens_per_sec", "per_token_ms", "host_idle_fraction",
                "host_sync_wait_s", "overlapped_dispatches_total",
                "chunked_prefills_total", "decode_blocks")


def chunked_async_run(label, graph, variables, prompts, counter, **kw):
    """One engine mode's main path (the counts zeroed just before, read
    just after) and a warm pass of the same schedule on it. Gates: every
    request completes; the decode kernel launched ``depth`` times a
    micro-step; every program family within its pin; at most one fetch a
    dispatched block. Returns (the first pass's results, the summary)."""
    engine = make_engine(graph, variables, **kw)
    seen = watch_fetches(engine)
    run = drive(engine, prompts)
    check_run(label, run, counter)
    blocks = sum(engine.metrics.decode_blocks.values())
    first_seen = dict(seen)
    fresh_metrics(engine)
    warm = drive(engine, prompts)
    check_run(f"{label} warm", warm, counter)
    pins = {
        "decode_compile_count": (engine.decode_compile_count,
                                 engine.num_decode_blocks),
        "prefill_compile_count": (engine.prefill_compile_count,
                                  engine.num_prefill_buckets),
        "resume_compile_count": (engine.resume_compile_count,
                                 engine.num_prefill_buckets),
    }
    over = {k: v for k, v in pins.items() if v[0] > v[1]}
    if over:
        raise AssertionError(f"{label}: programs over their pins: {over}")
    if first_seen["fetches"] > blocks:
        raise AssertionError(f"{label}: {first_seen['fetches']} fetches for "
                             f"{blocks} blocks")
    m = warm["metrics"]
    out = {k: m[k] for k in CHUNKED_KEYS}
    out.update(short_ttft(engine.metrics, warm["results"], prompts),
               programs={k: v[0] for k, v in pins.items()},
               pins={k: v[1] for k, v in pins.items()},
               capture_s=engine.capture_seconds,
               launch_counts=run["counts"], decode_micro_steps=run[
                   "micro_steps"], blocks=blocks, **first_seen)
    log(f"{label}: {out}")
    del engine
    gc.collect()
    return run["results"], out


def host_timed(acc: dict, key: str, fn):
    """``fn``, adding the host's wall ms in each call to ``acc[key]``."""
    def timed(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            acc[key] += (time.perf_counter() - t0) * 1e3
    return timed


def profile_block_modes(graph, variables) -> dict:
    """Wall time and device busy share of steady T=32 blocks, sync against
    async: all 8 slots live, the programs captured, then 4 ticks under
    ``torch.profiler`` from an idle card to a synchronize; with the host's
    ms a block in the dispatch (inputs, the replay, the staging) and in
    the fetch (the wait included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, kw in (("sync", {}), ("async", dict(async_host=True))):
        engine = make_engine(graph, variables, **kw)
        rng = np.random.default_rng(1)
        for _ in range(SLOTS):
            engine.submit(rng.integers(0, SERVE_MODEL["vocab_size"],
                                       size=32), 1 + 8 * DECODE_BLOCK)
        for _ in range(3):
            engine.step()  # admissions, the T=32 program's eager call
        torch.cuda.synchronize()
        host = {"dispatch_ms": 0.0, "fetch_ms": 0.0}
        for name, attr in (("dispatch_ms", "_dispatch_block"),
                           ("fetch_ms", "_fetch_inflight")):
            setattr(engine, attr, host_timed(host, name,
                                             getattr(engine, attr)))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof_out = device_profile(prof, wall_ms)
        out[label] = dict(prof_out, block_wall_ms=wall_ms / 4, blocks=4,
                          host_dispatch_ms=host["dispatch_ms"] / 4,
                          host_fetch_ms=host["fetch_ms"] / 4,
                          decode_compile_count=engine.decode_compile_count)
        del engine
        gc.collect()
    log("block wall, busy share, host dispatch and fetch ms, sync vs "
        "async: " + str({k: (v["block_wall_ms"], v["device_busy_share"],
                             v["host_dispatch_ms"], v["host_fetch_ms"])
                         for k, v in out.items()}))
    return out


def check_chunked_async(graph, variables, header: dict) -> tuple:
    """The chunked/async phase: the long/short schedule through the dense
    bf16 engine sync and monolithic (a), chunked (b), async (c) and both
    (d); then chunked+async on the paged prefix-cache engines, bf16 and
    int8, over the shared-header schedule, against the header phase's
    sync monolithic runs. Gates: (c) bit-equal to (a); the others equal
    to their twin or first differing at a near tie; the async runs
    overlapped a fetch with a running block. Returns (the line, (d)'s
    results)."""
    prompts = long_short_schedule()
    chunk = dict(prefill_chunk=CHUNK)
    runs, results = {}, {}
    for key, kw in (("a_sync", {}), ("b_chunked", chunk),
                    ("c_async", dict(async_host=True)),
                    ("d_chunked_async", dict(chunk, async_host=True))):
        results[key], runs[key] = chunked_async_run(
            f"chunked_async {key}", graph, variables, prompts, "launches",
            **kw)
    check_near_ties(graph, variables, "chunked_async c_async",
                    results["c_async"], results["a_sync"], exact=True)
    for key in ("b_chunked", "d_chunked_async"):
        runs[key].update(check_near_ties(
            graph, variables, f"chunked_async {key}", results[key],
            results["a_sync"], exact=False))
    paged = dict(paged=True, page_size=PAGE_SIZE,
                 num_pages=paged_num_pages(), prefix_cache=True,
                 async_host=True, **chunk)
    hprompts = header_schedule()
    for key, kw, counter, twin in (
        ("paged_bf16_chunked_async", paged, "paged_launches",
         "header paged bf16"),
        ("paged_int8_chunked_async", dict(paged, kv_dtype="int8"),
         "paged_q8_launches", "header paged int8"),
    ):
        got, runs[key] = chunked_async_run(
            f"chunked_async {key}", graph, variables, hprompts, counter,
            **kw)
        runs[key].update(check_near_ties(
            graph, variables, f"chunked_async {key}", got,
            header[twin]["results"], exact=False))
    for key, run in runs.items():
        if "async" in key and not (run["overlapped_dispatches_total"] > 0
                                   and run["overlapped_fetches"] > 0):
            raise AssertionError(f"chunked_async {key}: no pipelined "
                                 f"overlap: {run}")
    line = {"runs": runs, "block_modes": profile_block_modes(graph,
                                                             variables),
            "prefill_chunk": CHUNK, "long_prompts": [240, 440],
            "short_prompts": [8, 64]}
    return line, results["d_chunked_async"]


def drive_until_killed(engine, prompts, submitted: int, results: dict):
    """``drive``'s arrivals from request ``submitted`` on, until the
    engine drains or is killed; returns (submitted, killed)."""
    from mmlspark_tpu_torch.core.faults import EngineKilled

    while submitted < len(prompts) or engine.busy:
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < len(prompts):
                engine.submit(prompts[submitted], MAX_NEW)
                submitted += 1
        try:
            for res in engine.step():
                results[res.id] = res
        except EngineKilled:
            return submitted, True
    return submitted, False


def check_resilience(graph, variables, clean: dict) -> dict:
    """The resilience phase on the async chunked dense engine: a fault
    schedule (a transient and two OOMs at ``serve.decode``, the first
    fetched block holding slot 1 poisoned at ``serve.device_get``)
    against the fault-free run
    (``clean``); a real allocation failure; the crash drill (a kill at
    ``serve.prefill`` mid-fill, restore from ``last_snapshot``); and a
    bit-flipped snapshot."""
    import torch

    from mmlspark_tpu_torch.core import integrity
    from mmlspark_tpu_torch.core.faults import (
        Fault,
        FaultInjector,
        is_resource_exhausted,
    )
    from mmlspark_tpu_torch.core.integrity import SnapshotCorruption
    from mmlspark_tpu_torch.serve import ServeEngine

    prompts = long_short_schedule()
    kw = dict(prefill_chunk=CHUNK, async_host=True, retry_backoff_s=0.0,
              degrade_recover_ticks=4)
    inj = FaultInjector([
        Fault("serve.decode", "transient"),
        Fault("serve.decode", "oom", times=2),
        Fault("serve.device_get", "poison", slot=1),
    ])
    engine = make_engine(graph, variables, faults=inj, **kw)
    zero_counts()
    results = {}
    drive_until_killed(engine, prompts, 0, results)
    counts = read_counts()
    failed = [rid for rid, r in results.items() if r.status == "failed"]
    if len(results) != N_REQUESTS or len(failed) != 1 or \
            inj.counts != {"transient": 1, "oom": 2, "poison": 1}:
        raise AssertionError(f"resilience: results {len(results)}, failed "
                             f"{failed}, faults {inj.counts}")
    bad = results[failed[0]]
    if not np.array_equal(bad.tokens,
                          clean[failed[0]].tokens[:len(bad.tokens)]):
        raise AssertionError("resilience: the quarantined request's "
                             "tokens are not its real pre-fault tokens")
    ok = {rid: r for rid, r in results.items() if rid != failed[0]}
    ties = check_near_ties(graph, variables, "resilience", ok, clean,
                           exact=False)
    if engine.degraded or engine.decode_compile_count > \
            engine.num_decode_blocks or counts["launches"] <= 0:
        raise AssertionError(
            f"resilience: degraded {engine.degraded}, decode programs "
            f"{engine.decode_compile_count}, counts {counts}")
    faulted = {"faults": dict(inj.counts), "failed_request": failed[0],
               "retries_total": engine.metrics.retries_total,
               "quarantined_total": engine.metrics.quarantined_total,
               "decode_blocks": engine.metrics.decode_blocks,
               "decode_compile_count": engine.decode_compile_count,
               "degraded_at_end": engine.degraded, "launch_counts": counts,
               **ties}
    del engine
    gc.collect()

    try:
        torch.empty(1 << 46, device=DEVICE)
        raise AssertionError("a 256 TiB allocation succeeded")
    except AssertionError:
        raise
    except Exception as e:  # noqa: BLE001 — classified just below
        oom = {"type": type(e).__name__,
               "is_resource_exhausted": is_resource_exhausted(e)}
    if not oom["is_resource_exhausted"]:
        raise AssertionError(f"resilience: a real OOM classified {oom}")

    # the crash drill: snapshots every tick, a kill at the prefill site
    # while fills are open, a restore from the last complete snapshot
    inj = FaultInjector([Fault("serve.prefill", "kill", tick=KILL_TICK)])
    engine = make_engine(graph, variables, faults=inj,
                         snapshot_every_ticks=1, **kw)
    zero_counts()
    results = {}
    _, killed = drive_until_killed(engine, prompts, 0, results)
    snap = engine.last_snapshot
    filling = len(engine._sched.filling)
    del engine
    gc.collect()
    if not killed or not filling:
        raise AssertionError(f"resilience: the kill did not land mid-fill "
                             f"(killed {killed}, fills open {filling})")
    rebuilt = ServeEngine.restore(snap, graph, variables, slots=SLOTS,
                                  decode_block=DECODE_BLOCK,
                                  max_queue=N_REQUESTS, device=DEVICE, **kw)
    # requests submitted after the snapshot died with the engine: they
    # arrive again, and take the same ids
    drive_until_killed(rebuilt, prompts, snap["next_id"], results)
    counts = read_counts()
    if len(results) != N_REQUESTS or any(
            r.status != "completed" for r in results.values()):
        raise AssertionError("resilience crash drill: not every request "
                             "completed")
    drill = {"kill_tick": KILL_TICK, "snapshot_tick": snap["tick"],
             "restored_active": len(snap["active"]),
             "restored_queued": len(snap["queued"]),
             "launch_counts": counts,
             **check_near_ties(graph, variables, "crash drill", results,
                               clean, exact=False)}
    del rebuilt
    gc.collect()

    flipped = integrity.flip_bit_json(snap, 11)
    try:
        ServeEngine.restore(flipped, graph, variables, device=DEVICE)
        raise AssertionError("a bit-flipped snapshot restored")
    except SnapshotCorruption as e:
        corrupt = {"raised": type(e).__name__, "expected": e.expected,
                   "actual": e.actual}
    log(f"resilience: faulted run {faulted}; OOM {oom}; crash drill "
        f"{drill}; corrupt snapshot {corrupt}")
    return {"faulted": faulted, "real_oom": oom, "crash_drill": drill,
            "corrupt_snapshot": corrupt}


# -- generation and the weight-int8 engines --------------------------------------


def zero_counts() -> None:
    import torch

    import mmlspark_tpu_torch.ops.flash_attention as fa
    import mmlspark_tpu_torch.ops.fused_optim as fo
    import mmlspark_tpu_torch.ops.tree_checksum as tc

    torch.cuda.synchronize()
    for name in COUNTERS:
        setattr(fa, name, 0)
    fo.launches = 0
    tc.launches = 0


def read_counts() -> dict:
    import torch

    import mmlspark_tpu_torch.ops.flash_attention as fa
    import mmlspark_tpu_torch.ops.fused_optim as fo
    import mmlspark_tpu_torch.ops.tree_checksum as tc

    torch.cuda.synchronize()
    return {**{name: getattr(fa, name) for name in COUNTERS},
            "fused_optim_launches": fo.launches,
            "tree_checksum_launches": tc.launches}


def timed_path(fn):
    """One main path: the counts set to 0 just before ``fn()`` and read
    just after; returns (its result, wall ms, the counts)."""
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    counts = read_counts()
    return out, (time.perf_counter() - t0) * 1e3, counts


def numpy_support(logits: np.ndarray, temperature, top_k, top_p):
    """The tokens JAX's ``generate`` may sample from ``logits`` (B, V):
    its top-k and nucleus filter (``mmlspark_tpu/models/generate.py``
    l.330-348) transcribed in numpy, independent of the port's code."""
    x = logits.astype(np.float32) / np.float32(temperature)
    kth = -np.sort(-x, axis=-1)[:, top_k - 1:top_k]
    x = np.where(x < kth, -np.inf, x)
    srt = -np.sort(-x, axis=-1)
    z = np.exp(srt - srt[:, :1])
    probs = z / z.sum(axis=-1, keepdims=True)
    kept = np.cumsum(probs, axis=-1) - probs < top_p
    thresh = np.min(np.where(kept, srt, np.inf), axis=-1, keepdims=True)
    return x >= thresh


def check_launches(label: str, counts: dict, counter: str, want: int):
    if counts[counter] < want:
        raise AssertionError(f"{label}: {counter} = {counts[counter]}, "
                             f"wanted at least {want}: the path did not "
                             "go through the kernel")


def check_sampling(graph, variables, prompts) -> dict:
    """Sampled generation twice from one seed: equal streams, and every
    drawn token inside the support recomputed from its step's logits."""
    import importlib

    import torch

    from mmlspark_tpu_torch.models import generate

    gen_mod = importlib.import_module("mmlspark_tpu_torch.models.generate")
    filter_logits = gen_mod.filter_logits
    steps = []

    def recorded(logits, *args):  # each step's logits, as sampled
        steps.append(logits.float().cpu().numpy())
        return filter_logits(logits, *args)

    def run(seed):
        return generate(graph, variables, prompts, GEN_NEW,
                        rng=torch.Generator(device=DEVICE).manual_seed(seed),
                        device=DEVICE, **SAMPLING)

    gen_mod.filter_logits = recorded
    try:
        first, ms, counts = timed_path(lambda: run(0))
        recorded_steps, steps[:] = list(steps), []
        again = run(0)
    finally:
        gen_mod.filter_logits = filter_logits
    depth = SERVE_MODEL["depth"]
    check_launches("sampling", counts, "launches", depth * (GEN_NEW - 1))
    if not torch.equal(first, again):
        raise AssertionError("sampling: one seed gave two streams")
    drawn = first[:, GEN_PROMPT:].cpu().numpy()
    outside = 0
    for t, logits in enumerate(recorded_steps):
        support = numpy_support(logits, **SAMPLING)
        outside += int((~support[np.arange(GEN_BATCH), drawn[:, t]]).sum())
    kept = [int(numpy_support(lg, **SAMPLING).sum(axis=1).mean())
            for lg in recorded_steps[::32]]
    log(f"sampling: {GEN_BATCH} x {GEN_NEW} tokens in {ms:.1f} ms, counts "
        f"{counts}, {outside} drawn outside the support, mean support "
        f"{kept}")
    if len(recorded_steps) != GEN_NEW or outside:
        raise AssertionError(f"sampling: {len(recorded_steps)} steps, "
                             f"{outside} tokens outside the support")
    return {"wall_ms": ms, "launch_counts": counts, "equal_streams": True,
            "tokens_outside_support": outside,
            "mean_support_every_32_steps": kept, **SAMPLING}


def check_recompute(graph, variables, prompts) -> dict:
    """Greedy ``kv_cache=False`` (the flash forward over the whole
    buffer) against the cached path (the decode kernel): tokens equal,
    or a row's first difference at a near tie of the recompute logits;
    and each cached step's logits against a teacher-forced forward over
    the cached tokens, within BF16_LOGIT_TOL."""
    import importlib

    import torch

    from mmlspark_tpu_torch.models import generate

    gen_mod = importlib.import_module("mmlspark_tpu_torch.models.generate")
    greedy_next = gen_mod.greedy_next
    steps = []

    def recorded(logits):
        steps.append(logits.float())
        return greedy_next(logits)

    gen_mod.greedy_next = recorded
    try:
        cached, cached_ms, cached_counts = timed_path(lambda: generate(
            graph, variables, prompts, GEN_NEW, device=DEVICE))
    finally:
        gen_mod.greedy_next = greedy_next
    recompute, ms, counts = timed_path(lambda: generate(
        graph, variables, prompts, GEN_NEW, kv_cache=False, device=DEVICE))
    depth = SERVE_MODEL["depth"]
    check_launches("cached greedy", cached_counts, "launches",
                   depth * (GEN_NEW - 1))
    check_launches("recompute", counts, "fwd_mma_launches", depth * GEN_NEW)
    # the recompute path's logits of the cached tokens, every position
    forced = graph.apply(variables, cached)[:, GEN_PROMPT - 1:-1].float()
    step_logits = torch.stack(steps, dim=1)  # (B, N, V)
    logit_err = (step_logits - forced).abs().max().item()
    near_ties, diverged = 0, []
    got, want = recompute.cpu().numpy(), cached.cpu().numpy()
    for row in range(GEN_BATCH):
        diff = np.nonzero(got[row] != want[row])[0]
        if not diff.size:
            continue
        i = int(diff[0])
        top2 = forced[row, i - GEN_PROMPT].sort().values[-2:]
        margin = float(top2[1] - top2[0])
        diverged.append({"row": row, "token": i, "margin": margin})
        if i < GEN_PROMPT or not margin < BF16_LOGIT_TOL:
            raise AssertionError(f"recompute: row {row} differs from the "
                                 f"cached path at token {i}, top-2 margin "
                                 f"{margin}")
        near_ties += 1
    log(f"recompute: {ms:.1f} ms (cached {cached_ms:.1f} ms), counts "
        f"{counts}, near ties {near_ties} {diverged}, cached step logits vs "
        f"teacher-forced: max abs err {logit_err:.4g} (tolerance "
        f"{BF16_LOGIT_TOL})")
    if not logit_err <= BF16_LOGIT_TOL:
        raise AssertionError(f"recompute: step logits differ by {logit_err}")
    return {"wall_ms": ms, "launch_counts": counts,
            "cached_wall_ms": cached_ms, "cached_launch_counts": cached_counts,
            "near_ties": near_ties, "diverged": diverged,
            "step_logits_max_abs_err": logit_err,
            "tolerance": BF16_LOGIT_TOL}, cached


def check_beam(graph, variables, prompts) -> dict:
    """``beam_search(beams=4)``: beams=1 equals greedy ``generate``, the
    ``return_all`` scores are sorted, and the best beam's score equals
    the sum of its tokens' log-probs under a teacher-forced forward,
    within 2 BF16_LOGIT_TOL a token (the chosen logit and a step's
    log-sum-exp)."""
    import torch

    from mmlspark_tpu_torch.models import beam_search, generate

    (seqs, scores), ms, counts = timed_path(lambda: beam_search(
        graph, variables, prompts, BEAM_NEW, beams=BEAMS, return_all=True,
        device=DEVICE))
    check_launches("beam search", counts, "launches",
                   SERVE_MODEL["depth"] * (BEAM_NEW - 1))
    one = beam_search(graph, variables, prompts, BEAM_NEW, beams=1,
                      device=DEVICE)
    greedy = generate(graph, variables, prompts, BEAM_NEW, device=DEVICE)
    if not torch.equal(one, greedy):
        raise AssertionError("beam search: beams=1 differs from greedy")
    if not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        raise AssertionError(f"beam search: scores not sorted: {scores}")
    best = seqs[:, 0]
    lp = torch.log_softmax(graph.apply(variables, best).float(), dim=-1)
    tok = best[:, GEN_PROMPT:].long()
    forced = lp[:, GEN_PROMPT - 1:-1].gather(-1, tok[..., None]).sum(
        dim=(1, 2))
    err = (forced - scores[:, 0]).abs().max().item()
    tol = BEAM_NEW * 2 * BF16_LOGIT_TOL
    log(f"beam search: {GEN_BATCH} x {BEAMS} beams x {BEAM_NEW} tokens in "
        f"{ms:.1f} ms, counts {counts}, best scores "
        f"{scores[:, 0].tolist()}, teacher-forced max abs err {err:.4g} "
        f"(tolerance {tol})")
    if not err <= tol:
        raise AssertionError(f"beam search: best score differs from the "
                             f"teacher-forced sum by {err}")
    return {"wall_ms": ms, "launch_counts": counts, "beams": BEAMS,
            "best_scores": scores[:, 0].tolist(),
            "best_score_vs_teacher_forced_max_abs_err": err,
            "tolerance": tol, "beams_1_equals_greedy": True}


def check_generate(graph, variables) -> dict:
    """The generation paths at full width on GEN_BATCH seeded prompts of
    GEN_PROMPT tokens: sampling, the recompute oracle and beam search,
    each a main path of its own."""
    import torch

    rng = np.random.default_rng(7)
    prompts = torch.from_numpy(rng.integers(
        0, SERVE_MODEL["vocab_size"], size=(GEN_BATCH, GEN_PROMPT)).astype(
        np.int32)).to(DEVICE)
    recompute, _ = check_recompute(graph, variables, prompts)
    return {"sampling": check_sampling(graph, variables, prompts),
            "recompute": recompute,
            "beam_search": check_beam(graph, variables, prompts),
            "batch": GEN_BATCH, "prompt_len": GEN_PROMPT,
            "new_tokens": GEN_NEW, "beam_new_tokens": BEAM_NEW}


def check_quantized_engines(graph, variables, dense: dict) -> dict:
    """The random schedule through ``quantize_weights=True`` with dense
    bf16 KV and with paged int8 KV: every request completes through the
    decode kernels, the flip rate against the bf16 engine's streams, the
    device-resident weight bytes against f32, the engine's peak device
    memory over what was allocated before it, and no bf16 weight left
    bound after a call. Then the per-call dequantization alone."""
    import torch

    from mmlspark_tpu_torch.ops.quantize import (
        dequantize_weights,
        quantized_bytes,
    )

    prompts = random_schedule()
    paged = dict(paged=True, page_size=PAGE_SIZE,
                 num_pages=paged_num_pages(), kv_dtype="int8")
    runs = {}
    for label, kw, counter in (
        ("weight-int8 dense bf16 KV", {}, "launches"),
        ("weight-int8 paged int8 KV", paged, "paged_q8_launches"),
    ):
        run, engine = graphed_run(label, graph, variables, prompts, counter,
                                  quantize_weights=True, **kw)
        peak = run["programs"]["peak_memory_bytes"]
        stored, f32 = quantized_bytes(engine.variables)
        if not stored <= 0.3 * f32:
            raise AssertionError(f"{label}: weights {stored} bytes of "
                                 f"{f32} as f32")
        if graph._bound is not None:
            raise AssertionError(f"{label}: the graph kept bf16 weights")
        run.update(flip_rate_vs_dense_bf16=flip_rate(dense["results"],
                                                     run["results"]),
                   weight_bytes=stored, weight_bytes_f32=f32,
                   peak_memory_bytes=peak)
        log(f"{label}: {run['metrics']['tokens_per_sec']:.1f} tokens/s, "
            f"flip rate {run['flip_rate_vs_dense_bf16']:.3f}, weights "
            f"{stored} of {f32} bytes as f32, peak {peak} bytes over the "
            f"baseline, graph pool {run['programs']['graph_pool_bytes']} "
            "bytes")
        runs[label] = run
        qvars = engine.variables
        del engine
        gc.collect()
    deq = time_ms(lambda v: dequantize_weights(v), [(qvars,)], reps=50)
    # every kernel of a call, from the profiler: the event timer's spin
    # may not outlast a host loop of ~100 launches a call
    deq_profiled = profiler_ms(lambda v: dequantize_weights(v), [(qvars,)],
                               "", reps=20)
    t0 = time.perf_counter()
    for _ in range(20):
        graph.bind(dequantize_weights(qvars))
        graph.unbind()
    bind_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    n_leaves = sum(1 for b in qvars.values() for t in b.values()
                   if isinstance(t, dict))
    log(f"dequantize_weights: device {deq.ms:.4f} ms (covered "
        f"{deq.covered}; profiler {deq_profiled:.4f} ms), host-paced "
        f"{deq.call_ms:.4f} ms a call over {n_leaves} int8 leaves; with "
        f"bind and unbind {bind_ms:.3f} ms of host time")
    return runs, {"device_ms": deq.ms, "device_timer_covered": deq.covered,
                  "profiler_ms": deq_profiled, "call_ms": deq.call_ms,
                  "bind_unbind_host_ms": bind_ms, "int8_leaves": n_leaves}


# -- the int8 flip budget on a trained full-width model ------------------------

#: the JAX suite's int8 parity recipe (tests/test_quantized_serve.py:
#: overfit_periodic_lm on period 4, seq 16; the dense soak's prompts, 6
#: new tokens each, through slots=2, cache_len=32 engines), at the serve
#: model's full width. The suite trains its 32-wide model at lr 5e-2 for
#: 30 steps; at full width that rate does not learn the period, 5e-3
#: does (the phase checks that the bf16 streams follow it)
TRAINED_STEPS, TRAINED_LR, TRAINED_PERIOD, TRAINED_SEQ = 60, 5e-3, 4, 16
TRAINED_LENGTHS, TRAINED_NEW = (4, 1, 12, 7, 8, 3), 6
#: tests/test_quantized_serve.py's FLIP_BUDGET
FLIP_BUDGET = 0.25
#: the share of the bf16 oracle's tokens that must follow the task (the
#: period, or the motif below): below it the model has not learned it
#: and flips would measure ties
FOLLOW_FLOOR = 0.9
#: the periodic stream needs no attention (each next token is a function
#: of the current one), so its flips cannot see a wrong int8 cache read.
#: The recall task needs it: each row repeats a motif of MOTIF ids drawn
#: per row from 1..MOTIF_IDS, so the next token is the one MOTIF places
#: back, which neither the current token nor the position tells (one in
#: MOTIF_IDS without the cache). Fresh rows every step, so nothing is
#: memorised; the loss is over the predictable positions (>= MOTIF)
MOTIF, MOTIF_IDS, MOTIF_SEQ, MOTIF_BATCH = 4, 64, 32, 32
MOTIF_STEPS, MOTIF_LR, MOTIF_SEED = 200, 1e-3, 41
MOTIF_LENGTHS, MOTIF_NEW = (4, 9, 12, 7, 8, 5), 12


def suite_drive(graph, variables, prompts, new: int = TRAINED_NEW,
                **kw) -> dict:
    """The JAX suite's ``_drive``: every prompt submitted, a step after
    each second one, then run to the end; the counts set to 0 just before
    and read just after. Returns the streams by submission order."""
    from mmlspark_tpu_torch.serve import ServeEngine

    engine = ServeEngine(graph, variables, slots=2, cache_len=32,
                         max_queue=16, device=DEVICE, **kw)
    zero_counts()
    rids, results = [], {}
    for i, p in enumerate(prompts):
        rids.append(engine.submit(p, max_new_tokens=new))
        if i % 2:
            results.update({r.id: r for r in engine.step()})
    results.update(engine.run())
    counts = read_counts()
    streams = [np.asarray(results[rid].tokens)[len(p):]
               for rid, p in zip(rids, prompts)]
    return {"streams": streams, "counts": counts,
            "statuses": [results[rid].status for rid in rids]}


def stream_flips(want: list, got: list) -> float:
    """The suite's ``_flip_rate``: differing tokens (and any length
    difference) over the longer stream, summed over requests."""
    flips = total = 0
    for a, b in zip(want, got):
        n = min(len(a), len(b))
        flips += int(np.sum(a[:n] != b[:n])) + abs(len(a) - len(b))
        total += max(len(a), len(b))
    return flips / max(total, 1)


def motif_rows(n: int, seq: int, seed: int) -> np.ndarray:
    """n rows of ``seq`` tokens, each a motif of MOTIF ids from
    1..MOTIF_IDS (drawn per row) repeated."""
    motif = np.random.default_rng(seed).integers(1, MOTIF_IDS + 1,
                                                 size=(n, MOTIF))
    return np.tile(motif, (1, -(-seq // MOTIF)))[:, :seq].astype(np.int64)


def train_motif_lm(graph, steps: int = MOTIF_STEPS, lr: float = MOTIF_LR,
                   seed: int = MOTIF_SEED, log_every: int = 0):
    """The serve model trained on the recall task: ``steps`` adam steps
    at ``lr``, each on MOTIF_BATCH fresh rows of MOTIF_SEQ tokens, the
    cross-entropy over the positions the motif predicts. Returns the
    variables and the teacher-forced accuracy on a fresh batch at every
    ``log_every`` steps (``[(step, accuracy), ...]``)."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.models import init_variables

    variables = init_variables(graph, seed, device=DEVICE)
    leaves = [t.requires_grad_() for block in variables.values()
              for t in block.values()]
    opt = torch.optim.Adam(leaves, lr=lr)
    held = torch.from_numpy(motif_rows(MOTIF_BATCH, MOTIF_SEQ,
                                       seed - 1)).to(DEVICE)
    curve = []
    for step in range(1, steps + 1):
        ids = torch.from_numpy(motif_rows(
            MOTIF_BATCH, MOTIF_SEQ, seed * 10 ** 6 + step)).to(DEVICE)
        logits, _ = graph.apply(variables, ids, train=True)
        loss = F.cross_entropy(
            logits[:, MOTIF - 1:-1].float().reshape(-1, logits.shape[-1]),
            ids[:, MOTIF:].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (step % log_every == 0 or step == steps):
            with torch.no_grad():
                pred = graph.apply(variables, held)[:, MOTIF - 1:-1]
            curve.append((step, float(
                (pred.argmax(-1) == held[:, MOTIF:]).float().mean())))
    return ({name: {key: t.detach() for key, t in block.items()}
             for name, block in variables.items()}, curve)


def int8_flips(label: str, graph, variables, prompts, new: int,
               follows_task) -> dict:
    """The suite's schedule through the bf16 engine (the oracle), int8
    KV in the dense and the paged pool, and weight-int8 over int8 KV:
    the bf16 streams follow the task on FOLLOW_FLOOR of their tokens
    (``follows_task(request, position, token)``; below it flips would
    measure ties), every request completes, each int8 engine read its
    int8 decode kernel, and every flip rate against the bf16 streams is
    within FLIP_BUDGET."""
    oracle = suite_drive(graph, variables, prompts, new)
    follows = float(np.mean([
        follows_task(i, pos, tok)
        for i, (p, st) in enumerate(zip(prompts, oracle["streams"]))
        for pos, tok in enumerate(st, start=len(p))]))
    out = {"prompt_lengths": [len(p) for p in prompts], "new_tokens": new,
           "flip_budget": FLIP_BUDGET, "bf16_follows_task": follows,
           "bf16_launch_counts": oracle["counts"], "engines": {}}
    if not follows >= FOLLOW_FLOOR:
        raise AssertionError(f"trained int8 {label}: the bf16 streams "
                             f"follow the task on {follows} of their "
                             "tokens: the model did not learn it")
    for engine, kw, counter in (
        ("int8 KV dense", dict(kv_dtype="int8"), "q8_launches"),
        ("int8 KV paged", dict(kv_dtype="int8", paged=True),
         "paged_q8_launches"),
        ("weight-int8, int8 KV dense",
         dict(kv_dtype="int8", quantize_weights=True), "q8_launches"),
    ):
        run = suite_drive(graph, variables, prompts, new, **kw)
        rate = stream_flips(oracle["streams"], run["streams"])
        out["engines"][engine] = {"flip_rate_vs_bf16": rate,
                                  "launch_counts": run["counts"]}
        log(f"trained int8 {label} {engine}: flip rate {rate:.4f} (budget "
            f"{FLIP_BUDGET}), {counter} {run['counts'][counter]}")
        if set(run["statuses"]) != {"completed"} or \
                run["counts"][counter] < 1:
            raise AssertionError(f"trained int8 {label} {engine}: statuses "
                                 f"{run['statuses']}, counts {run['counts']}")
        if not rate <= FLIP_BUDGET:
            raise AssertionError(f"trained int8 {label} {engine}: flip rate "
                                 f"{rate} over the budget {FLIP_BUDGET}")
    return out


def check_trained_int8() -> dict:
    """The int8 flip budget at the serve model's full width, twice: on
    the JAX suite's recipe (``overfit_periodic_lm``, period 4, seq 16;
    its prompts) and on the recall task, which only a model that reads
    its cache can follow (prompts of fresh rows, each holding at least
    one whole motif). See :func:`int8_flips` for the gates."""
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.testing.datagen import overfit_periodic_lm

    graph = build_model("transformer_lm", **SERVE_MODEL)
    t0 = time.perf_counter()
    variables, ids = overfit_periodic_lm(
        graph, steps=TRAINED_STEPS, seq=TRAINED_SEQ, period=TRAINED_PERIOD,
        lr=TRAINED_LR, device=DEVICE)
    train_s = time.perf_counter() - t0
    row = ids[0].cpu().numpy().astype(np.int32)
    periodic = int8_flips(
        "periodic", graph, variables, [row[:n] for n in TRAINED_LENGTHS],
        TRAINED_NEW,
        lambda i, pos, tok: tok == (pos % TRAINED_PERIOD) + 1)
    periodic.update(train_steps=TRAINED_STEPS, lr=TRAINED_LR,
                    period=TRAINED_PERIOD, seq=TRAINED_SEQ, train_s=train_s)
    del variables
    t0 = time.perf_counter()
    variables, curve = train_motif_lm(graph, log_every=MOTIF_STEPS // 4)
    train_s = time.perf_counter() - t0
    rows = motif_rows(len(MOTIF_LENGTHS), MOTIF_SEQ, MOTIF_SEED + 1)
    motif = int8_flips(
        "recall", graph, variables,
        [r[:n].astype(np.int32) for r, n in zip(rows, MOTIF_LENGTHS)],
        MOTIF_NEW, lambda i, pos, tok: tok == rows[i, pos])
    motif.update(train_steps=MOTIF_STEPS, lr=MOTIF_LR, motif=MOTIF,
                 motif_ids=MOTIF_IDS, seq=MOTIF_SEQ, batch=MOTIF_BATCH,
                 train_s=train_s, held_out_accuracy=curve)
    return {"model": SERVE_MODEL, "periodic": periodic, "recall": motif}


# -- the full-width model, card vs CPU ------------------------------------------


def f32_graph(**kw):
    import torch

    from mmlspark_tpu_torch.models import build_model

    graph = build_model("transformer_lm", **dict(SERVE_MODEL, **kw))
    for _, mod in graph.blocks:
        for m in mod.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
    return graph


def check_model_vs_cpu(seed: int = 1) -> float:
    """The full-width model in float32: prefill 15 tokens, then one
    decode step through the kernel on the card, against the same on the
    CPU (the plain path), on identical weights."""
    import torch

    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.models.generate import _cached_apply

    graph = f32_graph()
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, SERVE_MODEL["vocab_size"], size=(2, 16)).astype(np.int32))
    logits = {}
    for dev in ("cpu", DEVICE):
        variables = init_variables(graph, seed, device=dev)
        d = SERVE_MODEL["d_model"] // SERVE_MODEL["heads"]
        cache = {
            f"block{i}": tuple(
                torch.zeros((2, 32, SERVE_MODEL["heads"], d), device=dev)
                for _ in range(2))
            for i in range(SERVE_MODEL["depth"])
        }
        x = ids.to(dev)
        _, cache = _cached_apply(graph, variables, x[:, :15], cache, 0)
        out, _ = _cached_apply(
            graph, variables, x[:, 15:], cache,
            torch.full((2,), 15, dtype=torch.int32, device=dev), step=True,
        )
        logits[dev] = out.cpu()
    got = logits[DEVICE]
    if got.shape != (2, 1, SERVE_MODEL["vocab_size"]) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"bad decode logits: shape {got.shape}")
    err = (got - logits["cpu"]).abs().max().item()
    log(f"full-width f32 cached decode, card vs CPU: max abs err {err:.3g}")
    # f32 end to end; the two devices sum in other orders through 8
    # layers, so allow 1e-3 on logits of magnitude ~5
    if not err <= 1e-3:
        raise AssertionError(f"card vs CPU logits differ by {err}")
    return err


def pool_caches(linear: dict, gen) -> dict:
    """The serve pools' decode formats of one prefilled linear f32 cache
    per block ((2, 32, H, D), 16 live positions): paged float32 pages of
    8 through a shuffled table, the dense int8 4-tuple with per-(row, kv
    head) scales, and the paged int8 5-tuple with per-page scales."""
    import torch

    from mmlspark_tpu_torch.serve.cache_pool import (
        kv_head_scales,
        quantize_kv,
    )

    ps, max_pages = 8, 4
    b = 2
    num_pages = b * max_pages + 1
    perm = (torch.randperm(num_pages - 1, generator=gen) + 1).tolist()
    pt = torch.zeros((b, max_pages), dtype=torch.int32)
    pt[:, :2] = torch.tensor(perm[:4]).reshape(b, 2)  # 16 live: 2 pages
    formats = {"paged_f32": {}, "dense_int8": {}, "paged_int8": {}}
    for name, (ck, cv) in linear.items():
        pages, q8, pq8 = [], [], []
        for t in (ck, cv):
            store = torch.zeros((num_pages,) + (t.shape[2], ps, t.shape[3]))
            for row in range(b):
                for j in range(2):
                    store[pt[row, j]] = t[row, j * ps:(j + 1) * ps].transpose(
                        0, 1)
            pages.append(store)
            scale = kv_head_scales(t, axes=(1, 3))  # (B, H)
            q8.append((quantize_kv(t, scale[:, None, :]), scale))
            pscale = kv_head_scales(store, axes=(2, 3))  # (pages, H)
            pq8.append((torch.round(store / pscale[:, :, None, None])
                        .clamp(-127, 127).to(torch.int8), pscale))
        formats["paged_f32"][name] = (pages[0], pages[1], pt)
        formats["dense_int8"][name] = (q8[0][0], q8[1][0], q8[0][1],
                                       q8[1][1])
        formats["paged_int8"][name] = (pq8[0][0], pq8[1][0], pt, pq8[0][1],
                                       pq8[1][1])
    return formats


def check_cache_formats_vs_cpu(seed: int = 2) -> dict:
    """The full-width f32 model's decode step over the paged and int8
    caches, on the card (the paged and int8 kernels) against the CPU
    (their plain versions). The caches are built once on the CPU and
    copied. Paged f32 within 1e-3, as the dense cache; int8 within 1e-2:
    the step re-quantizes its own K/V on each device, and a value may
    land one int8 step apart."""
    import torch

    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.models.generate import _cached_apply

    graph = f32_graph()
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, SERVE_MODEL["vocab_size"], size=(2, 16)).astype(np.int32))
    d = SERVE_MODEL["d_model"] // SERVE_MODEL["heads"]
    cpu_vars = init_variables(graph, seed, device="cpu")
    linear = {
        f"block{i}": tuple(torch.zeros((2, 32, SERVE_MODEL["heads"], d))
                           for _ in range(2))
        for i in range(SERVE_MODEL["depth"])
    }
    _, linear = _cached_apply(graph, cpu_vars, ids[:, :15], linear, 0)
    formats = pool_caches(linear, torch.Generator().manual_seed(seed))
    dev_vars = init_variables(graph, seed, device=DEVICE)
    errors = {}
    for fmt, caches in formats.items():
        logits = {}
        for dev, variables in (("cpu", cpu_vars), (DEVICE, dev_vars)):
            cache = {n: tuple(t.clone().to(dev) for t in c)
                     for n, c in caches.items()}
            out, _ = _cached_apply(
                graph, variables, ids[:, 15:].to(dev), cache,
                torch.full((2,), 15, dtype=torch.int32, device=dev),
                step=True,
            )
            logits[dev] = out.cpu()
        got = logits[DEVICE]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{fmt}: non-finite decode logits")
        err = (got - logits["cpu"]).abs().max().item()
        tol = 1e-3 if fmt == "paged_f32" else 1e-2
        errors[fmt] = err
        log(f"full-width f32 decode over {fmt}, card vs CPU: max abs err "
            f"{err:.3g} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"{fmt}: card vs CPU logits differ by "
                                 f"{err}")
    return errors


# -- training ------------------------------------------------------------------


def progression_rows(n: int, seed: int):
    """n rows of max_len tokens, each an arithmetic progression mod the
    vocabulary with a random start and stride (each next token follows
    from the last two, so a model can learn it); labels are the rows
    shifted by one."""
    rng = np.random.default_rng(seed)
    vocab, seq = SERVE_MODEL["vocab_size"], SERVE_MODEL["max_len"]
    start = rng.integers(0, vocab, size=(n, 1))
    stride = rng.integers(1, 64, size=(n, 1))
    x = ((start + stride * np.arange(seq)) % vocab).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def make_trainer(graph, recorder=None):
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    return SPMDTrainer(graph, TrainConfig(
        epochs=1, batch_size=TRAIN_BATCH, learning_rate=1e-3,
        optimizer="adam", log_every=1, shuffle=True), recorder=recorder,
        device=DEVICE)


def run_training(label: str, model: dict, steps: int, seed: int,
                 name: str = "transformer_lm"):
    """One training main path: ``steps`` adam steps of model ``name``
    through ``SPMDTrainer``, the counts set to 0 just before and read
    just after, and every dense-attention call counted. Returns the
    summary and the trained variables."""
    import torch

    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.models import transformer

    graph = build_model(name, **model)
    variables = init_variables(graph, seed, device=DEVICE)
    x, y = progression_rows(steps * TRAIN_BATCH, seed)
    trainer = make_trainer(graph)
    dense_calls = []
    dense = transformer.dense_attention

    def counted(*args, **kw):
        dense_calls.append(1)
        return dense(*args, **kw)

    transformer.dense_attention = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        trained = trainer.train(x, y, init_variables=variables)
        counts = read_counts()
    finally:
        transformer.dense_attention = dense
    peak = torch.cuda.max_memory_allocated()
    programs = trainer.telemetry.counter("retrace.train.step").value
    capture_s = trainer.telemetry.gauge("train.step_capture_s").value
    losses = [h["loss"] for h in trainer.history]
    # log_every=1: the trainer syncs on each step's loss, so the gaps
    # between its step events are the steps' wall times (steps 2+)
    stamps = [e["t"] for e in trainer.recorder.events()
              if e["name"] == "step"]
    step_ms = statistics.median(
        (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    tokens = TRAIN_BATCH * SERVE_MODEL["max_len"]
    want = model["depth"] * steps
    log(f"training {label}: losses {losses}, counts {counts}, dense "
        f"attention calls {len(dense_calls)}, step {step_ms:.2f} ms, "
        f"{programs} step program captured in {capture_s} s")
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training {label}: losses {losses}")
    if not counts["fwd_launches"] == counts["bwd_kv_launches"] == \
            counts["bwd_q_launches"] == want:
        raise AssertionError(f"training {label}: {counts}, wanted {want} "
                             "launches of each attention kernel")
    # bf16 at head dim 64: every attention launch takes the tensor cores
    for name in ATTN_COUNTERS:
        if counts[name.replace("_launches", "_mma_launches")] != want:
            raise AssertionError(f"training {label}: {counts}: a {name} "
                                 "launch did not take the mma kernel")
    if dense_calls:
        raise AssertionError(f"training {label}: dense attention ran "
                             f"{len(dense_calls)} times")
    # one step program, captured, and one fused optimizer pass a step
    # (the CPU, in a rehearsal, captures nothing and runs the plain update)
    if programs != 1 or DEVICE == "cuda" and not (
            capture_s > 0 and counts["fused_optim_launches"] == steps):
        raise AssertionError(f"training {label}: {programs} step programs "
                             f"(capture {capture_s} s), fused optimizer "
                             f"launches {counts['fused_optim_launches']}")
    return {
        "model": model, "steps": steps, "batch": TRAIN_BATCH,
        "losses": losses, "launch_counts": counts,
        "step_programs": programs, "step_capture_s": capture_s,
        "dense_attention_calls": len(dense_calls),
        "step_ms_median_steps_2_on": step_ms,
        "tokens_per_sec": tokens / (step_ms / 1e3),
        "peak_memory_bytes": peak,
    }, trained


def check_train_step_vs_cpu(seed: int = 3) -> dict:
    """One training step of the full-width float32 flash model — forward,
    loss, backward — on the card (the kernels) and on the CPU (their
    plain versions), from the same weights and the same 2 x 512 batch."""
    from mmlspark_tpu_torch.models import init_variables

    graph = f32_graph(attn_impl="flash")
    x, y = progression_rows(2, seed)
    return train_step_card_vs_cpu(
        "full-width f32 train step", graph,
        init_variables(graph, seed, device="cpu"), x, y,
        SERVE_MODEL["depth"])


def train_step_card_vs_cpu(label: str, graph, weights: dict, x, y,
                           depth: int, aux_weight: float = 0.0) -> dict:
    """One float32 training step of ``graph`` — forward, the masked loss
    plus ``aux_weight`` times the sown losses (the trainer's
    ``moe_aux_weight``), backward — on the card (the kernels) and on the
    CPU (their plain versions), from the same weights and batch: the loss
    within 1e-4 relative, every gradient within 1e-3 of its leaf's
    largest, each attention kernel launched ``depth`` times on the
    f32-FMA route."""
    import torch

    from mmlspark_tpu_torch.train import masked_loss
    from mmlspark_tpu_torch.train.trainer import sown_aux_loss

    import mmlspark_tpu_torch.ops.flash_attention as fa

    results = {}
    for dev in ("cpu", DEVICE):
        # the card's launches (the CPU's plain versions launch nothing)
        before = {n: getattr(fa, n) for n in ATTN_COUNTERS + ATTN_MMA_COUNTERS}
        variables = {
            b: {k: t.detach().to(dev, copy=True).requires_grad_(True)
                for k, t in leaves.items()}
            for b, leaves in weights.items()
        }
        mask = torch.ones(len(x), dtype=torch.bool, device=dev)
        out, updated = graph.apply(variables, torch.from_numpy(x).to(dev),
                                   train=True, mask=mask)
        loss = masked_loss("softmax_xent", out,
                           torch.from_numpy(y).to(dev), mask)
        loss = loss + aux_weight * sown_aux_loss(updated)
        loss.backward()
        results[dev] = (loss.item(), {
            f"{b}.{k}": t.grad.cpu() for b, leaves in variables.items()
            for k, t in leaves.items()})
    added = {n: getattr(fa, n) - before[n] for n in before}
    # float32: every attention kernel on the f32-FMA route, none on mma
    if added != {**dict.fromkeys(ATTN_COUNTERS, depth),
                 **dict.fromkeys(ATTN_MMA_COUNTERS, 0)}:
        raise AssertionError(f"{label} card vs CPU: launches {added}")
    (cpu_loss, cpu_grads), (loss, grads) = results["cpu"], results[DEVICE]
    loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
    grad_rel = {}
    for name, want in cpu_grads.items():
        err = (grads[name] - want).abs().max().item()
        scale = want.abs().max().item()
        grad_rel[name] = err / scale if scale else err
        if not err <= 1e-3 * scale:
            raise AssertionError(f"{label} card vs CPU: {name} grads "
                                 f"differ by {err} (leaf max {scale})")
    worst = max(grad_rel, key=grad_rel.get)
    log(f"{label}, card vs CPU: loss {loss} vs {cpu_loss} (rel "
        f"{loss_rel:.3g}), worst grad {worst} {grad_rel[worst]:.3g} of its "
        "leaf's max")
    if not np.isfinite(loss) or not loss_rel <= 1e-4:
        raise AssertionError(f"{label} loss {loss} vs CPU {cpu_loss}")
    return {"loss": loss, "cpu_loss": cpu_loss, "loss_rel_err": loss_rel,
            "worst_grad": worst, "worst_grad_rel_err": grad_rel[worst]}


# -- the trainer's resilience ------------------------------------------------------

#: the resilience phase: the full-width training model, adam, batch 8, 8
#: steps, checkpoints every 2 steps, audits every 2
RES_STEPS, RES_EVERY, RES_SEED = 8, 2, 7
#: the ladder's loss curve against the clean run: micro-batches of 4 rows
#: change the bf16 products' shapes, so their roundings
LADDER_LOSS_TOL = 2e-2


def fold_trees() -> list:
    """Random trees holding every word size (f32, bf16, f16, int8, int32,
    int64, f64, bool), odd lengths, empty leaves and a 4-byte leaf that is
    not 16-byte aligned, on the card."""
    import torch

    out = []
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        leaves = [
            torch.randn(7, 5, generator=g),
            torch.randn(8193 * 3 + 5, generator=g).bfloat16(),
            torch.randn(3, generator=g).half(),
            torch.randint(-128, 128, (16385 + 7,), generator=g,
                          dtype=torch.int8),
            torch.randint(-2 ** 31, 2 ** 31 - 1, (33,), generator=g,
                          dtype=torch.int32),
            torch.randint(-2 ** 62, 2 ** 62, (17,), generator=g,
                          dtype=torch.int64),
            torch.randn(9, generator=g, dtype=torch.float64),
            torch.rand(77, generator=g) > 0.5,
            torch.zeros(0),
            torch.randn(40_000 + seed, generator=g),
            torch.zeros((), dtype=torch.int32),
        ]
        leaves = [t.to(DEVICE) for t in leaves]
        leaves.append(torch.randn(50_001, device=DEVICE)[1:])
        out.append(leaves)
    return out


def train_state_leaves(seed: int) -> list:
    """The full-width training state's fold leaves in the trainer's order
    (parameters, adam's count, mu, nu) with seeded values, on the card."""
    import torch

    from mmlspark_tpu_torch.core import integrity
    from mmlspark_tpu_torch.models import build_model, init_variables

    graph = build_model("transformer_lm", **TRAIN_MODEL)
    params = init_variables(graph, seed, device=DEVICE)
    flat = [t for block in params.values() for t in block.values()]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    opt = {"count": torch.full((), 7, dtype=torch.int32, device=DEVICE),
           "mu": [torch.randn(t.shape, generator=gen, device=DEVICE) * 1e-3
                  for t in flat],
           "nu": [torch.rand(t.shape, generator=gen, device=DEVICE) * 1e-6
                  for t in flat]}
    return integrity.tree_leaves((params, opt))


def check_tree_checksum() -> dict:
    """The fold kernel against its plain version and numpy's host fold:
    bit-equal on the random trees and on the full-width training state;
    with the flag at 0 the carry stays and the workspace is left zero."""
    import torch

    from mmlspark_tpu_torch.core.integrity import tree_checksum_host
    from mmlspark_tpu_torch.ops import tree_checksum as tc

    equal = {}
    trees = fold_trees() + [train_state_leaves(RES_SEED)]
    on = torch.ones((), dtype=torch.bool, device=DEVICE)
    off = torch.zeros((), dtype=torch.bool, device=DEVICE)
    for i, leaves in enumerate(trees):
        label = "full_width_state" if i == len(trees) - 1 else f"random_{i}"
        plan = tc.FoldPlan(leaves)
        out = torch.full((), 77, dtype=torch.int32, device=DEVICE)
        tc.tree_fold(leaves, out=out, flag=off, plan=plan)
        kept = int(out) == 77
        kernel = tc.as_uint32(tc.tree_fold(leaves, out=out, flag=on,
                                           plan=plan))
        again = tc.as_uint32(tc.tree_fold(leaves, out=out, plan=plan))
        plain = tc.as_uint32(tc.tree_fold_reference(leaves))
        host = tree_checksum_host(leaves)
        equal[label] = (kernel == again == plain == host and kept
                        and not bool(plan.workspace.any()))
    log(f"tree_checksum vs plain vs host, bit-equal: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"tree_checksum differs: {equal}")
    return equal


def measure_tree_checksum(equal: dict, launches: int) -> dict:
    """The fold's ``kernels`` row over the full-width training state
    (parameters, count, mu, nu: 101.6 M words): device ms, graph ms (the
    fold replayed from a CUDA graph, as the captured step runs it; and the
    flag-0 launch's), the plain version's ms; bound: the bytes read once
    at the card's memory rate. No one PyTorch call computes this fold."""
    import torch

    from mmlspark_tpu_torch.ops import tree_checksum as tc

    leaves = train_state_leaves(RES_SEED + 1)
    plan = tc.FoldPlan(leaves)
    out = torch.zeros((), dtype=torch.int32, device=DEVICE)
    out2 = torch.zeros((), dtype=torch.int32, device=DEVICE)
    on = torch.ones((), dtype=torch.bool, device=DEVICE)
    off = torch.zeros((), dtype=torch.bool, device=DEVICE)

    def fold(flag):
        tc.tree_fold(leaves, out=out, flag=flag, plan=plan)

    kernel_t = time_ms(fold, [(on,)], reps=200)
    plain_t = time_ms(lambda: tc.tree_fold_reference(leaves, out=out2),
                      [()], reps=5)
    on_graph = graph_ms(fold, [(on,)])
    off_graph = graph_ms(fold, [(off,)])
    words = sum(tc.word_layout(t)[1] for t in leaves)
    log(f"tree_checksum over {plan.n_bytes} bytes: device "
        f"{kernel_t.ms:.4f} ms, graph {on_graph:.4f} ms, flag 0 graph "
        f"{off_graph:.4f} ms, plain {plain_t.ms:.3f} ms")
    return dict(kernel_row(
        "tree_checksum", "mmlspark_tpu_torch/csrc/tree_checksum.cu",
        "mmlspark_tpu/core/integrity.py:195 (tree_checksum under lax.cond "
        "in the jitted step, mmlspark_tpu/train/trainer.py:615; no TPU "
        "kernel: XLA fusion in the reference)",
        launches, 0.0, kernel_t, plain_t, None, plan.n_bytes, 2 * words,
        F32_FLOPS_PER_S,
        dict(leaves=len(leaves), words=words, dtype="float32 + int32"),
        design="a grid-stride walk over 8192-word chunks of every leaf "
               "from a device table, 16-byte loads, a uint32 sum a block "
               "added with integer atomics, the last block writes the "
               "carry; a device flag gates it (an empty launch off)",
        operations="2 integer ops a word (multiply-add) at the f32 rate",
        bit_equal=equal), graph_ms=on_graph, flag_off_graph_ms=off_graph)


def res_trainer(faults=None, **kw):
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    return SPMDTrainer(
        build_model("transformer_lm", **TRAIN_MODEL),
        TrainConfig(epochs=1, batch_size=TRAIN_BATCH, learning_rate=1e-3,
                    optimizer="adam", log_every=1, shuffle=True,
                    retry_backoff_s=0.0, **kw),
        faults=faults, device=DEVICE)


def res_run(label, weights, data, *, faults=None, killed=False, **kw):
    """One run of the resilience phase, a main path of its own: the counts
    set to 0 just before and read just after. Returns (trainer, trained
    variables or None when killed, counts)."""
    from mmlspark_tpu_torch.core.faults import EngineKilled

    trainer = res_trainer(faults, **kw)
    zero_counts()
    try:
        out = trainer.train(*data, init_variables=weights)
    except EngineKilled:
        out = None
    counts = read_counts()
    if (out is None) != killed:
        raise AssertionError(f"train_resilience {label}: killed "
                             f"{out is None}, expected {killed}")
    want = SERVE_MODEL["depth"] * len(trainer.history)
    if counts["fwd_mma_launches"] < want or \
            counts["bwd_kv_mma_launches"] < want:
        raise AssertionError(f"train_resilience {label}: {counts} over "
                             f"{len(trainer.history)} steps")
    return trainer, out, counts


def bit_equal(a: dict, b: dict) -> bool:
    import torch

    return a.keys() == b.keys() and all(
        torch.equal(a[blk][k], b[blk][k]) for blk in a for k in a[blk])


def losses(trainer, restored: bool = False) -> list:
    hist = (trainer.restored_history if restored else []) + trainer.history
    return [h["loss"] for h in hist]


def step_gaps_ms(trainer) -> list:
    """The wall ms between consecutive step events (``log_every=1``: the
    trainer syncs on each step's loss); gap i ends at step i + 1."""
    stamps = [e["t"] for e in trainer.recorder.events()
              if e["name"] == "step"]
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def poison_mlp(directory: str) -> bool:
    """A poisoned batch through an MLP on float rows (64 features, hidden
    256, batch 8, 8 steps): the poisoned step's loss is NaN, the others
    finite, one step quarantined, and adam's count in the final
    checkpoint is one short of the steps."""
    import shutil

    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    rng = np.random.default_rng(RES_SEED)
    x = rng.normal(size=(RES_STEPS * TRAIN_BATCH, 64)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    tr = SPMDTrainer(
        build_model("mlp", num_outputs=2, hidden=(256,)),
        TrainConfig(epochs=1, batch_size=TRAIN_BATCH, learning_rate=1e-2,
                    log_every=1, checkpoint_dir=directory),
        faults=FaultInjector([Fault("train.data", "poison", tick=2)]),
        device=DEVICE)
    tr.train(x, y)
    count = int(np.load(os.path.join(directory, f"payload-{RES_STEPS - 1}",
                                     "opt_state", "count.npy"),
                        allow_pickle=False))
    shutil.rmtree(directory)
    got = losses(tr)
    return (not np.isfinite(got[2]) and all(np.isfinite(got[:2] + got[3:]))
            and count == RES_STEPS - 1 and tr.telemetry.counter(
                "train.anomalies_skipped").value == 1)


def check_train_resilience() -> tuple:
    """The resilience phase at full width: the fold kernel, kill and
    resume, torn and flipped checkpoints, faults absorbed, the ladder,
    audits, and a checkpoint served. Returns (the ``train_resilience``
    line, the audited run's fold launches)."""
    import shutil
    import tempfile

    import torch

    from mmlspark_tpu_torch.core import integrity
    from mmlspark_tpu_torch.core.faults import (
        Fault,
        FaultInjector,
        parse_fault_spec,
    )
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.train import AtomicCheckpointStore

    t_phase = time.perf_counter()
    fold_equal = check_tree_checksum()
    graph = build_model("transformer_lm", **TRAIN_MODEL)
    weights = init_variables(graph, RES_SEED, device=DEVICE)
    data = progression_rows(RES_STEPS * TRAIN_BATCH, RES_SEED)
    root = tempfile.mkdtemp(prefix="chip-smoke-ck-")
    flags, counters, programs, times = {}, {}, {}, {}
    try:
        def ck(name, **kw):
            return dict(checkpoint_dir=os.path.join(root, name),
                        checkpoint_every=RES_EVERY, **kw)

        # the uninterrupted run
        clean, want, counts = res_run("clean", weights, data)
        want_losses = losses(clean)
        programs["clean"] = {
            "step_programs": clean.telemetry.counter(
                "retrace.train.step").value,
            "capture_s": clean.telemetry.gauge("train.step_capture_s").value}
        times["step_ms_audits_off"] = statistics.median(step_gaps_ms(clean))
        launch = {"clean": counts}

        # 2. kill at step 5, resume from the step-4 checkpoint
        killed, _, launch["killed"] = res_run(
            "killed", weights, data, killed=True, faults=FaultInjector(
                [Fault("train.step", "kill", tick=5)]), **ck("kill"))
        resumed, got, launch["resumed"] = res_run("resumed", weights, data,
                                                  **ck("kill"))
        counters["killed"] = killed.telemetry.to_dict()
        counters["resumed"] = resumed.telemetry.to_dict()
        # steps 0, 2 and 4 before the kill; 6 and the end, 7, after it
        flags["kill_resume_checkpoints"] = (
            counters["killed"]["train.checkpoints"],
            counters["resumed"]["train.checkpoints"]) == (3, 2)
        flags["kill_resume_params_bit_equal"] = bit_equal(got, want)
        flags["kill_resume_losses_bit_equal"] = \
            losses(resumed, True) == want_losses
        flags["resumed_from"] = resumed.history[0]["step"] - 1
        programs["resumed"] = resumed.telemetry.counter(
            "retrace.train.step").value
        served_dir = os.path.join(root, "kill")

        # 3. a torn checkpoint (kill between payload and commit at step 4)
        res_run("torn", weights, data, killed=True,
                faults=FaultInjector([Fault("train.checkpoint", "kill",
                                             tick=4)]), **ck("torn"))
        flags["torn_steps"] = AtomicCheckpointStore(
            os.path.join(root, "torn")).steps()
        torn, got, _ = res_run("torn resumed", weights, data, **ck("torn"))
        flags["torn_resume_bit_equal"] = (
            bit_equal(got, want) and losses(torn, True) == want_losses
            and torn.history[0]["step"] == 3)
        shutil.rmtree(os.path.join(root, "torn"))
        #    a flipped one (corrupt after the hash at step 4, kill at 5)
        res_run("flipped", weights, data, killed=True,
                faults=FaultInjector([
                    Fault("train.checkpoint", "corrupt", tick=4),
                    Fault("train.step", "kill", tick=5)]), **ck("flip"))
        flipped, got, _ = res_run("flipped resumed", weights, data,
                                  **ck("flip"))
        counters["flipped_resume"] = flipped.telemetry.to_dict()
        flags["flipped_resume_bit_equal"] = (
            bit_equal(got, want) and losses(flipped, True) == want_losses
            and flipped.history[0]["step"] == 3
            and flipped.telemetry.counter(
                "train.integrity.checksum_failures").value == 1)
        shutil.rmtree(os.path.join(root, "flip"))

        # 4. faults absorbed: transients, a poisoned batch, the ladder
        tr, got, _ = res_run("transients", weights, data,
                             faults=FaultInjector([
                                 Fault("train.step", "transient", tick=2),
                                 Fault("train.data", "transient", tick=3)]))
        flags["transients_bit_equal"] = (
            bit_equal(got, want) and losses(tr) == want_losses
            and tr.telemetry.counter("train.retries_total").value == 2)
        counters["transients"] = tr.telemetry.to_dict()
        # poison: the token rows hold no float column, so the hook skips
        # it (as the JAX package's does) and the run stays the clean one;
        # the MLP's float rows take the NaN, and its step is quarantined
        tr, got, _ = res_run("poison on tokens", weights, data,
                             faults=FaultInjector([Fault(
                                 "train.data", "poison", tick=2)]))
        flags["poison_on_tokens_skipped_bit_equal"] = (
            bit_equal(got, want) and losses(tr) == want_losses
            and tr.telemetry.counter("train.anomalies_skipped").value == 0)
        flags["poison_quarantined"] = poison_mlp(os.path.join(root,
                                                              "poison"))
        tr, got, launch["ladder"] = res_run(
            "ladder", weights, data, faults=FaultInjector(
                [Fault("train.step", "oom", tick=3)]))
        ladder = losses(tr)
        ladder_err = max(abs(a - b) for a, b in zip(ladder, want_losses))
        programs["ladder"] = {
            "step_programs": tr.telemetry.counter(
                "retrace.train.step").value,
            "capture_s": tr.telemetry.gauge("train.step_capture_s").value,
            "grad_accum": tr.telemetry.gauge("train.grad_accum").value}
        flags["ladder_ok"] = (
            programs["ladder"]["step_programs"] == 2
            and programs["ladder"]["grad_accum"] == 2
            and all(np.isfinite(ladder)) and ladder[:3] == want_losses[:3]
            and ladder_err <= LADDER_LOSS_TOL)
        flags["ladder_max_loss_err"] = ladder_err

        # 5. audits: clean, the seeded corrupt spec, a flip at an audit step
        tr, _, launch["audited"] = res_run("audited", weights, data,
                                           audit_every=RES_EVERY)
        counters["audited"] = tr.telemetry.to_dict()
        gaps = step_gaps_ms(tr)
        # the gap after step i holds that step's audit where (i + 1) is a
        # multiple of the cadence
        times["audited_step_gaps_ms"] = gaps
        times["step_ms_audits_on"] = statistics.median(
            g for i, g in enumerate(gaps) if (i + 1) % RES_EVERY)
        times["audit_step_ms"] = statistics.median(
            g for i, g in enumerate(gaps) if not (i + 1) % RES_EVERY)
        flags["audits_clean"] = (
            counters["audited"]["train.integrity.audits"]
            == RES_STEPS // RES_EVERY
            and counters["audited"]["train.integrity.sdc_suspected"] == 0
            and tr.telemetry.counter("retrace.train.step").value == 1
            and launch["audited"]["tree_checksum_launches"] == RES_STEPS)
        inj = parse_fault_spec("seed=3,train.step:corrupt=0.2")
        tr, _, _ = res_run("seeded corrupt", weights, data,
                           audit_every=RES_EVERY, faults=inj)
        counters["seeded_corrupt"] = tr.telemetry.to_dict()
        counters["seeded_corrupt"]["faults_injected"] = dict(inj.counts)
        counters["seeded_corrupt"]["replay_verdicts"] = tr.replay_verdicts
        c = counters["seeded_corrupt"]
        flags["seeded_corrupt_adjudicated"] = (
            len(tr.replay_verdicts) == c["train.integrity.sdc_suspected"]
            == c["train.integrity.replay_transient_sdc"]
            + c["train.integrity.replay_software_nondeterminism"]
            and c["train.integrity.checksum_failures"] == 0)
        t0 = time.perf_counter()
        tr, got, _ = res_run("audit-step corrupt", weights, data,
                             audit_every=RES_EVERY, faults=FaultInjector(
                                 [Fault("train.step", "corrupt", tick=3)]))
        times["audit_corrupt_run_s"] = time.perf_counter() - t0
        counters["audit_step_corrupt"] = tr.telemetry.to_dict()
        flags["audit_step_corrupt_adopted_bit_equal"] = (
            [v["verdict"] for v in tr.replay_verdicts] == ["transient_sdc"]
            and bit_equal(got, want))

        # the checkpoint's costs at full width: save, hash, restore, and
        # a host audit's fold
        state_leaves = train_state_leaves(RES_SEED + 2)
        n_params = sum(1 for _, m in graph.blocks
                       for _ in m.state_dict())
        params, count = state_leaves[:n_params], state_leaves[n_params]
        mu = state_leaves[n_params + 1:2 * n_params + 1]
        nu = state_leaves[2 * n_params + 1:]
        state = {"params": params, "opt_state": {"count": count, "mu": mu,
                                                 "nu": nu}}
        store = AtomicCheckpointStore(os.path.join(root, "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.save(0, state)
        times["checkpoint_save_s"] = time.perf_counter() - t0
        payload = os.path.join(root, "timed", "payload-0")
        t0 = time.perf_counter()
        integrity.dir_sha256(payload)
        times["checkpoint_sha256_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.restore(state)
        times["checkpoint_restore_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        integrity.tree_checksum_host((params, {"count": count, "mu": mu,
                                               "nu": nu}))
        times["host_audit_fold_s"] = time.perf_counter() - t0
        times["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(payload) for f in files)
        del state_leaves, params, mu, nu, state

        # 6. the resumed run's last checkpoint served by the dense engine
        served = serve_checkpoint(graph, served_dir, resumed_final=want)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"model": TRAIN_MODEL, "steps": RES_STEPS, "batch": TRAIN_BATCH,
           "checkpoint_every": RES_EVERY, "audit_every": RES_EVERY,
           "fold_bit_equal": fold_equal, "flags": flags,
           "counters": counters, "programs": programs, "times": times,
           "launch_counts": launch, "served": served,
           "phase_s": time.perf_counter() - t_phase}
    log(f"train_resilience: {json.dumps(out, default=str)[:3000]}")
    bad = [k for k, v in flags.items() if v is False]
    if bad or flags["torn_steps"] != [0, 2] or flags["resumed_from"] != 4:
        raise AssertionError(f"train_resilience gates failed: {bad}, "
                             f"{flags}")
    return out, launch["audited"]["tree_checksum_launches"]


def serve_checkpoint(graph, directory: str, resumed_final: dict) -> dict:
    """The newest checkpoint in ``directory``, restored through the store
    into a target rebuilt from scratch, served greedily by the dense
    engine: its parameters equal the trained ones, and its streams equal
    ``generate()`` over them or first differ at a near tie; the decode
    path launched ``flash_decode``."""
    import torch

    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.train import AtomicCheckpointStore

    params = init_variables(graph, 0, device="cpu")
    flat = [t for block in params.values() for t in block.values()]
    target = {"params": params,
              "opt_state": {"count": torch.zeros((), dtype=torch.int32),
                            "mu": [torch.zeros_like(t) for t in flat],
                            "nu": [torch.zeros_like(t) for t in flat]},
              "anomaly": {"streak": torch.zeros((), dtype=torch.int32),
                          "total": torch.zeros((), dtype=torch.int32)}}
    state, meta, step = AtomicCheckpointStore(directory).restore(target)
    variables = {b: {k: t.to(DEVICE) for k, t in leaves.items()}
                 for b, leaves in state["params"].items()}
    if step != RES_STEPS - 1 or not bit_equal(variables, resumed_final):
        raise AssertionError(f"served checkpoint: step {step}, parameters "
                             "differ from the trained ones")
    prompts = progression_rows(4, RES_SEED + 3)[0][:, :64]
    engine = make_engine(graph, variables)
    zero_counts()
    rids = [engine.submit(p, MAX_NEW) for p in prompts]
    results = engine.run()
    counts = read_counts()
    if sorted(results) != sorted(rids) or counts["launches"] <= 0 or any(
            r.status != "completed" for r in results.values()):
        raise AssertionError(f"served checkpoint: {counts}, results "
                             f"{ {i: r.status for i, r in results.items()} }")
    diverged = check_streams(graph, variables, dict(zip(rids, prompts)),
                             results, rids, "served checkpoint",
                             exact=False)
    return {"step": step, "requests": len(rids), "launch_counts": counts,
            "diverged": diverged, "steps_per_epoch": meta["steps_per_epoch"]}


def device_profile(prof, wall_ms: float) -> dict:
    """Device time, busy share and the top kernels of a profiled window."""
    import torch

    # a scheduled window's ProfilerStep annotation carries device time of
    # its own: it spans the kernels, it is not one
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "top_kernels": [
            {"name": e.key[:80], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in top
        ],
    }


def profile_train_step(trained: dict) -> dict:
    """One steady full-width training step under ``torch.profiler``,
    after the 8-step run warmed everything up: a 3-step ``train()`` from
    its weights whose recorder steps the profiler's schedule at each
    step's log event, so the active window is the third step alone (the
    trainer's set-up and the first step fall outside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from mmlspark_tpu_torch.core.telemetry import FlightRecorder
    from mmlspark_tpu_torch.models import build_model

    class Stepping(FlightRecorder):
        def record(self, name, **attrs):
            super().record(name, **attrs)
            if name == "step":
                prof.step()

    recorder = Stepping()
    trainer = make_trainer(build_model("transformer_lm", **TRAIN_MODEL),
                           recorder)
    x, y = progression_rows(3 * TRAIN_BATCH, 11)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1,
                                   repeat=1)) as prof:
        trainer.train(x, y, init_variables=trained)
    stamps = [e["t"] for e in recorder.events() if e["name"] == "step"]
    return dict(device_profile(prof, (stamps[2] - stamps[1]) * 1e3),
                batch=TRAIN_BATCH, seq=SERVE_MODEL["max_len"], step=2,
                step_programs=trainer.telemetry.counter(
                    "retrace.train.step").value)


def profile_decode_block(graph, variables, kinds=None) -> dict:
    """Where one steady decode block's time goes: all 8 slots live, one
    T=32 block under ``torch.profiler``; the kernels' device time against
    the block's wall time gives the device's busy and idle shares.
    ``kinds`` ({kind: name substrings}) also sums the device ms of the
    kernels whose names hold each kind's substrings (``other``: the
    rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine = make_engine(graph, variables)
    rng = np.random.default_rng(1)
    for _ in range(SLOTS):
        engine.submit(rng.integers(0, SERVE_MODEL["vocab_size"], size=32),
                      1 + 2 * DECODE_BLOCK)
    engine.step()  # admissions and a first block (eager, then captured)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict(device_profile(prof, wall_ms), block=DECODE_BLOCK,
               slots_live=SLOTS,
               decode_compile_count=engine.decode_compile_count,
               replayed=engine.decode_compile_count == 1)
    if kinds:
        by_kind = dict.fromkeys([*kinds, "other"], 0.0)
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or \
                    e.key.startswith("ProfilerStep"):
                continue
            kind = next((k for k, keys in kinds.items()
                         if any(key in e.key for key in keys)), "other")
            by_kind[kind] += e.self_device_time_total / 1e3
        out["device_ms_by_kind"] = by_kind
    return out


# -- timing ----------------------------------------------------------------------


def graph_ms(fn, arg_sets, replays: int = 20) -> float:
    """Device ms a call of ``fn`` when one CUDA graph holds a call on each
    of ``arg_sets`` (rotating through more memory than the L2) and is
    replayed back to back: the kernels' time with no launch gap between
    calls, as a captured decode block runs them."""
    import torch

    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(arg_sets))


def profiler_ms(fn, arg_sets, name: str, reps: int = 50) -> float:
    """Mean device time of the kernels whose name holds ``name`` over
    ``reps`` calls, from ``torch.profiler``: a cross-check of the event
    timer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            fn(*arg_sets[r % len(arg_sets)])
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key)
    return total / 1e3 / reps


#: the timed shape of every kernel: the slice's (B=8, L=512, H=Hkv=8,
#: D=64, bf16 query) with every row half full; paged: pages of 16, 32 a
#: row
TIMED = dict(b=8, L=512, h=8, hk=8, d=64, live=256)


def kernel_row(name, source, replaces, launches, max_abs_err, kernel_t,
               plain_t, library_t, n_bytes, n_flops, flops_per_s, shape,
               **notes):
    """One row of the ``kernels`` line from the three ``Timing``s (the
    library's None where no one call computes the function): ``ms``,
    ``plain_ms`` and ``library_ms`` are device times, the ``*call_ms``
    their host-paced twins. The bound is the larger of the bytes over
    the card's memory rate and the operations over its peak rate for the
    kernel's arithmetic."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / flops_per_s * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_t.ms,
        "plain_ms": plain_t.ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_t.ms if library_t else None,
        "call_ms": kernel_t.call_ms,
        "plain_call_ms": plain_t.call_ms,
        "library_call_ms": library_t.call_ms if library_t else None,
        "ratio_to_library": (kernel_t.ms / library_t.ms if library_t
                             else None),
        # per timing: the device still had work queued when the host
        # finished issuing the device-timed loop
        "device_timer_covered": {
            "kernel": kernel_t.covered, "plain": plain_t.covered,
            "library": library_t.covered if library_t else None},
        **notes,
        "shape": shape,
        "bytes": n_bytes,
        "flops": n_flops,
    }


def decode_row(name, source, replaces, launches, max_abs_err, kernel_t,
               plain_t, library_t, n_bytes, kv_dtype, library=None,
               **notes):
    """A decode kernel's row at the TIMED shape: q.k and p.v, 2 flops a
    multiply-add, at the f32 rate (the kernels compute in f32). The
    kernel's time is its wrapper's two launches, split-KV partials and
    their combine."""
    t = TIMED
    return kernel_row(
        name, source, replaces, launches, max_abs_err, kernel_t, plain_t,
        library_t, n_bytes, 4 * t["b"] * t["live"] * t["h"] * t["d"],
        F32_FLOPS_PER_S, dict(t, dtype="bfloat16", kv_dtype=kv_dtype),
        library=library,
        design="split-KV: one block per (chunk of 64 positions, kv head, "
               "row), then a combine kernel (decode_attention.cuh)",
        **notes)


def io_bytes(kv_elem: int) -> int:
    """Each live K and V row once, q in and out, the lengths."""
    t = TIMED
    return (2 * t["b"] * t["live"] * t["hk"] * t["d"] * kv_elem
            + 2 * t["b"] * t["h"] * t["d"] * 2 + t["b"] * 4)


def measure_kernels(errors: dict, launches: dict) -> list:
    """The four kernels at the timed shape: kernel, plain version and,
    where one PyTorch call computes the same function, that call."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_decode,
        flash_decode_reference,
        paged_flash_decode,
        paged_flash_decode_reference,
    )

    t = TIMED
    b, L, h, hk, d, live = (t[k] for k in ("b", "L", "h", "hk", "d", "live"))
    lens = torch.full((b,), live, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator().manual_seed(100)
    src = "mmlspark_tpu_torch/csrc/"
    jax_file = "mmlspark_tpu/ops/flash_attention.py"
    rows = []

    # float dense: bf16 slot caches, SDPA on the same live work
    sets = [kernel_inputs(b, L, h, hk, d, torch.bfloat16, False,
                          seed=100 + i)
            for i in range(ROTATE_BYTES // (2 * b * L * hk * d * 2) + 1)]
    lib_sets = [(q.transpose(1, 2).contiguous(),
                 k[:, :live].transpose(1, 2).contiguous(),
                 v[:, :live].transpose(1, 2).contiguous())
                for q, k, v in sets]
    def dense(q, k, v):
        return flash_decode(q, k, v, lens)

    kernel_t = time_ms(dense, sets)
    # the event timer's device time against the profiler's: the kernels
    # of one call (split-KV partials and their combine), summed; and the
    # calls replayed from one CUDA graph
    profiled = profiler_ms(dense, sets, "decode_")
    graphed = graph_ms(dense, sets)
    log(f"flash_decode device time: events {kernel_t.ms:.5f} ms, profiler "
        f"{profiled:.5f} ms, in a CUDA graph {graphed:.5f} ms a call "
        f"(host-paced {kernel_t.call_ms:.5f})")
    rows.append(decode_row(
        "flash_decode", src + "flash_decode.cu", f"{jax_file}:586",
        launches["launches"], errors["slice/bfloat16"], kernel_t,
        time_ms(lambda q, k, v: flash_decode_reference(q, k, v, lens), sets),
        time_ms(F.scaled_dot_product_attention, lib_sets),
        io_bytes(2), "bfloat16", "scaled_dot_product_attention",
        profiler_ms=profiled, graph_ms=graphed))
    del sets, lib_sets

    # int8 dense: no single PyTorch call attends over int8 K/V with scales
    sets = []
    for _ in range(ROTATE_BYTES // (2 * b * L * hk * d) + 1):
        q = torch.randn((b, 1, h, d), generator=gen).bfloat16().to(DEVICE)
        k8, ks = int8_kv((b, L, hk, d), (b, hk), gen)
        v8, vs = int8_kv((b, L, hk, d), (b, hk), gen)
        sets.append((q, k8, v8, ks, vs))
    def q8(q, k, v, ks, vs):
        return flash_decode(q, k, v, lens, k_scale=ks, v_scale=vs)

    rows.append(decode_row(
        "flash_decode_q8", src + "flash_decode.cu", f"{jax_file}:640",
        launches["q8_launches"], errors["q8_slice/bfloat16"],
        time_ms(q8, sets),
        time_ms(lambda q, k, v, ks, vs: flash_decode_reference(
            q, k, v, lens, k_scale=ks, v_scale=vs), sets),
        None, io_bytes(1) + 2 * b * hk * 4, "int8",
        graph_ms=graph_ms(q8, sets)))
    del sets

    # paged: shuffled tables, 16 live pages a row
    live_pages = live // PAGE_SIZE
    page_shape = (b * MAX_PAGES + 1, hk, PAGE_SIZE, d)
    table_bytes = b * live_pages * 4

    def paged_set(kv_int8: bool):
        _, pt = shuffled_page_table(b, [live] * b, gen)
        q = torch.randn((b, 1, h, d), generator=gen).bfloat16().to(DEVICE)
        if kv_int8:
            kp, ks = int8_kv(page_shape, page_shape[:2], gen)
            vp, vs = int8_kv(page_shape, page_shape[:2], gen)
            return q, kp, vp, pt, ks, vs
        kp, vp = (torch.randn(page_shape, generator=gen).bfloat16()
                  .to(DEVICE) for _ in range(2))
        return q, kp, vp, pt

    per_set = 2 * page_shape[0] * hk * PAGE_SIZE * d * 2
    sets = [paged_set(False) for _ in range(ROTATE_BYTES // per_set + 1)]

    def gathered(store, pt):  # the live K/V of each row, (B, H, S, D)
        g = store[pt[:, :live_pages].long()]  # (B, pages, Hkv, ps, D)
        return g.permute(0, 2, 1, 3, 4).reshape(b, hk, live, d).contiguous()

    lib_sets = [(q.transpose(1, 2).contiguous(), gathered(kp, pt),
                 gathered(vp, pt)) for q, kp, vp, pt in sets]
    def paged(q, k, v, pt):
        return paged_flash_decode(q, k, v, lens, pt)

    rows.append(decode_row(
        "paged_flash_decode", src + "paged_flash_decode.cu",
        f"{jax_file}:894", launches["paged_launches"],
        errors["paged_slice/bfloat16"],
        time_ms(paged, sets),
        time_ms(lambda q, k, v, pt: paged_flash_decode_reference(
            q, k, v, lens, pt), sets),
        time_ms(F.scaled_dot_product_attention, lib_sets),
        io_bytes(2) + table_bytes, "bfloat16",
        "scaled_dot_product_attention on the gathered live K/V (a "
        "yardstick without the page indirection)",
        graph_ms=graph_ms(paged, sets)))
    del sets, lib_sets

    sets = [paged_set(True) for _ in range(ROTATE_BYTES // (per_set // 2)
                                           + 1)]
    def paged_q8(q, k, v, pt, ks, vs):
        return paged_flash_decode(q, k, v, lens, pt, k_scale=ks, v_scale=vs)

    rows.append(decode_row(
        "paged_flash_decode_q8", src + "paged_flash_decode.cu",
        f"{jax_file}:942", launches["paged_q8_launches"],
        errors["paged_q8_slice/bfloat16"],
        time_ms(paged_q8, sets),
        time_ms(lambda q, k, v, pt, ks, vs: paged_flash_decode_reference(
            q, k, v, lens, pt, k_scale=ks, v_scale=vs), sets),
        None, io_bytes(1) + table_bytes + 2 * b * live_pages * hk * 4,
        "int8", graph_ms=graph_ms(paged_q8, sets)))
    return rows


#: the attention kernels' timed shape: the training path's, bf16
TIMED_ATTN = dict(b=8, s=512, h=8, hk=8, d=64, causal=True, window=None)


def backward_sets(b, s, h, hk, d, causal, window, seed, with_library):
    """Enough bf16 input sets at this shape that the backward call reading
    the fewest bytes rotates through more than the rotation floor: q, k,
    v, dO, the forward's (out, lse) and the backward's operands; with
    ``with_library``, SDPA on the same tensors in its (B, H, S, D) layout
    with the forward kept, so that its backward can be timed alone."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import flash_attention as fa

    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    work = attention_work(b, s, h, hk, d, causal, window)
    sets = []
    for i in range(ROTATE_BYTES // min(n for n, _ in work.values()) + 1):
        q, k, v, g = attention_inputs(b, s, h, hk, d, torch.bfloat16,
                                      seed=seed + i)
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        st = dict(q=q, k=k, v=v, g=g, out=out, lse=lse,
                  ops=fa._backward_operands(q, k, v, out, lse, g))
        if with_library:
            lib = [x.transpose(1, 2).detach().requires_grad_(True)
                   for x in (q, k, v)]
            st.update(lib=lib, lib_g=g.transpose(1, 2),
                      lib_out=F.scaled_dot_product_attention(
                          *lib, is_causal=causal))
        sets.append(st)
    return sets, kw, work


def backward_kernels(kw, mma: bool):
    """The two backward kernels of a route, each alone on a set's
    operands."""
    from mmlspark_tpu_torch.ops import flash_attention as fa

    args = (kw["causal"], kw["window"], kw["scale"], mma)
    return (lambda st: fa._launch_bwd_kv(st["ops"], *args),
            lambda st: fa._launch_bwd_q(st["ops"], *args))


def measure_attention_kernels(errors: dict, launches: dict):
    """The three attention kernels at the training shape: kernel, plain
    version and the SDPA yardstick, as ``kernels`` rows; and the
    ``attention_backward`` summary. The backward rows' plain version is
    the whole plain backward (dq, dk and dv in one), and their library
    call SDPA's backward alone, both backward kernels' work together;
    SDPA's backward computes D = rowsum(dO * out) itself, so the fair
    comparison is the whole ``flash_attention_backward`` call, which the
    summary times beside the two kernels."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import flash_attention as fa

    t = TIMED_ATTN
    b, s, h, hk, d = (t[k] for k in ("b", "s", "h", "hk", "d"))
    sets, kw, work = backward_sets(b, s, h, hk, d, t["causal"], t["window"],
                                   200, with_library=True)
    arg_sets = [(st,) for st in sets]

    def timed(fn):
        return time_ms(fn, arg_sets)

    src = "mmlspark_tpu_torch/csrc/"
    jax_file = "mmlspark_tpu/ops/flash_attention.py"
    shape = dict(t, dtype="bfloat16")
    err = errors["slice/bfloat16"]
    plain_bwd = timed(lambda st: fa.flash_attention_backward_reference(
        st["q"], st["k"], st["v"], st["out"], st["lse"], st["g"], **kw))
    lib_bwd = timed(lambda st: torch.autograd.grad(
        st["lib_out"], st["lib"], st["lib_g"], retain_graph=True))
    kv, dq = backward_kernels(kw, mma=True)
    kv_simt, dq_simt = backward_kernels(kw, mma=False)
    kv_t, dq_t = timed(kv), timed(dq)
    simt_t = {"bwd_kv": timed(kv_simt), "bwd_q": timed(dq_simt)}
    profiled = {"bwd_kv": profiler_ms(kv, arg_sets, "flash_bwd_kv_mma"),
                "bwd_q": profiler_ms(dq, arg_sets, "flash_bwd_q_mma")}
    whole = timed(lambda st: fa.flash_attention_backward(
        st["q"], st["k"], st["v"], st["out"], st["lse"], st["g"], **kw))
    pair = timed(lambda st: (kv(st), dq(st)))
    operands = timed(lambda st: fa._backward_operands(
        st["q"], st["k"], st["v"], st["out"], st["lse"], st["g"]))
    log(f"backward device times: dK/dV {kv_t.ms:.5f} ms (profiler "
        f"{profiled['bwd_kv']:.5f}, simt {simt_t['bwd_kv'].ms:.5f}), dQ "
        f"{dq_t.ms:.5f} (profiler {profiled['bwd_q']:.5f}, simt "
        f"{simt_t['bwd_q'].ms:.5f}), whole call {whole.ms:.5f}, SDPA's "
        f"backward {lib_bwd.ms:.5f}")
    bwd_notes = dict(
        plain="flash_attention_backward_reference: dq, dk and dv together",
        library="scaled_dot_product_attention's backward alone: both "
                "backward kernels together, and D = rowsum(dO * out)")

    def forward(st):
        return fa.flash_attention_forward(st["q"], st["k"], st["v"], **kw)

    fwd = timed(forward)
    # the event timer's device time against the profiler's, same launches
    fwd_profiled = profiler_ms(forward, arg_sets, "flash_fwd")
    log(f"forward device time: events {fwd.ms:.5f} ms, profiler "
        f"{fwd_profiled:.5f} ms a launch (host-paced {fwd.call_ms:.5f})")
    bwd_design = ("mma.sync m16n8k16 bf16 tensor cores, cp.async double "
                  "buffer, P and dS fed back in registers (the bf16 route; "
                  "f32 and other head dims keep flash_attention_bwd.cu)")
    # the main paths' launches of the f32-FMA route (flash_attention_fwd.cu,
    # flash_attention_bwd.cu: f32, and bf16 at other head dims than 64/128)
    simt = {k: launches[f"{k}_launches"] - launches[f"{k}_mma_launches"]
            for k in ("fwd", "bwd_kv", "bwd_q")}
    rows = [
        kernel_row(
            "flash_attention_fwd", src + "flash_attention_fwd_mma.cu",
            f"{jax_file}:123", launches["fwd_mma_launches"], err["out"], fwd,
            timed(lambda st: fa.flash_attention_reference(
                st["q"], st["k"], st["v"], **kw)),
            timed(lambda st: F.scaled_dot_product_attention(
                *(x.detach() for x in st["lib"]), is_causal=True)),
            *work["flash_attention_fwd"], BF16_FLOPS_PER_S, shape,
            library="scaled_dot_product_attention, causal",
            design="mma.sync m16n8k16 bf16 tensor cores, cp.async double "
                   "buffer (the bf16 route; f32 and other head dims keep "
                   "flash_attention_fwd.cu)",
            profiler_ms=fwd_profiled, simt_launches=simt["fwd"]),
        kernel_row(
            "flash_attention_bwd_kv", src + "flash_attention_bwd_mma.cu",
            f"{jax_file}:285", launches["bwd_kv_mma_launches"],
            max(err["dk_abs"], err["dv_abs"]), kv_t, plain_bwd, lib_bwd,
            *work["flash_attention_bwd_kv"], BF16_FLOPS_PER_S, shape,
            design=bwd_design, profiler_ms=profiled["bwd_kv"],
            simt_ms=simt_t["bwd_kv"].ms, simt_launches=simt["bwd_kv"],
            **bwd_notes),
        kernel_row(
            "flash_attention_bwd_q", src + "flash_attention_bwd_mma.cu",
            f"{jax_file}:330", launches["bwd_q_mma_launches"],
            err["dq_abs"], dq_t, plain_bwd, lib_bwd,
            *work["flash_attention_bwd_q"], BF16_FLOPS_PER_S, shape,
            design=bwd_design, profiler_ms=profiled["bwd_q"],
            simt_ms=simt_t["bwd_q"].ms, simt_launches=simt["bwd_q"],
            **bwd_notes),
    ]
    del sets, arg_sets
    timings = {"whole_call": whole, "operands_and_row_delta": operands,
               "kernels_together": pair, "bwd_kv": kv_t, "bwd_q": dq_t,
               "simt_bwd_kv": simt_t["bwd_kv"],
               "simt_bwd_q": simt_t["bwd_q"], "sdpa_backward": lib_bwd}
    summary = {
        "shape": shape,
        **{f"{name}_ms": tm.ms for name, tm in timings.items()},
        **{f"{name}_profiler_ms": ms for name, ms in profiled.items()},
        "whole_call_call_ms": whole.call_ms,
        "whole_call_over_sdpa": whole.ms / lib_bwd.ms,
        "kernels_over_sdpa": pair.ms / lib_bwd.ms,
        "simt_over_mma": {
            name: simt_t[name].ms / tm.ms
            for name, tm in (("bwd_kv", kv_t), ("bwd_q", dq_t))},
        "device_timer_covered": {name: tm.covered
                                 for name, tm in timings.items()},
        "gqa_window": measure_gqa_backward(),
    }
    return rows, summary


#: the GQA training run's attention shape (SMALL_TRAIN_MODEL, batch 8):
#: its dK/dV grid is 8 key tiles x 16 (row, kv head) = 128 blocks
TIMED_GQA = dict(b=8, s=512, h=8, hk=2, d=64, causal=True, window=128)


def measure_gqa_backward() -> dict:
    """Both backward routes' kernels at the GQA run's shape, device
    times (no one PyTorch call computes windowed GQA attention's
    backward through a flash kernel, so no library time)."""
    t = TIMED_GQA
    sets, kw, work = backward_sets(*(t[k] for k in (
        "b", "s", "h", "hk", "d", "causal", "window")), 300,
        with_library=False)
    arg_sets = [(st,) for st in sets]
    out = {"shape": dict(t, dtype="bfloat16")}
    for mma in (True, False):
        for name, fn in zip(("bwd_kv", "bwd_q"), backward_kernels(kw, mma)):
            tm = time_ms(fn, arg_sets)
            route = "mma" if mma else "simt"
            out[f"{route}_{name}_ms"] = tm.ms
            out[f"{route}_{name}_covered"] = tm.covered
    for name in ("bwd_kv", "bwd_q"):
        n_bytes, n_flops = work[f"flash_attention_{name}"]
        out[f"{name}_bound_ms"] = max(n_bytes / HBM_BYTES_PER_S,
                                      n_flops / BF16_FLOPS_PER_S) * 1e3
    log(f"GQA window backward: {out}")
    return out


# -- the stage layer and the flagship CNN (the ``dnn_stages`` line) ------------

#: ResNet-20 at full width through TPUModel: batch, images a transform
R20_BATCH, R20_IMAGES = 1024, 16384
FEED_DEPTHS = (2, 4, 8)
#: ResNet-50 at 224 through TPUModel
R50_BATCH, R50_IMAGES, R50_SIZE = 256, 2048, 224
#: DNNLearner on ResNet-20: batch, images (one step each per epoch), epochs
LEARNER_BATCH, LEARNER_IMAGES, LEARNER_EPOCHS = 256, 512, 3
#: DNNLearner on the flash LM: steps of TRAIN_BATCH rows; TPUModel over
#: LM_STAGE_ROWS 512-token rows, LM_STAGE_BATCH a call
LM_LEARNER_STEPS, LM_STAGE_ROWS, LM_STAGE_BATCH = 6, 8, 4
#: the BiLSTM tagger at its default widths: rows of TAGGER_LEN tokens
TAGGER_ROWS, TAGGER_LEN, TAGGER_BATCH = 1024, 128, 256
#: card (bf16 convolutions, cuDNN) against the port's f32 CPU forward on
#: the same weights: bf16 rounds every convolution's output, ~0.5% of
#: the largest logit on both ResNets on the CPU; allow 3e-2 of it
STAGE_LOGIT_TOL = 3e-2
#: the tagger's logits (f32 LSTM, bf16 Dense) against the CPU's: the
#: Dense rounds to bf16 (2^-7 relative), so allow two such steps
TAGGER_LOGIT_TOL = 2 * 2.0 ** -7
#: the LM's scores on the card (the flash forward, bf16) against the
#: CPU's plain bf16 forward: bf16 products summed in other orders
LM_STAGE_TOL = 3e-2


def seeded_images(n: int, size: int, seed: int) -> np.ndarray:
    """n seeded N(0, 1) float32 NHWC images (made in bulk)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, size, size, 3), generator=gen).numpy()


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def cpu_forward(name: str, config: dict, variables: dict, x, f32=True,
                output_node=None):
    """The port's forward on the CPU (the plain path) on ``variables``
    moved there: in float32 compute unless ``f32`` is False."""
    import torch

    from mmlspark_tpu_torch.models import build_model
    from mmlspark_tpu_torch.models.bridge import variables_to

    graph = build_model(name, **config)
    if f32:
        for _, mod in graph.blocks:
            for m in mod.modules():
                if hasattr(m, "dtype"):
                    m.dtype = torch.float32
    return graph.apply(variables_to(variables, "cpu"), torch.from_numpy(x),
                       output_node=output_node).numpy()


def flops_per_image(graph, variables, x) -> int:
    """2 x the multiply-adds of one image through every convolution and
    Dense, counted from the shapes one forward gives each layer."""
    from mmlspark_tpu_torch.models.resnet import Conv
    from mmlspark_tpu_torch.models.transformer import Dense

    macs = []

    def count(mod, inputs, out):
        if isinstance(mod, Conv):  # an NHWC output
            macs.append(out.shape[1] * out.shape[2] * mod.weight.numel())
        else:
            macs.append(mod.weight.numel())

    hooks = [m.register_forward_hook(count) for _, block in graph.blocks
             for m in block.modules() if isinstance(m, (Conv, Dense))]
    try:
        graph.apply(variables, x)
    finally:
        for h in hooks:
            h.remove()
    return 2 * sum(macs)


def stage_run(stage, ds) -> dict:
    """One ``TPUModel.transform`` as a main path: the counts set to 0 just
    before it and read just after, its wall time and peak memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, wall_ms, counts = timed_path(
        lambda: stage.transform(ds)[stage.output_col])
    return {"out": out, "wall_ms": wall_ms, "counts": counts,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def replay_ms(stage, x, replays: int = 20) -> float:
    """Device ms a batch of ``stage``'s captured forward program, replayed
    back to back (warm): the model alone, no feed."""
    import torch

    program, weights = stage.captured_forward()
    for _ in range(2):
        program(weights, x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        program(weights, x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def profile_replays(stage, x, reps: int = 5) -> dict:
    """``reps`` replays of ``stage``'s captured forward under
    ``torch.profiler``: device time and busy share, the top kernels, and
    the share of device time in convolution and matrix-product kernels
    (the rest: BatchNorm's f32 elementwise passes, casts, pooling)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    program, weights = stage.captured_forward()
    program(weights, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            program(weights, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = device_profile(prof, wall_ms)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    total = sum(e.self_device_time_total for e in kernels)
    mm = sum(e.self_device_time_total for e in kernels
             if any(k in e.key.lower() for k in MATMUL_KERNEL_KEYS))
    out.update(replays=reps, matmul_kernel_share=mm / total if total else None,
               kernel_launches=sum(e.count for e in kernels))
    return out


def eager_stage(stage):
    """A copy of ``stage`` whose programs are counted but never captured:
    every batch runs eagerly (the eager twin)."""
    from mmlspark_tpu_torch.core.env import default_device
    from mmlspark_tpu_torch.stages import dnn_model
    from mmlspark_tpu_torch.testing.compile_guard import ProgramCountingGraph

    class EagerPrograms(ProgramCountingGraph):
        def _capture(self, args):
            return None

    twin = stage.copy().set(weights=stage.weights)
    twin._device_weights(default_device(DEVICE))  # before its programs
    dnn_model.ProgramCountingGraph = EagerPrograms
    try:
        twin._forward()
    finally:
        dnn_model.ProgramCountingGraph = ProgramCountingGraph
    return twin


def check_stage_programs(label: str, stage, run: dict, eager: dict) -> None:
    """One program made and captured, and the eager twin's launch counts
    equal to the captured run's."""
    if stage.program_count != 1 or DEVICE == "cuda" and not \
            stage.capture_seconds > 0:
        raise AssertionError(f"{label}: {stage.program_count} programs, "
                             f"capture {stage.capture_seconds} s")
    if eager["counts"] != run["counts"]:
        raise AssertionError(f"{label}: launches on replay {run['counts']}, "
                             f"eager {eager['counts']}")


def check_resnet20_stage() -> dict:
    """ResNet-20 at width 16, batch 1024: the model alone (a replayed
    program), TPUModel over 16,384 images at each feed depth and with the
    bf16 feed, the eager twin, and the logits against the CPU's f32
    forward."""
    import torch

    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.stages import TPUModel

    graph = build_model("resnet20_cifar10")
    weights = init_variables(graph, 7, device=DEVICE)
    images = seeded_images(R20_IMAGES, 32, seed=7)
    ds = Dataset({"image": images})
    stage = TPUModel(model_name="resnet20_cifar10", input_col="image",
                     batch_size=R20_BATCH, device=DEVICE).set(weights=weights)
    cold = stage_run(stage, ds)  # the first batch eager, then the capture
    runs = {}
    for depth in FEED_DEPTHS:
        stage.set(feed_depth=depth)
        runs[f"feed_depth_{depth}"] = stage_run(stage, ds)
    stage.set(feed_depth=FEED_DEPTHS[0])
    warm = runs[f"feed_depth_{FEED_DEPTHS[0]}"]
    bf16_stage = stage.copy().set(weights=weights, feed_dtype="bfloat16")
    stage_run(bf16_stage, ds)
    runs["feed_bfloat16"] = stage_run(bf16_stage, ds)
    twin = eager_stage(stage)
    runs["eager_twin"] = eager = stage_run(twin, ds)
    check_stage_programs("resnet20 stage", stage, warm, eager)
    x = torch.from_numpy(images[:R20_BATCH]).to(DEVICE)
    model_ms = replay_ms(stage, x)
    replay_profile = profile_replays(stage, x)
    n_check = 64
    want = cpu_forward("resnet20_cifar10", {}, weights, images[:n_check])
    err = rel_err(warm["out"][:n_check], want)
    eager_err = rel_err(eager["out"], warm["out"])
    bf16_err = rel_err(runs["feed_bfloat16"]["out"], warm["out"])
    out = warm["out"]
    if out.shape != (R20_IMAGES, 10) or not np.isfinite(out).all() or \
            err > STAGE_LOGIT_TOL or eager_err > STAGE_LOGIT_TOL or \
            bf16_err > STAGE_LOGIT_TOL:
        raise AssertionError(
            f"resnet20 stage: scores {out.shape}, vs CPU f32 {err}, eager "
            f"{eager_err}, bf16 feed {bf16_err}")
    summary = {
        "model": {"name": "resnet20_cifar10", "width": 16},
        "batch": R20_BATCH, "images": R20_IMAGES,
        "model_only_ms_per_batch": model_ms,
        "model_only_images_per_sec": R20_BATCH / (model_ms / 1e3),
        "replay_profile": replay_profile,
        "cold_transform_s": cold["wall_ms"] / 1e3,
        "programs": stage.program_count,
        "capture_s": stage.capture_seconds,
        "logits_vs_cpu_f32_rel_err": err,
        "eager_vs_captured_rel_err": eager_err,
        "bf16_feed_vs_f32_feed_rel_err": bf16_err,
    }
    for label, run in runs.items():
        summary[label] = {
            "images_per_sec": R20_IMAGES / (run["wall_ms"] / 1e3),
            "wall_s": run["wall_ms"] / 1e3,
            "peak_memory_bytes": run["peak_memory_bytes"],
            "launch_counts_nonzero": {k: v for k, v in run["counts"].items()
                                      if v},
        }
    log(f"resnet20 stage: {summary}")
    return summary


def check_resnet50_stage() -> dict:
    """ResNet-50 at 224, batch 256: images/s through TPUModel with the
    logits and with the ``pool`` features, the model alone and its MFU
    against the bf16 dense peak, and the weight-int8 variant."""
    import torch

    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.ops.quantize import quantized_bytes
    from mmlspark_tpu_torch.stages import TPUModel

    graph = build_model("resnet50")
    weights = init_variables(graph, 8, device=DEVICE)
    images = seeded_images(R50_IMAGES, R50_SIZE, seed=8)
    ds = Dataset({"image": images})
    flops = flops_per_image(graph, weights,
                            torch.from_numpy(images[:1]).to(DEVICE))
    out = {"model": {"name": "resnet50", "input_size": R50_SIZE},
           "batch": R50_BATCH, "images": R50_IMAGES,
           "flops_per_image": flops, "bf16_peak_flops_per_s": BF16_FLOPS_PER_S}
    x = torch.from_numpy(images[:R50_BATCH]).to(DEVICE)
    scores = {}
    for label, kw in (("logits", {}), ("pool", {"output_node": "pool"}),
                      ("int8_logits", {"weight_quant": "int8"})):
        stage = TPUModel(model_name="resnet50", input_col="image",
                         batch_size=R50_BATCH, device=DEVICE, **kw).set(
            weights=weights)
        stage_run(stage, ds)  # cold: eager first batch, then the capture
        run = stage_run(stage, ds)
        check_stage_programs(f"resnet50 {label}", stage, run, run)
        ms = replay_ms(stage, x)
        scores[label] = run["out"]
        row = {"images_per_sec": R50_IMAGES / (run["wall_ms"] / 1e3),
               "wall_s": run["wall_ms"] / 1e3,
               "model_only_ms_per_batch": ms,
               "model_only_images_per_sec": R50_BATCH / (ms / 1e3),
               "peak_memory_bytes": run["peak_memory_bytes"],
               "capture_s": stage.capture_seconds}
        if label != "pool":
            row["mfu"] = flops * R50_BATCH / (ms / 1e3) / BF16_FLOPS_PER_S
        if label == "logits":
            row["replay_profile"] = profile_replays(stage, x)
        _, dev_weights = stage.captured_forward()
        if label == "int8_logits":
            stored, f32 = quantized_bytes(dev_weights)
            row.update(weight_bytes=stored, weight_bytes_f32=f32)
            row["top1_agreement_vs_bf16"] = float(np.mean(
                scores[label].argmax(1) == scores["logits"].argmax(1)))
        else:
            row["weight_bytes"] = quantized_bytes(dev_weights)[0]
        out[label] = row
    n_check = 4
    want = cpu_forward("resnet50", {}, weights, images[:n_check])
    err = rel_err(scores["logits"][:n_check], want)
    q_err = rel_err(scores["int8_logits"], scores["logits"])
    if scores["logits"].shape != (R50_IMAGES, 1000) or \
            scores["pool"].shape != (R50_IMAGES, 2048) or \
            not all(np.isfinite(s).all() for s in scores.values()) or \
            err > STAGE_LOGIT_TOL:
        raise AssertionError(f"resnet50 stage: vs CPU f32 {err}, shapes "
                             f"{[s.shape for s in scores.values()]}")
    out.update(logits_vs_cpu_f32_rel_err=err, int8_vs_bf16_rel_err=q_err)
    log(f"resnet50 stage: {out}")
    return out


def probed_learner(fn):
    """Run ``fn()`` with ``DNNLearner``'s trainer logging every step;
    returns (its result, the trainers it made)."""
    import dataclasses

    from mmlspark_tpu_torch.stages import dnn_learner
    from mmlspark_tpu_torch.train import SPMDTrainer

    trainers = []

    class ProbedTrainer(SPMDTrainer):
        def __init__(self, graph, config, *args, **kw):
            super().__init__(graph, dataclasses.replace(config, log_every=1),
                             *args, **kw)
            trainers.append(self)

    dnn_learner.SPMDTrainer = ProbedTrainer
    try:
        return fn(), trainers
    finally:
        dnn_learner.SPMDTrainer = SPMDTrainer


def learner_summary(label: str, model, trainer, counts, wall_ms,
                    rows_per_step: int) -> dict:
    """The learner's losses, step time and programs; fails unless every
    loss is finite, the last below the first, and the step is one
    captured program."""
    import torch

    losses = [h["loss"] for h in model.train_history]
    stamps = [e["t"] for e in trainer.recorder.events()
              if e["name"] == "step"]
    step_ms = statistics.median(
        (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    programs = trainer.telemetry.counter("retrace.train.step").value
    capture_s = trainer.telemetry.gauge("train.step_capture_s").value
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            programs != 1 or DEVICE == "cuda" and not capture_s > 0:
        raise AssertionError(f"{label}: losses {losses}, {programs} step "
                             f"programs, capture {capture_s} s")
    return {"losses": losses, "step_ms_median_steps_2_on": step_ms,
            "rows_per_sec": rows_per_step / (step_ms / 1e3),
            "step_programs": programs, "step_capture_s": capture_s,
            "fit_wall_s": wall_ms / 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launch_counts_nonzero": {k: v for k, v in counts.items() if v}}


def check_resnet20_learner() -> dict:
    """DNNLearner on ResNet-20 (width 16): a few adam steps over seeded
    images, the loss falling, the running statistics moved off their
    starting values, one step program."""
    import torch

    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.stages import DNNLearner

    images = seeded_images(LEARNER_IMAGES, 32, seed=9)
    labels = np.random.default_rng(9).integers(0, 10, size=LEARNER_IMAGES)
    ds = Dataset({"image": images, "label": labels})
    learner = DNNLearner(model_name="resnet20_cifar10", features_col="image",
                         batch_size=LEARNER_BATCH, epochs=LEARNER_EPOCHS,
                         device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (model, wall_ms, counts), (trainer,) = probed_learner(
        lambda: timed_path(lambda: learner.fit(ds)))
    out = learner_summary("resnet20 learner", model, trainer, counts,
                          wall_ms, LEARNER_BATCH)
    var = model.weights["stage3"]["ResBlock_2.ConvBN_1.BatchNorm_0.var"]
    mean = model.weights["stage3"]["ResBlock_2.ConvBN_1.BatchNorm_0.mean"]
    moved = float((var - 1).abs().max()), float(mean.abs().max())
    if not min(moved) > 0:
        raise AssertionError(f"resnet20 learner: running stats {moved}")
    out.update(model={"name": "resnet20_cifar10", "width": 16},
               batch=LEARNER_BATCH, steps=len(out["losses"]),
               running_stats_moved=moved)
    log(f"resnet20 learner: {out}")
    return out


def check_lm_stages() -> dict:
    """DNNLearner fits the flash LM at full width, then its TPUModel
    scores 512-token rows: both through the tensor-core attention
    kernels (the forward in both, the backward pair in the fit), the
    scores against the CPU's plain bf16 forward."""
    import torch

    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.stages import DNNLearner

    x, y = progression_rows(LM_LEARNER_STEPS * TRAIN_BATCH, seed=10)
    learner = DNNLearner(model_name="transformer_lm",
                         model_config=TRAIN_MODEL, features_col="tokens",
                         batch_size=TRAIN_BATCH, epochs=1,
                         learning_rate=1e-3, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (model, wall_ms, counts), (trainer,) = probed_learner(
        lambda: timed_path(lambda: learner.fit(
            Dataset({"tokens": x, "label": y}))))
    fit = learner_summary("LM learner", model, trainer, counts, wall_ms,
                          TRAIN_BATCH)
    fit["tokens_per_sec"] = fit.pop("rows_per_sec") * SERVE_MODEL["max_len"]
    want = SERVE_MODEL["depth"] * LM_LEARNER_STEPS
    if not all(counts[c] == want for c in ATTN_MMA_COUNTERS):
        raise AssertionError(f"LM learner: {counts}, wanted {want} launches "
                             "of each tensor-core attention kernel")
    rows, _ = progression_rows(LM_STAGE_ROWS, seed=11)
    model.set(batch_size=LM_STAGE_BATCH)
    ds = Dataset({"tokens": rows})
    stage_run(model, ds)
    run = stage_run(model, ds)
    eager = stage_run(eager_stage(model), ds)
    check_stage_programs("LM stage", model, run, eager)
    calls = LM_STAGE_ROWS // LM_STAGE_BATCH
    if run["counts"]["fwd_mma_launches"] != SERVE_MODEL["depth"] * calls:
        raise AssertionError(f"LM stage: {run['counts']}")
    want_scores = cpu_forward("transformer_lm", TRAIN_MODEL, model.weights,
                              rows[:2], f32=False)
    err = rel_err(run["out"][:2], want_scores)
    if run["out"].shape != (LM_STAGE_ROWS, SERVE_MODEL["max_len"],
                            SERVE_MODEL["vocab_size"]) or err > LM_STAGE_TOL:
        raise AssertionError(f"LM stage: scores {run['out'].shape}, vs CPU "
                             f"{err}")
    stage = {"rows": LM_STAGE_ROWS, "batch": LM_STAGE_BATCH,
             "tokens_per_sec": LM_STAGE_ROWS * SERVE_MODEL["max_len"]
             / (run["wall_ms"] / 1e3),
             "wall_s": run["wall_ms"] / 1e3,
             "peak_memory_bytes": run["peak_memory_bytes"],
             "scores_vs_cpu_bf16_rel_err": err,
             "eager_twin_tokens_per_sec": LM_STAGE_ROWS
             * SERVE_MODEL["max_len"] / (eager["wall_ms"] / 1e3),
             "launch_counts_nonzero": {k: v for k, v in run["counts"].items()
                                       if v}}
    out = {"model": TRAIN_MODEL, "learner": dict(fit, steps=LM_LEARNER_STEPS,
                                                 batch=TRAIN_BATCH),
           "stage": stage}
    log(f"LM stages: {out}")
    return out


def check_tagger_stage() -> dict:
    """The BiLSTM tagger at its default widths through TPUModel (the LSTM
    is cuDNN's), against the CPU's forward on the same weights."""
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.stages import TPUModel

    graph = build_model("bilstm_tagger")
    weights = init_variables(graph, 12, device=DEVICE)
    rows = np.random.default_rng(12).integers(
        0, 10000, size=(TAGGER_ROWS, TAGGER_LEN)).astype(np.int32)
    stage = TPUModel(model_name="bilstm_tagger", input_col="tokens",
                     batch_size=TAGGER_BATCH, device=DEVICE).set(
        weights=weights)
    ds = Dataset({"tokens": rows})
    stage_run(stage, ds)
    run = stage_run(stage, ds)
    check_stage_programs("tagger stage", stage, run, run)
    want = cpu_forward("bilstm_tagger", {}, weights, rows[:4], f32=False)
    err = rel_err(run["out"][:4], want)
    if run["out"].shape != (TAGGER_ROWS, TAGGER_LEN, 8) or \
            err > TAGGER_LOGIT_TOL:
        raise AssertionError(f"tagger stage: {run['out'].shape}, vs CPU "
                             f"{err}")
    out = {"model": {"name": "bilstm_tagger", "vocab_size": 10000,
                     "embed_dim": 128, "hidden": 128, "num_tags": 8},
           "rows": TAGGER_ROWS, "row_len": TAGGER_LEN, "batch": TAGGER_BATCH,
           "tokens_per_sec": TAGGER_ROWS * TAGGER_LEN
           / (run["wall_ms"] / 1e3),
           "wall_s": run["wall_ms"] / 1e3,
           "peak_memory_bytes": run["peak_memory_bytes"],
           "logits_vs_cpu_rel_err": err}
    log(f"tagger stage: {out}")
    return out


def check_dnn_stages() -> dict:
    """The ``dnn_stages`` line: every stage path above, each a main path
    of its own, with its seconds."""
    out = {}
    for label, fn in (("resnet20", check_resnet20_stage),
                      ("resnet50", check_resnet50_stage),
                      ("resnet20_learner", check_resnet20_learner),
                      ("transformer_lm", check_lm_stages),
                      ("bilstm_tagger", check_tagger_stage)):
        t0 = time.perf_counter()
        out[label] = fn()
        out[label]["phase_s"] = time.perf_counter() - t0
        gc.collect()
    return out


# -- the switch-MoE LM (ROADMAP.md Queue 1 item 18) ------------------------------

#: the MoE LM at full width: the serve model's widths, the family's
#: default experts and capacity factor, d_ff = 4 x d_model (~151 M
#: parameters, 0.30 GB in bf16)
MOE_MODEL = dict(SERVE_MODEL, n_experts=8, d_ff=2048, capacity_factor=1.25)
#: the card-vs-CPU float32 checks: a small MoE with head dim 64
SMALL_MOE = dict(vocab_size=512, d_model=128, heads=2, depth=2, n_experts=4,
                 max_len=128)
#: f32 logits of the small MoE, card vs CPU: the same f32 arithmetic
#: summed in other orders through two layers
MOE_F32_TOL = 1e-4
#: the trainer's default weight on the sown load-balance loss
MOE_AUX_WEIGHT = 1e-2
#: the kernels of a MoE decode block, by name, for its profile
MOE_KINDS = {
    "attention": ("decode_partial_kernel", "decode_combine_kernel"),
    "matmul": ("gemm", "nvjet", "cutlass", "sm90_", "sm80_", "xmma"),
}


def moe_graph(f32: bool = False, **kw):
    import torch

    from mmlspark_tpu_torch.models import build_model

    graph = build_model("transformer_lm_moe", **kw)
    if f32:
        for _, mod in graph.blocks:
            for m in mod.modules():
                if hasattr(m, "dtype"):
                    m.dtype = torch.float32
    return graph


def moe_forced_logits(graph, variables, tokens, prompt_len: int):
    """The logits each generated token of a MoE stream was picked from,
    recomputed the way the stream was made: the prompt prefilled at once
    (capacity routing), then the stream's own tokens fed back one decode
    step at a time (dropless routing). Row i predicts token
    ``prompt_len + i``; f32."""
    import torch

    from mmlspark_tpu_torch.models.generate import _cached_apply, init_cache

    toks = torch.from_numpy(np.asarray(tokens, np.int32)).to(DEVICE)
    p, n = prompt_len, len(tokens)
    cache = init_cache(graph, variables, 1, n)
    logits, cache = _cached_apply(graph, variables, toks[None, :p], cache, 0)
    rows = [logits[0, -1].float()]
    for pos in range(p, n - 1):
        logits, cache = _cached_apply(graph, variables,
                                      toks[None, pos:pos + 1], cache, pos,
                                      step=True)
        rows.append(logits[0, 0].float())
    return torch.stack(rows)


def check_moe_streams(graph, variables, label: str, got: dict, want: dict,
                      prompt_lens: dict) -> dict:
    """Each MoE stream of ``got`` against its twin in ``want`` (token
    arrays by request): equal, or first differing at a near tie — the
    twin's top-2 margin below BF16_LOGIT_TOL — with every token the
    differing stream emitted within BF16_LOGIT_TOL of its step's best
    logit. ``check_near_ties`` for MoE: the margins come from each
    stream's own cached decode (``moe_forced_logits``), since a full
    scoring forward routes every token through the capacity path, which
    may drop tokens the dropless decode keeps."""
    import torch

    diverged, worst = [], 0.0
    for rid in sorted(want):
        g, w = np.asarray(got[rid]), np.asarray(want[rid])
        if g.shape == w.shape and np.array_equal(g, w):
            continue
        p = prompt_lens[rid]
        n = min(len(g), len(w))
        first = int(np.argmax(g[:n] != w[:n])) if \
            (g[:n] != w[:n]).any() else n
        top2 = moe_forced_logits(graph, variables, w, p)[first - p] \
            .sort().values[-2:] if first >= p else None
        margin = float(top2[1] - top2[0]) if top2 is not None else None
        if first < p or not margin < BF16_LOGIT_TOL:
            raise AssertionError(
                f"{label} request {rid}: differs from its twin at token "
                f"{first} (prompt {p}), top-2 margin {margin}")
        steps = moe_forced_logits(graph, variables, g, p)
        picked = steps.gather(1, torch.from_numpy(
            g[p:].astype(np.int64))[:, None].to(DEVICE))[:, 0]
        gap = float((steps.max(dim=1).values - picked).max())
        worst = max(worst, gap)
        if gap > BF16_LOGIT_TOL:
            raise AssertionError(f"{label} request {rid}: an emitted token "
                                 f"is {gap} below its step's best")
        diverged.append({"request": int(rid), "token": first,
                         "margin": margin})
    log(f"{label}: streams equal their twin's or first differ at a near "
        f"tie: {diverged}; largest emitted-token gap {worst:.4g}")
    return {"diverged": diverged, "max_emitted_gap": worst}


def moe_ffn_pieces_ms(variables) -> dict:
    """Device ms of one decode micro-step's MoE FFN pieces in one layer at
    the engine's shapes (8 tokens, bf16 expert weights as the engine
    keeps them), each replayed from one CUDA graph over every layer's
    weights in turn (so each call reads its own, cold): the router
    (softmax, argmax, the chosen probability), the gather of each token's
    expert weights, and the expert products (two batched products, bias
    and gelu)."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.parallel.expert import router_probs

    gen = torch.Generator().manual_seed(25)
    x = torch.randn((SLOTS, MOE_MODEL["d_model"]), generator=gen).to(
        DEVICE, torch.bfloat16)
    layers = [(v["moe.gate"], *(v[f"moe.experts.{k}"].to(torch.bfloat16)
                                for k in ("w_in", "b_in", "w_out",
                                          "b_out")))
              for name, v in variables.items() if "moe.gate" in v]
    expert = router_probs(x, layers[0][0]).argmax(-1)
    gathered = [(x, w_in[expert], b_in[expert], w_out[expert],
                 b_out[expert]) for _, w_in, b_in, w_out, b_out in layers]

    def router(x, gate):
        probs = router_probs(x, gate)
        e = probs.argmax(-1)
        return probs.gather(-1, e[:, None])

    def gather(w_in, b_in, w_out, b_out):
        return w_in[expert], b_in[expert], w_out[expert], b_out[expert]

    def products(x, w_in, b_in, w_out, b_out):
        h = F.gelu(torch.einsum("nd,ndf->nf", x, w_in) + b_in,
                   approximate="tanh")
        return torch.einsum("nf,nfd->nd", h, w_out) + b_out

    return {
        "router_ms": graph_ms(router, [(x, g) for g, *_ in layers]),
        "weight_gather_ms": graph_ms(gather, [tuple(w) for _, *w in layers]),
        "expert_products_ms": graph_ms(products, gathered),
    }


def check_moe_vs_cpu(seed: int = 22) -> dict:
    """The small MoE in float32 on the card against the CPU on identical
    weights: the scoring forward (capacity routing, the flash forward
    kernel), and a prefill then one decode step (dropless routing, the
    ``flash_decode`` kernel) over float32 caches: logits within
    MOE_F32_TOL."""
    import torch

    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.models.generate import _cached_apply

    graph = moe_graph(f32=True, attn_impl="flash", **SMALL_MOE)
    n = SMALL_MOE["max_len"] // 2
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, SMALL_MOE["vocab_size"], size=(2, n)).astype(np.int32))
    d = SMALL_MOE["d_model"] // SMALL_MOE["heads"]
    out = {}
    for dev in ("cpu", DEVICE):
        variables = init_variables(graph, seed, device=dev)
        x = ids.to(dev)
        full = graph.apply(variables, x)
        cache = {f"block{i}": tuple(
            torch.zeros((2, n, SMALL_MOE["heads"], d), device=dev)
            for _ in range(2)) for i in range(SMALL_MOE["depth"])}
        _, cache = _cached_apply(graph, variables, x[:, :n - 1], cache, 0)
        step, _ = _cached_apply(
            graph, variables, x[:, n - 1:], cache,
            torch.full((2,), n - 1, dtype=torch.int32, device=dev),
            step=True)
        out[dev] = (full.cpu(), step.cpu())
    errs = {}
    for i, name in enumerate(("forward", "decode_step")):
        got, want = out[DEVICE][i], out["cpu"][i]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"small f32 MoE {name}: non-finite logits")
        errs[name] = (got - want).abs().max().item()
    log(f"small f32 MoE, card vs CPU: max abs errs {errs}")
    if not max(errs.values()) <= MOE_F32_TOL:
        raise AssertionError(f"small f32 MoE card vs CPU: {errs}")
    return errs


def check_moe() -> dict:
    """The ``moe`` line: the switch-MoE LM at full width served by the
    dense and the paged prefix-cache bf16 engines on the random schedule
    (each a main path with its warm pass and eager twin, through
    ``graphed_run``), every stream against the port's ``generate()`` and
    dense against paged; one replayed T=32 block profiled; the small f32
    MoE's logits card vs CPU; then ``SPMDTrainer`` on the same model with
    the flash kernels, its aux loss, and one f32 step of the small MoE
    card vs CPU."""
    import torch

    from mmlspark_tpu_torch.models import generate, init_variables
    from mmlspark_tpu_torch.train.trainer import sown_aux_loss

    graph = moe_graph(**MOE_MODEL)
    variables = init_variables(graph, 21, device=DEVICE)
    prompts = random_schedule()
    lengths = {len(p) for p in prompts}
    depth = MOE_MODEL["depth"]
    out = {"model": MOE_MODEL,
           "parameters": graph.param_count(variables),
           "distinct_prompt_lengths": len(lengths)}
    runs = {}
    for label, kw, counter in (
        ("moe dense bf16", {}, "launches"),
        ("moe paged bf16", dict(paged=True, page_size=PAGE_SIZE,
                                num_pages=paged_num_pages(),
                                prefix_cache=True), "paged_launches"),
    ):
        run, engine = graphed_run(label, graph, variables, prompts, counter,
                                  **kw)
        del engine
        gc.collect()
        pr = run["programs"]
        want = depth * run["micro_steps"]
        if run["counts"][counter] != want:
            raise AssertionError(f"{label}: {counter} = "
                                 f"{run['counts'][counter]}, wanted {want}")
        # exact-length prefill: one program a distinct prompt length
        if pr["prefill_compile_count"] != len(lengths) or \
                pr["num_prefill_buckets"] != CACHE_LEN - 1:
            raise AssertionError(f"{label}: prefill programs {pr}, "
                                 f"{len(lengths)} distinct prompt lengths")
        runs[label] = run
    prompt_lens = {rid: len(p) for rid, p in enumerate(prompts)}
    gen = {rid: generate(graph, variables, p[None], MAX_NEW,
                         device=DEVICE)[0].cpu().numpy()
           for rid, p in enumerate(prompts)}
    tokens = {label: {rid: r.tokens for rid, r in run["results"].items()}
              for label, run in runs.items()}
    for label, run in runs.items():
        run["vs_generate"] = check_moe_streams(
            graph, variables, f"{label} vs generate()", tokens[label], gen,
            prompt_lens)
        out[label] = dict(engine_summary(run), vs_generate=run["vs_generate"])
    out["paged_vs_dense"] = check_moe_streams(
        graph, variables, "moe paged vs dense", tokens["moe paged bf16"],
        tokens["moe dense bf16"], prompt_lens)
    del runs, tokens
    gc.collect()
    profile = profile_decode_block(graph, variables, MOE_KINDS)
    pieces = moe_ffn_pieces_ms(variables)
    steps = depth * DECODE_BLOCK
    profile["moe_ffn_pieces_ms_per_block"] = {
        k: v * steps for k, v in pieces.items()}
    profile["moe_ffn_pieces_ms_per_layer_step"] = pieces
    out["profile"] = profile
    out["small_f32_card_vs_cpu_max_abs_err"] = check_moe_vs_cpu()
    del graph, variables
    gc.collect()

    model = dict(MOE_MODEL, attn_impl="flash")
    training, trained = run_training("moe full width", model,
                                     TRAIN_STEPS, seed=23,
                                     name="transformer_lm_moe")
    x, _ = progression_rows(TRAIN_BATCH, 24)
    with torch.no_grad():
        _, updated = moe_graph(**model).apply(
            trained, torch.from_numpy(x).to(DEVICE), train=True)
    aux = float(sown_aux_loss(updated))
    if not (np.isfinite(aux) and aux > 0):
        raise AssertionError(f"moe training: aux loss {aux}")
    training["aux_loss_after"] = aux
    del trained, updated
    gc.collect()
    small = moe_graph(f32=True, attn_impl="flash", **SMALL_MOE)
    sx = np.random.default_rng(26).integers(
        0, SMALL_MOE["vocab_size"], size=(2, SMALL_MOE["max_len"])).astype(
        np.int32)
    training["train_step_f32_small_card_vs_cpu"] = train_step_card_vs_cpu(
        "small f32 MoE train step", small,
        init_variables(small, 27, device="cpu"), sx, np.roll(sx, -1, 1),
        SMALL_MOE["depth"], aux_weight=MOE_AUX_WEIGHT)
    out["training"] = training
    log(f"moe: {out}")
    return out


# -- the image path (ROADMAP.md Queue 1 item 17) ----------------------------------

#: ImageFeaturizer over ResNet-50 at 224 (the dnn_stages configuration),
#: cut one layer (``pool``, 2048-d), on seeded uint8 256x256 images
#: resized on the card
FEAT_IMAGES, FEAT_SIZE, FEAT_BATCH = 2048, 256, 256
#: the featurized net's config (the resize target is its input size)
FEAT_CONFIG: dict = {}
#: features of FEAT_CHECKED images against the CPU's float32 forward on
#: the same resized input: bf16 convolutions round each output (the
#: logits sit ~0.5% off, dnn_stages), so allow 1% of the largest
FEAT_CHECKED, FEAT_REL_TOL = 16, 1e-2
#: the ragged host path: images of mixed sizes
RAGGED_IMAGES, RAGGED_SIZES = 64, (160, 320)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures", "images")
ZOO_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "models", "zoo_repo")


def uint8_images(n: int, size, seed: int) -> np.ndarray:
    """n seeded uint8 HWC images of ``size`` (h, w), made in bulk."""
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, *size, 3), dtype=np.uint8)


def check_decoder() -> dict:
    """The port's native decoder: built or not (with the compiler's
    message), which decoder runs, and host decode images/s over the
    committed fixtures. A missing decoder is host code: printed, not a
    failure."""
    from mmlspark_tpu_torch.ops import decode, native_build

    native = native_build.load_native("decode") is not None
    out = {"native_built": native,
           "native_build_error": native_build.build_error("decode"),
           "pil_available": decode._pil_image() is not None}
    files = [os.path.join(FIXTURES, f) for f in sorted(os.listdir(FIXTURES))]
    blobs = [open(f, "rb").read() for f in files]
    if native or out["pil_available"]:
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            for b in blobs:
                decode.decode_image(b)
        out["host_decode_images_per_sec"] = \
            reps * len(blobs) / (time.perf_counter() - t0)
    else:
        out["host_decode_images_per_sec"] = None
    out["ctf"] = check_ctf()
    log(f"image decoder: {out}")
    return out


def check_ctf() -> dict:
    """The port's native CTF parser: built or not, and a seeded dataset
    written and read back (natively where it built) equal."""
    import tempfile

    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.data.ctf import read_ctf, write_ctf
    from mmlspark_tpu_torch.ops import native_build

    rng = np.random.default_rng(33)
    feats = rng.normal(size=(512, 32))
    feats[rng.random(feats.shape) < 0.6] = 0.0
    ds = Dataset({"label": rng.integers(0, 5, 512).astype(np.float64),
                  "features": feats})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.ctf")
        write_ctf(ds, path)
        back = read_ctf(path, feature_dim=32)
    equal = bool(np.array_equal(back["features"], feats)
                 and np.array_equal(back["label"], ds["label"]))
    if not equal:
        raise AssertionError("CTF round trip differs")
    return {"native_built": native_build.load_native("ctf") is not None,
            "native_build_error": native_build.build_error("ctf"),
            "round_trip_equal": equal}


def check_featurizer() -> dict:
    """ImageFeaturizer over ResNet-50 at 224 on FEAT_IMAGES seeded uint8
    images of 256x256 (resized, rounded and scaled on the card, a batch
    at a time, straight into the captured programs), as a main path:
    images/s beside the model alone, the resize's own device ms, and the
    features of FEAT_CHECKED images against the CPU's float32 forward on
    the same resized input."""
    import torch

    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.stages import ImageFeaturizer, TPUModel
    from mmlspark_tpu_torch.stages.image import resize_scale

    graph = build_model("resnet50", **FEAT_CONFIG)
    size = graph.input_shape[0]
    weights = init_variables(graph, 8, device=DEVICE)
    images = uint8_images(FEAT_IMAGES, (FEAT_SIZE, FEAT_SIZE), seed=30)
    ds = Dataset({"image": images})
    model = TPUModel(model_name="resnet50", model_config=FEAT_CONFIG,
                     input_col="image", batch_size=FEAT_BATCH,
                     device=DEVICE).set(weights=weights)
    feat = ImageFeaturizer(model=model, cut_output_layers=1,
                           batch_size=FEAT_BATCH, scale=1 / 255)
    cold = timed_path(lambda: feat.transform(ds)["features"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got, wall_ms, counts = timed_path(lambda: feat.transform(ds)["features"])
    peak = torch.cuda.max_memory_allocated()
    scorer = feat._scorer
    chunk = torch.from_numpy(images[:FEAT_BATCH]).to(DEVICE)
    x = resize_scale(chunk, size, size, 1 / 255)
    model_ms = replay_ms(scorer, x)
    # the resize alone, over four device-resident chunks in turn
    chunks = [(torch.from_numpy(images[i:i + FEAT_BATCH]).to(DEVICE),)
              for i in range(0, 4 * FEAT_BATCH, FEAT_BATCH)]
    resize_t = time_ms(lambda c: resize_scale(c, size, size, 1 / 255),
                       chunks, reps=20)
    # the same resized input through the CPU's float32 forward; and the
    # CPU's own resize against the card's
    n = FEAT_CHECKED
    resized = x[:n].cpu()
    want = cpu_forward("resnet50", FEAT_CONFIG, weights, resized.numpy(),
                       output_node="pool")
    err = rel_err(got[:n], want)
    cpu_resized = resize_scale(torch.from_numpy(images[:n]), size, size,
                               1 / 255)
    level = ((cpu_resized - resized).abs() * 255).round()
    if got.shape != (FEAT_IMAGES, 2048) or not np.isfinite(got).all() or \
            err > FEAT_REL_TOL or scorer.program_count != 1:
        raise AssertionError(f"featurizer: {got.shape}, vs CPU f32 {err}, "
                             f"{scorer.program_count} programs")
    out = {
        "model": {"name": "resnet50", "input_size": size,
                  "output": "pool"},
        "images": FEAT_IMAGES, "source_size": FEAT_SIZE,
        "batch": FEAT_BATCH,
        "images_per_sec": FEAT_IMAGES / (wall_ms / 1e3),
        "wall_s": wall_ms / 1e3, "cold_wall_s": cold[1] / 1e3,
        "model_only_ms_per_batch": model_ms,
        "model_only_images_per_sec": FEAT_BATCH / (model_ms / 1e3),
        "resize_device_ms_per_batch": resize_t.ms,
        "resize_call_ms_per_batch": resize_t.call_ms,
        "resize_device_timer_covered": resize_t.covered,
        "host_uint8_bytes": int(images.nbytes),
        "peak_memory_bytes": peak, "programs": scorer.program_count,
        "capture_s": scorer.capture_seconds,
        "features_vs_cpu_f32_rel_err": err,
        "card_vs_cpu_resize_max_levels": float(level.max()),
        "card_vs_cpu_resize_differing_share": float((level > 0).float()
                                                     .mean()),
        "launch_counts_nonzero": {k: v for k, v in counts.items() if v},
    }
    log(f"featurizer: {out}")
    return out


def check_ragged_featurizer() -> dict:
    """RAGGED_IMAGES images of mixed sizes through ImageFeaturizer's host
    path (each resized on the host, then scored on the card), against the
    same host-resized images through the model's own stage."""
    from mmlspark_tpu_torch.core.schema import ImageRow
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.ops import image_ops
    from mmlspark_tpu_torch.stages import ImageFeaturizer, TPUModel

    rng = np.random.default_rng(31)
    rows = [ImageRow(path=str(i), data=uint8_images(
        1, tuple(int(v) for v in rng.integers(*RAGGED_SIZES, size=2)),
        seed=100 + i)[0]) for i in range(RAGGED_IMAGES)]
    graph = build_model("resnet50", **FEAT_CONFIG)
    size = graph.input_shape[0]
    weights = init_variables(graph, 8, device=DEVICE)
    model = TPUModel(model_name="resnet50", model_config=FEAT_CONFIG,
                     input_col="image", batch_size=32, device=DEVICE).set(
        weights=weights)
    feat = ImageFeaturizer(model=model, cut_output_layers=1, batch_size=32,
                           scale=1 / 255)
    got, wall_ms, _ = timed_path(
        lambda: feat.transform(Dataset({"image": rows}))["features"])
    x = np.stack([image_ops.resize(r.data, size, size)
                  for r in rows]).astype(np.float32) / 255
    want = model.copy(output_node="pool").set(weights=weights).transform(
        Dataset({"image": x}))["scores"]
    err = rel_err(got, want)
    if got.shape != (RAGGED_IMAGES, 2048) or err > 1e-3:
        raise AssertionError(f"ragged featurizer: {got.shape}, against the "
                             f"stage on host-resized images {err}")
    out = {"images": RAGGED_IMAGES, "sizes": list(RAGGED_SIZES),
           "images_per_sec": RAGGED_IMAGES / (wall_ms / 1e3),
           "wall_s": wall_ms / 1e3, "vs_host_resized_stage_rel_err": err}
    log(f"ragged featurizer: {out}")
    return out


def check_zoo_featurizer(decoder: dict) -> dict:
    """``ResNet20_Digits04`` fetched by ``ModelDownloader`` from the
    committed repo through a ``file://`` URI (sha256-verified), loaded as
    the port's TPUModel, featurizing the committed fixture images where a
    decoder runs here (numpy-made ones where none does), the ``pool``
    features against the CPU's float32 forward."""
    import tempfile

    from mmlspark_tpu_torch.core.stage import PipelineStage
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.data.readers import read_images
    from mmlspark_tpu_torch.models.zoo import ModelDownloader
    from mmlspark_tpu_torch.stages import ImageFeaturizer, TPUModel

    with tempfile.TemporaryDirectory() as local:
        dl = ModelDownloader(local, remote=f"file://{ZOO_REPO}")
        schema = dl.download_by_name("ResNet20_Digits04")
        stage = PipelineStage.load(dl.local_path(schema))
    if not isinstance(stage, TPUModel):
        raise AssertionError(f"zoo payload loaded as {type(stage)}")
    stage.set(device=DEVICE)
    if decoder["native_built"] or decoder["pil_available"]:
        ds = read_images(FIXTURES)
        source = "committed fixtures"
        images = np.stack([r.data for r in ds["image"]])
    else:
        images = uint8_images(24, (32, 32), seed=32)
        ds = Dataset({"image": images})
        source = "numpy-made (no decoder here)"
    feat = ImageFeaturizer(model=stage, cut_output_layers=1, batch_size=8,
                           scale=1 / 255)
    got, wall_ms, _ = timed_path(lambda: feat.transform(ds)["features"])
    want = cpu_forward(stage.model_name, stage.model_config,
                       feat._scorer._dev_weights,
                       images.astype(np.float32) / 255, output_node="pool")
    err = rel_err(got, want)
    if got.shape != (len(images), 64) or err > STAGE_LOGIT_TOL:
        raise AssertionError(f"zoo featurizer: {got.shape}, vs CPU f32 "
                             f"{err}")
    out = {"model": schema.name, "sha256": schema.hash, "images": source,
           "n": len(images), "wall_ms": wall_ms,
           "features_vs_cpu_f32_rel_err": err}
    log(f"zoo featurizer: {out}")
    return out


def check_image() -> dict:
    """The ``image`` line: the decoder's build status and host rate, the
    ResNet-50 featurizer on the card, the ragged host path, and the zoo
    backbone on the fixtures."""
    out = {"decoder": check_decoder()}
    for label, fn in (("featurizer_resnet50", check_featurizer),
                      ("ragged", check_ragged_featurizer),
                      ("zoo_resnet20_digits04",
                       lambda: check_zoo_featurizer(out["decoder"]))):
        t0 = time.perf_counter()
        out[label] = fn()
        out[label]["phase_s"] = time.perf_counter() - t0
        gc.collect()
    return out


#: the fleet phase: the kill tick (mid-schedule, after the first periodic
#: snapshot), the drain tick, the requests of the corrupt drill
FLEET_KILL_TICK, FLEET_DRAIN_TICK, DRILL_REQUESTS = 6, 4, 4
#: the decode kernels' launch counters, by pool
DECODE_COUNTERS = ("launches", "q8_launches", "paged_launches",
                   "paged_q8_launches")


def fleet_kwargs(**kw) -> dict:
    """Every replica's engine configuration: the single engine's."""
    return dict(slots=SLOTS, cache_len=CACHE_LEN, decode_block=DECODE_BLOCK,
                max_queue=N_REQUESTS, retry_backoff_s=0.0, device=DEVICE,
                **kw)


class FleetProbe:
    """Per-replica decode launches and the hand-off's costs, read by
    wrapping ``ServeEngine.step``, ``_hand_off``, ``_adopt_payload`` and
    the payload checksum for the probe's life (the replicas step one at a
    time, so a step's counter delta is that replica's alone). A timed
    production or adoption runs between two device syncs of the probe's
    own (4 a request, not the engine's), so it holds its own device work
    only: production is the clone plus the checksum, whose host copy
    waits for the clone; adoption is the re-verify plus the slot
    write."""

    def __init__(self):
        self.launches: dict = {}
        self.handoffs: list = []
        self.adoptions: list = []
        self.checksum_ms: list = []
        self.verify_ms: list = []

    def __enter__(self):
        import time as _time

        import mmlspark_tpu_torch.ops.flash_attention as fa
        from mmlspark_tpu_torch.core import integrity
        from mmlspark_tpu_torch.serve.engine import ServeEngine

        self._saved = (ServeEngine.step, ServeEngine._hand_off,
                       ServeEngine._adopt_payload,
                       integrity.payload_checksum, integrity.verify_payload)
        step, hand_off, adopt, checksum, verify = self._saved
        probe = self

        def counts():
            return {k: getattr(fa, k) for k in DECODE_COUNTERS}

        def sync():
            if DEVICE == "cuda":
                import torch

                torch.cuda.synchronize()

        def timed(fn, sink, fence=False):
            def inner(*a, **kw):
                if fence:
                    sync()
                t0 = _time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    if fence:
                        sync()
                    sink.append((_time.perf_counter() - t0) * 1e3)
            return inner

        def probed_step(self_):
            before = counts()
            try:
                return step(self_)
            finally:
                key = f"replica{self_._replica}.{self_.role}"
                tally = probe.launches.setdefault(
                    key, dict.fromkeys(DECODE_COUNTERS, 0))
                for k, v in counts().items():
                    tally[k] += v - before[k]

        def probed_hand_off(self_, *a, **kw):
            sync()
            t0 = _time.perf_counter()
            hand_off(self_, *a, **kw)
            sync()
            pay = self_._outbox[-1]
            probe.handoffs.append({
                "ms": (_time.perf_counter() - t0) * 1e3,
                "bytes": sum(t.numel() * t.element_size()
                             for leaves in pay["kv"].values()
                             for t in leaves),
                "tokens": pay["length"]})

        ServeEngine.step = probed_step
        ServeEngine._hand_off = probed_hand_off
        ServeEngine._adopt_payload = timed(adopt, self.adoptions,
                                           fence=True)
        integrity.payload_checksum = timed(checksum, self.checksum_ms)
        integrity.verify_payload = timed(verify, self.verify_ms)
        return self

    def __exit__(self, *exc):
        from mmlspark_tpu_torch.core import integrity
        from mmlspark_tpu_torch.serve.engine import ServeEngine

        (ServeEngine.step, ServeEngine._hand_off,
         ServeEngine._adopt_payload, integrity.payload_checksum,
         integrity.verify_payload) = self._saved
        return False

    def summary(self) -> dict:
        def mean(xs):
            return statistics.fmean(xs) if xs else None

        def diff(a, b):
            return a - b if a is not None and b is not None else None

        n = len(self.handoffs)
        produce = mean([h["ms"] for h in self.handoffs])
        checksum = mean(self.checksum_ms[:n])
        adopt, verify = mean(self.adoptions), mean(self.verify_ms)
        return {
            "launches_per_replica": self.launches,
            "handoffs": n,
            "payload_bytes_mean": mean([h["bytes"] for h in self.handoffs]),
            "payload_tokens_mean": mean([h["tokens"] for h in
                                         self.handoffs]),
            # production: the clone of rows [0, p), then the checksum,
            # whose host copy waits for the clone on the stream
            "produce_ms_mean": produce,
            "checksum_ms_mean": checksum,
            "clone_ms_mean": diff(produce, checksum),
            # adoption: the re-verify's host copy, then the slot write
            "adopt_ms_mean": adopt,
            "verify_ms_mean": verify,
            "write_ms_mean": diff(adopt, verify),
        }


def drive_set(target, prompts, arrivals: dict | None = None) -> dict:
    """``drive`` for a ReplicaSet or a DisaggFleet: the prompts arrive 2 a
    tick, MAX_NEW tokens each, the launch counts set to 0 just before and
    read just after. ``arrivals`` maps a tick to a callable run before
    it (a drain). Returns the results keyed by global id, the counts and
    the wall seconds."""
    import torch

    zero_counts()
    t0 = time.perf_counter()
    submitted, results, tick = 0, {}, 0
    while submitted < len(prompts) or target.busy:
        if arrivals and tick in arrivals:
            arrivals[tick]()
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < len(prompts):
                target.submit(prompts[submitted], MAX_NEW)
                submitted += 1
        for res in target.step():
            results[res.id] = res
        tick += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    bad = {g: r.status for g, r in results.items()
           if r.status != "completed" or r.generated != MAX_NEW}
    if len(results) != len(prompts) or bad:
        raise AssertionError(f"not every request completed: {bad}")
    tokens = sum(r.generated for r in results.values())
    return dict(results=results, counts=counts, wall_s=wall,
                tokens_per_sec=tokens / wall)


def held_bytes(base: int) -> int:
    """Device bytes allocated over ``base`` after a collection."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - base


def perf_families(engines) -> dict:
    """Each program family's analytics across ``engines`` (the last
    engine's figures where two report one family), gated: every share
    at or under 100%."""
    fams = {}
    for engine in engines:
        for family, f in engine.metrics.to_dict()["perf_families"].items():
            fams[family] = {k: f[k] for k in (
                "flops", "bytes_accessed", "cost_source", "dispatches",
                "device_s", "mfu", "hbm_bw_util_pct")}
    over = {k: f for k, f in fams.items()
            if (f["mfu"] or 0) > 1.0 or (f["hbm_bw_util_pct"] or 0) > 100.0}
    if over or not any(k.startswith("decode[T=") for k in fams) or \
            not any(k.startswith("prefill[") for k in fams):
        raise AssertionError(f"fleet analytics: families {fams}; over "
                             f"100%: {over}")
    if any(f["cost_source"] != "meta" for f in fams.values()):
        raise AssertionError(f"fleet analytics: a family without a cost: "
                             f"{fams}")
    return fams


def check_replica_set(graph, variables, dense: dict) -> dict:
    """ReplicaSet(replicas=2) on the dense bf16 pool over the random
    schedule: a clean run (cold, then warm), a kill of replica 0 mid-
    schedule, and a drain of replica 1 under load; every stream equal to
    the single engine's (``dense``); failover's rebuild and recapture
    seconds and the device memory held with and without failovers."""
    import torch

    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.serve import ReplicaSet

    prompts = random_schedule()
    want = dense["results"]
    out = {}
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    rs = ReplicaSet(graph, variables, replicas=2, **fleet_kwargs())
    with FleetProbe() as probe:
        cold = drive_set(rs, prompts)
    check_near_ties(graph, variables, "replicas clean", cold["results"],
                    want, exact=True)
    for i in range(2):
        fresh_metrics(rs.engine(i))
    warm = drive_set(rs, prompts)
    check_near_ties(graph, variables, "replicas clean warm",
                    {g - N_REQUESTS: r for g, r in warm["results"].items()},
                    want, exact=True)
    out["clean"] = dict(
        tokens_per_sec_cold=cold["tokens_per_sec"],
        tokens_per_sec_warm=warm["tokens_per_sec"],
        single_engine_tokens_per_sec_warm=dense["programs"][
            "warm_tokens_per_sec"],
        launch_counts=cold["counts"],
        launches_per_replica=probe.launches,
        capture_s=[rs.engine(i).capture_seconds for i in range(2)],
        graph_pool_bytes=[rs.engine(i).graph_pool_bytes()
                          for i in range(2)])
    analytics = perf_families([rs.engine(i) for i in range(2)])
    held_clean = held_bytes(base)
    drained = drive_set(rs, prompts, {FLEET_DRAIN_TICK: lambda: rs.drain(1)})
    # a migrated request re-prefills prompt + emitted tokens, whose bf16
    # K/V round otherwise than the decode steps that made them: its
    # stream may first differ at a near tie (the restore rule of the
    # resilience phase)
    ties_drain = check_near_ties(
        graph, variables, "replicas drain",
        {g - 2 * N_REQUESTS: r for g, r in drained["results"].items()},
        want, exact=False)
    if rs.replica_state(1) != "drained" or rs.drains_total != 1:
        raise AssertionError("replicas drain: replica 1 did not retire")
    out["drain"] = dict(tokens_per_sec=drained["tokens_per_sec"],
                        launch_counts=drained["counts"],
                        diverged=ties_drain["diverged"],
                        migrated=sum(1 for e in rs.recorder.events()
                                     if e["name"] == "migrated"))
    del rs
    gc.collect()

    inj = FaultInjector([Fault("serve.decode", "kill", tick=FLEET_KILL_TICK,
                               replica=0)])
    rs = ReplicaSet(graph, variables, replicas=2, faults=inj,
                    **fleet_kwargs())
    timing = {}
    inner = rs._failover

    def timed_failover(rep, cause, reason):
        timing["memory_before"] = held_bytes(base)
        t0 = time.perf_counter()
        inner(rep, cause, reason)
        timing["rebuild_s"] = time.perf_counter() - t0
        timing["memory_after"] = held_bytes(base)

    rs._failover = timed_failover
    killed = drive_set(rs, prompts)
    ties_kill = check_near_ties(graph, variables, "replicas kill",
                                killed["results"], want, exact=False)
    held_killed = held_bytes(base)
    if rs.replica_failovers_total != 1:
        raise AssertionError(f"replicas kill: "
                             f"{rs.replica_failovers_total} failovers")
    if held_killed > 1.25 * held_clean:
        raise AssertionError(
            f"replicas kill: {held_killed} bytes held after the failover "
            f"against {held_clean} without: the dead engine leaked")
    out["kill"] = dict(
        failovers=rs.replica_failovers_total, kill_tick=FLEET_KILL_TICK,
        diverged=ties_kill["diverged"],
        rebuild_s=timing["rebuild_s"],
        recapture_s=rs.engine(0).capture_seconds,
        memory_bytes_at_failover=timing["memory_before"],
        memory_bytes_after_rebuild=timing["memory_after"],
        memory_bytes_held_after_run=held_killed,
        memory_bytes_held_clean=held_clean,
        tokens_per_sec=killed["tokens_per_sec"],
        launch_counts=killed["counts"])
    del rs
    gc.collect()
    log(f"replica set: {out}")
    return out, analytics


def check_disagg(graph, variables, dense: dict, header: dict) -> dict:
    """DisaggFleet(prefill_replicas=1, decode_replicas=2): dense bf16 on
    the random schedule, dense int8 and paged prefix-cache bf16 and int8
    on the header schedule, each against the single engine of its pool on
    the same schedule (the paged int8 one then repeats its header
    requests from the fleet index); per-replica decode launches (the
    prefill replica's must be 0), the hand-off's bytes and ms, the fleet
    index's hits."""
    from mmlspark_tpu_torch.serve import DisaggFleet

    paged = dict(paged=True, page_size=PAGE_SIZE,
                 num_pages=paged_num_pages(), prefix_cache=True)
    out = {}
    for label, kw, prompts, want, counter, exact in (
        ("dense_bf16", {}, random_schedule(), dense["results"],
         "launches", True),
        ("dense_int8", dict(kv_dtype="int8"), header_schedule(),
         header["header dense int8"]["results"], "q8_launches", True),
        ("paged_prefix_bf16", paged, header_schedule(),
         header["header paged bf16"]["results"], "paged_launches", True),
        # the decode replica re-quantizes the handed-off prefix rows,
        # which the prefill replica dequantized out of its shared pages,
        # with fresh per-page scales: a near tie may flip
        ("paged_prefix_int8", dict(paged, kv_dtype="int8"),
         header_schedule(), header["header paged int8"]["results"],
         "paged_q8_launches", False),
    ):
        fleet = DisaggFleet(graph, variables, prefill_replicas=1,
                            decode_replicas=2, **fleet_kwargs(**kw))
        with FleetProbe() as probe:
            run = drive_set(fleet, prompts)
        ties = check_near_ties(graph, variables, f"disagg {label}",
                               run["results"], want, exact=exact)
        md = fleet.metrics_dict()
        per = probe.launches
        prefill_launches = sum(per.get("replica0.prefill", {}).values())
        decode = [per.get(f"replica{i}.decode", {}).get(counter, 0)
                  for i in (1, 2)]
        if prefill_launches or not all(decode) or \
                run["counts"][counter] != sum(decode):
            raise AssertionError(f"disagg {label}: decode launches per "
                                 f"replica {per}")
        if md["handoffs_total"] < N_REQUESTS or \
                md["handoff_fallbacks_total"] or \
                fleet.engine(0).decode_compile_count or \
                any(fleet.engine(i).prefill_compile_count for i in (1, 2)):
            raise AssertionError(f"disagg {label}: {md}")
        out[label] = dict(
            tokens_per_sec=run["tokens_per_sec"],
            launch_counts=run["counts"], handoffs_total=md["handoffs_total"],
            fleet_prefix_hits_total=md["fleet_prefix_hits_total"],
            fleet_prefill_tokens_saved_total=md[
                "fleet_prefill_tokens_saved_total"],
            ttft_ms_p99=md["ttft_ms_p99"], diverged=ties["diverged"],
            **probe.summary())
        if label == "paged_prefix_int8":
            out[label].update(repeat_from_the_index(fleet, prompts, run))
        del fleet
        gc.collect()
    log(f"disagg: {out}")
    return out


def repeat_from_the_index(fleet, prompts, first: dict) -> dict:
    """The header requests again: each an exact repeat, so the fleet
    index serves it decode-only (no prefill anywhere) with the first
    pass's stream; the prefill replica's own prefix cache hit the shared
    header in the first pass."""
    repeats = prompts[::2]
    prefills = fleet.engine(0).metrics.submitted
    hits = fleet.fleet_prefix_hits_total
    again = drive_set(fleet, repeats)
    for i, (gid, res) in enumerate(sorted(again["results"].items())):
        if not np.array_equal(res.tokens, first["results"][2 * i].tokens):
            raise AssertionError(f"fleet index repeat {gid}: the stream "
                                 "differs from the first pass")
    md = fleet.metrics_dict()
    local = fleet.engine(0).pool.paging_stats()["prefix_cache_hits_total"]
    if md["fleet_prefix_hits_total"] - hits != len(repeats) or \
            fleet.engine(0).metrics.submitted != prefills or not local:
        raise AssertionError(f"fleet index: {md}; prefill replica's "
                             f"prefix hits {local}")
    return {"repeats": len(repeats),
            "fleet_prefix_hits_total": md["fleet_prefix_hits_total"],
            "fleet_prefill_tokens_saved_total": md[
                "fleet_prefill_tokens_saved_total"],
            "prefill_replica_prefix_hits": local,
            "repeat_tokens_per_sec": again["tokens_per_sec"],
            "repeat_launch_counts": again["counts"]}


def check_fleet_drills(graph, variables, dense: dict) -> dict:
    """A corrupted hand-off falls back to a full prefill with equal
    streams; a tight SLO sheds admissions and still completes every
    admitted request."""
    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.serve import DisaggFleet, ServeEngine

    prompts = random_schedule()[:DRILL_REQUESTS]
    want = dense["results"]
    inj = FaultInjector([Fault("serve.handoff", "corrupt", tick=0)])
    fleet = DisaggFleet(graph, variables, prefill_replicas=1,
                        decode_replicas=1, faults=inj, **fleet_kwargs())
    run = drive_set(fleet, prompts)
    check_near_ties(graph, variables, "corrupt hand-off", run["results"],
                    want, exact=True)
    md = fleet.metrics_dict()
    if not (md["integrity_handoff_checksum_failures_total"] >= 1
            and md["handoff_fallbacks_total"] >= 1):
        raise AssertionError(f"corrupt hand-off: no fallback: {md}")
    out = {"corrupt_handoff": dict(
        integrity_handoff_checksum_failures_total=md[
            "integrity_handoff_checksum_failures_total"],
        handoff_fallbacks_total=md["handoff_fallbacks_total"])}
    del fleet
    engine = ServeEngine(graph, variables, slo="ttft_p99_ms=0.001,"
                         "min_samples=1,window_s=600", **fleet_kwargs())
    shed = drive_set(engine, random_schedule())
    check_near_ties(graph, variables, "slo shed", shed["results"], want,
                    exact=True)
    d = engine.metrics.to_dict()
    if not (d["slo_shed_ticks_total"] > 0 and d["slo_violations_total"] > 0):
        raise AssertionError(f"slo shed: nothing shed: {d['slo']}")
    out["slo_shed"] = dict(
        slo_shed_ticks_total=d["slo_shed_ticks_total"],
        slo_violations_total=d["slo_violations_total"],
        completed=d["completed"], ttft_ms_p99=d["ttft_ms_p99"],
        tokens_per_sec=shed["tokens_per_sec"])
    out["trace"] = write_trace(engine)
    del engine
    gc.collect()
    return out


def write_trace(engine) -> dict:
    """The engine's Chrome trace, written and parsed back."""
    import tempfile

    from mmlspark_tpu_torch.core.perf import export_chrome_trace

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        export_chrome_trace(engine.recorder, path=path)
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    if not any(e["name"].startswith("decode[T=") for e in slices):
        raise AssertionError("trace: no decode dispatch slice")
    return {"events": len(doc["traceEvents"]), "slices": len(slices)}


def fleet_launches(fleet: dict) -> dict:
    """The decode kernels' launches over every run of the fleet phase;
    each kernel's must be > 0 (each pool ran a fleet)."""
    total = dict.fromkeys(DECODE_COUNTERS, 0)
    runs = [fleet["replica_set"][k]["launch_counts"]
            for k in ("clean", "drain", "kill")]
    for run in fleet["disagg"].values():
        runs.append(run["launch_counts"])
        if "repeat_launch_counts" in run:
            runs.append(run["repeat_launch_counts"])
    for counts in runs:
        for k in DECODE_COUNTERS:
            total[k] += counts[k]
    if not all(total.values()):
        raise AssertionError(f"fleet: a decode kernel was not launched: "
                             f"{total}")
    fleet["launch_counts"] = total
    return total


def check_fleet(graph, variables, dense: dict, header: dict) -> dict:
    """The fleet phase: the replica set, the disaggregated fleet, the
    drills and the analytics (``device_peak`` resolves the card)."""
    from mmlspark_tpu_torch.core.perf import device_peak

    peak = device_peak()
    if DEVICE == "cuda" and peak.source != "table":
        raise AssertionError(f"device_peak: {peak} is not the table's")
    replicas, analytics = check_replica_set(graph, variables, dense)
    return {
        "replica_set": replicas,
        "disagg": check_disagg(graph, variables, dense, header),
        "drills": check_fleet_drills(graph, variables, dense),
        "analytics": {"peak": peak.to_dict(), "families": analytics},
    }


# -- multi-model serving over an imported graph (ROADMAP.md Queue 1 item 19) --

#: the batch deployments: ResNet-50 at 224 on the ladder 1-64, fed 64 + 64
#: + 40 images (the last batch padded to 64), and the serve model exported
#: to ONNX at one 128-token row (its reshape targets bake batch 1)
MM_R50_BATCH, MM_R50_IMAGES, MM_R50_TIMED, MM_R50_SIZE = 64, 168, 256, 224
MM_OX_LEN, MM_OX_ROWS = 128, 8
#: the padded batch's real rows against the unpadded batch's direct
#: apply: bf16 convolutions at another batch size may take another cuDNN
#: algorithm; max abs error over the logits' max abs
MM_PAD_TOL = 2e-2
#: the imported LM (f32 ops) against the native graph computing in f32
#: on the same weights: sums in other orders through 8 layers
MM_OX_F32_TOL = 2e-3
#: seconds every request to the metrics endpoint may take
MM_HTTP_TIMEOUT = 30


def mm_spec(path: str) -> str:
    """The phase's ``--models`` spec: the serve model as ``lm`` under the
    dense engine's configuration, ResNet-50 and the ONNX file."""
    lm = ":".join(f"{k}={v}" for k, v in SERVE_MODEL.items())
    return (f"lm=transformer_lm:{lm}:slots={SLOTS}:cache_len={CACHE_LEN}:"
            f"decode_block={DECODE_BLOCK}:max_queue={N_REQUESTS};"
            f"r50=resnet50:input_size={MM_R50_SIZE}:"
            f"max_batch={MM_R50_BATCH}:max_queue=256;"
            f"ox=onnx:path={path}:max_batch=1:max_queue={MM_OX_ROWS}")


def drive_mm(engine, prompts, examples: dict, hub=None) -> dict:
    """One main path through the multi-model facade: every batch example
    queued first, then the LM prompts arriving 2 a tick (MAX_NEW tokens
    each) — the dense engine's schedule — with every deployment stepped
    each tick; the hub (when given) scraped between ticks. The counts are
    set to 0 just before and read just after."""
    import torch

    zero_counts()
    t0 = time.perf_counter()
    batch_gids = {name: [engine.submit(x, model=name) for x in xs]
                  for name, xs in examples.items()}
    lm_gids, results, submitted = [], {}, 0
    while submitted < len(prompts) or engine.busy:
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < len(prompts):
                lm_gids.append(engine.submit(
                    prompts[submitted], model="lm", max_new_tokens=MAX_NEW))
                submitted += 1
        for res in engine.step():
            results[res.id] = res
        if hub is not None:
            hub.to_prometheus()
            hub.merged_events()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    lm = engine.deployment("lm")
    return dict(
        results={i: results[g] for i, g in enumerate(lm_gids)},
        batch={name: [results[g] for g in gids]
               for name, gids in batch_gids.items()},
        lm_gids=lm_gids, counts=counts, wall_s=wall,
        micro_steps=sum(int(t) * n
                        for t, n in lm.metrics.decode_blocks.items()))


def check_mm_batches(engine, run: dict, images, rows, variables) -> dict:
    """``r50``: each batch bit-equal to a direct apply of the same
    bucket-size batch on the card (the padded one's real rows to the
    direct apply of the same padded batch), and the padded batch's real
    rows within MM_PAD_TOL of the unpadded batch's direct apply; ``ox``:
    every row bit-equal to the imported graph's
    direct apply and within MM_OX_F32_TOL of the native graph computing
    in f32 on the same weights; each deployment's programs within their
    pin, one for each bucket used."""
    import torch

    r50, ox = engine.deployment("r50"), engine.deployment("ox")
    got = np.stack([r.output for r in run["batch"]["r50"]])
    if any(r.status != "completed" for rs in run["batch"].values()
           for r in rs) or got.shape != (MM_R50_IMAGES, 1000) or \
            not np.isfinite(got).all():
        raise AssertionError(f"multimodel r50: outputs {got.shape}")
    out = {}
    for lo in range(0, MM_R50_IMAGES, MM_R50_BATCH):
        x = images[lo:min(lo + MM_R50_BATCH, MM_R50_IMAGES)]
        real = len(x)
        pad = np.zeros((MM_R50_BATCH - real,) + x.shape[1:], x.dtype)
        direct = r50.graph.apply(r50.variables, torch.from_numpy(
            np.concatenate([x, pad])).to(DEVICE)).float().cpu().numpy()
        if not np.array_equal(got[lo:lo + real], direct[:real]):
            raise AssertionError(
                f"multimodel r50 batch at {lo}: not bit-equal to the "
                "direct apply; max abs err "
                f"{np.abs(got[lo:lo + real] - direct[:real]).max()}")
        if real < MM_R50_BATCH:
            unpadded = r50.graph.apply(r50.variables, torch.from_numpy(
                x).to(DEVICE)).float().cpu().numpy()
            out["r50_padded_vs_unpadded_rel_err"] = err = rel_err(
                got[lo:lo + real], unpadded)
            if not err <= MM_PAD_TOL:
                raise AssertionError(f"multimodel r50 padded batch: {err} "
                                     f"> {MM_PAD_TOL}")
    ox_rows = np.stack([r.output for r in run["batch"]["ox"]])
    ids = torch.from_numpy(rows).to(DEVICE)
    ox_direct = np.stack([
        ox.graph.apply(ox.variables, ids[i:i + 1]).cpu().numpy()[0]
        for i in range(len(rows))])
    if ox_rows.shape != (MM_OX_ROWS, MM_OX_LEN, SERVE_MODEL["vocab_size"]) \
            or not np.array_equal(ox_rows, ox_direct):
        raise AssertionError(f"multimodel ox: {ox_rows.shape}, not "
                             "bit-equal to the direct apply")
    native = f32_graph().apply(variables, ids)
    out["ox_vs_native_f32_max_abs_err"] = err = float(
        np.abs(ox_rows - native.cpu().numpy()).max())
    if not err <= MM_OX_F32_TOL:
        raise AssertionError(f"multimodel ox vs the native f32 graph: "
                             f"{err} > {MM_OX_F32_TOL}")
    for name, dep in (("r50", r50), ("ox", ox)):
        # a batch deployment's metrics count its dispatches by bucket
        used = sorted(int(b) for b in dep.metrics.decode_blocks)
        if dep.batch_compile_count != len(used) or \
                dep.batch_compile_count > dep.num_batch_buckets:
            raise AssertionError(
                f"multimodel {name}: {dep.batch_compile_count} programs "
                f"(pin {dep.num_batch_buckets}, buckets used {used})")
        out[f"{name}_programs"] = {
            "count": dep.batch_compile_count, "buckets_used": used,
            "num_batch_buckets": dep.num_batch_buckets}
    return out


def check_mm_fairness(engine, prompts, images, rows) -> dict:
    """``device_budget=1`` while ``lm`` saturates: each batch deployment
    dispatches within ceil(3 / 1) = 3 ticks of its examples' arrival.
    Counted as a main path of its own."""
    engine.device_budget = 1
    try:
        zero_counts()
        for p in prompts:
            engine.submit(p, model="lm", max_new_tokens=MAX_NEW)
        for _ in range(3):
            engine.step()
        waiting = {"r50": {engine.submit(x, model="r50")
                           for x in images[:4]},
                   "ox": {engine.submit(rows[0], model="ox")}}
        served = {}
        for tick in range(1, 4):
            done = {r.id for r in engine.step()}
            for name, gids in waiting.items():
                if name not in served and gids <= done:
                    served[name] = tick
        engine.run()
        counts = read_counts()
    finally:
        engine.device_budget = None
    if set(served) != {"r50", "ox"} or max(served.values()) > 3:
        raise AssertionError(f"multimodel fairness: served at ticks "
                             f"{served} under a saturating LM stream")
    return {"ticks_to_serve": served, "launch_counts": counts}


def check_mm_faults(r50, images) -> dict:
    """A fresh ResNet-50 deployment under ``serve.batch`` faults: a
    transient at tick 0 retried and absorbed; buckets 64 and 32 captured;
    an ``oom`` at tick 2 halves the admission cap to 32, the requeued 64
    images run on the existing bucket-32 program (no new program) and two
    clean dispatches recover the cap."""
    half = MM_R50_BATCH // 2
    from mmlspark_tpu_torch.core.faults import Fault, FaultInjector
    from mmlspark_tpu_torch.serve import BatchDeployment
    from mmlspark_tpu_torch.testing import compile_guard

    drill = BatchDeployment(
        r50.graph, r50.variables, max_batch=MM_R50_BATCH, max_queue=256,
        faults=FaultInjector([Fault("serve.batch", "transient", tick=0),
                              Fault("serve.batch", "oom", tick=2)]),
        retry_limit=2, degrade_recover_ticks=2, device=DEVICE)
    results = {}

    def step():
        for r in drill.step():
            results[r.id] = r

    for x in images[:MM_R50_BATCH]:
        drill.submit(x)
    step()
    for x in images[:half]:
        drill.submit(x)
    step()
    programs = drill.batch_compile_count
    for x in images[:MM_R50_BATCH]:
        drill.submit(x)
    caps = []
    with compile_guard(lambda: drill.batch_compile_count, max_programs=0,
                       label="multimodel oom drill"):
        while drill.busy or drill.degraded:
            step()
            caps.append(drill._admit_cap)
            if len(caps) > 8:
                break
    done = sum(r.status == "completed" for r in results.values())
    out = {"retries": drill.metrics.retries_total,
           "faults_injected": drill.metrics.faults_injected_total,
           "programs": drill.batch_compile_count,
           "admit_caps_after_oom": caps, "completed": done}
    if drill.metrics.retries_total != 1 or programs != 2 or \
            caps[:3] != [half, half, MM_R50_BATCH] or drill.degraded or \
            done != 2 * MM_R50_BATCH + half:
        raise AssertionError(f"multimodel faults drill: {out}")
    drill.release_programs()
    return out


def check_mm_hub(hub, engine, run: dict, tmp: str) -> dict:
    """The hub's outputs after the main path: the merged timeline ordered
    by wall time, one chain per LM request under its facade trace id, a
    trace that round-trips through JSON, and ``GET /metrics`` on an
    ephemeral loopback port (a timeout on the request; the server closed
    in a ``finally``) with every deployment's labeled series; the
    refresh, export and bundle costs on the host clock."""
    import urllib.request

    from mmlspark_tpu_torch.core.tracehub import MetricsServer

    out = {}
    t0 = time.perf_counter()
    hub.refresh()
    out["refresh_ms"] = (time.perf_counter() - t0) * 1e3
    walls = [ev["wall"] for ev in hub.merged_events()]
    chains = hub.request_chains()
    missing = [g for g in run["lm_gids"]
               if not {"routed", "start"} <= {
                   ev["name"] for ev in chains.get(f"m{g}", [])}]
    if walls != sorted(walls) or missing:
        raise AssertionError(f"multimodel hub: timeline ordered "
                             f"{walls == sorted(walls)}, chains missing "
                             f"{missing}")
    t0 = time.perf_counter()
    doc = hub.export_trace()
    out["export_ms"] = (time.perf_counter() - t0) * 1e3
    out["trace_events"] = len(json.loads(json.dumps(doc,
                                                     default=str))[
        "traceEvents"])
    t0 = time.perf_counter()
    hub.write_bundle(os.path.join(tmp, "bundle"),
                     metrics=engine.metrics_dict())
    out["bundle_ms"] = (time.perf_counter() - t0) * 1e3
    server = MetricsServer(hub, port=0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics",
            timeout=MM_HTTP_TIMEOUT).read().decode()
    finally:
        server.close()
    want = [f'serve_completed_total{{model="{m}"}}' for m in engine.models]
    if not all(w in body for w in want):
        raise AssertionError(f"multimodel /metrics lacks {want}")
    out.update(metrics_bytes=len(body), merged_events=len(walls),
               chains=len(chains))
    return out


def mm_timings(engine, images, rows, variables, graph) -> dict:
    """Warm figures: ``r50`` images/s through the facade alone (copy in,
    replay, copy out) and its program alone (replays, device time), and
    ``ox`` ms a batch beside the native graph's forward on the same ids,
    both replayed from a CUDA graph."""
    import torch

    r50, ox = engine.deployment("r50"), engine.deployment("ox")
    for x in images[:MM_R50_TIMED]:
        r50.submit(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while r50.busy:
        r50.step()
    wall = time.perf_counter() - t0
    x = torch.from_numpy(images[:MM_R50_BATCH]).to(DEVICE)
    program = r50._dispatch
    for _ in range(2):
        program(r50.variables, x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        program(r50.variables, x)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 20
    ids = torch.from_numpy(rows[:1]).to(DEVICE)
    return {
        "r50_images_per_sec": MM_R50_TIMED / wall,
        "r50_program_ms_per_batch": ms,
        "r50_program_images_per_sec": MM_R50_BATCH / (ms / 1e3),
        "ox_ms_per_batch": graph_ms(
            lambda t: ox.graph.apply(ox.variables, t), [(ids,)]),
        "native_bf16_ms_per_batch": graph_ms(
            lambda t: graph.apply(variables, t), [(ids,)]),
    }


def check_mm_replicas(graph, variables, dense: dict) -> dict:
    """``ReplicaSet(models={"lm": ..., "lm2": ...}, replicas=2)``: the
    even prompts to ``lm`` (the dense engine's weights), the odd ones to
    ``lm2`` (other seeded weights), 2 a tick; every request routed to its
    model's replica, ``lm``'s streams equal to the dense engine's and
    ``lm2``'s to a dedicated engine's on the same prompts; the hub sees
    both replicas with their model labels."""
    import torch

    from mmlspark_tpu_torch.core.tracehub import TelemetryHub
    from mmlspark_tpu_torch.models import init_variables
    from mmlspark_tpu_torch.serve import ReplicaSet

    prompts = random_schedule()
    v2 = init_variables(graph, 17, device=DEVICE)
    solo = drive(make_engine(graph, v2), prompts[1::2])
    rs = ReplicaSet(graph, variables, replicas=2,
                    models={"lm": (graph, variables), "lm2": (graph, v2)},
                    **fleet_kwargs())
    hub = TelemetryHub()
    hub.attach_replicaset(rs)
    zero_counts()
    t0 = time.perf_counter()
    gids, submitted, results = [], 0, {}
    while submitted < len(prompts) or rs.busy:
        for _ in range(ARRIVALS_PER_TICK):
            if submitted < len(prompts):
                gids.append(rs.submit(
                    prompts[submitted], MAX_NEW,
                    model="lm" if submitted % 2 == 0 else "lm2"))
                submitted += 1
        for res in rs.step():
            results[res.id] = res
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for i, g in enumerate(gids):
        want = dense["results"][i] if i % 2 == 0 else \
            solo["results"][i // 2]
        if results[g].status != "completed" or \
                not np.array_equal(results[g].tokens, want.tokens):
            raise AssertionError(f"model routing: request {i} "
                                 f"({'lm' if i % 2 == 0 else 'lm2'}) "
                                 "differs from its dedicated engine")
    per = rs.metrics_dict()["per_replica"]
    routed = {k: (v["model"], v["submitted"]) for k, v in per.items()}
    prom = hub.to_prometheus()
    half = N_REQUESTS // 2
    if routed != {"replica0": ("lm", half), "replica1": ("lm2", half)} or \
            'model="lm2"' not in prom:
        raise AssertionError(f"model routing: {routed}")
    return {"routed": routed, "launch_counts": counts, "wall_s": wall,
            "tokens_per_sec": sum(r.generated for r in results.values())
            / wall}


def check_multimodel(graph, variables, dense: dict, smi: str,
                     r50_alone: float) -> dict:
    """The multi-model phase: ``engine_from_spec`` over ``lm`` (the serve
    model, the dense engine's weights and configuration), ``r50`` (ResNet-
    50 at 224, seeded weights drawn on the card) and ``ox`` (the serve
    model written by the port's ONNX exporter at one 128-token row,
    imported back) with a TelemetryHub attached; then fairness, the fault
    drill, the warm figures, model routing over replicas and the
    teardown. Every figure beside the card's name and power limit."""
    import tempfile

    import torch

    from mmlspark_tpu_torch.core.tracehub import TelemetryHub
    from mmlspark_tpu_torch.models.onnx_export import save_onnx
    from mmlspark_tpu_torch.serve import engine_from_spec
    from mmlspark_tpu_torch.testing import compile_guard

    # full float32 products and convolutions: a TF32 convolution is what
    # the bit-equality gates must not silently absorb
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts = random_schedule()
    images = seeded_images(max(MM_R50_IMAGES, MM_R50_TIMED), MM_R50_SIZE,
                           seed=13)
    rows = np.random.default_rng(13).integers(
        0, SERVE_MODEL["vocab_size"], size=(MM_OX_ROWS, MM_OX_LEN)
    ).astype(np.int32)
    out = {"card": smi, "spec_shapes": {
        "r50_max_batch": MM_R50_BATCH, "ox_sample_shape": [1, MM_OX_LEN]}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_model.onnx")
        t0 = time.perf_counter()
        save_onnx(graph, variables, (1, MM_OX_LEN), path)
        out["onnx_export_s"] = time.perf_counter() - t0
        out["onnx_bytes"] = os.path.getsize(path)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine = engine_from_spec(mm_spec(path), variables={"lm": variables},
                                  seed=13, device=DEVICE)
        out["build_s"] = time.perf_counter() - t0
        lm = engine.deployment("lm")
        fetches = []
        inner = lm._fetch
        lm._fetch = lambda inflight: fetches.append(1) or inner(inflight)
        hub = TelemetryHub()
        hub.attach_multimodel(engine)
        examples = {"r50": list(images[:MM_R50_IMAGES]), "ox": list(rows)}
        run = drive_mm(engine, prompts, examples, hub)
        check_run("multimodel lm", run, "launches")
        check_near_ties(graph, variables, "multimodel lm", run["results"],
                        dense["results"], exact=True)
        blocks = sum(lm.metrics.decode_blocks.values())
        programs = {"decode_compile_count": lm.decode_compile_count,
                    "prefill_compile_count": lm.prefill_compile_count}
        want = {k: dense["programs"][k] for k in programs}
        if programs != want or len(fetches) != blocks:
            raise AssertionError(
                f"multimodel lm with the hub: programs {programs} (the "
                f"dense engine's {want}), {len(fetches)} fetches over "
                f"{blocks} decode blocks")
        out["lm"] = {"cold_tokens_per_sec": lm.metrics.to_dict()[
            "tokens_per_sec"], "fetches": len(fetches),
            "decode_blocks": blocks, **programs}
        out.update(check_mm_batches(engine, run, images, rows, variables))
        out["hub"] = check_mm_hub(hub, engine, run, tmp)
        out["launch_counts"] = run["counts"]
        out["main_path_wall_s"] = run["wall_s"]

        # the warm pass: every program already captured
        fresh_metrics(lm)
        guards = [compile_guard(lambda d=d: d.batch_compile_count,
                                max_programs=0, label=f"warm {n}")
                  for n, d in (("r50", engine.deployment("r50")),
                               ("ox", engine.deployment("ox")))]
        with compile_guard(lambda: lm.decode_compile_count, max_programs=0,
                           label="multimodel warm decode"), \
                compile_guard(lambda: lm.prefill_compile_count,
                              max_programs=0,
                              label="multimodel warm prefill"), \
                guards[0], guards[1]:
            warm = drive_mm(engine, prompts, examples)
        check_run("multimodel lm warm", warm, "launches")
        out["lm"].update(
            warm_tokens_per_sec=lm.metrics.to_dict()["tokens_per_sec"],
            dense_engine_warm_tokens_per_sec=dense["programs"][
                "warm_tokens_per_sec"])
        out["fairness"] = check_mm_fairness(engine, prompts, images, rows)
        out["faults"] = check_mm_faults(engine.deployment("r50"), images)
        out["timings"] = mm_timings(engine, images, rows, variables, graph)
        out["timings"]["r50_model_alone_images_per_sec_dnn_stages"] = \
            r50_alone
        out["deployments"] = {
            name: {"capture_s": dep.capture_seconds,
                   "graph_pool_bytes": dep.graph_pool_bytes()}
            for name, dep in ((n, engine.deployment(n))
                              for n in engine.models)}
        held = torch.cuda.memory_allocated() - base
        engine.close()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        after = {n: engine.deployment(n).graph_pool_bytes()
                 for n in engine.models}
        out["teardown"] = {"held_bytes_before_close": held,
                           "held_bytes_after_close":
                               torch.cuda.memory_allocated() - base,
                           "graph_pool_bytes_after_close": after}
        if any(after.values()) or DEVICE == "cuda" and not all(
                d["graph_pool_bytes"] > 0
                for d in out["deployments"].values()):
            raise AssertionError(f"multimodel teardown: {out['teardown']}, "
                                 f"{out['deployments']}")
        del engine, lm, hub
        gc.collect()
    out["replicas"] = check_mm_replicas(graph, variables, dense)
    log(f"multimodel: {out}")
    return out


# -- the classical one-liner path (PR 14) ------------------------------------

#: the real Adult train split's row count and 14-column schema
#: (``bench.py``'s census scale); the flights table at the same rows
CENSUS_ROWS = 32561
CENSUS_SEED, FLIGHTS_SEED = 11, 3
#: (label, TrainClassifier kwargs) over the census table
CLASSIFIER_RUNS = (
    ("gbt", dict(model="gbt", max_iter=10, max_depth=5)),
    ("random_forest", dict(model="random_forest")),
    ("decision_tree", dict(model="decision_tree")),
    ("naive_bayes", dict(model="naive_bayes")),
    ("logistic_regression_e1", dict(model="logistic_regression", epochs=1,
                                    batch_size=256)),
    ("logistic_regression_e5", dict(model="logistic_regression", epochs=5,
                                    batch_size=256)),
    ("mlp", dict(model="mlp")),
)
REGRESSOR_RUNS = tuple((m, dict(model=m)) for m in (
    "linear_regression", "decision_tree", "random_forest", "gbt", "mlp"))
TREE_LEARNERS = ("decision_tree", "random_forest", "gbt")
#: "census scale x 2^12 hashed dims": 64 dense columns and 4032 sparse
#: hashed counts, labels from a seeded rule over a few of them
WIDE_ROWS, WIDE_DENSE, WIDE_HASHED = 32561, 64, 4032
WIDE_FIT = dict(max_iter=4, max_depth=5, max_bins=32)
#: gini trees count rows (exact in f32); boosted and variance trees'
#: predictions; one fitted model scored on the card and on the CPU; the
#: wide histogram's float sums against float64, relative to the sum of
#: magnitudes in each bin
GINI_VALUE_TOL = 1e-6
GBT_PRED_TOL = 1e-4
SCORE_TOL = 1e-6
HIST_REL_TOL = 1e-4
TITANIC_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "titanic.csv")
#: notebook 101's accuracy floor on the Titanic table
#: (examples/e101_adult_census_train_classifier.py)
TITANIC_FLOOR = 0.73
TITANIC_LEARNERS = ("logistic_regression", "gbt", "random_forest")


class HostClock:
    """Seconds a fit spends in its host phases: binning
    (``trees.quantile_edges`` and ``trees.bin_features``) and
    ``Featurize`` (fit and transform), by wrapping those functions for
    the block, as ``bench.py``'s ``bench_trees`` does."""

    def __init__(self):
        self.seconds = {"binning": 0.0, "featurize": 0.0}
        self._saved: list = []

    def __enter__(self):
        from mmlspark_tpu_torch.stages import featurize, trees

        for owner, name, key in (
                (trees, "quantile_edges", "binning"),
                (trees, "bin_features", "binning"),
                (featurize.Featurize, "_fit", "featurize"),
                (featurize.FeaturizeModel, "_transform", "featurize")):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, key))
        return self

    def _wrap(self, fn, key):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[key] += time.perf_counter() - t0
        return timed

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def classical_fit(make, ds) -> tuple:
    """One fit, ``make().fit(ds)``: (the model, {its seconds, the host
    phases' seconds, the tree fetches it made, its peak device memory
    over what was allocated when it began})."""
    import torch

    from mmlspark_tpu_torch.stages import trees

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = trees.fetches
    t0 = time.perf_counter()
    with HostClock() as clock:
        model = make().fit(ds)
    torch.cuda.synchronize()
    return model, {
        "s": time.perf_counter() - t0,
        "binning_s": clock.seconds["binning"],
        "featurize_s": clock.seconds["featurize"],
        "fetches": trees.fetches - before,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() - held,
    }


def bit_equal_trees(a, b) -> bool:
    return all(np.array_equal(np.asarray(getattr(a, k)),
                              np.asarray(getattr(b, k)))
               for k in ("feats", "threshs", "values",
                         "feature_importances"))


def subset_scores(model, idx, feats) -> np.ndarray:
    """The CPU scores of the trees ``idx`` of a fitted tree model."""
    params = dict(model.param_values())
    for k in ("feats", "threshs", "values"):
        params[k] = np.asarray(params[k])[idx]
    params["device"] = "cpu"
    return np.asarray(type(model)(**params).transform(feats)["scores"])


def card_vs_cpu(card, cpu, x, y, feats, est) -> dict:
    """One tree fit on the card against the same fit on the CPU (the
    plain path): gini trees equal in structure with values within
    GINI_VALUE_TOL; boosted and variance trees equal in structure or
    parting only at near ties (two candidates' gains within 1e-5
    relative, ``testing/tree_parity.py``), their predictions within
    GBT_PRED_TOL over the trees before a boosted fit parts (all of them
    where it does not) or over a forest's agreeing trees."""
    from mmlspark_tpu_torch.testing.tree_parity import (
        forest_divergence,
        gbt_divergence,
    )

    kind = type(cpu).__name__
    same = bool(np.array_equal(card.feats, cpu.feats)
                and np.array_equal(card.threshs, cpu.threshs))
    out = {"structures_equal": same, "near_ties": 0, "splits": []}
    if kind == "TreeClassifierModel":
        out["values_max_abs_err"] = float(np.abs(card.values
                                                 - cpu.values).max())
        if not same or out["values_max_abs_err"] > GINI_VALUE_TOL:
            raise AssertionError(f"gini trees: card != cpu ({out})")
        return out
    trees_ = range(cpu.feats.shape[0])
    if kind == "TreeRegressorModel":
        div = forest_divergence(
            cpu, card, x, y, seed=est.seed, subsample=est.subsample,
            feature_subset=est.feature_subset, lam=est.lambda_,
            max_bins=est.max_bins)
        keep = [i for i in trees_ if i not in div["diverged_trees"]]
    else:
        div = gbt_divergence(cpu, card, x, y, lam=est.lambda_,
                             max_bins=est.max_bins)
        first = div["first_diverged_tree"]
        keep = list(trees_)[:first] if first is not None else list(trees_)
    out["splits"] = div["splits"]
    out["near_ties"] = len(div["splits"])
    out["trees_compared"] = len(keep)
    if not all(s["near_tie"] for s in div["splits"]):
        raise AssertionError(f"{kind}: a split differs past a near tie "
                             f"({div['splits']})")
    if keep:
        err = float(np.abs(subset_scores(card, keep, feats)
                           - subset_scores(cpu, keep, feats)).max())
        out["pred_max_abs_err"] = err
        if err > GBT_PRED_TOL:
            raise AssertionError(f"{kind}: card vs cpu predictions {out}")
    return out


def score_card_and_cpu(model, ds) -> dict:
    """One fitted model scored on the card and on the CPU, within
    SCORE_TOL; the card's warm scoring rows/s, end to end (featurize on
    the host included) and of the learner alone on featurized rows."""
    import torch

    model.transform(ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = np.asarray(model.transform(ds)["scores"])
    e2e_s = time.perf_counter() - t0
    feats = model.featurizer.transform(ds)
    learner = model.learner_model
    t0 = time.perf_counter()
    learner.transform(feats)
    torch.cuda.synchronize()
    learner_s = time.perf_counter() - t0
    device = learner.device
    learner.set(device="cpu")
    try:
        cpu = np.asarray(model.transform(ds)["scores"])
    finally:
        learner.set(device=device)
    err = float(np.abs(card - cpu).max())
    if err > SCORE_TOL:
        raise AssertionError(f"scores card vs cpu {err}")
    return {"card_vs_cpu_max_abs_err": err,
            "rows_per_sec": ds.num_rows / e2e_s,
            "learner_rows_per_sec": ds.num_rows / learner_s}


def training_labels(model, ds, label_col: str) -> np.ndarray:
    """The learner's training labels: class indices over the model's
    levels, or the float targets."""
    if hasattr(model, "levels"):
        index = {v: i for i, v in enumerate(model.levels)}
        return np.asarray([index[v] for v in ds[label_col]], np.int64)
    return np.asarray(ds[label_col], np.float64)


def classical_table(label_col: str, runs, ds, train_cls,
                    metric_keys) -> dict:
    """Every learner of ``runs`` through ``train_cls`` on ``ds``: a cold
    and a warm fit on the card (a tree learner's two bit-identical, one
    fetch each), the tree learners against the same fit on the CPU,
    scoring on the card against the CPU, and the training-set
    metrics."""
    from mmlspark_tpu_torch.stages.eval_metrics import ComputeModelStatistics

    out = {}
    for label, kw in runs:
        def make(device=DEVICE, kw=kw):
            return train_cls(label_col=label_col, seed=0, device=device,
                             **kw)

        cold, cold_t = classical_fit(make, ds)
        warm, warm_t = classical_fit(make, ds)
        row = {"cold": cold_t, "warm": warm_t}
        stats = ComputeModelStatistics().transform(warm.transform(ds))
        row["metrics"] = {k: float(stats[k][0]) for k in metric_keys
                          if k in stats.columns}
        if kw["model"] in TREE_LEARNERS:
            if not bit_equal_trees(cold.learner_model, warm.learner_model):
                raise AssertionError(f"{label}: two card fits differ")
            if (cold_t["fetches"], warm_t["fetches"]) != (1, 1):
                raise AssertionError(
                    f"{label}: {cold_t['fetches']} and {warm_t['fetches']}"
                    " fetches (one a fit)")
            cpu, cpu_t = classical_fit(lambda: make("cpu"), ds)
            feats = cpu.featurizer.transform(ds)
            est = make()
            est = (est._make_learner(len(cpu.levels))
                   if hasattr(cpu, "levels") else est._make_learner())
            row["cpu_s"] = cpu_t["s"]
            row["deterministic"] = True
            row["card_vs_cpu"] = card_vs_cpu(
                warm.learner_model, cpu.learner_model,
                np.asarray(feats["features"], np.float64),
                training_labels(cpu, ds, label_col), feats, est)
            row["scoring"] = score_card_and_cpu(warm, ds)
        log(f"classical {label}: {row}")
        out[label] = row
    return out


def profile_fit(make, ds) -> dict:
    """One warm fit under ``torch.profiler``: device busy share and the
    kernels that take its time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        make().fit(ds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_profile(prof, wall_ms)


def wide_table(seed: int = 41) -> tuple:
    """The wide case's seeded [WIDE_ROWS, 4096] features and labels."""
    rng = np.random.default_rng(seed)
    x = np.empty((WIDE_ROWS, WIDE_DENSE + WIDE_HASHED), np.float64)
    x[:, :WIDE_DENSE] = rng.standard_normal((WIDE_ROWS, WIDE_DENSE))
    x[:, WIDE_DENSE:] = rng.poisson(0.2, (WIDE_ROWS, WIDE_HASHED))
    score = (x[:, 0] + 0.8 * x[:, 1] - 0.6 * x[:, 2] * x[:, 3]
             + 1.5 * x[:, WIDE_DENSE] - 1.0 * x[:, WIDE_DENSE + 7])
    y = (score + 0.3 * rng.standard_normal(WIDE_ROWS) > 0.2).astype(np.int64)
    return x, y


def root_histogram_check(model, x, y) -> dict:
    """The first round's root-level histogram (class 0) of the wide fit on
    the card against a float64 numpy ``bincount`` over the same codes:
    counts exact, gradient and hessian sums within HIST_REL_TOL of the
    sum of magnitudes in their bin; and the level histogram's device ms
    at the root (1 node) and at depth 4 (16 nodes), beside its byte
    bound (codes, stats and node ids read once, the histogram written
    once, at HBM_BYTES_PER_S)."""
    import torch

    from mmlspark_tpu_torch.stages import trees

    dev = torch.device(DEVICE)
    n, d = x.shape
    max_bins = WIDE_FIT["max_bins"]
    codes = trees.bin_features(x, np.asarray(model.edges))
    bins = trees._device_bins(codes, max_bins, dev)
    k = len(model.base)
    margins = torch.tensor(np.asarray(model.base, np.float32),
                           device=dev)[None, :].expand(n, k)
    p = trees._softmax(margins)
    onehot = torch.from_numpy(np.eye(k, dtype=np.float32)[y]).to(dev)
    g, h = p - onehot, p * (1.0 - p)
    stats = torch.stack([g[:, 0], h[:, 0], torch.ones(n, device=dev)], 1)
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    hist = trees._level_histogram(bins, stats, slot, 1, max_bins)[0]
    hist = hist.cpu().numpy().astype(np.float64)
    ids = (codes + max_bins * np.arange(d)[None, :]).ravel()
    size = d * max_bins
    s64 = stats.cpu().numpy().astype(np.float64)
    counts = np.bincount(ids, minlength=size).reshape(d, max_bins)
    worst = 0.0
    for j in (0, 1):
        w = np.repeat(s64[:, j], d)
        ref = np.bincount(ids, weights=w, minlength=size)
        mag = np.bincount(ids, weights=np.abs(w), minlength=size)
        got = hist[:, :, j].ravel()
        worst = max(worst, float((np.abs(got - ref)
                                  / np.maximum(mag, 1e-30)).max()))
    counts_exact = bool(np.array_equal(hist[:, :, 2], counts))
    if not counts_exact or worst > HIST_REL_TOL:
        raise AssertionError(f"wide root histogram: counts exact "
                             f"{counts_exact}, sums rel err {worst}")
    timing = {}
    for nodes in (1, 16):
        slot_n = torch.from_numpy(np.random.default_rng(nodes).integers(
            0, nodes, n)).to(dev)
        t = time_ms(lambda s: trees._level_histogram(bins, stats, s, nodes,
                                                     max_bins),
                    [(slot_n,)], reps=10)
        nbytes = n * d + n * 3 * 4 + n * 8 + nodes * d * max_bins * 3 * 4
        bound = max(nbytes / HBM_BYTES_PER_S, n * d * 3 / F32_FLOPS_PER_S)
        timing[f"nodes_{nodes}"] = {
            "ms": t.ms, "call_ms": t.call_ms, "covered": t.covered,
            "bytes": nbytes, "bound_ms": bound * 1e3, "bound_by": "bytes"
            if nbytes / HBM_BYTES_PER_S >= n * d * 3 / F32_FLOPS_PER_S
            else "operations"}
    return {"counts_exact": counts_exact, "sums_max_rel_err": worst,
            "level_histogram": timing}


def check_wide() -> dict:
    """The wide case: two card fits of GBTClassifier(**WIDE_FIT) on the
    seeded [32561, 4096] table, bit-identical, one fetch each; the root
    histogram against numpy and its device ms beside its bound."""
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.stages.trees import GBTClassifier

    t0 = time.perf_counter()
    x, y = wide_table()
    ds = Dataset({"features": x, "label": y})
    gen_s = time.perf_counter() - t0

    def make():
        return GBTClassifier(seed=0, device=DEVICE, **WIDE_FIT)

    a, a_t = classical_fit(make, ds)
    b, b_t = classical_fit(make, ds)
    if not bit_equal_trees(a, b) or (a_t["fetches"], b_t["fetches"]) != (1, 1):
        raise AssertionError(f"wide: bit-equal {bit_equal_trees(a, b)}, "
                             f"fetches {a_t['fetches']}, {b_t['fetches']}")
    out = {"rows": WIDE_ROWS, "features": x.shape[1], "fit": WIDE_FIT,
           "table_seconds": gen_s, "cold": a_t, "warm": b_t,
           "deterministic": True,
           "bins_bytes": WIDE_ROWS * x.shape[1]}
    out.update(root_histogram_check(a, x, y))
    per_fit = WIDE_FIT["max_iter"] * len(a.base) * WIDE_FIT["max_depth"]
    levels = out["level_histogram"]
    out["level_histograms_per_fit"] = per_fit
    out["histogram_s_per_fit_estimate"] = per_fit * 0.5 * (
        levels["nodes_1"]["ms"] + levels["nodes_16"]["ms"]) / 1e3
    log(f"classical wide: {out}")
    return out


def check_matrices() -> dict:
    """The recorded learner matrices retrained on the card: every tree
    and naive-Bayes row within the JAX test's TOL of the recorded CSVs,
    the logistic/linear/MLP rows within NN_TOL, every row's gap
    reported."""
    from mmlspark_tpu_torch.testing import benchmark_metrics as bm

    t0 = time.perf_counter()
    cls = bm.compare_to_recorded(bm.run_matrix(device=DEVICE))
    t1 = time.perf_counter()
    reg = bm.compare_to_recorded(bm.run_regressor_matrix(device=DEVICE),
                                 regression=True)
    t2 = time.perf_counter()
    bad = cls["mismatches"] + reg["mismatches"] + cls["missing"] + \
        reg["missing"]
    if bad:
        raise AssertionError(f"recorded matrices: {bad}")
    return {"tol": bm.TOL, "nn_tol": bm.NN_TOL,
            "classifier_gaps": cls["gaps"], "regressor_gaps": reg["gaps"],
            "classifier_matrix_s": t1 - t0, "regressor_matrix_s": t2 - t1}


def read_titanic():
    """``tests/fixtures/titanic.csv`` as ``data.readers.read_csv`` reads
    it, without pandas (the card machine has none): a column whose cells
    all parse as numbers is int64 (no gaps, all integral) or float64 with
    nan for gaps; any other column holds its strings, nan for gaps."""
    import csv

    from mmlspark_tpu_torch.data import Dataset

    with open(TITANIC_CSV, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    cols = {}
    for j, name in enumerate(header):
        cells = [r[j] for r in body]
        try:
            vals = [float(c) if c != "" else np.nan for c in cells]
        except ValueError:
            cols[name] = [c if c != "" else np.nan for c in cells]
            continue
        arr = np.asarray(vals)
        if not np.isnan(arr).any() and np.all(arr == np.round(arr)):
            arr = arr.astype(np.int64)
        cols[name] = arr
    return Dataset(cols)


def notebook_101(device) -> dict:
    """Notebook 101's flow (examples/e101): the Titanic table split 3:1,
    ``CleanMissingData`` over age and fare, ``TrainClassifier`` for
    TITANIC_LEARNERS, ``FindBestModel`` by AUC, a save and
    ``PipelineStage.load``, then ``ComputeModelStatistics``."""
    import tempfile

    from mmlspark_tpu_torch.core.stage import PipelineStage
    from mmlspark_tpu_torch.stages.eval_metrics import ComputeModelStatistics
    from mmlspark_tpu_torch.stages.find_best import FindBestModel
    from mmlspark_tpu_torch.stages.prep import CleanMissingData
    from mmlspark_tpu_torch.stages.train_classifier import TrainClassifier

    t0 = time.perf_counter()
    test, train = read_titanic().random_split(0.25, seed=0)
    imputer = CleanMissingData(input_cols=["age", "fare"],
                               cleaning_mode="Mean").fit(train)
    train, test = imputer.transform(train), imputer.transform(test)
    candidates = [TrainClassifier(label_col="survived", model=m, epochs=25,
                                  learning_rate=5e-2, device=device).fit(train)
                  for m in TITANIC_LEARNERS]
    best = FindBestModel(models=candidates,
                         evaluation_metric="AUC").fit(test)
    with tempfile.TemporaryDirectory() as d:
        best.best_model.save(d + "/model")
        model = PipelineStage.load(d + "/model")
    stats = ComputeModelStatistics().transform(model.transform(test))
    table = best.all_model_metrics
    return {
        "best": TITANIC_LEARNERS[candidates.index(best.best_model)],
        "accuracy": float(stats["accuracy"][0]),
        "AUC": float(stats["AUC"][0]),
        "candidates_auc": dict(zip(TITANIC_LEARNERS,
                                   (float(v) for v in table["AUC"]))),
        "rows": train.num_rows + test.num_rows, "s": time.perf_counter() - t0,
    }


def check_notebook_101() -> dict:
    """The flow on the card and on the CPU: the same best model, the
    card's accuracy above TITANIC_FLOOR."""
    card, cpu = notebook_101(DEVICE), notebook_101("cpu")
    if card["best"] != cpu["best"] or card["accuracy"] <= TITANIC_FLOOR:
        raise AssertionError(f"notebook 101: card {card}, cpu {cpu}")
    return {"card": card, "cpu": cpu, "floor": TITANIC_FLOOR}


def check_classical(smi: str) -> dict:
    """The classical one-liner path on the card (phase 12)."""
    from mmlspark_tpu_torch.stages import featurize as fz
    from mmlspark_tpu_torch.stages.train_classifier import TrainClassifier
    from mmlspark_tpu_torch.stages.train_regressor import TrainRegressor
    from mmlspark_tpu_torch.testing.datagen import make_census, make_flights

    t0 = time.perf_counter()
    census = make_census(CENSUS_ROWS, seed=CENSUS_SEED, full_schema=True)
    flights = make_flights(CENSUS_ROWS, seed=FLIGHTS_SEED)
    # Featurize alone, tree-style (as TrainClassifier configures it)
    cols = [c for c in census.columns if c != "income"]
    t1 = time.perf_counter()
    fz.Featurize(feature_columns={"features": cols},
                 number_of_features=fz.TREE_NN_NUM_FEATURES,
                 one_hot_encode_categoricals=False).fit(census) \
        .transform(census)
    featurize_s = time.perf_counter() - t1
    out = {"card": smi, "rows": CENSUS_ROWS,
           "census_featurize_s": featurize_s}
    out["census"] = classical_table(
        "income", CLASSIFIER_RUNS, census, TrainClassifier,
        ("accuracy", "AUC"))
    out["flights"] = classical_table(
        "arr_delay", REGRESSOR_RUNS, flights, TrainRegressor,
        ("R^2", "root_mean_squared_error"))
    out["census_gbt_profile"] = profile_fit(
        lambda: TrainClassifier(label_col="income", seed=0, device=DEVICE,
                                **CLASSIFIER_RUNS[0][1]), census)
    out["wide"] = check_wide()
    out["matrices"] = check_matrices()
    out["notebook_101"] = check_notebook_101()
    out["s"] = time.perf_counter() - t0
    return out


#: the context-parallel phase: the serve model's widths, CP_BATCH rows of
#: CP_SEQ seeded tokens, one training forward and backward each through
#: ``flash``, ``ulysses`` and ``ring`` (the last two over a one-rank NCCL
#: mesh on the card)
CP_BATCH, CP_SEQ = 4, 512
#: timed forward-and-backward calls of each; the median is reported
CP_REPS = 5
#: ring (plain streaming-softmax ops, f32 accumulation) against flash in
#: bf16: each parameter gradient within CP_GRAD_TOL of its largest
#: magnitude; the logits within BF16_LOGIT_TOL
CP_GRAD_TOL = 2e-2
#: ResNet-20 from entry(): a seeded batch of its example's shape
ENTRY_SEED = 13


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def lm_forward_backward(graph, variables, ids):
    """One training forward and backward of the LM on ``ids``: the logits
    and every parameter's gradient of the next-token loss."""
    import torch.nn.functional as F

    leaves = {n: {k: t.detach().clone().requires_grad_()
                  for k, t in block.items()}
              for n, block in variables.items()}
    logits, _ = graph.apply(leaves, ids, train=True)
    F.cross_entropy(logits[:, :-1].float().reshape(-1, logits.shape[-1]),
                    ids[:, 1:].reshape(-1)).backward()
    return logits.detach(), {f"{n}.{k}": t.grad
                             for n, block in leaves.items()
                             for k, t in block.items()}


def check_context_parallel() -> dict:
    """The transformer at the serve model's widths with ``attn_impl=
    "ulysses"`` and ``"ring"`` over ``make_mesh({"seq": 1})`` on the
    one-rank NCCL group ``main`` starts, each one training forward and
    backward a main path, against ``"flash"`` on the same variables and tokens. At one
    rank the all-to-all and the gathers are identities, so Ulysses must
    be bit-equal to flash (logits and every gradient) and must launch the
    forward and both backward kernels ``depth`` times each, through the
    tensor cores; the ring runs the plain streaming-softmax update, within
    BF16_LOGIT_TOL (logits) and CP_GRAD_TOL (gradients) of flash."""
    import torch
    import torch.distributed as dist

    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import make_mesh, mesh_shape

    mesh = make_mesh({"seq": 1})
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        raise AssertionError(
            f"context_parallel: the group is {dist.get_backend()} on "
            f"{mesh.device_type}, not NCCL on the card")
    depth = SERVE_MODEL["depth"]
    variables = init_variables(
        build_model("transformer_lm", **SERVE_MODEL), 0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    ids = torch.randint(0, SERVE_MODEL["vocab_size"], (CP_BATCH, CP_SEQ),
                        generator=gen, device=DEVICE)
    runs = {}
    for impl in ("flash", "ulysses", "ring"):
        graph = build_model(
            "transformer_lm", attn_impl=impl,
            mesh=None if impl == "flash" else mesh, **SERVE_MODEL)
        lm_forward_backward(graph, variables, ids)  # warm
        (logits, grads), wall_ms, counts = timed_path(
            lambda: lm_forward_backward(graph, variables, ids))
        walls = [wall_ms]
        for _ in range(CP_REPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_forward_backward(graph, variables, ids)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        runs[impl] = dict(logits=logits, grads=grads, counts=counts,
                          wall_ms=statistics.median(walls))
    flash, uly, ring = runs["flash"], runs["ulysses"], runs["ring"]
    for name in ATTN_COUNTERS + ATTN_MMA_COUNTERS:
        if uly["counts"][name] != depth:
            raise AssertionError(
                f"context_parallel: ulysses {name} = "
                f"{uly['counts'][name]}, want {depth} (one a layer)")
    diff = [k for k in flash["grads"]
            if not torch.equal(flash["grads"][k], uly["grads"][k])]
    if not torch.equal(flash["logits"], uly["logits"]) or diff:
        raise AssertionError(
            "context_parallel: ulysses at one rank is not bit-equal to "
            f"flash (logits equal: "
            f"{torch.equal(flash['logits'], uly['logits'])}, gradients "
            f"that differ: {diff})")
    logit_err = float((ring["logits"].float()
                       - flash["logits"].float()).abs().max())
    grad_err = max(rel_err(ring["grads"][k].float().cpu(),
                           flash["grads"][k].float().cpu())
                   for k in flash["grads"])
    if logit_err > BF16_LOGIT_TOL or grad_err > CP_GRAD_TOL:
        raise AssertionError(
            f"context_parallel: ring against flash: logits "
            f"{logit_err} (tolerance {BF16_LOGIT_TOL}), gradients "
            f"{grad_err} (tolerance {CP_GRAD_TOL})")
    return {
        "backend": dist.get_backend(), "world_size":
            dist.get_world_size(), "mesh": mesh_shape(mesh),
        "batch": CP_BATCH, "seq": CP_SEQ,
        "ulysses_bit_equal_to_flash": True,
        "ring_logits_max_abs_err": logit_err,
        "ring_grad_max_rel_err": grad_err,
        "wall_ms_median": {k: r["wall_ms"] for k, r in runs.items()},
        "launch_counts": {k: {n: r["counts"][n]
                              for n in ATTN_COUNTERS + ATTN_MMA_COUNTERS}
                          for k, r in runs.items()},
    }


# -- the trainer's mesh mode (ROADMAP.md Queue 1 items 13a-13d) -------------

#: the mesh phase's training runs: TRAIN_BATCH x max_len rows, 8 steps
MESH_STEPS, MESH_SEED = 8, 17
#: the one-rank mesh step when the rules' leaves were gathered whole for
#: an unsplit forward: 8.00 ms on an H100 80GB HBM3 at 700 W (PERF.md),
#: printed beside the split step's
GATHERED_MESH_STEP_MS = 8.00


def split_step_collectives(depth: int) -> int:
    """The split step's all-reduce calls on a ``{"data": 1, "model": 1}``
    mesh: the embedding's sum and each layer's ``attn_out`` and
    ``mlp_out`` sums, the loss's max and sums, the gradient sums of each
    layer's ``qkv`` and ``mlp_in`` inputs and of the head's, the norm's
    sum over model, and the row count's and the gradients' sums over
    data."""
    return (1 + 2 * depth) + 2 + (2 * depth + 1) + 1 + 2


def expert_step_collectives(depth: int) -> int:
    """The expert-local step's all-reduce calls on ``{"data": 1,
    "expert": 1}``: each block's combine sum and the gradient sums of
    its tokens and gate, and the two sums over data."""
    return 3 * depth + 2
#: the pipelined LM: the serve model's widths, 4 microbatches a batch
PIPE_MICROBATCHES = 4
#: the sequence-parallel tagger's rows (the dnn_stages phase's, seed 12)
#: and its training batch
SEQ_ROWS, SEQ_TRAIN_ROWS = 256, 64
#: the pipelined forward against its own stage loop on the card: the
#: largest logit difference over the largest logit (bf16 products of
#: other shapes: TOLERANCE["bfloat16"])
PIPE_SEQUENTIAL_TOL = 1e-2


def count_collectives():
    """Wrap the torch.distributed collectives and point-to-point ops the
    port calls with counters; returns (the counts dict, an undo)."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "broadcast", "batch_isend_irecv",
             "all_to_all_single")
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(dist, n) for n in names}

    def wrap(name):
        fn = saved[name]

        def counted(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return counted

    for n in names:
        setattr(dist, n, wrap(n))

    def undo():
        for n in names:
            setattr(dist, n, saved[n])

    return counts, undo


def mesh_train_run(label: str, graph, weights: dict, x, y, **cfg) -> dict:
    """``MESH_STEPS`` adam steps of ``graph`` through ``SPMDTrainer`` from
    ``weights``, a main path: the counts set to 0 just before and read
    just after, the Python-level collective calls counted (the eager
    first step and the capture each issue the step's collectives once;
    the replays issue them from the graph)."""
    import torch

    from mmlspark_tpu_torch.train import SPMDTrainer, TrainConfig

    trainer = SPMDTrainer(graph, TrainConfig(
        epochs=1, batch_size=TRAIN_BATCH, learning_rate=1e-3,
        optimizer="adam", log_every=1, shuffle=True, **cfg), device=DEVICE)
    collectives, undo = count_collectives()
    try:
        torch.cuda.synchronize()
        zero_counts()
        trained = trainer.train(x, y, init_variables=weights)
        counts = read_counts()
    finally:
        undo()
    stamps = [e["t"] for e in trainer.recorder.events()
              if e["name"] == "step"]
    out = {
        "losses": [h["loss"] for h in trainer.history],
        "launch_counts": counts, "collective_calls": collectives,
        "step_programs": trainer.telemetry.counter(
            "retrace.train.step").value,
        "step_capture_s": trainer.telemetry.gauge(
            "train.step_capture_s").value,
        "step_ms_median_steps_2_on": statistics.median(
            (b - a) * 1e3 for a, b in zip(stamps, stamps[1:])),
    }
    log(f"mesh_train {label}: {out}")
    return out, trained


def stage_loop_variables(weights: dict, depth: int) -> dict:
    """The pipelined LM's one-stage variables as a plain
    ``transformer_lm``'s (``stages["layer{i}.*"][0]`` -> ``block{i}``):
    its own stage loop, another code path over the same numbers."""
    out = {"embed": weights["embed"], "z": weights["z"]}
    for i in range(depth):
        pre = f"layer{i}."
        out[f"block{i}"] = {k[len(pre):]: v[0]
                            for k, v in weights["stages"].items()
                            if k.startswith(pre)}
    return out


def check_mesh_train() -> dict:
    """The trainer's mesh mode over the one-rank NCCL group ``main``
    starts, at the serve model's widths:

    (a) ``TRANSFORMER_TP_RULES`` on ``{"data": 1, "model": 1}`` with the
        flash LM through the split step (each rank's Megatron-split copy
        on its shards, the vocab-parallel loss) against the plain
        trainer, from the same weights on the same batches: loss curves
        and final parameters bit-equal (every collective is an identity
        at one rank, the split's leaves are the whole ones, and the
        vocab-parallel loss is ``log_softmax`` plus a rest that is
        exactly 0 at one rank, with a gradient of exact zeros), the step
        captured once with its split_step_collectives() all-reduces
        inside, the forward and both backward kernels launched depth x
        steps times each on the tensor cores;
    (b) ``transformer_lm_pipelined`` on ``{"data": 1, "pipe": 1}`` with
        4 microbatches under ``PIPELINE_STAGE_RULES``: its forward
        against its own stage loop on the card (PIPE_SEQUENTIAL_TOL) and
        the CPU's f32 forward (BF16_LOGIT_TOL), then 8 training steps;
    (c) the BiLSTM tagger at its default widths on ``{"data": 1, "seq":
        1}``: the sequence-parallel logits against the dense tagger's
        (TAGGER_LOGIT_TOL), and 4 ``bilstm_seq_parallel_train_step``
        calls lowering the loss;
    (d) ``python -m mmlspark_tpu_torch train --mesh data=1`` as a
        process;
    (e) ``EXPERT_RULES`` on ``{"data": 1, "expert": 1}`` with the flash
        MoE LM at ``MOE_MODEL``'s widths through the expert-local FFN
        against the plain trainer: bit-equal (the rank's experts are all
        of them, its dispatch slice the whole buffer, and the sum over
        expert an identity), captured once with its
        expert_step_collectives() all-reduces, the kernels launched
        depth x steps times each."""
    import torch
    import torch.distributed as dist

    from mmlspark_tpu_torch.models import build_model, init_variables
    from mmlspark_tpu_torch.parallel import (
        EXPERT_RULES,
        PIPELINE_STAGE_RULES,
        TRANSFORMER_TP_RULES,
        bilstm_seq_parallel_apply,
        bilstm_seq_parallel_train_step,
        make_mesh,
    )

    if dist.get_backend() != "nccl":
        raise AssertionError(f"mesh_train: the group is "
                             f"{dist.get_backend()}, not NCCL")
    depth = SERVE_MODEL["depth"]
    want = depth * MESH_STEPS
    x, y = progression_rows(MESH_STEPS * TRAIN_BATCH, MESH_SEED)
    out = {}

    # (a) the rules' mesh step against the plain step
    graph = build_model("transformer_lm", attn_impl="flash", **SERVE_MODEL)
    weights = init_variables(graph, MESH_SEED, device=DEVICE)
    plain, plain_vars = mesh_train_run("plain", graph, weights, x, y)
    meshed, mesh_vars = mesh_train_run(
        "tp rules", graph, weights, x, y,
        mesh_axes={"data": 1, "model": 1},
        param_rules=TRANSFORMER_TP_RULES)
    out["tp_rules_vs_plain"] = mesh_leg_vs_plain(
        "split step", plain, meshed, plain_vars, mesh_vars, want,
        split_step_collectives(depth), {"data": 1, "model": 1})
    del plain_vars, mesh_vars, weights
    gc.collect()

    # (b) the pipelined LM
    pmesh = make_mesh({"data": 1, "pipe": 1})
    pconfig = dict(SERVE_MODEL)
    pgraph = build_model("transformer_lm_pipelined", mesh=pmesh,
                         n_microbatches=PIPE_MICROBATCHES, **pconfig)
    pweights = init_variables(pgraph, MESH_SEED, device=DEVICE)
    ids = torch.from_numpy(x[:TRAIN_BATCH]).to(DEVICE)
    (logits, fwd_ms, _) = timed_path(lambda: pgraph.apply(pweights, ids))
    loop = build_model("transformer_lm", attn_impl="dense", **SERVE_MODEL)
    loop_vars = stage_loop_variables(pweights, depth)
    want_loop = loop.apply(loop_vars, ids)
    seq_err = rel_err(logits.float().cpu(), want_loop.float().cpu())
    cpu_logits = cpu_forward("transformer_lm", {"attn_impl": "dense",
                                                **SERVE_MODEL},
                             loop_vars, x[:TRAIN_BATCH])
    cpu_err = float(np.abs(logits.float().cpu().numpy()
                           - cpu_logits).max())
    if not seq_err <= PIPE_SEQUENTIAL_TOL or not cpu_err <= BF16_LOGIT_TOL:
        raise AssertionError(
            f"mesh_train: pipelined forward vs its stage loop {seq_err} "
            f"(tolerance {PIPE_SEQUENTIAL_TOL}), vs the CPU's f32 "
            f"{cpu_err} (tolerance {BF16_LOGIT_TOL})")
    pipe_run, _ = mesh_train_run(
        "pipelined", pgraph, pweights, x, y,
        mesh_axes={"data": 1, "pipe": 1},
        param_rules=PIPELINE_STAGE_RULES)
    losses = pipe_run["losses"]
    if len(losses) != MESH_STEPS or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"mesh_train: pipelined losses {losses}")
    out["pipelined"] = {
        "mesh": {"data": 1, "pipe": 1},
        "n_microbatches": PIPE_MICROBATCHES,
        "forward_vs_stage_loop_rel_err": seq_err,
        "forward_bit_equal_to_stage_loop": bool(torch.equal(
            logits, want_loop)),
        "forward_vs_cpu_f32_max_abs_err": cpu_err,
        "forward_ms": fwd_ms, "training": pipe_run}

    # (c) the sequence-parallel tagger
    smesh = make_mesh({"data": 1, "seq": 1})
    tagger = build_model("bilstm_tagger")
    tweights = init_variables(tagger, 12, device=DEVICE)
    rows = np.random.default_rng(12).integers(
        0, 10000, size=(TAGGER_ROWS, TAGGER_LEN)).astype(np.int32)
    trows = torch.from_numpy(rows[:SEQ_ROWS]).to(DEVICE)
    par = bilstm_seq_parallel_apply(tagger, tweights, trows, smesh)
    dense = tagger.apply(tweights, trows)
    tag_err = rel_err(par.float().cpu(), dense.float().cpu())
    tag_abs = float((par - dense).abs().max())
    if not tag_err <= TAGGER_LOGIT_TOL:
        raise AssertionError(f"mesh_train: sequence-parallel tagger vs "
                             f"dense {tag_err} (tolerance "
                             f"{TAGGER_LOGIT_TOL})")
    tids = rows[:SEQ_TRAIN_ROWS]
    tags = (tids % 8).astype(np.int32)
    v, tlosses = tweights, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        loss, v = bilstm_seq_parallel_train_step(tagger, v, tids, tags,
                                                 smesh, learning_rate=5e-2)
        tlosses.append(float(loss))
    step_ms = (time.perf_counter() - t0) * 1e3 / 4
    if not all(np.isfinite(tlosses)) or not tlosses[-1] < tlosses[0]:
        raise AssertionError(f"mesh_train: tagger losses {tlosses}")
    out["bilstm_seq_parallel"] = {
        "mesh": {"data": 1, "seq": 1}, "rows": SEQ_ROWS,
        "row_len": TAGGER_LEN, "logits_rel_err_vs_dense": tag_err,
        "logits_max_abs_err_vs_dense": tag_abs,
        "train_rows": SEQ_TRAIN_ROWS, "train_losses": tlosses,
        "train_step_ms": step_ms}

    # (d) the CLI's mesh training, a process with its own group
    cli, cli_s = run_cli(["-m", "mmlspark_tpu_torch", "train", "--mesh",
                          "data=1"])
    lines = [ln for ln in cli.stdout.splitlines() if ln.startswith("{")]
    metrics = json.loads(lines[-1]) if len(lines) == 1 else {}
    if not metrics.get("steps_total") or \
            not np.isfinite(metrics.get("final_loss") or np.nan):
        raise AssertionError(f"mesh_train cli: {len(lines)} JSON lines, "
                             f"{metrics}")
    out["cli_train_mesh"] = {k: metrics[k] for k in (
        "steps_total", "final_loss", "retrace.train.step",
        "train.step_ms_p50")} | {"process_s": cli_s}

    # (e) the expert-local FFN against the plain step
    mgraph = moe_graph(attn_impl="flash", **MOE_MODEL)
    mweights = init_variables(mgraph, MESH_SEED, device=DEVICE)
    plain, plain_vars = mesh_train_run("moe plain", mgraph, mweights, x, y)
    meshed, mesh_vars = mesh_train_run(
        "expert rules", mgraph, mweights, x, y,
        mesh_axes={"data": 1, "expert": 1}, param_rules=EXPERT_RULES)
    out["expert_local_vs_plain"] = mesh_leg_vs_plain(
        "expert-local step", plain, meshed, plain_vars, mesh_vars,
        MOE_MODEL["depth"] * MESH_STEPS,
        expert_step_collectives(MOE_MODEL["depth"]),
        {"data": 1, "expert": 1}, gathers=0)
    return out


def mesh_leg_vs_plain(label: str, plain: dict, meshed: dict,
                      plain_vars: dict, mesh_vars: dict, want: int,
                      per_step: int, mesh: dict, gathers: int = 1) -> dict:
    """Gate a mesh leg against the plain step on the same weights and
    batches: loss curves and final parameters bit-equal, one step
    program captured, ``per_step`` all-reduce calls a step (the eager
    first step and the capture each make them once; the replays run
    them from the graph) and ``gathers`` all-gathers (the end of the
    run's join of the split's leaves; none in the step), each attention
    kernel launched ``want`` times. Returns the leg's summary with the
    step ms beside the plain step's and the gathering mesh step's."""
    import torch

    differ = [f"{b}.{k}" for b in plain_vars for k in plain_vars[b]
              if not torch.equal(plain_vars[b][k], mesh_vars[b][k])]
    if meshed["losses"] != plain["losses"] or differ:
        raise AssertionError(
            f"mesh_train {label}: not bit-equal to the plain step: losses "
            f"{meshed['losses']} vs {plain['losses']}, parameters that "
            f"differ: {differ[:8]} ({len(differ)})")
    if meshed["step_programs"] != 1 or not meshed["step_capture_s"] > 0:
        raise AssertionError(
            f"mesh_train {label}: {meshed['step_programs']} step programs, "
            f"capture {meshed['step_capture_s']}")
    calls = meshed["collective_calls"]
    if calls["all_reduce"] != 2 * per_step or calls["all_gather"] != gathers:
        raise AssertionError(
            f"mesh_train {label}: collective calls {calls}, want "
            f"{2 * per_step} all-reduces (2 x {per_step}) and {gathers} "
            "all-gathers")
    for name in ATTN_COUNTERS + ATTN_MMA_COUNTERS:
        if meshed["launch_counts"][name] != want:
            raise AssertionError(
                f"mesh_train {label}: {name} = "
                f"{meshed['launch_counts'][name]}, want {want} (depth x "
                "steps)")
    step_ms = meshed["step_ms_median_steps_2_on"]
    plain_ms = plain["step_ms_median_steps_2_on"]
    log(f"mesh_train {label}: step {step_ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms, the gathering mesh step {GATHERED_MESH_STEP_MS} ms; "
        f"{per_step} NCCL calls a step")
    return {"mesh": mesh, "bit_equal": True, "step_ms": step_ms,
            "plain_step_ms": plain_ms,
            "gathered_mesh_step_ms": GATHERED_MESH_STEP_MS,
            "nccl_calls_per_step": per_step, "plain": plain,
            "mesh_step": meshed}


#: the engine's mesh mode on the card: the one-rank NCCL group ``main``
#: starts, as a (data, model) mesh
MESH_SERVE = {"data": 1, "model": 1}


def mesh_serve_run(label: str, graph, variables, prompts, counter: str,
                   plain: dict, **kw) -> dict:
    """One mesh engine's main path (``ServeEngine(..., mesh=MESH_SERVE)``,
    the counts set to 0 just before and read just after, the Python-level
    collective calls counted: the eager first call and the capture of
    each program issue its collectives, replays issue them from the
    graph), then a warm pass of the same schedule. Gates: every request
    completes; the kernel of ``counter`` launched ``depth`` times a
    micro-step; every stream bit-equal to ``plain``'s (the one-device
    engine's run of the same schedule in an earlier phase: at one rank
    every collective is an identity and the split is the whole); program
    counts within their pins and none new on the warm pass; something
    captured."""
    import torch

    from mmlspark_tpu_torch.testing import compile_guard

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine(graph, variables, mesh=MESH_SERVE, **kw)
    collectives, undo = count_collectives()
    try:
        run = drive(engine, prompts)
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() - base
    check_run(label, run, counter)
    differ = [rid for rid, res in plain["results"].items()
              if not np.array_equal(res.tokens, run["results"][rid].tokens)]
    if differ:
        raise AssertionError(f"{label}: streams of requests {differ} differ "
                             "from the one-device engine's")
    programs = program_summary(engine, peak)
    metrics = run["metrics"]
    fresh_metrics(engine)
    with compile_guard(lambda: engine.decode_compile_count, max_programs=0,
                       label=f"{label} warm decode"), \
            compile_guard(lambda: engine.prefill_compile_count,
                          max_programs=0, label=f"{label} warm prefill"):
        warm = drive(engine, prompts)
    check_run(f"{label} warm", warm, counter)
    over = [k for k, pin in (("decode_compile_count", "num_decode_blocks"),
                             ("prefill_compile_count", "num_prefill_buckets"),
                             ("resume_compile_count", "num_prefill_buckets"))
            if programs[k] > programs[pin]]
    if over or DEVICE == "cuda" and not (programs["capture_s"] > 0
                                         and programs["graph_pool_bytes"] > 0):
        raise AssertionError(f"{label}: programs {programs}")
    out = {
        "mesh_shape": metrics["mesh_shape"],
        "mesh_devices": metrics["mesh_devices"],
        "cache_pool_bytes_per_device":
            metrics["cache_pool_bytes_per_device"],
        "completed": metrics["completed"],
        "streams_bit_equal_plain": True,
        "launch_counts": run["counts"], "decode_micro_steps":
            run["micro_steps"], "collective_calls": collectives,
        "programs": programs,
        "warm_tokens_per_sec": warm["metrics"]["tokens_per_sec"],
        "plain_warm_tokens_per_sec":
            plain["programs"]["warm_tokens_per_sec"],
        "warm_per_token_ms": warm["metrics"]["per_token_ms"],
        "plain_warm_per_token_ms": plain["programs"]["warm_per_token_ms"],
        "first_pass_tokens_per_sec": metrics["tokens_per_sec"],
    }
    if "paging" in plain:
        out["paging"] = engine.pool.paging_stats()
        if out["paging"]["prefix_cache_hits_total"] < 1:
            raise AssertionError(f"{label}: no prefix-cache hit")
    log(f"{label}: {out}")
    del engine
    gc.collect()
    return out


def check_mesh_serve(graph, variables, dense: dict, header: dict,
                     smi: str) -> dict:
    """The engine's mesh mode over the one-rank NCCL group ``main``
    starts, at the full width of the serve model: the dense bf16 engine
    on the random schedule and the paged bf16 (prefix cache), dense int8
    and paged int8 (prefix cache) engines on the shared-header schedule,
    each bit-equal to its one-device twin of the engine phases
    (:func:`mesh_serve_run`); then ``python -m mmlspark_tpu_torch serve
    --mesh data=1,model=1`` as a process."""
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        raise AssertionError(f"mesh_serve: the group is "
                             f"{dist.get_backend()}, not NCCL")
    paged = dict(paged=True, page_size=PAGE_SIZE,
                 num_pages=paged_num_pages(), prefix_cache=True)
    runs = {"dense bf16": mesh_serve_run(
        "mesh dense bf16", graph, variables, random_schedule(), "launches",
        dense)}
    for label, kw, counter in (
        ("header paged bf16", paged, "paged_launches"),
        ("header dense int8", dict(kv_dtype="int8"), "q8_launches"),
        ("header paged int8", dict(paged, kv_dtype="int8"),
         "paged_q8_launches"),
    ):
        runs[label] = mesh_serve_run(f"mesh {label}", graph, variables,
                                     header_schedule(), counter,
                                     header[label], **kw)
    cli, cli_s = run_cli(["-c", CLI_SERVE.replace(
        '"--requests", "8"', '"--requests", "8", "--mesh", '
        '"data=1,model=1"')])
    lines = [ln for ln in cli.stdout.splitlines() if ln.startswith("{")]
    metrics = json.loads(lines[-1]) if len(lines) == 1 else {}
    counts = json.loads(cli.stderr.split("KERNEL_COUNTS ")[-1]
                        .splitlines()[0])
    if metrics.get("completed") != 8 or \
            metrics.get("mesh_shape") != MESH_SERVE or counts["launches"] < 1:
        raise AssertionError(f"mesh_serve cli: {len(lines)} JSON lines, "
                             f"{metrics}, decode launches {counts}")
    return {"mesh": MESH_SERVE, "device": smi, "engines": runs,
            "cli_serve_mesh": {k: metrics[k] for k in (
                "completed", "tokens_generated", "tokens_per_sec",
                "mesh_shape", "mesh_devices", "stream_digest")}
            | {"process_s": cli_s, "kernel_counts": counts}}


#: the CLI's serve demo as a subprocess: ``python -m mmlspark_tpu_torch``
#: run by runpy (what ``-m`` does) with an exit hook that reports the
#: decode kernels' launch counters on stderr
CLI_SERVE = r"""
import atexit, json, runpy, sys
def report():
    import mmlspark_tpu_torch.ops.flash_attention as fa
    print("KERNEL_COUNTS " + json.dumps({"launches": fa.launches,
          "paged_launches": fa.paged_launches}), file=sys.stderr)
atexit.register(report)
sys.argv = ["mmlspark_tpu_torch", "serve", "--requests", "8"]
runpy.run_module("mmlspark_tpu_torch", run_name="__main__", alter_sys=True)
"""


def run_cli(args: list, timeout: int = 600, codes: tuple = (0,)):
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=root, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode not in codes:
        raise AssertionError(f"cli: {args[:3]} exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    return out, time.perf_counter() - t0


def check_cli() -> dict:
    """``python -m mmlspark_tpu_torch serve --requests 8`` on the card:
    its one JSON line, every request completed, and the decode kernel
    launched in that process; ``python -m mmlspark_tpu_torch env`` names
    the card."""
    import torch

    out, serve_s = run_cli(["-c", CLI_SERVE])
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        raise AssertionError(f"cli serve: {len(lines)} JSON lines")
    metrics = json.loads(lines[0])
    counts = json.loads(out.stderr.split("KERNEL_COUNTS ")[-1]
                        .splitlines()[0])
    if metrics["completed"] != 8 or counts["launches"] < 1:
        raise AssertionError(f"cli serve: completed {metrics['completed']}"
                             f" of 8, decode launches {counts['launches']}")
    env_out, env_s = run_cli(["-m", "mmlspark_tpu_torch", "env"])
    info = json.loads(env_out.stdout)
    if info["platform"] != "gpu" or \
            info["device_kind"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"cli env: {info}")
    return {"serve": {k: metrics[k] for k in (
        "completed", "tokens_generated", "tokens_per_sec", "ttft_ms_p50",
        "per_token_ms")}, "serve_kernel_counts": counts,
        "serve_process_s": serve_s, "env": info, "env_process_s": env_s}


def check_entry() -> dict:
    """``entry()``'s ResNet-20 forward on the card at its example's shape
    (a seeded batch) against the port's f32 forward on the CPU, within
    STAGE_LOGIT_TOL of the largest logit."""
    import torch

    from mmlspark_tpu_torch.entry import entry

    forward, (variables, example_x) = entry()
    if example_x.device.type != "cuda" or tuple(example_x.shape) != \
            (128, 32, 32, 3):
        raise AssertionError(f"entry: example {tuple(example_x.shape)} on "
                             f"{example_x.device}")
    x = seeded_images(example_x.shape[0], 32, ENTRY_SEED)
    forward(variables, example_x)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = forward(variables, torch.from_numpy(x).to(DEVICE))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    want = cpu_forward("resnet20_cifar10", {}, variables, x)
    err = rel_err(got.float().cpu().numpy(), want)
    if not np.isfinite(got.float().cpu().numpy()).all() or \
            err > STAGE_LOGIT_TOL:
        raise AssertionError(f"entry: card vs CPU {err} (tolerance "
                             f"{STAGE_LOGIT_TOL})")
    return {"batch": int(x.shape[0]), "logits_rel_err_vs_cpu_f32": err,
            "forward_ms": wall_ms, "logits_shape": list(got.shape)}


#: the launcher's evidence tools as subprocesses: ``python -m
#: mmlspark_tpu_torch evidence ...`` run by runpy, with an exit hook that
#: reports every attention kernel's launch counter on stderr
EVIDENCE_RUN = r"""
import atexit, json, runpy, sys
def report():
    import mmlspark_tpu_torch.ops.flash_attention as fa
    print("KERNEL_COUNTS " + json.dumps({c: getattr(fa, c)
          for c in fa.COUNTERS}), file=sys.stderr)
atexit.register(report)
sys.argv = ["mmlspark_tpu_torch", *sys.argv[1:]]
runpy.run_module("mmlspark_tpu_torch", run_name="__main__", alter_sys=True)
"""
#: the launch counters each tool's process must have advanced
EVIDENCE_COUNTERS = {"flash": ATTN_COUNTERS + ATTN_MMA_COUNTERS,
                     "decode": ("launches",), "profile": (), "feed": ()}


def evidence_record(which: str, proc, out: str) -> dict:
    """A tool's record: the file it wrote, or (a refused record) the JSON
    line it printed on stderr."""
    if proc.returncode == 0:
        with open(out, encoding="utf-8") as f:
            return json.load(f)
    lines = [ln for ln in proc.stderr.splitlines()
             if ln.startswith('{"tool"')]
    if not lines:
        raise AssertionError(f"evidence {which}: exit {proc.returncode} "
                             f"without a record:\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def decode_near_ties_only(record: dict, problems: list) -> bool:
    """Does the decode record fail its contract only on the agreement
    floor, with every diverging row first differing at a near tie? The
    tool keeps its gate and writes no record then; the phase holds the
    streams to the near-tie rule every stream comparison of this script
    uses, and the run reports the agreement."""
    num = record["numerics"]
    return len(problems) == 1 and problems[0].startswith(
        "greedy token agreement") and num["divergences"] and all(
        d["near_tie"] for d in num["divergences"])


def check_evidence() -> dict:
    """``python -m mmlspark_tpu_torch evidence flash|decode|profile|feed``
    and ``docgen`` as subprocesses on the card, each at the tool's own
    sizes: every tool exits 0 with a record its ``check_record`` accepts
    (the decode tool may instead refuse its record for agreement alone,
    every divergence a near tie), the flash process launched the forward
    and both backward kernels (the tensor-core route), the decode
    process the decode kernel, and docgen wrote every page."""
    import importlib
    import tempfile

    import torch

    from mmlspark_tpu_torch.__main__ import EVIDENCE_TOOLS

    torch.cuda.empty_cache()
    out = {"process_s": {}, "kernel_counts": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for which, counters in EVIDENCE_COUNTERS.items():
            path = os.path.join(tmp, which, "record.json")
            args = ["-c", EVIDENCE_RUN, "evidence", which, "--out",
                    os.path.dirname(path) if which == "profile" else path]
            proc, secs = run_cli(args, codes=(0, 3) if which == "decode"
                                 else (0,))
            if which == "profile":
                path = os.path.join(tmp, which, "summary.json")
            record = evidence_record(which, proc, path)
            tool = importlib.import_module(
                f"mmlspark_tpu_torch.tools.{EVIDENCE_TOOLS[which]}")
            problems = tool.check_record(record)
            if problems and not (which == "decode" and
                                 decode_near_ties_only(record, problems)):
                raise AssertionError(f"evidence {which}: {problems}")
            counts = json.loads(proc.stderr.split("KERNEL_COUNTS ")[-1]
                                .splitlines()[0])
            missing = [c for c in counters if not counts[c] > 0]
            if missing:
                raise AssertionError(f"evidence {which}: no launches of "
                                     f"{missing}: {counts}")
            record["contract_problems"] = problems
            out[which], out["process_s"][which] = record, secs
            out["kernel_counts"][which] = counts
            log(f"evidence {which}: {secs:.1f}s, contract problems "
                f"{problems}, launches {counts}")
        api = os.path.join(tmp, "docs", "api")
        _, secs = run_cli(["-m", "mmlspark_tpu_torch", "docgen", api])
        pages = sorted(os.listdir(api))
        html = sorted(os.listdir(os.path.join(tmp, "docs", "html")))
        if len(pages) < 18 or len(html) != len(pages) or \
                "index.rst" not in pages:
            raise AssertionError(f"docgen: {pages} / {html}")
        out["docgen"] = {"rst_pages": len(pages), "html_pages": len(html)}
        out["process_s"]["docgen"] = secs
    return out


#: the launch counters an example's process must have advanced: e307's
#: overfit LMs train through the attention kernels and decode through
#: the dense decode kernel, all at head dim 16
EXAMPLE_COUNTERS = {"e307": ("fwd_launches", "bwd_kv_launches",
                             "bwd_q_launches", "launches")}
#: the sample workflows the harness must find, and how many of their
#: processes run at once (the card and the host's 8 cores have room)
N_EXAMPLES, EXAMPLE_WORKERS = 12, 4


def check_examples(smi: str) -> dict:
    """The port's sample workflows on the card through its harness, one
    process each (``python -m mmlspark_tpu_torch run <script>``),
    EXAMPLE_WORKERS at a time: every example passes, its OK line has the
    keys its source prints, and the counters of EXAMPLE_COUNTERS advanced
    in their processes."""
    import importlib.util
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mmlspark_tpu_torch.examples import harness

    torch.cuda.empty_cache()
    paths = harness.discover([], use_shard=False)
    if len(paths) != N_EXAMPLES:
        raise AssertionError(f"examples: {len(paths)} found, not "
                             f"{N_EXAMPLES}")
    with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
        done = list(pool.map(harness.run_example, paths))
    runs, failed = {}, []
    for path, run in zip(paths, done):
        name = os.path.basename(path)[:4]
        want, _ = harness.ok_fields(path)
        missing = [c for c in EXAMPLE_COUNTERS.get(name, ())
                   if not run.launches.get(c, 0) > 0]
        passed = run.ok and list(run.result) == list(want) and not missing
        runs[name] = {"status": "PASS" if passed else "FAIL",
                      "seconds": run.seconds, "ok": run.result,
                      "launches": run.launches}
        log(f"examples {name}: {runs[name]['status']} {run.seconds:.1f}s "
            f"{run.detail}")
        if not passed:
            runs[name]["missing_launches"] = missing
            failed.append(name)
            log(f"examples {name} output:\n{run.output[-3000:]}")
    if failed:
        raise AssertionError(f"examples failed: {failed}")
    total = {c: sum(r["launches"].get(c, 0) for r in runs.values())
             for c in COUNTERS + ("fused_optim_launches",)}
    # the optional host libraries the examples' stages would reach for
    # (the port reads CSV without pandas and the digits without sklearn)
    host = {m: importlib.util.find_spec(m) is not None
            for m in ("pandas", "sklearn", "PIL")}
    return {"device": smi, "passed": f"{len(runs)}/{len(paths)}",
            "workers": EXAMPLE_WORKERS, "runs": runs, "launches": total,
            "process_seconds": sum(r["seconds"] for r in runs.values()),
            "host_modules": host}


ENGINE_KEYS = (
    "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99", "per_token_ms",
    "per_token_ms_p50", "tick_ms_p50", "completed", "tokens_generated",
    "wall_s", "decode_blocks", "slot_utilization_mean",
    "cache_pool_bytes_per_device", "kv_dtype",
)


def engine_summary(run: dict) -> dict:
    out = {k: run["metrics"][k] for k in ENGINE_KEYS}
    out.update(decode_micro_steps=run["micro_steps"],
               launch_counts=run["counts"])
    for key in ("paging", "hits", "flip_rate_vs_dense_bf16", "diverged",
                "weight_bytes", "weight_bytes_f32", "peak_memory_bytes",
                "programs"):
        if key in run:
            out[key] = run[key]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke run needs a "
            "CUDA GPU")
        return 2
    import mmlspark_tpu_torch  # noqa: F401  (fails outside the repo)
    from mmlspark_tpu_torch.models import build_model, init_variables

    # full float32 for f32 products and convolutions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = device_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    build_kernels()
    errors = check_kernels()
    attn_errors = check_attention_kernels()
    optim_equal = check_fused_optimizer()

    graph = build_model("transformer_lm", **SERVE_MODEL)
    variables = init_variables(graph, 0, device=DEVICE)
    t0 = time.perf_counter()
    dense = check_engine(graph, variables)
    header = check_header_engines(graph, variables)
    log(f"engine phases took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    chunked, clean = check_chunked_async(graph, variables, header)
    resilience = check_resilience(graph, variables, clean)
    del clean
    log(f"chunked/async and resilience phases took "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    generation = check_generate(graph, variables)
    quantized, dequantize = check_quantized_engines(graph, variables, dense)
    trained_int8 = check_trained_int8()
    log(f"generation, weight-int8 and trained int8 phases took "
        f"{time.perf_counter() - t0:.1f}s")
    model_err = check_model_vs_cpu()
    format_errs = check_cache_formats_vs_cpu()
    t0 = time.perf_counter()
    training, trained = run_training("full width", TRAIN_MODEL, TRAIN_STEPS,
                                     seed=5)
    small_training, _ = run_training("depth 2, GQA, window, RoPE",
                                     SMALL_TRAIN_MODEL, SMALL_TRAIN_STEPS,
                                     seed=6)
    step_vs_cpu = check_train_step_vs_cpu()
    log(f"training phases took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_resilience, fold_launches = check_train_resilience()
    log(f"train_resilience phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dnn_stages = check_dnn_stages()
    log(f"dnn_stages phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    moe = check_moe()
    log(f"moe phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    image = check_image()
    log(f"image phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fleet = check_fleet(graph, variables, dense, header)
    log(f"fleet phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    multimodel = check_multimodel(
        graph, variables, dense, smi,
        dnn_stages["resnet50"]["logits"]["model_only_images_per_sec"])
    log(f"multimodel phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    classical = check_classical(smi)
    log(f"classical phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    from mmlspark_tpu_torch.parallel import initialize_distributed
    import torch.distributed as dist

    # one NCCL rank on the card for the parallel phases
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        context_parallel = check_context_parallel()
        t1 = time.perf_counter()
        mesh_train = check_mesh_train()
        log(f"mesh_train phase took {time.perf_counter() - t1:.1f}s")
        t1 = time.perf_counter()
        mesh_serve = check_mesh_serve(graph, variables, dense, header, smi)
        log(f"mesh_serve phase took {time.perf_counter() - t1:.1f}s")
    finally:
        dist.destroy_process_group()
    cli = check_cli()
    entry_run = check_entry()
    log(f"context_parallel, mesh_train, mesh_serve, cli and entry phases "
        f"took "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    evidence = check_evidence()
    log(f"evidence phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    examples = check_examples(smi)
    examples["phase_s"] = time.perf_counter() - t0
    log(f"examples phase took {examples['phase_s']:.1f}s")

    # each kernel's launches on the main paths: the first slices' runs
    # plus the MoE engines' (decode), the MoE training run's (attention),
    # the fleet phase's (decode), the multi-model phase's (decode: the
    # facade's lm deployment and the model-routed replica set) and the
    # mesh engines' (decode)
    moe_counts = {label: moe[label]["launch_counts"]
                  for label in ("moe dense bf16", "moe paged bf16")}
    fleet_counts = fleet_launches(fleet)
    mesh_counts = {label: run["launch_counts"]
                   for label, run in mesh_serve["engines"].items()}
    # (and the sample workflows' processes: decode, attention, optimizer)
    ex_counts = examples["launches"]
    launches = {
        "launches": dense["counts"]["launches"]
        + moe_counts["moe dense bf16"]["launches"]
        + fleet_counts["launches"]
        + multimodel["launch_counts"]["launches"]
        + multimodel["replicas"]["launch_counts"]["launches"]
        + mesh_counts["dense bf16"]["launches"]
        + ex_counts["launches"],
        "q8_launches": header["header dense int8"]["counts"]["q8_launches"]
        + fleet_counts["q8_launches"]
        + mesh_counts["header dense int8"]["q8_launches"]
        + ex_counts["q8_launches"],
        "paged_launches":
            header["header paged bf16"]["counts"]["paged_launches"]
            + moe_counts["moe paged bf16"]["paged_launches"]
            + fleet_counts["paged_launches"]
            + mesh_counts["header paged bf16"]["paged_launches"]
            + ex_counts["paged_launches"],
        "paged_q8_launches":
            header["header paged int8"]["counts"]["paged_q8_launches"]
            + fleet_counts["paged_q8_launches"]
            + mesh_counts["header paged int8"]["paged_q8_launches"]
            + ex_counts["paged_q8_launches"],
    }
    # the attention kernels' launches: the training runs', the MoE
    # training run's, the Ulysses run's of the context-parallel phase and
    # the mesh phase's split and expert-local steps
    moe_train = moe["training"]["launch_counts"]
    ulysses = context_parallel["launch_counts"]["ulysses"]
    mesh_step = mesh_train["tp_rules_vs_plain"]["mesh_step"]["launch_counts"]
    expert_step = mesh_train["expert_local_vs_plain"]["mesh_step"][
        "launch_counts"]
    attn_rows, attn_backward = measure_attention_kernels(
        attn_errors, {k: v + moe_train[k] + ulysses.get(k, 0)
                      + mesh_step[k] + expert_step[k] + ex_counts.get(k, 0)
                      for k, v in training["launch_counts"].items()})
    rows = measure_kernels(errors, launches) + attn_rows + [
        measure_fused_optimizer(
            optim_equal, training["launch_counts"]["fused_optim_launches"]
            + mesh_step["fused_optim_launches"]
            + expert_step["fused_optim_launches"]
            + ex_counts["fused_optim_launches"]),
        measure_tree_checksum(train_resilience["fold_bit_equal"],
                              fold_launches)]
    print(json.dumps({"kernel_errors": errors,
                      "attention_kernel_errors": attn_errors,
                      "fused_optimizer_bit_equal": optim_equal,
                      "model_f32_card_vs_cpu_max_abs_err": model_err,
                      "model_f32_cache_formats_card_vs_cpu": format_errs,
                      "train_step_f32_card_vs_cpu": step_vs_cpu}))
    print(json.dumps({"engine": engine_summary(dense),
                      "model": SERVE_MODEL, "slots": SLOTS,
                      "cache_len": CACHE_LEN,
                      "decode_block": DECODE_BLOCK}))
    print(json.dumps({"header_engines": {
        label: engine_summary(run) for label, run in header.items()},
        "page_size": PAGE_SIZE, "num_pages": paged_num_pages(),
        "header_len": HEADER_LEN}))
    print(json.dumps({"generate": generation}))
    print(json.dumps({"quantized_weights": {
        label: engine_summary(run) for label, run in quantized.items()},
        "dequantize_per_call": dequantize}))
    print(json.dumps({"trained_int8": trained_int8}))
    print(json.dumps({"programs": {
        label: run["programs"] for label, run in (
            ("dense bf16", dense), *header.items(), *quantized.items())}}))
    print(json.dumps({"training": training,
                      "small_training": small_training}))
    print(json.dumps({"profile": profile_decode_block(graph, variables)}))
    print(json.dumps({"train_profile": profile_train_step(trained)}))
    print(json.dumps({"attention_backward": attn_backward}))
    print(json.dumps({"chunked_async": chunked}))
    print(json.dumps({"resilience": resilience}))
    print(json.dumps({"train_resilience": train_resilience}, default=str))
    print(json.dumps({"dnn_stages": dnn_stages}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"image": image}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"multimodel": multimodel}))
    print(json.dumps({"classical": classical}))
    print(json.dumps({"context_parallel": context_parallel}))
    print(json.dumps({"mesh_train": mesh_train}))
    print(json.dumps({"mesh_serve": mesh_serve}))
    print(json.dumps({"cli": cli, "entry": entry_run}))
    print(json.dumps({"evidence": evidence}))
    print(json.dumps({"examples": examples}))
    log(f"smoke run took {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
