#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # paper Table 6 at 10000 jobs, S = 2
    python3 chip_smoke.py --jobs N   # a shorter stream (the cut is printed)

Phases, each failing the run with a non-zero exit:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the device;
2. the scheduler's main path — ``repro_torch.experiments.table6.run`` (TOLA
   on the proposed grid and on the Even benchmark, r in {0, 1200}, plus the
   learner comparison over 21 instances: hedge and exp3 each with the
   paper's schedule and 8 constant etas, ucb1, egreedy and ftl) under
   torch.profiler and the port's launch capture (``repro_torch.obs``), with
   every kernel's launch counter set to 0 just before and read just after;
   each kernel must have launched (``learner_replay`` once per r) and the
   capture must count every launch the counters count; each kernel's
   CUDA-event time comes from the capture, the device's busy share and its
   largest device entries from the profiler (a lower bound where the
   profiler kept fewer launches than the capture counted), and the plan
   backend ``"auto"`` resolves to (``device``: the
   plan tensors are built on the card) with the device plan build's
   seconds, which must be positive;
3. each of those kernels against its plain PyTorch version on the card, on
   the inputs of its last main-path launch: max abs error, kernel and plain
   times (CUDA events, median of 5 after a warm-up), device time and the
   bound. The chain: every main-path launch must take the shared-memory
   route (their routes and shares of tasks with work are printed); both
   routes are held bit for bit to the plain version and timed (per call,
   device, the kernel alone), and so is a synthetic horizon on each side of
   the route's slot limit (58111 slots: shared memory, 70000: global). The
   task kernel is held bit for bit too, timed the same three ways, its
   call checked to launch that one kernel and no other device operation,
   and held bit for bit again at synthetic horizons of 1, 2 and 3 slots,
   its search tree's node count and one slot either side, 58111, 70000
   and 300000 slots, each with shared and per-scenario plans (its one
   route takes them all). Hedge: the final log-weights and
   sampled trajectory rows equal to the plain version's, each pass's device
   time (a warning when their sum leaves the device time by over 5 %), the
   trajectory pass of one instance alone, the ring's shared memory (as the
   ``.cu`` lays it out) against the card's limit, and the step's
   dependency chain read from the SASS (``cuobjdump``) at latencies a
   probe kernel measures, times J at the card's maximum SM clock: the
   dependency floor. The learner kernel (exp3, ucb1, egreedy, ftl): every
   instance's trace and final state bit for bit against the plain version
   (which follows the kernel's order of operations) on both main-path
   launches and on three short streams at the handoff's edges (d = 0,
   every sample first, P 1024); its time per launch and per kind (one
   instance alone) and its update step's dependency floor from the SASS;
   then all 21
   comparison instances of both scenarios against the float64 host loop
   ``_replay_numpy_one``, each instance's first divergence printed with
   its float64 margin and ``learner_replay.margin_bound`` (and, for the
   argmin kinds, the gap between the two lowest scores and ``gap_bound``),
   failing where a trace leaves the loop at a draw above the bound, or
   where the bound is 1 or more; a planted fault (chosen + 1 at the first
   draw of an exp3 instance) must fail both checks. The ptxas registers
   and spills of the cost, Hedge and learner kernels, and the task
   kernel's search tree (levels, shared memory per block) and blocks per
   SM, are printed in phase 1;
4. correctness on a small input: the cost tensor against the float64 host
   simulator and all five learner kinds (two Hedge schedules) against the
   float64 host loop: identical traces, weights and probabilities within
   1e-5 (exp3 within 1e-4: the reference's own float32 scan misses 1e-5
   there), and the learner kernel bit for bit with its plain version on
   the CPU;
5. the LM substrate's serving path at full width —
   ``repro_torch.launch.serve.serve_requests`` on tinyllama-1.1b (22
   layers, the flash attention kernel in every prefill: 44 launches),
   mamba2-2.7b (64 layers, the SSD scan kernel: 128 launches), llama3-8b
   (64 flash launches), granite-3-8b (80), qwen2.5-32b at full width with
   its depth cut to ``QWEN_LAYERS`` (the cut printed; 2 per layer),
   hymba-1.5b (window 1024 and 128 meta tokens as the flash kernel's
   prefix: 64 flash launches, and 64 SSD scans) and seamless-m4t-medium
   (the reference's zero-frame audio stub; 12 encoder, 12 causal and 12
   cross flash launches per prefill: 72), deepseek-moe-16b (28 layers of
   64 routed experts top-6 and 2 shared: 56 flash launches), olmoe-1b-7b
   (16 layers, 64 experts top-8: 32) and phi-3-vision-4.2b (the
   reference's zero-patch vision stub, 576 patches before the 1024 tokens,
   dh 96: 64), each from the port's own init
   from a fixed seed (one copy of the weights on the card: the serves take
   the model's tensors), 8 requests of 1024 tokens in batches of 4, 16 new
   tokens each; counters set to 0 just before each and read just after,
   every bfloat16 flash launch on the tensor-core route; wall time,
   tokens/s, the first completion and the peak memory (reset before each
   model; each must stay within ``SERVE_MEM_SHARE`` of the card); then,
   for seamless, one prefill on seeded frames, for phi-3-vision one on
   seeded patches; then the first group once more under torch.profiler for
   the device's busy share and the share of the kernels' device entries;
6. the two kernels against their plain versions on the inputs of their
   last launch in each serve, for each mask and length (seamless's
   encoder, causal and cross launches from its seeded-frames prefill;
   phi-3-vision's from its serve and from its seeded-patches prefill):
   error, kernel, plain and library times (SDPA wherever it computes the
   same mask: causal, non-causal, or hymba's window and prefix as an
   explicit boolean mask), bound; for flash attention also the CUDA-core
   kernel's time on the same inputs; for the SSD scan its device time,
   each of its four passes' device time (a warning when their sum leaves
   the device time by over 5 %), its shared memory per block and its
   bounds: the row's, f32-accurate products on the tensor cores at the
   least cost for their operands (three bf16 products where x is bfloat16,
   three TF32 elsewhere), the kernel's own scheme, three TF32 products
   each, and f32 on the CUDA cores), and at the six flash and four SSD
   shapes of the reference's kernel tests in float32 (flash: the CUDA-core
   kernel) and bfloat16 (flash: the tensor-core kernel), plus flash at
   dh 96 (ragged, windowed, non-causal) and SSD cases at mamba2's widths
   with 32 chunks and at five shapes off the serve path (odd P and N, 128
   columns, a 4096-row chunk, 70000 heads); then layer 0's ``moe_ffn`` of
   both MoE smoke configs on the card against the CPU, on activations
   where capacity drops entries: the kept entries first, then the output;
7. the smoke configs of every served architecture on the card (kernels)
   against the same weights on the CPU (plain versions): prefill and
   decode logits (seamless on seeded frames, phi-3-vision on seeded
   patches, decoding after them), and the greedy tokens of a float32
   serve.
8. paper Tables 2-5 — ``repro_torch.experiments.exp1_spot_ondemand``,
   ``exp2_self_owned`` and ``exp3_policy12`` at 1500 jobs (the reference
   benchmarks' default stream; the cut from the paper's ~10000 is
   printed), seed 0, S = 1, job types 1-4, r in {300, 600, 900, 1200} —
   under torch.profiler and the launch capture, the launch counters set to
   0 just before and read just after: the tables, each driver's wall, the
   engine's phase seconds summed over the 76 sweeps, the Greedy seconds,
   the device's busy share (profiler) and the cost kernels' launches and
   CUDA-event time (capture). It fails unless both cost kernels launched,
   the capture counted each launch, every alpha and
   benchmark alpha is finite and in (0, p_od], every sweep's best-policy
   alpha lies within 1e-5 of the host's float64 ``run_jobs`` for that
   policy and mode, and the phase's last chain and task launches are
   bit-equal to their plain versions; it prints the knife-edge count, the
   (job, policy) unit costs of exp1's proposed sweeps (r = 0) that leave
   the host's ``run_jobs`` by more than 1e-5, and the largest gap;
9. the fleet orchestrator — ``repro_torch.sched.FleetOrchestrator`` on 30
   training DAG jobs with 4 reserved pods (``schedule`` with and without
   learning) and ``stage_plan``, on the card (device plans) against
   ``device="cpu"`` with ``plan_backend="device"`` (the same float32
   plans): every ``ScheduleReport`` field within 1e-5, the same best
   policy, the stage plan bit for bit, and the chain kernel launched;
10. device plans — (a) Table 6's round-0 grids (proposed at r = 0 and
   r = 1200, Even at r = 1200; 10000 jobs, S = 2) with host plans and with
   device plans on the card, each side under torch.profiler: every
   policy's fixed alpha within 1e-5 of the other side's (on the proposed
   r = 1200 grid once the host's float64 plan carries the device plan's
   policy-(12) counts, whose ceil epsilons differ, ROADMAP queue C; the
   raw gap and the number of counts set apart are printed), the count of
   (scenario, job, policy) unit costs more than 1e-5 apart and the largest
   gap, each side's plan, pool, views and eval seconds, device busy time,
   pageable host-to-device copies and idle share, from an emptied
   cross-call plan cache (both sides build); (b) the device plan of the
   proposed r = 1200 grid, query-free and with one availability query per
   scenario, built with the cache off on the card and on the CPU: starts,
   ends, z_t, d_eff and pins equal by ``torch.equal``, the self-owned sums
   equal; (c) ``table6.run`` on the regime and the adversarial families
   (500 jobs, cut from the Table 6 stream for the time limit and the cut
   printed; S = 2, r in {0, 1200}, hedge), the launch counters set to
   0 before each and read after: both cost kernels launched, every alpha
   finite and in (0, p_od]; the groups its calls took from the plan cache
   are summed;
11. streamed scenarios on Table 6's stream (10000 jobs, job type 2, market
   seed 1000; the proposed grids at r = 1200 and r = 0) — (a)
   ``ScenarioSpec`` synthesis on the card (fresh, regime and adversarial
   at S = 64, two adaptive chunks with explicit periods and offsets):
   levels and spike masks bit for bit with the host's, availability at
   every bid of both grids and at 1.0 equal to the float64 views', A bit
   for bit with the same function on the CPU, C within 1e-4 of the host
   views at the grids' bids; C's gap printed beside the gap a float32
   running sum leaves; (b) ``evaluate_grid`` at r = 1200 on a fresh spec
   with S = 16: ``scenario_chunk=8`` (double-buffered, and not) bit for
   bit with one pass, the chain kernel once per chunk, fixed alphas within
   1e-5 of ``spec.materialize()`` through the list path (unit costs more
   than 1e-5 apart counted, not bounded), ``reduce="mean"`` within rtol
   1e-12 of the stacked mean; (c) ``replay_stream`` of exp4's 21
   instances over a fresh spec with S = 16 in chunks of 8 at r = 1200 and
   r = 0, the launch counters set to 0 before each: the chain, Hedge and
   learner kernels once per chunk; its summary against
   ``replay`` over the monolithic tensor at the reference's bars; (d) the
   adaptive adversary (S = 32, chunks of 8, r = 1200) ends ``"locked"``,
   its issued chunks rebuilt give the host's availability on the card, its
   Hedge regret printed beside the fixed adversarial family's; (e)
   ``table6.run`` on the adaptive family (500 jobs, S = 16, chunk 8, r =
   0) prints finite streamed rows;
12. the cross-call caches and delta evaluation on Table 6's stream (the
   proposed r = 1200 round-0 grid, 175 policies in 65 groups; the fresh
   spec of phase 11 (b), S = 16 in chunks of 8), from emptied caches: (a)
   with plans on the card, a cold, a warm and a cache-off run bit for bit
   (unit, spot and on-demand costs, self-owned work), the warm run serving
   all 65 groups from the plan cache, one view-cache hit per (chunk, bid)
   and no device plan pass, each run launching the chain kernel as often
   as the cold one; (b) the same with host plans; (c) every tenth policy
   re-bid: ``evaluate_grid_delta`` against (a)'s warm result bit for bit
   with the full re-evaluation, at most 18 of the groups re-scored; a delta
   with no change re-scores nothing, launches nothing and equals its
   input; a chained delta (every sixth policy re-bid once more) bit for
   bit with a cache-off full re-evaluation; (d) at the end, the caches'
   counts, the card's peak allocated memory and the process's peak RSS,
   and the plan-cache groups summed over phase 8's sweeps and phase 10's
   Table 6 runs;
13. observability (``repro_torch.obs``) — (a) phase 12's grid and spec
   through ``evaluate_grid`` untraced and under
   ``observe(programs=True)``: the results bit for bit, every timings entry
   (and each chunk's) equal to its spans' seconds folded left to right,
   each kernel's captured launches equal to the launch counter; each
   kernel's captured CUDA-event time per launch printed beside the same
   launch timed again and phase 3's median; the Chrome trace written to
   ``build/archive/phase13_trace.json``; (b) ``replay_stream`` on the
   adaptive family (S = 16, chunks of 8, hedge) under ``observe()``: the
   escalation counters equal to the stream's own stage history, the plan
   and view cache counters equal to the caches' own count deltas, one
   weight-entropy observation per chunk; a re-bid delta's
   ``engine.delta_groups_rescored`` equal to its timings; (c)
   tinyllama-1.1b's serve (phase 5's two groups of four requests) captured:
   44 tensor-core flash launches and one ``serve.requests`` span; (d) the
   overhead measured directly: spans of (a) times one span's cost under 2 %
   of (a)'s untraced wall with tracing off, and with tracing and capture
   on (plus each captured launch times one captured launch's cost) under
   10 %; (e) no ``nvcc`` build over the phase (``CompileWatch``);
14. the scenario x policy-group mesh (``repro_torch.engine.mesh``) — (a) a
   1x1 mesh over NCCL, on a process group of one rank (a ``FileStore``
   under ``build/archive/phase14/``) set up and torn down here: phase 12's
   grid and spec (S = 16 in chunks of 8) through ``evaluate_grid(mesh=)``
   bit for bit with the unsharded call, early-start (one chain launch per
   chunk) and Even planned-start (one task launch per bid per chunk);
   ``run_tola_scenarios(mesh=)`` on phase 2's r = 1200 proposed inputs (S =
   2, with its refinement round): cost matrices and chosen traces bit for
   bit with phase 2's; ``replay_stream(mesh=)`` with hedge and exp3 within
   1e-4 of the unmeshed host fold on every statistic; the adaptive
   stream's round trip under the mesh (S = 16, chunks of 8, hedge) within
   1e-4 of the unmeshed one; ``collective_counts``: no collective in an
   eval program, one all-gather per evaluated chunk, one all-reduce per
   folded chunk; eval and splice seconds and the card's peak memory;
   (b) a 2x2 mesh of four gloo ranks sharing the card (NCCL refuses two
   ranks on one device), started by ``torch.multiprocessing`` (spawn) with
   a join timeout, each loading the libraries phase 1 built and building
   none: at S = 13 (scenario padding) on the r = 1200 grid (13 groups per
   bid: group padding), every rank's (S, J, P) tensors bit for bit the
   unsharded card tensors (SHA-256 per scenario and field), the fold
   (hedge, exp3, chunks of 8) within 1e-4 of the unmeshed host fold, each
   rank's collective counts and kernel launches (one chain launch per rank
   per chunk), eval and splice seconds and peak memory printed. A rank on
   the CPU, a rank that fails or hangs, or a gloo process group where NCCL
   was asked for fails the run;
15. the static contract checker (``repro_torch.analysis``) — (a) the CLI's
   Layer 1 over ``src/repro_torch`` exits 0 under
   ``analysis-baseline-torch.json`` (the per-rule table printed); (b) the
   program verifier over its full inventory on the card
   (``verify_all(device="cuda")``, every program under
   ``torch.cuda.set_sync_debug_mode("error")``), the eval, gather and fold
   programs on a 1x1 NCCL mesh set up as in phase 14 (a): every check of
   every program passes (each printed); (c) each ``kernels.*`` program
   raised its launch counter; (d) planted faults fail their checks on the
   card: ``.item()`` and ``.tolist()`` (syncs), a float64 output (dtype), a
   written argument (mutation), an all-gather in a zero-collective program
   (collectives); (e) no ``nvcc`` build over the phase (``CompileWatch``).
   Its time is printed against its 30 s budget.
16. training (``repro_torch.launch``'s ``make_train_step`` and
   ``train_loop``) — (a) the flash kernel's training forward, which also
   writes each row's log-sum-exp, and ``FlashAttention``'s gradients at
   tinyllama's train shape (4, 4096, 32/4, 64) in bfloat16 (the
   tensor-core route; lse within 1e-4, out, dq, dk, dv within relative RMS
   2e-2 of the plain version's float32 autograd) and at a float32 smoke
   shape (the CUDA-core route; 1e-5 and 1e-4), ``SSDScan`` at mamba2's
   train shape (2, 4096, 80, 64, 128, chunk 256): y within 1e-4 of the
   plain version's max abs, and the gradients within 1e-4 of each one's
   max abs of float64 autograd through another chunked form of the scan
   (the backward itself differentiates the plain version), each forward's
   device time with and without the lse store and each backward's; (b) tinyllama-1.1b at full width, bf16
   activations and float32 masters, ``train_4k``'s sequence 4096 with the
   global batch cut from 256 to 8: two steps of two microbatches, exactly
   88 flash launches a step (22 layers, 2 microbatches, forward and remat
   recompute), all tensor-core, finite loss and grad norm, the step
   counted, the parameters moved, then one step from the first state in
   one batch within the reference's 5e-3 of the first step's loss; wall
   per step, tokens/s, the idle share of a third step under torch.profiler
   and the peak memory, within 0.9 of the card; then one more step under
   ``launch.op_analysis`` (the dry-run's per-rank roofline on the card):
   its FLOPs and collective bytes equal to a meta trace of the same step,
   its compute and memory terms at or under the measured wall of a step,
   its peak live bytes plus what the card held before it within 10 % of
   ``max_memory_allocated`` over it; (c) mamba2-2.7b at full
   width with its depth cut to 32 of 64 layers, one step of 2 x 4096:
   exactly 64 SSD calls, the same prints and
   memory bar; (d) one step of every architecture's float32 smoke config
   on the card against the CPU (loss and grad norm within 1e-5 relative,
   each first-moment leaf within 1e-4 of its max abs, the kernels
   launched); (e) ``train_loop`` at smoke size (tinyllama, 8 steps, batch
   4 x 32, checkpoints every 3 in a temporary directory) preempted at 6 and
   resumed against the run that was not stopped (bit for bit, or within
   1e-6 relative; which one is printed), then 30 steps whose last five
   losses average below the first five. Its time is printed against its
   120 s budget, with (e)'s resume report; the kernels line gains the
   flash and SSD launches counted in each step of (b) and (c); (a) also
   prints each backward's bound (``flash_backward_work``,
   ``ssd_backward_work``) and SDPA's backward at tinyllama's train shape
   (autograd through a retained SDPA graph), and (b) keeps its losses,
   grad norms and per-tensor state digests for phase 17 (a);
17. the mesh of the LM substrate (``launch.steps.ShardedTrainStep``,
   ``launch.train``'s mesh path, ``distributed``) — (a) tinyllama-1.1b at
   full width on a 1x1 NCCL mesh (its ``FileStore`` under
   ``build/archive/phase17/``): two meshed steps of phase 16 (b)'s 8 x 4096
   in two microbatches from the same seeded init, their losses, grad norms
   and parameter and moment digests bit for bit phase 16 (b)'s, exactly 88
   flash launches a step, all tensor-core, one all-gather and one
   all-reduce a step, wall per step and peak memory (within 0.9 of the
   card); then the checkpoint gather of that state (``gather_state``: one
   all-gather a tensor, each copied to the host), its seconds and the card
   memory it adds (at most two of the largest tensor), and ``train_loop``
   on the same NCCL group (the ``torchrun`` CLI's path) on the tinyllama
   float32 smoke config, preempted and resumed, bit for bit the card's
   uninterrupted run; (b) a 2x2 mesh of four gloo ranks sharing the
   card, spawned with a join timeout, each loading phase 1's libraries
   and building none, the step split over ``"model"``
   (``distributed/tensor_parallel.py``): the tinyllama, mamba2 and
   olmoe float32 smoke configs' meshed steps (the CUDA-core flash route,
   the SSD kernel and the split experts, half the one-rank step's
   launches per rank), each step within 1e-5 of the card's one-rank step
   from the same state (loss, grad norm, parameters but Adam's sign knife
   edges, moments) and the losses within 1e-5 of the one-rank run's,
   each rank holding exactly three copies of its shard bytes between
   steps and no whole parameter, computing with less than the whole
   model, and issuing the layer counts' all-reduces; ``compressed_psum_tree``
   bit for bit its one-process emulation and within 2 % of the exact
   mean, and ``pipeline_apply`` within 1e-5 of the sequential stages,
   over the four ranks; ``train_loop`` preempted on the 2x2 mesh, the
   group shrunk to two ranks (``engine.mesh.regroup``) and resumed on
   1x2, within 1e-5 of the card's uninterrupted run; (c) on the same
   ranks, tinyllama-1.1b and mamba2-2.7b at full width with the depth cut
   to two layers, 2 x 1024 in two microbatches, two steps: the split
   forward's first-batch logits within relative RMS 2e-2 of the one-rank
   step's and each loss within 1e-2, every flash launch on
   ``flash_fwd_tc`` at 16/2 heads and every SSD call at 40 heads (half
   the one-rank step's launches a rank), the layer counts' all-reduces,
   each rank's parameter bytes during the step against the one-rank
   step's and its peak memory; then each kernel on rank 0's inputs
   against its plain version, timed beside it and its bound; rank 0 runs
   its last step of each under ``launch.op_analysis``, whose collective
   bytes equal, kind by kind, what its counted helpers recorded in that
   step and a meta trace of the same step at rank 0's position of a 2x2
   ``StandInMesh``; then on the same ranks the split serve
   (``ShardedServeStep``): phase 5's first group of requests (batch 4
   over ``"data"``, 1024-token prompts, 16 new) for tinyllama-1.1b at full
   width and depth against phase 5's tokens, and for mamba2-2.7b at the
   two-layer cut against the one-rank serve there: tokens equal up to
   each request's first knife edge, logits within relative RMS 2e-2,
   every flash launch on ``flash_fwd_tc`` at (2, 1024, 16/2, 64) and
   every SSD call at 40 heads, launches and all-reduces exact from the
   layer counts, each rank's cache of its kv or SSD heads, its parameter
   bytes half the model's; rank 0's launches against their plain
   versions. A rank on the CPU, or one that fails or hangs, fails the
   run. Its time is printed against its 120 s budget; the kernels line
   gains (a)'s flash launches per step, rank 0's launches in (b), (c)'s
   per-rank entry and the split serve's.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``. Without a CUDA
GPU, or without the repository's ``src/repro_torch`` beside it, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import importlib
import json
import math
import pathlib
import re
import resource
import statistics
import subprocess
import sys
import time

ETA_GRID = [0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0]
LEARNERS = ["hedge", "exp3", "ucb1", "egreedy", "ftl"]
# Comparison rows per r: hedge and exp3 with the paper's schedule and each
# grid eta, ucb1, egreedy and ftl with their defaults (comparison_specs).
COMPARE_ROWS = 2 * (1 + len(ETA_GRID)) + 3
FLEET_TOL = 1e-5     # absolute, on ScheduleReport fields
PLAN_TOL = 1e-5      # absolute, on fixed alphas and unit costs, device vs host
# Phase 10's families besides Table 6's fresh markets, and its grids: Table
# 6's round-0 evaluations (label, grid, r, Even benchmark).
PLAN_FAMILIES = ("regime", "adversarial")
PLAN_FAMILY_JOBS = 500   # (c)'s stream: phase 11 (e)'s table6.run depth
PLAN_GRIDS = [("proposed r=0", "spot_od", 0, False),
              ("proposed r=1200", "selfowned", 1200, False),
              ("even r=1200", "bench", 1200, True)]
PLAN_FIELDS = ("starts", "ends", "z_t", "d_eff", "pins")
# Phase 11, the streamed scenarios: Table 6's market seed, the scenario
# counts of its legs (synthesis, streamed evaluation, replay_stream, the
# adaptive adversary), the chunk, the driver's stream and the bars:
# ScenarioSpec device C against the float64 host views
# (tests/test_scenarios.py:176), the reference's replay_stream bars
# against the monolithic replay (tests/test_scenarios.py:306-318) and its
# reduce="mean" bar.
STREAM_SEED = 1000
STREAM_S = {"synth": 64, "eval": 16, "replay": 16, "adaptive": 32}
STREAM_CHUNK = 8
STREAM_DRIVER_JOBS = 500
STREAM_C_TOL = 1e-4
STREAM_REALIZED_RTOL, STREAM_REGRET_RTOL = 1e-12, 1e-9
STREAM_MEAN_RTOL = 1e-12
# Phase 12, the cross-call caches: Table 6's proposed r = 1200 round-0 grid
# (its groups), the re-bid steps of benchmarks/bench_pipeline.py (every
# tenth policy, then every sixth) and the most groups the first re-bid may
# re-score (one per re-bid policy: ceil(175 / 10)).
CACHE_GROUPS = 65
CACHE_REBID, CACHE_CHAIN_REBID = 10, 6
CACHE_MAX_RESCORED = 18
# Phase 13, observability: phase 12's grid and spec, the adaptive stream's
# size, the repetitions that time one span and one captured launch, the
# overhead bars (tests/test_obs.py's 2 % with spans off; bench_obs.py's
# 1.1x gate with everything on) and where the Chrome trace goes.
OBS_ADAPTIVE_S = 16
SPAN_REPS, EVENT_REPS = 20000, 200
DISABLED_SHARE, ENABLED_SHARE = 0.02, 0.10
OBS_TRACE = pathlib.Path("build") / "archive" / "phase13_trace.json"
# Phase 14, the mesh: (a) phase 12's grid and spec on a 1x1 NCCL mesh, (b)
# a 2x2 mesh of four gloo ranks sharing the card at S = 13.
MESH_DIR = pathlib.Path("build") / "archive" / "phase14"
MESH_SHAPE = (2, 2)
MESH_S = 13
MESH_LEARNERS = ["hedge", "exp3"]
MESH_FOLD_TOL = 1e-4     # absolute, the reference's fold bar
MESH_TIMEOUT = 300.0     # seconds for the four ranks, start to end
MESH_FIELDS = ("unit_cost", "spot_cost", "ondemand_cost", "spot_work",
               "ondemand_work")
MESH_EVAL_KEYS = ("engine.eval.chain:sharded", "engine.eval.task:sharded",
                  "engine.eval.chain_ps:sharded",
                  "engine.eval.task_ps:sharded")
MESH_KEYS = MESH_EVAL_KEYS + ("engine.gather:sharded", "learn.fold:sharded")
# Phase 15, the static contract checker: its NCCL store and its budget.
# Phase 17, the mesh of the LM substrate: its budget, (a)'s store, (b)'s
# smoke steps (shrink MESH_SMOKE_STEPS first if the script passes 1150 s),
# preempted loop and compression and pipeline shapes (the CPU tests').
MESH_TRAIN_BUDGET = 120.0    # seconds
MESH_TRAIN_DIR = pathlib.Path("build") / "archive" / "phase17"
MESH_TRAIN_TIMEOUT = 400.0   # seconds for (b)/(c)'s four ranks, start to end
MESH_SMOKE_ARCHS = ("tinyllama_1_1b", "mamba2_2_7b", "olmoe_1b_7b")
MESH_SMOKE_BATCH, MESH_SMOKE_SEQ, MESH_SMOKE_STEPS = 4, 32, 2
MESH_SMOKE_LR = 1e-2
MESH_SPLIT_TOL = 1e-5        # relative, float32 split against one rank
# (c): the split at full width, depth cut, against the one-rank steps.
MESH_FULL_ARCHS = {"tinyllama_1_1b": "flash_attention",
                   "mamba2_2_7b": "ssd_scan"}
MESH_FULL_HEADS = {"tinyllama_1_1b": (16, 2), "mamba2_2_7b": (40,)}
MESH_FULL_LAYERS = 2
MESH_FULL_BATCH, MESH_FULL_SEQ, MESH_FULL_STEPS, MESH_FULL_MICRO = \
    2, 1024, 2, 2
MESH_FULL_LOGIT_TOL = 2e-2   # relative RMS, ROADMAP queue C's bf16 bar
MESH_FULL_LOSS_TOL = 1e-2    # relative
# (c)'s split serve on the same ranks (ShardedServeStep): phase 5's first
# group of requests (batch 4 over "data", 1024-token prompts, 16 new), for
# tinyllama-1.1b at full width and depth against phase 5's tokens, and for
# mamba2-2.7b at the two-layer cut against the one-rank serve at that cut;
# each with its flash or SSD launches a rank (prefill only).
MESH_SERVE_DEPTH = {"tinyllama_1_1b": None, "mamba2_2_7b": MESH_FULL_LAYERS}
MESH_SERVE_LAUNCHES = {"tinyllama_1_1b": {"flash_attention": 22},
                       "mamba2_2_7b": {"ssd_scan": MESH_FULL_LAYERS}}
MESH_SERVE_LOGIT_TOL = 2e-2  # relative RMS, the bf16 bar
# Phase 16 (b)'s analysed step: its peak live bytes against the allocator's
# peak over that step (relative).
TRAIN_PEAK_TOL = 0.1
MESH_LOOP = dict(global_batch=4, seq_len=32, log_every=100, ckpt_every=2,
                 microbatches=2)
MESH_LOOP_STEPS, MESH_LOOP_PREEMPT = 6, 4     # preempted at a checkpoint
MESH_COMP_SHAPE = (4, 32)
MESH_PIPE = (4, 8, 2, 16)    # stages, microbatches, rows, width
ANALYSIS_DIR = pathlib.Path("build") / "archive" / "phase15"
ANALYSIS_BUDGET = 30.0   # seconds
# Phase 16, training: its budget, the flash and SSD training checks, and
# the full-width steps (tinyllama's train_4k global batch cut from 256).
TRAIN_BUDGET = 120.0     # seconds
TRAIN_SEED = 16
# label: (B, S, H, K, dh, dtype, causal, window, prefix, route)
TRAIN_FLASH = {
    "tinyllama train": (4, 4096, 32, 4, 64, "bfloat16", True, 0, 0, "tc"),
    "float32 smoke": (2, 200, 4, 2, 16, "float32", True, 32, 8, "cuda core"),
}
# The backward kernels also at the serves' other masks and head dims, at a
# training batch of 4 (S: one length, or (Sq, Sk)).
TRAIN_FLASH_BWD = {
    "llama3-8b": (4, 1024, 32, 8, 128, "bfloat16", True, 0, 0, "tc"),
    "phi-3-vision": (4, 1600, 32, 32, 96, "bfloat16", True, 0, 0, "tc"),
    "hymba": (4, 1152, 25, 5, 64, "bfloat16", True, 1024, 128, "tc"),
    "seamless cross": (4, (1024, 256), 16, 16, 64, "bfloat16", False, 0, 0,
                       "tc"),
}
TRAIN_FLASH_TOL = {"bfloat16": (1e-4, 2e-2),   # lse abs, relative RMS
                   "float32": (1e-5, 1e-4)}     # lse abs, max abs
TRAIN_SSD = (2, 4096, 80, 64, 1, 128, 256)     # mamba2's train shape
TRAIN_SSD_TOL = 1e-4     # relative to each gradient's max abs
# The SSD backward's shapes: mamba2's with a state gradient, a grouped one
# whose length is no multiple of the chunk, mamba2's with a bfloat16 x (at
# LM_TOL's bfloat16 bar).
TRAIN_SSD_BWD = {
    "mamba2 train": (TRAIN_SSD, "float32"),
    "grouped, ragged": ((2, 1000, 8, 64, 2, 64, 256), "float32"),
    "mamba2 train, bf16 x": (TRAIN_SSD, "bfloat16"),
}
TRAIN_SEQ = 4096
TRAIN_BATCH, TRAIN_MICRO = 8, 2
MAMBA_TRAIN_BATCH = 2
MAMBA_TRAIN_LAYERS = 32  # of 64, at full width: cut for the time limit
TRAIN_MICRO_TOL = 5e-3   # the reference's bar (tests/test_arch_smoke.py)
TRAIN_MEM_SHARE = 0.9
TRAIN_TRACE = pathlib.Path("build") / "archive" / "train_trace.json"
# The device kernel names torch.profiler shows, one entry per captured
# launch of each key (the Hedge call's trajectory pass).
PROFILED_AS = {"policy_cost_chain": ("chain_smem_kernel", "chain_kernel"),
               "policy_cost_chain_smem": ("chain_smem_kernel",),
               "policy_cost": ("task_tree_kernel",),
               "hedge_replay": ("trajectory_kernel",),
               "learner_replay": ("learner_block_kernel",)}
# Keys whose launches are a subset of another key's (one event pair each).
SUBSET_KEYS = ("policy_cost_chain_smem", "flash_attention_tc")
COST_TOL = 1e-5      # relative to max(1, |plain|)
TABLE_TOL = 1e-5     # absolute, on alphas and unit costs of Tables 2-5
TABLE_JOBS = 1500    # jobs per stream of Tables 2-5 (benchmarks/common.py)
PROFILE_ATTEMPTS = 5  # profiled windows a device-time measurement may take
HEDGE_TOL = 1e-5     # absolute, on probabilities and weights
# exp3 at phase 4's small input, on weights and chosen probabilities: the
# reference's own float32 scan leaves its float64 loop by 5.4e-5 there
# (tests/test_torch_learn_bandits.py::
# test_exp3_no_further_from_float64_than_reference_scan); a typical
# probability at 25 policies is 0.04.
EXP3_SMALL_TOL = 1e-4
KNIFE_EDGE = 1e-6    # |cdf - u*total| / total below which a draw may flip
# The reference's kernel bars (tests/test_kernels.py:37,59): flash attention
# 2e-5 in float32 and 2e-2 in bfloat16; the SSD scan 1e-4 in float32, and a
# y rounded to bfloat16 at the bfloat16 bar.
LM_TOL = {"float32": {"flash": 2e-5, "ssd": 1e-4},
          "bfloat16": {"flash": 2e-2, "ssd": 2e-2}}
STATE_TOL = 1e-4     # the SSD final state is float32 in every case
FLASH_SHAPES = [     # tests/test_kernels.py:17-39 (BH, BK, Sq, Sk, dh, ...)
    (4, 2, 256, 256, 64, True, 0, 0), (2, 2, 384, 384, 128, True, 0, 0),
    (4, 1, 128, 512, 64, False, 0, 0), (2, 2, 512, 512, 64, True, 128, 16),
    (2, 1, 200, 300, 64, True, 0, 0), (1, 1, 640, 640, 64, True, 256, 0)]
SSD_SHAPES = [       # tests/test_kernels.py:42-62 (Bb, S, H, P, G, N, chunk)
    (2, 256, 4, 64, 1, 64, 64), (1, 200, 2, 32, 1, 16, 64),
    (2, 128, 4, 64, 2, 32, 32), (1, 512, 8, 64, 1, 128, 128)]
# mamba2's widths over 32 chunks: the state passing beyond the 4 chunks of
# every shape above and of the serve prompts.
SSD_LONG = (1, 8192, 80, 64, 1, 128, 256)
# Shapes off the serve path: P 20 and 33, N 18 and 20 (element-wise
# staging, odd P), P 128 with N 200 (two column tiles, four state row
# blocks), grouped and ragged; a 4096-row chunk (64 causal tile rows) and
# 70000 heads (more (batch, head) pairs than a y or z grid dimension holds).
SSD_ODD = [(1, 77, 2, 20, 2, 18, 32), (1, 130, 2, 33, 1, 20, 64),
           (2, 700, 4, 128, 2, 200, 256), (1, 4096, 2, 32, 1, 16, 4096),
           (1, 64, 70000, 8, 1, 16, 64)]
# The learner kernel's edge streams: jobs taken from the Table 6 launch and
# the seed of the P 1024 cost tensor.
EDGE_JOBS, EDGE_SEED = 600, 13
SSD_PASSES = ("ssd_chunk_state", "ssd_cb", "ssd_state_pass", "ssd_chunk_scan")
# qwen2.5-32b's depth at full width: its 64 layers of float32 masters (about
# 131 GB) do not fit the card's 80 GB; the deepest cut whose serve peak, in
# this script after the earlier phases, stays within SERVE_MEM_SHARE of the
# card's memory (34 layers peaked at 0.9060 of an H100 80GB; PERF.md §4).
QWEN_LAYERS = 33
SERVE_MEM_SHARE = 0.9
# (arch, launches of each kernel on its prefill path: layers x prefill
# rounds (seamless: 12 encoder, 12 self and 12 cross layers), depth cut)
SERVE = [("tinyllama_1_1b", {"flash_attention": 22 * 2}, None),
         ("mamba2_2_7b", {"ssd_scan": 64 * 2}, None),
         ("llama3_8b", {"flash_attention": 32 * 2}, None),
         ("granite_3_8b", {"flash_attention": 40 * 2}, None),
         ("qwen2_5_32b", {"flash_attention": QWEN_LAYERS * 2}, QWEN_LAYERS),
         ("hymba_1_5b", {"flash_attention": 32 * 2, "ssd_scan": 32 * 2},
          None),
         ("seamless_m4t_medium", {"flash_attention": 36 * 2}, None),
         ("deepseek_moe_16b", {"flash_attention": 28 * 2}, None),
         ("olmoe_1b_7b", {"flash_attention": 16 * 2}, None),
         ("phi_3_vision_4_2b", {"flash_attention": 32 * 2}, None)]
# The device kernels each wrapper launches, and the TPU kernel it replaces.
SERVE_KERNEL_NAMES = {"flash_attention": ("flash_fwd_tc", "flash_fwd_kernel"),
                      "ssd_scan": SSD_PASSES}
SERVE_REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:101",
                  "ssd_scan": "src/repro/kernels/ssd_scan.py:78"}
SERVE_FRAMES_SEED = 3   # seamless's seeded frames (its serve stubs zeros)
# phi-3-vision's seeded patches (its serve stubs zeros), at the scale of the
# reference's tests (tests/test_arch_smoke.py).
SERVE_PATCHES_SEED, SERVE_PATCHES_SCALE = 4, 0.02
# Flash attention at dh 96 off phi-3-vision's causal serve shape: ragged
# causal, a window with a prefix, non-causal with Sk > Sq (BH, BK, Sq, Sk,
# dh, causal, window, prefix).
FLASH_DH96 = [(4, 2, 200, 300, 96, True, 0, 0),
              (2, 2, 512, 512, 96, True, 128, 16),
              (2, 1, 130, 257, 96, False, 0, 0)]
# Phase 6's moe_ffn check: (batch, seq) of its seeded activations, every
# other token pushed towards expert 0 so that capacity drops entries.
MOE_CHECK_SHAPE = (4, 256)
MOE_ARCHS = ("deepseek_moe_16b", "olmoe_1b_7b")
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 4, 1024, 16
SERVE_TRACE = pathlib.Path("build") / "archive" / "serve_trace.json"
# Phase 5's tokens of the architectures phase 17 (c) serves split at full
# depth.
SERVED: dict = {}
# Chain cases off Table 6's path: a synthetic horizon at the shared-memory
# route's last slot count and one beyond it (the global route), with
# (B, S, R, L) and the seed of their data.
CHAIN_LONG = [(58111, "smem"), (70000, "global")]
CHAIN_LONG_SHAPE, CHAIN_LONG_SEED = (1, 2, 20000, 49), 7
# Task cases off Table 6's path: horizons around the task kernel's search
# tree (its node count is added at run time, from the .cu's layout) and
# long ones, with (S, T) and the seed of their data.
TASK_HORIZONS = (1, 2, 3, 58111, 70000, 300000)
TASK_LONG_SHAPE, TASK_LONG_SEED = (2, 20000), 9
HEDGE_PASSES = ("trajectory_kernel", "sample_kernel")
# Dependent-latency probe of the operations on the Hedge step's chain, in SM
# cycles: 4096 dependent iterations of one warp, timed with clock64.
LATENCY_PROBE = r"""
#include <cuda_runtime.h>
#define N 4096
__global__ void probe(long long* cyc, int* sink, float y, int m) {
  float x = threadIdx.x * 1e-3f;
  int v = threadIdx.x;
  long long t[5];
  t[0] = clock64();
  for (int i = 0; i < N; ++i) x = x - y;                        // FADD
  t[1] = clock64();
  for (int i = 0; i < N; ++i) x = fmaxf(x, y * (float)(i & 1));  // FMNMX
  t[2] = clock64();
  for (int i = 0; i < N; ++i) v = v ^ ((v >> 31) & m);           // SHF + LOP3
  t[3] = clock64();
  for (int i = 0; i < N; ++i)                                    // REDUX,
    v = __reduce_max_sync(0xffffffffu, v) ^ (int)threadIdx.x;    // move, LOP3
  t[4] = clock64();
  sink[threadIdx.x] = v + (int)x;
  if (threadIdx.x == 0)
    for (int k = 0; k < 4; ++k) cyc[k] = t[k + 1] - t[k];
}
extern "C" int latency_probe(long long* cyc, int* sink) {
  probe<<<1, 32>>>(cyc, sink, 1.0001f, 0x7fffffff);
  return (int)cudaDeviceSynchronize();
}
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: " + out.stderr.strip()


def ptxas_summary(log: str, kernel: str) -> list[tuple[str, str, str]]:
    """(entry, registers line, spill line) of each entry function whose
    mangled name holds ``kernel``, from an ``nvcc -Xptxas=-v`` log."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "registers" in line:
            out.append((name, line.split(":", 1)[-1].strip(), spills))
            name = None
    return out


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 20) -> float:
    """Milliseconds of device time per call of ``fn``: the calls are queued
    behind a 10 ms device-side sleep, so the host's preparation of each call
    overlaps the device's work and drops out of the event interval."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_entries(torch, fn, reps: int, want) -> list:
    """The CUDA entries of torch.profiler's ``key_averages`` over ``reps``
    calls of ``fn``, the window profiled again (at most PROFILE_ATTEMPTS
    times) until ``want(entries)`` holds: after a long profiled run the
    profiler on the card's machine drops CUDA records, at times every one
    of a short window (``PERF.md`` §7). It never invents one. Returns the
    entries of every window profiled."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    entries = []
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        entries += [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
        if want(entries):
            break
    return entries


def pass_device_ms(torch, fn, names, reps: int = 5) -> dict:
    """Mean device milliseconds of each kernel of ``fn`` whose name holds
    one of ``names``, over the launches torch.profiler recorded in ``reps``
    calls (it may drop some, so the mean is over those it kept)."""
    out = {}
    for e in cuda_entries(torch, fn, reps, lambda es: any(
            kernel_named(e.key, names) for e in es)):
        hit = kernel_named(e.key, names)
        if hit:
            tot, cnt = out.get(hit, (0.0, 0))
            out[hit] = (tot + e.self_device_time_total / 1e3, cnt + e.count)
    return {n: out[n][0] / out[n][1] for n in names if n in out}


def kernel_named(key: str, names) -> str | None:
    """The first of ``names`` that the profiler key ``key`` is a kernel of
    (the name followed by its template or argument list)."""
    return next((n for n in names if n + "<" in key or n + "(" in key), None)


def start_latency_probe(build_dir: pathlib.Path, nvcc: str):
    """Start compiling the latency probe beside the kernels' builds."""
    build_dir.mkdir(parents=True, exist_ok=True)
    src = build_dir / "latency_probe.cu"
    src.write_text(LATENCY_PROBE)
    lib = build_dir / "liblatency_probe.so"
    return subprocess.Popen(
        [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
         "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib




def latency_table(torch, lib_path) -> dict:
    """SM cycles of one dependent FADD, FMNMX, integer operation (SHF or
    LOP3) and redux.sync with the move of its result to a register."""
    import ctypes
    lib = ctypes.CDLL(str(lib_path))
    cyc = torch.zeros(4, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, dtype=torch.int32, device="cuda")
    if lib.latency_probe(ctypes.c_void_p(cyc.data_ptr()),
                         ctypes.c_void_p(sink.data_ptr())) != 0:
        fail("the latency probe did not run")
    fadd, fmnmx, map2, redux = (float(c) / 4096 for c in cyc.tolist())
    return {"fp": fadd, "fmnmx": fmnmx, "int": map2 / 2,
            "redux_move": redux - map2 / 2}


def sass_lines(cuobjdump, lib_path, name: str) -> list[tuple[int, str, str]]:
    """(address, opcode, operands) of the SASS of the function whose
    mangled name holds ``name``, from ``cuobjdump -sass``."""
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120).stdout
    body = next((part for part in out.split("Function : ")[1:]
                 if part.split("\n", 1)[0].strip().find(name) >= 0), "")
    ins = []
    for line in body.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z0-9_.]+)\s*([^;]*);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return ins


def sass_function(cuobjdump, lib_path, name: str) -> list[tuple[str, str]]:
    """(opcode, operands) of the SASS of the function whose mangled name
    holds ``name``, from ``cuobjdump -sass``."""
    return [(op, args) for _, op, args in sass_lines(cuobjdump, lib_path,
                                                     name)]


def sass_regs(operands: str) -> list[str]:
    return re.findall(r"\bU?R(?:\d+)\b", operands)


def redux_path(first: str, seq, last: str, lat: dict):
    """The longest path by ``lat``'s latencies from the result of a REDUX
    (operands ``first``) through the instructions ``seq`` ((opcode,
    operands)) to the operand of a REDUX (operands ``last``): (cycles,
    opcodes), or None where no path joins them. A load or shuffle starts no
    path; a move of REDUX's result costs nothing (it is in redux_move)."""
    def cost(op):
        if op.startswith(("FADD", "FMUL")):
            return lat["fp"]
        if op.startswith("FMNMX"):
            return lat["fmnmx"]
        if op.startswith(("MOV", "IMAD.U32", "IMAD.MOV")):
            return 0.0
        return lat["int"]

    ready = {sass_regs(first)[0]: (lat["redux_move"], ["REDUX"])}
    for op, args in seq:
        rs = sass_regs(args)
        if not rs or op.startswith(("ST", "BRA", "BAR")) or "SETP" in op:
            continue               # no register written
        hit = [ready[r] for r in rs[1:] if r in ready]
        if hit and not op.startswith(("LD", "SHFL")):
            t, path = max(hit, key=lambda h: h[0])
            ready[rs[0]] = (t + cost(op), path + [op.split(".")[0]])
        else:
            ready.pop(rs[0], None)     # overwritten off the chain
    rs = sass_regs(last)
    return ready.get(rs[1]) if len(rs) > 1 else None


def loop_chain(lines, lat: dict) -> tuple[list[str], float, int]:
    """The dependency chain of one trip of a loop that carries its state
    through one REDUX a trip (the learner kernel's update warp), in the
    SASS ``lines`` ((address, opcode, operands)): for each REDUX that a
    later backward branch jumps over (the first such branch closes its
    loop), the path from its result down to that branch and on from the
    branch's target back to its own operand. The compiler's divergent
    fallback blocks, at the end of the function, branch back into the code
    they left and so look like loops that span most of it: of the paths
    that close, the one of the shortest loop is taken. Returns its opcodes
    (ending with the REDUX), its cycles and how many REDUXes closed one."""
    at = {addr: i for i, (addr, _, _) in enumerate(lines)}
    ins = [(op, args) for _, op, args in lines]
    closed = []
    for r, (op, args) in enumerate(ins):
        if not op.startswith("REDUX"):
            continue
        for b in range(r + 1, len(ins)):
            target = re.findall(r"0x([0-9a-f]+)", ins[b][1])
            t = at.get(int(target[-1], 16)) if ins[b][0].startswith("BRA") \
                and target else None
            if t is not None and t <= r:
                c = redux_path(args, ins[r + 1:b + 1] + ins[t:r], args, lat)
                if c:
                    closed.append((b - t, c))
                break
    if not closed:
        return [], float("nan"), 0
    _, (t, path) = min(closed, key=lambda c: c[0])
    return path + ["REDUX"], t, len(closed)


def step_chain(ins, lat: dict) -> tuple[list[str], float]:
    """The dependency chain of one Hedge step in the SASS: from the result
    of one REDUX to the operand of the next, the longest path by ``lat``'s
    latencies. Every pair of consecutive REDUXes is walked (the compiler
    also emits REDUXes in divergent fallback blocks, where no chain joins
    them); returns the median chain over the pairs that do join: its
    opcodes, ending with the REDUX, and its cycles."""
    def walk(a, b):
        return redux_path(ins[a][1], ins[a + 1:b], ins[b][1], lat)

    reduxes = [i for i, (op, _) in enumerate(ins) if op.startswith("REDUX")]
    joined = sorted((c for c in (walk(a, b) for a, b in
                                 zip(reduxes, reduxes[1:])) if c),
                    key=lambda c: c[0])
    if not joined:
        return [], float("nan")
    t, path = joined[len(joined) // 2]
    return path + ["REDUX"], t


def smi_clocks() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    sm, sm_max = (float(v) for v in out[0].split(",")) if out else (0, 0)
    return {"sm_mhz": sm, "max_sm_mhz": sm_max}


DeviceRow = collections.namedtuple(
    "DeviceRow", ("key", "self_device_time_total", "count"))
TRACE_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_rows(prof, path: pathlib.Path) -> list:
    """The device entries of a device-only torch.profiler run, summed by
    name (microseconds, as ``key_averages``) from its Chrome trace, which
    the profiler's C++ side writes: ``key_averages`` first builds a Python
    object per event, 5-14 s a serve on an H100. The trace file
    is removed after reading."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    totals: dict = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") in TRACE_DEVICE_CATS:
            t = totals.setdefault(ev["name"], [0.0, 0])
            t[0] += float(ev["dur"])
            t[1] += 1
    path.unlink()
    return [DeviceRow(k, us, n) for k, (us, n) in totals.items()]


def device_breakdown(torch, prof, wall_s: float, top: int = 8,
                     kernels: dict[str, tuple[str, ...]] | None = None,
                     rows=None):
    """Print the device's busy share over ``wall_s`` and its largest
    entries, from a torch.profiler run (or from its ``rows``,
    ``trace_device_rows``); with ``kernels`` = {label: names}, also the
    device time, launches and busy share of each label's kernel names
    together. Returns the device entries."""
    if rows is None:
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
    rows = sorted(rows, key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[device busy {busy_ms:.3f} ms of {wall_s * 1e3:.0f} ms wall: busy "
          f"share {busy_ms / (wall_s * 1e3):.6f}, idle share "
          f"{1 - busy_ms / (wall_s * 1e3):.6f}]")
    for e in rows[:top]:
        print(f"  device {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d} calls  {e.key[:70]}")
    for label, names in (kernels or {}).items():
        hits = [e for e in rows if kernel_named(e.key, names)]
        k_ms = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"  {label} ({', '.join(names)}): device {k_ms:.3f} ms over "
              f"{sum(e.count for e in hits)} launches, "
              f"{k_ms / busy_ms if busy_ms else math.nan:.6f} of the busy "
              "time")
    return rows


def capture_report(rows, reg, launches: dict, keys, smi: str) -> dict:
    """Each kernel's launches and device time from a launch capture (a CUDA
    event pair per launch: no record is lost), held against the launch
    counters, beside the launches torch.profiler kept (``rows``, the
    device entries ``device_breakdown`` returned); returns the capture's
    kernel entries."""
    snap = reg.snapshot()["kernels"]
    short = []
    for key in keys:
        e = snap.get(key, {"launches": 0, "device_ms": 0.0})
        n = e["launches"]
        if n != launches.get(key, 0):
            fail(f"the capture counted {n} {key} launches, the launch "
                 f"counter {launches.get(key, 0)}")
        kept = sum(r.count for r in rows
                   if kernel_named(r.key, PROFILED_AS[key]))
        per = e["device_ms"] / n if n else math.nan
        bnd = f", bound {e['bound_ms']:.3f} ms" if "bound_ms" in e else ""
        print(f"  {key}: {n} launches, {e['device_ms']:.3f} ms of CUDA-event "
              f"time ({per:.4f} ms per launch{bnd}); torch.profiler kept "
              f"{kept} [{smi}]")
        if kept < n:
            short.append(key)
    if short:
        print(f"  torch.profiler kept fewer launches than the capture counted "
              f"({', '.join(short)}): the busy share above is a lower bound")
    return snap


def task_case(torch, np, n_slots: int, Sp: int, seed: int):
    """Synthetic inputs of one task call: a market of ``n_slots`` slots
    (availability 0-1, 30 % of the slots out, prices 0.2-1), windows that
    start anywhere up to a tenth past the horizon, 40 % of the tasks
    without work, shared (Sp 1) or per-scenario (Sp 2) plans."""
    S, T = TASK_LONG_SHAPE
    g = np.random.default_rng(seed)
    frac = g.random((S, n_slots)) * (g.random((S, n_slots)) < 0.7)
    price = 0.2 + 0.8 * g.random((S, n_slots))
    zero = np.zeros((S, 1))
    A = np.concatenate([zero, np.cumsum(frac / 12, -1)], -1)
    C = np.concatenate([zero, np.cumsum(frac * price / 12, -1)], -1)
    start = g.random(T) * n_slots / 12 * 1.1
    end = start + g.exponential(2.0, T)
    z = g.random((Sp, T)) * 3 * (g.random((Sp, T)) < 0.6)
    d = g.integers(1, 4, (Sp, T)).astype(np.float64)
    if Sp == 1:
        z, d = z[0], d[0]
    return [torch.tensor(x, dtype=torch.float32, device="cuda")
            for x in (A, C, start, end, z, d)]


def device_ops(torch, fn, reps: int = 5) -> dict:
    """{device entry: count} of ``reps`` calls of ``fn`` under
    torch.profiler, profiled again until it records one: every kernel,
    copy and fill they put on the device (the profiler may drop some
    launches, never invent one)."""
    out: dict = {}
    for e in cuda_entries(torch, fn, reps, bool):
        out[e.key] = out.get(e.key, 0) + e.count
    return out


def flash_plain_bshd(q, k, v, **kw):
    """The plain version on the models' (B, S, H, dh) layout."""
    from repro_torch.kernels.flash_attention import attention_plain_bshd
    return attention_plain_bshd(q, k, v, **kw)


def allclose(got, ref, tol: float) -> tuple[float, bool]:
    d = (got.float() - ref.float()).abs()
    return float(d.max()), bool((d <= tol + tol * ref.float().abs()).all())


def serve_phases(torch, np) -> tuple[dict, dict]:
    """Serve every architecture of ``SERVE`` at full width (qwen2.5-32b at
    its depth cut), each within ``SERVE_MEM_SHARE`` of the card; returns each architecture's launch counts and the inputs
    of the last launch of each (architecture, kernel, mask and lengths)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    # The module (the package attribute of its name is the function).
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import build

    captured: dict = {}
    label = [None]     # the run whose launches are kept, None: none

    def flash_key(a, k):
        q, kk = a[0], a[1]
        return (label[0], "flash_attention", k["causal"], k["window"],
                k["prefix"], q.shape[1], kk.shape[1])

    keys = {"flash_attention": flash_key,
            "ssd_scan": lambda a, k: (label[0], "ssd_scan")}
    originals = {"flash_attention": (fa, "flash_attention_strided"),
                 "ssd_scan": (ss, "ssd_scan")}
    for name, (mod, attr) in originals.items():
        fn = getattr(mod, attr)

        def wrapper(*a, _fn=fn, _key=keys[name], **k):
            if label[0]:
                captured[_key(a, k)] = (a, k)    # the last launch's inputs
            return _fn(*a, **k)
        setattr(mod, attr, wrapper)
        originals[name] = (mod, attr, fn)
    total = torch.cuda.get_device_properties(0).total_memory
    counts = {}
    for arch, expected, depth in SERVE:
        cfg = get_config(arch)
        if depth:
            print(f"[{cfg.name}: depth cut from {cfg.n_layers} to {depth} "
                  f"layers at full width, to keep the float32 masters and "
                  f"the serve's peak within {SERVE_MEM_SHARE:.0%} of the "
                  f"card's {total / 2**30:.3f} GiB]")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT), dtype=np.int32)
        torch.cuda.reset_peak_memory_stats()
        # One copy of the weights: the model's; the serves take its tensors.
        t0 = time.perf_counter()
        model = build(cfg, "cuda")
        model.init_weights(torch.Generator("cuda").manual_seed(0))
        state = model.state_dict()
        n_params = sum(t.numel() for t in state.values())
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        LAUNCHES.clear()
        label[0] = arch
        t0 = time.perf_counter()
        out, stats = serve_requests(cfg, prompts, SERVE_BATCH, SERVE_NEW,
                                    params=state, device="cuda")
        torch.cuda.synchronize()
        t_phase = time.perf_counter() - t0
        label[0] = None
        if arch in MESH_SERVE_DEPTH and MESH_SERVE_DEPTH[arch] is None:
            SERVED[arch] = out      # (c) serves it at full depth too
        counts[arch] = launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        print(f"[phase serve {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {n_params / 1e9:.3f}e9 parameters, "
              f"{SERVE_REQUESTS} requests x {SERVE_PROMPT} tokens, batch "
              f"{SERVE_BATCH}, {SERVE_NEW} new: serve loop "
              f"{stats['wall_s']:.3f}s, {stats['tokens_per_s']:.1f} tok/s; "
              f"{t_phase:.3f}s with the call, init {t_init:.3f}s; launches "
              f"{launches}; peak memory {peak / 2**30:.3f} GiB of "
              f"{total / 2**30:.3f}]")
        print(f"  first completion: {out[0].tolist()}")
        for kernel, n in expected.items():
            if launches.get(kernel, 0) != n:
                fail(f"serve {arch}: {kernel} launched "
                     f"{launches.get(kernel, 0)} times, expected {n}")
        if "flash_attention" in expected and launches.get(
                "flash_attention_tc", 0) != expected["flash_attention"]:
            fail(f"serve {arch}: {launches.get('flash_attention_tc', 0)} of "
                 f"{expected['flash_attention']} flash launches took the "
                 "tensor-core route")
        if out.shape != (SERVE_REQUESTS, SERVE_NEW) or out.min() < 0 \
                or out.max() >= cfg.vocab or not stats["tokens_per_s"] > 0:
            fail(f"serve {arch}: bad output {out.shape} [{out.min()}, "
                 f"{out.max()}] or stats {stats}")
        if cfg.kind == "encdec":
            # The serve's stub frames are zeros: the encoder's and the cross
            # launches saw zeros. One prefill on seeded frames for their
            # checks.
            gen = torch.Generator("cuda").manual_seed(SERVE_FRAMES_SEED)
            frames = torch.randn(SERVE_BATCH, SERVE_PROMPT // 4, cfg.d_model,
                                 device="cuda", generator=gen)
            label[0] = f"{arch} (seeded frames)"
            model.prefill({"tokens": torch.as_tensor(
                prompts[:SERVE_BATCH], device="cuda"), "frames": frames},
                max_len=SERVE_PROMPT + SERVE_NEW)
            label[0] = None
        if cfg.kind == "vlm":
            # Likewise the vision stub's zero patches: one prefill on
            # seeded ones, for vision_proj and a non-trivial prefix.
            gen = torch.Generator("cuda").manual_seed(SERVE_PATCHES_SEED)
            patches = SERVE_PATCHES_SCALE * torch.randn(
                SERVE_BATCH, cfg.frontend_len, cfg.d_model, device="cuda",
                generator=gen)
            label[0] = f"{arch} (seeded patches)"
            model.prefill({"tokens": torch.as_tensor(
                prompts[:SERVE_BATCH], device="cuda"), "vision": patches},
                max_len=SERVE_PROMPT + SERVE_NEW)
            label[0] = None
        # The first group again under the profiler, from the same weights
        # (the serve's tensors: no copy in the profiled window, which then
        # holds the serve loop alone). Device activity only, and one group:
        # the busy share needs no host events, and reading a trace of the
        # host's ops took 22-54 s a model.
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out_p, stats_p = serve_requests(cfg, prompts[:SERVE_BATCH],
                                            SERVE_BATCH, SERVE_NEW,
                                            params=state, device="cuda")
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows = device_breakdown(torch, prof, stats_p["wall_s"], kernels={
            k: SERVE_KERNEL_NAMES[k] for k in expected},
            rows=trace_device_rows(prof, SERVE_TRACE))
        if not rows:
            fail(f"serve {arch}: the profiler's trace holds no device event")
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        print(f"  first group under torch.profiler (not counted): serve loop "
              f"{stats_p['wall_s']:.3f}s, idle share "
              f"{1 - busy / (stats_p['wall_s'] * 1e3):.6f}; profiled run and "
              f"trace collection {t1 - t0:.3f}s, reading the trace "
              f"{time.perf_counter() - t1:.3f}s")
        if not np.array_equal(out_p, out[:SERVE_BATCH]):
            fail(f"serve {arch}: the profiled run generated other tokens")
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak memory over the model's serves {peak / 2**30:.3f} GiB, "
              f"{peak / total:.4f} of the card")
        if depth:
            kv_layer = 2 * 2 * SERVE_BATCH * (SERVE_PROMPT + SERVE_NEW) \
                * cfg.n_kv_heads * cfg.dh
            one_more = peak + kv_layer + 4 * sum(
                t.numel() for k, t in state.items()
                if k.startswith("layers.0."))
            print(f"  one layer more: about {one_more / 2**30:.3f} GiB "
                  f"({one_more / total:.4f} of the card)")
        if peak > SERVE_MEM_SHARE * total:
            fail(f"serve {arch}: peak {peak / total:.4f} of the card at "
                 f"{cfg.n_layers} layers, over {SERVE_MEM_SHARE}")
        del model, state, out_p, prof
        torch.cuda.empty_cache()
    for mod, attr, fn in originals.values():
        setattr(mod, attr, fn)
    return counts, captured


def sdpa_yardstick(torch, q, k, v, kw):
    """One SDPA call that computes what the flash launch computes (the same
    mask), or None: causal without a window, non-causal (the encoder and
    cross attention), and a window with a prefix as an explicit boolean
    mask. Timed beside the kernel, never used on the path."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    Sq, Sk = q.shape[1], k.shape[1]
    if not kw["window"]:
        if kw["causal"] and Sq != Sk:
            return None
        return lambda: sdpa(qt, kt, vt, is_causal=kw["causal"],
                            enable_gqa=True)
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    ok = (i - j < kw["window"]) | (j < kw["prefix"])
    if kw["causal"]:
        ok &= j <= i
    return lambda: sdpa(qt, kt, vt, attn_mask=ok, enable_gqa=True)


def flash_entry(torch, inputs, label: str, launches: int) -> dict:
    """A flash launch's inputs against the plain version, on both kernels,
    timed beside the plain version, SDPA and the bound."""
    # The module (the package attribute of its name is the function).
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels import ops
    from repro_torch.obs.compiled import work_bound

    (q, k, v, _), kw = inputs
    dtype = str(q.dtype).split(".")[-1]
    got = ops.flash_attention(q, k, v, **kw)
    plain = flash_plain_bshd(q, k, v, **kw)
    err, ok = allclose(got, plain, LM_TOL[dtype]["flash"])
    # The CUDA-core kernel through its own entry point, same inputs.
    out_cc = torch.empty_like(got)
    fa.launch_cuda_core(q, k, v, out_cc, **kw)
    err_cc, ok_cc = allclose(out_cc, plain, LM_TOL[dtype]["flash"])
    B, Sq, H, dh = q.shape
    b_ms, b_by = work_bound(fa.flash_work(q, k, v, got, kw["causal"],
                                          kw["window"], kw["prefix"]))
    lib = sdpa_yardstick(torch, q, k, v, kw)
    # ms, cuda_core_ms and library_ms: one call at a time, the wrapper's
    # preparation included; *device_ms: device time alone.
    run = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
    run_cc = lambda: fa.launch_cuda_core(q, k, v, out_cc, **kw)  # noqa: E731
    e = {"serve": label, "launches": launches, "max_abs_err": err,
         "ms": cuda_ms(torch, run),
         "cuda_core_ms": cuda_ms(torch, run_cc),
         "cuda_core_max_abs_err": err_cc,
         "plain_ms": cuda_ms(torch, lambda: flash_plain_bshd(q, k, v, **kw)),
         "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": cuda_ms(torch, lib) if lib else None,
         "device_ms": device_ms(torch, run),
         "cuda_core_device_ms": device_ms(torch, run_cc),
         "library_device_ms": device_ms(torch, lib) if lib else None,
         "library_max_abs_err": float((lib().transpose(1, 2).float()
                                       - plain.float()).abs().max())
         if lib else None,
         "shape": {"B": B, "Sq": Sq, "Sk": k.shape[1], "H": H,
                   "K": k.shape[2], "dh": dh, "dtype": dtype, **kw}}
    mask = ("causal" if kw["causal"] else "non-causal") + (
        f", window {kw['window']}, prefix {kw['prefix']}"
        if kw["window"] else "")
    print(f"flash_attention, {label} ({B}, {Sq}/{k.shape[1]}, {H}/"
          f"{k.shape[2]}, {dh}) {dtype} {mask}: max abs err vs plain "
          f"{err:.3e} (tensor-core route), {err_cc:.3e} (CUDA-core kernel) "
          f"(tol {LM_TOL[dtype]['flash']} abs + rel) "
          f"{'OK' if ok and ok_cc else 'FAIL'}; ms per call (device only): "
          f"tensor cores {e['ms']:.4f} ({e['device_ms']:.4f}), CUDA cores "
          f"{e['cuda_core_ms']:.4f} ({e['cuda_core_device_ms']:.4f}), SDPA "
          f"{e['library_ms']} ({e['library_device_ms']}), plain "
          f"{e['plain_ms']:.4f}, bound {b_ms:.4f} ({b_by}); {launches} "
          "launches")
    if not (ok and ok_cc):
        fail(f"flash_attention disagrees with its plain version at {label}")
    if not got.abs().max() > 0:
        fail(f"flash_attention at {label}: all-zero output checks nothing")
    return e


def ssd_entry(torch, inputs, label: str, launches: int) -> dict:
    """An SSD launch's inputs against the plain version, timed beside it,
    its passes and its bounds."""
    from repro_torch.kernels import ssd_scan as ss

    (x, dt, A, Bm, Cm, *rest), kw = inputs
    chunk = rest[0] if rest else kw.get("chunk", 128)
    dtype = str(x.dtype).split(".")[-1]
    y, st = ss.ssd_scan(x, dt, A, Bm, Cm, chunk)
    yr, sr = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    e_y, ok_y = allclose(y, yr, LM_TOL[dtype]["ssd"])
    e_s, ok_s = allclose(st, sr, STATE_TOL)
    x32 = x.float()
    e_32, ok_32 = allclose(ss.ssd_scan(x32, dt, A, Bm, Cm, chunk)[0],
                           ss.ssd_scan_plain(x32, dt, A, Bm, Cm, chunk)[0],
                           LM_TOL["float32"]["ssd"])
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2:]
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (x, dt, A, Bm, Cm, y, st))
    x_ops, other_ops = ss.ssd_ops(Bb, S, H, P, G, N, min(chunk, S))
    bounds = ss.ssd_bounds(n_bytes, x_ops, other_ops,
                           x.dtype == torch.bfloat16)
    b_ms, b_by = bounds["row"]
    run = lambda: ss.ssd_scan(x, dt, A, Bm, Cm, chunk)  # noqa: E731
    dev_ms = device_ms(torch, run)
    passes = pass_device_ms(torch, run, SSD_PASSES)
    pass_sum = sum(passes.values())
    smem = ss.smem_bytes(x.dtype, P)
    e = {"serve": label, "launches": launches, "max_abs_err": max(e_y, e_s),
         "ms": cuda_ms(torch, run),
         "plain_ms": cuda_ms(torch, lambda: ss.ssd_scan_plain(
             x, dt, A, Bm, Cm, chunk)),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "bound_kernel_scheme_ms": bounds["kernel"][0],
         "bound_tf32_3_ms": bounds["tf32_3"][0],
         "bound_f32_cuda_core_ms": bounds["f32"][0],
         "bound_f32_cuda_core_by": bounds["f32"][1],
         "ops": {"x": x_ops, "other": other_ops},
         "device_ms": dev_ms, "pass_device_ms": passes,
         "pass_sum_over_device_ms": pass_sum / dev_ms,
         "smem_bytes": smem,
         "shape": {"B": Bb, "S": S, "H": H, "P": P, "G": G, "N": N,
                   "chunk": chunk, "dtype": dtype},
         "y_err": e_y, "state_err": e_s, "y_err_float32_x": e_32}
    print(f"ssd_scan, {label} ({Bb}, {S}, {H}, {P}, {G}, {N}, chunk {chunk})"
          f": ms per call {e['ms']:.4f}, device {dev_ms:.4f} (passes: "
          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
          + f", sum {pass_sum:.4f}), plain {e['plain_ms']:.4f}; {launches} "
          "calls, each the four passes of the one kernel (no route); "
          f"dynamic shared memory per block {smem}")
    print(f"ssd_scan bounds, {label}: {x_ops / 1e9:.3f} GFLOP with x, "
          f"{other_ops / 1e9:.3f} GFLOP without, {n_bytes / 1e6:.1f} MB: "
          f"{b_ms:.4f} ({b_by}; x products at bf16/3, the rest at TF32/3: "
          f"the row's), {bounds['kernel'][0]:.4f} (the kernel's scheme: x "
          f"products at TF32/2), {bounds['tf32_3'][0]:.4f} (all at TF32/3), "
          f"{bounds['f32'][0]:.4f} ({bounds['f32'][1]}, f32 on the CUDA "
          "cores)")
    if set(passes) != set(SSD_PASSES) or abs(pass_sum / dev_ms - 1) > 0.05:
        print(f"WARNING: ssd_scan's profiled passes ({sorted(passes)}) sum to "
              f"{pass_sum:.4f} ms against {dev_ms:.4f} ms of device time by "
              "events: the per-pass times are not to be trusted in this run")
    ok = ok_y and ok_s and ok_32
    print(f"ssd_scan vs plain, {label}: y ({dtype}) max abs err {e_y:.3e} "
          f"(tol {LM_TOL[dtype]['ssd']} abs + rel), final state {e_s:.3e} "
          f"(tol {STATE_TOL}), y with x in float32 {e_32:.3e} (tol "
          f"{LM_TOL['float32']['ssd']}) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"ssd_scan disagrees with its plain version at {label}")
    return e


def lm_kernel_entries(torch, counts, captured) -> list[dict]:
    """Each LM kernel against its plain version on the inputs of its last
    launch in each serve (each mask and length of it: seamless's encoder and
    cross launches from its seeded-frames prefill), timed beside its plain
    version, its library call and its bound. The entry's own numbers,
    ``launches`` among them, are its first serve's (tinyllama's flash,
    mamba2's SSD); ``serves`` holds every one with its own serve's count,
    and ``launches_all_serves`` sums the serves'."""
    from repro_torch.configs import get_config

    checks = {"flash_attention": flash_entry, "ssd_scan": ssd_entry}
    serves = {name: [] for name in checks}
    for (label, name, *_), inputs in captured.items():
        arch = label.split(" (")[0]
        if label == arch and get_config(arch).kind == "encdec":
            continue     # the stub's zero frames: held on seeded frames
        serves[name].append(checks[name](
            torch, inputs, label, counts[arch].get(name, 0)))
    entries = []
    for name, first in (("flash_attention", "tinyllama_1_1b"),
                        ("ssd_scan", "mamba2_2_7b")):
        rows = serves[name]
        head = dict(next(r for r in rows if r["serve"] == first))
        head.update({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": SERVE_REPLACES[name],
            "launches": counts[first].get(name, 0),
            "launches_all_serves": sum(c.get(name, 0)
                                       for c in counts.values()),
            "serves": rows})
        if name == "flash_attention":
            head["launches_tc"] = counts[first].get("flash_attention_tc", 0)
            head["launches_tc_all_serves"] = sum(
                c.get("flash_attention_tc", 0) for c in counts.values())
        entries.append(head)
    return entries


def lm_kernel_sweep(torch) -> None:
    """Both LM kernels against their plain versions at the reference's test
    shapes (window, prefix, ragged, non-causal, grouped), f32 and bf16."""
    from repro_torch.kernels import LAUNCHES
    # The module (the package attribute of its name is the function).
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator("cuda").manual_seed(1)
    rand = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                      generator=gen)
    worst = {}
    smem_limit = getattr(torch.cuda.get_device_properties(0),
                         "shared_memory_per_block_optin", 232448)
    smem_max = 0
    for dtype, tdt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        tol = LM_TOL[dtype]
        for BH, BK, Sq, Sk, dh, causal, window, prefix in \
                FLASH_SHAPES + FLASH_DH96:
            q, k, v = (rand(*s).to(tdt) for s in
                       ((BH, Sq, dh), (BK, Sk, dh), (BK, Sk, dh)))
            kw = dict(causal=causal, window=window, prefix=prefix)
            n_tc = LAUNCHES["flash_attention_tc"]
            err, ok = allclose(fa.flash_attention_fwd(q, k, v, **kw),
                               fa.attention_plain(q, k, v, **kw),
                               tol["flash"])
            # bfloat16 (dh 64, 96 and 128) takes the tensor cores, float32
            # the CUDA-core kernel.
            tc = LAUNCHES["flash_attention_tc"] - n_tc
            worst[("flash", dtype)] = max(worst.get(("flash", dtype), 0), err)
            if not ok:
                fail(f"flash_attention {dtype} at {(BH, BK, Sq, Sk, dh)} "
                     f"{kw}: max abs err {err:.3e}")
            if tc != (tdt == torch.bfloat16):
                fail(f"flash_attention {dtype} at {(BH, BK, Sq, Sk, dh)} "
                     f"{kw}: {tc} tensor-core launches")
        for Bb, S, H, P, G, N, chunk in SSD_SHAPES + [SSD_LONG] + SSD_ODD:
            x = rand(Bb, S, H, P).to(tdt)
            dt = torch.rand(Bb, S, H, device="cuda", generator=gen) * 0.19 \
                + 0.01
            A = -(torch.rand(H, device="cuda", generator=gen) * 1.5 + 0.5)
            Bm, Cm = rand(Bb, S, G, N), rand(Bb, S, G, N)
            smem_max = max(smem_max, *ss.smem_bytes(tdt, P).values())
            if smem_max > smem_limit:
                fail(f"ssd_scan {dtype} P={P}: {smem_max} bytes of shared "
                     f"memory per block, the card allows {smem_limit}")
            y, st = ss.ssd_scan(x, dt, A, Bm, Cm, chunk)
            yr, sr = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
            e_y, ok_y = allclose(y, yr, tol["ssd"])
            e_s, ok_s = allclose(st, sr, STATE_TOL)
            worst[("ssd", dtype)] = max(worst.get(("ssd", dtype), 0), e_y, e_s)
            if not (ok_y and ok_s):
                fail(f"ssd_scan {dtype} at {(Bb, S, H, P, G, N, chunk)}: y "
                     f"{e_y:.3e}, state {e_s:.3e}")
    print("LM kernels vs plain at the reference's test shapes (flash: "
          "bfloat16 on the tensor-core route, float32 on the CUDA-core "
          f"kernel, also at dh 96: {FLASH_DH96}; SSD also at {SSD_LONG}, 32 "
          f"chunks, and {SSD_ODD}): "
          + ", ".join(
        f"{name} {dtype} max abs err {e:.3e}"
        for (name, dtype), e in sorted(worst.items()))
          + f" OK; SSD shared memory per block at most {smem_max} of "
          f"{smem_limit} bytes")


def moe_ffn_check(torch, np) -> None:
    """Layer 0's ``moe_ffn`` of each MoE smoke config on the card (the same
    weights and activations) against the CPU, float32 and bfloat16, on
    seeded activations whose every other token is pushed towards expert 0,
    which then drops entries past its capacity. First the kept (token,
    expert) entries of both: the experts are replaced by ones that write
    their index's unit vector (and the shared experts by zero), so a
    token's output is non-zero at dim e where its entry for expert e was
    kept; tokens whose entries differ (a router knife edge) are counted and
    printed, and left out of the output's comparison (float32: 1e-4 abs +
    rel; bfloat16: relative RMS 2e-2; aux 1e-5)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build
    from repro_torch.models import layers as ll

    def unit_experts(buf, p):
        n_exp, d = buf.shape[1], buf.shape[3]
        return torch.eye(n_exp, d, device=buf.device)[None, :, None, :] \
            .expand(buf.shape).to(buf.dtype)

    rms = lambda a: float(a.float().square().mean().sqrt())  # noqa: E731
    B, S = MOE_CHECK_SHAPE
    for arch in MOE_ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
            cpu = build(cfg, "cpu")
            cpu.init_weights(torch.Generator().manual_seed(0))
            gpu = build(cfg, "cuda")
            gpu.load_state_dict(cpu.state_dict())
            x = torch.from_numpy(np.random.default_rng(5).normal(
                size=(B, S, cfg.d_model)).astype(np.float32))
            x[:, ::2] += 3.0 * cpu.layers[0].ffn.router.detach()[:, 0]
            x = x.to(getattr(torch, dtype))
            layers = {"cpu": cpu.layers[0].ffn, "cuda": gpu.layers[0].ffn}
            kept, out = {}, {}
            swiglu, expert_swiglu = ll.swiglu, ll._expert_swiglu
            try:
                ll._expert_swiglu = unit_experts
                ll.swiglu = lambda h, p: torch.zeros_like(h)
                with torch.no_grad():
                    for dev, ffn in layers.items():
                        y, _ = ll.moe_ffn(x.to(dev), ffn, cfg)
                        kept[dev] = (y[..., :cfg.n_experts] != 0).cpu()
            finally:
                ll.swiglu, ll._expert_swiglu = swiglu, expert_swiglu
            with torch.no_grad():
                for dev, ffn in layers.items():
                    y, aux = ll.moe_ffn(x.to(dev), ffn, cfg)
                    out[dev] = (y.cpu(), float(aux))
            n_entries = B * S * cfg.top_k
            dropped = n_entries - int(kept["cpu"].sum())
            same = (kept["cpu"] == kept["cuda"]).all(-1)
            differ = torch.nonzero(~same).tolist()
            (y_c, aux_c), (y_g, aux_g) = out["cpu"], out["cuda"]
            if dtype == "float32":
                err, ok = allclose(y_g[same], y_c[same], 1e-4)
                bar = "1e-4 abs + rel"
            else:
                err = rms(y_g[same].float() - y_c[same].float()) \
                    / rms(y_c[same])
                ok, bar = err <= 2e-2, "relative RMS 2e-2"
            ok_aux = abs(aux_g - aux_c) <= 1e-5 * max(1.0, abs(aux_c))
            print(f"  moe_ffn {cfg.name} {dtype} ({B}, {S}, {cfg.d_model}), "
                  f"{cfg.n_experts} experts top-{cfg.top_k}: {dropped} of "
                  f"{n_entries} entries dropped on the CPU; kept entries "
                  f"differ at {len(differ)} tokens {differ[:8]}; output card "
                  f"vs CPU {err:.3e} ({bar}), aux {aux_g:.7f} vs {aux_c:.7f}"
                  f" {'OK' if ok and ok_aux else 'FAIL'}")
            if not 0 < dropped < n_entries:
                fail(f"moe_ffn {cfg.name}: {dropped} of {n_entries} entries "
                     "dropped checks no capacity drop")
            if len(differ) > B * S // 100:
                fail(f"moe_ffn {cfg.name} {dtype}: kept entries differ at "
                     f"{len(differ)} of {B * S} tokens")
            if not (ok and ok_aux):
                fail(f"moe_ffn {cfg.name} {dtype}: card off the CPU")


def lm_model_check(torch, np) -> None:
    """The smoke configs served on the card (kernels) against the same
    weights on the CPU (plain versions); the encoder-decoder's prefill on
    seeded frames, the vlm's on seeded patches (decoding after them)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import build

    rms = lambda a: float(a.float().square().mean().sqrt())  # noqa: E731
    for arch, *_ in SERVE:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
            cpu = build(cfg, "cpu")
            cpu.init_weights(torch.Generator().manual_seed(0))
            state = cpu.state_dict()
            gpu = build(cfg, "cuda")
            gpu.load_state_dict(state)
            rng = np.random.default_rng(1)
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (2, 40), dtype=np.int32))}
            if cfg.kind == "encdec":
                batch["frames"] = torch.from_numpy(rng.normal(
                    size=(2, 10, cfg.d_model)).astype(np.float32))
            patches = cfg.frontend_len if cfg.kind == "vlm" else 0
            if patches:
                batch["vision"] = SERVE_PATCHES_SCALE * torch.from_numpy(
                    rng.normal(size=(2, patches, cfg.d_model)).astype(
                        np.float32))
            # Prefill on both; then both decode from the CPU's cache: a
            # bfloat16 cache of a float32 model rounds keys 1e-6 apart to
            # neighbouring bfloat16 values (ROADMAP queue C), so the caches
            # are held to one bfloat16 ulp and the decode to its own bar.
            lg_c, cache_c = cpu.prefill(batch, max_len=48 + patches)
            lg_g, cache_g = gpu.prefill(
                {k: t.to("cuda") for k, t in batch.items()},
                max_len=48 + patches)
            for key, ref in cache_c.items():
                got = cache_g[key].cpu()
                if ref.dtype == torch.int32:
                    err, ok = float((got - ref).abs().max()), \
                        torch.equal(got, ref)
                elif dtype == "bfloat16":
                    err = rms(got.float() - ref.float()) / max(rms(ref),
                                                               1e-30)
                    ok = err <= 2e-2
                else:
                    d = (got.float() - ref.float()).abs()
                    rel = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 1e-4
                    err = float(d.max())
                    ok = bool((d <= 1e-4 + rel * ref.float().abs()).all())
                if not ok:
                    fail(f"{cfg.name} {dtype} prefill cache {key}: card off "
                         f"the CPU by {err:.3e}")
            nxt = batch["tokens"][:, 3:4]
            pos = 40 + cfg.n_meta_tokens + patches
            lg2_g, _ = gpu.decode({k: t.to("cuda", copy=True) for k, t in
                                   cache_c.items()}, nxt.to("cuda"), pos)
            lg2_c, _ = cpu.decode(cache_c, nxt, pos)
            print(f"  {cfg.name} {dtype} prefill cache ({', '.join(cache_c)})"
                  ", card vs CPU: OK (float32: 1e-4, bfloat16-stored values "
                  "one bfloat16 ulp; bfloat16: relative RMS 2e-2)")
            logits = [(lg_c, lg2_c), (lg_g.cpu(), lg2_g.cpu())]
            for step, (a, b) in zip(("prefill", "decode"), zip(*logits)):
                if dtype == "float32":
                    err, ok = allclose(b, a, 1e-4)
                    bar = "1e-4 abs + rel"
                else:
                    err = rms(b.float() - a.float()) / rms(a)
                    ok, bar = err <= 2e-2, "relative RMS 2e-2"
                print(f"  {cfg.name} {dtype} {step} logits, card vs CPU: "
                      f"{err:.3e} ({bar}) {'OK' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{cfg.name} {dtype} {step}: card off the CPU")
            if dtype == "float32":
                prompts = np.random.default_rng(2).integers(
                    0, cfg.vocab, (5, 24), dtype=np.int32)
                outs = [serve_requests(cfg, prompts, 2, 6, params=state,
                                       device=d)[0] for d in ("cpu", "cuda")]
                if not np.array_equal(*outs):
                    fail(f"{cfg.name}: greedy tokens on the card differ from "
                         f"the CPU's:\n{outs[1]}\n{outs[0]}")
                print(f"  {cfg.name} float32 serve: greedy tokens equal on "
                      f"the card and the CPU")


def tables_phase(torch, np, n_jobs: int, smi: str) -> dict:
    """Phase 8: paper Tables 2-5 (exp1-exp3) on the card, every check of
    the phase; returns each cost kernel's launches in the phase and its
    last launch's error against its plain version."""
    from repro_torch.obs import capture
    from repro_torch.core import run_jobs
    from repro_torch.experiments import common
    from repro_torch.experiments import exp1_spot_ondemand as exp1
    from repro_torch.experiments import exp2_self_owned as exp2
    from repro_torch.experiments import exp3_policy12 as exp3
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import policy_cost as pc

    # Each sweep's inputs, best policy and alpha (with exp1's proposed
    # unit costs for the knife-edge count), the engine's phase seconds and
    # the Greedy seconds; the inputs of each cost kernel's last launch.
    sweeps, engine_s, greedy_s, captured = [], {}, [0.0], {}
    plan_cached = [0]          # groups the sweeps took from the plan cache
    current = [""]
    sweep_fn, greedy_fn = common.sweep_policies, common.run_greedy
    kernel_fns = {n: getattr(pc, n) for n in ("policy_cost_chain",
                                              "policy_cost")}

    def sweep(jobs, policies, markets, r_total=0, **kw):
        pol, alpha, costs, res = sweep_fn(jobs, policies, markets, r_total,
                                          **kw)
        for key, v in res.timings.items():
            if isinstance(v, float):    # not the chunk list or the flag
                engine_s[key] = engine_s.get(key, 0.0) + v
        plan_cached[0] += res.timings["plan_cached"]
        proposed = current[0] == "exp1" and kw.get("windows", "dealloc") \
            == "dealloc"
        sweeps.append({"driver": current[0], "jobs": jobs,
                       # the drivers pass their setup's scenario source
                       "markets": getattr(markets, "markets", markets),
                       "policies": policies,
                       "r_total": r_total, "kw": kw, "policy": pol,
                       "alpha": alpha,
                       "unit_cost": res.unit_cost[0] if proposed else None})
        return pol, alpha, costs, res

    def greedy(*a, **k):
        t = time.perf_counter()
        out = greedy_fn(*a, **k)
        greedy_s[0] += time.perf_counter() - t
        return out

    def recorder(name):
        fn = kernel_fns[name]

        def wrapper(*a, **k):
            captured[name] = (a, k)
            return fn(*a, **k)
        return wrapper

    common.sweep_policies, common.run_greedy = sweep, greedy
    for name in kernel_fns:
        setattr(pc, name, recorder(name))
    types, rs = [1, 2, 3, 4], [300, 600, 900, 1200]
    print(f"CUT: paper Tables 2-5 at {n_jobs} jobs per stream (the "
          f"reference's benchmarks/common.py default; the paper's streams "
          f"hold ~10000), seed 0, S = 1, job types {types}, r {rs}")
    from torch.profiler import ProfilerActivity, profile
    walls = {}
    LAUNCHES.clear()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            capture() as reg:
        for label, call in (
                ("exp1", lambda: exp1.run(n_jobs, types, 0, 1, "cuda")),
                ("exp2", lambda: exp2.run(n_jobs, types, rs, 0, 1, "cuda")),
                ("exp3", lambda: exp3.run(n_jobs, types, rs, 0, 1, "cuda"))):
            current[0] = label
            t = time.perf_counter()
            walls[label] = (call(), time.perf_counter() - t)
        torch.cuda.synchronize()
    t_all = time.perf_counter() - t_all
    launches = dict(LAUNCHES)
    common.sweep_policies, common.run_greedy = sweep_fn, greedy_fn
    for name, fn in kernel_fns.items():
        setattr(pc, name, fn)

    for (label, (res, wall)), mod in zip(walls.items(), (exp1, exp2, exp3)):
        mod.print_rows(res)
        print(f"[{label}: {wall:.3f}s]")
    print(f"[phase tables: {t_all:.3f}s; engine "
          + " ".join(f"{k}={v:.3f}s" for k, v in engine_s.items())
          + f" over {len(sweeps)} sweeps ({plan_cached[0]} groups from the "
          f"plan cache); greedy={greedy_s[0]:.3f}s; launches {launches}]")
    # The busy share and the copies from torch.profiler; the cost kernels'
    # launches and device time from the launch capture.
    rows = device_breakdown(torch, prof, t_all)
    captured_ms = capture_report(rows, reg, launches, (
        "policy_cost_chain", "policy_cost_chain_smem", "policy_cost"), smi)
    for name in kernel_fns:
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched by paper Tables 2-5")

    # Every alpha of the tables is some sweep's best alpha (Greedy's only
    # through rho_vs_greedy).
    p_od = sweeps[0]["markets"][0].p_ondemand
    for w in sweeps:
        if not (math.isfinite(w["alpha"]) and 0.0 < w["alpha"] <= p_od):
            fail(f"Tables 2-5: a {w['driver']} sweep's alpha {w['alpha']} is "
                 f"not finite or outside (0, {p_od}]")
    for label, (res, _) in walls.items():
        for key, row in res.items():
            for name, v in row.items():
                if isinstance(v, float) and not math.isfinite(v):
                    fail(f"Tables 2-5: {label} {key} {name} = {v}")

    # Each sweep's best policy, realized on the host in float64.
    t = time.perf_counter()
    worst = 0.0
    for w in sweeps:
        kw = w["kw"]
        host = run_jobs(w["jobs"], w["policy"], w["markets"][0], w["r_total"],
                        windows=kw.get("windows", "dealloc"),
                        selfowned=kw.get("selfowned", "prop12"),
                        early_start=kw.get("early_start", True))
        gap = abs(w["alpha"] - host.average_unit_cost())
        worst = max(worst, gap)
        if gap > TABLE_TOL:
            fail(f"{w['driver']} sweep (r {w['r_total']}, {kw}): best policy "
                 f"{w['policy']} alpha {w['alpha']!r} on the card, "
                 f"{host.average_unit_cost()!r} by the host's run_jobs")
    print(f"best-policy alphas of all {len(sweeps)} sweeps vs the host's "
          f"float64 run_jobs: largest gap {worst:.3e} (tol {TABLE_TOL}) OK "
          f"[{time.perf_counter() - t:.3f}s]")

    # The knife-edge count: every (job, policy) unit cost of exp1's
    # proposed sweeps (r = 0: shared, dedicated and realized agree) against
    # the host's run_jobs.
    t = time.perf_counter()
    n_off = n_cells = 0
    gap_max = 0.0
    for w in (w for w in sweeps if w["unit_cost"] is not None):
        for p, pol in enumerate(w["policies"]):
            host = run_jobs(w["jobs"], pol, w["markets"][0], 0)
            unit = host.total_cost / np.maximum(host.workload, 1e-12)
            gap = np.abs(w["unit_cost"][:, p] - unit)
            n_off += int((gap > TABLE_TOL).sum())
            n_cells += gap.size
            gap_max = max(gap_max, float(gap.max()))
    print(f"knife edges: {n_off} of {n_cells} (job, policy) unit costs of "
          f"exp1's proposed sweeps leave the host's float64 run_jobs by more "
          f"than {TABLE_TOL}; largest gap {gap_max:.3e} "
          f"[{time.perf_counter() - t:.3f}s]")

    # The phase's last launch of each cost kernel against its plain version.
    errs = {}
    for name, plain, keys in (
            ("policy_cost_chain", pc.policy_cost_chain_plain, pc.OUT_KEYS),
            ("policy_cost", pc.policy_cost_plain, pc.OUT_KEYS + ("finish",))):
        a, k = captured[name]
        got, ref = kernel_fns[name](*a, **k), plain(*a, **k)
        equal = all(torch.equal(got[key], ref[key]) for key in keys)
        errs[name] = max(float((got[key].double() - ref[key].double())
                               .abs().max()) for key in keys)
        print(f"{name} at the phase's last launch ({tuple(a[0].shape)} A, "
              f"{tuple(a[3].shape)} ends) vs plain: max abs err "
              f"{errs[name]:.3e} {'OK' if equal else 'FAIL'} (bit-equal "
              "required)")
        if not equal:
            fail(f"{name}'s last launch of Tables 2-5 is not bit-equal to "
                 "its plain version")
    return {"launches": launches, "max_abs_err": errs,
            "device_ms": {k: e["device_ms"] for k, e in captured_ms.items()},
            "knife_edges": n_off, "cells": n_cells, "gap_max": gap_max,
            "plan_cached": plan_cached[0], "sweeps": len(sweeps)}


def small_learners(torch, np, Cs, arr, specs) -> None:
    """Phase 4's learners: every kind on the card against the float64 host
    loop on a small input. Traces identical; weights and chosen
    probabilities within HEDGE_TOL, the reference's bar, except exp3's,
    within EXP3_SMALL_TOL: its importance weight amplifies rounding, so
    that the reference's own float32 scan misses 1e-5 here too (ROADMAP
    queue C). The learner kernel's results also equal its plain version's
    on the CPU, bit for bit."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.learn import replay

    n_before = LAUNCHES["learner_replay"]
    lr_d = replay(Cs, arr, 3.0, learners=specs, seed=5, backend="torch",
                  device="cuda")
    launched = LAUNCHES["learner_replay"] - n_before
    lr_h = replay(Cs, arr, 3.0, learners=specs, seed=5, backend="numpy")
    lr_c = replay(Cs, arr, 3.0, learners=specs, seed=5, backend="torch",
                  device="cpu")
    J, P = Cs.shape[1:]
    lines, bad = [], []
    for k, sp in enumerate(specs):
        e_w = float(np.abs(lr_d.weights[:, k] - lr_h.weights[:, k]).max())
        e_p = float(np.abs(lr_d.p_chosen[:, k] - lr_h.p_chosen[:, k]).max())
        tol = EXP3_SMALL_TOL if sp.kind == "exp3" else HEDGE_TOL
        same = np.array_equal(lr_d.chosen[:, k], lr_h.chosen[:, k])
        plain = sp.kind == "hedge" or all(
            np.array_equal(getattr(lr_d, key)[:, k], getattr(lr_c, key)[:, k])
            for key in ("chosen", "p_chosen", "expected_unit", "weights"))
        lines.append(f"{sp.label} weights {e_w:.3e}, p_chosen {e_p:.3e} (tol "
                     f"{tol:.0e})")
        if not (same and plain and max(e_w, e_p) <= tol):
            bad.append(f"{sp.label}: chosen equal {same}, equal to the plain "
                       f"version {plain}, weights {e_w:.3e}, p_chosen "
                       f"{e_p:.3e} (tol {tol:.0e})")
    if bad or launched != 1:
        fail(f"learner replay off the float64 host loop ({launched} "
             f"learner_replay launches): " + "; ".join(bad))
    print(f"small input (2 x {J} jobs x {P} policies) vs the float64 host "
          f"loop: traces identical; " + "; ".join(lines) + "; the learner "
          "kernel bit for bit with its plain version on the CPU")


def host_draw(np, C, spec, u, ev_kind, ev_j, etas, gammas, j_star: int):
    """The float64 host loop (``_replay_numpy_one``'s arithmetic) up to the
    sample of job ``j_star``: that draw's margin min |cdf / total - u|, the
    argmin kinds' gap (second-lowest score minus the lowest, inf for the
    weights kinds), the state's largest magnitude (as the plain version's
    ``scale``) and the updates applied before it."""
    from repro_torch.learn.learners import (
        _NEG, init_state, sample_probs, update_state)
    from repro_torch.learn.replay import _sample_cdf
    m = C.shape[1]
    st = init_state(m)
    chosen, p_sel, n_done = {}, {}, 0
    for kind, j in zip(ev_kind, ev_j):
        if kind == 1:
            oh = np.where(np.arange(m) == chosen[j], 1.0, 0.0)
            st = update_state(spec.kind, st, C[j], oh, p_sel[j], etas[j])
            n_done += 1
            continue
        p = sample_probs(spec.kind, st, gammas[j])
        if j != j_star:
            chosen[j] = _sample_cdf(p, u[j])
            p_sel[j] = p[chosen[j]]
            continue
        cdf = np.cumsum(p)
        margin = float(np.abs(cdf / cdf[-1] - u[j]).min())
        if spec.kind in ("hedge", "exp3"):
            return margin, np.inf, float(np.abs(st["logw"]).max()), n_done
        counts, sums = st["counts"], st["sums"]
        cs = np.maximum(counts, 1.0)
        mean = sums / cs
        score, size = mean, np.abs(mean)
        if spec.kind == "ucb1":
            bonus = np.sqrt(2.0 * np.log(max(counts.sum(), 1.0)) / cs)
            score, size = mean - bonus, size + bonus
        untried = counts < 0.5
        score = np.where(untried, -_NEG, score)
        size = np.where(untried, 0.0, size)
        if spec.kind == "ftl":
            score, size = sums, np.abs(sums)
        low = np.sort(score)[:2]
        gap = float(low[-1] - low[0]) if m > 1 else np.inf
        return margin, gap, float(size.max()), n_done
    raise ValueError(f"job {j_star} has no sample event")


def plain_mismatches(kinds, got, ref) -> tuple[list, float]:
    """Every (kind, scenario, instance) whose trace or final state is not
    bit-equal between the kernel's outputs ``got`` and the plain
    version's ``ref``, and the largest absolute difference."""
    keys = ("chosen", "p_chosen", "expected_cost", "weights", "logw", "sums",
            "counts")
    bad, err = [], 0.0
    for kk, kind in enumerate(kinds):
        for s in range(got["chosen"].shape[0]):
            for key in keys:
                g_, r_ = got[key][s, kk], ref[key][s, kk]
                if not torch_equal(g_, r_):
                    bad.append(f"{kind} (s {s}, k {kk}) {key}")
                if key != "chosen" and g_.numel():
                    err = max(err, float((g_.double() - r_.double()).abs()
                                         .nan_to_num(0.0).max()))
    return bad, err


def torch_equal(a, b) -> bool:
    """Bit-equality of two tensors of one shape (-inf padding included)."""
    return a.shape == b.shape and bool((a == b).all())


def host_divergence(np, C, spec, u, ev_k, ev_j, eta, gam, got, host):
    """One comparison instance's trace ``got`` against the float64 host
    loop's ``host``: None where they agree, else the first divergence with
    its float64 margin and bound, the argmin kinds' gap and bound, and
    whether a float32 replay may part there (``ok``)."""
    from repro_torch.kernels import learner_replay as lk
    diff = np.nonzero(got != host)[0]
    if not len(diff):
        return None
    j = int(diff[0])
    mg, gp, sc, n_d = host_draw(np, C, spec, u, ev_k, ev_j, eta, gam, j)
    mb = lk.margin_bound(spec.kind, sc, C.shape[-1])
    row = {"job": j, "differ": int(len(diff)), "margin": mg,
           "margin_bound": mb, "scale": sc, "n_done": n_d}
    ok = mg <= mb < 1
    if spec.kind in ("ucb1", "egreedy", "ftl"):
        row["gap"], row["gap_bound"] = gp, lk.gap_bound(spec.kind, n_d, sc)
        ok = ok or 0 < gp <= row["gap_bound"]
    row["ok"] = ok
    return row






def learner_edge_streams(torch, np, learner_fn, last, arrivals,
                         d: float) -> list:
    """The learner kernel bit for bit against its plain version on short
    streams that take the handoff to its edges: d = 0 (every update right
    after its own sample: the pipeline runs as the serial walk), d past the
    arrival span (every sample before every update: one snapshot, read by
    all), both on the first EDGE_JOBS jobs of the last Table 6 launch, and
    Table 6's delay d over its arrival span at P 1024 (12 snapshot slots,
    so the ring wraps often) on a seeded cost tensor."""
    from repro_torch.kernels import learner_replay as lk
    from repro_torch.learn.replay import build_events

    (kinds, C, etas, gammas, u, *_), _ = last
    n = min(EDGE_JOBS, C.shape[1])
    arr = arrivals[:n]
    span = float(arr[-1] - arr[0])
    cut = lambda t: t[:, :n].contiguous()  # noqa: E731
    g = np.random.default_rng(EDGE_SEED)
    wide = torch.from_numpy((g.random((C.shape[0], n, 1024)) * 0.6
                             + np.linspace(0, 0.4, 1024)).astype(np.float32))
    cases = [("d = 0", cut(C), 0.0), ("samples first", cut(C), 2 * span),
             ("Table 6's d / span, P 1024", wide.to(C.device),
              d / float(arrivals[-1] - arrivals[0]) * span)]
    rows = []
    for label, Cc, d in cases:
        ev_k, ev_j, n_done = build_events(arr, d)
        ev = [torch.from_numpy(x).to(C.device) for x in (ev_k, ev_j)]
        a = (kinds, Cc, cut(etas), cut(gammas), cut(u), *ev)
        bad, err = plain_mismatches(kinds, learner_fn(*a),
                                    lk.learner_replay_plain(*a))
        lag = int((np.argsort(ev_j[ev_k == 1]) - n_done).max())
        rows.append({"stream": label, "J": n, "P": Cc.shape[-1],
                     "largest_lag": lag, "bit_equal": not bad,
                     "max_abs_err": err})
        print(f"learner_replay vs plain, {label} (J {n}, P {Cc.shape[-1]}, "
              f"largest lag {lag}): {'bit for bit' if not bad else bad[:4]}")
        if bad:
            fail(f"learner_replay not bit-equal to its plain version on the "
                 f"{label} stream: " + "; ".join(bad[:8]))
    return rows


def learner_checks(torch, np, learner_fn, calls, comparison, launches,
                   regs_of, lat_clocks) -> dict:
    """Phase 3's learner kernel checks: both main-path launches (r = 0,
    then r = 1200) bit for bit against the plain version on the card, the
    handoff's edge streams, every comparison instance against the float64
    host loop, a planted fault that both checks must catch, times, the
    bound and the update warp's dependency floor, and a time per kind;
    returns the kernel's entry."""
    from repro_torch.device import _library_path, _nvcc
    from repro_torch.kernels import learner_replay as lk
    from repro_torch.learn.replay import _replay_numpy_one, build_events
    from repro_torch.obs.compiled import work_bound

    def plain_run(a, k):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = lk.learner_replay_plain(*a, **k)
        end.record()
        end.synchronize()
        return ref, start.elapsed_time(end)

    shapes = []
    for a, k in calls:
        kinds, Cl, etas = a[:3]
        got = learner_fn(*a, **k)
        ref, plain_ms = plain_run(a, k)
        bad, err = plain_mismatches(kinds, got, ref)
        S, J, P = Cl.shape
        n_inst = {kind: S * list(kinds).count(kind) for kind in set(kinds)}
        print(f"learner_replay vs plain (P {P}): " + ", ".join(
            f"{kind} {n - sum(b.startswith(kind + ' ') for b in bad)} of {n}"
            for kind, n in sorted(n_inst.items()))
            + f" instances bit for bit (trace and final state); plain "
            f"{plain_ms:.1f} ms")
        if bad:
            fail(f"learner_replay (P {P}) not bit-equal to its plain "
                 "version: " + "; ".join(bad[:8]))
        shapes.append({"P": P, "plain_ms": plain_ms, "max_abs_err": err,
                       "vs_plain": {kind: {"instances": n, "bit_equal": n}
                                    for kind, n in sorted(n_inst.items())}})
    a, k = calls[-1]
    kinds, Cl, etas = a[:3]
    S, J, P = Cl.shape
    K = etas.shape[0]
    C64, arrivals, d, kw, lr = comparison       # the same replay's inputs
    ev_k, ev_jj, _ = build_events(arrivals, d)
    got = learner_fn(*a, **k)
    edges = learner_edge_streams(torch, np, learner_fn, calls[-1], arrivals,
                                 d)

    # Every comparison instance against the float64 host loop.
    specs = lr.specs
    m = C64.shape[-1]
    et = np.stack([sp.eta.values(arrivals, d, m) for sp in specs])
    ga = np.stack([sp.explore.values(arrivals, d, m) for sp in specs])
    seed = kw.get("seed", 0)
    uu = np.stack([np.random.default_rng(seed + s).random(len(arrivals))
                   for s in range(C64.shape[0])])
    t = time.perf_counter()
    host_rows = []
    for s in range(C64.shape[0]):
        for kk, sp in enumerate(specs):
            host = _replay_numpy_one(C64[s], sp, uu[s], ev_k, ev_jj, et[kk],
                                     ga[kk])[0]
            host_rows.append((s, sp.label, host_divergence(
                np, C64[s], sp, uu[s], ev_k, ev_jj, et[kk], ga[kk],
                lr.chosen[s, kk], host)))
    print(f"comparison instances vs the float64 host loop (r = 1200, "
          f"{C64.shape[0]} scenarios x {len(specs)} instances, J "
          f"{len(arrivals)}, P {m}) [{time.perf_counter() - t:.3f}s]:")
    for s, label, row in host_rows:
        gap = (f", gap {row['gap']:.3e} (bound {row['gap_bound']:.3e})"
               if row and "gap" in row else "")
        print(f"  s {s} {label}: " + ("identical trace" if row is None else
              f"first divergence at job {row['job']} ({row['differ']} draws "
              f"differ): float64 margin {row['margin']:.3e} (bound "
              f"{row['margin_bound']:.3e}){gap}, scale {row['scale']:.4g} "
              f"after {row['n_done']} updates "
              f"{'OK' if row['ok'] else 'FAIL'}"))
    off = [(s, label, row) for s, label, row in host_rows
           if row and not row["ok"]]
    if off:
        fail(f"{len(off)} comparison trace(s) leave the float64 host loop at "
             f"a draw above the bound: {off[:4]}")

    # A planted fault, chosen + 1 at the first draw of the first exp3
    # instance of scenario 0, must fail both checks.
    ke, kc = ([sp.kind for sp in specs].index("exp3"),
              list(kinds).index("exp3"))
    j0 = int(ev_jj[list(ev_k).index(0)])
    planted = {key: v.clone() for key, v in got.items()}
    planted["chosen"][0, kc, j0] = (planted["chosen"][0, kc, j0] + 1) % P
    caught_plain = bool(plain_mismatches(kinds, planted, ref)[0])
    trace = lr.chosen[0, ke].copy()
    trace[j0] = (trace[j0] + 1) % m
    host = _replay_numpy_one(C64[0], specs[ke], uu[0], ev_k, ev_jj, et[ke],
                             ga[ke])[0]
    row = host_divergence(np, C64[0], specs[ke], uu[0], ev_k, ev_jj, et[ke],
                          ga[ke], trace, host)
    caught_host = row is not None and not row["ok"]
    print(f"planted fault (chosen + 1 at job {j0}, s 0, {specs[ke].label}): "
          f"caught by the plain check {caught_plain}, by the host check "
          f"{caught_host} (margin {row['margin']:.3e}, bound "
          f"{row['margin_bound']:.3e})")
    if not (caught_plain and caught_host):
        fail("a planted fault in the learner trace passes the checks")
    del got, ref

    # Times and the bound (``learner_replay.learner_work``: each input read
    # once, each output written once, ``OPS_PER_JOB`` per instance, job and
    # policy).
    names = ("learner_block_kernel",)
    for sh, (a_, k_) in zip(shapes, calls):
        run = lambda: learner_fn(*a_, **k_)  # noqa: E731
        sh["ms"] = cuda_ms(torch, run)
        sh["device_ms"] = device_ms(torch, run, reps=5)
        sh["kernel_device_ms"] = pass_device_ms(torch, run, names).get(
            names[0])
        # One instance of each kind alone, the others' rows dropped.
        one = {}
        for kind in ("exp3", "ucb1", "egreedy", "ftl"):
            kk = list(a_[0]).index(kind)
            a1 = ([kind], a_[1], *(t[kk:kk + 1].contiguous()
                                   for t in a_[2:4]), *a_[4:])
            one[kind] = device_ms(torch, lambda: learner_fn(*a1), reps=5)
        sh["one_instance_device_ms"] = one
        print(f"learner_replay at P {sh['P']}: ms per call {sh['ms']:.4f}, "
              f"device {sh['device_ms']:.4f}, the kernel alone "
              f"{sh['kernel_device_ms']}; one instance of each kind: "
              + ", ".join(f"{x} {v:.4f}" for x, v in one.items()))
    b_ms, b_by = work_bound(lk.learner_work(kinds, S, J, P))
    nj = lk.lanes(P)
    # The update warp's exp3 step in the SASS: the loop-carried chain
    # through the REDUX of its max, at the probe's latencies, J times at
    # the card's maximum SM clock.
    lat, clocks = lat_clocks
    chain_ops, chain_cycles, n_closed = loop_chain(
        sass_lines(pathlib.Path(_nvcc()).parent / "cuobjdump",
                   _library_path("learner_replay"),
                   f"learner_block_kernelILi{nj}E"), lat)
    floor_ms = J * chain_cycles / (clocks["max_sm_mhz"] * 1e3) \
        if clocks["max_sm_mhz"] else None
    print(f"learner_replay update step in the SASS of learner_block_kernel"
          f"<{nj}>: {' '.join(chain_ops)}, {chain_cycles:.1f} cycles "
          f"({n_closed} loop-carried REDUX chain(s)); SM clock {clocks}: "
          f"dependency floor {floor_ms} ms over {J} updates; operations "
          f"bound {b_ms:.4f} ms")
    src = (pathlib.Path(__file__).resolve().parent / "src" / "repro_torch"
           / "kernels" / "csrc" / "learner_replay.cu").read_text()
    warps = int(re.search(r"kSampleWarps = (\d+);", src).group(1))
    r0, r1200 = shapes[0], shapes[-1]
    entry = {
        "name": "learner_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/learner_replay.cu",
        "replaces": "src/repro/learn/replay.py:119",
        "launches": launches["learner_replay"],
        "max_abs_err": max(sh["max_abs_err"] for sh in shapes),
        "ms": r1200["ms"], "plain_ms": r1200["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_ms": r1200["device_ms"],
        "kernel_device_ms": r1200["kernel_device_ms"],
        "dependency_floor_ms": floor_ms, "step_chain": chain_ops,
        "step_chain_cycles": chain_cycles, "latency_cycles": lat,
        "sm_clocks_mhz": clocks, "sample_warps": warps,
        "cost_row_read_bytes": 4 * S * K * J * P,
        "registers": {n: v for n, v in regs_of.items()
                      if n == f"learner_block_kernel<{nj}>"
                      or n == f"learner_block_kernel<{lk.lanes(r0['P'])}>"},
        "shape": {"S": S, "K": K, "J": J, "P": P, "nj": nj,
                  "kinds": list(kinds)},
        "launch_shapes": shapes, "edge_streams": edges,
        "vs_host_float64": [{"s": s, "learner": label, "first": row}
                            for s, label, row in host_rows]}
    print(f"learner_replay ({K} instances x {S} scenarios, J {J}, P {P}): ms "
          f"per call {entry['ms']:.3f}, device {entry['device_ms']:.3f}, "
          f"plain {r1200['plain_ms']:.1f}; bound {b_ms:.4f} ({b_by}); "
          f"dependency floor {floor_ms}; launches {entry['launches']}; "
          f"{warps} sample warps; registers {entry['registers']}")
    return entry




def fleet_phase(torch, np) -> None:
    """Phase 9: the fleet orchestrator on the card against the CPU, at the
    reference's system-test inputs (tests/test_system.py:50-80)."""
    from repro_torch.core import Policy
    from repro_torch.kernels import LAUNCHES
    from repro_torch.sched import FleetOrchestrator, FleetSpec, training_job_dag
    from repro_torch.sched import orchestrator

    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0, 30))
    jobs = [training_job_dag("llama3_8b", float(a), deadline_factor=2.0,
                             max_pods=8, cache=[]) for a in arrivals]
    fleet, horizon = FleetSpec(reserved_pods=4), float(arrivals[-1] + 50)
    card = FleetOrchestrator(fleet, horizon, device="cuda")
    host = FleetOrchestrator(fleet, horizon, device="cpu")
    LAUNCHES.clear()
    got = {learn: card.schedule(jobs, learn=learn) for learn in (True, False)}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    # Like with like: the card builds its plans in float32 ("auto"), so the
    # CPU side takes the same device plans (host float64 plans meet a knife
    # edge of this input, ROADMAP queue C).
    real_tola = orchestrator.run_tola
    orchestrator.run_tola = functools.partial(real_tola, plan_backend="device")
    try:
        want = {learn: host.schedule(jobs, learn=learn)
                for learn in (True, False)}
    finally:
        orchestrator.run_tola = real_tola
    worst = 0.0
    for learn in (True, False):
        g, w = dataclasses.asdict(got[learn]), dataclasses.asdict(want[learn])
        for key, v in g.items():
            if key == "best_policy":
                if v != w[key]:
                    fail(f"fleet schedule(learn={learn}): best policy {v} on "
                         f"the card, {w[key]} on the CPU")
                continue
            worst = max(worst, abs(v - w[key]))
            if not abs(v - w[key]) <= FLEET_TOL:
                fail(f"fleet schedule(learn={learn}) {key}: {v!r} on the "
                     f"card, {w[key]!r} on the CPU")
        print(f"fleet schedule(learn={learn}) on the card: unit cost "
              f"{got[learn].unit_cost:.6f}, spot / self-owned / on-demand "
              f"{got[learn].spot_fraction:.4f} / "
              f"{got[learn].selfowned_fraction:.4f} / "
              f"{got[learn].ondemand_fraction:.4f}, best policy "
              f"{got[learn].best_policy}, top weight "
              f"{got[learn].weights_top:.4f}")
    if launches.get("policy_cost_chain", 0) < 1:
        fail(f"the fleet orchestrator launched no chain kernel: {launches}")
    dag = training_job_dag("mamba2_2_7b", 0.0, max_pods=4, cache=[])
    pol = Policy(beta=0.625, bid=0.24, beta0=0.5)
    plans = [FleetOrchestrator(FleetSpec(reserved_pods=2), 200.0,
                               device=dv).stage_plan(dag, pol)
             for dv in ("cuda", "cpu")]
    same = all(np.array_equal(getattr(plans[0], f.name),
                              getattr(plans[1], f.name), equal_nan=True)
               for f in dataclasses.fields(plans[0]))
    sizes = plans[0].sizes[plans[0].mask]
    feasible = bool(np.all(sizes > 0)) and \
        plans[0].ends[0, plans[0].mask[0]][-1] <= dag.deadline + 1e-6
    if not (same and feasible):
        fail(f"fleet stage_plan: card equal to CPU {same}, feasible "
             f"{feasible}")
    print(f"fleet vs CPU (device plans on both): report fields within "
          f"{worst:.3e} (tol {FLEET_TOL}), best policies equal; stage_plan "
          f"bit for bit and feasible; launches {launches}")


def device_copies(torch, prof) -> tuple[float, float]:
    """Device busy ms and the pageable host-to-device copies' ms of a
    torch.profiler run."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    pageable = sum(e.self_device_time_total for e in rows
                   if "HtoD" in e.key and "Pageable" in e.key) / 1e3
    return busy, pageable


def fixed_alphas(unit_cost, Z):
    """(S, P) alpha of every fixed policy: unit costs weighted by workload
    (``TolaResult.fixed_unit_costs``)."""
    return (unit_cost * Z[None, :, None]).sum(axis=1) / Z.sum()


def counts_swap_gap(torch, np, jobs, policies, markets, r_total, dev_unit,
                    Z) -> float:
    """Largest fixed-alpha gap between device plans (``dev_unit``) and the
    host's float64 plan carrying the device plan's policy-(12) counts, on
    the card's cost kernels; prints how many counts the two plans set
    apart."""
    from repro_torch.engine import backend, build_grid_plan
    from repro_torch.engine.plan import _cloud_residuals
    from repro_torch.engine.scenarios import MarketListBatch
    from repro_torch.kernels.policy_cost import OUT_KEYS

    host = build_grid_plan(jobs, policies, r_total, n_scenarios=len(markets))
    card = build_grid_plan(jobs, policies, r_total, n_scenarios=len(markets),
                           plan_backend="device", device="cuda")
    moved, cells, swapped = 0, set(), []
    for gh, gd in zip(host.groups, card.groups):
        r = gd.r_alloc.double().cpu().numpy()
        if id(gh.r_alloc) not in cells:
            cells.add(id(gh.r_alloc))
            moved += int((r != gh.r_alloc)[gh.plan.mask].sum())
        z_t, d_eff, pins, so_w, so_r = _cloud_residuals(gh.plan, r)
        swapped.append(dataclasses.replace(
            gh, r_alloc=r, z_t=z_t, d_eff=d_eff, pins=pins,
            selfowned_work=so_w, selfowned_reserved=so_r))
    host.groups = swapped
    J, P, S = host.n_jobs, host.n_policies, len(markets)
    out = {k: np.zeros((S, J, P)) for k in OUT_KEYS}
    backend.run(host, MarketListBatch(markets, torch.device("cuda")), True,
                out)
    unit = (out["spot_cost"] + out["ondemand_cost"]) / \
        np.maximum(host.workload, 1e-12)[None, :, None]
    gap = float(np.abs(fixed_alphas(dev_unit, Z)
                       - fixed_alphas(unit, Z)).max())
    print(f"  policy-(12) counts set apart by the two plans: {moved} of "
          f"{len(cells) * int(host.groups[0].plan.mask.sum())} (cell, task) "
          f"pairs; with the device counts in the host plan, fixed alphas "
          f"within {gap:.3e}")
    return gap


def device_plan_phase(torch, np, n_jobs: int):
    """Phase 10: device plans against host plans on Table 6's round-0
    grids, the card's device plan against the CPU's, and Table 6 on the
    regime and adversarial market families. Returns Table 6's jobs and the
    groups (c)'s Table 6 runs took from the plan cache."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.engine as engine
    from repro_torch.core import (
        benchmark_bid_policies, selfowned_policies, spot_od_policies)
    from repro_torch.engine import (
        build_grid_plan, cache, clear_caches, evaluate_grid)
    from repro_torch.experiments import table6
    from repro_torch.experiments.common import make_setup
    from repro_torch.kernels import LAUNCHES

    setup = make_setup(n_jobs, 2, seed=0, scenarios=2, device="cuda")
    jobs, markets = setup.jobs, setup.markets
    Z = np.array([j.total_work for j in jobs])
    grid_of = {"spot_od": spot_od_policies(), "selfowned": selfowned_policies(),
               "bench": benchmark_bid_policies()}

    def grid_kw(r, even):
        return dict(r_total=r, windows="even", selfowned="naive",
                    early_start=False) if even else dict(r_total=r)

    # (a) host plans against device plans, each side under the profiler.
    # Both sides build: the plan cache is emptied of earlier phases'
    # groups (Table 6's round-0 plans among them), since the copies and
    # seconds printed are those of a build.
    clear_caches()
    out = {}
    for side in ("host", "device"):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out[side] = [evaluate_grid(jobs, grid_of[g], markets,
                                       plan_backend=side, device="cuda",
                                       **grid_kw(r, even))
                         for _, g, r, even in PLAN_GRIDS]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy, pageable = device_copies(torch, prof)
        for (label, *_), res in zip(PLAN_GRIDS, out[side]):
            t = res.timings
            print(f"{side} plans, {label}: plan {t['plan']:.3f}s pool "
                  f"{t['pool']:.3f}s views {t['views']:.3f}s eval "
                  f"{t['eval']:.3f}s plan_device {t['plan_device']:.3f}s")
        print(f"{side} plans, the three grids: {wall:.3f}s wall, device busy "
              f"{busy:.3f} ms, pageable host-to-device copies {pageable:.3f} "
              f"ms, idle share {1 - busy / (wall * 1e3):.6f}")
    count, worst = 0, 0.0
    for (label, g, r, even), h, d in zip(PLAN_GRIDS, out["host"],
                                         out["device"]):
        gap = np.abs(d.unit_cost - h.unit_cost)
        count += int((gap > PLAN_TOL).sum())
        worst = max(worst, float(gap.max()))
        fgap = float(np.abs(fixed_alphas(d.unit_cost, Z)
                            - fixed_alphas(h.unit_cost, Z)).max())
        print(f"{label}: fixed alphas, device vs host plans, max abs "
              f"{fgap:.3e}; unit costs more than {PLAN_TOL} apart "
              f"{int((gap > PLAN_TOL).sum())} of {gap.size}, largest "
              f"{float(gap.max()):.6e}")
        if r > 0 and not even:
            # Policy (12)'s counts: the device ceils with a 1e-5 epsilon and
            # snaps f(beta_0) to 0 below it, the host with 1e-9 (the
            # reference's two plan backends, ROADMAP queue C). Hold the
            # rest of the plan at the bar: the host's float64 plan with the
            # device's counts put in (residuals recomputed in float64).
            fgap = counts_swap_gap(torch, np, jobs, grid_of[g], markets, r,
                                   d.unit_cost, Z)
        if not fgap <= PLAN_TOL:
            fail(f"device plans move {label}'s fixed alphas by {fgap:.3e} "
                 f"from host plans (tol {PLAN_TOL})")
    print(f"device vs host plans: knife-edge count {count} unit costs more "
          f"than {PLAN_TOL} apart, largest gap {worst:.6e}")

    # (b) the card's device plan against the CPU's, bit for bit, query-free
    # and staged (one availability query per scenario).
    queries = [lambda s, e: np.full(s.shape, 900.0),
               lambda s, e: np.maximum(1200.0 - 0.1 * s, 0.0)]
    for label, avail in (("round 0", None), ("per-scenario queries", queries)):
        plans = {}
        for dv in ("cuda", "cpu"):
            t0 = time.perf_counter()
            # Built, not served from (a)'s cached groups: the cache is off.
            with cache.disabled():
                plans[dv] = build_grid_plan(
                    jobs, grid_of["selfowned"], 1200, availability=avail,
                    n_scenarios=2, plan_backend="device", device=dv)
            plans[dv + "_s"] = time.perf_counter() - t0
        bad = []
        for gi, (gc, gh) in enumerate(zip(plans["cuda"].groups,
                                          plans["cpu"].groups)):
            for f in PLAN_FIELDS:
                src = (gc.plan, gh.plan) if f in ("starts", "ends") \
                    else (gc, gh)
                a, b = (getattr(x, f) for x in src)
                if not (a.device.type == "cuda" and
                        torch.equal(a.cpu(), b)):
                    bad.append((gi, f))
            if not (np.array_equal(gc.selfowned_work, gh.selfowned_work)
                    and np.array_equal(gc.selfowned_reserved,
                                       gh.selfowned_reserved)):
                bad.append((gi, "self-owned sums"))
        print(f"device plan of the proposed r=1200 grid ({label}, "
              f"{len(plans['cuda'].groups)} groups), card vs CPU: "
              f"{'bit for bit' if not bad else 'DIFFERENT ' + str(bad[:6])}; "
              f"build {plans['cuda_s']:.3f}s on the card, "
              f"{plans['cpu_s']:.3f}s on the CPU")
        if bad:
            fail(f"the device plan differs between the card and the CPU "
                 f"({label}): {bad[:6]}")

    # (c) Table 6 on the other materialized families, on a cut stream; the
    # groups its calls take from the plan cache are summed.
    p_od = markets[0].p_ondemand
    cached, eval_fn = [0], engine.evaluate_grid

    def counted(*a, **k):
        res = eval_fn(*a, **k)
        cached[0] += res.timings["plan_cached"]
        return res
    print(f"CUT: Table 6 on the {' and '.join(PLAN_FAMILIES)} families at "
          f"{PLAN_FAMILY_JOBS} jobs (the Table 6 stream above: {n_jobs}), "
          f"for the script's time limit")
    for kind in PLAN_FAMILIES:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        before = cached[0]
        engine.evaluate_grid = counted
        try:
            res = table6.run(PLAN_FAMILY_JOBS, [0, 1200], seed=0,
                             scenarios=2, device="cuda", scenario_kind=kind)
        finally:
            engine.evaluate_grid = eval_fn
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        print(f"Table 6 on --scenario-kind {kind}: "
              f"{time.perf_counter() - t0:.3f}s; launches {launches}; "
              f"{cached[0] - before} groups from the plan cache; plan "
              "seconds (round 0 and the refinement round) " + ", ".join(
                  f"r={r} {leg} {res[r]['timings'][leg]['plan']:.3f}"
                  for r in (0, 1200) for leg in ("proposed", "benchmark")))
        table6.print_tables(res)
        for name in ("policy_cost_chain", "policy_cost"):
            if launches.get(name, 0) < 1:
                fail(f"Table 6 on {kind} markets launched no {name}")
        for r in (0, 1200):
            for key in ("alpha_tola", "alpha_bench", "best_fixed"):
                v = res[r][key]
                if not (math.isfinite(v) and 0.0 < v <= p_od):
                    fail(f"Table 6 on {kind} markets, r={r}: {key} {v} not "
                         f"finite in (0, {p_od}]")
    return jobs, cached[0]


def ulp_gap(np, a, b) -> int:
    """Largest distance in float32 ulps between two float32 arrays."""
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return int(np.abs(a - b).max())


def synth_check(torch, np, spec, s0: int, s1: int, bids, periods=None,
                offsets=None) -> dict:
    """One chunk of ``spec`` synthesized on the card against the host: the
    levels and spike mask bit for bit with the host's, availability of
    every bid equal to the float64 views', A bit for bit with the same
    function on the CPU (on the card's levels), and C's gap from the host
    float64 views beside the gap a float32 running sum leaves (per bid)."""
    from repro_torch.core.market import stacked_view_arrays
    from repro_torch.engine import SynthBatch
    from repro_torch.engine import scenarios as sc

    batch = SynthBatch(spec, s0, s1, "cuda", periods=periods,
                       offsets=offsets).prepare()
    h, price, spike = batch._parts
    idx = np.arange(s0, s1)
    host_p = spec.prices(s0, s1, periods, offsets)
    want_spike = spec.spike_mask(s0, s1, periods, offsets) \
        if spec.kind in ("adversarial", "adaptive") \
        else np.zeros(host_p.shape, bool)
    bad = []
    if not np.array_equal(h.cpu().numpy(),
                          sc._levels(spec.seed, 0, idx, spec.n_slots)):
        bad.append("levels")
    if not np.array_equal(spike.cpu().numpy(), want_spike):
        bad.append("spike mask")
    parts_cpu = [t.cpu() for t in (h, price, spike)]
    c_gap, c32_gap = {}, {}
    for bid in bids:
        A, C = batch.stacked(bid)
        avail = host_p <= bid + 1e-12
        if not np.array_equal((A[:, 1:] > A[:, :-1]).cpu().numpy(), avail):
            bad.append(f"availability at bid {bid}")
        clears = spec.price_hi <= bid + 1e-12
        th = torch.from_numpy(spec.thresholds(bid, idx))
        A_cpu, _ = sc._device_views(*parts_cpu, th, clears, spec.slot)
        if not torch.equal(A.cpu(), A_cpu):
            bad.append(f"A at bid {bid} (card vs CPU)")
        _, C64 = stacked_view_arrays(host_p, avail, spec.slot)
        c_gap[bid] = float(np.abs(C.cpu().double().numpy() - C64).max())
        # The route the port does not take: the reference's float32
        # running sum, here on the card.
        step = torch.where(A[:, 1:] > A[:, :-1], price * spec.slot,
                           torch.zeros((), device=price.device))
        C32 = torch.cumsum(step, -1)
        c32_gap[bid] = float(np.abs(C32.cpu().double().numpy()
                                    - C64[:, 1:]).max())
    ulps = ulp_gap(np, price.cpu().numpy(), host_p.astype(np.float32))
    return {"bad": bad, "c_gap": c_gap, "c32_gap": c32_gap, "ulps": ulps}


def stream_phase(torch, np, jobs) -> dict:
    """Phase 11: ScenarioSpec synthesis on the card, streamed evaluation,
    replay_stream and the adaptive adversary on Table 6's stream, and the
    Table 6 driver's streamed rows. Returns the kernels' launches in (c)'s
    r = 1200 stream."""
    from repro_torch.core import selfowned_policies, spot_od_policies
    from repro_torch.engine import ScenarioSpec, ScenarioStream, evaluate_grid
    from repro_torch.experiments import table6
    from repro_torch.kernels import LAUNCHES
    from repro_torch.learn import replay, replay_stream

    horizon = max(j.deadline for j in jobs) + 1.0
    arrivals = np.array([j.arrival for j in jobs])
    d = max(j.deadline - j.arrival for j in jobs)
    Z = np.array([j.total_work for j in jobs])
    grids = {1200: selfowned_policies(), 0: spot_od_policies()}
    bids = sorted({p.bid for g in grids.values() for p in g})
    specs = table6.comparison_specs(LEARNERS, ETA_GRID)
    K = STREAM_CHUNK

    def spec(kind, S):
        return ScenarioSpec(kind, horizon, S, seed=STREAM_SEED)

    # (a) synthesis of each generative kind, and adaptive chunks with
    # explicit periods and offsets, against the host.
    t0 = time.perf_counter()
    S = STREAM_S["synth"]
    menu = spec("adaptive", S).period_menu()
    cases = [(k, spec(k, S), 0, S, None, None)
             for k in ("fresh", "regime", "adversarial")]
    cases += [("adaptive", spec("adaptive", S), s0, s0 + K,
               menu[(np.arange(K) + s0) % len(menu)],
               np.where(np.arange(K) % 3 == 0, -1, 7 * np.arange(K) + s0))
              for s0 in (0, S - K)]
    for label, sp, s0, s1, periods, offsets in cases:
        got = synth_check(torch, np, sp, s0, s1, bids + [1.0], periods,
                          offsets)
        grid_gap = max(got["c_gap"][b] for b in bids)
        print(f"synthesis {label} [{s0}, {s1}) x {sp.n_slots} slots: levels, "
              f"spikes, availability at {len(bids) + 1} bids and A "
              f"{'bit for bit' if not got['bad'] else got['bad']}; prices "
              f"within {got['ulps']} float32 ulps of the host's rounded; C "
              f"vs host float64 views max {grid_gap:.3e} over the grids' "
              f"bids (a float32 running sum: "
              f"{max(got['c32_gap'][b] for b in bids):.3e}), at bid 1.0 "
              f"{got['c_gap'][1.0]:.3e} (float32 running sum "
              f"{got['c32_gap'][1.0]:.3e})")
        if got["bad"]:
            fail(f"ScenarioSpec synthesis ({label}) differs from the host: "
                 f"{got['bad']}")
        if not grid_gap <= STREAM_C_TOL:
            fail(f"synthesized C ({label}) leaves the host views by "
                 f"{grid_gap:.3e} (tol {STREAM_C_TOL})")
    print(f"[stream (a) synthesis: {time.perf_counter() - t0:.3f}s]")

    # (b) streamed evaluation at r = 1200 against one pass and against the
    # materialized list path.
    t0 = time.perf_counter()
    sp16 = spec("fresh", STREAM_S["eval"])
    run = functools.partial(evaluate_grid, jobs, grids[1200], sp16, 1200,
                            device="cuda")
    LAUNCHES.clear()
    chunked = run(scenario_chunk=K)
    torch.cuda.synchronize()
    n_chain = LAUNCHES["policy_cost_chain"]
    serial = run(scenario_chunk=K, overlap=False)
    whole = run()
    keys = ("unit_cost", "spot_cost", "ondemand_cost", "spot_work",
            "ondemand_work")
    same = all(np.array_equal(getattr(x, k), getattr(whole, k))
               for x in (chunked, serial) for k in keys)
    for label, r_ in (("overlap", chunked), ("serial", serial),
                      ("one pass", whole)):
        t = r_.timings
        print(f"streamed eval ({label}, chunk "
              f"{K if r_ is not whole else sp16.n_scenarios}): synth "
              f"{t['synth']:.4f}s views {t['views']:.4f}s eval "
              f"{t['eval']:.3f}s plan {t['plan']:.3f}s pool {t['pool']:.3f}s "
              f"overlap {t['overlap']}")
    print(f"chunk {K} vs one pass, S = {sp16.n_scenarios}, r = 1200: "
          f"{'bit for bit' if same else 'DIFFERENT'}; chain launches in the "
          f"chunked run {n_chain}")
    if not same:
        fail("scenario_chunk=8 differs from one pass on the card")
    if n_chain != -(-sp16.n_scenarios // K):
        fail(f"the chunked evaluation launched the chain kernel {n_chain} "
             f"times, not once per chunk")
    mat = evaluate_grid(jobs, grids[1200], sp16.materialize(), 1200,
                        device="cuda")
    fgap = float(np.abs(fixed_alphas(chunked.unit_cost, Z)
                        - fixed_alphas(mat.unit_cost, Z)).max())
    gap = np.abs(chunked.unit_cost - mat.unit_cost)
    print(f"streamed spec vs its materialized list: fixed alphas max abs "
          f"{fgap:.3e} (tol {PLAN_TOL}); unit costs more than {PLAN_TOL} "
          f"apart {int((gap > PLAN_TOL).sum())} of {gap.size}, largest "
          f"{float(gap.max()):.6e}")
    if not fgap <= PLAN_TOL:
        fail(f"streamed fixed alphas leave the materialized list path by "
             f"{fgap:.3e}")
    mean = run(scenario_chunk=K, reduce="mean")
    want = whole.unit_cost.mean(axis=0)
    diff = np.abs(mean.unit_cost[0] - want)
    rel = float((diff / np.maximum(np.abs(want), 1e-300)).max())
    print(f"reduce='mean' vs the stacked mean: max rel {rel:.3e} (rtol "
          f"{STREAM_MEAN_RTOL}; {int((want == 0).sum())} cells of mean "
          f"0)")
    if not np.all(diff <= STREAM_MEAN_RTOL * np.abs(want)):
        fail(f"reduce='mean' leaves the stacked mean by {rel:.3e}")
    del chunked, serial, whole, mat, mean, gap
    print(f"[stream (b) evaluation: {time.perf_counter() - t0:.3f}s]")

    # (c) replay_stream of exp4's 21 instances, against the monolithic
    # replay at S = 16.
    t0 = time.perf_counter()
    stream_launches = {}
    for r in (1200, 0):
        LAUNCHES.clear()
        t = time.perf_counter()
        slr = replay_stream(jobs, grids[r], spec("fresh", STREAM_S["replay"]),
                            r, learners=specs, seed=0, scenario_chunk=K,
                            device="cuda")
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        n_chunks = -(-STREAM_S["replay"] // K)
        print(f"replay_stream r={r}, S = {STREAM_S['replay']} in chunks of "
              f"{K}, {len(specs)} instances: {time.perf_counter() - t:.3f}s; "
              f"launches {launches}")
        for name in ("policy_cost_chain", "hedge_replay", "learner_replay"):
            if launches.get(name, 0) != n_chunks:
                fail(f"replay_stream r={r} launched {name} "
                     f"{launches.get(name, 0)} times, not once per chunk")
        if r == 1200:
            stream_launches = launches
        for row in slr.summary()[:1] + slr.summary()[-3:]:
            print(f"  {row['learner']}: alpha_cf {row['realized_unit']:.6f} "
                  f"regret {row['regret']:.6f}")
        sp = spec("fresh", STREAM_S["eval"])
        slr = replay_stream(jobs, grids[r], sp, r, learners=specs, seed=0,
                            scenario_chunk=K, device="cuda")
        res = evaluate_grid(jobs, grids[r], sp, r, device="cuda")
        lr = replay(res.unit_cost, arrivals, d, workload=Z, learners=specs,
                    seed=0, device="cuda")
        want_r = lr.realized_unit().mean(axis=0)
        want_g = lr.regret_per_job().mean(axis=0)
        rel_r = float((np.abs(slr.realized_unit() - want_r)
                       / np.abs(want_r)).max())
        ok_g = np.all(np.abs(slr.regret_per_job() - want_g)
                      <= 1e-13 + STREAM_REGRET_RTOL * np.abs(want_g))
        print(f"replay_stream vs the monolithic replay, S = {sp.n_scenarios},"
              f" r={r}: realized max rel {rel_r:.3e} (rtol "
              f"{STREAM_REALIZED_RTOL}), regret max abs "
              f"{float(np.abs(slr.regret_per_job() - want_g).max()):.3e} "
              f"(rtol {STREAM_REGRET_RTOL}) {'OK' if ok_g else 'FAIL'}")
        if not (rel_r <= STREAM_REALIZED_RTOL and ok_g):
            fail(f"replay_stream r={r} leaves the monolithic replay")
        del res, lr
    print(f"[stream (c) replay_stream: {time.perf_counter() - t0:.3f}s]")

    # (d) the adaptive adversary against the fixed adversarial family.
    t0 = time.perf_counter()
    regret = {}
    for kind in ("adversarial", "adaptive"):
        stream = ScenarioStream(spec(kind, STREAM_S["adaptive"]))
        slr = replay_stream(jobs, grids[1200], stream, 1200, learners=specs,
                            seed=0, scenario_chunk=K, device="cuda")
        regret[kind] = slr.summary()[0]["regret"]
    print(f"Hedge regret at r = 1200, S = {STREAM_S['adaptive']}: adaptive "
          f"{regret['adaptive']:.6f}, fixed adversarial "
          f"{regret['adversarial']:.6f}; the adaptive stream ended "
          f"{stream.stage!r}, locked period "
          f"{stream._menu[stream._locked_period]:.4f}")
    if stream.stage != "locked":
        fail(f"the adaptive stream ended {stream.stage!r}, not 'locked'")
    bad = []
    for ci, (periods, offsets) in enumerate(zip(stream.chunk_periods,
                                                stream.chunk_offsets)):
        got = synth_check(torch, np, stream.spec, ci * K, (ci + 1) * K, bids,
                          periods, offsets)
        bad += [(ci, b) for b in got["bad"]]
    print(f"the adaptive stream's {len(stream.chunk_periods)} issued chunks "
          f"rebuilt: availability host vs card "
          f"{'equal' if not bad else bad[:4]}")
    if bad:
        fail(f"the adaptive stream's chunks differ on the card: {bad[:4]}")
    print(f"[stream (d) adaptive adversary: {time.perf_counter() - t0:.3f}s]")

    # (e) the Table 6 driver on the adaptive family.
    t0 = time.perf_counter()
    print(f"CUT: Table 6 with --scenario-kind adaptive at "
          f"{STREAM_DRIVER_JOBS} jobs (TOLA's realized replay over 16 "
          f"materialized markets is host-bound), r = 0, S = 16, chunk {K}")
    LAUNCHES.clear()
    res = table6.run(STREAM_DRIVER_JOBS, [0], seed=0, scenarios=16,
                     device="cuda", scenario_kind="adaptive",
                     scenario_chunk=K)
    torch.cuda.synchronize()
    table6.print_tables(res)
    rows = res[0].get("stream", [])
    if not rows or not all(math.isfinite(row[k]) for row in rows
                           for k in ("realized_unit", "regret")):
        fail(f"Table 6 printed no finite streamed rows: {rows}")
    if LAUNCHES["policy_cost_chain"] < 1:
        fail("Table 6 on the adaptive family launched no chain kernel")
    print(f"[stream (e) driver: {time.perf_counter() - t0:.3f}s; launches "
          f"{dict(LAUNCHES)}]")
    return stream_launches


def rebid(grid, every: int):
    """``benchmarks/bench_pipeline.py``'s re-bid: every ``every``-th
    policy's bid moved to bid * 1.01 + 1e-4 * (k + 1)."""
    out = list(grid)
    for k, i in enumerate(range(0, len(grid), every)):
        out[i] = dataclasses.replace(grid[i],
                                     bid=grid[i].bid * 1.01 + 1e-4 * (k + 1))
    return out


def cache_phase(torch, np, jobs) -> dict:
    """Phase 12: the cross-call plan and view caches and delta evaluation
    on Table 6's stream. Returns the kernels' launches in the phase."""
    from repro_torch.core import selfowned_policies
    from repro_torch.engine import (
        ScenarioSpec, cache, clear_caches, evaluate_grid, evaluate_grid_delta)
    from repro_torch.engine import plan as plan_mod
    from repro_torch.kernels import LAUNCHES

    clear_caches()
    horizon = max(j.deadline for j in jobs) + 1.0
    spec = ScenarioSpec("fresh", horizon, STREAM_S["eval"], seed=STREAM_SEED)
    K = STREAM_CHUNK
    grid = selfowned_policies()
    n_groups = len(plan_mod._grid_structure(grid, 1200, "dealloc").g_bid)
    n_views = -(-spec.n_scenarios // K) * len({round(p.bid, 12)
                                                for p in grid})
    fields = ("unit_cost", "spot_cost", "ondemand_cost", "selfowned_work",
              "spot_work", "ondemand_work", "selfowned_reserved")
    phase_launches: dict = {}
    device_plans, plan_passes = plan_mod._device_plans, [0]

    def counted_plans(*a, **k):
        plan_passes[0] += 1
        return device_plans(*a, **k)

    def timed(fn, *a, **k):
        """(result, wall, chain launches, device plan passes) of a call."""
        LAUNCHES.clear()
        plan_passes[0] = 0
        t = time.perf_counter()
        res = fn(*a, **k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for name, n in LAUNCHES.items():
            phase_launches[name] = phase_launches.get(name, 0) + n
        return res, wall, LAUNCHES.get("policy_cost_chain", 0), plan_passes[0]

    def grid_run(g, **kw):
        return timed(evaluate_grid, jobs, g, spec, 1200, scenario_chunk=K,
                     device="cuda", **kw)

    def same(a, b) -> bool:
        return all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in fields)

    def phases(res) -> str:
        t = res.timings
        return (f"plan {t['plan']:.4f}s pool {t['pool']:.4f}s views "
                f"{t['views']:.4f}s eval {t['eval']:.3f}s")

    plan_mod._device_plans = counted_plans
    try:
        # (a) and (b): cold, warm and cache-off runs, device then host plans.
        for label, backend in (("(a) device plans", "auto"),
                               ("(b) host plans", "host")):
            t0 = time.perf_counter()
            v0 = cache.VIEW_CACHE.cache_info()
            p0 = len(cache.PLAN_CACHE)
            cold = grid_run(grid, plan_backend=backend)
            v1 = cache.VIEW_CACHE.cache_info()
            warm = grid_run(grid, plan_backend=backend)
            v2 = cache.VIEW_CACHE.cache_info()
            with cache.disabled():
                off = grid_run(grid, plan_backend=backend)
            for name, (res, wall, chain, passes) in (
                    ("cold", cold), ("warm", warm), ("off", off)):
                print(f"{label}, {name}: {wall:.3f}s wall; {phases(res)}; "
                      f"plan_cached {res.timings['plan_cached']}; chain "
                      f"launches {chain}; device plan passes {passes}")
            print(f"{label}: view cache {v0} -> {v1} (cold) -> {v2} (warm); "
                  f"plan cache {p0} -> {len(cache.PLAN_CACHE)} entries")
            ok = same(cold[0], warm[0]) and same(cold[0], off[0])
            print(f"{label}: cold, warm and cache-off results "
                  f"{'bit for bit' if ok else 'DIFFERENT'}")
            if not ok:
                fail(f"phase 12 {label}: the warm or cache-off result differs "
                     f"from the cold one")
            got = warm[0].timings["plan_cached"]
            if not (got == n_groups == CACHE_GROUPS
                    and len(cache.PLAN_CACHE) - p0 == n_groups):
                fail(f"phase 12 {label}: the warm run took {got} groups from "
                     f"the plan cache, which gained "
                     f"{len(cache.PLAN_CACHE) - p0}; the grid has {n_groups} "
                     f"(expected {CACHE_GROUPS})")
            if cold[0].timings["plan_cached"] or off[0].timings["plan_cached"]:
                fail(f"phase 12 {label}: a cold or cache-off run took groups "
                     f"from the plan cache")
            if backend == "auto" and (v1.misses - v0.misses != n_views
                                      or v2.hits - v1.hits != n_views
                                      or v2.misses != v1.misses):
                fail(f"phase 12 {label}: view cache {v0} -> {v1} -> {v2}, "
                     f"not one miss, then one hit, per (chunk, bid) "
                     f"({n_views})")
            if backend == "auto" and (warm[3] != 0 or cold[3] < 1):
                fail(f"phase 12 {label}: device plan passes cold {cold[3]}, "
                     f"warm {warm[3]} (expected at least 1, then 0)")
            if not cold[2] >= 1 or warm[2] != cold[2] or off[2] != cold[2]:
                fail(f"phase 12 {label}: chain launches cold {cold[2]}, warm "
                     f"{warm[2]}, off {off[2]}")
            if backend == "auto":
                prev = warm[0]         # (c)'s delta starts from it
            del cold, warm, off
            print(f"[cache {label}: {time.perf_counter() - t0:.3f}s]")

        # (c) delta evaluation against (a)'s warm result.
        t0 = time.perf_counter()
        grid2 = rebid(grid, CACHE_REBID)
        full, full_s, full_chain, _ = grid_run(grid2)
        delta, delta_s, delta_chain, _ = timed(
            evaluate_grid_delta, prev, jobs, grid2, spec, 1200,
            scenario_chunk=K)
        n = delta.timings["delta_groups_rescored"]
        total = delta.timings["delta_groups_total"]
        ok = same(delta, full)
        print(f"(c) every {CACHE_REBID}th policy re-bid: full re-evaluation "
              f"{full_s:.3f}s ({full_chain} chain launches, plan_cached "
              f"{full.timings['plan_cached']}); evaluate_grid_delta "
              f"{delta_s:.3f}s ({delta_chain} chain launches), {n} of {total} "
              f"groups re-scored; {'bit for bit' if ok else 'DIFFERENT'}")
        if not ok:
            fail("phase 12 (c): the delta result differs from the full "
                 "re-evaluation")
        if not 0 < n <= CACHE_MAX_RESCORED < total:
            fail(f"phase 12 (c): {n} of {total} groups re-scored (expected "
                 f"1 to {CACHE_MAX_RESCORED})")
        del full, prev
        again, again_s, again_chain, _ = timed(
            evaluate_grid_delta, delta, jobs, grid2, spec, 1200,
            scenario_chunk=K)
        ok = same(again, delta)
        print(f"(c) delta with no change: {again_s:.3f}s, "
              f"{again.timings['delta_groups_rescored']} groups re-scored, "
              f"{again_chain} chain launches; "
              f"{'bit for bit' if ok else 'DIFFERENT'} with its prev")
        if again.timings["delta_groups_rescored"] != 0 or again_chain != 0 \
                or not ok:
            fail("phase 12 (c): a delta with no change re-scored, launched "
                 "or moved something")
        del again
        # The chained delta builds only its missing groups on the card (a
        # subset of the grid's window plans and cells); the cache-off full
        # re-evaluation builds the whole grid.
        grid3 = rebid(grid2, CACHE_CHAIN_REBID)
        chained, chained_s, chained_chain, passes = timed(
            evaluate_grid_delta, delta, jobs, grid3, spec, 1200,
            scenario_chunk=K)
        with cache.disabled():
            full3, full3_s, full3_chain, _ = grid_run(grid3)
        ok = same(chained, full3)
        print(f"(c) chained delta (every {CACHE_CHAIN_REBID}th policy re-bid "
              f"again): {chained_s:.3f}s, "
              f"{chained.timings['delta_groups_rescored']} of "
              f"{chained.timings['delta_groups_total']} groups re-scored, "
              f"{chained_chain} chain launches, {passes} device plan pass(es) "
              f"over the missing groups; cache-off full re-evaluation "
              f"{full3_s:.3f}s ({full3_chain} chain launches); "
              f"{'bit for bit' if ok else 'DIFFERENT'}")
        if not ok or chained.timings["delta_groups_rescored"] < 1 \
                or passes < 1:
            fail("phase 12 (c): the chained delta differs from the cache-off "
                 "full re-evaluation, or built no missing group")
        del delta, chained, full3
        print(f"[cache (c) delta: {time.perf_counter() - t0:.3f}s]")
    finally:
        plan_mod._device_plans = device_plans
    return phase_launches


def fold(xs) -> float:
    """Left-to-right float sum (the tracer's totals fold the same way;
    Python 3.12's ``sum()`` of floats is compensated and may differ)."""
    total = 0.0
    for x in xs:
        total += x
    return total


def per_op_seconds(fn, reps: int) -> float:
    """Host seconds per call of ``fn`` over ``reps`` calls."""
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps


def obs_phase(torch, np, jobs, smi: str, phase3: dict) -> dict:
    """Phase 13: the observability layer on the card. (a) The proposed
    r = 1200 round-0 grid on phase 12's spec, untraced and under
    ``observe(programs=True)``: bit for bit, timings equal to the spans,
    captured launches equal to the launch counters, the Chrome trace
    written; (b) ``replay_stream`` on the adaptive family and one re-bid
    delta under ``observe()``: the escalation, cache and delta counters
    against the stream's stage history, ``cache_info()`` and the delta's
    timings; (c) tinyllama-1.1b's serve captured; (d) the overhead of spans
    and capture, measured directly; (e) no kernel built. Returns the
    captured device ms and launches by kernel."""
    import collections

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import selfowned_policies
    from repro_torch.engine import (
        ScenarioSpec, ScenarioStream, cache, evaluate_grid,
        evaluate_grid_delta)
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import policy_cost as pc
    from repro_torch.launch.serve import serve_requests
    from repro_torch.learn import replay_stream

    watch = obs.compiled.CompileWatch()
    watch.__enter__()
    horizon = max(j.deadline for j in jobs) + 1.0
    spec = ScenarioSpec("fresh", horizon, STREAM_S["eval"], seed=STREAM_SEED)
    K = STREAM_CHUNK
    grid = selfowned_policies()
    fields = ("unit_cost", "spot_cost", "ondemand_cost", "selfowned_work",
              "spot_work", "ondemand_work", "selfowned_reserved")
    chain_fn, last_chain = pc.policy_cost_chain, []

    def chain_recorded(*a, **k):
        last_chain[:] = [(a, k)]
        return chain_fn(*a, **k)

    def grid_run():
        LAUNCHES.clear()
        t = time.perf_counter()
        res = evaluate_grid(jobs, grid, spec, 1200, scenario_chunk=K,
                            device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, dict(LAUNCHES)

    # (a) untraced and traced, from warm caches (a first untimed run warms
    # them whatever phase 12 left).
    t0 = time.perf_counter()
    grid_run()
    base, wall_u, launches_u = grid_run()
    pc.policy_cost_chain = chain_recorded
    try:
        with obs.observe(programs=True) as o:
            traced, wall_t, launches_t = grid_run()
    finally:
        pc.policy_cost_chain = chain_fn
    again, wall_u2, _ = grid_run()
    tr, snap = o.tracer, traced.obs["compiled"]["kernels"]
    ok = all(np.array_equal(getattr(base, f), getattr(traced, f))
             for f in fields) and all(
        np.array_equal(getattr(base, f), getattr(again, f)) for f in fields)
    print(f"(a) proposed r = 1200 grid, S = {spec.n_scenarios} in chunks of "
          f"{K}: untraced {wall_u:.3f}s, traced {wall_t:.3f}s, untraced "
          f"again {wall_u2:.3f}s (walls for information) [{smi}]; traced "
          f"and untraced results {'bit for bit' if ok else 'DIFFERENT'}")
    if not ok:
        fail("phase 13 (a): the traced result differs from the untraced one")
    totals, bad = tr.totals(), []
    for key in ("plan", "pool", "synth", "views", "eval"):
        spans = [r.seconds for r in tr.named(key)]
        if not (traced.timings[key] == fold(spans) == totals.get(key, 0.0)):
            bad.append((key, traced.timings[key], fold(spans)))
    chunks = tr.named("chunk")
    if len(chunks) != len(traced.timings["chunks"]):
        bad.append(("chunks", len(chunks), len(traced.timings["chunks"])))
    for entry, c in zip(traced.timings["chunks"], chunks):
        kids = tr.children(c.id)
        for key in ("synth", "views", "eval"):
            if entry[key] != fold(r.seconds for r in kids if r.name == key):
                bad.append((f"chunk {c.attrs['index']} {key}", entry[key]))
    print(f"(a) {len(tr)} spans; timings plan {traced.timings['plan']!r}, "
          f"pool {traced.timings['pool']!r}, synth "
          f"{traced.timings['synth']!r}, views {traced.timings['views']!r}, "
          f"eval {traced.timings['eval']!r}: "
          f"{'each equal to its spans bit for bit' if not bad else bad}")
    if bad:
        fail(f"phase 13 (a): timings differ from their spans: {bad}")
    keys = sorted(set(snap) | set(launches_t))
    mismatch = {k: (snap.get(k, {}).get("launches", 0), launches_t.get(k, 0))
                for k in keys
                if snap.get(k, {}).get("launches", 0) != launches_t.get(k, 0)}
    if mismatch or launches_t != launches_u or not launches_t:
        fail(f"phase 13 (a): captured launches vs the launch counter "
             f"{mismatch}; untraced {launches_u}, traced {launches_t}")
    for key in keys:
        e = snap[key]
        print(f"(a) {key}: {e['launches']} launches captured (= the launch "
              f"counter), {e['device_ms']:.3f} ms of CUDA-event time, "
              f"{e['device_ms'] / e['launches']:.4f} ms per launch, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}) [{smi}]")
    # The last chain launch's inputs again: a call (CUDA events around the
    # wrapper, median of 5) and the kernel alone (torch.profiler).
    (a_, k_), = last_chain
    B_, S_, n1_ = a_[0].shape
    run = lambda: chain_fn(*a_, **k_)  # noqa: E731
    same_ms = cuda_ms(torch, run)
    alone = pass_device_ms(torch, run, ("chain_smem_kernel",)).get(
        "chain_smem_kernel", math.nan)
    per = snap["policy_cost_chain"]["device_ms"] \
        / snap["policy_cost_chain"]["launches"]
    p3 = phase3.get("policy_cost_chain", {})
    print(f"(a) policy_cost_chain: captured {per:.4f} ms per launch; the "
          f"last launch's inputs ({B_} bids x {S_} scenarios) again: "
          f"{same_ms:.4f} ms per call, the kernel alone {alone:.4f} ms; "
          f"phase 3 at the main path's last launch: "
          f"{p3.get('ms', math.nan):.4f} ms per call, the kernel alone "
          f"{p3.get('kernel_device_ms') or math.nan:.4f} ms [{smi}]")
    path = pathlib.Path(__file__).resolve().parent / OBS_TRACE
    path.parent.mkdir(parents=True, exist_ok=True)
    tr.save(path)
    print(f"(a) Chrome trace of the traced run: {OBS_TRACE} "
          f"({path.stat().st_size} bytes, {len(tr)} spans)")
    n_spans = len(tr)
    n_events = sum(e["launches"] for k, e in snap.items()
                   if k not in SUBSET_KEYS)
    print(f"[obs (a): {time.perf_counter() - t0:.3f}s]")

    # (b) the adaptive stream, its counters against its own stage history
    # and the caches' counts; then one re-bid delta.
    t0 = time.perf_counter()
    stream = ScenarioStream(ScenarioSpec("adaptive", horizon, OBS_ADAPTIVE_S,
                                         seed=STREAM_SEED))
    stages, plan_chunk = [], stream._plan_chunk

    def staged(idx):
        stages.append(stream.stage)
        return plan_chunk(idx)
    stream._plan_chunk = staged
    info0 = {c: (c.cache_info(), c.evictions)
             for c in (cache.PLAN_CACHE, cache.VIEW_CACHE)}
    obs.METRICS.reset()        # counters from this block alone
    with obs.observe() as o:
        out = replay_stream(jobs, grid, stream, 1200, learners=["hedge"],
                            seed=0, scenario_chunk=K, device="cuda")
    m = out.obs["metrics"]

    def series(name, label):
        return {s["labels"][label]: s["value"]
                for s in m.get(name, {"series": []})["series"]}
    want_chunks = dict(collections.Counter(stages))
    want_esc = dict(collections.Counter(
        b for a, b in zip(stages, stages[1:]) if a != b))
    got_chunks = series("scenarios.adaptive_chunks", "stage")
    got_esc = series("scenarios.adaptive_escalations", "to")
    print(f"(b) adaptive stream, S = {OBS_ADAPTIVE_S} in chunks of {K}: "
          f"stages {stages}; adaptive_chunks {got_chunks} (history "
          f"{want_chunks}), adaptive_escalations {got_esc} (history "
          f"{want_esc})")
    if got_chunks != want_chunks or got_esc != want_esc or not want_esc:
        fail("phase 13 (b): the adaptive counters leave the stream's stage "
             "history (or the stream never escalated)")
    cache_ok = []
    for c, metric in ((cache.PLAN_CACHE, "engine.plan_cache"),
                      (cache.VIEW_CACHE, "engine.view_cache")):
        (ci0, ev0), ci1 = info0[c], c.cache_info()
        got = series(metric, "event")
        want = {"evict": c.evictions - ev0}
        if metric == "engine.plan_cache":   # the view cache emits evictions
            want.update(hit=ci1.hits - ci0.hits, miss=ci1.misses - ci0.misses)
        want = {k: v for k, v in want.items() if v}
        cache_ok.append(got == want)
        print(f"(b) {metric}: counters {got}, cache_info() deltas {want}")
    if not all(cache_ok):
        fail("phase 13 (b): the cache counters leave the caches' own counts")
    ent = {k: s for k, s in ((s["labels"]["learner"], s) for s in
                             m["learn.weight_entropy"]["series"])}
    top = series("learn.top_weight", "learner")
    print(f"(b) learn.weight_entropy {({k: (s['count'], s['sum']) for k, s in ent.items()})}, "
          f"learn.top_weight {top}")
    if any(s["count"] != out.n_chunks for s in ent.values()) or not top:
        fail("phase 13 (b): not one weight-entropy observation per chunk")
    obs.METRICS.reset()
    with obs.observe() as o:
        delta = evaluate_grid_delta(base, jobs, rebid(grid, CACHE_REBID),
                                    spec, 1200, scenario_chunk=K)
    d_series = delta.obs["metrics"]["engine.delta_groups_rescored"]["series"]
    n_re = delta.timings["delta_groups_rescored"]
    print(f"(b) re-bid delta: engine.delta_groups_rescored "
          f"{d_series[0]['value']}, timings {n_re}")
    if [s["value"] for s in d_series] != [n_re] or not n_re:
        fail("phase 13 (b): the delta counter leaves its timings")
    del delta, out
    print(f"[obs (b): {time.perf_counter() - t0:.3f}s]")

    # (c) tinyllama-1.1b's serve (phase 5's requests: two groups of four),
    # captured.
    t0 = time.perf_counter()
    arch = "tinyllama_1_1b"
    cfg = get_config(arch)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT), dtype=np.int32)
    expected = next(n for a, n, _ in SERVE if a == arch)["flash_attention"]
    with obs.observe(programs=True) as o:
        _, stats = serve_requests(cfg, prompts, SERVE_BATCH, SERVE_NEW,
                                  seed=0, device="cuda")
        serve_snap = o.compiled.snapshot()["kernels"]
    serve_spans = o.tracer.named("serve.requests")
    tc = serve_snap.get("flash_attention_tc", {"launches": 0})
    fl = serve_snap.get("flash_attention", {"launches": 0, "device_ms": 0})
    p6 = phase3.get("flash_attention", {})
    print(f"(c) serve {cfg.name}: {tc['launches']} flash_attention_tc "
          f"launches captured of {fl['launches']} flash_attention, "
          f"{fl['device_ms']:.3f} ms of CUDA-event time "
          f"({fl['device_ms'] / max(fl['launches'], 1):.4f} ms per launch; "
          f"phase 6's median {p6.get('ms', math.nan):.4f} ms per call, "
          f"device {p6.get('device_ms', math.nan):.4f}); serve.requests "
          f"spans {len(serve_spans)}, serve loop {stats['wall_s']:.3f}s "
          f"[{smi}]")
    if tc["launches"] != expected or fl["launches"] != expected \
            or len(serve_spans) != 1 \
            or serve_spans[0].seconds != stats["wall_s"]:
        fail(f"phase 13 (c): expected {expected} tensor-core launches and "
             f"one serve.requests span whose seconds are the serve's wall")
    torch.cuda.empty_cache()
    print(f"[obs (c): {time.perf_counter() - t0:.3f}s]")

    # (d) overhead, measured directly: spans opened by (a)'s traced run
    # times one span's cost with tracing off (and on), plus its captured
    # launches times one captured launch's cost (the chain's work count,
    # its event pair and the snapshot that waits for it).
    t0 = time.perf_counter()

    def one_span():
        with obs.span("x", a=1, b=2):
            pass
    off_s = per_op_seconds(one_span, SPAN_REPS)
    with obs.tracing():
        on_s = per_op_seconds(one_span, SPAN_REPS)
    zz = a_[4] if a_[4].dim() == 4 else a_[4][:, None]
    pp = a_[6] if a_[6].dim() == 4 else a_[6][:, None]
    R_, L_ = a_[3].shape[-2:]
    stream_ = torch.cuda.current_stream()

    def work():
        return pc.chain_work(B_, S_, zz.shape[1], R_, L_, n1_ - 1, zz, pp)
    with obs.capture() as reg:
        t = time.perf_counter()
        for _ in range(EVENT_REPS):
            with obs.record_launch("policy_cost_chain", stream_, work):
                pass
        reg.snapshot()
        event_s = (time.perf_counter() - t) / EVENT_REPS
    off_share = n_spans * off_s / wall_u
    on_share = (n_spans * on_s + n_events * event_s) / wall_u
    print(f"(d) {n_spans} spans x {off_s * 1e6:.3f} us with tracing off = "
          f"{off_share:.6f} of the untraced wall {wall_u:.3f}s (bar "
          f"{DISABLED_SHARE}); {n_spans} x {on_s * 1e6:.3f} us traced + "
          f"{n_events} captured launches x {event_s * 1e6:.3f} us = "
          f"{on_share:.6f} (bar {ENABLED_SHARE}); walls traced "
          f"{wall_t:.3f}s, untraced {wall_u:.3f}s and {wall_u2:.3f}s "
          f"(for information) [{smi}]")
    if not (off_share < DISABLED_SHARE and on_share < ENABLED_SHARE):
        fail("phase 13 (d): the observability overhead passes its bar")
    print(f"[obs (d): {time.perf_counter() - t0:.3f}s]")

    # (e) nothing was built.
    watch.__exit__(None, None, None)
    print(f"(e) nvcc builds over the phase: {watch.compiles}")
    if watch.compiles:
        fail(f"phase 13 (e): {watch.compiles} kernel build(s) on a warm path")
    return {"grid": {k: e for k, e in snap.items()},
            "serve": serve_snap, "disabled_share": off_share,
            "enabled_share": on_share}


def fold_stats(np, r) -> dict:
    """Every statistic of a ``StreamLearnResult`` the mesh phase holds to
    the host fold."""
    mean, lo, hi = r.confidence_bands()
    top = np.array([row["top_weight"] for row in r.summary()])
    return {"regret": r.regret_per_job(),
            "expected": r.regret_per_job(expected=True),
            "realized": r.realized_unit(), "std": r.regret_std(),
            "best_fixed": np.asarray([r.best_fixed()]),
            "weights": r.weights(), "curve": mean, "lo": lo, "hi": hi,
            "top_weight": top,
            "n": np.asarray([r.n_scenarios, r.n_chunks], np.float64)}


def fold_gap(np, a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a)


def scenario_digests(np, res) -> dict:
    """SHA-256 of every (field, scenario) slab of a result: bit equality
    of two (S, J, P) tensors without moving them between processes."""
    import hashlib

    return {f: [hashlib.sha256(np.ascontiguousarray(
        getattr(res, f)[s]).tobytes()).hexdigest()
        for s in range(getattr(res, f).shape[0])] for f in MESH_FIELDS}


def mesh_counts(compiled) -> tuple[dict, dict]:
    return ({k: compiled.collective_counts(k) for k in MESH_KEYS},
            {k: compiled.program_runs(k) for k in MESH_KEYS})


def count_faults(counts: dict, runs: dict, folded: int) -> list[str]:
    """What breaks the placement contract: a collective in an eval program,
    other than one all-gather per evaluated chunk, other than one
    all-reduce per folded chunk."""
    bad = [f"{k}: {counts[k]['total']} collective(s)"
           for k in MESH_EVAL_KEYS if counts[k]["total"]]
    evaluated = sum(runs[k] for k in MESH_EVAL_KEYS)
    g = counts["engine.gather:sharded"]
    if not g["all-gather"] == g["total"] == runs["engine.gather:sharded"] \
            == evaluated:
        bad.append(f"splice: {g} over {evaluated} evaluated chunks")
    f = counts["learn.fold:sharded"]
    if not f["all-reduce"] == f["total"] == runs["learn.fold:sharded"] \
            == folded:
        bad.append(f"fold: {f} over {folded} folded chunks")
    return bad


def mesh_rank(rank: int, out_dir: str) -> None:
    """One of phase 14 (b)'s four gloo ranks on the card (spawned)."""
    import datetime
    import os
    import pickle

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import numpy as np
    import torch
    import torch.distributed as dist

    out = pathlib.Path(out_dir)
    torch.cuda.set_device(0)
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    dist.init_process_group(
        "gloo", init_method=f"file://{out / 'store'}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        from repro_torch.engine import GridMesh, ScenarioSpec, evaluate_grid
        from repro_torch.kernels import LAUNCHES
        from repro_torch.learn import replay_stream
        from repro_torch.obs import compiled

        with open(out / "inputs.pkl", "rb") as f:
            x = pickle.load(f)
        spec = ScenarioSpec("fresh", x["horizon"], MESH_S, seed=STREAM_SEED)
        mesh = GridMesh.create(*MESH_SHAPE)
        compiled.reset_collectives()
        torch.cuda.reset_peak_memory_stats()
        watch = compiled.CompileWatch()
        with watch:
            LAUNCHES.clear()
            res = evaluate_grid(x["jobs"], x["grid"], spec, 1200,
                                device="cuda", mesh=mesh)
            torch.cuda.synchronize()
            eval_launches = dict(LAUNCHES)
            LAUNCHES.clear()
            fold = replay_stream(x["jobs"], x["grid"], spec, 1200,
                                 learners=MESH_LEARNERS, seed=0,
                                 scenario_chunk=STREAM_CHUNK, device="cuda",
                                 mesh=mesh)
            torch.cuda.synchronize()
            fold_launches = dict(LAUNCHES)
        counts, runs = mesh_counts(compiled)
        np.savez(out / f"rank{rank}.npz", **fold_stats(np, fold))
        (out / f"rank{rank}.json").write_text(json.dumps({
            "coords": [mesh.data_rank, mesh.model_rank],
            "backend": dist.get_backend(), "device": res.device,
            "digests": scenario_digests(np, res),
            "eval_s": res.timings["eval"], "splice_s": res.timings["splice"],
            "eval_launches": eval_launches, "fold_launches": fold_launches,
            "fold_chunks": fold.n_chunks, "counts": counts, "runs": runs,
            "compiles": watch.compiles,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
        # No rank tears its connections down while another is still in a
        # collective with it.
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args, timeout: float,
                label: str = "phase 14 (b)") -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes; fail the run
    if one raises or they are not all done within ``timeout`` seconds (the
    processes are killed either way before this returns)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.perf_counter(), 0.0)):
            if time.perf_counter() >= deadline:
                fail(f"{label}: the {world} ranks did not finish "
                     f"within {timeout} s")
    except mp.ProcessRaisedException as e:
        fail(f"{label}: a rank failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"{label}: a rank exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def mesh_phase(torch, np, jobs, tola_call) -> dict:
    """Phase 14: the scenario x policy-group mesh, (a) a 1x1 mesh over
    NCCL and (b) a 2x2 mesh of four gloo ranks sharing the card. Returns
    the kernels' launches of (a) and of one rank of (b)."""
    import pickle

    import torch.distributed as dist

    from repro_torch.core import (
        benchmark_bid_policies, run_tola_scenarios, selfowned_policies)
    from repro_torch.engine import (
        GridMesh, ScenarioSpec, ScenarioStream, evaluate_grid)
    from repro_torch.kernels import LAUNCHES
    from repro_torch.learn import replay_stream
    from repro_torch.obs import compiled

    horizon = max(j.deadline for j in jobs) + 1.0
    grid = selfowned_policies()
    K = STREAM_CHUNK
    spec = ScenarioSpec("fresh", horizon, STREAM_S["eval"], seed=STREAM_SEED)
    phase_launches: dict = {}

    def run(fn, *a, **k):
        """(result, wall, launches) of a call on the card."""
        LAUNCHES.clear()
        t = time.perf_counter()
        res = fn(*a, **k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for name, n in LAUNCHES.items():
            phase_launches[name] = phase_launches.get(name, 0) + n
        return res, wall, dict(LAUNCHES)

    def same(a, b) -> bool:
        return all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in MESH_FIELDS + ("selfowned_work",))

    # -- (a) a 1x1 mesh over NCCL -------------------------------------------
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    store = (MESH_DIR / "nccl_store").resolve()
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        mesh = GridMesh.create(1)
        if mesh.mesh is None or dist.get_backend() != "nccl":
            fail(f"phase 14 (a): the 1x1 mesh is not on an NCCL group "
                 f"({dist.get_backend()})")
        compiled.reset_collectives()
        torch.cuda.reset_peak_memory_stats()
        n_chunks = -(-spec.n_scenarios // K)
        legs = [("early start (chain)", grid, {}, "policy_cost_chain",
                 n_chunks),
                ("Even planned start (task)", benchmark_bid_policies(),
                 {"windows": "even", "selfowned": "naive",
                  "early_start": False}, "policy_cost",
                 n_chunks * len({round(p.bid, 12)
                                 for p in benchmark_bid_policies()}))]
        for label, g, kw, kernel, want in legs:
            un, t_un, l_un = run(evaluate_grid, jobs, g, spec, 1200,
                                 scenario_chunk=K, device="cuda", **kw)
            me, t_me, l_me = run(evaluate_grid, jobs, g, spec, 1200,
                                 scenario_chunk=K, device="cuda", mesh=mesh,
                                 **kw)
            print(f"(a) {label}, S = {spec.n_scenarios} in chunks of {K}: "
                  f"meshed {'bit for bit' if same(un, me) else 'DIFFERS'}; "
                  f"unsharded {t_un:.3f}s (eval {un.timings['eval']:.3f}s), "
                  f"meshed {t_me:.3f}s (eval {me.timings['eval']:.3f}s, of "
                  f"which splice {me.timings['splice']:.3f}s); {kernel} "
                  f"launches {l_un.get(kernel, 0)} and "
                  f"{l_me.get(kernel, 0)}")
            if not same(un, me) or not me.device.startswith("cuda"):
                fail(f"phase 14 (a) {label}: the meshed result differs from "
                     f"the unsharded one (device {me.device})")
            if l_me.get(kernel, 0) != want or l_un.get(kernel, 0) != want:
                fail(f"phase 14 (a) {label}: {kernel} launched "
                     f"{l_un.get(kernel, 0)} and {l_me.get(kernel, 0)} "
                     f"times, expected {want}")
        # TOLA on phase 2's r = 1200 proposed inputs, refinement included.
        args, kwargs, ref = tola_call
        got, t_tola, l_tola = run(run_tola_scenarios, *args,
                                  **dict(kwargs, mesh=mesh))
        ok = all(np.array_equal(a.cost_matrix, b.cost_matrix)
                 and np.array_equal(a.chosen, b.chosen)
                 for a, b in zip(ref, got))
        print(f"(a) run_tola_scenarios(mesh=) on phase 2's r = 1200 inputs "
              f"(S = {len(got)}, {kwargs.get('pool_iters', 1)} refinement "
              f"round(s)): cost matrices and chosen traces "
              f"{'bit for bit' if ok else 'DIFFER'} from phase 2's; "
              f"{t_tola:.3f}s; launches {l_tola}")
        if not ok:
            fail("phase 14 (a): meshed TOLA differs from phase 2's")
        # The fold, and the adaptive round trip.
        for label, src, learners in (
                ("fresh", lambda: spec, MESH_LEARNERS),
                ("adaptive", lambda: ScenarioStream(ScenarioSpec(
                    "adaptive", horizon, OBS_ADAPTIVE_S, seed=STREAM_SEED)),
                 ["hedge"])):
            host, t_h, _ = run(replay_stream, jobs, grid, src(), 1200,
                               learners=learners, seed=0, scenario_chunk=K,
                               device="cuda")
            sh, t_s, l_s = run(replay_stream, jobs, grid, src(), 1200,
                               learners=learners, seed=0, scenario_chunk=K,
                               device="cuda", mesh=mesh)
            gap = fold_gap(np, fold_stats(np, host), fold_stats(np, sh))
            print(f"(a) replay_stream(mesh=) {label} {learners}: "
                  f"{sh.n_chunks} chunks, largest gap to the host fold "
                  f"{gap:.3e} (bar {MESH_FOLD_TOL}); host {t_h:.3f}s, "
                  f"meshed {t_s:.3f}s; launches {l_s}")
            if gap >= MESH_FOLD_TOL or sh.n_scenarios != host.n_scenarios:
                fail(f"phase 14 (a): the sharded fold ({label}) leaves the "
                     f"host fold by {gap}")
        counts, runs = mesh_counts(compiled)
        folded = 2 * n_chunks
        bad = count_faults(counts, runs, folded)
        print(f"(a) collective_counts: "
              f"{ {k: counts[k]['total'] for k in MESH_KEYS} } over runs "
              f"{runs}")
        if bad:
            fail(f"phase 14 (a): placement contract broken: {bad}")
        print(f"(a) peak memory on the card "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    finally:
        dist.destroy_process_group()

    # -- (b) a 2x2 mesh of four gloo ranks sharing the card -----------------
    spec13 = ScenarioSpec("fresh", horizon, MESH_S, seed=STREAM_SEED)
    ref, t_ref, _ = run(evaluate_grid, jobs, grid, spec13, 1200,
                        device="cuda")
    want = scenario_digests(np, ref)
    host, t_host, _ = run(replay_stream, jobs, grid, spec13, 1200,
                          learners=MESH_LEARNERS, seed=0, scenario_chunk=K,
                          device="cuda")
    host_stats = fold_stats(np, host)
    out = (MESH_DIR / "ranks").resolve()
    out.mkdir(parents=True, exist_ok=True)
    for f in out.iterdir():
        f.unlink()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"jobs": jobs, "grid": grid, "horizon": horizon}, f)
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    t0 = time.perf_counter()
    spawn_ranks(mesh_rank, world, (str(out),), MESH_TIMEOUT)
    t_ranks = time.perf_counter() - t0
    print(f"(b) {MESH_SHAPE[0]}x{MESH_SHAPE[1]} mesh, {world} gloo ranks on "
          f"the card, S = {MESH_S}, {len(grid)} policies: ranks "
          f"{t_ranks:.3f}s start to end; unsharded reference {t_ref:.3f}s, "
          f"host fold {t_host:.3f}s")
    rank_launches = {}
    n_fold = -(-MESH_S // K)
    for r in range(world):
        meta = json.loads((out / f"rank{r}.json").read_text())
        with np.load(out / f"rank{r}.npz") as z:
            gap = fold_gap(np, host_stats, {k: z[k] for k in z.files})
        diff = {f: [s for s, (a, b) in enumerate(zip(want[f],
                                                      meta["digests"][f]))
                    if a != b] for f in MESH_FIELDS}
        diff = {f: v for f, v in diff.items() if v}
        bad = count_faults(meta["counts"], meta["runs"], n_fold)
        chain = meta["eval_launches"].get("policy_cost_chain", 0)
        print(f"(b) rank {r} at {tuple(meta['coords'])} ({meta['backend']}, "
              f"{meta['device']}): tensors "
              f"{'bit for bit' if not diff else f'DIFFER at {diff}'}; fold "
              f"gap {gap:.3e}; eval {meta['eval_s']:.3f}s of which splice "
              f"{meta['splice_s']:.3f}s; peak {meta['peak_gib']:.3f} GiB; "
              f"launches eval {meta['eval_launches']} fold "
              f"{meta['fold_launches']}; collectives "
              f"{ {k: v['total'] for k, v in meta['counts'].items()} }; "
              f"nvcc builds {meta['compiles']}")
        if diff:
            fail(f"phase 14 (b): rank {r}'s tensors differ from the "
                 f"unsharded card tensors at {diff}")
        if not meta["device"].startswith("cuda") \
                or meta["backend"] != "gloo":
            fail(f"phase 14 (b): rank {r} ran on {meta['device']} over "
                 f"{meta['backend']}")
        if gap >= MESH_FOLD_TOL or meta["fold_chunks"] != n_fold:
            fail(f"phase 14 (b): rank {r}'s fold leaves the host fold by "
                 f"{gap}")
        if bad or chain != 1 \
                or meta["fold_launches"].get("policy_cost_chain", 0) \
                != n_fold:
            fail(f"phase 14 (b): rank {r}: {bad}, {chain} chain launch(es) "
                 f"in a one-chunk evaluation")
        if meta["compiles"]:
            fail(f"phase 14 (b): rank {r} built {meta['compiles']} kernel "
                 f"librar(ies)")
        if r == 0:
            for d in (meta["eval_launches"], meta["fold_launches"]):
                for name, n in d.items():
                    rank_launches[name] = rank_launches.get(name, 0) + n
    return {"a": phase_launches, "b": rank_launches}


def analysis_phase(torch, np) -> dict:
    """Phase 15: the static contract checker. Returns the kernels'
    launches of (b)."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.analysis.programs import (
        PROGRAM_KEYS, verify_all, verify_program)
    from repro_torch.engine import GridMesh
    from repro_torch.engine.mesh import all_gather
    from repro_torch.kernels import LAUNCHES
    from repro_torch.obs import compiled

    watch = compiled.CompileWatch()
    with watch:
        # -- (a) Layer 1 through the CLI ------------------------------------
        root = pathlib.Path(__file__).resolve().parent
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = analysis_main(["--root", str(root)])
        print(f"(a) python -m repro_torch.analysis: exit {rc} in "
              f"{time.perf_counter() - t:.3f}s")
        for line in out.getvalue().splitlines():
            print(f"    {line}")
        if rc != 0:
            fail(f"phase 15 (a): the source rules found violations (exit "
                 f"{rc})")

        # -- (b), (c) the program verifier on a 1x1 NCCL mesh ---------------
        ANALYSIS_DIR.mkdir(parents=True, exist_ok=True)
        store = (ANALYSIS_DIR / "nccl_store").resolve()
        store.unlink(missing_ok=True)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                world_size=1, rank=0)
        try:
            mesh = GridMesh.create(1)
            if mesh.mesh is None or dist.get_backend() != "nccl":
                fail(f"phase 15 (b): the 1x1 mesh is not on an NCCL group "
                     f"({dist.get_backend()})")
            LAUNCHES.clear()
            t = time.perf_counter()
            checks = verify_all(mesh=mesh, device="cuda")
            t_verify = time.perf_counter() - t
            launches = dict(LAUNCHES)

            # (d) planted faults, each on CUDA tensors
            x = torch.arange(8, dtype=torch.float32, device="cuda") - 3.0
            planted = [
                ("syncs", "demo.item", lambda a: a * a.sum().item(), {}),
                ("syncs", "demo.tolist", lambda a: a + len(a.tolist()), {}),
                ("dtype", "demo.float64", lambda a: a.double() * 2.0, {}),
                ("mutation", "demo.write", lambda a: a.mul_(2.0), {}),
                ("collectives", "demo.gather",
                 lambda a: all_gather(mesh, a) + 1.0,
                 {"collectives": {"total": 0}}),
            ]
            faults = []
            for check, key, fn, kw in planted:
                res = verify_program(fn, (x.clone(),), key=key,
                                     device="cuda", **kw)
                got = [c for c in res if c.check == check]
                faults.append((check, key, got))
        finally:
            dist.destroy_process_group()

    # One line per program: every check's verdict, with the details that
    # say more than "ok" (allowances, accumulators, counts, launches).
    width = max(len(k) for k in PROGRAM_KEYS)
    for key in PROGRAM_KEYS:
        mine = [c for c in checks if c.program == key]
        bad = any(not c.ok for c in mine)
        print(f"(b) [{'FAIL' if bad else 'ok '}] {key:<{width}} " + "; ".join(
            f"{c.check} {'ok' if c.ok else 'FAIL'}" + (
                f" ({c.detail})" if not c.ok or "allowances" in c.detail
                or "accumulator" in c.detail or c.check == "launches"
                or "'total': 0" not in c.detail and c.check == "collectives"
                else "") for c in mine))
    failed = [c for c in checks if not c.ok]
    programs = {c.program for c in checks}
    print(f"(b) {len(programs)} programs verified on the card in "
          f"{t_verify:.3f}s, {len(checks)} checks, {len(failed)} failed; "
          f"launches {launches}")
    if failed or programs != set(PROGRAM_KEYS):
        fail(f"phase 15 (b): {len(failed)} failed check(s), programs "
             f"{sorted(set(PROGRAM_KEYS) ^ programs)} missing or extra: "
             + "; ".join(f"{c.program}/{c.check}: {c.detail}"
                         for c in failed))
    want = {(c.program, c.check) for c in checks}
    for key in PROGRAM_KEYS:
        need = {"build", "syncs", "dtype", "mutation", "collectives"}
        if key.startswith("kernels."):
            need.add("launches")
        if not all((key, n) in want for n in need):
            fail(f"phase 15 (b)/(c): {key} lacks one of the checks {need}")
    for check, key, got in faults:
        ok = len(got) == 1 and not got[0].ok and key in got[0].detail
        print(f"(d) planted {key}: {check} "
              f"{'fails as it must' if ok else 'DID NOT FAIL'}"
              + (f" ({got[0].detail})" if got else ""))
        if not ok:
            fail(f"phase 15 (d): the planted fault {key} passed its "
                 f"{check} check")
    print(f"(e) nvcc builds over the phase: {watch.compiles}")
    if watch.compiles:
        fail(f"phase 15 (e): {watch.compiles} kernel librar(ies) built")
    return launches



def _rel_rms(got, ref) -> float:
    d = (got.float() - ref.float()).square().mean().sqrt()
    return float(d / ref.float().square().mean().sqrt().clamp(min=1e-30))


def _flash_plain_train(torch, fa, q, k, v, do, kw):
    """The plain version's float32 output, log-sum-exp and autograd
    gradients on (B, S, heads, dh) inputs, one batch row at a time (the
    naive scores of a whole tinyllama microbatch would take 17 GB)."""
    outs = []
    for b in range(q.shape[0]):
        leaf = [t[b:b + 1].detach().float().requires_grad_() for t in (q, k, v)]
        rows = [t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[-1])
                for t in leaf]
        o, lse = fa.attention_plain(*rows, return_lse=True, **kw)
        H, S, dh = q.shape[2], q.shape[1], q.shape[3]
        o = o.reshape(1, H, S, dh).transpose(1, 2)
        grads = torch.autograd.grad(o, leaf, do[b:b + 1].float())
        outs.append((o.detach(), lse.reshape(1, H, S).detach(), *grads))
    return [torch.cat(parts) for parts in zip(*outs)]


def _ssd_f64(torch, x, dt, A, B, C, chunk):
    """(y, final state) of the SSD scan from a zero state in the
    whole-sequence chunked form (every chunk at once, the chunk states by a
    segment-sum over chunks; the sequence padded with dt = 0 to whole
    chunks), in the inputs' dtype: the gradient witness of phase 16 (a)."""
    Bb, S, H, P = x.shape
    pad = (-S) % chunk
    if pad:
        x, dt, B, C = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    rep = H // B.shape[2]
    nc = (S + pad) // chunk

    def segsum(a):                       # (..., T) -> (..., T, T)
        c = torch.cumsum(a, dim=-1)
        d = c[..., :, None] - c[..., None, :]
        keep = torch.ones(a.shape[-1], a.shape[-1], dtype=torch.bool,
                          device=a.device).tril()
        return d.masked_fill(~keep, float("-inf"))

    X = (x * dt[..., None]).reshape(Bb, nc, chunk, H, P)
    a = (A * dt).reshape(Bb, nc, chunk, H).permute(0, 3, 1, 2)  # (b,h,c,l)
    Bh = B.repeat_interleave(rep, dim=2).reshape(Bb, nc, chunk, H, -1)
    Ch = C.repeat_interleave(rep, dim=2).reshape(Bb, nc, chunk, H, -1)
    a_cum = torch.cumsum(a, dim=-1)
    L = segsum(a).exp()                                   # (b,h,c,l,s)
    CB = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y = torch.einsum("bhcls,bcshp->bclhp", CB * L, X)
    decay = (a_cum[..., -1:] - a_cum).exp()               # (b,h,c,l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = segsum(torch.nn.functional.pad(a_cum[..., -1], (1, 0)))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay.exp(), states)
    states, final = states[:, :-1], states[:, -1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states, a_cum.exp())
    return y.reshape(Bb, S + pad, H, P)[:, :S], final


@contextlib.contextmanager
def no_plain_backward_on_the_card():
    """The plain backwards (``flash_backward``, ``ssd_scan_backward_plain``)
    fail the run when they are given CUDA tensors: on the card the training
    steps take the backward kernels. CPU tensors still reach them."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels import ssd_scan as ss
    saved = []
    for mod, name in ((fa, "flash_backward"),
                      (ss, "ssd_scan_backward_plain")):
        orig = getattr(mod, name)

        def guarded(*a, _orig=orig, _name=name, **k):
            if a[0].device.type == "cuda":
                fail(f"{_name}, a plain backward, ran on CUDA tensors")
            return _orig(*a, **k)
        setattr(mod, name, guarded)
        saved.append((mod, name, orig))
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def flash_train_check(torch, fa, label: str, spec, rnd) -> dict:
    """Phase 16 (a) at one flash shape: the training forward with its
    log-sum-exp and ``FlashAttention``'s backward on the card, the backward
    kernels against the plain version (``flash_backward``) on the same
    inputs and against an independent witness (the plain forward's float32
    autograd), a second backward call bit for bit the first, and the
    device times of both forwards, the backward kernels, the plain
    backward and SDPA's backward."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.obs.compiled import work_bound

    B, S, H, K, dh, dtype, causal, window, prefix, route = spec
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    dt = getattr(torch, dtype)
    q, k, v = rnd(B, Sq, H, dh).to(dt), rnd(B, Sk, K, dh).to(dt), \
        rnd(B, Sk, K, dh).to(dt)
    do = rnd(B, Sq, H, dh).to(dt)
    kw = dict(causal=causal, window=window, prefix=prefix)
    LAUNCHES.clear()
    out, lse = fa.flash_forward_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    tc = LAUNCHES["flash_attention_tc"]
    if LAUNCHES["flash_attention"] != 1 or tc != (route == "tc"):
        fail(f"train flash {label}: launches {dict(LAUNCHES)}, expected "
             f"one on the {route} route")
    leaf = [t.detach().requires_grad_() for t in (q, k, v)]
    LAUNCHES.clear()
    fn_out = fa.FlashAttention.apply(*leaf, causal, window, prefix)
    fn_out.backward(do)
    torch.cuda.synchronize()
    bwd = (LAUNCHES["flash_attention_backward"],
           LAUNCHES["flash_attention_backward_tc"])
    if bwd != (1, int(route == "tc")):
        fail(f"train flash {label}: backward launches {dict(LAUNCHES)}, "
             f"expected one on the {route} route")
    grads = [t.grad for t in leaf]
    again = fa.flash_attention_backward(q, k, v, out, lse, do, **kw)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    plain = fa.flash_backward(q, k, v, out, lse, do, **kw)
    # relative RMS in bfloat16, max abs in float32
    gap = _rel_rms if dtype == "bfloat16" else \
        (lambda a, b: float((a.float() - b.float()).abs().max()))
    errs_plain = [gap(a, b) for a, b in zip(grads, plain)]
    abs_plain = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(grads, plain))
    del plain
    o_p, lse_p, *g_p = _flash_plain_train(torch, fa, q, k, v, do, kw)
    lse_err = float((lse - lse_p).abs().max())
    errs = [gap(a, b) for a, b in zip([fn_out.detach()] + grads, [o_p] + g_p)]
    del o_p, lse_p, g_p
    lse_tol, grad_tol = TRAIN_FLASH_TOL[dtype]
    bar = f"relative RMS {grad_tol}" if dtype == "bfloat16" \
        else f"max abs {grad_tol}"
    if not torch.equal(fn_out.detach(), out):
        fail(f"train flash {label}: the Function's forward is not the "
             "kernel's")
    ok = lse_err <= lse_tol and all(e <= grad_tol for e in errs + errs_plain)
    o = torch.empty_like(q)
    lse_buf = torch.empty_like(lse)
    t_fwd = device_ms(torch, lambda: fa.flash_attention_strided(
        q, k, v, o, **kw), reps=10)
    t_lse = device_ms(torch, lambda: fa.flash_attention_strided(
        q, k, v, o, lse=lse_buf, **kw), reps=10)
    run = lambda: fa.flash_attention_backward(  # noqa: E731
        q, k, v, out, lse, do, **kw)
    t_bwd = device_ms(torch, run, reps=10)
    t_call = cuda_ms(torch, run)
    t_plain = device_ms(torch, lambda: fa.flash_backward(
        q, k, v, out, lse, do, **kw), reps=2)
    b_ms, b_by = work_bound(fa.flash_backward_work(q, k, v, **kw))
    # The library's backward alone: autograd through a retained SDPA
    # graph (the yardstick's mask), where SDPA computes this attention.
    t_lib = None
    sdpa = sdpa_yardstick(torch, *leaf, kw) if dtype == "bfloat16" else None
    if sdpa is not None:
        lib_out = sdpa()
        t_lib = device_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaf, do.transpose(1, 2), retain_graph=True), reps=3)
        del lib_out
    print(f"  train flash {label} {(B, (Sq, Sk), H, K, dh)} {dtype} {kw}: "
          f"lse max abs {lse_err:.3e} (bar {lse_tol}); against the plain "
          f"forward's float32 autograd: out, dq, dk, dv "
          f"{', '.join(f'{e:.3e}' for e in errs)}; the kernels' dq, dk, dv "
          f"against flash_backward {', '.join(f'{e:.3e}' for e in errs_plain)}"
          f" ({bar}) {'OK' if ok else 'FAIL'}; forward {t_fwd:.4f} ms, with "
          f"the lse store {t_lse:.4f} ms; backward kernels ({route}) "
          f"{t_bwd:.4f} ms, flash_backward (torch ops) {t_plain:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), SDPA's backward "
          f"{'none' if t_lib is None else f'{t_lib:.4f} ms'}")
    print(f"  train flash {label}: a second backward call on the same inputs "
          f"{'equals' if same else 'DIFFERS from'} the first (torch.equal)")
    if not ok:
        fail(f"train flash {label}: off the plain version or its autograd")
    if not same:
        fail(f"train flash {label}: the backward kernels are not "
             "deterministic")
    e = {"shape": [B, Sq, Sk, H, K, dh], "dtype": dtype, "route": route,
         "mask": kw, "lse_max_abs_err": lse_err, "grad_errs": errs,
         "grad_errs_plain": errs_plain, "max_abs_err": abs_plain,
         "repeat_equal": same, "fwd_ms": t_fwd, "fwd_lse_ms": t_lse,
         "bwd_ms": t_bwd, "bwd_call_ms": t_call,
         "bwd_plain_ms": t_plain, "bwd_bound_ms": b_ms, "bwd_bound_by": b_by,
         "bwd_library_ms": t_lib}
    del q, k, v, do, out, lse, leaf, fn_out, grads, o, lse_buf
    torch.cuda.empty_cache()
    return e


def ssd_train_check(torch, ss, label: str, shape, dtype: str, gen,
                    rnd) -> dict:
    """Phase 16 (a) at one SSD shape: ``SSDScan``'s forward and backward on
    the card with a state gradient, the backward kernel against the plain
    version (``ssd_scan_backward_plain``) on the same inputs and against an
    independent witness (another chunked form of the scan, differentiated
    in float64), a second backward call bit for bit the first, and the
    device times of the forward, the backward kernel and the plain
    backward."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.obs.compiled import work_bound

    Bb, S, H, P, G, N, chunk = shape
    x = rnd(Bb, S, H, P).to(getattr(torch, dtype))
    dt = torch.rand(Bb, S, H, device="cuda", generator=gen) * 0.1 + 0.001
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    B_, C_ = rnd(Bb, S, G, N), rnd(Bb, S, G, N)
    dy = rnd(Bb, S, H, P).to(x.dtype)
    ds = rnd(Bb, H, P, N)
    ins = (x, dt, A, B_, C_)
    LAUNCHES.clear()
    leaf = [t.detach().requires_grad_() for t in ins]
    y, state = ss.SSDScan.apply(*leaf, chunk)
    ((y * dy).sum() + (state * ds).sum()).backward()
    torch.cuda.synchronize()
    if (LAUNCHES["ssd_scan"], LAUNCHES["ssd_scan_backward"]) != (1, 1):
        fail(f"train SSD {label}: launches {dict(LAUNCHES)}, expected one "
             "forward and one backward")
    grads = [t.grad for t in leaf]
    again = ss.ssd_scan_backward(*ins, dy, ds, chunk)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    rel = lambda a, b: float((a.float() - b.float()).abs().max()  # noqa: E731
                             / b.float().abs().max().clamp(min=1e-30))
    with torch.no_grad():
        y_p, _ = ss.ssd_scan_plain(*ins, chunk)
        plain = ss.ssd_scan_backward_plain(*ins, dy, ds, chunk)
        errs_plain = [rel(a, b) for a, b in zip(grads, plain)]
        abs_plain = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(grads, plain))
        del plain
    y_err = rel(y.detach(), y_p)
    del y_p
    wit = [t.detach().double().requires_grad_() for t in ins]
    y_w, st_w = _ssd_f64(torch, *wit, chunk)
    g_w = torch.autograd.grad((y_w * dy.double()).sum()
                              + (st_w * ds.double()).sum(), wit)
    errs = [rel(a, b) for a, b in zip(grads, g_w)]
    del wit, y_w, st_w, g_w
    bar = TRAIN_SSD_TOL if dtype == "float32" else LM_TOL[dtype]["ssd"]
    ok = y_err <= bar and all(e <= bar for e in errs + errs_plain)
    t_fwd = device_ms(torch, lambda: ss.ssd_scan(*ins, chunk), reps=5)
    run = lambda: ss.ssd_scan_backward(*ins, dy, ds, chunk)  # noqa: E731
    t_bwd = device_ms(torch, run, reps=5)
    t_call = cuda_ms(torch, run)
    t_plain = device_ms(torch, lambda: ss.ssd_scan_backward_plain(
        *ins, dy, ds, chunk), reps=1)
    b_ms, b_by = work_bound(ss.ssd_backward_work(*ins, chunk))
    print(f"  train SSD {label} {shape} x {dtype}: y {y_err:.3e}; dx, ddt, "
          f"dA, dB, dC against float64 autograd of another chunked form "
          f"{', '.join(f'{e:.3e}' for e in errs)}, against "
          f"ssd_scan_backward_plain {', '.join(f'{e:.3e}' for e in errs_plain)}"
          f" (relative to each one's max abs, bar {bar}) "
          f"{'OK' if ok else 'FAIL'}; forward (kernel) {t_fwd:.4f} ms, "
          f"backward kernel {t_bwd:.4f} ms, ssd_scan_backward_plain "
          f"{t_plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}); no library call "
          "computes it")
    print(f"  train SSD {label}: a second backward call on the same inputs "
          f"{'equals' if same else 'DIFFERS from'} the first (torch.equal)")
    if not ok:
        fail(f"train SSD {label}: off the plain version or the float64 "
             "gradients")
    if not same:
        fail(f"train SSD {label}: the backward kernel is not deterministic")
    e = {"shape": list(shape), "dtype": dtype, "y_err": y_err,
         "grad_errs": errs, "grad_errs_plain": errs_plain,
         "max_abs_err": abs_plain, "repeat_equal": same, "fwd_ms": t_fwd,
         "bwd_ms": t_bwd, "bwd_call_ms": t_call,
         "bwd_plain_ms": t_plain, "bwd_bound_ms": b_ms, "bwd_bound_by": b_by,
         "bwd_library_ms": None}
    del x, dt, A, B_, C_, dy, ds, ins, leaf, y, state, grads
    torch.cuda.empty_cache()
    return e


def train_kernel_checks(torch, np) -> dict:
    """Phase 16 (a): the flash kernel's training forward (with its
    log-sum-exp) and both backward kernels on the card, each against its
    plain version and an independent witness at every shape of
    TRAIN_FLASH, TRAIN_FLASH_BWD and TRAIN_SSD_BWD; their device times
    beside the plain backwards', the bounds and SDPA's backward."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator("cuda").manual_seed(TRAIN_SEED)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    report = {"flash_attention": {}, "ssd_scan": {}}
    for label, spec in {**TRAIN_FLASH, **TRAIN_FLASH_BWD}.items():
        report["flash_attention"][label] = flash_train_check(
            torch, fa, label, spec, rnd)
    for label, (shape, dtype) in TRAIN_SSD_BWD.items():
        report["ssd_scan"][label] = ssd_train_check(
            torch, ss, label, shape, dtype, gen, rnd)
    return report


def _idle_share(torch, fn, wall_s: float) -> float:
    """The device's idle share over one run of ``fn`` of ``wall_s`` host
    seconds, from the device entries of a device-only torch.profiler trace
    (read as phase 5 reads it)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = trace_device_rows(prof, TRAIN_TRACE)
    if not rows:
        fail("training: the profiler's trace holds no device event")
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  profiled step (not counted): wall {wall:.3f}s (unprofiled "
          f"{wall_s:.3f}s), device busy {busy:.3f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.6f}")
    return 1 - busy / (wall * 1e3)


def state_digests(torch, params: dict, state) -> dict:
    """Per-tensor digests of parameters and moments on the card: the int32
    bit patterns weighted by odd position numbers, summed in int64
    (wrapping). A change of one word always changes its tensor's digest
    (an odd weight times a non-zero difference below 2**32 is not 0 mod
    2**64)."""
    def one(t):
        w = t.reshape(-1).view(torch.int32).long()
        w.mul_(torch.arange(w.numel(), device=t.device).mul_(2).add_(1))
        return int(w.sum())

    out = {f"p.{n}": one(t) for n, t in params.items()}
    out.update({f"m.{n}": one(t) for n, t in state.m.items()})
    out.update({f"v.{n}": one(t) for n, t in state.v.items()})
    return out


def analysed_step(torch, cfg, step, state, batch: dict, n_micro: int,
                  wall: float) -> dict:
    """Phase 16 (b)'s analysis: one more step under ``op_analysis`` on the
    card, its FLOPs and collectives against a meta trace of the same step,
    its compute and memory terms against the measured wall of a step, and
    its peak live bytes (plus what the card held before it) against the
    allocator's peak over it."""
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import AdamW

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    card = analyze(step, state, batch)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    model = build(cfg, "meta")
    opt = AdamW(lr=3e-4)
    meta = analyze(make_train_step(model, opt, n_micro),
                   opt.init(dict(model.named_parameters())),
                   {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in batch.items()})
    t_meta = time.perf_counter() - t0
    terms = {"compute_s": card["flops"] / HW.PEAK_FLOPS_BF16,
             "memory_s": card["bytes"] / HW.HBM_BW,
             "collective_s": card["collectives"]["total"] / HW.NVLINK_BW}
    live = held + card["peak_bytes"]
    gap = abs(live - peak) / peak
    calls = {k: v["calls"] for k, v in card["kernels"].items()}
    same = meta["flops"] == card["flops"] \
        and meta["collectives"] == card["collectives"]
    print(f"  analysed step (op_analysis on the card, {t_card:.3f}s with the "
          f"analysis; not counted): {card['flops']:.6e} FLOPs, "
          f"{card['bytes']:.6e} bytes, collectives "
          f"{card['collectives']['total']} B, kernel calls {calls}; the meta "
          f"trace of the same step ({t_meta:.3f}s): {meta['flops']:.6e} "
          f"FLOPs, collectives {meta['collectives']['total']} B "
          f"({'equal' if same else 'DIFFER'});"
          f" compute_s {terms['compute_s']:.6f}, memory_s "
          f"{terms['memory_s']:.6f}, collective_s {terms['collective_s']:.6f}"
          f" against the measured wall {wall:.6f} s; peak live "
          f"{card['peak_bytes']} B + {held} B held before = {live} B against "
          f"max_memory_allocated {peak} B ({gap:.4f} off, bar "
          f"{TRAIN_PEAK_TOL}); warnings {card['warnings']}")
    faults = []
    if not same:
        faults.append("the card's counts differ from the meta trace's")
    if not card["flops"] > 0 or max(terms["compute_s"],
                                    terms["memory_s"]) > wall:
        faults.append(f"terms {terms} over the wall {wall}")
    if gap > TRAIN_PEAK_TOL:
        faults.append(f"peak live bytes {live} off the allocator's {peak}")
    if faults:
        fail(f"phase 16 (b) analysis: {'; '.join(faults)}")
    return {"flops": card["flops"], "bytes": card["bytes"],
            "collectives": card["collectives"], **terms, "wall_s": wall,
            "peak_live": live, "max_memory_allocated": peak,
            "meta_flops": meta["flops"]}


def train_full_width(torch, np, arch: str, batch: int, n_micro: int,
                     steps: int, expect: dict, analyse: bool = False,
                     layers: int | None = None) -> dict:
    """Phase 16 (b)/(c): ``make_train_step`` on ``arch`` at full width, bf16
    activations and float32 masters from the port's seeded init, on the
    trainer's synthetic batches of ``batch`` x TRAIN_SEQ; ``expect`` holds
    each kernel's launches per step; ``layers`` cuts the depth. With
    ``analyse`` one more step runs under ``op_analysis``
    (``analysed_step``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import AdamW, cosine_schedule

    total = torch.cuda.get_device_properties(0).total_memory
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, "cuda")
    model.init_weights(torch.Generator("cuda").manual_seed(0))
    params = dict(model.named_parameters())
    first = {n: p.detach().clone() for n, p in params.items()} \
        if n_micro > 1 else None
    opt = AdamW(lr=cosine_schedule(3e-4, 10, 100))
    ds = SyntheticTokens(cfg.vocab, batch, TRAIN_SEQ, host_rank=0,
                         host_count=1)
    data = [{k: torch.as_tensor(v, device="cuda")
             for k, v in ds.batch(s).items()} for s in range(steps)]
    state = opt.init(params)
    step = make_train_step(model, opt, n_microbatches=n_micro)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"[train {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
          f" {n_params / 1e9:.3f}e9 parameters, global batch {batch} (cut "
          f"from train_4k's 256) x {TRAIN_SEQ}, {n_micro} microbatch(es), "
          f"init {time.perf_counter() - t0:.3f}s]")
    losses, norms, walls, per_step = [], [], [], []
    for s in range(steps):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        state, m = step(state, data[s])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = {k: LAUNCHES.get(k, 0) for k in expect}
        per_step.append(dict(LAUNCHES))
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        norms.append(gn)
        print(f"  step {s + 1}: loss {loss:.6f}, grad norm {gn:.6f}, wall "
              f"{walls[-1]:.3f}s, {batch * TRAIN_SEQ / walls[-1]:.1f} "
              f"tokens/s; launches {dict(LAUNCHES)}")
        if got != expect:
            fail(f"train {arch} step {s + 1}: launches {got}, expected "
                 f"{expect}")
        for key in ("flash_attention", "flash_attention_backward"):
            if key in expect and LAUNCHES[f"{key}_tc"] != expect[key]:
                fail(f"train {arch}: {LAUNCHES[f'{key}_tc']} of "
                     f"{expect[key]} {key} launches took the tensor-core "
                     "route")
        if not (math.isfinite(loss) and math.isfinite(gn)) \
                or int(m["step"]) != s + 1:
            fail(f"train {arch} step {s + 1}: loss {loss}, grad norm {gn}, "
                 f"step {int(m['step'])}")
    out = {"losses": losses, "grad_norms": norms, "walls": walls,
           "tokens_per_s": batch * TRAIN_SEQ / walls[-1],
           "launches_per_step": per_step,
           # phase 17 (a) holds its meshed steps to these
           "digests": state_digests(torch, {n: p.detach() for n, p in
                                            params.items()}, state)}
    idle = _idle_share(torch, lambda: step(state, data[-1]), walls[-1])
    out["idle_share"] = idle
    if analyse:
        out["analysis"] = analysed_step(torch, cfg, step, state, data[-1],
                                        n_micro, walls[-1])
    if first is not None:
        moved = max(float((p.detach() - first[n]).abs().max())
                    for n, p in params.items())
        if not moved > 0:
            fail(f"train {arch}: the parameters did not move")
        # One step from the first state on the first batch, in one batch.
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(first[n])
        del first
        _, m1 = make_train_step(model, opt, 1)(opt.init(params), data[0])
        gap = abs(float(m1["loss"]) - losses[0])
        print(f"  one step from the first state in one batch: loss "
              f"{float(m1['loss']):.6f}, {gap:.3e} from the microbatched "
              f"step's (bar {TRAIN_MICRO_TOL}); parameters moved by up to "
              f"{moved:.3e}")
        if gap > TRAIN_MICRO_TOL:
            fail(f"train {arch}: one batch and {n_micro} microbatches "
                 f"disagree by {gap}")
        out["single_batch_gap"] = gap
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory {peak / 2**30:.3f} GiB, {peak / total:.4f} of the "
          f"card's {total / 2**30:.3f} GiB")
    if peak > TRAIN_MEM_SHARE * total:
        fail(f"train {arch}: peak {peak / total:.4f} of the card, over "
             f"{TRAIN_MEM_SHARE}")
    out["peak_gib"] = peak / 2**30
    del model, params, opt, data, state, step
    torch.cuda.empty_cache()
    return out


def train_smoke_parity(torch, np) -> None:
    """Phase 16 (d): one ``train_step`` of every architecture's float32
    smoke config on the card against the same step on the CPU."""
    from repro_torch.configs import ARCH_NAMES, smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _extras
    from repro_torch.models import build
    from repro_torch.optim import AdamW, cosine_schedule

    for arch in ARCH_NAMES:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        batch = SyntheticTokens(cfg.vocab, 2, 32, host_rank=0, host_count=1,
                                extras=_extras(cfg, 32)).batch(0)
        got = {}
        for dev in ("cpu", "cuda"):
            model = build(cfg, dev)
            if dev == "cpu":
                model.init_weights(torch.Generator().manual_seed(0))
                # a copy: the step updates the CPU model's tensors in place
                state_dict = {k: t.clone() for k, t in
                              model.state_dict().items()}
            else:
                model.load_state_dict(state_dict)
            opt = AdamW(lr=cosine_schedule(3e-4, 10, 30))
            params = dict(model.named_parameters())
            LAUNCHES.clear()
            st, m = make_train_step(model, opt)(
                opt.init(params),
                {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
            got[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        {n: t.cpu() for n, t in st.m.items()}, dict(LAUNCHES))
        (l_c, g_c, m_c, _), (l_g, g_g, m_g, launches) = got["cpu"], \
            got["cuda"]
        worst = max(float((m_g[n] - m_c[n]).abs().max()
                          / m_c[n].abs().max().clamp(min=1e-30))
                    for n in m_c)
        ok = abs(l_g - l_c) <= 1e-5 * abs(l_c) \
            and abs(g_g - g_c) <= 1e-5 * abs(g_c) and worst <= 1e-4
        kinds = {"ssm": ("ssd_scan",), "hybrid": ("flash_attention",
                                                  "ssd_scan")}
        for key in kinds.get(cfg.kind, ("flash_attention",)):
            if not launches.get(key):
                ok = False
        print(f"  {cfg.name} float32 train step, card vs CPU: loss {l_g:.7f} "
              f"vs {l_c:.7f}, grad norm {g_g:.6f} vs {g_c:.6f}, worst grad "
              f"leaf (first moment, 0.1 x clipped grad) {worst:.3e} of its "
              f"max abs; launches {launches} {'OK' if ok else 'FAIL'}")
        if not ok:
            fail(f"train {arch} smoke: the card's step is off the CPU's")


def train_loop_check(torch, np) -> dict:
    """Phase 16 (e): ``train_loop`` at smoke size on the card: preempted at
    6 and resumed, against the run that was not stopped; then 30 steps."""
    import shutil
    import tempfile

    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import train_loop

    cfg = smoke_config("tinyllama_1_1b")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        kw = dict(global_batch=4, seq_len=32, device="cuda", log_every=100,
                  ckpt_every=3)
        whole = train_loop(cfg, 8, f"{tmp}/whole", **kw)
        r1 = train_loop(cfg, 8, f"{tmp}/cut", preempt_at=6, **kw)
        r2 = train_loop(cfg, 8, f"{tmp}/cut", resume=True, **kw)
        if r1["status"] != "preempted" or r2["status"] != "done" \
                or len(r1["losses"]) != 6 or len(r2["losses"]) != 2:
            fail(f"train loop: preempt/resume returned {r1} then {r2}")
        resumed = r1["losses"] + r2["losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(resumed,
                                                      whole["losses"]))
        how = "bit for bit" if resumed == whole["losses"] else \
            "within 1e-6 relative"
        print(f"  train_loop {cfg.name}, 8 steps, batch 4 x 32, checkpoints "
              f"every 3, preempted at 6 and resumed: losses "
              f"{[round(x, 6) for x in resumed]}; largest relative gap to "
              f"the uninterrupted run {gap:.3e}: {how}")
        if gap > 1e-6:
            fail(f"train loop: the resumed run leaves the uninterrupted one "
                 f"by {gap}")
        long = train_loop(cfg, 30, f"{tmp}/long", **{**kw,
                                                      "ckpt_every": 100})
        first, last = np.mean(long["losses"][:5]), \
            np.mean(long["losses"][-5:])
        print(f"  train_loop 30 steps: mean loss of the first five "
              f"{first:.6f}, of the last five {last:.6f}")
        if not last < first:
            fail("train loop: the loss did not fall over 30 steps")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"resume_gap": gap, "resume": how}


# The backward kernels' entries of the kernels line: source, the
# reference function they compute (no Pallas kernel), the forward kernel's
# entry and phase 16 (a)'s check at the main path's shape.
BWD_KERNELS = {
    "flash_attention_backward": (
        "src/repro_torch/kernels/csrc/flash_backward.cu",
        "src/repro/models/layers.py:258", "flash_attention",
        "tinyllama train"),
    "ssd_scan_backward": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/models/layers.py:577", "ssd_scan", "mamba2 train"),
}


def backward_entry(name: str, checks: dict, run: dict) -> dict:
    """A backward kernel's entry of the kernels line: its launches in each
    full-width step of phase 16 (b) or (c) (the main path of training), and
    phase 16 (a)'s numbers at that step's shape."""
    source, replaces, _, label = BWD_KERNELS[name]
    head = checks[label]
    e = {"name": name, "route": "cuda", "source": source,
         "replaces": replaces,
         "launches": run["launches_per_step"][0].get(name, 0),
         "max_abs_err": head["max_abs_err"], "ms": head["bwd_call_ms"],
         "plain_ms": head["bwd_plain_ms"], "bound_ms": head["bwd_bound_ms"],
         "bound_by": head["bwd_bound_by"],
         "library_ms": head["bwd_library_ms"], "device_ms": head["bwd_ms"],
         "train_launches_per_step": [got.get(name, 0) for got in
                                     run["launches_per_step"]],
         "train": checks}
    if name == "flash_attention_backward":
        e["launches_tc"] = run["launches_per_step"][0].get(
            "flash_attention_backward_tc", 0)
    return e


def train_phase(torch, np) -> dict:
    """Phase 16: training on the card, (a)-(e), (b)-(e) with the plain
    backwards barred from CUDA tensors. Returns the forward kernels'
    training entries (the launches counted in each step of (b) and (c)),
    (e)'s resume report, (b)'s witness for phase 17 and the backward
    kernels' entries."""
    t0 = time.perf_counter()
    report = train_kernel_checks(torch, np)
    print(f"  (a) {time.perf_counter() - t0:.3f}s")
    with no_plain_backward_on_the_card():
        t0 = time.perf_counter()
        tiny = train_full_width(torch, np, "tinyllama_1_1b", TRAIN_BATCH,
                                TRAIN_MICRO, 2,
                                {"flash_attention": 22 * TRAIN_MICRO * 2,
                                 "flash_attention_backward":
                                     22 * TRAIN_MICRO},
                                analyse=True)
        print(f"  (b) {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        mamba = train_full_width(torch, np, "mamba2_2_7b", MAMBA_TRAIN_BATCH,
                                 1, 1, {"ssd_scan": MAMBA_TRAIN_LAYERS * 2,
                                        "ssd_scan_backward":
                                            MAMBA_TRAIN_LAYERS},
                                 layers=MAMBA_TRAIN_LAYERS)
        print(f"  (c) {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        train_smoke_parity(torch, np)
        print(f"  (d) {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        loop = train_loop_check(torch, np)
        print(f"  (e) {time.perf_counter() - t0:.3f}s")
    # (b)'s losses, grad norms and state digests: phase 17 (a)'s witness
    tiny_ref = {k: tiny[k] for k in ("losses", "grad_norms")}
    tiny_ref["digests"] = tiny.pop("digests")
    mamba.pop("digests")
    runs = {"flash_attention": tiny, "ssd_scan": mamba}
    entries = [backward_entry(name, report[fwd], runs[fwd])
               for name, (_, _, fwd, _) in BWD_KERNELS.items()]
    report["flash_attention"]["tinyllama_1_1b"] = tiny
    report["ssd_scan"]["mamba2_2_7b"] = mamba
    return {name: {"train_launches_per_step": [
                got[name] for got in runs[name]["launches_per_step"]],
                "train": r}
            for name, r in report.items()}, loop, tiny_ref, entries


def mesh_train_full_width(torch, np, ref: dict, loop_want: list) -> dict:
    """Phase 17 (a): tinyllama-1.1b at full width on a 1x1 NCCL mesh,
    ``ShardedTrainStep`` from phase 16 (b)'s seeded init on its batches,
    held to (b)'s losses, grad norms and state digests bit for bit; the
    checkpoint gather of that state; ``train_loop`` preempted and resumed
    on the same group, held to ``loop_want`` (the card's uninterrupted
    one-rank run's losses)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.engine import GridMesh
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.steps import ShardedTrainStep
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build
    from repro_torch.obs import compiled
    from repro_torch.optim import AdamW, cosine_schedule

    total = torch.cuda.get_device_properties(0).total_memory
    MESH_TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    store = (MESH_TRAIN_DIR / "nccl_store").resolve()
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        mesh = GridMesh.create(1, 1)
        if mesh.mesh is None or dist.get_backend() != "nccl":
            fail(f"phase 17 (a): the 1x1 mesh is not on an NCCL group "
                 f"({dist.get_backend()})")
        cfg = get_config("tinyllama_1_1b")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build(cfg, "cuda")
        model.init_weights(torch.Generator("cuda").manual_seed(0))
        opt = AdamW(lr=cosine_schedule(3e-4, 10, 100))
        step = ShardedTrainStep(model, opt, mesh, TRAIN_MICRO)
        shards = step.shard(dict(model.named_parameters()))
        step.release()
        state = opt.init(shards)
        ds = SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, host_rank=0,
                             host_count=1)
        data = [{k: torch.as_tensor(v, device="cuda")
                 for k, v in ds.batch(s).items()}
                for s in range(len(ref["losses"]))]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        flash, walls, counts = [], [], []
        for s, batch in enumerate(data):
            compiled.reset_collectives()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            state, m = step(shards, state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_tc"])
            bwd = (LAUNCHES["flash_attention_backward"],
                   LAUNCHES["flash_attention_backward_tc"])
            flash.append(got[0])
            c = compiled.collective_counts(step.KEY)
            counts.append(c)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            same = loss == ref["losses"][s] and gn == ref["grad_norms"][s]
            print(f"  (a) meshed step {s + 1}: loss {loss:.6f}, grad norm "
                  f"{gn:.6f} ({'bit for bit' if same else 'DIFFERS from'} "
                  f"phase 16 (b)'s {ref['losses'][s]:.6f}, "
                  f"{ref['grad_norms'][s]:.6f}); wall {walls[-1]:.3f}s "
                  f"(16 (b): the same step unmeshed); flash launches "
                  f"{got[0]}, tensor-core {got[1]}; backward {bwd[0]}, "
                  f"tensor-core {bwd[1]}; collectives "
                  f"all-gather {c['all-gather']}, all-reduce "
                  f"{c['all-reduce']} (total {c['total']})")
            if not same:
                fail(f"phase 17 (a) step {s + 1}: loss or grad norm differs "
                     f"from phase 16 (b)'s")
            if got != (22 * TRAIN_MICRO * 2,) * 2:
                fail(f"phase 17 (a) step {s + 1}: flash launches {got}, "
                     f"expected {22 * TRAIN_MICRO * 2}, all tensor-core")
            if bwd != (22 * TRAIN_MICRO,) * 2:
                fail(f"phase 17 (a) step {s + 1}: flash backward launches "
                     f"{bwd}, expected {22 * TRAIN_MICRO}, all tensor-core")
            if (c["all-gather"], c["all-reduce"], c["total"]) != (1, 1, 2):
                fail(f"phase 17 (a) step {s + 1}: collectives {c}, expected "
                     "one all-gather and one all-reduce")
        digests = state_digests(torch, shards, state)
        off = sorted(k for k, v in ref["digests"].items()
                     if digests.get(k) != v)
        peak = torch.cuda.max_memory_allocated()
        print(f"  (a) after {len(data)} meshed steps: "
              f"{len(digests) - len(off)} of {len(ref['digests'])} "
              f"parameter and moment digests equal phase 16 (b)'s"
              f"{f' (differ: {off[:5]})' if off else ''}; shards "
              f"{3 * step.shard_bytes() / 2**30:.3f} GiB held between steps "
              f"({held / 2**30:.3f} GiB allocated); peak "
              f"{peak / 2**30:.3f} GiB, {peak / total:.4f} of the card")
        if off or set(digests) != set(ref["digests"]):
            fail(f"phase 17 (a): the meshed state differs from phase 16 "
                 f"(b)'s at {off[:10]}")
        if peak > TRAIN_MEM_SHARE * total:
            fail(f"phase 17 (a): peak {peak / total:.4f} of the card")

        # A checkpoint's gather of the same state: a tensor at a time to
        # the host, adding at most two of the largest tensor to the card.
        del data
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        # the caching allocator hands out blocks of 512 bytes
        largest = max(-(-t.numel() * 4 // 512) * 512 for t in shards.values())
        torch.cuda.reset_peak_memory_stats()
        compiled.reset_collectives()
        t0 = time.perf_counter()
        whole, whole_opt = step.gather_state(shards, state)
        t_gather = time.perf_counter() - t0
        added = torch.cuda.max_memory_allocated() - before
        c = compiled.collective_counts(step.CKPT_KEY)
        names = list(shards)
        same = all(torch.equal(d[n], src[n].cpu())
                   for n in (names[0], names[-1])
                   for d, src in ((whole, shards), (whole_opt.m, state.m),
                                  (whole_opt.v, state.v)))
        print(f"  (a) checkpoint gather: {3 * step.shard_bytes() / 2**30:.3f}"
              f" GiB to the host in {t_gather:.3f}s, {c['all-gather']} "
              f"all-gathers (3 x {len(names)} tensors); card memory added "
              f"{added / 2**20:.1f} MiB, bar 2 x the largest tensor "
              f"{2 * largest / 2**20:.1f} MiB; host copy "
              f"{'equal to' if same else 'DIFFERS from'} the shards")
        if not same or added > 2 * largest \
                or c["all-gather"] != 3 * len(names):
            fail("phase 17 (a): the checkpoint gather is off its bars")
        del model, step, shards, state, whole, whole_opt
        torch.cuda.empty_cache()

        # The trainer's own loop on the NCCL group, preempted and resumed.
        cut = (MESH_TRAIN_DIR / "nccl_ckpt").resolve()
        shutil.rmtree(cut, ignore_errors=True)
        cfg = _smoke_config("tinyllama_1_1b")
        t0 = time.perf_counter()
        pre = train_loop(cfg, MESH_LOOP_STEPS, str(cut), device="cuda",
                         preempt_at=MESH_LOOP_PREEMPT, mesh=mesh, **MESH_LOOP)
        res = train_loop(cfg, MESH_LOOP_STEPS, str(cut), device="cuda",
                         resume=True, mesh=mesh, **MESH_LOOP)
        t_loop = time.perf_counter() - t0
        shutil.rmtree(cut, ignore_errors=True)
        losses = pre["losses"] + res["losses"]
        how = "bit for bit" if losses == loop_want else "DIFFERS from"
        print(f"  (a) train_loop on the 1x1 NCCL mesh, float32 smoke: "
              f"{pre['status']} at step {pre['step']}, resumed to "
              f"{res['step']} ({res['status']}), losses {losses}, {how} "
              f"the card's uninterrupted run; {t_loop:.3f}s")
        if pre["status"] != "preempted" or res["status"] != "done" \
                or losses != loop_want:
            fail(f"phase 17 (a): train_loop on NCCL gave {losses}, the "
                 f"uninterrupted run {loop_want}")
    finally:
        dist.destroy_process_group()
    return {"flash_launches_per_step": flash, "walls": walls,
            "collectives_per_step": [c["total"] for c in counts],
            "peak_gib": peak / 2**30, "gather_s": t_gather,
            "gather_added_mib": added / 2**20, "loop_s": t_loop}


def _pipe_stage(w, a):
    """Phase 17 (b)'s pipeline stage (a module-level function: spawned
    ranks unpickle it)."""
    import torch
    return torch.tanh(a @ w)


def _mesh_train_inputs(np):
    """Phase 17 (b)'s compression inputs per rank and pipeline weights and
    microbatches (the CPU tests' shapes)."""
    comp = [np.random.default_rng(100 + r).normal(
        size=MESH_COMP_SHAPE).astype(np.float32) for r in range(4)]
    n_stages, n_micro, bm, d = MESH_PIPE
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(n_stages, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_micro, bm, d)).astype(np.float32)
    return comp, w, x


def _smoke_batches(cfg, rank: int = 0, count: int = 1):
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import _extras
    ds = SyntheticTokens(cfg.vocab, MESH_SMOKE_BATCH, MESH_SMOKE_SEQ,
                         host_rank=rank, host_count=count,
                         extras=_extras(cfg, MESH_SMOKE_SEQ))
    return [ds.batch(s) for s in range(MESH_SMOKE_STEPS)]


def _smoke_config(arch: str):
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(arch), dtype="float32")


def split_reduces(cfg, m: int) -> int:
    """All-reduces over ``"model"`` of one microbatch of a decoder, MoE or
    Mamba-2 config on a ``"model"`` of ``m``, from its layer counts: the
    lookup, the cross entropy's max and sums and the head's gradient, then
    per block each split region's forward all-reduces (twice under remat)
    and its backward ones (attention 1 and 1, SwiGLU 1 and 1, experts 1
    and 2, the SSD mixer 2 and 2)."""
    if m == 1:
        return 0
    top = 4 if cfg.vocab % m == 0 else 0
    if cfg.kind == "ssm":
        block = [(2, 2)] if cfg.n_ssm_heads % m == 0 else []
    else:
        block = [(1, 1)] if cfg.n_heads % m == 0 else []
        if cfg.kind == "moe":
            block += [(1, 2)] if cfg.n_experts % m == 0 else []
        elif cfg.d_ff % m == 0:
            block += [(1, 1)]
    fwd = sum(f for f, _ in block) * cfg.n_layers
    bwd = sum(b for _, b in block) * cfg.n_layers
    return top + (2 if cfg.remat else 1) * fwd + bwd


def _full_cut_config(arch: str):
    """Phase 17 (c)'s config: ``arch`` at full width, depth cut."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=MESH_FULL_LAYERS)


def _full_batches(torch, cfg, rank: int = 0, count: int = 1) -> list:
    from repro_torch.data import SyntheticTokens
    ds = SyntheticTokens(cfg.vocab, MESH_FULL_BATCH, MESH_FULL_SEQ,
                         host_rank=rank, host_count=count)
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in ds.batch(s).items()} for s in range(MESH_FULL_STEPS)]


def mesh_full_rank(torch, mesh, arch: str, out: pathlib.Path,
                   rank: int) -> dict:
    """Phase 17 (c) on one rank of the 2x2 mesh: ``arch`` at full width
    (depth cut), the split forward's logits of its rows, then its meshed
    steps with the flash and SSD launches counted and their shapes seen;
    rank 0 keeps one launch's inputs of each kernel and runs its last step
    under ``op_analysis`` beside its helpers' own byte counts."""
    from repro_torch.kernels import LAUNCHES, ops
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.steps import ShardedTrainStep
    from repro_torch.models import build
    from repro_torch.obs import compiled
    from repro_torch.optim import AdamW, cosine_schedule

    cfg = _full_cut_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, "cuda")
    model.init_weights(torch.Generator("cuda").manual_seed(0))
    whole_bytes = 4 * sum(p.numel() for p in model.parameters())
    opt = AdamW(lr=cosine_schedule(3e-4, 10, 100))
    step = ShardedTrainStep(model, opt, mesh, MESH_FULL_MICRO)
    shards = step.shard(dict(model.named_parameters()))
    step.release()
    state = opt.init(shards)
    data = _full_batches(torch, cfg, mesh.data_rank, mesh.data_shards)
    seen = collections.Counter()
    real = {"flash_attention": ops.flash_attention, "ssd": ops.ssd}

    def keep(name, **tensors):
        path = out / f"full_{arch}_{name}.pt"
        if rank == 0 and not path.exists():
            torch.save(tensors, path)

    def flash(q, k, v, **kw):
        seen[f"flash q {tuple(q.shape)} kv {tuple(k.shape)}"] += 1
        keep("flash", q=q.detach(), k=k.detach(), v=v.detach(),
             kw=torch.tensor([kw["causal"], kw["window"], kw["prefix"]]))
        return real["flash_attention"](q, k, v, **kw)

    def ssd(x, dt, A, B, C, *, chunk=128, init_state=None):
        seen[f"ssd x {tuple(x.shape)} B {tuple(B.shape)}"] += 1
        keep("ssd", x=x.detach(), dt=dt.detach(), A=A.detach(),
             B=B.detach(), C=C.detach(), chunk=torch.tensor(chunk))
        return real["ssd"](x, dt, A, B, C, chunk=chunk, init_state=init_state)

    ops.flash_attention, ops.ssd = flash, ssd
    rec = {"losses": [], "norms": [], "launches": [], "walls": [],
           "counts": []}
    try:
        torch.save(step.logits(shards, data[0]).cpu(),
                   out / f"full_{arch}_logits{rank}.pt")
        for i, b in enumerate(data):
            seen.clear()
            compiled.reset_collectives()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            if rank == 0 and i == len(data) - 1:   # (b): analysed
                ana = analyze(step, shards, state, b)
                state, m = ana["result"]
                rec["analysis"] = {
                    "flops": ana["flops"], "bytes": ana["bytes"],
                    "collectives": ana["collectives"],
                    "helpers": compiled.collective_bytes(step.KEY),
                    "batch": {k: [list(v.shape), str(v.dtype)]
                              for k, v in b.items()}}
            else:
                state, m = step(shards, state, b)
            torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec["launches"].append(dict(LAUNCHES))
            rec["counts"].append(compiled.collective_counts(step.KEY))
            rec["losses"].append(float(m["loss"]))
            rec["norms"].append(float(m["grad_norm"]))
    finally:
        ops.flash_attention, ops.ssd = real["flash_attention"], real["ssd"]
    rec.update(shapes=dict(seen), compute_bytes=step.compute_bytes(),
               whole_bytes=whole_bytes, shard_bytes=step.shard_bytes(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del model, step, shards, state, data
    torch.cuda.empty_cache()
    return rec


def _serve_split_config(arch: str):
    """(c)'s serve config: ``arch`` at full width, at its depth cut."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    depth = MESH_SERVE_DEPTH[arch]
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


def _serve_prompts(np, cfg):
    """Phase 5's first group of prompts."""
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT),
        dtype=np.int32)[:SERVE_BATCH]


def serve_reduces(cfg) -> int:
    """All-reduces over ``"model"`` (2 wide) of one split prefill or decode
    step of a decoder or Mamba-2 config, from its layer counts: the
    lookup and greedy's two maxima where the vocab splits, then per layer
    attention's and the SwiGLU's one each, or the SSD mixer's two (its
    gated norm's sum and its output)."""
    top = 3 if cfg.vocab % 2 == 0 else 0
    if cfg.kind == "ssm":
        return top + 2 * cfg.n_layers * (cfg.n_ssm_heads % 2 == 0)
    return top + cfg.n_layers * ((cfg.n_heads % 2 == 0) + (cfg.d_ff % 2 == 0))


def mesh_serve_rank(torch, np, mesh, arch: str, out: pathlib.Path,
                    rank: int) -> dict:
    """Phase 17 (c)'s split serve on one rank: ``ShardedServeStep`` with the
    rank's slices of the seeded init, one prefill and ``SERVE_NEW - 1``
    decodes of its ``"data"`` rows of phase 5's first group; its launches,
    their shapes, its cache and collectives; each step's logits, kept as
    the model returns them to the step and gathered over ``"model"`` for
    the check afterwards (under a program key of their own). Rank 0 keeps
    one launch's inputs."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import LAUNCHES, ops
    from repro_torch.launch.steps import ShardedServeStep
    from repro_torch.models import build
    from repro_torch.obs import compiled

    cfg = _serve_split_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whole = build(cfg, "cuda")
    whole.init_weights(torch.Generator("cuda").manual_seed(0))
    whole_bytes = 4 * sum(p.numel() for p in whole.parameters())
    step = ShardedServeStep(build(cfg, "meta"), mesh,
                            SERVE_PROMPT + SERVE_NEW)
    step.load(dict(whole.named_parameters()), "cuda")
    del whole
    torch.cuda.empty_cache()
    rows = SERVE_BATCH // mesh.data_shards
    at = slice(mesh.data_rank * rows, (mesh.data_rank + 1) * rows)
    batch = {"tokens": torch.as_tensor(_serve_prompts(np, cfg)[at],
                                       device="cuda")}
    seen = collections.Counter()
    real = {"flash_attention": ops.flash_attention, "ssd": ops.ssd}

    def keep(name, **tensors):
        path = out / f"serve_{arch}_{name}.pt"
        if rank == 0 and not path.exists():
            torch.save(tensors, path)

    def flash(q, k, v, **kw):
        seen[f"flash q {tuple(q.shape)} kv {tuple(k.shape)}"] += 1
        keep("flash", q=q, k=k, v=v,
             kw=torch.tensor([kw["causal"], kw["window"], kw["prefix"]]))
        return real["flash_attention"](q, k, v, **kw)

    def ssd(x, dt, A, B, C, *, chunk=128, init_state=None):
        seen[f"ssd x {tuple(x.shape)} B {tuple(B.shape)}"] += 1
        keep("ssd", x=x, dt=dt, A=A, B=B, C=C, chunk=torch.tensor(chunk))
        return real["ssd"](x, dt, A, B, C, chunk=chunk, init_state=init_state)

    model, kept = step.model, []

    def keeping(fn):
        def call(*a, **k):
            lg, cache = fn(*a, **k)
            kept.append(lg[:, -1])
            return lg, cache
        return call

    ops.flash_attention, ops.ssd = flash, ssd
    model.prefill, model.decode = keeping(model.prefill), \
        keeping(model.decode)
    try:
        compiled.reset_collectives()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        tok, cache = step.prefill(batch)
        toks = [tok]
        for t in range(SERVE_NEW - 1):
            tok, cache = step.decode(cache, tok, SERVE_PROMPT + t)
            toks.append(tok)
        tokens = torch.cat(toks, 1).cpu().numpy()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        ops.flash_attention, ops.ssd = real["flash_attention"], real["ssd"]
        del model.prefill, model.decode
    rec = {"tokens": tokens.tolist(), "wall": wall, "launches": launches,
           "shapes": dict(seen),
           "cache": {k: list(v.shape) for k, v in cache.items()},
           "counts": [compiled.collective_counts(k)["total"] for k in
                      (step.PREFILL_KEY, step.DECODE_KEY)],
           "param_bytes": step.param_bytes(), "whole_bytes": whole_bytes}
    del cache
    vocab = step.plan.splits.get("")
    with compiled.program("phase17.serve.check"), torch.inference_mode():
        got = [(tp.gather_from_model(lg, mesh, -1) if vocab else lg)
               .float().cpu() for lg in kept]
    np.save(out / f"serve_{arch}_logits{rank}.npy",
            torch.stack(got, 1).numpy())
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del step, model, kept
    torch.cuda.empty_cache()
    return rec


def mesh_train_rank(rank: int, out_dir: str) -> None:
    """One of phase 17 (b) and (c)'s four gloo ranks on the card
    (spawned)."""
    import datetime
    import os

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import numpy as np
    import torch
    import torch.distributed as dist

    out = pathlib.Path(out_dir)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{out / 'store'}", world_size=4,
        rank=rank, timeout=datetime.timedelta(seconds=MESH_TRAIN_TIMEOUT))
    in_group = True
    try:
        no_plain_backward_on_the_card().__enter__()   # for the rank's life
        from repro_torch.distributed import (
            compressed_psum_tree, pipeline_apply)
        from repro_torch.engine import GridMesh
        from repro_torch.engine.mesh import regroup
        from repro_torch.kernels import LAUNCHES
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import ShardedTrainStep
        from repro_torch.launch.train import train_loop
        from repro_torch.models import build
        from repro_torch.obs import compiled
        from repro_torch.optim import AdamW

        meta = {"backend": dist.get_backend()}
        watch = compiled.CompileWatch()
        torch.cuda.reset_peak_memory_stats()
        with watch:
            mesh = GridMesh.create(2, 2)
            meta["coords"] = [mesh.data_rank, mesh.model_rank]
            for arch in MESH_SMOKE_ARCHS:
                cfg = _smoke_config(arch)
                model = build(cfg, "cuda")
                model.init_weights(torch.Generator("cuda").manual_seed(0))
                opt = AdamW(lr=MESH_SMOKE_LR)
                step = ShardedTrainStep(model, opt, mesh, 2)
                shards = step.shard(dict(model.named_parameters()))
                step.release()
                state = opt.init(shards)
                rec = {"device": str(shards["embed"].device),
                       "held": sum(t.numel() * t.element_size()
                                   for d in (shards, state.m, state.v)
                                   for t in d.values()),
                       "shard_bytes": step.shard_bytes(),
                       "compute_bytes": step.compute_bytes(),
                       "whole_between": sum(p.numel()
                                            for p in model.parameters()),
                       "losses": [], "norms": [], "launches": [],
                       "counts": []}
                for s, b in enumerate(_smoke_batches(cfg, mesh.data_rank,
                                                     mesh.data_shards)):
                    compiled.reset_collectives()
                    LAUNCHES.clear()
                    state, m = step(shards, state, {
                        k: torch.as_tensor(v, device="cuda")
                        for k, v in b.items()})
                    torch.cuda.synchronize()
                    rec["launches"].append(dict(LAUNCHES))
                    rec["counts"].append(
                        compiled.collective_counts(step.KEY)["total"])
                    rec["losses"].append(float(m["loss"]))
                    rec["norms"].append(float(m["grad_norm"]))
                    got = step.gather_state(shards, state, keep=rank == 0)
                    if got is not None:     # rank 0: the state after step s
                        np.savez(out / f"smoke_{arch}_step{s + 1}.npz",
                                 **{f"p.{n}": t.numpy()
                                    for n, t in got[0].items()},
                                 **{f"m.{n}": t.numpy()
                                    for n, t in got[1].m.items()},
                                 **{f"v.{n}": t.numpy()
                                    for n, t in got[1].v.items()})
                rec["whole_after"] = sum(p.numel()
                                         for p in model.parameters())
                meta[arch] = rec
                del model, step, shards, state

            for arch in MESH_FULL_ARCHS:
                meta[f"full {arch}"] = mesh_full_rank(torch, mesh, arch, out,
                                                      rank)
            for arch in MESH_SERVE_DEPTH:
                meta[f"serve {arch}"] = mesh_serve_rank(torch, np, mesh,
                                                        arch, out, rank)

            comp, w, x = _mesh_train_inputs(np)
            g = {"w": torch.from_numpy(comp[rank]).cuda()}
            with compiled.program("phase17.compress"):
                mean, _ = compressed_psum_tree(
                    g, {"w": torch.zeros_like(g["w"])},
                    make_mesh((4,), ("data",)), "data")
            np.save(out / f"compress{rank}.npy", mean["w"].cpu().numpy())
            with compiled.program("phase17.pipeline"):
                y = pipeline_apply(_pipe_stage, torch.from_numpy(w).cuda(),
                                   torch.from_numpy(x).cuda(), MESH_PIPE[0],
                                   make_mesh((4,), ("stage",)))
            np.save(out / f"pipe{rank}.npy", y.cpu().numpy())
            meta["comp_pipe_counts"] = [
                compiled.collective_counts(k)["total"]
                for k in ("phase17.compress", "phase17.pipeline")]

            cfg = _smoke_config("tinyllama_1_1b")
            cut = str(out / "ckpt")
            meta["preempted"] = train_loop(
                cfg, MESH_LOOP_STEPS, cut, device="cuda",
                preempt_at=MESH_LOOP_PREEMPT, mesh=mesh, **MESH_LOOP)
            in_group = regroup(2, f"file://{out / 'store2'}")
            if in_group:
                small = GridMesh.create(1, 2)
                meta["small_coords"] = [small.data_rank, small.model_rank]
                meta["resumed"] = train_loop(
                    cfg, MESH_LOOP_STEPS, cut, device="cuda", resume=True,
                    mesh=small, **MESH_LOOP)
        meta["compiles"] = watch.compiles
        meta["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        (out / f"rank{rank}.json").write_text(json.dumps(meta))
        if in_group:
            # No rank tears its connections down while another is still in
            # a collective with it.
            dist.barrier()
    finally:
        if in_group:
            dist.destroy_process_group()


def mesh_loop_witness() -> list:
    """The losses of phase 17's ``train_loop`` run on the card's one rank,
    not stopped: what its preempted and resumed runs are held to."""
    import shutil
    import tempfile

    from repro_torch.launch.train import train_loop

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    try:
        return train_loop(_smoke_config("tinyllama_1_1b"), MESH_LOOP_STEPS,
                          tmp, device="cuda", **MESH_LOOP)["losses"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def smoke_step_from(torch, arch: str, s: int, before):
    """One one-rank step of ``arch``'s float32 smoke config on the card, on
    (b)'s global batch ``s`` with two microbatches, from the whole state
    ``before`` (``p.``/``m.``/``v.`` arrays; None: the seeded init) ->
    ((loss, grad norm), the state after it as arrays)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import AdamW, OptState

    cfg = _smoke_config(arch)
    model = build(cfg, "cuda")
    model.init_weights(torch.Generator("cuda").manual_seed(0))
    params = dict(model.named_parameters())
    opt = AdamW(lr=MESH_SMOKE_LR)
    state = opt.init(params)
    if before is not None:
        on = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(on(before[f"p.{n}"]))
        state = OptState(step=torch.tensor(s, dtype=torch.int32,
                                           device="cuda"),
                         m={n: on(before[f"m.{n}"]) for n in params},
                         v={n: on(before[f"v.{n}"]) for n in params})
    b = _smoke_batches(cfg)[s]
    state, m = make_train_step(model, opt, 2)(
        state, {k: torch.as_tensor(v, device="cuda") for k, v in b.items()})
    after = {f"p.{n}": p.detach().cpu().numpy() for n, p in params.items()}
    after.update({f"m.{n}": t.cpu().numpy() for n, t in state.m.items()})
    after.update({f"v.{n}": t.cpu().numpy() for n, t in state.v.items()})
    return (float(m["loss"]), float(m["grad_norm"])), after


def state_gap(np, got: dict, want: dict) -> tuple[float, float, int]:
    """(the largest parameter gap but the sign knife edges of Adam's
    update, entries whose first moment is below 1e-3 of its tensor's
    largest; the largest moment gap over its tensor's largest entry; the
    knife edges counted)."""
    p_gap = m_gap = 0.0
    edges = 0
    for k, w in want.items():
        if k.startswith("p."):
            g = np.abs(want["m." + k[2:]])
            edge = (g < 1e-3 * g.max()) & (g > 0)
            edges += int(edge.sum())
            p_gap = max(p_gap, float(np.where(edge, 0.0,
                                              np.abs(got[k] - w)).max()))
        else:
            m_gap = max(m_gap, float(np.abs(got[k] - w).max())
                        / max(float(np.abs(w).max()), 1e-30))
    return p_gap, m_gap, edges


def mesh_full_witness(torch) -> dict:
    """Phase 17 (c)'s one-rank steps on the card at the same cut: per
    arch the first batch's logits (on the host), the losses, launches,
    walls, parameter bytes and peak memory of ``make_train_step`` with
    the same two microbatches."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import AdamW, cosine_schedule

    out = {}
    for arch in MESH_FULL_ARCHS:
        cfg = _full_cut_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build(cfg, "cuda")
        model.init_weights(torch.Generator("cuda").manual_seed(0))
        data = _full_batches(torch, cfg)
        with torch.no_grad():
            logits = model(data[0])[0].cpu()
        params = dict(model.named_parameters())
        opt = AdamW(lr=cosine_schedule(3e-4, 10, 100))
        state = opt.init(params)
        step = make_train_step(model, opt, MESH_FULL_MICRO)
        rec = {"logits": logits, "losses": [], "launches": [], "walls": [],
               "bytes": 4 * sum(p.numel() for p in params.values())}
        for b in data:
            LAUNCHES.clear()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec["launches"].append(dict(LAUNCHES))
            rec["losses"].append(float(m["loss"]))
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[arch] = rec
        del model, params, opt, state, step, data
        torch.cuda.empty_cache()
    return out


def mesh_full_check(torch, out: pathlib.Path, metas: list, ref: dict):
    """Phase 17 (c)'s checks on the four ranks' records against the
    one-rank witness ``ref``; then each kernel on rank 0's launch inputs
    against its plain version. Returns per kernel its (c) entry."""
    entries = {}
    for arch, kernel in MESH_FULL_ARCHS.items():
        cfg, want = _full_cut_config(arch), ref[arch]
        heads = MESH_FULL_HEADS[arch]
        n_split = 2 + split_reduces(cfg, 2)
        for r, meta in enumerate(metas):
            got = meta[f"full {arch}"]
            d = meta["coords"][0]
            rows = MESH_FULL_BATCH // 2
            logits = torch.load(out / f"full_{arch}_logits{r}.pt")
            rms = _rel_rms(logits, want["logits"][d * rows:(d + 1) * rows])
            gaps = [abs(a - b) / abs(b)
                    for a, b in zip(got["losses"], want["losses"])]
            per = [{k: n // 2 for k, n in w.items()}
                   for w in want["launches"]]
            launches = [{k: v for k, v in x.items() if k in per[0]}
                        for x in got["launches"]]
            print(f"  (c) rank {r} at {tuple(meta['coords'])}, {cfg.name} "
                  f"({cfg.n_layers} layers at full width, {MESH_FULL_BATCH} "
                  f"x {MESH_FULL_SEQ}, bf16): first-step logits rel. RMS "
                  f"{rms:.3e} (bar {MESH_FULL_LOGIT_TOL}); losses "
                  f"{got['losses']} against the one-rank "
                  f"{want['losses']}, gaps {[f'{g:.2e}' for g in gaps]} (bar "
                  f"{MESH_FULL_LOSS_TOL}); walls "
                  f"{[round(w, 3) for w in got['walls']]} s (one rank "
                  f"{[round(w, 3) for w in want['walls']]}); launches "
                  f"{launches}; shapes {got['shapes']}; collectives "
                  f"{[c['total'] for c in got['counts']]} (want {n_split}); "
                  f"parameters during the step {got['compute_bytes']} B "
                  f"against the one-rank {want['bytes']} B "
                  f"({got['compute_bytes'] / want['bytes']:.4f}); peak "
                  f"{got['peak_gib']:.3f} GiB (one rank "
                  f"{want['peak_gib']:.3f})")
            faults = []
            if rms > MESH_FULL_LOGIT_TOL or max(gaps) > MESH_FULL_LOSS_TOL:
                faults.append("off its bfloat16 bars")
            if launches != per or not all(x.get(
                    "flash_attention" if kernel == "flash_attention"
                    else "ssd_scan") for x in launches):
                faults.append(f"launches {launches}, want {per}")
            if kernel == "flash_attention" and any(
                    x.get(f"{key}_tc") != x.get(key) for x in got["launches"]
                    for key in ("flash_attention", "flash_attention_backward")):
                faults.append("a flash launch off the tensor cores")
            want_shape = "flash q (1, %d, %d, %d) kv (1, %d, %d, %d)" % (
                MESH_FULL_SEQ, heads[0], cfg.dh, MESH_FULL_SEQ, heads[1],
                cfg.dh) if kernel == "flash_attention" else \
                "ssd x (1, %d, %d, %d) B (1, %d, 1, %d)" % (
                    MESH_FULL_SEQ, heads[0], cfg.ssm_head_dim, MESH_FULL_SEQ,
                    cfg.d_state)
            if set(got["shapes"]) != {want_shape}:
                faults.append(f"shapes {got['shapes']}, want {want_shape}")
            if any(c["total"] != n_split for c in got["counts"]):
                faults.append(f"collectives {got['counts']}")
            if not got["compute_bytes"] < 0.6 * want["bytes"]:
                faults.append("the rank computes with whole parameters")
            if faults:
                fail(f"phase 17 (c) rank {r} {arch}: {'; '.join(faults)}")
        tag = "flash" if kernel == "flash_attention" else "ssd"
        inputs = torch.load(out / f"full_{arch}_{tag}.pt",
                            map_location="cuda")
        per_rank = metas[0][f"full {arch}"]["launches"][0].get(kernel, 0)
        if kernel == "flash_attention":
            c, w, pre = inputs["kw"].tolist()
            e = flash_entry(torch, ((inputs["q"], inputs["k"], inputs["v"],
                                     None), {"causal": bool(c), "window": w,
                                             "prefix": pre}),
                            "phase 17 (c) rank 0", per_rank)
        else:
            e = ssd_entry(torch, ((inputs["x"], inputs["dt"], inputs["A"],
                                   inputs["B"], inputs["C"],
                                   int(inputs["chunk"])), {}),
                          "phase 17 (c) rank 0", per_rank)
        entries[kernel] = {k: e[k] for k in (
            "launches", "shape", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err")}
    return entries


def mesh_serve_witness(torch, np) -> dict:
    """Phase 17 (c)'s one-rank serves at the split serve's configs: per
    arch the tokens (tinyllama-1.1b: phase 5's own; mamba2-2.7b:
    ``serve_requests`` at the cut) and the logits of each step teacher-
    forced on them (``model.prefill`` and ``model.decode``, the steps'
    own calls), float32 on the host."""
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import build

    out = {}
    for arch in MESH_SERVE_DEPTH:
        cfg = _serve_split_config(arch)
        prompts = _serve_prompts(np, cfg)
        if arch in SERVED:
            tokens = SERVED[arch][:SERVE_BATCH]
        else:
            tokens = serve_requests(cfg, prompts, SERVE_BATCH, SERVE_NEW,
                                    device="cuda")[0]
        model = build(cfg, "cuda")
        model.init_weights(torch.Generator("cuda").manual_seed(0))
        ref = torch.as_tensor(tokens, device="cuda")
        lg, cache = model.prefill(
            {"tokens": torch.as_tensor(prompts, device="cuda")},
            max_len=SERVE_PROMPT + SERVE_NEW)
        got = [lg[:, -1].float().cpu()]
        for t in range(SERVE_NEW - 1):
            lg, cache = model.decode(cache, ref[:, t:t + 1], SERVE_PROMPT + t)
            got.append(lg[:, -1].float().cpu())
        out[arch] = {"tokens": np.asarray(tokens),
                     "logits": torch.stack(got, 1).numpy(),
                     "from": "phase 5" if arch in SERVED else "serve_requests"}
        del model, cache, lg
        torch.cuda.empty_cache()
    return out


def mesh_serve_check(torch, np, out: pathlib.Path, metas: list,
                     want: dict) -> dict:
    """Phase 17 (c)'s split serve against the one-rank witness: tokens
    equal up to each request's first knife edge (a step whose one-rank
    top two logits lie within two bfloat16 ulps, or where the split's own
    logit deviations could reorder the one-rank pick), the logits of every step
    whose inputs equal the witness's (up to each request's first
    differing token) within relative RMS 2e-2, exact launches (all
    tensor-core) and all-reduces from the layer counts, the rank's cache
    of its heads; then rank 0's launches against their plain versions.
    Returns per kernel its entry."""
    entries = {}
    for arch in MESH_SERVE_DEPTH:
        cfg, ref = _serve_split_config(arch), want[arch]
        n_red = serve_reduces(cfg)
        rows = SERVE_BATCH // 2
        for r, meta in enumerate(metas):
            got = meta[f"serve {arch}"]
            d = meta["coords"][0]
            at = slice(d * rows, (d + 1) * rows)
            lg = np.load(out / f"serve_{arch}_logits{r}.npy")
            wl, wt = ref["logits"][at], ref["tokens"][at]
            toks = np.asarray(got["tokens"])
            # step t's inputs are the tokens before t: equal to the
            # witness's through the first differing token
            first = [int(np.argmax(toks[i] != wt[i])) if (toks[i] != wt[i])
                     .any() else SERVE_NEW for i in range(rows)]
            same_in = np.arange(SERVE_NEW)[None, :] <= np.minimum(
                np.array(first)[:, None], SERVE_NEW - 1)
            d2 = ((lg - wl) ** 2).mean(axis=-1)[same_in]
            rms = float(np.sqrt(d2.mean())
                        / np.sqrt((wl ** 2).mean(axis=-1)[same_in].mean()))
            # a knife edge: a step where the split's own deviation could
            # reorder the one-rank pick a with some c (l_a - l_c within
            # |d_a| + |d_c|), or the one-rank top two lie within two
            # bfloat16 ulps
            a = wl.argmax(axis=-1)[..., None]
            dev = np.abs(lg - wl)
            margin = np.take_along_axis(wl, a, -1) - wl \
                - np.take_along_axis(dev, a, -1) - dev
            np.put_along_axis(margin, a, np.inf, -1)
            top2 = np.sort(wl, axis=-1)[..., -2:]
            ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[..., 1]))) - 7)
            edge = (margin.min(axis=-1) <= 0) \
                | (top2[..., 1] - top2[..., 0] <= 2 * ulp)
            knife = [int(np.argmax(e)) if e.any() else SERVE_NEW
                     for e in edge]
            equal = all(np.array_equal(toks[i, :knife[i]], wt[i, :knife[i]])
                        for i in range(rows))
            same = int((toks == wt).all(axis=1).sum())
            print(f"  (c) split serve, rank {r} at {tuple(meta['coords'])}, "
                  f"{cfg.name} ({cfg.n_layers} layers at full width, rows "
                  f"{at.start}-{at.stop - 1} of {SERVE_BATCH} x "
                  f"{SERVE_PROMPT}, {SERVE_NEW} new): tokens "
                  f"{'equal' if equal else 'DIFFER from'} the one-rank "
                  f"serve's ({ref['from']}) up to the knife edges {knife} "
                  f"({same} of {rows} equal throughout); logits of the "
                  f"steps with the witness's inputs rel. RMS {rms:.3e} (bar "
                  f"{MESH_SERVE_LOGIT_TOL}); "
                  f"serve wall {got['wall']:.3f}s; launches "
                  f"{got['launches']}; shapes {got['shapes']}; cache "
                  f"{got['cache']}; all-reduces {got['counts']} (want "
                  f"[{n_red}, {n_red * (SERVE_NEW - 1)}]); parameters held "
                  f"{got['param_bytes']} B of {got['whole_bytes']} B "
                  f"({got['param_bytes'] / got['whole_bytes']:.4f}); peak "
                  f"{got['peak_gib']:.3f} GiB")
            faults = []
            if not equal or rms > MESH_SERVE_LOGIT_TOL:
                faults.append("off the one-rank serve")
            expect = MESH_SERVE_LAUNCHES[arch]
            if {k: got["launches"].get(k, 0) for k in expect} != expect:
                faults.append(f"launches {got['launches']}, want {expect}")
            if "flash_attention" in expect and got["launches"].get(
                    "flash_attention_tc") != expect["flash_attention"]:
                faults.append("a flash launch off the tensor cores")
            if cfg.kind == "ssm":
                want_shape = "ssd x (%d, %d, %d, %d) B (%d, %d, 1, %d)" % (
                    rows, SERVE_PROMPT, cfg.n_ssm_heads // 2,
                    cfg.ssm_head_dim, rows, SERVE_PROMPT, cfg.d_state)
                heads = got["cache"]["ssd"][2] == cfg.n_ssm_heads // 2
            else:
                want_shape = "flash q (%d, %d, %d, %d) kv (%d, %d, %d, %d)" \
                    % (rows, SERVE_PROMPT, cfg.n_heads // 2, cfg.dh, rows,
                       SERVE_PROMPT, cfg.n_kv_heads // 2, cfg.dh)
                heads = got["cache"]["k"][3] == cfg.n_kv_heads // 2
            if set(got["shapes"]) != {want_shape} or not heads:
                faults.append(f"shapes {got['shapes']} (want {want_shape}),"
                              f" cache {got['cache']}")
            if got["counts"] != [n_red, n_red * (SERVE_NEW - 1)]:
                faults.append(f"all-reduces {got['counts']}")
            if not got["param_bytes"] < 0.6 * got["whole_bytes"]:
                faults.append("the rank holds whole parameters")
            if faults:
                fail(f"phase 17 (c) split serve rank {r} {arch}: "
                     f"{'; '.join(faults)}")
        kernel = next(iter(MESH_SERVE_LAUNCHES[arch]))
        tag = "flash" if kernel == "flash_attention" else "ssd"
        inputs = torch.load(out / f"serve_{arch}_{tag}.pt",
                            map_location="cuda")
        per_rank = metas[0][f"serve {arch}"]["launches"].get(kernel, 0)
        if kernel == "flash_attention":
            c, w, pre = inputs["kw"].tolist()
            e = flash_entry(torch, ((inputs["q"], inputs["k"], inputs["v"],
                                     None), {"causal": bool(c), "window": w,
                                             "prefix": pre}),
                            "phase 17 (c) split serve, rank 0", per_rank)
        else:
            e = ssd_entry(torch, ((inputs["x"], inputs["dt"], inputs["A"],
                                   inputs["B"], inputs["C"],
                                   int(inputs["chunk"])), {}),
                          "phase 17 (c) split serve, rank 0", per_rank)
        entries[kernel] = {k: e[k] for k in (
            "launches", "shape", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err")}
    return entries


def mesh_analysis_check(torch, metas: list) -> dict:
    """Phase 17 (c)'s analysed split step of rank 0 (``op_analysis`` on
    the card): its collective bytes against what its counted helpers
    recorded in that step, kind by kind, and against a meta trace of the
    same step on a 2x2 ``StandInMesh`` at rank 0's position."""
    from repro_torch.engine.mesh import StandInMesh
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.steps import ShardedTrainStep
    from repro_torch.models import build
    from repro_torch.optim import AdamW

    out = {}
    for arch in MESH_FULL_ARCHS:
        got = metas[0][f"full {arch}"]["analysis"]
        model = build(_full_cut_config(arch), "meta")
        opt = AdamW(lr=3e-4)
        step = ShardedTrainStep(model, opt, StandInMesh(
            ("data", "model"), (2, 2), 0), MESH_FULL_MICRO)
        shards = step.shard({n: p.detach()
                             for n, p in model.named_parameters()})
        step.release()
        batch = {k: torch.empty(shape, dtype=getattr(torch, dt.split(".")[-1]),
                                device="meta")
                 for k, (shape, dt) in got["batch"].items()}
        meta = analyze(step, shards, opt.init(shards), batch)
        same = got["collectives"] == got["helpers"] == meta["collectives"]
        print(f"  (c) rank 0's analysed split step of {arch}: collectives "
              f"{got['collectives']} B; its helpers recorded "
              f"{got['helpers']} B; the meta trace on a 2x2 stand-in "
              f"{meta['collectives']} B ({'equal' if same else 'DIFFER'}); "
              f"{got['flops']:.6e} FLOPs (meta {meta['flops']:.6e}), "
              f"{got['bytes']:.6e} bytes")
        if not same or got["flops"] != meta["flops"]:
            fail(f"phase 17 (c) {arch}: the analysed collectives or FLOPs "
                 "differ from the helpers' or the meta trace's")
        out[arch] = {"collectives": got["collectives"], "flops": got["flops"]}
    return out


def mesh_train_smoke(torch, np, whole: list) -> dict:
    """Phase 17 (b) and (c): a 2x2 mesh of four gloo ranks sharing the
    card; the card's one-rank runs first, as the witnesses (``whole``: the
    one-rank ``train_loop``'s losses)."""
    import shutil

    from repro_torch.distributed.compression import dequantize, quantize_ef
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import AdamW

    want = {}
    for arch in MESH_SMOKE_ARCHS:
        cfg = _smoke_config(arch)
        model = build(cfg, "cuda")
        model.init_weights(torch.Generator("cuda").manual_seed(0))
        opt = AdamW(lr=MESH_SMOKE_LR)
        params = dict(model.named_parameters())
        state = opt.init(params)
        step = make_train_step(model, opt, 2)
        rec = {"losses": [], "norms": [], "launches": [],
               "bytes": 4 * sum(p.numel() for p in params.values())}
        for b in _smoke_batches(cfg):
            LAUNCHES.clear()
            state, m = step(state, {k: torch.as_tensor(v, device="cuda")
                                    for k, v in b.items()})
            torch.cuda.synchronize()
            rec["launches"].append(dict(LAUNCHES))
            rec["losses"].append(float(m["loss"]))
            rec["norms"].append(float(m["grad_norm"]))
        want[arch] = rec
        del model, params, state
    full_want = mesh_full_witness(torch)
    serve_want = mesh_serve_witness(torch, np)
    comp, w, x = _mesh_train_inputs(np)
    qs = [quantize_ef(torch.from_numpy(c).cuda(),
                      torch.zeros(c.shape, device="cuda")) for c in comp]
    smax = torch.stack([s for _, s, _ in qs]).max()
    total = sum(torch.clamp(torch.round(dequantize(q, s) / smax), -127, 127)
                .to(torch.int32) for q, s, _ in qs)
    comp_want = (total.float() * smax / torch.tensor(4.0, device="cuda")) \
        .cpu().numpy()
    exact = np.mean(comp, axis=0)
    seq = torch.from_numpy(x).cuda()
    for s in range(MESH_PIPE[0]):
        seq = _pipe_stage(torch.from_numpy(w[s]).cuda(), seq)
    seq = seq.cpu().numpy()

    out = (MESH_TRAIN_DIR / "ranks").resolve()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for arch, ref in serve_want.items():
        np.save(out / f"serve_{arch}_tokens.npy", ref["tokens"])
    t0 = time.perf_counter()
    spawn_ranks(mesh_train_rank, 4, (str(out),), MESH_TRAIN_TIMEOUT,
                label="phase 17 (b)/(c)")
    t_ranks = time.perf_counter() - t0
    print(f"  (b)/(c) 2x2 mesh, four gloo ranks on the card: {t_ranks:.3f}s "
          f"start to end")
    metas = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(4)]

    # (b): each split step against the one-rank step from the same state.
    near = lambda a, b: abs(a - b) <= MESH_SPLIT_TOL * abs(b)  # noqa: E731
    for arch in MESH_SMOKE_ARCHS:
        before = None
        for s in range(MESH_SMOKE_STEPS):
            (loss, gn), ref_state = smoke_step_from(torch, arch, s, before)
            with np.load(out / f"smoke_{arch}_step{s + 1}.npz") as z:
                got = {k: z[k] for k in z.files}
            p_gap, m_gap, edges = state_gap(np, got, ref_state)
            print(f"  (b) {arch} step {s + 1}: the one-rank step from the "
                  f"meshed state before it: loss {loss:.7f}, grad norm "
                  f"{gn:.7f}; ranks' losses "
                  f"{[m[arch]['losses'][s] for m in metas]}, grad norms "
                  f"{[m[arch]['norms'][s] for m in metas]}; state after: "
                  f"parameters {p_gap:.3e} off ({edges} knife edges "
                  f"excluded), moments {m_gap:.3e} of their largest (bars "
                  f"{MESH_SPLIT_TOL})")
            if not all(near(m[arch]["losses"][s], loss)
                       and near(m[arch]["norms"][s], gn) for m in metas) \
                    or p_gap > MESH_SPLIT_TOL or m_gap > MESH_SPLIT_TOL:
                fail(f"phase 17 (b) {arch} step {s + 1}: the split step is "
                     "off the one-rank step from the same state")
            before = got
    rank0 = {}
    n_stages, n_micro = MESH_PIPE[:2]
    for r, meta in enumerate(metas):
        faults = []
        if meta["backend"] != "gloo" or meta["compiles"]:
            faults.append(f"backend {meta['backend']}, {meta['compiles']} "
                          "kernel build(s)")
        for arch in MESH_SMOKE_ARCHS:
            got, ref = meta[arch], want[arch]
            traj = all(near(a, b) for a, b in zip(got["losses"],
                                                  ref["losses"]))
            # a rank runs one of the two microbatches of each step
            halves = [{k: n // 2 for k, n in d.items()}
                      for d in ref["launches"]]
            ok_launch = got["launches"] == halves and all(
                d.get(k) for d in got["launches"]
                for k in (("ssd_scan",) if "mamba" in arch
                          else ("flash_attention",)))
            n_split = 2 + split_reduces(_smoke_config(arch), 2)
            print(f"  (b) rank {r} at {tuple(meta['coords'])}, {arch} "
                  f"float32 smoke on {got['device']}: losses "
                  f"{got['losses']} ({'within' if traj else 'OFF'} "
                  f"{MESH_SPLIT_TOL} of the one-rank run's "
                  f"{ref['losses']}); held between steps {got['held']} B = "
                  f"3 x its shards {got['shard_bytes']} B "
                  f"({'yes' if got['held'] == 3 * got['shard_bytes'] else 'NO'})"
                  f", whole parameters {got['whole_between']} and "
                  f"{got['whole_after']} elements; parameters during the "
                  f"step {got['compute_bytes']} B of the one-rank "
                  f"{ref['bytes']}; launches per step {got['launches']}; "
                  f"collectives per step {got['counts']} (want {n_split})")
            if not traj:
                faults.append(f"{arch}'s losses leave the one-rank run's")
            if not got["device"].startswith("cuda") or not ok_launch:
                faults.append(f"{arch} ran on {got['device']} with launches "
                              f"{got['launches']} (want {halves})")
            if got["held"] != 3 * got["shard_bytes"] \
                    or got["whole_between"] or got["whole_after"] \
                    or not got["compute_bytes"] < ref["bytes"]:
                faults.append(f"{arch} holds {got['held']} B, not 3 x "
                              f"{got['shard_bytes']}, or computes whole")
            if got["counts"] != [n_split] * MESH_SMOKE_STEPS:
                faults.append(f"{arch} collectives {got['counts']}")
            if r == 0:
                for d in got["launches"]:
                    for k, n in d.items():
                        rank0[k] = rank0.get(k, 0) + n
        comp_got = np.load(out / f"compress{r}.npy")
        pipe_got = np.load(out / f"pipe{r}.npy")
        rel = float(np.abs(comp_got - exact).max()
                    / max(float(np.abs(c).max()) for c in comp))
        pipe_err = float(np.abs(pipe_got - seq).max())
        print(f"  (b) rank {r}: compressed_psum_tree "
              f"{'bit for bit' if np.array_equal(comp_got, comp_want) else 'DIFFERS from'}"
              f" its one-process emulation, {rel:.3e} of the largest input "
              f"from the exact mean (bar 0.02); pipeline_apply {pipe_err:.3e} "
              f"from the sequential stages (bar 1e-5); collectives "
              f"{meta['comp_pipe_counts']} (want [2, {n_micro + n_stages}]);"
              f" peak {meta['peak_gib']:.3f} GiB")
        if not np.array_equal(comp_got, comp_want) or rel >= 0.02 \
                or pipe_err >= 1e-5 \
                or meta["comp_pipe_counts"] != [2, n_micro + n_stages]:
            faults.append("compression or pipeline off its bar")
        pre = meta["preempted"]
        loop_near = lambda a, b: len(a) == len(b) and all(  # noqa: E731
            near(x, y) for x, y in zip(a, b))
        if pre["status"] != "preempted" \
                or not loop_near(pre["losses"], whole[:MESH_LOOP_PREEMPT]):
            faults.append(f"the 2x2 run before the preemption: {pre}")
        if r < 2:
            res = meta["resumed"]
            how = "within %g of" % MESH_SPLIT_TOL if loop_near(
                res["losses"], whole[MESH_LOOP_PREEMPT:]) else "OFF"
            print(f"  (b) rank {r}: train_loop preempted on 2x2 at step "
                  f"{MESH_LOOP_PREEMPT}, resumed on 1x2 at "
                  f"{tuple(meta['small_coords'])}: losses "
                  f"{pre['losses'] + res['losses']}, {how} the card's "
                  f"uninterrupted run {whole}")
            if res["status"] != "done" or how == "OFF":
                faults.append(f"the resumed run {res} leaves {whole}")
        if faults:
            fail(f"phase 17 (b) rank {r}: {'; '.join(faults)}")
    full = mesh_full_check(torch, out, metas, full_want)
    analysed = mesh_analysis_check(torch, metas)
    served = mesh_serve_check(torch, np, out, metas, serve_want)
    return {"rank0_launches": rank0, "ranks_s": t_ranks, "full": full,
            "analysis": analysed, "serve": served}


def mesh_train_phase(torch, np, ref: dict) -> dict:
    """Phase 17: the mesh of the LM substrate, (a), (b) and (c). Returns
    (a)'s flash launches per step, rank 0's launches in (b) and (c)'s
    kernel entries."""
    with no_plain_backward_on_the_card():
        loop_want = mesh_loop_witness()
        t0 = time.perf_counter()
        a = mesh_train_full_width(torch, np, ref, loop_want)
        print(f"  (a) {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        b = mesh_train_smoke(torch, np, loop_want)
        print(f"  (b) and (c) {time.perf_counter() - t0:.3f}s")
    return {"a": a, "b": b}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=10000,
                    help="jobs in the Table 6 stream (paper: ~10000)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA GPU is visible (torch.cuda.is_available() is False)")
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"src/repro_torch not found next to {pathlib.Path(__file__).name}")
    sys.path.insert(0, str(root / "src"))

    import numpy as np

    from repro_torch.core import (
        benchmark_bid_policies, generate_chain_jobs, selfowned_policies)
    from repro_torch.core.simulate import (
        _WORK_EPS, simulate_chains_early, simulate_tasks)
    from repro_torch.device import BUILD_DIR, _library_path, _nvcc, build_kernels
    from repro_torch.engine import (
        build_grid_plan, evaluate_grid, make_scenarios, resolve_plan_backend)
    from repro_torch.experiments import table6
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import policy_cost as pc
    from repro_torch.kernels import learner_replay as lk
    from repro_torch.kernels import weight_update as wu
    from repro_torch.learn import LearnerSpec, Schedule
    from repro_torch.obs import capture
    from repro_torch.obs.compiled import work_bound

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build and device ------------------------------------------------
    t0 = time.perf_counter()
    probe_proc, probe_lib = start_latency_probe(BUILD_DIR, _nvcc())
    logs = build_kernels()
    probe_log, _ = probe_proc.communicate()
    if probe_proc.returncode != 0:
        fail(f"the latency probe did not build:\n{probe_log}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"[nvcc {name}] {line.strip()}")
    for fn_name, regs, spills in ptxas_summary(logs.get("flash_attention", ""),
                                               "flash_fwd_tc"):
        print(f"[ptxas flash_fwd_tc] {fn_name}: {regs}; {spills}")
    for fn_name, regs, spills in ptxas_summary(logs.get("ssd_scan", ""),
                                               "ssd_"):
        # e.g. ..._14ssd_chunk_scanI13__nv_bfloat16Li64EE...: pass<x, PW>
        m = re.search(r"(ssd_[a-z_]+?)(I(13__nv_bfloat16|f)Li(\d+)E)?E",
                      fn_name)
        label = m.group(1) if m else fn_name
        if m and m.group(2):
            x_type = "bf16" if m.group(3) == "13__nv_bfloat16" else "f32"
            label += f"<{x_type}, PW {m.group(4)}>"
        print(f"[ptxas ssd_scan] {label}: {regs}; {spills}")
    regs_of = {}
    for src, names in (("policy_cost", ("chain_smem_kernel", "chain_kernel",
                                        "task_tree_kernel")),
                       ("hedge_replay", ("trajectory_kernel",
                                         "sample_kernel")),
                       ("learner_replay", ("learner_block_kernel",))):
        for fn_name, regs, spills in ptxas_summary(logs.get(src, ""), "_"):
            label = next((n for n in names if n in fn_name), None)
            m = re.search(r"ILi(\d+)E", fn_name)
            if label:
                label += f"<{m.group(1)}>" if m else ""
                regs_of[label] = f"{regs}; {spills or 'no spill line'}"
                print(f"[ptxas {src}] {label}: {regs_of[label]}")
    # The task kernel's search tree at a horizon long enough for all its
    # levels.
    tree = pc.task_layout(max(TASK_HORIZONS))
    print(f"[policy_cost task_tree_kernel] layout at {max(TASK_HORIZONS)} "
          f"slots: {tree['depth']} tree levels, {tree['smem_bytes']} bytes "
          f"of shared memory per block, {tree['threads']} threads per block, "
          f"{tree['blocks_per_sm']} blocks per SM; registers "
          f"{regs_of.get('task_tree_kernel')}")
    print(f"[phase build: {time.perf_counter() - t0:.3f}s, "
          f"{len(logs)} source(s) compiled]")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    smi = smi_line()
    print(f"nvidia-smi: {smi}")

    # -- 2. the main path: Table 6 -----------------------------------------
    captured: dict = {}
    every: dict = {}           # inputs of every learner_replay launch

    def record(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            captured[name] = (a, k)      # inputs of the last launch
            if name == "learner_replay":
                every.setdefault(name, []).append((a, k))
            return fn(*a, **k)
        setattr(mod, name, wrapper)
        return fn

    chain_fn = record(pc, "policy_cost_chain")
    task_fn = record(pc, "policy_cost")
    hedge_fn = record(wu, "hedge_replay")
    learner_fn = record(lk, "learner_replay")
    # The comparison replays' inputs and results (the last is r = 1200's).
    compare, replay_fn = [], table6.replay

    def compare_replay(C, arrivals, d, **kw):
        lr = replay_fn(C, arrivals, d, **kw)
        compare.append((C, arrivals, d, kw, lr))
        return lr
    table6.replay = compare_replay
    # Phase 2's r = 1200 proposed TOLA call and its results: phase 14 runs
    # it again under a mesh.
    tola_calls, tola_fn = [], table6.run_tola_scenarios

    def recorded_tola(*a, **k):
        out = tola_fn(*a, **k)
        if k.get("r_total") == 1200 and "windows" not in k:
            tola_calls.append((a, k, out))
        return out
    table6.run_tola_scenarios = recorded_tola
    # Each chain launch's route and share of tasks with work (kept on the
    # device, read after the run).
    chain_seen, recorded_chain = [], pc.policy_cost_chain
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def chain_probe(A, C, arrival, ends, z_t, *rest, **kw):
        zz = z_t if z_t.dim() == 4 else z_t[:, None]
        B_, S_, n1_ = A.shape
        plan = pc.chain_plan(B_, S_, zz.shape[1], *ends.shape[-2:], n1_ - 1,
                             sms)
        chain_seen.append((plan.route, (zz > _WORK_EPS).float().mean()))
        return recorded_chain(A, C, arrival, ends, z_t, *rest, **kw)
    pc.policy_cost_chain = chain_probe

    if args.jobs != 10000:
        print(f"CUT: Table 6 stream cut from 10000 to {args.jobs} jobs")
    # The main path runs under torch.profiler (CPU ops + CUDA activity) for
    # the device's busy share and copies, and under the port's launch
    # capture for each kernel's launches and device time (the profiler may
    # drop records of a long trace; the capture's event pairs do not).
    from torch.profiler import ProfilerActivity, profile
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            capture() as main_reg:
        res = table6.run(args.jobs, [0, 1200], seed=0, scenarios=2,
                         learners=LEARNERS, eta_grid=ETA_GRID, device="cuda")
        torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    table6.print_tables(res)
    print(f"[phase main path: {t_main:.3f}s; launches {launches}]")
    rows = device_breakdown(torch, prof, t_main)
    main_ms = {k: e["device_ms"] for k, e in capture_report(
        rows, main_reg, launches, ("policy_cost_chain",
                                   "policy_cost_chain_smem", "policy_cost",
                                   "hedge_replay", "learner_replay"),
        smi).items()}
    plan_auto = resolve_plan_backend("auto", dev)
    plan_s = {(r, leg): res[r]["timings"][leg]["plan_device"]
              for r in (0, 1200) for leg in ("proposed", "benchmark")}
    print(f"plan backend: auto -> {plan_auto}; device plan build seconds "
          + ", ".join(f"r={r} {leg} {t:.3f}" for (r, leg), t in
                      plan_s.items()))
    if plan_auto != "device" or min(plan_s.values()) <= 0.0:
        fail(f"Table 6 did not build its plans on the card: {plan_auto}, "
             f"{plan_s}")
    for name in ("policy_cost_chain", "policy_cost", "hedge_replay",
                 "learner_replay"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")
    if launches["learner_replay"] != 2:
        fail(f"learner_replay launched {launches['learner_replay']} times on "
             "the main path, not once per r")
    for r in (0, 1200):
        row = res[r]
        for key in ("alpha_tola", "alpha_bench", "rho_bar", "best_fixed"):
            if not math.isfinite(row[key]):
                fail(f"Table 6 r={r} {key} is not finite: {row[key]}")
        if not (0.0 < row["alpha_tola"] <= 1.0 and
                0.0 < row["alpha_bench"] <= 1.0):
            fail(f"Table 6 r={r} unit costs outside (0, p_od]: {row}")
        if len(row["comparison"]) != COMPARE_ROWS:
            fail(f"learner comparison r={r} has {len(row['comparison'])} rows")
        for c in row["comparison"]:
            if not all(math.isfinite(c[k]) for k in
                       ("realized_unit", "regret", "expected_regret",
                        "top_weight")):
                fail(f"learner comparison r={r} not finite: {c}")
    for name, fn in (("policy_cost_chain", chain_fn), ("policy_cost", task_fn)):
        setattr(pc, name, fn)
    wu.hedge_replay = hedge_fn
    lk.learner_replay = learner_fn
    table6.replay = replay_fn
    table6.run_tola_scenarios = tola_fn
    if len(tola_calls) != 1:
        fail(f"phase 2 made {len(tola_calls)} r = 1200 proposed TOLA calls")

    # -- 3. kernels against their plain versions, main-path inputs ----------
    kernels = []

    def max_err(got, ref, keys):
        return max(float((got[key].double() - ref[key].double()).abs().max())
                   for key in keys)

    # The chain: each main-path launch's route, then both routes on the
    # inputs of the last launch, each bit for bit against the plain version.
    routes = [r for r, _ in chain_seen]
    shares = [round(float(f), 4) for _, f in chain_seen]
    print(f"policy_cost_chain main-path launches: routes {routes}, share of "
          f"tasks with work {shares}; LAUNCHES policy_cost_chain "
          f"{launches.get('policy_cost_chain', 0)}, policy_cost_chain_smem "
          f"{launches.get('policy_cost_chain_smem', 0)}")
    if not routes or any(r != "smem" for r in routes) or \
            launches.get("policy_cost_chain_smem", 0) != len(routes):
        fail(f"a Table 6 chain launch left the shared-memory route: {routes}")
    (a, k) = captured["policy_cost_chain"]
    A, C, arrival, ends, z, d, pins = a
    ref = pc.policy_cost_chain_plain(*a, **k)
    err = max_err(chain_fn(*a, **k), ref, pc.OUT_KEYS)
    err_g = max_err(pc._chain_global_route(*a, **k), ref, pc.OUT_KEYS)
    B, S, n1 = A.shape
    R, L = ends.shape[-2:]
    zz = z if z.dim() == 4 else z[:, None]
    Sp = zz.shape[1]
    pp = pins if pins.dim() == 4 else pins[:, None]
    b_ms, b_by = work_bound(pc.chain_work(B, S, Sp, R, L, n1 - 1, zz, pp))
    run = lambda: chain_fn(*a, **k)  # noqa: E731
    run_g = lambda: pc._chain_global_route(*a, **k)  # noqa: E731
    names = ("chain_smem_kernel", "chain_kernel")
    kernels.append({
        "name": "policy_cost_chain", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_cost.cu",
        "replaces": "src/repro/kernels/policy_cost.py:288",
        "launches": launches["policy_cost_chain"], "max_abs_err": err,
        "ms": cuda_ms(torch, run),
        "plain_ms": cuda_ms(torch, lambda: pc.policy_cost_chain_plain(*a, **k)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_ms": device_ms(torch, run),
        "kernel_device_ms": pass_device_ms(torch, run, names).get(names[0]),
        "launches_smem": launches.get("policy_cost_chain_smem", 0),
        "main_path_routes": routes, "active_share": shares,
        "global_route_ms": cuda_ms(torch, run_g),
        "global_route_device_ms": device_ms(torch, run_g),
        "global_route_kernel_device_ms":
            pass_device_ms(torch, run_g, names).get(names[1]),
        "global_route_max_abs_err": err_g,
        "registers": {n: regs_of.get(n) for n in names},
        "shape": {"B": B, "S": S, "Sp": Sp, "R": R, "L": L, "n_slots": n1 - 1}})
    e = kernels[-1]
    print(f"policy_cost_chain vs plain at the last launch's inputs: max abs "
          f"err {err:.3e} (shared-memory route), {err_g:.3e} (global route) "
          f"{'OK' if err == err_g == 0.0 else 'FAIL'} (bit-equal required)")
    print(f"policy_cost_chain, ms per call (device; the kernel alone): shared"
          f"-memory route {e['ms']:.4f} ({e['device_ms']:.4f}; "
          f"{e['kernel_device_ms']}), global route {e['global_route_ms']:.4f} "
          f"({e['global_route_device_ms']:.4f}; "
          f"{e['global_route_kernel_device_ms']}), bound {b_ms:.4f} ({b_by})")
    if err != 0.0 or err_g != 0.0:
        fail("policy_cost_chain is not bit-equal to its plain version")
    # Horizons off Table 6's path, on both sides of the route's slot limit.
    Bl, Sl, Rl, Ll = CHAIN_LONG_SHAPE
    for n_slots, want in CHAIN_LONG:
        g = np.random.default_rng(CHAIN_LONG_SEED)
        frac = g.random((Bl, Sl, n_slots)) * (g.random((Bl, Sl, n_slots)) < 0.7)
        price = 0.2 + 0.8 * g.random((Bl, Sl, n_slots))
        zero = np.zeros((Bl, Sl, 1))
        A_l = np.concatenate([zero, np.cumsum(frac / 12, -1)], -1)
        C_l = np.concatenate([zero, np.cumsum(frac * price / 12, -1)], -1)
        arr_l = g.random((Bl, Rl)) * n_slots / 12 * 0.7
        ends_l = arr_l[..., None] + np.cumsum(g.exponential(1.0, (Bl, Rl, Ll)),
                                              -1)
        z_l = g.random((Bl, Sl, Rl, Ll)) * 3 * (g.random((Bl, Sl, Rl, Ll)) < 0.4)
        d_l = g.integers(1, 4, (Bl, Sl, Rl, Ll)).astype(np.float64)
        p_l = (g.random((Bl, Sl, Rl, Ll)) < 0.03).astype(np.float64)
        args_l = [torch.tensor(x, dtype=torch.float32, device="cuda")
                  for x in (A_l, C_l, arr_l, ends_l, z_l, d_l, p_l)]
        n_smem = LAUNCHES["policy_cost_chain_smem"]
        err_l = max_err(chain_fn(*args_l), pc.policy_cost_chain_plain(*args_l),
                        pc.OUT_KEYS)
        took = "smem" if LAUNCHES["policy_cost_chain_smem"] > n_smem \
            else "global"
        print(f"policy_cost_chain at {n_slots} slots (B {Bl}, S {Sl}, R {Rl}, "
              f"L {Ll}, synthetic A from seed {CHAIN_LONG_SEED}): route "
              f"{took}, max abs err vs plain {err_l:.3e} "
              f"{'OK' if err_l == 0.0 and took == want else 'FAIL'}")
        if err_l != 0.0 or took != want:
            fail(f"policy_cost_chain at {n_slots} slots: route {took} "
                 f"(expected {want}), max abs err {err_l:.3e}")

    (a, k) = captured["policy_cost"]
    A, C, start, end, z, d = a
    got = task_fn(*a, **k)
    ref = pc.policy_cost_plain(*a, **k)
    torch.cuda.synchronize()
    task_keys = pc.OUT_KEYS + ("finish",)
    err = max_err(got, ref, task_keys)
    S, n1 = A.shape
    T = start.shape[0]
    Sp = z.shape[0] if z.dim() == 2 else 1
    b_ms, b_by = work_bound(pc.task_work(S, Sp, T, n1 - 1, z))
    run = lambda: task_fn(*a, **k)  # noqa: E731
    layout = pc.task_layout(n1 - 1)
    blocks = pc.task_plan(S, T, layout["threads"], layout["blocks_per_sm"],
                          sms)
    ops_five_calls = device_ops(torch, run)
    one_kernel = len(ops_five_calls) == 1 and \
        kernel_named(next(iter(ops_five_calls)), ("task_tree_kernel",))
    kernels.append({
        "name": "policy_cost", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_cost.cu",
        "replaces": "src/repro/kernels/policy_cost.py:132",
        "launches": launches["policy_cost"], "max_abs_err": err,
        "ms": cuda_ms(torch, run),
        "plain_ms": cuda_ms(torch, lambda: pc.policy_cost_plain(*a, **k)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_ms": device_ms(torch, run),
        "kernel_device_ms": pass_device_ms(torch, run, ("task_tree_kernel",))
        .get("task_tree_kernel"),
        "registers": {"task_tree_kernel": regs_of.get("task_tree_kernel")},
        "layout": layout, "blocks_per_scenario": blocks,
        "device_ops_five_calls": ops_five_calls,
        "shape": {"S": S, "Sp": Sp, "T": T, "n_slots": n1 - 1}})
    e = kernels[-1]
    print(f"policy_cost vs plain: max abs err {err:.3e} "
          f"{'OK' if err == 0.0 else 'FAIL'} (bit-equal required); ms per "
          f"call {e['ms']:.4f}, device {e['device_ms']:.4f}, the kernel "
          f"alone {e['kernel_device_ms']}, bound {b_ms:.4f} ({b_by}); "
          f"{layout['depth']} tree levels, {layout['smem_bytes']} bytes of "
          f"shared memory and {layout['threads']} threads per block, "
          f"{blocks} blocks per scenario; device operations of five calls "
          "(profiled again while the profiler recorded none) "
          f"{ops_five_calls} {'OK' if one_kernel else 'FAIL'} (the kernel "
          "alone required)")
    if err != 0.0:
        fail("policy_cost is not bit-equal to its plain version")
    if not one_kernel:
        fail(f"policy_cost calls put other operations than their kernel on "
             f"the device, or the profiler saw none: {ops_five_calls}")
    # Horizons off Table 6's path: around the tree's node count and far
    # past the chain's slot limit, all on the one route.
    nodes = (1 << tree["depth"]) - 1
    horizons = sorted({*TASK_HORIZONS, nodes - 1, nodes, nodes + 1})
    worst = 0.0
    for n_slots in horizons:
        for Sp in (1, 2):
            args_t = task_case(torch, np, n_slots, Sp, TASK_LONG_SEED)
            err_t = max_err(task_fn(*args_t), pc.policy_cost_plain(*args_t),
                            task_keys)
            worst = max(worst, err_t)
            if err_t != 0.0:
                fail(f"policy_cost at {n_slots} slots, Sp {Sp}: max abs err "
                     f"{err_t:.3e} against its plain version")
    print(f"policy_cost at synthetic horizons {horizons} slots (S, T "
          f"{TASK_LONG_SHAPE}, Sp 1 and 2, seed {TASK_LONG_SEED}): max abs "
          f"err vs plain {worst:.3e} OK")

    (a, k) = captured["hedge_replay"]
    Ch, etas, u, n_done = a
    got = hedge_fn(*a, **k)
    ref = wu.hedge_replay_plain(*a, **k)
    torch.cuda.synchronize()

    def weights(logw):
        lw = logw.double()
        w = (lw - lw.amax(-1, keepdim=True)).exp()
        return w / w.sum(-1, keepdim=True)

    e_p = float((got["p_chosen"] - ref["p_chosen"]).abs().max())
    e_w = float((weights(got["logw"]) - weights(ref["logw"])).abs().max())
    e_c = float(((got["expected_cost"] - ref["expected_cost"]).abs()
                 / ref["expected_cost"].abs().clamp_min(1.0)).max())
    knife = ref["margin"] < KNIFE_EDGE
    differ = got["chosen"] != ref["chosen"]
    n_knife = int(knife.sum())
    n_bad = int((differ & ~knife).sum())
    S, J, P = Ch.shape
    K = etas.shape[0]
    # The trajectory bit for bit: the final weights, and sampled rows
    # against the plain version run over that many updates.
    logw_equal = torch.equal(got["logw"], ref["logw"])
    rows = sorted({1, 2, 17, J // 2, J - 1} & set(range(1, J)))
    rows_equal = {n: torch.equal(got["trajectory"][:, :, n],
                                 wu.hedge_replay_plain(
                                     Ch[:, :n], etas[:, :n], u[:, :n],
                                     n_done[:n].clamp_max(n))["logw"])
                  for n in rows}
    del ref
    b_ms, b_by = work_bound(wu.hedge_work(S, K, J, P))
    run = lambda: hedge_fn(*a, **k)  # noqa: E731
    dev_ms = device_ms(torch, run)
    passes = pass_device_ms(torch, run, HEDGE_PASSES)
    pass_sum = sum(passes.values())
    # One instance alone on the card: the trajectory pass's time per step
    # with nothing beside it, and the step's dependency chain in the SASS
    # at the SM clock nvidia-smi reports as the card's maximum.
    one = (Ch[:1].contiguous(), etas[:1].contiguous(), u[:1].contiguous(),
           n_done)
    one_ms = pass_device_ms(torch, lambda: hedge_fn(*one),
                            HEDGE_PASSES[:1]).get(HEDGE_PASSES[0])
    lat = latency_table(torch, probe_lib)
    # The ring the .cu lays out, here and at the largest P it takes,
    # against the shared memory a block may have on this card.
    smem_limit = getattr(torch.cuda.get_device_properties(0),
                         "shared_memory_per_block_optin", 232448)
    ring = wu.ring(P)
    ring_max = wu.ring(1024)["smem_bytes"]
    nj = ring["nj"]
    print(f"hedge_replay trajectory layout at P {P}: {ring}; ring at P 1024 "
          f"{ring_max} bytes; shared memory per block {smem_limit}")
    if max(ring["smem_bytes"], ring_max) > smem_limit:
        fail(f"hedge_replay's ring needs {max(ring['smem_bytes'], ring_max)} "
             f"bytes of shared memory, the card gives a block {smem_limit}")
    chain_ops, chain_cycles = step_chain(
        sass_function(pathlib.Path(_nvcc()).parent / "cuobjdump",
                      _library_path("hedge_replay"),
                      f"trajectory_kernelILi{nj}E"), lat)
    clocks = smi_clocks()
    floor_ms = J * chain_cycles / (clocks["max_sm_mhz"] * 1e3) \
        if clocks["max_sm_mhz"] else None
    ok = n_bad == 0 and max(e_p, e_w) <= HEDGE_TOL and e_c <= COST_TOL \
        and logw_equal and all(rows_equal.values())
    kernels.append({
        "name": "hedge_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hedge_replay.cu",
        "replaces": "src/repro/kernels/weight_update.py:136",
        "launches": launches["hedge_replay"], "max_abs_err": max(e_p, e_w),
        "ms": cuda_ms(torch, run),
        "plain_ms": cuda_ms(torch, lambda: wu.hedge_replay_plain(*a, **k)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_ms": dev_ms, "pass_device_ms": passes,
        "pass_sum_over_device_ms": pass_sum / dev_ms,
        "one_instance_trajectory_ms": one_ms,
        "step_chain": chain_ops, "step_chain_cycles": chain_cycles,
        "latency_cycles": lat, "sm_clocks_mhz": clocks,
        "dependency_floor_ms": floor_ms,
        "registers": {n: v for n, v in regs_of.items()
                      if n.startswith(("trajectory_kernel<" + str(nj) + ">",
                                       "sample_kernel"))},
        "shape": {"S": S, "K": K, "J": J, "P": P, "nj": nj}, "ring": ring,
        "logw_equal": logw_equal,
        "trajectory_rows_equal": {str(n): v for n, v in rows_equal.items()},
        "chosen_differ": int(differ.sum()), "knife_edges": n_knife})
    e = kernels[-1]
    print(f"hedge_replay vs plain: final logw equal {logw_equal}, trajectory "
          f"rows {rows} equal {list(rows_equal.values())}; p_chosen "
          f"{e_p:.3e}, weights {e_w:.3e} (tol {HEDGE_TOL}), expected_cost rel "
          f"{e_c:.3e}; chosen differ at {int(differ.sum())} of "
          f"{differ.numel()} draws, {n_knife} knife edges (|cdf - u*total| < "
          f"{KNIFE_EDGE} total), {n_bad} elsewhere {'OK' if ok else 'FAIL'}")
    print(f"hedge_replay, ms per call {e['ms']:.4f}, device {dev_ms:.4f} "
          "(passes: " + ", ".join(f"{n} {v:.4f}" for n, v in passes.items())
          + f", sum {pass_sum:.4f}); one instance alone: trajectory {one_ms} "
          f"ms, {one_ms * 1e6 / J if one_ms else float('nan'):.1f} ns per "
          f"step")
    print(f"hedge_replay step chain in the SASS of trajectory_kernel<{nj}>: "
          f"{' '.join(chain_ops)}, {chain_cycles:.1f} cycles at the probe's "
          f"latencies {lat}; SM clock {clocks}: dependency floor "
          f"{floor_ms} ms over {J} steps; operations bound {b_ms:.4f} ms")
    if set(passes) != set(HEDGE_PASSES) or abs(pass_sum / dev_ms - 1) > 0.05:
        print(f"WARNING: hedge_replay's profiled passes ({sorted(passes)}) "
              f"sum to {pass_sum:.4f} ms against {dev_ms:.4f} ms of device "
              "time by events: the per-pass times are not to be trusted in "
              "this run")
    if not ok:
        fail("hedge_replay disagrees with its plain version")
    kernels.append(learner_checks(
        torch, np, learner_fn, every["learner_replay"], compare[-1],
        launches, regs_of, (lat, clocks)))
    for k in kernels:       # the main path's CUDA-event time, all launches
        k["main_path_device_ms"] = main_ms.get(k["name"])

    # -- 4. small input against the float64 host references -----------------
    jobs = generate_chain_jobs(60, 2, seed=3)
    markets = make_scenarios(max(j.deadline for j in jobs) + 1.0, 2, seed=11)
    queries = [lambda s, e: np.full(s.shape, 30.0),
               lambda s, e: np.full(s.shape, 45.0)]
    cases = [("proposed r=60", selfowned_policies()[::7],
              dict(r_total=60), True),
             ("refined r=60", selfowned_policies()[::7],
              dict(r_total=60, availability=queries), True),
             ("even r=60", benchmark_bid_policies(),
              dict(r_total=60, windows="even", selfowned="naive"), False)]
    worst = 0.0
    for label, pols, kw, early in cases:
        res_d = evaluate_grid(jobs, pols, markets, early_start=early,
                              device="cuda", **kw)
        gplan = build_grid_plan(jobs, pols, n_scenarios=2, **kw)
        tot = np.zeros(res_d.unit_cost.shape)
        for s, m in enumerate(markets):
            for g in gplan.groups:
                view = m.view(float(g.bid))
                z_t = g.z_t[s] if g.per_scenario else g.z_t
                d_eff = g.d_eff[s] if g.per_scenario else g.d_eff
                pins = g.pins[s] if g.per_scenario else g.pins
                if early:
                    sim = simulate_chains_early(
                        view, g.plan.arrival, g.plan.ends, z_t, d_eff,
                        selfowned_pins=pins, p_ondemand=m.p_ondemand)
                    c = sim.spot_cost + sim.ondemand_cost
                else:
                    fl = g.plan.mask.ravel()
                    sim = simulate_tasks(
                        view, g.plan.starts.ravel()[fl],
                        g.plan.ends.ravel()[fl], z_t.ravel()[fl],
                        d_eff.ravel()[fl], m.p_ondemand)
                    owner = np.repeat(np.arange(len(jobs)),
                                      g.plan.mask.sum(axis=1))
                    c = np.zeros(len(jobs))
                    np.add.at(c, owner, sim.spot_cost + sim.ondemand_cost)
                tot[s][:, g.policy_idx] = c[:, None]
        oracle = tot / np.maximum(gplan.workload, 1e-12)[None, :, None]
        diff = np.abs(res_d.unit_cost - oracle)
        worst = max(worst, float(diff.max()))
        if not np.all(diff <= COST_TOL + COST_TOL * np.abs(oracle)):
            fail(f"cost tensor ({label}) off the float64 oracle by "
                 f"{diff.max():.3e}")
    print(f"small input: cost tensors vs float64 oracle max abs {worst:.3e} "
          f"(tol {COST_TOL} abs + rel)")
    rng = np.random.default_rng(4)
    Cs = rng.random((2, 300, 25)) * 0.6 + np.linspace(0, 0.4, 25)
    arr = np.cumsum(rng.exponential(0.25, 300))
    specs = [LearnerSpec("hedge"), LearnerSpec("hedge", eta=Schedule("const", 0.3))]
    specs += [LearnerSpec(kind) for kind in LEARNERS[1:]]
    small_learners(torch, np, Cs, arr, specs)

    # -- 5-7. the LM substrate's serving path -------------------------------
    t0 = time.perf_counter()
    counts, lm_inputs = serve_phases(torch, np)
    kernels += lm_kernel_entries(torch, counts, lm_inputs)
    lm_kernel_sweep(torch)
    moe_ffn_check(torch, np)
    lm_model_check(torch, np)
    print(f"[phase LM substrate: {time.perf_counter() - t0:.3f}s]")

    # -- 8. paper Tables 2-5 on the card ------------------------------------
    t0 = time.perf_counter()
    tables = tables_phase(torch, np, TABLE_JOBS, smi)
    for k in kernels:
        if k["name"] in tables["max_abs_err"]:
            k["tables_launches"] = tables["launches"][k["name"]]
            k["tables_max_abs_err"] = tables["max_abs_err"][k["name"]]
            k["tables_device_ms"] = tables["device_ms"][k["name"]]
    print(f"[phase tables with checks: {time.perf_counter() - t0:.3f}s]")

    # -- 9. the fleet orchestrator -------------------------------------------
    t0 = time.perf_counter()
    fleet_phase(torch, np)
    print(f"[phase fleet: {time.perf_counter() - t0:.3f}s]")

    # -- 10. device plans ----------------------------------------------------
    t0 = time.perf_counter()
    table6_jobs, table6_cached = device_plan_phase(torch, np, args.jobs)
    print(f"[phase device plans: {time.perf_counter() - t0:.3f}s]")

    # -- 11. streamed scenarios ----------------------------------------------
    t0 = time.perf_counter()
    stream_launches = stream_phase(torch, np, table6_jobs)
    for k in kernels:
        if k["name"] in stream_launches:
            k["stream_launches"] = stream_launches[k["name"]]
    print(f"[phase streamed scenarios: {time.perf_counter() - t0:.3f}s]")

    # -- 12. cross-call caches and delta evaluation -------------------------
    t0 = time.perf_counter()
    cache_launches = cache_phase(torch, np, table6_jobs)
    for k in kernels:
        k["cache_launches"] = cache_launches.get(k["name"], 0)
    print(f"[phase caches and delta: {time.perf_counter() - t0:.3f}s; "
          f"launches {cache_launches}]")
    # (d) what the caches hold at the end, and the memory of the whole run.
    from repro_torch.engine import cache
    print(f"plan cache {cache.PLAN_CACHE.cache_info()}, evictions "
          f"{cache.PLAN_CACHE.evictions}; view cache "
          f"{cache.VIEW_CACHE.cache_info()}, evictions "
          f"{cache.VIEW_CACHE.evictions}")
    print(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"allocated on the card, peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.3f} "
          f"GiB")
    print(f"groups from the plan cache: {tables['plan_cached']} over phase "
          f"8's {tables['sweeps']} sweeps, {table6_cached} over phase 10's "
          f"Table 6 runs")

    # -- 13. observability ---------------------------------------------------
    t0 = time.perf_counter()
    observed = obs_phase(torch, np, table6_jobs, smi,
                         {k["name"]: k for k in kernels})
    for k in kernels:
        e = observed["grid"].get(k["name"]) or observed["serve"].get(
            k["name"])
        if e:
            k["obs_launches"], k["obs_device_ms"] = e["launches"], \
                e["device_ms"]
    print(f"[phase observability: {time.perf_counter() - t0:.3f}s]")

    # -- 14. the scenario x policy-group mesh -------------------------------
    t0 = time.perf_counter()
    meshed = mesh_phase(torch, np, table6_jobs, tola_calls[0])
    for k in kernels:
        k["mesh_launches"] = meshed["a"].get(k["name"], 0)
        k["mesh_rank0_launches"] = meshed["b"].get(k["name"], 0)
    print(f"[phase mesh: {time.perf_counter() - t0:.3f}s; launches (a) "
          f"{meshed['a']}, rank 0 of (b) {meshed['b']}]")

    # -- 15. the static contract checker -----------------------------------
    t0 = time.perf_counter()
    checked = analysis_phase(torch, np)
    for k in kernels:
        k["analysis_launches"] = checked.get(k["name"], 0)
    t_phase = time.perf_counter() - t0
    print(f"[phase static checker: {t_phase:.3f}s (budget "
          f"{ANALYSIS_BUDGET:.0f}s); launches {checked}]")
    if t_phase > ANALYSIS_BUDGET:
        print(f"WARNING: phase 15 took {t_phase:.3f}s, over its "
              f"{ANALYSIS_BUDGET:.0f}s budget")

    # -- 16. training -------------------------------------------------------
    t0 = time.perf_counter()
    trained, loop, tiny_ref, bwd_entries = train_phase(torch, np)
    for k in kernels:
        k.update(trained.get(k["name"], {}))
    kernels += bwd_entries
    t_phase = time.perf_counter() - t0
    print(f"[phase training: {t_phase:.3f}s (budget {TRAIN_BUDGET:.0f}s); "
          f"train_loop {json.dumps(loop)}]")
    if t_phase > TRAIN_BUDGET:
        print(f"WARNING: phase 16 took {t_phase:.3f}s, over its "
              f"{TRAIN_BUDGET:.0f}s budget")

    # -- 17. the mesh of the LM substrate ----------------------------------
    t0 = time.perf_counter()
    meshed_lm = mesh_train_phase(torch, np, tiny_ref)
    for k in kernels:
        if k["name"] == "flash_attention":
            k["mesh_train_launches_per_step"] = \
                meshed_lm["a"]["flash_launches_per_step"]
        k["mesh_train_rank0_launches"] = \
            meshed_lm["b"]["rank0_launches"].get(k["name"], 0)
        if k["name"] in meshed_lm["b"]["full"]:
            k["mesh_split_rank"] = meshed_lm["b"]["full"][k["name"]]
        if k["name"] in meshed_lm["b"]["serve"]:
            k["mesh_serve_split_rank"] = meshed_lm["b"]["serve"][k["name"]]
    t_phase = time.perf_counter() - t0
    print(f"[phase mesh of the LM substrate: {t_phase:.3f}s (budget "
          f"{MESH_TRAIN_BUDGET:.0f}s); (a) walls "
          f"{[round(w, 3) for w in meshed_lm['a']['walls']]}, peak "
          f"{meshed_lm['a']['peak_gib']:.3f} GiB; (b) ranks "
          f"{meshed_lm['b']['ranks_s']:.3f}s]")
    if t_phase > MESH_TRAIN_BUDGET:
        print(f"WARNING: phase 17 took {t_phase:.3f}s, over its "
              f"{MESH_TRAIN_BUDGET:.0f}s budget")

    for k in kernels:    # the same two numbers under their other names
        k["max_abs_diff"], k["kernel_ms"] = k["max_abs_err"], k["ms"]
    print(f"[total {time.perf_counter() - t_all:.3f}s]")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
