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
   torch.profiler, with every kernel's launch counter set to 0 just before
   and read just after; each kernel must have launched (``learner_replay``
   once per r); the device's busy share is printed with its largest device
   entries;
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
   (which follows the kernel's order of operations); then all 21
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
   layers, the flash attention kernel in every prefill: 44 launches, each
   on the tensor-core route) and on mamba2-2.7b (64 layers, the SSD scan
   kernel: 128 launches), the port's own init from a fixed seed, 8 requests
   of 1024 tokens in batches of 4, 16 new tokens each; counters set to 0
   just before each and read just after; wall time, tokens/s and the first
   completion; then the first group once more under torch.profiler for the
   device's busy share and the share of the kernel's device entries;
6. the two kernels against their plain versions on the inputs of their last
   serve launch (error, kernel, plain and library times, bound; for flash
   attention also the CUDA-core kernel's time on the same inputs; for the
   SSD scan its device time, each of its four passes' device time (a
   warning when their sum leaves the device time by over 5 %), its shared
   memory per block and its bounds: the row's, f32-accurate products on
   the tensor cores at the least cost for their operands (three bf16
   products where x is bfloat16, three TF32 elsewhere), the kernel's own
   scheme, three TF32 products each, and f32 on the CUDA cores), and at
   the six flash and four SSD shapes of the reference's kernel tests in
   float32 (flash: the CUDA-core kernel) and bfloat16 (flash: the
   tensor-core kernel), plus SSD cases at mamba2's widths with 32 chunks and at five shapes off the
   serve path (odd P and N, 128 columns, a 4096-row chunk, 70000 heads);
7. the smoke configs of both architectures on the card (kernels) against
   the same weights on the CPU (plain versions): prefill and decode logits,
   and the greedy tokens of a float32 serve.
8. paper Tables 2-5 — ``repro_torch.experiments.exp1_spot_ondemand``,
   ``exp2_self_owned`` and ``exp3_policy12`` at 1500 jobs (the reference
   benchmarks' default stream; the cut from the paper's ~10000 is
   printed), seed 0, S = 1, job types 1-4, r in {300, 600, 900, 1200} —
   under torch.profiler, the launch counters set to 0 just before and read
   just after: the tables, each driver's wall, the engine's phase seconds
   summed over the 76 sweeps, the Greedy seconds and the device's busy
   share. It fails unless both cost kernels launched, every alpha and
   benchmark alpha is finite and in (0, p_od], every sweep's best-policy
   alpha lies within 1e-5 of the host's float64 ``run_jobs`` for that
   policy and mode, and the phase's last chain and task launches are
   bit-equal to their plain versions; it prints the knife-edge count, the
   (job, policy) unit costs of exp1's proposed sweeps (r = 0) that leave
   the host's ``run_jobs`` by more than 1e-5, and the largest gap;
9. the fleet orchestrator — ``repro_torch.sched.FleetOrchestrator`` on 30
   training DAG jobs with 4 reserved pods (``schedule`` with and without
   learning) and ``stage_plan``, on the card against ``device="cpu"``:
   every ``ScheduleReport`` field within 1e-5, the same best policy, the
   stage plan bit for bit, and the chain kernel launched.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``. Without a CUDA
GPU, or without the repository's ``src/repro_torch`` beside it, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import re
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
# H100 SXM: device memory rate, float32 rate outside the tensor cores and
# the dense bfloat16 and TF32 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
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
SSD_PASSES = ("ssd_chunk_state", "ssd_cb", "ssd_state_pass", "ssd_chunk_scan")
# (arch, kernel on its prefill path, launches: layers x prefill rounds, the
# device kernel names it launches)
SERVE = [("tinyllama_1_1b", "flash_attention", 22 * 2,
          ("flash_fwd_tc", "flash_fwd_kernel")),
         ("mamba2_2_7b", "ssd_scan", 64 * 2, SSD_PASSES)]
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 4, 1024, 16
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


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def sass_function(cuobjdump, lib_path, name: str) -> list[tuple[str, str]]:
    """(opcode, operands) of the SASS of the function whose mangled name
    holds ``name``, from ``cuobjdump -sass``."""
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120).stdout
    body = next((part for part in out.split("Function : ")[1:]
                 if part.split("\n", 1)[0].strip().find(name) >= 0), "")
    ins = []
    for line in body.splitlines():
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                      r"\s*([^;]*);", line)
        if m:
            ins.append((m.group(2), m.group(3)))
    return ins


def step_chain(ins, lat: dict) -> tuple[list[str], float]:
    """The dependency chain of one Hedge step in the SASS: from the result
    of one REDUX to the operand of the next, the longest path by ``lat``'s
    latencies. Every pair of consecutive REDUXes is walked (the compiler
    also emits REDUXes in divergent fallback blocks, where no chain joins
    them); returns the median chain over the pairs that do join: its
    opcodes, ending with the REDUX, and its cycles."""
    regs = lambda s: re.findall(r"\bU?R(?:\d+)\b", s)  # noqa: E731

    def cost(op):
        if op.startswith(("FADD", "FMUL")):
            return lat["fp"]
        if op.startswith("FMNMX"):
            return lat["fmnmx"]
        if op.startswith(("MOV", "IMAD.U32", "IMAD.MOV")):
            return 0.0            # the move of REDUX's result: in redux_move
        return lat["int"]

    def walk(a, b):
        ready = {regs(ins[a][1])[0]: (lat["redux_move"], ["REDUX"])}
        for op, args in ins[a + 1:b]:
            rs = regs(args)
            if not rs or op.startswith(("ST", "BRA", "BAR")) or "SETP" in op:
                continue               # no register written
            hit = [ready[r] for r in rs[1:] if r in ready]
            if hit and not op.startswith(("LD", "SHFL")):
                t, path = max(hit, key=lambda h: h[0])
                ready[rs[0]] = (t + cost(op), path + [op.split(".")[0]])
            else:
                ready.pop(rs[0], None)     # overwritten off the chain
        rs = regs(ins[b][1])
        return ready.get(rs[1]) if len(rs) > 1 else None

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


def device_breakdown(torch, prof, wall_s: float, top: int = 8,
                     kernel: tuple[str, tuple[str, ...]] | None = None) -> None:
    """Print the device's busy share over ``wall_s`` and its largest
    entries, from a torch.profiler run; with ``kernel`` = (label, names),
    also the device time, launches and busy share of the entries of those
    kernel names together."""
    rows = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[device busy {busy_ms:.3f} ms of {wall_s * 1e3:.0f} ms wall: busy "
          f"share {busy_ms / (wall_s * 1e3):.6f}, idle share "
          f"{1 - busy_ms / (wall_s * 1e3):.6f}]")
    for e in rows[:top]:
        print(f"  device {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d} calls  {e.key[:70]}")
    if kernel:
        label, names = kernel
        hits = [e for e in rows if kernel_named(e.key, names)]
        k_ms = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"  {label} ({', '.join(names)}): device {k_ms:.3f} ms over "
              f"{sum(e.count for e in hits)} launches, "
              f"{k_ms / busy_ms if busy_ms else math.nan:.6f} of the busy "
              "time")


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


def task_ops(n_slots: int) -> int:
    """Operations of one active task: two binary searches of
    ceil(log2(n+2)) comparisons each plus about 60 arithmetic operations
    (four interpolations, the two inversions, the flexibility test and
    the cost sums)."""
    return 2 * math.ceil(math.log2(n_slots + 2)) + 60


def attn_pairs(Sq: int, Sk: int, causal: bool, window: int,
               prefix: int) -> int:
    """(query, key) pairs the masks leave visible: the products the
    attention of these inputs needs."""
    import numpy as np
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= ((qp - kp) < window) | (kp < prefix)
    return int(ok.sum())


def ssd_ops(Bb: int, S: int, H: int, P: int, G: int, N: int,
            Q: int) -> tuple[int, int]:
    """Operations of the chunked SSD scan on these inputs, two per
    multiply-add, split by operand: (the products with x: the causal
    (C B^T .* L .* dt) x and the state update; the others: C B^T on the
    causal half once per group and C times the entering state, none for the
    first chunk, whose state is zero)."""
    x_ops = other_ops = 0
    for c, t0 in enumerate(range(0, S, Q)):
        q = min(Q, S - t0)
        pairs = q * (q + 1) // 2
        x_ops += 2 * Bb * H * (pairs * P + q * N * P)
        other_ops += 2 * Bb * (G * pairs * N + (H * q * N * P if c else 0))
    return x_ops, other_ops


def ssd_bounds(n_bytes: float, x_ops: int, other_ops: int,
               x_bf16: bool) -> dict:
    """Bounds of the SSD scan, (ms, by), under four rates for its products:
    "row", the least time at f32 accuracy on the tensor cores, where a
    product with a bfloat16 x (exact in bf16) splits its f32 operand into
    three bf16 parts (three products at the dense bf16 rate) and every
    other product takes three TF32 products; "kernel", the kernel's own
    scheme (two TF32 products with a bfloat16 x, three elsewhere);
    "tf32_3", three TF32 products each; "f32", the CUDA cores in f32."""
    x3 = x_ops * 3 / TF32_OPS_PER_S
    rest = other_ops * 3 / TF32_OPS_PER_S
    t_ops = {
        "row": (x_ops * 3 / BF16_OPS_PER_S if x_bf16 else x3) + rest,
        "kernel": (x_ops * 2 / TF32_OPS_PER_S if x_bf16 else x3) + rest,
        "tf32_3": x3 + rest,
        "f32": (x_ops + other_ops) / F32_OPS_PER_S}
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return {k: (t_bytes * 1e3, "bytes") if t_bytes >= t else
            (t * 1e3, "operations") for k, t in t_ops.items()}


def flash_plain_bshd(q, k, v, **kw):
    """The plain version on the models' (B, S, H, dh) layout."""
    from repro_torch.kernels.flash_attention import attention_plain
    B, Sq, H, dh = q.shape
    rows = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1], dh)  # noqa: E731
    return attention_plain(rows(q), rows(k), rows(v), **kw).reshape(
        B, H, Sq, dh).transpose(1, 2)


def allclose(got, ref, tol: float) -> tuple[float, bool]:
    d = (got.float() - ref.float()).abs()
    return float(d.max()), bool((d <= tol + tol * ref.float().abs()).all())


def serve_phases(torch, np) -> tuple[dict, dict]:
    """Serve tinyllama-1.1b and mamba2-2.7b at full width; returns the
    launch counts of each phase and the inputs of each LM kernel's last
    launch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import build

    captured: dict = {}
    originals = {"flash_attention": (fa, "flash_attention_strided"),
                 "ssd_scan": (ss, "ssd_scan")}
    for name, (mod, attr) in originals.items():
        fn = getattr(mod, attr)

        def wrapper(*a, _fn=fn, _name=name, **k):
            captured[_name] = (a, k)     # inputs of the last launch
            return _fn(*a, **k)
        setattr(mod, attr, wrapper)
        originals[name] = (mod, attr, fn)
    counts = {}
    for arch, kernel, expected, device_names in SERVE:
        cfg = get_config(arch)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT), dtype=np.int32)
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out, stats = serve_requests(cfg, prompts, SERVE_BATCH, SERVE_NEW,
                                    seed=0, device="cuda")
        torch.cuda.synchronize()
        t_phase = time.perf_counter() - t0
        counts[kernel] = launches = dict(LAUNCHES)
        print(f"[phase serve {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {SERVE_REQUESTS} requests x {SERVE_PROMPT} "
              f"tokens, batch {SERVE_BATCH}, {SERVE_NEW} new: serve loop "
              f"{stats['wall_s']:.3f}s, {stats['tokens_per_s']:.1f} tok/s; "
              f"{t_phase:.3f}s with init; launches {launches}]")
        print(f"  first completion: {out[0].tolist()}")
        if launches.get(kernel, 0) != expected:
            fail(f"serve {arch}: {kernel} launched {launches.get(kernel, 0)} "
                 f"times, expected {expected}")
        if kernel == "flash_attention" \
                and launches.get("flash_attention_tc", 0) != expected:
            fail(f"serve {arch}: {launches.get('flash_attention_tc', 0)} of "
                 f"{expected} flash launches took the tensor-core route")
        if out.shape != (SERVE_REQUESTS, SERVE_NEW) or out.min() < 0 \
                or out.max() >= cfg.vocab or not stats["tokens_per_s"] > 0:
            fail(f"serve {arch}: bad output {out.shape} [{out.min()}, "
                 f"{out.max()}] or stats {stats}")
        # The first group again under the profiler, with the same weights
        # initialised outside the profiled window (which then holds the
        # serve loop and a device-to-device weight copy). One group keeps
        # the trace, and the time to read it, short.
        model = build(cfg, "cuda")
        model.init_weights(torch.Generator("cuda").manual_seed(0))
        state = model.state_dict()
        del model
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out_p, stats_p = serve_requests(cfg, prompts[:SERVE_BATCH],
                                            SERVE_BATCH, SERVE_NEW,
                                            params=state, device="cuda")
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        device_breakdown(torch, prof, stats_p["wall_s"],
                         kernel=(kernel, device_names))
        print(f"  first group under torch.profiler (not counted): serve loop "
              f"{stats_p['wall_s']:.3f}s; profiled run and trace collection "
              f"{t1 - t0:.3f}s, reading the trace "
              f"{time.perf_counter() - t1:.3f}s")
        if not np.array_equal(out_p, out[:SERVE_BATCH]):
            fail(f"serve {arch}: the profiled run generated other tokens")
        del state
        torch.cuda.empty_cache()
    for mod, attr, fn in originals.values():
        setattr(mod, attr, fn)
    return counts, captured


def lm_kernel_entries(torch, counts, captured) -> list[dict]:
    """Each LM kernel against its plain version on the inputs of its last
    serve launch, timed beside its plain version, its library call and its
    bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss

    entries = []
    (q, k, v, _), kw = captured["flash_attention"]
    dtype = str(q.dtype).split(".")[-1]
    got = ops.flash_attention(q, k, v, **kw)
    plain = flash_plain_bshd(q, k, v, **kw)
    err, ok = allclose(got, plain, LM_TOL[dtype]["flash"])
    # The CUDA-core kernel through its own entry point, same inputs.
    out_cc = torch.empty_like(got)
    fa.launch_cuda_core(q, k, v, out_cc, **kw)
    err_cc, ok_cc = allclose(out_cc, plain, LM_TOL[dtype]["flash"])
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    n_ops = 4 * dh * attn_pairs(Sq, Sk, kw["causal"], kw["window"],
                                kw["prefix"]) * B * H
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    b_ms, b_by = bound(n_bytes, n_ops, peak)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = (lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)) \
        if kw["causal"] and not kw["window"] else None
    # ms, cuda_core_ms and library_ms: one call at a time, the wrapper's
    # preparation included; *device_ms: device time alone.
    run = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
    run_cc = lambda: fa.launch_cuda_core(q, k, v, out_cc, **kw)  # noqa: E731
    entries.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:101",
        "launches": counts["flash_attention"].get("flash_attention", 0),
        "launches_tc": counts["flash_attention"].get("flash_attention_tc", 0),
        "max_abs_err": err,
        "ms": cuda_ms(torch, run),
        "cuda_core_ms": cuda_ms(torch, run_cc),
        "cuda_core_max_abs_err": err_cc,
        "plain_ms": cuda_ms(torch, lambda: flash_plain_bshd(q, k, v, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, lib) if lib else None,
        "device_ms": device_ms(torch, run),
        "cuda_core_device_ms": device_ms(torch, run_cc),
        "library_device_ms": device_ms(torch, lib) if lib else None,
        "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "K": k.shape[2],
                  "dh": dh, "dtype": dtype, **kw}})
    print(f"flash_attention vs plain at the serve shape: max abs err "
          f"{err:.3e} (tensor-core route), {err_cc:.3e} (CUDA-core kernel) "
          f"(tol {LM_TOL[dtype]['flash']} abs + rel) "
          f"{'OK' if ok and ok_cc else 'FAIL'}")
    if not (ok and ok_cc):
        fail("flash_attention disagrees with its plain version")
    e = entries[-1]
    print("flash_attention at the serve shape, ms per call (device only): "
          f"tensor cores {e['ms']:.4f} ({e['device_ms']:.4f}), CUDA cores "
          f"{e['cuda_core_ms']:.4f} ({e['cuda_core_device_ms']:.4f}), SDPA "
          f"{e['library_ms']} ({e['library_device_ms']}), bound "
          f"{e['bound_ms']:.4f} ({e['bound_by']})")

    (x, dt, A, Bm, Cm, *rest), kw = captured["ssd_scan"]
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
    x_ops, other_ops = ssd_ops(Bb, S, H, P, G, N, min(chunk, S))
    bounds = ssd_bounds(n_bytes, x_ops, other_ops, x.dtype == torch.bfloat16)
    b_ms, b_by = bounds["row"]
    run = lambda: ss.ssd_scan(x, dt, A, Bm, Cm, chunk)  # noqa: E731
    dev_ms = device_ms(torch, run)
    passes = pass_device_ms(torch, run, SSD_PASSES)
    pass_sum = sum(passes.values())
    smem = ss.smem_bytes(x.dtype, P)
    entries.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:78",
        "launches": counts["ssd_scan"].get("ssd_scan", 0),
        "max_abs_err": max(e_y, e_s),
        "ms": cuda_ms(torch, run),
        "plain_ms": cuda_ms(torch, lambda: ss.ssd_scan_plain(
            x, dt, A, Bm, Cm, chunk)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "bound_rate": "products with the bf16 x at bf16 / 3 (f32 operand "
                      "split in three bf16 parts), the rest at TF32 / 3",
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
        "y_err": e_y, "state_err": e_s, "y_err_float32_x": e_32})
    e = entries[-1]
    print(f"ssd_scan at the serve shape, ms per call {e['ms']:.4f}, device "
          f"{dev_ms:.4f} (passes: " + ", ".join(
              f"{k} {v:.4f}" for k, v in passes.items())
          + f", sum {pass_sum:.4f}); {e['launches']} serve calls, each the "
          "four passes of the one kernel (no route); dynamic shared memory "
          f"per block {smem}")
    print(f"ssd_scan bounds at the serve shape: {x_ops / 1e9:.3f} GFLOP with "
          f"x, {other_ops / 1e9:.3f} GFLOP without, {n_bytes / 1e6:.1f} MB: "
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
    print(f"ssd_scan vs plain at the serve shape: y ({dtype}) max abs err "
          f"{e_y:.3e} (tol {LM_TOL[dtype]['ssd']} abs + rel), final state "
          f"{e_s:.3e} (tol {STATE_TOL}), y with x in float32 {e_32:.3e} "
          f"(tol {LM_TOL['float32']['ssd']}) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail("ssd_scan disagrees with its plain version")
    return entries


def lm_kernel_sweep(torch) -> None:
    """Both LM kernels against their plain versions at the reference's test
    shapes (window, prefix, ragged, non-causal, grouped), f32 and bf16."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flash_attention as fa
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
        for BH, BK, Sq, Sk, dh, causal, window, prefix in FLASH_SHAPES:
            q, k, v = (rand(*s).to(tdt) for s in
                       ((BH, Sq, dh), (BK, Sk, dh), (BK, Sk, dh)))
            kw = dict(causal=causal, window=window, prefix=prefix)
            n_tc = LAUNCHES["flash_attention_tc"]
            err, ok = allclose(fa.flash_attention_fwd(q, k, v, **kw),
                               fa.attention_plain(q, k, v, **kw),
                               tol["flash"])
            # bfloat16 (dh 64 and 128) takes the tensor cores, float32 the
            # CUDA-core kernel.
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
          f"kernel; SSD also at {SSD_LONG}, 32 chunks, and {SSD_ODD}): "
          + ", ".join(
        f"{name} {dtype} max abs err {e:.3e}"
        for (name, dtype), e in sorted(worst.items()))
          + f" OK; SSD shared memory per block at most {smem_max} of "
          f"{smem_limit} bytes")


def lm_model_check(torch, np) -> None:
    """The smoke configs served on the card (kernels) against the same
    weights on the CPU (plain versions)."""
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
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab, (2, 40), dtype=np.int32))
            logits = []
            for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
                lg, cache = model.prefill({"tokens": toks.to(dev)},
                                          max_len=48)
                lg2, _ = model.decode(cache, toks[:, 3:4].to(dev), 40)
                logits.append((lg.cpu(), lg2.cpu()))
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


def tables_phase(torch, np, n_jobs: int) -> dict:
    """Phase 8: paper Tables 2-5 (exp1-exp3) on the card, every check of
    the phase; returns each cost kernel's launches in the phase and its
    last launch's error against its plain version."""
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
    current = [""]
    sweep_fn, greedy_fn = common.sweep_policies, common.run_greedy
    kernel_fns = {n: getattr(pc, n) for n in ("policy_cost_chain",
                                              "policy_cost")}

    def sweep(jobs, policies, markets, r_total=0, **kw):
        pol, alpha, costs, res = sweep_fn(jobs, policies, markets, r_total,
                                          **kw)
        for key, v in res.timings.items():
            engine_s[key] = engine_s.get(key, 0.0) + v
        proposed = current[0] == "exp1" and kw.get("windows", "dealloc") \
            == "dealloc"
        sweeps.append({"driver": current[0], "jobs": jobs,
                       "markets": markets, "policies": policies,
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
                             ProfilerActivity.CUDA]) as prof:
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
          + f" over {len(sweeps)} sweeps; greedy={greedy_s[0]:.3f}s; "
          f"launches {launches}]")
    names = ("chain_smem_kernel", "chain_kernel", "task_tree_kernel")
    device_breakdown(torch, prof, t_all, kernel=("cost kernels", names))
    for name in kernel_fns:
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched by paper Tables 2-5")
    seen = sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel_named(e.key, names))
    n_launched = sum(launches.get(n, 0) for n in kernel_fns)
    if seen < n_launched:
        print(f"WARNING: the profiler recorded {seen} of the {n_launched} "
              "cost-kernel launches: it dropped records, so the busy time "
              "above is a lower bound")

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
            "knife_edges": n_off, "cells": n_cells, "gap_max": gap_max}


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


def learner_checks(torch, np, learner_fn, last, comparison, launches,
                   regs_of) -> dict:
    """Phase 3's learner kernel checks: the main path's last launch bit for
    bit against its plain version on the card, every comparison instance
    against the float64 host loop, a planted fault that both checks must
    catch, times and bound; returns the kernel's entry."""
    from repro_torch.kernels import learner_replay as lk
    from repro_torch.learn.replay import _replay_numpy_one, build_events

    a, k = last
    kinds, Cl, etas = a[:3]
    S, J, P = Cl.shape
    K = etas.shape[0]
    C64, arrivals, d, kw, lr = comparison       # the same replay's inputs
    ev_k, ev_jj, _ = build_events(arrivals, d)
    got = learner_fn(*a, **k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = lk.learner_replay_plain(*a, **k)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    bad, err = plain_mismatches(kinds, got, ref)
    n_inst = {kind: S * list(kinds).count(kind) for kind in set(kinds)}
    print("learner_replay vs plain: " + ", ".join(
        f"{kind} {n - sum(b.startswith(kind + ' ') for b in bad)} of {n}"
        for kind, n in sorted(n_inst.items()))
        + " instances bit for bit (trace and final state)")
    if bad:
        fail("learner_replay not bit-equal to its plain version: "
             + "; ".join(bad[:8]))

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
    del ref

    # Times and the bound: each input read once, each output written once;
    # operations per (instance, job) as the kernel does them: exp3 14 P
    # (max, difference, exp, sum, quotient, product, sum of the
    # distribution; the cdf's sums, quotients and comparisons; the expected
    # cost's products and sums; the update's max and shift), ucb1 12 P,
    # egreedy 10 P, ftl 7 P.
    run = lambda: learner_fn(*a, **k)  # noqa: E731
    per_job = {"exp3": 14, "ucb1": 12, "egreedy": 10, "ftl": 7}
    n_bytes = 4 * (S * J * P + 2 * K * J + S * J + 4 * J + K
                   + 3 * S * K * J + 4 * S * K * P)
    n_ops = S * J * P * sum(per_job[kind] for kind in kinds)
    b_ms, b_by = bound(n_bytes, n_ops)
    nj = lk.lanes(P)
    entry = {
        "name": "learner_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/learner_replay.cu",
        "replaces": "src/repro/learn/replay.py:119",
        "launches": launches["learner_replay"], "max_abs_err": err,
        "ms": cuda_ms(torch, run), "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_ms": device_ms(torch, run, reps=5),
        "cost_row_read_bytes": 4 * S * K * J * P,
        "registers": {n: v for n, v in regs_of.items()
                      if n == f"learner_kernel<{nj}>"},
        "shape": {"S": S, "K": K, "J": J, "P": P, "nj": nj,
                  "kinds": list(kinds)},
        "vs_plain": {kind: {"instances": n, "bit_equal": n}
                     for kind, n in sorted(n_inst.items())},
        "vs_host_float64": [{"s": s, "learner": label, "first": row}
                            for s, label, row in host_rows]}
    print(f"learner_replay ({K} instances x {S} scenarios, J {J}, P {P}): ms "
          f"per call {entry['ms']:.3f}, device {entry['device_ms']:.3f}, "
          f"plain {plain_ms:.1f}; bound {b_ms:.4f} ({b_by}); launches "
          f"{entry['launches']}; registers {entry['registers']}")
    return entry


def fleet_phase(torch, np) -> None:
    """Phase 9: the fleet orchestrator on the card against the CPU, at the
    reference's system-test inputs (tests/test_system.py:50-80)."""
    from repro_torch.core import Policy
    from repro_torch.kernels import LAUNCHES
    from repro_torch.sched import FleetOrchestrator, FleetSpec, training_job_dag

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
    want = {learn: host.schedule(jobs, learn=learn) for learn in (True, False)}
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
    print(f"fleet vs CPU: report fields within {worst:.3e} (tol "
          f"{FLEET_TOL}), best policies equal; stage_plan bit for bit and "
          f"feasible; launches {launches}")


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
    from repro_torch.engine import build_grid_plan, evaluate_grid, make_scenarios
    from repro_torch.experiments import table6
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import policy_cost as pc
    from repro_torch.kernels import learner_replay as lk
    from repro_torch.kernels import weight_update as wu
    from repro_torch.learn import LearnerSpec, Schedule

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
                       ("learner_replay", ("learner_kernel",))):
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

    def record(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            captured[name] = (a, k)      # inputs of the last launch
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
    # the device's busy share; a few hundred device events, so the tracing
    # cost is small against the host work.
    from torch.profiler import ProfilerActivity, profile
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = table6.run(args.jobs, [0, 1200], seed=0, scenarios=2,
                         learners=LEARNERS, eta_grid=ETA_GRID, device="cuda")
        torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    table6.print_tables(res)
    print(f"[phase main path: {t_main:.3f}s; launches {launches}]")
    device_breakdown(torch, prof, t_main)
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
    active = int(((zz > 0) | (pp > 0.5)).sum()) * (S // Sp)
    b_ms, b_by = bound(4 * (2 * B * S * n1 + B * R + B * R * L
                            + 3 * B * Sp * R * L + 4 * B * S * R),
                       active * task_ops(n1 - 1))
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
    active = int((z > 0).sum()) * (S // Sp)
    b_ms, b_by = bound(4 * (2 * S * n1 + 2 * T + 2 * Sp * T + 5 * S * T),
                       active * task_ops(n1 - 1))
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
    b_ms, b_by = bound(4 * (S * J * P + K * J + S * J + J + 3 * S * K * J
                            + S * K * P), 12 * S * K * J * P)
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
    kernels.append(learner_checks(torch, np, learner_fn,
                                  captured["learner_replay"], compare[-1],
                                  launches, regs_of))

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
    lm_model_check(torch, np)
    print(f"[phase LM substrate: {time.perf_counter() - t0:.3f}s]")

    # -- 8. paper Tables 2-5 on the card ------------------------------------
    t0 = time.perf_counter()
    tables = tables_phase(torch, np, TABLE_JOBS)
    for k in kernels:
        if k["name"] in tables["max_abs_err"]:
            k["tables_launches"] = tables["launches"][k["name"]]
            k["tables_max_abs_err"] = tables["max_abs_err"][k["name"]]
    print(f"[phase tables with checks: {time.perf_counter() - t0:.3f}s]")

    # -- 9. the fleet orchestrator -------------------------------------------
    t0 = time.perf_counter()
    fleet_phase(torch, np)
    print(f"[phase fleet: {time.perf_counter() - t0:.3f}s]")

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
