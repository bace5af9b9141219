#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # paper Table 6 at 10000 jobs, S = 2
    python3 chip_smoke.py --jobs N   # a shorter stream (the cut is printed)

Phases, each failing the run with a non-zero exit:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the device;
2. the main path — ``repro_torch.experiments.table6.run`` (TOLA on the
   proposed grid and on the Even benchmark, r in {0, 1200}, plus the Hedge
   learner comparison over 9 schedule instances) under torch.profiler,
   with every kernel's launch counter set to 0 just before and read just
   after; each kernel must have launched; the device's busy share is
   printed with its largest device entries;
3. each kernel against its plain PyTorch version on the card, on the inputs
   of its last main-path launch: max abs error, kernel and plain times
   (CUDA events, median of 5 after a warm-up) and the bound;
4. correctness on a small input: the cost tensor against the float64 host
   simulator and the Hedge replay against the float64 host loop.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``. Without a CUDA
GPU, or without the repository's ``src/repro_torch`` beside it, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ETA_GRID = [0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0]
# H100 SXM: device memory rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
COST_TOL = 1e-5      # relative to max(1, |plain|)
HEDGE_TOL = 1e-5     # absolute, on probabilities and weights
KNIFE_EDGE = 1e-6    # |cdf - u*total| / total below which a draw may flip


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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def task_ops(n_slots: int) -> int:
    """Operations of one active task: two binary searches of
    ceil(log2(n+2)) comparisons each plus about 60 arithmetic operations
    (four interpolations, the two inversions, the flexibility test and
    the cost sums)."""
    return 2 * math.ceil(math.log2(n_slots + 2)) + 60


def rel_err(got, ref):
    d = (got.double() - ref.double()).abs()
    return float(d.max()), bool((d <= COST_TOL * ref.double().abs()
                                 .clamp_min(1.0)).all())


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
    from repro_torch.core.simulate import simulate_chains_early, simulate_tasks
    from repro_torch.device import build_kernels
    from repro_torch.engine import build_grid_plan, evaluate_grid, make_scenarios
    from repro_torch.experiments import table6
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import policy_cost as pc
    from repro_torch.kernels import weight_update as wu
    from repro_torch.learn import LearnerSpec, Schedule, replay

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build and device ------------------------------------------------
    t0 = time.perf_counter()
    logs = build_kernels()
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"[nvcc {name}] {line.strip()}")
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
                         eta_grid=ETA_GRID, device="cuda")
        torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    table6.print_tables(res)
    print(f"[phase main path: {t_main:.3f}s; launches {launches}]")
    dev_rows = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in dev_rows) / 1e3
    print(f"[device busy {busy_ms:.3f} ms of {t_main * 1e3:.0f} ms main-path "
          f"wall: busy share {busy_ms / (t_main * 1e3):.6f}, idle share "
          f"{1 - busy_ms / (t_main * 1e3):.6f}]")
    for e in dev_rows[:8]:
        print(f"  device {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d} calls  {e.key[:70]}")
    for name in ("policy_cost_chain", "policy_cost", "hedge_replay"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")
    for r in (0, 1200):
        row = res[r]
        for key in ("alpha_tola", "alpha_bench", "rho_bar", "best_fixed"):
            if not math.isfinite(row[key]):
                fail(f"Table 6 r={r} {key} is not finite: {row[key]}")
        if not (0.0 < row["alpha_tola"] <= 1.0 and
                0.0 < row["alpha_bench"] <= 1.0):
            fail(f"Table 6 r={r} unit costs outside (0, p_od]: {row}")
        if len(row["comparison"]) != 1 + len(ETA_GRID):
            fail(f"learner comparison r={r} has {len(row['comparison'])} rows")
        for c in row["comparison"]:
            if not all(math.isfinite(c[k]) for k in
                       ("realized_unit", "regret", "expected_regret",
                        "top_weight")):
                fail(f"learner comparison r={r} not finite: {c}")
    for name, fn in (("policy_cost_chain", chain_fn), ("policy_cost", task_fn)):
        setattr(pc, name, fn)
    wu.hedge_replay = hedge_fn

    # -- 3. kernels against their plain versions, main-path inputs ----------
    kernels = []

    (a, k) = captured["policy_cost_chain"]
    A, C, arrival, ends, z, d, pins = a
    got = chain_fn(*a, **k)
    ref = pc.policy_cost_chain_plain(*a, **k)
    torch.cuda.synchronize()
    errs = [rel_err(got[key], ref[key]) for key in pc.OUT_KEYS]
    err, ok = max(e for e, _ in errs), all(o for _, o in errs)
    B, S, n1 = A.shape
    R, L = ends.shape[-2:]
    zz = z if z.dim() == 4 else z[:, None]
    Sp = zz.shape[1]
    pp = pins if pins.dim() == 4 else pins[:, None]
    active = int(((zz > 0) | (pp > 0.5)).sum()) * (S // Sp)
    b_ms, b_by = bound(4 * (2 * B * S * n1 + B * R + B * R * L
                            + 3 * B * Sp * R * L + 4 * B * S * R),
                       active * task_ops(n1 - 1))
    kernels.append({
        "name": "policy_cost_chain", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_cost.cu",
        "replaces": "src/repro/kernels/policy_cost.py:288",
        "launches": launches["policy_cost_chain"], "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: chain_fn(*a, **k)),
        "plain_ms": cuda_ms(torch, lambda: pc.policy_cost_chain_plain(*a, **k)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"B": B, "S": S, "Sp": Sp, "R": R, "L": L, "n_slots": n1 - 1}})
    print(f"policy_cost_chain vs plain: max abs err {err:.3e} "
          f"(tol {COST_TOL} x max(1,|ref|)) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail("policy_cost_chain disagrees with its plain version")

    (a, k) = captured["policy_cost"]
    A, C, start, end, z, d = a
    got = task_fn(*a, **k)
    ref = pc.policy_cost_plain(*a, **k)
    torch.cuda.synchronize()
    errs = [rel_err(got[key], ref[key]) for key in pc.OUT_KEYS + ("finish",)]
    err, ok = max(e for e, _ in errs), all(o for _, o in errs)
    S, n1 = A.shape
    T = start.shape[0]
    Sp = z.shape[0] if z.dim() == 2 else 1
    active = int((z > 0).sum()) * (S // Sp)
    b_ms, b_by = bound(4 * (2 * S * n1 + 2 * T + 2 * Sp * T + 5 * S * T),
                       active * task_ops(n1 - 1))
    kernels.append({
        "name": "policy_cost", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_cost.cu",
        "replaces": "src/repro/kernels/policy_cost.py:132",
        "launches": launches["policy_cost"], "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: task_fn(*a, **k)),
        "plain_ms": cuda_ms(torch, lambda: pc.policy_cost_plain(*a, **k)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"S": S, "Sp": Sp, "T": T, "n_slots": n1 - 1}})
    print(f"policy_cost vs plain: max abs err {err:.3e} "
          f"(tol {COST_TOL} x max(1,|ref|)) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail("policy_cost disagrees with its plain version")

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
    b_ms, b_by = bound(4 * (S * J * P + K * J + S * J + J + 3 * S * K * J
                            + S * K * P), 12 * S * K * J * P)
    ok = n_bad == 0 and max(e_p, e_w) <= HEDGE_TOL and e_c <= COST_TOL
    kernels.append({
        "name": "hedge_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hedge_replay.cu",
        "replaces": "src/repro/kernels/weight_update.py:136",
        "launches": launches["hedge_replay"], "max_abs_err": max(e_p, e_w),
        "ms": cuda_ms(torch, lambda: hedge_fn(*a, **k)),
        "plain_ms": cuda_ms(torch, lambda: wu.hedge_replay_plain(*a, **k)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"S": S, "K": K, "J": J, "P": P},
        "chosen_differ": int(differ.sum()), "knife_edges": n_knife})
    print(f"hedge_replay vs plain: p_chosen {e_p:.3e}, weights {e_w:.3e} "
          f"(tol {HEDGE_TOL}), expected_cost rel {e_c:.3e}; chosen differ at "
          f"{int(differ.sum())} of {differ.numel()} draws, {n_knife} knife "
          f"edges (|cdf - u*total| < {KNIFE_EDGE} total), {n_bad} elsewhere "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        fail("hedge_replay disagrees with its plain version")

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
    rng = np.random.default_rng(4)
    Cs = rng.random((2, 300, 25)) * 0.6 + np.linspace(0, 0.4, 25)
    arr = np.cumsum(rng.exponential(0.25, 300))
    specs = [LearnerSpec("hedge"), LearnerSpec("hedge", eta=Schedule("const", 0.3))]
    lr_d = replay(Cs, arr, 3.0, learners=specs, seed=5, backend="torch",
                  device="cuda")
    lr_h = replay(Cs, arr, 3.0, learners=specs, seed=5, backend="numpy")
    e_w = float(np.abs(lr_d.weights - lr_h.weights).max())
    e_p = float(np.abs(lr_d.p_chosen - lr_h.p_chosen).max())
    if not np.array_equal(lr_d.chosen, lr_h.chosen) or max(e_w, e_p) > HEDGE_TOL:
        fail(f"hedge replay off the float64 host loop (weights {e_w:.3e}, "
             f"p_chosen {e_p:.3e}, chosen equal "
             f"{np.array_equal(lr_d.chosen, lr_h.chosen)})")
    print(f"small input: cost tensors vs float64 oracle max abs {worst:.3e} "
          f"(tol {COST_TOL} abs + rel); hedge vs host loop weights "
          f"{e_w:.3e}, p_chosen {e_p:.3e}, chosen equal")

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
