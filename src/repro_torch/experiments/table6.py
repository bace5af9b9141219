"""Experiment 4 (paper Table 6) — TOLA online learning, on the port.

rho_bar = 1 - alpha_bar(P) / alpha_bar(P'): realized average unit cost when
TOLA drives the proposed grid vs when it drives the benchmark grid (Even
windows + naive self-owned, bid-only policies, planned starts). Job type 2,
r in {0, 300, 600, 900, 1200} by default. The cost tensors are computed on
the card (``device="cuda"``); ``--learner`` (several kinds) or
``--eta-grid`` adds the learner-comparison table, a replay of every
(learner, eta) instance over the last round's cost tensor: the Hedge
instances in one ``hedge_replay`` launch, the exp3, ucb1, egreedy and ftl
instances in one ``learner_replay`` launch. Its rows are the reference's
(``benchmarks/exp4_online_learning.py``, same ``comparison_specs``):
``--learner hedge exp3 ucb1 egreedy ftl`` with an 8-point ``--eta-grid``
gives 2 * (1 + 8) + 3 = 21 rows per r.

    PYTHONPATH=src python -m repro_torch.experiments.table6 --jobs 10000 \
        --r 0 1200 --scenarios 2 --learner hedge exp3 ucb1 egreedy ftl \
        --eta-grid 0.01 0.03 0.1 0.3 1 3 10 30
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (
    benchmark_bid_policies,
    generate_chain_jobs,
    run_tola_scenarios,
    selfowned_policies,
    spot_od_policies,
)
from repro_torch.engine import make_scenarios
from repro_torch.learn import LEARNER_KINDS, LearnerSpec, Schedule, replay

__all__ = ["run", "comparison_specs", "print_tables", "main"]


def comparison_specs(learners: list[str], eta_grid: list[float]):
    """Every requested learner with its default (alg4) schedule, plus one
    variant per eta-grid point for the learners that take a learning rate."""
    specs = []
    for kind in learners:
        specs.append(LearnerSpec(kind))
        if kind in ("hedge", "exp3"):
            for c in eta_grid:
                specs.append(LearnerSpec(kind, eta=Schedule("const", c)))
    return specs


def run(n_jobs: int, rs: list[int], seed: int = 0, scenarios: int = 1,
        learners: list[str] | None = None,
        eta_grid: list[float] | None = None, device="cuda",
        job_type: int = 2) -> dict:
    """Table 6 rows per r (plus ``"comparison"`` rows with an eta grid or
    several learners), and ``"timings"``: wall seconds per phase."""
    learners = learners or ["hedge"]
    eta_grid = eta_grid or []
    compare = len(learners) > 1 or bool(eta_grid)
    t0 = time.perf_counter()
    jobs = generate_chain_jobs(n_jobs, job_type, seed=seed)
    horizon = max(j.deadline for j in jobs) + 1.0
    markets = make_scenarios(horizon, max(scenarios, 1), seed=seed + 1000)
    arrivals = np.array([j.arrival for j in jobs])
    d = max(j.deadline - j.arrival for j in jobs)
    Z = np.array([j.total_work for j in jobs])
    out: dict = {"timings": {"setup": time.perf_counter() - t0}}
    for r in rs:
        t_r = time.perf_counter()
        grid = selfowned_policies() if r > 0 else spot_od_policies()
        props = run_tola_scenarios(
            jobs, grid, markets, r_total=r, seed=seed, early_start=True,
            learner=learners[0], device=device)
        benches = run_tola_scenarios(
            jobs, benchmark_bid_policies(), markets, r_total=r,
            windows="even", selfowned="naive", early_start=False, seed=seed,
            learner=learners[0], device=device)
        a_prop = np.array([p.average_unit_cost() for p in props])
        a_bench = np.array([b.average_unit_cost() for b in benches])
        row = {
            "learner": learners[0],
            "alpha_tola": float(a_prop.mean()),
            "alpha_bench": float(a_bench.mean()),
            "rho_bar": 1 - float(a_prop.mean()) / float(a_bench.mean()),
            "best_fixed": float(np.mean(
                [p.best_fixed_unit_cost for p in props])),
            "regret": float(np.mean([p.regret_per_job for p in props])),
            "top_weight": float(np.mean([p.weights.max() for p in props])),
            "timings": {"proposed": dict(props[0].timings),
                        "benchmark": dict(benches[0].timings)},
        }
        if len(markets) > 1:
            row["alpha_tola_std"] = float(a_prop.std())
        if compare:
            # One batched replay of every (learner, eta) instance over the
            # scenario-stacked cost tensor of the last round.
            t_c = time.perf_counter()
            C = np.stack([p.cost_matrix for p in props])
            lr = replay(C, arrivals, d, workload=Z,
                        learners=comparison_specs(learners, eta_grid),
                        seed=seed, backend="torch", device=device)
            row["comparison"] = lr.summary()
            row["timings"]["compare_replay"] = time.perf_counter() - t_c
        row["timings"]["wall"] = time.perf_counter() - t_r
        out[r] = row
    return out


def _phase_line(label: str, t: dict) -> str:
    keys = ("plan", "pool", "views", "eval", "replay", "realize")
    return f"{label}: " + " ".join(f"{k}={t.get(k, 0.0):.3f}s" for k in keys)


def print_tables(res: dict) -> None:
    """The Table 6 and learner-comparison tables, CSV, plus phase times."""
    rs = sorted(k for k in res if k != "timings")
    print("\n== Table 6 — TOLA online learning (job type 2) ==")
    print("r,alpha_tola,alpha_bench,rho_bar,best_fixed,regret,top_weight")
    for r in rs:
        v = res[r]
        print(f"{r},{v['alpha_tola']:.4f},{v['alpha_bench']:.4f},"
              f"{v['rho_bar']:.2%},{v['best_fixed']:.4f},{v['regret']:.4f},"
              f"{v['top_weight']:.3f}")
    if any("comparison" in res[r] for r in rs):
        print("\n== Learner comparison (counterfactual dedicated-pool "
              "replay, common random numbers) ==")
        print("r,learner,alpha_cf,regret,expected_regret,top_weight")
        for r in rs:
            for row in res[r].get("comparison", []):
                print(f"{r},{row['learner']},{row['realized_unit']:.4f},"
                      f"{row['regret']:.4f},{row['expected_regret']:.4f},"
                      f"{row['top_weight']:.3f}")
    print(f"\n[setup (jobs + markets): {res['timings']['setup']:.3f}s]")
    for r in rs:
        t = res[r]["timings"]
        print(f"[r={r} wall {t['wall']:.3f}s] "
              + _phase_line("proposed", t["proposed"]) + " | "
              + _phase_line("benchmark", t["benchmark"])
              + (f" | compare_replay={t['compare_replay']:.3f}s"
                 if "compare_replay" in t else ""))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--jobs", type=int, default=1500,
                   help="jobs per stream (paper: ~10000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--r", type=int, nargs="+", default=[0, 300, 600, 900,
                                                          1200])
    p.add_argument("--scenarios", type=int, default=1)
    p.add_argument("--learner", nargs="+", default=["hedge"],
                   choices=list(LEARNER_KINDS))
    p.add_argument("--eta-grid", type=float, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    res = run(args.jobs, args.r, args.seed, scenarios=args.scenarios,
              learners=args.learner, eta_grid=args.eta_grid,
              device=args.device)
    print_tables(res)
    return res


if __name__ == "__main__":
    main()
