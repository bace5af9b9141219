"""Experiment 4 (paper Table 6) — TOLA online learning, on the port.

rho_bar = 1 - alpha_bar(P) / alpha_bar(P'): realized average unit cost when
TOLA drives the proposed grid vs when it drives the benchmark grid (Even
windows + naive self-owned, bid-only policies, planned starts). Job type 2,
r in {0, 300, 600, 900, 1200} by default. The cost tensors, and the plan
tensors they are scored on, are computed on the card (``device="cuda"``);
``--scenario-kind`` picks the market family (fresh, regime, adversarial;
adaptive with ``--scenario-chunk``).
``--learner`` (several kinds) or
``--eta-grid`` adds the learner-comparison table, a replay of every
(learner, eta) instance over the last round's cost tensor: the Hedge
instances in one ``hedge_replay`` launch, the exp3, ucb1, egreedy and ftl
instances in one ``learner_replay`` launch. Its rows are the reference's
(``benchmarks/exp4_online_learning.py``, same ``comparison_specs``):
``--learner hedge exp3 ucb1 egreedy ftl`` with an 8-point ``--eta-grid``
gives 2 * (1 + 8) + 3 = 21 rows per r. ``--scenario-chunk K`` makes the
markets a ``ScenarioSpec`` and adds the streamed rows: every comparison
instance replayed chunk by chunk over the spec (``replay_stream``, a
fresh ``ScenarioStream`` per r, synthesized on the card; an ``adaptive``
spec reacts to the first learner at each chunk boundary). ``--mesh N``
shards every engine pass and the streamed fold over N ranks of a
``torch.distributed`` process group (clamped, with a warning, to its
ranks).

    PYTHONPATH=src python -m repro_torch.experiments.table6 --jobs 10000 \
        --r 0 1200 --scenarios 2 --learner hedge exp3 ucb1 egreedy ftl \
        --eta-grid 0.01 0.03 0.1 0.3 1 3 10 30
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (
    benchmark_bid_policies,
    run_tola_scenarios,
    selfowned_policies,
    spot_od_policies,
)
from repro_torch.engine import ScenarioStream
from repro_torch.experiments.common import SCENARIO_KINDS, make_setup
from repro_torch.obs import span
from repro_torch.learn import (
    LEARNER_KINDS,
    LearnerSpec,
    Schedule,
    replay,
    replay_stream,
)

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
        job_type: int = 2, scenario_kind: str = "fresh",
        scenario_chunk: int | None = None, mesh=None) -> dict:
    """Table 6 rows per r (plus ``"comparison"`` rows with an eta grid or
    several learners, and ``"stream"`` rows with a scenario chunk), and
    ``"timings"``: wall seconds per phase, each the seconds of the span
    of its name."""
    learners = learners or ["hedge"]
    eta_grid = eta_grid or []
    compare = len(learners) > 1 or bool(eta_grid)
    with span("setup", n_jobs=n_jobs, scenarios=scenarios) as sp:
        setup = make_setup(n_jobs, job_type, seed, scenarios=scenarios,
                           scenario_kind=scenario_kind, device=device,
                           scenario_chunk=scenario_chunk, mesh=mesh)
        jobs, markets = setup.jobs, setup.markets
        arrivals = np.array([j.arrival for j in jobs])
        d = max(j.deadline - j.arrival for j in jobs)
        Z = np.array([j.total_work for j in jobs])
    out: dict = {"timings": {"setup": sp.seconds}}
    for r in rs:
        with span("wall", r=r) as sp_r:
            grid = selfowned_policies() if r > 0 else spot_od_policies()
            props = run_tola_scenarios(
                jobs, grid, markets, r_total=r, seed=seed, early_start=True,
                learner=learners[0], device=device, mesh=setup.mesh)
            benches = run_tola_scenarios(
                jobs, benchmark_bid_policies(), markets, r_total=r,
                windows="even", selfowned="naive", early_start=False,
                seed=seed, learner=learners[0], device=device,
                mesh=setup.mesh)
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
                "top_weight": float(np.mean([p.weights.max()
                                             for p in props])),
                "timings": {"proposed": dict(props[0].timings),
                            "benchmark": dict(benches[0].timings)},
            }
            if len(markets) > 1:
                row["alpha_tola_std"] = float(a_prop.std())
            if compare:
                # One batched replay of every (learner, eta) instance over
                # the scenario-stacked cost tensor of the last round.
                with span("compare_replay") as sp:
                    C = np.stack([p.cost_matrix for p in props])
                    lr = replay(C, arrivals, d, workload=Z,
                                learners=comparison_specs(learners,
                                                          eta_grid),
                                seed=seed, backend="torch", device=device)
                    row["comparison"] = lr.summary()
                row["timings"]["compare_replay"] = sp.seconds
            if scenario_chunk:
                # Streamed counterfactual regret straight from the spec: no
                # (S, J, P) tensor, no per-scenario market objects; a fresh
                # adversary state per r.
                with span("stream") as sp:
                    slr = replay_stream(
                        jobs, grid, ScenarioStream(setup.scenarios),
                        r_total=r,
                        learners=comparison_specs(learners, eta_grid),
                        seed=seed, scenario_chunk=scenario_chunk,
                        device=device, mesh=setup.mesh)
                    row["stream"] = slr.summary()
                row["timings"]["stream"] = sp.seconds
        row["timings"]["wall"] = sp_r.seconds
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
    if any("stream" in res[r] for r in rs):
        print("\n== Streamed regret (ScenarioSpec, replay_stream by "
              "scenario chunks) ==")
        print("r,learner,alpha_cf,regret,expected_regret,top_weight")
        for r in rs:
            for row in res[r].get("stream", []):
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
                 if "compare_replay" in t else "")
              + (f" | stream={t['stream']:.3f}s" if "stream" in t else ""))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--jobs", type=int, default=1500,
                   help="jobs per stream (paper: ~10000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--r", type=int, nargs="+", default=[0, 300, 600, 900,
                                                          1200])
    p.add_argument("--scenarios", type=int, default=1)
    p.add_argument("--scenario-kind", choices=SCENARIO_KINDS, default="fresh",
                   help="market family (adversarial = lure/spike square "
                        "waves driving worst-case TOLA regret; adaptive = "
                        "spikes chosen by watching the learner, needs "
                        "--scenario-chunk)")
    p.add_argument("--scenario-chunk", type=int, default=None,
                   help="stream a ScenarioSpec K scenarios per pass and add "
                        "the streamed regret rows")
    p.add_argument("--learner", nargs="+", default=["hedge"],
                   choices=list(LEARNER_KINDS))
    p.add_argument("--eta-grid", type=float, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard the scenario axis over an N-rank mesh of the "
                        "torch.distributed process group (clamped to its "
                        "ranks with a warning; 1 without one)")
    args = p.parse_args(argv)
    if args.scenario_kind == "adaptive" and args.scenario_chunk is None:
        p.error("--scenario-kind adaptive needs --scenario-chunk (the "
                "adversary takes chunk-boundary feedback)")
    res = run(args.jobs, args.r, args.seed, scenarios=args.scenarios,
              learners=args.learner, eta_grid=args.eta_grid,
              device=args.device, scenario_kind=args.scenario_kind,
              scenario_chunk=args.scenario_chunk, mesh=args.mesh)
    print_tables(res)
    return res


if __name__ == "__main__":
    main()
