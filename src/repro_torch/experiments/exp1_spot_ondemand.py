"""Experiment 1 (paper Table 2) — spot + on-demand only, on the port.

rho_{0,x2} = 1 - alpha_proposed / alpha_benchmark, where the proposed policy
is Dealloc (Algorithm 1) + Prop 4.1 composition minimized over
P = C2 x B (25 policies), and the benchmarks are Greedy / Even minimized
over P' = B (bid only; Even's window split needs no parameter).

Also reports the strengthened Even(early-start) baseline (beyond the
paper). The proposed and Even(early) sweeps run the chain-cost kernel, the
Even sweep (planned starts) the task-cost kernel; Greedy is host float64.

    PYTHONPATH=src python -m repro_torch.experiments.exp1_spot_ondemand \
        --jobs 40 --types 1 --device cpu
"""

from __future__ import annotations

from repro_torch.core import B_BIDS, spot_od_policies
from repro_torch.experiments.common import (
    Timer,
    argparser,
    greedy_min,
    make_setup,
    print_table,
    sweep_min,
)

__all__ = ["run", "print_rows", "main"]


def run(n_jobs: int, types: list[int], seed: int = 0, scenarios: int = 1,
        device="cuda", scenario_kind: str = "fresh",
        scenario_chunk: int | None = None, mesh=None) -> dict:
    out = {}
    for jt in types:
        with Timer(f"exp1 type {jt}"):
            s = make_setup(n_jobs, jt, seed, scenarios=scenarios,
                           scenario_kind=scenario_kind, device=device,
                           scenario_chunk=scenario_chunk, mesh=mesh)
            pol, alpha, _ = sweep_min(s, spot_od_policies(), early_start=True)
            greedy = greedy_min(s, B_BIDS)
            even_planned = sweep_min(
                s, spot_od_policies(), windows="even", early_start=False)[1]
            even_early = sweep_min(
                s, spot_od_policies(), windows="even", early_start=True)[1]
            out[jt] = {
                "alpha": alpha,
                "best_policy": (round(pol.beta, 3), pol.bid),
                "rho_vs_greedy": 1 - alpha / greedy,
                "rho_vs_even": 1 - alpha / even_planned,
                "rho_vs_even_early": 1 - alpha / even_early,
            }
    return out


def print_rows(res: dict) -> None:
    rows = [[jt, f"{r['alpha']:.4f}", r["best_policy"],
             f"{r['rho_vs_greedy']:.2%}", f"{r['rho_vs_even']:.2%}",
             f"{r['rho_vs_even_early']:.2%}"] for jt, r in res.items()]
    print_table("Table 2 — cost improvement, spot + on-demand",
                ["type", "alpha", "best_policy", "rho_vs_greedy",
                 "rho_vs_even", "rho_vs_even_early(beyond-paper)"], rows)


def main(argv=None):
    args = argparser(__doc__.split("\n\n")[0]).parse_args(argv)
    res = run(args.jobs, args.types, args.seed, args.scenarios, args.device,
              args.scenario_kind, args.scenario_chunk, args.mesh)
    print_rows(res)
    return res


if __name__ == "__main__":
    main()
