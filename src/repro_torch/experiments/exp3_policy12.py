"""Experiment 3 (paper Tables 4 + 5) — isolating policy (12), on the port.

Both sides use the SAME deadline allocation (lines 1-5 of Algorithm 2); they
differ only in the self-owned allocator: policy (12) vs naive FCFS
(r_i = min{N, delta_i}). Each side is minimized over the full grid
P = C1 x C2 x B (early starts: the chain-cost kernel) so the comparison
isolates the self-owned policy alone.

Table 5's utilization ratio mu = util(prop12) / util(naive) is reported for
the cost-minimizing policy of each side (self-owned instance-time that
processed real workload, over the pool's capacity r * max deadline).

    PYTHONPATH=src python -m repro_torch.experiments.exp3_policy12 \
        --jobs 40 --types 1 --r 60 --device cpu
"""

from __future__ import annotations

from repro_torch.core import selfowned_policies
from repro_torch.experiments.common import (
    Timer,
    argparser,
    make_setup,
    print_table,
    sweep_min,
)

__all__ = ["run", "print_rows", "main"]


def _best(setup, r, selfowned):
    """Engine-batched sweep; returns (alpha, policy, StreamCosts)."""
    pol, alpha, costs = sweep_min(setup, selfowned_policies(), r_total=r,
                                  selfowned=selfowned, early_start=True)
    return alpha, pol, costs


def run(n_jobs: int, types: list[int], rs: list[int], seed: int = 0,
        scenarios: int = 1, device="cuda",
        scenario_kind: str = "fresh",
        scenario_chunk: int | None = None, mesh=None) -> dict:
    out = {}
    for jt in types:
        s = make_setup(n_jobs, jt, seed, scenarios=scenarios,
                       scenario_kind=scenario_kind, device=device,
                       scenario_chunk=scenario_chunk, mesh=mesh)
        horizon = max(j.deadline for j in s.jobs)
        for r in rs:
            with Timer(f"exp3 type {jt} r={r}"):
                a_prop, _, c_prop = _best(s, r, "prop12")
                a_naive, _, c_naive = _best(s, r, "naive")
                util_prop = c_prop.selfowned_work.sum() / (r * horizon)
                util_naive = c_naive.selfowned_work.sum() / (r * horizon)
                out[(r, jt)] = {
                    "rho": 1 - a_prop / a_naive,
                    "alpha_prop": a_prop,
                    "alpha_naive": a_naive,
                    "mu": util_prop / max(util_naive, 1e-12),
                }
    return out


def print_rows(res: dict) -> None:
    rows = [[r, jt, f"{v['alpha_prop']:.4f}", f"{v['alpha_naive']:.4f}",
             f"{v['rho']:.2%}", f"{v['mu']:.4f}"]
            for (r, jt), v in sorted(res.items())]
    print_table("Tables 4+5 — policy (12) vs naive self-owned",
                ["r", "type", "alpha_prop12", "alpha_naive", "rho",
                 "utilization_ratio_mu"], rows)


def main(argv=None):
    args = argparser(__doc__.split("\n\n")[0]).parse_args(argv)
    res = run(args.jobs, args.types, args.r, args.seed, args.scenarios,
              args.device, args.scenario_kind, args.scenario_chunk,
              args.mesh)
    print_rows(res)
    return res


if __name__ == "__main__":
    main()
