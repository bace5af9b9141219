"""Experiment 2 (paper Table 3) — overall improvement with self-owned pool,
on the port.

Proposed: Algorithm 2 end-to-end — Dealloc(beta/beta_0) windows + policy (12)
self-owned allocation + Prop 4.1 composition, minimized over
P = C1 x C2 x B (175 policies; the chain-cost kernel). Benchmark: Even
windows + naive FCFS self-owned (r_i = min{N, delta_i}) with planned
starts, minimized over P' = B (the task-cost kernel). Both replay the
chronological shared pool per policy on the host.

    PYTHONPATH=src python -m repro_torch.experiments.exp2_self_owned \
        --jobs 40 --types 1 --r 60 --device cpu
"""

from __future__ import annotations

from repro_torch.core import benchmark_bid_policies, selfowned_policies
from repro_torch.experiments.common import (
    Timer,
    argparser,
    make_setup,
    print_table,
    sweep_min,
)

__all__ = ["run", "print_rows", "main"]


def run(n_jobs: int, types: list[int], rs: list[int], seed: int = 0,
        scenarios: int = 1, device="cuda",
        scenario_kind: str = "fresh",
        scenario_chunk: int | None = None, mesh=None) -> dict:
    out = {}
    for jt in types:
        s = make_setup(n_jobs, jt, seed, scenarios=scenarios,
                       scenario_kind=scenario_kind, device=device,
                       scenario_chunk=scenario_chunk, mesh=mesh)
        for r in rs:
            with Timer(f"exp2 type {jt} r={r}"):
                pol, alpha, costs = sweep_min(
                    s, selfowned_policies(), r_total=r, early_start=True)
                bench_alpha = sweep_min(
                    s, benchmark_bid_policies(), r_total=r, windows="even",
                    selfowned="naive", early_start=False)[1]
                out[(r, jt)] = {
                    "alpha": alpha,
                    "bench": bench_alpha,
                    "rho": 1 - alpha / bench_alpha,
                    "best_policy": (round(pol.beta, 3), pol.bid,
                                    round(pol.beta0, 3)),
                }
    return out


def print_rows(res: dict) -> None:
    rows = [[r, jt, f"{v['alpha']:.4f}", f"{v['bench']:.4f}",
             f"{v['rho']:.2%}", v["best_policy"]]
            for (r, jt), v in sorted(res.items())]
    print_table("Table 3 — overall improvement with self-owned instances",
                ["r", "type", "alpha", "bench", "rho", "best_policy"], rows)


def main(argv=None):
    args = argparser(__doc__.split("\n\n")[0]).parse_args(argv)
    res = run(args.jobs, args.types, args.r, args.seed, args.scenarios,
              args.device, args.scenario_kind, args.scenario_chunk,
              args.mesh)
    print_rows(res)
    return res


if __name__ == "__main__":
    main()
