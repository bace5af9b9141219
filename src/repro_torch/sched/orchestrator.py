"""Fleet orchestrator: the paper's Algorithm 2 + TOLA driving training jobs.

Given a stream of training/eval DAG jobs (``sched.jobs``), the orchestrator:
  1. transforms each DAG to a chain (Nagarajan),
  2. learns {beta, beta_0, bid} online (TOLA) against the preemptible-pod
     market, its counterfactual cost tensor on the card,
  3. allocates reserved (self-owned) pods via policy (12), preemptible pods
     while flexibility holds, and on-demand pods after each stage's turning
     point (Def. 3.2),
  4. exposes per-job schedules so an elastic trainer knows when a stage
     must migrate from preemptible to on-demand capacity.

The cost report prices the whole fleet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import (
    Policy,
    SpotMarket,
    run_tola,
    selfowned_policies,
    spot_od_policies,
    transform,
)
from repro_torch.core.scheduler import build_plans, run_jobs
from repro_torch.core.types import ChainJob, DAGJob
from repro_torch.device import resolve_device
from repro_torch.sched.fleet import FleetSpec

__all__ = ["FleetOrchestrator", "ScheduleReport"]


@dataclasses.dataclass
class ScheduleReport:
    total_cost: float
    unit_cost: float
    spot_fraction: float
    selfowned_fraction: float
    ondemand_fraction: float
    best_policy: Policy
    weights_top: float


class FleetOrchestrator:
    """``device`` is where TOLA's cost tensor is computed (``"cuda"``, the
    default, raises without a GPU; ``"cpu"`` runs the plain versions)."""

    def __init__(self, fleet: FleetSpec, horizon_units: float,
                 market_seed: int = 0, device="cuda"):
        self.fleet = fleet
        self.market = SpotMarket(horizon_units, seed=market_seed)
        self.device = resolve_device(device)

    def schedule(self, dag_jobs: list[DAGJob], seed: int = 0,
                 learn: bool = True) -> ScheduleReport:
        chains: list[ChainJob] = [transform(j) for j in dag_jobs]
        r = self.fleet.reserved_pods
        grid = selfowned_policies() if r > 0 else spot_od_policies()
        if learn:
            res = run_tola(chains, grid, self.market, r_total=r, seed=seed,
                           device=self.device)
            costs = res.realized
            best = grid[int(np.argmax(res.weights))]
            top_w = float(res.weights.max())
        else:
            best_alpha, best, costs = np.inf, grid[0], None
            for pol in grid:
                c = run_jobs(chains, pol, self.market, r_total=r)
                a = c.average_unit_cost()
                if a < best_alpha:
                    best_alpha, best, costs = a, pol, c
            top_w = 1.0
        Z = costs.workload.sum()
        work = costs.spot_work.sum() + costs.ondemand_work.sum() + \
            costs.selfowned_work.sum()
        return ScheduleReport(
            total_cost=float(costs.total_cost.sum()),
            unit_cost=float(costs.total_cost.sum() / Z),
            spot_fraction=float(costs.spot_work.sum() / max(work, 1e-9)),
            selfowned_fraction=float(
                costs.selfowned_work.sum() / max(work, 1e-9)),
            ondemand_fraction=float(
                costs.ondemand_work.sum() / max(work, 1e-9)),
            best_policy=best,
            weights_top=top_w,
        )

    def stage_plan(self, dag_job: DAGJob, policy: Policy):
        """Planned windows + turning points for one job under a policy —
        what an elastic trainer consumes (when to expect migration)."""
        chain = transform(dag_job)
        plan = build_plans([chain], policy, self.fleet.reserved_pods)
        return plan
