"""The port's evaluation engine: plans, device views, cost kernels.

    from repro_torch.engine import evaluate_grid
    res = evaluate_grid(jobs, policies, markets, r_total)   # on the card
    C = res.unit_cost[s]          # (n_jobs, n_policies) cost matrix
"""

from repro_torch.engine.api import evaluate_grid, resolve_plan_backend
from repro_torch.engine.plan import EvalGroup, GridPlan, build_grid_plan
from repro_torch.engine.result import EngineResult
from repro_torch.engine.scenarios import (
    MarketListBatch,
    adversarial_scenarios,
    check_scenarios,
    make_scenarios,
    stack_views,
)

__all__ = ["evaluate_grid", "resolve_plan_backend", "EngineResult",
           "EvalGroup", "GridPlan", "build_grid_plan", "MarketListBatch",
           "check_scenarios", "make_scenarios", "adversarial_scenarios",
           "stack_views"]
