"""The port's evaluation engine: plans, device views, cost kernels.

    from repro_torch.engine import evaluate_grid
    res = evaluate_grid(jobs, policies, markets, r_total)   # on the card
    C = res.unit_cost[s]          # (n_jobs, n_policies) cost matrix

``markets`` may also be a ``ScenarioSpec`` (synthesized on the card) with
``scenario_chunk=K``; ``evaluate_grid_chunks`` yields the chunks. A
re-bid grid is re-scored against an earlier result with
``evaluate_grid_delta(res, jobs, policies2, markets, r_total)``. Every
entry point takes ``mesh=`` (a ``GridMesh``, an int or a ``DeviceMesh``)
to shard the scenario and group axes over a ``torch.distributed``
process group.
"""

from repro_torch.engine.api import (
    GridChunk,
    evaluate_grid,
    evaluate_grid_chunks,
    resolve_plan_backend,
)
from repro_torch.engine.cache import (
    clear_caches,
    evaluate_grid_delta,
    jobs_fingerprint,
    scenario_fingerprint,
)
from repro_torch.engine.cache import configure as configure_caches
from repro_torch.engine.mesh import GridMesh, ScenarioMesh, as_scenario_mesh
from repro_torch.engine.plan import EvalGroup, GridPlan, build_grid_plan
from repro_torch.engine.result import EngineResult
from repro_torch.engine.scenarios import (
    SCENARIO_KINDS,
    MarketListBatch,
    ScenarioBatch,
    ScenarioSource,
    ScenarioSpec,
    ScenarioStream,
    SynthBatch,
    adversarial_scenarios,
    as_source,
    check_scenarios,
    make_scenarios,
    replay_scenarios,
    stack_views,
)

__all__ = ["evaluate_grid", "evaluate_grid_chunks", "GridChunk",
           "resolve_plan_backend", "evaluate_grid_delta", "clear_caches",
           "configure_caches", "jobs_fingerprint", "scenario_fingerprint",
           "EngineResult", "EvalGroup", "GridPlan",
           "build_grid_plan", "SCENARIO_KINDS", "ScenarioSpec",
           "ScenarioStream", "ScenarioSource", "ScenarioBatch",
           "MarketListBatch", "SynthBatch", "as_source", "check_scenarios",
           "make_scenarios", "adversarial_scenarios", "replay_scenarios",
           "stack_views", "GridMesh", "ScenarioMesh", "as_scenario_mesh"]
