"""The paper's scheduling core (host float64, copied from ``repro.core``)
plus TOLA and the policy sweeps over the port's engine."""

from repro_torch.core.baselines import (
    B_BIDS,
    C1_BETA0,
    C2_BETA,
    benchmark_bid_policies,
    run_even,
    run_greedy,
    selfowned_policies,
    spot_od_policies,
    sweep_policies,
)
from repro_torch.core.dealloc import (
    dealloc,
    expected_spot_work,
    window_sizes,
    window_sizes_batch,
)
from repro_torch.core.market import SpotMarket
from repro_torch.core.policy import f_selfowned, selfowned_allocation, spot_ondemand_split
from repro_torch.core.pool import LazySegmentTree, SelfOwnedPool
from repro_torch.core.scheduler import (
    Policy,
    StreamCosts,
    build_plans_batch,
    evaluate_policy_fullpool,
    job_arrays,
    run_jobs,
)
from repro_torch.core.simulate import simulate_tasks
from repro_torch.core.tola import (
    TolaResult,
    cost_matrix,
    run_tola,
    run_tola_scenarios,
)
from repro_torch.core.transform import chain_of, transform
from repro_torch.core.types import (
    Allocation,
    ChainJob,
    DAGJob,
    JobCost,
    Task,
    TaskCost,
    chain_from_arrays,
)
from repro_torch.core.workload import generate_chain_jobs, generate_dag_jobs

__all__ = [
    "Allocation", "ChainJob", "DAGJob", "Task", "TaskCost", "JobCost",
    "chain_from_arrays", "SpotMarket", "SelfOwnedPool", "LazySegmentTree",
    "transform", "chain_of", "Policy", "StreamCosts", "build_plans_batch",
    "job_arrays", "simulate_tasks", "dealloc", "window_sizes",
    "window_sizes_batch",
    "expected_spot_work", "f_selfowned", "selfowned_allocation",
    "spot_ondemand_split", "run_jobs", "evaluate_policy_fullpool",
    "TolaResult", "cost_matrix", "run_tola", "run_tola_scenarios",
    "generate_chain_jobs", "generate_dag_jobs", "spot_od_policies", "selfowned_policies",
    "benchmark_bid_policies", "run_greedy", "run_even", "sweep_policies",
    "C1_BETA0", "C2_BETA", "B_BIDS",
]
