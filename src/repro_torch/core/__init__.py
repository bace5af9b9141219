"""The paper's scheduling core (host float64, copied from ``repro.core``)
plus TOLA over the port's engine."""

from repro_torch.core.baselines import (
    B_BIDS,
    C1_BETA0,
    C2_BETA,
    benchmark_bid_policies,
    selfowned_policies,
    spot_od_policies,
)
from repro_torch.core.market import SpotMarket
from repro_torch.core.scheduler import Policy, StreamCosts
from repro_torch.core.tola import (
    TolaResult,
    cost_matrix,
    run_tola,
    run_tola_scenarios,
)
from repro_torch.core.types import ChainJob, Task, chain_from_arrays
from repro_torch.core.workload import generate_chain_jobs

__all__ = [
    "ChainJob", "Task", "chain_from_arrays", "SpotMarket", "Policy",
    "StreamCosts", "TolaResult", "cost_matrix", "run_tola",
    "run_tola_scenarios", "generate_chain_jobs", "spot_od_policies",
    "selfowned_policies", "benchmark_bid_policies", "C1_BETA0", "C2_BETA",
    "B_BIDS",
]
