"""Result container of the port's evaluation engine."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EngineResult"]


@dataclasses.dataclass
class EngineResult:
    """Batched (scenario x job x policy) evaluation output (host float64).

    ``unit_cost[s, j, p]`` is the per-unit-workload cost of job j under
    policy p in market scenario s — the TOLA counterfactual cost matrix is
    ``unit_cost[s]``; the cost decomposition is kept per cell.
    """

    unit_cost: np.ndarray          # (S, J, P)
    spot_cost: np.ndarray          # (S, J, P)
    ondemand_cost: np.ndarray      # (S, J, P)
    spot_work: np.ndarray          # (S, J, P)
    ondemand_work: np.ndarray      # (S, J, P)
    workload: np.ndarray           # (J,)
    selfowned_work: np.ndarray     # (J, P); (S, J, P) with per-scenario
    selfowned_reserved: np.ndarray  # availability queries
    device: str = "cuda"
    single_market: bool = False    # True when the caller passed one market
    # Phase wall seconds: "plan" (window tensors), "pool" (self-owned +
    # residuals), "views" (stacked market views to the device), "eval"
    # (cost kernels, device results back on the host).
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def n_scenarios(self) -> int:
        return self.unit_cost.shape[0]

    @property
    def matrix(self) -> np.ndarray:
        """(J, P) unit-cost matrix — requires a single scenario."""
        if self.unit_cost.shape[0] != 1:
            raise ValueError(
                f"matrix is ambiguous over {self.unit_cost.shape[0]} "
                "scenarios; index unit_cost[s] explicitly")
        return self.unit_cost[0]
