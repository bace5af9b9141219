"""Result container of the port's evaluation engine."""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scheduler import StreamCosts

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
    # Scenarios EVALUATED — differs from the leading axis length only under
    # reduce="mean", where the arrays hold the scenario mean (axis 1).
    n_scenarios_total: int | None = None
    # Phase wall seconds, derived from the ``repro_torch.obs`` span tree
    # (every value is some span's ``.seconds``, or a left-to-right sum of
    # them in completion order, so under an active ``obs.tracing()`` the
    # dict and the tracer's totals agree bit for bit): "plan" (window
    # tensors), "pool" (self-owned + residuals), "synth" (scenario
    # synthesis, under overlap the residual wait), "views" (stacked market
    # views on the device, one span per bid), "eval" (cost kernels, device
    # results back on the host), each summed over the scenario chunks;
    # "chunks" the per-chunk split, "overlap" whether chunk synthesis was
    # double-buffered; "plan_cached" the groups the cross-call plan cache
    # served.
    timings: dict = dataclasses.field(default_factory=dict)
    # Observability snapshot ({"metrics": ..., "compiled": ...}) taken when
    # an ``repro_torch.obs`` collection context was active; None otherwise.
    obs: dict | None = None
    # Delta-evaluation handle: the jobs/scenario fingerprints, resolved
    # config and per-group dedup signatures this result was computed
    # under, read by ``evaluate_grid_delta`` to re-score only changed
    # groups. None when the inputs have no cross-call identity (adaptive
    # streams, availability queries, reduce="mean").
    delta_state: dict | None = None

    @property
    def n_scenarios(self) -> int:
        return self.unit_cost.shape[0]

    @property
    def total_cost(self) -> np.ndarray:
        return self.spot_cost + self.ondemand_cost

    @property
    def matrix(self) -> np.ndarray:
        """(J, P) unit-cost matrix — requires a single scenario."""
        if self.unit_cost.shape[0] != 1:
            raise ValueError(
                f"matrix is ambiguous over {self.unit_cost.shape[0]} "
                "scenarios; index unit_cost[s] explicitly")
        return self.unit_cost[0]

    def avg_unit_cost(self) -> np.ndarray:
        """alpha[s, p] = sum_j c_j / sum_j Z_j (paper Section 6.1)."""
        return self.total_cost.sum(axis=1) / self.workload.sum()

    def best(self, s: int | None = None) -> tuple[int, float]:
        """(policy index, alpha) minimizing the (scenario-mean) stream cost."""
        alpha = self.avg_unit_cost()
        a = alpha.mean(axis=0) if s is None else alpha[s]
        p = int(np.argmin(a))
        return p, float(a[p])

    def stream_costs(self, p: int, s: int = 0) -> StreamCosts:
        """Per-job StreamCosts of policy p in scenario s."""
        so_w = self.selfowned_work if self.selfowned_work.ndim == 2 \
            else self.selfowned_work[s]
        so_r = self.selfowned_reserved if self.selfowned_reserved.ndim == 2 \
            else self.selfowned_reserved[s]
        return StreamCosts(
            spot_cost=self.spot_cost[s, :, p].copy(),
            ondemand_cost=self.ondemand_cost[s, :, p].copy(),
            spot_work=self.spot_work[s, :, p].copy(),
            ondemand_work=self.ondemand_work[s, :, p].copy(),
            selfowned_work=so_w[:, p].copy(),
            workload=self.workload.copy(),
            selfowned_reserved=so_r[:, p].copy(),
        )
