"""TOLA / OptiLearning — the online-learning layer (paper Alg. 4, App. B.2).

Exponentiated-weights over a finite policy grid. When job j arrives at
``a_j`` a policy is sampled from the current weight distribution and drives
the job's actual allocation. Once a job's window has fully elapsed
(``t = a_j + d``), its cost under EVERY policy of the grid is computed
counterfactually and the weights are re-scaled with
``w <- w * exp(-eta_t * c_j(pi))``.

* The counterfactual cost matrix ``C[j, pi]`` does not depend on the weight
  evolution, so it is precomputed with one ``evaluate_grid`` pass on the
  card; the sequential sample/update replay is the float64 host loop of
  ``repro_torch.learn.replay`` (same logw arithmetic and uniform-stream
  consumption as ``rng.choice``).
* Per-job losses are normalized by the job workload Z_j (cost per unit
  workload), which keeps them in [0, p_od].
* The realized pass replays the sampled policies chronologically against the
  shared self-owned pool (host float64).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.market import SpotMarket
from repro_torch.core.pool import RangeMax
from repro_torch.core.scheduler import (
    Policy,
    StreamCosts,
    _allocate_pool,
    _simulate_plan,
    build_plans,
)
from repro_torch.core.types import ChainJob
from repro_torch.learn.learners import as_spec
from repro_torch.learn.replay import _replay_timed
from repro_torch.obs import span

__all__ = ["TolaResult", "cost_matrix", "run_tola", "run_tola_scenarios"]


@dataclasses.dataclass
class TolaResult:
    chosen: np.ndarray          # (n_jobs,) sampled policy index per job
    weights: np.ndarray         # (n_policies,) final distribution
    realized: StreamCosts       # realized costs under the sampled policies
    cost_matrix: np.ndarray     # (n_jobs, n_policies) counterfactual unit costs
    fixed_unit_costs: np.ndarray  # (n_policies,) stream alpha per fixed policy
    learn: "object | None" = None  # repro_torch.learn.LearnResult, last round
    # Wall seconds summed over the rounds (shared by the scenarios of one
    # run_tola_scenarios call): engine "plan"/"pool"/"synth"/"views"/"eval",
    # host "replay" (learner loop) and "realize" (shared pool + realized
    # costs).
    timings: dict = dataclasses.field(default_factory=dict)

    def average_unit_cost(self) -> float:
        return self.realized.average_unit_cost()

    @property
    def best_fixed_unit_cost(self) -> float:
        return float(self.fixed_unit_costs.min())

    @property
    def regret_per_job(self) -> float:
        """Realized average excess unit cost vs the best fixed policy."""
        return self.average_unit_cost() - self.best_fixed_unit_cost


def cost_matrix(
    jobs: list[ChainJob],
    policies: list[Policy],
    market: SpotMarket,
    r_total: int = 0,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    availability=None,
    plan_backend: str = "auto",
    device="cuda",
) -> np.ndarray:
    """C[j, pi] — per-unit-workload counterfactual cost of job j under pi,
    one ``evaluate_grid`` call over the whole grid."""
    from repro_torch.engine import evaluate_grid  # engine depends on core

    res = evaluate_grid(
        jobs, policies, market, r_total, windows=windows,
        selfowned=selfowned, early_start=early_start,
        availability=availability, pool="dedicated",
        plan_backend=plan_backend, device=device)
    return res.matrix


def _residual_availability(pool, r_total: int, slot: float):
    """Query fn: realized residual pool capacity over planned windows."""
    rmax = RangeMax(pool.used)

    def query(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
        lo = np.floor(starts / slot + 1e-9).astype(np.int64)
        hi = np.ceil(ends / slot - 1e-9).astype(np.int64)
        return np.maximum(r_total - rmax.query(lo, np.maximum(hi, lo + 1)), 0.0)

    return query


def _stream_meta(jobs: list[ChainJob]):
    """(arrivals, d, Z) of an arrival-ordered stream, validated."""
    arrivals = np.array([j.arrival for j in jobs])
    if np.any(np.diff(arrivals) < -1e-9):
        raise ValueError("jobs must be arrival-ordered")
    d = max(j.deadline - j.arrival for j in jobs)
    Z = np.array([j.total_work for j in jobs])
    return arrivals, d, Z


def _add(timings: dict, key: str, seconds: float) -> None:
    timings[key] = timings.get(key, 0.0) + seconds


def _tola_round(jobs, policies, C, arrivals, d, Z, spec, rng, market,
                r_total, windows, selfowned, early_start, timings=None):
    """One Alg.-4 round for one scenario: replay the learner over C (host
    float64), run the sampled policies against the shared pool, return the
    realized residual-availability query for the next refinement."""
    timings = {} if timings is None else timings
    lr, replay_t = _replay_timed(C, arrivals, d, workload=Z, learners=[spec],
                                 rng=rng, backend="numpy")
    chosen = lr.chosen[0, 0]
    with span("realize", r_total=r_total) as sp:
        plan = build_plans(jobs, [policies[c] for c in chosen], r_total,
                           windows)
        r_alloc, pool = _allocate_pool(plan, r_total, selfowned,
                                       market.slots_per_unit)
        realized = _simulate_plan(plan, r_alloc, market, early_start)
        availability = None if pool is None else \
            _residual_availability(pool, r_total, market.slot)
    _add(timings, "replay", replay_t)
    _add(timings, "realize", sp.seconds)
    return lr, chosen, realized, availability


def run_tola(
    jobs: list[ChainJob],
    policies: list[Policy],
    market: SpotMarket,
    r_total: int = 0,
    seed: int = 0,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    pool_iters: int = 1,
    learner="hedge",
    plan_backend: str = "auto",
    device="cuda",
) -> TolaResult:
    """Full Algorithm 4 over an arrival-ordered job list, one market.

    ``pool_iters``: number of pool-aware refinements of the counterfactual
    cost matrix (r_total > 0 only). Iteration 0 scores policies against a
    dedicated pool; each refinement re-scores them against the residual
    availability realized by the previous iteration's run.
    ``plan_backend`` goes to ``evaluate_grid`` (``"auto"``: device plans on
    the card).
    """
    return run_tola_scenarios(jobs, policies, [market], r_total, seed,
                              windows, selfowned, early_start, pool_iters,
                              learner, plan_backend, device)[0]


def run_tola_scenarios(
    jobs: list[ChainJob],
    policies: list[Policy],
    markets: list[SpotMarket],
    r_total: int = 0,
    seed: int = 0,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    pool_iters: int = 1,
    learner="hedge",
    plan_backend: str = "auto",
    device="cuda",
    mesh=None,
) -> list[TolaResult]:
    """Algorithm 4 across S market scenarios, cost matrices batched.

    Exactly ONE ``evaluate_grid`` call per refinement round, covering every
    scenario: round 0 is the engine's ordinary scenario axis; each pool
    refinement re-scores the grid against the S realized residual-
    availability queries in a single per-scenario-availability pass. The
    sequential sample/update replay runs per scenario with seed
    ``seed + s``, as looping single-market ``run_tola`` would. With device
    plans the refinement rounds take the plan layer's two-stage path: the
    planned windows go to the host once for the per-scenario queries.

    ``mesh`` shards the scenario axis (DESIGN.md §9) in every round: round
    0's ordinary scenario axis and the refinement rounds' per-scenario
    availability pass (the (S, R, L) refined plan stacks are sliced with
    the views). Every rank replays all scenarios on the host and returns
    the full result.
    """
    from repro_torch.engine import evaluate_grid  # engine depends on core
    from repro_torch.engine.mesh import as_scenario_mesh

    if not jobs or not policies:
        raise ValueError("need jobs and policies")
    S = len(markets)
    arrivals, d, Z = _stream_meta(jobs)
    spec = as_spec(learner)
    rngs = [np.random.default_rng(seed + s) for s in range(S)]
    timings: dict = {}
    mesh = as_scenario_mesh(mesh)

    avails: list | None = None
    iters = 1 + (pool_iters if r_total > 0 else 0)
    for it in range(iters):
        res = evaluate_grid(
            jobs, policies, markets, r_total, windows=windows,
            selfowned=selfowned, early_start=early_start, pool="dedicated",
            availability=avails, plan_backend=plan_backend, device=device,
            mesh=mesh)
        for key, sec in res.timings.items():
            if isinstance(sec, float):      # not the chunk list or the flag
                _add(timings, key, sec)
        C = res.unit_cost
        rounds = [
            _tola_round(jobs, policies, C[s], arrivals, d, Z, spec, rngs[s],
                        markets[s], r_total, windows, selfowned, early_start,
                        timings)
            for s in range(S)
        ]
        avails = [r[3] for r in rounds]
        if any(a is None for a in avails):
            avails = None  # r_total == 0: nothing to refine against

    return [
        TolaResult(chosen=chosen, weights=lr.weights[0, 0],
                   realized=realized, cost_matrix=C[s],
                   fixed_unit_costs=(C[s] * Z[:, None]).sum(axis=0) / Z.sum(),
                   learn=lr, timings=timings)
        for s, (lr, chosen, realized, _) in enumerate(rounds)
    ]
