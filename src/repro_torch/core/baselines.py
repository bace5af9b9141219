"""Benchmark policies (paper Section 6.1) + the policy grids.

* ``Greedy``  — head task bids full-parallelism spot until the remaining
  critical path hits the remaining window, then everything on-demand
  (sequential global state; host float64, executed by
  ``oracle_greedy_chain`` or the slot-synchronous ``_greedy_batch``).
* ``Even``    — window slack split evenly across tasks, per-task composition
  still per Prop 4.1: ``run_even`` realizes it on the host
  (``run_jobs(windows="even")``); the paper tables sweep it on the card
  through ``sweep_policies(..., windows="even")``, whose planned starts
  (``early_start=False``) run the task-cost kernel.
* ``NaiveSelfOwned`` — r_i = min{N(window), delta_i}, first-come-first-served
  (``selfowned='naive'``).

Policy grids C1 (beta_0), C2 (beta), B (bid) exactly as in Section 6.1.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.market import SpotMarket
from repro_torch.core.oracle import oracle_greedy_chain
from repro_torch.core.scheduler import Policy, StreamCosts, run_jobs
from repro_torch.core.types import ChainJob

__all__ = [
    "C1_BETA0", "C2_BETA", "B_BIDS",
    "spot_od_policies", "selfowned_policies", "benchmark_bid_policies",
    "run_greedy", "run_even", "sweep_policies",
]

C1_BETA0 = (2 / 12, 4 / 14, 6 / 16, 8 / 18, 1 / 2, 0.6, 0.7)
C2_BETA = (1.0, 1 / 1.3, 1 / 1.6, 1 / 1.9, 1 / 2.2)
B_BIDS = (0.18, 0.21, 0.24, 0.27, 0.30)


def spot_od_policies() -> list[Policy]:
    """P = {(beta, b)} — 25 policies (Experiment 1)."""
    return [Policy(beta=b2, bid=b) for b2 in C2_BETA for b in B_BIDS]


def selfowned_policies() -> list[Policy]:
    """P = {(beta_0, beta, b)} — 175 policies (Experiments 2-4)."""
    return [Policy(beta=b2, bid=b, beta0=b0)
            for b0 in C1_BETA0 for b2 in C2_BETA for b in B_BIDS]


def benchmark_bid_policies(beta: float = 0.5, beta0: float | None = None) -> list[Policy]:
    """P' = {b} — the benchmarks are parameterized by bid only."""
    return [Policy(beta=beta, bid=b, beta0=beta0) for b in B_BIDS]


def sweep_policies(
    jobs: list[ChainJob],
    policies: list[Policy],
    markets,
    r_total: int = 0,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    early_start: bool = True,
    device="cuda",
    scenario_chunk: int | None = None,
    mesh=None,
) -> "tuple[Policy, float, StreamCosts, EngineResult]":  # noqa: F821
    """min over a policy grid of the realized average unit cost.

    One batched engine pass with shared-pool (run_jobs) semantics across all
    policies x bids x scenarios, on the card unless ``device="cpu"``;
    returns (best policy, its alpha — scenario-mean when several markets
    are given, its StreamCosts in scenario 0, the full EngineResult).
    ``markets`` accepts everything ``evaluate_grid`` does (a market, a
    list, a ``ScenarioSpec`` / source); ``scenario_chunk`` streams the
    scenario axis K per pass; ``mesh`` shards the scenario axis over a
    mesh of ranks (DESIGN.md §9).
    """
    from repro_torch.engine import evaluate_grid

    res = evaluate_grid(jobs, policies, markets, r_total, windows=windows,
                        selfowned=selfowned, early_start=early_start,
                        pool="shared", scenario_chunk=scenario_chunk,
                        device=device, mesh=mesh)
    p, alpha = res.best()
    return policies[p], alpha, res.stream_costs(p, 0), res


def run_greedy(
    jobs: list[ChainJob], bid: float, market: SpotMarket, batch: bool = True
) -> StreamCosts:
    """Greedy benchmark over a job stream (spot + on-demand only).

    ``batch=True`` uses the slot-synchronous vectorized engine (cross-checked
    in tests against the sequential ``oracle_greedy_chain``)."""
    n = len(jobs)
    out = StreamCosts.zeros(n)
    out.workload[:] = [j.total_work for j in jobs]
    if batch:
        res = _greedy_batch(jobs, bid, market)
        out.spot_cost[:] = res["spot_cost"]
        out.ondemand_cost[:] = res["ondemand_cost"]
        out.spot_work[:] = res["spot_work"]
        out.ondemand_work[:] = res["ondemand_work"]
        return out
    for ji, job in enumerate(jobs):
        res = oracle_greedy_chain(
            market, bid, job.arrival, job.deadline,
            job.z_array(), job.delta_array())
        out.spot_cost[ji] = res["spot_cost"]
        out.ondemand_cost[ji] = res["ondemand_cost"]
        out.spot_work[ji] = res["spot_work"]
        out.ondemand_work[ji] = res["ondemand_work"]
    return out


def _greedy_batch(jobs: list[ChainJob], bid: float, market: SpotMarket) -> dict:
    """Slot-synchronous vectorized Greedy over all jobs at once.

    Invariants exploited (same as the sequential oracle):
      * while spot is available the head task runs at full parallelism, so
        both the remaining critical path and the remaining window shrink at
        rate 1 — the switch margin is CONSTANT inside available slots and
        only task-completion events occur there;
      * while spot is unavailable nothing runs, so the margin shrinks at
        rate 1 and the switch can fire mid-slot — at which point the
        on-demand cost is exactly the remaining workload (back-to-back
        full-parallelism on-demand fills the window).
    """
    J = len(jobs)
    L = max(j.l for j in jobs)
    rem = np.zeros((J, L)); delta = np.ones((J, L))
    for ji, job in enumerate(jobs):
        rem[ji, :job.l] = job.z_array(); delta[ji, :job.l] = job.delta_array()
    arrival = np.array([j.arrival for j in jobs])
    deadline = np.array([j.deadline for j in jobs])
    head = np.zeros(J, dtype=np.int64)
    lmax = np.array([j.l for j in jobs])
    crit = (rem / delta).sum(axis=1)
    spot_cost = np.zeros(J); spot_work = np.zeros(J); od_work = np.zeros(J)
    done = np.zeros(J, dtype=bool)

    avail = market.availability(bid)
    price = market.price
    slot = market.slot
    k_lo = int(np.floor(arrival.min() / slot))
    k_hi = min(int(np.ceil(deadline.max() / slot)) + 1, len(avail))
    rows = np.arange(J)

    for k in range(k_lo, k_hi):
        t0, t1 = k * slot, (k + 1) * slot
        live = (~done) & (arrival < t1 - 1e-15) & (head < lmax)
        if not live.any():
            continue
        span = np.minimum(t1, deadline) - np.maximum(t0, arrival)
        if avail[k]:
            # Completion events only; a few carry iterations handle chains of
            # short pseudo-tasks completing inside one slot.
            left = np.where(live, np.maximum(span, 0.0), 0.0)
            for _ in range(64):
                act = left > 1e-15
                if not act.any():
                    break
                h = np.minimum(head, L - 1)
                d_h = delta[rows, h]
                r_h = rem[rows, h]
                dt = np.minimum(left, np.where(act, r_h / d_h, 0.0))
                work = d_h * dt
                spot_cost += np.where(act, d_h * price[k] * dt, 0.0)
                spot_work += np.where(act, work, 0.0)
                crit -= np.where(act, dt, 0.0)
                rem[rows, h] = np.where(act, r_h - work, r_h)
                finished = act & (rem[rows, h] <= 1e-12)
                rem[rows[finished], h[finished]] = 0.0
                head = np.where(finished, head + 1, head)
                done |= finished & (head >= lmax)
                left = np.where(act, left - dt, 0.0)
                left = np.where(done, 0.0, left)
        else:
            margin = (deadline - np.maximum(t0, arrival)) - crit
            fire = live & (margin <= span + 1e-15) & (span > 0)
            if fire.any():
                # Switch: remaining work all on-demand; job leaves the pool.
                leftover = rem[fire].sum(axis=1)
                od_work[fire] += leftover
                done[fire] = True
                rem[fire] = 0.0
    # Any stragglers past the horizon (fp slack): on-demand them.
    tail = rem.sum(axis=1)
    od_work += np.where(tail > 1e-9, tail, 0.0)
    return {
        "spot_cost": spot_cost,
        "ondemand_cost": market.p_ondemand * od_work,
        "spot_work": spot_work,
        "ondemand_work": od_work,
    }


def run_even(
    jobs: list[ChainJob],
    policy: Policy,
    market: SpotMarket,
    r_total: int = 0,
    selfowned: str = "naive",
) -> StreamCosts:
    """Even-window benchmark (optionally with the naive self-owned policy)."""
    return run_jobs(jobs, policy, market, r_total=r_total,
                    windows="even", selfowned=selfowned)
