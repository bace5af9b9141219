"""Closed-form realized-cost simulator (Definition 3.2 over a realized market).

Given a task executing in a window [start, end] with ``d_eff = delta - r``
cloud instances and remaining workload ``z_t = z - r * (end - start)``, the
realized allocation process of Algorithm 2 (lines 11-15) is:

  * while the task has *flexibility* (Def. 3.1), request ``d_eff`` spot
    instances — work accrues at rate ``d_eff`` whenever the bid clears the
    spot price, i.e. work done by time t is ``d_eff * (A(t) - A(start))``;
  * at the *turning point* (flexibility exhausted) switch to ``d_eff``
    on-demand instances for the remaining work.

The flexibility margin g(t) = (end - t) - z_rem(t)/d_eff changes at rate
``-(1 - a(t))`` — it only shrinks while spot is UNavailable — hence the
turning point is the unique root of the monotone map H(t) = t - A(t)
(DESIGN.md Section 5):

    t* = earliest t with  H(t) >= H(start) + (end - start) - z_t / d_eff

and the task instead finishes on spot alone at

    t_fin = earliest t with  A(t) >= A(start) + z_t / d_eff

whichever comes first. Both are exact searchsorted queries on the market's
cumulative arrays; no per-slot loop anywhere. (The reference package's
``core/oracle.py`` re-derives the same quantities by sequential slot
stepping.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.market import BidView

__all__ = ["TaskSim", "simulate_tasks", "FLEX_REL", "FLEX_ABS"]

# Definition 3.1 requires STRICTLY positive flexibility to use spot. Tasks
# whose window exactly equals their minimum execution time (z == d * size —
# an atom under Dealloc, which leaves unselected tasks with zero slack) sit
# exactly on the turning-point guard, where the cost is discontinuous
# (ride-spot vs all-on-demand). An epsilon makes the branch deterministic
# under floating-point rounding: slack <= max(FLEX_REL * window,
# FLEX_ABS * end) counts as "no flexibility". FLEX_REL handles reassociation
# noise on the window itself; FLEX_ABS dominates the ABSOLUTE f32 rounding
# of the chain clock (~1.2e-7 * t), which exceeds the relative term for
# short windows late in the horizon. The SAME thresholds are used by the
# f64 oracle and the f32 cost kernels (``kernels/policy_cost.py``), so
# both take the same branch everywhere except a thin sliver around the
# threshold (DESIGN.md §5).
FLEX_REL = 1e-4
FLEX_ABS = 1e-5
# _WORK_EPS: "is there any cloud work left" predicate on z_t. Residual
# workloads are differences of f64 sums, so true zeros land within one ulp;
# 1e-15 is far below any real task's workload (O(1) units).
_WORK_EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class TaskSim:
    """Vectorized realized outcome for a batch of tasks (all arrays (n,))."""

    spot_cost: np.ndarray
    ondemand_cost: np.ndarray
    spot_work: np.ndarray
    ondemand_work: np.ndarray
    finish: np.ndarray          # realized completion time
    turning: np.ndarray         # turning point, +inf if none

    @property
    def total_cost(self) -> np.ndarray:
        return self.spot_cost + self.ondemand_cost


def simulate_tasks(
    view: BidView,
    start: np.ndarray,
    end: np.ndarray,
    z_t: np.ndarray,
    d_eff: np.ndarray,
    p_ondemand: float = 1.0,
) -> TaskSim:
    """Exact realized costs for tasks run per Definition 3.2 under one bid.

    Parameters
    ----------
    view:   the market's cumulative arrays for the policy's bid price.
    start, end: window [start_i, end_i] per task (planned or realized starts).
    z_t:    workload left for cloud instances (z - r * window), >= 0.
    d_eff:  cloud parallelism delta - r, >= 0. ``z_t > 0`` requires
            ``d_eff > 0`` (guaranteed by policy (12): r = delta forces
            z_t <= 0).
    """
    start = np.asarray(start, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    z_t = np.maximum(np.asarray(z_t, dtype=np.float64), 0.0)
    d_eff = np.asarray(d_eff, dtype=np.float64)

    n = start.shape[0]
    active = z_t > _WORK_EPS
    if np.any(active & (d_eff <= 0.0)):
        raise ValueError("task with remaining cloud work but no cloud instances")
    # Avoid 0/0 on inactive tasks.
    d_safe = np.where(d_eff > 0.0, d_eff, 1.0)
    need = z_t / d_safe  # instance-availability time needed

    A0 = view.A(start)
    H0 = start - A0
    C0 = view.C(start)

    # Turning point: first t with H(t) >= H0 + (end - start) - need.
    h_target = H0 + (end - start) - need
    # If need >= window (up to the relative flexibility epsilon) the task has
    # no flexibility at start: turn immediately.
    no_flex = (end - start) - need <= np.maximum(
        1e-15, np.maximum(FLEX_REL * (end - start), FLEX_ABS * end))
    t_turn = np.where(no_flex, start, view.t_for_H(h_target))
    # Spot-alone finish: first t with A(t) >= A0 + need.
    t_fin = view.t_for_A(A0 + need)

    # Exactly one of the two events lands inside [start, end]; compare.
    finish_on_spot = t_fin <= t_turn
    t_spot_end = np.where(finish_on_spot, t_fin, t_turn)
    # Defensive clamp (horizon overruns map to end; callers size the market
    # so this never truncates real windows).
    t_spot_end = np.minimum(t_spot_end, end)

    spot_avail = np.maximum(view.A(t_spot_end) - A0, 0.0)
    spot_work = np.minimum(d_eff * spot_avail, z_t)
    spot_cost = d_eff * np.maximum(view.C(t_spot_end) - C0, 0.0)
    od_work = z_t - spot_work
    od_cost = p_ondemand * od_work

    finish = np.where(finish_on_spot, t_fin, end)
    turning = np.where(finish_on_spot, np.inf, t_spot_end)

    # Inactive tasks: nothing happens.
    zeros = np.zeros(n)
    return TaskSim(
        spot_cost=np.where(active, spot_cost, zeros),
        ondemand_cost=np.where(active, od_cost, zeros),
        spot_work=np.where(active, spot_work, zeros),
        ondemand_work=np.where(active, od_work, zeros),
        finish=np.where(active, finish, start),
        turning=np.where(active, turning, np.inf),
    )


def simulate_chains_early(
    view: BidView,
    arrival: np.ndarray,      # (J,) job arrivals
    ends: np.ndarray,         # (J, L) planned task deadlines (padded)
    z_t: np.ndarray,          # (J, L) cloud workload per task (0 = padding)
    d_eff: np.ndarray,        # (J, L) cloud parallelism per task
    selfowned_pins: np.ndarray | None = None,  # (J, L) bool: r_i > 0
    p_ondemand: float = 1.0,
) -> TaskSim:
    """Early-start chain execution, vectorized over jobs.

    Task k of each chain begins at its predecessor's *realized* finish
    (paper Table 1: s~_i is "the earliest time at which the execution of
    task i can begin") and must still finish by its planned Dealloc deadline
    ``ends[:, k]``. Tasks holding self-owned instances are pinned: their
    self-owned share completes exactly at the planned window end (the
    reservation is the planned window), so their realized finish is the
    planned deadline.

    Returns a TaskSim with per-JOB aggregates (shape (J,)); ``finish`` is the
    realized completion of the whole chain and ``turning`` the count of tasks
    that lost flexibility.
    """
    J, L = z_t.shape
    cur = arrival.astype(np.float64).copy()
    agg = {k: np.zeros(J) for k in
           ("spot_cost", "ondemand_cost", "spot_work", "ondemand_work")}
    turn_count = np.zeros(J)
    for k in range(L):
        end_k = ends[:, k]
        live = end_k > cur - _WORK_EPS
        start_k = np.minimum(cur, end_k)
        sim = simulate_tasks(
            view, start_k, end_k, np.where(live, z_t[:, k], 0.0),
            np.maximum(d_eff[:, k], 0.0), p_ondemand)
        agg["spot_cost"] += sim.spot_cost
        agg["ondemand_cost"] += sim.ondemand_cost
        agg["spot_work"] += sim.spot_work
        agg["ondemand_work"] += sim.ondemand_work
        turn_count += np.isfinite(sim.turning)
        finish_k = sim.finish
        if selfowned_pins is not None:
            finish_k = np.where(selfowned_pins[:, k], end_k, finish_k)
        # Padding tasks (z_t == 0, no pin) leave `cur` untouched.
        moved = (z_t[:, k] > _WORK_EPS) | (
            selfowned_pins[:, k] if selfowned_pins is not None else False)
        cur = np.where(moved, finish_k, cur)
    return TaskSim(
        spot_cost=agg["spot_cost"], ondemand_cost=agg["ondemand_cost"],
        spot_work=agg["spot_work"], ondemand_work=agg["ondemand_work"],
        finish=cur, turning=turn_count,
    )
