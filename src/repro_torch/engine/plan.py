"""Plan layer of the port's evaluation engine (host float64 path).

Turns (jobs x policies) into a deduplicated batch of *evaluation groups*.
The padded ``PlanBatch`` depends on a policy only through its Dealloc
parameter, the self-owned allocation only through (plan, beta_0), and the
market realization additionally through the bid. Policies sharing the
triple (window key, beta_0, bid) are exact duplicates and collapse into one
group. Window plans for all distinct Dealloc parameters come out of one
vectorized ``build_plans_batch`` pass, and the market-independent
arithmetic (policy-(12) counts, cloud residuals, pins) follows in float64 —
the same numbers as the reference's host plan, which the cost kernels then
consume in float32.

When ``availability`` is a *list* of per-scenario queries (TOLA's batched
pool refinement), the self-owned arrays gain a leading scenario axis:
groups carry (S, J, L) tensors and backends pair scenario s with slice s.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.scheduler import (
    PlanBatch,
    Policy,
    _allocate_pool,
    _selfowned_counts_vec,
    build_plans_batch,
    job_arrays,
)
from repro_torch.core.types import ChainJob

__all__ = ["EvalGroup", "GridPlan", "build_grid_plan", "scenario_cat",
           "distinct_window_params"]


def scenario_cat(groups, attr: str, S: int):
    """Concatenate a group attribute into an (S, R, L) scenario-major stack,
    broadcasting groups whose arrays are scenario-independent."""
    return np.concatenate(
        [np.broadcast_to(getattr(g, attr),
                         (S,) + tuple(g.plan.ends.shape)) for g in groups],
        axis=1)


def _bid_key(bid: float) -> float:
    """The one bid-comparison rule of the plan layer: groups are deduped,
    listed and looked up on the same rounded value."""
    return round(bid, 12)


@dataclasses.dataclass
class EvalGroup:
    """One distinct (window plan, beta_0, bid) evaluation cell.

    ``policy_idx`` lists every policy of the original grid that this group
    realizes. The self-owned arrays are (J, L) when market-independent and
    (S, J, L) when the caller supplied per-scenario availability queries.
    """

    plan: PlanBatch
    policy_idx: np.ndarray   # (k,) columns of the cost matrix this fills
    bid: float
    r_alloc: np.ndarray      # (J, L) | (S, J, L) self-owned instances
    z_t: np.ndarray          # (J, L) | (S, J, L) cloud workload after s-o
    d_eff: np.ndarray        # (J, L) | (S, J, L) cloud parallelism after s-o
    pins: np.ndarray         # bool — tasks holding reservations
    selfowned_work: np.ndarray      # (J,) | (S, J)
    selfowned_reserved: np.ndarray  # (J,) | (S, J)

    @property
    def per_scenario(self) -> bool:
        return self.z_t.ndim == 3


@dataclasses.dataclass
class GridPlan:
    """The full batched evaluation plan for (jobs x policies)."""

    jobs: list[ChainJob]
    policies: list[Policy]
    groups: list[EvalGroup]
    workload: np.ndarray     # (J,) Z_j
    arrival: np.ndarray      # (J,)
    n_jobs: int
    n_policies: int
    L: int
    plan_seconds: float = 0.0   # window-plan tensor construction
    pool_seconds: float = 0.0   # self-owned allocation + residuals

    @property
    def bids(self) -> list[float]:
        seen: dict[float, float] = {}
        for g in self.groups:
            seen.setdefault(_bid_key(g.bid), g.bid)
        return sorted(seen.values())

    @property
    def per_scenario(self) -> bool:
        return any(g.per_scenario for g in self.groups)

    def groups_for_bid(self, bid: float) -> list[EvalGroup]:
        key = _bid_key(bid)
        return [g for g in self.groups if _bid_key(g.bid) == key]


def _window_key(policy: Policy, r_total: int, windows: str):
    if windows == "even":
        return ("even",)
    return ("dealloc", round(policy.dealloc_param(r_total), 12))


def distinct_window_params(policies, r_total: int,
                           windows: str = "dealloc") -> dict[tuple, float]:
    """Window-key dedup of a policy grid: {window key -> exact Dealloc param
    of the FIRST policy carrying it} in first-appearance order."""
    key_param: dict[tuple, float] = {}
    for pol in policies:
        wkey = _window_key(pol, r_total, windows)
        if wkey not in key_param:
            key_param[wkey] = (pol.dealloc_param(r_total)
                               if windows != "even" else 0.0)
    return key_param


@dataclasses.dataclass
class _GridStructure:
    """First-appearance-ordered dedup of the (window, beta_0, bid) grid."""

    key_param: dict[tuple, float]   # window key -> exact Dealloc param
    a_plan: list[int]               # akey -> window-plan index
    a_beta0: list[float | None]     # akey -> beta_0 of its first policy
    g_akey: list[int]               # group -> akey index
    g_bid: list[float]              # group -> exact bid of its first policy
    g_pols: list[list[int]]         # group -> policy columns it fills


def _grid_structure(policies, r_total: int, windows: str) -> _GridStructure:
    key_param = distinct_window_params(policies, r_total, windows)
    w_index = {k: i for i, k in enumerate(key_param)}
    akey_index: dict[tuple, int] = {}
    g_index: dict[tuple, int] = {}
    s = _GridStructure(key_param, [], [], [], [], [])
    for pi, pol in enumerate(policies):
        wkey = _window_key(pol, r_total, windows)
        b0 = None if pol.beta0 is None else round(pol.beta0, 12)
        akey = wkey + (b0,)
        ai = akey_index.get(akey)
        if ai is None:
            ai = akey_index[akey] = len(s.a_plan)
            s.a_plan.append(w_index[wkey])
            s.a_beta0.append(pol.beta0)
        gkey = akey + (_bid_key(pol.bid),)
        gi = g_index.get(gkey)
        if gi is None:
            gi = g_index[gkey] = len(s.g_bid)
            s.g_akey.append(ai)
            s.g_bid.append(pol.bid)
            s.g_pols.append([pi])
        else:
            s.g_pols[gi].append(pi)
    return s


def _cloud_residuals(plan: PlanBatch, r_alloc: np.ndarray):
    """Residual cloud workload (dust-killed), effective parallelism, pins,
    self-owned stats. ``r_alloc`` may carry a leading scenario axis."""
    sizes = plan.sizes
    z_t = np.maximum(plan.z - r_alloc * sizes, 0.0)
    z_t[z_t <= 1e-9 * (plan.z + 1.0)] = 0.0
    d_eff = np.maximum(plan.delta - r_alloc, 0.0)
    selfowned = np.minimum(r_alloc * sizes, plan.z)
    return z_t, d_eff, r_alloc > 0, selfowned.sum(axis=-1), \
        (r_alloc * sizes).sum(axis=-1)


def _group_alloc(plan: PlanBatch, pol_beta0: float | None, r_total: int,
                 selfowned: str, pool: str, availability,
                 slots_per_unit: int) -> np.ndarray:
    if r_total <= 0:
        return np.zeros_like(plan.z)
    beta0 = np.full(plan.z.shape[0],
                    np.nan if pol_beta0 is None else pol_beta0)
    if pool == "shared":
        # Chronological shared-pool replay on the planned windows; each
        # policy of a sweep owns a fresh pool. The allocation is
        # bid-independent, so bid is NaN.
        pplan = dataclasses.replace(plan, beta0=beta0,
                                    bid=np.full(plan.z.shape[0], np.nan))
        r_alloc, _ = _allocate_pool(pplan, r_total, selfowned, slots_per_unit)
        return r_alloc
    if availability is None:
        avail = float(r_total)
    elif isinstance(availability, (list, tuple)):
        # Per-scenario residual-occupancy queries -> (S, J, L) availability.
        avail = np.stack([q(plan.starts, plan.ends) for q in availability])
    else:
        avail = availability(plan.starts, plan.ends)
    r_alloc = _selfowned_counts_vec(
        plan.z, plan.delta, plan.sizes, beta0[:, None], avail, selfowned)
    return np.where(plan.mask, r_alloc, 0.0)


def build_grid_plan(
    jobs: list[ChainJob],
    policies: list[Policy],
    r_total: int = 0,
    windows: str = "dealloc",
    selfowned: str = "prop12",
    pool: str = "dedicated",
    availability=None,
    slots_per_unit: int = 12,
    n_scenarios: int | None = None,
) -> GridPlan:
    """Deduplicate (jobs x policies) into evaluation groups (host float64).

    ``pool="dedicated"`` scores each policy against an uncontended pool (the
    counterfactual evaluator TOLA uses; ``availability`` optionally replaces
    the constant ``r_total`` with a realized residual-occupancy query, or a
    LIST of per-scenario queries for scenario-batched pool refinement —
    pass ``n_scenarios`` so the list length is validated here).
    ``pool="shared"`` replays the chronological shared-pool allocation per
    policy.
    """
    if pool not in ("dedicated", "shared"):
        raise ValueError(f"unknown pool mode {pool!r}")
    if isinstance(availability, (list, tuple)) and n_scenarios is not None \
            and len(availability) != n_scenarios:
        raise ValueError(
            f"per-scenario availability needs one query per scenario "
            f"({len(availability)} queries, {n_scenarios} scenarios)")

    s = _grid_structure(policies, r_total, windows)
    arrays = job_arrays(jobs)
    params = list(s.key_param.values())

    t0 = time.perf_counter()
    if windows == "even":
        built = build_plans_batch(jobs, windows="even", arrays=arrays)
    else:
        built = build_plans_batch(jobs, params, windows="dealloc",
                                  arrays=arrays)
    t1 = time.perf_counter()
    alloc = [_group_alloc(built[s.a_plan[ai]], s.a_beta0[ai], r_total,
                          selfowned, pool, availability, slots_per_unit)
             for ai in range(len(s.a_plan))]
    groups: list[EvalGroup] = []
    for gi in range(len(s.g_bid)):
        ai = s.g_akey[gi]
        plan = built[s.a_plan[ai]]
        z_t, d_eff, pins, so_work, so_res = _cloud_residuals(plan, alloc[ai])
        groups.append(EvalGroup(
            plan=plan, policy_idx=np.asarray(s.g_pols[gi]),
            bid=s.g_bid[gi], r_alloc=alloc[ai], z_t=z_t, d_eff=d_eff,
            pins=pins, selfowned_work=so_work, selfowned_reserved=so_res))
    t2 = time.perf_counter()
    return GridPlan(jobs=jobs, policies=policies, groups=groups,
                    workload=arrays.z.sum(axis=1), arrival=arrays.arrival,
                    n_jobs=len(jobs), n_policies=len(policies),
                    L=arrays.z.shape[1], plan_seconds=t1 - t0,
                    pool_seconds=t2 - t1)
